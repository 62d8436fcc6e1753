"""Image I/O on the host (a copy of ``dreamllm_tpu/utils/image.py``; the
port imports nothing of that package): load, save and base64 with PIL.
Arrays are HWC, uint8 or float in [0, 1]; a tensor (on any device) is
brought to the host first. Device-side transforms live in ``models/clip.py``.
"""

from __future__ import annotations

import base64
import io
import os

import numpy as np


def _host(arr) -> np.ndarray:
    if hasattr(arr, "detach"):  # a tensor, possibly on the card
        arr = arr.detach().cpu()
    return np.asarray(arr)


def load_image(path_or_url: str) -> np.ndarray:
    """→ HWC uint8 RGB. Local paths only (zero-egress environments)."""
    from PIL import Image

    img = Image.open(path_or_url).convert("RGB")
    return np.asarray(img)


def save_image(arr, path: str):
    """Accepts float [0,1] or uint8 HWC."""
    from PIL import Image

    a = _host(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(a).save(path)


def image_to_base64(arr, format: str = "PNG") -> str:
    from PIL import Image

    a = _host(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format)
    return base64.b64encode(buf.getvalue()).decode()


def base64_to_image(s: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB"))


def make_grid(images, cols: int | None = None, pad: int = 2) -> np.ndarray:
    """Tile a list/array of same-size HWC images into one grid image."""
    import math

    arrs = [np.asarray(x) for x in images]
    n = len(arrs)
    cols = cols or math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    h, w, c = arrs[0].shape
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c), arrs[0].dtype)
    for i, a in enumerate(arrs):
        r, cc = divmod(i, cols)
        grid[r * (h + pad) : r * (h + pad) + h, cc * (w + pad) : cc * (w + pad) + w] = a
    return grid
