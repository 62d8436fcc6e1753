"""FID: Frechet distance + InceptionV3 (pytorch-fid-compatible), port of
``dreamllm_tpu/eval/fid.py``.

The InceptionV3 reproduces the *FID variant* of the torchvision model that
pytorch-fid uses (third_party/pytorch-fid/src/pytorch_fid/inception.py):
the same layer stack and its three quirks (FIDInceptionA/C/E_1 average-pool
with ``count_include_pad=False``; FIDInceptionE_2 max-pools in its
branch_pool), so converted torchvision weights (``convert/inception.py``)
give matching pool3 activations. Input protocol: images ``[B, H, W, 3]`` in
[0, 1], resized to 299x299 as the JAX package resizes (bilinear,
antialiased when it shrinks), scaled to [-1, 1]. Convolutions run NCHW
(channels-last memory) with OIHW kernels, as the port stores them.

FID is a float32 measurement: on the card the forward runs with TF32 off
for convolutions and matmuls (cuDNN takes TF32 by default), restored
afterwards. ``frechet_distance`` follows pytorch-fid's numerics (scipy
``sqrtm`` on the host, float64).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.sd.blocks import init_conv

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Frechet distance
# ---------------------------------------------------------------------------


def activation_statistics(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of [N, D] activations."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (fid_score.py
    calculate_frechet_distance numerics, with its eps-on-diagonal retry and
    its check of the imaginary part). ``sqrtm`` is called without
    ``disp``, which SciPy deprecated and then removed."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("sqrtm has large imaginary component")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


# ---------------------------------------------------------------------------
# InceptionV3 (FID variant)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    dtype: torch.dtype = torch.float32
    normalize_input: bool = True  # map [0,1] -> [-1,1]


def _bn_conv(kh, kw, cin, cout, dtype, dev, gen):
    """Conv + folded batch norm (inference): conv weight plus bn scale and
    bias. torchvision BasicConv2d = conv (no bias) + BN + relu."""
    return {
        "conv": init_conv(kh, kw, cin, cout, dtype, dev, gen),
        "bn_scale": torch.ones((cout,), dtype=dtype, device=dev),
        "bn_bias": torch.zeros((cout,), dtype=dtype, device=dev),
    }


def _apply_bn_conv(p, x, stride=1, padding="SAME"):
    """NCHW ``x``; "SAME" pads ``((kh-1)//2, (kw-1)//2)``, which is XLA's
    SAME for the odd kernels at stride 1 where the network uses it (1x7 and
    7x1 included); "VALID" pads nothing."""
    w = p["conv"]["w"]
    pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2) if padding == "SAME" else 0
    y = F.conv2d(x, w.to(x.dtype), None, stride, pad)
    c = (1, -1, 1, 1)
    y = y * p["bn_scale"].to(x.dtype).view(c) + p["bn_bias"].to(x.dtype).view(c)
    return F.relu(y)


def _avg_pool(x, count_include_pad=True):
    """3x3, stride 1, SAME."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _max_pool(x, stride=2, padding=0):
    """3x3; "VALID" at stride 2 by default, SAME (padding 1, -inf) at stride 1."""
    return F.max_pool2d(x, 3, stride, padding)


def _mixed_a(cin, pool_ch, d, dev, gen):  # InceptionA / FIDInceptionA
    return {
        "b1x1": _bn_conv(1, 1, cin, 64, d, dev, gen),
        "b5x5_1": _bn_conv(1, 1, cin, 48, d, dev, gen),
        "b5x5_2": _bn_conv(5, 5, 48, 64, d, dev, gen),
        "b3x3_1": _bn_conv(1, 1, cin, 64, d, dev, gen),
        "b3x3_2": _bn_conv(3, 3, 64, 96, d, dev, gen),
        "b3x3_3": _bn_conv(3, 3, 96, 96, d, dev, gen),
        "pool": _bn_conv(1, 1, cin, pool_ch, d, dev, gen),
    }


def _apply_mixed_a(p, x):
    b1 = _apply_bn_conv(p["b1x1"], x)
    b5 = _apply_bn_conv(p["b5x5_2"], _apply_bn_conv(p["b5x5_1"], x))
    b3 = _apply_bn_conv(p["b3x3_3"], _apply_bn_conv(p["b3x3_2"], _apply_bn_conv(p["b3x3_1"], x)))
    # FID quirk: count_include_pad=False
    bp = _apply_bn_conv(p["pool"], _avg_pool(x, count_include_pad=False))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _mixed_b(cin, d, dev, gen):  # InceptionB (reduction)
    return {
        "b3x3": _bn_conv(3, 3, cin, 384, d, dev, gen),
        "b3x3dbl_1": _bn_conv(1, 1, cin, 64, d, dev, gen),
        "b3x3dbl_2": _bn_conv(3, 3, 64, 96, d, dev, gen),
        "b3x3dbl_3": _bn_conv(3, 3, 96, 96, d, dev, gen),
    }


def _apply_mixed_b(p, x):
    b3 = _apply_bn_conv(p["b3x3"], x, stride=2, padding="VALID")
    d = _apply_bn_conv(p["b3x3dbl_1"], x)
    d = _apply_bn_conv(p["b3x3dbl_2"], d)
    d = _apply_bn_conv(p["b3x3dbl_3"], d, stride=2, padding="VALID")
    return torch.cat([b3, d, _max_pool(x)], dim=1)


def _mixed_c(cin, c7, d, dev, gen):  # InceptionC / FIDInceptionC
    return {
        "b1x1": _bn_conv(1, 1, cin, 192, d, dev, gen),
        "b7_1": _bn_conv(1, 1, cin, c7, d, dev, gen),
        "b7_2": _bn_conv(1, 7, c7, c7, d, dev, gen),
        "b7_3": _bn_conv(7, 1, c7, 192, d, dev, gen),
        "b7d_1": _bn_conv(1, 1, cin, c7, d, dev, gen),
        "b7d_2": _bn_conv(7, 1, c7, c7, d, dev, gen),
        "b7d_3": _bn_conv(1, 7, c7, c7, d, dev, gen),
        "b7d_4": _bn_conv(7, 1, c7, c7, d, dev, gen),
        "b7d_5": _bn_conv(1, 7, c7, 192, d, dev, gen),
        "pool": _bn_conv(1, 1, cin, 192, d, dev, gen),
    }


def _apply_mixed_c(p, x):
    b1 = _apply_bn_conv(p["b1x1"], x)
    b7 = _apply_bn_conv(p["b7_3"], _apply_bn_conv(p["b7_2"], _apply_bn_conv(p["b7_1"], x)))
    d = x
    for name in ("b7d_1", "b7d_2", "b7d_3", "b7d_4", "b7d_5"):
        d = _apply_bn_conv(p[name], d)
    bp = _apply_bn_conv(p["pool"], _avg_pool(x, count_include_pad=False))
    return torch.cat([b1, b7, d, bp], dim=1)


def _mixed_d(cin, d, dev, gen):  # InceptionD (reduction)
    return {
        "b3x3_1": _bn_conv(1, 1, cin, 192, d, dev, gen),
        "b3x3_2": _bn_conv(3, 3, 192, 320, d, dev, gen),
        "b7x7_1": _bn_conv(1, 1, cin, 192, d, dev, gen),
        "b7x7_2": _bn_conv(1, 7, 192, 192, d, dev, gen),
        "b7x7_3": _bn_conv(7, 1, 192, 192, d, dev, gen),
        "b7x7_4": _bn_conv(3, 3, 192, 192, d, dev, gen),
    }


def _apply_mixed_d(p, x):
    b3 = _apply_bn_conv(p["b3x3_2"], _apply_bn_conv(p["b3x3_1"], x), stride=2, padding="VALID")
    b7 = _apply_bn_conv(p["b7x7_1"], x)
    b7 = _apply_bn_conv(p["b7x7_2"], b7)
    b7 = _apply_bn_conv(p["b7x7_3"], b7)
    b7 = _apply_bn_conv(p["b7x7_4"], b7, stride=2, padding="VALID")
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _mixed_e(cin, d, dev, gen):  # InceptionE / FIDInceptionE_{1,2}
    return {
        "b1x1": _bn_conv(1, 1, cin, 320, d, dev, gen),
        "b3_1": _bn_conv(1, 1, cin, 384, d, dev, gen),
        "b3_2a": _bn_conv(1, 3, 384, 384, d, dev, gen),
        "b3_2b": _bn_conv(3, 1, 384, 384, d, dev, gen),
        "b3d_1": _bn_conv(1, 1, cin, 448, d, dev, gen),
        "b3d_2": _bn_conv(3, 3, 448, 384, d, dev, gen),
        "b3d_3a": _bn_conv(1, 3, 384, 384, d, dev, gen),
        "b3d_3b": _bn_conv(3, 1, 384, 384, d, dev, gen),
        "pool": _bn_conv(1, 1, cin, 192, d, dev, gen),
    }


def _apply_mixed_e(p, x, pool_kind: str):
    b1 = _apply_bn_conv(p["b1x1"], x)
    b3 = _apply_bn_conv(p["b3_1"], x)
    b3 = torch.cat([_apply_bn_conv(p["b3_2a"], b3), _apply_bn_conv(p["b3_2b"], b3)], dim=1)
    d = _apply_bn_conv(p["b3d_2"], _apply_bn_conv(p["b3d_1"], x))
    d = torch.cat([_apply_bn_conv(p["b3d_3a"], d), _apply_bn_conv(p["b3d_3b"], d)], dim=1)
    if pool_kind == "avg":  # FIDInceptionE_1: count_include_pad=False
        pooled = _avg_pool(x, count_include_pad=False)
    else:  # FIDInceptionE_2: *max* pooling (pytorch-fid quirk)
        pooled = _max_pool(x, stride=1, padding=1)
    bp = _apply_bn_conv(p["pool"], pooled)
    return torch.cat([b1, b3, d, bp], dim=1)


def init_inception_params(cfg: InceptionConfig = InceptionConfig(), *,
                          generator: torch.Generator | None = None, device="cuda") -> Params:
    """Random weights (conv kernels ``N(0, 1/fan_in)`` as the JAX package
    draws them, BN scale 1, bias 0). The draws differ from JAX's: bring
    JAX's in through ``bridge.from_jax``, converted torchvision weights
    through ``convert/inception.py``."""
    dev = resolve_device(device)
    d, g = cfg.dtype, generator
    return {
        "stem1": _bn_conv(3, 3, 3, 32, d, dev, g),     # stride 2 valid
        "stem2": _bn_conv(3, 3, 32, 32, d, dev, g),    # valid
        "stem3": _bn_conv(3, 3, 32, 64, d, dev, g),    # same
        "stem4": _bn_conv(1, 1, 64, 80, d, dev, g),    # valid
        "stem5": _bn_conv(3, 3, 80, 192, d, dev, g),   # valid
        "mixed_5b": _mixed_a(192, 32, d, dev, g),
        "mixed_5c": _mixed_a(256, 64, d, dev, g),
        "mixed_5d": _mixed_a(288, 64, d, dev, g),
        "mixed_6a": _mixed_b(288, d, dev, g),
        "mixed_6b": _mixed_c(768, 128, d, dev, g),
        "mixed_6c": _mixed_c(768, 160, d, dev, g),
        "mixed_6d": _mixed_c(768, 160, d, dev, g),
        "mixed_6e": _mixed_c(768, 192, d, dev, g),
        "mixed_7a": _mixed_d(768, d, dev, g),
        "mixed_7b": _mixed_e(1280, d, dev, g),
        "mixed_7c": _mixed_e(2048, d, dev, g),
    }


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and CUDA matmuls, restored on exit:
    cuDNN takes TF32 for float32 convolutions by default, which would make
    FID a TF32 number; it is a float32 measurement."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` to 299x299 as ``jax.image.resize(..., "bilinear")``: half-pixel
    centres, a triangle kernel, antialiased (the kernel widened by the
    shrink factor) where a side shrinks."""
    if x.shape[2] == 299 and x.shape[3] == 299:
        return x
    shrink = x.shape[2] > 299 or x.shape[3] > 299
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=shrink)


@torch.no_grad()
def inception_pool3(params: Params, images: torch.Tensor,
                    cfg: InceptionConfig = InceptionConfig()) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> ``[B, 2048]`` float32 pool3 activations,
    on the device of ``params``."""
    dev = params["stem1"]["conv"]["w"].device
    x = torch.as_tensor(images).to(device=dev, dtype=torch.float32)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with full_float32():
        if x.shape[2] != 299:
            x = resize_299(x)
        if cfg.normalize_input:
            x = x * 2.0 - 1.0
        x = x.to(cfg.dtype)
        x = _apply_bn_conv(params["stem1"], x, stride=2, padding="VALID")
        x = _apply_bn_conv(params["stem2"], x, padding="VALID")
        x = _apply_bn_conv(params["stem3"], x)
        x = _max_pool(x)
        x = _apply_bn_conv(params["stem4"], x, padding="VALID")
        x = _apply_bn_conv(params["stem5"], x, padding="VALID")
        x = _max_pool(x)
        x = _apply_mixed_a(params["mixed_5b"], x)
        x = _apply_mixed_a(params["mixed_5c"], x)
        x = _apply_mixed_a(params["mixed_5d"], x)
        x = _apply_mixed_b(params["mixed_6a"], x)
        x = _apply_mixed_c(params["mixed_6b"], x)
        x = _apply_mixed_c(params["mixed_6c"], x)
        x = _apply_mixed_c(params["mixed_6d"], x)
        x = _apply_mixed_c(params["mixed_6e"], x)
        x = _apply_mixed_d(params["mixed_7a"], x)
        x = _apply_mixed_e(params["mixed_7b"], x, pool_kind="avg")
        x = _apply_mixed_e(params["mixed_7c"], x, pool_kind="max")
        return x.float().mean(dim=(2, 3))  # global average pool -> [B, 2048]


def compute_fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = activation_statistics(feats_a)
    mu2, s2 = activation_statistics(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


def compute_fid_against_stats(feats: np.ndarray, stats_npz: str) -> float:
    """FID vs a precomputed stats file (``fid_stats_mscoco256_val.npz``
    convention: arrays ``mu`` and ``sigma``)."""
    d = np.load(stats_npz)
    mu1, s1 = activation_statistics(feats)
    return frechet_distance(mu1, s1, d["mu"], d["sigma"])


def save_stats_npz(feats: np.ndarray, out_path: str):
    """Precompute a reference-statistics file from pool3 features
    (pytorch-fid's --save-stats equivalent)."""
    mu, sigma = activation_statistics(feats)
    np.savez(out_path, mu=mu, sigma=sigma)


def stats_from_image_dir(
    inception_params, image_dir: str, out_path: str, *,
    batch_size: int = 32, image_size: int = 256,
) -> str:
    """Walk a directory of images -> pool3 features -> stats npz (builds
    ``fid_stats_*`` files from a local COCO val dump)."""
    import os

    from PIL import Image

    from dreamllm_tpu_torch.eval.text2img import extract_inception_features

    paths = sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if not paths:
        raise ValueError(f"no images under {image_dir}")
    feats = []
    for i in range(0, len(paths), batch_size):
        batch = []
        for p in paths[i : i + batch_size]:
            img = Image.open(p).convert("RGB").resize((image_size, image_size))
            batch.append(np.asarray(img, np.float32) / 255.0)
        feats.append(extract_inception_features(inception_params, np.stack(batch),
                                                batch_size=batch_size))
    save_stats_npz(np.concatenate(feats), out_path)
    return out_path
