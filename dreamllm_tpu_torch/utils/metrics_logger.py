"""Experiment metrics logging: wandb when available, JSONL fallback (port of
``dreamllm_tpu/utils/metrics_logger.py``).

The reference's vendored WandbCallback (omni/integrations/
integration_utils.py:127+, rewrite_logs :111-125). Without wandb the writer
degrades to a run-dir ``metrics.jsonl`` that external dashboards can tail;
the interface stays wandb-shaped. Rank 0 writes (``torch.distributed``'s
rank when a process group is initialised, else 0); values may be tensors.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from dreamllm_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger("dreamllm_tpu_torch.metrics")


def rewrite_logs(d: dict) -> dict:
    """Prefix eval_/val_ keys into sections (reference :111-125)."""
    out = {}
    for k, v in d.items():
        if k.startswith("eval_"):
            out["eval/" + k[5:]] = v
        elif k.startswith("val_"):
            out["val/" + k[4:]] = v
        else:
            out["train/" + k] = v
    return out


class MetricsLogger:
    def __init__(self, run_dir: str, project: str = "dreamllm_tpu_torch",
                 run_name: str | None = None, use_wandb: bool = True):
        self.run_dir = run_dir
        self._wandb = None
        self._file = None
        if _process_index() != 0:
            return
        os.makedirs(run_dir, exist_ok=True)
        if use_wandb:
            try:
                import wandb  # noqa: F401

                self._wandb = wandb.init(
                    project=project, name=run_name, dir=run_dir, resume="allow"
                )
            except Exception:
                self._wandb = None
        if self._wandb is None:
            self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            logger.info("wandb unavailable — logging metrics to %s/metrics.jsonl", run_dir)

    def log(self, metrics: dict[str, Any], step: int):
        if _process_index() != 0:
            return
        logs = rewrite_logs({k: _to_py(v) for k, v in metrics.items()})
        if self._wandb is not None:
            self._wandb.log(logs, step=step)
        elif self._file is not None:
            self._file.write(json.dumps({"step": step, "ts": time.time(), **logs}) + "\n")
            self._file.flush()

    def log_images(self, images: dict[str, Any], step: int):
        """Validation images: wandb.Image or PNGs under run_dir/val_images."""
        if _process_index() != 0:
            return
        if self._wandb is not None:
            import wandb

            self._wandb.log({k: wandb.Image(_np(v)) for k, v in images.items()}, step=step)
            return
        out = os.path.join(self.run_dir, "val_images")
        os.makedirs(out, exist_ok=True)
        from PIL import Image

        for k, v in images.items():
            arr = (_np(v) * 255).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(out, f"{step:06d}_{k}.png"))

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()

    # callback protocol for the Trainer
    def on_log(self, trainer, step, logs):
        self.log(logs, step)

    def on_validate(self, trainer, step, logs):
        imgs = {k: v for k, v in logs.items() if getattr(v, "ndim", 0) == 3}
        scalars = {k: v for k, v in logs.items() if k not in imgs}
        if scalars:
            self.log({f"val_{k}": v for k, v in scalars.items()}, step)
        if imgs:
            self.log_images(imgs, step)


def _to_py(v):
    if torch.is_tensor(v):
        v = v.detach().float().cpu() if v.is_floating_point() else v.detach().cpu()
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        pass
    # non-scalar metrics (per-task vectors, small arrays) must still be JSON
    # serializable in the JSONL fallback
    if hasattr(v, "tolist"):
        try:
            return v.tolist()
        except Exception:  # noqa: BLE001
            pass
    if isinstance(v, (str, int, bool, list, dict, type(None))):
        return v
    return repr(v)


def _np(v):
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)
