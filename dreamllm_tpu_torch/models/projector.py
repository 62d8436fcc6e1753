"""Projectors between vision features and the LLM embedding space (port of
``dreamllm_tpu/models/projector.py``):

* ``linear``: one dense layer (the DreamLLM-7B recipe);
* ``mlp``: dense, exact-erf GELU, ..., dense (``depth`` layers, the middle
  ones ``hidden_dim`` wide; the LLaVA and DreamLLM-SDXL recipes use depth 2);
* ``conv``: a 3x3 SAME conv with GELU over the square token grid, then dense;
* ``sam``: two stride-2 3x3 SAME convs with GELU (the grid side goes to
  ``ceil(ceil(g / 2) / 2)``), then dense.

Dense weights are ``[in, out]``; conv kernels are OIHW (the bridge turns
JAX's HWIO around) over NHWC token grids. A stride-2 SAME conv pads as XLA
does, ``(pad // 2, pad - pad // 2)``: ``(0, 1)`` at an even side, ``(1, 1)``
at an odd one, where ``F.conv2d``'s own padding would be symmetric.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.llama import dense_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    projector_type: str = "linear"  # linear | mlp | conv | sam
    in_dim: int = 1024
    out_dim: int = 4096
    depth: int = 1
    hidden_dim: int | None = None  # mlp middle width; defaults to out_dim
    dtype: torch.dtype = torch.float32


def init_projector_params(cfg: ProjectorConfig, *, generator: torch.Generator | None = None,
                          device="cuda") -> Params:
    dev = resolve_device(device)
    d = cfg.dtype

    def dense(din, dout):
        return {"w": dense_init((din, dout), d, dev, generator),
                "b": torch.zeros((dout,), dtype=d, device=dev)}

    def conv(cin, cout):
        w = dense_init((cout, cin, 3, 3), d, dev, generator, scale=(9 * cin) ** -0.5)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((cout,), dtype=d, device=dev)}

    t = cfg.projector_type
    if t == "linear":
        return {"layers": [dense(cfg.in_dim, cfg.out_dim)]}
    if t == "mlp":
        hid = cfg.hidden_dim or cfg.out_dim
        dims = [cfg.in_dim] + [hid] * (cfg.depth - 1) + [cfg.out_dim]
        return {"layers": [dense(a, b) for a, b in zip(dims[:-1], dims[1:])]}
    if t == "conv":
        return {"conv": conv(cfg.in_dim, cfg.in_dim), "proj": dense(cfg.in_dim, cfg.out_dim)}
    if t == "sam":
        return {"conv1": conv(cfg.in_dim, cfg.in_dim), "conv2": conv(cfg.in_dim, cfg.in_dim),
                "proj": dense(cfg.in_dim, cfg.out_dim)}
    raise ValueError(f"unknown projector_type {t!r}")


def _same_pad(size: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of a 3-wide window along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, p: Params, stride: int = 1) -> torch.Tensor:
    """3x3 SAME conv of an NHWC grid with an OIHW kernel."""
    ph, pw = _same_pad(x.shape[1], stride), _same_pad(x.shape[2], stride)
    y = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(y, p["w"].to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def projector_forward(params: Params, cfg: ProjectorConfig, x: torch.Tensor) -> torch.Tensor:
    """``[B, S, in_dim]`` → ``[B, S', out_dim]`` in ``x``'s dtype: ``S' = S``
    except for ``sam`` (:func:`projector_out_len`). ``conv`` and ``sam``
    need a square ``S``."""
    t = cfg.projector_type
    if t in ("linear", "mlp"):
        layers = params["layers"]
        for i, layer in enumerate(layers):
            x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
            if i + 1 < len(layers):
                x = F.gelu(x)  # exact erf, as JAX's approximate=False
        return x
    if t not in ("conv", "sam"):
        raise ValueError(f"unknown projector_type {t!r}")
    b, s, c = x.shape
    g = math.isqrt(s)
    if g * g != s:
        raise ValueError(f"conv projectors need a square token grid, got {s} tokens")
    grid = x.reshape(b, g, g, c)
    if t == "conv":
        grid = F.gelu(_conv2d(grid, params["conv"], stride=1))
    else:
        grid = F.gelu(_conv2d(grid, params["conv1"], stride=2))
        grid = F.gelu(_conv2d(grid, params["conv2"], stride=2))
    y = grid.reshape(b, -1, c)
    p = params["proj"]
    return y @ p["w"].to(y.dtype) + p["b"].to(y.dtype)


def projector_out_len(cfg: ProjectorConfig, in_len: int) -> int:
    """The output sequence length for ``in_len`` input tokens."""
    if cfg.projector_type == "sam":
        side = ((math.isqrt(in_len) + 1) // 2 + 1) // 2
        return side * side
    return in_len
