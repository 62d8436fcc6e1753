"""Weight-only int8 quantization and the projection dispatch (port of
``dreamllm_tpu/ops/quant.py``).

Scheme: symmetric per-output-channel int8, ``scale[o] = max|W[:, o]| /
127``, ``Wq = round(W / scale)``, and ``y = (x @ Wq) * scale``.

:func:`matmul` is the one projection entry of the decoder: a plain tensor,
a :class:`QTensor` (int8), a :class:`Q4Tensor` (int4, ``ops/quant4.py``
with its kernel) or a :class:`LoRATensor` (an unmerged adapter over any of
them). The int8 branch rounds as JAX does: the product in x's
dtype, then the scale cast to x's dtype before the multiply. In eager
PyTorch that writes a copy of the weight in x's dtype on every call; a
kernel that reads the int8 weight directly (ROADMAP K5) is not part of this
module.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dreamllm_tpu_torch.ops.quant4 import QUANTIZED_KEYS, Q4Tensor, matmul4


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor      # int8, the shape of the original weight [in, out]
    scale: torch.Tensor  # float32 [1, out]: one per output channel

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def dtype(self):
        return self.q.dtype

    def numel(self) -> int:
        return self.q.numel()

    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


@dataclasses.dataclass
class LoRATensor:
    """A weight with an UNMERGED low-rank adapter: ``y = x @ base + (x @ a)
    @ b * scale``. ``base`` is a plain tensor, a :class:`QTensor` or a
    :class:`Q4Tensor`: the QLoRA formulation, where the frozen base keeps
    its int8/int4 footprint and the merged weight is never materialised.
    ``scale`` (alpha / rank) is a 0-d float32 tensor, data like the factors,
    so an attached tree survives the checkpoint round trip."""

    base: Any            # tensor | QTensor | Q4Tensor, logical [in, out]
    a: torch.Tensor      # [in, r]
    b: torch.Tensor      # [r, out]
    scale: torch.Tensor  # 0-d float32

    @property
    def shape(self):
        return tuple(self.base.shape)

    @property
    def ndim(self):
        return self.base.ndim

    @property
    def dtype(self):
        return self.base.dtype

    def numel(self) -> int:
        return self.base.numel()

    def nbytes(self) -> int:
        base = (self.base.nbytes() if not torch.is_tensor(self.base)
                else self.base.numel() * self.base.element_size())
        return base + sum(t.numel() * t.element_size() for t in (self.a, self.b, self.scale))

    def to(self, device) -> "LoRATensor":
        return LoRATensor(self.base.to(device), self.a.to(device), self.b.to(device),
                          self.scale.to(device))


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric quantization over the contraction
    ('in') axis; bit-exact with the JAX package's compiled quantization."""
    wf = w.float()
    amax = wf.abs().amax(dim=w.ndim - 2, keepdim=True)
    # amax * float32(1/127), as JAX computes it under jit (see quantize_int4)
    scale = (amax * amax.new_tensor(1.0 / 127.0)).clamp_min(1e-10)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain weight, a :class:`QTensor` (int8: the product
    in x's dtype, then the per-channel scale in x's dtype), a
    :class:`Q4Tensor` (int4: ``matmul4``, with the w4a16 kernel's gate) or a
    :class:`LoRATensor` (the base's product plus the rank-r correction in
    x's dtype, as in JAX: gradients reach x and the factors, never an
    integer base)."""
    if torch.is_tensor(w):
        return x @ w
    if isinstance(w, LoRATensor):
        lo = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
        return matmul(x, w.base) + lo * w.scale.to(x.dtype)
    if isinstance(w, QTensor):
        y = x @ w.q.to(x.dtype)
        return y * w.scale.reshape((1,) * (y.ndim - 1) + (-1,)).to(x.dtype)
    if isinstance(w, Q4Tensor):
        return matmul4(x, w)
    raise TypeError(f"matmul over a {type(w).__name__} weight")


def quantize_llama_params(params: dict) -> dict:
    """int8-quantize the decoder's projections (fused layout included) and
    ``lm_head``; embeddings and norms keep their dtype."""
    out = dict(params)
    out["layers"] = [{k: quantize_int8(v) if k in QUANTIZED_KEYS else v for k, v in layer.items()}
                     for layer in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quantize_int8(params["lm_head"])
    return out
