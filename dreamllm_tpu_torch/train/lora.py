"""LoRA adapters for the decoder (port of ``dreamllm_tpu/train/lora.py``).

A LoRA tree mirrors the port's per-layer layout of ``params["layers"]``,
with low-rank factors for each target matrix:

    lora["layers"][i]["wq"] = {"a": [in, r], "b": [r, out]}

(JAX stacks them as ``{"layers": {"wq": {"a": [L, in, r], ...}}}``;
``bridge.from_jax`` converts.) ``apply_lora`` merges ``W + a @ b * scale``
into a float base; ``attach_lora`` wraps each target in a
:class:`~dreamllm_tpu_torch.ops.quant.LoRATensor`, the unmerged form that
works over an int8/int4 base (QLoRA). ``lora_loss_fn`` closes over the
frozen base so that only the factors are differentiated.
"""

from __future__ import annotations

import dataclasses

import torch

from dreamllm_tpu_torch.ops.quant import LoRATensor

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = DEFAULT_TARGETS  # keys of each params["layers"][i]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora_params(params: dict, cfg: LoRAConfig, *,
                     generator: torch.Generator | None = None) -> dict:
    """Factors for every target of every layer: ``a`` drawn ``N(0, 1/in)``
    in float32 from ``generator``, ``b`` zero (the initial delta is 0, the
    standard LoRA init). The factors take the base's dtype where it is a
    float and train in float32 over an integer (int8/int4) base. They lie
    on the base's device. The draws differ from JAX's: parity tests bring
    JAX factors in through ``bridge.from_jax``."""
    layers = []
    for layer in params["layers"]:
        out = {}
        for t in cfg.targets:
            w = layer[t]  # a tensor, or a QTensor/Q4Tensor (QLoRA)
            din, dout = w.shape
            dt = w.dtype if w.dtype.is_floating_point else torch.float32
            dev = w.device if torch.is_tensor(w) else w.scale.device
            a = torch.randn((din, cfg.rank), dtype=torch.float32, device=dev,
                            generator=generator) * din ** -0.5
            out[t] = {"a": a.to(dt), "b": torch.zeros((cfg.rank, dout), dtype=dt, device=dev)}
        layers.append(out)
    return {"layers": layers}


def _is_quantized(w) -> bool:
    return not torch.is_tensor(w)


def apply_lora(params: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """Merge: ``W' = W + a @ b * scale`` in float32, cast back to W's dtype.
    Returns a new tree (the base is unchanged). A quantized base raises:
    merging would dequantize it; use :func:`attach_lora`."""
    for layer, factors in zip(params["layers"], lora["layers"]):
        for t in factors:
            if _is_quantized(layer[t]):
                raise TypeError(
                    f"apply_lora cannot merge into quantized weight {t!r} "
                    f"({type(layer[t]).__name__}); use attach_lora / qlora_loss_fn for a "
                    "quantized base")
    layers = []
    for layer, factors in zip(params["layers"], lora["layers"]):
        layer = dict(layer)
        for t, f in factors.items():
            delta = (f["a"].float() @ f["b"].float()) * cfg.scale
            layer[t] = (layer[t].float() + delta).to(layer[t].dtype)
        layers.append(layer)
    return {**params, "layers": layers}


def attach_lora(params: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """Wrap each target weight in a :class:`LoRATensor`: the adapter stays
    unmerged and every projection computes ``x @ base + (x @ a) @ b *
    scale`` (``ops/quant.py matmul``). Works over a quantized base, which
    keeps its int8/int4 footprint. ``scale`` is a 0-d float32 tensor on the
    factors' device."""
    layers = []
    for layer, factors in zip(params["layers"], lora["layers"]):
        layer = dict(layer)
        for t, f in factors.items():
            scale = torch.tensor(cfg.scale, dtype=torch.float32, device=f["a"].device)
            layer[t] = LoRATensor(base=layer[t], a=f["a"], b=f["b"], scale=scale)
        layers.append(layer)
    return {**params, "layers": layers}


def lora_loss_fn(base_params: dict, lora_cfg: LoRAConfig, loss_fn, merge: bool = True):
    """Wrap ``loss_fn(params, batch, rng)`` into ``fn(lora, batch, rng)``,
    which differentiates only the factors: the base is closed over, frozen
    by construction (its tensors do not require gradients).

    ``merge=False`` attaches instead of merging. A quantized base (QLoRA)
    selects attach whatever ``merge`` says."""
    quantized = any(_is_quantized(layer[t]) for layer in base_params["layers"]
                    for t in lora_cfg.targets if t in layer)

    def fn(lora, batch, rng):
        combine = apply_lora if (merge and not quantized) else attach_lora
        return loss_fn(combine(base_params, lora, lora_cfg), batch, rng)

    return fn


def qlora_loss_fn(quantized_base: dict, lora_cfg: LoRAConfig, loss_fn):
    """QLoRA: differentiate the factors over a frozen int8/int4 base;
    ``lora_loss_fn(..., merge=False)``."""
    return lora_loss_fn(quantized_base, lora_cfg, loss_fn, merge=False)
