"""LLaMA/Vicuna decoder (port of ``dreamllm_tpu/models/llama.py``).

Parameters are a dict with per-layer dicts in ``params["layers"]`` (a list;
the JAX package stacks them on a leading ``L`` axis and scans). Matmul
weights keep the JAX ``[in, out]`` layout, so a projection is ``x @ W``.

The KV cache has the JAX package's static shape, ``k``/``v`` ``[L, B,
max_len, Hkv, D]`` plus per-slot ``seg``/``pos`` metadata, and is updated
IN PLACE: a forward with ``kv_cache=`` writes into the caller's buffers and
returns the same dict with ``index`` advanced. A write past ``max_len``
raises; JAX clamps it silently instead (a deliberate difference).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.ops.activations import swiglu
from dreamllm_tpu_torch.ops.attention import dot_product_attention, flash_attention
from dreamllm_tpu_torch.ops.norms import rms_norm
from dreamllm_tpu_torch.ops.rope import RopeConfig, apply_rope, rope_cos_sin

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder hyperparameters; defaults follow LLaMA/Vicuna-7B."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None  # None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling_type: str = "none"  # "none" | "linear" | "dynamic"
    rope_scaling_factor: float = 1.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32  # parameter dtype; compute follows inputs

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def rope(self) -> RopeConfig:
        return RopeConfig(
            head_dim=self.head_dim,
            base=self.rope_theta,
            scaling_type=self.rope_scaling_type,
            scaling_factor=self.rope_scaling_factor,
            max_position_embeddings=self.max_position_embeddings,
        )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, device, generator, scale=None) -> torch.Tensor:
    """Normal(0, 1) * scale (default ``fan_in ** -0.5``), drawn in float32."""
    if scale is None:
        scale = shape[0] ** -0.5
    w = torch.randn(shape, dtype=torch.float32, device=device, generator=generator)
    return (w * scale).to(dtype)


def init_llama_params(cfg: LlamaConfig, *, generator: torch.Generator | None = None,
                      device="cuda") -> Params:
    """Random init with the JAX package's fan-in scales (weights
    ``N(0, 1/fan_in)``, embeddings ``N(0, 0.02^2)``, norms 1). The draws
    differ from JAX's: parity tests bring JAX weights in through
    :func:`dreamllm_tpu_torch.bridge.from_jax` instead."""
    dev = resolve_device(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
    hq, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim

    def dense(shape, scale=None):
        return dense_init(shape, d, dev, generator, scale)

    layers = [
        {
            "input_norm": torch.ones((h,), dtype=d, device=dev),
            "post_attn_norm": torch.ones((h,), dtype=d, device=dev),
            "wq": dense((h, hq * hd)),
            "wk": dense((h, hkv * hd)),
            "wv": dense((h, hkv * hd)),
            "wo": dense((hq * hd, h)),
            "w_gate": dense((h, i)),
            "w_up": dense((h, i)),
            "w_down": dense((i, h)),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    params: Params = {
        "embed_tokens": dense((cfg.vocab_size, h), scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=d, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, *, device="cuda") -> Params:
    """Static bf16 cache, whatever the model's dtype (as in JAX): k/v
    ``[L, B, max_len, Hkv, D]``; ``seg`` (0 = empty slot) and ``pos``
    ``[B, max_len]`` int32; ``index`` the next write offset (a Python int,
    or a ``[B]`` tensor for per-row offsets). The int8 cache comes with the
    quantized slice."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "seg": torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
        "index": 0,
    }


def cache_write(buf: torch.Tensor, val: torch.Tensor, idx) -> torch.Tensor:
    """Write ``val`` ``[B, s, ...]`` into ``buf`` ``[B, S, ...]`` at offset
    ``idx`` (an int or 0-d tensor: one slot range for every row; a ``[B]``
    tensor: per-row offsets), in place. Raises if a write passes the end."""
    b, s = val.shape[:2]
    cap = buf.shape[1]
    if not torch.is_tensor(idx) or idx.ndim == 0:
        i = int(idx)
        if i < 0 or i + s > cap:
            raise IndexError(f"KV cache write [{i}, {i + s}) outside capacity {cap}")
        buf[:, i:i + s] = val.to(buf.dtype)
        return buf
    if int(idx.min()) < 0 or int(idx.max()) + s > cap:  # one host sync per call
        raise IndexError(f"KV cache write at offsets {idx.tolist()} + {s} outside capacity {cap}")
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = idx.to(buf.device).long()[:, None] + torch.arange(s, device=buf.device)[None]
    buf[rows, cols] = val.to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(layer, x, cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    q = (x @ layer["wq"]).reshape(b, s, hq, hd)
    k = (x @ layer["wk"]).reshape(b, s, hkv, hd)
    v = (x @ layer["wv"]).reshape(b, s, hkv, hd)
    q, k = apply_rope(q, k, cos, sin)

    if cache_kv is not None:
        ck, cv = cache_kv  # [B, max_len, Hkv, D] views into the stacked cache
        cache_write(ck, k, cache_meta["index"])
        cache_write(cv, v, cache_meta["index"])
        # positional-causal mask over the whole cache, built once per call
        out = dot_product_attention(q, ck.to(q.dtype), cv.to(q.dtype), bias=cache_meta["bias"])
    elif use_flash:
        out = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    else:
        out = dot_product_attention(q, k, v, causal=True, segment_ids=segment_ids)
    return out.reshape(b, s, hq * hd) @ layer["wo"]


def _decoder_layer(layer, x, cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash):
    x = x + _attention(layer, rms_norm(x, layer["input_norm"], cfg.rms_norm_eps),
                       cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash)
    y = rms_norm(x, layer["post_attn_norm"], cfg.rms_norm_eps)
    return x + swiglu(y @ layer["w_gate"], y @ layer["w_up"]) @ layer["w_down"]


def _dots_contexts():
    """Selective checkpointing that saves matmul outputs (the counterpart
    of ``jax.checkpoint_policies.dots_saveable``): elementwise work and the
    flash kernel are recomputed in the backward, the products are not."""
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.addmm.default])


def _remat_plan(remat, n_layers: int) -> list[str | None]:
    """Per layer: ``"full"``, ``"dots"`` or None (save everything)."""
    if not remat:
        return [None] * n_layers
    if remat is True or remat == "full":
        return ["full"] * n_layers
    if remat == "dots":
        return ["dots"] * n_layers
    if isinstance(remat, int) and not isinstance(remat, bool):
        if not 0 <= remat <= n_layers:
            raise ValueError(f"remat={remat} out of [0, L] range")
        return ["dots"] * (n_layers - remat) + [None] * remat
    raise ValueError(f"unknown remat policy: {remat!r}")


def llama_forward(
    params: Params,
    cfg: LlamaConfig,
    *,
    input_ids: torch.Tensor | None = None,
    inputs_embeds: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_cache: Params | None = None,
    use_flash: bool = True,
    remat: bool | str | int = False,
    output_stats: bool = False,
) -> dict:
    """Run the decoder stack.

    ``input_ids`` ``[B, S]`` or ``inputs_embeds`` ``[B, S, H]``;
    ``segment_ids`` default all-ones; ``positions`` default ``arange(S)``
    (+ the cache index when decoding). With ``kv_cache`` the new k/v go in
    at ``kv_cache["index"]`` and attention runs over the whole cache through
    the plain path with an additive bias; without it, causal attention goes
    through :func:`flash_attention` (``use_flash``) or the plain path.

    ``remat`` (cache-free forward only; it matters under autograd): True or
    ``"full"`` checkpoints every layer (``torch.utils.checkpoint``,
    non-reentrant: the backward reruns the layer, so the flash forward
    launches twice a layer); ``"dots"`` saves the layer's matmul outputs and
    recomputes the rest; an int ``k`` gives the first ``L - k`` layers
    ``"dots"`` and saves everything in the last ``k``. The JAX package's
    ``scan_unroll`` has no counterpart: the layers are a Python loop, there
    is no scan to unroll.

    ``output_stats`` adds ``layer_absmax`` ``[L]`` float32, each layer's
    largest |activation|, detached (monitoring only).

    Returns ``{"last_hidden_state", "kv_cache"}``.
    """
    if output_stats and kv_cache is not None:
        raise ValueError("output_stats is a training/monitoring feature; the decode "
                         "(kv_cache) path does not collect layer stats")
    if inputs_embeds is None:
        inputs_embeds = params["embed_tokens"][input_ids]
    x = inputs_embeds
    b, s, _ = x.shape
    dev = x.device

    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=torch.int32, device=dev)
    if positions is None:
        start = kv_cache["index"] if kv_cache is not None else 0
        ar = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if torch.is_tensor(start) and start.ndim == 1:
            positions = ar + start.to(dev, torch.int32)[:, None]
        else:
            positions = ar + int(start)

    # dynamic NTK scales from the static window: the cache capacity when
    # decoding, else this call's length (the JAX rule, not HF's)
    window = kv_cache["k"].shape[2] if kv_cache is not None else s
    cos, sin = rope_cos_sin(cfg.rope, positions, seq_len=max(window, cfg.max_position_embeddings))

    cache_meta = None
    if kv_cache is not None:
        idx = kv_cache["index"]
        seg = cache_write(kv_cache["seg"], segment_ids, idx)
        pos = cache_write(kv_cache["pos"], positions, idx)
        keep = ((pos[:, None, :] <= positions[:, :, None])
                & (seg[:, None, :] == segment_ids[:, :, None])
                & (segment_ids[:, :, None] != 0))
        bias = torch.zeros(keep.shape, dtype=torch.float32, device=dev)
        bias.masked_fill_(~keep, -1e30)
        cache_meta = {"index": idx, "bias": bias[:, None, None]}  # [B,1,1,S,max_len]

    plan = _remat_plan(remat if kv_cache is None and torch.is_grad_enabled() else False,
                       len(params["layers"]))
    stats = []
    for li, layer in enumerate(params["layers"]):
        ckv = (kv_cache["k"][li], kv_cache["v"][li]) if kv_cache is not None else None
        if plan[li] is None:
            x = _decoder_layer(layer, x, cos, sin, cfg, segment_ids, ckv, cache_meta, use_flash)
        else:
            ctx = {"context_fn": _dots_contexts} if plan[li] == "dots" else {}
            x = checkpoint(_decoder_layer, layer, x, cos, sin, cfg, segment_ids, None, None,
                           use_flash, use_reentrant=False, **ctx)
        if output_stats:
            stats.append(x.detach().abs().max().float())

    if kv_cache is not None:
        kv_cache["index"] = kv_cache["index"] + s
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    out = {"last_hidden_state": x, "kv_cache": kv_cache}
    if output_stats:
        out["layer_absmax"] = torch.stack(stats)
    return out


def llama_logits(params: Params, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head with float32 logits.

    JAX multiplies the bf16 hidden state by the bf16 head with float32
    accumulation and returns float32 logits. A bf16 ``@`` here would round
    the logits through bf16 and could flip a greedy argmax on a near-tie, so
    both operands go up to float32 first: exact products, float32 sums, the
    JAX result. The cost is a float32 copy of the head on every call (0.5 GB
    for the 7B ``[4096, 32064]`` head).
    """
    w = params.get("lm_head")
    if w is None:
        w = params["embed_tokens"].T
    return hidden.float() @ w.float()
