"""LLaMA/Vicuna decoder (port of ``dreamllm_tpu/models/llama.py``).

Parameters are a dict with per-layer dicts in ``params["layers"]`` (a list;
the JAX package stacks them on a leading ``L`` axis and scans). Matmul
weights keep the JAX ``[in, out]`` layout, so a projection is ``x @ W``.

The KV cache has the JAX package's static shape, ``k``/``v`` ``[L, B,
max_len, Hkv, D]`` plus per-slot ``seg``/``pos`` metadata (and, for the int8
cache, per-(slot, head) ``k_scale``/``v_scale``), and is updated IN PLACE: a
forward with ``kv_cache=`` writes into the caller's buffers and returns the
same dict with ``index`` advanced. A write past ``max_len`` raises; JAX
clamps it silently instead (a deliberate difference).

Every projection goes through :func:`dreamllm_tpu_torch.ops.quant.matmul`,
so a layer may hold plain, int8 (``QTensor``) or int4 (``Q4Tensor``)
weights, in the training layout (``wq``/``wk``/``wv``, ``w_gate``/``w_up``)
or the fused serving layout of :func:`fuse_llama_params` (``wqkv``,
``w_gate_up``).
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
from dreamllm_tpu_torch.ops.quant import QTensor
from dreamllm_tpu_torch.ops.quant import matmul as qmm
from dreamllm_tpu_torch.ops.quant4 import Q4Tensor
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


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
                  device="cuda") -> Params:
    """Static cache, whatever the model's dtype (as in JAX): k/v
    ``[L, B, max_len, Hkv, D]`` in ``dtype``; ``seg`` (0 = empty slot) and
    ``pos`` ``[B, max_len]`` int32; ``index`` the next write offset (a Python
    int, or a ``[B]`` tensor for per-row offsets).

    ``dtype=torch.int8`` stores k/v as int8 codes with per-(slot, head)
    float32 absmax scales ``k_scale``/``v_scale`` ``[L, B, max_len, Hkv]``:
    half the cache's memory and read traffic of bf16."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "seg": torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
        "index": 0,
    }
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    return cache


def check_cache_write(cap: int, idx, s: int) -> None:
    """Raise if writing ``s`` rows at offset ``idx`` (an int, a 0-d or a
    ``[B]`` tensor) passes the end of a ``cap``-row cache. A tensor offset
    costs one host sync."""
    if not torch.is_tensor(idx) or idx.ndim == 0:
        lo = hi = int(idx)
    else:
        lo, hi = torch.stack([idx.min(), idx.max()]).tolist()
    if lo < 0 or hi + s > cap:
        raise IndexError(f"KV cache write at offsets [{lo}, {hi}] + {s} outside capacity {cap}")


def cache_write(buf: torch.Tensor, val: torch.Tensor, idx) -> torch.Tensor:
    """Write ``val`` ``[B, s, ...]`` into ``buf`` ``[B, S, ...]`` at offset
    ``idx`` (an int or 0-d tensor: one slot range for every row; a ``[B]``
    tensor: per-row offsets), in place. The caller bounds the offsets first
    (:func:`check_cache_write`, once a forward in :func:`llama_forward`)."""
    b, s = val.shape[:2]
    if not torch.is_tensor(idx) or idx.ndim == 0:
        i = int(idx)
        buf[:, i:i + s] = val.to(buf.dtype)
        return buf
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = idx.to(buf.device).long()[:, None] + torch.arange(s, device=buf.device)[None]
    buf[rows, cols] = val.to(buf.dtype)
    return buf


def _kv_quantize(x: torch.Tensor):
    """``[B, S, H, D]`` -> (int8 codes, ``[B, S, H]`` float32 scales):
    per-(slot, head) absmax / 127, rounded half to even as in JAX. JAX runs
    this inside its compiled layer scan, where XLA turns the division by the
    constant into a product with float32(1/127): so does the port."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8)
    scale = scale * scale.new_tensor(1.0 / 127.0)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(layer, x, cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    if "wqkv" in layer:
        # fused serving layout (fuse_llama_params): one projection, then a split
        q, k, v = qmm(x, layer["wqkv"]).split([hq * hd, hkv * hd, hkv * hd], dim=-1)
        q, k, v = q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
    else:
        q = qmm(x, layer["wq"]).reshape(b, s, hq, hd)
        k = qmm(x, layer["wk"]).reshape(b, s, hkv, hd)
        v = qmm(x, layer["wv"]).reshape(b, s, hkv, hd)
    q, k = apply_rope(q, k, cos, sin)

    if cache_kv is not None:
        # views into the stacked cache: (k, v) or, int8, (k, v, k_scale, v_scale);
        # the offsets were checked once for the whole forward
        idx = cache_meta["index"]
        if len(cache_kv) == 4:
            ck, cv, sk, sv = cache_kv
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            for buf, val in ((ck, kq), (cv, vq), (sk, ks), (sv, vs)):
                cache_write(buf, val, idx)
            kd, vd = _kv_dequantize(ck, sk, q.dtype), _kv_dequantize(cv, sv, q.dtype)
        else:
            ck, cv = cache_kv
            cache_write(ck, k, idx)
            cache_write(cv, v, idx)
            kd, vd = ck.to(q.dtype), cv.to(q.dtype)
        # positional-causal mask over the whole cache, built once per call
        out = dot_product_attention(q, kd, vd, bias=cache_meta["bias"])
    elif use_flash:
        out = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    else:
        out = dot_product_attention(q, k, v, causal=True, segment_ids=segment_ids)
    return qmm(out.reshape(b, s, hq * hd), layer["wo"])


def _decoder_layer(layer, x, cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash):
    x = x + _attention(layer, rms_norm(x, layer["input_norm"], cfg.rms_norm_eps),
                       cos, sin, cfg, segment_ids, cache_kv, cache_meta, use_flash)
    y = rms_norm(x, layer["post_attn_norm"], cfg.rms_norm_eps)
    if "w_gate_up" in layer:
        gate, up = qmm(y, layer["w_gate_up"]).chunk(2, dim=-1)
    else:
        gate, up = qmm(y, layer["w_gate"]), qmm(y, layer["w_up"])
    return x + qmm(swiglu(gate, up), layer["w_down"])


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
        check_cache_write(kv_cache["seg"].shape[1], idx, s)  # once for every write below
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
        ckv = None
        if kv_cache is not None:
            ckv = tuple(kv_cache[n][li] for n in ("k", "v", "k_scale", "v_scale")
                        if n in kv_cache)
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


def fuse_llama_params(params: Params) -> Params:
    """Serving transform: concatenate q/k/v and gate/up so each decoder layer
    runs two fewer projections. Composes with quantization (quantize AFTER
    fusing, as the JAX package's int8 serving does)."""
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        layer["wqkv"] = torch.cat([layer.pop("wq"), layer.pop("wk"), layer.pop("wv")], dim=-1)
        layer["w_gate_up"] = torch.cat([layer.pop("w_gate"), layer.pop("w_up")], dim=-1)
        layers.append(layer)
    return {**params, "layers": layers}


def llama_logits(params: Params, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head with float32 logits.

    JAX multiplies the bf16 hidden state by the bf16 head with float32
    accumulation and returns float32 logits. A bf16 ``@`` here would round
    the logits through bf16 and could flip a greedy argmax on a near-tie, so
    both operands go up to float32 first: exact products, float32 sums, the
    JAX result. The cost is a float32 copy of the head on every call (0.5 GB
    for the 7B ``[4096, 32064]`` head).

    A quantized head (``Q4Tensor``/``QTensor``) takes the float32 hidden
    state through the projection dispatch, as in JAX: float32 in, float32
    logits out (an int4 head goes through the w4a16 kernel's function when
    its width is a multiple of 128, else through the float32 dequantize
    product).
    """
    w = params.get("lm_head")
    if w is None:
        w = params["embed_tokens"].T
    if isinstance(w, (Q4Tensor, QTensor)):
        return qmm(hidden.float(), w)
    return hidden.float() @ w.float()
