"""Token sampling and batched text decoding with a static KV cache (port of
``dreamllm_tpu/generation/sampler.py``: ``SamplingConfig``,
``validate_sampling``, ``sample_token``, ``sample_token_per_row`` and
``generate_text``). Beam search and speculative decoding wait for ROADMAP
#15.

The random stream is an explicit ``torch.Generator``. It does not give
``jax.random``'s numbers: tests compare greedy decodes, or feed both sides
the same noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.llama import (
    LlamaConfig,
    init_kv_cache,
    llama_forward,
    llama_logits,
)
from dreamllm_tpu_torch.utils.errors import ClientError


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    greedy: bool = False
    eos_token_id: int = 2
    pad_token_id: int = 0
    # extra halt tokens; unlike EOS the stop token itself is stored
    stop_tokens: tuple[int, ...] = ()
    # single-token stop separators: treated exactly like EOS (decoding
    # halts and the token is NOT stored)
    halt_tokens: tuple[int, ...] = ()


def validate_sampling(temperature: float, top_k: int, top_p: float) -> None:
    """Reject sampling values that poison a row instead of failing loudly
    (``top_p <= 0`` masks every logit, a NaN temperature poisons the logits).
    Serving paths call this on client-controlled values. Raises
    :class:`ClientError` (a ValueError)."""
    if not math.isfinite(temperature) or temperature < 0:
        raise ClientError(f"temperature must be finite and >= 0, got {temperature}")
    if math.isnan(top_p) or not (0.0 < top_p <= 1.0):
        raise ClientError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ClientError(f"top_k must be >= 0, got {top_k}")


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 cfg: SamplingConfig) -> torch.Tensor:
    """Next token ids ``[B]`` (int32) from ``[B, V]`` logits."""
    if cfg.greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep the smallest set with cumulative prob >= top_p (always the
        # top-1); cut entries map to +inf so the min lands on the smallest
        # kept logit
        cut = (cum - probs) >= cfg.top_p
        cutoff = sorted_logits.masked_fill(cut, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_token_per_row(
    logits: torch.Tensor,        # [B, V]
    greedy: torch.Tensor,        # [B] bool
    temperature: torch.Tensor,   # [B] float32
    top_k: torch.Tensor,         # [B] int (0 = off)
    top_p: torch.Tensor,         # [B] float32 (1.0 = off)
    generators=None,             # [B] of torch.Generator | None: per-row streams
) -> torch.Tensor:
    """:func:`sample_token` with per-row sampling parameters: a greedy row
    returns its argmax; otherwise top-k cuts below the k-th largest (ties
    kept), then top-p keeps the smallest prefix of the post-top-k sorted
    distribution reaching ``top_p`` (always the top-1), as in JAX.

    Each sampled row draws from its own stream, ``generators[i]`` (the
    engine derives them from (request seed, sample index)), where JAX splits
    one key; only the sampled rows are filtered and drawn, so a greedy row
    consumes no randomness. Which rows sample is read on the host, one sync
    (JAX decides the all-greedy case with a ``lax.cond`` on the device)."""
    v = logits.shape[-1]
    greedy_tok = logits.argmax(dim=-1).to(torch.int32)
    rows = [i for i, g in enumerate(greedy.tolist()) if not g]
    if not rows:
        return greedy_tok
    if generators is None or any(generators[i] is None for i in rows):
        raise ValueError(f"sample_token_per_row: sampled rows {rows} each need a generator")
    sel = torch.tensor(rows, device=logits.device)
    l = logits[sel].float() / temperature[sel].float().clamp_min(1e-6)[:, None]
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    k = top_k[sel].long().clamp(0, v)
    k_on = (k > 0)[:, None]
    kth = sorted_l.gather(1, (k - 1).clamp_min(0)[:, None])
    lk = l.masked_fill(k_on & (l < kth), float("-inf"))
    # top-p over the post-top-k sorted values, masked by VALUE (< kth) like
    # the unsorted cut, so entries tied with the k-th largest stay in the mass
    sorted_k = sorted_l.masked_fill(k_on & (sorted_l < kth), float("-inf"))
    probs = torch.softmax(sorted_k, dim=-1)
    cum = probs.cumsum(dim=-1)
    tp = top_p[sel].float()[:, None]
    cut = (cum - probs) >= tp
    cutoff = sorted_k.masked_fill(cut, float("inf")).amin(dim=-1, keepdim=True)
    lk = lk.masked_fill((tp < 1.0) & (lk < cutoff), float("-inf"))
    p = torch.softmax(lk, dim=-1)
    drawn = torch.cat([torch.multinomial(p[j:j + 1], 1, generator=generators[i])[:, 0]
                       for j, i in enumerate(rows)])
    out = greedy_tok.clone()
    out[sel] = drawn.to(torch.int32)
    return out


def _isin(tok: torch.Tensor, ids: tuple[int, ...]) -> torch.Tensor:
    hit = torch.zeros_like(tok, dtype=torch.bool)
    for t in ids:
        hit |= tok == t
    return hit


@torch.no_grad()
def generate_text(
    params,
    llm_cfg: LlamaConfig,
    input_ids: torch.Tensor,         # [B, S] right-padded with pad_token_id
    prompt_lengths: torch.Tensor,    # [B] true prompt lengths
    cfg: SamplingConfig,
    generator: torch.Generator | None = None,
    *,
    inputs_embeds: torch.Tensor | None = None,  # optional spliced embeds [B, S, H]
    cache_dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Batched decode. Returns ``tokens`` ``[B, max_new_tokens]`` int32
    (pad-filled after EOS), ``lengths`` ``[B]`` (the exact per-row emit
    count), ``steps`` (decode steps run, an int) and the final ``kv_cache``
    — JAX's values exactly.

    The prompt may be right-padded; segment ids come from
    ``prompt_lengths``, so pad slots never take part in attention. The cache
    is static (``S + max_new_tokens`` slots, ``cache_dtype``: bf16 or
    ``torch.int8``) and every step has the same shapes. JAX runs the decode
    as a ``while_loop`` that stops on the device once every row is done;
    here it is a Python loop that reads the done flags on the host once a
    step (one sync per decoded token) to stop as early. ``generator`` drives
    sampling; it must live on ``device``, where the parameters must be.
    """
    dev = resolve_device(device)
    if params["embed_tokens"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed_tokens'].device}, not {dev}")
    b, s = input_ids.shape
    max_new = cfg.max_new_tokens
    input_ids = input_ids.to(dev).long()
    prompt_lengths = prompt_lengths.to(dev).to(torch.int32)

    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    seg = (pos < prompt_lengths[:, None]).to(torch.int32)
    positions = torch.where(seg == 1, pos, torch.zeros_like(pos))

    cache = init_kv_cache(llm_cfg, b, s + max_new, dtype=cache_dtype, device=dev)
    out = llama_forward(params, llm_cfg,
                        input_ids=None if inputs_embeds is not None else input_ids,
                        inputs_embeds=None if inputs_embeds is None else inputs_embeds.to(dev),
                        segment_ids=seg, positions=positions, kv_cache=cache)
    # logits at each row's last real token
    last_idx = (prompt_lengths.long() - 1).clamp_min(0)
    last_hidden = out["last_hidden_state"][torch.arange(b, device=dev), last_idx][:, None]
    tok = sample_token(llama_logits(params, llm_cfg, last_hidden)[:, 0], generator, cfg)

    toks = torch.full((b, max_new), cfg.pad_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    ones = torch.ones((b, 1), dtype=torch.int32, device=dev)
    steps = 0
    while steps < max_new and not bool(done.all()):
        i = steps
        out = llama_forward(params, llm_cfg, input_ids=tok[:, None].long(), segment_ids=ones,
                            positions=(prompt_lengths + i)[:, None], kv_cache=cache)
        nxt = sample_token(llama_logits(params, llm_cfg, out["last_hidden_state"])[:, 0],
                           generator, cfg)
        hit_stop = _isin(tok, cfg.stop_tokens)
        done_now = done | (tok == cfg.eos_token_id) | _isin(tok, cfg.halt_tokens)
        toks[:, i] = torch.where(done_now, torch.full_like(tok, cfg.pad_token_id), tok)
        # the exact emit count: a generated pad-id token still counts
        count += (~done_now).to(torch.int32)
        done = done_now | hit_stop  # a stop token is stored, then halts
        tok = torch.where(done, torch.full_like(nxt, cfg.eos_token_id), nxt)
        steps += 1
    # rows that halt early are fed EOS while others decode; their trailing
    # cache slots are junk (as in JAX)
    return {"tokens": toks, "lengths": count, "kv_cache": cache, "steps": steps}
