"""Token sampling and batched text decoding with a static KV cache (port of
``dreamllm_tpu/generation/sampler.py``: ``SamplingConfig``,
``validate_sampling``, ``sample_token``, ``sample_token_per_row`` and
``generate_text``, ``beam_search`` and ``generate_text_speculative``).

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


def _cache_rows(cache: dict, rows: torch.Tensor, dim_of) -> dict:
    """``cache`` with every tensor's batch rows taken at ``rows`` (a gather,
    so rows may repeat): k/v and the int8 scales on dim 1, seg/pos on dim 0;
    the scalar index is kept."""
    return {n: (t.index_select(dim_of(n), rows) if torch.is_tensor(t) else t)
            for n, t in cache.items()}


def _batch_dim(name: str) -> int:
    return 0 if name in ("seg", "pos") else 1


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values, descending,
    and among equal values the lower index first (``torch.topk`` promises no
    order among ties; a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(
    params,
    llm_cfg: LlamaConfig,
    input_ids: torch.Tensor,         # [B, S] right-padded
    prompt_lengths: torch.Tensor,    # [B]
    *,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    eos_token_id: int = 2,
    pad_token_id: int = 0,
    halt_tokens: tuple[int, ...] = (),
    length_penalty: float = 1.0,
    inputs_embeds: torch.Tensor | None = None,
    cache_dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Batched beam search with a static KV cache of ``[L, B*K, S, ...]``.

    The prompt is prefilled once per sample and its cache tiled per beam;
    every step reorders the beams' cache rows with one gather. A finished
    beam extends only with ``pad_token_id`` at no cost; a live beam may not
    pick it. The loop stops once every beam is done (one host read a step,
    as :func:`generate_text` reads its done flags).

    Returns ``tokens`` ``[B, max_new_tokens]`` (the best beam by score /
    length ** ``length_penalty``, EOS and halt tokens stripped to pad) and
    ``scores`` ``[B]`` (that normalised score), JAX's values.
    """
    dev = resolve_device(device)
    if params["embed_tokens"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed_tokens'].device}, not {dev}")
    b, s = input_ids.shape
    k = num_beams
    input_ids = input_ids.to(dev).long()
    prompt_lengths = prompt_lengths.to(dev).to(torch.int32)
    neg = -1e9

    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    seg = (pos < prompt_lengths[:, None]).to(torch.int32)
    positions = torch.where(seg == 1, pos, torch.zeros_like(pos))

    # prefill once per sample, then tile the cache per beam
    cache = init_kv_cache(llm_cfg, b, s + max_new_tokens, dtype=cache_dtype, device=dev)
    out = llama_forward(params, llm_cfg,
                        input_ids=None if inputs_embeds is not None else input_ids,
                        inputs_embeds=None if inputs_embeds is None else inputs_embeds.to(dev),
                        segment_ids=seg, positions=positions, kv_cache=cache)
    last_idx = (prompt_lengths.long() - 1).clamp_min(0)
    last_hidden = out["last_hidden_state"][torch.arange(b, device=dev), last_idx][:, None]
    logp0 = torch.log_softmax(llama_logits(params, llm_cfg, last_hidden)[:, 0].float(), dim=-1)
    tile = torch.arange(b, device=dev).repeat_interleave(k)
    cache = _cache_rows(cache, tile, _batch_dim)
    beam_lens = prompt_lengths.repeat_interleave(k)  # [B*K]

    # the initial beams: each sample's top-k first tokens
    top_lp, top_tok = _top_k_stable(logp0, k)
    scores = top_lp.reshape(b * k)
    cur = top_tok.reshape(b * k).to(torch.int32)
    toks = torch.full((b * k, max_new_tokens), pad_token_id, dtype=torch.int32, device=dev)
    toks[:, 0] = cur

    def halted(t):
        return (t == eos_token_id) | _isin(t, halt_tokens)

    done = halted(cur)
    v = llm_cfg.vocab_size
    ones = torch.ones((b * k, 1), dtype=torch.int32, device=dev)
    base_row = torch.arange(b, device=dev)[:, None] * k
    i = 0
    while i < max_new_tokens - 1 and not bool(done.all()):
        o = llama_forward(params, llm_cfg, input_ids=cur[:, None].long(), segment_ids=ones,
                          positions=(beam_lens + i)[:, None], kv_cache=cache)
        lp = torch.log_softmax(llama_logits(params, llm_cfg, o["last_hidden_state"])[:, 0].float(),
                               dim=-1)
        lp = lp.masked_fill(done[:, None], neg)
        lp[:, pad_token_id] = torch.where(done, 0.0, neg)
        cand = (scores[:, None] + lp).reshape(b, k * v)
        new_scores, flat = _top_k_stable(cand, k)               # [B, K]
        gather_rows = (base_row + flat // v).reshape(b * k)
        cache = _cache_rows(o["kv_cache"], gather_rows, _batch_dim)
        toks, done = toks[gather_rows], done[gather_rows]
        scores = new_scores.reshape(b * k)
        nxt = (flat % v).reshape(b * k).to(torch.int32)
        toks[:, i + 1] = torch.where(done, pad_token_id, nxt)
        done = done | halted(nxt)
        cur = torch.where(done, pad_token_id, nxt).to(torch.int32)
        i += 1
    # the length-penalised best beam of each sample (score / len ** alpha)
    lengths = ((toks != pad_token_id) & (toks != eos_token_id)).sum(dim=-1)
    norm = (scores / lengths.float().clamp_min(1.0) ** length_penalty).reshape(b, k)
    best = norm.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    rows = torch.arange(b, device=dev)
    toks = toks.reshape(b, k, max_new_tokens)[rows, best]
    # eos / halt separators appear only as a beam's last stored token
    toks = torch.where(halted(toks), pad_token_id, toks)
    return {"tokens": toks, "scores": norm[rows, best]}


def lookup_draft(buf: list[int], cur_len: int, k: int, pad_token_id: int) -> list[int]:
    """Prompt-lookup draft: the ``k`` tokens after the latest earlier match
    of the bigram ``buf[cur_len-2 : cur_len]`` in ``buf[:cur_len]`` (the
    match must start before ``cur_len - 2``), or ``k`` pad tokens when
    nothing matches. ``buf`` is the working sequence of
    :func:`generate_text_speculative`, read as JAX reads it (its slice may
    run into slots past ``cur_len``)."""
    x, y = buf[max(cur_len - 2, 0)], buf[max(cur_len - 1, 0)]
    for j in range(min(cur_len - 3, len(buf) - 2), -1, -1):
        if buf[j] == x and buf[j + 1] == y:
            start = min(max(j + 2, 0), len(buf) - k)
            return buf[start:start + k]
    return [pad_token_id] * k


@torch.no_grad()
def generate_text_speculative(
    params,
    llm_cfg: LlamaConfig,
    input_ids: torch.Tensor,         # [1, S] right-padded
    prompt_lengths: torch.Tensor,    # [1]
    cfg: SamplingConfig,
    *,
    draft_len: int = 8,
    inputs_embeds: torch.Tensor | None = None,
    cache_dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Prompt-lookup speculative greedy decode (batch 1); the output equals
    greedy :func:`generate_text` token for token.

    Each verify step feeds ``[cur, d_1..d_K]`` (``K = draft_len``, drafts
    from :func:`lookup_draft`) at positions ``cur_len - 1 + arange(K + 1)``,
    takes the greedy picks g_0..g_K, accepts the longest prefix with
    ``d_i == g_{i-1}`` and emits ``a + 1`` tokens, cut at EOS or a halt
    token (not stored), after a stop token (stored) and at the budget. The
    cache write index is rewound to ``index + a + 1``: rejected rows are
    overwritten by the next window and hidden meanwhile by the positional
    mask. The picks are read on the host once a step (the drafts and the
    acceptance are host work), which is also where the loop reads its done
    flag. The cache holds ``S + max_new_tokens + K + 1`` rows, so no window
    writes past its end.

    Returns ``tokens`` ``[1, max_new_tokens]``, ``lengths`` ``[1]`` (0 when
    the first token is EOS), the ``kv_cache``, ``steps`` (verify steps),
    ``accepted`` (drafts accepted in all) and ``emitted`` (the emit cursor,
    first token included): JAX's values, as ints where JAX returns scalars.
    """
    if not cfg.greedy:
        raise ValueError("speculative decoding preserves exactness only for greedy sampling")
    b, s = input_ids.shape
    if b != 1:
        raise ValueError(f"prompt-lookup speculation is a batch-1 feature, got batch {b}")
    dev = resolve_device(device)
    if params["embed_tokens"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed_tokens'].device}, not {dev}")
    K, max_new, pad = draft_len, cfg.max_new_tokens, cfg.pad_token_id
    plen = int(prompt_lengths.reshape(-1)[0])
    ids_host = input_ids[0].tolist()
    input_ids = input_ids.to(dev).long()

    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    seg = (pos < plen).to(torch.int32)
    positions = torch.where(seg == 1, pos, torch.zeros_like(pos))
    # the dense worst case: every step writes K + 1 rows and advances one
    cache = init_kv_cache(llm_cfg, 1, s + max_new + K + 1, dtype=cache_dtype, device=dev)
    out = llama_forward(params, llm_cfg,
                        input_ids=None if inputs_embeds is not None else input_ids,
                        inputs_embeds=None if inputs_embeds is None else inputs_embeds.to(dev),
                        segment_ids=seg, positions=positions, kv_cache=cache)
    last = out["last_hidden_state"][:, max(plen - 1, 0)][:, None]
    first = int(llama_logits(params, llm_cfg, last)[0, 0].argmax())

    def is_halt(t):  # EOS and halt separators: not stored, decoding halts
        return t == cfg.eos_token_id or t in cfg.halt_tokens

    def is_stop(t):  # stop tokens: stored, then decoding halts
        return t in cfg.stop_tokens

    # the working sequence (prompt + generated): the drafts' source
    buf = ids_host + [0] * (max_new + K + 2)
    buf[plen] = first
    toks = [pad] * (max_new + K + 1)
    first_eos = is_halt(first)
    toks[0] = pad if first_eos else first
    done = first_eos or is_stop(first)
    cnt, cur, accepted, steps = 1, first, 0, 0
    seg_w = torch.ones((1, K + 1), dtype=torch.int32, device=dev)
    ar_w = torch.arange(K + 1, dtype=torch.int32)
    while cnt < max_new and not done:
        cur_len = plen + cnt
        draft = lookup_draft(buf, cur_len, K, pad)
        window = torch.tensor([[cur] + draft], dtype=torch.long).to(dev, non_blocking=True)
        index = cache["index"]
        out = llama_forward(params, llm_cfg, input_ids=window, segment_ids=seg_w,
                            positions=(cur_len - 1 + ar_w)[None].to(dev, non_blocking=True),
                            kv_cache=cache)
        g = llama_logits(params, llm_cfg, out["last_hidden_state"])[0].argmax(dim=-1).tolist()
        a = next((i for i in range(K) if draft[i] != g[i]), K)
        eos_at = next((i for i in range(a + 1) if is_halt(g[i])), K + 1)
        stop_at = next((i for i in range(a + 1) if is_stop(g[i])), K + 1)
        n_emit = min(a + 1, eos_at, stop_at + 1, max_new - cnt)
        store = [t if i < n_emit else pad for i, t in enumerate(g)]
        toks[cnt:cnt + K + 1] = store
        buf[cur_len:cur_len + K + 1] = store
        # only cur and the a accepted drafts stay in the cache
        cache["index"] = index + a + 1
        if n_emit > 0:
            cur = g[n_emit - 1]
        done = eos_at <= K or stop_at <= K or n_emit < a + 1 or n_emit == 0
        cnt += n_emit
        accepted += a
        steps += 1
    tokens = torch.tensor([toks[:max_new]], dtype=torch.int32, device=dev)
    lengths = torch.tensor([0 if first_eos else min(cnt, max_new)], dtype=torch.int32, device=dev)
    return {"tokens": tokens, "lengths": lengths, "kv_cache": cache, "steps": steps,
            "accepted": accepted, "emitted": cnt}
