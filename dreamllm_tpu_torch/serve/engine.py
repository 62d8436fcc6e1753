"""Continuous-batching decode engine (port of ``dreamllm_tpu/serve/engine.py``,
its default path).

Requests are admitted into per-slot KV-cache lanes while the other slots
keep decoding:

  * static shapes: ``slots`` lanes of ``max_len`` cache rows; a prompt
    prefills as a host loop of ``prefill_len``-token appends into a one-lane
    cache (chunked prefill), which is then copied into a free lane;
  * per-lane int32 cache offsets (the vector ``cache_write`` of
    ``models/llama.py``): each lane fills at its own rate;
  * decode runs in chunks of ``chunk_steps`` steps over every lane at once;
    admission happens at chunk boundaries, so its latency is bounded by a
    chunk;
  * a freed lane is recycled by rewriting its seg/pos metadata at insert;
    stale K/V need no zeroing (positional masking keeps them invisible).

Where JAX compiles three programs (prefill chunk, insert, decode chunk),
the port runs the same functions eagerly on the card: a decode chunk is a
Python loop of ``chunk_steps`` forwards whose only host sync is the cache
bound check of each forward (``models/llama.py check_cache_write``). The
scheduler keeps JAX's pipeline: chunk N+1 is enqueued before chunk N's
tokens are read, which were copied to pinned host memory behind an event.

Greedy output is token-identical to ``generate_text``. A sampled request
draws each token from a ``torch.Generator`` seeded from (request seed,
sample index) only, so its output does not depend on its slot or its
co-tenants (JAX keeps the property through ``_stream_key``).

Two admission paths sit beside the token prompt:

  * the prompt-prefix KV cache (``EngineConfig.prefix_cache_entries``): an
    LRU of lane-size prefill caches keyed by the token tuple of a prompt's
    full-chunk prefix. A request whose prompt shares a chunk-aligned prefix
    with an entry starts its prefill after it (the K/V rows of a prefix do
    not depend on what follows), and stays token-identical;
  * embeddings prompts (``submit(prompt_embeds=)``): pre-spliced input
    embeddings (image features from ``multimodal_embed``) prefill through
    the same chunks and then decode as any other lane.

Per-slot speculative decoding (``speculative_k > 0``): each decode step
drafts ``k`` tokens per lane by prompt lookup (the latest earlier match of
the lane's last two tokens in its token ``history``) and verifies them in
one forward of ``1 + k`` tokens a lane. A draft is accepted only when it
equals the token the true stream samples at its position (greedy, or the
request's (seed, index) generator), so the output equals the plain
engine's. With ``speculative_adaptive`` the scheduler keeps both chunk
functions and picks one per chunk by an epsilon-greedy bandit over measured
tokens per second, keyed by the number of busy lanes. A verify window may
reach past a lane's ``max_len``: the spec engine's cache has ``k`` rows of
slack past ``max_len`` that no position reaches (JAX drops those writes;
the port's cache write raises for every other caller), and the history
drops them.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.sampler import (
    SamplingConfig,
    sample_token_per_row,
    validate_sampling,
)
from dreamllm_tpu_torch.models.llama import (
    LlamaConfig,
    init_kv_cache,
    llama_forward,
    llama_logits,
)
from dreamllm_tpu_torch.serve.batching import left_truncate_keep_bos
from dreamllm_tpu_torch.utils.errors import ClientError
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.serve.engine")

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


_M64 = (1 << 64) - 1


def stream_generator(seed: int, idx: int, device) -> torch.Generator:
    """The generator of sample ``idx`` of a request's sampling stream,
    derived from (request seed, sample index) only, so a request's sampled
    output does not depend on its slot, admission order or co-tenants. The
    pair is mixed by splitmix64, so every bit of the generator's seed
    depends on both (the CPU generator keeps only the low 32 bits)."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (idx & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    g = torch.Generator(device=device)
    g.manual_seed(z ^ (z >> 31))
    return g


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 8              # concurrent cache lanes
    prefill_len: int = 512      # tokens per prefill chunk (chunked prefill)
    max_len: int = 1024         # per-lane KV capacity (prompt + generated)
    chunk_steps: int = 8        # decode steps per scheduled chunk
    cache_dtype: str = "bfloat16"   # or "int8" (halved KV memory)
    bos_token_id: int | None = 1    # kept at position 0 when left-truncating
    # per-slot speculative decoding (0 = off): k prompt-lookup drafts a lane
    # a step, verified in one forward of 1 + k tokens; the output does not
    # change, only the speed
    speculative_k: int = 0
    # with speculative_k > 0: keep the plain chunk function too and pick one
    # per chunk from measured tokens/s a busy-lane count (an epsilon-greedy
    # bandit); False always drafts
    speculative_adaptive: bool = True
    # per-lane capacity for single-token stop separators: each request may
    # pass up to this many stop_token_ids; they halt the lane WITHOUT being
    # emitted (EOS semantics)
    max_stop_tokens: int = 4
    # LRU prompt-prefix KV cache (0 = off). Requests sharing a token-exact
    # prefix of >= prefill_len tokens (a chat system prompt, a few-shot
    # header) skip the prefill of the cached full chunks. Each entry holds
    # one lane-size KV copy on the card (7B bf16 at max_len 1024: 0.5 GiB),
    # so size it to the number of distinct system prompts.
    prefix_cache_entries: int = 0


# ---------------------------------------------------------------------------
# Device functions of the state
# ---------------------------------------------------------------------------


def init_engine_state(llm_cfg: LlamaConfig, ecfg: EngineConfig, *, device="cuda") -> dict:
    dev = resolve_device(device)
    s = ecfg.slots
    # a verify window writes 1 + k rows from a lane's offset (at most
    # max_len - 1): k rows of slack take what passes max_len; no position
    # reaches them, so they stay masked
    cache = init_kv_cache(llm_cfg, s, ecfg.max_len + ecfg.speculative_k,
                          dtype=_CACHE_DTYPES[ecfg.cache_dtype], device=dev)
    cache["index"] = torch.zeros((s,), dtype=torch.int32, device=dev)  # per-lane offsets
    extra = {}
    if ecfg.speculative_k:
        # per-lane token history aligned with cache positions (prompt ids at
        # insert, decoded tokens as they are stored): the drafts' source
        extra["history"] = torch.zeros((s, ecfg.max_len), dtype=torch.int32, device=dev)
    return {
        **extra,
        "cache": cache,
        "cur_tok": torch.zeros((s,), dtype=torch.int32, device=dev),
        "active": torch.zeros((s,), dtype=torch.bool, device=dev),
        # per-slot single-token stop set (-1 = empty; never a token id)
        "halt": torch.full((s, ecfg.max_stop_tokens), -1, dtype=torch.int32, device=dev),
        "emitted": torch.zeros((s,), dtype=torch.int32, device=dev),
        "budget": torch.zeros((s,), dtype=torch.int32, device=dev),
        # per-slot sampling parameters (insert sets the real values)
        "greedy": torch.ones((s,), dtype=torch.bool, device=dev),
        "temperature": torch.ones((s,), dtype=torch.float32, device=dev),
        "top_k": torch.zeros((s,), dtype=torch.int32, device=dev),
        "top_p": torch.ones((s,), dtype=torch.float32, device=dev),
    }


def make_engine_fns(llm_cfg: LlamaConfig, scfg: SamplingConfig, ecfg: EngineConfig, *,
                    device="cuda"):
    """Build ``(prefill_chunk_fn, insert_fn, decode_chunk_fn)``, the
    counterparts of JAX's compiled programs, as eager functions that update
    the state in place. ``prefill_chunk_fn.embeds`` is the embeddings-prompt
    twin of the prefill (JAX's ``prefill_embeds_chunk_fn``). With
    ``speculative_k`` the decode function is the speculative one, carrying
    the plain one as ``.plain`` when ``speculative_adaptive``."""
    P, S, K = ecfg.prefill_len, ecfg.max_len, ecfg.chunk_steps
    if S % P != 0:
        # the final prefill chunk writes a full P-row slice at its start
        raise ValueError(f"max_len ({S}) must be a multiple of prefill_len ({P})")
    dev = resolve_device(device)
    cache_dtype = _CACHE_DTYPES[ecfg.cache_dtype]
    lane_names = ("k", "v", "k_scale", "v_scale")
    arange_p = torch.arange(P, dtype=torch.int32, device=dev)[None]
    arange_s = torch.arange(S, dtype=torch.int32, device=dev)
    pre: dict = {}

    def empty_prefill_cache():
        """The one-lane prefill cache, lane-sized so its rows copy straight
        into an engine lane. One buffer serves every admission: its seg/pos
        are cleared here, its stale K/V stay masked; reuse is ordered after
        the previous insert's copy on the stream."""
        if not pre:
            pre.update(init_kv_cache(llm_cfg, 1, S, dtype=cache_dtype, device=dev))
        pre["seg"].zero_()
        pre["pos"].zero_()
        pre["index"] = 0
        return pre

    def _first_token(logits, samp):
        if samp["greedy"]:
            return logits.argmax(dim=-1).to(torch.int32)
        gen = stream_generator(samp["seed"], 0, dev)  # sample index 0 of the stream
        return sample_token_per_row(
            logits, torch.zeros((1,), dtype=torch.bool, device=dev),
            torch.full((1,), samp["temperature"], device=dev),
            torch.full((1,), samp["top_k"], device=dev),
            torch.full((1,), samp["top_p"], device=dev), [gen])

    def _prefill(params, cache, clen: int, start: int, samp, **inp):
        seg = (arange_p < clen).to(torch.int32)
        cache["index"] = start
        out = llama_forward(params, llm_cfg, segment_ids=seg,
                            positions=torch.where(seg == 1, arange_p + start, 0), kv_cache=cache,
                            **inp)
        last = out["last_hidden_state"][:, max(clen - 1, 0)][:, None]
        return out["kv_cache"], _first_token(llama_logits(params, llm_cfg, last)[:, 0], samp)

    def prefill_chunk_fn(params, cache, ids, clen: int, start: int, samp):
        """Append ONE P-token chunk (right-padded, ``clen`` real) at offset
        ``start``. Returns (cache, first token ``[1]``), the token meaningful
        only on the final chunk."""
        return _prefill(params, cache, clen, start, samp, input_ids=ids)

    def prefill_embeds_chunk_fn(params, cache, embeds, clen: int, start: int, samp):
        """:func:`prefill_chunk_fn` for a chunk of input embeddings ``[1, P,
        H]`` (zero-padded): a multimodal prompt's spliced embeddings prefill
        through the same lanes; decode after it is token-driven."""
        return _prefill(params, cache, clen, start, samp,
                        inputs_embeds=embeds.to(llm_cfg.dtype))

    def insert_fn(state, pre_cache, plen: int, slot: int, first_tok, budget: int, samp, halt,
                  lane_ids=None):
        """Claim lane ``slot``: copy the prefilled K/V, reset the lane's
        metadata and its per-request sampling parameters. ``lane_ids``
        (``[max_len]`` int32, the prompt ids zero-padded) seeds the lane's
        token history when the engine speculates; None leaves zeros (an
        embeddings prompt drafts from its generated tokens only)."""
        cache = state["cache"]
        for name in lane_names:
            if name in cache:
                cache[name][:, slot, :S] = pre_cache[name][:, 0]
        lane_seg = (arange_s < plen).to(torch.int32)
        cache["seg"][slot] = 0  # the slack rows past max_len too
        cache["seg"][slot, :S] = lane_seg
        cache["pos"][slot, :S] = torch.where(lane_seg == 1, arange_s, 0)
        cache["index"][slot] = plen
        if "history" in state:
            state["history"][slot] = 0 if lane_ids is None else lane_ids
        state["halt"][slot] = halt
        first = first_tok.reshape(()).to(torch.int32)
        eos_now = (first == scfg.eos_token_id) | (first == halt).any()
        state["cur_tok"][slot] = first
        state["active"][slot] = ~eos_now & (budget > 0)
        state["emitted"][slot] = 0
        state["budget"][slot] = budget
        for name in ("greedy", "temperature", "top_k", "top_p"):
            state[name][slot] = samp[name]
        return state

    def generators(row_seeds, emitted, offsets):
        """Per row, the generator of the sample it draws now, or None: lane
        i's rows draw samples ``emitted[i] + o`` (``o`` in ``offsets``) of
        its request's stream. ``emitted`` is read on the card, once."""
        e = emitted.tolist()
        return [None if seed is None else stream_generator(seed, e[i] + o, dev)
                for i, seed in enumerate(row_seeds) for o in offsets]

    def decode_chunk_fn(params, state, row_seeds=None):
        """K decode steps over every lane. Returns ``(state, tokens [B, K],
        valid [B, K], active [B] int32)``; the state is updated in place.

        The step semantics are ``generate_text``'s: the carried token is
        STORED this step and the sampled token becomes the next carry.
        ``row_seeds``: None when every active lane is greedy (argmax, no
        sort), else per lane the request's seed or None. A lane's token
        sampled now is sample ``emitted`` (after this step's count) of its
        stream, as in JAX: the index is read on the card at each step, so it
        holds whichever chunk function ran before."""
        cache = state["cache"]
        cur, active = state["cur_tok"], state["active"]
        emitted, budget = state["emitted"], state["budget"]
        hist = state.get("history")
        emits, valids = [], []
        for j in range(K):
            idx0 = cache["index"]
            gens = None if row_seeds is None else generators(row_seeds, emitted, (1,))
            # a lane that filled its cache sits at S and is inactive: its
            # (masked, seg 0) write goes to the last row instead
            widx = torch.where(active, idx0, idx0.clamp_max(S - 1))
            cache["index"] = widx
            out = llama_forward(params, llm_cfg, input_ids=cur[:, None].long(),
                                segment_ids=active[:, None].to(torch.int32),
                                positions=widx[:, None], kv_cache=cache)
            cache["index"] = torch.where(active, idx0 + 1, idx0)
            logits = llama_logits(params, llm_cfg, out["last_hidden_state"])[:, 0]
            emitted = emitted + active.to(torch.int32)
            if gens is None:
                nxt = logits.argmax(dim=-1).to(torch.int32)
            else:
                # inactive lanes count as greedy: their token is never emitted
                nxt = sample_token_per_row(logits, state["greedy"] | ~active,
                                           state["temperature"], state["top_k"],
                                           state["top_p"], gens)
            emit = torch.where(active, cur, scfg.pad_token_id)
            if hist is not None:
                # keep the drafts' source aligned with the cache across mode
                # switches: position idx0 holds the token written there now
                hist = torch.where(active[:, None] & (arange_s[None] == idx0[:, None]),
                                   cur[:, None], hist)
            hit_stop = torch.zeros_like(active)
            for t in scfg.stop_tokens:
                hit_stop |= emit == t
            valids.append(active)
            emits.append(emit)
            hit_halt = (nxt[:, None] == state["halt"]).any(dim=1)
            active = (active & (nxt != scfg.eos_token_id) & ~hit_halt & ~hit_stop
                      & (emitted < budget) & (cache["index"] < S))
            cur = nxt
        state.update(cur_tok=cur, active=active, emitted=emitted)
        if hist is not None:
            state["history"] = hist
        # routing goes by the validity mask, not by the pad id: a generated
        # pad-id token (<unk> is id 0 in LLaMA vocabs) stays in the stream
        return (state, torch.stack(emits, dim=1), torch.stack(valids, dim=1),
                active.to(torch.int32))

    k = ecfg.speculative_k
    W = 1 + k  # verify window: the carried token and k drafts
    arange_w = torch.arange(W, dtype=torch.int32, device=dev)
    arange_k = torch.arange(k, dtype=torch.int32, device=dev)

    def decode_spec_chunk_fn(params, state, row_seeds=None):
        """K speculative decode steps over every lane. Returns ``(state,
        tokens [B, K*(1+k)], valid [B, K*(1+k)], active [B] int32)``, the
        rows chunk-ordered per lane; the state is updated in place.

        Each step drafts ``k`` tokens a lane from its history (the latest
        match of ``(prev, cur)`` strictly before ``index - 1``), verifies
        ``[cur, d_1..d_k]`` in one forward, samples the true stream at every
        window position (position i draws sample ``emitted + 1 + i``, the
        index read on the card) and accepts drafts while they equal it, with
        the plain step's stop rules applied at every stored token. Rows of
        the window past the accepted prefix stay in the cache, hidden by
        their positions until the next window overwrites them."""
        cache = state["cache"]
        cur, active = state["cur_tok"], state["active"]
        emitted, budget, hist = state["emitted"], state["budget"], state["history"]
        halt = state["halt"]
        b = cur.shape[0]
        rows = torch.arange(b, device=dev)[:, None]
        toks, valids = [], []
        for _ in range(K):
            idx0 = cache["index"]
            # draft: the latest 2-gram (prev, cur) match in the history
            prev = hist.gather(1, (idx0.long() - 1).clamp_min(0)[:, None])[:, 0]
            hist_prev = torch.nn.functional.pad(hist[:, :-1], (1, 0))
            cand = ((hist == cur[:, None]) & (hist_prev == prev[:, None])
                    & (arange_s[None] >= 1) & (arange_s[None] < idx0[:, None] - 1))
            jstar = torch.where(cand, arange_s[None], -1).amax(dim=1)
            start = torch.where(jstar >= 0, jstar + 1, 0)
            drafts = hist.gather(1, (start[:, None] + arange_k[None]).clamp(0, S - 1).long())
            qtok = torch.cat([cur[:, None], drafts], dim=1)  # [B, W]

            gens = None if row_seeds is None else generators(row_seeds, emitted,
                                                             range(1, W + 1))
            pos = idx0[:, None] + arange_w[None]
            # a finished lane sits at max_len: its (seg 0) window goes one row lower
            cache["index"] = torch.where(active, idx0, idx0.clamp_max(S - 1))
            out = llama_forward(params, llm_cfg, input_ids=qtok.long(),
                                segment_ids=active[:, None].expand(b, W).to(torch.int32),
                                positions=pos, kv_cache=cache)
            logits = llama_logits(params, llm_cfg, out["last_hidden_state"])  # [B, W, V]
            if gens is None:
                sampled = logits.argmax(dim=-1).to(torch.int32)
            else:
                sampled = sample_token_per_row(
                    logits.reshape(b * W, -1), (state["greedy"] | ~active).repeat_interleave(W),
                    state["temperature"].repeat_interleave(W), state["top_k"].repeat_interleave(W),
                    state["top_p"].repeat_interleave(W), gens).reshape(b, W)

            # the sequential accept/emit rule, unrolled over the window: `live`
            # = the lane is active and this position is on the true path;
            # `lane_active` = what the lane carries out, set by the last
            # reached position's continuation checks (the plain step's)
            live, lane_active, emit_cnt = active, active, emitted
            masks = []
            for j in range(W):
                masks.append(live)
                emit_cnt = emit_cnt + live.to(torch.int32)
                cj, nxt_j = qtok[:, j], sampled[:, j]
                hit_stop = torch.zeros_like(live)
                for t in scfg.stop_tokens:
                    hit_stop = hit_stop | (cj == t)
                cont = ((nxt_j != scfg.eos_token_id) & ~(nxt_j[:, None] == halt).any(dim=1)
                        & ~hit_stop & (emit_cnt < budget) & (idx0 + j + 1 < S))
                lane_active = torch.where(live, cont, lane_active)
                if j < k:
                    live = live & cont & (nxt_j == drafts[:, j])
            adv = emit_cnt - emitted  # tokens stored this step (0 if inactive)
            cur = sampled.gather(1, (adv.long() - 1).clamp_min(0)[:, None])[:, 0]
            cache["index"] = idx0 + adv
            # the whole window goes into the history (rows past the accepted
            # prefix are overwritten later, and drafting reads only below
            # index - 1); positions past max_len are dropped
            wide = torch.nn.functional.pad(hist, (0, W))
            wide[rows, pos.long()] = qtok
            hist = wide[:, :S]
            active, emitted = lane_active, emit_cnt
            toks.append(qtok)
            valids.append(torch.stack(masks, dim=1))
        state.update(cur_tok=cur, active=active, emitted=emitted, history=hist)
        return (state, torch.cat(toks, dim=1), torch.cat(valids, dim=1),
                active.to(torch.int32))

    prefill_chunk_fn.empty_cache = empty_prefill_cache
    prefill_chunk_fn.embeds = prefill_embeds_chunk_fn
    if k:
        if ecfg.speculative_adaptive:
            decode_spec_chunk_fn.plain = decode_chunk_fn  # both share the state
        return prefill_chunk_fn, insert_fn, decode_spec_chunk_fn
    return prefill_chunk_fn, insert_fn, decode_chunk_fn


def _clone_cache(cache: dict) -> dict:
    """A copy of a prefill cache's tensors (``index`` is set per chunk)."""
    return {name: t.clone() for name, t in cache.items() if torch.is_tensor(t)}


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


class _Request:
    __slots__ = ("ids", "embeds", "max_new_tokens", "tokens", "done", "slot", "stream", "error",
                 "chunk_joined", "chunk_last", "samp", "abandoned", "stop_ids", "stop_fn")

    def __init__(self, ids, max_new_tokens, stream=None, samp=None, embeds=None, stop_ids=(),
                 stop_fn=None):
        self.ids = ids
        self.embeds = embeds  # [S, H] on the engine's device, or None (an ids prompt)
        self.abandoned = False  # submitter timed out; skip at admission
        self.stop_ids = tuple(stop_ids)  # single-token stops (device-side)
        # host-side stop predicate over the accumulated ids, checked at
        # chunk boundaries
        self.stop_fn = stop_fn
        self.max_new_tokens = max_new_tokens
        self.samp = samp  # per-request sampling params (host floats/ints)
        self.tokens: list[int] = []
        self.done = threading.Event()
        self.slot = -1
        self.stream = stream  # optional per-token callback
        self.error: Exception | None = None
        # the first decode chunk whose results include this request; results
        # of EARLIER chunks on a recycled lane belong to its predecessor
        self.chunk_joined = -1
        # the last chunk that can emit for it (at most chunk_steps a chunk):
        # after it is dispatched the lane is certainly inactive
        self.chunk_last = -1


def _to_host(tensors):
    """Start copying ``tensors`` to the host behind the work already
    enqueued; returns (host tensors, event or None). On the card the copies
    go to pinned memory without blocking, and the event marks when they
    are complete; on the CPU the tensors are returned as they are."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class ContinuousBatchingEngine:
    """Slot-scheduled decode: submit token prompts, receive generated ids.

    ``submit()`` is thread-safe and blocking (or pass ``stream`` for a
    per-token callback). The engine thread admits waiting requests into free
    lanes at every chunk boundary while busy lanes keep decoding. The
    parameters must be on ``device``.
    """

    def __init__(self, params, llm_cfg: LlamaConfig, scfg: SamplingConfig,
                 ecfg: EngineConfig | None = None, *, device="cuda"):
        self.device = resolve_device(device)
        if params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"parameters are on {params['embed_tokens'].device}, "
                             f"not {self.device}")
        self.params = params
        self.llm_cfg = llm_cfg
        self.scfg = scfg
        self.ecfg = ecfg or EngineConfig()
        self.prefill_fn, self.insert_fn, self.decode_chunk_fn = make_engine_fns(
            llm_cfg, scfg, self.ecfg, device=self.device)
        # adaptive speculation: the plain chunk function beside the drafting
        # one, and the bandit's tokens/s EMAs per (mode, busy lanes)
        self.decode_plain_fn = getattr(self.decode_chunk_fn, "plain", None)
        self._mode_ema: dict[tuple[str, int], float] = {}
        self._mode_seen: dict[tuple[str, int], int] = {}
        self._mode_picks: dict[int, int] = {}  # picks per busy-lane count
        self._last_fetch_t: float | None = None
        self.spec_chunks = 0
        self.plain_chunks = 0
        self.state = init_engine_state(llm_cfg, self.ecfg, device=self.device)
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._by_slot: dict[int, _Request] = {}
        # requests whose lane was retired early (budget certainly exhausted
        # in dispatched chunks) but whose final tokens are still in the
        # un-fetched pending chunk
        self._retired: list[_Request] = []
        self._free = list(range(self.ecfg.slots))
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._submit_lock = threading.Lock()  # serializes submit vs stop drain
        # `admissions` counts lane registrations; tests and load tools wait
        # on it instead of polling _by_slot
        self._adm_cond = threading.Condition()
        self.admissions = 0
        self.chunks_dispatched = 0
        self.decode_steps = 0  # decode forwards run, warmup included
        self.active_history: deque[int] = deque(maxlen=4096)
        self._admit_count = 0
        # prompt-prefix KV cache: token tuple -> lane-size copy of the
        # prefill cache after that prefix (scheduler thread only). Entries
        # are clones: the shared prefill buffer that later prompts fill
        # never aliases one.
        self._prefix_cache: OrderedDict[tuple, dict] = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0

    # -- public API --------------------------------------------------------

    def start(self) -> "ContinuousBatchingEngine":
        if self._thread is not None and self._thread.is_alive():
            return self  # already running
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @torch.no_grad()
    def warmup(self, embeds: bool = False) -> "ContinuousBatchingEngine":
        """Run each function once on scratch / idle state before serving, so
        that the first request does not pay one-time costs (the kernels'
        build at their first launch, the allocator's first blocks) while
        live lanes wait; with the prefix cache, one entry's copy as well,
        with ``embeds`` the embeddings prefill, and with adaptive
        speculation both chunk functions. Lane 0 is inserted with budget 0,
        i.e. inactive. Must run before :meth:`start`."""
        if self.running:
            raise RuntimeError("warmup() must run before start()")
        samp = {"greedy": True, "temperature": 1.0, "top_k": 0, "top_p": 1.0, "seed": 0}
        P = self.ecfg.prefill_len
        if embeds:
            emb = torch.zeros((1, P, self.llm_cfg.hidden_size), dtype=self.llm_cfg.dtype,
                              device=self.device)
            self.prefill_fn.embeds(self.params, self.prefill_fn.empty_cache(), emb, 1, 0, samp)
        ids = torch.zeros((1, P), dtype=torch.long, device=self.device)
        pre, first = self.prefill_fn(self.params, self.prefill_fn.empty_cache(), ids, 1, 0, samp)
        if self.ecfg.prefix_cache_entries:
            # the allocation of an entry's copy, before serving
            _clone_cache(pre)
        halt = torch.full((self.ecfg.max_stop_tokens,), -1, dtype=torch.int32, device=self.device)
        self.state = self.insert_fn(self.state, pre, 1, 0, first, 0, samp, halt)
        for fn in (self.decode_chunk_fn, self.decode_plain_fn):
            if fn is not None:
                out = fn(self.params, self.state)
                self.decode_steps += self.ecfg.chunk_steps
                self.state = out[0]
        self._deactivate(torch.zeros_like(self.state["active"]))
        out[3].cpu()  # completes the work
        return self

    def wait_for_admissions(self, n: int, timeout: float | None = None) -> bool:
        """Block until ``n`` lane registrations have happened since
        construction. Returns False on timeout."""
        with self._adm_cond:
            return self._adm_cond.wait_for(lambda: self.admissions >= n, timeout)

    def stop(self) -> None:
        """Stop the loop and fail anything not finished.

        - queued-but-not-admitted requests fail with "engine stopped";
        - in-flight (admitted) requests fail with "engine stopped" and their
          lanes are deactivated once the scheduler has exited;
        - a request whose admission raced stop() (popped from the queue, not
          yet registered) is failed by ``_admit``'s registration check,
          which also deactivates the lane its insert just activated."""
        with self._submit_lock:
            self._stopped = True
        self._queue.put(None)
        t = self._thread
        if t:
            t.join(timeout=30)
            if not t.is_alive():
                self._thread = None
        exc = RuntimeError("engine stopped")
        # the sweep shares _submit_lock with _admit's registration: a live
        # scheduler (timed-out join) cannot register a request behind it
        swept_any = False
        with self._submit_lock:
            for slot in list(self._by_slot):
                req = self._by_slot.pop(slot, None)
                if req is None:
                    continue
                swept_any = True
                req.error = exc
                req.done.set()
            # rebuild rather than append per slot: a racing _finish may have
            # freed a slot already, and a duplicate entry would admit two
            # requests into the same lane after a restart
            self._free = [s for s in range(self.ecfg.slots) if s not in self._by_slot]
            for req in self._retired:
                swept_any = True
                req.error = exc
                req.done.set()
            self._retired = []
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    req.error = exc
                    req.done.set()
        # swept lanes are still active on the card: after stop()+start()
        # they would decode as zombies. Deactivate them, but only once the
        # scheduler thread has really exited (it may be mid-dispatch).
        if swept_any and self._thread is None:
            try:
                self._deactivate(torch.ones_like(self.state["active"]))
            except Exception:
                logger.exception("post-stop lane deactivation failed")

    def submit(
        self,
        prompt_ids: list[int] | None = None,
        max_new_tokens: int = 128,
        timeout: float | None = 600.0,
        stream: Callable[[int], None] | None = None,
        greedy: bool | None = None,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        prompt_embeds=None,
        seed: int | None = None,
        stop_token_ids=(),
        stop_fn=None,
    ) -> list[int]:
        """Block until the request finishes; returns the generated token ids
        (EOS excluded). Prompts prefill in chunks; one longer than the lane
        (``max_len - 1``) is truncated from the LEFT, BOS kept.

        ``prompt_embeds`` (``[S, H]``, a tensor or an array, instead of
        ``prompt_ids``) serves a multimodal prompt: embeddings spliced by
        ``multimodal_embed`` prefill through the embeddings chunks and then
        decode as any other lane. They are cast to the model's dtype, moved
        to the engine's device, never truncated (a prompt longer than the
        lane raises :class:`ClientError`) and bypass the prefix cache.

        ``greedy``/``temperature``/``top_k``/``top_p`` override the engine's
        SamplingConfig for this request only; passing any of the last three
        implies ``greedy=False`` unless ``greedy`` is given. ``seed`` pins
        the request's sampling stream (None: a per-admission seed).
        ``stop_token_ids`` (up to ``EngineConfig.max_stop_tokens``) halt the
        lane without emitting the token; ``stop_fn`` is a host predicate
        over the accumulated ids, checked at chunk boundaries. An error of
        the engine's thread (a kernel that fails, say) is raised here."""
        s = self.scfg
        if greedy is None:
            greedy = s.greedy if temperature is None and top_k is None and top_p is None else False
        samp = {
            "greedy": bool(greedy),
            "temperature": float(s.temperature if temperature is None else temperature),
            "top_k": int(s.top_k if top_k is None else top_k),
            "top_p": float(s.top_p if top_p is None else top_p),
            "seed": None if seed is None else int(seed) & 0xFFFFFFFF,
        }
        validate_sampling(samp["temperature"], samp["top_k"], samp["top_p"])
        if prompt_embeds is not None:
            if prompt_ids is not None:
                raise ValueError("pass prompt_ids OR prompt_embeds, not both")
            embeds = (prompt_embeds if torch.is_tensor(prompt_embeds)
                      else torch.as_tensor(np.asarray(prompt_embeds)))
            if embeds.ndim != 2 or embeds.shape[0] < 1:
                raise ClientError(f"prompt_embeds must be [S>=1, H], got {tuple(embeds.shape)}")
            if embeds.shape[1] != self.llm_cfg.hidden_size:
                raise ClientError(f"prompt_embeds hidden dim {embeds.shape[1]} != model "
                                  f"hidden_size {self.llm_cfg.hidden_size}")
            if embeds.shape[0] > self.ecfg.max_len - 1:
                # an ids prompt left-truncates, but an embeddings prompt's spans
                # (image patches) are opaque here: a cut could halve an image
                raise ClientError(f"prompt_embeds length {embeds.shape[0]} exceeds the lane "
                                  f"capacity {self.ecfg.max_len - 1}; shorten the prompt "
                                  "(embeddings prompts are not truncated)")
            embeds = embeds.to(device=self.device, dtype=self.llm_cfg.dtype)
            req = _Request([], max_new_tokens, stream, samp, embeds=embeds,
                           stop_ids=stop_token_ids, stop_fn=stop_fn)
        else:
            req = _Request(list(prompt_ids or []), max_new_tokens, stream, samp,
                           stop_ids=stop_token_ids, stop_fn=stop_fn)
            if not req.ids:
                raise ClientError("empty prompt (prepend a BOS token)")
        if len(req.stop_ids) > self.ecfg.max_stop_tokens:
            raise ClientError(f"{len(req.stop_ids)} stop_token_ids exceed the engine's "
                              f"max_stop_tokens={self.ecfg.max_stop_tokens}")
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
            self._queue.put(req)
        if not req.done.wait(timeout):
            # best-effort cancel: a still-queued request is skipped at admission
            req.abandoned = True
            raise TimeoutError("engine request timed out")
        if req.error is not None:
            raise req.error
        return req.tokens

    # -- engine loop ---------------------------------------------------------

    def _deactivate(self, mask: torch.Tensor) -> None:
        """Host-initiated lane stop: clear ``active`` and the budget where
        ``mask`` is set."""
        self.state["active"] &= ~mask
        self.state["budget"].masked_fill_(mask, 0)

    def _prefix_lookup(self, ids: list[int], store_at: int, pre_cache: dict) -> int:
        """The longest chunk-aligned prefix of ``ids`` (at most ``store_at``
        tokens) that an entry holds: that entry is copied into
        ``pre_cache``, marked recently used, and its length returned (0 on a
        miss). An entry stored for a LONGER prefix serves any chunk-aligned
        prefix of itself: its rows past the match are overwritten by this
        prompt's remaining chunks or masked (later positions, and the
        lane's seg metadata at insert)."""
        P = self.ecfg.prefill_len
        best_k, best_key = 0, None
        for key in self._prefix_cache:
            for k in range(min(len(key), store_at) // P, best_k, -1):
                if tuple(ids[:k * P]) == key[:k * P]:
                    best_k, best_key = k, key
                    break
        if not best_k:
            self.prefix_misses += 1
            return 0
        self._prefix_cache.move_to_end(best_key)
        for name, t in self._prefix_cache[best_key].items():
            pre_cache[name].copy_(t)
        self.prefix_hits += 1
        return best_k * P

    def _prefix_store(self, ids: list[int], store_at: int, pre_cache: dict) -> None:
        """Store a clone of the prefill cache after ``ids[:store_at]``,
        unless an entry already covers it; a new entry drops the shorter
        entries it covers, and the least recently used go past the cap."""
        key = tuple(ids[:store_at])
        if any(len(k) >= store_at and k[:store_at] == key for k in self._prefix_cache):
            return
        for k in [k for k in self._prefix_cache if len(k) < store_at and key[:len(k)] == k]:
            del self._prefix_cache[k]
        self._prefix_cache[key] = _clone_cache(pre_cache)
        while len(self._prefix_cache) > self.ecfg.prefix_cache_entries:
            self._prefix_cache.popitem(last=False)

    def _admit(self, req: _Request) -> None:
        P = self.ecfg.prefill_len
        emb = req.embeds
        if emb is not None:
            ids, plen = [], emb.shape[0]  # overlong embeddings were refused at submit
        else:
            # the lane must hold prompt + at least one generated token
            ids = left_truncate_keep_bos(req.ids, self.ecfg.max_len - 1, self.ecfg.bos_token_id)
            plen = len(ids)
        self._admit_count += 1
        samp = dict(req.samp)
        if samp["seed"] is None:
            # a per-admission stream: identical unseeded sampled prompts
            # should not give identical outputs
            samp["seed"] = self._admit_count
        # the prefix cache: the K/V rows of a prefix do not depend on the
        # request's sampling (which only picks `first` from the final chunk,
        # always run), so reusing them is exact. Embeddings prompts bypass
        # it (keys are token tuples); so do prompts without one full chunk
        # before their last token.
        store_at = ((plen - 1) // P) * P if self.ecfg.prefix_cache_entries and emb is None else 0
        pre_cache = self.prefill_fn.empty_cache()
        start0 = self._prefix_lookup(ids, store_at, pre_cache) if store_at else 0
        first = None
        ids_t = torch.tensor(ids, dtype=torch.long)
        for start in range(start0, plen, P):
            if store_at and start == store_at:
                self._prefix_store(ids, store_at, pre_cache)
            clen = min(P, plen - start)
            if emb is not None:
                chunk = torch.zeros((1, P, emb.shape[1]), dtype=emb.dtype, device=emb.device)
                chunk[0, :clen] = emb[start:start + clen]
                pre_cache, first = self.prefill_fn.embeds(self.params, pre_cache, chunk, clen,
                                                          start, samp)
                continue
            padded = torch.zeros((1, P), dtype=torch.long)
            padded[0, :clen] = ids_t[start:start + clen]
            pre_cache, first = self.prefill_fn(self.params, pre_cache,
                                               padded.to(self.device, non_blocking=True),
                                               clen, start, samp)
        slot = self._free.pop()
        try:
            budget = min(req.max_new_tokens, self.ecfg.max_len - plen)
            halt = torch.full((self.ecfg.max_stop_tokens,), -1, dtype=torch.int32)
            if req.stop_ids:
                halt[:len(req.stop_ids)] = torch.tensor(req.stop_ids, dtype=torch.int32)
            lane_ids = None
            if self.ecfg.speculative_k and ids:  # embeddings prompts draft from generated tokens
                lane_ids = torch.zeros((self.ecfg.max_len,), dtype=torch.int32)
                lane_ids[:plen] = ids_t
                lane_ids = lane_ids.to(self.device, non_blocking=True)
            self.state = self.insert_fn(self.state, pre_cache, plen, slot, first, budget, samp,
                                        halt.to(self.device), lane_ids)
        except Exception as e:
            self._free.append(slot)  # don't leak the lane on a failed insert
            self._fail_all(e)
            raise
        req.slot = slot
        req.samp = samp
        # no host sync here: a budget<=0 or first-token-EOS lane was inserted
        # inactive and finishes when its first chunk's results come back
        req.chunk_joined = self.chunks_dispatched
        req.chunk_last = req.chunk_joined + -(-max(budget, 0) // self.ecfg.chunk_steps) - 1
        # registration is mutually exclusive with stop()'s sweep: if stop ran
        # since the loop's _stopped check, failing the request NOW is the only
        # way its submitter wakes up
        with self._submit_lock:
            if self._stopped:
                # stop()'s sweep may already have rebuilt _free with this slot
                if slot not in self._free:
                    self._free.append(slot)
                # the insert above activated the lane, and the sweep saw an
                # empty _by_slot: deactivate it here, or a restart resumes it
                # as a zombie
                try:
                    mask = torch.zeros((self.ecfg.slots,), dtype=torch.bool)
                    mask[slot] = True
                    self._deactivate(mask.to(self.device))
                except Exception:
                    logger.exception("stop-race lane deactivation failed")
                req.error = RuntimeError("engine stopped")
                req.done.set()
                return
            self._by_slot[slot] = req
        with self._adm_cond:
            self.admissions += 1
            self._adm_cond.notify_all()

    def _finish(self, slot: int) -> None:
        req = self._by_slot.pop(slot)
        self._free.append(slot)
        req.done.set()

    @staticmethod
    def _deliver(req, row_toks, row_valid) -> None:
        """Append one chunk row's valid tokens to ``req`` (+ stream them). A
        raising stream callback is logged once and disabled for that
        request; tokens still accumulate."""
        for t, ok in zip(row_toks, row_valid):
            if not ok:
                continue
            t = int(t)
            req.tokens.append(t)
            if req.stream:
                try:
                    req.stream(t)
                except Exception:
                    logger.exception("stream callback failed; disabling")
                    req.stream = None

    def _route(self, toks, valid, chunk_idx: int) -> None:
        """Distribute a chunk's ``[B, K]`` tokens to their requests, by the
        validity mask. Requests that joined AFTER this chunk was dispatched
        (a recycled lane) are skipped."""
        for slot, req in list(self._by_slot.items()):
            if req.chunk_joined > chunk_idx:
                continue
            self._deliver(req, toks[slot], valid[slot])

    def _fail_all(self, exc: Exception) -> None:
        """A scheduler error fails every in-flight request visibly (each
        submitter raises it), frees their lanes and re-initializes the
        device state, which the failed step may have left half-written."""
        logger.exception("engine loop error")
        for slot in list(self._by_slot):
            req = self._by_slot.pop(slot)
            req.error = exc
            req.done.set()
        for req in self._retired:
            req.error = exc
            req.done.set()
        self._retired = []
        self._free = list(range(self.ecfg.slots))
        try:
            self.state = init_engine_state(self.llm_cfg, self.ecfg, device=self.device)
        except Exception:
            logger.exception("engine state re-init failed; engine is down")
            self._stopped = True

    def _row_seeds(self):
        """Per lane, the seed of its request's sampling stream, or None where
        the lane is empty or greedy; None when no lane samples. The sample
        index is not reckoned here: a speculative chunk emits 1 to ``1 + k``
        tokens a lane a step, so the chunk functions read each lane's
        ``emitted`` count on the card, as JAX keys its draws off it."""
        seeds = [None] * self.ecfg.slots
        for slot, req in self._by_slot.items():
            if not req.samp["greedy"]:
                seeds[slot] = req.samp["seed"]
        return None if all(s is None for s in seeds) else seeds

    def _pick_decode_fn(self):
        """Epsilon-greedy bandit over {spec, plain}, keyed by the busy-lane
        count; an arm's reward is the measured tokens/s of its chunks at
        that count. Unseen arms are probed first; the losing arm is
        re-probed on every 32nd pick at that count. Returns ``(fn, mode)``."""
        mode0 = "spec" if self.ecfg.speculative_k else "plain"
        if self.decode_plain_fn is None:
            return self.decode_chunk_fn, mode0
        bucket = len(self._by_slot)
        ks, kp = ("spec", bucket), ("plain", bucket)
        if self._mode_seen.get(ks, 0) == 0:
            return self.decode_chunk_fn, "spec"
        if self._mode_seen.get(kp, 0) == 0:
            return self.decode_plain_fn, "plain"
        spec_better = self._mode_ema[ks] >= self._mode_ema[kp]
        # the pick counter (not the sample counts, which stall while rewards
        # are dropped as admission-polluted) drives the re-probe
        picks = self._mode_picks.get(bucket, 0) + 1
        self._mode_picks[bucket] = picks
        if picks % 32 == 0:
            spec_better = not spec_better
        if spec_better:
            return self.decode_chunk_fn, "spec"
        return self.decode_plain_fn, "plain"

    def _note_mode_result(self, mode: str, bucket: int, toks_per_s: float) -> None:
        key = (mode, bucket)
        self._mode_seen[key] = self._mode_seen.get(key, 0) + 1
        prev = self._mode_ema.get(key)
        self._mode_ema[key] = toks_per_s if prev is None else 0.8 * prev + 0.2 * toks_per_s

    def _reward(self, mode: str, bucket: int, dispatch_t: float, polluted, n_valid: int) -> None:
        """Feed one chunk's tokens/s to the bandit. Its time runs from the
        previous fetch while the pipeline was full (the card busy back to
        back), else from its dispatch. A window with admissions measures
        prefill work on top of the chunk, so its reward is dropped, except
        as an arm's first sample at that count: under steady churn every
        window has admissions, and an unseen arm must still be measured."""
        now = time.perf_counter()
        t0 = self._last_fetch_t if self._last_fetch_t is not None else dispatch_t
        dt = max(now - max(t0, dispatch_t), 1e-6)
        if not polluted or (mode, bucket) not in self._mode_seen:
            self._note_mode_result(mode, bucket, n_valid / dt)
        self._last_fetch_t = now

    def _loop(self) -> None:
        with torch.no_grad():
            self._loop_body()

    def _loop_body(self) -> None:
        """Pipelined scheduler: chunk N+1 is enqueued before chunk N's
        results are read, so the host's routing of chunk N overlaps the
        card's work on chunk N+1. Results (finishes, lane frees, stream
        callbacks) therefore lag one chunk; a finished lane decodes one more
        chunk with active=False, emitting only masked-invalid rows."""
        # (chunk_idx, (host toks, valid, active), event, mode, dispatch time,
        #  busy lanes, admissions before the dispatch)
        pending = None
        while not self._stopped:
            # retire lanes whose occupant has CERTAINLY exhausted its budget
            # in the chunks already dispatched; EOS-terminated requests free
            # one chunk later through the active mask below
            for slot in list(self._by_slot):
                r = self._by_slot[slot]
                if self.chunks_dispatched > r.chunk_last:
                    del self._by_slot[slot]
                    self._free.append(slot)
                    if pending is None:
                        r.done.set()
                    else:
                        self._retired.append(r)
            # admit as many waiting requests as there are free lanes; block
            # only when fully idle
            block = not self._by_slot and pending is None
            admits = 0  # admissions this pass (they pollute the chunk's timing)
            while self._free:
                try:
                    req = self._queue.get(block=block, timeout=0.1 if block else None)
                except queue.Empty:
                    break
                if req is None:
                    return
                if req.abandoned:
                    req.done.set()
                    block = False
                    continue
                try:
                    self._admit(req)
                    admits += 1
                except Exception as e:
                    req.error = e
                    req.done.set()
                    logger.exception("admission failed")
                block = False
            new_pending = None
            if self._by_slot:
                try:
                    chunk_idx = self.chunks_dispatched
                    fn, mode = self._pick_decode_fn()
                    if mode == "spec":
                        self.spec_chunks += 1
                    else:
                        self.plain_chunks += 1
                    dispatch_t = time.perf_counter()
                    self.state, toks, valid, active = fn(self.params, self.state,
                                                         self._row_seeds())
                    self.chunks_dispatched += 1
                    self.decode_steps += self.ecfg.chunk_steps
                    self.active_history.append(len(self._by_slot))
                    new_pending = (chunk_idx, *_to_host([toks, valid, active]), mode,
                                   dispatch_t, len(self._by_slot), admits)
                except Exception as e:
                    pending = None  # the failed run invalidates in-flight results
                    self._fail_all(e)
                    continue
            else:
                self._last_fetch_t = None  # the pipeline drained: timing restarts
            if pending is not None:
                (chunk_idx, (toks_h, valid_h, active_h), ev, mode, dispatch_t, bucket,
                 disp_admits) = pending
                try:
                    if ev is not None:
                        ev.synchronize()
                    toks_l, valid_l, active_l = toks_h.tolist(), valid_h.tolist(), active_h.tolist()
                except Exception as e:
                    pending = None
                    self._fail_all(e)
                    continue
                if self.decode_plain_fn is not None:
                    self._reward(mode, bucket, dispatch_t, disp_admits or admits,
                                 sum(map(sum, valid_l)))
                self._route(toks_l, valid_l, chunk_idx)
                # early-retired requests: route their final rows from this
                # chunk, complete those whose last possible chunk this was
                still = []
                for r in self._retired:
                    if r.chunk_joined <= chunk_idx <= r.chunk_last:
                        self._deliver(r, toks_l[r.slot], valid_l[r.slot])
                    if chunk_idx >= r.chunk_last:
                        r.done.set()
                    else:
                        still.append(r)
                self._retired = still
                for slot in list(self._by_slot):
                    r = self._by_slot[slot]
                    if r.chunk_joined <= chunk_idx and not active_l[slot]:
                        self._finish(slot)
                # host-side stop predicates retire their lanes now
                host_stops = []
                for slot in list(self._by_slot):
                    r = self._by_slot[slot]
                    if r.stop_fn is not None and r.chunk_joined <= chunk_idx and r.tokens:
                        try:
                            hit = bool(r.stop_fn(r.tokens))
                        except Exception:
                            logger.exception("stop_fn failed; disabling")
                            r.stop_fn = None
                            continue
                        if hit:
                            host_stops.append(slot)
                if host_stops:
                    mask = torch.zeros((self.ecfg.slots,), dtype=torch.bool)
                    mask[host_stops] = True
                    try:
                        self._deactivate(mask.to(self.device))
                    except Exception as e:
                        pending = None
                        self._fail_all(e)
                        continue
                    for slot in host_stops:
                        self._finish(slot)
            pending = new_pending
