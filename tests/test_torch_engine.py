"""The port's continuous-batching engine (``dreamllm_tpu_torch/serve/
engine.py``) on the CPU, with the tiny int4 decoder of serve.py's layout
(and int8 weights on the int8 cache): its greedy output is token-identical
to the port's ``generate_text`` and to JAX's (``w4_matmul`` in interpret
mode); requests are admitted mid-decode; a sampled request's stream depends
on its seed only, not on its slot or its co-tenants; ``stop()`` fails what
is left and leaves no zombie lane; an error of the engine's thread reaches
the submitter; and the optional parts build (speculation itself:
``test_torch_engine_spec.py``).
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu_torch.generation.sampler as psamp
from dreamllm_tpu_torch.serve.engine import (
    ContinuousBatchingEngine,
    EngineConfig,
    left_truncate_keep_bos,
)
from dreamllm_tpu_torch.utils.errors import ClientError
from tests._torch_serve_helpers import jax_generate, serve_params
from tests._torch_serve_helpers import jax_int4_kernel_function  # noqa: F401  (fixture)

PROMPTS = [[1, 17, 23, 42, 7, 99, 301, 12, 5, 88], [1, 99, 3, 250, 480, 61, 9, 14, 77],
           [1, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65]]


def _engine(weights="int4", vocab=512, **kw):
    _, pc, _, pp = serve_params(vocab, weights)
    scfg = psamp.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1, pad_token_id=0,
                                stop_tokens=kw.pop("stop_tokens", ()))
    ecfg = EngineConfig(slots=kw.pop("slots", 2), prefill_len=16, max_len=kw.pop("max_len", 64),
                        chunk_steps=kw.pop("chunk_steps", 4), **kw)
    return ContinuousBatchingEngine(pp, pc, scfg, ecfg, device="cpu")


def _port_ref(ids, max_new, weights="int4", vocab=512, cache=torch.bfloat16, **kw):
    _, pc, _, pp = serve_params(vocab, weights)
    out = psamp.generate_text(
        pp, pc, torch.tensor([ids]), torch.tensor([len(ids)]),
        psamp.SamplingConfig(**{"greedy": True, "max_new_tokens": max_new, "eos_token_id": -1,
                                **kw}),
        cache_dtype=cache, device="cpu")
    return out["tokens"][0, :int(out["lengths"][0])].tolist()


def _submit_all(eng, prompts, budgets, **kw):
    results = [None] * len(prompts)

    def worker(i):
        results[i] = eng.submit(prompts[i], max_new_tokens=budgets[i], **kw)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
        time.sleep(0.02)  # staggered arrivals
    for th in threads:
        th.join(timeout=300)
    return results


@pytest.mark.parametrize("weights,cache,vocab", [("int4", "bfloat16", 512),
                                                 ("int8", "int8", 500)])
def test_engine_greedy_matches_generate_text_and_jax(weights, cache, vocab,
                                                     jax_int4_kernel_function):  # noqa: F811
    budgets = [10, 14, 7]
    eng = _engine(weights, vocab, slots=3, cache_dtype=cache).start()
    try:
        got = _submit_all(eng, PROMPTS, budgets)
    finally:
        eng.stop()
    jc, _, jp, _ = serve_params(vocab, weights)
    tcache, jcache = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
                      "int8": (torch.int8, jnp.int8)}[cache]
    # JAX decodes the three prompts as one right-padded batch (one compile);
    # with no stop rule a row's first n tokens are its budget-n output
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    ids = np.zeros((3, lens.max()), np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
    want = jax_generate(jc, jp, ids, lens, cache_dtype=jcache, max_new_tokens=max(budgets),
                        eos_token_id=-1)["tokens"]
    for i, (prompt, n, g) in enumerate(zip(PROMPTS, budgets, got)):
        assert len(g) == n
        assert g == _port_ref(prompt, n, weights, vocab, tcache)
        assert g == want[i, :n].tolist()


def test_engine_admits_mid_decode():
    """A request that arrives while another decodes is served before the
    first finishes (the continuous-batching property)."""
    eng = _engine(slots=2, chunk_steps=2, max_len=128).start()
    try:
        long_res: list = []
        t1 = threading.Thread(target=lambda: long_res.append(
            eng.submit(PROMPTS[0], max_new_tokens=60)))
        t1.start()
        assert eng.wait_for_admissions(1, timeout=60)
        for _ in range(500):
            if eng.chunks_dispatched >= 1:
                break
            time.sleep(0.01)
        short = eng.submit(PROMPTS[1], max_new_tokens=4, timeout=300)
        t1.join(timeout=300)
        assert short == _port_ref(PROMPTS[1], 4)
        assert long_res and long_res[0] == _port_ref(PROMPTS[0], 60)
        assert max(eng.active_history) == 2  # both lanes decoded together
    finally:
        eng.stop()


def test_more_requests_than_slots_and_stop_tokens():
    eng = _engine(slots=2, stop_tokens=()).start()
    prompts = [[1, 3 + i, 40 + i, 90 + 2 * i, 200 + i, 7, 8, 9, 10] for i in range(5)]
    try:
        got = _submit_all(eng, prompts, [6] * 5)
        assert got == [_port_ref(p, 6) for p in prompts]
        # a single-token stop separator halts the lane without being emitted
        free = _port_ref(PROMPTS[2], 8)
        cut = eng.submit(PROMPTS[2], max_new_tokens=8, stop_token_ids=[free[3]])
        assert cut == free[:free.index(free[3])]
    finally:
        eng.stop()


def test_sampled_stream_is_independent_of_slot_and_cotenants():
    """The same seed gives the same sampled tokens whether the request runs
    alone in slot 1 or beside greedy co-tenants in another slot; another
    seed gives others."""
    eng = _engine(slots=3, max_len=128).start()
    try:
        alone = eng.submit(PROMPTS[0], max_new_tokens=12, temperature=1.5, seed=7)
        # occupy slots with long greedy requests, then the sampled one lands elsewhere
        bg = threading.Thread(target=lambda: _submit_all(eng, PROMPTS[1:], [100, 100]))
        bg.start()
        assert eng.wait_for_admissions(3, timeout=60)
        crowded = eng.submit(PROMPTS[0], max_new_tokens=12, temperature=1.5, seed=7)
        bg.join(timeout=300)
        other = eng.submit(PROMPTS[0], max_new_tokens=12, temperature=1.5, seed=8)
    finally:
        eng.stop()
    assert alone == crowded and len(alone) == 12
    assert alone != other


def test_stop_fails_inflight_and_queued_requests_and_restarts_clean():
    eng = _engine(slots=1, max_len=128).start()
    errs = []

    def req(ids):
        try:
            eng.submit(ids, max_new_tokens=100, timeout=60)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=req, args=(p,)) for p in PROMPTS[:2]]
    try:
        threads[0].start()
        assert eng.wait_for_admissions(1, timeout=60)
        threads[1].start()  # queued behind the only lane
        time.sleep(0.05)
        eng.stop()
        for th in threads:
            th.join(timeout=30)
        assert len(errs) == 2 and all("stopped" in str(e) for e in errs)
        assert not bool(eng.state["active"].any())
        assert sorted(eng._free) == [0] and not eng._by_slot
        with pytest.raises(RuntimeError, match="stopped"):
            eng.submit(PROMPTS[0], max_new_tokens=2)
        eng.start()
        assert eng.submit(PROMPTS[2], max_new_tokens=5) == _port_ref(PROMPTS[2], 5)
    finally:
        eng.stop()


def test_stop_racing_admission_deactivates_the_inserted_lane():
    """stop() lands after the scheduler inserted a lane but before it
    registered the request: the registration check fails the request,
    deactivates the lane, and puts the slot back exactly once."""
    eng = _engine(slots=2)
    entered, release = threading.Event(), threading.Event()
    orig_insert = eng.insert_fn

    def gated_insert(*a, **kw):
        out = orig_insert(*a, **kw)
        entered.set()
        assert release.wait(60)
        return out

    eng.insert_fn = gated_insert
    eng.start()
    errs = []
    th = threading.Thread(target=lambda: errs.append(
        pytest.raises(RuntimeError, eng.submit, PROMPTS[0], max_new_tokens=8, timeout=60)))
    th.start()
    assert entered.wait(30)
    stopper = threading.Thread(target=eng.stop)
    stopper.start()
    for _ in range(3000):
        if eng._stopped:
            break
        time.sleep(0.001)
    assert eng._stopped
    release.set()
    stopper.join(timeout=60)
    th.join(timeout=30)
    assert errs and "stopped" in str(errs[0].value)
    assert not bool(eng.state["active"].any())
    assert not eng._by_slot and sorted(eng._free) == [0, 1]


def test_loop_error_reaches_the_submitter_and_the_engine_recovers():
    eng = _engine(slots=2)
    real = eng.decode_chunk_fn
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected kernel failure")
        return real(*a)

    eng.decode_chunk_fn = flaky
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit(PROMPTS[0], max_new_tokens=4, timeout=60)
        assert sorted(eng._free) == [0, 1]
        assert eng.submit(PROMPTS[0], max_new_tokens=4, timeout=120) == _port_ref(PROMPTS[0], 4)
    finally:
        eng.stop()


def test_warmup_and_request_validation():
    eng = _engine(slots=2).warmup()
    assert eng.decode_steps == eng.ecfg.chunk_steps and not bool(eng.state["active"].any())
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.warmup()
        with pytest.raises(ClientError):
            eng.submit([], max_new_tokens=2)
        with pytest.raises(ClientError):
            eng.submit([1, 2], temperature=float("nan"))
        with pytest.raises(ClientError):
            eng.submit([1, 2], stop_token_ids=[3, 4, 5, 6, 7])
        # an overlong prompt keeps BOS and its most recent context
        long = [1] + list(range(3, 120))
        got = eng.submit(long, max_new_tokens=3)
        assert got == _port_ref(left_truncate_keep_bos(long, 63, 1), 1) + got[1:] and len(got) == 1
    finally:
        eng.stop()


def test_parts_of_later_slices_raise():
    """Speculation builds both chunk programs (the drafting one and, for the
    adaptive bandit, the plain one). The prefix cache builds, and an
    embeddings prompt is checked at submit: it must be ``[S, hidden]``,
    fit the lane (it is never truncated) and come without ids."""
    spec = _engine(speculative_k=2)
    assert spec.decode_plain_fn is not None and spec.decode_chunk_fn is not spec.decode_plain_fn
    assert "history" in spec.state and spec.spec_chunks == spec.plain_chunks == 0
    eng = _engine(prefix_cache_entries=2)
    assert eng.prefix_hits == eng.prefix_misses == 0 and not eng._prefix_cache
    with pytest.raises(ClientError, match="hidden dim"):
        eng.submit(prompt_embeds=np.zeros((3, 255), np.float32))
    with pytest.raises(ClientError, match="exceeds the lane"):
        eng.submit(prompt_embeds=np.zeros((64, 256), np.float32))
    with pytest.raises(ClientError, match=r"\[S>=1, H\]"):
        eng.submit(prompt_embeds=np.zeros((256,), np.float32))
    with pytest.raises(ValueError, match="not both"):
        eng.submit([1, 2], prompt_embeds=np.zeros((2, 256), np.float32))
    with pytest.raises(ValueError, match="multiple of prefill_len"):
        _engine(max_len=60)


def test_left_truncation_keeps_bos():
    assert left_truncate_keep_bos([1, 5, 6, 7], 3, 1) == [1, 6, 7]
    assert left_truncate_keep_bos([4, 5, 6, 7], 3, 1) == [5, 6, 7]
    assert left_truncate_keep_bos([1, 5], 3, 1) == [1, 5]


def _jax_tokens(prompts, max_new, weights="int4", vocab=512):
    """JAX's greedy tokens for ``prompts`` as one right-padded batch."""
    jc, _, jp, _ = serve_params(vocab, weights)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    ids = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    out = jax_generate(jc, jp, ids, lens, max_new_tokens=max_new, eos_token_id=-1)["tokens"]
    return [row.tolist() for row in out]


def test_engine_prefix_cache_exact_and_bounded(jax_int4_kernel_function):  # noqa: F811
    """Requests sharing a token-exact full-chunk prefix skip its prefill and
    stay token-identical to the uncached port and to JAX; the LRU stays
    bounded; an entry survives the prefills that follow it; prompts shorter
    than one full chunk + 1 bypass the cache."""
    eng = _engine(prefix_cache_entries=2).start()  # P = 16
    try:
        sys_prompt = [1] + list(range(20, 51))        # 32 tokens = 2 chunks
        a, b = sys_prompt + [60, 61, 62], sys_prompt + [70, 71]
        got_a = eng.submit(a, max_new_tokens=8)
        assert eng.prefix_hits == 0 and eng.prefix_misses == 1
        got_b = eng.submit(b, max_new_tokens=8)       # hits the 32-token prefix
        assert eng.prefix_hits == 1
        assert eng.submit(a, max_new_tokens=8) == got_a  # the entry was not overwritten
        assert eng.prefix_hits == 2
        for base in (100, 105, 110):                  # distinct prefixes: LRU eviction
            eng.submit([1] + [base] * 33, max_new_tokens=2)
        assert len(eng._prefix_cache) <= 2
        hits, misses = eng.prefix_hits, eng.prefix_misses
        eng.submit([1, 5, 9], max_new_tokens=2)
        eng.submit([1] + list(range(3, 19)), max_new_tokens=2)  # 17 tokens: one chunk + 1
        assert eng.prefix_hits == hits and eng.prefix_misses == misses + 1
    finally:
        eng.stop()
    assert got_a == _port_ref(a, 8) and got_b == _port_ref(b, 8)
    assert [got_a, got_b] == _jax_tokens([a, b], 8)


def test_engine_prefix_cache_partial_match_extends(jax_int4_kernel_function):  # noqa: F811
    """A hit on a SHORTER entry still stores the prompt's own longer
    prefix, which then replaces the entry it covers; a prompt sharing only
    the first chunk of the longer entry hits it too (its stale tail rows sit
    at later positions, masked); every answer stays exact."""
    eng = _engine(prefix_cache_entries=4).start()
    try:
        head16 = [1] + list(range(20, 35))            # exactly one chunk
        eng.submit(head16 + [40], max_new_tokens=2)   # stores the 16-token prefix
        long_prompt = head16 + list(range(40, 56)) + [90, 91]
        got = eng.submit(long_prompt, max_new_tokens=8)
        assert eng.prefix_hits == 1
        assert any(len(k) == 32 for k in eng._prefix_cache)
        got2 = eng.submit(long_prompt + [99], max_new_tokens=8)
        assert eng.prefix_hits == 2
        assert all(len(k) == 32 for k in eng._prefix_cache)
        short = head16 + [77, 78, 79]
        got3 = eng.submit(short, max_new_tokens=8)
        assert eng.prefix_hits == 3
    finally:
        eng.stop()
    prompts = [long_prompt, long_prompt + [99], short]
    assert [got, got2, got3] == [_port_ref(p, 8) for p in prompts] == _jax_tokens(prompts, 8)


def test_engine_embeds_prompt_matches_ids_prompt(jax_int4_kernel_function):  # noqa: F811
    """``submit(prompt_embeds=embed_tokens[ids])`` is token-identical to
    ``submit(ids)`` and to JAX, for a prompt inside one chunk and for one
    that prefills in three; the embeddings prompt bypasses the prefix cache."""
    _, _, _, pp = serve_params(512, "int4")
    eng = _engine(prefix_cache_entries=2).warmup(embeds=True).start()
    try:
        short, long_p = [1, 17, 23, 42, 55], [1] + list(range(5, 40))
        ref = eng.submit(short, max_new_tokens=10)
        got = eng.submit(prompt_embeds=pp["embed_tokens"][torch.tensor(short)],
                         max_new_tokens=10)
        ref2 = eng.submit(long_p, max_new_tokens=8)
        hits, misses = eng.prefix_hits, eng.prefix_misses
        got2 = eng.submit(prompt_embeds=pp["embed_tokens"][torch.tensor(long_p)].numpy(),
                          max_new_tokens=8)
        assert (eng.prefix_hits, eng.prefix_misses) == (hits, misses)
    finally:
        eng.stop()
    assert got == ref and got2 == ref2
    jax10, jax8 = _jax_tokens([short, long_p], 10)
    assert ref == jax10 and ref2 == jax8[:8]
