"""Per-slot speculative decoding in the port's engine
(``dreamllm_tpu_torch/serve/engine.py``, ``speculative_k > 0``) on the CPU,
float32 weights of the tiny serving decoder: speculation must not show in
the output. Greedy answers equal ``generate_text``'s and JAX's spec
engine's; a sampled request's tokens equal the non-speculative engine's,
also when a plain chunk follows a speculative one (the sample index comes
from the lane's ``emitted`` count, not from a host reckoning of tokens a
chunk); budgets are exact; concurrent lanes do not cross; a lane that
fills its cache stops as the plain engine's does, though its verify windows
reach past ``max_len``; the adaptive bandit switches programs without
changing the output and prefers the mode measured faster (rewards
injected, never timed here).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import dreamllm_tpu.serve.engine as jengine
import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu_torch.generation.sampler as psamp
from dreamllm_tpu_torch.serve.engine import ContinuousBatchingEngine, EngineConfig
from tests._torch_serve_helpers import serve_params

VOCAB = 512
REPEAT_PROMPT = [1] + [5, 6, 7, 8] * 6   # n-gram rich: drafts are accepted
RANDOM_PROMPT = [1] + np.random.default_rng(3).integers(2, VOCAB, 25).tolist()
ECFG = dict(slots=2, prefill_len=32, max_len=128, chunk_steps=4)


def _engine(k, **kw):
    _, pc, _, pp = serve_params(VOCAB)
    scfg = psamp.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1, pad_token_id=0)
    return ContinuousBatchingEngine(pp, pc, scfg, EngineConfig(**ECFG, speculative_k=k, **kw),
                                    device="cpu")


def _ref(ids, max_new):
    _, pc, _, pp = serve_params(VOCAB)
    out = psamp.generate_text(pp, pc, torch.tensor([ids]), torch.tensor([len(ids)]),
                              psamp.SamplingConfig(greedy=True, max_new_tokens=max_new,
                                                   eos_token_id=-1),
                              cache_dtype=torch.bfloat16, device="cpu")
    return out["tokens"][0, :int(out["lengths"][0])].tolist()


def _serve(eng, ids, max_new, **kw):
    eng.start()
    try:
        return eng.submit(ids, max_new_tokens=max_new, timeout=600, **kw)
    finally:
        eng.stop()


def _record_emits(eng) -> list[int]:
    """Wrap the engine's chunk functions to record, per spec chunk, the
    most tokens one lane emitted in it."""
    most: list[int] = []
    spec, plain = eng.decode_chunk_fn, eng.decode_plain_fn

    def recording(*a):
        out = spec(*a)
        most.append(int(out[2].sum(dim=1).max()))
        return out

    recording.plain = plain
    eng.decode_chunk_fn = recording
    return most


def _alternate(eng) -> dict:
    """Force strict alternation of the two programs, spec first."""
    flip = {"n": 0}
    spec, plain = eng.decode_chunk_fn, eng.decode_plain_fn

    def pick():
        flip["n"] += 1
        return (spec, "spec") if flip["n"] % 2 else (plain, "plain")

    eng._pick_decode_fn = pick
    return flip


@pytest.mark.parametrize("prompt", [REPEAT_PROMPT, RANDOM_PROMPT], ids=["repetitive", "random"])
def test_greedy_identity_vs_generate_text(prompt):
    eng = _engine(4, speculative_adaptive=False)  # every chunk drafts: no timing involved
    most = _record_emits(eng)
    assert _serve(eng, prompt, 24) == _ref(prompt, 24)
    if prompt is REPEAT_PROMPT:
        assert max(most) > ECFG["chunk_steps"]  # drafts were accepted


def test_greedy_identity_vs_jax_spec_engine():
    """Both prompts at once through JAX's spec engine and the port's."""
    jc, _, jp, _ = serve_params(VOCAB)
    jeng = jengine.ContinuousBatchingEngine(
        jp, jc, jsamp.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1),
        jengine.EngineConfig(**ECFG, speculative_k=4, speculative_adaptive=False)).start()
    eng = _engine(4, speculative_adaptive=False).start()
    try:
        for prompt, n in ((REPEAT_PROMPT, 20), (RANDOM_PROMPT, 16)):
            want = jeng.submit(prompt, max_new_tokens=n, timeout=600)
            assert eng.submit(prompt, max_new_tokens=n, timeout=600) == want
            assert len(want) == n
    finally:
        jeng.stop()
        eng.stop()


SAMPLED = dict(temperature=0.2, top_k=2, seed=1234)  # cool enough for drafts to pass


@pytest.mark.parametrize("policy", ["static", "alternating"])
def test_sampled_identity_vs_nonspec_engine(policy):
    """The same (seed, prompt, sampling values) give the same tokens with and
    without speculation. With strict alternation a plain chunk follows each
    spec chunk whose lane emitted more than one token a step: the host's old
    reckoning (``chunk_steps`` samples a chunk) would draw from the wrong
    indices there."""
    ref = _serve(_engine(0), REPEAT_PROMPT, 24, **SAMPLED)
    eng = _engine(4, speculative_adaptive=(policy == "alternating"))
    most = _record_emits(eng)
    if policy == "alternating":
        flip = _alternate(eng)
    got = _serve(eng, REPEAT_PROMPT, 24, **SAMPLED)
    assert got == ref and len(ref) == 24
    assert max(most) > ECFG["chunk_steps"]  # a sampled draft was accepted
    if policy == "alternating":
        assert flip["n"] >= 3 and eng.plain_chunks >= 1
    assert got != _serve(_engine(0), REPEAT_PROMPT, 24, **{**SAMPLED, "seed": 99})


def test_sampled_lane_after_spec_chunk_draws_its_own_indices():
    """A sampled lane decodes spec chunks until one accepts a draft, then
    plain chunks; it must draw sample ``emitted`` of its stream at every
    step, which no count of chunks since it joined gives."""
    ref = _serve(_engine(0), REPEAT_PROMPT, 24, **SAMPLED)
    eng = _engine(4)
    most = _record_emits(eng)
    spec, plain = eng.decode_chunk_fn, eng.decode_plain_fn

    def pick():
        if any(m > ECFG["chunk_steps"] for m in most):
            return plain, "plain"
        return spec, "spec"

    eng._pick_decode_fn = pick
    got = _serve(eng, REPEAT_PROMPT, 24, **SAMPLED)
    assert max(most) > ECFG["chunk_steps"] and eng.plain_chunks >= 1
    assert got == ref


def test_budget_exact():
    eng = _engine(4, speculative_adaptive=False).start()
    try:
        got = eng.submit(REPEAT_PROMPT, max_new_tokens=3, timeout=600)
        got1 = eng.submit(REPEAT_PROMPT, max_new_tokens=1, timeout=600)
    finally:
        eng.stop()
    assert len(got) == 3 and len(got1) == 1 and got[:1] == got1


def test_concurrent_spec_requests():
    eng = _engine(2, speculative_adaptive=False).start()
    prompts, outs = [REPEAT_PROMPT, RANDOM_PROMPT], {}

    def one(i):
        outs[i] = eng.submit(prompts[i], max_new_tokens=16, timeout=600)

    try:
        ts = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
    finally:
        eng.stop()
    assert [outs[0], outs[1]] == [_ref(p, 16) for p in prompts]
    assert max(eng.active_history) == 2


def test_lane_capacity_respected():
    """A lane that fills to max_len stops exactly as the plain engine's: its
    last verify windows write rows past max_len, which the slack takes (a
    raising cache write would fail the request)."""
    long_prompt = [1] + [5, 6, 7, 8] * 29  # 117 tokens, lane capacity 128
    got = _serve(_engine(4, speculative_adaptive=False), long_prompt, 64)
    ref = _serve(_engine(0), long_prompt, 64)
    assert got == ref and len(got) == 128 - len(long_prompt)


def test_adaptive_mode_switching_preserves_greedy_identity():
    eng = _engine(4)
    assert eng.decode_plain_fn is not None  # speculative_adaptive defaults to True
    flip = _alternate(eng)
    got = _serve(eng, REPEAT_PROMPT, 24)
    assert flip["n"] >= 2  # both programs ran
    assert got == _ref(REPEAT_PROMPT, 24)


def test_adaptive_disabled_keeps_single_program():
    eng = _engine(2, speculative_adaptive=False)
    assert eng.decode_plain_fn is None
    assert _serve(eng, REPEAT_PROMPT, 12) == _ref(REPEAT_PROMPT, 12)
    assert eng.plain_chunks == 0 and eng.spec_chunks >= 1  # every chunk drafted


def test_bandit_prefers_measured_faster_mode():
    eng = _engine(2)
    assert eng._pick_decode_fn()[1] == "spec"  # unseen arms are probed first
    eng._note_mode_result("spec", 0, 100.0)
    assert eng._pick_decode_fn()[1] == "plain"
    eng._note_mode_result("plain", 0, 300.0)
    picks = [eng._pick_decode_fn()[1] for _ in range(10)]
    assert picks.count("plain") >= 9
    for _ in range(20):  # the EMA follows new evidence
        eng._note_mode_result("spec", 0, 900.0)
    assert eng._pick_decode_fn()[1] == "spec"
    # the losing arm is re-probed on every 32nd pick at one count
    picks = [eng._pick_decode_fn()[1] for _ in range(64)]
    assert picks.count("plain") == 2


def test_polluted_rewards_count_only_as_first_sample():
    eng = _engine(2)
    eng._reward("spec", 1, 0.0, True, 10)  # an unseen arm takes a polluted sample
    assert eng._mode_seen[("spec", 1)] == 1
    eng._reward("spec", 1, 0.0, True, 10)  # later polluted samples are dropped
    assert eng._mode_seen[("spec", 1)] == 1
    eng._reward("spec", 1, 0.0, False, 10)
    assert eng._mode_seen[("spec", 1)] == 2


def test_warmup_runs_both_programs_and_embeds_prompts_draft_from_generated():
    _, _, _, pp = serve_params(VOCAB)
    eng = _engine(4).warmup(embeds=True)
    assert eng.decode_steps == 2 * ECFG["chunk_steps"]
    assert not bool(eng.state["active"].any())
    assert tuple(eng.state["history"].shape) == (ECFG["slots"], ECFG["max_len"])
    assert eng.state["cache"]["k"].shape[2] == ECFG["max_len"] + 4  # the slack rows
    eng.start()
    try:
        by_ids = eng.submit(REPEAT_PROMPT, max_new_tokens=12, timeout=600)
        emb = pp["embed_tokens"][torch.tensor(REPEAT_PROMPT)]
        assert eng.submit(prompt_embeds=emb, max_new_tokens=12, timeout=600) == by_ids
    finally:
        eng.stop()
    assert by_ids == _ref(REPEAT_PROMPT, 12)
