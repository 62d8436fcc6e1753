"""The port's ``generate_text_speculative`` (prompt-lookup speculation,
``dreamllm_tpu_torch/generation/sampler.py``) against JAX's on the CPU,
float32 weights of the tiny serving decoder from ``bridge.from_jax``: the
same tokens, lengths, verify steps, accepted drafts and emit cursor on a
random and a repetitive prompt, and the output of greedy ``generate_text``;
EOS and halt tokens are not stored, a first-token EOS gives length 0, stop
tokens are stored and then halt; a sampled config or a batch of two is
refused. On the int4 decoder a verify window of 8 rows takes the w4a16
kernel's function and one of 9 the dequantize product, where plain decode
takes the kernel's function: there the tokens must equal, or differ first
where the plain run's top-2 logit margin is a near-tie.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu_torch.generation.sampler as psamp
from tests._torch_serve_helpers import jax_int4_kernel_function  # noqa: F401  (fixture)
from tests._torch_serve_helpers import serve_params, to_torch

VOCAB = 512
# Where int4 speculation and plain int4 decode first part, the plain run's
# top-2 logit margin at that position must be below this: K3's function
# rounds its float32 input to bf16 (a relative 2^-9), the dequantize
# product does not, and through two layers that moves a logit by about 1e-2.
NEAR_TIE = 5e-2


def _prompt(kind: str, n: int = 24, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "repetitive":
        chunk = rng.integers(3, VOCAB, 6)
        return np.concatenate([[1], np.tile(chunk, 4)])[:n][None].astype(np.int32)
    return np.concatenate([[1], rng.integers(3, VOCAB, n - 1)])[None].astype(np.int32)


def _cfgs(**kw):
    args = {"greedy": True, "max_new_tokens": 20, "eos_token_id": -1, **kw}
    return jsamp.SamplingConfig(**args), psamp.SamplingConfig(**args)


def _port(ids, weights="plain", draft_len=6, **kw):
    _, pc, _, pp = serve_params(VOCAB, weights)
    out = psamp.generate_text_speculative(pp, pc, to_torch(ids), torch.tensor([ids.shape[1]]),
                                          _cfgs(**kw)[1], draft_len=draft_len,
                                          cache_dtype=torch.float32, device="cpu")
    return {"tokens": out["tokens"].numpy(), "lengths": out["lengths"].numpy(),
            "steps": out["steps"], "accepted": out["accepted"], "emitted": out["emitted"]}


def _jax(ids, weights="plain", draft_len=6, **kw):
    jc, _, jp, _ = serve_params(VOCAB, weights)
    out = jsamp.generate_text_speculative(jp, jc, jnp.asarray(ids),
                                          jnp.asarray([ids.shape[1]], jnp.int32), _cfgs(**kw)[0],
                                          draft_len=draft_len, cache_dtype=jnp.float32)
    return {"tokens": np.asarray(out["tokens"]), "lengths": np.asarray(out["lengths"]),
            "steps": int(out["steps"]), "accepted": int(out["accepted"]),
            "emitted": int(out["emitted"])}


def _greedy(ids, weights="plain", **kw):
    _, pc, _, pp = serve_params(VOCAB, weights)
    out = psamp.generate_text(pp, pc, to_torch(ids), torch.tensor([ids.shape[1]]), _cfgs(**kw)[1],
                              cache_dtype=torch.float32, device="cpu")
    return {"tokens": out["tokens"].numpy(), "lengths": out["lengths"].numpy()}


def _same(got, want):
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_speculative_matches_jax_and_greedy(kind):
    ids = _prompt(kind)
    got = _port(ids)
    _same(got, _jax(ids))
    _same({k: got[k] for k in ("tokens", "lengths")}, _greedy(ids))
    assert got["emitted"] == 20 and got["tokens"].dtype == np.int32
    if kind == "repetitive":
        assert got["accepted"] > 0 and got["steps"] < 19  # speculation engaged


@pytest.mark.parametrize("which", ["eos", "halt"])
def test_eos_and_halt_tokens_are_not_stored(which):
    ids = _prompt("random", 16, seed=2)
    free = _greedy(ids)["tokens"][0]
    kw = {"eos_token_id": int(free[4])} if which == "eos" else {"halt_tokens": (int(free[4]),)}
    got, ref = _port(ids, draft_len=4, **kw), _greedy(ids, **kw)
    _same({k: got[k] for k in ("tokens", "lengths")}, ref)
    _same(got, _jax(ids, draft_len=4, **kw))
    cut = list(free).index(free[4])
    assert int(got["lengths"][0]) == cut and (got["tokens"][0, cut:] == 0).all()


def test_first_token_eos_gives_length_zero():
    ids = _prompt("random", 10, seed=9)
    eos = int(_greedy(ids)["tokens"][0, 0])
    got = _port(ids, draft_len=3, max_new_tokens=4, eos_token_id=eos)
    _same({k: got[k] for k in ("tokens", "lengths")},
          _greedy(ids, max_new_tokens=4, eos_token_id=eos))
    assert int(got["lengths"][0]) == 0 and got["steps"] == 0
    _same(got, _jax(ids, draft_len=3, max_new_tokens=4, eos_token_id=eos))


def test_stop_tokens_are_stored_then_halt():
    ids = _prompt("random", 14, seed=11)
    free = _greedy(ids, max_new_tokens=12)["tokens"][0]
    stop = int(free[5])
    kw = {"max_new_tokens": 12, "stop_tokens": (stop,)}
    got = _port(ids, draft_len=4, **kw)
    _same({k: got[k] for k in ("tokens", "lengths")}, _greedy(ids, **kw))
    _same(got, _jax(ids, draft_len=4, **kw))
    n = int(got["lengths"][0])
    assert got["tokens"][0, n - 1] == stop and (got["tokens"][0, n:] == 0).all()


def test_sampled_config_and_batch_two_are_refused():
    _, pc, _, pp = serve_params(VOCAB)
    ids = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="greedy"):
        psamp.generate_text_speculative(pp, pc, ids, torch.tensor([8]),
                                        psamp.SamplingConfig(greedy=False), device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        psamp.generate_text_speculative(pp, pc, ids.repeat(2, 1), torch.tensor([8, 8]),
                                        psamp.SamplingConfig(greedy=True), device="cpu")


def _first_gap_margin(ids, weights, tokens, ref_tokens) -> float | None:
    """None if the two streams are equal; else the top-2 logit margin of the
    plain decoder at their first differing position, teacher-forced on the
    reference stream up to it."""
    diff = np.nonzero(tokens != ref_tokens)[0]
    if not len(diff):
        return None
    j = int(diff[0])
    _, pc, _, pp = serve_params(VOCAB, weights)
    seq = torch.tensor(np.concatenate([ids[0], ref_tokens[:j]]))[None]
    h = psamp.llama_forward(pp, pc, input_ids=seq, use_flash=False)["last_hidden_state"]
    top2 = psamp.llama_logits(pp, pc, h[:, -1:])[0, 0].topk(2).values
    return float(top2[0] - top2[1])


@pytest.mark.parametrize("draft_len", [7, 8], ids=["window8-kernel", "window9-dequantize"])
@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_int4_speculation_equals_plain_decode_up_to_near_ties(
        kind, draft_len, jax_int4_kernel_function):  # noqa: F811
    ids = _prompt(kind, seed=4)
    got = _port(ids, "int4", draft_len)
    want = _jax(ids, "int4", draft_len)
    ref = _greedy(ids, "int4")["tokens"][0]
    # the two packages compute the same function: equal, or a near-tie
    for other in (want["tokens"][0], ref):
        margin = _first_gap_margin(ids, "int4", got["tokens"][0], other)
        assert margin is None or margin < NEAR_TIE, margin
    if (got["tokens"] == want["tokens"]).all():
        _same(got, want)
