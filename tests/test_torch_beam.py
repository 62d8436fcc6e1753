"""The port's ``beam_search`` (``dreamllm_tpu_torch/generation/sampler.py``)
against JAX's on the CPU, float32 weights of the tiny serving decoder from
``bridge.from_jax``: the same best-beam tokens, scores within 1e-4, for 1
and 4 beams at batch 2, a length penalty other than 1, EOS and halt tokens,
and the int8 cache; one beam equals greedy ``generate_text``; batch rows
are independent; and a planted score tie is broken as ``jax.lax.top_k``
breaks it (the lower index first).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu_torch.generation.sampler as psamp
from tests._torch_serve_helpers import prompts, serve_params, to_torch

SCORE_TOL = 1e-4  # float32 scores of the two packages (summed log-probs)
VOCAB = 512


def _both(ids, lens, jp=None, pp=None, *, cache=("float32", "float32"), **kw):
    jc, pc, jp0, pp0 = serve_params(VOCAB)
    jp, pp = jp or jp0, pp or pp0
    jo = jsamp.beam_search(jp, jc, jnp.asarray(ids), jnp.asarray(lens),
                           cache_dtype=getattr(jnp, cache[0]), **kw)
    po = psamp.beam_search(pp, pc, to_torch(ids), to_torch(lens),
                           cache_dtype=getattr(torch, cache[1]), device="cpu", **kw)
    return ({"tokens": np.asarray(jo["tokens"]), "scores": np.asarray(jo["scores"])},
            {"tokens": po["tokens"].numpy(), "scores": po["scores"].numpy()})


def _greedy(ids, lens, n, pp=None, **kw):
    _, pc, _, pp0 = serve_params(VOCAB)
    out = psamp.generate_text(pp or pp0, pc, to_torch(ids), to_torch(lens),
                              psamp.SamplingConfig(greedy=True, max_new_tokens=n, **kw),
                              cache_dtype=torch.float32, device="cpu")
    return out["tokens"].numpy()


@pytest.mark.parametrize("num_beams,length_penalty,stop,cache", [
    (1, 1.0, "none", "float32"),
    (4, 1.0, "none", "float32"),
    (4, 0.6, "none", "float32"),
    (4, 1.3, "eos", "float32"),
    (4, 1.0, "halt", "float32"),
    (3, 1.0, "none", "int8"),
], ids=["1beam", "4beams", "4beams-lp0.6", "4beams-lp1.3-eos", "4beams-halt", "3beams-int8"])
def test_beam_search_matches_jax(num_beams, length_penalty, stop, cache):
    ids, lens = prompts(2, seed=5)
    kw = dict(num_beams=num_beams, max_new_tokens=8, length_penalty=length_penalty,
              eos_token_id=-1)
    if stop != "none":
        # a token greedy decoding reaches in both rows stops some beams early
        free = _greedy(ids, lens, 8, eos_token_id=-1)
        tok = int(free[0, 2])
        kw.update(eos_token_id=tok) if stop == "eos" else kw.update(halt_tokens=(tok,))
    want, got = _both(ids, lens, cache=(cache, cache), **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_TOL)
    assert got["tokens"].dtype == np.int32 and got["scores"].dtype == np.float32
    if stop != "none":
        assert tok not in got["tokens"]  # stripped


def test_one_beam_is_greedy_generate_text():
    ids, lens = prompts(2, seed=6)
    _, got = _both(ids, lens, num_beams=1, max_new_tokens=10, eos_token_id=-1)
    np.testing.assert_array_equal(got["tokens"], _greedy(ids, lens, 10, eos_token_id=-1))


def test_beam_rows_are_independent():
    ids, lens = prompts(2, seed=7, lengths=(12, 7))
    _, pc, _, pp = serve_params(VOCAB)
    kw = dict(num_beams=3, max_new_tokens=6, eos_token_id=-1, cache_dtype=torch.float32,
              device="cpu")
    both = psamp.beam_search(pp, pc, to_torch(ids), to_torch(lens), **kw)
    for r in range(2):
        n = int(lens[r])
        solo = psamp.beam_search(pp, pc, to_torch(ids[r:r + 1, :n]), to_torch(lens[r:r + 1]),
                                 **kw)
        assert torch.equal(both["tokens"][r], solo["tokens"][0])
        assert abs(float(both["scores"][r]) - float(solo["scores"][0])) <= SCORE_TOL


def test_top_k_breaks_ties_as_jax():
    """Rows of many equal values, large and small k: the values and the
    indices of ``jax.lax.top_k``. (No zeros: JAX ranks +0.0 above -0.0,
    a sort takes them as equal; a beam score is never a signed zero.)"""
    rng = np.random.default_rng(0)
    x = (np.round(rng.normal(size=(4, 3000)) * 2) + 0.5).astype(np.float32)  # ~20 values
    for k in (1, 4, 37, 3000):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = psamp._top_k_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("num_beams", [1, 2])
def test_planted_score_tie_is_broken_as_jax_breaks_it(num_beams):
    """Copy the head's column of greedy's first pick into its neighbour one
    below: the two first tokens then score exactly alike in both packages,
    and both must take the lower index first."""
    ids, lens = prompts(1, seed=8)
    jc, pc, jp, pp = serve_params(VOCAB)
    first = int(_greedy(ids, lens, 1, eos_token_id=-1)[0, 0])
    low = first - 1 if first > 1 else first + 1
    low, high = min(first, low), max(first, low)
    head = np.asarray(jp["lm_head"]).copy()
    head[:, low] = head[:, high] = head[:, first]
    jp2 = {**jp, "lm_head": jnp.asarray(head)}
    pp2 = {**pp, "lm_head": torch.from_numpy(head)}
    logits = psamp.llama_logits(pp2, pc, pp2["embed_tokens"][:1][None])[0, 0]
    assert float(logits[low]) == float(logits[high])  # the tie is exact
    want, got = _both(ids, lens, jp2, pp2, num_beams=num_beams, max_new_tokens=5,
                      eos_token_id=-1)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_TOL)
    if num_beams == 1:
        assert int(got["tokens"][0, 0]) == low
