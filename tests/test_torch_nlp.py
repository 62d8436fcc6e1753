"""The port's NLP evaluation (``dreamllm_tpu_torch/eval/nlp.py``) against
the JAX package's on the CPU, float32, on JAX's weights
(``bridge.from_jax``): per-sequence log-probs of padded batches (summed and
per-token), the continuation scores that ``/logprob`` serves, the
multiple-choice pick and perplexity. Log-probs within 1e-4 (sums of float32
log-softmax values of a 512-token vocabulary)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.data.tokenization as jtok
import dreamllm_tpu.eval.nlp as jnlp
import dreamllm_tpu_torch.data.tokenization as ptok
import dreamllm_tpu_torch.eval.nlp as pnlp
from tests._torch_serve_helpers import serve_params

TOL = 1e-4
CHOICES = [" yes", " no", " maybe not today", " the answer is four"]


def _batch():
    rng = np.random.default_rng(3)
    lens = np.asarray([9, 14, 6], np.int32)
    ids = np.zeros((3, 14), np.int32)
    for i, k in enumerate(lens):
        ids[i, :k] = np.concatenate([[1], rng.integers(3, 512, k - 1)])
    return ids, np.asarray([4, 9, 1], np.int32), lens


@pytest.mark.parametrize("normalize", [False, True])
def test_sequence_logprob_matches_jax(normalize):
    jc, pc, jp, pp = serve_params(512, "plain")
    ids, start, lens = _batch()
    want = jnlp.sequence_logprob(jp, jc, jnp.asarray(ids), jnp.asarray(start), jnp.asarray(lens),
                                 normalize_by_length=normalize)
    got = pnlp.sequence_logprob(pp, pc, torch.from_numpy(ids), torch.from_numpy(start),
                                torch.from_numpy(lens), normalize_by_length=normalize)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_choice_logprobs_and_multiple_choice_match_jax(normalize):
    jc, pc, jp, pp = serve_params(512, "plain")
    context = "the quick brown fox asks whether"
    want = jnlp.choice_logprobs(jp, jc, jtok.ToyTokenizer(vocab_size=512), context, CHOICES,
                                normalize_by_length=normalize)
    got = pnlp.choice_logprobs(pp, pc, ptok.ToyTokenizer(vocab_size=512), context, CHOICES,
                               normalize_by_length=normalize)
    assert isinstance(got, np.ndarray) and got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    pick = pnlp.multiple_choice(pp, pc, ptok.ToyTokenizer(vocab_size=512), context, CHOICES,
                                normalize_by_length=normalize)
    assert pick == jnlp.multiple_choice(jp, jc, jtok.ToyTokenizer(vocab_size=512), context,
                                        CHOICES, normalize_by_length=normalize)


def test_perplexity_matches_jax():
    jc, pc, jp, pp = serve_params(512, "plain")
    ids, _, lens = _batch()
    want = jnlp.perplexity(jp, jc, jnp.asarray(ids), jnp.asarray(lens))
    got = pnlp.perplexity(pp, pc, torch.from_numpy(ids), torch.from_numpy(lens))
    assert isinstance(got, float) and got > 1.0
    assert abs(got - want) <= 1e-5 * want
