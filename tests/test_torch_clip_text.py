"""The CLIP text tower of the PyTorch port against the JAX package's, on the
CPU in float32 at a tiny size: ``clip_text_forward`` (causal pre-LN layers,
quick-gelu, EOT pooling at the highest id) and ``clip_similarity`` with a
tensor ``logit_scale`` (the log of the scale, exponentiated) and a float one
(the scale itself). Tolerance 1e-4 unless a test states otherwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.clip_text as jct
import dreamllm_tpu_torch.models.clip_text as pct
from tests._torch_port_helpers import clip_text_params, n, t


def _ids(seed=0):
    """Three prompts of 5, 9 and 12 tokens, each ending in EOT (the highest
    id), padded with 0 to 12; the first prompt's EOT is followed by a second
    one, so that pooling must take the first."""
    _, pc, _, _ = clip_text_params()
    eot = pc.vocab_size - 1
    rng = np.random.default_rng(seed)
    ids = np.zeros((3, 12), np.int32)
    for row, length in enumerate((5, 9, 12)):
        ids[row, :length - 1] = rng.integers(1, eot, length - 1)
        ids[row, length - 1] = eot
    ids[0, 7] = eot
    return ids


def test_clip_text_forward_matches_jax():
    """Last hidden states and the pooled EOT states within 1e-4 (float32
    through two layers); each row equals the same prompt computed alone
    within 1e-5; pooling takes the first EOT."""
    jc, pc, jp, pp = clip_text_params()
    ids = _ids()
    want_h, want_p = jct.clip_text_forward(jp, jc, jnp.asarray(ids))
    got_h, got_p = pct.clip_text_forward(pp, pc, t(ids))
    assert tuple(got_h.shape) == (3, 12, pc.hidden_size) and tuple(got_p.shape) == (3, 32)
    np.testing.assert_allclose(n(got_h), np.asarray(want_h), atol=1e-4)
    np.testing.assert_allclose(n(got_p), np.asarray(want_p), atol=1e-4)
    assert torch.equal(got_p[0], got_h[0, 4]) and torch.equal(got_p[2], got_h[2, 11])
    for row in range(3):
        _, alone = pct.clip_text_forward(pp, pc, t(ids[row:row + 1]))
        np.testing.assert_allclose(n(alone[0]), n(got_p[row]), rtol=1e-5, atol=1e-5)


def test_clip_text_is_causal():
    """A token changed after the EOT changes nothing at or before it."""
    _, pc, _, pp = clip_text_params()
    ids = _ids()
    other = ids.copy()
    other[1, 10] = 7
    a, pa = pct.clip_text_forward(pp, pc, t(ids))
    b, pb = pct.clip_text_forward(pp, pc, t(other))
    assert torch.equal(a[1, :10], b[1, :10]) and torch.equal(pa, pb)
    assert not torch.equal(a[1, 10:], b[1, 10:])


@pytest.mark.parametrize("scale", ["tensor", "float"])
def test_clip_similarity_matches_jax(scale):
    """``logits_per_image [3, 2]`` within 1e-5 relative (values up to 100):
    a tensor ``logit_scale`` is exponentiated, a float is used as it is."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((3, 40)).astype(np.float32)
    txt = rng.standard_normal((2, 32)).astype(np.float32)
    vproj = rng.standard_normal((40, 24)).astype(np.float32)
    tproj = rng.standard_normal((32, 24)).astype(np.float32)
    if scale == "tensor":
        js, ps, factor = jnp.asarray(np.log(100.0), jnp.float32), torch.tensor(np.log(100.0)), 100
    else:
        js, ps, factor = 20.0, 20.0, 20.0
    want = np.asarray(jct.clip_similarity(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vproj),
                                          jnp.asarray(tproj), js))
    got = pct.clip_similarity(t(img), t(txt), t(vproj), t(tproj), ps)
    assert tuple(got.shape) == (3, 2)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    assert float(got.abs().max()) <= factor * (1 + 1e-5)
