"""The port's projectors and ``clip_pooled_output`` against the JAX
package's, on the CPU in float32: every projector type on weights that JAX
initialised and ``bridge.from_jax`` brought over (conv kernels HWIO → OIHW),
square token grids of odd and even side (XLA pads a stride-2 SAME conv
asymmetrically at an even side), and ``projector_out_len`` against the
output's real length. Tolerance 1e-5: float32 products of at most a few
hundred terms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.clip as jclip
import dreamllm_tpu.models.projector as jproj
import dreamllm_tpu_torch.models.clip as pclip
import dreamllm_tpu_torch.models.projector as pproj
from tests._torch_port_helpers import clip_params, n, t, to_port

ATOL = 1e-5

CASES = {
    "linear": dict(projector_type="linear", in_dim=24, out_dim=40),
    "mlp2": dict(projector_type="mlp", in_dim=24, out_dim=40, depth=2),
    "mlp3-hidden": dict(projector_type="mlp", in_dim=24, out_dim=40, depth=3, hidden_dim=56),
    "conv": dict(projector_type="conv", in_dim=16, out_dim=40),
    "sam": dict(projector_type="sam", in_dim=16, out_dim=40),
}


def _pair(name, seed=0):
    jc, pc = jproj.ProjectorConfig(**CASES[name]), pproj.ProjectorConfig(**CASES[name])
    jp = jproj.init_projector_params(jax.random.PRNGKey(seed), jc)
    return jc, pc, jp, to_port(jp, pproj.init_projector_params(pc, device="meta"))


@pytest.mark.parametrize("name,side", [
    ("linear", 4), ("mlp2", 4), ("mlp3-hidden", 3), ("conv", 5), ("conv", 6),
    ("sam", 5), ("sam", 6), ("sam", 7), ("sam", 16)])
def test_projector_matches_jax(name, side):
    jc, pc, jp, pp = _pair(name)
    x = np.random.default_rng(side).standard_normal((2, side * side, jc.in_dim)).astype(np.float32)
    want = np.asarray(jproj.projector_forward(jp, jc, jnp.asarray(x)))
    got = n(pproj.projector_forward(pp, pc, t(x)))
    assert got.shape == want.shape == (2, pproj.projector_out_len(pc, side * side), jc.out_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_projector_conv_weights_cross_as_oihw():
    _, _, jp, pp = _pair("sam")
    w = pp["conv1"]["w"]
    assert tuple(w.shape) == (16, 16, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(n(w), np.asarray(jp["conv1"]["w"]).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("name", ["linear", "mlp2", "conv", "sam"])
def test_projector_out_len_matches_jax(name):
    jc, pc = jproj.ProjectorConfig(**CASES[name]), pproj.ProjectorConfig(**CASES[name])
    for side in range(1, 40):
        assert pproj.projector_out_len(pc, side * side) == jproj.projector_out_len(jc, side * side)


def test_projector_init_shapes_match_jax():
    for name in CASES:
        jc, pc = jproj.ProjectorConfig(**CASES[name]), pproj.ProjectorConfig(**CASES[name])
        jp = jax.tree.map(np.shape, jproj.init_projector_params(jax.random.PRNGKey(0), jc))
        pp = pproj.init_projector_params(pc, device="meta")
        flat_j = jax.tree.leaves(jp, is_leaf=lambda x: isinstance(x, tuple))
        flat_p = [tuple(x.shape) for x in jax.tree.leaves(pp)]
        # conv kernels: HWIO in JAX, OIHW in the port
        assert [s if len(s) != 4 else (s[3], s[2], s[0], s[1]) for s in flat_j] == flat_p


def test_projector_rejects_unknown_types_and_ragged_grids():
    with pytest.raises(ValueError, match="unknown projector_type"):
        pproj.init_projector_params(pproj.ProjectorConfig(projector_type="qformer"), device="cpu")
    _, pc, _, pp = _pair("conv")
    with pytest.raises(ValueError, match="square"):
        pproj.projector_forward(pp, pc, torch.zeros((1, 10, 16)))


def test_clip_pooled_output_matches_jax():
    jc, pc, jp, pp = clip_params()
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jh = jclip.clip_vision_forward(jp, jc, jnp.asarray(x))
    ph = pclip.clip_vision_forward(pp, pc, t(x))
    want = np.asarray(jclip.clip_pooled_output(jp, jc, jh))
    got = n(pclip.clip_pooled_output(pp, pc, ph))
    assert got.shape == (2, pc.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL)
