"""The port's int4 weights (``dreamllm_tpu_torch/ops/quant4.py``) against the
JAX package's, on the CPU: packing and scales bit for bit; the kernel's
plain version (``w4_matmul_reference``) against JAX's Pallas kernel run in
interpret mode; the gate's other shapes against JAX's dequantize path; the
``matmul4`` gradient against ``jax.grad``; and the limits ``chip_smoke.py``
holds the Hopper kernel to, which must reject a kernel that drops a group.

Tolerances: both sides multiply bf16-rounded x by exact small integers and
sum in float32 in different orders; on outputs of magnitude up to ~100 the
float32 difference stays below 1e-4 relative. A bf16 output is held to one
bf16 ulp of the largest reference value.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dreamllm_tpu.ops.quant4 as jq4
import dreamllm_tpu_torch.ops.quant4 as pq4
from tests._torch_port_helpers import n, np_tree, t
from tests._torch_serve_helpers import port_transform, serve_params


def _weights(rng, k, nn):
    return rng.standard_normal((k, nn)).astype(np.float32) * k ** -0.5


@pytest.mark.parametrize("shape", [(256, 128), (512, 1664), (768, 384)])
def test_quantize_int4_is_bit_exact(shape):
    """Against JAX's compiled quantization (serving jits it): the same codes
    and scales, to the bit."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jax.jit(jq4.quantize_int4)(jnp.asarray(w))
    got = pq4.quantize_int4(t(w))
    assert got.packed.dtype == torch.uint8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(n(got.packed), np.asarray(want.packed))
    np.testing.assert_array_equal(n(got.scale), np.asarray(want.scale))
    assert got.shape == tuple(want.shape) and got.numel() == want.size
    # one float32 product a weight in both packages
    np.testing.assert_array_equal(n(pq4.dequantize_int4(got, torch.float32)),
                                  np.asarray(jq4.dequantize_int4(want, jnp.float32)))


def test_quantize_int4_takes_one_matrix():
    """The port's layers are a list, so a weight is one 2-D matrix; a
    stacked ``[L, K, N]`` leaf is split a layer at a time (``bridge``), and
    ``quantize_int4`` refuses it rather than pack it as JAX's stacked
    layout."""
    with pytest.raises(ValueError, match="2-D"):
        pq4.quantize_int4(torch.zeros((2, 256, 128)))
    with pytest.raises(ValueError, match="divisible by 256"):
        pq4.quantize_int4(torch.zeros((384, 128)))


def test_eager_jax_scales_differ_by_at_most_an_ulp():
    """JAX's eager 2-D call divides amax by 7 where its compiled code (and
    the port) multiplies by float32(1/7): a scale may sit one float32 ulp
    away, and a weight on a rounding boundary may then take the next code
    (1 in 147456 here)."""
    w = np.random.default_rng(1).standard_normal((768, 384)).astype(np.float32)
    want = jq4.quantize_int4(jnp.asarray(w))
    got = pq4.quantize_int4(t(w))
    np.testing.assert_allclose(n(got.scale), np.asarray(want.scale), rtol=2.4e-7, atol=0)
    codes = lambda p: np.concatenate([p & 0xF, p >> 4]).astype(np.int16)  # noqa: E731
    diff = np.abs(codes(n(got.packed)) - codes(np.asarray(want.packed)))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-4


def test_packing_puts_the_two_halves_of_k_in_one_byte():
    """Row i in the low nibble, row i + K/2 in the high one, stored q + 8."""
    w = np.zeros((256, 128), np.float32)
    w[3, 5], w[128 + 3, 5], w[0, 0] = 7.0, -7.0, 1.0
    q = pq4.quantize_int4(t(w))
    assert int(q.packed[3, 5]) == (7 + 8) | ((-7 + 8) << 4)
    assert int(q.packed[0, 1]) == 8 | (8 << 4)  # zeros
    with pytest.raises(ValueError, match="divisible by 256"):
        pq4.quantize_int4(torch.zeros((384, 128)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nn", [512, 1664])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_reference_matches_jax_interpret_kernel(b, nn, dtype):
    rng = np.random.default_rng(b * 7 + nn)
    w, x = _weights(rng, 512, nn), rng.standard_normal((b, 512)).astype(np.float32)
    jt = jq4.quantize_int4(jnp.asarray(w))
    want = np.asarray(jq4.w4_matmul(jnp.asarray(x).astype(dtype), jt, interpret=True))
    pt = pq4.quantize_int4(t(w))
    assert pq4.kernel_takes((b, 512), pt)
    got = pq4.w4_matmul(t(x).to(getattr(torch, dtype)), pt)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (b, nn)
    want = want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(n(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    else:
        tol = chip_smoke.bf16_ulp(float(np.abs(want).max()))
        assert np.abs(n(got.float()) - want).max() <= tol


@pytest.mark.parametrize("case", ["b9", "n500", "x3d-b12"])
def test_outside_the_gate_matches_jax_dequant_path(case):
    """B > 8 and N % 128 != 0 take ``x @ dequantize_int4(t, x.dtype)`` in
    both packages (JAX's own CPU path is that product, unpatched)."""
    rng = np.random.default_rng(3)
    b, nn = {"b9": (9, 512), "n500": (4, 500), "x3d-b12": (12, 256)}[case]
    w = _weights(rng, 512, nn)
    x = rng.standard_normal((b, 512)).astype(np.float32)
    if case == "x3d-b12":
        x = x.reshape(3, 4, 512)
    pt = pq4.quantize_int4(t(w))
    assert not pq4.kernel_takes(x.shape, pt)
    want = np.asarray(jq4.matmul4(jnp.asarray(x), jq4.quantize_int4(jnp.asarray(w))))
    got = pq4.matmul4(t(x), pt)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)


def test_3d_decode_rows_take_the_kernel_function(monkeypatch):
    """``[B, 1, K]`` decode activations flatten to B rows and take the
    kernel's function; JAX's ``_matmul4_impl`` does the same."""
    monkeypatch.setattr(jq4, "w4_matmul", functools.partial(jq4.w4_matmul, interpret=True))
    rng = np.random.default_rng(4)
    w, x = _weights(rng, 512, 256), rng.standard_normal((5, 1, 512)).astype(np.float32)
    want = np.asarray(jq4.matmul4(jnp.asarray(x), jq4.quantize_int4(jnp.asarray(w))))
    calls = []
    real = pq4.w4_matmul_reference
    monkeypatch.setattr(pq4, "w4_matmul_reference", lambda *a: calls.append(1) or real(*a))
    got = pq4.matmul4(t(x), pq4.quantize_int4(t(w)))
    assert calls and tuple(got.shape) == (5, 1, 256)
    np.testing.assert_allclose(n(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b", [3, 12])
def test_matmul4_gradient_matches_jax(b):
    """dx = g @ dequant(W)^T through the kernel's path (b 3) and the
    dequantize path (b 12); the weight gets no gradient."""
    rng = np.random.default_rng(5)
    w = _weights(rng, 512, 256)
    x = rng.standard_normal((b, 512)).astype(np.float32)
    g = rng.standard_normal((b, 256)).astype(np.float32)
    jt = jq4.quantize_int4(jnp.asarray(w))
    want = jax.grad(lambda xx: jnp.sum(jq4.matmul4(xx, jt) * g))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (pq4.matmul4(xt, pq4.quantize_int4(t(w))) * t(g)).sum().backward()
    np.testing.assert_allclose(n(xt.grad), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k,nn", [(4096, 512), (11008, 256)])
def test_w4_limits_reject_a_dropped_group(k, nn, b):
    """``chip_smoke.py``'s limits on the w4a16 kernel (bf16 output), at the
    7B contraction widths: a kernel that skipped one 128-row group (here its
    last high-half group, scale zeroed) must fail both the max-abs limit
    and the relative-RMS limit."""
    rng = np.random.default_rng(k + b)
    wq = pq4.quantize_int4(t(_weights(rng, k, nn)))
    x = t(rng.standard_normal((b, k)).astype(np.float32)).bfloat16()
    full = pq4.w4_matmul_reference(x, wq)
    scale = wq.scale.clone()
    scale[-1] = 0.0
    cut = pq4.w4_matmul_reference(x, pq4.Q4Tensor(wq.packed, scale))
    err, tol, rel_rms = chip_smoke.w4_errors(cut, full)
    assert err > tol, (err, tol)
    assert rel_rms > chip_smoke.W4_REL_RMS, rel_rms
    # the reference against itself passes
    err, tol, rel_rms = chip_smoke.w4_errors(full, full)
    assert err <= tol and rel_rms <= chip_smoke.W4_REL_RMS


def test_float32_limit_rejects_a_dropped_group():
    rng = np.random.default_rng(9)
    wq = pq4.quantize_int4(t(_weights(rng, 4096, 256)))
    x = t(rng.standard_normal((8, 4096)).astype(np.float32))
    full = pq4.w4_matmul_reference(x, wq)
    scale = wq.scale.clone()
    scale[0] = 0.0
    cut = pq4.w4_matmul_reference(x, pq4.Q4Tensor(wq.packed, scale))
    err, tol, _ = chip_smoke.w4_errors(cut, full)
    assert err > tol


def test_cuda_launch_refuses_cpu_tensors():
    wq = pq4.quantize_int4(torch.zeros((256, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        pq4.w4_matmul_cuda(torch.zeros((1, 256)), wq)


# DreamLLM-7B's decode projections [K, N] (chip_smoke.W4_SHAPES) and the smallest shape
_KERNEL_GRID_SHAPES = {
    "wqkv": (4096, 12288), "wo": (4096, 4096), "w_gate_up": (4096, 22016),
    "w_gate": (4096, 11008), "w_down": (11008, 4096), "head32000": (4096, 32000),
    "smallest": (256, 128),
}


@pytest.mark.parametrize("name", list(_KERNEL_GRID_SHAPES))
def test_kernel_grid_covers_every_column_and_row(name):
    k, nn = _KERNEL_GRID_SHAPES[name]
    kp, chunks, tiles = k // 2, k // 256, nn // 128
    per_block, blocks_k = pq4._plan(kp, nn)
    splits = blocks_k * pq4._WARPS // per_block
    # the grid (ceil(N / (128 * per_block)), blocks_k) of 4-warp blocks, a
    # 128-column tile a warp: every column in one tile, warps past it idle
    col_blocks = -(-tiles // per_block)
    assert per_block in (1, pq4._WARPS) and tiles * 128 == nn
    assert (col_blocks - 1) * per_block < tiles <= col_blocks * per_block
    # the runs of 128-row chunks the kernel gives split s of `splits` cover
    # each packed row once, in order, none more than one chunk longer
    runs = [(s * chunks // splits, (s + 1) * chunks // splits) for s in range(splits)]
    assert [c for b, e in runs for c in range(b, e)] == list(range(chunks))
    assert all(e - b <= -(-chunks // splits) for b, e in runs)
    # a cluster: a power of two up to 16 blocks, each with work
    assert blocks_k & (blocks_k - 1) == 0 and 1 <= blocks_k <= min(16, chunks)
    if per_block == pq4._WARPS:  # four tiles a block only where that fills the SMs
        assert pq4._SMS <= col_blocks * blocks_k <= 3 * pq4._SMS
    else:  # else one tile a block, every warp a chunk where there are enough
        assert blocks_k <= 8 and (pq4._WARPS * blocks_k <= chunks or blocks_k == 1)
        assert -(-tiles // pq4._WARPS) * 16 < pq4._SMS or 16 > chunks


def test_gate_copies_jax():
    wq = pq4.quantize_int4(torch.zeros((256, 384)))
    assert pq4.kernel_takes((8, 256), wq) and pq4.kernel_takes((1, 256), wq)
    assert not pq4.kernel_takes((9, 256), wq)           # more than 8 rows
    assert not pq4.kernel_takes((2, 1, 256), wq)        # x not 2-D (matmul4 flattens)
    assert not pq4.kernel_takes((1, 512), pq4.quantize_int4(torch.zeros((512, 32064))))
    assert not pq4.kernel_takes((1, 256), pq4.quantize_int4(torch.zeros((256, 100))))
    kp_odd = pq4.Q4Tensor(torch.zeros((64, 128), dtype=torch.uint8), torch.zeros((1, 128)))
    assert not pq4.kernel_takes((1, 128), kp_odd)       # K/2 % 128 != 0


@pytest.mark.parametrize("weights", ["int4", "int4-fused"])
def test_bridge_carries_stacked_int4_layers(weights):
    """A JAX ``Q4Tensor`` stacked ``[L, K/2, N]`` crosses the bridge as one
    2-D ``Q4Tensor`` a layer, equal to the port's own quantization of the
    same float32 weights."""
    _, _, jp, pp = serve_params(512, weights)
    _, _, _, plain = serve_params(512, "plain")
    mine = port_transform(plain, weights)
    keys = [k for k in pp["layers"][0] if isinstance(pp["layers"][0][k], pq4.Q4Tensor)]
    assert len(keys) == (4 if weights == "int4-fused" else 7)
    for li, layer in enumerate(pp["layers"]):
        for key in keys:
            got, want = layer[key], mine["layers"][li][key]
            assert got.packed.ndim == 2
            assert torch.equal(got.packed, want.packed) and torch.equal(got.scale, want.scale)
            np.testing.assert_array_equal(n(got.packed), np.asarray(jp["layers"][key].packed)[li])
    assert torch.equal(pp["lm_head"].packed, mine["lm_head"].packed)


def test_bridge_refuses_a_float_leaf_where_the_port_holds_int4():
    from dreamllm_tpu_torch.bridge import from_jax

    _, _, jp, _ = serve_params(512, "plain")
    _, _, _, pp = serve_params(512, "int4")
    like = {"lm_head": pp["lm_head"]}
    with pytest.raises(TypeError, match="Q4Tensor"):
        from_jax(np_tree({"lm_head": jp["lm_head"]}), like, device="cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((4096, 1024), generator=g, device="cuda") * 4096 ** -0.5
    wq = pq4.quantize_int4(w)
    for b in (1, 3, 8):
        x = torch.randn((b, 4096), generator=g, device="cuda").bfloat16()
        before = pq4.w4_matmul_cuda.launches
        got = pq4.w4_matmul(x, wq)
        assert pq4.w4_matmul_cuda.launches == before + 1
        err, tol, rel_rms = chip_smoke.w4_errors(got, pq4.w4_matmul_reference(x, wq))
        assert err <= tol and rel_rms <= chip_smoke.W4_REL_RMS
