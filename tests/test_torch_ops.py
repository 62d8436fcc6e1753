"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs come from numpy with a seed; both sides run float32 (JAX at
"highest" matmul precision, see conftest.py). Tolerances: 1e-5 for
elementwise ops, 1e-4 absolute for attention (float32 sums of up to 256
terms, taken in other orders).
"""

from __future__ import annotations

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dreamllm_tpu.ops.activations as jact
import dreamllm_tpu.ops.attention as jatt
import dreamllm_tpu.ops.norms as jnorm
import dreamllm_tpu.ops.rope as jrope
import dreamllm_tpu_torch.ops.activations as pact
import dreamllm_tpu_torch.ops.attention as patt
import dreamllm_tpu_torch.ops.norms as pnorm
import dreamllm_tpu_torch.ops.rope as prope
from tests._torch_port_helpers import n, t

ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# norms, RoPE, activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_norms_match_jax(eps):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64) * 3 + 1
    w, b = _rand(rng, 64), _rand(rng, 64)
    np.testing.assert_allclose(n(pnorm.rms_norm(t(x), t(w), eps)),
                               np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        n(pnorm.layer_norm(t(x), t(w), t(b), eps)),
        np.asarray(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps)),
        rtol=1e-5, atol=1e-5)
    img = _rand(rng, 2, 4, 6, 32) * 2 - 1
    wc, bc = _rand(rng, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        n(pnorm.group_norm(t(img), t(wc), t(bc), num_groups=8, eps=eps)),
        np.asarray(jnorm.group_norm(jnp.asarray(img), jnp.asarray(wc), jnp.asarray(bc),
                                    num_groups=8, eps=eps)),
        rtol=1e-5, atol=1e-5)


def test_norms_keep_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert pnorm.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("scaling,factor,seq_len", [
    ("none", 1.0, None), ("linear", 2.0, None),
    ("dynamic", 2.0, 96),  # window past max_pos: the base grows
    ("dynamic", 2.0, 32),  # window inside max_pos: unscaled
])
def test_rope_matches_jax(scaling, factor, seq_len):
    kw = dict(head_dim=16, base=10000.0, scaling_type=scaling, scaling_factor=factor,
              max_position_embeddings=64)
    jcfg, pcfg = jrope.RopeConfig(**kw), prope.RopeConfig(**kw)
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 2
    jc, js = jrope.rope_cos_sin(jcfg, jnp.asarray(pos), seq_len=seq_len)
    pc, ps = prope.rope_cos_sin(pcfg, t(pos), seq_len=seq_len)
    np.testing.assert_allclose(n(pc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(n(ps), np.asarray(js), atol=1e-5)
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 2, 20, 4, 16), _rand(rng, 2, 20, 2, 16)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    pq, pk = prope.apply_rope(t(q), t(k), pc, ps)
    np.testing.assert_allclose(n(pq), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(n(pk), np.asarray(jk), atol=1e-5)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "quick_gelu"])
def test_activations_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = _rand(rng, 3, 64) * 3, _rand(rng, 3, 64)
    args_j = (jnp.asarray(a),) if name == "quick_gelu" else (jnp.asarray(a), jnp.asarray(b))
    args_p = (t(a),) if name == "quick_gelu" else (t(a), t(b))
    np.testing.assert_allclose(n(getattr(pact, name)(*args_p)),
                               np.asarray(getattr(jact, name)(*args_j)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dot_product_attention
# ---------------------------------------------------------------------------


def _segments(b, s, rng, pad=8):
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cut = int(rng.integers(s // 4, s // 2))
        seg[i, :cut] = 1
        seg[i, cut:s - pad] = 2
    return seg


ATTN_CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "segments": dict(segment_ids="seg"),
    "causal_segments": dict(causal=True, segment_ids="seg"),
    "kv_only_mask": dict(kv_segment_ids="kvseg"),
    "bias": dict(bias="bias"),
    "scale": dict(sm_scale=0.3),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("return_lse", [False, True])
def test_dot_product_attention_matches_jax(case, groups, return_lse):
    rng = np.random.default_rng(3)
    b, sq, skv, hkv, d = 2, 24, 24, 2, 16
    hq = hkv * groups
    q, k, v = _rand(rng, b, sq, hq, d), _rand(rng, b, skv, hkv, d), _rand(rng, b, skv, hkv, d)
    kw = dict(ATTN_CASES[case])
    seg = _segments(b, sq, rng)
    real_rows = np.ones((b, sq), bool)
    if kw.get("segment_ids") == "seg":
        kw["segment_ids"] = seg
        real_rows = seg != 0  # padding rows are garbage by contract
    if kw.get("kv_segment_ids") == "kvseg":
        kw["kv_segment_ids"] = (np.arange(skv) < 17).astype(np.int32)[None].repeat(b, 0)
    if kw.get("bias") == "bias":
        kw["bias"] = _rand(rng, b, 1, 1, sq, skv)
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    pkw = {k_: (t(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      return_lse=return_lse, **jkw)
    got = patt.dot_product_attention(t(q), t(k), t(v), return_lse=return_lse, **pkw)
    if return_lse:
        (want, want_lse), (got, got_lse) = want, got
        np.testing.assert_allclose(n(got_lse)[real_rows], np.asarray(want_lse)[real_rows],
                                   atol=ATOL)
    np.testing.assert_allclose(n(got)[real_rows], np.asarray(want)[real_rows], atol=ATOL)


def test_fully_masked_rows_stay_finite():
    rng = np.random.default_rng(4)
    q, k, v = (t(_rand(rng, 1, 16, 2, 8)) for _ in range(3))
    seg = torch.zeros((1, 16), dtype=torch.int32)
    out, lse = patt.dot_product_attention(q, k, v, segment_ids=seg, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # every score is NEG_INF: a uniform softmax, mean(V), as in JAX
    torch.testing.assert_close(out[0, 0], v[0].mean(0), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# flash_attention: the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


FLASH_CASES = [
    # (d, causal, groups, segments)
    (64, False, 1, False), (64, True, 1, False), (64, False, 2, True), (64, True, 2, True),
    (128, False, 1, False), (128, True, 1, False), (128, False, 2, True), (128, True, 2, True),
]


@pytest.mark.parametrize("d,causal,groups,segments", FLASH_CASES)
def test_flash_plain_version_matches_pallas_kernel(d, causal, groups, segments):
    """The port's ``flash_attention_reference`` (what the CPU runs and the
    card holds its kernel against) vs the TPU kernel body
    ``_flash_kernel_t`` in Pallas interpret mode, output and LSE."""
    rng = np.random.default_rng(5)
    b, s, hkv = 1, 256, 1
    hq = hkv * groups
    q, k, v = _rand(rng, b, s, hq, d), _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    seg = _segments(b, s, rng) if segments else None
    jseg = None if seg is None else jnp.asarray(seg)
    want, want_lse = jatt._flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseg, causal=causal,
        sm_scale=d ** -0.5, block_q=128, block_k=128, interpret=True, return_lse=True)
    pseg = None if seg is None else t(seg)
    got, got_lse = patt.flash_attention_reference(t(q), t(k), t(v), pseg, pseg, causal=causal,
                                                  sm_scale=d ** -0.5, return_lse=True)
    rows = np.ones((b, s), bool) if seg is None else seg != 0
    np.testing.assert_allclose(n(got)[rows], np.asarray(want)[rows], atol=ATOL)
    lse_rows = rows[:, None, :].repeat(hq, 1)
    np.testing.assert_allclose(n(got_lse)[lse_rows], np.asarray(want_lse)[:, :, 0][lse_rows],
                               atol=ATOL)


@pytest.mark.parametrize("d,causal,groups,segments", FLASH_CASES)
def test_flash_attention_matches_jax_flash_attention(d, causal, groups, segments):
    """The public wrappers on both sides, JAX in interpret mode (the kernel
    where its rule allows, XLA elsewhere), the port on the CPU."""
    rng = np.random.default_rng(6)
    b, s, hkv = 2, 256, 1
    hq = hkv * groups
    q, k, v = _rand(rng, b, s, hq, d), _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    seg = _segments(b, s, rng) if segments else None
    want = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                segment_ids=None if seg is None else jnp.asarray(seg),
                                block_q=128, block_k=128, interpret=True)
    before = patt.flash_attention.launches
    got = patt.flash_attention(t(q), t(k), t(v), causal=causal,
                               segment_ids=None if seg is None else t(seg))
    assert patt.flash_attention.launches == before  # the CPU launches no kernel
    rows = np.ones((b, s), bool) if seg is None else seg != 0
    np.testing.assert_allclose(n(got)[rows], np.asarray(want)[rows], atol=ATOL)


def test_flash_kv_only_mask_matches_truncated_kv():
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, 1, 128, 2, 128), _rand(rng, 1, 256, 2, 128), _rand(rng, 1, 256, 2, 128)
    kvseg = (np.arange(256) < 140).astype(np.int32)[None]
    got = patt.flash_attention(t(q), t(k), t(v), kv_segment_ids=t(kvseg))
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k[:, :140]),
                                      jnp.asarray(v[:, :140]))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# the eligibility rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_shape,kv_len,causal,want", [
    ((2, 4096, 5, 64), 4096, False, True),    # UNet 64x64 self-attention at 512 px
    ((2, 1024, 10, 64), 1024, False, True),   # UNet 32x32 self-attention
    ((2, 256, 20, 64), 256, False, False),    # UNet 16x16: d 64 needs sq >= 512
    ((2, 64, 20, 64), 64, False, False),      # UNet mid block
    ((2, 4096, 5, 64), 77, False, False),     # cross-attention over 77 tokens
    ((2, 4096, 5, 64), 64, False, False),     # cross-attention over 64 dream queries
    ((1, 128, 32, 128), 256, True, False),    # causal with sq != skv
    ((1, 2048, 32, 128), 2048, True, True),   # causal decoder prefill
    ((1, 1, 32, 128), 512, False, False),     # decode step
    ((1, 256, 8, 96), 256, False, False),     # head dim 96
])
def test_flash_eligibility_rule(q_shape, kv_len, causal, want):
    k_shape = (q_shape[0], kv_len, q_shape[2], q_shape[3])
    assert patt.flash_eligible(q_shape, k_shape, causal=causal) is want


@pytest.mark.parametrize("sq,skv,d,causal", [
    (128, 128, 128, False), (128, 256, 128, True), (256, 256, 64, False),
    (512, 512, 64, True), (512, 64, 64, False), (384, 384, 128, False),
    (96, 96, 128, False), (640, 640, 64, False), (256, 256, 32, False),
])
def test_flash_eligibility_agrees_with_jax(sq, skv, d, causal):
    """The JAX wrapper's own decision, read by intercepting its kernel call."""
    taken = []

    def spy(q, *a, **kw):
        taken.append(True)
        return q

    q = jnp.zeros((1, sq, 1, d), jnp.float32)
    kv = jnp.zeros((1, skv, 1, d), jnp.float32)
    with mock.patch.object(jatt, "_flash_core", spy):
        jatt.flash_attention(q, kv, kv, causal=causal, interpret=True)
    assert patt.flash_eligible(q.shape, kv.shape, causal=causal) is bool(taken)


# ---------------------------------------------------------------------------
# the kernel wrapper's contract off the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,s", [(5, 4096), (10, 1024)])
def test_output_limits_reject_a_dropped_key_tile(heads, s):
    """``chip_smoke.py``'s limits on the kernel's output, at the UNet's
    shapes (256 of the query rows): a kernel that skipped its last 64-key
    tile must fail both the max-abs and the relative-RMS limit."""
    rng = np.random.default_rng(11)
    q = t(_rand(rng, 2, 256, heads, 64)).bfloat16()
    k, v = (t(_rand(rng, 2, s, heads, 64)).bfloat16() for _ in range(2))
    full = patt.flash_attention_reference(q, k, v, None, None, causal=False, sm_scale=0.125)
    cut = patt.flash_attention_reference(q, k[:, :-64], v[:, :-64], None, None, causal=False,
                                         sm_scale=0.125)
    err, tol, rel_rms = chip_smoke.out_errors(cut, full)
    assert err > 4 * tol and rel_rms > 4 * chip_smoke.OUT_REL_RMS


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 512, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not CUDA"):
        patt.flash_attention_cuda(q, q, q, None, None, causal=False, sm_scale=0.125)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 1024, 2, 64), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    got = patt.flash_attention(q, k, v)
    want = patt.flash_attention_reference(q, k, v, None, None, causal=False, sm_scale=0.125)
    err, tol, rel_rms = chip_smoke.out_errors(got, want)
    assert err <= tol and rel_rms <= chip_smoke.OUT_REL_RMS
    with pytest.raises(TypeError):
        patt.flash_attention(q.float(), k.float(), v.float())


# ---------------------------------------------------------------------------
# flash-attention backward: the kernel's plain version
# ---------------------------------------------------------------------------

_BWD_CASES = {
    # name: (b, s, hq, hkv, d, causal, segments)
    "noncausal-d64": (1, 512, 2, 2, 64, False, None),
    "causal-d128": (1, 256, 2, 2, 128, True, None),
    "causal-gqa-d128": (1, 256, 4, 2, 128, True, None),
    "packed-segments-padding-tail": (2, 256, 2, 2, 128, True,
                                     [[1] * 100 + [2] * 120 + [0] * 36, [1] * 256]),
}


@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_flash_backward_plain_version_matches_jax_kernel_and_autograd(case):
    """The plain backward (through autograd of the port's ``flash_attention``
    on the CPU) against ``jax.grad`` of the Pallas kernels in interpret mode
    and against torch autograd of ``dot_product_attention``. float32; 1e-3
    relative + 1e-4 absolute, the JAX package's own limits for this
    comparison (sums of up to 512 terms in other orders, P rebuilt from the
    LSE). Padding rows are compared for zero gradient only."""
    import jax

    b, s, hq, hkv, d, causal, segments = _BWD_CASES[case]
    rng = np.random.default_rng(31)
    q, k, v = _rand(rng, b, s, hq, d), _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    do = _rand(rng, b, s, hq, d)
    seg = None if segments is None else np.asarray(segments, np.int32)
    rows = np.ones((b, s), bool) if seg is None else seg != 0
    do = do * rows[:, :, None, None]  # the caller masks padding rows' loss

    def jloss(q_, k_, v_):
        out = jatt.flash_attention(q_, k_, v_, causal=causal,
                                   segment_ids=None if seg is None else jnp.asarray(seg),
                                   block_q=128, block_k=128, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def grads(fn):
        tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
        out = fn(tq, tk, tv, causal=causal, segment_ids=None if seg is None else t(seg))
        return torch.autograd.grad(out, (tq, tk, tv), t(do))

    with mock.patch.object(patt, "flash_attention_bwd_reference",
                           wraps=patt.flash_attention_bwd_reference) as spy:
        got = grads(patt.flash_attention)
    assert spy.call_count == 1  # autograd went through the plain backward
    plain = grads(patt.dot_product_attention)
    for name, g_, w_, p_ in zip("qkv", got, want, plain):
        np.testing.assert_allclose(n(g_)[rows], np.asarray(w_)[rows], rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name} vs the Pallas kernel")
        np.testing.assert_allclose(n(g_)[rows], n(p_)[rows], rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name} vs autograd of plain attention")
        assert float(g_[t(~rows)].abs().max() if (~rows).any() else 0.0) == 0.0


def test_flash_backward_ignores_upstream_gradient_on_padding_rows():
    """dO on a padding row (segment 0) must change nothing: dQ there is
    zero and dK/dV get no contribution, by the mask, not by the LSE."""
    rng = np.random.default_rng(32)
    q, k, v, do = (t(_rand(rng, 1, 128, 2, 128)) for _ in range(4))
    seg = t(np.asarray([[1] * 100 + [0] * 28], np.int32))
    out, lse = patt.flash_attention_reference(q, k, v, seg, seg, causal=True,
                                              sm_scale=128 ** -0.5, return_lse=True)
    kw = dict(causal=True, sm_scale=128 ** -0.5)
    a = patt.flash_attention_bwd_reference(q, k, v, do, out, lse, seg, seg, **kw)
    do2 = do.clone()
    do2[:, 100:] = 0.0
    b = patt.flash_attention_bwd_reference(q, k, v, do2, out, lse, seg, seg, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0][:, 100:].abs().max()) == 0.0


@pytest.mark.parametrize("heads,s,d", [(5, 4096, 64), (10, 1024, 64), (4, 1024, 128)])
def test_grad_limits_reject_a_dropped_kv_tile(heads, s, d):
    """``chip_smoke.py``'s limits on the backward kernel, at the UNet's
    shapes and a decoder-like one (256 of the query rows, bf16): a backward
    that skipped its last 64-row K/V tile must fail the relative-RMS limit
    for dQ, dK and dV, and the max-abs limit for dK and dV (whose last 64
    rows would be missing altogether)."""
    rng = np.random.default_rng(33)
    q, do = (t(_rand(rng, 1, 256, heads, d)).bfloat16() for _ in range(2))
    k, v = (t(_rand(rng, 1, s, heads, d)).bfloat16() for _ in range(2))
    scale = d ** -0.5
    out, lse = patt.flash_attention_reference(q, k, v, None, None, causal=False, sm_scale=scale,
                                              return_lse=True)
    full = patt.flash_attention_bwd_reference(q, k, v, do, out, lse, None, None, causal=False,
                                              sm_scale=scale)
    cut = patt.flash_attention_bwd_reference(q, k[:, :-64], v[:, :-64], do, out, lse, None,
                                             None, causal=False, sm_scale=scale)
    pad = torch.zeros_like(k[:, -64:])
    cut = (cut[0], torch.cat([cut[1], pad], 1), torch.cat([cut[2], pad], 1))
    for name, c, f in zip(("dq", "dk", "dv"), cut, full):
        err, tol, rel_rms = chip_smoke.grad_errors(c, f)
        assert rel_rms > 4 * chip_smoke.GRAD_REL_RMS, (name, rel_rms)
        if name != "dq":
            assert err > tol, (name, err, tol)


def test_flash_cuda_float32_raises_naming_both_kernels():
    """The documented contract: bf16 only on the card, forward and backward."""
    msg = patt._BF16_ONLY.format(name="q", dtype=torch.float32)
    assert "flash_fwd.cu" in msg and "flash_bwd.cu" in msg and "bfloat16" in msg
    q = torch.zeros((1, 512, 1, 64))
    with pytest.raises(ValueError, match="not CUDA"):
        patt.flash_attention_bwd_cuda(q, q, q, q, q, torch.zeros((1, 1, 512)), None, None,
                                      causal=False, sm_scale=0.125)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 1024, 2, 64), generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    q.requires_grad_()
    before = patt.flash_attention_bwd_cuda.launches
    (dq,) = torch.autograd.grad(patt.flash_attention(q, k, v), (q,), do)
    assert patt.flash_attention_bwd_cuda.launches == before + 1
    out, lse = patt.flash_attention_cuda(q.detach(), k, v, None, None, causal=False,
                                         sm_scale=0.125, return_lse=True)
    want = patt.flash_attention_bwd_reference(q.detach(), k, v, do, out, lse, None, None,
                                              causal=False, sm_scale=0.125)
    err, tol, rel_rms = chip_smoke.grad_errors(dq, want[0])
    assert err <= tol and rel_rms <= chip_smoke.GRAD_REL_RMS
