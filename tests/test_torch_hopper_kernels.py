"""The Hopper kernels K1 (flash-attention forward, ``csrc/flash_fwd.cu``),
K2 (flash-attention backward, ``csrc/flash_bwd.cu``) and K3 (w4a16 int4
matmul, ``csrc/w4a16.cu``) at their edge cases, on the card, against their
plain versions with ``chip_smoke.py``'s limits, and twice on the same inputs
for the same bits. They skip without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hopper_kernels.py
"""

from __future__ import annotations

import math

import pytest
import torch

import chip_smoke
import dreamllm_tpu_torch.ops.attention as patt
import dreamllm_tpu_torch.ops.quant4 as pq4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

_PAD = [[1] * 300 + [2] * 400 + [0] * 300]  # a padding tail: 300 fully masked rows

_FLASH_CASES = {
    # name: (b, s, hq, hkv, d, causal, segments, fused projection views)
    "ragged-s1000-d64": (2, 1000, 3, 3, 64, False, None, False),
    "ragged-s1000-causal-d128": (1, 1000, 2, 2, 128, True, None, False),
    "causal-diagonal-d64": (1, 640, 2, 2, 64, True, None, False),
    "gqa-causal-d128": (1, 512, 8, 2, 128, True, None, False),
    "segments-padding-tail-causal-d128": (1, 1000, 2, 2, 128, True, _PAD, False),
    "segments-fully-masked-rows-d64": (1, 1000, 2, 2, 64, False, _PAD, False),
    "fused-projection-views-d64": (2, 768, 4, 4, 64, False, None, True),
    "fused-projection-views-gqa-d128": (1, 1024, 4, 2, 128, True, None, True),
}


def _qkv(b, s, hq, hkv, d, fused, gen):
    if not fused:
        return [torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
                for h in (hq, hkv, hkv)]
    # q, k, v as strided views of one [B, S, (Hq + 2 Hkv) * D] projection
    qkv = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d), v.reshape(b, s, hkv, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FLASH_CASES))
def test_flash_forward_kernel_edge_cases_on_card(case):
    _card()
    b, s, hq, hkv, d, causal, segments, fused = _FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _qkv(b, s, hq, hkv, d, fused, gen)
    if fused:
        assert not q.is_contiguous()
    seg = None
    if segments is not None:
        seg = torch.tensor(segments * b, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, sm_scale=scale, return_lse=True)
    before = patt.flash_attention.launches
    got, got_lse = patt.flash_attention_cuda(q, k, v, seg, seg, **kw)
    again, again_lse = patt.flash_attention_cuda(q, k, v, seg, seg, **kw)
    want, want_lse = patt.flash_attention_reference(q, k, v, seg, seg, **kw)
    torch.cuda.synchronize()
    assert patt.flash_attention.launches == before + 2
    assert torch.equal(got, again) and torch.equal(got_lse, again_lse)
    assert torch.isfinite(got.float()).all()
    rows = torch.ones((b, s), dtype=torch.bool, device="cuda") if seg is None else seg != 0
    err, tol, rel_rms = chip_smoke.out_errors(got[rows], want[rows])
    assert err <= tol and rel_rms <= chip_smoke.OUT_REL_RMS, (err, tol, rel_rms)
    lse_err = (got_lse - want_lse).abs().transpose(1, 2)[rows].max().item()
    assert lse_err <= chip_smoke.LSE_TOL
    if seg is not None and not causal:
        # every key is masked for a padding row: it averages V, never NaN
        mean_v = v.float().mean(dim=1).repeat_interleave(hq // hkv, dim=1)  # [B, Hq, D]
        pad = got[~rows].float()                                           # [rows, Hq, D]
        ref = mean_v[:, None].expand(b, s, hq, d)[~rows]
        err, tol, _ = chip_smoke.out_errors(pad, ref)
        assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

# ids 0 in rows 200-399: key and query chunks 4 and 5 (rows 256-383) hold
# only padding
_GAP = [[1] * 200 + [0] * 200 + [2] * 600]
_INTERLEAVED = [[1, 2] * 512]  # every chunk spans ids 1-2: the range skip drops nothing
_PACKED3 = [[1] * 400 + [2] * 500 + [3] * 124]

_BWD_CASES = {
    # name: (b, s, hq, hkv, d, causal, segments, fused projection views)
    "ragged-s1000-d64": (2, 1000, 3, 3, 64, False, None, False),
    "ragged-s1000-causal-d128": (1, 1000, 2, 2, 128, True, None, False),
    "causal-diagonal-d64": (1, 640, 2, 2, 64, True, None, False),
    "padding-tail-causal-d128": (1, 1000, 2, 2, 128, True, _PAD, False),
    "padding-tail-d64": (1, 1000, 2, 2, 64, False, _PAD, False),
    "all-padding-tiles-d128": (1, 1000, 2, 2, 128, False, _GAP, False),
    "all-padding-tiles-causal-d64": (1, 1000, 2, 2, 64, True, _GAP, False),
    "interleaved-ids-d64": (1, 1024, 2, 2, 64, False, _INTERLEAVED, False),
    "interleaved-ids-causal-d128": (1, 1024, 2, 2, 128, True, _INTERLEAVED, False),
    "gqa-32-8-causal-segments-d128": (1, 1024, 32, 8, 128, True, _PACKED3, False),
    "fused-projection-views-d64": (2, 768, 4, 4, 64, False, None, True),
    "fused-projection-views-gqa-d128": (1, 1024, 4, 2, 128, True, None, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_flash_backward_kernel_edge_cases_on_card(case):
    _card()
    b, s, hq, hkv, d, causal, segments, fused = _BWD_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _qkv(b, s, hq, hkv, d, fused, gen)
    do = torch.randn((b, s, hq, d), generator=gen, device="cuda").bfloat16()
    seg = None
    if segments is not None:
        seg = torch.tensor(segments * b, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    out, lse = patt.flash_attention_cuda(q, k, v, seg, seg, causal=causal, sm_scale=scale,
                                         return_lse=True)
    kw = dict(causal=causal, sm_scale=scale)
    before = patt.flash_attention_bwd_cuda.launches
    got = patt.flash_attention_bwd_cuda(q, k, v, do, out, lse, seg, seg, **kw)
    again = patt.flash_attention_bwd_cuda(q, k, v, do, out, lse, seg, seg, **kw)
    want = patt.flash_attention_bwd_reference(q, k, v, do, out, lse, seg, seg, **kw)
    torch.cuda.synchronize()
    assert patt.flash_attention_bwd_cuda.launches == before + 2
    # the kernel's own tile count agrees with the plain skip rule
    share = chip_smoke.flash_bwd_tile_share(q, k, v, do, out, lse, seg, causal, scale)
    assert all(0.0 < x <= 1.0 for x in share.values()), share
    for label, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g_, a_), f"{label}: two calls gave different bits"
        assert torch.isfinite(g_.float()).all(), label
        err, tol, rel_rms = chip_smoke.grad_errors(g_, w_)
        assert err <= tol and rel_rms <= chip_smoke.GRAD_REL_RMS, (label, err, tol, rel_rms)
        if seg is not None and (seg == 0).any():
            # padding rows: no gradient to their queries, nothing from their keys
            assert g_[seg == 0].float().abs().max().item() == 0.0, label


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _w4_check(k, n, b, xdtype, gen):
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    wq = pq4.quantize_int4(w)
    x = torch.randn((b, k), generator=gen, device="cuda").to(xdtype)
    before = pq4.w4_matmul_cuda.launches
    got, again = pq4.w4_matmul(x, wq), pq4.w4_matmul(x, wq)
    want = pq4.w4_matmul_reference(x, wq)
    torch.cuda.synchronize()
    assert pq4.w4_matmul_cuda.launches == before + 2
    assert got.dtype == xdtype and got.shape == (b, n)
    assert torch.equal(got, again)
    err, tol, rel_rms = chip_smoke.w4_errors(got, want)
    assert err <= tol and rel_rms <= chip_smoke.W4_REL_RMS, (err, tol, rel_rms)


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 9))
def test_w4_kernel_every_batch_on_card(b):
    _card()
    # K 11008: 43 chunks over 4 warps a block, split across blocks
    _w4_check(11008, 1024, b, torch.bfloat16, torch.Generator(device="cuda").manual_seed(b))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,b,xdtype", [
    (256, 128, 1, torch.bfloat16),     # the smallest shape: one chunk, one column tile
    (256, 128, 8, torch.float32),
    (4096, 4096, 3, torch.float32),    # float32 x, rounded to bf16 inside
    (4096, 32000, 1, torch.float32),   # the 32000-wide head
])
def test_w4_kernel_small_and_float32_on_card(k, n, b, xdtype):
    _card()
    _w4_check(k, n, b, xdtype, torch.Generator(device="cuda").manual_seed(k + n + b))
