"""Attention ops (port of ``dreamllm_tpu/ops/attention.py``): the plain
PyTorch attention, and flash attention with its hand-written Hopper kernels:
the forward (``csrc/flash_fwd.cu``, the counterpart of the TPU kernel
``_flash_kernel_t``) and the backward (``csrc/flash_bwd.cu``, the counterpart
of ``_flash_bwd_kernel``), joined by :class:`_FlashCore` so that autograd
runs the backward kernel.

Layout is BSHD throughout. Padding and packing are segment ids (0 =
padding). GQA maps query head ``h`` to KV head ``h // (Hq // Hkv)`` without
copying K/V. Masked scores are the finite ``NEG_INF``, never ``-inf``, so a
fully masked row gives a finite (garbage-by-contract) output.

Dispatch in :func:`flash_attention` copies the JAX package's eligibility
rule. Shapes outside it take :func:`dot_product_attention`, as XLA took them
in JAX. Inside it, a CPU tensor takes :func:`flash_attention_reference`
(the kernel's plain version) and a CUDA tensor launches the kernel or
raises; nothing falls back. Both kernels take bfloat16 only: a float32 CUDA
call inside the rule raises, with or without gradients.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30  # large finite negative; avoids NaN from (-inf) - (-inf)


# ---------------------------------------------------------------------------
# Plain attention
# ---------------------------------------------------------------------------


def _mask(b, sq, skv, device, causal, segment_ids, kv_segment_ids):
    """Boolean keep-mask broadcastable to ``[B, Hkv, G, Sq, Skv]``, or None."""
    mask = None
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (skv - sq)  # right-aligned
        ki = torch.arange(skv, device=device)[None, :]
        mask = (ki <= qi)[None, None, None]
    if segment_ids is not None or kv_segment_ids is not None:
        # kv_segment_ids alone marks padded KV with 0, valid KV with 1; the
        # queries then form one segment
        qseg = (segment_ids if segment_ids is not None
                else torch.ones((b, sq), dtype=torch.int32, device=device))
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        seg = (qseg[:, :, None] == kv_seg[:, None, :]) & (qseg[:, :, None] != 0)
        seg = seg[:, None, None]
        mask = seg if mask is None else (mask & seg)
    return mask


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Plain attention with fp32 scores and softmax. BSHD, GQA-aware.

    q: ``[B, Sq, Hq, D]``; k/v: ``[B, Skv, Hkv, D]`` with ``Hq % Hkv == 0``.
    Segment ids follow the JAX contract (0 = padding; ``kv_segment_ids``
    alone masks padded KV). ``bias`` is added to the scores after masking.

    Products take the operands in float32: a bf16 x bf16 product is exact
    in float32, so this is the JAX package's "bf16 operands, fp32
    accumulation" without rounding the scores to bf16. The probabilities
    are rounded to ``v.dtype`` before the P·V product, as in JAX.

    Returns ``out`` ``[B, Sq, Hq, D]``, and with ``return_lse`` also the
    float32 log-sum-exp ``[B, Sq, Hq]``.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of KV heads {hkv}")
    groups = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    qg = q.reshape(b, sq, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * sm_scale
    mask = _mask(b, sq, skv, q.device, causal, segment_ids, kv_segment_ids)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    if bias is not None:
        scores = scores + bias.float()

    if not return_lse:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
        return out.reshape(b, sq, hq, d).to(q.dtype)

    m = scores.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)  # masked rows stay finite
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = (p / denom).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    lse = (m + torch.log(denom))[..., 0]            # [B, Hkv, G, Sq]
    lse = lse.reshape(b, hq, sq).transpose(1, 2)    # -> [B, Sq, Hq]
    return out.reshape(b, sq, hq, d).to(q.dtype), lse


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_eligible(q_shape, k_shape, *, causal: bool = False) -> bool:
    """The JAX package's rule for running the flash kernel on a shape
    (``dreamllm_tpu/ops/attention.py`` ``flash_attention``), copied as it
    is: its default blocks, ``d % 128 == 0 or d == 64``, ``sq >= 128``,
    ``d == 64 => sq >= 512``, ``skv >= 128``, block divisibility, and causal
    only when ``sq == skv``. The blocks only feed the rule: the Hopper
    kernel tiles by 64 rows whatever they are."""
    d = q_shape[-1]
    sq, skv = q_shape[1], k_shape[1]
    block_q = 256 if d == 64 else 1024
    while block_q > 128 and sq % min(block_q, sq) != 0:
        block_q //= 2
    block_k = 1024
    while block_k > 128 and skv % min(block_k, skv) != 0:
        block_k //= 2
    return (
        (d % 128 == 0 or d == 64)
        and sq >= 128
        and (d % 128 == 0 or sq >= 512)
        and skv >= 128
        and sq % min(block_q, sq) == 0
        and skv % min(block_k, skv) == 0
        and (not causal or sq == skv)
    )


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    *,
    causal: bool,
    sm_scale: float,
    return_lse: bool = False,
):
    """The kernel's plain version: same arguments, same outputs (LSE as
    ``[B, Hq, Sq]`` float32). The CPU path of :func:`flash_attention`, and
    what ``chip_smoke.py`` holds the kernel against on the card."""
    out = dot_product_attention(
        q, k, v, causal=causal, segment_ids=qseg, kv_segment_ids=kseg,
        sm_scale=sm_scale, return_lse=return_lse,
    )
    if return_lse:
        out, lse = out
        return out, lse.transpose(1, 2).contiguous()
    return out


_BF16_ONLY = ("the flash kernels (forward csrc/flash_fwd.cu, backward csrc/flash_bwd.cu) "
              "take bfloat16 only on CUDA, got {name}.dtype={dtype}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"flash kernel: {name} needs a contiguous head dim, strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(
            f"flash kernel: {name} rows must be 16-byte aligned, strides {t.stride()}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    *,
    causal: bool,
    sm_scale: float,
    return_lse: bool = False,
):
    """Launch the Hopper kernel (``csrc/flash_fwd.cu``) on the current
    stream. bf16 BSHD q/k/v, read through their strides; head_dim 64 or
    128; ``causal`` needs ``sq == skv``. Raises on anything else."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.bfloat16:
            raise TypeError(_BF16_ONLY.format(name=name, dtype=t.dtype))
        _check_rows(name, t)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if d not in (64, 128):
        raise NotImplementedError(f"flash kernel: head_dim {d} (built for 64 and 128)")
    if hq % hkv or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if causal and sq != skv:
        raise ValueError("flash kernel: causal needs sq == skv")
    if (qseg is None) != (kseg is None):
        raise ValueError("flash kernel: pass both segment arrays or neither")

    from dreamllm_tpu_torch.ops import _build

    lib = _build.load("flash_fwd.cu")
    if not getattr(lib, "_dl_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dl_flash_fwd_bf16.argtypes = (
            [P] * 7 + [I] * 6 + [L] * 14 + [ctypes.c_float, I, P])
        lib.dl_flash_fwd_bf16.restype = I
        lib.dl_cuda_error_string.argtypes = [I]
        lib.dl_cuda_error_string.restype = ctypes.c_char_p
        lib._dl_typed = True

    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if qseg is not None:
        qseg = qseg.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kseg.to(device=q.device, dtype=torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        b, sq, skv, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        qseg.stride(0) if qseg is not None else 0,
        kseg.stride(0) if kseg is not None else 0,
        float(sm_scale), int(causal), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash kernel launch failed: {lib.dl_cuda_error_string(err).decode()} ({err})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    *,
    causal: bool,
    sm_scale: float,
):
    """The backward kernel's plain version: the same recurrence on whole
    tensors. ``P = exp(S - LSE)`` exactly from the saved LSE ``[B, Hq, Sq]``,
    ``delta = rowsum(dO * O)``, ``dS = P * (dP - delta) * sm_scale``, with P
    and dS rounded to the input dtype before their products and float32
    accumulation. Masked pairs have ``P = 0`` by the mask, not by the LSE,
    so padding rows get zero dQ and add nothing to dK/dV. Returns
    ``(dq, dk, dv)`` in the input dtype. The CPU path of autograd through
    :func:`flash_attention`, and what ``chip_smoke.py`` holds the kernel
    against on the card."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    dtype = q.dtype
    qg = q.reshape(b, sq, hkv, groups, d).float()
    dog = do.to(dtype).reshape(b, sq, hkv, groups, d).float()
    kf, vf = k.float(), v.float()

    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * sm_scale
    lse_g = lse.reshape(b, hkv, groups, sq)[..., None]
    mask = _mask(b, sq, skv, q.device, causal, qseg, kseg)
    if mask is not None:
        p = torch.exp(s.masked_fill(~mask, NEG_INF) - lse_g).masked_fill(~mask, 0.0)
    else:
        p = torch.exp(s - lse_g)
    delta = (do.to(dtype).float() * out.float()).sum(-1)             # [B, Sq, Hq]
    delta = delta.reshape(b, sq, hkv, groups).permute(0, 2, 3, 1)[..., None]

    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = (p * (dp - delta) * sm_scale).to(dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


BWD_TILE = 64  # rows of the backward kernel's streamed tiles and range chunks


def bwd_tiles(d: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(query rows, key rows) of one tile pair of the backward kernel's dK/dV
    pass and of its dQ pass at head dim ``d``. Mirrors ``launch<D>`` in
    ``csrc/flash_bwd.cu``: a block owns 128 rows and streams 64-row tiles,
    128-row query tiles in the dK/dV pass at head dim 64."""
    return (BWD_TILE if d == 128 else 2 * BWD_TILE, 2 * BWD_TILE), (2 * BWD_TILE, BWD_TILE)


def segment_tile_ranges(seg: torch.Tensor, tile: int = BWD_TILE):
    """Per ``tile``-row chunk of ``seg`` ``[B, S]``: ``(lo, hi, has_zero)``,
    each ``[B, ceil(S / tile)]``. ``lo``/``hi`` are the least and largest
    nonzero id (``lo > hi`` when the chunk has none); ``has_zero`` says
    whether it holds a 0 (padding). Rows past ``S`` are in no chunk. The
    plain version of the range kernel of ``csrc/flash_bwd.cu``."""
    b, s = seg.shape
    n = -(-s // tile)
    pad = n * tile - s
    seg = seg.to(torch.int64)
    big = torch.iinfo(torch.int64).max
    nz = torch.nn.functional.pad(seg != 0, (0, pad)).reshape(b, n, tile)
    ids = torch.nn.functional.pad(seg, (0, pad)).reshape(b, n, tile)
    valid = torch.nn.functional.pad(torch.ones_like(seg, dtype=torch.bool), (0, pad))
    lo = torch.where(nz, ids, big).amin(-1)
    hi = torch.where(nz, ids, -big).amax(-1)
    has_zero = (~nz & valid.reshape(b, n, tile)).any(-1)
    return lo, hi, has_zero


def flash_bwd_tile_pairs(
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    sq: int,
    skv: int,
    *,
    causal: bool,
    q_tile: int = BWD_TILE,
    k_tile: int = BWD_TILE,
) -> torch.Tensor:
    """The backward kernel's skip rule in plain PyTorch: a bool
    ``[B, ceil(sq / q_tile), ceil(skv / k_tile)]`` (``B`` 1 without
    segments) that is True for each (query tile, key tile) pair the kernel
    computes, at the tiles of one pass (:func:`bwd_tiles`). A pair is
    skipped when causal puts every key after every query, or, with
    segment ids, when the query tile has no nonzero id, the key tile has
    none, or their ranges of nonzero ids are disjoint: no kept pair of
    :func:`_mask` lies in a skipped tile. The wrapper does not call it; the
    tests do, and ``chip_smoke.py`` holds the kernel's own count
    (:func:`flash_bwd_tiles_computed`) to it."""
    nq, nk = -(-sq // q_tile), -(-skv // k_tile)
    keep = torch.ones((1, nq, nk), dtype=torch.bool)
    if causal:
        iq = torch.arange(nq)[:, None]
        jk = torch.arange(nk)[None, :]
        keep = keep & (jk * k_tile <= iq * q_tile + q_tile - 1)[None]
    if qseg is not None:
        qlo, qhi, _ = (x.cpu() for x in segment_tile_ranges(qseg, q_tile))
        klo, khi, _ = (x.cpu() for x in segment_tile_ranges(kseg, k_tile))
        meet = ((qlo <= qhi)[:, :, None] & (klo <= khi)[:, None, :]
                & (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None]))
        keep = keep & meet
    return keep


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    *,
    causal: bool,
    sm_scale: float,
):
    """Launch the Hopper backward (``csrc/flash_bwd.cu``) on the current
    stream: one C call that runs the delta kernel, with segment ids the
    kernel that writes each 64-row chunk's id range, and one launch of the
    dK/dV and dQ passes (tile pairs skipped as :func:`flash_bwd_tile_pairs`
    says). Same contract as :func:`flash_attention_cuda` (bf16 BSHD through
    strides, head_dim 64 or 128, causal needs ``sq == skv``); ``lse`` is the
    forward's float32 ``[B, Hq, Sq]``. Raises on anything else.
    ``flash_attention_bwd_cuda.launches`` counts launches, this function's
    and :func:`flash_bwd_tiles_computed`'s."""
    return _flash_bwd_launch(q, k, v, do, out, lse, qseg, kseg, causal, sm_scale, None)


def flash_bwd_tiles_computed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    qseg: torch.Tensor | None,
    kseg: torch.Tensor | None,
    *,
    causal: bool,
    sm_scale: float,
) -> dict[str, tuple[int, int]]:
    """Launch the backward as :func:`flash_attention_bwd_cuda` does (one
    more count) and return the kernel's own count of tile pairs, per pass
    (``"dkv"``, ``"dq"``): ``(computed, causal)``, the pairs its blocks
    staged and the pairs causality alone leaves, at :func:`bwd_tiles`' sizes
    and summed over heads and batch."""
    tiles = torch.zeros(4, dtype=torch.int32, device=q.device)
    _flash_bwd_launch(q, k, v, do, out, lse, qseg, kseg, causal, sm_scale, tiles)
    c = tiles.tolist()
    return {"dkv": (c[0], c[1]), "dq": (c[2], c[3])}


def _flash_bwd_launch(q, k, v, do, out, lse, qseg, kseg, causal, sm_scale, tiles):
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(s % 8 for s in do.stride()[:-1]):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.bfloat16:
            raise TypeError(_BF16_ONLY.format(name=name, dtype=t.dtype))
        _check_rows(name, t)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if d not in (64, 128):
        raise NotImplementedError(f"flash kernel: head_dim {d} (built for 64 and 128)")
    if (hq % hkv or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d
            or do.shape != q.shape or out.shape != q.shape):
        raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)} out{tuple(out.shape)}")
    if causal and sq != skv:
        raise ValueError("flash kernel: causal needs sq == skv")
    if (qseg is None) != (kseg is None):
        raise ValueError("flash kernel: pass both segment arrays or neither")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_cuda:
        raise ValueError(f"flash kernel: lse must be CUDA float32 [B, Hq, Sq], got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    lse = lse.contiguous()

    from dreamllm_tpu_torch.ops import _build

    lib = _build.load("flash_bwd.cu")
    if not getattr(lib, "_dl_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dl_flash_bwd_bf16.argtypes = (
            [P] * 14 + [I] * 6 + [L] * 26 + [ctypes.c_float, I, P])
        lib.dl_flash_bwd_bf16.restype = I
        lib.dl_cuda_error_string.argtypes = [I]
        lib.dl_cuda_error_string.restype = ctypes.c_char_p
        lib._dl_typed = True

    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    ranges = None
    if qseg is not None:
        qseg = qseg.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kseg.to(device=q.device, dtype=torch.int32).contiguous()
        # per 64-row chunk of queries and of keys: (lo, hi, has a 0, -)
        chunks = -(-sq // BWD_TILE) + -(-skv // BWD_TILE)
        ranges = torch.empty(4 * b * chunks, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl_flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        ranges.data_ptr() if ranges is not None else None,
        tiles.data_ptr() if tiles is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, skv, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *out.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        qseg.stride(0) if qseg is not None else 0,
        kseg.stride(0) if kseg is not None else 0,
        float(sm_scale), int(causal), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash backward launch failed: {lib.dl_cuda_error_string(err).decode()} ({err})")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class _FlashCore(torch.autograd.Function):
    """Forward kernel + backward kernel as one differentiable op (the
    counterpart of the JAX package's ``_flash_core`` custom VJP). The
    forward saves ``(q, k, v, qseg, kseg, out, lse)``; the backward runs the
    backward kernel on CUDA and its plain version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, sm_scale):
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_reference
        out, lse = fwd(q, k, v, qseg, kseg, causal=causal, sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, qseg, kseg, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, qseg, kseg, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, do, out, lse, qseg, kseg,
                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Flash attention, BSHD. The kernel on CUDA, its plain version on the
    CPU, :func:`dot_product_attention` for shapes outside the JAX rule.
    Differentiable: when an input requires grad the call goes through
    :class:`_FlashCore`, whose backward is the backward kernel on CUDA and
    its plain version on the CPU. Both kernels take bfloat16 only: a float32
    CUDA call inside the rule raises. ``flash_attention.launches`` counts
    forward launches, ``flash_attention_bwd_cuda.launches`` backward ones.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not flash_eligible(q.shape, k.shape, causal=causal):
        return dot_product_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                     kv_segment_ids=kv_segment_ids, sm_scale=sm_scale)
    if segment_ids is not None or kv_segment_ids is not None:
        b, sq = q.shape[:2]
        qseg = (segment_ids if segment_ids is not None
                else torch.ones((b, sq), dtype=torch.int32, device=q.device))
        kseg = kv_segment_ids if kv_segment_ids is not None else segment_ids
    else:
        qseg = kseg = None  # no segment compare at all in the kernel
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no path for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashCore.apply(q, k, v, qseg, kseg, causal, sm_scale)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, qseg, kseg, causal=causal, sm_scale=sm_scale)
    return flash_attention_reference(q, k, v, qseg, kseg, causal=causal, sm_scale=sm_scale)


flash_attention.launches = 0
