"""Weight-only int4 (w4a16) group quantization (port of
``dreamllm_tpu/ops/quant4.py``) with its hand-written Hopper matmul kernel
``csrc/w4a16.cu`` (the counterpart of the TPU kernel ``_w4_kernel``).

Scheme, as in the JAX package: group-wise symmetric int4, group 128 along
the contraction dim,

    scale[g, n] = max|W[128g:128(g+1), n]| / 7
    q           = clip(round(W / scale), -8, 7)        stored as (q+8) in [0,15]

packed two nibbles a byte, the two nibbles from DIFFERENT halves of K:
``packed[i, n] = (q[i, n]+8) | (q[i + K/2, n]+8) << 4``.

The port keeps one dict per decoder layer, so a :class:`Q4Tensor` here is
2-D: ``packed`` uint8 ``[K/2, N]``, ``scale`` float32 ``[K/128, N]``.

:func:`w4_matmul` copies the JAX package's gate: the kernel's function runs
for 2-D x with at most 8 rows, ``K/2 % 128 == 0`` and ``N % 128 == 0``
(JAX's "a 128-multiple column block that divides N, up to 8192" exists
exactly then); every other shape takes ``x @ dequantize_int4(t, x.dtype)``,
as XLA took it in JAX. So DreamLLM's 32064-wide ``lm_head`` (not a multiple
of 128) takes the float32 dequantize path in both packages, and a 32000-wide
head takes the kernel with float32 x. Inside the gate a CPU tensor runs
:func:`w4_matmul_reference` (the kernel's plain version) and a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

GROUP = 128  # quantization group length along K
_BLK_K = 128  # packed rows per kernel chunk (one group in each half of K)
_MAX_ROWS = 8  # activation rows the kernel takes (the decode regime)


@dataclasses.dataclass
class Q4Tensor:
    packed: torch.Tensor  # uint8 [K//2, N]: low nibble = first K-half
    scale: torch.Tensor   # float32 [K//GROUP, N] per-group scales

    @property
    def shape(self):  # logical (unpacked) shape
        kp, n = self.packed.shape
        return (kp * 2, n)

    @property
    def ndim(self):
        return self.packed.ndim

    @property
    def dtype(self):
        return self.packed.dtype

    def numel(self) -> int:  # logical (unpacked) element count
        return self.packed.numel() * 2

    def nbytes(self) -> int:
        return self.packed.numel() + 4 * self.scale.numel()

    def to(self, device) -> "Q4Tensor":
        return Q4Tensor(self.packed.to(device), self.scale.to(device))


def quantize_int4(w: torch.Tensor) -> Q4Tensor:
    """Group-128 symmetric int4 over the contraction axis of a 2-D ``[K, N]``
    weight; bit-exact with the JAX package's compiled quantization
    (``jax.jit``, as its serving builds it, or ``lax.map`` over stacked
    layers, one matrix at a time). Requires ``K % 256 == 0`` (two 128-row
    halves a packed byte row)."""
    if w.ndim != 2:
        raise ValueError(f"quantize_int4 takes one 2-D [K, N] weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    if k % (2 * GROUP):
        raise ValueError(f"K={k} must be divisible by {2 * GROUP}")
    wf = w.float().reshape(k // GROUP, GROUP, n)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    # amax * float32(1/7): what JAX computes where it quantizes for serving,
    # under jit (XLA turns the division by the constant into that product;
    # JAX's eager call divides, and may differ by an ulp in a scale)
    scale = (amax * amax.new_tensor(1.0 / 7.0)).clamp_min(1e-10)
    q = torch.round(wf / scale).clamp(-8, 7).reshape(k, n)  # half to even, as jnp.round
    u = (q + 8).to(torch.uint8)
    lo, hi = u[: k // 2], u[k // 2:]
    return Q4Tensor(packed=lo | (hi << 4), scale=scale.reshape(k // GROUP, n).contiguous())



def dequantize_int4(t: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    p = t.packed
    lo = (p & 0xF).to(torch.int8) - 8
    hi = ((p >> 4) & 0xF).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=0).float()
    k, n = q.shape
    w = (q.reshape(k // GROUP, GROUP, n) * t.scale[:, None, :]).reshape(k, n)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# The kernel's function: plain version and CUDA launch
# ---------------------------------------------------------------------------


def kernel_takes(x_shape, t: Q4Tensor) -> bool:
    """The JAX package's gate (``w4_matmul``'s ``ok``), without its "on a
    TPU or in interpret mode" clause: 2-D x with 1..8 rows (JAX pads 0..8 to
    8; an empty x is left to the plain product here), ``K/2 % 128 == 0``
    and ``N % 128 == 0``."""
    kp, n = t.packed.shape
    return (len(x_shape) == 2 and 1 <= x_shape[0] <= _MAX_ROWS
            and kp % _BLK_K == 0 and n % 128 == 0)


def w4_matmul_reference(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    """The kernel's plain version: x rounded to bf16; per 128-row group and
    column ``(x . u - 8 * sum x) * scale`` in float32 (u the stored nibble,
    0..15), the low-half group of each packed chunk first; groups added in
    float32; the result cast to ``x.dtype``. The CPU path of
    :func:`w4_matmul`, and what ``chip_smoke.py`` holds the kernel against."""
    kp, n = t.packed.shape
    b = x.shape[0]
    n_chunks = kp // _BLK_K
    xb = x.to(torch.bfloat16).float().reshape(b, 2 * n_chunks, GROUP)  # [B, groups, 128]
    p = t.packed
    u = torch.cat([p & 0xF, p >> 4], dim=0).float().reshape(2 * n_chunks, GROUP, n)
    dots = torch.einsum("bgk,gkn->bgn", xb, u)                        # [B, groups, N]
    corr = 8.0 * xb.sum(dim=-1)                                       # [B, groups]
    per = (dots - corr[..., None]) * t.scale[None]
    chunk = per[:, :n_chunks] + per[:, n_chunks:]                     # low group + high group
    return chunk.sum(dim=1).to(x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132  # streaming multiprocessors of an H100 SXM
_WARPS = 4  # warps a kernel block


def _plan(kp: int, n: int) -> tuple[int, int]:
    """The kernel's grid: ``(tiles, blocks_k)``. A block's four warps own
    ``tiles`` neighbouring 128-column tiles and split K ``4 / tiles`` ways;
    ``blocks_k`` blocks (one thread block cluster) share those columns, so
    the grid is ``(ceil(n / (128 * tiles)), blocks_k)`` and K is split
    ``blocks_k * 4 / tiles`` ways, each a run of whole 128-row chunks.

    Four tiles a block where that fills the H100's 132 SMs: ``blocks_k`` the
    power of two up to 16 that gives each warp at least two chunks and the
    grid at most three blocks an SM, doubled (up to one chunk a warp) while
    the grid has fewer blocks than SMs. Where even that leaves fewer blocks
    than SMs (the 4096-wide projections), one tile a block and up to 8
    blocks, each warp at least one chunk: more, shorter runs. Measured at
    the 7B shapes (PERF.md)."""
    chunks = kp // _BLK_K
    col_blocks = -(-(n // 128) // _WARPS)
    bk = 1
    while 2 * bk <= min(16, chunks // 2) and col_blocks * 2 * bk <= 3 * _SMS:
        bk *= 2
    while col_blocks * bk < _SMS and 2 * bk <= min(16, chunks):
        bk *= 2
    if col_blocks * bk >= _SMS:
        return _WARPS, bk
    bk = 1
    while 2 * bk <= 8 and _WARPS * 2 * bk <= chunks and (n // 128) * 2 * bk <= 3 * _SMS:
        bk *= 2
    return 1, bk


def w4_matmul_cuda(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/w4a16.cu``) on the current stream.
    x: contiguous CUDA ``[B, K]``, 1 <= B <= 8, float32 or bfloat16; t on
    the same card, packed uint8 ``[K/2, N]`` and scale float32
    ``[K/128, N]``, contiguous, ``K/2 % 128 == 0``, ``N % 128 == 0``.
    Returns ``[B, N]`` in x's dtype. Raises on anything else.
    ``w4_matmul_cuda.launches`` counts launches."""
    p, s = t.packed, t.scale
    if not (x.is_cuda and p.is_cuda and s.is_cuda):
        raise ValueError(f"w4a16 kernel: x, packed, scale must be CUDA tensors, got "
                         f"{x.device}, {p.device}, {s.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"w4a16 kernel takes float32 or bfloat16 x, got {x.dtype}")
    if p.dtype != torch.uint8 or s.dtype != torch.float32:
        raise TypeError(f"w4a16 kernel: packed must be uint8 and scale float32, got "
                        f"{p.dtype}, {s.dtype}")
    kp, n = p.shape
    if x.ndim != 2 or not 1 <= x.shape[0] <= _MAX_ROWS or x.shape[1] != 2 * kp:
        raise ValueError(f"w4a16 kernel: x {tuple(x.shape)} against packed {tuple(p.shape)} "
                         f"(need [1..{_MAX_ROWS}, {2 * kp}])")
    if kp % _BLK_K or n % 128 or tuple(s.shape) != (2 * kp // GROUP, n):
        raise ValueError(f"w4a16 kernel: packed {tuple(p.shape)}, scale {tuple(s.shape)}")
    if not (x.is_contiguous() and p.is_contiguous() and s.is_contiguous()):
        raise ValueError("w4a16 kernel: x, packed and scale must be contiguous")
    if p.data_ptr() % 16 or x.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("w4a16 kernel: x, packed and scale must be 16-byte aligned")
    b = x.shape[0]
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)

    from dreamllm_tpu_torch.ops import _build

    lib = _build.load("w4a16.cu")
    if not getattr(lib, "_dl_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dl_w4a16.argtypes = [P] * 4 + [I] * 6 + [P]
        lib.dl_w4a16.restype = I
        lib.dl_cuda_error_string.argtypes = [I]
        lib.dl_cuda_error_string.restype = ctypes.c_char_p
        lib._dl_typed = True

    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dl_w4a16(x.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(),
                       _DTYPES[x.dtype], b, kp, n, *_plan(kp, n), stream)
    if err != 0:
        raise RuntimeError(
            f"w4a16 kernel launch failed: {lib.dl_cuda_error_string(err).decode()} ({err})")
    w4_matmul_cuda.launches += 1
    return out


w4_matmul_cuda.launches = 0


def w4_matmul(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    """``x [B, K] @ W`` with W a 2-D :class:`Q4Tensor`; returns x's dtype.
    Inside the gate (:func:`kernel_takes`) the kernel's function runs: its
    plain version on a CPU tensor, the kernel on a CUDA tensor (which
    launches or raises). Every other shape takes the dequantize product."""
    if not kernel_takes(x.shape, t):
        return x @ dequantize_int4(t, x.dtype)
    if x.device.type == "cpu":
        return w4_matmul_reference(x, t)
    return w4_matmul_cuda(x.contiguous(), t)


def _matmul4_impl(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    if x.ndim == 2:
        return w4_matmul(x, t)
    y = w4_matmul(x.reshape(-1, x.shape[-1]), t)
    return y.reshape(*x.shape[:-1], y.shape[-1])


class _Matmul4(torch.autograd.Function):
    """``x @ W`` differentiable in x: ``dx = g @ dequant(W)^T`` on the
    dequantized weight, no gradient for the (frozen, int4) weight; the
    counterpart of JAX's ``matmul4`` custom VJP, which QLoRA over an int4
    base needs."""

    @staticmethod
    def forward(ctx, x, packed, scale):
        ctx.save_for_backward(packed, scale)
        return _matmul4_impl(x, Q4Tensor(packed, scale))

    @staticmethod
    def backward(ctx, g):
        packed, scale = ctx.saved_tensors
        w = dequantize_int4(Q4Tensor(packed, scale), g.dtype)
        return g @ w.transpose(-1, -2), None, None


def matmul4(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    """x @ W for any leading x dims; the kernel's gate applies to the
    flattened rows. Goes through autograd only when x needs a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Matmul4.apply(x, t.packed, t.scale)
    return _matmul4_impl(x, t)


# the projections the quantized serving layouts store quantized
QUANTIZED_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gate_up")


def quantize_llama_params_int4(params: dict) -> dict:
    """int4-quantize the decoder's projections (fused layout included) and
    ``lm_head``, layer by layer; embeddings and norms keep their dtype."""
    out = dict(params)
    out["layers"] = [{k: quantize_int4(v) if k in QUANTIZED_KEYS else v for k, v in layer.items()}
                     for layer in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quantize_int4(params["lm_head"])
    return out
