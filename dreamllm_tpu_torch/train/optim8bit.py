"""8-bit AdamW (port of ``dreamllm_tpu/train/optim8bit.py``): Adam's moments
stored as int8 codes with one float32 absmax scale per 256-element block (a
linear code for m, a sqrt-space code for v), about 2.03 bytes of optimizer
state per parameter against 8 for float32 moments.

The fused update is the hand-written Hopper kernel ``csrc/adam8bit.cu``
(the counterpart of the TPU kernel ``_fused_adam_kernel``);
:func:`adam8bit_update_reference` is its plain version, the unfused math of
the JAX package. With ``fused_update=True`` a CUDA leaf launches the kernel
or raises and a CPU leaf takes the plain version; with ``fused_update=False``
the plain math runs everywhere by the caller's choice.

State is a plain tree: ``{"count", "m", "v"}`` with ``m``/``v`` mirroring the
parameters; a leaf is a :class:`_Moment`, a float32 tensor (small leaves and
``fp32_moments_mask``), or ``None`` where the parameter leaf is ``None``
(frozen). The port keeps one dict per layer where JAX stacks layers on a
leading axis, so ``min_8bit_size`` and the 256-blocks see PER-LAYER leaves
here: a ``[4096]`` norm is 4096 elements in the port and ``32 * 4096`` in
JAX's ``[32, 4096]`` stack. At the 7B widths every per-layer leaf is a
multiple of 256 and at least 4096 elements, so both packages make the same
choice and cut the same blocks.

The 256-blocks run over a leaf in the JAX package's element order. That is
the row-major order of every leaf but a conv kernel: the port stores those
OIHW and JAX stores HWIO, so a 4-D leaf is blocked in HWIO order here too
(:func:`_logical`), in the plain math and on its way to the kernel. Both
packages then cut the same blocks and compute the same scales, and
``bridge.opt_state_from_jax`` carries such moments as they are.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, NamedTuple

import torch

from dreamllm_tpu_torch.train.tree import broadcast_prefix, tree_leaves, tree_map

BLOCK = 256


class GradientTransformation(NamedTuple):
    """An ``(init, update)`` pair: ``init(params) -> state`` and
    ``update(grads, state, params=None, *, skip=None) -> (updates, state)``.
    ``skip`` is a 0-d bool tensor on the gradients' device: where true, the
    update is zeros and the state comes back unchanged, without a host sync."""

    init: Callable
    update: Callable


class _Moment(NamedTuple):
    codes: torch.Tensor  # int8 [n_blocks, BLOCK]
    scale: torch.Tensor  # float32 [n_blocks]


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device (PyTorch's CUDA kernels
    turn division by a Python scalar into a product with its reciprocal)."""
    return x / x.new_tensor(c)


def _logical(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the order its blocks run: a 4-D (OIHW) conv kernel as HWIO,
    the JAX package's layout; any other leaf as it is."""
    return x.permute(2, 3, 1, 0) if x.ndim == 4 else x


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    flat = _logical(x).reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _quant_blocks(xb: torch.Tensor, floor_positive: bool = False) -> _Moment:
    scale = xb.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.round(xb / safe * 127.0).to(torch.int8)  # half to even, as jnp.round
    if floor_positive:
        codes = torch.where((xb > 0.0) & (codes == 0), torch.ones_like(codes), codes)
    return _Moment(codes, scale[:, 0])


def _dequant(mq: _Moment) -> torch.Tensor:
    return mq.codes.float() * _div(mq.scale, 127.0)[:, None]


def _unblock(xb: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`_to_blocks`: a 4-D ``shape`` is OIHW, its blocks
    HWIO."""
    n = 1
    for s in shape:
        n *= s
    flat = xb.reshape(-1)[:n]
    if len(shape) == 4:
        o, i, h, w = shape
        return flat.reshape(h, w, i, o).permute(3, 2, 0, 1)
    return flat.reshape(tuple(shape))


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK, *, floor_positive: bool = False):
    """Any float tensor -> (int8 codes, flat and padded to whole blocks;
    float32 scales ``[ceil(n / block)]``). ``floor_positive``: a strictly
    positive entry never rounds to code 0."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    mq = _quant_blocks(blocks, floor_positive)
    return mq.codes.reshape(-1), mq.scale


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape, block: int = BLOCK):
    return _unblock(_dequant(_Moment(codes.reshape(-1, block), scale)), shape)


def quant_moment_m(x: torch.Tensor) -> _Moment:
    """float32 first moment -> stored :class:`_Moment` (linear code)."""
    return _quant_blocks(_to_blocks(x))


def quant_moment_v(x: torch.Tensor) -> _Moment:
    """float32 second moment -> stored :class:`_Moment`, in SQRT space:
    squared gradients span several orders of magnitude inside one block and a
    linear code would zero everything below blockmax/254; the square root
    halves the dynamic range and ``floor_positive`` keeps a small nonzero
    entry from dequantizing to exactly 0."""
    return _quant_blocks(torch.sqrt(_to_blocks(x).clamp_min(0.0)), floor_positive=True)


def dequant_moment_m(mq: _Moment, shape) -> torch.Tensor:
    return _unblock(_dequant(mq), shape)


def dequant_moment_v(mq: _Moment, shape) -> torch.Tensor:
    vsq = _dequant(mq)
    return _unblock(vsq * vsq, shape)


# ---------------------------------------------------------------------------
# The fused update: plain version and kernel
# ---------------------------------------------------------------------------


def adam8bit_update_reference(g, p, mq: _Moment, vq: _Moment, scalars, *, b1, b2, eps,
                              wd: float = 0.0, skip=None):
    """The kernel's plain version (the JAX package's unfused math): one leaf's
    dequantize -> Adam -> requantize, op by op on whole tensors. ``scalars``
    is a float32 tensor ``[lr, bc1, bc2]`` on the leaf's device. Returns
    ``(update, new_m, new_v)`` as new tensors; with ``skip`` true the update
    is zeros and the moments are the old ones."""
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    gb = _to_blocks(g)
    m = _dequant(mq)
    vsq = _dequant(vq)
    v = vsq * vsq
    m = b1 * m + (1.0 - b1) * gb
    v = b2 * v + (1.0 - b2) * gb * gb
    upd = _unblock((m / bc1) / (torch.sqrt(v / bc2) + eps), g.shape)
    if wd:
        upd = upd + wd * p.float()
    upd = (-lr * upd).to(g.dtype)
    new_m = _quant_blocks(m)
    new_v = _quant_blocks(torch.sqrt(v.clamp_min(0.0)), floor_positive=True)
    if skip is not None:
        upd = torch.where(skip, torch.zeros_like(upd), upd)
        new_m = _Moment(*(torch.where(skip, o, n) for o, n in zip(mq, new_m)))
        new_v = _Moment(*(torch.where(skip, o, n) for o, n in zip(vq, new_v)))
    return upd, new_m, new_v


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adam8bit_update_cuda(g, p, mq: _Moment, vq: _Moment, scalars, *, b1, b2, eps,
                         wd: float = 0.0, skip=None, out=None):
    """Launch the Hopper kernel (``csrc/adam8bit.cu``) on the current stream
    for one leaf. ``g`` and ``p``: contiguous CUDA tensors of one dtype
    (float32 or bfloat16) and shape; codes and scales are OVERWRITTEN IN
    PLACE; the update goes to ``out`` (which may be ``g`` itself) or a new
    tensor. ``scalars``: float32 ``[lr, bc1, bc2]`` on the device; ``skip``:
    0-d bool or int32 tensor on the device, or None. Raises on anything the
    kernel does not take. ``adam8bit_update_cuda.launches`` counts launches."""
    n = g.numel()
    nb = -(-n // BLOCK)
    if out is None:
        out = torch.empty_like(g)
    for name, t in (("g", g), ("p", p), ("out", out)):
        if not t.is_cuda or t.dtype != g.dtype or t.shape != g.shape or not t.is_contiguous():
            raise ValueError(f"adam8bit kernel: {name} must be a contiguous CUDA tensor of g's "
                             f"dtype and shape, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"adam8bit kernel: {name} is not 16-byte aligned")
    if g.dtype not in _DTYPES:
        raise TypeError(f"adam8bit kernel takes float32 or bfloat16, got {g.dtype}")
    for name, mo in (("m", mq), ("v", vq)):
        if (mo.codes.dtype != torch.int8 or tuple(mo.codes.shape) != (nb, BLOCK)
                or mo.scale.dtype != torch.float32 or tuple(mo.scale.shape) != (nb,)
                or not (mo.codes.is_cuda and mo.scale.is_cuda)
                or not (mo.codes.is_contiguous() and mo.scale.is_contiguous())):
            raise ValueError(f"adam8bit kernel: moment {name} must be CUDA int8 [{nb}, {BLOCK}] "
                             f"codes with float32 [{nb}] scales")
    if (not scalars.is_cuda or scalars.dtype != torch.float32 or scalars.numel() != 3
            or not scalars.is_contiguous()):
        raise ValueError("adam8bit kernel: scalars must be 3 contiguous CUDA float32 values")
    if skip is not None and (skip.dtype != torch.int32 or skip.device != g.device):
        skip = skip.to(device=g.device, dtype=torch.int32)

    from dreamllm_tpu_torch.ops import _build

    lib = _build.load("adam8bit.cu")
    if not getattr(lib, "_dl_typed", False):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.dl_adam8bit.argtypes = [P] * 9 + [L, I] + [F] * 6 + [P]
        lib.dl_adam8bit.restype = I
        lib.dl_cuda_error_string.argtypes = [I]
        lib.dl_cuda_error_string.restype = ctypes.c_char_p
        lib._dl_typed = True

    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dl_adam8bit(
        g.data_ptr(), p.data_ptr(), out.data_ptr(),
        mq.codes.data_ptr(), mq.scale.data_ptr(), vq.codes.data_ptr(), vq.scale.data_ptr(),
        scalars.data_ptr(), skip.data_ptr() if skip is not None else None,
        n, _DTYPES[g.dtype], b1, 1.0 - b1, b2, 1.0 - b2, eps, float(wd), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"adam8bit kernel launch failed: {lib.dl_cuda_error_string(err).decode()} ({err})")
    adam8bit_update_cuda.launches += 1
    return out


adam8bit_update_cuda.launches = 0


def adam8bit_update_fused(g, p, mq: _Moment, vq: _Moment, scalars, *, b1, b2, eps,
                          wd: float = 0.0, skip=None):
    """One CUDA leaf through the kernel, blocked as
    :func:`adam8bit_update_reference` blocks it: a 4-D (OIHW) leaf goes to
    the kernel in HWIO order and its update comes back as an OIHW view.
    Codes and scales are overwritten in place, and the update is written
    over the gradient in that order (the gradient's own storage where it is
    contiguous there: the gradient is consumed)."""
    gl = _logical(g).contiguous()
    pl = _logical(p).contiguous() if p is not None else gl
    upd = adam8bit_update_cuda(gl, pl, mq, vq, scalars, b1=b1, b2=b2, eps=eps, wd=wd,
                               skip=skip, out=gl)
    return upd.permute(3, 2, 0, 1) if g.ndim == 4 else upd


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------


def decay_flags(weight_decay: float, mask, params, grads):
    """Per-leaf bools with ``grads``' structure: does weight decay apply?
    ``mask`` is a callable on the parameters or a (prefix) tree of bools, as
    for ``optax.adamw``; without one, decay applies to every leaf."""
    on = weight_decay > 0.0 and params is not None
    tree = (mask(params) if callable(mask) else mask) if on else None
    if tree is None:
        return tree_map(lambda _: on, grads)
    return broadcast_prefix(tree, grads)


def _adam_fp32(g, p, m, v, lr, bc1, bc2, *, b1, b2, eps, wd, skip):
    """Plain AdamW on float32 moments (small leaves, ``fp32_moments_mask``)."""
    gf = g.float()
    new_m = b1 * m + (1.0 - b1) * gf
    new_v = b2 * v + (1.0 - b2) * torch.square(gf)
    upd = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
    if wd:
        upd = upd + wd * p.float()
    upd = (-lr * upd).to(g.dtype)
    if skip is not None:
        upd = torch.where(skip, torch.zeros_like(upd), upd)
        new_m = torch.where(skip, m, new_m)
        new_v = torch.where(skip, v, new_v)
    return upd, new_m, new_v


def adamw_8bit(
    learning_rate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mask: Any | None = None,
    fused_update: bool = True,
    min_8bit_size: int = 0,
    fp32_moments_mask: Any | None = None,
) -> GradientTransformation:
    """AdamW with int8 blockwise-quantized moments.

    ``learning_rate``: a float or a schedule ``f(count)``, read at the count
    BEFORE the increment (the first update uses ``f(0)``); the bias
    corrections use ``count + 1``. ``mask``: weight-decay mask, a callable on
    the parameters or a tree of bools (True = decay). ``min_8bit_size``:
    leaves with fewer elements keep float32 moments. ``fp32_moments_mask``:
    callable or tree of bools, True = float32 moments whatever the size (the
    embedding table: its rows see mostly-zero gradients, which blockwise int8
    moments decay badly). The choice is made at ``init`` and recorded by the
    stored type, so ``update`` dispatches without the masks.

    ``fused_update``: True sends every :class:`_Moment` leaf on a CUDA tensor
    to the fused kernel, which overwrites the leaf's codes and scales in
    place and writes the update over the gradient's storage (the gradient is
    consumed); a kernel that cannot launch raises. False runs the plain,
    unfused math, which returns new tensors. CPU leaves always take the plain
    math. The default follows the measurement on the H100 recorded in
    PERF.md (``chip_smoke.py`` times a full 7B update both ways).

    Parameters stay in their own dtype: the update is cast to the gradient's
    dtype and added to the (bf16) parameters by the caller; no float32 master
    copy is kept, as in the JAX package.
    """

    def init(params):
        fp32_tree = fp32_moments_mask(params) if callable(fp32_moments_mask) else fp32_moments_mask
        if fp32_tree is None:
            fp32_tree = tree_map(lambda _: False, params)
        else:
            fp32_tree = broadcast_prefix(fp32_tree, params)

        def make(quant):
            def one(p, f):
                if p is None:
                    return None
                zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                if bool(f) or p.numel() < min_8bit_size:
                    return zeros
                return quant(zeros)
            return one

        dev = next((p.device for p in tree_leaves(params) if p is not None), torch.device("cpu"))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(make(quant_moment_m), params, fp32_tree),
            "v": tree_map(make(quant_moment_v), params, fp32_tree),
        }

    def update(grads, state, params=None, *, skip=None):
        count = state["count"]
        new_count = count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
        bc1 = 1.0 - b1 ** new_count.float()
        bc2 = 1.0 - b2 ** new_count.float()
        scalars = torch.stack([lr, bc1, bc2])
        # the kernel reads the flag as an int: convert once, not once a leaf
        skip_flag = skip.to(torch.int32) if skip is not None and fused_update else None

        decay_tree = decay_flags(weight_decay, mask, params, grads)
        if params is None:
            params = tree_map(lambda _: None, grads)

        def step(g, mq, vq, p, do_decay):
            if g is None:
                return None, mq, vq
            wd = weight_decay if (do_decay and p is not None) else 0.0
            if not isinstance(mq, _Moment):
                return _adam_fp32(g, p, mq, vq, lr, bc1, bc2, b1=b1, b2=b2, eps=eps, wd=wd,
                                  skip=skip)
            if fused_update and g.device.type != "cpu":
                upd = adam8bit_update_fused(g, p, mq, vq, scalars, b1=b1, b2=b2, eps=eps, wd=wd,
                                            skip=skip_flag)
                return upd, mq, vq
            return adam8bit_update_reference(g, p, mq, vq, scalars, b1=b1, b2=b2, eps=eps,
                                             wd=wd, skip=skip)

        out = tree_map(step, grads, state["m"], state["v"], params, decay_tree)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)  # noqa: E731
        if skip is not None:
            new_count = torch.where(skip, count, new_count)
        return pick(0), {"count": new_count, "m": pick(1), "v": pick(2)}

    return GradientTransformation(init, update)
