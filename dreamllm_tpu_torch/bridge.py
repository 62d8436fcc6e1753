"""Bring a JAX parameter tree, or a JAX optimizer state, into the port.

``from_jax(tree, like)`` walks ``like``, a parameter tree of the port (from
its ``init_*`` functions, cheapest on ``device="meta"``), and fills every
leaf from the matching leaf of ``tree``, a nested dict/list of numpy arrays
taken from the JAX package (``jax.tree.map(np.asarray, params)``), or of
CPU tensors in the same layout (the port's ``convert/`` modules build such
trees; a stacked leaf is then sliced, not copied, on the CPU):

* a list in the port against a dict in JAX is a layer stack: JAX stacks the
  layers on a leading ``[L, ...]`` axis, the port keeps one dict per layer;
* a 4-D leaf is a conv kernel: JAX stores HWIO, the port OIHW (kept
  channels-last, as the port's own init stores it);
* matmul weights keep the JAX ``[in, out]`` layout (the port computes
  ``x @ W``), so they copy as they are;
* a quantized weight (the JAX package's ``Q4Tensor`` with ``packed`` and
  ``scale``, or ``QTensor`` with ``q`` and ``scale``, as numpy) fills a
  :class:`~dreamllm_tpu_torch.ops.quant4.Q4Tensor` or
  :class:`~dreamllm_tpu_torch.ops.quant.QTensor` of ``like`` field by
  field; a stacked ``[L, K/2, N]`` packed leaf gives one 2-D ``Q4Tensor`` a
  layer;
* an attached LoRA weight (the JAX package's ``LoRATensor`` with ``base``,
  ``a``, ``b`` and ``scale``) fills a
  :class:`~dreamllm_tpu_torch.ops.quant.LoRATensor`: its base as any other
  weight (raw or quantized), its stacked ``scale [L]`` one 0-d tensor a
  layer. A LoRA factor tree (``{"layers": {t: {"a": [L, in, r], "b": [L, r,
  out]}}}``) is a plain tree and crosses as one, one pair a layer.

Every leaf is cast to the dtype of its counterpart in ``like``. A leaf of
``like`` that ``tree`` lacks, a shape that disagrees, and a leaf of ``tree``
that nothing consumed all raise.

``opt_state_from_jax(state, like)`` does the same for an optimizer state of
the JAX package's ``make_optimizer`` (optax AdamW or ``Adam8bitState``),
given as numpy with its namedtuples intact, against the port's state from
``tx.init(params)``. Stored 8-bit moments cross as they are: the port cuts
its 256-blocks in the JAX element order, HWIO for a conv kernel
(``train/optim8bit.py``), so codes and scales mean the same in both.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.ops.quant import LoRATensor, QTensor
from dreamllm_tpu_torch.ops.quant4 import Q4Tensor

Path = tuple

# quantized weight types of the port -> their tensor fields, which the JAX
# package's classes of the same names carry too
_QUANT_FIELDS = {Q4Tensor: ("packed", "scale"), QTensor: ("q", "scale")}
# the fields of an attached LoRA weight, in the port's and the JAX package's
# LoRATensor alike
_LORA_FIELDS = ("base", "a", "b", "scale")


def _is_lora(node) -> bool:
    return (all(hasattr(node, f) for f in _LORA_FIELDS)
            and not isinstance(node, (dict, list, tuple)))


def _quant_fields(node):
    """The tensor fields of a JAX quantized weight (duck-typed: the port
    imports nothing of the JAX package), or None for any other node."""
    for fields in _QUANT_FIELDS.values():
        if all(hasattr(node, f) for f in fields) and not isinstance(node, (dict, list, tuple)):
            return fields
    return None


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: same bits as torch.bfloat16
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _fmt(path: Path) -> str:
    return "/".join(str(p) for p in path) or "<root>"


def _leaf(arr, like: torch.Tensor, jpath: Path, index, stack_len, used, dev) -> torch.Tensor:
    a = arr if torch.is_tensor(arr) else np.asarray(arr)
    if index is not None:
        if a.shape[0] != stack_len:
            raise ValueError(
                f"{_fmt(jpath)}: stacked over {a.shape[0]} layers, the port has {stack_len}")
        a = a[index]
    t = a if torch.is_tensor(a) else _to_torch(a)
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(
            f"{_fmt(jpath)}{'' if index is None else f'[{index}]'}: JAX shape "
            f"{tuple(t.shape)} (after layout change) != port shape {tuple(like.shape)}")
    t = t.to(device=dev, dtype=like.dtype)
    if t.ndim == 4 and like.is_contiguous(memory_format=torch.channels_last):
        t = t.contiguous(memory_format=torch.channels_last)
    else:
        t = t.contiguous()
    used.add((jpath, index))
    return t


def _convert(node, like, jpath: Path, index, stack_len, used, dev):
    if isinstance(like, dict):
        if not isinstance(node, dict):
            raise TypeError(f"{_fmt(jpath)}: expected a dict in the JAX tree, got {type(node)}")
        out = {}
        for key, sub in like.items():
            if key not in node:
                raise KeyError(f"JAX tree lacks {_fmt(jpath + (key,))}")
            out[key] = _convert(node[key], sub, jpath + (key,), index, stack_len, used, dev)
        return out
    if isinstance(like, list):
        if isinstance(node, (list, tuple)):
            if len(node) != len(like):
                raise ValueError(f"{_fmt(jpath)}: {len(node)} entries in JAX, {len(like)} in the port")
            return [_convert(n, s, jpath + (i,), index, stack_len, used, dev)
                    for i, (n, s) in enumerate(zip(node, like))]
        if index is not None:
            raise ValueError(f"{_fmt(jpath)}: a layer stack inside a layer stack")
        # layer stack: leaf [L, ...] in JAX -> one dict per layer in the port
        return [_convert(node, s, jpath, i, len(like), used, dev) for i, s in enumerate(like)]
    if isinstance(like, LoRATensor):
        if not _is_lora(node):
            raise TypeError(f"{_fmt(jpath)}: the port holds a LoRATensor here, the JAX tree a "
                            f"{type(node).__name__}")
        base = _convert(node.base, like.base, jpath + ("base",), index, stack_len, used, dev)
        return LoRATensor(base, *(_leaf(getattr(node, f), getattr(like, f), jpath + (f,), index,
                                        stack_len, used, dev) for f in _LORA_FIELDS[1:]))
    if type(like) in _QUANT_FIELDS:
        fields = _QUANT_FIELDS[type(like)]
        if _quant_fields(node) != fields:
            raise TypeError(f"{_fmt(jpath)}: the port holds a {type(like).__name__} here, the JAX "
                            f"tree a {type(node).__name__}")
        return type(like)(*(_leaf(getattr(node, f), getattr(like, f), jpath + (f,), index,
                                  stack_len, used, dev) for f in fields))
    if torch.is_tensor(like):
        return _leaf(node, like, jpath, index, stack_len, used, dev)
    raise TypeError(f"{_fmt(jpath)}: unexpected port leaf {type(like)}")


def _jax_leaves(node, path: Path = ()):
    fields = _quant_fields(node)
    if _is_lora(node):
        yield from _jax_leaves(node.base, path + ("base",))
        for f in _LORA_FIELDS[1:]:
            yield path + (f,), getattr(node, f)
    elif fields is not None:
        for f in fields:
            yield path + (f,), getattr(node, f)
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _jax_leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _jax_leaves(v, path + (i,))
    else:
        yield path, node


def from_jax(tree: Any, like: Any, *, device="cuda") -> Any:
    """Port parameters with ``like``'s structure and dtypes, filled from the
    numpy tree ``tree`` of the JAX package, on ``device``."""
    dev = resolve_device(device)
    used: set = set()
    out = _convert(tree, like, (), None, None, used, dev)
    unused = []
    for path, arr in _jax_leaves(tree):
        if (path, None) in used:
            continue
        n = np.shape(arr)[0] if np.ndim(arr) else 0
        if not n or any((path, i) not in used for i in range(n)):
            unused.append(_fmt(path))
    if unused:
        raise ValueError(f"JAX leaves the port did not consume: {unused}")
    return out


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------


def _find_adam(node):
    """The first node of a JAX optimizer state that holds Adam moments: an
    object with ``count`` and ``mu``/``nu`` (optax) or ``m``/``v`` (8-bit)."""
    for a, b in (("mu", "nu"), ("m", "v")):
        if hasattr(node, a) and hasattr(node, b) and hasattr(node, "count"):
            return node.count, getattr(node, a), getattr(node, b)
    children = ()
    if isinstance(node, dict):
        children = node.values()
    elif isinstance(node, (list, tuple)):
        children = node
    elif hasattr(node, "__dict__"):
        children = vars(node).values()
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def _is_moment(x) -> bool:
    return hasattr(x, "codes") and hasattr(x, "scale")


def _is_absent(x) -> bool:
    """optax's MaskedNode (an empty namedtuple) or None: a frozen leaf."""
    return x is None or (isinstance(x, tuple) and len(x) == 0)


def _moment_leaf(node, like, plike, jpath, index, stack_len, used, dev):
    from dreamllm_tpu_torch.train.optim8bit import BLOCK, _Moment

    where = f"{_fmt(jpath)}{'' if index is None else f'[{index}]'}"
    if _is_moment(like):
        if not _is_moment(node):
            raise ValueError(f"{where}: the port keeps 8-bit moments here, the JAX state "
                             f"holds {type(node).__name__}")
        codes, scale = np.asarray(node.codes), np.asarray(node.scale)
        nb = like.codes.shape[0]
        if index is not None:
            if plike is None:
                raise ValueError(f"{where}: pass params= to split a layer-stacked 8-bit moment")
            if plike.numel() % BLOCK or codes.shape[0] != stack_len * nb:
                raise ValueError(
                    f"{where}: the JAX moment blocks the stacked [{stack_len}, ...] leaf by "
                    f"{BLOCK} and its blocks do not split on layer boundaries "
                    f"({plike.numel()} elements a layer, {codes.shape[0]} blocks in all)")
            codes, scale = codes[index * nb:(index + 1) * nb], scale[index * nb:(index + 1) * nb]
        if codes.shape != tuple(like.codes.shape) or scale.shape != tuple(like.scale.shape):
            raise ValueError(f"{where}: JAX moment {codes.shape}/{scale.shape} != port "
                             f"{tuple(like.codes.shape)}/{tuple(like.scale.shape)}")
        used.add((jpath, index))
        return _Moment(torch.from_numpy(np.array(codes)).to(dev),
                       torch.from_numpy(np.array(scale)).to(dev))
    if _is_moment(node):
        raise ValueError(f"{where}: the JAX state holds 8-bit moments here, the port a tensor")
    return _leaf(node, like, jpath, index, stack_len, used, dev)


def _convert_moments(node, like, plike, jpath, index, stack_len, used, dev):
    if isinstance(like, dict):
        if not isinstance(node, dict):
            raise TypeError(f"{_fmt(jpath)}: expected a dict in the JAX state, got {type(node)}")
        out = {}
        for key, sub in like.items():
            if key not in node:
                raise KeyError(f"JAX state lacks {_fmt(jpath + (key,))}")
            out[key] = _convert_moments(node[key], sub, plike[key] if plike is not None else None,
                                        jpath + (key,), index, stack_len, used, dev)
        return out
    if isinstance(like, list):
        sub_p = plike if plike is not None else [None] * len(like)
        if isinstance(node, (list, tuple)) and not _is_moment(node) and not _is_absent(node):
            if len(node) != len(like):
                raise ValueError(f"{_fmt(jpath)}: {len(node)} entries in JAX, {len(like)} in the port")
            return [_convert_moments(n, s, p, jpath + (i,), index, stack_len, used, dev)
                    for i, (n, s, p) in enumerate(zip(node, like, sub_p))]
        if index is not None:
            raise ValueError(f"{_fmt(jpath)}: a layer stack inside a layer stack")
        return [_convert_moments(node, s, p, jpath, i, len(like), used, dev)
                for i, (s, p) in enumerate(zip(like, sub_p))]
    if like is None:
        if not _is_absent(node):
            raise ValueError(f"{_fmt(jpath)}: the port has no moment here (frozen), the JAX "
                             f"state holds {type(node).__name__}")
        return None
    if _is_absent(node):
        raise ValueError(f"JAX state lacks {_fmt(jpath)} (masked there, trainable in the port)")
    return _moment_leaf(node, like, plike, jpath, index, stack_len, used, dev)


def _state_leaves(node, path: Path = ()):
    """(path, leaf) of a JAX moment tree; a stored 8-bit moment is one leaf,
    a masked node none."""
    if _is_absent(node):
        return
    if _is_moment(node):
        yield path, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _state_leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _state_leaves(v, path + (i,))
    else:
        yield path, node


def opt_state_from_jax(jax_opt_state: Any, like: Any, *, params: Any = None,
                       device="cuda") -> Any:
    """The port's optimizer state filled from a JAX one.

    ``jax_opt_state``: the state of the JAX package's ``make_optimizer``
    transform as numpy (``jax.tree.map(np.asarray, state)``: namedtuples
    stay, so the optax AdamW state ``(count, mu, nu)`` or the
    ``Adam8bitState`` ``(count, m, v)`` is found by its fields, wherever the
    chain and the freeze mask put it). ``like``: the port's state from
    ``make_optimizer(...).init(params)``; the result has its structure,
    dtypes and ``None`` leaves. ``params``: the port's parameters; needed
    where a layer-stacked leaf has 8-bit moments, to check that its
    256-blocks split on layer boundaries (they do when a layer's leaf is a
    multiple of 256 elements; otherwise this raises).

    Raises on a missing, unused or misshapen leaf, as :func:`from_jax` does.
    """
    dev = resolve_device(device)
    found = _find_adam(jax_opt_state)
    if found is None:
        raise ValueError("no Adam state (count, mu/nu or m/v) in the JAX optimizer state")
    count, jm, jv = found

    def fill(node):
        if isinstance(node, dict) and "count" in node and "m" in node and "v" in node:
            out = {"count": torch.tensor(int(np.asarray(count)), dtype=node["count"].dtype,
                                         device=dev)}
            for key, jtree in (("m", jm), ("v", jv)):
                used: set = set()
                out[key] = _convert_moments(jtree, node[key], params, (), None, None, used, dev)
                unused = []
                for path, leaf in _state_leaves(jtree):
                    if (path, None) in used:
                        continue
                    arr = leaf.codes if _is_moment(leaf) else leaf
                    n = np.shape(arr)[0] if np.ndim(arr) else 0
                    if not n or not any((path, i) in used for i in range(n)):
                        unused.append(_fmt(path))
                if unused:
                    raise ValueError(f"JAX {key} leaves the port did not consume: {unused}")
            return out
        if isinstance(node, list):
            return [fill(v) for v in node]
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return node

    return fill(like)
