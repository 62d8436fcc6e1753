"""Checkpoint save/restore with the LLM-versus-plugin split layout (port of
``dreamllm_tpu/train/checkpoints.py``, ``torch.save``/``torch.load`` in place
of orbax). Each top-level parameter subtree is its own file inside
``checkpoint-{step}/``:

    checkpoint-000100/
      llm.pt  clip_vision_embedding.pt  dream_embedding.pt  sd_head.pt
      opt_state.pt  meta.json  host_state.json

``load_params(dir, overrides={"sd_head": other_dir})`` re-points individual
plugins at another run's checkpoint: the stage-mix workflow. Quantized
weights (``QTensor``, ``Q4Tensor``), attached adapters (``LoRATensor``, its
base tagged inside it) and 8-bit moments are stored as tagged dicts of CPU
tensors, so every file loads with ``weights_only=True`` and
comes back as the same types, with ``like=`` and without it. Checkpoints
written by the JAX package (orbax) are not read here; bring a JAX state
across with ``bridge.from_jax`` and ``bridge.opt_state_from_jax``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any

import torch

from dreamllm_tpu_torch.ops.quant import LoRATensor, QTensor
from dreamllm_tpu_torch.ops.quant4 import GROUP, Q4Tensor
from dreamllm_tpu_torch.train.optim8bit import _Moment
from dreamllm_tpu_torch.train.tree import tree_map


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"checkpoint-{step:06d}")


def _to_cpu(tree):
    """Tensors moved to the CPU; a stored moment or a quantized weight
    becomes a tagged dict, so the file holds plain containers and tensors
    only."""
    def one(x):
        if isinstance(x, LoRATensor):
            return {"__loratensor__": True, "base": one(x.base), "a": x.a.detach().cpu(),
                    "b": x.b.detach().cpu(), "scale": x.scale.detach().cpu()}
        if isinstance(x, _Moment):
            return {"__moment__": True, "codes": x.codes.cpu(), "scale": x.scale.cpu()}
        if isinstance(x, QTensor):
            return {"__qtensor__": True, "q": x.q.detach().cpu(), "scale": x.scale.detach().cpu()}
        if isinstance(x, Q4Tensor):
            return {"__q4tensor__": True, "packed": x.packed.detach().cpu(),
                    "scale": x.scale.detach().cpu(), "group": GROUP, "shape": list(x.shape)}
        return x.detach().cpu() if torch.is_tensor(x) else x

    return tree_map(one, tree)


def _from_saved(tree):
    if isinstance(tree, dict):
        if tree.get("__moment__"):
            return _Moment(tree["codes"], tree["scale"])
        if tree.get("__loratensor__"):
            return LoRATensor(_from_saved(tree["base"]), tree["a"], tree["b"], tree["scale"])
        if tree.get("__qtensor__"):
            return QTensor(tree["q"], tree["scale"])
        if tree.get("__q4tensor__"):
            out = Q4Tensor(tree["packed"], tree["scale"])
            if tree["group"] != GROUP or list(out.shape) != list(tree["shape"]):
                raise ValueError(f"int4 weight saved with group {tree['group']} and shape "
                                 f"{tree['shape']}; this port reads group {GROUP}, and the "
                                 f"packed tensor gives shape {list(out.shape)}")
            return out
        return {k: _from_saved(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_saved(v) for v in tree]
    return tree


def _like(tree, like, where: str):
    """``tree`` cast and moved to the dtypes and devices of ``like``, after
    checking that the two agree in structure and shapes."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"{where}: checkpoint keys {sorted(tree) if isinstance(tree, dict) else type(tree)} "
                             f"!= expected {sorted(like)}")
        return {k: _like(tree[k], v, f"{where}/{k}") for k, v in like.items()}
    if isinstance(like, list):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"{where}: checkpoint list does not match the expected length {len(like)}")
        return [_like(t, v, f"{where}/{i}") for i, (t, v) in enumerate(zip(tree, like))]
    if isinstance(like, _Moment):
        if not isinstance(tree, _Moment):
            raise ValueError(f"{where}: expected an 8-bit moment, checkpoint has {type(tree)}")
        return _Moment(_like(tree.codes, like.codes, where), _like(tree.scale, like.scale, where))
    if isinstance(like, (QTensor, Q4Tensor, LoRATensor)):
        if type(tree) is not type(like):
            raise ValueError(f"{where}: expected a {type(like).__name__}, checkpoint has "
                             f"{type(tree).__name__}")
        return type(like)(*(_like(getattr(tree, f.name), getattr(like, f.name), f"{where}/{f.name}")
                            for f in dataclasses.fields(like)))
    if torch.is_tensor(like):
        if not torch.is_tensor(tree) or tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"{where}: checkpoint shape "
                             f"{tuple(tree.shape) if torch.is_tensor(tree) else type(tree)} "
                             f"!= expected {tuple(like.shape)}")
        return tree.to(device=like.device, dtype=like.dtype)
    if like is None and tree is not None:
        raise ValueError(f"{where}: expected no leaf here, checkpoint has {type(tree)}")
    return tree


def save_checkpoint(
    root: str,
    step: int,
    params: dict,
    opt_state: Any = None,
    extra_meta: dict | None = None,
    host_state: dict | None = None,
) -> str:
    """Write ``checkpoint-{step}/`` with one file per parameter subtree.

    ``host_state``: JSON-serializable host-side training state (generator
    state, data-stream position). Everything is written into ``<path>.tmp``
    and renamed into place at the end: a crash mid-save leaves only a
    ``.tmp`` directory, never a ``checkpoint-NNN`` that
    :func:`latest_checkpoint` would pick up half-written."""
    path = _ckpt_dir(root, step)
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # leftover from a previous crashed save
    os.makedirs(tmp)
    for name, subtree in params.items():
        torch.save(_to_cpu(subtree), os.path.join(tmp, f"{name}.pt"))
    if opt_state is not None:
        torch.save(_to_cpu(opt_state), os.path.join(tmp, "opt_state.pt"))
    meta = {"step": step, "param_groups": sorted(params.keys())}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if host_state is not None:
        with open(os.path.join(tmp, "host_state.json"), "w") as f:
            json.dump(host_state, f)
    if os.path.isdir(path):
        shutil.rmtree(path)  # re-saving the same step
    os.replace(tmp, path)
    return path


def load_host_state(path: str) -> dict | None:
    """Host-side resume state saved beside the checkpoint, or None."""
    p = os.path.join(path, "host_state.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def latest_checkpoint(root: str) -> str | None:
    """Most recent complete ``checkpoint-*`` under ``root``. A directory
    without ``meta.json`` is an incomplete save and is never resumed from."""
    if not os.path.isdir(root):
        return None
    best, best_step = None, -1
    for name in os.listdir(root):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if not m or int(m.group(1)) <= best_step:
            continue
        cand = os.path.join(root, name)
        if not os.path.exists(os.path.join(cand, "meta.json")):
            continue
        best, best_step = cand, int(m.group(1))
    return best


def _load(file: str):
    return _from_saved(torch.load(file, map_location="cpu", weights_only=True))


def load_params(path: str, like: dict | None = None,
                overrides: dict[str, str] | None = None) -> dict:
    """The parameter dict of a checkpoint directory.

    ``like``: optional template tree; the result takes its dtypes and
    devices, and a structure or shape that disagrees raises. Without it the
    tensors come back on the CPU as saved. ``overrides``: plugin name ->
    ANOTHER checkpoint directory; that subtree loads from there (stage
    mixing)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out = {}
    for name in meta["param_groups"]:
        base = os.path.abspath((overrides or {}).get(name, path))
        tree = _load(os.path.join(base, f"{name}.pt"))
        if like is not None and name in like:
            tree = _like(tree, like[name], name)
        out[name] = tree
    return out


def load_opt_state(path: str, like: Any = None) -> Any:
    tree = _load(os.path.join(os.path.abspath(path), "opt_state.pt"))
    return _like(tree, like, "opt_state") if like is not None else tree


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "meta.json")) as f:
        return int(json.load(f)["step"])
