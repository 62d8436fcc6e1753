"""Optimizer factory and LR schedules (port of
``dreamllm_tpu/train/optim.py``): AdamW with weight-decay grouping that
excludes norms and biases, the schedule zoo (constant, linear, cosine,
cosine with restarts, polynomial, each with linear warmup), global-norm
clipping, the freeze mask, per-layer update multipliers, and EMA.

There is no optax here. A transform is an ``(init, update)`` pair
(:class:`GradientTransformation`) whose state is a plain tree of tensors,
so that :func:`dreamllm_tpu_torch.bridge.opt_state_from_jax` can carry a JAX
optimizer state across. Both AdamW variants keep ``{"count", "m", "v"}``;
``None`` stands for a frozen leaf in gradients, updates and moments alike
(the JAX package materialises zeros there; the port does not, to save the
memory). Schedules take the step count as a 0-d tensor and stay on its
device: nothing in an update syncs with the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from dreamllm_tpu_torch.train.optim8bit import (
    GradientTransformation,
    adamw_8bit,
    decay_flags,
)
from dreamllm_tpu_torch.train.tree import (
    broadcast_prefix,
    path_str,
    tree_leaves,
    tree_map,
    tree_map_with_path,
)

__all__ = [
    "GradientTransformation", "OptimizerConfig", "adam_state", "adamw", "apply_updates",
    "clip_by_global_norm", "ema_decay_schedule", "ema_update", "global_norm",
    "layerwise_multiplier_tree", "llrd_multiplier", "make_lr_schedule", "make_optimizer",
    "scale_grads_by_tree", "trailing_layers_multiplier",
]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    schedule: str = "cosine"  # constant | linear | cosine | cosine_restarts | polynomial
    warmup_steps: int = 0
    total_steps: int = 10000
    min_lr_ratio: float = 0.0
    num_cycles: float = 0.5          # cosine periods (HF convention)
    power: float = 1.0               # polynomial decay power
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0       # 0 disables clipping
    scale_lr_by: float = 1.0         # linear LR scaling factor
    # int8 blockwise-quantized Adam moments (train/optim8bit.py)
    optimizer_8bit: bool = False
    # leaves smaller than min_8bit_size keep float32 moments, and so does any
    # parameter whose path contains one of fp32_moment_paths (the embedding
    # table). The thresholds see the port's per-layer leaves (optim8bit.py).
    min_8bit_size: int = 4096
    fp32_moment_paths: tuple = ("embed_tokens",)
    # the fused 8-bit update kernel (csrc/adam8bit.cu) on CUDA leaves; False
    # runs the unfused math. The default is the faster on an H100 (PERF.md).
    fused_update: bool = True


def make_lr_schedule(cfg: OptimizerConfig):
    """``f(count) -> lr`` as a float32 0-d tensor on ``count``'s device."""
    peak = cfg.learning_rate * cfg.scale_lr_by
    floor = peak * cfg.min_lr_ratio
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

    def progress(step):
        return (step / decay_steps).clamp(0.0, 1.0)

    if cfg.schedule == "constant":
        def main(step):
            return torch.full_like(step, peak)
    elif cfg.schedule == "linear":
        def main(step):  # optax.linear_schedule(peak, floor, decay_steps)
            return peak + (floor - peak) * progress(step)
    elif cfg.schedule == "cosine":
        def main(step):  # HF cosine: 0.5 * (1 + cos(pi * 2 * num_cycles * progress))
            c = 0.5 * (1.0 + torch.cos(math.pi * 2.0 * cfg.num_cycles * progress(step)))
            return floor + (peak - floor) * c.clamp_min(0.0)
    elif cfg.schedule == "cosine_restarts":
        def main(step):
            p = progress(step)
            cycle_pos = (p * cfg.num_cycles) % 1.0
            lr = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * cycle_pos))
            # past the end cycle_pos wraps to 0 (the full peak); HF's
            # hard-restarts schedule returns the floor for progress >= 1
            return torch.where(p >= 1.0, torch.full_like(lr, floor), lr)
    elif cfg.schedule == "polynomial":
        def main(step):
            return floor + (peak - floor) * (1.0 - progress(step)) ** cfg.power
    else:
        raise ValueError(cfg.schedule)

    warmup = cfg.warmup_steps

    def schedule(count):
        step = torch.as_tensor(count).float()
        if warmup > 0:
            # linear 0 -> peak over the warmup, then `main` counted from its end
            warm = peak * (step / warmup).clamp(0.0, 1.0)
            return torch.where(step < warmup, warm, main(step - warmup))
        return main(step)

    return schedule


def _decay_mask(params) -> Any:
    """True where weight decay applies: matmul, conv and embedding weights.
    Norm scales and biases are excluded by parameter PATH (a leaf or any
    parent named ``*norm*``/``ln*``, a leaf named like a bias), then by
    rank: a decayed leaf has at least 2 dims. JAX's layer-stacked norm
    scales are rank 2, which is why the path decides first; the port's
    per-layer leaves give the same answer."""

    def decay(path, p) -> bool:
        if p is None:
            return False
        keys = [str(k).lower() for k in path if not isinstance(k, int)]
        leaf = keys[-1] if keys else ""
        if any("norm" in k or k.startswith("ln") or k.endswith("_ln") for k in keys):
            return False
        if leaf in ("b", "bias", "bq", "bk", "bv", "bo") or leaf.endswith("_b"):
            return False
        return p.ndim >= 2

    return tree_map_with_path(decay, params)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every non-None leaf, as
    ``optax.global_norm``: each leaf's sum is taken in the leaf's own dtype."""
    leaves = [g for g in tree_leaves(tree) if g is not None]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: leaves pass unchanged while the norm is
    below ``max_norm``, else become ``(g / norm) * max_norm``. IN PLACE: the
    gradient tensors are overwritten (at 7B a second copy is 13.5 GB)."""

    def init(params):
        return None

    def update(grads, state, params=None, *, skip=None):
        norm = global_norm(grads)
        trigger = norm < max_norm

        def clip(g):
            if g is None:
                return None
            return g.copy_(torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm))

        return tree_map(clip, grads), state

    return GradientTransformation(init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          mask=None) -> GradientTransformation:
    """``optax.adamw`` semantics: moments are kept in the parameter's dtype
    (float32 parameters, float32 moments), ``update = -lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)``, the schedule read at the count BEFORE
    the increment and the bias corrections at ``count + 1``."""

    def init(params):
        zeros = lambda p: None if p is None else torch.zeros_like(p)  # noqa: E731
        dev = next((p.device for p in tree_leaves(params) if p is not None), torch.device("cpu"))
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params=None, *, skip=None):
        count = state["count"]
        new_count = count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        bc1 = 1.0 - b1 ** new_count.float()
        bc2 = 1.0 - b2 ** new_count.float()
        decay_tree = decay_flags(weight_decay, mask, params, grads)
        if params is None:
            params = tree_map(lambda _: None, grads)

        def step(g, m, v, p, do_decay):
            if g is None:
                return None, m, v
            new_m = (1.0 - b1) * g + b1 * m
            new_v = (1.0 - b2) * torch.square(g) + b2 * v
            upd = (new_m / bc1.to(g.dtype)) / (torch.sqrt(new_v / bc2.to(g.dtype)) + eps)
            if do_decay and p is not None:
                upd = upd + weight_decay * p
            upd = torch.as_tensor(-lr, dtype=upd.dtype, device=upd.device) * upd
            if skip is not None:
                upd = torch.where(skip, torch.zeros_like(upd), upd)
                new_m, new_v = torch.where(skip, m, new_m), torch.where(skip, v, new_v)
            return upd, new_m, new_v

        out = tree_map(step, grads, state["m"], state["v"], params, decay_tree)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)  # noqa: E731
        if skip is not None:
            new_count = torch.where(skip, count, new_count)
        return pick(0), {"count": new_count, "m": pick(1), "v": pick(2)}

    return GradientTransformation(init, update)


def scale_grads_by_tree(multipliers: Any) -> GradientTransformation:
    """Multiply each update leaf by the matching multiplier (None = leave it).
    Placed AFTER Adam in :func:`make_optimizer`: Adam's ``m / (sqrt(v) +
    eps)`` is invariant to a constant gradient scale, so scaling the UPDATE
    is what realises layer-wise LR decay, and a 0 multiplier freezes a layer
    including its weight-decay term. See :func:`layerwise_multiplier_tree`
    for how a per-layer vector maps onto the port's per-layer leaves."""

    def init(params):
        return None

    def update(updates, state, params=None, *, skip=None):
        def apply(u, m):
            if u is None or m is None:
                return u
            m = torch.as_tensor(m, dtype=u.dtype, device=u.device)
            return u * m.reshape(m.shape + (1,) * (u.ndim - m.ndim))

        return tree_map(apply, updates, multipliers), state

    return GradientTransformation(init, update)


def _chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params=None, *, skip=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params, skip=skip)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def _masked(tx: GradientTransformation, trainable_mask) -> GradientTransformation:
    """Run ``tx`` on the trainable leaves only: frozen leaves are ``None`` in
    the parameters it initialises from, in the gradients it sees (so the
    clipping norm counts trainable gradients only) and in the updates."""

    def prune(tree, like):
        mask = broadcast_prefix(trainable_mask, like)
        return tree_map(lambda x, keep: x if keep else None, tree, mask)

    def init(params):
        return tx.init(prune(params, params))

    def update(grads, state, params=None, *, skip=None):
        pruned = prune(params, params) if params is not None else None
        return tx.update(prune(grads, grads), state, pruned, skip=skip)

    return GradientTransformation(init, update)


def make_optimizer(
    cfg: OptimizerConfig,
    trainable_mask: Any | None = None,
    grad_multipliers: Any | None = None,
) -> GradientTransformation:
    """Clip + AdamW (float32-style or 8-bit) + schedule, with an optional
    freeze mask (a tree of bools, possibly a prefix; True = trainable) and
    optional per-layer update multipliers. The state is the list of the
    chain's states, ``[clip, adam, (multipliers)]``; the AdamW state is
    ``state[-1]`` or ``state[-2]``, see :func:`adam_state`."""
    schedule = make_lr_schedule(cfg)
    chain = []
    if cfg.max_grad_norm and cfg.max_grad_norm > 0:
        chain.append(clip_by_global_norm(cfg.max_grad_norm))
    decay_mask = _decay_mask if cfg.weight_decay > 0 else None
    if cfg.optimizer_8bit:
        def fp32_moments(params):
            paths = tuple(cfg.fp32_moment_paths or ())
            return tree_map_with_path(lambda kp, _: any(p in path_str(kp) for p in paths), params)

        chain.append(adamw_8bit(
            learning_rate=schedule, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, mask=decay_mask,
            min_8bit_size=cfg.min_8bit_size,
            fp32_moments_mask=fp32_moments if cfg.fp32_moment_paths else None,
            fused_update=cfg.fused_update,
        ))
    else:
        chain.append(adamw(learning_rate=schedule, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                           weight_decay=cfg.weight_decay, mask=decay_mask))
    if grad_multipliers is not None:
        chain.append(scale_grads_by_tree(grad_multipliers))
    tx = _chain(*chain)
    if trainable_mask is not None:
        tx = _masked(tx, trainable_mask)
    return tx


def adam_state(opt_state) -> dict:
    """The ``{"count", "m", "v"}`` dict inside a :func:`make_optimizer` state."""
    for s in opt_state:
        if isinstance(s, dict) and "count" in s:
            return s
    raise ValueError("no AdamW state in this optimizer state")


def apply_updates(params, updates):
    """``p + u`` per leaf, cast to the parameter's dtype; a ``None`` update
    leaves the parameter (the same tensor) in place."""
    return tree_map(lambda p, u: p if u is None else (p + u.to(p.dtype)).to(p.dtype),
                    params, updates)


# ---------------------------------------------------------------------------
# Per-layer update scaling
# ---------------------------------------------------------------------------


def trailing_layers_multiplier(num_layers: int, unfreeze_last: int) -> torch.Tensor:
    """``[L]`` vector: 0 for the frozen leading layers, 1 for the trailing K."""
    idx = torch.arange(num_layers)
    return (idx >= num_layers - unfreeze_last).float()


def llrd_multiplier(num_layers: int, decay: float) -> torch.Tensor:
    """``[L]`` layer-wise LR decay: top layer 1.0, each earlier layer x decay."""
    idx = torch.arange(num_layers)
    return decay ** (num_layers - 1 - idx).float()


def layerwise_multiplier_tree(params: Any, rules: dict[str, torch.Tensor]) -> Any:
    """A multiplier tree: ``rules`` maps slash-path prefixes to an ``[L]``
    vector for every leaf under that prefix; elsewhere None. JAX applies the
    vector along the leading axis of a layer-stacked ``[L, ...]`` leaf; the
    port keeps a list of L per-layer dicts under such a prefix, so the leaf
    of layer ``i`` gets the scalar ``vec[i]``. A prefix that ends at a
    non-list leaf keeps the whole vector, broadcast from the leading axis."""

    def walk(tree, path, vec, layer):
        if vec is None:
            for prefix, v in rules.items():
                if path == prefix or path.startswith(prefix + "/"):
                    vec = v
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k, vec, layer)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            if vec is not None and layer is None:
                if len(tree) != len(vec):
                    raise ValueError(f"{path}: {len(tree)} layers, multiplier has {len(vec)}")
                return [walk(v, f"{path}/{i}", vec, i) for i, v in enumerate(tree)]
            return [walk(v, f"{path}/{i}", vec, layer) for i, v in enumerate(tree)]
        if vec is None:
            return None
        return vec[layer] if layer is not None else vec

    return walk(params, "", None, None)


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------


def ema_decay_schedule(step, max_decay: float = 0.9999):
    """Warmup decay ``min(max_decay, (1 + step) / (10 + step))``."""
    step = torch.as_tensor(step).float()
    return torch.clamp((1.0 + step) / (10.0 + step), max=max_decay)


def ema_update(ema_params, params, decay):
    """``ema <- decay * ema + (1 - decay) * params``, in the EMA's dtype."""
    return tree_map(lambda e, p: (e * decay + p.to(e.dtype) * (1.0 - decay)).to(e.dtype),
                    ema_params, params)
