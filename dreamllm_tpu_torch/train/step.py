"""The train step: joint LM + diffusion loss, gradient accumulation, remat
(port of ``dreamllm_tpu/train/step.py``).

One Python function over plain tensors replaces the jitted step. Gradients
come from ``torch.autograd.grad`` on leaf copies of the trainable parameters
and have the parameters' dtype (bf16 at 7B), as JAX's do; micro-batches
accumulate in float32 and are cast back. The non-finite guard is a flag on
the device handed to the optimizer, so a step never syncs with the host.
``mesh=`` of the JAX step is not ported (one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig, dreamllm_forward
from dreamllm_tpu_torch.train.optim import GradientTransformation, apply_updates, global_norm
from dreamllm_tpu_torch.train.tree import broadcast_prefix, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # 0-d int32
    params: Any
    opt_state: Any


def _to_device(tree, dev):
    return tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, tree)


def init_train_state(params, tx: GradientTransformation, *, device="cuda") -> TrainState:
    """Parameters moved to ``device`` (a no-op where they already are), the
    optimizer state initialised from them, ``step`` 0."""
    dev = resolve_device(device)
    params = _to_device(params, dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=tx.init(params))


def make_train_step(
    cfg: DreamLLMConfig,
    tx: GradientTransformation,
    *,
    head_loss_fn: Callable | None = None,
    head_in_params: bool = True,
    grad_accum: int = 1,
    remat: bool | str | int = True,
    use_flash: bool = True,
    skip_nonfinite: bool = True,
    trainable_mask=None,
    device="cuda",
):
    """Build the train step ``(state, batch, generator=None, draws=None) ->
    (state, aux)``. ``device`` is where the step runs; the state and the
    batch must already be there (it raises without a card unless
    ``device="cpu"``).

    With ``grad_accum > 1`` the batch's leading dim must be divisible by it;
    micro-batches run in a Python loop and their gradients are averaged in
    float32, then cast to the parameters' dtype. ``draws``, when given, is a
    list of one dict per micro-batch (or one dict when ``grad_accum == 1``).

    ``head_in_params``: the diffusion head lives in ``params["sd_head"]`` and
    trains jointly (pass False for LM-only configs).

    ``remat``: True/"full" recomputes whole decoder layers in the backward;
    "dots" saves the matmul outputs and recomputes the rest; an int ``k``
    gives the first ``L - k`` layers "dots" and saves everything in the last
    ``k`` (``llama_forward``). ``scan_unroll`` is not ported: there is no scan.

    ``trainable_mask``: the same tree of bools (possibly a prefix) given to
    ``make_optimizer``. Frozen leaves take no part in autograd
    (``requires_grad`` stays False: the CLIP tower's backward and the UNet's
    parameter-gradient pass are skipped), their gradients read as ``None``
    (zeros), and their updates are dropped whatever ``tx`` returns, so a
    ``tx`` built without the mask cannot weight-decay them. ``grad_norm`` and
    the non-finite guard then see trainable gradients only.

    ``skip_nonfinite``: on a non-finite loss or gradient norm the update is
    dropped: ``ok`` is computed on the device and handed to ``tx.update`` as
    ``skip=~ok``: the fused 8-bit kernel leaves its codes untouched, the plain
    paths select the old state, and both emit a zero update, which keeps the
    parameters' values. ``aux["update_skipped"]`` is 1.0 then; the optimizer's
    count does not advance, the step counter does (the data stream consumed
    the batch).

    The step is functional in the parameters (new tensors for trainable
    leaves, the same tensors for frozen ones) but NOT in the optimizer state
    when ``tx`` uses the fused kernel, which updates moments in place.
    """
    dev = resolve_device(device)

    def micro(params, batch, generator, draws):
        mask = (broadcast_prefix(trainable_mask, params) if trainable_mask is not None
                else tree_map(lambda _: True, params))
        # fresh autograd leaves for the trainable parameters; frozen ones as
        # they are (requires_grad False)
        live = tree_map(lambda p, m: p.detach().requires_grad_(True) if m else p.detach(),
                        params, mask)
        head_params = live.get("sd_head") if head_in_params else None
        loss, aux = dreamllm_forward(
            live, cfg, batch,
            head_loss_fn=head_loss_fn if head_in_params else None,
            head_params=head_params,
            generator=generator, draws=draws,
            use_flash=use_flash, remat=remat,
        )
        leaves = [p for p in tree_leaves(live) if p.requires_grad]
        got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

        def grad_of(p):
            if not p.requires_grad:
                return None
            g = next(got)
            return torch.zeros_like(p) if g is None else g

        grads = tree_map(grad_of, live)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return grads, aux

    def step_fn(state: TrainState, batch, generator=None, draws=None):
        if state.step.device.type != dev.type:
            raise ValueError(f"train step built for {dev}, state is on {state.step.device}")
        if grad_accum == 1:
            grads, aux = micro(state.params, batch, generator, draws)
        else:
            def split(x, i):
                n = x.shape[0] // grad_accum
                return x[i * n:(i + 1) * n]

            acc, auxes = None, []
            for i in range(grad_accum):
                mb = {k: split(v, i) if torch.is_tensor(v) else v for k, v in batch.items()}
                g, a = micro(state.params, mb, generator, draws[i] if draws else None)
                # accumulate in float32: a bf16 running sum absorbs small
                # micro-gradients (x + eps == x at 8 significand bits)
                if acc is None:
                    acc = tree_map(lambda gi: None if gi is None else gi.float(), g)
                else:
                    acc = tree_map(lambda c, gi: None if gi is None else c.add_(gi.float()),
                                   acc, g)
                auxes.append(a)
            grads = tree_map(lambda g, p: None if g is None else (g / grad_accum).to(p.dtype),
                             acc, state.params)
            aux = {k: torch.stack([a[k] for a in auxes]).mean(dim=0) for k in auxes[0]}

        gnorm = global_norm(grads)
        skip = None
        if skip_nonfinite:
            ok = torch.isfinite(aux["loss"]) & torch.isfinite(gnorm)
            skip = ~ok
        updates, opt_state = tx.update(grads, state.opt_state, state.params, skip=skip)
        if trainable_mask is not None:
            # self-enforcing freeze: a frozen parameter never moves, whatever tx returns
            mask = broadcast_prefix(trainable_mask, updates)
            updates = tree_map(lambda u, m: u if m else None, updates, mask)
        params = apply_updates(state.params, updates)
        aux["grad_norm"] = gnorm.detach()
        if skip_nonfinite:
            # a skipped update is all zeros (tx.update saw skip), so p + 0 keeps
            # every parameter's value: no select, and no second copy at 7B
            aux["update_skipped"] = skip.float()
        return TrainState(step=state.step + 1, params=params, opt_state=opt_state), aux

    return step_fn
