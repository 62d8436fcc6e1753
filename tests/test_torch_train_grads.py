"""Gradients of the port's joint training forward on the CPU, float32, tiny
sizes: ``dreamllm_forward``'s loss, aux and the gradient of every trainable
leaf against ``jax.value_and_grad`` of the JAX package's, and every remat
policy against no remat. A file of its own beside
``test_torch_train_forward.py`` so that two test workers share the work.
JAX weights reach the port through ``bridge.from_jax``; JAX's random draws
are replayed into the port (``replay_draws``). Tolerances are stated per
test.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.sd.head as phead
from dreamllm_tpu_torch.ops import attention as patt
from dreamllm_tpu_torch.train.tree import tree_leaves_with_path
from tests._torch_port_helpers import (
    jax_batch,
    jax_leaf,
    n,
    port_batch,
    replay_draws,
    train_batch,
    train_cfgs,
    train_params,
)


def _port_grads(pc, ph, pparams, batch, draws, remat, head_kw=None):
    mask = pdl.param_freeze_mask(pparams, pc)
    flat_mask = dict(tree_leaves_with_path(mask))
    live = {}

    def leafify(tree, path=()):
        if isinstance(tree, dict):
            return {k: leafify(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [leafify(v, path + (i,)) for i, v in enumerate(tree)]
        if flat_mask[path]:
            live[path] = tree.detach().clone().requires_grad_()
            return live[path]
        return tree

    params = leafify(pparams)
    loss, aux = pdl.dreamllm_forward(
        params, pc, batch, head_loss_fn=phead.make_head_loss_fn(ph, **(head_kw or {})),
        head_params=params["sd_head"], draws=draws, use_flash=True, remat=remat)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss, aux, dict(zip(live, grads))


def test_dreamllm_forward_loss_aux_and_gradients_match_jax():
    """Joint loss with NEFTune, ``log_hidden_states`` and ``loss_scale``, a
    packed row with a padding tail, 64 px dream images (32x32 latents: the
    UNet's first-level self-attention, S 1024 D 64, takes the flash path, so
    the backward runs the flash backward's plain version): loss and aux
    within 2e-4 relative; the gradient of every trainable leaf within 2e-3 of
    that leaf's largest |gradient| + 1e-6 (float32 through the decoder, the
    VAE and the UNet and back, summed in other orders)."""
    kw = dict(neftune_noise_alpha=5.0, log_hidden_states=True, loss_scale="l2",
              loss_weight_vm=2.0)
    jc, pc, jh, ph = train_cfgs(model_kw=kw)
    jparams, pparams = train_params()
    batch = train_batch(seed=4, px=64)
    key = jax.random.PRNGKey(11)
    jmask = jdl.param_freeze_mask(jparams, jc)

    def jloss(params):
        params = jax.tree.map(lambda m, p: p if m else jax.lax.stop_gradient(p), jmask, params)
        return jdl.dreamllm_forward(params, jc, jax_batch(batch),
                                    head_loss_fn=jhead.make_head_loss_fn(jh),
                                    head_params=params["sd_head"], rng=key, use_flash=True)

    # jitted: op-by-op JAX on the CPU takes several times longer
    (want, waux), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    draws = replay_draws(key, n_samples=2, latent_shape=(32, 32, 4),
                         neftune_shape=(2, 40, 64))
    before = patt.flash_attention_bwd_reference
    calls = []
    patt.flash_attention_bwd_reference = lambda *a, **k: (calls.append(1), before(*a, **k))[1]
    try:
        got, gaux, ggrads = _port_grads(pc, ph, pparams, port_batch(batch), draws, remat=False)
    finally:
        patt.flash_attention_bwd_reference = before
    assert len(calls) == 2  # the UNet's two first-level self-attentions (down and up)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-4)
    assert set(gaux) == set(waux)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k].detach()), float(waux[k]), rtol=2e-4,
                                   err_msg=k)
    assert len(ggrads) > 20
    for path, g in ggrads.items():
        ref = jax_leaf(wgrads, path)
        np.testing.assert_allclose(n(g), ref, atol=2e-3 * np.abs(ref).max() + 1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("remat", [True, "full", "dots", 1, 0, 2])
def test_every_remat_policy_gives_the_same_gradients(remat):
    """Checkpointing recomputes the same float32 operations in the same
    order, so gradients agree with the un-checkpointed ones to 1e-6 of each
    leaf's largest |gradient| (also with the UNet checkpointed per block)."""
    jc, pc, jh, ph = train_cfgs()
    _, pparams = train_params()
    batch = port_batch(train_batch(seed=5, px=32))
    draws = replay_draws(jax.random.PRNGKey(2), n_samples=2, latent_shape=(16, 16, 4))
    want_loss, _, want = _port_grads(pc, ph, pparams, batch, draws, remat=False)
    got_loss, _, got = _port_grads(pc, ph, pparams, batch, draws, remat=remat,
                                   head_kw=dict(remat_unet=True))
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss.detach()), rtol=1e-6)
    for path, g in got.items():
        ref = want[path]
        assert float((g - ref).abs().max()) <= 1e-6 * float(ref.abs().max()) + 1e-12, path


def test_remat_rejects_unknown_policies_and_parallel_axes_are_not_ported():
    jc, pc, jh, ph = train_cfgs()
    _, pparams = train_params()
    batch = port_batch(train_batch(px=32))
    for bad in ("some", 3, -1):
        with pytest.raises(ValueError):
            with torch.enable_grad():
                pdl.dreamllm_forward(pparams, pc, {"input_ids": batch["input_ids"]}, remat=bad)
    for kw in (dict(sequence_parallel_axis="sp"), dict(pipeline_parallel_axis="pp")):
        with pytest.raises(NotImplementedError, match="Queue 1 #22"):
            pdl.dreamllm_forward(pparams, dataclasses.replace(pc, **kw), batch)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pdl.dreamllm_forward(pparams, dataclasses.replace(
            pc, sequence_parallel_axis="sp", pipeline_parallel_axis="pp"), batch)
