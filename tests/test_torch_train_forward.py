"""Parity of the port's training forward with the JAX package's on the CPU,
float32, tiny sizes: the VAE encoder, the scheduler's training helpers, the
diffusion loss, the masked cross entropy, the freeze mask and the LM-only
forward (gradients and remat policies: ``test_torch_train_grads.py``). JAX weights reach the port through
``bridge.from_jax``; JAX's random draws are replayed into the port
(``replay_draws``). Tolerances are stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu.models.sd.schedulers as jsch
import dreamllm_tpu.models.sd.vae as jvae
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.models.sd.schedulers as psch
import dreamllm_tpu_torch.models.sd.vae as pvae
from dreamllm_tpu_torch.train.tree import tree_leaves_with_path
from tests._torch_port_helpers import (
    head_params,
    jax_batch,
    n,
    port_batch,
    replay_draws,
    t,
    train_batch,
    train_cfgs,
    train_params,
)


def test_vae_encode_and_sample_match_jax():
    """1e-4: float32 through 2 levels of resnets and the mid attention; the
    encoder's (0, 1) downsample padding differs from the UNet's."""
    jc, pc, jp, pp = head_params()
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jm, jl = jvae.vae_encode(jp["vae"], jc.vae, jnp.asarray(x))
    pm, pl = pvae.vae_encode(pp["vae"], pc.vae, t(x))
    assert tuple(pm.shape) == (2, 8, 8, 4)
    np.testing.assert_allclose(n(pm), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(n(pl), np.asarray(jl), atol=1e-4)
    key = jax.random.PRNGKey(3)
    eps = jax.random.normal(key, jm.shape, jm.dtype)
    np.testing.assert_allclose(n(pvae.vae_sample(pm, pl, eps=t(eps))),
                               np.asarray(jvae.vae_sample(jm, jl, key)), atol=1e-4)
    a = pvae.vae_sample(pm, pl, torch.Generator().manual_seed(1))
    b = pvae.vae_sample(pm, pl, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, pm)


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_scheduler_training_helpers_match_jax(prediction):
    """1e-6: a table lookup and two products in float32."""
    js = jsch.make_schedule(1000, prediction_type=prediction)
    ps = psch.make_schedule(1000, prediction)
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.asarray([0, 500, 999], np.int32)
    for jf, pf in ((jsch.add_noise, psch.add_noise), (jsch.get_velocity, psch.get_velocity)):
        np.testing.assert_allclose(
            n(pf(ps, t(x0), t(noise), t(ts))),
            np.asarray(jf(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts))), atol=1e-6)
    np.testing.assert_allclose(n(psch.snr(ps, t(ts))), np.asarray(jsch.snr(js, jnp.asarray(ts))),
                               rtol=1e-6)


HEAD_CASES = {
    "epsilon": dict(),
    "v-prediction-min-snr": dict(prediction_type="v_prediction", snr_gamma=5.0),
    "epsilon-min-snr-offset-perturbation": dict(snr_gamma=5.0, noise_offset=0.1,
                                                input_perturbation=0.1),
    "all-dropped": dict(uncond_prob=1.0),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
@pytest.mark.parametrize("pre_encoded", [False, True], ids=["images", "latents"])
def test_sd_head_loss_matches_jax(case, pre_encoded):
    """The diffusion loss on 2 x 2 dream spans (one absent), 32 px images:
    2e-4 relative (float32 through the VAE encoder and the UNet; the loss is
    a mean of squares of O(1) values)."""
    _, _, jh, ph = train_cfgs(head_kw=HEAD_CASES[case])
    _, _, jp, pp = head_params()
    rng = np.random.default_rng(2)
    imgs = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 2, 8, 64)).astype(np.float32)
    uncond = rng.standard_normal((1, 8, 64)).astype(np.float32)
    valid = np.asarray([[True, True], [True, False]])
    lat = rng.standard_normal((2, 2, 16, 16, 4)).astype(np.float32) if pre_encoded else None
    key = jax.random.PRNGKey(7)
    # jitted: op-by-op JAX on the CPU takes several times longer
    want, waux = jax.jit(lambda p, i, c, u, v, k, l: jhead.sd_head_loss(
        p, jh, i, c, u, v, k, latents=l))(
        jp, jnp.asarray(imgs), jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(valid),
        key, None if lat is None else jnp.asarray(lat))
    draws = replay_draws(key, n_samples=4, latent_shape=(16, 16, 4), uncond_prob=jh.uncond_prob)
    got, gaux = phead.sd_head_loss(
        pp, ph, t(imgs), t(cond), t(uncond), t(valid), None,
        latents=None if lat is None else t(lat), draws=draws)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    np.testing.assert_allclose(float(gaux["dm_mse"]), float(waux["dm_mse"]), rtol=2e-4)
    # remat_unet changes nothing in the value; its own draws from a generator are reproducible
    fn = phead.make_head_loss_fn(ph, remat_unet=True)
    again, _ = fn(pp, t(imgs), t(cond), t(uncond), t(valid), None,
                  latents=None if lat is None else t(lat), draws=draws, add_time_ids=None)
    np.testing.assert_allclose(float(again), float(got), rtol=1e-6)
    a, _ = phead.sd_head_loss(pp, ph, t(imgs), t(cond), t(uncond), t(valid),
                              torch.Generator().manual_seed(4))
    b, _ = phead.sd_head_loss(pp, ph, t(imgs), t(cond), t(uncond), t(valid),
                              torch.Generator().manual_seed(4))
    assert float(a) == float(b) and np.isfinite(float(a))


def test_masked_cross_entropy_matches_jax():
    """1e-6 relative: a float32 log-softmax over 50 classes."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :4] = -100
    for lab in (labels, np.full_like(labels, -100)):  # all ignored: 0, not NaN
        want = float(jdl.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(pdl.masked_cross_entropy(t(logits), t(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_param_freeze_mask_matches_jax():
    jc, pc, _, _ = train_cfgs()
    jparams, pparams = train_params()
    jmask, pmask = jdl.param_freeze_mask(jparams, jc), pdl.param_freeze_mask(pparams, pc)
    assert pmask["clip_vision_embedding"]["projector"] == jmask["clip_vision_embedding"][
        "projector"]
    assert not any(v for _, v in tree_leaves_with_path(pmask["clip_vision_embedding"]["clip"]))
    assert not any(v for _, v in tree_leaves_with_path(pmask["sd_head"]["unet"]))
    assert not any(v for _, v in tree_leaves_with_path(pmask["sd_head"]["vae"]))
    assert all(v for _, v in tree_leaves_with_path(pmask["llm"]))
    assert pmask["sd_head"]["projector"] == jmask["sd_head"]["projector"]
    assert pmask["dream_embedding"] == jmask["dream_embedding"] == {"queries": True}


def test_lm_only_forward_and_nan_rerouting():
    """No dream spans: vm_loss 0 and the loss is the LM loss; a NaN LM loss
    is rerouted to 0 in the value (the train step's guard drops the update)."""
    jc, pc, _, _ = train_cfgs()
    jparams, pparams = train_params()
    batch = train_batch(px=32)
    text = {k: batch[k] for k in ("input_ids", "labels", "segment_ids", "positions")}
    want, waux = jdl.dreamllm_forward(jparams, jc, jax_batch(text))
    got, gaux = pdl.dreamllm_forward(pparams, pc, port_batch(text))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert float(gaux["vm_loss"]) == float(waux["vm_loss"]) == 0.0
    bad = {**pparams, "llm": {**pparams["llm"],
                              "final_norm": pparams["llm"]["final_norm"] * float("nan")}}
    loss, aux = pdl.dreamllm_forward(bad, pc, port_batch(text))
    assert not np.isfinite(float(aux["lm_loss"])) and float(loss) == 0.0
