"""The SDXL head of the PyTorch port against the JAX package's, on the CPU
in float32 at tiny sizes: the UNet's text-time embedding, the full and
shallow UNet with ``added_cond``, the ControlNet residual hooks,
``sdxl_head_loss`` (loss and gradients, JAX's draws replayed, with and
without pre-encoded latents), ``sdxl_head_pipeline`` (DDIM and
DPM-Solver++ from the same start latents) and ``generate_interleaved``'s
choice of the SDXL pipeline for an SDXL head.

The tiny SDXL UNet keeps SDXL's layout: a DownBlock2D first, then a
cross-attention level whose self-attention (16x16 = S 256, one head of D
128) passes the flash rule, so the kernel's plain version is what these
tests hold against JAX. Its ``conv_out`` is redrawn at its fan-in scale
(``sdxl_params``). Tolerance 1e-4 unless a test states otherwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.generation.interleaved as jgen
import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu.models.sd.sdxl as jsdxl
import dreamllm_tpu.models.sd.unet as junet
import dreamllm_tpu_torch.configs as pconfigs
import dreamllm_tpu_torch.generation.interleaved as pgen
import dreamllm_tpu_torch.generation.sampler as psamp
import dreamllm_tpu_torch.models.sd.controlnet as pcn
import dreamllm_tpu_torch.models.sd.sdxl as psdxl
import dreamllm_tpu_torch.models.sd.unet as punet
from dreamllm_tpu_torch.ops import attention as patt
from tests._torch_port_helpers import (
    config_fields,
    dreamllm_params,
    live_head_params,
    n,
    replay_draws,
    sdxl_params,
    t,
)

_cache: dict = {}


@pytest.fixture
def flash_calls(monkeypatch):
    """The query shapes of every call of the flash kernel's plain version
    (what a CPU tensor inside the flash rule runs)."""
    seen = []
    real = patt.flash_attention_reference

    def spy(q, k, v, *a, **kw):
        seen.append((tuple(q.shape), k.shape[1]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(patt, "flash_attention_reference", spy)
    return seen


def _inputs(seed=0, b=2, ctx_len=8):
    _, pc, _, _ = sdxl_params()
    rng = np.random.default_rng(seed)
    side = pc.unet.sample_size
    return dict(
        x=rng.standard_normal((b, side, side, 4)).astype(np.float32),
        ctx=rng.standard_normal((b, ctx_len, pc.unet.cross_attention_dim)).astype(np.float32),
        ts=np.asarray([981, 3][:b], np.int32),
        time_ids=np.asarray([[1024, 1024, 0, 0, 1024, 1024], [512, 768, 16, 32, 1024, 1024]][:b],
                            np.float32),
        text=rng.standard_normal((b, pc.pooled_dim)).astype(np.float32),
    )


def _jadded(c):
    return {"time_ids": jnp.asarray(c["time_ids"]), "text_embeds": jnp.asarray(c["text"])}


def _padded(c):
    return {"time_ids": t(c["time_ids"]), "text_embeds": t(c["text"])}


def test_dreamllm_sdxl_7b_matches_the_project_recipe():
    """``configs.dreamllm_sdxl_7b`` equals what the JAX project builds from
    ``projects/dreamllm_sdxl/configs/common.py``, field for field; every
    part in the given dtype but the VAE (float32) and the global projector
    (float32, as JAX's); ``make_add_time_ids`` as JAX's."""
    from projects.dreamllm.train import build_model_cfg
    from projects.dreamllm_sdxl.configs import common

    jm, jh = build_model_cfg({"model": common.model, "sd_head": common.sd_head,
                              "head_type": "sdxl"})
    pm, ph = pconfigs.dreamllm_sdxl_7b(torch.bfloat16)
    assert config_fields(pm) == config_fields(jm)
    assert config_fields(ph) == config_fields(jh)
    assert (ph.unet.sample_size, pm.n_dream_queries, ph.vae.scaling_factor) == (128, 196, 0.13025)
    assert ph.unet.dtype == ph.projector_cfg().dtype == pm.llm.dtype == torch.bfloat16
    assert ph.vae_dtype == ph.global_projector_cfg().dtype == torch.float32
    np.testing.assert_array_equal(
        n(psdxl.make_add_time_ids((1024, 768), (8, 16), (1024, 1024), 3)),
        np.asarray(jsdxl.make_add_time_ids((1024, 768), (8, 16), (1024, 1024), 3)))


def test_unet_time_embedding_matches_jax():
    """The time embedding plus the text-time addition, 1e-4; a text-time
    UNet refuses to run without ``added_cond``."""
    jc, pc, jp, pp = sdxl_params()
    c = _inputs()
    want = junet._unet_time_embedding(jp["unet"], jc.unet, jnp.asarray(c["ts"]), _jadded(c),
                                      jnp.asarray(c["x"]))
    got = punet._unet_time_embedding(pp["unet"], pc.unet, t(c["ts"]), _padded(c), t(c["x"]))
    assert tuple(got.shape) == (2, pc.unet.time_embed_dim)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    bare = punet._unet_time_embedding(pp["unet"], pc.unet, t(c["ts"]),
                                      {"time_ids": t(c["time_ids"]),
                                       "text_embeds": torch.zeros(2, pc.pooled_dim)}, t(c["x"]))
    assert float((bare - got).abs().max()) > 1e-2  # the pooled embedding is seen
    with pytest.raises(ValueError, match="added_cond"):
        punet._unet_time_embedding(pp["unet"], pc.unet, t(c["ts"]), None, t(c["x"]))


def _jax_unet_case(ctx_len):
    if ("unet", ctx_len) not in _cache:
        jc, _, jp, _ = sdxl_params()
        c = _inputs(ctx_len=ctx_len)
        fwd = jax.jit(junet.unet_forward, static_argnums=1, static_argnames="return_deep")
        out, deep = fwd(jp["unet"], jc.unet, jnp.asarray(c["x"]), jnp.asarray(c["ts"]),
                        jnp.asarray(c["ctx"]), _jadded(c), return_deep=True)
        x2 = c["x"] + 0.1 * np.random.default_rng(9).standard_normal(c["x"].shape).astype(
            np.float32)
        shallow = jax.jit(junet.unet_forward_shallow, static_argnums=1)(
            jp["unet"], jc.unet, jnp.asarray(x2), jnp.asarray([961, 1]), jnp.asarray(c["ctx"]),
            deep, _jadded(c))
        _cache[("unet", ctx_len)] = dict(c=c, x2=x2, out=np.asarray(out),
                                         deep=np.asarray(deep), shallow=np.asarray(shallow))
    return _cache[("unet", ctx_len)]


@pytest.mark.parametrize("ctx_len", [8, 128])
def test_unet_forward_and_shallow_with_added_cond_match_jax(ctx_len, flash_calls):
    """``unet_forward`` and ``unet_forward_shallow`` with ``added_cond``:
    1e-4 with outputs near rms 1. The full forward's 8 self-attentions of
    the second level (2 down, 4 up, 2 mid) take the flash path's plain
    version, and so do its 8 cross-attentions when the context passes the
    rule too (128 tokens; DreamLLM-SDXL's 196 dream queries do, SD-2.1's 64
    do not); the shallow forward runs only the first level, which has no
    attention."""
    _, pc, _, pp = sdxl_params()
    w = _jax_unet_case(ctx_len)
    c = w["c"]
    out, deep = punet.unet_forward(pp["unet"], pc.unet, t(c["x"]), t(c["ts"]), t(c["ctx"]),
                                   _padded(c), return_deep=True)
    want_calls = [((2, 256, 1, 128), 256), ((2, 256, 1, 128), ctx_len)] * 8
    assert flash_calls == [w_ for w_ in want_calls if w_[1] >= 128]
    assert float(np.sqrt((w["out"] ** 2).mean())) > 0.1
    np.testing.assert_allclose(n(out), w["out"], atol=1e-4)
    np.testing.assert_allclose(n(deep), w["deep"], atol=1e-4)
    shallow = punet.unet_forward_shallow(pp["unet"], pc.unet, t(w["x2"]), torch.tensor([961, 1]),
                                         t(c["ctx"]), deep, _padded(c))
    assert len(flash_calls) == (16 if ctx_len >= 128 else 8)
    np.testing.assert_allclose(n(shallow), w["shallow"], atol=1e-4)


def _residual_shapes(ucfg, b):
    """``[B, h, w, c]`` of every skip the UNet stacks, and of its mid block."""
    ch = pcn._skip_channels(ucfg)
    sides = [ucfg.sample_size]
    for i in range(len(ucfg.block_out_channels)):
        sides += [ucfg.sample_size >> i] * ucfg.layers_per_block
        if i < len(ucfg.block_out_channels) - 1:
            sides.append(ucfg.sample_size >> (i + 1))
    last = ucfg.sample_size >> (len(ucfg.block_out_channels) - 1)
    return ([(b, s, s, c) for s, c in zip(sides, ch)],
            (b, last, last, ucfg.block_out_channels[-1]))


@pytest.mark.parametrize("which", ["sd21", "sdxl"])
def test_residual_hooks_match_jax(which):
    """``down_block_residuals`` and ``mid_block_residual`` (rms 0.5) against
    JAX, 1e-4. Under ``remat`` they enter outside the checkpointed blocks:
    the same output and the same gradients, to the residuals too, bit for
    bit. A wrong count of residuals raises."""
    jc, pc, jp, pp = live_head_params() if which == "sd21" else sdxl_params()
    rng = np.random.default_rng(4)
    side = pc.unet.sample_size
    x = rng.standard_normal((2, side, side, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, pc.unet.cross_attention_dim)).astype(np.float32)
    ts = np.asarray([500, 20], np.int32)
    shapes, mid_shape = _residual_shapes(pc.unet, 2)
    res = [0.5 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    mid = 0.5 * rng.standard_normal(mid_shape).astype(np.float32)
    jadd = padd = None
    if which == "sdxl":
        c = _inputs()
        jadd, padd = _jadded(c), _padded(c)
    want = jax.jit(junet.unet_forward, static_argnums=1)(
        jp["unet"], jc.unet, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jadd,
        down_block_residuals=tuple(jnp.asarray(r) for r in res),
        mid_block_residual=jnp.asarray(mid))
    plain = junet.unet_forward(jp["unet"], jc.unet, jnp.asarray(x), jnp.asarray(ts),
                               jnp.asarray(ctx), jadd)
    assert float(np.abs(np.asarray(want) - np.asarray(plain)).max()) > 1e-2

    def port(remat):
        rs = [t(r).requires_grad_() for r in res]
        m = t(mid).requires_grad_()
        out = punet.unet_forward(pp["unet"], pc.unet, t(x), t(ts), t(ctx), padd,
                                 down_block_residuals=tuple(rs), mid_block_residual=m,
                                 remat=remat)
        grads = torch.autograd.grad((out * out).sum(), rs + [m])
        return out.detach(), grads

    got, grads = port(False)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    got_r, grads_r = port(True)
    assert torch.equal(got_r, got)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads))
    with pytest.raises(ValueError, match="residuals"):
        punet.unet_forward(pp["unet"], pc.unet, t(x), t(ts), t(ctx), padd,
                           down_block_residuals=tuple(t(r) for r in res[:-1]))


# ---------------------------------------------------------------------------
# The training loss
# ---------------------------------------------------------------------------


def _loss_case(case):
    """JAX's loss and gradients (projector, global projector, cond) for one
    batch of two rows, two dream spans each, one span invalid."""
    key = ("loss", case)
    if key not in _cache:
        jc, _, jp, _ = sdxl_params()
        if case == "knobs":
            jc = dataclasses.replace(jc, noise_offset=0.05, input_perturbation=0.1, snr_gamma=5.0)
        rng = np.random.default_rng(11)
        images = rng.uniform(-1, 1, (2, 2, 64, 64, 3)).astype(np.float32)
        cond = rng.standard_normal((2, 2, 8, 64)).astype(np.float32)
        uncond = rng.standard_normal((1, 8, 64)).astype(np.float32)
        valid = np.asarray([[True, True], [True, False]])
        tids = None
        if case == "knobs":
            tids = np.broadcast_to(np.asarray([512, 512, 8, 8, 64, 64], np.float32),
                                   (2, 2, 6)).copy()
        rng_key = jax.random.PRNGKey(3)

        def jloss(hp, cond_):
            return jsdxl.sdxl_head_loss({**jp, **hp}, jc, jnp.asarray(images), cond_,
                                        jnp.asarray(uncond), jnp.asarray(valid), rng_key,
                                        add_time_ids=None if tids is None else jnp.asarray(tids))[0]

        hp = {"projector": jp["projector"], "global_projector": jp["global_projector"]}
        loss, (ghp, gcond) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            hp, jnp.asarray(cond))
        draws = replay_draws(rng_key, n_samples=4, latent_shape=(32, 32, 4))
        _cache[key] = dict(jc=jc, images=images, cond=cond, uncond=uncond, valid=valid, tids=tids,
                           draws=draws, loss=float(loss), ghp=jax.tree.map(np.asarray, ghp),
                           gcond=np.asarray(gcond))
    return _cache[key]


@pytest.mark.parametrize("case,latents", [("plain", False), ("plain", True), ("knobs", True)])
def test_sdxl_head_loss_and_grads_match_jax(case, latents):
    """Loss 1e-5 relative; the gradients of the projector, the global
    projector and the dream states 1e-4 of each one's largest value. JAX's
    five-way key split is replayed (``replay_draws``). ``latents``: the port
    gets the latents from its ``encode_latents`` on JAX's VAE draw and skips
    the encoder, against JAX's loss with the encoder: the same numbers.
    ``knobs``: explicit ``add_time_ids``, noise offset, input perturbation
    and min-SNR weighting."""
    _, pc, _, pp = sdxl_params()
    w = _loss_case(case)
    if case == "knobs":
        pc = dataclasses.replace(pc, noise_offset=0.05, input_perturbation=0.1, snr_gamma=5.0)
    draws = dict(w["draws"])
    lat = None
    if latents:
        lat = psdxl.encode_latents(pp, pc, t(w["images"]), eps=draws.pop("vae_eps"))
        assert tuple(lat.shape) == (2, 2, 32, 32, 4)
    hp = {k: {"layers": [{n_: v.detach().clone().requires_grad_() for n_, v in layer.items()}
                         for layer in pp[k]["layers"]]}
          for k in ("projector", "global_projector")}
    cond = t(w["cond"]).requires_grad_()
    loss, aux = psdxl.sdxl_head_loss(
        {**pp, **hp}, pc, t(w["images"]), cond, t(w["uncond"]), t(w["valid"]), None,
        add_time_ids=None if w["tids"] is None else t(w["tids"]), latents=lat, draws=draws)
    assert torch.equal(aux["dm_mse"], loss)
    np.testing.assert_allclose(float(loss.detach()), w["loss"], rtol=1e-5)
    leaves = [hp[k]["layers"][0][p] for k in ("projector", "global_projector") for p in "wb"]
    got = torch.autograd.grad(loss, leaves + [cond])
    want = [w["ghp"][k]["layers"][0][p] for k in ("projector", "global_projector")
            for p in "wb"] + [w["gcond"]]
    for g, ref in zip(got, want):
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(n(g), ref, atol=1e-4 * scale)
    # the invalid span's states get no gradient
    assert float(got[-1][1, 1].abs().max()) == 0.0


def test_joint_forward_with_the_sdxl_head_matches_jax():
    """``dreamllm_forward`` with ``make_sdxl_head_loss_fn``: the batch's
    ``add_time_ids`` reach the UNet (a crop and an original size other than
    the image's), JAX's draws replayed; loss and both terms within 1e-5
    relative."""
    import dreamllm_tpu.models.dreamllm as jdl
    import dreamllm_tpu_torch.models.dreamllm as pdl
    from tests._torch_port_helpers import jax_batch, port_batch, train_batch

    jc, pc, jp, pp = dreamllm_params()
    jhc, phc, jhp, php = sdxl_params()
    batch = train_batch(seed=6, px=64)
    batch["add_time_ids"] = np.broadcast_to(
        np.asarray([48, 80, 4, 8, 64, 64], np.float32), (2, 1, 6)).copy()
    key = jax.random.PRNGKey(5)
    want, waux = jax.jit(lambda p, hp: jdl.dreamllm_forward(
        p, jc, jax_batch(batch), head_loss_fn=jsdxl.make_sdxl_head_loss_fn(jhc),
        head_params=hp, rng=key))(jp, jhp)
    draws = replay_draws(key, n_samples=2, latent_shape=(32, 32, 4))
    got, gaux = pdl.dreamllm_forward(pp, pc, port_batch(batch),
                                     head_loss_fn=psdxl.make_sdxl_head_loss_fn(phc),
                                     head_params=php, draws=draws)
    for k, w in (("loss", want), ("lm_loss", waux["lm_loss"]), ("vm_loss", waux["vm_loss"])):
        g = got if k == "loss" else gaux[k]
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=k)
    assert float(gaux["vm_loss"]) > 0


# ---------------------------------------------------------------------------
# The pipeline and the interleaved document
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler,rescale", [("ddim", 0.7), ("dpm", 0.0)])
def test_sdxl_head_pipeline_matches_jax(sampler, rescale):
    """Three steps from the same start latents, guidance 5.0 (JAX's
    default), batch 2 against one unconditional row: the images within 1e-4
    (float32 UNet and VAE)."""
    jc, pc, jp, pp = sdxl_params()
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((2, 8, 64)).astype(np.float32)
    uncond = rng.standard_normal((1, 8, 64)).astype(np.float32)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    kw = dict(num_inference_steps=3, guidance_rescale=rescale, sampler=sampler)
    want = jsdxl.sdxl_head_pipeline(jp, jc, jnp.asarray(cond), jnp.asarray(uncond),
                                    jax.random.PRNGKey(0), latents=jnp.asarray(lat), **kw)
    got = psdxl.sdxl_head_pipeline(pp, pc, t(cond), t(uncond), None, latents=t(lat), **kw)
    assert tuple(got.shape) == (2, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    assert float(np.asarray(want).std()) > 1e-2


def test_generate_interleaved_picks_the_sdxl_pipeline(monkeypatch):
    """With no ``pipeline_fn``, an SDXL head makes its image through
    ``sdxl_head_pipeline`` in both packages (each given the same start
    latents), conditioned on the whole dream span: the text identical, the
    image within 1e-3 (the decoder, projectors, 2 CFG UNet steps and the VAE
    in float32)."""
    jc, pc, jp, pp = dreamllm_params()
    _, phc, _, php = sdxl_params()
    jhc, _, jhp, _ = sdxl_params()
    rng = np.random.default_rng(8)
    ids = rng.integers(10, 31000, (1, 6)).astype(np.int32)
    noise = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    common = dict(max_new_tokens=10, max_images=1, num_inference_steps=2, guidance_scale=5.0,
                  sampler="dpm", append_image_span=True, force_image_interval=4)
    jcalls, pcalls = [], []
    jreal, preal = jsdxl.sdxl_head_pipeline, pgen.sdxl_head_pipeline

    def jpipe(*a, **kw):
        jcalls.append(a[2].shape)
        return jreal(*a, latents=jnp.asarray(noise), **kw)

    def ppipe(*a, **kw):
        pcalls.append(tuple(a[2].shape))
        return preal(*a, latents=t(noise), **kw)

    margins = []
    real_logits = pgen.llama_logits

    def logits_spy(*a):
        out = real_logits(*a)
        top2 = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return out

    monkeypatch.setattr(jsdxl, "sdxl_head_pipeline", jpipe)
    monkeypatch.setattr(pgen, "sdxl_head_pipeline", ppipe)
    monkeypatch.setattr(pgen, "sd_head_pipeline", None)  # must not be chosen
    monkeypatch.setattr(pgen, "llama_logits", logits_spy)
    want = jgen.generate_interleaved(
        jp, jc, jhp, jhc, jnp.asarray(ids),
        jgen.InterleavedConfig(sampling=jsamp.SamplingConfig(greedy=True, eos_token_id=-1),
                               **common), jax.random.PRNGKey(0))
    got = pgen.generate_interleaved(
        pp, pc, php, phc, t(ids),
        pgen.InterleavedConfig(sampling=psamp.SamplingConfig(greedy=True, eos_token_id=-1),
                               **common), None, device="cpu")
    assert min(margins) > 1e-3, min(margins)  # a greedy near-tie would be flaky, not wrong
    assert pcalls == [(1, pc.n_dream_queries, pc.llm.hidden_size)] and len(jcalls) == 1
    kinds = [s[0] for s in got["segments"]]
    assert kinds == [s[0] for s in want["segments"]] == ["text", "image", "text"]
    for (kind, g), (_, w) in zip(got["segments"], want["segments"]):
        if kind == "text":
            assert n(g).tolist() == np.asarray(w).tolist()
        else:
            assert tuple(g.shape) == (64, 64, 3)
            np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-3)
