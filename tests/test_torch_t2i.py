"""Text-to-image creation in the PyTorch port against the JAX package, on
the CPU in float32 at tiny sizes: ``encode_prompt_embeds``, the UNet's deep
feature and DeepCache's shallow forward, ``ddpm_step``, and
``sd_head_pipeline`` with ``deepcache_interval`` as ``projects/dreamllm/
inference.py`` drives it (a prompt with the positive suffix, the negative
prompt as the unconditional side), both on JAX's weights (``bridge.from_jax``)
and the same start latents.

Both packages start the UNet's ``conv_out`` at std 1e-5, which at these
widths leaves the UNet's output near 1e-4 and the images next to their start
latents: an absolute limit of 1e-4 would then pass a wrong shallow forward.
So the UNet tests and the pipeline tests redraw ``conv_out`` at its fan-in
scale on the JAX side before ``bridge.from_jax`` (:func:`live_head`), which
puts the UNet's output near rms 0.5, and planted faults in the shallow
forward must fail the same check.

Tolerances: 1e-5 for the scheduler step (the same float32 formulas), 1e-4
for the UNet outputs, the deep feature, the shallow forward and the
pipeline's images and latents (float32 through resnets, attention and the
VAE in other orders); the prompt states within the decoder tests' 1e-4 and
their greedy pick identical after its top-2 margin is asserted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.data.tokenization as jtok
import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.llama as jllama
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu.models.sd.schedulers as jsch
import dreamllm_tpu.models.sd.unet as junet
import dreamllm_tpu.models.sd.vae as jvae
import dreamllm_tpu_torch.data.tokenization as ptok
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.models.sd.schedulers as psch
import dreamllm_tpu_torch.models.sd.unet as punet
import dreamllm_tpu_torch.models.sd.vae as pvae
from tests._torch_port_helpers import dreamllm_params, head_params, n, t, to_port

# projects/dreamllm/inference.py, mode "t2i"
POSITIVE_SUFFIX = ", best quality, extremely detailed"
NEGATIVE_PROMPT = (
    "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
    "fewer digits, cropped, worst quality, low quality"
)
PROMPT = "a red fox sitting in fresh snow under a pine tree"

# the JAX parity suite's tiny UNet (tests/test_sd_torch_parity.py): two
# resnets a block, so DeepCache's shallow forward takes three skips
PARITY_UNET = dict(sample_size=8, block_out_channels=(16, 32),
                   down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                   up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                   layers_per_block=2, transformer_layers_per_block=(1, 1),
                   num_attention_heads=(2, 4), cross_attention_dim=24, norm_num_groups=4)
PARITY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4,
                  latent_channels=4)

_cache: dict = {}


def parity_head():
    """(JAX cfg, port cfg, JAX params, port params) of the parity suite's
    tiny SD head, llm hidden 12, initialised by JAX from ``PRNGKey(0)``."""
    if "head" not in _cache:
        jc = jhead.SDHeadConfig(unet=junet.UNetConfig(**PARITY_UNET),
                                vae=jvae.VAEConfig(**PARITY_VAE), llm_hidden_size=12)
        pc = phead.SDHeadConfig(unet=punet.UNetConfig(**PARITY_UNET),
                                vae=pvae.VAEConfig(**PARITY_VAE), llm_hidden_size=12)
        jp = jhead.init_sd_head_params(jax.random.PRNGKey(0), jc)
        _cache["head"] = (jc, pc, jp, to_port(jp, phead.init_sd_head_params(pc, device="meta")))
    return _cache["head"]


def live_head(which):
    """``head_params()`` (``"helpers"``) or :func:`parity_head` (``"parity"``)
    with the UNet's ``conv_out`` redrawn from a seed at its fan-in scale,
    std (9 cin)^-1/2, in the JAX tree and carried to the port."""
    key = ("live", which)
    if key not in _cache:
        jc, pc, jp, _ = head_params() if which == "helpers" else parity_head()
        conv = jp["unet"]["conv_out"]
        kh, kw, cin, cout = np.shape(conv["w"])  # HWIO
        w = np.random.default_rng(11).standard_normal((kh, kw, cin, cout)).astype(np.float32)
        w *= (kh * kw * cin) ** -0.5
        jp = {**jp, "unet": {**jp["unet"], "conv_out": {**conv, "w": jnp.asarray(w)}}}
        _cache[key] = (jc, pc, jp, to_port(jp, phead.init_sd_head_params(pc, device="meta")))
    return _cache[key]


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddpm_step_matches_jax(prediction, monkeypatch):
    """The same noise (JAX's draw, replayed through ``torch.randn``), t = 0
    included: 1e-5."""
    js = jsch.make_schedule(prediction_type=prediction)
    ps = psch.make_schedule(prediction_type=prediction)
    np.testing.assert_array_equal(n(ps.betas), np.asarray(js.betas))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    out = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)

    def step(ts, noise, generator=None):
        drawn = []

        def randn(shape, **kw):
            assert tuple(shape) == x.shape and kw["generator"] is generator
            drawn.append(shape)
            return noise.to(kw["dtype"])

        with monkeypatch.context() as m:
            m.setattr(torch, "randn", randn)
            got = psch.ddpm_step(ps, t(out), torch.tensor(ts), t(x), generator)
        assert len(drawn) == 1
        return got

    for i, ts in enumerate(([999, 500, 1], [0, 0, 0], [3, 0, 740])):
        key = jax.random.PRNGKey(i)
        want = jsch.ddpm_step(js, jnp.asarray(out), jnp.asarray(ts), jnp.asarray(x), key)
        got = step(ts, t(jax.random.normal(key, x.shape, jnp.float32)))
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a generator's draw: the t = 0 rows take no noise at all
    g = torch.Generator().manual_seed(0)
    a = psch.ddpm_step(ps, t(out), torch.tensor([0, 5, 0]), t(x), g)
    b = step([0, 5, 0], torch.zeros(x.shape), g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]) and not torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# UNet: the deep feature and the shallow (cached) forward
# ---------------------------------------------------------------------------


def unet_case(which):
    """JAX's outputs for one UNet case on :func:`live_head`: the full
    forward with its deep feature at ``ts``, then the shallow forward of the
    next step (perturbed latents, ``ts2``) on that deep feature."""
    key = ("unet", which)
    if key not in _cache:
        jc, pc, jp, pp = live_head(which)
        side = jc.unet.sample_size
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, side, side, 4)).astype(np.float32)
        ctx = rng.standard_normal((2, 8, jc.unet.cross_attention_dim)).astype(np.float32)
        ts, ts2 = np.asarray([981, 3], np.int32), np.asarray([961, 1], np.int32)
        x2 = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        # compiled: the JAX UNet runs several times faster under jit than op by op
        jout, jdeep = jax.jit(junet.unet_forward, static_argnums=1,
                              static_argnames="return_deep")(
            jp["unet"], jc.unet, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
            return_deep=True)
        jshallow = jax.jit(junet.unet_forward_shallow, static_argnums=1)(
            jp["unet"], jc.unet, jnp.asarray(x2), jnp.asarray(ts2), jnp.asarray(ctx), jdeep)
        _cache[key] = dict(x=x, x2=x2, ctx=ctx, ts=ts, ts2=ts2, out=np.asarray(jout),
                           deep=np.asarray(jdeep), shallow=np.asarray(jshallow))
    return _cache[key]


def port_shallow(which):
    _, pc, _, pp = live_head(which)
    c = unet_case(which)
    return punet.unet_forward_shallow(pp["unet"], pc.unet, t(c["x2"]), t(c["ts2"]),
                                      t(c["ctx"]), t(c["deep"]))


@pytest.mark.parametrize("which", ["helpers", "parity"])
def test_unet_deep_feature_and_shallow_forward_match_jax(which):
    """``unet_forward(return_deep=True)`` and ``unet_forward_shallow`` on the
    deep feature of the same step, against JAX: 1e-4 with outputs near rms
    0.5. ``helpers``: one resnet a block, 32x32 latents (the port's flash
    path on the first level); ``parity``: two resnets a block."""
    _, pc, _, pp = live_head(which)
    c = unet_case(which)
    pout, pdeep = punet.unet_forward(pp["unet"], pc.unet, t(c["x"]), t(c["ts"]), t(c["ctx"]),
                                     return_deep=True)
    side = pc.unet.sample_size
    assert tuple(pdeep.shape) == (2, side, side, pc.unet.block_out_channels[1])
    assert float(np.sqrt((c["out"] ** 2).mean())) > 0.1
    np.testing.assert_allclose(n(pout), c["out"], atol=1e-4)
    np.testing.assert_allclose(n(pdeep), c["deep"], atol=1e-4)
    assert torch.equal(punet.unet_forward(pp["unet"], pc.unet, t(c["x"]), t(c["ts"]),
                                          t(c["ctx"])), pout)
    assert float(np.sqrt((c["shallow"] ** 2).mean())) > 0.1
    np.testing.assert_allclose(n(port_shallow(which)), c["shallow"], atol=1e-4)


def _skips_reversed(monkeypatch, ts_full):
    real = punet._up_block
    monkeypatch.setattr(punet, "_up_block",
                        lambda blk, nh, g, h, temb, ctx, *take:
                        real(blk, nh, g, h, temb, ctx, *reversed(take)))


def _temb_of_the_full_step(monkeypatch, ts_full):
    real = punet._unet_time_embedding
    monkeypatch.setattr(punet, "_unet_time_embedding",
                        lambda p, cfg, ts, added, sample: real(p, cfg, t(ts_full), added, sample))


def _no_transformer(monkeypatch, ts_full):
    monkeypatch.setattr(punet, "_transformer2d", lambda p, h, ctx, nh, g: h)


@pytest.mark.parametrize("which", ["helpers", "parity"])
@pytest.mark.parametrize("plant", [_skips_reversed, _temb_of_the_full_step, _no_transformer],
                         ids=["skips_reversed", "temb_of_the_full_step", "no_transformer"])
def test_shallow_forward_check_sees_planted_faults(which, plant, monkeypatch):
    """The shallow forward's check above fails on a shallow forward that
    takes its skips in the wrong order, embeds the timestep of the full step
    that cached the deep feature, or leaves out the first level's
    transformers."""
    want = unet_case(which)["shallow"]
    plant(monkeypatch, unet_case(which)["ts"])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(n(port_shallow(which)), want, atol=1e-4)


# ---------------------------------------------------------------------------
# The prompt's dream states and the whole t2i path
# ---------------------------------------------------------------------------


def test_encode_prompt_embeds_matches_jax(monkeypatch):
    """The prompt's dream-query states within 1e-4, and the greedy token
    each state picks through the LM head identical (top-2 margins above
    1e-3 asserted first)."""
    jc, pc, jp, pp = dreamllm_params()
    for prompt in (PROMPT + POSITIVE_SUFFIX, NEGATIVE_PROMPT):
        want = jdl.encode_prompt_embeds(jp, jc, jtok.ToyTokenizer(), prompt)
        got = pdl.encode_prompt_embeds(pp, pc, ptok.ToyTokenizer(), prompt)
        assert tuple(got.shape) == (1, pc.n_dream_queries, pc.llm.hidden_size)
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
        plog = pllama.llama_logits(pp["llm"], pc.llm, got)[0]
        jlog = np.asarray(jllama.llama_logits(jp["llm"], jc.llm, want))[0]
        top2 = plog.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        np.testing.assert_array_equal(n(plog.argmax(-1)), jlog.argmax(-1))
    # plain attention, as JAX: the spliced forward never asks for the kernel
    seen = []
    real = pdl.llama_forward
    monkeypatch.setattr(pdl, "llama_forward",
                        lambda *a, **kw: seen.append(kw.get("use_flash")) or real(*a, **kw))
    pdl.encode_prompt_embeds(pp, pc, ptok.ToyTokenizer(), PROMPT)
    assert seen == [False]


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_t2i_with_deepcache_matches_jax(sampler):
    """inference.py's t2i path at DeepCache interval 2 (5 steps: full UNet
    at steps 0, 2 and 4, shallow at 1 and 3) with guidance 3.5: the prompt
    and the negative prompt through ``encode_prompt_embeds``, then the
    pipeline from the same latents. Images within 1e-4, and the final
    latents (``return_latents``) decode to those images."""
    jc, pc, jp, pp = dreamllm_params()
    jhc, phc, jhp, php = live_head("helpers")
    jcond = jdl.encode_prompt_embeds(jp, jc, jtok.ToyTokenizer(), PROMPT + POSITIVE_SUFFIX)
    jneg = jdl.encode_prompt_embeds(jp, jc, jtok.ToyTokenizer(), NEGATIVE_PROMPT)
    pcond = pdl.encode_prompt_embeds(pp, pc, ptok.ToyTokenizer(), PROMPT + POSITIVE_SUFFIX)
    pneg = pdl.encode_prompt_embeds(pp, pc, ptok.ToyTokenizer(), NEGATIVE_PROMPT)
    lat = np.random.default_rng(8).standard_normal((1, 32, 32, 4)).astype(np.float32)
    kw = dict(num_inference_steps=5, guidance_scale=3.5, sampler=sampler, deepcache_interval=2)
    want = jhead.sd_head_pipeline(jhp, jhc, jcond, jneg, None, latents=jnp.asarray(lat), **kw)
    got = phead.sd_head_pipeline(php, phc, pcond, pneg, None, latents=t(lat), **kw)
    assert tuple(got.shape) == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    latents = phead.sd_head_pipeline(php, phc, pcond, pneg, None, latents=t(lat),
                                     return_latents=True, **kw)
    assert tuple(latents.shape) == (1, 32, 32, 4) and latents.dtype == torch.float32
    decoded = pvae.vae_decode(php["vae"], phc.vae, latents / phc.vae.scaling_factor)
    assert torch.equal((decoded / 2.0 + 0.5).clamp(0.0, 1.0), got)


def test_deepcache_interval_selects_the_unet_per_step(monkeypatch):
    """Which steps run the full UNet: every step at interval 1, steps
    ``i % k == 0`` at interval k; a shallow step always gets the deep feature
    of the latest full step."""
    jc, pc, jp, pp = parity_head()
    calls = []
    real_full, real_shallow = phead.unet_forward, phead.unet_forward_shallow

    def full(*a, **kw):
        out, deep = real_full(*a, **kw)
        calls.append(("full", deep))
        return out, deep

    def shallow(*a):
        calls.append(("shallow", a[-1]))
        return real_shallow(*a)

    monkeypatch.setattr(phead, "unet_forward", full)
    monkeypatch.setattr(phead, "unet_forward_shallow", shallow)
    cond = torch.zeros((1, 3, 12))
    for k, want in ((1, "FFFFFFF"), (2, "FSFSFSF"), (3, "FSSFSSF")):
        calls.clear()
        phead.sd_head_pipeline(pp, pc, cond, cond, None, num_inference_steps=7,
                               deepcache_interval=k, latents=torch.zeros((1, 8, 8, 4)),
                               return_latents=True)
        assert "".join("F" if c == "full" else "S" for c, _ in calls) == want
        last_deep = None
        for kind, deep in calls:
            if kind == "full":
                last_deep = deep
            else:
                assert deep is last_deep


def test_deepcache_drift_is_bounded():
    """The port's copy of the JAX suite's ``TestDeepCacheDriftBound`` (same
    configuration, weights and inputs): the interval-2 drift from the full
    trajectory is nonzero, under 0.10 and under half the distance to an
    independent sample. On :func:`live_head`: with ``conv_out`` at its
    initial std 1e-5 the images barely leave their start latents and the
    drift reads near 1e-6 whatever the shallow forward does."""
    _, pc, _, pp = live_head("parity")
    rng = np.random.default_rng(0)
    cond_e = t(rng.standard_normal((1, 3, 12)).astype(np.float32))
    uncond_e = t(rng.standard_normal((1, 3, 12)).astype(np.float32))
    lat0 = t(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))

    def run(dc, seed_lat=lat0):
        return n(phead.sd_head_pipeline(pp, pc, cond_e, uncond_e, None, num_inference_steps=8,
                                        guidance_scale=3.0, deepcache_interval=dc,
                                        latents=seed_lat))

    full = run(1)
    dc2 = run(2)
    other = run(1, t(rng.standard_normal((1, 8, 8, 4)).astype(np.float32)))
    drift = float(np.abs(dc2 - full).mean())
    resample = float(np.abs(other - full).mean())
    assert resample > 0.1, resample  # the images follow the UNet, not only the latents
    assert drift > 0.0
    assert drift < 0.10, drift
    assert drift < 0.5 * resample, (drift, resample)
