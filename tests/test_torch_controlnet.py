"""ControlNet in the PyTorch port against the JAX package, on the CPU in
float32 at tiny sizes: the conditioning embedder (its stride-2 convs pad as
XLA's "SAME": ``(0, 1)`` on an even side), ``controlnet_forward``'s
residuals, the zero-initialised ControlNet as an exact no-op, and
``controlnet_pipeline`` from the same start latents.

The ControlNet sits over ``head_params()``'s UNet, whose first level (32x32
latents, one head of D 64, S 1024) passes the flash rule: the encoder's
self-attention there runs the kernel's plain version. The "live" weights
(``controlnet_params()``, ``live_head_params()``) have the embedder's
``conv_out``, the zero convs and the UNet's ``conv_out`` redrawn at their
fan-in scale, so that the checks see what lies behind them. Tolerance 1e-4
unless a test states otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.sd.controlnet as jcn
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu_torch.configs as pconfigs
import dreamllm_tpu_torch.models.sd.blocks as pblocks
import dreamllm_tpu_torch.models.sd.controlnet as pcn
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.models.sd.unet as punet
from dreamllm_tpu_torch.ops import attention as patt
from tests._torch_port_helpers import controlnet_params, live_head_params, n, t


def _symmetric(x, p):
    """The stride-2 conv with ``conv2d``'s default padding, 1 on every side
    (diffusers' convention)."""
    return pblocks.conv2d(x, p, stride=2)


@pytest.mark.parametrize("side", [16, 33])
def test_cond_embed_matches_jax_and_pads_as_xla(side, monkeypatch):
    """The embedder against JAX, 1e-4. On an even side XLA's "SAME" pads
    (0, 1) at stride 2, and the same embedder padding 1 on every side fails
    the check; on an odd side both pad (1, 1)."""
    _, _, jp, pp = controlnet_params()
    img = np.random.default_rng(side).uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    want = np.asarray(jcn.controlnet_cond_embed(jp["cond_embedding"], jnp.asarray(img)))
    got = pcn.controlnet_cond_embed(pp["cond_embedding"], t(img))
    assert tuple(got.shape) == (2, -(-side // 2), -(-side // 2), 64)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(n(got), want, atol=1e-4)
    monkeypatch.setattr(pcn, "_conv_same_stride2", _symmetric)
    sym = n(pcn.controlnet_cond_embed(pp["cond_embedding"], t(img)))
    if side % 2 == 0:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(sym, want, atol=1e-4)
    else:
        np.testing.assert_allclose(sym, want, atol=1e-4)


def test_skip_count_and_layout_match_jax():
    """One residual a skip, as JAX counts them (12 over DreamLLM-7B's SD-2.1
    UNet, ``configs.controlnet_7b``); the ControlNet's encoder subtrees have
    the UNet's layout and the zero convs are zero."""
    cn7 = pconfigs.controlnet_7b()
    assert cn7.unet == pconfigs.dreamllm_7b()[1].unet
    assert pcn.n_skip_residuals(cn7.unet) == 12
    assert cn7.conditioning_embedding_out_channels == (16, 32, 96, 256)
    jc, pc, _, _ = controlnet_params()
    assert pcn.n_skip_residuals(pc.unet) == jcn.n_skip_residuals(jc.unet) == 4
    _, _, _, fresh = controlnet_params(live=False)
    unet = punet.init_unet_params(pc.unet, device="meta")
    for k in ("time_embedding", "conv_in", "down", "mid"):
        assert (torch.utils._pytree.tree_map(lambda x: tuple(x.shape), fresh[k])
                == torch.utils._pytree.tree_map(lambda x: tuple(x.shape), unet[k]))
    zeros = fresh["zero_convs"] + [fresh["mid_zero_conv"], fresh["cond_embedding"]["conv_out"]]
    assert len(fresh["zero_convs"]) == 4
    assert all(float(z["w"].abs().max()) == 0.0 and float(z["b"].abs().max()) == 0.0
               for z in zeros)


def _case(seed=6):
    _, pc, _, _ = controlnet_params()
    rng = np.random.default_rng(seed)
    side = pc.unet.sample_size
    return dict(x=rng.standard_normal((2, side, side, 4)).astype(np.float32),
                ctx=rng.standard_normal((2, 8, pc.unet.cross_attention_dim)).astype(np.float32),
                ts=np.asarray([900, 40], np.int32),
                img=rng.uniform(0, 1, (2, 2 * side, 2 * side, 3)).astype(np.float32))


def test_controlnet_forward_matches_jax(monkeypatch):
    """Every residual at conditioning scale 0.7 within 1e-4. The encoder's
    first-level self-attention (S 1024, D 64) runs the flash kernel's plain
    version; the 16x16 mid block's (D 32) does not."""
    jc, pc, jp, pp = controlnet_params()
    c = _case()
    seen = []
    real = patt.flash_attention_reference
    monkeypatch.setattr(patt, "flash_attention_reference",
                        lambda q, *a, **kw: seen.append(tuple(q.shape)) or real(q, *a, **kw))
    jdown, jmid = jax.jit(jcn.controlnet_forward, static_argnums=1)(
        jp, jc, jnp.asarray(c["x"]), jnp.asarray(c["ts"]), jnp.asarray(c["ctx"]),
        jnp.asarray(c["img"]), 0.7)
    down, mid = pcn.controlnet_forward(pp, pc, t(c["x"]), t(c["ts"]), t(c["ctx"]), t(c["img"]),
                                       conditioning_scale=0.7)
    assert seen == [(2, 1024, 1, 64)]
    assert len(down) == len(jdown) == 4
    for g, w in zip(down + (mid,), tuple(jdown) + (jmid,)):
        assert float(np.abs(np.asarray(w)).max()) > 0.1
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4)


def test_zero_initialised_controlnet_is_a_no_op():
    """A fresh ControlNet's residuals are zeros, and the UNet with them, and
    ``controlnet_pipeline`` with it, equal the plain UNet and
    ``sd_head_pipeline`` bit for bit."""
    _, pc, _, cn = controlnet_params(live=False)
    _, hc, _, hp = live_head_params()
    c = _case()
    down, mid = pcn.controlnet_forward(cn, pc, t(c["x"]), t(c["ts"]), t(c["ctx"]), t(c["img"]))
    assert all(float(r.abs().max()) == 0.0 for r in down + (mid,))
    plain = punet.unet_forward(hp["unet"], hc.unet, t(c["x"]), t(c["ts"]), t(c["ctx"]))
    with_res = punet.unet_forward(hp["unet"], hc.unet, t(c["x"]), t(c["ts"]), t(c["ctx"]),
                                  down_block_residuals=down, mid_block_residual=mid)
    assert torch.equal(with_res, plain)
    rng = np.random.default_rng(7)
    cond, uncond = (t(rng.standard_normal((b, 8, 64)).astype(np.float32)) for b in (2, 1))
    lat = t(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    kw = dict(num_inference_steps=2, guidance_scale=7.5, latents=lat)
    got = phead.controlnet_pipeline(hp, hc, cn, pc, t(c["img"]), cond, uncond, **kw)
    want = phead.sd_head_pipeline(hp, hc, cond, uncond, **kw)
    assert torch.equal(got, want)


def test_controlnet_pipeline_matches_jax():
    """Three DDIM steps at guidance 7.5, batch 2 against one unconditional
    row, conditioning scale 1: the images within 1e-4, and away from the
    plain pipeline's by more than 1e-2 (the ControlNet is seen)."""
    jc, pc, jp, pp = controlnet_params()
    jhc, phc, jhp, php = live_head_params()
    c = _case()
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((2, 8, 64)).astype(np.float32)
    uncond = rng.standard_normal((1, 8, 64)).astype(np.float32)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    want = np.asarray(jhead.controlnet_pipeline(
        jhp, jhc, jp, jc, jnp.asarray(c["img"]), jnp.asarray(cond), jnp.asarray(uncond),
        jax.random.PRNGKey(0), num_inference_steps=3, latents=jnp.asarray(lat)))
    got = phead.controlnet_pipeline(php, phc, pp, pc, t(c["img"]), t(cond), t(uncond),
                                    num_inference_steps=3, latents=t(lat))
    assert tuple(got.shape) == (2, 64, 64, 3)
    np.testing.assert_allclose(n(got), want, atol=1e-4)
    plain = phead.sd_head_pipeline(php, phc, t(cond), t(uncond), num_inference_steps=3,
                                   guidance_scale=7.5, latents=t(lat))
    assert float((plain - got).abs().max()) > 1e-2
