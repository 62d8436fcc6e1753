"""ControlNet: spatial control of the diffusion UNet (port of
``dreamllm_tpu/models/sd/controlnet.py``).

* A trainable copy of the UNet's encoder (``time_embedding``, ``conv_in``,
  the down blocks and the mid block; ``add_embedding`` too on an SDXL
  UNet), laid out like the matching subtrees of ``init_unet_params`` so
  that a UNet's encoder weights copy straight in.
* A conditioning embedder from the control image (pixel space, NHWC in
  [0, 1]) down to the latent resolution.
* Zero-initialised 1x1 convolutions ("zero convs"), one a skip and one for
  the mid block: a fresh ControlNet adds exact zeros to the UNet.

``controlnet_forward`` returns the residuals that ``unet_forward(
down_block_residuals=, mid_block_residual=)`` adds.

The embedder's stride-2 convolutions pad as the JAX package's ``"SAME"``
does, XLA's rule: ``(0, 1)`` on an even side, ``(1, 1)`` on an odd one.
diffusers' ``ControlNetConditioningEmbedding`` pads 1 on every side, so a
ControlNet converted from diffusers differs from both packages there. The
encoder's own downsample pads 1 on every side, as the UNet's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.projector import _same_pad
from dreamllm_tpu_torch.models.sd.blocks import conv2d, downsample, init_conv, resnet_block
from dreamllm_tpu_torch.models.sd.unet import (
    UNetConfig,
    _down_resnets,
    _transformer2d,
    _unet_time_embedding,
    init_unet_params,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    conditioning_channels: int = 3
    # channel ladder of the conditioning embedder (diffusers' default)
    conditioning_embedding_out_channels: tuple[int, ...] = (16, 32, 96, 256)


def _skip_channels(cfg: UNetConfig) -> list[int]:
    """The channels of every skip ``unet_forward`` stacks, in order:
    ``conv_in``'s output, then each down block's resnets and its downsample
    (all but the last block)."""
    ch = [cfg.block_out_channels[0]]
    for i in range(len(cfg.down_block_types)):
        ch += [cfg.block_out_channels[i]] * cfg.layers_per_block
        if i < len(cfg.block_out_channels) - 1:
            ch.append(cfg.block_out_channels[i])
    return ch


def n_skip_residuals(cfg: UNetConfig) -> int:
    """How many down-block residuals a UNet of ``cfg`` takes: one a skip."""
    return len(_skip_channels(cfg))


def init_controlnet_params(cfg: ControlNetConfig, *, generator: torch.Generator | None = None,
                           device="cuda") -> Params:
    u = cfg.unet
    d, dev, gen = u.dtype, resolve_device(device), generator
    full = init_unet_params(u, generator=gen, device=dev)
    p: Params = {k: full[k] for k in ("time_embedding", "conv_in", "down", "mid")}
    if "add_embedding" in full:
        p["add_embedding"] = full["add_embedding"]
    del full

    # conditioning embedder: conv3x3 -> [conv3x3, conv3x3 stride 2]* -> zero conv3x3
    ch = cfg.conditioning_embedding_out_channels
    p["cond_embedding"] = {
        "conv_in": init_conv(3, 3, cfg.conditioning_channels, ch[0], d, dev, gen),
        "blocks": [{"conv1": init_conv(3, 3, ch[i], ch[i], d, dev, gen),
                    "conv2": init_conv(3, 3, ch[i], ch[i + 1], d, dev, gen)}
                   for i in range(len(ch) - 1)],
        "conv_out": init_conv(3, 3, ch[-1], u.block_out_channels[0], d, dev, gen, scale=0.0),
    }
    p["zero_convs"] = [init_conv(1, 1, c, c, d, dev, gen, scale=0.0) for c in _skip_channels(u)]
    c_mid = u.block_out_channels[-1]
    p["mid_zero_conv"] = init_conv(1, 1, c_mid, c_mid, d, dev, gen, scale=0.0)
    return p


def _conv_same_stride2(x: torch.Tensor, p: Params) -> torch.Tensor:
    """A 3x3 stride-2 conv padded as XLA's "SAME" pads it."""
    ph, pw = _same_pad(x.shape[1], 2), _same_pad(x.shape[2], 2)
    return conv2d(F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1])), p, stride=2, padding=0)


def controlnet_cond_embed(params: Params, cond_image: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` control image → ``[B, H/8, W/8, ch0]`` feature
    (diffusers' ``ControlNetConditioningEmbedding``, JAX's padding)."""
    h = F.silu(conv2d(cond_image, params["conv_in"]))
    for blk in params["blocks"]:
        h = F.silu(conv2d(h, blk["conv1"]))
        h = F.silu(_conv_same_stride2(h, blk["conv2"]))
    return conv2d(h, params["conv_out"])


def controlnet_forward(
    params: Params,
    cfg: ControlNetConfig,
    sample: torch.Tensor,                 # [B, h, w, in_ch] latents (NHWC)
    timesteps: torch.Tensor,              # [B] or scalar
    encoder_hidden_states: torch.Tensor,  # [B, S_ctx, cross_attention_dim]
    cond_image: torch.Tensor,             # [B, 8h, 8w, cond_ch] in [0, 1]
    conditioning_scale: float = 1.0,
    added_cond: dict | None = None,
):
    """``(down_residuals, mid_residual)`` for ``unet_forward``, as diffusers'
    ``ControlNetModel.forward`` computes them: the encoder runs on the
    latents plus the embedded control image, and each skip and the mid
    output pass their zero conv, scaled by ``conditioning_scale``."""
    u = cfg.unet
    g = u.norm_num_groups
    heads = u.num_attention_heads
    temb = _unet_time_embedding(params, u, timesteps, added_cond, sample)
    ctx = encoder_hidden_states.to(sample.dtype)

    h = conv2d(sample, params["conv_in"])
    h = h + controlnet_cond_embed(params["cond_embedding"], cond_image.to(h.dtype))
    skips = [h]
    for i, blk in enumerate(params["down"]):
        outs = _down_resnets(blk, heads[i], g, h, temb, ctx)
        skips.extend(outs)
        h = outs[-1]
        if "downsample" in blk:
            h = downsample(blk["downsample"], h)
            skips.append(h)

    m = params["mid"]
    h = resnet_block(m["resnet1"], h, temb, groups=g, eps=1e-5)
    h = _transformer2d(m["attention"], h, ctx, heads[-1], g)
    h = resnet_block(m["resnet2"], h, temb, groups=g, eps=1e-5)

    down_res = tuple(conv2d(s, z) * conditioning_scale
                     for s, z in zip(skips, params["zero_convs"]))
    mid_res = conv2d(h, params["mid_zero_conv"]) * conditioning_scale
    return down_res, mid_res
