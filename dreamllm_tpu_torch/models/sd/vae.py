"""AutoencoderKL, SD 1.x/2.x layout (port of
``dreamllm_tpu/models/sd/vae.py``): encoder, sampling and decoder.

As in JAX both halves run in the dtype of what they are given: the pipeline
passes float32 latents and the training loss float32 images, so bf16 weights
are cast up per conv and the result comes out float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.sd.blocks import (
    attn_block,
    conv2d,
    downsample,
    init_attn_block,
    init_conv,
    init_norm,
    init_resnet_block,
    resnet_block,
    upsample,
)
from dreamllm_tpu_torch.ops.norms import group_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32


def init_vae_params(cfg: VAEConfig, *, generator: torch.Generator | None = None,
                    device="cuda") -> Params:
    dev = resolve_device(device)
    d, gen = cfg.dtype, generator
    ch = cfg.block_out_channels
    c_mid = ch[-1]

    def mid():
        return {
            "resnet1": init_resnet_block(c_mid, c_mid, None, d, dev, gen),
            "attn": init_attn_block(c_mid, d, dev, gen),
            "resnet2": init_resnet_block(c_mid, c_mid, None, d, dev, gen),
        }

    enc: Params = {"conv_in": init_conv(3, 3, cfg.in_channels, ch[0], d, dev, gen)}
    down = []
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": [init_resnet_block(cin if j == 0 else cout, cout, None, d, dev, gen)
                             for j in range(cfg.layers_per_block)]}
        if i < len(ch) - 1:
            block["downsample"] = init_conv(3, 3, cout, cout, d, dev, gen)
        down.append(block)
        cin = cout
    enc["down"] = down
    enc["mid"] = mid()
    enc["norm_out"] = init_norm(c_mid, d, dev)
    enc["conv_out"] = init_conv(3, 3, c_mid, 2 * cfg.latent_channels, d, dev, gen)

    dec: Params = {"conv_in": init_conv(3, 3, cfg.latent_channels, c_mid, d, dev, gen)}
    dec["mid"] = mid()
    up = []
    rev = list(reversed(ch))
    cin = rev[0]
    for i, cout in enumerate(rev):
        block = {"resnets": [init_resnet_block(cin if j == 0 else cout, cout, None, d, dev, gen)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsample"] = init_conv(3, 3, cout, cout, d, dev, gen)
        up.append(block)
        cin = cout
    dec["up"] = up
    dec["norm_out"] = init_norm(ch[0], d, dev)
    dec["conv_out"] = init_conv(3, 3, ch[0], cfg.out_channels, d, dev, gen)

    lc = cfg.latent_channels
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": init_conv(1, 1, 2 * lc, 2 * lc, d, dev, gen),
        "post_quant_conv": init_conv(1, 1, lc, lc, d, dev, gen),
    }


def vae_encode(params: Params, cfg: VAEConfig, x: torch.Tensor):
    """Image ``[B, H, W, 3]`` in [-1, 1] -> ``(mean, logvar)``, each
    ``[B, H/8, W/8, latent]``."""
    g = cfg.norm_num_groups
    e = params["encoder"]
    h = conv2d(x, e["conv_in"])
    for block in e["down"]:
        for r in block["resnets"]:
            h = resnet_block(r, h, groups=g)
        if "downsample" in block:
            h = downsample(block["downsample"], h, symmetric=False)
    m = e["mid"]
    h = resnet_block(m["resnet1"], h, groups=g)
    h = attn_block(m["attn"], h, groups=g)
    h = resnet_block(m["resnet2"], h, groups=g)
    h = F.silu(group_norm(h, e["norm_out"]["w"], e["norm_out"]["b"], num_groups=g))
    h = conv2d(h, e["conv_out"])
    h = conv2d(h, params["quant_conv"])
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_sample(mean: torch.Tensor, logvar: torch.Tensor,
               generator: torch.Generator | None = None, *,
               eps: torch.Tensor | None = None) -> torch.Tensor:
    """``DiagonalGaussianDistribution.sample()``: ``eps`` is the normal draw,
    or comes from ``generator`` on ``mean``'s device."""
    if eps is None:
        eps = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device, generator=generator)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def vae_decode(params: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latent ``[B, h, w, latent]`` (already / scaling_factor) → image
    ``[B, 8h, 8w, 3]``."""
    g = cfg.norm_num_groups
    d = params["decoder"]
    h = conv2d(z, params["post_quant_conv"])
    h = conv2d(h, d["conv_in"])
    m = d["mid"]
    h = resnet_block(m["resnet1"], h, groups=g)
    h = attn_block(m["attn"], h, groups=g)
    h = resnet_block(m["resnet2"], h, groups=g)
    for block in d["up"]:
        for r in block["resnets"]:
            h = resnet_block(r, h, groups=g)
        if "upsample" in block:
            h = upsample(block["upsample"], h)
    h = F.silu(group_norm(h, d["norm_out"]["w"], d["norm_out"]["b"], num_groups=g))
    return conv2d(h, d["conv_out"])
