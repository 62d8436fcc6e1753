"""UNet2DConditionModel, SD-2.1 and SDXL configurations (port of
``dreamllm_tpu/models/sd/unet.py``). Latents are NHWC at the boundary.

The spatial self-attention of each transformer block goes through
:func:`flash_attention`, exactly where the JAX UNet calls it: at 512 px the
64x64 (S 4096, 5 heads) and 32x32 (S 1024, 10 heads) levels pass the flash
rule and run the Hopper kernel; the 16x16 and 8x8 levels and every
cross-attention (64 KV tokens) take the plain path.

DeepCache: ``unet_forward(return_deep=True)`` also returns the feature that
enters the last (shallowest) up block, and :func:`unet_forward_shallow`
reuses it on the steps between two full ones, where only ``conv_in``, the
first down block and the last up block run: at 512 px that is the 64x64
level's 2 down and 3 up self-attentions, 5 flash launches of the full
forward's 10.

SDXL (:func:`sdxl_unet_config`): three levels, 1 / 2 / 10 transformer
layers, cross-attention width 2048, and the "text_time" addition embedding
(``added_cond``: six micro-conditioning ids embedded sinusoidally, after the
pooled text embedding, through ``add_embedding``, added to the time
embedding). At 1024 px its 64x64 (S 4096, 10 heads) and 32x32 (S 1024, 20
heads) levels pass the flash rule: 70 self-attentions a forward.

ControlNet: ``unet_forward(down_block_residuals=, mid_block_residual=)``
adds one residual to each skip after the down blocks and one to the mid
block's output, as diffusers' ``down_block_additional_residuals`` and
``mid_block_additional_residual`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.sd.blocks import (
    conv2d,
    dense,
    downsample,
    init_conv,
    init_dense,
    init_norm,
    init_resnet_block,
    resnet_block,
    timestep_embedding,
    upsample,
)
from dreamllm_tpu_torch.ops.activations import geglu
from dreamllm_tpu_torch.ops.attention import flash_attention
from dreamllm_tpu_torch.ops.norms import group_norm, layer_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    # SDXL's "text_time" addition: temb += linear_2(silu(linear_1(cat(
    #   pooled text embeds, sinusoidal(add_time_ids)))))
    addition_embed_type: str | None = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    dtype: torch.dtype = torch.float32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def sdxl_unet_config(**kw) -> UNetConfig:
    """SDXL-base's UNet (128x128 latents, 1024 px); ``kw`` overrides."""
    defaults = dict(
        sample_size=128,
        block_out_channels=(320, 640, 1280),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
        transformer_layers_per_block=(1, 2, 10),
        num_attention_heads=(5, 10, 20),
        cross_attention_dim=2048,
        addition_embed_type="text_time",
    )
    defaults.update(kw)
    return UNetConfig(**defaults)


# ---------------------------------------------------------------------------
# Transformer2D (spatial transformer with cross attention)
# ---------------------------------------------------------------------------


def _init_tx_block(c, ctx_dim, dtype, dev, gen) -> Params:
    return {
        "ln1": init_norm(c, dtype, dev),
        "attn1": {n: init_dense(c, c, dtype, dev, gen) for n in ("q", "k", "v", "out")},
        "ln2": init_norm(c, dtype, dev),
        "attn2": {
            "q": init_dense(c, c, dtype, dev, gen),
            "k": init_dense(ctx_dim, c, dtype, dev, gen),
            "v": init_dense(ctx_dim, c, dtype, dev, gen),
            "out": init_dense(c, c, dtype, dev, gen),
        },
        "ln3": init_norm(c, dtype, dev),
        "ff_in": init_dense(c, 8 * c, dtype, dev, gen),  # geglu gate | up
        "ff_out": init_dense(4 * c, c, dtype, dev, gen),
    }


def _init_transformer2d(c, n_layers, ctx_dim, dtype, dev, gen) -> Params:
    return {
        "norm": init_norm(c, dtype, dev),
        "proj_in": init_dense(c, c, dtype, dev, gen),
        "blocks": [_init_tx_block(c, ctx_dim, dtype, dev, gen) for _ in range(n_layers)],
        "proj_out": init_dense(c, c, dtype, dev, gen),
    }


def _mha(p, x, ctx, num_heads):
    b, s, c = x.shape
    hd = c // num_heads
    q = dense(x, p["q"]).reshape(b, s, num_heads, hd)
    k = dense(ctx, p["k"]).reshape(b, ctx.shape[1], num_heads, hd)
    v = dense(ctx, p["v"]).reshape(b, ctx.shape[1], num_heads, hd)
    o = flash_attention(q, k, v, causal=False).reshape(b, s, c)
    return dense(o, p["out"])


def _tx_block(p, x, ctx, num_heads):
    y = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
    x = x + _mha(p["attn1"], y, y, num_heads)
    x = x + _mha(p["attn2"], layer_norm(x, p["ln2"]["w"], p["ln2"]["b"]), ctx, num_heads)
    y = layer_norm(x, p["ln3"]["w"], p["ln3"]["b"])
    gate, up = dense(y, p["ff_in"]).chunk(2, dim=-1)
    return x + dense(geglu(gate, up), p["ff_out"])


def _transformer2d(p, x, ctx, num_heads, groups):
    b, h, w, c = x.shape
    y = group_norm(x, p["norm"]["w"], p["norm"]["b"], num_groups=groups).reshape(b, h * w, c)
    y = dense(y, p["proj_in"])
    for blk in p["blocks"]:
        y = _tx_block(blk, y, ctx, num_heads)
    y = dense(y, p["proj_out"])
    return x + y.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_unet_params(cfg: UNetConfig, *, generator: torch.Generator | None = None,
                     device="cuda") -> Params:
    for t in cfg.down_block_types + cfg.up_block_types:
        if t not in ("CrossAttnDownBlock2D", "DownBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"):
            raise NotImplementedError(f"UNet block type {t!r}")
    dev = resolve_device(device)
    d, gen = cfg.dtype, generator
    ch = cfg.block_out_channels
    ted = cfg.time_embed_dim
    p: Params = {
        "time_embedding": {
            "linear_1": init_dense(ch[0], ted, d, dev, gen),
            "linear_2": init_dense(ted, ted, d, dev, gen),
        },
        "conv_in": init_conv(3, 3, cfg.in_channels, ch[0], d, dev, gen),
    }
    if cfg.addition_embed_type == "text_time":
        p["add_embedding"] = {
            "linear_1": init_dense(cfg.projection_class_embeddings_input_dim, ted, d, dev, gen),
            "linear_2": init_dense(ted, ted, d, dev, gen),
        }

    down = []
    cin = ch[0]
    for i, btype in enumerate(cfg.down_block_types):
        cout = ch[i]
        blk: Params = {"resnets": [
            init_resnet_block(cin if j == 0 else cout, cout, ted, d, dev, gen)
            for j in range(cfg.layers_per_block)
        ]}
        if btype == "CrossAttnDownBlock2D":
            blk["attentions"] = [
                _init_transformer2d(cout, cfg.transformer_layers_per_block[i],
                                    cfg.cross_attention_dim, d, dev, gen)
                for _ in range(cfg.layers_per_block)
            ]
        if i < len(ch) - 1:
            blk["downsample"] = init_conv(3, 3, cout, cout, d, dev, gen)
        down.append(blk)
        cin = cout
    p["down"] = down

    c_mid = ch[-1]
    p["mid"] = {
        "resnet1": init_resnet_block(c_mid, c_mid, ted, d, dev, gen),
        "attention": _init_transformer2d(c_mid, cfg.transformer_layers_per_block[-1],
                                         cfg.cross_attention_dim, d, dev, gen),
        "resnet2": init_resnet_block(c_mid, c_mid, ted, d, dev, gen),
    }

    up = []
    rev = list(reversed(ch))
    prev_out = rev[0]
    n = len(ch)
    for i, btype in enumerate(cfg.up_block_types):
        cout = rev[i]
        cin_skip_last = rev[min(i + 1, n - 1)]
        resnets = []
        for j in range(cfg.layers_per_block + 1):
            skip_ch = cin_skip_last if j == cfg.layers_per_block else cout
            rin = prev_out if j == 0 else cout
            resnets.append(init_resnet_block(rin + skip_ch, cout, ted, d, dev, gen))
        blk = {"resnets": resnets}
        if btype == "CrossAttnUpBlock2D":
            tl = tuple(reversed(cfg.transformer_layers_per_block))[i]
            blk["attentions"] = [
                _init_transformer2d(cout, tl, cfg.cross_attention_dim, d, dev, gen)
                for _ in range(cfg.layers_per_block + 1)
            ]
        if i < n - 1:
            blk["upsample"] = init_conv(3, 3, cout, cout, d, dev, gen)
        up.append(blk)
        prev_out = cout
    p["up"] = up

    p["norm_out"] = init_norm(ch[0], d, dev)
    p["conv_out"] = init_conv(3, 3, ch[0], cfg.out_channels, d, dev, gen, scale=1e-5)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _unet_time_embedding(params: Params, cfg: UNetConfig, timesteps: torch.Tensor,
                         added_cond: dict | None, sample: torch.Tensor) -> torch.Tensor:
    """The time embedding, plus SDXL's text-time embedding of ``added_cond``
    (``time_ids [B, 6]``, ``text_embeds [B, pooled]``) on a "text_time"
    UNet: one implementation for the full, shallow and ControlNet
    forwards. As in JAX, the text-time input is the concatenation in the
    promoted dtype of ``text_embeds`` and ``sample``, and so is its sum with
    the time embedding."""
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(sample.dtype)
    te = params["time_embedding"]
    temb = dense(F.silu(dense(temb, te["linear_1"])), te["linear_2"])
    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("an SDXL UNet needs added_cond {'time_ids', 'text_embeds'}")
        tids = added_cond["time_ids"]
        tid_emb = timestep_embedding(tids.reshape(-1), cfg.addition_time_embed_dim)
        tid_emb = tid_emb.reshape(tids.shape[0], -1).to(sample.dtype)
        text = added_cond["text_embeds"]
        dt = torch.promote_types(text.dtype, tid_emb.dtype)
        add = torch.cat([text.to(dt), tid_emb.to(dt)], dim=-1)
        ae = params["add_embedding"]
        add = dense(F.silu(dense(add, ae["linear_1"])), ae["linear_2"])
        temb = temb.to(torch.promote_types(temb.dtype, add.dtype)) + add
    return temb


def _down_resnets(blk, n_heads, groups, h, temb, ctx) -> list:
    """A down block's resnets (each followed by its transformer, if any):
    their outputs, the block's skips."""
    outs = []
    for j, r in enumerate(blk["resnets"]):
        h = resnet_block(r, h, temb, groups=groups, eps=1e-5)
        if "attentions" in blk:
            h = _transformer2d(blk["attentions"][j], h, ctx, n_heads, groups)
        outs.append(h)
    return outs


def _up_block(blk, n_heads, groups, h, temb, ctx, *take):
    """An up block over its skips ``take``, the last one first."""
    for j, r in enumerate(blk["resnets"]):
        h = torch.cat([h, take[-(j + 1)]], dim=-1)
        h = resnet_block(r, h, temb, groups=groups, eps=1e-5)
        if "attentions" in blk:
            h = _transformer2d(blk["attentions"][j], h, ctx, n_heads, groups)
    if "upsample" in blk:
        h = upsample(blk["upsample"], h)
    return h


def _head_out(params: Params, groups: int, h: torch.Tensor) -> torch.Tensor:
    h = F.silu(group_norm(h, params["norm_out"]["w"], params["norm_out"]["b"],
                          num_groups=groups, eps=1e-5))
    return conv2d(h, params["conv_out"])


def unet_forward(
    params: Params,
    cfg: UNetConfig,
    sample: torch.Tensor,                 # [B, H, W, in_ch] latents (NHWC)
    timesteps: torch.Tensor,              # [B] or scalar
    encoder_hidden_states: torch.Tensor,  # [B, S_ctx, cross_attention_dim]
    added_cond: dict | None = None,       # SDXL: {"time_ids": [B, 6], "text_embeds": [B, 1280]}
    return_deep: bool = False,
    down_block_residuals: tuple | None = None,        # ControlNet: one a skip
    mid_block_residual: torch.Tensor | None = None,   # ControlNet
    remat: bool = False,
):
    """``remat``: checkpoint each down, mid and up block
    (``torch.utils.checkpoint``, non-reentrant): the backward keeps only the
    activations at block boundaries and recomputes inside a block; the
    ControlNet residuals are added outside the checkpointed blocks.
    ``return_deep``: return ``(out, deep)``, ``deep`` the input of the last
    up block (DeepCache's cached feature). ``down_block_residuals`` (one a
    skip, in the order the down blocks stack them: ``conv_in``'s output
    first) and ``mid_block_residual`` are cast to the skip's dtype and
    added."""
    g = cfg.norm_num_groups
    heads = cfg.num_attention_heads
    temb = _unet_time_embedding(params, cfg, timesteps, added_cond, sample)
    ctx = encoder_hidden_states.to(sample.dtype)

    def ckpt(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def down_blk(blk, n_heads, h, temb, ctx):
        outs = _down_resnets(blk, n_heads, g, h, temb, ctx)
        if "downsample" in blk:
            outs.append(downsample(blk["downsample"], outs[-1]))
        return tuple(outs)

    def mid_blk(m, h, temb, ctx):
        h = resnet_block(m["resnet1"], h, temb, groups=g, eps=1e-5)
        h = _transformer2d(m["attention"], h, ctx, heads[-1], g)
        return resnet_block(m["resnet2"], h, temb, groups=g, eps=1e-5)

    h = conv2d(sample, params["conv_in"])
    skips = [h]
    for i, blk in enumerate(params["down"]):
        outs = ckpt(down_blk, blk, heads[i], h, temb, ctx)
        skips.extend(outs)
        h = outs[-1]

    if down_block_residuals is not None:
        if len(down_block_residuals) != len(skips):
            raise ValueError(f"{len(down_block_residuals)} down-block residuals for "
                             f"{len(skips)} skips")
        skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_residuals)]

    h = ckpt(mid_blk, params["mid"], h, temb, ctx)
    if mid_block_residual is not None:
        h = h + mid_block_residual.to(h.dtype)

    rev_heads = list(reversed(heads))
    deep = None
    for i, blk in enumerate(params["up"]):
        if i == len(params["up"]) - 1:
            deep = h  # the feature entering the last (shallowest) up block
        n_res = len(blk["resnets"])
        take, skips = skips[-n_res:], skips[:-n_res]
        h = ckpt(_up_block, blk, rev_heads[i], g, h, temb, ctx, *take)

    out = _head_out(params, g, h)
    return (out, deep) if return_deep else out


def unet_forward_shallow(
    params: Params,
    cfg: UNetConfig,
    sample: torch.Tensor,                 # [B, H, W, in_ch] latents (NHWC)
    timesteps: torch.Tensor,              # [B] or scalar
    encoder_hidden_states: torch.Tensor,  # [B, S_ctx, cross_attention_dim]
    deep_feature: torch.Tensor,           # cached input of the last up block
    added_cond: dict | None = None,
) -> torch.Tensor:
    """DeepCache's cached step: ``conv_in`` and the first down block's
    resnets (and transformers) give fresh skips, and the last up block runs
    on ``deep_feature`` from the latest full step (:func:`unet_forward` with
    ``return_deep=True``), taking the skips last first, as the full forward
    does. The first down block's downsample and everything deeper are
    skipped."""
    g = cfg.norm_num_groups
    n_heads = cfg.num_attention_heads[0]
    temb = _unet_time_embedding(params, cfg, timesteps, added_cond, sample)
    ctx = encoder_hidden_states.to(sample.dtype)
    h = conv2d(sample, params["conv_in"])
    skips = [h] + _down_resnets(params["down"][0], n_heads, g, h, temb, ctx)
    h = _up_block(params["up"][-1], n_heads, g, deep_feature, temb, ctx, *skips)
    return _head_out(params, g, h)
