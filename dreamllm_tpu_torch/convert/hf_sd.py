"""diffusers AutoencoderKL / UNet2DConditionModel / ControlNetModel state
dicts <-> the port's SD trees (port of ``dreamllm_tpu/convert/hf_sd.py``).

Covers the checkpoints the reference loads (modeling_plugins.py:375-381:
``AutoencoderKL.from_pretrained``, ``UNet2DConditionModel.from_pretrained``,
e.g. stabilityai/stable-diffusion-2-1-base), keyed by diffusers' module
names. The converters return the JAX package's layout as CPU tensors of the
target dtype (``bridge.from_jax`` carries it into the port's):

  * conv ``[out,in,kh,kw]`` -> HWIO ``(2,3,1,0)``;
  * linear ``[out,in]`` -> ``[in,out]``;
  * GEGLU ``ff.net.0.proj``: diffusers chunks its output as ``(value,
    gate)``; the tree's ``ff_in`` convention is ``(gate, up)``: the two
    row-halves are swapped here at conversion time.

The ``export_*`` inverses take the port's own trees (OIHW conv kernels, as
the port's ``init_*`` functions and ``from_jax`` leave them) and give
diffusers-named CPU tensors in the tree's dtype.

Only ``use_linear_projection=True`` transformers are supported (SD 2.x and
SDXL, the models the reference ships; SD 1.x uses 1x1-conv projections).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dreamllm_tpu_torch.convert._tensors import cast, hwio, to_tensor, transposed
from dreamllm_tpu_torch.models.sd.unet import UNetConfig
from dreamllm_tpu_torch.models.sd.vae import VAEConfig


def _conv(sd, name, dtype):
    return {"w": hwio(sd[name + ".weight"], dtype), "b": cast(sd[name + ".bias"], dtype)}


def _linear(sd, name, dtype):
    return {"w": transposed(sd[name + ".weight"], dtype), "b": cast(sd[name + ".bias"], dtype)}


def _norm(sd, name, dtype):
    return {"w": cast(sd[name + ".weight"], dtype), "b": cast(sd[name + ".bias"], dtype)}


def _resnet(sd, p, dtype, temb=False):
    out = {
        "norm1": _norm(sd, p + ".norm1", dtype),
        "conv1": _conv(sd, p + ".conv1", dtype),
        "norm2": _norm(sd, p + ".norm2", dtype),
        "conv2": _conv(sd, p + ".conv2", dtype),
    }
    if temb and p + ".time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _linear(sd, p + ".time_emb_proj", dtype)
    if p + ".conv_shortcut.weight" in sd:
        out["shortcut"] = _conv(sd, p + ".conv_shortcut", dtype)
    return out


def _vae_attn(sd, p, dtype):
    return {
        "norm": _norm(sd, p + ".group_norm", dtype),
        "q": _linear(sd, p + ".to_q", dtype),
        "k": _linear(sd, p + ".to_k", dtype),
        "v": _linear(sd, p + ".to_v", dtype),
        "out": _linear(sd, p + ".to_out.0", dtype),
    }


def convert_vae_state_dict(state_dict: Mapping[str, Any], cfg: VAEConfig, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    sd = state_dict
    n = len(cfg.block_out_channels)

    enc: dict = {"conv_in": _conv(sd, "encoder.conv_in", dtype)}
    down = []
    for i in range(n):
        blk = {"resnets": [_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", dtype)
                           for j in range(cfg.layers_per_block)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", dtype)
        down.append(blk)
    enc["down"] = down
    enc["mid"] = {
        "resnet1": _resnet(sd, "encoder.mid_block.resnets.0", dtype),
        "attn": _vae_attn(sd, "encoder.mid_block.attentions.0", dtype),
        "resnet2": _resnet(sd, "encoder.mid_block.resnets.1", dtype),
    }
    enc["norm_out"] = _norm(sd, "encoder.conv_norm_out", dtype)
    enc["conv_out"] = _conv(sd, "encoder.conv_out", dtype)

    dec: dict = {"conv_in": _conv(sd, "decoder.conv_in", dtype)}
    dec["mid"] = {
        "resnet1": _resnet(sd, "decoder.mid_block.resnets.0", dtype),
        "attn": _vae_attn(sd, "decoder.mid_block.attentions.0", dtype),
        "resnet2": _resnet(sd, "decoder.mid_block.resnets.1", dtype),
    }
    up = []
    for i in range(n):
        blk = {"resnets": [_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dtype)
                           for j in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dtype)
        up.append(blk)
    dec["up"] = up
    dec["norm_out"] = _norm(sd, "decoder.conv_norm_out", dtype)
    dec["conv_out"] = _conv(sd, "decoder.conv_out", dtype)

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv", dtype),
        "post_quant_conv": _conv(sd, "post_quant_conv", dtype),
    }


def _geglu_ff_in(sd, p, dtype):
    """diffusers GEGLU rows are (value, gate); the tree's are (gate, up=value)."""
    w = to_tensor(sd[p + ".weight"])  # [2*inner, in]
    b = to_tensor(sd[p + ".bias"])
    half = w.shape[0] // 2
    w = torch.cat([w[half:], w[:half]], dim=0)
    b = torch.cat([b[half:], b[:half]], dim=0)
    return {"w": transposed(w, dtype), "b": cast(b, dtype)}


def _attn(sd, p, dtype):
    return {
        "q": _linear(sd, p + ".to_q", dtype),
        "k": _linear(sd, p + ".to_k", dtype),
        "v": _linear(sd, p + ".to_v", dtype),
        "out": _linear(sd, p + ".to_out.0", dtype),
    }


def _tx_block(sd, p, dtype):
    return {
        "ln1": _norm(sd, p + ".norm1", dtype),
        "attn1": _attn(sd, p + ".attn1", dtype),
        "ln2": _norm(sd, p + ".norm2", dtype),
        "attn2": _attn(sd, p + ".attn2", dtype),
        "ln3": _norm(sd, p + ".norm3", dtype),
        "ff_in": _geglu_ff_in(sd, p + ".ff.net.0.proj", dtype),
        "ff_out": _linear(sd, p + ".ff.net.2", dtype),
    }


def _transformer2d(sd, p, n_layers, dtype):
    return {
        "norm": _norm(sd, p + ".norm", dtype),
        "proj_in": _linear(sd, p + ".proj_in", dtype),
        "blocks": [_tx_block(sd, f"{p}.transformer_blocks.{k}", dtype) for k in range(n_layers)],
        "proj_out": _linear(sd, p + ".proj_out", dtype),
    }


def _encoder_half(sd, u: UNetConfig, dtype) -> dict:
    """Time (and SDXL text-time) embeddings, ``conv_in``, the down blocks
    and the mid block: the part a ControlNet shares with the UNet."""
    p: dict = {
        "time_embedding": {
            "linear_1": _linear(sd, "time_embedding.linear_1", dtype),
            "linear_2": _linear(sd, "time_embedding.linear_2", dtype),
        },
        "conv_in": _conv(sd, "conv_in", dtype),
    }
    if u.addition_embed_type == "text_time":
        p["add_embedding"] = {
            "linear_1": _linear(sd, "add_embedding.linear_1", dtype),
            "linear_2": _linear(sd, "add_embedding.linear_2", dtype),
        }
    down = []
    for i, btype in enumerate(u.down_block_types):
        blk = {"resnets": [_resnet(sd, f"down_blocks.{i}.resnets.{j}", dtype, temb=True)
                           for j in range(u.layers_per_block)]}
        if btype == "CrossAttnDownBlock2D":
            blk["attentions"] = [
                _transformer2d(sd, f"down_blocks.{i}.attentions.{j}",
                               u.transformer_layers_per_block[i], dtype)
                for j in range(u.layers_per_block)
            ]
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", dtype)
        down.append(blk)
    p["down"] = down
    p["mid"] = {
        "resnet1": _resnet(sd, "mid_block.resnets.0", dtype, temb=True),
        "attention": _transformer2d(sd, "mid_block.attentions.0",
                                    u.transformer_layers_per_block[-1], dtype),
        "resnet2": _resnet(sd, "mid_block.resnets.1", dtype, temb=True),
    }
    return p


def convert_unet_state_dict(state_dict: Mapping[str, Any], cfg: UNetConfig, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    sd = state_dict
    p = _encoder_half(sd, cfg, dtype)
    up = []
    rev_tl = list(reversed(cfg.transformer_layers_per_block))
    for i, btype in enumerate(cfg.up_block_types):
        blk = {"resnets": [_resnet(sd, f"up_blocks.{i}.resnets.{j}", dtype, temb=True)
                           for j in range(cfg.layers_per_block + 1)]}
        if btype == "CrossAttnUpBlock2D":
            blk["attentions"] = [
                _transformer2d(sd, f"up_blocks.{i}.attentions.{j}", rev_tl[i], dtype)
                for j in range(cfg.layers_per_block + 1)
            ]
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", dtype)
        up.append(blk)
    p["up"] = up
    p["norm_out"] = _norm(sd, "conv_norm_out", dtype)
    p["conv_out"] = _conv(sd, "conv_out", dtype)
    return p


def convert_controlnet_state_dict(state_dict: Mapping[str, Any], cfg, dtype=None) -> dict:
    """diffusers ControlNetModel -> the ``models/sd/controlnet.py`` tree. The
    encoder part (time_embedding/conv_in/down_blocks/mid_block) shares the
    UNet name mapping; the rest is the conditioning embedder and the zero
    convs (``controlnet_cond_embedding.*``, ``controlnet_down_blocks.{i}``,
    ``controlnet_mid_block``)."""
    from dreamllm_tpu_torch.models.sd.controlnet import n_skip_residuals

    u = cfg.unet
    dtype = dtype or u.dtype
    sd = state_dict
    p = _encoder_half(sd, u, dtype)
    n_blocks = len(cfg.conditioning_embedding_out_channels) - 1
    p["cond_embedding"] = {
        "conv_in": _conv(sd, "controlnet_cond_embedding.conv_in", dtype),
        "blocks": [
            {
                "conv1": _conv(sd, f"controlnet_cond_embedding.blocks.{2 * i}", dtype),
                "conv2": _conv(sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}", dtype),
            }
            for i in range(n_blocks)
        ],
        "conv_out": _conv(sd, "controlnet_cond_embedding.conv_out", dtype),
    }
    p["zero_convs"] = [_conv(sd, f"controlnet_down_blocks.{i}", dtype)
                       for i in range(n_skip_residuals(u))]
    p["mid_zero_conv"] = _conv(sd, "controlnet_mid_block", dtype)
    return p


# ---------------------------------------------------------------------------
# Inverse: the port's trees -> diffusers-named state dicts (writing
# checkpoints in the published layout, and round-trip tests of the mapping)
# ---------------------------------------------------------------------------


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().contiguous()


def _inv_conv(out, name, p):
    out[name + ".weight"] = _leaf(p["w"])  # the port keeps torch's OIHW
    out[name + ".bias"] = _leaf(p["b"])


def _inv_linear(out, name, p):
    out[name + ".weight"] = _leaf(p["w"].t())
    out[name + ".bias"] = _leaf(p["b"])


def _inv_norm(out, name, p):
    out[name + ".weight"] = _leaf(p["w"])
    out[name + ".bias"] = _leaf(p["b"])


def _inv_resnet(out, name, p):
    _inv_norm(out, name + ".norm1", p["norm1"])
    _inv_conv(out, name + ".conv1", p["conv1"])
    _inv_norm(out, name + ".norm2", p["norm2"])
    _inv_conv(out, name + ".conv2", p["conv2"])
    if "time_emb_proj" in p:
        _inv_linear(out, name + ".time_emb_proj", p["time_emb_proj"])
    if "shortcut" in p:
        _inv_conv(out, name + ".conv_shortcut", p["shortcut"])


def _inv_vae_attn(out, name, p):
    _inv_norm(out, name + ".group_norm", p["norm"])
    _inv_linear(out, name + ".to_q", p["q"])
    _inv_linear(out, name + ".to_k", p["k"])
    _inv_linear(out, name + ".to_v", p["v"])
    _inv_linear(out, name + ".to_out.0", p["out"])


def _inv_tx_block(out, name, p):
    _inv_norm(out, name + ".norm1", p["ln1"])
    for attn in ("attn1", "attn2"):
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", "to_out.0")):
            _inv_linear(out, f"{name}.{attn}.{b}", p[attn][a])
    _inv_norm(out, name + ".norm2", p["ln2"])
    _inv_norm(out, name + ".norm3", p["ln3"])
    # (gate, up) rows -> diffusers (value, gate)
    w = p["ff_in"]["w"].t()  # [2*inner, in]
    b = p["ff_in"]["b"]
    half = w.shape[0] // 2
    out[name + ".ff.net.0.proj.weight"] = _leaf(torch.cat([w[half:], w[:half]], dim=0))
    out[name + ".ff.net.0.proj.bias"] = _leaf(torch.cat([b[half:], b[:half]], dim=0))
    _inv_linear(out, name + ".ff.net.2", p["ff_out"])


def _inv_transformer2d(out, name, p):
    _inv_norm(out, name + ".norm", p["norm"])
    _inv_linear(out, name + ".proj_in", p["proj_in"])
    for k, blk in enumerate(p["blocks"]):
        _inv_tx_block(out, f"{name}.transformer_blocks.{k}", blk)
    _inv_linear(out, name + ".proj_out", p["proj_out"])


def export_vae_state_dict(params: dict) -> dict:
    out: dict = {}
    e = params["encoder"]
    _inv_conv(out, "encoder.conv_in", e["conv_in"])
    for i, blk in enumerate(e["down"]):
        for j, r in enumerate(blk["resnets"]):
            _inv_resnet(out, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in blk:
            _inv_conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
    _inv_resnet(out, "encoder.mid_block.resnets.0", e["mid"]["resnet1"])
    _inv_vae_attn(out, "encoder.mid_block.attentions.0", e["mid"]["attn"])
    _inv_resnet(out, "encoder.mid_block.resnets.1", e["mid"]["resnet2"])
    _inv_norm(out, "encoder.conv_norm_out", e["norm_out"])
    _inv_conv(out, "encoder.conv_out", e["conv_out"])

    d = params["decoder"]
    _inv_conv(out, "decoder.conv_in", d["conv_in"])
    _inv_resnet(out, "decoder.mid_block.resnets.0", d["mid"]["resnet1"])
    _inv_vae_attn(out, "decoder.mid_block.attentions.0", d["mid"]["attn"])
    _inv_resnet(out, "decoder.mid_block.resnets.1", d["mid"]["resnet2"])
    for i, blk in enumerate(d["up"]):
        for j, r in enumerate(blk["resnets"]):
            _inv_resnet(out, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            _inv_conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    _inv_norm(out, "decoder.conv_norm_out", d["norm_out"])
    _inv_conv(out, "decoder.conv_out", d["conv_out"])
    _inv_conv(out, "quant_conv", params["quant_conv"])
    _inv_conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def _inv_encoder_half(out, params):
    _inv_linear(out, "time_embedding.linear_1", params["time_embedding"]["linear_1"])
    _inv_linear(out, "time_embedding.linear_2", params["time_embedding"]["linear_2"])
    if "add_embedding" in params:
        _inv_linear(out, "add_embedding.linear_1", params["add_embedding"]["linear_1"])
        _inv_linear(out, "add_embedding.linear_2", params["add_embedding"]["linear_2"])
    _inv_conv(out, "conv_in", params["conv_in"])
    for i, blk in enumerate(params["down"]):
        for j, r in enumerate(blk["resnets"]):
            _inv_resnet(out, f"down_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(blk.get("attentions", [])):
            _inv_transformer2d(out, f"down_blocks.{i}.attentions.{j}", a)
        if "downsample" in blk:
            _inv_conv(out, f"down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
    _inv_resnet(out, "mid_block.resnets.0", params["mid"]["resnet1"])
    _inv_transformer2d(out, "mid_block.attentions.0", params["mid"]["attention"])
    _inv_resnet(out, "mid_block.resnets.1", params["mid"]["resnet2"])


def export_unet_state_dict(params: dict) -> dict:
    out: dict = {}
    _inv_encoder_half(out, params)
    for i, blk in enumerate(params["up"]):
        for j, r in enumerate(blk["resnets"]):
            _inv_resnet(out, f"up_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(blk.get("attentions", [])):
            _inv_transformer2d(out, f"up_blocks.{i}.attentions.{j}", a)
        if "upsample" in blk:
            _inv_conv(out, f"up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    _inv_norm(out, "conv_norm_out", params["norm_out"])
    _inv_conv(out, "conv_out", params["conv_out"])
    return out


def export_controlnet_state_dict(params: dict) -> dict:
    out: dict = {}
    _inv_encoder_half(out, params)
    emb = params["cond_embedding"]
    _inv_conv(out, "controlnet_cond_embedding.conv_in", emb["conv_in"])
    for i, blk in enumerate(emb["blocks"]):
        _inv_conv(out, f"controlnet_cond_embedding.blocks.{2 * i}", blk["conv1"])
        _inv_conv(out, f"controlnet_cond_embedding.blocks.{2 * i + 1}", blk["conv2"])
    _inv_conv(out, "controlnet_cond_embedding.conv_out", emb["conv_out"])
    for i, z in enumerate(params["zero_convs"]):
        _inv_conv(out, f"controlnet_down_blocks.{i}", z)
    _inv_conv(out, "controlnet_mid_block", params["mid_zero_conv"])
    return out
