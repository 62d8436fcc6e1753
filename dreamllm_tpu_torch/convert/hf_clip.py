"""HF/torch CLIP checkpoints -> the port's CLIP trees (port of
``dreamllm_tpu/convert/hf_clip.py``).

Covers the weights the reference loads through
``CLIPVisionModel.from_pretrained`` (modeling_plugins.py:216-230) and the
full ``CLIPModel`` of the CLIP-select re-ranker. The trees are in the JAX
package's layout (torch conv ``[out, in, kh, kw]`` -> HWIO; linear ``[out,
in]`` -> ``[in, out]``; per-layer tensors stacked on axis 0), CPU tensors
of the target dtype; ``bridge.from_jax`` carries them into the port's.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dreamllm_tpu_torch.convert._tensors import cast, hwio, to_tensor, transposed
from dreamllm_tpu_torch.models.clip import CLIPVisionConfig
from dreamllm_tpu_torch.models.clip_text import CLIPTextConfig

# tree leaf -> (HF name inside ``encoder.layers.{l}.``, transposed), shared by
# the vision and the text tower
_LAYER = {
    "ln1_w": ("layer_norm1.weight", False), "ln1_b": ("layer_norm1.bias", False),
    "ln2_w": ("layer_norm2.weight", False), "ln2_b": ("layer_norm2.bias", False),
    "wq": ("self_attn.q_proj.weight", True), "bq": ("self_attn.q_proj.bias", False),
    "wk": ("self_attn.k_proj.weight", True), "bk": ("self_attn.k_proj.bias", False),
    "wv": ("self_attn.v_proj.weight", True), "bv": ("self_attn.v_proj.bias", False),
    "wo": ("self_attn.out_proj.weight", True), "bo": ("self_attn.out_proj.bias", False),
    "fc1_w": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False),
}


def _layers(sd: Mapping[str, Any], prefix: str, n_layers: int, dtype) -> dict:
    lp = prefix + "encoder.layers.{l}."

    def stack(name, transpose):
        rows = []
        for l in range(n_layers):
            x = to_tensor(sd[lp.format(l=l) + name])
            rows.append((x.t() if transpose else x).to(dtype))
        return torch.stack(rows)

    return {k: stack(name, tr) for k, (name, tr) in _LAYER.items()}


def clip_config_from_hf(hf_config: Any, dtype=torch.float32) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        dtype=dtype,
    )


def convert_clip_vision_state_dict(
    state_dict: Mapping[str, Any],
    cfg: CLIPVisionConfig,
    prefix: str = "vision_model.",
    dtype=None,
) -> dict:
    dtype = dtype or cfg.dtype
    sd = state_dict
    return {
        "class_embedding": cast(sd[prefix + "embeddings.class_embedding"], dtype),
        "patch_embedding": hwio(sd[prefix + "embeddings.patch_embedding.weight"], dtype),
        "position_embedding": cast(sd[prefix + "embeddings.position_embedding.weight"], dtype),
        "pre_ln_w": cast(sd[prefix + "pre_layrnorm.weight"], dtype),
        "pre_ln_b": cast(sd[prefix + "pre_layrnorm.bias"], dtype),
        "post_ln_w": cast(sd[prefix + "post_layernorm.weight"], dtype),
        "post_ln_b": cast(sd[prefix + "post_layernorm.bias"], dtype),
        "layers": _layers(sd, prefix, cfg.num_hidden_layers, dtype),
    }


def clip_text_config_from_hf(hf_config, dtype=torch.float32) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        max_position_embeddings=hf_config.max_position_embeddings,
        layer_norm_eps=hf_config.layer_norm_eps,
        projection_dim=getattr(hf_config, "projection_dim", 512),
        dtype=dtype,
    )


def convert_clip_text_state_dict(
    state_dict: Mapping[str, Any],
    cfg: CLIPTextConfig,
    prefix: str = "text_model.",
    dtype=None,
) -> dict:
    """HF CLIPTextModel state dict -> the ``models/clip_text`` tree (the
    CLIP-select re-ranking protocol with real weights)."""
    dtype = dtype or cfg.dtype
    sd = state_dict
    return {
        "token_embedding": cast(sd[prefix + "embeddings.token_embedding.weight"], dtype),
        "position_embedding": cast(sd[prefix + "embeddings.position_embedding.weight"], dtype),
        "final_ln_w": cast(sd[prefix + "final_layer_norm.weight"], dtype),
        "final_ln_b": cast(sd[prefix + "final_layer_norm.bias"], dtype),
        "layers": _layers(sd, prefix, cfg.num_hidden_layers, dtype),
    }


def convert_clip_model_dir(path: str, dtype=None):
    """Full CLIPModel dir -> ``((vision cfg, vision tree), (text cfg, text
    tree), visual_projection, text_projection, logit_scale)``: everything
    the CLIP-select protocol needs (``eval/text2img.py``'s scorer). The
    trees are the JAX package's layout; the projections ``[in, out]`` and
    ``logit_scale`` (float32) need no change of layout."""
    import json
    import os

    from dreamllm_tpu_torch.convert.cli import _Attr, load_state_dict_dir

    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    sd = load_state_dict_dir(path)
    vcfg = clip_config_from_hf(_Attr(raw["vision_config"]), dtype=dtype or torch.float32)
    tcfg = clip_text_config_from_hf(_Attr(raw["text_config"]), dtype=dtype or torch.float32)
    vision = convert_clip_vision_state_dict(sd, vcfg, prefix="vision_model.", dtype=dtype)
    text = convert_clip_text_state_dict(sd, tcfg, prefix="text_model.", dtype=dtype)
    vproj = transposed(sd["visual_projection.weight"], dtype or torch.float32)
    tproj = transposed(sd["text_projection.weight"], dtype or torch.float32)
    logit_scale = cast(sd["logit_scale"], torch.float32)
    return (vcfg, vision), (tcfg, text), vproj, tproj, logit_scale
