"""Model recipes.

``dreamllm_7b`` is the DreamLLM-7B recipe of the JAX project
(``projects/dreamllm/configs/common.py``, ``model`` and ``sd_head``):
a Vicuna-7B decoder (vocab 32064 = 32000 + the special tokens, padded;
hidden 4096, MLP 11008, 32 layers, 32 heads, 2048 positions), the CLIP
ViT-L/14 tower at 224 px, linear projectors 1024→4096 and 4096→1024, 64
dream queries, 256 image tokens, and the SD-2.1 base UNet and VAE at
512 px. Every part is bf16, as the JAX interleaved benchmark runs it
(``scripts/bench/interleaved.py``), without its int8 weights and fused
projections, which belong to the quantized slice.

``dreamllm_sdxl_7b`` is DreamLLM-SDXL-7B (``projects/dreamllm_sdxl/configs/
common.py``): the same decoder at 4096 positions, CLIP ViT-L/14 at 224 px
through a 2-layer MLP projector, 196 dream queries, and the SDXL-base head
(1024 px; a linear 4096→2048 projector and the 4096→1280 global projector;
the VAE in float32 by the head's policy). ``llava_7b`` is LLaVA-1.5-7B as
``projects/llava/configs/pretrain.py`` trains it (stage 1: the projector
only). ``controlnet_7b`` is a ControlNet over DreamLLM-7B's SD-2.1 UNet.
"""

from __future__ import annotations

import torch

import dataclasses

from dreamllm_tpu_torch.models.clip import CLIPVisionConfig
from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig
from dreamllm_tpu_torch.models.llama import LlamaConfig
from dreamllm_tpu_torch.models.llava import llava_pretrain_config
from dreamllm_tpu_torch.models.projector import ProjectorConfig
from dreamllm_tpu_torch.models.sd.controlnet import ControlNetConfig
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig
from dreamllm_tpu_torch.models.sd.sdxl import SDXLHeadConfig
from dreamllm_tpu_torch.models.sd.unet import UNetConfig, sdxl_unet_config
from dreamllm_tpu_torch.models.sd.vae import VAEConfig


def _vicuna_7b(dtype: torch.dtype, max_positions: int) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32064,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        max_position_embeddings=max_positions,
        dtype=dtype,
    )


def _clip_l14(dtype: torch.dtype, image_size: int) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_hidden_layers=24,
        num_attention_heads=16,
        image_size=image_size,
        patch_size=14,
        dtype=dtype,
    )


def dreamllm_7b(dtype: torch.dtype = torch.bfloat16) -> tuple[DreamLLMConfig, SDHeadConfig]:
    """``(model config, SD head config)`` of DreamLLM-7B."""
    llm = _vicuna_7b(dtype, 2048)
    vision = _clip_l14(dtype, 224)
    model = DreamLLMConfig(
        llm=llm,
        vision=vision,
        vision_projector=ProjectorConfig(projector_type="linear", in_dim=1024, out_dim=4096,
                                         dtype=dtype),
        n_dream_queries=64,
        image_embed_len=256,
    )
    head = SDHeadConfig(
        unet=UNetConfig(dtype=dtype),  # SD 2.1 base: 64x64 latents, 512 px
        vae=VAEConfig(dtype=dtype),
        llm_hidden_size=4096,
        projector=ProjectorConfig(projector_type="linear", in_dim=4096, out_dim=1024,
                                  dtype=dtype),
        dtype=dtype,
    )
    return model, head


def controlnet_7b(dtype: torch.dtype = torch.bfloat16) -> ControlNetConfig:
    """A ControlNet over DreamLLM-7B's SD-2.1 UNet (diffusers' default
    conditioning embedder: 3 channels, 16/32/96/256)."""
    return ControlNetConfig(unet=dreamllm_7b(dtype)[1].unet)


def dreamllm_sdxl_7b(dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[DreamLLMConfig, SDXLHeadConfig]:
    """``(model config, SDXL head config)`` of DreamLLM-SDXL-7B."""
    model = DreamLLMConfig(
        llm=_vicuna_7b(dtype, 4096),  # vicuna-7b-v1.5
        vision=_clip_l14(dtype, 224),
        vision_projector=ProjectorConfig(projector_type="mlp", depth=2, in_dim=1024,
                                         out_dim=4096, dtype=dtype),
        n_dream_queries=196,
        image_embed_len=256,
    )
    head = SDXLHeadConfig(
        unet=sdxl_unet_config(dtype=dtype),  # SDXL base: 128x128 latents, 1024 px
        vae=VAEConfig(scaling_factor=0.13025),
        llm_hidden_size=4096,
        projector=ProjectorConfig(projector_type="linear", in_dim=4096, out_dim=2048,
                                  dtype=dtype),
        pooled_dim=1280,
        uncond_prob=0.1,
        dtype=dtype,
    )
    return model, head


def llava_7b(dtype: torch.dtype = torch.bfloat16) -> DreamLLMConfig:
    """LLaVA-1.5-7B, stage 1 (projector only): Vicuna-7B-v1.5 at 4096
    positions, CLIP ViT-L/14 at 336 px (576 image tokens), a 2-layer MLP
    projector; every part in ``dtype``."""
    cfg = llava_pretrain_config(llm=_vicuna_7b(dtype, 4096), vision=_clip_l14(dtype, 336))
    return dataclasses.replace(
        cfg, vision_projector=dataclasses.replace(cfg.vision_projector, dtype=dtype))
