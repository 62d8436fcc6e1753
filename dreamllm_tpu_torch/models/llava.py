"""LLaVA (port of ``dreamllm_tpu/models/llava.py``): the DreamLLM decoder
with its CLIP image plugin and no creation path. A variant is a
configuration here: a :class:`DreamLLMConfig` with no dream queries,
``loss_weight_vm`` 0 and a freeze preset, and a parameter tree without
``dream_embedding``. ``multimodal_embed``, ``dreamllm_forward`` and
``param_freeze_mask`` take such a tree: they read the dream queries only
for a batch that has dream spans.
"""

from __future__ import annotations

import dataclasses

import torch

from dreamllm_tpu_torch.models.clip import CLIPVisionConfig
from dreamllm_tpu_torch.models.dreamllm import (
    DreamLLMConfig,
    SpecialTokens,
    dreamllm_forward,
    init_dreamllm_params,
)
from dreamllm_tpu_torch.models.llama import LlamaConfig
from dreamllm_tpu_torch.models.projector import ProjectorConfig


def llava_config(
    llm: LlamaConfig | None = None,
    vision: CLIPVisionConfig | None = None,
    projector_type: str = "mlp",
    projector_depth: int = 2,
    frozen: tuple[str, ...] = ("clip_vision_embedding/clip",),
    special_tokens: SpecialTokens | None = None,
) -> DreamLLMConfig:
    """LLaVA-1.5: CLIP ViT-L/14 at 336 px → a 2-layer MLP projector → the
    Vicuna decoder (576 image tokens); no dream queries, no diffusion
    loss. The projector's parameters are float32, as in JAX
    (``configs.llava_7b`` sets its dtype)."""
    llm = llm or LlamaConfig()
    vision = vision or CLIPVisionConfig(image_size=336, patch_size=14)
    return DreamLLMConfig(
        llm=llm,
        vision=vision,
        vision_projector=ProjectorConfig(
            projector_type=projector_type,
            in_dim=vision.hidden_size,
            out_dim=llm.hidden_size,
            depth=projector_depth,
        ),
        special_tokens=special_tokens or SpecialTokens(),
        n_dream_queries=0,
        image_embed_len=(vision.image_size // vision.patch_size) ** 2,
        loss_weight_vm=0.0,
        frozen=frozen,
    )


def init_llava_params(cfg: DreamLLMConfig, *, generator: torch.Generator | None = None,
                      device="cuda") -> dict:
    """The parameter tree without the dream queries."""
    params = init_dreamllm_params(cfg, generator=generator, device=device)
    params.pop("dream_embedding", None)
    return params


def llava_forward(params, cfg: DreamLLMConfig, batch: dict, **kw):
    """The LM-only joint forward (``dreamllm_forward`` with no head loss)."""
    return dreamllm_forward(params, cfg, batch, head_loss_fn=None, **kw)


# training-stage freeze presets (projects/llava/configs): stage 1 trains the
# projector only; stage 2 (SFT) unfreezes the decoder too
LLAVA_PRETRAIN_FROZEN = ("clip_vision_embedding/clip", "llm")


def llava_pretrain_config(**kw) -> DreamLLMConfig:
    return dataclasses.replace(llava_config(**kw), frozen=LLAVA_PRETRAIN_FROZEN)
