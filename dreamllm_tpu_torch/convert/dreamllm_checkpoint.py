"""Converter for trained reference (Omni/DreamLLM) checkpoints (port of
``dreamllm_tpu/convert/dreamllm_checkpoint.py``).

A reference run dir contains (projects/dreamllm/README.md:21, plugin
save_model, modeling_plugins.py:167-169/:293-295/:447-449):

    pytorch_model*.bin / *.safetensors   -- LLM ("model."-prefixed LLaMA keys)
    config.json                          -- DreamLLMConfig (LLaMA hyperparams)
    dream_embedding.bin                  -- {"dream_queries": [1, 64, H]}
    clip_vision_embedding.bin            -- "clip_vision_model.vision_model.*"
                                            + "projector.projector.*"
    stable_diffusion_head.bin            -- "unet.*", "vae.*",
                                            "projector.projector.*"

The ``*_bin`` converters return the JAX package's layout (CPU tensors);
:func:`convert_reference_run_dir` carries everything into the port's
layout and writes the port's checkpoint (``train/checkpoints.py``): the
switching path for users with trained reference models.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from dreamllm_tpu_torch.convert._tensors import cast, to_tensor, transposed
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.convert")


def _subdict(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_reference_projector(sd: Mapping[str, Any], dtype=torch.float32) -> dict:
    """reference BaseProjector state dict -> the projector tree (the same in
    both layouts: dense weights ``[in, out]``).

    Linear: "projector.weight"/"projector.bias"; MLP: Sequential indices
    "projector.0.weight", "projector.2.weight", ... (GELUs at odd slots).
    """
    def bias(name, w):
        return cast(sd[name], dtype) if name in sd else torch.zeros((w.shape[0],), dtype=dtype)

    if "projector.weight" in sd:
        w = to_tensor(sd["projector.weight"])
        return {"layers": [{"w": transposed(w, dtype), "b": bias("projector.bias", w)}]}
    layers = []
    i = 0
    while f"projector.{i}.weight" in sd:
        w = to_tensor(sd[f"projector.{i}.weight"])
        layers.append({"w": transposed(w, dtype), "b": bias(f"projector.{i}.bias", w)})
        i += 2  # skip the GELU slots
    if not layers:
        raise KeyError(f"no projector weights among {sorted(sd)[:8]}")
    return {"layers": layers}


def convert_dream_embedding_bin(sd: Mapping[str, Any], dtype=torch.float32) -> dict:
    q = to_tensor(sd["dream_queries"])  # [1, N, H]
    return {"queries": cast(q[0], dtype)}


def convert_clip_embedding_bin(sd: Mapping[str, Any], clip_cfg, dtype=torch.float32) -> dict:
    from dreamllm_tpu_torch.convert.hf_clip import convert_clip_vision_state_dict

    return {
        "clip": convert_clip_vision_state_dict(
            _subdict(sd, "clip_vision_model."), clip_cfg, prefix="vision_model.", dtype=dtype),
        "projector": convert_reference_projector(_subdict(sd, "projector."), dtype),
    }


def convert_sd_head_bin(sd: Mapping[str, Any], unet_cfg, vae_cfg, dtype=torch.float32) -> dict:
    from dreamllm_tpu_torch.convert.hf_sd import convert_unet_state_dict, convert_vae_state_dict

    return {
        "unet": convert_unet_state_dict(_subdict(sd, "unet."), unet_cfg, dtype),
        "vae": convert_vae_state_dict(_subdict(sd, "vae."), vae_cfg, dtype),
        "projector": convert_reference_projector(_subdict(sd, "projector."), dtype),
    }


def _load_torch_bin(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _projector_like(tree: dict) -> dict:
    """A template of the projector tree's own shapes and dtypes: its layout
    is the port's already, and the reference files name no projector
    config."""
    return {"layers": [{k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                        for k, v in layer.items()} for layer in tree["layers"]]}


def convert_reference_run_dir(
    run_dir: str,
    *,
    clip_cfg=None,
    unet_cfg=None,
    vae_cfg=None,
    out_dir: str | None = None,
    dtype=torch.bfloat16,
) -> dict:
    """Convert a full reference checkpoint directory into the port's
    parameter dict, on the CPU (and write the port's checkpoint when
    ``out_dir`` is given). Configs default to the standard DreamLLM-7B
    recipe (CLIP-L/14, SD-2.1)."""
    from dreamllm_tpu_torch.bridge import from_jax
    from dreamllm_tpu_torch.convert.cli import convert_llama_dir
    from dreamllm_tpu_torch.models.clip import CLIPVisionConfig, init_clip_vision_params
    from dreamllm_tpu_torch.models.llama import init_llama_params
    from dreamllm_tpu_torch.models.sd.unet import UNetConfig, init_unet_params
    from dreamllm_tpu_torch.models.sd.vae import VAEConfig, init_vae_params

    clip_cfg = clip_cfg or CLIPVisionConfig(dtype=dtype)
    unet_cfg = unet_cfg or UNetConfig(dtype=dtype)
    vae_cfg = vae_cfg or VAEConfig(dtype=dtype)

    def port(tree, like):
        return from_jax(tree, like, device="cpu")

    params: dict = {}
    llm_cfg, llm = convert_llama_dir(run_dir, dtype)
    params["llm"] = port(llm, init_llama_params(llm_cfg, device="meta"))
    del llm
    logger.info("converted LLM from %s", run_dir)

    p = os.path.join(run_dir, "clip_vision_embedding.bin")
    if os.path.exists(p):
        tree = convert_clip_embedding_bin(_load_torch_bin(p), clip_cfg, dtype)
        params["clip_vision_embedding"] = {
            "clip": port(tree["clip"], init_clip_vision_params(clip_cfg, device="meta")),
            "projector": port(tree["projector"], _projector_like(tree["projector"])),
        }
        logger.info("converted clip_vision_embedding.bin")
    p = os.path.join(run_dir, "dream_embedding.bin")
    if os.path.exists(p):
        params["dream_embedding"] = convert_dream_embedding_bin(_load_torch_bin(p), dtype)
        logger.info("converted dream_embedding.bin")
    p = os.path.join(run_dir, "stable_diffusion_head.bin")
    if os.path.exists(p):
        tree = convert_sd_head_bin(_load_torch_bin(p), unet_cfg, vae_cfg, dtype)
        params["sd_head"] = {
            "unet": port(tree["unet"], init_unet_params(unet_cfg, device="meta")),
            "vae": port(tree["vae"], init_vae_params(vae_cfg, device="meta")),
            "projector": port(tree["projector"], _projector_like(tree["projector"])),
        }
        logger.info("converted stable_diffusion_head.bin")

    if out_dir:
        from dreamllm_tpu_torch.train.checkpoints import save_checkpoint

        path = save_checkpoint(out_dir, 0, params, extra_meta={"source": run_dir})
        logger.info("wrote %s", path)
    return params
