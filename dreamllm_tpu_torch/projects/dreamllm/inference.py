"""DreamLLM inference entry point: text-to-image and interleaved generation
(port of ``projects/dreamllm/inference.py``).

    python -m dreamllm_tpu_torch.projects.dreamllm.inference \\
        --config_file projects/dreamllm/configs/smoke.py device=cpu \\
        prompt="a photo of a corgi" +mode=t2i

``mode=t2i`` writes ``samples/t2i_000.png`` (positive suffix and negative
prompt as the JAX entry engineers them); ``mode=interleaved`` writes
``samples/document.md`` and one PNG for each generated image. The head is
initialised by ``head_type`` (``init_sdxl_head_params`` for an SDXL recipe)
before the checkpoint overlay, as the train entry does. The JAX entry
initialises the SD-2.1 head whatever the recipe says, so an SDXL recipe
without a checkpoint raises ``KeyError: 'global_projector'`` there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig, generate_interleaved
from dreamllm_tpu_torch.generation.sampler import SamplingConfig
from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds
from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline
from dreamllm_tpu_torch.models.sd.sdxl import sdxl_head_pipeline
from dreamllm_tpu_torch.projects.dreamllm.train import (
    build_model_cfg,
    init_params,
    make_tokenizer,
    seeded,
)
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("projects.dreamllm.inference")

POSITIVE_SUFFIX = ", best quality, extremely detailed"
NEGATIVE_PROMPT = (
    "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
    "fewer digits, cropped, worst quality, low quality"
)


def _png(img: torch.Tensor, path: str) -> None:
    from PIL import Image

    arr = img.float().cpu().numpy()
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)
    logger.info("wrote %s", path)


@torch.no_grad()
def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    run_dir = default_setup(args, config)
    cfg, head_cfg = build_model_cfg(config)
    tokenizer = make_tokenizer(config, cfg)

    params = init_params(config, cfg, head_cfg, dev)
    ck = latest_checkpoint(config.get("checkpoint", config["trainer"]["output_dir"]))
    if ck:
        params = load_params(ck, like=params)
        logger.info("loaded %s", ck)

    mode = config.get("mode", "t2i")
    prompt = config.get("prompt", "a photo of a dog")
    steps = config.get("num_inference_steps", 50)
    guidance = config.get("guidance_scale", 3.5)
    gen = seeded(dev, config.get("sample_seed", 0))

    out_dir = os.path.join(run_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    pipeline_fn = (sdxl_head_pipeline if config.get("head_type", "sd") == "sdxl"
                   else sd_head_pipeline)

    if mode == "t2i":
        cond = encode_prompt_embeds(params, cfg, tokenizer, prompt + POSITIVE_SUFFIX)
        neg = encode_prompt_embeds(params, cfg, tokenizer, NEGATIVE_PROMPT)
        imgs = pipeline_fn(params["sd_head"], head_cfg, cond, neg, gen,
                           num_inference_steps=steps, guidance_scale=guidance)
        for i, img in enumerate(imgs):
            _png(img, os.path.join(out_dir, f"t2i_{i:03d}.png"))
    elif mode == "interleaved":
        st = cfg.special_tokens
        ids = torch.tensor([[st.bos] + tokenizer.encode(prompt)], dtype=torch.int32, device=dev)
        out = generate_interleaved(
            params, cfg, params["sd_head"], head_cfg, ids,
            InterleavedConfig(
                max_new_tokens=config.get("max_new_tokens", 256),
                max_images=config.get("max_images", 2),
                num_inference_steps=steps,
                guidance_scale=guidance,
                sampling=SamplingConfig(temperature=0.7, top_p=0.9),
            ),
            gen,
            device=dev,
        )
        doc_parts = []
        for i, (kind, payload) in enumerate(out["segments"]):
            if kind == "text":
                doc_parts.append(tokenizer.decode(payload.cpu().tolist()))
            else:
                path = os.path.join(out_dir, f"interleaved_{i:03d}.png")
                _png(payload, path)
                doc_parts.append(f"![image]({path})")
        with open(os.path.join(out_dir, "document.md"), "w") as f:
            f.write("\n\n".join(doc_parts))
        logger.info("wrote interleaved document with %d images", len(out["images"]))
    else:
        raise ValueError(mode)
    return out_dir


if __name__ == "__main__":
    main()
