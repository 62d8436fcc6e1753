"""Plain Stable-Diffusion sampling CLI (port of
``projects/stable_diffusion/sample.py``): sample from a caption embedding
drawn by numpy from the prompt's crc32, the JAX entry's draw bit for bit.

    python -m dreamllm_tpu_torch.projects.stable_diffusion.sample \\
        --config_file projects/stable_diffusion/configs/smoke.py device=cpu \\
        prompt="a photo of a corgi" num_inference_steps=20
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from dreamllm_tpu_torch.config import LazyArgumentParser, default_setup, instantiate
from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig, sd_head_pipeline
from dreamllm_tpu_torch.projects.dreamllm.train import seeded, torch_dtypes
from dreamllm_tpu_torch.projects.stable_diffusion.train import init_sd_params
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params
from dreamllm_tpu_torch.train.tree import tree_map
from dreamllm_tpu_torch.utils.image import save_image
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("projects.stable_diffusion.sample")


def prompt_cond(prompt: str, cond_len: int, cond_dim: int) -> np.ndarray:
    """``[1, cond_len, cond_dim]`` float32: the JAX entry's numpy draw."""
    # crc32, not builtin hash(): stable across interpreter processes
    g = np.random.default_rng(zlib.crc32(prompt.encode()) % 2**31)
    return g.standard_normal((1, cond_len, cond_dim)).astype(np.float32)


@torch.no_grad()
def main(argv=None):
    args, config = LazyArgumentParser().parse(argv)
    dev = resolve_device(args.device)
    run_dir = default_setup(args, config)
    head_cfg = SDHeadConfig(**instantiate(torch_dtypes(config["sd_head"])))
    cond_dim = config.get("cond_dim", head_cfg.llm_hidden_size)
    cond_len = config.get("cond_len", 16)

    params = init_sd_params(head_cfg, seeded(dev, config.get("seed", 0)), dev)
    ck = latest_checkpoint(config.get("checkpoint", config["trainer"]["output_dir"]))
    if ck:
        loaded = tree_map(lambda t: t if t is None else t.to(dev), load_params(ck))
        for key in ("projector", "unet", "vae"):
            if key in loaded:
                params[key] = loaded[key]
        if "sd_head" in loaded:
            params = loaded["sd_head"]
        logger.info("loaded %s", ck)

    # the draw is float32; the UNet runs in its conditioning's dtype, so the
    # condition takes the projector's (bf16 when the recipe asks for it: the
    # flash kernels take bf16 only)
    dtype = head_cfg.projector_cfg().dtype
    cond = torch.from_numpy(prompt_cond(config.get("prompt", "a photo"), cond_len,
                                        cond_dim)).to(dev, dtype)
    uncond = torch.zeros((1, cond_len, cond_dim), dtype=dtype, device=dev)
    imgs = sd_head_pipeline(
        params, head_cfg, cond, uncond, seeded(dev, config.get("sample_seed", 0)),
        num_inference_steps=config.get("num_inference_steps", 20),
        guidance_scale=config.get("guidance_scale", 7.5),
        sampler=config.get("sampler", "dpm"),
        deepcache_interval=config.get("deepcache_interval", 1),
    )
    out = os.path.join(run_dir, "sample.png")
    save_image(imgs[0].float().cpu().numpy(), out)
    logger.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main()
