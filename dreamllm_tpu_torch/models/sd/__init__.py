"""Diffusion heads: the SD-2.1 and SDXL UNets, VAE, schedulers, the SD and
SDXL heads' losses and pipelines, and ControlNet."""

from dreamllm_tpu_torch.models.sd.controlnet import (
    ControlNetConfig,
    controlnet_forward,
    init_controlnet_params,
)
from dreamllm_tpu_torch.models.sd.head import SDHeadConfig, controlnet_pipeline, sd_head_pipeline
from dreamllm_tpu_torch.models.sd.sdxl import (
    SDXLHeadConfig,
    init_sdxl_head_params,
    make_add_time_ids,
    sdxl_head_pipeline,
)
from dreamllm_tpu_torch.models.sd.unet import UNetConfig, sdxl_unet_config

__all__ = ["ControlNetConfig", "SDHeadConfig", "SDXLHeadConfig", "UNetConfig",
           "controlnet_forward", "controlnet_pipeline", "init_controlnet_params",
           "init_sdxl_head_params", "make_add_time_ids", "sd_head_pipeline",
           "sdxl_head_pipeline", "sdxl_unet_config"]
