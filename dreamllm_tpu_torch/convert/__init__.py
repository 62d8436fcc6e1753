"""Checkpoint converters: HF LLaMA, CLIP and diffusers SD directories,
pytorch-fid's InceptionV3 and trained reference runs into the port's trees
(port of ``dreamllm_tpu/convert``); ``python -m
dreamllm_tpu_torch.convert.cli`` writes the port's checkpoint."""

from dreamllm_tpu_torch.convert.hf_llama import (
    convert_llama_state_dict,
    llama_config_from_hf,
    resize_vocab_with_mean_init,
)
