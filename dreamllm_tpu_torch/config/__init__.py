"""Lazy configs and the CLI plumbing (port of ``dreamllm_tpu/config``)."""

from dreamllm_tpu_torch.config.arg_parser import LazyArgumentParser, LazyArguments, default_setup
from dreamllm_tpu_torch.config.lazy import (
    LazyCall,
    LazyConfig,
    deep_instantiate,
    instantiate,
    locate,
)

__all__ = ["LazyArgumentParser", "LazyArguments", "LazyCall", "LazyConfig", "deep_instantiate",
           "default_setup", "instantiate", "locate"]
