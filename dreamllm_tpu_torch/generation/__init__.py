"""Decode-time drivers: token sampling, beam search, speculative decoding
and interleaved text+image generation."""

from dreamllm_tpu_torch.generation.sampler import (
    SamplingConfig,
    beam_search,
    generate_text,
    generate_text_speculative,
    sample_token,
    sample_token_per_row,
)

__all__ = ["SamplingConfig", "beam_search", "generate_text", "generate_text_speculative",
           "sample_token", "sample_token_per_row"]
