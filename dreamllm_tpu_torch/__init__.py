"""PyTorch/CUDA port of ``dreamllm_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
(``ops/attention.py`` here is the counterpart of ``dreamllm_tpu/ops/
attention.py`` there) and keeps its public layouts: BSHD attention, NHWC
images and latents, ``[in, out]`` matmul weights. Parameters are nested
dicts of tensors; weights reach the port from a JAX tree through
:func:`bridge.from_jax`.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``. On a CPU tensor a
kernel wrapper runs its plain PyTorch version; on a CUDA tensor it launches
its kernel or raises.

Importing the package imports torch only: no JAX, nothing of
``dreamllm_tpu``, and no kernel is built until its first CUDA launch.
"""

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.sampler import (
    SamplingConfig,
    beam_search,
    generate_text,
    generate_text_speculative,
)
from dreamllm_tpu_torch.models.clip_text import clip_similarity, clip_text_forward
from dreamllm_tpu_torch.models.llava import llava_forward
from dreamllm_tpu_torch.models.sd import controlnet_pipeline, sdxl_head_pipeline

__all__ = ["SamplingConfig", "beam_search", "clip_similarity", "clip_text_forward",
           "controlnet_pipeline", "generate_text", "generate_text_speculative", "llava_forward",
           "resolve_device", "sdxl_head_pipeline"]
