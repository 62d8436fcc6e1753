"""LLaMA decoder, CLIP vision and text towers, projectors, the DreamLLM
assembly and its LLaVA variant."""
