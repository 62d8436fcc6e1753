"""Entry points of ``projects/dreamllm_sdxl`` on the port."""
