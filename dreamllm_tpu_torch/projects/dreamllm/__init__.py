"""Entry points of ``projects/dreamllm`` on the port."""
