"""Entry points of ``projects/llava`` on the port."""
