"""Entry points of ``projects/stable_diffusion`` on the port."""
