"""Training: optimizer, train step, checkpoints and the trainer loop (port
of ``dreamllm_tpu/train``)."""
