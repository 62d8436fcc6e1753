"""Plain PyTorch attention, norms, RoPE and activations, and the wrappers of
the hand-written CUDA kernels (``csrc/``)."""


def kernel_launches() -> dict:
    """How often each hand-written kernel has been launched in this process
    (each wrapper counts where it launches its kernel): the flash forward
    and backward, the fused 8-bit AdamW and the w4a16 int4 matmul."""
    from dreamllm_tpu_torch.ops.attention import flash_attention, flash_attention_bwd_cuda
    from dreamllm_tpu_torch.ops.quant4 import w4_matmul_cuda
    from dreamllm_tpu_torch.train.optim8bit import adam8bit_update_cuda

    return {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd_cuda.launches,
            "adam8bit": adam8bit_update_cuda.launches, "w4a16": w4_matmul_cuda.launches}
