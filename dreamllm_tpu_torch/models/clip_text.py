"""CLIP text encoder and the dual-tower similarity (port of
``dreamllm_tpu/models/clip_text.py``), for CLIP-select evaluation: several
seeds a caption, keep the image with the highest ``logits_per_image``.

HF ``CLIPTextModel``: token and position embeddings, a causal pre-LN
transformer with quick-gelu, a final layer norm; the pooled embedding is the
hidden state at each sequence's EOT position, the highest token id (HF's
convention). ``clip_similarity`` adds the full ``CLIPModel``'s text and
visual projections and ``logit_scale``.

Attention is plain: 77 positions are outside the flash rule. Layers are one
dict each (JAX stacks them on a leading axis; ``bridge.from_jax`` splits
them).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.models.llama import dense_init
from dreamllm_tpu_torch.ops.activations import quick_gelu
from dreamllm_tpu_torch.ops.attention import dot_product_attention
from dreamllm_tpu_torch.ops.norms import layer_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    dtype: torch.dtype = torch.float32


def init_clip_text_params(cfg: CLIPTextConfig, *, generator: torch.Generator | None = None,
                          device="cuda") -> Params:
    """Random init with the JAX package's scales (weights ``N(0,
    1/fan_in)``, embeddings ``N(0, 0.02^2)``); the draws differ from JAX's."""
    dev = resolve_device(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.dtype

    def dense(shape, scale=None):
        return dense_init(shape, d, dev, generator, scale)

    def zeros(n):
        return torch.zeros((n,), dtype=d, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=d, device=dev)

    layers = [
        {
            "ln1_w": ones(h), "ln1_b": zeros(h), "ln2_w": ones(h), "ln2_b": zeros(h),
            "wq": dense((h, h)), "bq": zeros(h),
            "wk": dense((h, h)), "bk": zeros(h),
            "wv": dense((h, h)), "bv": zeros(h),
            "wo": dense((h, h)), "bo": zeros(h),
            "fc1_w": dense((h, i)), "fc1_b": zeros(i),
            "fc2_w": dense((i, h)), "fc2_b": zeros(h),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    return {
        "token_embedding": dense((cfg.vocab_size, h), 0.02),
        "position_embedding": dense((cfg.max_position_embeddings, h), 0.02),
        "final_ln_w": ones(h),
        "final_ln_b": zeros(h),
        "layers": layers,
    }


def clip_text_forward(params: Params, cfg: CLIPTextConfig,
                      input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, S]`` ids → ``(last_hidden [B, S, H], pooled [B, H])``, pooled at
    the EOT position ``argmax(input_ids)`` (the first one, on a tie)."""
    b, s = input_ids.shape
    input_ids = input_ids.to(params["token_embedding"].device).long()
    x = params["token_embedding"][input_ids]
    x = x + params["position_embedding"][None, :s].to(x.dtype)
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    eps = cfg.layer_norm_eps
    for layer in params["layers"]:
        y = layer_norm(x, layer["ln1_w"], layer["ln1_b"], eps)
        q = (y @ layer["wq"] + layer["bq"]).reshape(b, s, nh, hd)
        k = (y @ layer["wk"] + layer["bk"]).reshape(b, s, nh, hd)
        v = (y @ layer["wv"] + layer["bv"]).reshape(b, s, nh, hd)
        a = dot_product_attention(q, k, v, causal=True).reshape(b, s, cfg.hidden_size)
        x = x + (a @ layer["wo"] + layer["bo"])
        y = layer_norm(x, layer["ln2_w"], layer["ln2_b"], eps)
        x = x + (quick_gelu(y @ layer["fc1_w"] + layer["fc1_b"]) @ layer["fc2_w"]
                 + layer["fc2_b"])
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], eps)
    eot = input_ids.argmax(dim=-1)
    return x, x[torch.arange(b, device=x.device), eot]


def clip_similarity(
    image_embeds: torch.Tensor,       # [Ni, H_vision] pooled CLS (clip_pooled_output)
    text_embeds: torch.Tensor,        # [Nt, H_text] pooled EOT
    visual_projection: torch.Tensor,  # [H_vision, proj]
    text_projection: torch.Tensor,    # [H_text, proj]
    logit_scale: torch.Tensor | float = 100.0,
) -> torch.Tensor:
    """``logits_per_image [Ni, Nt]``, HF ``CLIPModel``'s similarity: a
    tensor ``logit_scale`` is the log of the scale (as a checkpoint stores
    it) and is exponentiated, a float is the scale itself."""
    ie = image_embeds @ visual_projection
    te = text_embeds @ text_projection
    ie = ie / torch.linalg.vector_norm(ie, dim=-1, keepdim=True)
    te = te / torch.linalg.vector_norm(te, dim=-1, keepdim=True)
    scale = torch.exp(logit_scale) if torch.is_tensor(logit_scale) else logit_scale
    return scale * ie @ te.T
