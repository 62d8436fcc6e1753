"""HF/torch LLaMA checkpoint -> the port's decoder parameters (port of
``dreamllm_tpu/convert/hf_llama.py``).

An explicit, testable mapping in place of the reference's
``transformers.from_pretrained`` (modeling_dreamllm.py:1244-1333). The
converter takes a state dict of torch tensors (or numpy arrays) and returns
the JAX package's layout, as CPU tensors of the target dtype:

  * torch ``nn.Linear`` weights are ``[out, in]``; the tree's are ``[in,
    out]`` (``y = x @ W``), transposed here once;
  * per-layer tensors are stacked along a leading ``L`` axis.

``bridge.from_jax(tree, init_llama_params(cfg, device="meta"))`` gives the
port's per-layer tree (the stacked leaves are sliced, not copied, on the
CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, MutableMapping

import numpy as np
import torch

from dreamllm_tpu_torch.convert._tensors import cast, to_tensor
from dreamllm_tpu_torch.models.llama import LlamaConfig


def llama_config_from_hf(hf_config: Any, dtype=torch.float32) -> LlamaConfig:
    """Build a LlamaConfig from a transformers LlamaConfig-like object."""
    rs = getattr(hf_config, "rope_scaling", None) or {}
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        num_key_value_heads=getattr(hf_config, "num_key_value_heads", None),
        max_position_embeddings=hf_config.max_position_embeddings,
        rms_norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling_type=rs.get("type", rs.get("rope_type", "none")) or "none",
        rope_scaling_factor=rs.get("factor", 1.0),
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        dtype=dtype,
    )


def convert_llama_state_dict(
    state_dict: MutableMapping[str, Any],
    cfg: LlamaConfig,
    prefix: str = "model.",
    dtype=None,
    *,
    consume: bool = False,
) -> dict:
    """Map an HF LLaMA state dict to the stacked-layer tree.

    ``consume``: delete each source tensor from ``state_dict`` once its
    leaf is built, so that a whole 7B conversion holds about one copy of
    the weights at a time (the CLI's host-memory peak)."""
    dtype = dtype or cfg.dtype
    L = cfg.num_hidden_layers
    get = state_dict.pop if consume else state_dict.__getitem__

    def layer_stack(fmt: str, transpose: bool) -> torch.Tensor:
        rows = []
        for l in range(L):
            x = to_tensor(get(fmt.format(l=l)))
            rows.append((x.t() if transpose else x).to(dtype))
        return torch.stack(rows)

    layers = {
        "input_norm": layer_stack(prefix + "layers.{l}.input_layernorm.weight", False),
        "post_attn_norm": layer_stack(prefix + "layers.{l}.post_attention_layernorm.weight",
                                      False),
        "wq": layer_stack(prefix + "layers.{l}.self_attn.q_proj.weight", True),
        "wk": layer_stack(prefix + "layers.{l}.self_attn.k_proj.weight", True),
        "wv": layer_stack(prefix + "layers.{l}.self_attn.v_proj.weight", True),
        "wo": layer_stack(prefix + "layers.{l}.self_attn.o_proj.weight", True),
        "w_gate": layer_stack(prefix + "layers.{l}.mlp.gate_proj.weight", True),
        "w_up": layer_stack(prefix + "layers.{l}.mlp.up_proj.weight", True),
        "w_down": layer_stack(prefix + "layers.{l}.mlp.down_proj.weight", True),
    }
    params = {
        "embed_tokens": cast(get(prefix + "embed_tokens.weight"), dtype),
        "layers": layers,
        "final_norm": cast(get(prefix + "norm.weight"), dtype),
    }
    if "lm_head.weight" in state_dict and not cfg.tie_word_embeddings:
        params["lm_head"] = cast(to_tensor(get("lm_head.weight")).t(), dtype)
    return params


def resize_vocab_with_mean_init(
    params: dict,
    cfg: LlamaConfig,
    new_vocab_size: int,
    dtype=None,
) -> tuple[dict, LlamaConfig]:
    """Grow ``embed_tokens``/``lm_head`` to ``new_vocab_size``, initializing
    every NEW token row to the mean of the existing embeddings.

    The canonical cold start: a stock 32,000-vocab Vicuna checkpoint -> the
    32,064-vocab configs (7 multimodal special tokens + pad). Mirrors the
    reference's ``resize_token_embeddings`` (modeling_dreamllm.py:1310-1322)
    followed by ``average_init_token_embeddings`` (tokenizer_utils.py:70-80).

    As in the JAX package, the mean is taken in float32 numpy over the rows
    as the tree holds them, already rounded to its dtype, and rounded to
    ``dtype`` after: the new rows are bit for bit the JAX package's.
    """
    emb_t = params["embed_tokens"]
    emb = emb_t.float().contiguous().numpy()
    old = emb.shape[0]
    if new_vocab_size < old:
        raise ValueError(
            f"cannot shrink vocab {old} -> {new_vocab_size}; the reference "
            "only warns on this, but silently dropping token rows loses "
            "trained embeddings"
        )
    if new_vocab_size == old and cfg.vocab_size == old:
        return params, cfg
    dtype = dtype or emb_t.dtype
    n_new = new_vocab_size - old
    out = dict(params)
    if n_new > 0:
        new_rows = np.tile(emb.mean(axis=0, keepdims=True), (n_new, 1))
        out["embed_tokens"] = cast(np.concatenate([emb, new_rows], axis=0), dtype)
        if "lm_head" in params:  # [H, V] (y = x @ W)
            head = params["lm_head"].float().contiguous().numpy()
            new_cols = np.tile(head.mean(axis=1, keepdims=True), (1, n_new))
            out["lm_head"] = cast(np.concatenate([head, new_cols], axis=1), dtype)
    return out, dataclasses.replace(cfg, vocab_size=new_vocab_size)

