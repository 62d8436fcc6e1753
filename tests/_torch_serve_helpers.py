"""Shared pieces of the quantized-serving parity tests
(``test_torch_quant*.py``, ``test_torch_generate_text.py``,
``test_torch_engine.py``).

A tiny decoder (hidden 256, so every projection has ``K % 256 == 0`` as int4
needs) is initialised by the JAX package in float32, transformed there
(fused and/or quantized, as ``projects/dreamllm/serve.py`` does) and brought
into the port through ``bridge.from_jax``, whose ``like`` tree is the port's
own transform of a meta-device init: the quantized leaves cross as they are.

On the CPU JAX's ``w4_matmul`` takes its dequantize path unless asked for
interpret mode; :func:`jax_int4_kernel_function` patches it to
``interpret=True``, so that JAX computes the kernel's function exactly where
a TPU would, which is what the port's gate does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu.models.llama as jllama
import dreamllm_tpu.ops.quant as jquant
import dreamllm_tpu.ops.quant4 as jq4
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.ops.quant as pquant
import dreamllm_tpu_torch.ops.quant4 as pq4
from tests._torch_port_helpers import np_tree
from dreamllm_tpu_torch.bridge import from_jax

SERVE_LLAMA = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
WEIGHTS = ("plain", "int8", "int4", "int4-fused")
LOGIT_TOL = 1e-4  # float32 logits of the two packages (test_torch_generation.py)


def serve_cfgs(vocab: int, dtype: str = "float32"):
    args = {**SERVE_LLAMA, "vocab_size": vocab}
    return (jllama.LlamaConfig(**args, dtype=getattr(jnp, dtype)),
            pllama.LlamaConfig(**args, dtype=getattr(torch, dtype)))


def _jax_transform(params, weights: str):
    if weights == "int8":  # serve.py: fuse, then quantize
        return jquant.quantize_llama_params(jllama.fuse_llama_params(params))
    if weights == "int4":  # serve.py: quantize the training layout
        return jq4.quantize_llama_params_int4(params)
    if weights == "int4-fused":  # bench.py's decode: fuse, then quantize
        return jq4.quantize_llama_params_int4(jllama.fuse_llama_params(params))
    return params


def port_transform(params, weights: str):
    if weights == "int8":
        return pquant.quantize_llama_params(pllama.fuse_llama_params(params))
    if weights == "int4":
        return pq4.quantize_llama_params_int4(params)
    if weights == "int4-fused":
        return pq4.quantize_llama_params_int4(pllama.fuse_llama_params(params))
    return params


@functools.lru_cache(maxsize=None)
def serve_params(vocab: int = 512, weights: str = "plain", seed: int = 0,
                 dtype: str = "float32"):
    """(JAX cfg, port cfg, JAX params, port params) in ``dtype``, ``weights``
    one of :data:`WEIGHTS`. Tests must not modify what this returns."""
    jc, pc = serve_cfgs(vocab, dtype)
    # compiled, as projects/dreamllm/serve.py quantizes
    jp = jax.jit(functools.partial(_jax_transform, weights=weights))(
        jllama.init_llama_params(jax.random.PRNGKey(seed), jc))
    like = port_transform(pllama.init_llama_params(pc, device="meta"), weights)
    return jc, pc, jp, from_jax(np_tree(jp), like, device="cpu")


@pytest.fixture
def jax_int4_kernel_function(monkeypatch):
    """Make JAX's ``w4_matmul`` run its Pallas kernel in interpret mode on
    the CPU (its own tests call it so), for the length of one test."""
    monkeypatch.setattr(jq4, "w4_matmul", functools.partial(jq4.w4_matmul, interpret=True))


def jax_generate(jc, jp, ids: np.ndarray, lens: np.ndarray, *, cache_dtype=jnp.bfloat16,
                 **scfg) -> dict:
    """JAX's ``generate_text`` (greedy unless ``scfg`` says otherwise) as
    numpy: tokens, lengths, steps."""
    out = jsamp.generate_text(jp, jc, jnp.asarray(ids), jnp.asarray(lens),
                              jsamp.SamplingConfig(**{"greedy": True, **scfg}),
                              jax.random.PRNGKey(0), cache_dtype=cache_dtype)
    return {"tokens": np.asarray(out["tokens"]), "lengths": np.asarray(out["lengths"]),
            "steps": int(out["steps"])}


def logit_margins(monkeypatch, module) -> list[float]:
    """Record, for every ``llama_logits`` call that ``module`` makes, the
    smallest top-1 minus top-2 gap over its rows."""
    margins: list[float] = []
    real = module.llama_logits

    def spy(*a):
        out = real(*a)
        top2 = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return out

    monkeypatch.setattr(module, "llama_logits", spy)
    return margins


def prompts(batch: int, seed: int = 0, lengths=(12, 9, 14, 10)) -> tuple[np.ndarray, np.ndarray]:
    """``batch`` right-padded prompts (BOS first) with their lengths."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([lengths[i % len(lengths)] for i in range(batch)], np.int32)
    ids = np.zeros((batch, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = np.concatenate([[1], rng.integers(3, 500, n - 1)])
    return ids, lens


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))
