"""The PyTorch port's decoder against ``transformers.LlamaForCausalLM``, an
oracle independent of both packages. A tiny random HF model is built here
(no download), converted by ``dreamllm_tpu.convert.hf_llama`` into the JAX
layout and brought into the port by ``bridge.from_jax``; there is no RoPE
scaling (the JAX package's dynamic NTK differs from HF's on purpose,
``dreamllm_tpu/models/llama.py``). Float32; logits within 3e-4, the
tolerance of ``tests/test_convert_cli.py``'s HF parity check, for the
cache-free forward and for a prefill followed by cached decode steps; the
greedy continuation equal to HF's ``generate`` after every pick's top-2
margin is asserted to exceed 10x that tolerance.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu_torch.generation.sampler as psamp
import dreamllm_tpu_torch.models.llama as pllama
from dreamllm_tpu.convert.hf_llama import convert_llama_state_dict, llama_config_from_hf
from tests._torch_port_helpers import n, to_port
from tests._torch_serve_helpers import logit_margins

TOL = 3e-4
HF = {
    "gqa": dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64),
    "mha-tied-theta": dict(vocab_size=96, hidden_size=64, intermediate_size=160,
                           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                           max_position_embeddings=64, tie_word_embeddings=True,
                           rope_theta=50000.0, rms_norm_eps=1e-5),
}

_models: dict = {}


def _models_for(name):
    """(HF model, port config, port parameters), built once per case."""
    if name not in _models:
        from transformers import LlamaConfig, LlamaForCausalLM

        torch.manual_seed(0)
        hf = LlamaForCausalLM(LlamaConfig(**HF[name])).eval()
        jcfg = llama_config_from_hf(hf.config, dtype=jnp.float32)
        jparams = convert_llama_state_dict(hf.state_dict(), jcfg)
        fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                  if f.name != "dtype"}
        pcfg = pllama.LlamaConfig(**fields, dtype=torch.float32)
        assert pcfg.rope_scaling_type == "none"
        _models[name] = (hf, pcfg, to_port(jparams, pllama.init_llama_params(pcfg,
                                                                             device="meta")))
    return _models[name]


@pytest.mark.parametrize("name", sorted(HF))
def test_forward_logits_match_hf(name):
    hf, pcfg, pp = _models_for(name)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, pcfg.vocab_size, (2, 11)))
    with torch.no_grad():
        want = hf(ids).logits
        h = pllama.llama_forward(pp, pcfg, input_ids=ids)["last_hidden_state"]
        got = pllama.llama_logits(pp, pcfg, h)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(HF))
def test_cached_decode_matches_hf(name):
    """A 7-token prefill into a float32 cache, then 5 one-token steps; each
    step's logits against HF's full forward over the same prefix."""
    hf, pcfg, pp = _models_for(name)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, pcfg.vocab_size, (1, 12)))
    with torch.no_grad():
        want = hf(ids).logits[0]
        cache = pllama.init_kv_cache(pcfg, 1, 16, dtype=torch.float32, device="cpu")
        h = pllama.llama_forward(pp, pcfg, input_ids=ids[:, :7], kv_cache=cache)
        got = [pllama.llama_logits(pp, pcfg, h["last_hidden_state"])[0, -1]]
        for i in range(7, 12):
            h = pllama.llama_forward(pp, pcfg, input_ids=ids[:, i:i + 1],
                                     positions=torch.tensor([[i]]), kv_cache=cache)
            got.append(pllama.llama_logits(pp, pcfg, h["last_hidden_state"])[0, -1])
    np.testing.assert_allclose(n(torch.stack(got)), n(want[6:]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(HF))
def test_greedy_generation_matches_hf(name, monkeypatch):
    hf, pcfg, pp = _models_for(name)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, pcfg.vocab_size, (1, 9)))
    with torch.no_grad():
        want = hf.generate(ids, attention_mask=torch.ones_like(ids), max_new_tokens=8,
                           do_sample=False, eos_token_id=None, pad_token_id=0)[0, 9:]
    margins = logit_margins(monkeypatch, psamp)
    got = psamp.generate_text(pp, pcfg, ids, torch.tensor([9]),
                              psamp.SamplingConfig(greedy=True, max_new_tokens=8,
                                                   eos_token_id=-1),
                              cache_dtype=torch.float32, device="cpu")
    assert min(margins) > 10 * TOL, margins
    assert got["tokens"][0].tolist() == want.tolist()
