"""The port's ``generate_text`` against the JAX package's, on the CPU, with a
tiny float32 decoder (hidden 256) in each serving layout: plain weights,
int8 (fused, as ``projects/dreamllm/serve.py`` builds it), int4 (the
training layout, as serve.py builds it) and int4 fused (as ``bench.py``
decodes), over the bf16 and the int8 KV cache, with a vocab that is (512)
and one that is not (500) a multiple of 128 (the int4 head takes the
kernel's function in the first, the float32 dequantize product in the
second). JAX's ``w4_matmul`` runs in interpret mode, so both packages
compute the kernel's function where a TPU would.

Greedy tokens, ``lengths`` and ``steps`` must be identical. A near-tie
within the logits' tolerance would make such a test flaky rather than the
port wrong, so every greedy pick's top-2 margin is asserted first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu_torch.generation.sampler as psamp
from tests._torch_serve_helpers import (
    LOGIT_TOL,
    jax_generate,
    logit_margins,
    prompts,
    serve_params,
    to_torch,
)
from tests._torch_serve_helpers import jax_int4_kernel_function  # noqa: F401  (fixture)

CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


def _port_generate(pc, pp, ids, lens, cache="bf16", **scfg):
    return psamp.generate_text(pp, pc, to_torch(ids), to_torch(lens),
                               psamp.SamplingConfig(**{"greedy": True, **scfg}),
                               cache_dtype=CACHES[cache][1], device="cpu")


@pytest.mark.parametrize("weights,cache,vocab", [
    ("plain", "bf16", 512),
    ("plain", "int8", 500),
    ("int8", "bf16", 500),
    ("int8", "int8", 512),
    ("int4", "bf16", 512),
    ("int4", "int8", 500),
    ("int4-fused", "bf16", 500),
    ("int4-fused", "int8", 512),
])
def test_greedy_matches_jax(weights, cache, vocab, jax_int4_kernel_function,  # noqa: F811
                            monkeypatch):
    jc, pc, jp, pp = serve_params(vocab, weights)
    ids, lens = prompts(3, seed=5)  # top-2 margins >= 3.4e-3 in every case
    want = jax_generate(jc, jp, ids, lens, cache_dtype=CACHES[cache][0], max_new_tokens=10,
                        eos_token_id=-1)
    margins = logit_margins(monkeypatch, psamp)
    got = _port_generate(pc, pp, ids, lens, cache, max_new_tokens=10, eos_token_id=-1)
    assert min(margins) > 10 * LOGIT_TOL, min(margins)
    assert got["tokens"].dtype == torch.int32 and tuple(got["tokens"].shape) == (3, 10)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    assert got["steps"] == want["steps"] == 10
    if cache == "int8":
        assert got["kv_cache"]["k"].dtype == torch.int8 and "k_scale" in got["kv_cache"]


@pytest.mark.parametrize("weights", ["plain", "int4-fused"])
def test_greedy_matches_jax_with_bf16_weights(weights, jax_int4_kernel_function,  # noqa: F811
                                              monkeypatch):
    """bf16 parameters and activations, as the 7B model serves. The two
    frameworks round bf16 activations at other places, so a logit may move
    by a few 1e-3: every pick's top-2 margin must exceed 1e-2."""
    jc, pc, jp, pp = serve_params(512, weights, dtype="bfloat16")
    ids, lens = prompts(3, seed=3)  # margins >= 2.1e-2 for both weight sets
    want = jax_generate(jc, jp, ids, lens, max_new_tokens=10, eos_token_id=-1)
    margins = logit_margins(monkeypatch, psamp)
    got = _port_generate(pc, pp, ids, lens, max_new_tokens=10, eos_token_id=-1)
    assert min(margins) > 1e-2, min(margins)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])


def _stream(pc, pp, ids, lens):
    """The greedy tokens each row would emit with no stop rule."""
    return _port_generate(pc, pp, ids, lens, max_new_tokens=10, eos_token_id=-1)["tokens"]


@pytest.mark.parametrize("rule", ["eos", "halt", "stop", "all"])
def test_stop_semantics_match_jax(rule):
    """EOS and halt tokens end a row unstored; a stop token is stored, then
    ends it; finished rows pad; ``lengths`` counts emitted tokens and
    ``steps`` the decode steps until every row is done. The rule tokens are
    taken from the rows' own greedy streams so that each one fires."""
    jc, pc, jp, pp = serve_params(512, "plain")
    ids, lens = prompts(3)
    free = _stream(pc, pp, ids, lens).numpy()
    kw = {"eos_token_id": -1}
    if rule in ("eos", "all"):
        kw["eos_token_id"] = int(free[0, 3])
    if rule in ("halt", "all"):
        kw["halt_tokens"] = (int(free[1, 5]),)
    if rule in ("stop", "all"):
        kw["stop_tokens"] = (int(free[2, 2]),)
    want = jax_generate(jc, jp, ids, lens, max_new_tokens=10, pad_token_id=0, **kw)
    got = _port_generate(pc, pp, ids, lens, max_new_tokens=10, pad_token_id=0, **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    assert got["steps"] == want["steps"]
    assert (got["lengths"].numpy() < 10).any()


def test_inputs_embeds_prefill_matches_jax():
    jc, pc, jp, pp = serve_params(512, "plain")
    ids, lens = prompts(2, seed=3)
    emb = np.asarray(jp["embed_tokens"])[ids]
    want = jsamp.generate_text(jp, jc, jnp.asarray(ids), jnp.asarray(lens),
                               jsamp.SamplingConfig(greedy=True, max_new_tokens=6, eos_token_id=-1),
                               jax.random.PRNGKey(0), inputs_embeds=jnp.asarray(emb))
    got = psamp.generate_text(pp, pc, to_torch(ids), to_torch(lens),
                              psamp.SamplingConfig(greedy=True, max_new_tokens=6, eos_token_id=-1),
                              inputs_embeds=to_torch(emb), device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_sample_token_per_row_semantics():
    """A greedy row returns its argmax; top-k 1 and a tiny top-p reduce a
    sampled row to its argmax; top-k 3 stays within the top 3; per-row
    generators make a row's draw independent of the other rows; a greedy
    row draws nothing, and a sampled row without a generator raises."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32) * 3)
    top1 = logits.argmax(-1)
    greedy = torch.tensor([True, False, False, False])
    temp = torch.ones(4)
    top_k = torch.tensor([0, 1, 0, 3], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1e-6, 1.0])
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    out = psamp.sample_token_per_row(logits, greedy, temp, top_k, top_p, gens)
    assert out.dtype == torch.int32 and out[:3].tolist() == top1[:3].tolist()
    assert int(out[3]) in set(logits[3].topk(3).indices.tolist())
    # row 3's draw depends on its own generator only
    gens2 = [torch.Generator().manual_seed(i + 10) for i in range(3)]
    gens2.append(torch.Generator().manual_seed(3))
    again = psamp.sample_token_per_row(logits, greedy, temp, top_k, top_p, gens2)
    assert int(again[3]) == int(out[3])
    # the greedy row's generator was not drawn from; the process RNG neither
    state = torch.get_rng_state()
    g0 = torch.Generator().manual_seed(0)
    psamp.sample_token_per_row(logits, greedy, temp, top_k, top_p, [g0] + gens2[1:])
    assert torch.equal(g0.get_state(), torch.Generator().manual_seed(0).get_state())
    assert torch.equal(torch.get_rng_state(), state)
    with pytest.raises(ValueError, match="need a generator"):
        psamp.sample_token_per_row(logits, greedy, temp, top_k, top_p, gens[:3] + [None])
    # all greedy: argmax without a draw
    allg = psamp.sample_token_per_row(logits, torch.ones(4, dtype=torch.bool), temp,
                                      top_k, top_p)
    assert allg.tolist() == top1.tolist()


def test_validate_sampling_rejects_poisoned_values():
    from dreamllm_tpu_torch.utils.errors import ClientError

    psamp.validate_sampling(0.7, 5, 0.9)
    for bad in ((float("nan"), 0, 1.0), (-1.0, 0, 1.0), (1.0, -1, 1.0), (1.0, 0, 0.0),
                (1.0, 0, float("nan"))):
        with pytest.raises(ClientError):
            psamp.validate_sampling(*bad)
    assert issubclass(ClientError, ValueError)


def test_generate_text_refuses_the_wrong_device():
    _, pc, _, pp = serve_params(512, "plain")
    ids, lens = prompts(1)
    cfg = psamp.SamplingConfig(greedy=True, max_new_tokens=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            psamp.generate_text(pp, pc, to_torch(ids), to_torch(lens), cfg)
