"""LoRA and QLoRA in the PyTorch port (``dreamllm_tpu_torch/train/lora.py``,
``ops/quant.py LoRATensor``) against the JAX package on the CPU, float32, on
JAX's weights and factors (``bridge.from_jax``): the merged forward, the
attached forward over a raw, int8 and int4 base (JAX's int4 product through
``w4_matmul`` in interpret mode, the kernel's function), the factor
gradients of ``qlora_loss_fn`` against ``jax.grad``, greedy decoding over
an attached int4 tree, the merge's refusal of a quantized base, the
checkpoint round trip of an attached tree and a JAX-attached tree through
the bridge. Every adapter but the fresh one has ``b`` drawn nonzero, so the
correction is live. Hidden states within 1e-4 (as the decoder's other
parity tests), gradients within 1e-4 of each factor's largest gradient.

One exception: where an int4 projection takes the kernel's function (at
most 8 rows), both packages round its float32 input to bf16 first, and the
two inputs differ by float32 rounding (1e-7), so now and then an element
lands on the neighbouring bf16 value (2^-8 relative) and the difference
travels on. Those forwards are held to a relative RMS of 5e-3 and a
max-abs of 1e-2 (measured over 36 prompts: at most 1.4e-3 and 6.0e-3; most
prompts agree within 1e-6), and the adapter's own effect on the same
forward must be ten times the RMS limit, so the check sees the adapter."""

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
import dreamllm_tpu.train.lora as jlora
import dreamllm_tpu_torch.generation.sampler as psamp
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.ops.quant as pquant
import dreamllm_tpu_torch.ops.quant4 as pq4
import dreamllm_tpu_torch.train.lora as plora
from dreamllm_tpu_torch.bridge import from_jax
from dreamllm_tpu_torch.train.checkpoints import load_params, save_checkpoint
from dreamllm_tpu_torch.train.optim import OptimizerConfig, apply_updates, make_optimizer
from dreamllm_tpu_torch.train.tree import tree_leaves, tree_map
from tests._torch_port_helpers import n, np_tree
from tests._torch_serve_helpers import jax_int4_kernel_function  # noqa: F401  (fixture)
from tests._torch_serve_helpers import logit_margins, serve_cfgs

TOL = 1e-4
BASES = ("plain", "int8", "int4")
LCFG = dict(rank=4, alpha=8.0)  # scale 2


def _transforms(weights):
    """(JAX transform, port transform) of the unfused training layout, as
    QLoRA quantizes it."""
    return {"plain": (lambda p: p, lambda p: p),
            "int8": (jquant.quantize_llama_params, pquant.quantize_llama_params),
            "int4": (jq4.quantize_llama_params_int4, pq4.quantize_llama_params_int4)}[weights]


@functools.lru_cache(maxsize=None)
def bases(weights: str):
    """(JAX cfg, port cfg, JAX base, port base); the JAX base quantized
    under ``jax.jit``, as JAX's serving does. Tests must not modify them."""
    jc, pc = serve_cfgs(512)
    jt, pt = _transforms(weights)
    jp = jax.jit(jt)(jllama.init_llama_params(jax.random.PRNGKey(0), jc))
    like = pt(pllama.init_llama_params(pc, device="meta"))
    return jc, pc, jp, from_jax(np_tree(jp), like, device="cpu")


@functools.lru_cache(maxsize=None)
def factors(weights: str, live: bool = True):
    """(JAX LoRA tree, port LoRA tree) over ``bases(weights)``: JAX's init,
    ``b`` redrawn N(0, 0.05^2) when ``live``."""
    jc, pc, jp, pp = bases(weights)
    lcfg = jlora.LoRAConfig(**LCFG)
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jp, lcfg)
    if live:
        keys = jax.random.split(jax.random.PRNGKey(2), len(lcfg.targets))
        for k, tgt in zip(keys, lcfg.targets):
            f = jl["layers"][tgt]
            f["b"] = jax.random.normal(k, f["b"].shape, f["b"].dtype) * 0.05
    like = plora.init_lora_params(pllama.init_llama_params(pc, device="meta"),
                                  plora.LoRAConfig(**LCFG))
    return jl, from_jax(np_tree(jl), like, device="cpu")


def _ids(b=1, s=6, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.ones((b, 1), np.int32), rng.integers(3, 512, (b, s - 1))], 1)


KERNEL_REL_RMS, KERNEL_MAX_ABS = 5e-3, 1e-2  # int4 forwards through the kernel's function


def _hidden_pair(jtree, ptree, ids):
    jc, pc, _, _ = bases("plain")
    want = jllama.llama_forward(jtree, jc, input_ids=jnp.asarray(ids))["last_hidden_state"]
    got = pllama.llama_forward(ptree, pc, input_ids=torch.from_numpy(ids).long())
    return n(got["last_hidden_state"]), np.asarray(want)


def _rel_rms(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_hidden_close(got, want, weights, bare):
    """``got`` against JAX's ``want`` (module docstring); ``bare``: the
    port's forward without the adapter, for the int4 kernel-path case."""
    if weights != "int4":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        return
    assert _rel_rms(got, want) <= KERNEL_REL_RMS and np.abs(got - want).max() <= KERNEL_MAX_ABS
    assert _rel_rms(bare, want) > 10 * KERNEL_REL_RMS


def test_init_lora_params_layout_and_dtypes():
    """One ``{a [in, r], b [r, out]}`` pair per target and layer; ``b``
    zero; float factors over a float base, float32 over an integer one; ``a``
    drawn N(0, 1/in) from the generator; JAX's stacked tree converts to the
    same layout."""
    for weights in BASES:
        _, pc, _, pp = bases(weights)
        cfg = plora.LoRAConfig(rank=8)
        lora = plora.init_lora_params(pp, cfg, generator=torch.Generator().manual_seed(0))
        assert len(lora["layers"]) == pc.num_hidden_layers
        for layer, base in zip(lora["layers"], pp["layers"]):
            assert set(layer) == set(cfg.targets)
            for tgt, f in layer.items():
                din, dout = base[tgt].shape
                assert tuple(f["a"].shape) == (din, 8) and tuple(f["b"].shape) == (8, dout)
                assert f["a"].dtype == f["b"].dtype == torch.float32
                assert not f["b"].any() and abs(float(f["a"].std()) * din ** 0.5 - 1) < 0.1
    jl, pl = factors("int4", live=False)
    assert all(not f["b"].any() for layer in pl["layers"] for f in layer.values())
    np.testing.assert_array_equal(n(pl["layers"][1]["wk"]["a"]),
                                  np.asarray(jl["layers"]["wk"]["a"][1]))


def test_merged_forward_matches_jax():
    jc, pc, jp, pp = bases("plain")
    jl, pl = factors("plain")
    lcfg = jlora.LoRAConfig(**LCFG)
    merged_j, merged_p = jlora.apply_lora(jp, jl, lcfg), plora.apply_lora(
        pp, pl, plora.LoRAConfig(**LCFG))
    assert merged_p["layers"][0]["wq"].dtype == torch.float32
    assert not torch.equal(merged_p["layers"][0]["wq"], pp["layers"][0]["wq"])
    got, want = _hidden_pair(merged_j, merged_p, _ids(2, 12))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a fresh adapter (b = 0) merges to the base's exact weights
    fresh = plora.apply_lora(pp, factors("plain", live=False)[1], plora.LoRAConfig(**LCFG))
    assert all(torch.equal(fresh["layers"][i][k], pp["layers"][i][k])
               for i in range(2) for k in ("wq", "wk", "wv", "wo"))


@pytest.mark.parametrize("weights", BASES)
def test_attached_forward_matches_jax(weights, jax_int4_kernel_function):  # noqa: F811
    """``x @ base + (x @ a) @ b * scale`` at every target, six tokens (the
    int4 base takes the kernel's function in both packages); on a raw base
    the attached forward equals the merged one."""
    _, _, jp, pp = bases(weights)
    jl, pl = factors(weights)
    jatt = jlora.attach_lora(jp, jl, jlora.LoRAConfig(**LCFG))
    patt = plora.attach_lora(pp, pl, plora.LoRAConfig(**LCFG))
    w = patt["layers"][0]["wq"]
    assert isinstance(w, pquant.LoRATensor) and float(w.scale) == 2.0
    assert w.shape == pp["layers"][0]["wq"].shape and w.numel() == pp["layers"][0]["wq"].numel()
    got, want = _hidden_pair(jatt, patt, _ids())
    assert_hidden_close(got, want, weights, _hidden_pair(jp, pp, _ids())[0])
    if weights == "plain":
        merged, _ = _hidden_pair(jatt, plora.apply_lora(pp, pl, plora.LoRAConfig(**LCFG)),
                                 _ids())
        np.testing.assert_allclose(got, merged, atol=TOL, rtol=0)


def _jax_lm_loss(cfg):
    def loss(p, batch, rng):
        h = jllama.llama_forward(p, cfg, input_ids=batch[:, :-1])["last_hidden_state"]
        logp = jax.nn.log_softmax(jllama.llama_logits(p, cfg, h), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, batch[:, 1:, None], axis=-1))
    return loss


def port_lm_loss(cfg, remat=True):
    """Next-token cross-entropy over the cache-free decoder (full remat, as
    the QLoRA step runs it)."""
    def loss(p, batch, rng):
        h = pllama.llama_forward(p, cfg, input_ids=batch[:, :-1], remat=remat)
        logp = torch.log_softmax(pllama.llama_logits(p, cfg, h["last_hidden_state"]), dim=-1)
        return -logp.gather(-1, batch[:, 1:, None]).mean()
    return loss


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_qlora_factor_grads_match_jax(weights):
    """The factors' gradients of ``qlora_loss_fn`` (24 tokens a row: the
    int4 products take the dequantize path, the backward the dequantized
    weight, in both packages) against ``jax.grad``; the frozen base gets
    none."""
    jc, pc, jp, pp = bases(weights)
    jl, pl = factors(weights)
    ids = _ids(2, 25, seed=5)
    jloss, jgrads = jax.value_and_grad(
        jlora.qlora_loss_fn(jp, jlora.LoRAConfig(**LCFG), _jax_lm_loss(jc)))(
        jl, jnp.asarray(ids), None)
    lora = tree_map(lambda x: x.clone().requires_grad_(True), pl)
    loss = plora.qlora_loss_fn(pp, plora.LoRAConfig(**LCFG), port_lm_loss(pc))(
        lora, torch.from_numpy(ids).long(), None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for i, layer in enumerate(lora["layers"]):
        for tgt, f in layer.items():
            for k in ("a", "b"):
                want = np.asarray(jgrads["layers"][tgt][k][i])
                assert np.abs(want).max() > 0
                np.testing.assert_allclose(n(f[k].grad), want, rtol=0,
                                           atol=TOL * np.abs(want).max())
    assert not any(torch.is_tensor(x) and x.requires_grad for x in tree_leaves(pp))


def test_apply_lora_rejects_quantized_base_and_loss_fn_autoselects():
    _, pc, _, pp = bases("int8")
    _, pl = factors("int8")
    with pytest.raises(TypeError, match="attach_lora"):
        plora.apply_lora(pp, pl, plora.LoRAConfig(**LCFG))
    seen = []

    def loss(p, batch, rng):
        seen.append(type(p["layers"][0]["wq"]))
        return port_lm_loss(pc, remat=False)(p, batch, rng)

    # merge=True (the default) attaches over a quantized base
    out = plora.lora_loss_fn(pp, plora.LoRAConfig(**LCFG), loss)(
        pl, torch.from_numpy(_ids(1, 8)).long(), None)
    assert seen == [pquant.LoRATensor] and bool(torch.isfinite(out))
    _, pl_raw = factors("plain")
    plora.lora_loss_fn(bases("plain")[3], plora.LoRAConfig(**LCFG), loss)(
        pl_raw, torch.from_numpy(_ids(1, 8)).long(), None)
    assert seen[-1] is torch.Tensor


def _same_bits(a, b):
    if isinstance(a, (pquant.LoRATensor, pquant.QTensor, pq4.Q4Tensor)):
        assert type(a) is type(b)
        return all(_same_bits(getattr(a, f), getattr(b, f)) for f in vars(a))
    assert a.dtype == b.dtype and torch.equal(a, b)
    return True


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_attached_checkpoint_round_trip(weights, tmp_path):
    """An attached tree saves as tagged CPU tensors and loads with
    ``weights_only=True``, with and without ``like=``: the same types and
    bits (the scale included) and the same forward."""
    _, pc, _, pp = bases(weights)
    _, pl = factors(weights)
    att = plora.attach_lora(pp, pl, plora.LoRAConfig(**LCFG))
    path = save_checkpoint(str(tmp_path), 3, {"llm": att})
    ids = torch.from_numpy(_ids()).long()
    want = pllama.llama_forward(att, pc, input_ids=ids)["last_hidden_state"]
    for like in (None, {"llm": att}):
        back = load_params(path, like=like)["llm"]
        for layer, ref in zip(back["layers"], att["layers"]):
            for k in ref:
                assert _same_bits(layer[k], ref[k])
        got = pllama.llama_forward(back, pc, input_ids=ids)["last_hidden_state"]
        assert torch.equal(got, want)


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_jax_attached_tree_through_the_bridge(weights, jax_int4_kernel_function):  # noqa: F811
    """JAX's attached tree (``LoRATensor`` nodes with a stacked ``scale
    [L]``) becomes one port ``LoRATensor`` a layer over the same base and
    factors, and computes JAX's forward."""
    _, pc, jp, pp = bases(weights)
    jl, pl = factors(weights)
    jatt = jlora.attach_lora(jp, jl, jlora.LoRAConfig(**LCFG))
    like = plora.attach_lora(pp, pl, plora.LoRAConfig(**LCFG))
    patt = from_jax(np_tree(jatt), like, device="cpu")
    for layer, ref in zip(patt["layers"], like["layers"]):
        for k in ("wq", "wk", "wv", "wo"):
            assert _same_bits(layer[k], ref[k])
    ids = _ids(1, 5, seed=9)
    got, want = _hidden_pair(jatt, patt, ids)
    assert_hidden_close(got, want, weights, _hidden_pair(jp, pp, ids)[0])


def test_attached_int4_generate_text_matches_jax(monkeypatch,
                                                 jax_int4_kernel_function):  # noqa: F811
    """Greedy decoding over an attached int4 tree (every decode step
    through the int4 kernel's function and the rank-4 correction) gives
    JAX's tokens; a fresh adapter (``b = 0``) gives the bare base's tokens
    bit for bit."""
    jc, pc, jp, pp = bases("int4")
    jl, pl = factors("int4")
    ids, lens = _ids(2, 9, seed=11), np.asarray([9, 7], np.int32)
    ids[1, 7:] = 0
    scfg = dict(greedy=True, max_new_tokens=8, eos_token_id=-1)
    jatt = jlora.attach_lora(jp, jl, jlora.LoRAConfig(**LCFG))
    want = jsamp.generate_text(jatt, jc, jnp.asarray(ids), jnp.asarray(lens),
                               jsamp.SamplingConfig(**scfg), jax.random.PRNGKey(0))
    margins = logit_margins(monkeypatch, psamp)

    def run(params):
        return psamp.generate_text(params, pc, torch.from_numpy(ids), torch.from_numpy(lens),
                                   psamp.SamplingConfig(**scfg), device="cpu")["tokens"]

    got = run(plora.attach_lora(pp, pl, plora.LoRAConfig(**LCFG)))
    assert min(margins) > 10 * TOL, margins
    assert got.tolist() == np.asarray(want["tokens"]).tolist()
    fresh = plora.attach_lora(pp, factors("int4", live=False)[1], plora.LoRAConfig(**LCFG))
    assert torch.equal(run(fresh), run(pp))


def test_qlora_training_lowers_the_loss_and_leaves_the_base():
    """Five QLoRA steps over the int4 base with ``make_optimizer``'s 8-bit
    AdamW (the factors of this width keep float32 moments below
    ``min_8bit_size``; a threshold of 256 puts them on the 8-bit path):
    the loss falls, every ``b`` moves off zero and the base keeps its bits."""
    _, pc, _, pp = bases("int4")
    before = [(layer["wq"].packed.clone(), layer["wq"].scale.clone()) for layer in pp["layers"]]
    lora = plora.init_lora_params(pp, plora.LoRAConfig(**LCFG),
                                  generator=torch.Generator().manual_seed(3))
    tx = make_optimizer(OptimizerConfig(learning_rate=1e-2, schedule="constant",
                                        optimizer_8bit=True, min_8bit_size=256))
    state = tx.init(lora)
    fn = plora.qlora_loss_fn(pp, plora.LoRAConfig(**LCFG), port_lm_loss(pc))
    batch = torch.from_numpy(_ids(2, 17, seed=2)).long()
    losses = []
    for _ in range(5):
        lora = tree_map(lambda x: x.detach().requires_grad_(True), lora)
        loss = fn(lora, batch, None)
        loss.backward()
        losses.append(float(loss.detach()))
        updates, state = tx.update(tree_map(lambda x: x.grad, lora), state, lora)
        with torch.no_grad():
            lora = apply_updates(lora, updates)
    assert losses[-1] < losses[0], losses
    assert all(bool(f["b"].any()) for layer in lora["layers"] for f in layer.values())
    for layer, (packed, scale) in zip(pp["layers"], before):
        assert torch.equal(layer["wq"].packed, packed) and torch.equal(layer["wq"].scale, scale)
