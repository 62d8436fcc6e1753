"""The port's int8 weights and projection dispatch
(``dreamllm_tpu_torch/ops/quant.py``) against the JAX package's, on the CPU:
the quantization bit for bit against JAX's compiled quantization, the int8
product's rounding (product in x's dtype, then the scale cast to x's dtype),
the dispatch over plain, int8 and int4 weights, and the serving layouts of
``quantize_llama_params``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.ops.quant as jquant
import dreamllm_tpu.ops.quant4 as jq4
import dreamllm_tpu_torch.ops.quant as pquant
import dreamllm_tpu_torch.ops.quant4 as pq4
from tests._torch_port_helpers import n, t
from tests._torch_serve_helpers import jax_int4_kernel_function  # noqa: F401  (fixture)
from tests._torch_serve_helpers import port_transform, serve_params


@pytest.mark.parametrize("shape", [(64, 96), (3, 128, 40)])
def test_quantize_int8_is_bit_exact(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jax.jit(jquant.quantize_int8)(jnp.asarray(w))
    got = pquant.quantize_int8(t(w))
    assert got.q.dtype == torch.int8 and got.scale.shape == tuple(want.scale.shape)
    np.testing.assert_array_equal(n(got.q), np.asarray(want.q))
    np.testing.assert_array_equal(n(got.scale), np.asarray(want.scale))
    np.testing.assert_array_equal(n(pquant.dequantize(got, torch.float32)),
                                  np.asarray(jquant.dequantize(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_product_rounds_as_jax(lead, dtype):
    """``(x @ q.to(x.dtype)) * scale.to(x.dtype)``: in bf16 the product and
    the scale multiply each round to bf16, as in JAX. Float32 sums in other
    orders: within 1e-5; bf16: within one bf16 ulp of the largest value."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal((*lead, 64)).astype(np.float32)
    qt = jax.jit(jquant.quantize_int8)(jnp.asarray(w))
    want = np.asarray(jquant.matmul(jnp.asarray(x).astype(dtype), qt)).astype(np.float32)
    got = pquant.matmul(t(x).to(getattr(torch, dtype)), pquant.quantize_int8(t(w)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(n(got.float()) - want).max() <= ulp


def test_dispatch_over_plain_and_int4(jax_int4_kernel_function):  # noqa: F811
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    np.testing.assert_allclose(n(pquant.matmul(t(x), t(w))),
                               np.asarray(jquant.matmul(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    want = jquant.matmul(jnp.asarray(x), jq4.quantize_int4(jnp.asarray(w)))
    got = pquant.matmul(t(x), pq4.quantize_int4(t(w)))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_dispatch_refuses_lora_weights():
    """The dispatch takes an attached adapter (``LoRATensor`` over a raw
    base: ``x @ base + (x @ a) @ b * scale``, JAX's rounding) and refuses a
    weight type it does not know."""
    class Unknown:
        pass

    with pytest.raises(TypeError, match="Unknown"):
        pquant.matmul(torch.zeros((1, 4)), Unknown())
    rng = np.random.default_rng(4)
    w, a, b = (rng.standard_normal(s).astype(np.float32) for s in ((256, 128), (256, 4), (4, 128)))
    x = rng.standard_normal((3, 256)).astype(np.float32)
    want = jquant.matmul(jnp.asarray(x), jquant.LoRATensor(
        base=jnp.asarray(w), a=jnp.asarray(a), b=jnp.asarray(b), scale=jnp.float32(2.0)))
    got = pquant.matmul(t(x), pquant.LoRATensor(t(w), t(a), t(b), torch.tensor(2.0)))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_serving_layouts_quantize_every_projection(weights):
    """int8 serving fuses then quantizes (wqkv, w_gate_up, wo, w_down); int4
    serving quantizes the training layout; both quantize lm_head and keep
    embeddings and norms in float32. The bridged JAX weights equal the
    port's own quantization of the same float32 weights."""
    _, _, _, pp = serve_params(512, weights)
    _, _, _, plain = serve_params(512, "plain")
    mine = port_transform(plain, weights)
    kind = pquant.QTensor if weights == "int8" else pq4.Q4Tensor
    layer = pp["layers"][0]
    want_keys = ({"wqkv", "wo", "w_gate_up", "w_down"} if weights == "int8"
                 else {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})
    assert {k for k, v in layer.items() if isinstance(v, kind)} == want_keys
    assert layer["input_norm"].dtype == torch.float32 and isinstance(pp["lm_head"], kind)
    assert pp["embed_tokens"].dtype == torch.float32
    fields = ("q", "scale") if weights == "int8" else ("packed", "scale")
    for li, lay in enumerate(pp["layers"]):
        for key in want_keys:
            for f in fields:
                assert torch.equal(getattr(lay[key], f), getattr(mine["layers"][li][key], f))


def test_qtensor_reports_its_logical_shape():
    q = pquant.quantize_int8(torch.ones((8, 4)))
    assert q.shape == (8, 4) and q.ndim == 2 and q.numel() == 32 and q.nbytes() == 32 + 16
    q4 = pq4.quantize_int4(torch.ones((256, 4)))
    assert q4.shape == (256, 4) and q4.numel() == 1024 and q4.nbytes() == 512 + 4 * 8
