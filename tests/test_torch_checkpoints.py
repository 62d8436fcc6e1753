"""Checkpoints of the PyTorch port that hold quantized weights: an int8
(``QTensor``) and an int4 (``Q4Tensor``) leaf save, load with ``like=`` and
without it, and come back as the same types with the same bits, so they
multiply to the same bits; the same holds for a decoder that the JAX
package quantized (compiled, as ``projects/dreamllm/serve.py`` does) and
``bridge.from_jax`` brought over. The JAX package's own round trip is
``tests/test_quant.py::TestQuantCheckpoint``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dreamllm_tpu_torch.train.checkpoints as pckpt
from dreamllm_tpu_torch.models.llama import llama_forward
from dreamllm_tpu_torch.ops.quant import QTensor, matmul, quantize_int8
from dreamllm_tpu_torch.ops.quant4 import Q4Tensor, quantize_int4
from tests._torch_port_helpers import t
from tests._torch_serve_helpers import serve_params


def _same_quantized(a, b):
    assert type(a) is type(b)
    for x, y in zip(vars(a).values(), vars(b).values()):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


@pytest.mark.parametrize("with_like", [False, True], ids=["no-like", "like"])
def test_qtensor_checkpoint_roundtrip(tmp_path, with_like):
    """``{"llm": {"a": int4, "b": int8}}`` (with a plain leaf beside them):
    the same bits back, and ``matmul`` gives the same bits."""
    rng = np.random.default_rng(0)
    w = t(rng.standard_normal((512, 256)).astype(np.float32))
    params = {"llm": {"a": quantize_int4(w), "b": quantize_int8(w), "norm": torch.ones(256)}}
    path = pckpt.save_checkpoint(str(tmp_path / "q"), 1, params)
    back = pckpt.load_params(path, like=params if with_like else None)
    assert isinstance(back["llm"]["a"], Q4Tensor) and isinstance(back["llm"]["b"], QTensor)
    assert back["llm"]["a"].shape == (512, 256) and back["llm"]["b"].q.dtype == torch.int8
    for key in ("a", "b"):
        _same_quantized(back["llm"][key], params["llm"][key])
    assert torch.equal(back["llm"]["norm"], params["llm"]["norm"])
    x = t(rng.standard_normal((3, 512)).astype(np.float32))
    for key in ("a", "b"):
        assert torch.equal(matmul(x, back["llm"][key]), matmul(x, params["llm"][key]))


@pytest.mark.parametrize("weights", ["int8", "int4", "int4-fused"])
def test_jax_quantized_decoder_roundtrip(tmp_path, weights):
    """A tiny decoder quantized by the JAX package, brought over by
    ``bridge.from_jax``, saved by the port and loaded with and without
    ``like=``: every leaf's bits, and the decoder's forward, unchanged."""
    _, pc, _, pp = serve_params(512, weights)
    path = pckpt.save_checkpoint(str(tmp_path / weights), 3, {"llm": pp})
    ids = torch.tensor([[3, 9, 21, 40, 7]])
    want = llama_forward(pp, pc, input_ids=ids)["last_hidden_state"]
    for like in (None, {"llm": pp}):
        back = pckpt.load_params(path, like=like)["llm"]
        for a, b in zip(back["layers"], pp["layers"]):
            for key in a:
                if torch.is_tensor(a[key]):
                    assert torch.equal(a[key], b[key])
                else:
                    _same_quantized(a[key], b[key])
        assert torch.equal(llama_forward(back, pc, input_ids=ids)["last_hidden_state"], want)


def test_quantized_leaf_against_the_wrong_template_raises(tmp_path):
    w = torch.randn((256, 128), generator=torch.Generator().manual_seed(0))
    path = pckpt.save_checkpoint(str(tmp_path / "q"), 1, {"llm": {"a": quantize_int8(w)}})
    with pytest.raises(ValueError, match="expected a Q4Tensor"):
        pckpt.load_params(path, like={"llm": {"a": quantize_int4(w)}})
    with pytest.raises(ValueError, match="shape"):
        pckpt.load_params(path, like={"llm": {"a": quantize_int8(w[:, :64])}})
