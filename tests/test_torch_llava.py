"""LLaVA in the PyTorch port against the JAX package, on the CPU in float32
at a tiny size: the recipe (``llava_config``, ``llava_pretrain_config`` and
``configs.llava_7b`` against ``projects/llava/configs/pretrain.py``), the
parameter tree without dream queries, the freeze mask, and
``llava_forward``'s loss and the projector's gradients (stage 1 trains the
projector only). Tolerances are stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.llava as jllava
import dreamllm_tpu_torch.configs as pconfigs
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.llava as pllava
from dreamllm_tpu_torch.train.tree import tree_leaves_with_path
from tests._torch_port_helpers import config_fields, llava_cfgs, llava_params, n, t


def test_recipes_match_jax():
    """The default and stage-1 configs field for field; ``llava_7b`` equals
    what ``projects/llava/configs/pretrain.py`` builds; the dream queries
    are gone from the tree."""
    for pretrain in (False, True):
        jc, pc = llava_cfgs(pretrain)
        assert config_fields(pc) == config_fields(jc)
    d_j, d_p = jllava.llava_config(), pllava.llava_config()
    assert config_fields(d_p) == config_fields(d_j)
    assert (d_p.image_embed_len, d_p.n_dream_queries, d_p.loss_weight_vm) == (576, 0, 0.0)
    assert pllava.LLAVA_PRETRAIN_FROZEN == jllava.LLAVA_PRETRAIN_FROZEN

    from dreamllm_tpu.config import instantiate
    from projects.llava.configs.pretrain import config

    m = instantiate(config["model"])
    frozen = tuple(m.pop("frozen"))
    want = jdl.DreamLLMConfig(**m, frozen=frozen)
    got = pconfigs.llava_7b(torch.bfloat16)
    assert config_fields(got) == config_fields(want)
    assert got.llm.dtype == got.vision.dtype == got.vision_projector.dtype == torch.bfloat16
    _, _, jp, pp = llava_params()
    assert "dream_embedding" not in pp and set(pp) == set(jp)


def test_freeze_mask_matches_jax():
    """Stage 1: the projector trains, the decoder and the CLIP tower do
    not, leaf for leaf as JAX's mask says (a stacked JAX leaf is one entry
    for all layers)."""
    jc, pc, jp, pp = llava_params()
    jmask = jdl.param_freeze_mask(jp, jc)
    got = dict(tree_leaves_with_path(pdl.param_freeze_mask(pp, pc)))

    def jax_value(path):
        node = jmask
        for key in path:
            if not (isinstance(key, int) and isinstance(node, dict)):
                node = node[key]
        return bool(node)

    assert got and all(v == jax_value(p) for p, v in got.items())
    trainable = {p[:2] for p, v in got.items() if v}
    assert trainable == {("clip_vision_embedding", "projector")}


def _batch(seed=0, b=2, s=24):
    """Two rows: ``bos``, an image span (4 patches) at position 2, text; the
    second row packed from two segments with a padding tail."""
    _, pc = llava_cfgs()
    st = pc.special_tokens
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 31000, (b, s)).astype(np.int32)
    ids[:, 0] = st.bos
    ids[:, 1], ids[:, 6] = st.im_start, st.im_end
    ids[:, 2:6] = st.im_patch
    labels = ids.copy()
    labels[:, 1:7] = -100
    seg = np.ones((b, s), np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    seg[1, 16:21], seg[1, 21:] = 2, 0
    pos[1, 16:21] = np.arange(5)
    labels[1, 21:] = -100
    return {"input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos,
            "images": rng.standard_normal((b, 1, 32, 32, 3)).astype(np.float32),
            "image_positions": np.full((b, 1), 2, np.int32)}


def test_llava_forward_loss_and_projector_grads_match_jax():
    """Loss within 1e-5 relative, ``vm_loss`` 0, and the gradient of every
    projector leaf within 1e-4 of its largest value, against
    ``jax.value_and_grad`` of JAX's ``llava_forward``."""
    jc, pc, jp, pp = llava_params()
    batch = _batch()

    def jloss(proj):
        params = {**jp, "clip_vision_embedding": {**jp["clip_vision_embedding"],
                                                  "projector": proj}}
        return jllava.llava_forward(params, jc, {k: jnp.asarray(v) for k, v in batch.items()})

    (want, waux), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp["clip_vision_embedding"]["projector"])
    proj = {"layers": [{k: v.detach().clone().requires_grad_() for k, v in layer.items()}
                       for layer in pp["clip_vision_embedding"]["projector"]["layers"]]}
    params = {**pp, "clip_vision_embedding": {**pp["clip_vision_embedding"], "projector": proj}}
    loss, aux = pllava.llava_forward(params, pc, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(aux["vm_loss"]) == float(waux["vm_loss"]) == 0.0
    leaves = [layer[k] for layer in proj["layers"] for k in ("w", "b")]
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == 4  # two dense layers
    for g, (i, k) in zip(grads, [(i, k) for i in range(2) for k in ("w", "b")]):
        ref = np.asarray(wgrads["layers"][i][k])
        assert float(np.abs(ref).max()) > 0
        np.testing.assert_allclose(n(g), ref, atol=1e-4 * float(np.abs(ref).max()))
