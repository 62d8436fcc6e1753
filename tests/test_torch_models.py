"""Parity of the PyTorch port's LLaMA, CLIP, projector and DreamLLM
modules with the JAX package's, on the CPU, at tiny sizes (2 layers,
widths of 64 or less), float32, with JAX weights brought over by
``bridge.from_jax``. Tolerance: 1e-4 absolute on hidden states and logits
(float32 through 2 layers, sums taken in other orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.clip as jclip
import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.llama as jllama
import dreamllm_tpu_torch.models.clip as pclip
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.models.projector as pproj
from dreamllm_tpu_torch.bridge import from_jax
from tests._torch_port_helpers import (
    clip_params,
    dreamllm_params,
    llama_params,
    n,
    np_tree,
    t,
)

ATOL = 1e-4


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [True, False])
def test_llama_forward_without_cache(use_flash):
    jc, pc, jp, pp = llama_params()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    seg = np.ones((2, 12), np.int32)
    seg[1, 7:] = 2  # a packed second sequence
    want = jllama.llama_forward(jp, jc, input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg),
                                use_flash=use_flash)
    got = pllama.llama_forward(pp, pc, input_ids=t(ids).long(), segment_ids=t(seg),
                               use_flash=use_flash)
    np.testing.assert_allclose(n(got["last_hidden_state"]),
                               np.asarray(want["last_hidden_state"]), atol=ATOL)
    np.testing.assert_allclose(n(pllama.llama_logits(pp, pc, got["last_hidden_state"])),
                               np.asarray(jllama.llama_logits(jp, jc, want["last_hidden_state"])),
                               atol=ATOL)


@pytest.mark.parametrize("rope", ["none", "linear", "dynamic"])
def test_llama_decode_with_cache(rope):
    """Prefill 6 tokens, then 3 single-token steps, through the bf16 cache
    on both sides; hidden states, logits and the cache contents agree."""
    jc, pc, jp, pp = llama_params(rope_scaling_type=rope, rope_scaling_factor=2.0)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jc.vocab_size, (1, 9)).astype(np.int32)
    # a cache larger than max_position_embeddings: dynamic NTK scales from it
    jcache = jllama.init_kv_cache(jc, 1, 80)
    pcache = pllama.init_kv_cache(pc, 1, 80, device="cpu")
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jo = jllama.llama_forward(jp, jc, input_ids=jnp.asarray(ids[:, lo:hi]), kv_cache=jcache)
        po = pllama.llama_forward(pp, pc, input_ids=t(ids[:, lo:hi]).long(), kv_cache=pcache)
        jcache, pcache = jo["kv_cache"], po["kv_cache"]
        np.testing.assert_allclose(n(po["last_hidden_state"]),
                                   np.asarray(jo["last_hidden_state"]), atol=ATOL)
        np.testing.assert_allclose(n(pllama.llama_logits(pp, pc, po["last_hidden_state"])),
                                   np.asarray(jllama.llama_logits(jp, jc, jo["last_hidden_state"])),
                                   atol=ATOL)
    assert int(pcache["index"]) == int(jcache["index"]) == 9
    for key in ("seg", "pos"):
        np.testing.assert_array_equal(n(pcache[key]), np.asarray(jcache[key]))
    np.testing.assert_allclose(n(pcache["k"].float()), np.asarray(jcache["k"], np.float32),
                               atol=1e-2)  # bf16 cache: one bf16 ulp at |k| < 4


def test_cache_write_vector_index_matches_jax():
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((3, 10, 2), dtype=np.float32)
    val = rng.standard_normal((3, 2, 2), dtype=np.float32)
    idx = np.asarray([0, 3, 8], np.int32)
    want = jllama.cache_write(jnp.asarray(buf), jnp.asarray(val), jnp.asarray(idx))
    got = pllama.cache_write(t(buf), t(val), t(idx))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    want = jllama.cache_write(jnp.asarray(buf), jnp.asarray(val), jnp.asarray(4, jnp.int32))
    got = pllama.cache_write(t(buf), t(val), 4)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_cache_overflow_raises():
    """JAX clamps a write past the end silently; the port raises, once a
    forward and before any write (``check_cache_write``)."""
    with pytest.raises(IndexError):
        pllama.check_cache_write(4, 3, 2)
    with pytest.raises(IndexError):
        pllama.check_cache_write(4, torch.tensor([4]), 1)
    with pytest.raises(IndexError):
        pllama.check_cache_write(4, torch.tensor([-1, 0]), 1)
    pllama.check_cache_write(4, torch.tensor([0, 2]), 2)  # the last row fits
    # through the forward: a full cache refuses one more token, unchanged
    _, pc, _, pp = llama_params()
    cache = pllama.init_kv_cache(pc, 2, 4, device="cpu")
    ids = torch.ones((2, 4), dtype=torch.long)
    cache = pllama.llama_forward(pp, pc, input_ids=ids, kv_cache=cache)["kv_cache"]
    before = {k: v.clone() for k, v in cache.items() if torch.is_tensor(v)}
    for idx in (4, torch.tensor([3, 4], dtype=torch.int32)):
        cache["index"] = idx
        with pytest.raises(IndexError):
            pllama.llama_forward(pp, pc, input_ids=ids[:, :1], kv_cache=cache)
        for k, v in before.items():
            assert torch.equal(cache[k], v), k


def test_llama_logits_are_float32_from_bf16():
    _, pc, _, pp = llama_params()
    pp = {k: v for k, v in pp.items()}
    pp["lm_head"] = pp["lm_head"].bfloat16()
    h = torch.randn((1, 2, pc.hidden_size)).bfloat16()
    got = pllama.llama_logits(pp, pc, h)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, h.float() @ pp["lm_head"].float(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("select_layer,drop_cls", [(-2, True), (None, False), (0, True)])
def test_clip_vision_forward(select_layer, drop_cls):
    jc, pc, jp, pp = clip_params()
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3), dtype=np.float32)
    want = jclip.clip_vision_forward(jp, jc, jnp.asarray(x), select_layer=select_layer,
                                     drop_cls=drop_cls)
    got = pclip.clip_vision_forward(pp, pc, t(x), select_layer=select_layer, drop_cls=drop_cls)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("size_in", [64, 48, 32, 20])
def test_clip_preprocess_matches_jax_resize(size_in):
    """Keys a=-0.5 bicubic, antialiased when downsampling, as
    ``jax.image.resize`` computes it (not ``F.interpolate``'s a=-0.75)."""
    img = np.random.default_rng(4).random((2, size_in, size_in, 3), dtype=np.float32)
    want = jclip.clip_preprocess(jnp.asarray(img), 32)
    got = pclip.clip_preprocess(t(img), 32)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# DreamLLM assembly
# ---------------------------------------------------------------------------


def test_multimodal_embed_and_dream_states():
    jc, pc, jp, pp = dreamllm_params()
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 32000, (2, 24)).astype(np.int32)
    images = rng.standard_normal((2, 2, 32, 32, 3), dtype=np.float32)
    img_pos = np.asarray([[2, 12], [5, -1]], np.int32)   # -1: absent
    dream_pos = np.asarray([[16], [22]], np.int32)       # 22 + 8 runs past the end: dropped
    want = jdl.multimodal_embed(jp, jc, jnp.asarray(ids), images=jnp.asarray(images),
                                image_positions=jnp.asarray(img_pos),
                                dream_positions=jnp.asarray(dream_pos))
    got = pdl.multimodal_embed(pp, pc, t(ids).long(), images=t(images),
                               image_positions=t(img_pos), dream_positions=t(dream_pos))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)

    hidden = rng.standard_normal((2, 24, 64), dtype=np.float32)
    pos = np.asarray([[3, -1], [10, 20]], np.int32)
    wc, wv = jdl.extract_dream_hidden(jnp.asarray(hidden), jnp.asarray(pos), 8)
    gc, gv = pdl.extract_dream_hidden(t(hidden), t(pos), 8)
    np.testing.assert_array_equal(n(gc), np.asarray(wc))
    np.testing.assert_array_equal(n(gv), np.asarray(wv))

    np.testing.assert_array_equal(n(pdl.canonical_dream_sequence(pc)),
                                  np.asarray(jdl.canonical_dream_sequence(jc)))
    np.testing.assert_allclose(n(pdl.unconditional_dream_hidden(pp, pc)),
                               np.asarray(jdl.unconditional_dream_hidden(jp, jc)), atol=ATOL)


def test_encode_images_through_projector():
    jc, pc, jp, pp = dreamllm_params()
    x = np.random.default_rng(6).standard_normal((3, 32, 32, 3), dtype=np.float32)
    want = jdl.encode_images(jp, jc, jnp.asarray(x))
    got = pdl.encode_images(pp, pc, t(x))
    assert tuple(got.shape) == (3, 4, 64)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def test_projector_types_beyond_linear_raise():
    """Every projector type of the JAX package is ported now (parity in
    tests/test_torch_projector.py): an ``mlp`` builds, and only a type that
    neither package knows raises."""
    cfg = pproj.ProjectorConfig(projector_type="mlp", in_dim=8, out_dim=16, depth=2)
    assert [tuple(l["w"].shape) for l in pproj.init_projector_params(cfg, device="cpu")[
        "layers"]] == [(8, 16), (16, 16)]
    with pytest.raises(ValueError, match="unknown projector_type"):
        pproj.init_projector_params(pproj.ProjectorConfig(projector_type="qformer"),
                                    device="cpu")


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def test_bridge_consumes_every_jax_leaf():
    _, pc, jp, pp = dreamllm_params()
    like = pdl.init_dreamllm_params(pc, device="meta")
    jleaves = jax.tree.leaves(jp)
    n_layers = pc.llm.num_hidden_layers
    # every JAX element lands in the port once: stacked [L, ...] leaves are
    # split over L per-layer tensors, nothing is dropped or duplicated
    assert sum(int(np.size(a)) for a in jleaves) == sum(
        x.numel() for x in jax.tree.leaves(pp, is_leaf=torch.is_tensor))
    assert len(pp["llm"]["layers"]) == n_layers
    for key, arr in jp["llm"]["layers"].items():
        np.testing.assert_array_equal(n(pp["llm"]["layers"][1][key]), np.asarray(arr[1]))
    assert like["llm"]["embed_tokens"].device.type == "meta"


def test_bridge_raises_on_missing_extra_or_misshapen_leaves():
    _, pc, jp, _ = dreamllm_params()
    like = pdl.init_dreamllm_params(pc, device="meta")
    tree = np_tree(jp)
    extra = {**tree, "stray": np.zeros(3)}
    with pytest.raises(ValueError, match="stray"):
        from_jax(extra, like, device="cpu")
    missing = {**tree, "llm": {k: v for k, v in tree["llm"].items() if k != "final_norm"}}
    with pytest.raises(KeyError, match="final_norm"):
        from_jax(missing, like, device="cpu")
    layers = dict(tree["llm"]["layers"])
    layers["wq"] = layers["wq"][:, :, :-1]
    bad = {**tree, "llm": {**tree["llm"], "layers": layers}}
    with pytest.raises(ValueError, match="wq"):
        from_jax(bad, like, device="cpu")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, pc = pllama.LlamaConfig(), pllama.LlamaConfig(num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pllama.init_kv_cache(pc, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pclip.init_clip_vision_params(pclip.CLIPVisionConfig(num_hidden_layers=1))
