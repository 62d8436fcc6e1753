"""Parity of the port's optimizer pieces with the JAX package's on the CPU:
the 8-bit AdamW and the plain version of its fused kernel against both JAX
paths (the XLA formulation and the Pallas kernel in interpret mode), the
float32 AdamW against optax, every LR schedule, the decay mask, clipping,
per-layer multipliers, EMA, and the optimizer-state bridge. Inputs come from
numpy with a seed; tolerances are stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreamllm_tpu.train.optim as joptim
import dreamllm_tpu.train.optim8bit as j8
import dreamllm_tpu_torch.train.optim as poptim
import dreamllm_tpu_torch.train.optim8bit as p8
from dreamllm_tpu_torch.bridge import opt_state_from_jax
from tests._torch_port_helpers import n, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# 8-bit AdamW and the fused kernel's plain version
# ---------------------------------------------------------------------------


def test_quantize_roundtrip_matches_jax():
    """Codes and scales bit for bit (same absmax, same round-half-to-even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    x[3] = 0.5 / 127 * np.abs(x[:256]).max()  # a tie: must round to even
    for floor_positive in (False, True):
        xs = np.abs(x) * 1e-3 if floor_positive else x
        jc, js = j8.quantize_blockwise(jnp.asarray(xs), floor_positive=floor_positive)
        pc, ps = p8.quantize_blockwise(t(xs), floor_positive=floor_positive)
        np.testing.assert_array_equal(n(pc), np.asarray(jc))
        np.testing.assert_array_equal(n(ps), np.asarray(js))
        np.testing.assert_array_equal(
            n(p8.dequantize_blockwise(pc, ps, xs.shape)),
            np.asarray(j8.dequantize_blockwise(jc, js, xs.shape)))
    for jq, pq, jd, pd in ((j8.quant_moment_m, p8.quant_moment_m, j8.dequant_moment_m,
                            p8.dequant_moment_m),
                           (j8.quant_moment_v, p8.quant_moment_v, j8.dequant_moment_v,
                            p8.dequant_moment_v)):
        v = np.abs(x).reshape(10, 100)
        jm, pm = jq(jnp.asarray(v)), pq(t(v))
        np.testing.assert_array_equal(n(pm.codes), np.asarray(jm.codes))
        np.testing.assert_array_equal(n(pd(pm, v.shape)), np.asarray(jd(jm, v.shape)))


def _trajectory_inputs(sizes, dtype):
    rng = np.random.default_rng(1)
    params = {f"p{j}": (rng.standard_normal(shape).astype(np.float32) * 0.1)
              for j, shape in enumerate(sizes)}
    if dtype == "bfloat16":
        params = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
                  for k, v in params.items()}
    return params


def _grad(x, i):
    return 0.01 * x + 0.05 * np.sin(x * (i + 1))


@pytest.mark.parametrize("jax_path", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_8bit_matches_both_jax_paths(jax_path, dtype):
    """Four steps of ``adamw_8bit`` with weight decay on some leaves,
    ``min_8bit_size`` and ``fp32_moments_mask``: against the JAX XLA path
    and against the Pallas kernel under ``_FUSED_INTERPRET``. The port's
    8-bit leaves run :func:`adam8bit_update_reference`, the plain version of
    the CUDA kernel. Codes must agree except where a float32 scale one ulp
    off crosses a rounding boundary: at most 1 code in 1000 off by one,
    scales within 2.4e-7 relative (two float32 ulps), updates within 1e-6
    relative of lr (float32) or one bf16 ulp."""
    sizes = [(8, 256), (1024,), (300, 5), (64,), (512,)]  # 64 < min_8bit_size; p4 is masked
    params = _trajectory_inputs(sizes, dtype)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    sched = lambda c: 3e-3 / (1.0 + c)  # noqa: E731 a schedule, to test the pre-increment read
    kw = dict(b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.05, min_8bit_size=256)
    decay = {k: k in ("p0", "p2") for k in params}
    fp32 = {k: k == "p4" for k in params}
    jtx = j8.adamw_8bit(lambda c: sched(c.astype(jnp.float32)), mask=decay,
                        fp32_moments_mask=fp32, **kw)
    ptx = p8.adamw_8bit(lambda c: sched(c.float()), mask=decay, fp32_moments_mask=fp32,
                        fused_update=True, **kw)  # CPU leaves: the plain version

    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    pp = {k: t(v).to(pdt) for k, v in params.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    assert isinstance(ps["m"]["p0"], p8._Moment) and torch.is_tensor(ps["m"]["p3"])
    assert torch.is_tensor(ps["m"]["p4"]) and isinstance(js.m["p0"], j8._Moment)

    j8._FUSED_INTERPRET = jax_path == "pallas-interpret"
    try:
        for i in range(4):
            g = {k: _grad(np.asarray(v.astype(jnp.float32)), i) for k, v in jp.items()}
            ju, js = jtx.update({k: jnp.asarray(v).astype(jdt) for k, v in g.items()}, js, jp)
            pu, ps = ptx.update({k: t(v).to(pdt) for k, v in g.items()}, ps, pp)
            for k in params:
                a, b = n(pu[k].float()), np.asarray(ju[k].astype(jnp.float32))
                tol = 1e-6 * 3e-3 if dtype == "float32" else 2.0 ** -8 * np.abs(b).max()
                np.testing.assert_allclose(a, b, atol=tol, err_msg=f"update {k} step {i}")
                for key, jtree in (("m", js.m), ("v", js.v)):
                    pm, jm = ps[key][k], jtree[k]
                    if isinstance(pm, p8._Moment):
                        diff = np.abs(n(pm.codes).astype(np.int32)
                                      - np.asarray(jm.codes).astype(np.int32))
                        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (key, k, i)
                        np.testing.assert_allclose(n(pm.scale), np.asarray(jm.scale),
                                                   rtol=2.4e-7)
                    else:
                        np.testing.assert_allclose(n(pm), np.asarray(jm), rtol=1e-5, atol=1e-12)
            jp = optax.apply_updates(jp, ju)
            pp = poptim.apply_updates(pp, pu)
            # keep both trajectories on the same parameters
            pp = {k: t(np.asarray(v.astype(jnp.float32))).to(pdt) for k, v in jp.items()}
    finally:
        j8._FUSED_INTERPRET = False
    assert int(ps["count"]) == int(js.count) == 4


def test_adamw_8bit_skip_leaves_state_untouched():
    p = {"w": torch.randn(4, 256, generator=torch.Generator().manual_seed(0))}
    tx = p8.adamw_8bit(1e-3, weight_decay=0.1, mask={"w": True})
    st = tx.init(p)
    _, st = tx.update({"w": torch.ones(4, 256)}, st, p)
    u, st2 = tx.update({"w": torch.full((4, 256), float("nan"))}, st, p,
                       skip=torch.tensor(True))
    assert float(u["w"].abs().max()) == 0.0 and int(st2["count"]) == 1
    for key in ("m", "v"):
        assert torch.equal(st2[key]["w"].codes, st[key]["w"].codes)
        assert torch.equal(st2[key]["w"].scale, st[key]["w"].scale)


def test_fused_kernel_wrapper_refuses_cpu_tensors():
    g = torch.zeros(256)
    mq = p8.quant_moment_m(g)
    with pytest.raises(ValueError, match="CUDA"):
        p8.adam8bit_update_cuda(g, g, mq, mq, torch.zeros(3), b1=0.9, b2=0.99, eps=1e-8)


@pytest.mark.cuda
def test_fused_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = (torch.randn((1000, 33), generator=gen, device="cuda") * 1e-3).bfloat16()  # ragged tail
    p = torch.randn((1000, 33), generator=gen, device="cuda").bfloat16()
    zeros = torch.zeros_like(g, dtype=torch.float32)
    mq, vq = p8.quant_moment_m(zeros), p8.quant_moment_v(zeros)
    scalars = torch.tensor([1e-3, 0.1, 0.01], device="cuda")
    kw = dict(b1=0.9, b2=0.99, eps=1e-8, wd=0.01)
    want_u, want_m, want_v = p8.adam8bit_update_reference(g, p, mq, vq, scalars, **kw)
    got_u = p8.adam8bit_update_cuda(g, p, mq, vq, scalars, **kw)
    assert torch.equal(got_u, want_u)
    assert torch.equal(mq.codes, want_m.codes) and torch.equal(vq.codes, want_v.codes)


# ---------------------------------------------------------------------------
# float32 AdamW, clipping, the factory
# ---------------------------------------------------------------------------


def _small_params(rng):
    return {
        "llm": {"embed_tokens": rng.standard_normal((50, 8)).astype(np.float32),
                "layers": {"wq": rng.standard_normal((2, 8, 8)).astype(np.float32),
                           "input_norm": np.ones((2, 8), np.float32)},
                "final_norm": np.ones((8,), np.float32)},
        "proj": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                 "b": np.zeros((4,), np.float32)},
    }


def _port_params(jparams):
    layers = jparams["llm"]["layers"]
    return {
        "llm": {"embed_tokens": t(jparams["llm"]["embed_tokens"]),
                "layers": [{k: t(v[i]) for k, v in layers.items()} for i in range(2)],
                "final_norm": t(jparams["llm"]["final_norm"])},
        "proj": {k: t(v) for k, v in jparams["proj"].items()},
    }


def _stacked(ptree):
    """Port tree (per-layer list) -> numpy tree in the JAX layout."""
    layers = ptree["llm"]["layers"]
    return {
        "llm": {"embed_tokens": n(ptree["llm"]["embed_tokens"]),
                "layers": {k: np.stack([n(layer[k]) for layer in layers]) for k in layers[0]},
                "final_norm": n(ptree["llm"]["final_norm"])},
        "proj": {k: n(v) for k, v in ptree["proj"].items()},
    }


@pytest.mark.parametrize("feature", ["freeze-mask", "multipliers"])
@pytest.mark.parametrize("eight_bit", [False, True], ids=["fp32", "8bit"])
def test_make_optimizer_matches_jax(eight_bit, feature):
    """Clip + AdamW + cosine schedule with warmup + weight decay by path,
    with a freeze mask or with per-layer multipliers applied after Adam (the
    JAX transform cannot map a multiplier tree over masked updates, so one
    at a time), four steps.
    Updates within 1e-6 absolute (lr 1e-2, float32 throughout; 8-bit: every
    8-bit leaf here is a multiple of 256 a layer, so blocks agree)."""
    rng = np.random.default_rng(2)
    jparams = _small_params(rng)
    if eight_bit:  # leaves whose per-layer size is a multiple of 256
        jparams["llm"]["layers"]["wq"] = rng.standard_normal((2, 16, 16)).astype(np.float32)
    pparams = _port_params(jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    cfg = dict(learning_rate=1e-2, schedule="cosine", warmup_steps=2, total_steps=10,
               weight_decay=0.1, max_grad_norm=0.5, optimizer_8bit=eight_bit, min_8bit_size=256)
    jmask = {"llm": True, "proj": {"w": True, "b": False}}
    vec = np.asarray([0.5, 1.0], np.float32)
    jmult = joptim.layerwise_multiplier_tree(jparams, {"llm/layers": jnp.asarray(vec)})
    pmult = poptim.layerwise_multiplier_tree(pparams, {"llm/layers": t(vec)})
    assert pmult["proj"]["w"] is None and float(pmult["llm"]["layers"][0]["wq"]) == 0.5
    frozen = feature == "freeze-mask"
    if frozen:
        jtx = joptim.make_optimizer(joptim.OptimizerConfig(**cfg), trainable_mask=jax.tree.map(
            lambda _: True, jparams) | {"proj": {"w": True, "b": False}})
        ptx = poptim.make_optimizer(poptim.OptimizerConfig(**cfg), trainable_mask=jmask)
    else:
        jtx = joptim.make_optimizer(joptim.OptimizerConfig(**cfg), grad_multipliers=jmult)
        ptx = poptim.make_optimizer(poptim.OptimizerConfig(**cfg), grad_multipliers=pmult)
    js, ps = jtx.init(jparams), ptx.init(pparams)
    for i in range(4):
        g = jax.tree.map(lambda x: np.asarray(_grad(np.asarray(x), i) * 3.0, np.float32), jparams)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jparams)
        pu, ps = ptx.update(_port_params(g), ps, pparams)
        if frozen:
            assert pu["proj"]["b"] is None  # frozen: no update at all in the port
            pu["proj"]["b"] = torch.zeros(4)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-6),
                     _stacked(pu), ju)
    # the carried JAX state equals the port's
    carried = opt_state_from_jax(_np_tree(js), ps, params=pparams, device="cpu")
    got, want = poptim.adam_state(ps), poptim.adam_state(carried)
    assert int(got["count"]) == int(want["count"]) == 4
    if frozen:
        assert got["m"]["proj"]["b"] is None and want["m"]["proj"]["b"] is None
    a, b = got["m"]["llm"]["layers"][1]["wq"], want["m"]["llm"]["layers"][1]["wq"]
    if eight_bit:
        assert isinstance(a, p8._Moment) and np.abs(
            n(a.codes).astype(int) - n(b.codes).astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-9)


def test_opt_state_from_jax_raises_on_what_it_cannot_place():
    rng = np.random.default_rng(3)
    # a [2, 200] stacked leaf: 400 elements -> 2 JAX blocks that straddle the layers
    jparams = {"layers": {"w": jnp.asarray(rng.standard_normal((2, 200)), jnp.float32)}}
    pparams = {"layers": [{"w": t(np.asarray(jparams["layers"]["w"][i]))} for i in range(2)]}
    js = j8.adamw_8bit(1e-3).init(jparams)
    ps = p8.adamw_8bit(1e-3).init(pparams)
    with pytest.raises(ValueError, match="layer boundaries"):
        opt_state_from_jax(_np_tree(js), [ps], params=pparams, device="cpu")
    with pytest.raises(ValueError, match="no Adam state"):
        opt_state_from_jax({"x": np.zeros(3)}, [ps], device="cpu")
    # a JAX leaf the port lacks, and a port leaf the JAX state lacks
    good_j = {"a": jnp.zeros((256,), jnp.float32), "b": jnp.zeros((256,), jnp.float32)}
    js = _np_tree(j8.adamw_8bit(1e-3).init(good_j))
    pa = p8.adamw_8bit(1e-3).init({"a": torch.zeros(256)})
    with pytest.raises(ValueError, match="did not consume"):
        opt_state_from_jax(js, [pa], device="cpu")
    pc = p8.adamw_8bit(1e-3).init({"a": torch.zeros(256), "b": torch.zeros(256),
                                   "c": torch.zeros(256)})
    with pytest.raises(KeyError, match="lacks"):
        opt_state_from_jax(js, [pc], device="cpu")
    pw = p8.adamw_8bit(1e-3).init({"a": torch.zeros(512), "b": torch.zeros(256)})
    with pytest.raises(ValueError, match="!= port"):
        opt_state_from_jax(js, [pw], device="cpu")


SCHEDULES = [
    dict(schedule="constant"),
    dict(schedule="linear", min_lr_ratio=0.1),
    dict(schedule="cosine", min_lr_ratio=0.05),
    dict(schedule="cosine", num_cycles=1.5),
    dict(schedule="cosine_restarts", num_cycles=3.0, min_lr_ratio=0.1),
    dict(schedule="polynomial", power=2.0, min_lr_ratio=0.1),
]


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda k: f"{k['schedule']}-{len(k)}")
def test_lr_schedule_matches_jax(kw, warmup):
    """Every schedule at steps before, inside and past its range; 1e-6
    relative + 1e-12 (float32 evaluation of the same formula)."""
    cfg = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=50, scale_lr_by=2.0, **kw)
    js = joptim.make_lr_schedule(joptim.OptimizerConfig(**cfg))
    ps = poptim.make_lr_schedule(poptim.OptimizerConfig(**cfg))
    for step in (0, 1, 3, 6, 7, 8, 20, 49, 50, 51, 80):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = float(ps(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12, err_msg=f"step {step}")


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        poptim.make_lr_schedule(poptim.OptimizerConfig(schedule="nope"))


def test_decay_mask_matches_jax_by_path():
    rng = np.random.default_rng(4)
    jparams = _small_params(rng)
    jparams["unet"] = {"norm1": {"w": np.ones((3, 3), np.float32), "b": np.zeros(3, np.float32)},
                       "attn": {"ln1": {"w": np.ones((2, 2), np.float32)},
                                "bq": np.zeros((2, 2), np.float32),
                                "q": {"w": np.ones((2, 2), np.float32),
                                      "out_b": np.zeros((2, 2), np.float32)}}}
    pparams = _port_params(jparams)
    pparams["unet"] = jax.tree.map(t, jparams["unet"])
    jmask = joptim._decay_mask(jax.tree.map(jnp.asarray, jparams))
    pmask = poptim._decay_mask(pparams)
    assert pmask["unet"] == jmask["unet"]
    assert pmask["proj"] == jmask["proj"] == {"w": True, "b": False}
    assert pmask["llm"]["embed_tokens"] is True and pmask["llm"]["final_norm"] is False
    for layer in pmask["llm"]["layers"]:  # JAX's stacked [2, 8] norm is rank 2 and still excluded
        assert layer == {"wq": jmask["llm"]["layers"]["wq"],
                         "input_norm": jmask["llm"]["layers"]["input_norm"]}
        assert layer == {"wq": True, "input_norm": False}


def test_clip_and_global_norm_match_optax():
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    want_norm = float(optax.global_norm(jax.tree.map(jnp.asarray, g)))
    pg = {"a": t(g["a"]), "b": [t(g["b"][0]), None]}
    np.testing.assert_allclose(float(poptim.global_norm(pg)), want_norm, rtol=1e-6)
    for max_norm in (0.5, 100.0):
        ju, _ = optax.clip_by_global_norm(max_norm).update(jax.tree.map(jnp.asarray, g), None)
        pu, _ = poptim.clip_by_global_norm(max_norm).update(
            {"a": t(g["a"]).clone(), "b": [t(g["b"][0]).clone(), None]}, None)
        np.testing.assert_allclose(n(pu["a"]), np.asarray(ju["a"]), rtol=1e-6)
        np.testing.assert_allclose(n(pu["b"][0]), np.asarray(ju["b"][0]), rtol=1e-6)
        assert pu["b"][1] is None


def test_multipliers_and_ema_match_jax():
    np.testing.assert_array_equal(n(poptim.trailing_layers_multiplier(6, 2)),
                                  np.asarray(joptim.trailing_layers_multiplier(6, 2)))
    np.testing.assert_allclose(n(poptim.llrd_multiplier(5, 0.8)),
                               np.asarray(joptim.llrd_multiplier(5, 0.8)), rtol=1e-6)
    # a stacked leaf scaled along its leading axis == per-layer scalars
    vec = np.asarray([0.0, 0.5, 1.0], np.float32)
    u = np.arange(24, dtype=np.float32).reshape(3, 2, 4)
    ju, _ = joptim.scale_grads_by_tree({"w": jnp.asarray(vec)}).update({"w": jnp.asarray(u)}, None)
    pmult = poptim.layerwise_multiplier_tree({"x": [{"w": t(u[i])} for i in range(3)]},
                                             {"x": t(vec)})
    pu, _ = poptim.scale_grads_by_tree(pmult).update({"x": [{"w": t(u[i])} for i in range(3)]},
                                                     None)
    np.testing.assert_array_equal(np.stack([n(l["w"]) for l in pu["x"]]), np.asarray(ju["w"]))
    for step in (0, 5, 1000, 10 ** 6):
        np.testing.assert_allclose(float(poptim.ema_decay_schedule(torch.tensor(step))),
                                   float(joptim.ema_decay_schedule(jnp.asarray(step))), rtol=1e-6)
    rng = np.random.default_rng(6)
    e, p = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal((3, 4)).astype(
        np.float32)
    want = joptim.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.99)
    got = poptim.ema_update({"w": t(e)}, {"w": t(p)}, 0.99)
    np.testing.assert_allclose(n(got["w"]), np.asarray(want["w"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# 8-bit moments of a conv kernel: blocked in the JAX package's HWIO order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (3, 3, 32, 64)], ids=["ragged", "whole"])
def test_adamw_8bit_conv_leaf_matches_jax(shape):
    """Two 8-bit AdamW updates of a trainable ``[3, 3, cin, cout]`` conv
    kernel, HWIO in JAX and OIHW (channels-last, as the bridge stores it)
    in the port, through the port's plain math on the CPU. The port must
    cut the same 256-blocks as JAX: codes within the limits of
    :func:`test_adamw_8bit_matches_both_jax_paths` (off by at most one, in
    at most 1 of 1000), scales within two float32 ulps, updates within 1e-6
    relative of lr; and the bridge carries JAX's moments as they are."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    kw = dict(b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.05)
    jtx = j8.adamw_8bit(3e-3, mask={"w": True}, **kw)
    ptx = p8.adamw_8bit(3e-3, mask={"w": True}, fused_update=True, **kw)  # CPU: plain math
    hwio_to_oihw = (3, 2, 0, 1)
    jp = {"w": jnp.asarray(w)}
    pp = {"w": t(w).permute(*hwio_to_oihw).contiguous(memory_format=torch.channels_last)}
    js, ps = jtx.init(jp), ptx.init(pp)
    for i in range(2):
        g = _grad(w, i).astype(np.float32)
        ju, js = jtx.update({"w": jnp.asarray(g)}, js, jp)
        pu, ps = ptx.update({"w": t(g).permute(*hwio_to_oihw)}, ps, pp)
        assert tuple(pu["w"].shape) == tuple(pp["w"].shape)
        np.testing.assert_allclose(n(pu["w"].permute(2, 3, 1, 0)), np.asarray(ju["w"]),
                                   atol=1e-6 * 3e-3, err_msg=f"update step {i}")
        for key, jtree in (("m", js.m), ("v", js.v)):
            pm, jm = ps[key]["w"], jtree["w"]
            diff = np.abs(n(pm.codes).astype(np.int32) - np.asarray(jm.codes).astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (key, i)
            np.testing.assert_allclose(n(pm.scale), np.asarray(jm.scale), rtol=2.4e-7)
        jp = {"w": jp["w"] + ju["w"]}
        w = np.asarray(jp["w"])
        pp = {"w": t(w).permute(*hwio_to_oihw).contiguous(memory_format=torch.channels_last)}
    carried = opt_state_from_jax(_np_tree(js), ps, params=pp, device="cpu")
    for key in ("m", "v"):
        jm = getattr(js, key)["w"]
        np.testing.assert_array_equal(n(carried[key]["w"].codes), np.asarray(jm.codes))
        np.testing.assert_array_equal(n(carried[key]["w"].scale), np.asarray(jm.scale))
    # the carried moments dequantize to JAX's, element by element, in the port's layout
    np.testing.assert_array_equal(
        n(p8.dequant_moment_m(carried["m"]["w"], tuple(pp["w"].shape)).permute(2, 3, 1, 0)),
        np.asarray(j8.dequant_moment_m(js.m["w"], shape)))
