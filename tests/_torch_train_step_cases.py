"""Shared bodies of ``test_torch_train_step.py`` (float32 AdamW) and
``test_torch_train_step8.py`` (8-bit AdamW), two files so that two test
workers share the JAX compiles.

The training slice as a whole, JAX package against the PyTorch port on
the CPU in float32: three ``make_train_step`` updates on one tiny joint
batch (2-layer decoder, CLIP, 2-level UNet and VAE frozen as the SFT recipe
freezes them), with float32 AdamW and 8-bit AdamW, ``grad_accum`` 1 and 2;
and the non-finite skip. JAX weights reach the port through
``bridge.from_jax``; the JAX random draws are replayed into the port.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import dreamllm_tpu.models.dreamllm as jdl
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu.train.optim as joptim
import dreamllm_tpu.train.step as jstep
import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.train.optim as poptim
import dreamllm_tpu_torch.train.step as pstep
from dreamllm_tpu_torch.train.optim8bit import _Moment, dequant_moment_m, dequant_moment_v
from dreamllm_tpu_torch.train.tree import tree_leaves_with_path
from tests._torch_port_helpers import (
    jax_leaf,
    jax_batch,
    n,
    port_batch,
    replay_draws,
    train_batch,
    train_cfgs,
    train_params,
)

# lr large enough that three steps move float32 parameters visibly; the
# 8-bit threshold is set so that the port's per-layer leaves and JAX's
# layer-stacked ones make the same 8-bit/float32 choice
# (see optim8bit.py). eps 1e-5, not 1e-8: Adam's normalised update g / (|g|
# + eps) turns a 1e-9 rounding difference of a near-zero gradient into a
# visible step at eps 1e-8, which would test the rounding and not the code.
OPT = dict(learning_rate=1e-3, schedule="cosine", warmup_steps=0, total_steps=100,
           weight_decay=0.01, max_grad_norm=1.0, min_8bit_size=1024, eps=1e-5)


# 32 px images: 16x16 latents. The UNet's attention (S 256) is then below the
# flash rule, which keeps three steps cheap; the flash path and its backward
# inside the joint loss are covered by tests/test_torch_train_grads.py.
PX = 32


def _port_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _setup(eight_bit, grad_accum, skip_nonfinite=True):
    jc, pc, jh, ph = train_cfgs()
    jparams, pparams = train_params()
    jmask, pmask = jdl.param_freeze_mask(jparams, jc), pdl.param_freeze_mask(pparams, pc)
    jtx = joptim.make_optimizer(joptim.OptimizerConfig(optimizer_8bit=eight_bit, **OPT),
                                trainable_mask=jmask)
    ptx = poptim.make_optimizer(poptim.OptimizerConfig(optimizer_8bit=eight_bit, **OPT),
                                trainable_mask=pmask)
    jstate = jstep.init_train_state(jparams, jtx)
    pstate = pstep.init_train_state(pparams, ptx, device="cpu")
    jfn = jstep.make_train_step(jc, jtx, head_loss_fn=jhead.make_head_loss_fn(jh), remat=True,
                                use_flash=True, trainable_mask=jmask, grad_accum=grad_accum,
                                donate=False, skip_nonfinite=skip_nonfinite)
    pfn = pstep.make_train_step(pc, ptx, head_loss_fn=phead.make_head_loss_fn(ph), remat=True,
                                use_flash=True, trainable_mask=pmask, grad_accum=grad_accum,
                                device="cpu", skip_nonfinite=skip_nonfinite)
    return jstate, pstate, jfn, pfn, pmask


def _draws(rng, grad_accum, batch):
    b = batch["input_ids"].shape[0] // grad_accum
    px = batch["images_dm"].shape[2]
    kw = dict(n_samples=b, latent_shape=(px // 2, px // 2, 4))
    if grad_accum == 1:
        return replay_draws(rng, **kw)
    return [replay_draws(r, **kw) for r in jax.random.split(rng, grad_accum)]


def run_three_train_steps(eight_bit, grad_accum):
    """Loss and grad_norm within 2e-4 relative (float32 sums in another
    order through 2 decoder layers, the UNet and the VAE), trainable
    parameters within 2e-5 absolute after each of three updates at lr 1e-3
    (2% of one step; with 8-bit moments 1 element in 1000 may differ by up
    to one step), frozen parameters identical. 8-bit moments are compared
    dequantized, within 2/127 of their block scale: one code step either
    side where a float32 rounding crosses a code boundary."""
    jstate, pstate, jfn, pfn, pmask = _setup(eight_bit, grad_accum)
    batch = train_batch(px=PX)
    rng = jax.random.PRNGKey(5)
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        jstate, jaux = jfn(jstate, jax_batch(batch), sub)
        pstate, paux = pfn(pstate, port_batch(batch), None, _draws(sub, grad_accum, batch))
        for key in ("loss", "lm_loss", "vm_loss", "grad_norm"):
            np.testing.assert_allclose(float(paux[key]), float(jaux[key]), rtol=2e-4, err_msg=key)
        assert float(paux["update_skipped"]) == float(jaux["update_skipped"]) == 0.0
        for path, p in tree_leaves_with_path(pstate.params):
            want = jax_leaf(jstate.params, path)
            if _port_leaf(pmask, path):
                diff = np.abs(n(p) - want)
                # 8-bit: where a float32 rounding flips one int8 code of a
                # moment, that element's next update moves by a visible part
                # of a step; allow 1 element in 1000 up to one whole step
                share = 1e-3 if eight_bit else 0.0
                assert (diff > 2e-5).mean() <= share and diff.max() <= 1e-3, (
                    path, diff.max(), (diff > 2e-5).mean())
            else:
                np.testing.assert_array_equal(n(p), want, err_msg=str(path))
    assert int(pstate.step) == int(jstate.step) == 3

    # moments: the JAX state carried over by the bridge has the port's
    # structure; compare leaf by leaf
    from dreamllm_tpu_torch.bridge import opt_state_from_jax

    carried = opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state), pstate.opt_state,
                                 params=pstate.params, device="cpu")
    got, want = poptim.adam_state(pstate.opt_state), poptim.adam_state(carried)
    assert int(got["count"]) == int(want["count"]) == 3
    n_moments = 0
    for key, deq in (("m", dequant_moment_m), ("v", dequant_moment_v)):
        for path, leaf in tree_leaves_with_path(got[key]):
            ref = _port_leaf(want[key], path)
            if leaf is None:
                assert ref is None and not _port_leaf(pmask, path)
                continue
            if isinstance(leaf, _Moment):
                n_moments += 1
                shape = _port_leaf(pstate.params, path).shape
                a, b = deq(leaf, shape), deq(ref, shape)
                scale = leaf.scale.repeat_interleave(256)[:a.numel()].reshape(shape)
                tol = scale * (2 / 127) if key == "m" else (scale * (2 / 127)) ** 2 + 2 * (
                    scale * (2 / 127)) * a.sqrt()
                assert bool(((a - b).abs() <= tol + 1e-12).all()), (key, path)
            else:
                # float32 moments: 1e-3 relative, plus 1e-4 of the leaf's
                # largest moment for entries that nearly cancel
                np.testing.assert_allclose(n(leaf), n(ref), rtol=1e-3,
                                           atol=1e-4 * float(ref.abs().max()) + 1e-12,
                                           err_msg=f"{key} {path}")
    assert (n_moments > 0) == eight_bit


def run_nonfinite_skip(eight_bit):
    """A NaN in the batch's CLIP image poisons the gradient: parameters,
    moments and the optimizer's count stay as they were, update_skipped is
    1 and the step counter advances; the next clean step updates again."""
    _, pstate, _, pfn, pmask = _setup(eight_bit, 1)
    batch = port_batch(train_batch(px=PX))
    draws = _draws(jax.random.PRNGKey(1), 1, batch)
    pstate, _ = pfn(pstate, batch, None, draws)  # one clean step: nonzero moments
    before_p = [p.clone() for p in tree_leaves_with_path(pstate.params) for p in [p[1]]]
    adam = poptim.adam_state(pstate.opt_state)
    flat = lambda st: [x.clone() for _, leaf in  # noqa: E731
                       list(tree_leaves_with_path(st["m"])) + list(tree_leaves_with_path(st["v"]))
                       if leaf is not None
                       for x in (leaf if isinstance(leaf, _Moment) else (leaf,))]
    before_m = flat(adam)

    bad = dict(batch)
    bad["images"] = batch["images"].clone()
    bad["images"][0, 0, 0, 0, 0] = float("nan")
    state2, aux = pfn(pstate, bad, None, draws)
    assert float(aux["update_skipped"]) == 1.0
    assert not np.isfinite(float(aux["grad_norm"])) or not np.isfinite(float(aux["loss"]))
    assert int(state2.step) == 2
    adam2 = poptim.adam_state(state2.opt_state)
    assert int(adam2["count"]) == 1
    for a, (_, b) in zip(before_p, tree_leaves_with_path(state2.params)):
        assert torch.equal(a, b)
    for a, b in zip(before_m, flat(adam2)):
        assert torch.equal(a, b)

    state3, aux = pfn(state2, batch, None, draws)
    assert float(aux["update_skipped"]) == 0.0 and int(state3.step) == 3
    assert int(poptim.adam_state(state3.opt_state)["count"]) == 2
    moved = [not torch.equal(a, b) for a, (path, b) in
             zip(before_p, tree_leaves_with_path(state3.params)) if _port_leaf(pmask, path)]
    assert all(moved)
