"""The port's ``Trainer`` and checkpoints on the CPU: a few joint train
steps with save, resume and ``save_total_limit`` in a temporary directory,
the log window, validation and callbacks, and the checkpoint layout with its
plugin overrides. Port only: the JAX trainer writes orbax checkpoints, which
the port does not read."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import dreamllm_tpu_torch.models.dreamllm as pdl
import dreamllm_tpu_torch.models.sd.head as phead
import dreamllm_tpu_torch.train.checkpoints as pckpt
import dreamllm_tpu_torch.train.optim as poptim
import dreamllm_tpu_torch.train.step as pstep
from dreamllm_tpu_torch.train.optim8bit import _Moment
from dreamllm_tpu_torch.train.trainer import Trainer, TrainerConfig
from dreamllm_tpu_torch.train.tree import tree_leaves_with_path
from tests._torch_port_helpers import port_batch, train_batch, train_cfgs, train_params


def _make(tmp_path, max_steps, **cfg_kw):
    _, pc, _, ph = train_cfgs()
    _, pparams = train_params()
    mask = pdl.param_freeze_mask(pparams, pc)
    tx = poptim.make_optimizer(
        poptim.OptimizerConfig(learning_rate=1e-3, optimizer_8bit=True, min_8bit_size=1024,
                               total_steps=100, eps=1e-5), trainable_mask=mask)
    state = pstep.init_train_state(pparams, tx, device="cpu")
    step_fn = pstep.make_train_step(pc, tx, head_loss_fn=phead.make_head_loss_fn(ph),
                                    trainable_mask=mask, device="cpu")

    class Data:  # a stream whose batches differ, to make a wrong resume position visible
        def __iter__(self):
            i = 0
            while True:
                yield port_batch(train_batch(seed=i, px=32))
                i += 1

    cfg = TrainerConfig(max_steps=max_steps, output_dir=str(tmp_path), **cfg_kw)
    return Trainer(cfg, step_fn, Data(), state,
                   generator=torch.Generator().manual_seed(9), device="cpu")


def _flat(tree):
    """Tensors of a tree in the order of their paths (a resumed parameter
    dict lists its groups in the checkpoint's order)."""
    out = []
    for path, leaf in sorted(tree_leaves_with_path(tree), key=lambda kv: str(kv[0])):
        if isinstance(leaf, _Moment):
            out.extend(leaf)
        elif torch.is_tensor(leaf):
            out.append(leaf)
    return out


def test_trainer_save_resume_prune_and_logs(tmp_path):
    """Four steps straight through against two steps, a fresh Trainer that
    resumes from the checkpoint, and two more. What is restored (parameters,
    8-bit moments, the generator's state, the data position) is bit for
    bit; the two runs' final parameters agree within 2e-5 (2% of one step
    at lr 1e-3), 1 element in 1000 up to one step: the CPU's kernels pick
    code paths by buffer alignment, so the same step on the same state need
    not round alike, and a flipped int8 code moves one element visibly. A
    resume that lost the moments, the generator or the data position would
    differ by whole steps everywhere. ``save_total_limit`` keeps the newest
    checkpoints only."""
    events = []

    class Spy:
        def on_step(self, trainer, step, aux):
            events.append(("step", step))

        def on_log(self, trainer, step, logs):
            events.append(("log", step, logs))

        def on_save(self, trainer, step, path):
            events.append(("save", step))

        def on_validate(self, trainer, step, logs):
            events.append(("val", step, logs))

    straight = _make(tmp_path / "a", 4, save_steps=1, save_total_limit=2, log_steps=2,
                     val_steps=2, tokens_per_batch=80)
    straight.callbacks = [Spy()]
    straight.val_fn = lambda params, step: {"score": 0.5, "image": np.zeros((2, 2))}
    final = straight.train()
    assert int(final.step) == 4
    assert sorted(os.listdir(tmp_path / "a")) == ["checkpoint-000003", "checkpoint-000004"]
    assert [e[1] for e in events if e[0] == "step"] == [1, 2, 3, 4]
    assert [e[1] for e in events if e[0] == "save"] == [1, 2, 3, 4]
    assert [e[1] for e in events if e[0] == "val"] == [2, 4]
    logs = [e for e in events if e[0] == "log"]
    assert [e[1] for e in logs] == [2, 4]
    for key in ("loss", "lm_loss", "vm_loss", "grad_norm", "update_skipped", "steps_per_sec",
                "tokens_per_sec"):
        assert np.isfinite(logs[0][2][key]), key
    assert logs[0][2]["update_skipped"] == 0.0

    first = _make(tmp_path / "b", 2, save_steps=2, log_steps=0)
    first.train()
    ckpt = pckpt.latest_checkpoint(str(tmp_path / "b"))
    assert ckpt.endswith("checkpoint-000002") and pckpt.checkpoint_step(ckpt) == 2
    assert sorted(os.listdir(ckpt)) == [
        "clip_vision_embedding.pt", "dream_embedding.pt", "host_state.json", "llm.pt",
        "meta.json", "opt_state.pt", "sd_head.pt"]
    assert pckpt.load_host_state(ckpt)["data_position"] == 2
    second = _make(tmp_path / "b", 4, save_steps=2, log_steps=0)
    second.maybe_resume()
    assert int(second.state.step) == 2
    for a, b in zip(_flat(first.state.params) + _flat(first.state.opt_state),
                    _flat(second.state.params) + _flat(second.state.opt_state)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert torch.equal(first.generator.get_state(), second.generator.get_state())
    nxt_a, nxt_b = next(first.data_iter), next(second.data_iter)
    assert all(torch.equal(nxt_a[k], nxt_b[k]) for k in nxt_a)
    resumed = _make(tmp_path / "b", 4, save_steps=2, log_steps=0).train()
    assert int(resumed.step) == 4
    for a, b in zip(_flat(final.params), _flat(resumed.params)):
        diff = (a - b).abs()
        assert float((diff > 2e-5).float().mean()) <= 1e-3 and float(diff.max()) <= 1e-3

    # resume=False starts over; save_steps=0 still saves the final step, as JAX does
    fresh = _make(tmp_path / "b", 1, save_steps=0, resume=False, log_steps=0)
    assert int(fresh.train().step) == 1
    assert os.path.exists(os.path.join(tmp_path / "b", "checkpoint-000001", "meta.json"))
    assert pckpt.latest_checkpoint(str(tmp_path / "b")).endswith("checkpoint-000004")


def test_checkpoint_layout_overrides_and_mismatches(tmp_path):
    params = {"llm": {"w": torch.arange(6.0).reshape(2, 3), "layers": [{"n": torch.ones(3)}]},
              "sd_head": {"p": torch.zeros(2, dtype=torch.bfloat16)}}
    opt = [None, {"count": torch.tensor(3, dtype=torch.int32),
                  "m": {"w": _Moment(torch.ones((1, 256), dtype=torch.int8), torch.ones(1))},
                  "v": {"w": None}}]
    a = pckpt.save_checkpoint(str(tmp_path / "a"), 5, params, opt, extra_meta={"note": "x"},
                              host_state={"data_position": 5})
    other = {**params, "sd_head": {"p": torch.ones(2, dtype=torch.bfloat16)}}
    b = pckpt.save_checkpoint(str(tmp_path / "b"), 7, other)
    assert json.load(open(os.path.join(a, "meta.json")))["note"] == "x"
    assert pckpt.load_host_state(b) is None and pckpt.latest_checkpoint(str(tmp_path / "c")) is None
    os.makedirs(tmp_path / "a" / "checkpoint-000009")  # no meta.json: an incomplete save
    assert pckpt.latest_checkpoint(str(tmp_path / "a")) == a

    got = pckpt.load_params(a)
    assert torch.equal(got["llm"]["w"], params["llm"]["w"])
    assert got["sd_head"]["p"].dtype == torch.bfloat16
    like = {"llm": {"w": torch.zeros((2, 3), dtype=torch.float64),
                    "layers": [{"n": torch.zeros(3)}]},
            "sd_head": {"p": torch.zeros(2)}}
    mixed = pckpt.load_params(a, like=like, overrides={"sd_head": b})
    assert mixed["llm"]["w"].dtype == torch.float64 and float(mixed["sd_head"]["p"].sum()) == 2.0
    state = pckpt.load_opt_state(a, like=opt)
    assert isinstance(state[1]["m"]["w"], _Moment) and int(state[1]["count"]) == 3
    assert state[1]["v"]["w"] is None and state[0] is None
    with pytest.raises(ValueError, match="shape"):
        pckpt.load_params(a, like={**like, "llm": {**like["llm"], "w": torch.zeros(3, 2)}})
    with pytest.raises(ValueError, match="keys"):
        pckpt.load_params(a, like={**like, "llm": {"w": like["llm"]["w"]}})
    with pytest.raises(ValueError, match="8-bit moment"):
        pckpt.load_opt_state(a, like=[None, {**opt[1], "v": {"w": opt[1]["m"]["w"]},
                                             "m": {"w": opt[1]["m"]["w"]}}][:1] + [
            {**opt[1], "m": {"w": opt[1]["m"]["w"]}, "v": {"w": opt[1]["m"]["w"]}}])


def test_train_entry_points_raise_without_a_card():
    """``init_train_state``, ``make_train_step`` and ``Trainer`` default to
    ``device="cuda"`` and raise here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, pc, _, _ = train_cfgs()
    tx = poptim.make_optimizer(poptim.OptimizerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pstep.init_train_state({"w": torch.zeros(2)}, tx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pstep.make_train_step(pc, tx)
    state = pstep.init_train_state({"w": torch.zeros(2)}, tx, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig(), lambda *a: None, [], state)
