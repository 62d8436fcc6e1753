"""The port's hyperparameter search (``dreamllm_tpu_torch/train/
hp_search.py``, a numpy-only copy) against the JAX package's: the same seed
draws the same trials, the default space and the objective agree, and the
best run is the same."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import dreamllm_tpu.train.hp_search as jhp
import dreamllm_tpu_torch.train.hp_search as php

SPACE = [("learning_rate", "loguniform", 1e-6, 1e-4, None), ("warmup", "uniform", 0.0, 0.2, None),
         ("epochs", "int", 1, 5, None), ("batch", "categorical", None, None, (4, 8, 16))]


def _space(mod):
    return [mod.HPDim(name, kind, low, high, choices) for name, kind, low, high, choices in SPACE]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_search_draws_the_same_trials_as_jax(seed, direction):
    trials = {"jax": [], "port": []}

    def recorder(key):
        def train_fn(hp):
            trials[key].append(dict(hp))
            return {"eval_loss": (np.log10(hp["learning_rate"]) + 5.0) ** 2 + hp["warmup"],
                    "eval_runtime": 3.0}
        return train_fn

    want = jhp.hyperparameter_search(recorder("jax"), _space(jhp), n_trials=12, seed=seed,
                                     direction=direction)
    got = php.hyperparameter_search(recorder("port"), _space(php), n_trials=12, seed=seed,
                                    direction=direction)
    assert trials["port"] == trials["jax"] and len(trials["port"]) == 12
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_default_space_and_objective_match_jax():
    assert ([dataclasses.asdict(d) for d in php.default_hp_space()]
            == [dataclasses.asdict(d) for d in jhp.default_hp_space()])
    for metrics in ({"eval_loss": 1.5, "epoch": 2},
                    {"eval_loss": 1.5, "acc": 0.8, "f1": 0.6, "eval_runtime": 9.0,
                     "steps_per_second": 3.0}):
        assert (php.default_compute_objective(metrics)
                == jhp.default_compute_objective(metrics))
    with pytest.raises(ValueError):
        php.HPDim("x", "gaussian").sample(np.random.default_rng(0))
