"""Hyperparameter search (a copy of ``dreamllm_tpu/train/hp_search.py``,
which uses numpy only; the port imports nothing of that package).

The space is a declarative object sampled with numpy (random search), with
an optuna adapter when optuna happens to be installed. Trials re-enter the
caller's train function with overridden config values. The same seed gives
the same trials as the JAX package's copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HPDim:
    """One search dimension."""

    name: str
    kind: str                      # "loguniform" | "uniform" | "int" | "categorical"
    low: float | None = None
    high: float | None = None
    choices: Sequence[Any] | None = None

    def sample(self, rng: np.random.Generator):
        if self.kind == "loguniform":
            return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))
        if self.kind == "uniform":
            return float(rng.uniform(self.low, self.high))
        if self.kind == "int":
            return int(rng.integers(int(self.low), int(self.high) + 1))
        if self.kind == "categorical":
            return self.choices[int(rng.integers(0, len(self.choices)))]
        raise ValueError(self.kind)


def default_hp_space() -> list[HPDim]:
    """The reference's default space (trainer_utils.py:268-276): lr log-uniform
    1e-6..1e-4, epochs 1..5, seed 1..40, per-device batch in {4,...,64}."""
    return [
        HPDim("learning_rate", "loguniform", 1e-6, 1e-4),
        HPDim("num_train_epochs", "int", 1, 5),
        HPDim("seed", "int", 1, 40),
        HPDim("per_device_train_batch_size", "categorical", choices=(4, 8, 16, 32, 64)),
    ]


def default_compute_objective(metrics: dict[str, float]) -> float:
    """eval_loss when that's all there is, else the sum of the non-speed
    metrics (trainer_utils.py:245-265)."""
    metrics = dict(metrics)
    loss = metrics.pop("eval_loss", None)
    metrics.pop("epoch", None)
    for k in [m for m in metrics if m.endswith(("_runtime", "_per_second", "_compilation_time"))]:
        metrics.pop(k)
    return loss if not metrics else sum(metrics.values())


@dataclasses.dataclass
class BestRun:
    """trainer_utils.py:229-243."""

    run_id: str
    objective: float
    hyperparameters: dict[str, Any]


def hyperparameter_search(
    train_fn: Callable[[dict[str, Any]], dict[str, float]],
    space: Sequence[HPDim] | None = None,
    *,
    n_trials: int = 20,
    direction: str = "minimize",
    seed: int = 0,
    compute_objective: Callable[[dict[str, float]], float] = default_compute_objective,
    backend: str = "random",
) -> BestRun:
    """Run ``n_trials`` of ``train_fn(hparams) -> metrics`` and return the best.

    ``backend="optuna"`` uses optuna's TPE sampler when the package exists
    (the reference's primary backend); ``"random"`` needs nothing.
    """
    space = list(space) if space is not None else default_hp_space()
    sign = -1.0 if direction == "maximize" else 1.0

    if backend == "optuna":
        try:
            import optuna  # noqa: F401
        except ImportError:
            backend = "random"  # graceful degrade, matching is_*_available gates

    if backend == "optuna":
        import optuna

        def objective(trial):
            hp = {}
            for d in space:
                if d.kind == "loguniform":
                    hp[d.name] = trial.suggest_float(d.name, d.low, d.high, log=True)
                elif d.kind == "uniform":
                    hp[d.name] = trial.suggest_float(d.name, d.low, d.high)
                elif d.kind == "int":
                    hp[d.name] = trial.suggest_int(d.name, int(d.low), int(d.high))
                else:
                    hp[d.name] = trial.suggest_categorical(d.name, list(d.choices))
            return sign * compute_objective(train_fn(hp))

        study = optuna.create_study(direction="minimize")
        study.optimize(objective, n_trials=n_trials)
        return BestRun(str(study.best_trial.number), sign * study.best_value,
                       study.best_trial.params)

    rng = np.random.default_rng(seed)
    best: BestRun | None = None
    for t in range(n_trials):
        hp = {d.name: d.sample(rng) for d in space}
        obj = compute_objective(train_fn(hp))
        if best is None or sign * obj < sign * best.objective:
            best = BestRun(str(t), obj, hp)
    return best
