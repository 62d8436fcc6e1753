"""Training loop: step, log, validate and save around the train step (port
of ``dreamllm_tpu/train/trainer.py``):

* the step loop; non-finite losses are filtered INSIDE the step
  (``make_train_step`` ``skip_nonfinite``) and reported in
  ``aux["update_skipped"]``;
* a scalar log window whose device scalars are fetched once per
  ``log_steps``, never per step;
* tokens/sec and steps/sec;
* ``val_steps``-gated validation through a user ``val_fn``;
* a checkpoint every ``save_steps`` in the LLM-versus-plugin split layout,
  and one at the end whenever the run took a step (whatever ``save_steps``
  is, as in JAX); auto-resume from the latest one, ``save_total_limit``
  pruning;
* callbacks: ``on_step``/``on_log``/``on_save``/``on_validate``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
import time
from typing import Any, Callable, Iterable

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.train.checkpoints import (
    checkpoint_step,
    latest_checkpoint,
    load_host_state,
    load_opt_state,
    load_params,
    save_checkpoint,
)
from dreamllm_tpu_torch.train.step import TrainState
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    log_steps: int = 10
    save_steps: int = 500       # 0 disables the periodic ones; the final one is always saved
    val_steps: int = 0          # 0 disables mid-training validation
    output_dir: str = "./runs/train"
    resume: bool = True
    tokens_per_batch: int | None = None  # for tokens/sec reporting
    # keep at most N checkpoints, the oldest deleted after each save. None = all.
    save_total_limit: int | None = None


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        step_fn: Callable,                 # (state, batch, generator) -> (state, aux)
        data_iter: Iterable,               # yields batches on the step's device
        state: TrainState,
        *,
        generator: torch.Generator | None = None,
        val_fn: Callable[[Any, int], dict] | None = None,  # (params, step) -> logs
        callbacks: list | None = None,
        device="cuda",
    ):
        """``device`` is where ``state`` lives and the step runs (it raises
        without a card unless ``device="cpu"``); ``generator``, the stream of
        the step's random draws, defaults to a generator on it seeded 0."""
        self.device = resolve_device(device)
        if state.step.device.type != self.device.type:
            raise ValueError(f"Trainer on {self.device}, state is on {state.step.device}")
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_source = data_iter   # kept for the resumable-stream protocol
        self.data_iter = iter(data_iter)
        self.state = state
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.val_fn = val_fn
        self.callbacks = callbacks or []
        self.log_buffer: list[dict] = []
        self._last_saved = -1

    def _fire(self, hook: str, **kw):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(trainer=self, **kw)

    def maybe_resume(self):
        if not self.cfg.resume:
            return
        path = latest_checkpoint(self.cfg.output_dir)
        if path is None:
            return
        logger.info("resuming from %s", path)
        params = load_params(path, like=self.state.params)
        opt_state = load_opt_state(path, like=self.state.opt_state)
        self.state = TrainState(
            step=torch.tensor(checkpoint_step(path), dtype=torch.int32, device=self.device),
            params=params, opt_state=opt_state,
        )
        # host-side state: the generator and the data-stream position.
        # Without it a resumed run replays data from the start of the stream
        # with a fresh generator: silent sample repetition.
        hs = load_host_state(path)
        if hs is None:
            logger.warning("checkpoint has no host_state.json: resuming parameters only "
                           "(the data stream restarts; samples may repeat)")
            return
        if "generator" in hs:
            self.generator.set_state(torch.tensor(hs["generator"], dtype=torch.uint8))
        if "data_state" in hs and hasattr(self.data_source, "load_state_dict"):
            self.data_source.load_state_dict(hs["data_state"])
            self.data_iter = iter(self.data_source)
            logger.info("restored data stream state")
        elif hs.get("data_position"):
            n = int(hs["data_position"])
            logger.info("skipping %d consumed batches to restore data position", n)
            for _ in range(n):
                next(self.data_iter)

    def save(self, step: int):
        if step == self._last_saved:
            return
        host_state: dict = {
            "generator": self.generator.get_state().tolist(),
            "data_position": step,
        }
        if hasattr(self.data_source, "state_dict"):
            host_state["data_state"] = self.data_source.state_dict()
        path = save_checkpoint(self.cfg.output_dir, step, self.state.params,
                               self.state.opt_state, host_state=host_state)
        self._last_saved = step
        logger.info("saved %s", path)
        self._prune_checkpoints()
        self._fire("on_save", step=step, path=path)

    def _prune_checkpoints(self):
        """Delete the oldest ``checkpoint-*`` directories past
        ``save_total_limit`` (applied after each save, newest kept)."""
        limit = self.cfg.save_total_limit
        if not limit:
            return
        root = self.cfg.output_dir
        steps = sorted(int(m.group(1)) for name in os.listdir(root)
                       if (m := re.fullmatch(r"checkpoint-(\d+)", name)))
        for s in steps[:-limit]:
            victim = os.path.join(root, f"checkpoint-{s:06d}")
            shutil.rmtree(victim, ignore_errors=True)
            logger.info("pruned %s (save_total_limit=%d)", victim, limit)

    def _flush_logs(self, cur: int, dt: float) -> dict:
        keys = list(self.log_buffer[0])
        # one host sync for the whole window
        table = torch.stack([torch.stack([b[k].float().reshape(()) for k in keys])
                             for b in self.log_buffer]).cpu().tolist()

        def window_mean(i):
            # a skipped step leaves a NaN loss in the buffer by design: keep
            # it out of the window's mean instead of poisoning the log
            finite = [row[i] for row in table if math.isfinite(row[i])]
            return sum(finite) / len(finite) if finite else float("nan")

        n = len(table)
        logs = {k: window_mean(i) for i, k in enumerate(keys)}
        logs["steps_per_sec"] = n / dt  # n, not log_steps: a window after a resume may be short
        if self.cfg.tokens_per_batch:
            logs["tokens_per_sec"] = self.cfg.tokens_per_batch * n / dt
        self.log_buffer.clear()
        skipped = logs.get("update_skipped", 0.0)
        if skipped:
            logger.warning("%d/%d updates skipped on non-finite loss in this window",
                           int(round(skipped * n)), n)
        logger.info("step %d: %s", cur, {k: round(v, 5) for k, v in logs.items()})
        return logs

    def train(self) -> TrainState:
        self.maybe_resume()
        start_step = int(self.state.step)
        t_last = time.perf_counter()
        for step in range(start_step, self.cfg.max_steps):
            batch = next(self.data_iter)
            self.state, aux = self.step_fn(self.state, batch, self.generator)
            self.log_buffer.append(aux)  # device scalars; fetched at log time
            self._fire("on_step", step=step + 1, aux=aux)

            cur = step + 1
            if self.cfg.log_steps and cur % self.cfg.log_steps == 0:
                logs = self._flush_logs(cur, time.perf_counter() - t_last)
                t_last = time.perf_counter()
                self._fire("on_log", step=cur, logs=logs)

            if self.cfg.val_steps and cur % self.cfg.val_steps == 0 and self.val_fn:
                val_logs = self.val_fn(self.state.params, cur)
                scalars = {k: round(float(v), 5) for k, v in val_logs.items()
                           if not hasattr(v, "ndim") or v.ndim == 0}
                arrays = [k for k in val_logs if k not in scalars]
                logger.info("validation @%d: %s arrays=%s", cur, scalars, arrays)
                self._fire("on_validate", step=cur, logs=val_logs)

            if self.cfg.save_steps and cur % self.cfg.save_steps == 0:
                self.save(cur)

        if int(self.state.step) > start_step:
            self.save(int(self.state.step))
        return self.state
