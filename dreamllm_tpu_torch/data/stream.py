"""Stateful, resumable batch streams.

The reference restores a preempted run's data position by replaying the
dataloader (``skip_first_batches`` + RNG reload, omni/train/trainer.py:698-757)
— O(steps) host work on every resume. Here the stream itself is a small state
machine: ``state_dict()`` captures the sample cursor and the builder's RNG
bit-generator state, so ``load_state_dict()`` resumes in O(1) and the sample
sequence continues exactly where it stopped.

``train.Trainer`` persists this state into the checkpoint's host_state.json
whenever the stream it was given exposes the protocol (otherwise it falls back
to batch-replay via ``data_position``).

Packing caveat: with ``pack=True`` up to ``batch_size - 1`` leftover packed
rows may be pending when a checkpoint is taken; they are built from samples
already consumed from the cursor, so an O(1)-resumable snapshot cannot keep
them without serializing image tensors into the checkpoint. We drop them on
restore (bounded, logged) — samples are *skipped*, never repeated.

A copy of ``dreamllm_tpu/data/stream.py`` with its imports pointed at the port."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from dreamllm_tpu_torch.data.collator import collate, collate_packed, pack_samples
from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.data.stream")


class BatchStream:
    """Infinite batch iterator over an indexable sample source.

    source        — ``len()`` + ``[]`` (a MixedDataset); iterated modulo.
    builder       — DreamLLMBuilder (``build(sample) -> BuiltSample``; its
                    ``rng`` is part of the resumable state).
    collate_kw    — kwargs for :func:`collate` / :func:`collate_packed`.
    pack          — first-fit pack ``pack_block``× samples into seq_len rows.
    """

    # consecutive per-sample failures before giving up: a systematic fault
    # (wrong schema, dead decoder) must surface as an error, not an infinite
    # warn loop (reference consecutive_failures breakers,
    # unified_it_pair_webdataset.py:112-140)
    max_consecutive_failures: int = 100

    def __init__(self, source, builder, batch_size: int, collate_kw: dict,
                 *, pack: bool = False, pack_block: int = 4,
                 image_embed_len: int | None = None,
                 n_dream_queries: int | None = None):
        self.source = source
        self.builder = builder
        self.batch_size = batch_size
        self.collate_kw = dict(collate_kw)
        self.pack = pack
        self.pack_block = pack_block
        # single source of truth: span-footprint checks in pack_samples must
        # agree with collate's, so default both from collate_kw
        self.image_embed_len = (
            image_embed_len if image_embed_len is not None
            else self.collate_kw.get("image_embed_len", 256))
        self.n_dream_queries = (
            n_dream_queries if n_dream_queries is not None
            else self.collate_kw.get("n_dream_queries", 64))
        self._i = 0
        self._pending: list = []  # packed rows awaiting batching

    def __iter__(self):
        return self

    def _build(self, want: int) -> list:
        out = []
        n = len(self.source)
        failures = 0
        while len(out) < want:
            try:
                out.append(self.builder.build(self.source[self._i % n]))
                failures = 0
            except Exception as e:  # per-sample fault tolerance
                failures += 1
                logger.warning("sample %d failed: %s", self._i, e)
                if failures >= self.max_consecutive_failures:
                    raise RuntimeError(
                        f"{failures} consecutive sample failures — the data "
                        "source or builder config is broken (last error: "
                        f"{e!r})") from e
            finally:
                self._i += 1
        return out

    def __next__(self) -> dict:
        bs = self.batch_size
        if not self.pack:
            return collate(self._build(bs), **self.collate_kw)
        while len(self._pending) < bs:
            self._pending.extend(pack_samples(
                self._build(bs * self.pack_block),
                self.collate_kw["seq_len"],
                image_embed_len=self.image_embed_len,
                n_dream_queries=self.n_dream_queries,
            ))
        rows, self._pending[:] = self._pending[:bs], self._pending[bs:]
        return collate_packed(rows, **self.collate_kw)

    # ---- resumable-stream protocol (consumed by train.Trainer) ----

    def state_dict(self) -> dict:
        return {
            "cursor": self._i,
            "builder_rng": self.builder.rng.bit_generator.state,
            "pending_rows": len(self._pending),
        }

    def load_state_dict(self, state: dict) -> None:
        self._i = int(state["cursor"])
        self.builder.rng.bit_generator.state = state["builder_rng"]
        if state.get("pending_rows"):
            logger.info(
                "resume drops %d pending packed rows (samples skipped, not "
                "repeated)", state["pending_rows"])
        self._pending = []


class MappedStream:
    """Apply ``fn`` per batch while forwarding the resumable-stream protocol
    (so the wrappers that move a batch to the card don't hide state_dict from the
    Trainer)."""

    def __init__(self, stream, fn: Callable[[Any], Any]):
        self.stream = stream
        self.fn = fn

    def __iter__(self):
        return self

    def __next__(self):
        return self.fn(next(self.stream))

    def __getattr__(self, name):
        # forwards state_dict/load_state_dict when (and only when) the
        # wrapped stream has them — hasattr() on the wrapper then answers
        # truthfully, which is what Trainer's protocol check relies on
        return getattr(self.stream, name)


class PrefetchStream:
    """Background-thread prefetch: overlap host batch building (tokenize /
    pack / collate — expensive on a single-core host) with device compute.

    The producer thread pulls from the wrapped stream into a bounded buffer
    of ``depth`` batches; ``__next__`` pops. With a stateful inner stream the
    resumable protocol stays EXACT: the producer snapshots the inner state
    *after* building each batch and the pair travels through the buffer, so
    ``state_dict()`` always describes the position right after the most
    recently *delivered* batch — buffered-but-undelivered batches are
    rebuilt after a resume, never skipped.
    """

    def __init__(self, stream, depth: int = 2):
        import queue
        import threading

        self.stream = stream
        self.depth = max(1, int(depth))
        self._queue_cls = queue
        self._threading = threading
        self._stateful = hasattr(stream, "state_dict")
        self._last_state = stream.state_dict() if self._stateful else None
        self._buf: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def _ensure_started(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = self._threading.Thread(target=self._produce, daemon=True)
            self._thread.start()

    def _put_interruptible(self, pair) -> None:
        # bounded put, interruptible so close()/load_state_dict() can stop a
        # producer blocked on a full buffer; ALL puts (including the end/err
        # sentinels) go through here — a blocking sentinel put would deadlock
        # _halt's join and could land stale in a post-resume buffer
        while not self._stop.is_set():
            try:
                self._buf.put(pair, timeout=0.1)
                return
            except self._queue_cls.Full:
                continue

    def _produce(self):
        while not self._stop.is_set():
            try:
                item = next(self.stream)
            except StopIteration:
                self._put_interruptible(("__end__", None))
                return
            except Exception as e:  # surface in the consumer, not the thread
                self._put_interruptible(("__err__", e))
                return
            state = self.stream.state_dict() if self._stateful else None
            self._put_interruptible((item, state))

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_started()
        item, state = self._buf.get()
        if isinstance(item, str) and item == "__end__":
            raise StopIteration
        if isinstance(item, str) and item == "__err__":
            raise state
        if self._stateful:
            self._last_state = state
        return item

    def _halt(self):
        """Stop the producer and WAIT for it to exit before touching shared
        state. Proceeding after a timed-out join would leave a zombie thread
        advancing the inner stream underneath load_state_dict's rewind (and a
        restart would then run two producers on one stream) — so the join is
        unconditional; only a warning is emitted if it runs long (one batch
        build on a slow host)."""
        self._stop.set()
        t = self._thread
        waited = 0.0
        while t is not None and t.is_alive():
            t.join(timeout=5)
            if t.is_alive():
                waited += 5
                logger.warning(
                    "prefetch producer still finishing its in-flight batch "
                    "(%.0fs) — waiting for a clean stop", waited)
        self._thread = None
        while True:
            try:
                self._buf.get_nowait()
            except self._queue_cls.Empty:
                break

    def close(self):
        self._halt()

    # resumable-stream protocol — exposed through __getattr__ so that
    # hasattr() is False when the inner stream is stateless (a class-level
    # def would make hasattr True and then blow up inside Trainer.save)
    def _state_dict(self) -> dict:
        return self._last_state

    def _load_state_dict(self, state: dict) -> None:
        self._halt()  # producer is strictly ahead; discard its lookahead
        self.stream.load_state_dict(state)
        self._last_state = self.stream.state_dict()

    def __getattr__(self, name):
        if name == "state_dict" and self.__dict__.get("_stateful"):
            return self._state_dict
        if name == "load_state_dict" and self.__dict__.get("_stateful"):
            return self._load_state_dict
        raise AttributeError(name)
