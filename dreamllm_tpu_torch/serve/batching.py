"""Dynamic micro-batching for serving (port of
``dreamllm_tpu/serve/batching.py``).

* ``DynamicBatcher``: a queue and a window dispatcher. Concurrent requests
  collect for up to ``window_ms`` (or until ``max_batch``), run as ONE
  batched call, and each caller gets its own result, or the call's error.
* ``make_batched_generate_fn``: ``generate_text`` at a FIXED batch size and
  prompt length: short batches pad with dummy rows, so every call has the
  same shapes (one compiled program in JAX; on the card, the same kernels
  at the same shapes).
* ``left_truncate_keep_bos``: the one truncation rule of the serving stack
  (the engine's admission and the fixed-shape batcher).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Sequence

import torch

from dreamllm_tpu_torch.device import resolve_device
from dreamllm_tpu_torch.generation.sampler import SamplingConfig, generate_text


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class DynamicBatcher:
    """Collect concurrent ``submit()`` calls into batched ``batch_fn`` calls.

    ``batch_fn(items: list) -> list`` must return one result per item, in
    order. Requests wait at most ``window_ms`` for co-travellers; a full
    ``max_batch`` dispatches immediately.
    """

    def __init__(
        self,
        batch_fn: Callable[[list], list],
        *,
        max_batch: int = 8,
        window_ms: float = 10.0,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._q: queue.Queue[_Pending | None] = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._submit_lock = threading.Lock()  # serializes submit vs stop drain
        # bounded: a long-running server would otherwise grow one entry per
        # dispatch forever
        self.batch_sizes: deque[int] = deque(maxlen=1024)

    def start(self):
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout: float | None = None):
        """Stop accepting work and fail anything not yet dispatched.

        Waits for an in-flight batch_fn to finish unless ``join_timeout``
        bounds it. The drain runs
        AFTER the worker exits (or after the loop observed ``_stopped``), and
        ``submit`` holds ``_submit_lock`` while enqueueing, so no request can
        slip between the stopped check and the drain and be stranded.
        """
        with self._submit_lock:
            self._stopped = True
        self._q.put(None)
        t = self._thread
        if t:
            t.join(timeout=join_timeout)
            if not t.is_alive():
                self._thread = None
        # fail anything still queued visibly — stranding it would block each
        # submitter for its full timeout. The worker no longer consumes (it
        # either exited or will exit on its next loop check before get()).
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.error = RuntimeError("batcher stopped")
                p.event.set()

    def submit(self, item, timeout: float | None = 600.0):
        p = _Pending(item)
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("batched request timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _loop(self):
        while not self._stopped:
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            # window: wait up to window_s for more, cap at max_batch
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self.batch_sizes.append(len(batch))
            try:
                results = self.batch_fn([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for {len(batch)} items"
                    )
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # propagate to every waiter
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()


def left_truncate_keep_bos(ids: list[int], cap: int,
                           bos_token_id: int | None) -> list[int]:
    """Left-truncate an overlong prompt to ``cap`` tokens, keeping BOS at
    position 0 when it is actually present: LLaMA-family models are
    calibrated with it."""
    if len(ids) <= cap:
        return list(ids)
    head = ([ids[0]] if bos_token_id is not None and ids
            and ids[0] == bos_token_id else [])
    return head + list(ids[-(cap - len(head)):])


def make_batched_generate_fn(
    params,
    llm_cfg,
    tokenizer,
    *,
    batch_size: int = 4,
    max_prompt_len: int = 512,
    max_new_tokens: int = 128,
    greedy: bool = True,
    temperature: float = 1.0,
    top_p: float = 1.0,
    eos_token_id: int = 2,
    pad_token_id: int = 0,
    bos_token_id: int | None = 1,
    kv_cache_int8: bool = False,   # halve the KV cache's memory
    device="cuda",
) -> Callable[[list[str]], list[str]]:
    """``fn(prompts) -> texts`` over ``generate_text`` at a fixed shape.

    Takes up to ``batch_size`` prompts a call (more are cut into
    ``batch_size`` chunks: a ``DynamicBatcher`` window may collect more);
    short batches pad with dummy rows (one pad token), so every call decodes
    ``batch_size`` rows of ``max_prompt_len``. Prompts get BOS and are
    left-truncated to ``max_prompt_len``. Call ``n`` samples from a
    generator on ``device`` seeded ``n``; the parameters must be there."""
    dev = resolve_device(device)
    scfg = SamplingConfig(
        greedy=greedy, temperature=temperature, top_p=top_p,
        max_new_tokens=max_new_tokens,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id,
    )
    cache_dtype = torch.int8 if kv_cache_int8 else torch.bfloat16
    counter = [0]

    def fn(prompts: Sequence[str]) -> list[str]:
        if len(prompts) > batch_size:
            out: list[str] = []
            for i in range(0, len(prompts), batch_size):
                out += fn(prompts[i : i + batch_size])
            return out
        n = len(prompts)
        ids = torch.zeros((batch_size, max_prompt_len), dtype=torch.long)
        lens = torch.ones((batch_size,), dtype=torch.int32)  # dummy rows: 1 pad token
        for i, prompt in enumerate(prompts):
            t = tokenizer.encode(prompt)
            if bos_token_id is not None and (not t or t[0] != bos_token_id):
                t = [bos_token_id] + list(t)
            t = left_truncate_keep_bos(t, max_prompt_len, bos_token_id)
            ids[i, : len(t)] = torch.tensor(t)
            lens[i] = len(t)
        counter[0] += 1
        gen = torch.Generator(device=dev).manual_seed(counter[0])
        out = generate_text(params, llm_cfg, ids, lens, scfg, gen, cache_dtype=cache_dtype,
                            device=dev)
        toks, lengths = out["tokens"].cpu(), out["lengths"].cpu()
        return [tokenizer.decode(toks[i, : int(lengths[i])].tolist()).strip()
                for i in range(n)]

    return fn
