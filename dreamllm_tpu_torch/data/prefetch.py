"""Host-to-card input pipelining (port of ``dreamllm_tpu/data/prefetch.py``).

``device_prefetch`` keeps ``size`` batches in flight on the card while the
host builds the next ones: the role the reference's ``DataLoader(num_workers,
pin_memory)`` with non-blocking copies plays. Its default transfer copies
from pinned host memory on a side stream, so the copy overlaps the step
that runs on the consumer's stream; the consumer waits on the copy's event
only when it takes the batch. ``background_iterator`` runs a host-side
iterator in a thread.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from dreamllm_tpu_torch.device import resolve_device


def _map_leaves(tree, fn):
    """``fn`` over every tensor leaf (a numpy array becomes a tensor first)
    of a nested dict/list/tuple; other leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return fn(tree) if torch.is_tensor(tree) else tree


class _InFlight:
    """A batch whose copy was enqueued on a side stream, with the event
    recorded after the copy."""

    def __init__(self, item, event: torch.cuda.Event, device: torch.device):
        self.item = item
        self.event = event
        self.device = device

    def ready(self):
        """Make the caller's current stream wait for the copy, and tell the
        allocator that the buffers are used there: without
        ``record_stream`` it could hand their memory to the side stream's
        next copy while the consumer still reads them."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(self.event)

        def mark(t):
            if t.is_cuda:
                t.record_stream(consumer)
            return t

        return _map_leaves(self.item, mark)


def _card_transfer(device="cuda") -> Callable[[Any], Any]:
    """The default transfer of :func:`device_prefetch`: every tensor leaf to
    ``device``. On a CUDA device each leaf is pinned and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    an event recorded after the copy. On the CPU it is ``.to(device)``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda item: _map_leaves(item, lambda t: t.to(dev))
    side = torch.cuda.Stream(dev)

    def move(t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def transfer(item):
        # the copies go to fresh buffers, so the side stream need not wait
        # for the consumer's work: that is the overlap
        with torch.cuda.stream(side):
            out = _map_leaves(item, move)
            event = torch.cuda.Event()
            event.record(side)
        return _InFlight(out, event, dev)

    return transfer


def device_prefetch(
    it: Iterable,
    size: int = 2,
    transfer: Callable[[Any], Any] | None = None,
    device="cuda",
) -> Iterator:
    """Yield the items of ``it`` with ``size`` transfers started ahead.

    ``transfer`` defaults to :func:`_card_transfer` on ``device`` (the card
    unless the caller asks for the CPU); a custom one returns the moved
    item."""
    transfer = transfer or _card_transfer(device)
    it = iter(it)
    buf: collections.deque = collections.deque()
    try:
        for _ in range(size):
            buf.append(transfer(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(transfer(next(it)))
        except StopIteration:
            pass
        yield out.ready() if isinstance(out, _InFlight) else out


def background_iterator(it: Iterable, maxsize: int = 4) -> Iterator:
    """Run the (host-side) iterator in a thread so sample building overlaps
    device compute even when it holds the GIL sparingly (tar decode, numpy)."""
    import queue

    q: queue.Queue = queue.Queue(maxsize=maxsize)
    END = object()
    err: list = []

    def worker():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is END:
            if err:
                raise err[0]
            return
        yield x
