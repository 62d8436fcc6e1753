"""The port's ``data/prefetch.py`` held to the JAX package's cases
(``tests/test_chat_prefetch.py`` ``TestPrefetch``): order, completeness,
fewer items than the depth, errors raised on the consumer's side. On the
CPU (``device="cpu"``) the default transfer is ``.to("cpu")``; the card's
path (pinned memory, a side stream, an event the consumer waits on) runs
in the ``cuda``-marked case and in ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dreamllm_tpu.data.prefetch import background_iterator as jax_background_iterator
from dreamllm_tpu.data.prefetch import device_prefetch as jax_device_prefetch
from dreamllm_tpu_torch.data.prefetch import background_iterator, device_prefetch


@pytest.mark.parametrize("n,size", [(7, 3), (2, 3), (0, 2), (5, 1)],
                         ids=["more-than-size", "fewer-than-size", "empty", "size-1"])
def test_device_prefetch_order_and_completeness(n, size):
    items = [{"x": np.full((2,), i), "nested": [np.arange(3) + i, (np.ones(1) * i,)]}
             for i in range(n)]
    want = list(jax_device_prefetch(iter(items), size=size))
    got = list(device_prefetch(iter(items), size=size, device="cpu"))
    assert len(got) == len(want) == n
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.is_tensor(g["x"]) and g["x"].device.type == "cpu"
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(g["nested"][0].numpy(), np.asarray(w["nested"][0]))
        assert isinstance(g["nested"][1], tuple)
        np.testing.assert_array_equal(g["nested"][1][0].numpy(), [i])


def test_device_prefetch_custom_transfer_and_laziness():
    """A custom transfer is used as given, and at most ``size`` items are
    pulled ahead of the consumer."""
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield i

    it = device_prefetch(source(), size=2, transfer=lambda x: x * 10, device="cpu")
    assert next(it) == 0 and len(pulled) == 3
    assert list(it) == [10, 20, 30, 40, 50]


def test_device_prefetch_propagates_source_errors():
    def gen():
        yield {"x": np.zeros(1)}
        raise RuntimeError("boom")

    for fn, kw in ((jax_device_prefetch, {}), (device_prefetch, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="boom"):
            list(fn(gen(), size=1, **kw))


def test_background_iterator():
    assert list(background_iterator(range(20), maxsize=4)) == list(
        jax_background_iterator(range(20), maxsize=4)) == list(range(20))


def test_background_iterator_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = background_iterator(gen(), maxsize=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_device_prefetch_without_a_card_raises(monkeypatch):
    """The default device is the card; without one the default transfer
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(device_prefetch(iter([np.zeros(1)])))


@pytest.mark.cuda
def test_device_prefetch_on_the_card_equals_a_synchronous_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the side-stream copy runs on the card")
    gen = torch.Generator().manual_seed(0)
    items = [{"x": torch.randn((64, 1024), generator=gen), "ids": torch.arange(i, i + 8)}
             for i in range(6)]
    for got, item in zip(device_prefetch(iter(items), size=2), items):
        y = got["x"] * 2  # consumer-stream work on the prefetched buffer
        assert got["x"].is_cuda and torch.equal(got["x"], item["x"].cuda())
        assert torch.equal(y, item["x"].cuda() * 2) and torch.equal(got["ids"], item["ids"].cuda())
