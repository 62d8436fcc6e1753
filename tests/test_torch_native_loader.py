"""The port's ``data/native_loader.py`` against the JAX package's: the same
tar shards (JPEGs written with PIL, one corrupt member, as
``tests/test_native_loader.py`` writes them) through both loaders give the
same ``(image, caption)`` stream bit for bit and the same ``decoded`` /
``failed`` stats. The two builds compile one source (``native/dataplane.cpp``)
with one command line, so their decodes agree exactly. The port's library
is built under ``build/native/``, never beside the source."""

from __future__ import annotations

import io
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

import dreamllm_tpu.data.native_loader as jnl
import dreamllm_tpu_torch.data.native_loader as pnl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_shard(path, n=8, size=64, corrupt_index=None, seed=0):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            arr = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=95)
            data = buf.getvalue()
            if corrupt_index == i:
                data = b"\x00" * len(data)  # not a jpeg at all
            ti = tarfile.TarInfo(f"{seed}-{i:05d}.jpg")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
            cap = f"shard {seed} caption number {i}".encode()
            ti = tarfile.TarInfo(f"{seed}-{i:05d}.txt")
            ti.size = len(cap)
            tf.addfile(ti, io.BytesIO(cap))


@pytest.fixture(scope="module")
def built():
    try:
        jnl._ensure_built()
        lib = pnl._ensure_built()
    except (jnl.NativeLoaderUnavailable, pnl.NativeLoaderUnavailable) as e:
        pytest.skip(f"native loader unavailable: {e}")
    return lib


def test_builds_under_build_native(built):
    assert built == os.path.join(ROOT, "build", "native", "libdataplane.so")
    assert os.path.exists(built)
    assert pnl._ensure_built() == built  # fresh: no rebuild


def _both(paths, **kw):
    out = []
    for mod in (jnl, pnl):
        loader = mod.NativeImageTextLoader(paths, **kw)
        stream = list(loader)
        out.append((stream, loader.stats))
    return out


def _equal_streams(a, b):
    assert len(a) == len(b)
    for (ia, ta), (ib, tb) in zip(a, b):
        assert ta == tb and ia.dtype == ib.dtype == np.uint8 and np.array_equal(ia, ib)


@pytest.mark.parametrize("image_size", [64, 48])
def test_one_thread_streams_equal_bit_for_bit(tmp_path, built, image_size):
    """One worker thread: shard and member order, so the two streams are
    equal item by item; 48 px resizes the 64 px JPEGs."""
    paths = []
    for k in range(2):
        paths.append(str(tmp_path / f"s{k}.tar"))
        make_shard(paths[-1], n=5, size=64, corrupt_index=2 if k == 1 else None, seed=k)
    (jax_stream, jax_stats), (port_stream, port_stats) = _both(
        paths, image_size=image_size, n_threads=1)
    _equal_streams(port_stream, jax_stream)
    assert port_stats == jax_stats == {"decoded": 9, "failed": 1}
    assert len(port_stream) == 9


def test_many_threads_same_multiset(tmp_path, built):
    """Four threads over four shards: the order depends on the threads, the
    items and stats do not."""
    paths = []
    for k in range(4):
        paths.append(str(tmp_path / f"m{k}.tar"))
        make_shard(paths[-1], n=6, size=48, corrupt_index=k if k % 2 else None, seed=10 + k)
    (jax_stream, jax_stats), (port_stream, port_stats) = _both(
        paths, image_size=48, n_threads=4)
    _equal_streams(sorted(port_stream, key=lambda x: x[1]), sorted(jax_stream, key=lambda x: x[1]))
    assert port_stats == jax_stats == {"decoded": 22, "failed": 2}


def test_unavailable_where_jax_raises(tmp_path, monkeypatch):
    """``NativeLoaderUnavailable`` where the JAX package raises it: a missing
    source and a failing compiler."""
    for mod in (jnl, pnl):
        monkeypatch.setattr(mod, "_SRC", str(tmp_path / "missing.cpp"))
        monkeypatch.setattr(mod, "_LIB", str(tmp_path / "none" / "lib.so"))
        with pytest.raises(mod.NativeLoaderUnavailable, match="missing source"):
            mod._ensure_built()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnl, "_SRC", str(bad))
    monkeypatch.setattr(pnl, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(pnl, "_LIB", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(pnl.NativeLoaderUnavailable, match="build failed"):
        pnl._ensure_built()
    assert not os.path.exists(tmp_path / "build" / "lib.so")


def test_empty_shard_list_raises(built):
    with pytest.raises(ValueError, match="empty shard list"):
        pnl.NativeImageTextLoader([])
