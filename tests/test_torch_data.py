"""The port's data stream against the JAX package's, bit for bit: the train
entries' ``data_stream`` (DataManager -> DreamLLMBuilder -> collate ->
BatchStream) gives the same batches over the four synthetic datasets, with
packing off and on, and across a ``state_dict``/``load_state_dict`` resume
through ``PrefetchStream``; ``MixedDataset`` routes alike; one webdataset
tar reads alike; the caption filters decide alike."""

from __future__ import annotations

import copy
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from dreamllm_tpu.config import LazyConfig as JaxLazyConfig
from dreamllm_tpu.data import filters as jax_filters
from dreamllm_tpu.data import mixed as jax_mixed
from dreamllm_tpu.data import registry as jax_registry
from dreamllm_tpu.data import stream as jax_stream
from dreamllm_tpu.data import webdataset as jax_wds
from dreamllm_tpu_torch.config import LazyConfig
from dreamllm_tpu_torch.data import filters as port_filters
from dreamllm_tpu_torch.data import mixed as port_mixed
from dreamllm_tpu_torch.data import registry as port_registry
from dreamllm_tpu_torch.data import stream as port_stream
from dreamllm_tpu_torch.data import webdataset as port_wds
from dreamllm_tpu_torch.projects.dreamllm import train as port_train
from projects.dreamllm import train as jax_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "projects/dreamllm/configs/smoke.py")
DATASETS = ["synthetic_pairs", "synthetic_interleaved", "synthetic_instruct",
            "synthetic_conversation"]
N_BATCHES = 4


def _overrides(dataset: str, pack: bool) -> list[str]:
    return [f"data.datasets=['{dataset}']", "data.size_list=[24]", "data.max_images=2",
            "data.max_dreams=2", "data.max_seq_len=192", f"+data.pack={pack}",
            "data.batch_size=3", "seed=3"]


def _streams(dataset: str, pack: bool):
    """(JAX stream, port stream) of the smoke recipe's data section, each
    built by its package's train entry."""
    ovs = _overrides(dataset, pack)
    jcfg = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(SMOKE), ovs)
    pcfg = LazyConfig.apply_overrides(LazyConfig.load(SMOKE), ovs)
    jm, _ = jax_train.build_model_cfg(jcfg)
    pm, _ = port_train.build_model_cfg(pcfg)
    js = jax_train.data_stream(jcfg, jm, jax_train.make_tokenizer(jcfg, jm))
    ps = port_train.data_stream(pcfg, pm, port_train.make_tokenizer(pcfg, pm))
    return js, ps


def _assert_same(jb: dict, pb: dict, where: str):
    assert sorted(jb) == sorted(pb), where
    for k in jb:
        want = np.asarray(jb[k])
        got = pb[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", (where, k)
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (where, k)
        assert np.array_equal(got, want), (where, k)


@pytest.mark.parametrize("pack", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_batches_equal_jax(dataset, pack):
    js, ps = _streams(dataset, pack)
    labels_seen, segments = 0, 0
    for i in range(N_BATCHES):
        jb, pb = next(js), next(ps)
        _assert_same(jb, pb, f"{dataset} pack={pack} batch {i}")
        labels_seen += int((pb["labels"] != -100).sum())
        segments = max(segments, int(pb["segment_ids"].max()))
    assert labels_seen > 0
    assert (segments > 1) == pack  # packing puts several samples into a row


@pytest.mark.parametrize("pack", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_resume_through_prefetch_equals_jax(dataset, pack):
    """Both packages: 2 batches through a ``PrefetchStream``, its state
    saved (JSON round trip, as ``host_state.json`` holds it), a fresh stream
    restored from it, 2 more batches: equal bit for bit, and the resumed
    port stream continues where the uninterrupted one does."""
    results = []
    for mod, make in ((jax_stream, lambda: _streams(dataset, pack)[0]),
                      (port_stream, lambda: _streams(dataset, pack)[1])):
        first = mod.PrefetchStream(make(), depth=2)
        for _ in range(2):
            next(first)
        state = json.loads(json.dumps(first.state_dict()))
        first.close()
        resumed = mod.PrefetchStream(make(), depth=2)
        resumed.load_state_dict(state)
        results.append([next(resumed) for _ in range(2)])
        resumed.close()
    for i, (jb, pb) in enumerate(zip(*results)):
        _assert_same(jb, pb, f"resumed batch {i}")
    if not pack:  # without packing nothing is dropped at the snapshot
        straight = _streams(dataset, pack)[1]
        for _ in range(2):
            next(straight)
        for i, pb in enumerate(results[1]):
            _assert_same({k: v.numpy() for k, v in next(straight).items()}, pb,
                         f"uninterrupted batch {i + 2}")


def test_prefetch_state_protocol_follows_the_inner_stream():
    """``PrefetchStream`` answers ``hasattr(state_dict)`` as its inner stream
    does (the Trainer's protocol check), through ``MappedStream`` too."""
    stateless = port_stream.PrefetchStream(iter(range(5)), depth=2)
    assert not hasattr(stateless, "state_dict") and next(stateless) == 0
    stateless.close()
    _, ps = _streams("synthetic_pairs", False)
    mapped = port_stream.MappedStream(ps, lambda b: b)
    stateful = port_stream.PrefetchStream(mapped, depth=2)
    assert hasattr(mapped, "state_dict") and hasattr(stateful, "load_state_dict")
    assert stateful.state_dict()["cursor"] == 0
    next(stateful)
    assert stateful.state_dict()["cursor"] == 3  # one batch of 3 delivered
    stateful.close()


def test_mixed_dataset_routing_matches_jax():
    parts = [[f"a{i}" for i in range(3)], [f"b{i}" for i in range(5)], ["c0"]]
    sizes = [4, 7, 2]
    j, p = jax_mixed.MixedDataset(parts, sizes), port_mixed.MixedDataset(parts, sizes)
    assert len(j) == len(p) == 13
    assert [p[i] for i in range(13)] == [j[i] for i in range(13)]
    for bad in (-1, 13):
        with pytest.raises(IndexError):
            p[bad]


@pytest.mark.parametrize("kw", [dict(size_list=[5, 9]), dict(ratios=[0.25, 0.75], total_size=40)])
def test_data_manager_matches_jax(kw):
    names = ["synthetic_pairs", "synthetic_interleaved"]
    j = jax_registry.DataManager()(names, **kw)
    p = port_registry.DataManager()(names, **kw)
    assert j.sizes == p.sizes and len(j) == len(p)
    for i in (0, len(p) // 2, len(p) - 1):
        a, b = j[i], p[i]
        assert type(a).__name__ == type(b).__name__
        assert repr(getattr(a, "text", None)) == repr(getattr(b, "text", None))


def _write_tar(path: str) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    caps = ["a red bird on a branch", "visit www.example.com now", "café au lait",
            "", "two dogs playing", "a photo of a nude statue"]
    with tarfile.open(path, "w") as tf:
        for i, cap in enumerate(caps):
            img = (rng.random((12 + i, 10, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG" if i % 2 else "JPEG")
            entries = [("png" if i % 2 else "jpg", buf.getvalue()), ("txt", cap.encode()),
                       ("json", json.dumps({"k": i}).encode())]
            for ext, data in entries:
                ti = tarfile.TarInfo(f"{i:05d}.{ext}")
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))


def _canon(sample: dict) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in sample.items()}


def test_webdataset_tar_reads_like_jax(tmp_path):
    path = str(tmp_path / "shard-000000.tar")
    _write_tar(path)
    assert ([dict(g) for g in port_wds.group_tar_entries(path)]
            == [dict(g) for g in jax_wds.group_tar_entries(path)])
    outs = []
    for wds, flt in ((jax_wds, jax_filters), (port_wds, port_filters)):
        stream = wds.ShardStream([path], shuffle_buffer=3, seed=7, resample=False,
                                 filters=flt.quality_filters(min_side=9))
        outs.append([_canon(s) for s in stream])
    assert outs[0] == outs[1]
    assert sorted(s["txt"] for s in outs[1]) == [
        "a photo of a nude statue", "a red bird on a branch", "two dogs playing"]
    assert all(np.asarray(s["image"]).ndim == 3 for s in outs[1])


FILTER_SAMPLES = [
    {"txt": "a red bird", "image": np.zeros((8, 9, 3))},
    {"txt": "  ", "image": np.zeros((8, 9, 3))},
    {"txt": "no image"},
    {"txt": "see https://x.org/a", "image": np.zeros((8, 9, 3))},
    {"txt": "naïve caption", "image": np.zeros((8, 9, 3))},
    {"txt": "a stock photo of a lake", "image": np.zeros((8, 9, 3))},
    {"txt": "tiny", "image": np.zeros((3, 40, 3))},
]


@pytest.mark.parametrize("name", ["has_caption_and_image", "english_only", "no_urls",
                                  "caption_blacklist", "min_image_size", "quality_filters"])
def test_caption_filters_match_jax(name):
    def decisions(mod):
        if name == "caption_blacklist":
            fs = [mod.caption_blacklist()]
        elif name == "min_image_size":
            fs = [mod.min_image_size(4)]
        elif name == "quality_filters":
            fs = mod.quality_filters(min_side=4)
        else:
            fs = [getattr(mod, name)]
        return [all(f(copy.copy(s)) for f in fs) for s in FILTER_SAMPLES]

    got, want = decisions(port_filters), decisions(jax_filters)
    assert got == want and any(got) and not all(got)
