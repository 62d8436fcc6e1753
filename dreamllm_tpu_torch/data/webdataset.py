"""Webdataset-style tar-shard streaming — self-contained replacement for the
reference's vendored webdataset library (third_party/webdataset, 7.9k LoC)
covering the subset the pipelines use (SURVEY §2.6): resampled shard
iteration → tar entry grouping → shuffle buffer → decode → filter, with
warn-and-continue fault tolerance (unified_it_pair_webdataset.py:95-140).

Pure python/tarfile on the host; heavy image work happens on device.

A copy of ``dreamllm_tpu/data/webdataset.py`` with its imports pointed at the port."""

from __future__ import annotations

import io
import json
import logging
import random
import tarfile
from typing import Any, Callable, Iterable, Iterator, Sequence

logger = logging.getLogger("dreamllm_tpu_torch.data")

# bound at import: the except clause below must not look up module globals
# (they are already None when a live stream generator is finalized at
# interpreter shutdown)
_SHARD_ERRORS = (tarfile.TarError, OSError)


class _PipeStream:
    """Reader over a ``pipe:`` subprocess that surfaces the child's exit
    status: a transfer command dying mid-stream (e.g. ``aws s3 cp`` exit 1
    after a whole number of tar members) otherwise looks like clean EOF and
    the truncated shard would be silently treated as complete."""

    def __init__(self, proc, url: str):
        self._proc = proc
        self._url = url
        self._raw = proc.stdout
        self._checked = False

    def read(self, n: int = -1) -> bytes:
        data = self._raw.read(n)
        if not data:  # EOF — now the exit status is meaningful
            self._check()
        return data

    def _check(self) -> None:
        if self._checked:
            return
        self._checked = True
        rc = self._proc.wait(timeout=30)
        if rc != 0:
            raise OSError(f"{self._url!r} exited with status {rc} — stream truncated")

    def readable(self) -> bool:  # tarfile/BufferedReader protocol
        return True

    def close(self) -> None:
        try:
            self._raw.close()
        finally:
            if not self._checked:
                self._checked = True
                if self._proc.poll() is None:
                    self._proc.terminate()
                try:
                    self._proc.wait(timeout=10)
                except Exception:  # noqa: BLE001
                    self._proc.kill()
                    self._proc.wait()


def open_stream(url: str, timeout: float = 120.0):
    """gopen equivalent (reference third_party/webdataset gopen + megfile
    smart_open): open a shard URL as a streaming binary file object.

    Schemes:
      * plain path / ``file://`` — local file
      * ``http://`` / ``https://`` — streamed over urllib (no full download)
      * ``pipe:CMD`` — stdout of a shell command (the wds convention; covers
        any object store with a CLI, e.g. ``pipe:aws s3 cp s3://b/k -`` or
        ``pipe:gsutil cat gs://b/k``)
      * ``s3://`` / ``gs://`` — convenience rewrite onto the pipe form
    """
    if url.startswith("file://"):
        return open(url[len("file://"):], "rb")
    if url.startswith(("http://", "https://")):
        import urllib.request

        return urllib.request.urlopen(url, timeout=timeout)
    if url.startswith("pipe:"):
        import subprocess

        proc = subprocess.Popen(
            url[len("pipe:"):], shell=True, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        return _PipeStream(proc, url)
    if url.startswith("s3://"):
        return open_stream(f"pipe:aws s3 cp {url} -", timeout)
    if url.startswith("gs://"):
        return open_stream(f"pipe:gsutil cat {url}", timeout)
    return open(url, "rb")


def group_tar_entries(path: str) -> Iterator[dict[str, bytes]]:
    """Yield {"__key__": str, "<ext>": bytes, ...} groups from one tar shard
    (entries grouped by basename before the first dot, wds convention).
    ``path`` may be any :func:`open_stream` URL — tar reading is fully
    streaming (``r|*``), so remote shards never hit local disk."""
    stream = open_stream(path)
    try:
        with tarfile.open(fileobj=stream, mode="r|*") as tf:  # streaming mode
            current_key = None
            sample: dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                base = name.rsplit("/", 1)[1] if "/" in name else name
                if "." not in base:
                    continue
                stem, ext = base.split(".", 1)
                # the grouping key keeps the DIRECTORY (wds keys are full
                # paths): same-basename files under different dirs must not
                # collide into one corrupted sample
                prefix = name[: len(name) - len(base)]
                key = prefix + stem
                if key != current_key:
                    if sample:
                        yield sample
                    current_key = key
                    sample = {"__key__": key}
                f = tf.extractfile(member)
                if f is not None:
                    sample[ext.lower()] = f.read()
            if sample:
                yield sample
    finally:
        try:
            stream.close()
        except Exception:
            pass


def default_decoder(sample: dict[str, Any]) -> dict[str, Any]:
    """Decode common extensions: images → RGB numpy HWC uint8, json/txt."""
    out = {"__key__": sample.get("__key__", "")}
    for ext, data in sample.items():
        if ext == "__key__":
            continue
        # match on the LAST suffix: multi-dot entries like 'image_00.jpg'
        # (interleaved shards) must decode as images, not stay raw bytes
        kind = ext.rsplit(".", 1)[-1]
        if kind in ("jpg", "jpeg", "png", "webp"):
            from PIL import Image
            import numpy as np

            img = Image.open(io.BytesIO(data)).convert("RGB")
            out["image" if ext == kind else ext] = np.asarray(img)
        elif kind == "json":
            out["json" if ext == kind else ext] = json.loads(data)
        elif kind in ("txt", "text", "caption"):
            out["txt" if ext == kind else ext] = data.decode("utf-8")
        else:
            out[ext] = data
    return out


class ShardStream:
    """Infinite (or single-epoch) sample stream over tar shards.

    Pipeline: shards (resampled or round-robin) → group → decode → filters →
    shuffle buffer. Any per-sample exception is logged and skipped, with a
    consecutive-failure circuit breaker (reference :112-140).
    """

    def __init__(
        self,
        shards: Sequence[str],
        *,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        resample: bool = True,
        decoder: Callable[[dict], dict] = default_decoder,
        filters: Sequence[Callable[[dict], bool]] = (),
        map_fn: Callable[[dict], Any] | None = None,
        max_consecutive_failures: int = 100,
    ):
        assert shards, "empty shard list"
        self.shards = list(shards)
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.resample = resample
        self.decoder = decoder
        self.filters = list(filters)
        self.map_fn = map_fn
        self.max_consecutive_failures = max_consecutive_failures
        self._yielded = 0   # samples produced since stream start (resume)
        self._skip = 0

    def _shard_iter(self, rng: random.Random) -> Iterator[str]:
        if self.resample:
            while True:
                yield rng.choice(self.shards)
        else:
            order = list(self.shards)
            rng.shuffle(order)
            yield from order

    def _raw(self, rng: random.Random) -> Iterator[dict]:
        failures = 0
        for shard in self._shard_iter(rng):
            try:
                for sample in group_tar_entries(shard):
                    try:
                        s = self.decoder(sample)
                        # a successful DECODE resets the breaker even when
                        # quality filters drop the sample — scattered decode
                        # errors in a heavily-filtered corpus must not
                        # accumulate as if they were consecutive
                        failures = 0
                        if all(f(s) for f in self.filters):
                            yield s
                    except Exception as e:  # warn-and-continue
                        failures += 1
                        logger.warning("sample decode failed (%s): %s", sample.get("__key__"), e)
                        if failures >= self.max_consecutive_failures:
                            raise RuntimeError(
                                f"{failures} consecutive sample failures"
                            ) from e
            except _SHARD_ERRORS as e:
                failures += 1
                logger.warning("shard %s failed: %s", shard, e)
                if failures >= self.max_consecutive_failures:
                    raise

    def _iterate(self, rng: random.Random) -> Iterator[Any]:
        buf: list[Any] = []
        map_failures = 0
        for s in self._raw(rng):
            if self.map_fn is not None:
                # same warn-and-continue contract as decode: one odd sample
                # that survives filters must not kill an hours-long stream
                try:
                    s = self.map_fn(s)
                    map_failures = 0
                except Exception as e:  # noqa: BLE001
                    map_failures += 1
                    key = s.get("__key__") if isinstance(s, dict) else None
                    logger.warning("map_fn failed (%s): %s", key, e)
                    if map_failures >= self.max_consecutive_failures:
                        raise RuntimeError(
                            f"{map_failures} consecutive map_fn failures"
                        ) from e
                    continue
            if self.shuffle_buffer <= 1:
                yield s
                continue
            buf.append(s)
            if len(buf) >= self.shuffle_buffer:
                i = rng.randrange(len(buf))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[Any]:
        n_skip, self._skip = self._skip, 0
        self._yielded = 0
        for s in self._iterate(random.Random(self.seed)):
            self._yielded += 1
            if n_skip > 0:
                n_skip -= 1
                continue
            yield s

    # ---- resumable-stream protocol (consumed by train.Trainer; the
    # reference's skip_first_batches + RNG reload, trainer.py:698-757) ----
    def state_dict(self) -> dict:
        return {"yielded": self._yielded, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        """Fast-forward the next iteration past ``yielded`` samples — the
        shard order and shuffle buffer are deterministic in ``seed``, so the
        sequence continues instead of repeating. Assumes one live iterator."""
        if state.get("seed", self.seed) != self.seed:
            logger.warning("resume seed %s != stream seed %s", state.get("seed"), self.seed)
        self._skip = int(state["yielded"])


class IterableAsMapStyle:
    """Map-style facade over an infinite stream: __getitem__ just advances the
    iterator (the reference does the same, unified_it_pair_webdataset.py:
    93-149 — index is ignored by design for resampled web data)."""

    def __init__(self, stream: Iterable, size: int):
        self.stream = stream
        self._it = None
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if self._it is None:
            self._it = iter(self.stream)
        return next(self._it)

    def state_dict(self) -> dict:
        sd = getattr(self.stream, "state_dict", None)
        return sd() if sd else {}

    def load_state_dict(self, state: dict) -> None:
        ld = getattr(self.stream, "load_state_dict", None)
        if ld:
            ld(state)
            self._it = None  # next access re-enters the fast-forwarded stream
