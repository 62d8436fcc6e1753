"""ctypes bindings for the native data plane (port of
``dreamllm_tpu/data/native_loader.py``).

The C++ pipeline (``native/dataplane.cpp``, read where it is) streams tar
shards, decodes JPEG (libjpeg) and resizes off the GIL in worker threads:
the equivalent of the reference's torch DataLoader worker processes around
webdataset. Callers catch ``NativeLoaderUnavailable`` and use
``data/webdataset.py``.

The shared library is built on first use with the JAX package's command
line (g++, plain C ABI through ctypes) into ``build/native/libdataplane.so``,
again whenever the source is newer. A thread lock and a file lock guard the
build, so that several processes (pytest workers) build it once; the
library is written under a temporary name and renamed into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

from dreamllm_tpu_torch.utils.logging import get_logger

logger = get_logger("dreamllm_tpu_torch.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "dataplane.cpp")
_BUILD = os.path.join(_REPO_ROOT, "build", "native")
_LIB = os.path.join(_BUILD, "libdataplane.so")
_build_lock = threading.Lock()


class NativeLoaderUnavailable(RuntimeError):
    pass


def _fresh() -> bool:
    return os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)


def _ensure_built() -> str:
    with _build_lock:
        if not os.path.exists(_SRC):
            raise NativeLoaderUnavailable(f"missing source {_SRC}")
        if _fresh():
            return _LIB
        os.makedirs(_BUILD, exist_ok=True)
        with open(os.path.join(_BUILD, "lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if _fresh():  # another process built it while this one waited
                    return _LIB
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                cmd = [
                    "g++", "-O3", "-march=native", "-shared", "-fPIC",
                    _SRC, "-o", tmp, "-ljpeg", "-lpthread",
                ]
                try:
                    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=180)
                except (subprocess.CalledProcessError, FileNotFoundError,
                        subprocess.TimeoutExpired) as e:
                    detail = getattr(e, "stderr", "") or str(e)
                    raise NativeLoaderUnavailable(f"build failed: {detail[:500]}") from e
                os.replace(tmp, _LIB)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        logger.info("built %s", _LIB)
        return _LIB


def _load():
    lib = ctypes.CDLL(_ensure_built())
    lib.dp_create.restype = ctypes.c_void_p
    lib.dp_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dp_next.restype = ctypes.c_int
    lib.dp_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.dp_destroy.argtypes = [ctypes.c_void_p]
    lib.dp_decoded.restype = ctypes.c_long
    lib.dp_decoded.argtypes = [ctypes.c_void_p]
    lib.dp_failed.restype = ctypes.c_long
    lib.dp_failed.argtypes = [ctypes.c_void_p]
    return lib


class NativeImageTextLoader:
    """Iterator over (image [S,S,3] uint8, caption str) from tar shards,
    decoded by the C++ pipeline."""

    def __init__(self, shards: list[str], image_size: int = 224,
                 n_threads: int = 4, capacity: int = 256, loop: bool = False):
        if not shards:
            raise ValueError("empty shard list")
        self.lib = _load()
        arr = (ctypes.c_char_p * len(shards))(*[s.encode() for s in shards])
        self.handle = self.lib.dp_create(
            arr, len(shards), n_threads, image_size, capacity, int(loop)
        )
        if not self.handle:
            raise NativeLoaderUnavailable("dp_create returned NULL")
        self.image_size = image_size
        self._img = np.empty((image_size, image_size, 3), np.uint8)
        self._text = ctypes.create_string_buffer(1 << 16)
        self._tlen = ctypes.c_int(0)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        rc = self.lib.dp_next(
            self.handle,
            self._img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._text, len(self._text), ctypes.byref(self._tlen),
        )
        if rc != 1:
            self.close()
            raise StopIteration
        return self._img.copy(), self._text.value.decode("utf-8", "replace")

    @property
    def stats(self) -> dict:
        if self._closed:  # snapshot taken by close(); handle is freed
            return dict(self._final_stats)
        return {
            "decoded": int(self.lib.dp_decoded(self.handle)),
            "failed": int(self.lib.dp_failed(self.handle)),
        }

    def close(self):
        if not self._closed and self.handle:
            self._final_stats = {
                "decoded": int(self.lib.dp_decoded(self.handle)),
                "failed": int(self.lib.dp_failed(self.handle)),
            }
            self.lib.dp_destroy(self.handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
