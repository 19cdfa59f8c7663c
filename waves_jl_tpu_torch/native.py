"""ctypes binding to the repository's native episode stores, the
counterpart of `waves_jl_tpu/native/store.py`.

`native/episode_store.cpp` writes one bundle of named float32 arrays to a
`.wbin` file and reads it back through one mmap; `native/dataset_shard.cpp`
streams many such bundles into one shard file. Both are used as they are:
each is built with `g++ -O3 -shared -fPIC -std=c++17` at first use into
`waves_jl_tpu_torch/_build/`, named by a hash of its source. Where there
is no `g++`, or a build or a call fails, the functions raise; nothing falls
back to another format.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
BUILD_DIR = Path(__file__).resolve().parent / "_build"
STORE_SOURCE = _REPO / "native" / "episode_store.cpp"
SHARD_SOURCE = _REPO / "native" / "dataset_shard.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}

_U64, _U32, _P = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
# the arguments of ws_write and ds_append after the handle or path:
# count, NUL-separated names, ndims, dims flattened, float32 pointers
_BUNDLE_ARGS = [_U64, ctypes.c_char_p, ctypes.POINTER(_U32), ctypes.POINTER(_U64),
                ctypes.POINTER(_FLOAT_P)]
_SIGNATURES = {
    "episode_store": {
        "ws_write": (ctypes.c_int, [ctypes.c_char_p, *_BUNDLE_ARGS]),
        "ws_open": (_P, [ctypes.c_char_p]),
        "ws_count": (_U64, [_P]),
        "ws_name": (ctypes.c_char_p, [_P, _U64]),
        "ws_ndim": (_U32, [_P, _U64]),
        "ws_dims": (None, [_P, _U64, ctypes.POINTER(_U64)]),
        "ws_read": (None, [_P, _U64, _FLOAT_P]),
        "ws_close": (None, [_P]),
    },
    "dataset_shard": {
        "ds_create": (_P, [ctypes.c_char_p]),
        "ds_append": (ctypes.c_int64, [_P, *_BUNDLE_ARGS]),
        "ds_finish": (ctypes.c_int, [_P]),
        "dss_open": (_P, [ctypes.c_char_p]),
        "dss_episodes": (_U64, [_P]),
        "dss_count": (_U64, [_P, _U64]),
        "dss_name": (ctypes.c_char_p, [_P, _U64, _U64]),
        "dss_ndim": (_U32, [_P, _U64, _U64]),
        "dss_dims": (None, [_P, _U64, _U64, ctypes.POINTER(_U64)]),
        "dss_read": (None, [_P, _U64, _U64, _FLOAT_P]),
        "dss_close": (None, [_P]),
    },
}


def build(source: Path) -> Path:
    """Compile `source` into a shared library unless it is built already
    for this source and these flags; returns the library's path."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native episode store builds only where g++ is "
                           "installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build finds a whole library or none
    return lib


def _lib(source: Path):
    """The loaded library of `source`, built at first use, with its C
    signatures declared."""
    with _lock:
        if source.stem not in _libs:
            cdll = ctypes.CDLL(str(build(source)))
            for name, (res, args) in _SIGNATURES[source.stem].items():
                fn = getattr(cdll, name)
                fn.restype = res
                fn.argtypes = args
            _libs[source.stem] = cdll
        return _libs[source.stem]


def _bundle_args(tensors: dict):
    """ctypes arguments of one bundle of {name: array}, as float32, and the
    contiguous arrays they point into (kept alive by the caller)."""
    names = list(tensors)
    originals = [np.asarray(tensors[k], dtype=np.float32) for k in names]
    shapes = [a.shape for a in originals]  # ascontiguousarray turns 0-d into 1-d
    arrays = [np.ascontiguousarray(a) for a in originals]
    dims = [d for s in shapes for d in s]
    args = (len(names), b"".join(k.encode() + b"\0" for k in names),
            (_U32 * len(names))(*[len(s) for s in shapes]), (_U64 * len(dims))(*dims),
            (_FLOAT_P * len(names))(*[a.ctypes.data_as(_FLOAT_P) for a in arrays]))
    return args, arrays


def save_bundle(path: str, tensors: dict) -> None:
    """Write {name: float32 array} to a `.wbin` file."""
    args, _arrays = _bundle_args(tensors)
    if _lib(STORE_SOURCE).ws_write(path.encode(), *args) != 0:
        raise IOError(f"cannot write bundle {path}")


def _read_entries(count, name, ndim, dims, read) -> dict:
    out = {}
    for i in range(count):
        nd = ndim(i)
        shape = (_U64 * nd)()
        dims(i, shape)
        arr = np.empty(tuple(shape), dtype=np.float32)
        read(i, arr.ctypes.data_as(_FLOAT_P))
        out[name(i).decode()] = arr
    return out


def load_bundle(path: str) -> dict:
    """Read a `.wbin` file back as {name: float32 array}."""
    lib = _lib(STORE_SOURCE)
    h = lib.ws_open(path.encode())
    if not h:
        raise IOError(f"cannot open bundle {path}")
    try:
        return _read_entries(lib.ws_count(h), lambda i: lib.ws_name(h, i),
                             lambda i: lib.ws_ndim(h, i), lambda i, s: lib.ws_dims(h, i, s),
                             lambda i, p: lib.ws_read(h, i, p))
    finally:
        lib.ws_close(h)


class ShardWriter:
    """Streaming shard writer: bundles are appended one at a time, so the
    dataset never has to fit in memory."""

    def __init__(self, path: str):
        self._lib = _lib(SHARD_SOURCE)
        self._h = self._lib.ds_create(path.encode())
        if not self._h:
            raise IOError(f"cannot create shard {path}")

    def append(self, tensors: dict) -> int:
        """Append one bundle of {name: float32 array}; returns its index."""
        if self._h is None:
            raise IOError("shard already finished")
        args, _arrays = _bundle_args(tensors)
        idx = self._lib.ds_append(self._h, *args)
        if idx < 0:
            raise IOError("shard append failed")
        return int(idx)

    def finish(self) -> None:
        if self._h is None:
            raise IOError("shard already finished")
        rc = self._lib.ds_finish(self._h)
        self._h = None
        if rc != 0:
            raise IOError(f"shard finish failed rc={rc}")


def load_shard(path: str, limit: int | None = None) -> list[dict]:
    """Read a shard back as a list of {name: float32 array}; `limit` copies
    only the first episodes out of the map."""
    lib = _lib(SHARD_SOURCE)
    h = lib.dss_open(path.encode())
    if not h:
        raise IOError(f"cannot open shard {path}")
    try:
        n_eps = lib.dss_episodes(h)
        if limit is not None:
            n_eps = min(n_eps, limit)
        return [_read_entries(lib.dss_count(h, ep), lambda i: lib.dss_name(h, ep, i),
                              lambda i: lib.dss_ndim(h, ep, i),
                              lambda i, s: lib.dss_dims(h, ep, i, s),
                              lambda i, p: lib.dss_read(h, ep, i, p))
                for ep in range(n_eps)]
    finally:
        lib.dss_close(h)
