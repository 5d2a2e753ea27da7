"""ctypes bindings for the native host-ops library (``csrc/host_ops.cpp`` and
``csrc/metaio_writer.cpp``), the same API as the JAX package's
``utils/native.py``.

The library is built with ``g++`` at first use, never at import, into
``att_aspp_unet_tpu_torch/build/`` (ignored by git).  Its file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded; the build runs under a file lock and writes a
temporary file that is renamed into place, so concurrent processes never
load a half-written library.  When the library cannot be built or loaded,
every entry point returns ``None`` (``False`` for the writer) and the callers
(``io/mha.py``, ``measure/contour.py``) fall back to Python zlib and the
Python tracer; the first such fallback in a process prints one ``[warn]
native host ops unavailable: <reason>`` line to stderr.

Each entry point that ran in the library counts one call under its name
(:func:`read_native_calls`, :func:`reset_native_calls`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("host_ops.cpp", "metaio_writer.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None       # why the library is unavailable
_calls: Counter = Counter()


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libhostops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    ``RuntimeError`` when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "hostops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *(str(CSRC_DIR / s) for s in SOURCES),
               "-o", str(tmp), *LINK_FLAGS]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr}")
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ll, ci, cs = ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p
    dbl, dblp = ctypes.c_double, ctypes.POINTER(ctypes.c_double)
    sigs = {
        "ho_inflate": (ci, [u8p, ll, u8p, ll]),
        "ho_deflate": (ll, [u8p, ll, u8p, ll, ci]),
        "ho_deflate_bound": (ll, [ll]),
        "ho_clahe_u8": (None, [u8p, ci, ci, ctypes.c_float, ci, ci, u8p]),
        "ho_median3_u8": (None, [u8p, ci, ci, u8p]),
        "ho_label": (ci, [u8p, ci, ci, ci, i32p]),
        "ho_largest_component": (ll, [u8p, ci, ci, ci, u8p]),
        "ho_fill_holes": (None, [u8p, ci, ci, u8p]),
        "ho_trace_contour": (ci, [u8p, ci, ci, i32p, ci]),
        "ho_write_mha_u8": (ci, [cs, u8p, ci, ci, ci, dbl, dbl, dbl, dbl,
                                 dbl, dbl, ci]),
        "ho_read_mha_dims_u8": (ci, [cs, i32p, i32p, i32p, dblp, dblp,
                                     dblp]),
        "ho_read_mha_u8": (ci, [cs, u8p, ll]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at the first call; ``None`` (with one
    warning per process) when it cannot be built or loaded."""
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lock:
        if _lib is None and _reason is None:
            try:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError,
                    AttributeError) as err:
                _reason = str(err).strip().splitlines()[0] or repr(err)
                print(f"[warn] native host ops unavailable: {_reason}",
                      file=sys.stderr, flush=True)
    return _lib


def available() -> bool:
    return load() is not None


def read_native_calls() -> Dict[str, int]:
    """Calls that ran in the library since the last reset, by entry point."""
    return dict(_calls)


def reset_native_calls() -> None:
    _calls.clear()


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def inflate_into(blob: bytes, out_len: int) -> Optional[np.ndarray]:
    """:func:`inflate` into a new uint8 array, without the copy to bytes."""
    lib = load()
    if lib is None:
        return None
    src = np.frombuffer(blob, np.uint8)
    dst = np.empty(out_len, np.uint8)
    rc = lib.ho_inflate(_ptr(src), len(src), _ptr(dst), out_len)
    if rc != 0:
        return None
    _calls["inflate"] += 1
    return dst


def inflate(blob: bytes, out_len: int) -> Optional[bytes]:
    out = inflate_into(blob, out_len)
    return None if out is None else out.tobytes()


def deflate(data: bytes, level: int = 6) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    cap = int(lib.ho_deflate_bound(len(src)))
    dst = np.empty(cap, np.uint8)
    n = lib.ho_deflate(_ptr(src), len(src), _ptr(dst), cap, level)
    if n <= 0:
        return None
    _calls["deflate"] += 1
    return dst[:n].tobytes()


def clahe_u8(img: np.ndarray, clip: float = 1.0, grid=(8, 8)
             ) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    img = _u8(img)
    out = np.empty_like(img)
    lib.ho_clahe_u8(_ptr(img), img.shape[0], img.shape[1], clip, grid[0],
                    grid[1], _ptr(out))
    _calls["clahe_u8"] += 1
    return out


def median3_u8(img: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    img = _u8(img)
    out = np.empty_like(img)
    lib.ho_median3_u8(_ptr(img), img.shape[0], img.shape[1], _ptr(out))
    _calls["median3_u8"] += 1
    return out


def label(mask: np.ndarray, connectivity: int = 8):
    """(labels int32, count) of the mask's components, or ``None``."""
    lib = load()
    if lib is None:
        return None
    m = _u8(mask > 0)
    labels = np.empty(m.shape, np.int32)
    n = lib.ho_label(_ptr(m), m.shape[0], m.shape[1], connectivity,
                     _ptr(labels, ctypes.c_int32))
    _calls["label"] += 1
    return labels, int(n)


def largest_component(mask: np.ndarray, connectivity: int = 8):
    """(mask of the largest component, its size), or ``None``."""
    lib = load()
    if lib is None:
        return None
    m = _u8(mask > 0)
    out = np.empty_like(m)
    size = lib.ho_largest_component(_ptr(m), m.shape[0], m.shape[1],
                                    connectivity, _ptr(out))
    _calls["largest_component"] += 1
    return out, int(size)


def fill_holes(mask: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    m = _u8(mask > 0)
    out = np.empty_like(m)
    lib.ho_fill_holes(_ptr(m), m.shape[0], m.shape[1], _ptr(out))
    _calls["fill_holes"] += 1
    return out


def trace_contour(mask: np.ndarray) -> Optional[np.ndarray]:
    """(K, 2) int32 (x, y) border pixels in traversal order, or ``None``."""
    lib = load()
    if lib is None:
        return None
    m = _u8(mask > 0)
    max_pts = int(8 * m.sum() + 8)
    buf = np.empty(2 * max(max_pts, 1), np.int32)
    n = lib.ho_trace_contour(_ptr(m), m.shape[0], m.shape[1],
                             _ptr(buf, ctypes.c_int32), max_pts)
    _calls["trace_contour"] += 1
    return buf[: 2 * n].reshape(n, 2).copy()


def write_mha_u8(path, vol: np.ndarray, spacing=(1.0, 1.0, 1.0),
                 offset=(0.0, 0.0, 0.0), compressed: bool = True) -> bool:
    """The independent C++ MetaIO writer (``csrc/metaio_writer.cpp``), the
    cross-implementation partner of ``io.mha.write_mha``.  ``vol`` is
    (z, y, x) uint8; spacing and offset are (x, y, z) like the Python
    codec's."""
    lib = load()
    if lib is None:
        return False
    vol = _u8(vol)
    nz, ny, nx = vol.shape
    rc = lib.ho_write_mha_u8(
        str(path).encode(), _ptr(vol), nx, ny, nz, float(spacing[0]),
        float(spacing[1]), float(spacing[2]), float(offset[0]),
        float(offset[1]), float(offset[2]), 1 if compressed else 0)
    _calls["write_mha_u8"] += 1
    return rc == 0


def read_mha_u8(path):
    """The independent C++ MetaIO reader: ((z, y, x) uint8 array, (x, y, z)
    spacing), or ``None``."""
    lib = load()
    if lib is None:
        return None
    dims = [ctypes.c_int32() for _ in range(3)]
    sp = [ctypes.c_double() for _ in range(3)]
    rc = lib.ho_read_mha_dims_u8(str(path).encode(),
                                 *(ctypes.byref(v) for v in dims + sp))
    if rc != 0:
        return None
    nx, ny, nz = (v.value for v in dims)
    out = np.empty((nz, ny, nx), np.uint8)
    rc = lib.ho_read_mha_u8(str(path).encode(), _ptr(out), out.size)
    _calls["read_mha_u8"] += 1
    if rc != 0:
        return None
    return out, tuple(v.value for v in sp)
