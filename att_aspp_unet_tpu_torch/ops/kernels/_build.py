"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use into ``att_aspp_unet_tpu_torch/build/`` (ignored by git);
the library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  :func:`build_all`
starts one ``nvcc`` per source, all at once, under a file lock: processes
that need the kernels at the same time (data-parallel ranks, test workers)
compile each source once, the later ones finding the library built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNEL_SOURCES = ("fused_double_cbr", "clahe_interp", "int8_conv3x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    return log


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source running in parallel.  Returns the compiler
    log (``-Xptxas -v``: registers, shared memory, spills) per source that
    was built."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "kernels.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            jobs = {n: _start(n) for n in names}
            return {n: _finish(n, j) for n, j in jobs.items()
                    if j is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
