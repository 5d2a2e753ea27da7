"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use into ``att_aspp_unet_tpu_torch/build/`` (ignored by git);
the library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  :func:`build_all`
starts one ``nvcc`` per source, all at once, under a file lock: processes
that need the kernels at the same time (data-parallel ranks, test workers)
compile each source once, the later ones finding the library built.  When
every library is built, loading writes nothing and starts no compiler, so
the kernels load from a package tree the process cannot write (a container
image built with ``python -m att_aspp_unet_tpu_torch.ops.kernels._build``);
a library that is missing there raises an error naming it.
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
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNEL_SOURCES = ("fused_double_cbr", "clahe_interp", "int8_conv3x3",
                  "swin_ops")
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
    was built.  Writes nothing when every library exists; raises
    ``RuntimeError`` naming the missing libraries and the build directory
    when there is no ``nvcc`` or the directory cannot be written."""
    names = list(names)
    missing = [library_path(n).name for n in names
               if not library_path(n).exists()]
    if not missing:
        return {}
    with _lock:
        try:
            find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lock = open(BUILD_DIR / "kernels.lock", "w")
        except (RuntimeError, OSError) as err:
            raise RuntimeError(f"kernel libraries {', '.join(missing)} are "
                               f"missing from {BUILD_DIR} and cannot be "
                               f"built there: {err}") from err
        with lock:
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


def main() -> int:
    """Build the kernel libraries and the host-ops library into the
    package's build directory: a container image's build step, which needs
    ``nvcc`` and ``g++`` but no card."""
    from ...utils import native

    ok = True
    t0 = time.time()
    try:
        built = build_all()
    except RuntimeError as err:
        print(err, file=sys.stderr)
        built, ok = {}, False
    for name in built:
        out = library_path(name)
        # nvcc wrote the file, and the rename kept its time: its own seconds
        print(f"built {out.name} in "
              f"{max(out.stat().st_mtime - t0, 0.0):.1f} s")
    t0 = time.perf_counter()
    had_host_ops = native.library_path().exists()
    try:
        out = native.build()
    except RuntimeError as err:
        print(err, file=sys.stderr)
        ok = False
    else:
        if not had_host_ops:
            print(f"built {out.name} in {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
