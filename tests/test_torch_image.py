"""The port's container image (``Dockerfile.torch``) on the CPU, with the
parser and ignore-file matcher that chip_smoke's ``[image]`` phase uses:
what it copies and leaves out, its build step (the kernel build's
``__main__``) on a copy of the package with a stand-in ``nvcc``, loading
from that copy once it is read-only, and ``test_local_torch.sh`` against an
in-process ``infer.container.run``.  Building and running the image itself
needs docker and a network; on the card ``[image]`` runs its recipe."""

import dataclasses
import importlib.util
import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from att_aspp_unet_tpu_torch.config import Config
from att_aspp_unet_tpu_torch.infer import container
from att_aspp_unet_tpu_torch.infer.models import load_model
from att_aspp_unet_tpu_torch.io import read_json, read_mha
from att_aspp_unet_tpu_torch.ops.kernels import _build
from att_aspp_unet_tpu_torch.utils import native
from att_aspp_unet_tpu_torch.utils.nnunet_import import load_plans_config

from .test_torch_baseline import _small_plans
from .test_torch_parallel import FAKE_NVCC
from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STAGES = chip_smoke.parse_dockerfile(REPO / "Dockerfile.torch")
BUILDER = next(st for st in STAGES if st["name"] == "builder")
RUNTIME = STAGES[-1]
PATTERNS = chip_smoke.dockerignore_patterns(
    REPO / "Dockerfile.torch.dockerignore")
BUILD_STEP = next(r for r in BUILDER["run"] if "ops.kernels._build" in r)
PLAN_DIR = REPO / chip_smoke.PLAN_DIR
CASE = REPO / "test/input"


def test_copy_sources_exist_and_the_runtime_copies_from_the_builder():
    """Every COPY source of the build context exists; the runtime stage
    copies only from the builder, the package and ``resources`` among it."""
    for frm, srcs, _ in BUILDER["copy"]:
        assert frm is None
        assert all((REPO / s).exists() for s in srcs), srcs
    runtime = [(frm, s) for frm, srcs, _ in RUNTIME["copy"] for s in srcs]
    assert {frm for frm, _ in runtime} == {"builder"}
    assert {"/opt/app/att_aspp_unet_tpu_torch",
            "/opt/app/resources"} <= {s for _, s in runtime}


def test_the_image_holds_nothing_of_the_jax_package():
    text = (REPO / "Dockerfile.torch").read_text()
    assert "jax" not in text.lower()
    named = {Path(s).parts[0] for st in STAGES for frm, srcs, _ in st["copy"]
             if frm is None for s in srcs}
    assert not named & set(chip_smoke.NOT_IN_IMAGE), named
    assert RUNTIME["entrypoint"] == ["python", "-m",
                                     "att_aspp_unet_tpu_torch.inference"]
    assert shlex.split(BUILD_STEP) == [
        "python", "-m", "att_aspp_unet_tpu_torch.ops.kernels._build"]


@pytest.mark.parametrize("rel,left_out", [
    ("att_aspp_unet_tpu_torch/build", True),
    ("att_aspp_unet_tpu_torch/build/libhostops-9629a393ed45ec07.so", True),
    ("att_aspp_unet_tpu_torch/__pycache__/cli.cpython-312.pyc", True),
    ("att_aspp_unet_tpu_torch/ops/kernels/__pycache__", True),
    ("test/output/images/fetal-abdomen-segmentation/output.mha", True),
    ("acouslicai_torch.tar.gz", True),
    (".probe/x.py", True),
    ("att_aspp_unet_tpu_torch/csrc/fused_double_cbr.cu", False),
    ("att_aspp_unet_tpu_torch/ops/kernels/_build.py", False),
    ("resources/synthetic/weights.npz", False),
    ("test/input/images/stacked-fetal-ultrasound/case.mha", False),
])
def test_the_ignore_file_leaves_out_built_and_cached_files(rel, left_out):
    assert chip_smoke.dockerignored(rel, PATTERNS) is left_out


def test_the_context_of_this_checkout_stages_no_build_or_cache(tmp_path):
    """The builder's COPY sources of this checkout, staged as chip_smoke
    stages them (``build/`` and ``__pycache__`` exist here once any test
    built the host ops or imported the package): every source file, and
    nothing built or cached."""
    (REPO / "att_aspp_unet_tpu_torch/build").mkdir(exist_ok=True)
    chip_smoke.stage_context(BUILDER, tmp_path, PATTERNS)
    app = tmp_path / BUILDER["workdir"].lstrip("/")
    staged = {q.relative_to(app).as_posix() for q in app.rglob("*")
              if q.is_file()}
    assert not [q for q in staged if "/build/" in q or "__pycache__" in q
                or q.endswith(".pyc")]
    tracked = subprocess.run(
        ["git", "ls-files", "att_aspp_unet_tpu_torch", "resources"],
        cwd=REPO, capture_output=True, text=True)
    if tracked.returncode == 0 and tracked.stdout:
        assert set(tracked.stdout.split()) <= staged
    assert "att_aspp_unet_tpu_torch/csrc/fused_double_cbr.cu" in staged


def test_entry_and_build_modules_exist_and_the_entry_runs_without_jax():
    """The ENTRYPOINT module, run as ``python -m`` runs it, imports what its
    ``main`` imports with JAX and the JAX package blocked, and exits with
    its message for ``MODEL_TAG=att_aspp`` without ``WEIGHTS``."""
    entry = RUNTIME["entrypoint"][2]
    assert importlib.util.find_spec(entry) is not None
    assert importlib.util.find_spec(shlex.split(BUILD_STEP)[2]) is not None
    code = rf"""
import runpy, sys
BLOCKED = {{"jax", "jaxlib", "flax", "optax", "orbax", "att_aspp_unet_tpu"}}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block())
try:
    runpy.run_module({entry!r}, run_name="__main__", alter_sys=True)
except SystemExit as exit:
    print(exit)
assert "torch" in sys.modules
assert not BLOCKED & {{m.split(".")[0] for m in sys.modules}}
"""
    env = {k: v for k, v in os.environ.items()
           if k not in chip_smoke.ENTRY_ENV}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(env, MODEL_TAG="att_aspp"),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "MODEL_TAG=att_aspp needs WEIGHTS" in res.stdout


# the build step as the image runs it, in a process where torch cannot be
# imported: it needs no device
NO_TORCH_BUILD = r"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
runpy.run_module(sys.argv[1], run_name="__main__", alter_sys=True)
"""
# a later process on the read-only copy: it must build and write nothing
RELOAD = r"""
from att_aspp_unet_tpu_torch.ops.kernels import _build
from att_aspp_unet_tpu_torch.utils import native
assert _build.build_all() == {}
assert native.load() is not None
"""
BUILD_ALL = ("from att_aspp_unet_tpu_torch.ops.kernels import _build; "
             "_build.build_all()")


def _tree(root: Path):
    return {str(q): q.stat().st_mtime_ns for q in [root, *root.rglob("*")]}


def _chmod_tree(root: Path, writable: bool):
    for q in [root, *root.rglob("*")]:
        mode = q.stat().st_mode
        q.chmod(mode | 0o200 if writable else mode & ~0o222)


def test_build_entry_then_loading_from_a_read_only_copy(tmp_path):
    """The image's build step on a copy of the package (a stand-in ``nvcc``
    that logs its calls, the real ``g++``, no torch importable, no card
    visible) builds the three kernel libraries and the host-ops library.
    With the copy read-only, ``build_all()`` and ``native.load()`` return
    without writing and without calling the stand-in; with a library
    deleted and no compiler to be found, ``build_all()`` raises naming the
    library and the build directory, and writes nothing."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host ops")
    app = tmp_path / "app"
    shutil.copytree(REPO / "att_aspp_unet_tpu_torch",
                    app / "att_aspp_unet_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    bin_dir, calls = tmp_path / "bin", tmp_path / "calls.log"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text(FAKE_NVCC.format(log=calls))
    (bin_dir / "nvcc").chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(app), CUDA_VISIBLE_DEVICES="",
               PYTHONDONTWRITEBYTECODE="1",
               PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    res = subprocess.run([sys.executable, "-c", NO_TORCH_BUILD,
                          shlex.split(BUILD_STEP)[2]], cwd=app, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    build = app / "att_aspp_unet_tpu_torch/build"
    names = sorted([_build.library_path(n).name for n in _build.KERNEL_SOURCES]
                   + [native.library_path().name])
    assert sorted(q.name for q in build.glob("*.so")) == names
    assert sorted(line.split()[1] for line in res.stdout.splitlines()) == names
    n_calls = len(calls.read_text().splitlines())
    assert n_calls == len(_build.KERNEL_SOURCES)

    _chmod_tree(app, writable=False)
    try:
        before = _tree(app)
        res = subprocess.run([sys.executable, "-c", RELOAD], cwd=app,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr
        assert _tree(app) == before
        assert len(calls.read_text().splitlines()) == n_calls

        gone = _build.library_path("clahe_interp").name
        build.chmod(0o755)
        (build / gone).unlink()
        build.chmod(0o555)
        before = _tree(app)
        path = [d for d in os.environ["PATH"].split(os.pathsep)
                if not (Path(d) / "nvcc").exists()]
        no_compiler = dict(env, PATH=os.pathsep.join(path),
                           CUDA_HOME=str(tmp_path / "no-cuda"))
        # build_all() raises; the build step reports it and exits 1
        for code in (BUILD_ALL, NO_TORCH_BUILD):
            res = subprocess.run([sys.executable, "-c", code,
                                  shlex.split(BUILD_STEP)[2]], cwd=app,
                                 env=no_compiler, capture_output=True,
                                 text=True, timeout=120)
            assert res.returncode == 1
            assert gone in res.stderr and str(build.resolve()) in res.stderr, \
                res.stderr
        assert _tree(app) == before
    finally:
        _chmod_tree(app, writable=True)


def test_local_script_serves_the_contract_on_the_cpu(tmp_path):
    """``test_local_torch.sh`` with ``RUN_DIR`` holding the repository's
    ``test/input`` case (12 x 96 x 128), ``DEVICE=cpu``, ``MODEL_TAG`` unset
    and a small nnU-Net plan: a uint8 {0, 1} volume with spacing 0.28 and
    the frame and mask of an in-process ``infer.container.run``."""
    run_dir = tmp_path / "run"
    shutil.copytree(CASE, run_dir / "test/input")
    plans = _small_plans(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in chip_smoke.ENTRY_ENV}
    env.update(RUN_DIR=str(run_dir), DEVICE="cpu", PLANS=str(plans),
               DATASET_JSON=str(PLAN_DIR / "dataset.json"),
               OMP_NUM_THREADS="1",
               PATH=f"{Path(sys.executable).parent}{os.pathsep}"
                    f"{os.environ['PATH']}")
    res = subprocess.run(["bash", str(REPO / "test_local_torch.sh")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = run_dir / "test/output"
    vol = read_mha(out / "images/fetal-abdomen-segmentation/output.mha")
    assert vol.array.dtype == np.uint8 and vol.array.shape == (12, 96, 128)
    assert set(np.unique(vol.array)) <= {0, 1}
    assert all(abs(s - 0.28) < 1e-9 for s in vol.spacing)

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, plain_unet=load_plans_config(
            plans, dataset_json=PLAN_DIR / "dataset.json",
            base=cfg.plain_unet),
        container=dataclasses.replace(
            cfg.container, input_path=str(run_dir / "test/input"),
            output_path=str(tmp_path / "ref")))
    assert container.run(cfg, load_model("baseline", None, cfg),
                         save_probabilities=False, debug_frames=False,
                         device="cpu", log=lambda *_: None) == 0
    ref = tmp_path / "ref"
    assert read_json(out / "fetal-abdomen-frame-number.json") == read_json(
        ref / "fetal-abdomen-frame-number.json")
    assert np.array_equal(vol.array, read_mha(
        ref / "images/fetal-abdomen-segmentation/output.mha").array)
