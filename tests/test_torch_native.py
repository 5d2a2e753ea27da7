"""The port's native host ops (``att_aspp_unet_tpu_torch/utils/native.py`` over
``csrc/host_ops.cpp`` and ``csrc/metaio_writer.cpp``) against the JAX
package's binding of its own copy of the sources and against the Python
paths: zlib bytes, ``.mha`` bytes, contours, the image ops; the hashed,
locked build; the fallback with its one warning."""

import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from att_aspp_unet_tpu.io import MetaImage as JMetaImage
from att_aspp_unet_tpu.io import write_mha as j_write_mha
from att_aspp_unet_tpu.measure import trace_contour as j_trace_contour
from att_aspp_unet_tpu_torch.io import MetaImage, read_mha, write_mha
from att_aspp_unet_tpu_torch.io import mha as port_mha
from att_aspp_unet_tpu_torch.measure.contour import (trace_contour,
                                                     trace_contour_python)
from att_aspp_unet_tpu_torch.utils import native

from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the host ops")


@pytest.fixture(scope="module")
def port_lib():
    """The port's library, built (under its lock) at first use."""
    assert native.available(), "the port's host ops did not build"
    return native


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's binding, loaded.  Its own build runs ``make`` in
    ``native/`` and can lose a race between test workers; then its sources
    are built into a private directory and the binding pointed there."""
    from att_aspp_unet_tpu.utils import native as jn

    if jn.available():
        yield jn
        return
    so = tmp_path_factory.mktemp("jnative") / "libhostops.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                    str(REPO / "native/host_ops.cpp"),
                    str(REPO / "native/metaio_writer.cpp"), "-o", str(so),
                    "-lz"], check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_LIB_PATH", so)
        mp.setattr(jn, "_lib", None)
        mp.setattr(jn, "_tried", False)
        assert jn.available()
        yield jn


def _payloads():
    rng = np.random.default_rng(7)
    sweep = (rng.random((6, 40, 52)) * 60).astype(np.uint8)
    sweep[:, 10:30, 12:40] += 120                   # structured, compressible
    return {"noise": (rng.random(50000) * 255).astype(np.uint8).tobytes(),
            "sweep": sweep.tobytes(),
            "zeros": bytes(70000),
            "one byte": b"\x07"}


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["noise", "sweep", "zeros", "one byte"])
def test_deflate_inflate_bytes(port_lib, jnative, kind, level):
    data = _payloads()[kind]
    got = port_lib.deflate(data, level)
    assert got == zlib.compress(data, level) == jnative.deflate(data, level)
    assert port_lib.inflate(got, len(data)) == data
    assert port_lib.inflate(zlib.compress(data, level), len(data)) == data
    np.testing.assert_array_equal(port_lib.inflate_into(got, len(data)),
                                  np.frombuffer(data, np.uint8))
    # a stream that does not fill the buffer is refused, for zlib to name
    assert port_lib.inflate(got, len(data) + 1) is None


def test_mha_bytes_native_python_and_jax(port_lib, tmp_path, monkeypatch):
    """The codec writes the same file through the native zlib, through
    Python's zlib and through the JAX package's codec, and reads it back
    either way."""
    vol = np.frombuffer(_payloads()["sweep"], np.uint8).reshape(6, 40, 52)
    img = MetaImage(vol, spacing=(0.28, 0.3, 1.0), offset=(1.5, -2.0, 0.0))
    native.reset_native_calls()
    write_mha(tmp_path / "native.mha", img)
    assert native.read_native_calls() == {"deflate": 1}
    j_write_mha(tmp_path / "jax.mha", JMetaImage(vol, spacing=img.spacing,
                                                 offset=img.offset))
    back = read_mha(tmp_path / "native.mha")
    assert native.read_native_calls() == {"deflate": 1, "inflate": 1}
    monkeypatch.setattr(native, "inflate_into", lambda *a: None)
    monkeypatch.setattr(native, "deflate", lambda *a: None)
    write_mha(tmp_path / "python.mha", img)
    raw = (tmp_path / "native.mha").read_bytes()
    assert raw == (tmp_path / "python.mha").read_bytes()
    assert raw == (tmp_path / "jax.mha").read_bytes()
    np.testing.assert_array_equal(back.array, vol)
    python_back = read_mha(tmp_path / "native.mha").array
    np.testing.assert_array_equal(python_back, vol)
    assert native.read_native_calls() == {"deflate": 1, "inflate": 1}
    # both paths hand out an array of their own (the native buffer, a copy
    # of zlib's bytes)
    assert back.array.flags.writeable and python_back.flags.writeable


@pytest.mark.parametrize("compressed", [True, False])
def test_metaio_cross_implementation(port_lib, jnative, tmp_path, compressed):
    """The C++ writer's files read back in the Python codec and the Python
    codec's in the C++ reader; the port's C++ writer writes the JAX
    package's bytes."""
    vol = (np.random.default_rng(11).random((5, 34, 46)) * 255).astype(
        np.uint8)
    kw = dict(spacing=(0.28, 0.28, 0.28), offset=(1.5, -2.0, 0.0),
              compressed=compressed)
    assert port_lib.write_mha_u8(tmp_path / "cpp.mha", vol, **kw)
    assert jnative.write_mha_u8(tmp_path / "jcpp.mha", vol, **kw)
    assert (tmp_path / "cpp.mha").read_bytes() == \
        (tmp_path / "jcpp.mha").read_bytes()
    img = read_mha(tmp_path / "cpp.mha")
    np.testing.assert_array_equal(img.array, vol)
    assert img.spacing == pytest.approx((0.28,) * 3)
    assert img.offset == pytest.approx((1.5, -2.0, 0.0))
    write_mha(tmp_path / "py.mha", MetaImage(vol, spacing=(0.28,) * 3),
              compressed=compressed)
    arr, spacing = port_lib.read_mha_u8(tmp_path / "py.mha")
    np.testing.assert_array_equal(arr, vol)
    assert spacing == pytest.approx((0.28,) * 3)


def _masks():
    yy, xx = np.mgrid[:48, :56]
    disk = ((yy - 24) ** 2 + (xx - 28) ** 2) <= 15 ** 2
    holed = disk & (((yy - 24) ** 2 + (xx - 28) ** 2) > 6 ** 2)
    border = np.zeros((30, 40), bool)
    border[0:12, 0:15] = True                       # touches two edges
    border[18:30, 25:40] = True                     # and the other two
    one = np.zeros((9, 9), bool)
    one[4, 6] = True
    rng = np.random.default_rng(3)
    from scipy import ndimage as ndi
    blob = ndi.binary_opening(rng.random((40, 40)) < 0.55, iterations=1)
    diagonal = np.eye(12, dtype=bool) | np.eye(12, k=1, dtype=bool)
    return {"disk with a hole": holed, "border contact": border,
            "one pixel": one, "empty": np.zeros((7, 8), bool),
            "random blobs": blob, "diagonal strip": diagonal,
            "full frame": np.ones((5, 6), bool)}


@pytest.mark.parametrize("name", list(_masks()))
def test_trace_contour_native_python_jax(port_lib, jnative, name):
    mask = _masks()[name].astype(np.uint8)
    got = port_lib.trace_contour(mask)
    py = trace_contour_python(mask)
    assert got.dtype == py.dtype == np.int32
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(got, jnative.trace_contour(mask))
    np.testing.assert_array_equal(got, j_trace_contour(mask))
    np.testing.assert_array_equal(trace_contour(mask * 255), py)
    if name == "empty":
        assert got.shape == (0, 2)
    if name == "one pixel":
        assert got.tolist() == [[6, 4]]


def test_image_ops_match_the_jax_binding(port_lib, jnative):
    rng = np.random.default_rng(5)
    img = (rng.random((50, 61)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(port_lib.clahe_u8(img, 1.0, (8, 8)),
                                  jnative.clahe_u8(img, 1.0, (8, 8)))
    np.testing.assert_array_equal(port_lib.median3_u8(img),
                                  jnative.median3_u8(img))
    m = (rng.random((48, 48)) < 0.35).astype(np.uint8)
    for conn in (4, 8):
        (la, na), (lb, nb) = port_lib.label(m, conn), jnative.label(m, conn)
        assert na == nb
        np.testing.assert_array_equal(la, lb)
        (ca, sa), (cb, sb) = (port_lib.largest_component(m, conn),
                              jnative.largest_component(m, conn))
        assert sa == sb
        np.testing.assert_array_equal(ca, cb)
    holed = _masks()["disk with a hole"]
    from scipy import ndimage as ndi
    np.testing.assert_array_equal(port_lib.fill_holes(holed),
                                  ndi.binary_fill_holes(holed).astype(np.uint8))


def test_library_is_named_by_the_sources(port_lib, tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libhostops-") and path.suffix == ".so"
    assert not list(native.BUILD_DIR.glob("libhostops-*.tmp"))
    for name in native.SOURCES:
        shutil.copy(native.CSRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    assert native.library_path() == path
    with open(tmp_path / "host_ops.cpp", "a") as f:
        f.write("// an edit\n")
    assert native.library_path() != path


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Three processes that find no library build one under the lock; each
    loads a whole one."""
    code = ("import sys; from pathlib import Path; "
            "from att_aspp_unet_tpu_torch.utils import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "assert native.available(); print(native.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [outs[0][0].strip()]
    assert not list(tmp_path.glob("*.tmp"))


def test_fallback_is_python_with_one_warning(tmp_path, monkeypatch, capsys):
    """Without a compiler the codec and the tracer run in Python, and the
    process says so once."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    vol = np.frombuffer(_payloads()["sweep"], np.uint8).reshape(6, 40, 52)
    native.reset_native_calls()
    write_mha(tmp_path / "x.mha", MetaImage(vol))
    np.testing.assert_array_equal(read_mha(tmp_path / "x.mha").array, vol)
    mask = _masks()["disk with a hole"]
    np.testing.assert_array_equal(trace_contour(mask),
                                  trace_contour_python(mask))
    assert not native.available()
    assert native.read_native_calls() == {}
    err = capsys.readouterr().err.splitlines()
    warns = [e for e in err if e.startswith("[warn] native host ops")]
    assert len(warns) == 1 and "no-such-g++" in warns[0]
    assert port_mha._deflate(b"abc", 6) == zlib.compress(b"abc", 6)


def test_select_traces_natively(port_lib):
    """The best-frame selection's circularity ranking traces its candidates
    in the library."""
    from att_aspp_unet_tpu_torch.postprocess.select import \
        select_best_frame_exact

    masks = np.stack([_masks()["disk with a hole"].astype(np.uint8)] * 4)
    masks[1, :, :20] = 0
    native.reset_native_calls()
    select_best_frame_exact(masks)
    assert native.read_native_calls().get("trace_contour", 0) >= 1
