"""The staged upload (``infer/staging.py``) on the CPU: the ring of pinned
slots, driven through stand-ins for CUDA's streams and events, and the
engine's upload path on and off it.

The stand-in events finish only when a test says so, so that the slot waits
are the ring's own decisions; the uploads themselves run as CPU copies."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer import staging
from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
from att_aspp_unet_tpu_torch.utils import profiling
from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

from .test_torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = (Path(__file__).resolve().parents[1]
           / "resources/synthetic_scout_noclahe128/weights.npz")


class FakeEvent:
    """Recorded: not done until :meth:`finish` or a wait."""

    def __init__(self):
        self.done, self.waits = True, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True

    def record(self, stream):
        self.done = False
        stream.recorded.append(self)

    def finish(self):
        self.done = True


class FakeStream:
    def __init__(self):
        self.recorded, self.waited = [], []

    def wait_event(self, event):
        self.waited.append(event)


class FakeCuda:
    """What :class:`staging.Staging` asks of ``torch.cuda``."""

    def __init__(self):
        self.compute = FakeStream()
        self.current = self.compute

    def Stream(self, device):           # noqa: N802 - torch.cuda's name
        return FakeStream()

    def Event(self):                    # noqa: N802
        return FakeEvent()

    @contextlib.contextmanager
    def stream(self, s):
        before, self.current = self.current, s
        try:
            yield
        finally:
            self.current = before

    def current_stream(self, device):
        return self.current


def _ring():
    cuda = FakeCuda()
    return staging.Staging("cpu", cuda=cuda), cuda


def _delta(before, name):
    return profiling.counts().get(name, 0) - before.get(name, 0)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_slots_alternate_and_the_compute_stream_waits_on_each_copy():
    ring, cuda = _ring()
    before = profiling.counts()
    buffers = []
    for i in range(4):
        ring.upload(_u8((3, 5, 7), i))
        buffers.append(ring._slots[(ring._next - 1) % staging.SLOTS]
                       .data_ptr())
        cuda.compute.waited[-1].finish()
    e0, e1 = ring._events
    # each upload records its slot's event on the copy stream, and the
    # compute stream (not the host) waits on that event
    assert ring.stream.recorded == [e0, e1, e0, e1]
    assert cuda.compute.waited == [e0, e1, e0, e1]
    assert buffers[0] == buffers[2] != buffers[1] == buffers[3]
    assert cuda.current is cuda.compute
    assert _delta(before, "staged_uploads") == 4
    assert _delta(before, "upload_slot_waits") == 0


@pytest.mark.parametrize("finished", [True, False])
def test_waits_only_for_its_own_slot_unfinished(finished):
    """The second upload takes the other slot and never waits; the third
    reuses the first slot and waits exactly when that slot's copy has not
    finished."""
    ring, _ = _ring()
    before = profiling.counts()
    ring.upload(_u8((4, 6)))
    ring.upload(_u8((4, 6), 1))
    first, second = ring._events
    assert _delta(before, "upload_slot_waits") == 0
    assert first.waits == second.waits == 0
    if finished:
        first.finish()
    ring.upload(_u8((4, 6), 2))
    assert first.waits == int(not finished)
    assert second.waits == 0
    assert _delta(before, "upload_slot_waits") == int(not finished)


def test_a_slot_grows_for_a_larger_request_and_is_kept_for_smaller():
    ring, _ = _ring()
    for size in (100, 100, 40, 40, 400, 10):
        ring.upload(_u8((size, 3)))
        for e in ring._events:
            e.finish()
    assert [s.numel() for s in ring._slots] == [1200, 300]
    kept = ring._slots[1].data_ptr()
    ring.upload(_u8((20, 3)))
    ring.upload(_u8((20, 3)))
    assert ring._slots[1].data_ptr() == kept
    assert [s.numel() for s in ring._slots] == [1200, 300]


def _inputs():
    a = _u8((9, 6, 10))
    t = torch.from_numpy(_u8((10, 9, 6), 3))
    return {
        "contiguous": a,
        "strided": a[::2, :, 1::3],
        "transposed": a.transpose(1, 0, 2),
        "float32": np.random.default_rng(4).random((5, 7)).astype(np.float32),
        "bool": a > 128,
        "tensor": t,
        "tensor_strided": t.permute(2, 0, 1)[:, 1:],
        "list": [[1, 2, 3], [4, 5, 6]],
        "empty": np.zeros((0, 4, 4), np.uint8),
        "scalar": np.array(7, np.int64),
    }


@pytest.mark.parametrize("chunk", [staging.CHUNK_BYTES, 50])
@pytest.mark.parametrize("name", list(_inputs()))
def test_inputs_come_out_equal(monkeypatch, name, chunk):
    """Every input comes out equal, in its dtype and shape, whether in one
    chunk or many; the caller's array may change as soon as the call
    returns."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", chunk)
    data = _inputs()[name]
    want = (data.clone() if isinstance(data, torch.Tensor)
            else torch.as_tensor(np.array(data)))
    ring, _ = _ring()
    got = ring.upload(data)
    if isinstance(data, np.ndarray) and data.size:
        data[...] = 0
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_chunks_cover_the_rows_once():
    src = torch.zeros((10, 3, 4), dtype=torch.float32)     # 48-byte rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(staging, "CHUNK_BYTES", 100)
        parts = staging._chunks(src)
    assert parts == [slice(a, a + 2) for a in range(0, 10, 2)]
    assert staging._chunks(torch.zeros(())) == [...]


# ------------------------------------------------------------- the engine

N, H, W = 6, 40, 48


def _engine(**predict):
    cfg = Config(preprocess=PreprocessConfig(img_size=32),
                 model=ModelConfig(base_c=16),
                 predict=PredictConfig(frame_batch=4, **predict))
    return AttAsppEngine(cfg, load_npz_variables(WEIGHTS), device="cpu")


@pytest.fixture(scope="module")
def sweeps():
    return [_u8((N, H, W), seed) for seed in (10, 11)]


@pytest.fixture(scope="module")
def thr(sweeps):
    """A threshold from the data, so that the masks are not empty."""
    probs = _engine().predict_full(sweeps[0]).numpy()
    return float(np.quantile(probs, 0.8))


def test_a_cpu_engine_uploads_as_before(sweeps, thr):
    eng = _engine()
    assert eng._staging is None
    before = profiling.counts()
    got = eng._to_device(sweeps[0])
    assert torch.equal(got, torch.as_tensor(sweeps[0]))
    t = torch.from_numpy(sweeps[1])
    assert eng._to_device(t) is t
    eng.predict_case(sweeps[0], (0.28, 0.28), thr)
    assert _delta(before, "staged_uploads") == 0


@pytest.mark.parametrize("cascade", [True, False])
def test_staged_requests_serve_bit_equal(sweeps, thr, cascade):
    """Through the ring (stand-in streams), the cascade's requests, two in
    flight, serve the same frames, masks and ACs as the plain upload, and
    count one staged upload each; the direct path does not use the ring."""
    kw = dict(cascade=True, cascade_img_size=32, cascade_scouts=3,
              cascade_scout_batch=4) if cascade else {}
    eng = _engine(**kw)
    want = [eng.predict_case(s, (0.28, 0.28), thr) for s in sweeps]
    eng._staging, _ = _ring()
    before = profiling.counts()
    handles = [eng.predict_case_submit(s, thr) for s in sweeps]
    handles.append(eng.predict_case_submit(torch.from_numpy(sweeps[0]), thr))
    got = [eng.predict_case_collect(h, (0.28, 0.28)) for h in handles]
    for (f, m, ac), (fw, mw, acw) in zip(got, want + want[:1]):
        assert (f, ac) == (fw, acw)
        np.testing.assert_array_equal(m, mw)
        assert mw.any()
    assert _delta(before, "staged_uploads") == (3 if cascade else 0)
