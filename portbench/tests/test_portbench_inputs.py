"""CPU test of the input generator: its sweeps have the statistics of the
port's host generator (``tools/synthetic.make_sweep``) at a small size, and
the same seed gives the same sweep.

Tolerances: over four seeds of 40 frames of 96 x 128, the host generator's
own seeds spread by about 0.6 % in the mean intensity, 2 % in the standard
deviation, 0.001 in the share of zero pixels (the fan) and 4 grey levels in
the 99th percentile; the bounds below are about twice those spreads, so a
generator that drops or doubles a component (the rim, a distractor, the
fan, the speckle gain) falls outside them."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.inputs.sweeps import make_sweep  # noqa: E402

SEEDS = (1000, 1001, 1002, 1003)


def _stats(frames: np.ndarray) -> dict:
    x = frames.astype(np.float64)
    return {"mean": x.mean(), "std": x.std(), "zero": (x == 0).mean(),
            "p99": np.percentile(x, 99)}


@pytest.fixture(scope="module")
def pair():
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep as host

    ours = [make_sweep(40, 96, 128, s, "cpu") for s in SEEDS]
    theirs = [host(40, 96, 128, seed=s)[:2] for s in SEEDS]
    return ours, theirs


def test_statistics_match_the_host_generator(pair):
    ours, theirs = pair
    a = _stats(np.concatenate([f.numpy() for f, _ in ours]))
    b = _stats(np.concatenate([f for f, _ in theirs]))
    assert a["mean"] == pytest.approx(b["mean"], rel=0.015)
    assert a["std"] == pytest.approx(b["std"], rel=0.04)
    assert a["zero"] == pytest.approx(b["zero"], abs=0.002)
    assert abs(a["p99"] - b["p99"]) <= 8


def test_the_ramp_peaks_where_the_rim_is_brightest(pair):
    """One ramp per sweep: the peak frame lies in [0.3 n, 0.7 n), and frames
    near it (rim at full contrast) are brighter than frames far from it
    (no abdomen) in the share of bright pixels the rim adds, as in the host
    generator."""
    for frames, best in pair[0] + pair[1]:
        frames = np.asarray(frames, np.float64)
        assert 12 <= best < 28
        fm = (frames > 120).mean(axis=(1, 2))
        near = fm[best - 2:best + 3].mean()
        far = np.concatenate([fm[:3], fm[-3:]]).mean()
        assert near > far


def test_the_same_seed_gives_the_same_sweep():
    a, ba = make_sweep(12, 64, 80, 2 ** 31 + 5, "cpu")
    b, bb = make_sweep(12, 64, 80, 2 ** 31 + 5, "cpu")
    c, _ = make_sweep(12, 64, 80, 2 ** 31 + 6, "cpu")
    assert ba == bb and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.shape == (12, 64, 80)


def test_a_content_pool_serves_the_same_inputs_in_a_seeded_order():
    """With ``content_seed`` every seed gets the same set of inputs, in an
    order its own seed draws; without it the content follows the seed."""
    from portbench.harness import make_inputs

    traffic = dict(sweeps_per_request=1, frames_per_sweep=3, height=32,
                   width=40, distinct=5)
    pooled = dict(traffic, content_seed=300)
    a, b, a2 = (make_inputs(pooled, s, "cpu")
                for s in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 11))
    key = lambda xs: sorted(x.tobytes() for x in xs)   # noqa: E731
    assert key(a) == key(b)
    assert [x.tobytes() for x in a] != [x.tobytes() for x in b]
    assert [x.tobytes() for x in a] == [x.tobytes() for x in a2]
    c, d = (make_inputs(traffic, s, "cpu") for s in (2 ** 31 + 11,
                                                      2 ** 31 + 12))
    assert key(c) != key(d)
