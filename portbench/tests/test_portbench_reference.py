"""CPU tests of the comparison that decides ``correct``: at tiny sizes the
port (its kernels' plain versions) and the plain reference agree for each
configuration; a run whose timed path is broken underneath comes out not
correct, once per fault a serving cell can have (an answer altered where it
is produced; part of each request's frames left out); and each cell's
control reads above the program.  The harness's look for a card is skipped:
these tests drive ``harness.execute`` on the CPU."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SEED = 2 ** 31 + 1234


def _tiny_attaspp(traffic: str) -> harness.Cell:
    """The cell at a size the CPU runs in seconds: the distilled scout's
    weights (base_c 16, trained at 128 px) serve as the main model too, at
    128 px, on 140 x 186 frames, so that the abdomen has the size in the
    model's input that training gave it (at 562 x 744 -> 128 px)."""
    cell = harness.find_cell({"cascade_case840": "attaspp-cascade-case840",
                              "direct_tta_sweep140":
                              "attaspp-direct-tta-sweep140"}[traffic])
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["weights"] = cell.config["scout"]["weights"]
    cell.config["model"].update(base_c=16, img_size=128)
    cell.traffic = dict(cell.traffic, frames_per_sweep=20, height=140,
                        width=186, distinct=2, warmup_requests=1,
                        in_flight=1, sweeps_per_request=min(
                            2, cell.traffic["sweeps_per_request"]))
    return cell


def _tiny_nnunet() -> harness.Cell:
    cell = harness.find_cell("nnunet2d-sweep140")
    cell.config = dict(cell.config, UNet_base_num_features=4,
                       unet_max_num_features=16, n_stages=3,
                       patch_size=[32, 48], n_conv_per_stage_encoder=[2] * 3,
                       tile_batch=4)
    cell.traffic = dict(cell.traffic, frames_per_sweep=6, height=40,
                        width=60, distinct=3, warmup_requests=1)
    return cell


def _run(cell, wrap=None, seconds=6.0, **kw):
    return harness.execute(cell, SEED, seconds, False, "cpu",
                           time.perf_counter(), wrap=wrap, **kw)


@pytest.mark.parametrize("traffic", ["cascade_case840",
                                     "direct_tta_sweep140"])
def test_attaspp_port_and_reference_agree(traffic):
    line = _run(_tiny_attaspp(traffic))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    # the port's plain versions on the CPU compute in bf16 as on the card:
    # a few boundary pixels move, by about what the card's runs read
    # (0.0023-0.0061, the largest over every judged request)
    assert line["checks"]["served_gap"]["value"] < 0.005


def test_nnunet_port_and_reference_agree():
    line = _run(_tiny_nnunet(), seconds=4.0)
    # the port serves bf16 on the CPU too: at this 3-stage, 4-feature plan
    # about 1 % of the foreground voxels move (on the card, at the plan's
    # widths, 4.6-5.0 %)
    assert line["correct"], line["checks"]
    assert line["checks"]["served_gap"]["value"] < 0.05
    assert line["failed"] == 0


class _Altered:
    """The system with every answer altered where it is produced: the
    served mask shifted by 4 px and the labels' classes swapped."""

    def __init__(self, system):
        self.system = system

    def submit(self, x):
        return self.system.submit(x)

    def collect(self, handle, keep):
        frame, mask, third = self.system.collect(handle, keep)
        if isinstance(third, float):               # (frame, mask, ac)
            return frame, np.roll(mask, 4, axis=-1), third
        if third is not None:
            third = torch.as_tensor(third)
            third = torch.where(third == 1, 2, torch.where(third == 2, 1,
                                                           third))
        return frame, mask, third

    def counters(self):
        return self.system.counters()

    def close(self):
        self.system.close()


class _HalfFrames(_Altered):
    """The system fed every other frame of each request only."""

    def submit(self, x):
        return self.system.submit(np.ascontiguousarray(x[::2]))

    def collect(self, handle, keep):
        return self.system.collect(handle, keep)


class _OneInputAltered(_Altered):
    """The system with the masks of one distinct input's requests altered
    (a fault in part of the requests, such as a wrong tail micro-batch)."""

    def submit(self, x):
        return x[:1].copy(), self.system.submit(x)

    def collect(self, handle, keep):
        first, handle = handle
        frame, mask, ac = self.system.collect(handle, keep)
        if not hasattr(self, "marked"):
            self.marked = first
        if np.array_equal(first, self.marked):
            mask = np.roll(mask, 4, axis=-1)
        return frame, mask, ac


@pytest.mark.parametrize("fault", [_Altered, _HalfFrames, _OneInputAltered])
@pytest.mark.parametrize("traffic", ["cascade_case840",
                                     "direct_tta_sweep140"])
def test_a_broken_attaspp_path_is_not_correct(fault, traffic):
    cell = _tiny_attaspp(traffic)
    if fault is _OneInputAltered:           # 1 of 4 inputs: not a majority
        cell.traffic = dict(cell.traffic, distinct=4)
    cell.limits = json.loads((cell.base / "limits" / f"{cell.name}.json")
                             .read_text())
    line = _run(cell, wrap=fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_Altered, _HalfFrames])
def test_a_broken_nnunet_path_is_not_correct(fault):
    line = _run(_tiny_nnunet(), wrap=fault, seconds=4.0)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("which", ["cascade_case840", "direct_tta_sweep140",
                                   "nnunet"])
def test_the_control_in_the_programs_place_is_not_correct(which):
    """The cell's lower-precision control (the reference with its convs in
    float8) served through the same run as the program comes out not
    correct, and reads above the program on the same seed."""
    cell = _tiny_nnunet() if which == "nnunet" else _tiny_attaspp(which)
    seconds = 4.0 if which == "nnunet" else 6.0
    prog, ctl = {}, {}
    assert _run(cell, seconds=seconds, notes=prog)["correct"]
    # the control computes in f32 with its float8 rounding on the CPU, a few
    # times slower than the program: a longer window still serves two
    # requests on a loaded CPU
    line = _run(cell, seconds=2 * seconds, control=True, notes=ctl)
    assert not line["correct"], line["checks"]
    assert line["failed"] == 0 and ctl["judged"] >= 2
    assert ctl["numbers"]["served_gap"] > prog["numbers"]["served_gap"], \
        (prog, ctl)
