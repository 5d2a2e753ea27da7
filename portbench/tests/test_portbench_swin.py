"""CPU tests of the Swin UNETR configuration (``configs/swinunetr2d_f48``):
its work counts against ``torch.utils.flop_counter.FlopCounterMode`` on the
plain reference and against the shapes the port's window attention sees,
the weight draw, and the comparison that decides ``correct`` at a tiny size
(port and reference agree; a broken path and the float8 control do not)."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import swin_unetr as ref  # noqa: E402

SWIN = harness.load_module(harness.PKG / "configs" / "swinunetr2d_f48.py")
CFG = json.loads((harness.PKG / "configs" / "swinunetr2d_f48.json")
                 .read_text())
SEED = 2 ** 31 + 4321


def _small(feature_size, tile, **kw):
    heads = kw.pop("num_heads", CFG["num_heads"])
    return dict(CFG, feature_size=feature_size, tile=list(tile),
                num_heads=heads, **kw)


@pytest.mark.parametrize("feature_size,tile", [(12, (64, 96)),
                                               (12, (128, 160)),
                                               (24, (96, 64))])
def test_flops_equal_the_flop_counter_on_the_reference(feature_size, tile):
    """Every conv, transposed conv, linear and attention product the
    reference runs on one tile; the counter leaves out the elementwise ops
    (norms, GELU, softmax, adds), as ``swin_unetr_flops`` does."""
    cfg = _small(feature_size, tile)
    model = ref.SwinUNETR(1, 3, feature_size).eval()
    with FlopCounterMode(display=False) as fc:
        model(torch.zeros(1, 1, *tile))
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert SWIN.swin_unetr_flops(cfg) == fc.get_total_flops()
    assert SWIN.window_attention_work(cfg)[0] == by_op["aten.bmm"]


def test_published_widths_count():
    """139 GFLOP a 448 x 576 tile view; the window attention's products
    2.36 GFLOP of it; 311 TFLOP a 140-frame sweep of 562 x 744 (4 tiles x
    4 mirror views a frame)."""
    assert SWIN.swin_unetr_flops(CFG) == pytest.approx(138.92e9, rel=1e-4)
    flops, nbytes, bias = SWIN.window_attention_work(CFG)
    assert flops == pytest.approx(2.3603e9, rel=1e-4)
    traffic = json.loads((harness.PKG / "traffic" / "sweep140.json")
                         .read_text())
    work = SWIN.request_work(CFG, traffic)
    assert work["flops"] == 140 * 4 * 4 * SWIN.swin_unetr_flops(CFG)
    assert work["wattn_bytes"] == 140 * 16 * nbytes + 18 * bias
    assert work["k2_stacks"] == [(140, 562, 744, (8, 8))]


def test_window_attention_bytes_follow_from_the_shapes(monkeypatch):
    """q, k and v read and the output written for the map's own tokens in
    bf16, each call's (heads, 64, 64) f32 bias, and the products over the
    padded windows, for every ``window_attn`` call of the port's forward:
    ``window_attention_work`` of the same tile."""
    from att_aspp_unet_tpu_torch.config import SwinUNETRConfig
    from att_aspp_unet_tpu_torch.models import swin_unetr as sw

    seen = []
    real = sw.window_attn

    def spy(qkv, qkv_bias, table, index, heads, window, shift):
        B, H, W, C3 = qkv.shape
        C = C3 // 3
        ws, _ = sw.window_and_shift((H, W), window, shift)
        padded = B * (H + -H % ws[0]) * (W + -W % ws[1])
        seen.append((4 * B * H * W * C * 2, heads * 64 * 64 * 4,
                     4.0 * ws[0] * ws[1] * C * padded))
        return real(qkv, qkv_bias, table, index, heads, window, shift)

    monkeypatch.setattr(sw, "window_attn", spy)
    cfg = _small(12, (64, 96))
    model = sw.SwinUNETR(SwinUNETRConfig(feature_size=12))
    model(torch.zeros(1, 1, 64, 96))
    flops, nbytes, bias = SWIN.window_attention_work(cfg)
    assert len(seen) == sum(CFG["depths"])
    assert sum(s[0] for s in seen) == nbytes
    assert sum(s[1] for s in seen) == bias
    assert sum(s[2] for s in seen) == flops


def test_the_weight_draw():
    sd = SWIN.make_weights(CFG, "cpu")
    model = ref.SwinUNETR(1, 3, 48)
    assert set(sd) == set(model.state_dict())
    q = sd["swinViT.layers1.0.blocks.0.attn.qkv.weight"].float()
    assert sd["swinViT.layers1.0.blocks.0.attn.qkv.weight"].dtype == \
        torch.bfloat16
    assert float(q.std()) == pytest.approx(48 ** -0.5, rel=0.05)
    table = sd["swinViT.layers4.0.blocks.1.attn.relative_position_bias_table"]
    assert table.shape == (169, 24) and float(table.std()) == \
        pytest.approx(1.0, rel=0.1)
    assert torch.equal(sd["encoder1.layer.norm1.weight"], torch.ones(48))
    assert not sd["swinViT.layers1.0.blocks.0.attn.qkv.bias"].any()
    assert torch.equal(sd["swinViT.layers1.0.blocks.0.attn."
                          "relative_position_index"],
                       ref.relative_position_index(7))


def _tiny() -> harness.Cell:
    """The cell at feature size 12 on 64 x 96 tiles of 70 x 100 frames, one
    distinct sweep (a loaded CPU may serve a single request in the window,
    which is then the judged one).  Its gaps are smaller than at the
    published widths (the program reads 0.001-0.005 here, the float8
    control 0.03-0.06), so its limit is 0.02, between the two, in place of
    the cell's."""
    cell = harness.find_cell("swinunetr2d-sweep140")
    cell.config = dict(cell.config, feature_size=12, tile=[64, 96],
                       tile_batch=4)
    cell.traffic = dict(cell.traffic, frames_per_sweep=6, height=70,
                        width=100, distinct=1, warmup_requests=1)
    cell.limits = {"served_gap": 0.02}
    return cell


def _run(cell, **kw):
    return harness.execute(cell, SEED, kw.pop("seconds", 8.0), False, "cpu",
                           time.perf_counter(), **kw)


class _Altered:
    """The system with its labels' classes swapped where they are
    produced."""

    def __init__(self, system):
        self.system = system

    def submit(self, x):
        return self.system.submit(x)

    def collect(self, handle, keep):
        frame, mask, labels = self.system.collect(handle, keep)
        if labels is not None:
            labels = torch.as_tensor(labels)
            labels = torch.where(labels == 1, 2,
                                 torch.where(labels == 2, 1, labels))
        return frame, mask, labels

    def counters(self):
        return self.system.counters()

    def close(self):
        self.system.close()


def test_port_reference_fault_and_control():
    """At a tiny size the port agrees with the reference; with its answers
    altered it does not; the float8 control in its place reads not
    correct, above the program."""
    prog, ctl = {}, {}
    line = _run(_tiny(), notes=prog)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert not _run(_tiny(), wrap=_Altered)["correct"]
    line = _run(_tiny(), seconds=12.0, control=True, notes=ctl)
    assert not line["correct"], line["checks"]
    assert ctl["numbers"]["served_gap"] > prog["numbers"]["served_gap"]


def test_padding_share_from_the_counters():
    reader = harness.load_module(harness.PKG / "metrics" /
                                 "wattn_pad_share.swin.py")
    ctx = {"counters": ({"window_attn_tokens": 10,
                         "window_attn_pad_tokens": 1},
                        {"window_attn_tokens": 87808 * 2 + 10,
                         "window_attn_pad_tokens": 2128 * 2 + 1})}
    assert reader.read(ctx) == pytest.approx(100 * 2128 / 87808)
    assert reader.read({"counters": ({}, {})}) is None


def test_roofline_reads_only_its_kernels():
    reader = harness.load_module(harness.PKG / "metrics" /
                                 "wattn_roofline.swin.py")
    work = {"wattn_flops": 989e9, "wattn_bytes": 3.35e9}   # 1 ms each
    trace = {"kernel_s": {"cudnn_generated_fort_native_sdpa_sm90_x": 0.004,
                          "sm90_xmma_fprop_implicit_gemm": 1.0}}
    ctx = {"trace": trace, "work": work, "traced": [0, 1]}
    assert reader.read(ctx) == pytest.approx(50.0)
    trace["kernel_s"] = {"sm90_xmma_fprop_implicit_gemm": 1.0}
    assert reader.read(ctx) is None
    assert reader.read({"trace": None}) is None
    assert np.isfinite(SWIN.window_attention_work(CFG)[1])


def _two_blobs(second: int) -> torch.Tensor:
    """(N, C, H, W) probabilities with two class-1 blobs of 100 and
    ``second`` voxels, far apart."""
    sm = torch.zeros(4, 3, 20, 40)
    sm[:, 0] = 1.0
    a = torch.zeros(4, 20, 40, dtype=torch.bool)
    a[:, :5, :5] = True                                 # 100 voxels
    b = torch.zeros_like(a)
    flat = b.view(4, -1)
    n = 0
    for f in range(4):                       # ``second`` voxels, one block
        for i in range(10, 20):
            for j in range(30, 40):
                if n < second:
                    flat[f, i * 40 + j] = True
                    n += 1
    for m in (a, b):
        sm[:, 0][m] = 0.0
        sm[:, 1][m] = 1.0
    return sm


@pytest.mark.parametrize("second,tied", [(99, True), (90, False)])
def test_the_judge_takes_either_of_two_tied_components(second, tied):
    """Components within ``TIE`` of the largest are each a valid pick; a
    clearly smaller one is not."""
    from portbench.reference.nnunet import labels_3d

    sm = _two_blobs(second)
    choices = SWIN.tied_labelings(sm, 0.5)
    assert np.array_equal(choices[0], labels_3d(sm, 0.5))
    assert len(choices) == (2 if tied else 1)
    other = (sm[:, 1] > 0.5).numpy() & (choices[0] == 0)
    served = np.where(other, 1, 0).astype(np.uint8)
    best = min(SWIN.gaps(0, served, ref) for ref in choices)
    if tied:
        assert best == (0.0, 0.0)
    else:
        assert best[0] > 1.0


def test_tied_labelings_agree_with_labels_3d_without_ties():
    from portbench.reference.nnunet import labels_3d

    gen = torch.Generator().manual_seed(4)
    sm = torch.softmax(3 * torch.randn(6, 3, 24, 30, generator=gen), 1)
    choices = SWIN.tied_labelings(sm, 0.5)
    assert np.array_equal(choices[0], labels_3d(sm, 0.5))
