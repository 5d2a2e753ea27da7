"""CPU tests of the work counts: the configurations' FLOP counts equal a
count by hooks on every conv of the plain reference models, and the
Attention-ASPP-UNet's count equals the port's ``bench.forward_gflops``."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import attaspp, nnunet  # noqa: E402

ATT = harness.load_module(harness.PKG / "configs" / "attaspp_b48_512.py")
NN = harness.load_module(harness.PKG / "configs" / "nnunet2d_dataset300.py")


def _hook_flops(model: nn.Module, x: torch.Tensor) -> float:
    """2 x multiply-adds of every Conv2d / ConvTranspose2d the forward runs,
    from the shapes they see."""
    total = [0.0]

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        cin, cout = mod.in_channels, mod.out_channels
        if isinstance(mod, nn.ConvTranspose2d):
            hw = inp[0].shape[-2] * inp[0].shape[-1]
        else:
            hw = out.shape[-2] * out.shape[-1]
        total[0] += 2.0 * k * cin * cout * hw * x.shape[0]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("base_c,size", [(4, 32), (8, 64), (16, 128)])
def test_attaspp_flops_equal_a_hook_count_on_the_reference(base_c, size):
    model = attaspp.AttentionASPPUNetV1(1, 1, base_c=base_c).eval()
    got = _hook_flops(model, torch.zeros(1, 1, size, size))
    assert ATT.forward_gflops(base_c, size) * 1e9 == pytest.approx(
        got, rel=1e-12)
    assert ATT.forward_gflops(base_c, size, tta=True) == pytest.approx(
        2 * got / 1e9, rel=1e-12)


@pytest.mark.parametrize("base_c,size,tta", [(48, 512, False),
                                             (48, 512, True),
                                             (16, 128, False)])
def test_attaspp_flops_equal_the_twins(base_c, size, tta):
    from att_aspp_unet_tpu_torch.bench import forward_gflops

    assert ATT.forward_gflops(base_c, size, tta) == forward_gflops(
        base_c, size, tta=tta)


def test_nnunet_flops_equal_a_count_of_the_reference_convs(monkeypatch):
    """The reference PlainConvUNet calls ``F.conv2d`` and
    ``F.conv_transpose2d`` itself: count those calls' work."""
    cfg = json.loads((harness.PKG / "configs"
                      / "nnunet2d_dataset300.json").read_text())
    cfg.update(UNet_base_num_features=4, unet_max_num_features=16,
               n_stages=4, patch_size=[32, 48],
               n_conv_per_stage_encoder=[2] * 4)
    model = NN._reference_model(cfg, "cpu")
    total = [0.0]
    conv, convT = nnunet.F.conv2d, nnunet.F.conv_transpose2d

    def counted(fn, transposed):
        def run(x, w, *a, **kw):
            out = fn(x, w, *a, **kw)
            k = w.shape[-2] * w.shape[-1]
            cin, cout = (w.shape[0], w.shape[1]) if transposed else \
                (w.shape[1], w.shape[0])
            hw = (x if transposed else out).shape[-2:]
            total[0] += 2.0 * k * cin * cout * hw[0] * hw[1] * x.shape[0]
            return out
        return run

    monkeypatch.setattr(nnunet.F, "conv2d", counted(conv, False))
    monkeypatch.setattr(nnunet.F, "conv_transpose2d", counted(convT, True))
    model(torch.zeros(1, 1, 32, 48))
    assert NN.plain_unet_flops(cfg) == pytest.approx(total[0], rel=1e-12)


def test_request_work_of_the_cells():
    """The cells' work per request, from their traffic: the cascade's scout
    runs 840 frames in micro-batches of 128 (the engine's rule keeps 128:
    the last batch wastes 56 <= 210 frames) and the main model 8 frames; the
    direct path 140 frames twice (TTA) in micro-batches of 16."""
    for name, want_k1 in (("attaspp-cascade-case840",
                           [(16, 128, 128)] * 6 + [(16, 128, 72),
                                                   (48, 512, 8)]),
                          ("attaspp-direct-tta-sweep140",
                           [(48, 512, 32)] * 8 + [(48, 512, 24)])):
        cell = harness.find_cell(name)
        work = cell.config_mod.request_work(cell.config, cell.traffic)
        assert work["k1_batches"] == want_k1
    cas = harness.find_cell("attaspp-cascade-case840")
    work = cas.config_mod.request_work(cas.config, cas.traffic)
    assert work["k2_stacks"] == [(8, 562, 744, (8, 8))]
    assert work["flops"] == pytest.approx(
        1e9 * (840 * ATT.forward_gflops(16, 128)
               + 8 * ATT.forward_gflops(48, 512)))
    base = harness.find_cell("nnunet2d-sweep140")
    work = base.config_mod.request_work(base.config, base.traffic)
    assert work["flops"] == pytest.approx(
        140 * 4 * 4 * NN.plain_unet_flops(base.config))
    assert work["k1_batches"] == []
