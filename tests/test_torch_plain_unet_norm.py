"""The dispatch of ``ops/kernels/instance_norm.py::conv_norm_act``, which
nnU-Net's ``ConvNormAct`` calls, between the port's InstanceNorm + LeakyReLU
kernels and :class:`InstanceNorm` with ``leaky_relu_``, on the CPU: which
maps qualify, that every other case keeps the plain arithmetic, and that a
forward of the plan's network sends each of its 26 norms to the kernel
where the maps qualify.  The kernels
themselves are held against their plain version on a card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from att_aspp_unet_tpu_torch.config import PlainUNetConfig
from att_aspp_unet_tpu_torch.models.plain_unet import (ConvNormAct,
                                                       PlainConvUNet)
from att_aspp_unet_tpu_torch.ops.kernels import instance_norm

from .test_torch_threads import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32


class _Spy:
    """Stands in for the kernel entry: records each call's channel count and
    returns the plain result (from the map in the layout the conv gave it,
    so that the arithmetic is the plain path's to the bit)."""

    def __init__(self):
        self.channels = []

    def __call__(self, y, norm, slope):
        assert y.is_contiguous(memory_format=torch.channels_last)
        self.channels.append(y.shape[1])
        return F.leaky_relu(norm(y.contiguous()), slope)


def _map(cuda, dtype, C):
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(2, C, 7, 9))


@pytest.mark.parametrize("cuda,dtype,C,param,want", [
    (True, BF16, 32, F32, True),
    (True, BF16, 512, F32, True),
    (True, BF16, 2048, F32, True),
    (True, F32, 32, F32, False),
    (True, BF16, 32, BF16, True),
    (False, BF16, 32, F32, False),
    (True, BF16, 12, F32, True),
    (True, BF16, 2056, F32, True),
])
def test_fused_norm_applies_only_where_the_kernel_takes_the_map(
        cuda, dtype, C, param, want):
    """The CPU and f32 maps keep the plain path; every bf16 map on a card
    goes to the kernels, also one they cannot take (12 or 2056 channels, or
    a bf16 affine ``param``, which the choice does not read), on which
    their entry raises instead of the block falling back unseen."""
    assert instance_norm.fused_norm_applies(_map(cuda, dtype, C)) is want


@pytest.mark.parametrize("dtype,param", [(BF16, F32), (F32, F32),
                                         (BF16, BF16)])
def test_conv_norm_act_keeps_the_plain_path_where_the_kernel_does_not_apply(
        monkeypatch, dtype, param):
    """On the CPU, with a bf16 or an f32 map and an f32 or a bf16 affine,
    the block calls no kernel and computes today's
    ``leaky_relu_(InstanceNorm(conv(x)))`` bit for bit."""
    spy = _Spy()
    monkeypatch.setattr(instance_norm, "instance_norm_act", spy)
    gen = torch.Generator().manual_seed(5)
    blk = ConvNormAct(8, 16, 1, device="cpu", dtype=dtype, param_dtype=param)
    with torch.no_grad():
        blk.conv.weight.copy_(torch.randn(blk.conv.weight.shape,
                                          generator=gen) * 0.2)
        blk.norm.weight.copy_(torch.rand(16, generator=gen) + 0.5)
        blk.norm.bias.copy_(torch.randn(16, generator=gen))
        x = torch.randn(2, 8, 12, 10, generator=gen).to(dtype)
        got = blk(x)
        want = F.leaky_relu_(blk.norm(F.conv2d(x, blk.conv.weight, None, 1,
                                               1)), 0.01)
    assert spy.channels == []
    assert got.dtype == dtype and torch.equal(got, want)


def test_plan_forward_sends_each_of_its_26_norms_to_the_kernel(monkeypatch):
    """The plan's 7 stages (32 -> 512 features): with every map taken as
    qualifying, one forward calls the kernel entry once per conv block, 26
    times, encoder then decoder, and gives the plain forward's logits."""
    cfg = PlainUNetConfig()
    model = PlainConvUNet.from_config(cfg, seed=0)
    x = torch.randn(1, 1, 64, 64, generator=torch.Generator().manual_seed(2))
    want = model(x)
    spy = _Spy()
    monkeypatch.setattr(instance_norm, "fused_norm_applies", lambda y: True)
    monkeypatch.setattr(instance_norm, "instance_norm_act", spy)
    got = model(x)
    feats = [min(cfg.base_c * 2 ** s, cfg.max_c) for s in range(cfg.n_stages)]
    encoder = [f for f in feats for _ in range(cfg.conv_per_stage)]
    decoder = [f for f in feats[-2::-1] for _ in range(cfg.conv_per_stage)]
    assert spy.channels == encoder + decoder
    assert spy.channels[:4] == [32, 32, 64, 64] and len(spy.channels) == 26
    assert sum(isinstance(m, ConvNormAct) for m in model.modules()) == 26
    torch.testing.assert_close(got, want, rtol=0, atol=0)
