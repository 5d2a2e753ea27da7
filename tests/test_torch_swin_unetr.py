"""The port's SwinUNETR (``models/swin_unetr.py``) against the plain f32
oracle of ``tests/torch_ref.py``, in f32 and in bf16; on the labeled path
(``BaselineEngine``, the container's ``MODEL_TAG=swin_unetr``) against the
benchmark's reference pipeline; its spans and window-attention counters.

The small model is feature size 12 on 64 x 96 tiles: stage maps of 32 x 48,
16 x 24, 8 x 12 and 4 x 6, so that stages 0-2 pad to whole 7 x 7 windows and
run shifted and unshifted blocks, and stage 3 (4 x 6, shorter than the
window) takes its map as its window with no shift, as MONAI does."""

import copy
import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from att_aspp_unet_tpu_torch.config import (Config, ContainerConfig,
                                            PlainUNetConfig, SwinUNETRConfig)
from att_aspp_unet_tpu_torch.infer import container
from att_aspp_unet_tpu_torch.infer.models import load_swin_unetr
from att_aspp_unet_tpu_torch.infer.engine import BaselineEngine
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, write_mha
from att_aspp_unet_tpu_torch.models import swin_unetr as sw
from att_aspp_unet_tpu_torch.ops.kernels import window_attn as wa
from att_aspp_unet_tpu_torch.models.plain_unet import PlainConvUNet
from att_aspp_unet_tpu_torch.utils import profiling
from portbench.reference import nnunet as ref_nnunet
from portbench.reference import ops as ref_ops
from portbench.reference import swin_unetr as bench_ref

from . import torch_ref
from .test_torch_threads import one_torch_thread  # noqa: F401

FEATURES = 12
TILE = (64, 96)
# the labeled path's tiles, which either network takes
PLAIN = PlainUNetConfig(patch_size=TILE, tile_batch=4)
# bf16 against f32: the relative RMS error of the logits.  bf16 keeps 8
# mantissa bits (a rounding moves a value by up to 0.4 %); through the four
# stages' blocks, their LayerNorms and the ten residual conv blocks the
# logits' relative RMS error read 1.6-2.2 % on three seeds.  A model with
# the relative-position bias zeroed or the shift mask dropped read 9-36 %.
BF16_RTOL = 0.04


def _cfg(dtype="float32"):
    return SwinUNETRConfig(feature_size=FEATURES, compute_dtype=dtype)


def _config(model: sw.SwinUNETR, **kw) -> Config:
    return Config(swin_unetr=model.cfg, plain_unet=PLAIN, **kw)


def _seeded(seed: int, dtype="float32") -> sw.SwinUNETR:
    """The small model from the seeded init, with every bias and LayerNorm
    and InstanceNorm affine moved off 0 and 1, so that each is exercised."""
    model = sw.SwinUNETR.from_config(_cfg(dtype), seed=seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _oracle(model: sw.SwinUNETR) -> torch_ref.SwinUNETR:
    ref = torch_ref.SwinUNETR(1, 3, FEATURES).eval()
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in model.state_dict().items()})
    return ref


def _tiles(seed: int, n: int = 4) -> torch.Tensor:
    return torch.rand(n, 1, *TILE,
                      generator=torch.Generator().manual_seed(seed))


def _rel_rms(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference_in_f32(seed):
    model = _seeded(seed)
    x = _tiles(seed)
    got, want = model(x), _oracle(model)(x)
    assert got.shape == (4, 3, *TILE) and got.dtype == \
        torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _drop_bias(model):
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, sw.WindowAttention):
                mod.relative_position_bias_table.zero_()
    return model


@pytest.mark.parametrize("fault", [None, "bias", "mask"])
def test_bf16_within_its_tolerance_and_a_broken_attention_outside(
        fault, monkeypatch):
    """The bf16 model within ``BF16_RTOL`` of the f32 oracle; a copy with
    the relative-position bias zeroed, or with the shift mask dropped,
    outside it."""
    f32 = _seeded(2)
    x = _tiles(2)
    want = _oracle(f32)(x)
    bf16 = sw.SwinUNETR(_cfg("bfloat16"))
    bf16.load_state_dict(f32.state_dict())
    if fault == "bias":
        bf16 = _drop_bias(copy.deepcopy(bf16))
    elif fault == "mask":
        real = wa.region_ids
        monkeypatch.setattr(wa, "region_ids",
                            lambda *a, **k: torch.zeros_like(real(*a, **k)))
    err = _rel_rms(bf16(x), want)
    if fault is None:
        assert err < BF16_RTOL
    else:
        assert err > BF16_RTOL, fault


def test_the_two_reference_copies_are_bit_equal():
    model = _seeded(3)
    a = _oracle(model)
    b = bench_ref.SwinUNETR(1, 3, FEATURES).eval()
    b.load_state_dict(a.state_dict())
    x = _tiles(3, 2)
    assert torch.equal(a(x), b(x))


def _expected_tokens(hw, window=7):
    """(tokens, padding tokens) of one image's pass through the four
    stages' blocks, depth 2 each: each stage's map padded to whole
    windows (a side not longer than the window is its own window)."""
    H, W = hw
    tokens = pad = 0
    for i in range(4):
        h, w = H >> (i + 1), W >> (i + 1)
        wh, ww = min(h, window), min(w, window)
        hp, wp = math.ceil(h / wh) * wh, math.ceil(w / ww) * ww
        tokens += 2 * hp * wp
        pad += 2 * (hp * wp - h * w)
    return tokens, pad


@pytest.mark.parametrize("hw", [(64, 96), (448, 576)])
def test_window_counters_match_the_padded_window_count(hw):
    cfg = SwinUNETRConfig(feature_size=6, num_heads=(1, 2, 4, 8),
                          compute_dtype="float32")
    model = sw.SwinUNETR.from_config(cfg)
    before = profiling.counts()
    model(torch.zeros(2, 1, *hw))
    after = profiling.counts()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in
             ("window_attn_calls", "window_attn_tokens",
              "window_attn_pad_tokens")}
    tokens, pad = _expected_tokens(hw)
    assert delta == {"window_attn_calls": 8, "window_attn_tokens": 2 * tokens,
                     "window_attn_pad_tokens": 2 * pad}
    if hw == (448, 576):       # one block of each stage: 2,128 of 87,808
        assert (tokens // 2, pad // 2) == (87808, 2128)


def test_spans_of_a_profiled_forward():
    from torch.profiler import ProfilerActivity, profile

    model = sw.SwinUNETR.from_config(_cfg())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_tiles(4, 1))
    names = [profiling.name_of(e.name) for e in prof.events()]
    assert names.count("swin_encoder") == 1
    assert names.count("swin_decoder") == 1
    assert names.count("window_attention") == 8


def _sweep(seed: int, n=6, hw=(70, 100)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    ring = np.exp(-((np.hypot(yy - hw[0] / 2, xx - hw[1] / 2) - 18) / 3) ** 2)
    frames = [np.clip(120 * ring * (0.5 + k / n) + rng.normal(60, 25, hw),
                      0, 255) for k in range(n)]
    return np.stack(frames).astype(np.uint8)


def _reference_labels(model, sweep):
    with torch.no_grad():
        x = ref_ops.enhance(torch.as_tensor(sweep), 1.0, (8, 8))
        sm = ref_nnunet.sliding_window(_oracle(model), x.float() / 255.0,
                                       TILE, 0.5)
    return sm, ref_nnunet.labels_3d(sm, 0.5)


def test_labeled_engine_runs_swin_against_the_reference_pipeline():
    """BaselineEngine on the Swin network (enhancement, the tiled mirrored
    window of the labeled path's tiles, the 3-D postprocess) against the
    benchmark's reference pipeline with the f32 oracle in its place."""
    model = _seeded(5)
    sweep = _sweep(5)
    engine = BaselineEngine(_config(model), model, device="cpu")
    probs = engine.predict(sweep)
    labels = engine.postprocess(probs).numpy()
    sm, ref = _reference_labels(model, sweep)
    assert probs.shape == (3, *sweep.shape)
    np.testing.assert_allclose(probs.transpose(0, 1).numpy(), sm.numpy(),
                               rtol=0, atol=1e-3)
    assert np.count_nonzero(labels) > 0
    assert np.mean(labels != ref) < 1e-3


@pytest.mark.parametrize("by", ["config", "env"])
def test_model_tag_swin_unetr_runs_the_labeled_container(by, tmp_path,
                                                         monkeypatch):
    model = _seeded(6)
    sweep = _sweep(6)
    case = tmp_path / "in/images/stacked-fetal-ultrasound/case_0.mha"
    case.parent.mkdir(parents=True)
    write_mha(case, MetaImage(sweep, spacing=(0.28,) * 3))
    tag = "swin_unetr" if by == "config" else "baseline"
    cfg = _config(model, container=ContainerConfig(
        input_path=str(tmp_path / "in"), output_path=str(tmp_path / "out"),
        model_tag=tag))
    monkeypatch.chdir(tmp_path)
    if by == "env":
        monkeypatch.setenv("MODEL_TAG", "swin_unetr")
    rc = container.run_from_env(cfg, model, device="cpu",
                                save_probabilities=False, debug_frames=False,
                                log=lambda *a: None)
    engine = BaselineEngine(cfg, model, device="cpu")
    _, frame = container.select_labeled_mask_and_frame(
        engine.postprocess(engine.predict(sweep)))
    assert rc == 0
    assert read_json(tmp_path / "out/fetal-abdomen-frame-number.json") == \
        frame
    assert (tmp_path / "out/images/fetal-abdomen-segmentation/output.mha") \
        .exists()


def test_a_tile_not_divisible_by_32_is_refused():
    model = sw.SwinUNETR.from_config(_cfg())
    bad = dataclasses.replace(_config(model), plain_unet=dataclasses.replace(
        PLAIN, patch_size=(64, 100)))
    with pytest.raises(ValueError, match="multiples of 32"):
        BaselineEngine(bad, model, device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        model(torch.zeros(1, 1, 64, 100))
    with pytest.raises(ValueError, match="swin_unetr"):
        container.run(Config(container=ContainerConfig(model_tag="swin")),
                      None)


def test_load_swin_unetr_from_a_state_dict(tmp_path, capsys):
    """A state dict of MONAI's names loads with every key; one without the
    InstanceNorm affine (as MONAI's checkpoints are) leaves it at 1 and 0."""
    model = sw.SwinUNETR.from_config(_cfg(), seed=7)
    cfg = _config(model)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    got = load_swin_unetr(tmp_path / "w.pt", cfg)
    assert "loaded with 0 missing InstanceNorm affine keys" in \
        capsys.readouterr().out
    x = _tiles(7, 1)
    assert torch.equal(got(x), model(x))
    monai = {k: v for k, v in model.state_dict().items()
             if ".norm1." not in k and ".norm2." not in k
             and ".norm3." not in k or "swinViT" in k}
    torch.save({"state_dict": monai}, tmp_path / "monai.pth")
    got = load_swin_unetr(tmp_path / "monai.pth", cfg)
    n_missing = len(model.state_dict()) - len(monai)
    assert f"loaded with {n_missing} missing InstanceNorm affine keys" in \
        capsys.readouterr().out
    assert torch.equal(got(x), model(x))
    (tmp_path / "w.npz").write_bytes(b"")
    with pytest.raises(SystemExit, match="state dict"):
        load_swin_unetr(tmp_path / "w.npz", cfg)


@pytest.mark.parametrize("foreign", ["plain_unet", "attention_key_missing",
                                     "unexpected_key"])
def test_load_swin_unetr_refuses_a_foreign_state_dict(foreign, tmp_path):
    """A checkpoint of another network (an nnU-Net state dict under
    ``MODEL_TAG=swin_unetr``), or one that lacks a key other than a conv
    block's InstanceNorm affine, or has a key the model lacks, is refused
    instead of serving the initialisation."""
    model = sw.SwinUNETR.from_config(_cfg(), seed=9)
    sd = model.state_dict()
    if foreign == "plain_unet":
        sd = PlainConvUNet(PlainUNetConfig(base_c=4, max_c=16, n_stages=3,
                                           patch_size=TILE)).state_dict()
    elif foreign == "attention_key_missing":
        sd.pop("swinViT.layers1.0.blocks.0.attn.qkv.weight")
    else:
        sd["decoder1.extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(SystemExit, match="not a SwinUNETR state dict"):
        load_swin_unetr(tmp_path / "w.pth", _config(model))



def test_the_entry_point_serves_swin_unetr_from_weights(tmp_path,
                                                        monkeypatch):
    """``python -m att_aspp_unet_tpu_torch.inference``'s main in process:
    ``MODEL_TAG=swin_unetr`` with ``WEIGHTS`` a state dict serves the
    labeled path and picks the engine's frame."""
    from att_aspp_unet_tpu_torch import inference

    model = _seeded(8)
    sweep = _sweep(8)
    case = tmp_path / "test/input/images/stacked-fetal-ultrasound/c_1.mha"
    case.parent.mkdir(parents=True)
    write_mha(case, MetaImage(sweep, spacing=(0.28,) * 3))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    cfg = _config(model)
    monkeypatch.chdir(tmp_path)
    for k, v in dict(MODEL_TAG="swin_unetr", WEIGHTS=str(tmp_path / "w.pt"),
                     CASE_ID="swin_case", DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("PLANS", raising=False)
    # the small configuration in place of the full-width default
    monkeypatch.setattr("att_aspp_unet_tpu_torch.config.Config", lambda: cfg)
    assert inference.main() == 0
    engine = BaselineEngine(cfg, model, device="cpu")
    _, frame = container.select_labeled_mask_and_frame(
        engine.postprocess(engine.predict(sweep)))
    out = tmp_path / "test/output"
    assert read_json(out / "fetal-abdomen-frame-number.json") == frame
    assert (out / "images/fetal-abdomen-segmentation/swin_case.mha").exists()
