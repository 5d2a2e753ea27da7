"""The nnU-Net v2 2d baseline configuration: the program's
``BaselineEngine`` on the plan's PlainConvUNet with the benchmark's seeded
weights, the work one request needs, and the judge against the plain
reference.

Each request is ``BaselineEngine.predict`` (enhancement with K2, the
Gaussian-weighted mirrored sliding window) -> ``postprocess`` (the 3-D
largest component of each class) in the submit, and
``infer/container.select_labeled_mask_and_frame`` in the collect.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import numpy as np

FP8_FAULT = "fp8"


def feats(cfg) -> List[int]:
    return [min(cfg["UNet_base_num_features"] * 2 ** s,
                cfg["unet_max_num_features"]) for s in range(cfg["n_stages"])]


def _reference_model(cfg, device, quant=None):
    from portbench.reference.nnunet import PlainConvUNet

    return PlainConvUNet(feats(cfg), cfg["n_conv_per_stage_encoder"][0],
                         cfg["num_classes"], cfg["in_channels"],
                         quant=quant).to(device).eval()


def make_weights(cfg, device) -> Dict[str, "object"]:
    """The state dict (nnU-Net's names) both sides load: every conv and
    transposed-conv kernel LeCun-normal truncated at 2 standard deviations
    (variance 1 / fan-in), drawn on ``device`` from ``init_seed`` in one
    call and held in bf16; biases 0; InstanceNorm scale 1, bias 0."""
    import torch

    shapes = {k: v.shape for k, v in _reference_model(cfg, "meta")
              .state_dict().items()}
    kernels = [k for k, s in shapes.items()
               if k.endswith(".weight") and len(s) == 4]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["init_seed"]))
    flat = torch.empty(sum(math.prod(shapes[k]) for k in kernels),
                       device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    sd, at = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            transposed = ".transpconvs." in k
            fan_in = (s[0] if transposed else s[1]) * s[2] * s[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            sd[k] = (flat[at:at + n] * std).reshape(s).to(torch.bfloat16)
            at += n
        elif ".norm." in k:
            sd[k] = (torch.ones if k.endswith("weight") else torch.zeros)(
                s, device=device)
        else:
            sd[k] = torch.zeros(s, device=device, dtype=torch.bfloat16)
    return sd


class Baseline:
    def __init__(self, engine):
        self.engine = engine

    def submit(self, sweep):
        return self.engine.postprocess(self.engine.predict(sweep))

    def collect(self, labels, keep: bool):
        from att_aspp_unet_tpu_torch.infer.container import \
            select_labeled_mask_and_frame

        mask, frame = select_labeled_mask_and_frame(labels)
        return frame, mask, labels if keep else None

    def counters(self):
        return {}

    def close(self):
        self.engine = None


class ReferenceInPlace:
    """The reference pipeline put in the program's place (the control:
    ``quant="fp8"``)."""

    def __init__(self, cfg, device, quant):
        self.cfg, self.device = cfg, device
        self.model = _reference_model(cfg, device, quant)
        self.model.load_state_dict({k: v.float() for k, v in
                                    make_weights(cfg, device).items()})

    def submit(self, sweep):
        import torch

        return _reference_labels(self.cfg, self.model,
                                 torch.as_tensor(sweep).to(self.device))

    def collect(self, labels, keep: bool):
        from portbench.reference.nnunet import frame_ladder

        frame, _ = frame_ladder(labels)
        mask = (labels[frame] > 0).astype(np.uint8) if frame >= 0 else \
            np.zeros(labels.shape[1:], np.uint8)
        return frame, mask, labels if keep else None

    def counters(self):
        return {}

    def close(self):
        self.model = None


def build(cfg, traffic, device, control: bool = False):
    if control:
        return ReferenceInPlace(cfg, device, FP8_FAULT)
    from att_aspp_unet_tpu_torch.config import (Config, PlainUNetConfig,
                                                PreprocessConfig)
    from att_aspp_unet_tpu_torch.infer.engine import BaselineEngine
    from att_aspp_unet_tpu_torch.models import PlainConvUNet

    pp = cfg["preprocess"]
    pu = PlainUNetConfig(
        in_channels=cfg["in_channels"], num_classes=cfg["num_classes"],
        base_c=cfg["UNet_base_num_features"],
        max_c=cfg["unet_max_num_features"], n_stages=cfg["n_stages"],
        conv_per_stage=cfg["n_conv_per_stage_encoder"][0],
        patch_size=tuple(cfg["patch_size"]), tile_step=cfg["tile_step"],
        use_gaussian=cfg["use_gaussian"], use_mirroring=cfg["use_mirroring"],
        mirror_batch=cfg["mirror_batch"], tile_batch=cfg["tile_batch"])
    config = Config(preprocess=PreprocessConfig(
        clahe_clip=pp["clahe_clip"], clahe_grid=tuple(pp["clahe_grid"]),
        median_kernel=pp["median_kernel"]), plain_unet=pu)
    model = PlainConvUNet(pu, device=device)
    model.load_state_dict(make_weights(cfg, device))
    return Baseline(BaselineEngine(config, model.eval(), device=device))


# -------------------------------------------------------------- work


def plain_unet_flops(cfg) -> float:
    """2 x multiply-adds of one PlainConvUNet forward over a patch: the 3x3
    convs (stride 2 where a stage begins), the 2x2 transposed convs and the
    1x1 head.  A copy of ``chip_smoke.plain_unet_flops``."""
    h, w = cfg["patch_size"]
    f = feats(cfg)
    n_conv = cfg["n_conv_per_stage_encoder"][0]
    px = [(h >> s) * (w >> s) for s in range(cfg["n_stages"])]
    total, cin = 0.0, cfg["in_channels"]
    for s, c in enumerate(f):
        total += 2 * 9 * (cin + (n_conv - 1) * c) * c * px[s]
        cin = c
    for s in range(cfg["n_stages"] - 2, -1, -1):
        total += 2 * f[s + 1] * f[s] * px[s]
        total += 2 * 9 * (2 * f[s] + (n_conv - 1) * f[s]) * f[s] * px[s]
    return total + 2 * f[0] * cfg["num_classes"] * px[0]


def tiles_per_frame(cfg, H: int, W: int) -> int:
    from portbench.reference.nnunet import tile_starts

    th, tw = cfg["patch_size"]
    return (len(tile_starts(max(H, th), th, cfg["tile_step"]))
            * len(tile_starts(max(W, tw), tw, cfg["tile_step"])))


def request_work(cfg, traffic) -> Dict[str, object]:
    """The convs' FLOPs and K2's stacks (frames, H, W, grid) of one
    request; the baseline runs no K1."""
    n = int(traffic["sweeps_per_request"]) * int(traffic["frames_per_sweep"])
    H, W = int(traffic["height"]), int(traffic["width"])
    views = 4 if cfg["use_mirroring"] else 1
    return {"flops": n * tiles_per_frame(cfg, H, W) * views
            * plain_unet_flops(cfg),
            "k1_batches": [],
            "k2_stacks": [(n, H, W, tuple(cfg["preprocess"]["clahe_grid"]))]}


# ------------------------------------------------------------- judge


def _reference_labels(cfg, model, sweep) -> np.ndarray:
    import torch

    from portbench.reference import nnunet, ops

    pp = cfg["preprocess"]
    t0 = time.perf_counter()
    x = torch.cat([ops.enhance(sweep[i:i + 16], pp["clahe_clip"],
                               tuple(pp["clahe_grid"]))
                   for i in range(0, sweep.shape[0], 16)])
    t1 = time.perf_counter()
    sm = nnunet.sliding_window(model, x.to(torch.float32) / 255.0,
                               tuple(cfg["patch_size"]), cfg["tile_step"])
    t2 = time.perf_counter()
    labels = nnunet.labels_3d(sm, cfg["softmax_threshold"])
    print(f"[portbench] reference: enhance {t1 - t0:.1f} s, sliding window "
          f"{t2 - t1:.1f} s, 3-D postprocess {time.perf_counter() - t2:.1f}"
          " s", file=sys.stderr)
    return labels


def judge(cfg, traffic, inputs, judged, device) -> Dict[str, float]:
    """``served_gap``: the larger, over the judged requests, of
    ``label_px``, the voxels whose served label differs from the
    reference's, over the reference's foreground voxels, and ``frame_gap``,
    how far the reference's ladder value (the larger of the class-1 and
    class-2 areas) of the served frame lies under that of its own pick,
    relative (0 where the picks agree).  The two parts are returned beside
    it, not compared."""
    import torch

    from portbench.reference.nnunet import frame_ladder

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True      # the fastest exact-f32 convs
    model = _reference_model(cfg, device)
    model.load_state_dict({k: v.float() for k, v in
                           make_weights(cfg, device).items()})
    worst = {"label_px": 0.0, "frame_gap": 0.0}
    refs = {}
    with torch.no_grad():
        for idx, (frame, mask, labels) in judged:
            if idx not in refs:
                refs[idx] = _reference_labels(
                    cfg, model, torch.as_tensor(inputs[idx]).to(device))
            ref = refs[idx]
            got = np.asarray(labels.cpu() if hasattr(labels, "cpu")
                             else labels)
            if got.shape != ref.shape:          # not the request's volume
                worst["label_px"] = math.inf
                continue
            diff = int(np.count_nonzero(got != ref))
            worst["label_px"] = max(worst["label_px"],
                                    diff / max(int((ref > 0).sum()), 1))
            f_ref, value = frame_ladder(ref)
            gap = 0.0
            if int(frame) != f_ref:
                best = float(value[f_ref]) if f_ref >= 0 else 0.0
                got_v = float(value[int(frame)]) if int(frame) >= 0 else 0.0
                gap = (best - got_v) / max(best, 1.0) if best > got_v \
                    else 0.0
                if int(frame) < 0 <= f_ref:
                    gap = 1.0
            worst["frame_gap"] = max(worst["frame_gap"], gap)
    worst["served_gap"] = max(worst["label_px"], worst["frame_gap"])
    return worst
