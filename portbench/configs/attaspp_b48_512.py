"""The Attention-ASPP-UNet configuration: the program's engine for a traffic
mix, the work one request needs, and the judge that holds what the timed
path returned against the plain reference.

The traffic's ``path`` names the serving path: the two-tier cascade
(``cascade``: the distilled 128-px scout over every frame, the main model
on the ``cascade_scouts`` best) or the direct path (the main model on every
frame), with or without hflip TTA, in micro-batches of ``frame_batch``.
Each request is ``AttAsppEngine.predict_case_submit`` and
``predict_case_collect``: (best frame, refined mask, AC in mm).
"""

from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np


ROOT = Path(__file__).resolve().parents[2]


# ------------------------------------------------------ system under test


class Serving:
    """One engine serving whole requests through submit / collect."""

    def __init__(self, engine, threshold: float, spacing):
        self.engine, self.threshold, self.spacing = engine, threshold, spacing

    def submit(self, sweep):
        return self.engine.predict_case_submit(sweep, self.threshold)

    def collect(self, handle, keep: bool):
        return self.engine.predict_case_collect(handle, self.spacing)

    def counters(self) -> Dict[str, int]:
        return {"exact_repeats": int(self.engine.exact_repeats)}

    def close(self) -> None:
        self.engine = None


def _threshold(cfg, path) -> float:
    return float(cfg["threshold_tta"] if path["tta_hflip"]
                 else cfg["threshold"])


class ReferenceInPlace:
    """The reference pipeline put in the program's place, its convs in
    float8 (the control): each request's pick, its refined mask and the
    AC of that mask."""

    def __init__(self, cfg, traffic, device, quant: str):
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.models = reference_models(cfg, traffic, device, quant)

    def submit(self, sweep):
        import torch

        from portbench.reference import post

        with torch.no_grad():
            ref = reference_case(self.cfg, self.traffic,
                                 torch.as_tensor(sweep).to(self.device),
                                 self.models, [])
        mask = ref["pick_mask"]
        return ref["frame"], mask, post.measure_ac_mm(
            mask, tuple(self.cfg["spacing_mm"]))

    def collect(self, handle, keep: bool):
        return handle

    def counters(self) -> Dict[str, int]:
        return {}

    def close(self) -> None:
        self.models = None


def build(cfg, traffic, device, control: bool = False):
    """The port's engine at the configuration and the traffic's path;
    ``control`` puts the reference with its convs in float8 in its place
    (the lower-precision control)."""
    if control:
        return ReferenceInPlace(cfg, traffic, device, "fp8")
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                PredictConfig,
                                                PreprocessConfig)
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

    m, pp, post, sc = (cfg[k] for k in ("model", "preprocess",
                                        "postprocess", "scout"))
    path = traffic["path"]
    predict = dict(threshold=_threshold(cfg, path),
                   tta_hflip=bool(path["tta_hflip"]),
                   frame_batch=int(path["frame_batch"]),
                   cascade=bool(path["cascade"]), **post)
    if path["cascade"]:
        predict.update(cascade_img_size=sc["img_size"],
                       cascade_scouts=int(path["cascade_scouts"]),
                       cascade_scout_batch=int(path["cascade_scout_batch"]),
                       cascade_scout_weights=str(ROOT / sc["weights"]),
                       cascade_scout_base_c=int(sc["base_c"]),
                       cascade_scout_clahe=bool(sc["use_clahe"]),
                       cascade_scout_thr=float(sc["threshold"]))
    config = Config(
        preprocess=PreprocessConfig(clahe_clip=pp["clahe_clip"],
                                    clahe_grid=tuple(pp["clahe_grid"]),
                                    median_kernel=pp["median_kernel"],
                                    img_size=m["img_size"]),
        model=ModelConfig(base_c=m["base_c"], gate_variant=m["gate_variant"],
                          use_aspp=m["use_aspp"],
                          aspp_rates=tuple(m["aspp_rates"]),
                          conv_lowering="direct"),
        predict=PredictConfig(**predict))
    engine = AttAsppEngine(config, load_npz_variables(ROOT / cfg["weights"]),
                           device=device)
    return Serving(engine, _threshold(cfg, path), tuple(cfg["spacing_mm"]))


# -------------------------------------------------------------- work


def forward_gflops(base_c: int, size: int, tta: bool = False) -> float:
    """Conv FLOPs (2 x multiply-adds) of one v1 Attention-ASPP-UNet forward
    over a ``size`` x ``size`` frame, in GFLOP: the encoder pairs, the
    five-branch ASPP and its projection, per decoder level the 2x2
    transposed conv, the v1 gate and the pair, and the 1x1 head; hflip TTA
    doubles it.  A copy of the port's ``bench.forward_gflops``."""
    def conv(k, ci, co, s):
        return 2.0 * k * k * ci * co * s * s

    c, S = base_c, size
    f = 0.0
    for (s, ci, co) in ((S, 1, c), (S // 2, c, 2 * c),
                        (S // 4, 2 * c, 4 * c), (S // 8, 4 * c, 8 * c)):
        f += conv(3, ci, co, s) + conv(3, co, co, s)
    b, ci, co = S // 16, 8 * c, 16 * c
    f += conv(1, ci, co, b) + 3 * conv(3, ci, co, b) + \
        2 * ci * co + conv(1, 5 * co, co, b)
    for (s, gi, fo, gated) in ((S // 8, 16 * c, 8 * c, True),
                               (S // 4, 8 * c, 4 * c, True),
                               (S // 2, 4 * c, 2 * c, True),
                               (S, 2 * c, c, False)):
        f += 2.0 * 4 * gi * fo * (s // 2) ** 2
        if gated:
            f += 2 * conv(1, fo, fo // 2, s) + conv(1, fo // 2, 1, s)
        f += conv(3, 2 * fo, fo, s) + conv(3, fo, fo, s)
    f += conv(1, c, 1, S)
    return f * (2.0 if tta else 1.0) / 1e9


def scout_micro_batch(n: int, requested: int, frame_batch: int) -> int:
    """The scout tier's micro-batch for an ``n``-frame stack: halved from
    the requested size until a partly empty last batch wastes at most n / 4
    frames, at worst down to ``frame_batch`` (the engine's rule)."""
    b = max(1, requested or frame_batch)
    while b > frame_batch and (-n) % b > n // 4:
        b //= 2
    return max(1, min(b, max(n, 1)))


def _batches(n: int, b: int) -> List[int]:
    return [min(b, n - i) for i in range(0, n, b)]


def _shape(cfg, traffic):
    n = int(traffic["sweeps_per_request"]) * int(traffic["frames_per_sweep"])
    post = cfg["postprocess"]
    n_scout = min(max(int(traffic["path"].get("cascade_scouts", 0)),
                      post["topk_frames"]), n)
    m = max(1, min(post["topk_frames"] + post["refine_margin"], n))
    return n, n_scout, m


def request_work(cfg, traffic) -> Dict[str, object]:
    """What one request needs, whatever computes it: the convs' FLOPs, K1's
    micro-batches (base_c, size, frames) and K2's stacks (frames, H, W,
    grid)."""
    path, mdl, sc = traffic["path"], cfg["model"], cfg["scout"]
    H, W = int(traffic["height"]), int(traffic["width"])
    grid = tuple(cfg["preprocess"]["clahe_grid"])
    tta = bool(path["tta_hflip"])
    views = 2 if tta else 1
    c, S, fb = mdl["base_c"], mdl["img_size"], int(path["frame_batch"])
    n, n_scout, _ = _shape(cfg, traffic)
    if path["cascade"]:
        sb = scout_micro_batch(n, int(path["cascade_scout_batch"]), fb)
        flops = (n * forward_gflops(sc["base_c"], sc["img_size"])
                 + n_scout * forward_gflops(c, S, tta))
        k1 = [(sc["base_c"], sc["img_size"], b) for b in _batches(n, sb)]
        k1 += [(c, S, views * b) for b in _batches(n_scout, min(fb, n_scout))]
        k2 = [(n_scout, H, W, grid)]
        if sc["use_clahe"]:
            k2.append((n, sc["img_size"], sc["img_size"], grid))
    else:
        flops = n * forward_gflops(c, S, tta)
        k1 = [(c, S, views * b) for b in _batches(n, fb)]
        k2 = [(n, H, W, grid)]
    return {"flops": flops * 1e9, "k1_batches": k1, "k2_stacks": k2}


# ------------------------------------------------------------- judge


def _tier2_probs(frames, model, cfg, tta: bool):
    """Blurred native-resolution probabilities of raw uint8 frames (K, H,
    W): enhance at native resolution, resize to the model size, forward,
    resize back, 5x5 Gaussian."""
    import torch

    from portbench.reference import attaspp, ops

    pp, S = cfg["preprocess"], cfg["model"]["img_size"]
    H, W = frames.shape[-2:]
    out = []
    for i in range(0, frames.shape[0], 8):
        u8 = ops.enhance(frames[i:i + 8], pp["clahe_clip"],
                         tuple(pp["clahe_grid"]))
        x = ops.resize_bilinear(u8.to(torch.float32), (S, S)) / 255.0
        p = attaspp.probs(model, x, tta)
        out.append(ops.gaussian_blur(ops.resize_bilinear(p, (H, W)),
                                     cfg["postprocess"]["gaussian_kernel"],
                                     0.0))
    return torch.cat(out)


def _scout_keys(sweep, scout, cfg) -> np.ndarray:
    """The scout tier's rank key of every frame."""
    import torch

    from portbench.reference import attaspp, ops, post

    sc, pp = cfg["scout"], cfg["preprocess"]
    s = sc["img_size"]
    keys = []
    for i in range(0, sweep.shape[0], 128):
        lo = ops.resize_bilinear(sweep[i:i + 128].to(torch.float32), (s, s))
        u8 = ops.enhance(lo, pp["clahe_clip"] if sc["use_clahe"] else 0.0,
                         tuple(pp["clahe_grid"]))
        p = attaspp.probs(scout, u8.to(torch.float32) / 255.0, False, 128)
        keys.append(post.rank_keys(p > float(np.float32(sc["threshold"]))))
    return np.concatenate(keys)


def _shortfall(key_f: float, selected_keys) -> float:
    """How far ``key_f`` lies under the last selected key, relative."""
    k = float(min(selected_keys))
    return max(0.0, (k - float(key_f)) / max(k, 1.0))


def reference_case(cfg, traffic, sweep, models, frames_p: List[int]):
    """The reference pipeline on one request (a (N, H, W) uint8 tensor):
    its pick, and for the program's picks ``frames_p`` the refined mask,
    the blurred probability's distance from the threshold, and the gap by
    which the reference ranks each below its own pick (0 where they
    agree)."""
    import torch

    from portbench.reference import post

    path = traffic["path"]
    main, scout = models
    n, n_scout, m = _shape(cfg, traffic)
    thr = _threshold(cfg, path)
    ids = np.arange(n)
    stages = []                                  # (key of each frame, kept)
    if path["cascade"]:
        keys1 = _scout_keys(sweep, scout, cfg)
        pop = ids[post.rank(keys1, ids)][:n_scout]
        stages.append((dict(enumerate(keys1)), pop))
        k_cand = min(m, n_scout)
    else:
        pop, k_cand = ids, m
    todo = sorted(set(pop.tolist()) | set(frames_p))
    probs = _tier2_probs(sweep[torch.as_tensor(todo, device=sweep.device)],
                         main, cfg, bool(path["tta_hflip"]))
    binary = probs > float(np.float32(thr))
    keys2 = dict(zip(todo, post.rank_keys(binary).tolist()))
    pk = np.array([keys2[f] for f in pop])
    cand = pop[post.rank(pk, pop)][:k_cand]
    stages.append((keys2, cand))
    need = list(cand) + [f for f in frames_p if f not in set(cand)]
    pos = {f: i for i, f in enumerate(todo)}
    refined = post.refine(binary[torch.as_tensor([pos[f] for f in need],
                                                 device=binary.device)])
    masks = dict(zip(need, refined))
    cand_masks = refined[:len(cand)]
    topk = cfg["postprocess"]["topk_frames"]
    top = post.top_by_area(cand_masks, topk)
    circ = {f: post.circularity_score(masks[f]) for f in need}
    f_ref = int(cand[top[int(np.argmax([circ[cand[i]] for i in top]))]])
    areas = {f: int(masks[f].sum()) for f in need}
    top_areas = [areas[cand[i]] for i in top]
    result = {"frame": f_ref, "pick_mask": masks[f_ref], "masks": {},
              "gap": {}, "margin": {}}
    for f in frames_p:
        gap = 0.0
        if f != f_ref:
            gap = max([_shortfall(keys[f], [keys[g] for g in kept])
                       for keys, kept in stages]
                      + [_shortfall(areas[f], top_areas),
                         max(0.0, circ[f_ref] - circ[f])])
        result["masks"][f] = masks[f]
        result["margin"][f] = (probs[pos[f]] - float(np.float32(thr))) \
            .abs().cpu().numpy()
        result["gap"][f] = gap
    return result


def reference_models(cfg, traffic, device, quant=None):
    from portbench.reference import attaspp

    main = attaspp.load_npz(ROOT / cfg["weights"], cfg["model"]["base_c"],
                            device, quant)
    scout = None
    if traffic["path"]["cascade"]:
        sc = cfg["scout"]
        scout = attaspp.load_npz(ROOT / sc["weights"], sc["base_c"], device,
                                 quant)
    return main, scout


def judge(cfg, traffic, inputs, judged, device) -> Dict[str, float]:
    """``served_gap``: how far the served decisions lie on the wrong side of
    the reference's own criteria, the largest of three parts (each 0 where
    the program decides as the reference does):

    - ``pixel_gap``: for each served mask, the pixels that differ from the
      reference's refined mask of the same frame, each at the distance of
      the reference's blurred probability there from the threshold; the
      75th percentile of those distances; its largest over every judged
      request, so that a fault in the masks of one input shows;
    - ``pick_gap``: where a served frame is not the reference's pick, how
      far the reference ranks it below its own pick
      (:func:`reference_case`), the largest over the requests;
    - ``ac_gap``: a served AC's distance from the reference's ellipse AC of
      the served mask, relative, the largest over the requests.

    Beside them, not compared: ``mask_px``, the largest share of a mask's
    pixels that differ, and ``area_bias``, the served masks' net extra
    pixels over the reference's, over its area."""
    import torch

    from portbench.reference import post

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True      # the fastest exact-f32 convs
    models = reference_models(cfg, traffic, device)
    by_input = defaultdict(list)
    for idx, out in judged:
        by_input[idx].append(out)
    out = {"pixel_gap": 0.0, "pick_gap": 0.0, "ac_gap": 0.0, "mask_px": 0.0}
    bias_px, area_px = 0, 0
    spacing = tuple(cfg["spacing_mm"])
    with torch.no_grad():
        for idx, outs in sorted(by_input.items()):
            sweep = torch.as_tensor(inputs[idx]).to(device)
            if any(not 0 <= int(o[0]) < sweep.shape[0] for o in outs):
                out["pick_gap"] = math.inf      # no frame of the request
                continue
            frames_p = sorted({int(o[0]) for o in outs})
            ref = reference_case(cfg, traffic, sweep, models, frames_p)
            for frame, mask, ac in outs:
                served = np.asarray(mask) > 0
                rm = ref["masks"][int(frame)] > 0
                differs = served != rm
                m = ref["margin"][int(frame)][differs]
                if m.size:
                    out["pixel_gap"] = max(out["pixel_gap"],
                                           float(np.quantile(m, 0.75)))
                own = post.measure_ac_mm(served.astype(np.uint8), spacing)
                out["pick_gap"] = max(out["pick_gap"], ref["gap"][int(frame)])
                out["ac_gap"] = max(out["ac_gap"], abs(float(ac) - own)
                                    / max(own, 1.0))
                out["mask_px"] = max(out["mask_px"], int(differs.sum())
                                     / max(int(rm.sum()), 1))
                bias_px += int((served & ~rm).sum()) - int((rm & ~served)
                                                            .sum())
                area_px += int(rm.sum())
    out["area_bias"] = bias_px / max(area_px, 1)
    out["served_gap"] = max(out["pixel_gap"], out["pick_gap"],
                            out["ac_gap"])
    return out
