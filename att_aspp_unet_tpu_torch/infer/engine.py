"""Sweep inference engine: the four serving modes, on one device or with the
frames of a sweep split over several.

Counterpart of ``att_aspp_unet_tpu/infer/engine.py`` (``AttAsppEngine``):

- direct (``predict_case`` without ``cascade``): enhance -> resize 512 ->
  hflip-TTA forward -> resize back to native -> 5x5 Gaussian -> threshold ->
  rank candidates by a refined-area proxy -> refine the top ``topk +
  refine_margin`` -> exact circularity re-rank on the host -> ellipse AC;
- cascade (``PredictConfig.cascade``): a cheap low-resolution scout forward
  over every frame (optionally a distilled model of its own) ranks the
  frames, and only the ``cascade_scouts`` best go through the direct path's
  full-resolution half;
- bulk (``predict_bulk``): S same-shape sweeps through one cascade, the
  promoted frames of all sweeps sharing tier-2 micro-batches and one refine;
- ROI (``predict_roi``): the container path — 128 linspace-subsampled frames,
  a 224 x 224 intensity-centroid crop, forward without TTA, paste back;
- baseline (:class:`BaselineEngine`): the container's labeled path, an
  nnU-Net-style PlainConvUNet (the default model) or a SwinUNETR over
  Gaussian-weighted sliding-window tiles with mirror TTA, then a 3-D
  largest-component postprocess per class.

The device half runs eagerly in PyTorch; the two hand-written kernels run
inside it (CLAHE's K2 in every enhancement, K1 for every conv pair of every
forward).  Ranking happens on the device and every result crosses to the
host in one transfer, in the collect halves.  On a card the submit halves
read nothing back and never wait for the device: a device half is a list of
steps, those with connected-component or hole-fill fixed points run them
speculatively (``postprocess/cc.speculative``), and their "had not settled"
records travel with the result.  The handle keeps the input of each such step
on the device, so a collect half that finds a record set repeats the work
from that step on with the exact loops: never the upload, and no forward that
came before the step.

With ``devices`` (the counterpart of the JAX engines' ``mesh``), every path
splits the frame axis into contiguous shards, one per data device, cut at
micro-batch boundaries (``parallel/mesh.py``); each device runs enhancement
(K2), the forward (K1, with its own copy of the model and its own prepacked
weights) and the per-frame tail on its shard, and only what the rest of the
path needs is gathered onto the primary device (the first of ``devices``):
the probabilities, or the rank keys and the candidates' masks.  The cascade
and the bulk path split twice: the scout tier over all frames at scout
micro-batch boundaries, promotion per sweep on the primary device from the
gathered keys, then the promoted frames' tier-2 forward at tier-2
micro-batch boundaries.  Every micro-batch is the one-device engine's, so
the results are too.

With ``ModelConfig.conv_lowering="int8"`` the model's 3x3 ConvBNReLU convs
serve post-training-quantized (``nn/quant.py``, kernel K3).  Their
activation scales come from the variables' ``quant`` collection or, without
one, from a calibration forward of the direct model (K1 in its calibration
mode) over ``quant_calib_frames`` evenly spaced frames of the first sweep
the engine sees, preprocessed at ``img_size`` without TTA, on the primary
device; every replica then carries the same int8 weights and scales.  The
cascade's scout always serves direct.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, ModelConfig
from ..measure.ellipse import measure_ac_mm
from ..models.plain_unet import PlainConvUNet
from ..models.swin_unetr import SwinUNETR, check_tile
from ..models.sliding_window import (compute_tile_starts,
                                     sliding_window_predict)
from ..nn.quant import tree_set
from ..parallel import mesh
from ..ops.image import gaussian_blur, resize_bilinear, resize_nearest
from ..postprocess import cc
from ..postprocess.morphology import (binary_closing, fill_holes,
                                      structuring_ellipse)
from ..postprocess.refine import (postprocess_roi_stack,
                                  postprocess_softmax_stack, refine_mask,
                                  refine_mask_true_size)
from ..postprocess.select import (select_best_frame_exact,
                                  select_max_area_frame)
from ..preprocess.enhance import enhance_frames, preprocess_sweep
from ..preprocess.roi import crop_roi, paste_roi_probs
from ..utils.convert import (jax_plain_unet_to_torch, jax_variables_to_torch,
                             quant_tree)
from ..utils.npz_weights import load_npz_variables
from ..utils.profiling import count, span
from .staging import Staging


def forward_probs_tta(model, x: torch.Tensor, hflip: bool = True
                      ) -> torch.Tensor:
    """(B, S, S) -> sigmoid probabilities (B, S, S) f32; logits averaged
    over the horizontal-flip pair, run as one doubled batch."""
    inp = x[:, None]
    if not hflip:
        return torch.sigmoid(model(inp).float())[:, 0]
    B = x.shape[0]
    logits = model(torch.cat([inp, torch.flip(inp, dims=(-1,))], dim=0)).float()
    logits = (logits[:B] + torch.flip(logits[B:], dims=(-1,))) / 2.0
    return torch.sigmoid(logits)[:, 0]


def predict_sweep_probs(model, frames: torch.Tensor, batch: int = 8,
                        hflip: bool = True) -> torch.Tensor:
    """(N, S, S) float frames -> (N, S, S) probabilities, in micro-batches of
    ``batch`` frames to bound activation memory."""
    outs = [forward_probs_tta(model, frames[i:i + batch], hflip)
            for i in range(0, frames.shape[0], batch)]
    return torch.cat(outs, dim=0)


def _maxpool4_same(m: torch.Tensor) -> torch.Tensor:
    """4x4 stride-4 max pool with XLA's "SAME" padding: the total pad
    ``(ceil(n/4) - 1) * 4 + 4 - n`` splits low = total // 2, high = rest."""
    H, W = m.shape[-2], m.shape[-1]

    def pads(n):
        total = max((-(-n // 4) - 1) * 4 + 4 - n, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = pads(H), pads(W)
    mp = F.pad(m, (pl, pr, pt, pb))
    Hp, Wp = mp.shape[-2], mp.shape[-1]
    return mp.reshape(*m.shape[:-2], Hp // 4, 4, Wp // 4, 4).amax(dim=(-3, -1))


def candidate_rank_areas(binary: torch.Tensor, close_kernel: int = 7,
                         fill_proxy: bool = True) -> torch.Tensor:
    """(N, H, W) 0/1 -> (N,) key ~ each frame's area after refinement: the
    full-resolution close plus 16 px per quarter-resolution cell that hole
    filling adds.  ``fill_proxy=False`` keeps the closed area only (the scout
    tier's cheaper key, ``PredictConfig.cascade_scout_rank="closed"``)."""
    closed = binary_closing(binary, structuring_ellipse(close_kernel))
    closed_raw = closed.sum(dim=(-2, -1), dtype=torch.long)
    if not fill_proxy:
        return closed_raw
    pooled = _maxpool4_same(closed)
    cells = pooled.sum(dim=(-2, -1), dtype=torch.long)
    filled = fill_holes(pooled).sum(dim=(-2, -1), dtype=torch.long)
    return closed_raw + 16 * (filled - cells)


def rank_order(areas: torch.Tensor, keys: Optional[torch.Tensor] = None,
               n_valid: Optional[int] = None) -> torch.Tensor:
    """Positions of ``areas`` (..., N) in candidate order, on the areas'
    device: descending area, the higher ``keys`` value first on ties — what
    ``lexsort((-keys, -areas))`` gives.  ``keys`` (distinct along the last
    axis) defaults to the position, the frame index; entries whose key is
    ``n_valid`` or more (padding frames) rank below every real frame.

    A stable descending sort of the areas taken in descending key order keeps
    that order among equal areas, so no composite key is needed."""
    N = areas.shape[-1]
    if keys is None:
        first = torch.arange(N - 1, -1, -1, device=areas.device) \
            .expand(areas.shape)
        key_sorted = first
    else:
        first = torch.argsort(keys, dim=-1, descending=True)
        key_sorted = keys.gather(-1, first)
    a = areas.gather(-1, first)
    if n_valid is not None:
        a = torch.where(key_sorted < n_valid, a, torch.full_like(a, -1))
    second = torch.argsort(a, dim=-1, descending=True, stable=True)
    return first.gather(-1, second)


def rank_candidates(areas, n_valid: int, n_cand: int) -> torch.Tensor:
    """Frame indices of the ``n_cand`` best candidates of one sweep
    (``np.argsort(areas)[::-1]`` order; frames at ``n_valid`` or beyond rank
    below every real frame), as a tensor on the areas' device."""
    return rank_order(torch.as_tensor(areas).long(), None, n_valid)[:n_cand]


def scout_micro_batch(n: int, requested: int, frame_batch: int) -> int:
    """Effective scout-tier micro-batch for an ``n``-frame stack: the
    requested batch (0 = ``frame_batch``), halved until a last, partly empty
    batch would waste no more than n/4 frames' worth of work, at worst down
    to ``frame_batch``.  Same rule as the JAX package, so both pick the same
    batch for a stack."""
    b = max(1, requested or frame_batch)
    while b > frame_batch and (-n) % b > n // 4:
        b //= 2
    return max(1, min(b, max(n, 1)))


# A device half is a list of steps ``(fn, fixed)``: ``fn`` maps the previous
# step's result to its own, ``fixed`` says that it runs fixed-point loops.
Step = Tuple[Callable, bool]


def run_steps(steps: List[Step], state):
    for fn, _ in steps:
        state = fn(state)
    return state


def cascade_steps(model, n_valid: int, *, img_size: int, low_size: int,
                  clahe_clip: float, clahe_grid: Tuple[int, int],
                  median_kernel: int, batch: int, tta: bool, gauss_k: int,
                  threshold: float, n_scout: int, n_cand: int,
                  min_area_px: int, min_area_frac: float, close_kernel: int,
                  lowres_enhance: bool = False, scout_batch: int = 0,
                  scout_model=None, scout_thr: float = 0.0,
                  scout_clip: Optional[float] = None,
                  scout_rank: str = "refined",
                  devices: Optional[List[torch.device]] = None
                  ) -> List[Step]:
    """Two-tier cascade over an (S, N, H, W) stack of S independent
    same-shape sweeps on the device, as the steps of a device half: the one
    implementation behind the single-case cascade (S = 1) and the bulk path.

    Tier 1 scouts all S*N frames at ``low_size`` in micro-batches of
    ``scout_batch`` (never TTA) and promotes the ``n_scout`` best-ranked
    frames of each sweep; tier 2 runs the S*n_scout promoted frames at
    ``img_size`` through the main ``model`` in shared micro-batches of
    ``batch`` (honouring ``tta``) and ranks, refines and selects exactly as
    the direct path does; all S*n_cand candidates refine in one call.

    ``lowres_enhance`` enhances the scout tier at ``low_size`` and only the
    promoted frames at native resolution; enhancement is per frame, so tier 2
    equals the direct path either way.  ``scout_model`` / ``scout_thr`` give
    tier 1 a model and threshold of its own (default: the main ones);
    ``scout_clip <= 0`` skips CLAHE in the scout tier (needs
    ``lowres_enhance``: without it tier 1 shares tier 2's natively
    CLAHE-enhanced frames); ``scout_rank="closed"`` ranks tier 1 by closed
    area only.

    ``devices`` (the first the primary, where the stack lies) splits the
    scout tier's S*N frames at ``scout_batch`` boundaries and the promoted
    frames' tier-2 forward at ``batch`` boundaries; ``model`` and
    ``scout_model`` are then dicts of one replica per device.  Promotion and
    selection run on the primary device from the gathered rank keys.

    The steps: scout forward (sweeps -> thresholded scout masks), promote
    (fixed points in the rank key -> promoted indices), tier-2 forward
    (-> thresholded native masks), select (fixed points in the rank key and
    the refinement -> ``(cand_idx (S, n_cand) int64, refined (S, n_cand, H,
    W) uint8)``).
    """
    if scout_model is None:
        scout_model = model
    sb = scout_batch or batch
    if not scout_thr:
        scout_thr = threshold
    if scout_clip is not None and scout_clip <= 0 and not lowres_enhance:
        raise ValueError(
            "a no-CLAHE scout (scout_clip<=0) requires "
            "cascade_lowres_enhance=True: without it the scout tier shares "
            "the natively CLAHE-enhanced frames and would rank "
            "off-distribution input")
    if scout_clip is None or not lowres_enhance:
        scout_clip = clahe_clip

    def scout(sweeps):
        """Tier 1: the low-resolution forward over every frame, per shard."""
        S, N, H, W = sweeps.shape
        flat = sweeps.reshape(S * N, H, W)
        srcs, xs = [], []
        with span("scout_preprocess"):
            for part in mesh.split_frames(flat, devices or [flat.device], sb):
                if lowres_enhance:
                    srcs.append(part)
                    lo_u8 = enhance_frames(
                        resize_bilinear(part.to(torch.float32),
                                        (low_size, low_size)),
                        scout_clip, clahe_grid, median_kernel)
                    xs.append(lo_u8.to(torch.float32) / 255.0)
                else:
                    srcs.append(enhance_frames(
                        part, clahe_clip, clahe_grid,
                        median_kernel).to(torch.float32))
                    xs.append(resize_bilinear(srcs[-1], (low_size, low_size))
                              / 255.0)
        with span("scout_forward"):
            binaries = [_threshold(predict_sweep_probs(
                _replica(scout_model, x.device), x, sb, hflip=False),
                scout_thr) for x in xs]
        return srcs, (S, N), binaries

    def promote(state):
        srcs, (S, N), binaries = state
        with span("scout_rank"):
            areas_lo = mesh.gather([candidate_rank_areas(
                b, close_kernel, fill_proxy=(scout_rank != "closed"))
                for b in binaries], srcs[0].device).reshape(S, N)
            return srcs, rank_order(areas_lo, None, n_valid)[:, :n_scout]

    def tier2(state):
        """Tier 2: the full-resolution forward on the promoted frames."""
        srcs, scout_idx = state
        S, (H, W) = scout_idx.shape[0], srcs[0].shape[-2:]
        N = sum(s.shape[0] for s in srcs) // S
        with span("preprocess"):
            flat_idx = (torch.arange(S, device=scout_idx.device)[:, None] * N
                        + scout_idx).reshape(-1)
            xf_hi = _take_frames(srcs, flat_idx)
            if lowres_enhance:
                xf_hi = enhance_frames(xf_hi, clahe_clip, clahe_grid,
                                       median_kernel).to(torch.float32)
            x_hi = resize_bilinear(xf_hi, (img_size, img_size)) / 255.0
        with span("forward"):
            probs_hi = [predict_sweep_probs(_replica(model, x.device), x,
                                            batch, tta)
                        for x in mesh.split_frames(
                            x_hi, devices or [x_hi.device], batch)]
            return scout_idx, mesh.gather([_threshold(gaussian_blur(
                resize_bilinear(p, (H, W)), gauss_k, 0.0), threshold)
                for p in probs_hi], x_hi.device)

    def select(state):
        scout_idx, binary = state
        S, (H, W) = scout_idx.shape[0], binary.shape[-2:]
        with span("select"):
            areas = candidate_rank_areas(binary, close_kernel) \
                .reshape(S, n_scout)
            # ties prefer the higher original frame index, as in the direct
            # path
            local = rank_order(areas, scout_idx, n_valid)[:, :n_cand]
            cand_idx = scout_idx.gather(1, local)
            cand = binary.reshape(S, n_scout, H, W).gather(
                1, local[:, :, None, None].expand(S, n_cand, H, W))
            refined = refine_mask_true_size(cand.reshape(S * n_cand, H, W),
                                            min_area_px, min_area_frac,
                                            close_kernel)
            return cand_idx, refined.reshape(S, n_cand, H, W)

    return [(scout, False), (promote, True), (tier2, False), (select, True)]


def _replica(model, device: torch.device):
    """``model``, or its replica on ``device`` where it is a dict of them."""
    return model[device] if isinstance(model, dict) else model


def cascade_candidates(model, sweeps: torch.Tensor, n_valid: int, **kw):
    """:func:`cascade_steps` run in one go on an (S, N, H, W) stack:
    ``(cand_idx (S, n_cand) int64, refined (S, n_cand, H, W) uint8)``."""
    return run_steps(cascade_steps(model, n_valid, **kw), sweeps)


def _pack_result(cand_idx: torch.Tensor, refined: torch.Tensor,
                 unsettled: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., m) candidate indices, (..., m, H, W) uint8 masks and a 0-d uint8
    of flag bits as one uint8 tensor (..., m, H*W + 5), so that a result
    crosses to the host in one transfer: each mask row is followed by its
    frame index as int32 bytes and by the flags."""
    idx_bytes = cand_idx.to(torch.int32).contiguous().view(torch.uint8) \
        .reshape(*cand_idx.shape, 4)
    flag = torch.zeros((), dtype=torch.uint8, device=refined.device) \
        if unsettled is None else unsettled.to(torch.uint8)
    return torch.cat([refined.reshape(*cand_idx.shape, -1), idx_bytes,
                      flag.expand(*cand_idx.shape, 1)], dim=-1)


def _unpack_result(packed: torch.Tensor, hw: Tuple[int, int]):
    """Host inverse of :func:`_pack_result`: (cand_idx, refined, unsettled)
    in numpy and int (the flag bits)."""
    arr = packed.cpu().numpy()
    cand_idx = np.ascontiguousarray(arr[..., -5:-1]).view(np.int32)[..., 0]
    refined = arr[..., :-5].reshape(*arr.shape[:-1], *hw)
    return cand_idx, refined, int(arr[..., -1].max())


def _replicas(model, devices: List[torch.device], fmt=torch.preserve_format
              ) -> Dict[torch.device, torch.nn.Module]:
    """``model`` (on ``devices[0]``) and a copy of it on each other distinct
    device."""
    return {d: model if d == devices[0] else
            copy.deepcopy(model).to(d, memory_format=fmt) for d in devices}


def _resolve(device, devices):
    """(primary, data devices) of an engine: ``devices[0]`` and ``devices``,
    or ``device`` alone; a card with its index, as the tensors on it name
    it."""
    devs = mesh.resolve_devices([device] if devices is None else devices)
    return devs[0], devs


class AttAsppEngine:
    """Attention-ASPP-UNet inference over full sweeps.

    ``variables`` is the JAX package's nested numpy tree
    (``utils.npz_weights.load_npz_variables``); ``device`` defaults to the
    card and raises if there is none.  ``devices`` (a list, in place of
    ``device``) splits the frames of every path over those devices, the
    first being the primary; a card may be listed twice.  With
    ``PredictConfig.cascade`` and ``cascade_scout_weights`` a second,
    smaller model is loaded for the cascade's tier-1 ranking forward
    (:meth:`_init_scout`).  With ``conv_lowering="int8"`` the variables'
    ``quant`` collection gives the activation scales; without one they are
    calibrated on the first sweep (:meth:`_ensure_quant`).

    Under a ``torch.profiler`` session each request leaves the spans of
    ``utils/profiling.py``: ``submit`` (with ``upload``, the cascade's
    ``scout_preprocess``, ``scout_forward`` and ``scout_rank``, then
    ``preprocess``, ``forward`` and ``select``) and ``collect`` (with
    ``transfer``, ``repeat`` where a step is repeated exactly, and
    ``finish``), both carrying the request's sequence number.  On a card
    ``upload`` spans the host's copy of the input into a pinned staging
    slot; its copy to the card follows on a side stream (counters
    ``staged_uploads`` and ``upload_slot_waits``, ``staging.py``).
    """

    def __init__(self, cfg: Config, variables: Optional[dict] = None,
                 device="cuda", model=None, devices=None):
        self.cfg = cfg
        self.device, self.devices = _resolve(device, devices)
        self.variables = variables
        self._calib_model = None
        if model is None:
            if (cfg.model.conv_lowering == "int8"
                    and not (variables or {}).get("quant")):
                # the direct model serves the calibration forward only
                self._calib_model = jax_variables_to_torch(
                    variables, dataclasses.replace(cfg.model,
                                                   conv_lowering="direct"),
                    device=self.device)
            else:
                model = jax_variables_to_torch(variables, cfg.model,
                                               device=self.device)
        self._set_model(model)
        # on a card the submit halves run their fixed points speculatively,
        # so that the host never waits for the device there
        self.speculate = self.device.type == "cuda"
        self._staging = (Staging(self.device) if self.device.type == "cuda"
                         else None)
        self.exact_repeats = 0       # collects that had to repeat some steps
        self._requests = itertools.count()     # sequence numbers of submits
        self._init_scout(cfg)

    def _init_scout(self, cfg: Config) -> None:
        """Load the optional distilled scout of cascade serving.

        ``cascade_scout_weights`` names a flat-npz checkpoint of a smaller
        Attention-ASPP-UNet that replaces the main model in the cascade's
        tier-1 ranking forward only; tier 2, which produces the served masks,
        always runs the main model.  The ``summary.json`` next to the weights
        supplies what the configuration leaves open: ``use_clahe`` (a scout
        trained without CLAHE must not be served CLAHE input), ``img_size``
        (a scout runs at the resolution it was trained at) and ``base_c``
        (fallback 16; a wrong width is a shape error at load).  A scout is
        the v1 + ASPP model whatever variant the main model is: the
        distilled scouts are trained so.  The scout's
        threshold, unless configured, comes from ``thr.json`` next to the
        weights if that holds ``best_thr_no_tta`` or ``best_thr``, else from
        ``summary.json``; within the chosen file the no-TTA value wins (the
        scout tier never uses TTA).
        """
        self.scout_model = self.scout_models = None
        self._scout_clahe = True
        self._scout_img_size = None
        pc = cfg.predict
        self._scout_thr = float(pc.cascade_scout_thr or 0.0)
        path, flag = pc.cascade_scout_weights, pc.cascade_scout_clahe
        if flag is not None:
            self._scout_clahe = bool(flag)
        if not (pc.cascade and path):
            return
        meta = _read_json_or_empty(Path(path).parent / "summary.json")
        if flag is None:
            self._scout_clahe = bool(meta.get("use_clahe", True))
        if meta.get("img_size"):
            self._scout_img_size = int(meta["img_size"])
        if not self._scout_thr:
            thr_src = _read_json_or_empty(Path(path).parent / "thr.json")
            keys = ("best_thr_no_tta", "best_thr")
            src = thr_src if any(thr_src.get(k) for k in keys) else meta
            for key in keys:
                if src.get(key):
                    self._scout_thr = float(src[key])
                    break
        base_c = pc.cascade_scout_base_c
        if base_c is None:
            base_c = int(meta.get("base_c", 16))
        v1 = ModelConfig()
        # the scout always serves direct (as in the JAX package)
        scout_cfg = dataclasses.replace(
            cfg.model, base_c=base_c, use_att=v1.use_att,
            use_aspp=v1.use_aspp, att_depth=v1.att_depth,
            gate_variant=v1.gate_variant, conv_lowering="direct")
        self.scout_model = jax_variables_to_torch(
            load_npz_variables(path), scout_cfg, device=self.device)
        self.scout_models = _replicas(self.scout_model, self.devices)

    def _set_model(self, model) -> None:
        """Serve ``model`` (None: not calibrated yet), a replica on each
        device."""
        self.model = model
        self.models = {} if model is None else _replicas(model, self.devices)

    @torch.no_grad()
    def _ensure_quant(self, sweep) -> None:
        """Lazy calibration of the int8 path (``conv_lowering="int8"``
        without a ``quant`` collection): ``quant_calib_frames`` evenly spaced
        frames of ``sweep``, preprocessed at ``img_size``, through one
        calibration forward of the direct model on the primary device (K1
        with its absmax output); then the int8 model is built once and
        serves every sweep of the engine's lifetime.  Pass a ``quant``
        collection (:meth:`quant_variables` of an engine, or the JAX
        engine's) for scales that do not depend on the first sweep."""
        if self.model is not None:
            return
        p, pc = self.cfg.preprocess, self.cfg.predict
        n = int(np.shape(sweep)[0])
        idx = np.linspace(0, n - 1, min(pc.quant_calib_frames, n)).astype(int)
        if isinstance(sweep, torch.Tensor):
            frames = sweep[torch.from_numpy(idx).to(sweep.device)]
        else:
            frames = np.asarray(sweep)[idx]
        x = preprocess_sweep(self._to_device(frames), p.img_size, p.clahe_clip,
                             p.clahe_grid, p.median_kernel)
        leaves = list(_leaves(self._calib_model.calibrate(x[:, None])))
        # one transfer of the sites' absmax values
        values = torch.stack([v for _, v in leaves]).cpu().numpy()
        quant: dict = {}
        for (path, _), v in zip(leaves, values):
            tree_set(quant, "/".join(path[:-1]), path[-1], np.float32(v))
        self._calib_model = None
        self._set_model(jax_variables_to_torch(
            {**self.variables, "quant": quant}, self.cfg.model,
            device=self.device))

    def quant_variables(self) -> dict:
        """The variables with the int8 model's ``quant`` collection (per
        site ``act_absmax`` and ``w_scale``), as the JAX engine keeps them:
        saved with ``save_npz_variables``, either package serves them
        without calibrating again."""
        if self.model is None or self.model.cfg.conv_lowering != "int8":
            raise ValueError("quant_variables: no calibrated int8 model")
        return {**{k: v for k, v in self.variables.items() if k != "quant"},
                "quant": quant_tree(self.model)}

    def _to_device(self, sweep) -> torch.Tensor:
        """``sweep`` on the primary device.  On a card, host memory goes
        through the pinned staging slots and the side copy stream
        (``staging.py``): the host waits for its own copy into a slot, not
        for the card, and the compute stream waits for the upload."""
        with span("upload"):
            on_host = not isinstance(sweep, torch.Tensor) or \
                sweep.device.type == "cpu"
            if self._staging is not None and on_host:
                return self._staging.upload(sweep)
            if isinstance(sweep, torch.Tensor):
                return sweep.to(self.device)
            return torch.as_tensor(np.asarray(sweep)).to(self.device)

    # ---------------- full-frame (predict CLI) paths ----------------

    @torch.no_grad()
    def predict_full(self, sweep) -> torch.Tensor:
        """Raw (N, H, W) sweep -> (N, H, W) f32 probabilities at native
        resolution (blurred, ready for thresholding) on the primary device.
        ``tta_hflip`` defaults off in ``PredictConfig``; the predict CLI
        turns it on."""
        self._ensure_quant(sweep)
        return mesh.gather([self._full_probs(s) for s in mesh.split_frames(
            sweep, self.devices, self.cfg.predict.frame_batch)], self.device)

    def _full_probs(self, sweep: torch.Tensor) -> torch.Tensor:
        """:meth:`predict_full` of frames on one device, by its model."""
        p, pc = self.cfg.preprocess, self.cfg.predict
        with span("preprocess"):
            x = preprocess_sweep(sweep, p.img_size, p.clahe_clip,
                                 p.clahe_grid, p.median_kernel)
        with span("forward"):
            probs = predict_sweep_probs(self.models[sweep.device], x,
                                        pc.frame_batch, pc.tta_hflip)
            native = resize_bilinear(probs, tuple(sweep.shape[-2:]))
            return gaussian_blur(native, pc.gaussian_kernel, 0.0)

    @torch.no_grad()
    def psi_sweep(self, sweep) -> np.ndarray:
        """Raw (N, H, W) frames -> (N, H, W) f32 mean attention-psi maps at
        native resolution (the ``--viz_att`` diagnostic): the preprocessed
        frames through the forward (no TTA) in ``frame_batch`` micro-batches,
        every returned psi bilinearly resized to ``img_size``, their mean
        (zeros without a gate), resized to the frame."""
        p, pc = self.cfg.preprocess, self.cfg.predict
        self._ensure_quant(sweep)
        sweep = self._to_device(sweep)
        x = preprocess_sweep(sweep, p.img_size, p.clahe_clip, p.clahe_grid,
                             p.median_kernel)
        S = (p.img_size, p.img_size)
        maps = []
        for i in range(0, x.shape[0], pc.frame_batch):
            xb = x[i:i + pc.frame_batch, None]
            _, psis = self.model(xb, return_psi=True)
            ups = [resize_bilinear(a[:, 0].float(), S) for a in psis
                   if a is not None]
            maps.append(sum(ups) / len(ups) if ups else torch.zeros(
                (xb.shape[0],) + S, dtype=torch.float32, device=self.device))
        psi = resize_bilinear(torch.cat(maps), tuple(sweep.shape[-2:]))
        return psi.cpu().numpy()

    @torch.no_grad()
    def refine(self, probs, threshold: Optional[float] = None
               ) -> torch.Tensor:
        """Threshold and ``refine_mask`` every frame of an (N, H, W)
        probability stack: (N, H, W) uint8 {0, 1} on the stack's device."""
        pc = self.cfg.predict
        thr = pc.threshold if threshold is None else threshold
        return refine_mask(_threshold(torch.as_tensor(probs), thr),
                           pc.min_area_px, pc.min_area_frac, pc.close_kernel)

    def select_best(self, masks) -> int:
        """Top-``topk_frames`` masks by area, winner by traced-contour
        circularity (host numpy)."""
        return select_best_frame_exact(
            torch.as_tensor(masks).cpu().numpy(), self.cfg.predict.topk_frames)

    def _cascade_args(self, thr: float, n: int, n_staged: int, S: int,
                      tier2_batch: int) -> dict:
        """Keyword arguments of :func:`cascade_steps` for ``S`` sweeps of
        ``n_staged`` frames each, of which ``n`` are real.  The refined
        candidate set and the tier-2 micro-batch are bounded by the promote count: frames that never ran at full
        resolution cannot be refined, and ``n_scout`` keeps at least ``topk``
        frames in play for the exact re-rank of the collect half."""
        p, pc = self.cfg.preprocess, self.cfg.predict
        m = max(1, min(pc.topk_frames + pc.refine_margin, n))
        n_scout = min(max(pc.cascade_scouts, pc.topk_frames), n_staged)
        return dict(
            img_size=p.img_size,
            low_size=self._scout_img_size or pc.cascade_img_size,
            clahe_clip=p.clahe_clip, clahe_grid=p.clahe_grid,
            median_kernel=p.median_kernel,
            batch=min(tier2_batch, S * n_scout),
            tta=pc.tta_hflip, gauss_k=pc.gaussian_kernel,
            threshold=float(thr), n_scout=n_scout, n_cand=min(m, n_scout),
            min_area_px=pc.min_area_px, min_area_frac=pc.min_area_frac,
            close_kernel=pc.close_kernel,
            lowres_enhance=pc.cascade_lowres_enhance,
            scout_batch=scout_micro_batch(S * n_staged, pc.cascade_scout_batch,
                                          pc.frame_batch),
            scout_model=self.scout_models, scout_thr=self._scout_thr,
            scout_clip=p.clahe_clip if self._scout_clahe else 0.0,
            scout_rank=pc.cascade_scout_rank, devices=self.devices)

    @torch.no_grad()
    def _submit(self, steps: List[Step], state, hw: Tuple[int, int],
                seq: int):
        """Run the steps of a device half on ``state`` and pack the last
        one's (cand_idx, refined) for the collect half, in a handle that keeps
        the request's sequence number ``seq`` last.  With ``speculate``
        the fixed points read nothing back: bit k of the packed flags says
        that the k-th step with fixed points had not settled, and the handle
        keeps that step's input on the device for the collect half."""
        if not self.speculate:
            return _pack_result(*run_steps(steps, state)), hw, None, seq
        flags = torch.zeros((), dtype=torch.uint8, device=self.device)
        resume = []                  # (index of the step, its input)
        for i, (fn, fixed) in enumerate(steps):
            if not fixed:
                state = fn(state)
                continue
            resume.append((i, state))
            with cc.speculative() as unsettled:
                state = fn(state)
            if unsettled:
                flags = flags | (torch.stack([u.to(self.device) for u in
                                              unsettled]).any()
                                 .to(torch.uint8) << (len(resume) - 1))
        return _pack_result(*state, flags), hw, (steps, resume), seq

    @torch.no_grad()
    def _collect(self, handle):
        """The one device->host transfer of a handle: (cand_idx, refined).
        Where a step's fixed points had not settled, the steps from the
        first such one on run again, with the exact loops."""
        packed, hw, redo, _ = handle
        with span("transfer"):
            cand_idx, refined, flags = _unpack_result(packed, hw)
        if flags:
            self.exact_repeats += 1
            steps, resume = redo
            first, state = resume[(flags & -flags).bit_length() - 1]
            with span("repeat"):
                cand_idx, refined, _ = _unpack_result(
                    _pack_result(*run_steps(steps[first:], state)), hw)
        return cand_idx, refined

    def _case_steps(self, thr: float, n: int) -> List[Step]:
        """Device half of one ``n``-frame case, from the raw sweep to
        (cand_idx (m,), refined (m, H, W))."""
        pc = self.cfg.predict
        if pc.cascade:
            return ([(lambda sweep: self._to_device(sweep)[None], False)]
                    + cascade_steps(self.models, n, **self._cascade_args(
                        thr, n, n, 1, pc.frame_batch))
                    + [(lambda out: (out[0][0], out[1][0]), False)])
        m = max(1, min(pc.topk_frames + pc.refine_margin, n))

        def forward(sweep):
            with span("upload"):
                shards = mesh.split_frames(sweep, self.devices,
                                           pc.frame_batch)
            return [_threshold(self._full_probs(s), thr) for s in shards]

        def select(binaries):
            # each device computes its shard's rank keys; the keys and the
            # candidates' masks gather on the primary device
            with span("select"):
                areas = [candidate_rank_areas(b, pc.close_kernel)
                         for b in binaries]
                cand_idx = rank_candidates(mesh.gather(areas, self.device),
                                           n, m)
                return cand_idx, refine_mask_true_size(
                    _take_frames(binaries, cand_idx), pc.min_area_px,
                    pc.min_area_frac, pc.close_kernel)

        return [(forward, False), (select, True)]

    def predict_case_submit(self, sweep, threshold: Optional[float] = None):
        """Device half of :meth:`predict_case`: probabilities, candidate
        ranking on the device and refinement of the top candidates, through
        the cascade when ``PredictConfig.cascade`` is set.  Nothing is
        transferred to the host here; returns a handle for
        :meth:`predict_case_collect`."""
        pc = self.cfg.predict
        thr = pc.threshold if threshold is None else threshold
        shape = tuple(int(v) for v in np.shape(sweep))
        seq = next(self._requests)
        with span("submit", seq):
            self._ensure_quant(sweep)
            return self._submit(self._case_steps(thr, shape[0]), sweep,
                                shape[-2:], seq)

    def _finish(self, cand_idx: np.ndarray, refined: np.ndarray, spacing):
        """Exact circularity re-rank of one sweep's refined candidates and
        the ellipse AC: (best_frame, mask, ac_mm)."""
        with span("finish"):
            local = select_best_frame_exact(refined,
                                            self.cfg.predict.topk_frames)
            best_mask = refined[local]
            ac = (self.measure(best_mask, spacing) if spacing is not None
                  else float("nan"))
            return int(cand_idx[local]), best_mask, ac

    def predict_case_collect(self, handle,
                             spacing: Optional[Tuple[float, float]] = None):
        """Host half: the one device->host transfer of the case (candidate
        indices and refined masks together), the exact circularity re-rank
        and the ellipse AC.  Returns (best_frame, mask, ac_mm)."""
        with span("collect", handle[-1]):
            return self._finish(*self._collect(handle), spacing)

    def predict_case(self, sweep, spacing: Optional[Tuple[float, float]] = None,
                     threshold: Optional[float] = None):
        """Full sweep -> (best_frame, refined_mask, ac_mm)."""
        return self.predict_case_collect(
            self.predict_case_submit(sweep, threshold), spacing)

    def measure(self, mask: np.ndarray, spacing: Tuple[float, float]) -> float:
        return measure_ac_mm(np.asarray(mask), spacing)

    # ---------------- bulk (multi-sweep) cascade serving ----------------

    def _bulk_steps(self, thr: float, S: int, n: int) -> List[Step]:
        """Device half of a bulk group of ``S`` raw ``n``-frame sweeps, to
        (cand_idx (S, m), refined (S, m, H, W)).  The frame axis is
        zero-padded to a multiple of ``frame_batch``; the padding frames rank
        below every real frame."""
        pc = self.cfg.predict
        pad_n = (-n) % pc.frame_batch

        def upload(sweeps):
            arr = self._to_device(sweeps)
            return F.pad(arr, (0, 0, 0, 0, 0, pad_n)) if pad_n else arr

        return [(upload, False)] + cascade_steps(
            self.models, n, **self._cascade_args(thr, n, n + pad_n, S,
                                                 pc.bulk_frame_batch))

    def predict_bulk_submit(self, sweeps, threshold: Optional[float] = None):
        """Device half for S independent same-shape sweeps, (S, N, H, W), as
        one cascade: the scout scans all S*N frames in shared micro-batches,
        tier 2 forwards the S*n_scout promoted frames in micro-batches of
        ``bulk_frame_batch``, and all candidates refine in one call, so the
        per-call fixed work (a short tier-2 batch, the latency-bound refine
        propagation) is paid once per group.  Promotion and selection stay
        per sweep.  Requires ``PredictConfig.cascade``."""
        pc = self.cfg.predict
        if not pc.cascade:
            raise ValueError("predict_bulk requires PredictConfig.cascade")
        thr = pc.threshold if threshold is None else threshold
        shape = tuple(int(v) for v in np.shape(sweeps))
        seq = next(self._requests)
        with span("submit", seq):
            self._ensure_quant(sweeps[0])
            return self._submit(self._bulk_steps(thr, *shape[:2]), sweeps,
                                shape[-2:], seq)

    def predict_bulk_collect(self, handle,
                             spacing: Optional[Tuple[float, float]] = None
                             ) -> List[tuple]:
        """Host half of :meth:`predict_bulk_submit`: one device->host
        transfer, then per sweep the exact circularity re-rank and the
        ellipse AC.  Returns ``[(best_frame, mask, ac_mm), ...]``, length S."""
        with span("collect", handle[-1]):
            cand_idx, refined = self._collect(handle)
            return [self._finish(cand_idx[s], refined[s], spacing)
                    for s in range(cand_idx.shape[0])]

    def predict_bulk(self, sweeps,
                     spacing: Optional[Tuple[float, float]] = None,
                     threshold: Optional[float] = None) -> List[tuple]:
        """S same-shape sweeps -> ``[(best_frame, mask, ac_mm), ...]``; per
        sweep the results equal S :meth:`predict_case` calls."""
        return self.predict_bulk_collect(
            self.predict_bulk_submit(sweeps, threshold), spacing)

    # ---------------- ROI (container) path ----------------

    @torch.no_grad()
    def predict_roi(self, sweep) -> torch.Tensor:
        """Raw (N, H, W) sweep -> (n_sub, H, W) probabilities of the ROI
        deployment path: ``subsample_frames`` linspace-subsampled frames
        (picked on the host, so only they are uploaded), enhanced, cropped to
        ``roi_size`` around the intensity centroid, forwarded without TTA in
        ``frame_batch`` micro-batches, pasted back into zero maps."""
        pc = self.cfg.predict
        n = int(np.shape(sweep)[0])
        idxs = np.linspace(0, n - 1, min(pc.subsample_frames, n)).astype(int)
        # calibrated on full frames at img_size, as the JAX engine does
        self._ensure_quant(sweep)
        if not isinstance(sweep, torch.Tensor):
            sweep = np.asarray(sweep)
        return mesh.gather([self._roi_probs(s) for s in mesh.split_frames(
            sweep[idxs], self.devices, pc.frame_batch)], self.device)

    def _roi_probs(self, frames: torch.Tensor) -> torch.Tensor:
        """:meth:`predict_roi` of subsampled frames on one device."""
        p, pc = self.cfg.preprocess, self.cfg.predict
        vol = enhance_frames(frames, p.clahe_clip, p.clahe_grid,
                             p.median_kernel).to(torch.float32) / 255.0
        patches, origins = crop_roi(vol, pc.roi_size)
        probs_roi = predict_sweep_probs(self.models[frames.device], patches,
                                        pc.frame_batch, hflip=False)
        return paste_roi_probs(probs_roi, origins, tuple(vol.shape[-2:]))

    @torch.no_grad()
    def postprocess_roi(self, probs: torch.Tensor) -> torch.Tensor:
        return postprocess_roi_stack(probs, 0.05)


class BaselineEngine:
    """PlainConvUNet or SwinUNETR + sliding-window tiled inference (the
    labeled, nnU-Net-style path).

    ``model`` is the port's :class:`PlainConvUNet` or :class:`SwinUNETR`
    (moved to ``device``), or the JAX package's PlainConvUNet params tree as
    numpy, converted with ``jax_plain_unet_to_torch``.  Either network
    takes its tile, step and batching from ``cfg.plain_unet`` (a
    SwinUNETR's tile sides must be multiples of 32).  ``devices`` as in
    :class:`AttAsppEngine`:
    enhancement and the sliding window run per shard, and the softmax stack
    gathers on the primary device, where the 3-D postprocess needs all of
    it.  Its spans: ``predict`` (with ``preprocess`` and ``forward``), then
    ``postprocess``; each postprocess call is counted as
    ``postprocess_calls``."""

    def __init__(self, cfg: Config, model, device="cuda", devices=None):
        self.cfg = cfg
        self.device, self.devices = _resolve(device, devices)
        if isinstance(model, SwinUNETR):
            check_tile(cfg.plain_unet.patch_size)
        elif not isinstance(model, PlainConvUNet):
            model = jax_plain_unet_to_torch(model, cfg.plain_unet)
        # on a card the conv kernels channel-last too, so that cuDNN keeps
        # every activation channel-last instead of converting around each
        # conv (the 1-channel input alone does not decide the layout)
        fmt = (torch.channels_last if self.device.type == "cuda"
               else torch.preserve_format)
        self.model = model.to(self.device, memory_format=fmt).eval()
        self.models = _replicas(self.model, self.devices, fmt)

    @torch.no_grad()
    def predict(self, sweep) -> torch.Tensor:
        """Raw (N, H, W) sweep -> (C, N, H, W) f32 softmax probabilities on
        the device: enhancement at native resolution (one CLAHE over the
        whole stack), then the tiled, mirrored forward."""
        with span("predict"):
            if not isinstance(sweep, torch.Tensor):
                sweep = torch.as_tensor(np.asarray(sweep))
            probs = mesh.gather([self._probs(s) for s in mesh.split_frames(
                sweep, self.devices,
                self._frames_per_batch(sweep.shape[-2:]))], self.device)
            return probs.transpose(0, 1).contiguous()

    def _frames_per_batch(self, hw) -> int:
        """Frames from one tile micro-batch boundary to the next: shards cut
        there batch their tiles as the one-device engine does."""
        pu = self.cfg.plain_unet
        T = 1
        for n, tile in zip(hw, pu.patch_size):
            T *= len(compute_tile_starts(int(n), tile, pu.tile_step))
        return pu.tile_batch // math.gcd(T, pu.tile_batch)

    def _probs(self, sweep: torch.Tensor) -> torch.Tensor:
        """(n, C, H, W) softmax of frames on one device, by its model."""
        p, pu = self.cfg.preprocess, self.cfg.plain_unet
        with span("preprocess"):
            x = preprocess_sweep(sweep, None, p.clahe_clip, p.clahe_grid,
                                 p.median_kernel)
        with span("forward"):
            return sliding_window_predict(
                self.models[sweep.device], x, tuple(pu.patch_size),
                pu.tile_step, pu.use_gaussian, pu.use_mirroring,
                pu.tile_batch, pu.mirror_batch)

    @torch.no_grad()
    def postprocess(self, probabilities) -> torch.Tensor:
        """(C, N, H, W) probabilities -> (N, H, W) uint8 labels: threshold
        0.5 and the largest 3-D component of classes 1 and 2."""
        count("postprocess_calls")
        with span("postprocess"):
            return postprocess_softmax_stack(
                torch.as_tensor(probabilities).to(self.device), 0.5)


def _read_json_or_empty(path: Path) -> dict:
    """A JSON object from ``path``; {} if the file is missing or unreadable."""
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text())
    except (ValueError, OSError):
        return {}
    return data if isinstance(data, dict) else {}


def select_mask_and_frame(mask_stack) -> Tuple[np.ndarray, int]:
    """Max-area frame pick with the -1 / empty contract
    (``select_fetal_abdomen_mask_and_frame``), to the host: (mask2d, frame)."""
    stack = torch.as_tensor(mask_stack)
    if stack.dim() == 2:
        return (stack > 0).to(torch.uint8).cpu().numpy(), 0
    sel, frame = select_max_area_frame(stack)
    return sel.cpu().numpy(), int(frame)


def resize_mask_to(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour paste-back of a mask to native resolution."""
    mask = np.asarray(mask)
    if mask.shape == tuple(hw):
        return (mask > 0).astype(np.uint8)
    out = resize_nearest(torch.from_numpy(mask), tuple(hw))
    return (out.numpy() > 0).astype(np.uint8)


def _take_frames(shards: List[torch.Tensor], idx: torch.Tensor
                 ) -> torch.Tensor:
    """Frames ``idx`` (on the primary device) of the stack that ``shards``
    (contiguous, all but the last of one length) form, on the primary
    device: each shard contributes the frames it holds and zeros elsewhere,
    so that only len(idx) frames per shard cross devices and nothing waits
    for the host."""
    if len(shards) == 1:
        return shards[0][idx]
    per, out = shards[0].shape[0], None
    for d, s in enumerate(shards):
        local = idx.to(s.device) - d * per
        mine = (local >= 0) & (local < s.shape[0])
        rows = s[local.clamp(0, s.shape[0] - 1)] \
            * mine[:, None, None].to(s.dtype)
        rows = rows.to(idx.device)
        out = rows if out is None else out + rows
    return out


def _leaves(tree: dict, path=()):
    """(path, leaf) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _threshold(probs: torch.Tensor, thr: float) -> torch.Tensor:
    """f32 probabilities above the threshold rounded to f32, as 0/1 uint8.
    The threshold stays a Python scalar: a tensor made from it would have to
    be copied to the device, and the host would wait for the device there."""
    return (probs > float(np.float32(thr))).to(torch.uint8)
