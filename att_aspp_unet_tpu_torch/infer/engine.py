"""Sweep inference engine: the standalone predict direct path.

Counterpart of ``att_aspp_unet_tpu/infer/engine.py`` (``AttAsppEngine`` direct
path): enhance -> resize 512 -> hflip-TTA forward -> resize back to native ->
5x5 Gaussian -> threshold -> rank candidates by a refined-area proxy ->
refine the top ``topk + refine_margin`` -> exact circularity re-rank on the
host -> ellipse AC.  The device half runs eagerly in PyTorch; the two
hand-written kernels run inside it (CLAHE's K2 in preprocessing, K1 for every
conv pair of the forward).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..device import resolve_device
from ..measure.ellipse import measure_ac_mm
from ..ops.image import gaussian_blur, resize_bilinear
from ..postprocess.morphology import (binary_closing, fill_holes,
                                      structuring_ellipse)
from ..postprocess.refine import refine_mask_true_size
from ..postprocess.select import select_best_frame_exact
from ..preprocess.enhance import preprocess_sweep
from ..utils.convert import jax_variables_to_torch


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


def candidate_rank_areas(binary: torch.Tensor,
                         close_kernel: int = 7) -> torch.Tensor:
    """(N, H, W) 0/1 -> (N,) key ~ each frame's area after refinement: the
    full-resolution close plus 16 px per quarter-resolution cell that hole
    filling adds."""
    closed = binary_closing(binary, structuring_ellipse(close_kernel))
    closed_raw = closed.sum(dim=(-2, -1), dtype=torch.long)
    pooled = _maxpool4_same(closed)
    cells = pooled.sum(dim=(-2, -1), dtype=torch.long)
    filled = fill_holes(pooled).sum(dim=(-2, -1), dtype=torch.long)
    return closed_raw + 16 * (filled - cells)


def rank_candidates(areas: np.ndarray, n_valid: int, n_cand: int) -> np.ndarray:
    """Candidate order: descending area, the higher frame index first on ties
    (``np.argsort(areas)[::-1]``); frames at ``n_valid`` or beyond rank
    below every real frame."""
    areas = np.asarray(areas, np.int64)
    idx = np.arange(areas.shape[0], dtype=np.int64)
    areas = np.where(idx < n_valid, areas, -1)
    return np.lexsort((-idx, -areas))[:n_cand]


class AttAsppEngine:
    """Attention-ASPP-UNet inference over full sweeps on one device.

    ``variables`` is the JAX package's nested numpy tree
    (``utils.npz_weights.load_npz_variables``); ``device`` defaults to the
    card and raises if there is none.

    ``stage_times``: when a dict, every case adds its seconds in
    "preprocess", "forward" and "postprocess" to it, synchronising the
    device at each stage boundary (three syncs per case); None records
    nothing and adds no sync.
    """

    def __init__(self, cfg: Config, variables: Optional[dict] = None,
                 device="cuda", model=None,
                 stage_times: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = jax_variables_to_torch(variables, cfg.model,
                                           device=self.device)
        self.model = model
        self.stage_times = stage_times
        self._t = 0.0

    def _mark(self, stage: Optional[str] = None) -> None:
        """End ``stage`` now (None starts the clock)."""
        if self.stage_times is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_times[stage] = (self.stage_times.get(stage, 0.0)
                                       + now - self._t)
        self._t = now

    def _to_device(self, sweep) -> torch.Tensor:
        return torch.as_tensor(np.asarray(sweep)).to(self.device)

    @torch.no_grad()
    def predict_full(self, sweep) -> torch.Tensor:
        """Raw (N, H, W) sweep -> (N, H, W) f32 probabilities at native
        resolution (blurred, ready for thresholding).  ``tta_hflip`` defaults
        off in ``PredictConfig``; the predict CLI turns it on."""
        p, pc = self.cfg.preprocess, self.cfg.predict
        self._mark()
        sweep = self._to_device(sweep)
        x = preprocess_sweep(sweep, p.img_size, p.clahe_clip, p.clahe_grid,
                             p.median_kernel)
        self._mark("preprocess")
        probs = predict_sweep_probs(self.model, x, pc.frame_batch,
                                    pc.tta_hflip)
        self._mark("forward")
        native = resize_bilinear(probs, tuple(sweep.shape[-2:]))
        return gaussian_blur(native, pc.gaussian_kernel, 0.0)

    @torch.no_grad()
    def predict_case_submit(self, sweep, threshold: Optional[float] = None):
        """Device half of :meth:`predict_case`: probabilities, candidate
        ranking and refinement of the top candidates.  Returns a handle for
        :meth:`predict_case_collect`."""
        pc = self.cfg.predict
        thr = pc.threshold if threshold is None else threshold
        n = int(np.shape(sweep)[0])
        probs = self.predict_full(sweep)
        binary = _threshold(probs, thr)
        areas = candidate_rank_areas(binary, pc.close_kernel)
        m = max(1, min(pc.topk_frames + pc.refine_margin, n))
        cand_idx = rank_candidates(areas.cpu().numpy(), n, m)
        cand = binary[torch.as_tensor(cand_idx, device=binary.device)]
        refined = refine_mask_true_size(cand, pc.min_area_px,
                                        pc.min_area_frac, pc.close_kernel)
        return cand_idx, refined

    def predict_case_collect(self, handle,
                             spacing: Optional[Tuple[float, float]] = None):
        """Host half: exact circularity re-rank of the refined candidates and
        the ellipse AC.  Returns (best_frame, mask, ac_mm)."""
        cand_idx, refined = handle
        refined = refined.cpu().numpy()
        local = select_best_frame_exact(refined, self.cfg.predict.topk_frames)
        best_mask = refined[local]
        ac = (measure_ac_mm(best_mask, spacing) if spacing is not None
              else float("nan"))
        self._mark("postprocess")
        return int(cand_idx[local]), best_mask, ac

    def predict_case(self, sweep, spacing: Optional[Tuple[float, float]] = None,
                     threshold: Optional[float] = None):
        """Full sweep -> (best_frame, refined_mask, ac_mm)."""
        return self.predict_case_collect(
            self.predict_case_submit(sweep, threshold), spacing)


def _threshold(probs: torch.Tensor, thr: float) -> torch.Tensor:
    t = torch.tensor(np.float32(thr), device=probs.device)
    return (probs > t).to(torch.uint8)
