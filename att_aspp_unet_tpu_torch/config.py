"""Configuration of the predict path: the fields of
``att_aspp_unet_tpu/config.py`` that this path reads, with the same names and
defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class PreprocessConfig:
    """Per-frame enhancement: min-max -> CLAHE -> median-3 -> resize."""

    clahe_clip: float = 1.0      # <= 0 disables CLAHE
    clahe_grid: Tuple[int, int] = (8, 8)   # cv2 order: (cols, rows)
    median_kernel: int = 3
    img_size: int = 512          # network input H = W


@dataclass(frozen=True)
class ModelConfig:
    """Attention-ASPP-UNet, v1 gates on u4/u3/u2, ASPP bridge."""

    in_channels: int = 1
    num_classes: int = 1
    base_c: int = 48
    aspp_rates: Tuple[int, ...] = (6, 12, 18)
    compute_dtype: str = "bfloat16"   # "float32" for reference-precision runs


@dataclass(frozen=True)
class PredictConfig:
    """Sweep prediction settings (``predict()`` of the reference CLI)."""

    threshold: float = 0.48
    tta_hflip: bool = False      # the predict CLI turns it on
    gaussian_kernel: int = 5
    topk_frames: int = 5
    refine_margin: int = 11      # extra refined candidates beyond topk
    min_area_px: int = 20
    min_area_frac: float = 0.0015
    close_kernel: int = 7
    frame_batch: int = 16        # frames per forward micro-batch


@dataclass(frozen=True)
class Config:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
