"""Configuration of the serving paths (direct, cascade, bulk, ROI container,
nnU-Net baseline), of threshold calibration and of training: the fields of
``att_aspp_unet_tpu/config.py`` that these paths read, with the same names
and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PreprocessConfig:
    """Per-frame enhancement: min-max -> CLAHE -> median-3 -> resize."""

    clahe_clip: float = 1.0      # <= 0 disables CLAHE
    clahe_grid: Tuple[int, int] = (8, 8)   # cv2 order: (cols, rows)
    median_kernel: int = 3
    img_size: int = 512          # network input H = W


@dataclass(frozen=True)
class ModelConfig:
    """Attention-ASPP-UNet: v1 gates (BN, on u4/u3/u2) or v2 gates (no BN,
    residual ``x*a + x``, on u4 when ``att_depth`` >= 4 and u3 when >= 3),
    ASPP bridge or a single ConvBNReLU (``use_aspp=False``)."""

    in_channels: int = 1
    num_classes: int = 1
    base_c: int = 48
    use_att: bool = True
    use_aspp: bool = True
    att_depth: int = 4               # v2 gates on u4 (>= 4) and u3 (>= 3)
    gate_variant: str = "v1"         # "v1" | "v2"
    aspp_rates: Tuple[int, ...] = (6, 12, 18)
    aspp_dropout: float = 0.1        # training only: the identity at eval
    compute_dtype: str = "bfloat16"   # "float32" for reference-precision runs


@dataclass(frozen=True)
class PlainUNetConfig:
    """nnU-Net-style PlainConvUNet of the baseline path: the plan "2d" of
    ``resources/nnUNet_results/.../plans.json`` (7 stages, base 32 features
    capped at 512, 2 convs per stage, patch 448 x 576), predicted with
    Gaussian-weighted half-overlapping tiles and mirror TTA.  The JAX
    package's TPU-only ``conv_lowering`` has no counterpart here."""

    in_channels: int = 1
    num_classes: int = 3             # background / optimal / suboptimal
    base_c: int = 32
    max_c: int = 512
    n_stages: int = 7
    conv_per_stage: int = 2
    patch_size: Tuple[int, int] = (448, 576)
    tile_step: float = 0.5
    use_gaussian: bool = True
    use_mirroring: bool = True
    mirror_batch: bool = True        # the 4 mirror views as one forward
    tile_batch: int = 32             # patch tiles per forward micro-batch
    compute_dtype: str = "bfloat16"  # "float32" for reference-precision runs
    param_dtype: str = "float32"     # InstanceNorm's affine parameters


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
    # tier-2 micro-batch of bulk (multi-sweep) cascade serving: the promoted
    # frames of all sweeps of a group share micro-batches of this size
    bulk_frame_batch: int = 16
    roi_size: int = 224          # ROI deployment path: crop side
    subsample_frames: int = 128  # ROI path: linspace subsample of the sweep
    # Two-tier cascade (opt-in): scout every frame with a cheap low-resolution
    # forward, run the full forward only on the ``cascade_scouts`` best-ranked
    # frames; ranking, refinement and selection then run on full-resolution
    # probabilities exactly as in the direct path.
    cascade: bool = False
    cascade_img_size: int = 256  # scout size of a scout-less cascade; a
    #                              scout's summary.json img_size overrides it
    cascade_scouts: int = 8      # frames promoted to the full forward
    # enhance the scout tier at the scout size and only the promoted frames
    # at native resolution (tier 2 stays identical to the direct path)
    cascade_lowres_enhance: bool = True
    cascade_scout_batch: int = 128   # scout micro-batch; 0 = frame_batch
    # optional distilled scout: flat-npz weights of a smaller model used for
    # the tier-1 ranking forward only.  base_c / clahe None = read from the
    # summary.json next to the weights; thr 0 = adopt the scout's thr.json
    cascade_scout_weights: Optional[str] = None
    cascade_scout_base_c: Optional[int] = None
    cascade_scout_clahe: Optional[bool] = None
    cascade_scout_rank: str = "refined"   # or "closed": no hole-fill proxy
    cascade_scout_thr: float = 0.0


@dataclass(frozen=True)
class CalibrateConfig:
    """Threshold calibration: ``thr_steps`` thresholds from ``thr_lo`` to
    ``thr_hi``, the mean Dice over the val set at each; ``with_ci`` adds the
    per-threshold statistics, a t-distribution 95 % CI and plots."""

    thr_lo: float = 0.1
    thr_hi: float = 0.9
    thr_steps: int = 17
    with_ci: bool = False


@dataclass(frozen=True)
class ContainerConfig:
    """Grand-Challenge container contract: read
    ``<input>/images/stacked-fetal-ultrasound/*.mha|*.tiff``, write
    ``<output>/images/fetal-abdomen-segmentation/<case>.mha`` (uint8 {0, 1},
    spacing 0.28, compressed) and ``<output>/fetal-abdomen-frame-number.json``.
    ``MODEL_TAG`` selects the model, ``CASE_ID`` names the output."""

    input_path: str = "./test/input"
    output_path: str = "./test/output"
    model_tag: str = "baseline"      # "baseline" | "att_aspp"
    case_id: str = "output"
    spacing_mm: float = 0.28
    # as in the JAX package's config; read by its AC analysis tools, which
    # are not ported, and by nothing in this package yet
    frames_per_sweep: int = 140


@dataclass(frozen=True)
class LossConfig:
    """Criterion = weighted BCE + Dice (or Tversky) + Sobel edge loss."""

    loss_type: str = "combo"         # "combo" (Dice+BCE) | "tversky"
    tversky_alpha: float = 0.7
    tversky_beta: float = 0.3
    dice_smooth: float = 1.0
    edge_weight: float = 0.05
    neg_bce_weight: float = 0.05     # finetune-only empty-mask down-weight


@dataclass(frozen=True)
class AugmentConfig:
    """Training augmentation on the device: hflip, affine, gamma,
    brightness/contrast, elastic, then the deterministic CLAHE + median-3
    tail (``use_clahe=False`` trains on unequalised input, for a scout whose
    serving tier skips CLAHE)."""

    hflip_p: float = 0.5
    affine_p: float = 0.7
    scale_range: Tuple[float, float] = (0.92, 1.08)
    rotate_deg: float = 7.0
    translate_frac: float = 0.02
    gamma_p: float = 0.3
    gamma_range: Tuple[float, float] = (0.8, 1.2)
    brightness_contrast_p: float = 0.3
    brightness_limit: float = 0.1
    contrast_limit: float = 0.1
    elastic_p: float = 0.25
    elastic_alpha: float = 8.0
    elastic_sigma: float = 3.0
    use_clahe: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Two-stage (main -> finetune) training: batch 8, 120 epochs, lr 3e-4,
    AdamW wd 5e-4, 5 % linear warmup (in epochs) -> cosine, global-norm clip
    1.0, early-stop patience 15, seed 2025."""

    seed: int = 2025
    stage: str = "main"              # "main" | "finetune"
    batch_size: int = 8
    epochs: int = 120
    lr: float = 3e-4
    weight_decay: float = 5e-4
    grad_clip: float = 1.0
    warmup_frac: float = 0.05        # no warmup in the finetune stage
    early_stop_patience: int = 15
    val_frac: float = 0.1            # positive-only fallback split
    differential_lr: bool = False    # attention params at lr, backbone 0.5x
    loss: LossConfig = field(default_factory=LossConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass(frozen=True)
class Config:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    plain_unet: PlainUNetConfig = field(default_factory=PlainUNetConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
    calibrate: CalibrateConfig = field(default_factory=CalibrateConfig)
    container: ContainerConfig = field(default_factory=ContainerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
