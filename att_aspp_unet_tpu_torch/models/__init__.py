"""The segmentation model."""

from .att_aspp_unet import AttentionASPPUNet  # noqa: F401
