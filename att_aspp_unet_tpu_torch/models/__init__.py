"""The segmentation models."""

from .att_aspp_unet import AttentionASPPUNet  # noqa: F401
from .plain_unet import PlainConvUNet  # noqa: F401
from .swin_unetr import SwinUNETR  # noqa: F401
