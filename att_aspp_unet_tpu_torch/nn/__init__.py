"""Eval-only building blocks."""

from .blocks import (ASPP, AttentionGateV1, AttentionGateV2,  # noqa: F401
                     ConvBNReLU, FusedCBRPair, UpBlock)
