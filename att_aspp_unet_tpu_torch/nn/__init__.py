"""Eval-only building blocks."""

from .blocks import ASPP, AttentionGateV1, FusedCBRPair, UpBlock  # noqa: F401
