"""Building blocks: the eval model's (``blocks``, exported here) and the
train model's (``train_blocks``)."""

from .blocks import (ASPP, AttentionGateV1, AttentionGateV2,  # noqa: F401
                     ConvBNReLU, FusedCBRPair, Int8CBRPair, Int8ConvBNReLU,
                     UpBlock)
