"""Hand-written Hopper kernels (``csrc/``), their wrappers and their plain
PyTorch versions: ``fused_conv.fused_double_cbr`` (K1),
``clahe_interp.clahe_interp`` (K2) and ``int8_conv.int8_conv3x3`` (K3)."""
