"""Hand-written Hopper kernels (``csrc/``), their wrappers and their plain
PyTorch versions: ``fused_conv.fused_double_cbr`` (K1) and
``clahe_interp.clahe_interp`` (K2)."""
