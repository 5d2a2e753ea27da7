"""Sweep preprocessing."""

from .enhance import enhance_frames, preprocess_sweep  # noqa: F401
