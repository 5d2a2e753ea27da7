"""Sweep preprocessing."""

from .enhance import enhance_frames, preprocess_sweep  # noqa: F401
from .roi import crop_roi, paste_roi_probs  # noqa: F401
