"""Contour tracing and AC measurement (host numpy)."""

from .ellipse import measure_ac_mm  # noqa: F401
