"""Sweep inference: engine, outputs, directory prediction."""

from .engine import AttAsppEngine  # noqa: F401
