"""Sweep inference: engine, outputs, directory prediction."""
