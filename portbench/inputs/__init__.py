"""Inputs of the benchmark's cells, made from the run's seed."""
