"""Diagnostic outputs of the predict CLI."""
