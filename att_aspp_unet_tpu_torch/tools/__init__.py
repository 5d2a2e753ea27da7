"""Test and smoke-run tooling."""
