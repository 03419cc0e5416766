"""Serving entry points for the model zoo, twin of ``repro/launch``."""
