"""Configurations (port of ``repro.configs``; this slice carries the
paper's sketch configuration and the solver presets)."""
