"""Configurations (port of ``repro.configs``: the paper's sketch
configuration, the solver presets and the GraSS configuration)."""
