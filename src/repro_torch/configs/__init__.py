"""Configurations (port of ``repro.configs``): the paper's sketch
configuration, the solver presets and the GraSS configuration, and the ten
model configurations with their schema (``base``) and ``registry``."""
