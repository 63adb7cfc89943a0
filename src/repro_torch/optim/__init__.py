"""Optimizers and sketched gradient compression (port of ``repro.optim``)."""
