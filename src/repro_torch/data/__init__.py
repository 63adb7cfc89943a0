"""Data pipeline (port of ``repro.data``)."""
