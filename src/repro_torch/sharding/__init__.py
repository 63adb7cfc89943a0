"""Sharding: activation constraints + parameter partition rules (port of ``repro.sharding``)."""
