"""Models (port of ``repro.models``): the dense decoder family in PyTorch."""
