"""Command-line entry points of the port (``repro_torch.launch.serve``)."""
