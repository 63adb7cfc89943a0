"""Command-line entry points of the port (``repro_torch.launch.serve``, ``repro_torch.launch.train``)."""
