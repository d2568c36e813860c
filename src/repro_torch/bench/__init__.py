"""Benchmarks of the port (``python -m repro_torch.bench.<name>``)."""
