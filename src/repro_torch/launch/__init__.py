"""Entry points: ``python -m repro_torch.launch.serve`` (the serve CLI)."""
