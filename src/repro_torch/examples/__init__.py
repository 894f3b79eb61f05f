"""End-to-end examples of the port, run as ``python -m
repro_torch.examples.<name>``."""
