"""The port's examples, run with ``python -m repro_torch.examples.<name>``."""
