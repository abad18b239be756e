"""The examples on the port (counterparts of ``examples/``):
``python -m repro_torch.examples.<name> [--device cuda|cpu]``."""
