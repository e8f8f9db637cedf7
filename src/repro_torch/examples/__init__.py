"""Runnable examples of the port (the port of the reference's root
``examples/`` RangeReach scripts), each ``python -m
repro_torch.examples.<name>``, on the GPU unless ``--device cpu``."""
