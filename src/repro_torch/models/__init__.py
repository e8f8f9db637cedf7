"""Model substrate (the port of ``repro.models``): the recsys and LM
families; the GNN family comes with its slice."""

from . import lm, recsys

__all__ = ["lm", "recsys"]
