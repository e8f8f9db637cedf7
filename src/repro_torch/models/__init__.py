"""Model substrate (the port of ``repro.models``): the LM, GNN and
recsys families."""

from . import gnn, lm, recsys

__all__ = ["gnn", "lm", "recsys"]
