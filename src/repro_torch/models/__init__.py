"""Model substrate (the port of ``repro.models``): the recsys family so
far; the LM and GNN families come with their slices."""

from . import recsys

__all__ = ["recsys"]
