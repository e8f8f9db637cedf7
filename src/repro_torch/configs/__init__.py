"""Per-architecture configs (the port of ``repro.configs``)."""
from .registry import ARCHS, all_cells, arch_names, get_arch
