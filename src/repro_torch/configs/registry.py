"""The ported architectures, importable by id (the reference's
``repro.configs.registry``; DIN so far, the LM and GNN configs come with
their slices)."""
from . import din

_MODULES = (din,)

ARCHS = {m.NAME: m for m in _MODULES}


def arch_names():
    return tuple(ARCHS)


def get_arch(name: str):
    return ARCHS[name].spec()


def all_cells():
    """[(arch, shape, Cell)]."""
    out = []
    for name in ARCHS:
        spec = get_arch(name)
        for shape, cell in spec.cells.items():
            out.append((name, shape, cell))
    return out
