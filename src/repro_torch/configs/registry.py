"""All assigned architectures, importable by id (the port of
``repro.configs.registry``, in its order)."""
from . import (
    deepseek_v3_671b,
    dimenet,
    din,
    equiformer_v2,
    gemma2_2b,
    gemma3_12b,
    graphcast,
    h2o_danube_1_8b,
    llama4_maverick_400b_a17b,
    schnet,
)

_MODULES = (
    llama4_maverick_400b_a17b,
    deepseek_v3_671b,
    gemma3_12b,
    h2o_danube_1_8b,
    gemma2_2b,
    graphcast,
    dimenet,
    equiformer_v2,
    schnet,
    din,
)

ARCHS = {m.NAME: m for m in _MODULES}


def arch_names():
    return tuple(ARCHS)


def get_arch(name: str):
    return ARCHS[name].spec()


def all_cells():
    """[(arch, shape, Cell)] — the 40 cells."""
    out = []
    for name in ARCHS:
        spec = get_arch(name)
        for shape, cell in spec.cells.items():
            out.append((name, shape, cell))
    return out
