"""equiformer-v2 [gnn]: 12L d_hidden=128 l_max=6 m_max=2 8 heads,
SO(2)-eSCN equivariant graph attention. [arXiv:2306.12059]"""
from ..models.gnn import equiformer_v2 as module
from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .base import ArchSpec, gnn_cells

NAME = "equiformer-v2"


def make_config(reduced: bool = False, d_feat=None, shape=None
                ) -> EquiformerV2Config:
    if reduced:
        return EquiformerV2Config(n_layers=2, d_hidden=16, l_max=2,
                                  m_max=1, n_heads=2, n_rbf=8)
    return EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                              n_heads=8, d_feat=d_feat)


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="gnn", make_config=make_config,
        cells=gnn_cells(NAME, module, make_config),
        notes="exact Wigner-D (Ivanic-Ruedenberg) frame alignment; "
              "per-edge irrep state (49 coeff x 128 ch) dominates memory "
              "on ogb_products",
    )
