"""dimenet [gnn]: 6 blocks d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6 — directional message passing, triplet gather.
[arXiv:2003.03123]"""
from ..models.gnn import dimenet as module
from ..models.gnn.dimenet import DimeNetConfig
from .base import ArchSpec, gnn_cells

NAME = "dimenet"


def make_config(reduced: bool = False, d_feat=None, shape=None
                ) -> DimeNetConfig:
    if reduced:
        return DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                             n_spherical=4, n_radial=4)
    return DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                         n_spherical=7, n_radial=6, d_feat=d_feat)


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="gnn", make_config=make_config,
        cells=gnn_cells(NAME, module, make_config),
        notes="triplet budget = 2*E on the large graph cells (capped "
              "2^26); feature-graph cells synthesize 3-D positions",
    )
