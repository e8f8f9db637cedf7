"""schnet [gnn]: 3 interactions d_hidden=64 rbf=300 cutoff=10 —
continuous-filter convolutions. [arXiv:1706.08566]"""
from ..models.gnn import schnet as module
from ..models.gnn.schnet import SchNetConfig
from .base import ArchSpec, gnn_cells

NAME = "schnet"


def make_config(reduced: bool = False, d_feat=None, shape=None
                ) -> SchNetConfig:
    if reduced:
        return SchNetConfig(n_interactions=2, d_hidden=32, n_rbf=30)
    return SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300,
                        cutoff=10.0, d_feat=d_feat)


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="gnn", make_config=make_config,
        cells=gnn_cells(NAME, module, make_config),
    )
