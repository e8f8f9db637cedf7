"""graphcast [gnn]: 16L d_hidden=512 mesh_refinement=6 sum-aggregation
n_vars=227 — encoder-processor-decoder mesh GNN. [arXiv:2212.12794]"""
from ..models.gnn import graphcast as module
from ..models.gnn.graphcast import GraphCastConfig
from .base import ArchSpec, gnn_cells

NAME = "graphcast"


def make_config(reduced: bool = False, d_feat=None, shape=None
                ) -> GraphCastConfig:
    if reduced:
        return GraphCastConfig(n_layers=2, d_hidden=32, n_vars=8)
    n_vars = d_feat if d_feat is not None else 16  # molecule cells: 16
    return GraphCastConfig(n_layers=16, d_hidden=512, n_vars=n_vars,
                           mesh_refinement=6)


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="gnn", make_config=make_config,
        cells=gnn_cells(NAME, module, make_config),
        notes="n_vars follows the cell's feature width (227 is the "
              "native weather config; the four assigned shapes carry "
              "their own d_feat)",
    )
