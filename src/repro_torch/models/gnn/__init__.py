"""The GNN family (the port of ``repro.models.gnn``): SchNet, DimeNet,
GraphCast and EquiformerV2 on segment message passing."""
from . import dimenet, equiformer_v2, graphcast, schnet
from .dimenet import DimeNetConfig
from .equiformer_v2 import EquiformerV2Config
from .graphcast import GraphCastConfig
from .schnet import SchNetConfig
