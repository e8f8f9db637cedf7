"""din [recsys]: embed_dim=18 seq_len=100 attn MLP 80-40 MLP 200-80,
target attention. [arXiv:1706.06978]"""
from ..models.recsys.din import DINConfig
from .base import ArchSpec, recsys_cells

NAME = "din"


def make_config(reduced: bool = False) -> DINConfig:
    if reduced:
        return DINConfig(n_items=1000, n_cates=20, seq_len=16)
    return DINConfig(n_items=1_000_000, n_cates=1_000, embed_dim=18,
                     seq_len=100, attn_hidden=(80, 40),
                     mlp_hidden=(200, 80))


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="recsys", make_config=make_config,
        cells=recsys_cells(NAME, make_config),
        notes="embedding lookup is the hot path; the history is pooled by "
              "target attention (plain torch); the EmbeddingBag op "
              "(segment_bag, K10) pools bags over the same tables",
    )
