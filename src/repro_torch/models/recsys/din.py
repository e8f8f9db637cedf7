"""DIN — Deep Interest Network (Zhou et al., 2017), the port of
``repro.models.recsys.din``.

Assigned config: embed_dim=18, seq_len=100, attention MLP 80-40, output
MLP 200-80, target attention interaction.  The hot path is the embedding
lookup over the large item and category tables.  The history is pooled
by target attention: a weighted sum whose weights the attention MLP
computes per (history item, target) pair, in plain torch as the
reference has it.  The EmbeddingBag op
(:func:`repro_torch.kernels.segment_bag.embedding_bag`, K10) pools bags
of rows of the same tables by sum or mean; this model does not call it.

Serving shapes: ``serve_p99`` / ``serve_bulk`` batch scoring through
:func:`apply`, and ``retrieval_cand``, which scores ONE user's history
against 10^6 candidate items in chunks of batched products
(:func:`score_candidates`).

A batch is a dict of tensors on the parameters' device: ``hist_items``
(B, S) int32, ``hist_mask`` (B, S) bool, ``target_item`` (B,) int32 and,
for :func:`loss_fn`, ``label`` (B,) float32.

Under a process mesh (``mesh``) the leaves are placed by
``mlp_param_spec``: both tables split on their rows where ``model``
divides them (looked up vocabulary-parallel, ``nn.lookup``), the two
MLPs in the Megatron pairing (``nn.mlp``).  A batch's rows, or the
retrieval's candidates, are this rank's block over the data axes:
:func:`loss_fn`'s mean is the whole batch's, and a rank scores its
candidates in chunks with a last partial one where the chunk does not
divide its block (a candidate's score does not depend on its chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ...device import DeviceLike, resolve_device
from ...distributed import collectives as CO
from ..nn import DATA, Params, data_mean, embed_init, local_tree, lookup
from ..nn import mlp, mlp_init, tree_to


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cates: int = 1_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: Tuple[int, ...] = (80, 40)
    mlp_hidden: Tuple[int, ...] = (200, 80)


def _draw(generator: torch.Generator, cfg: DINConfig) -> Params:
    d = cfg.embed_dim
    de = 2 * d  # item + cate concatenated
    return {
        "item_emb": embed_init(generator, cfg.n_items, d),
        "cate_emb": embed_init(generator, cfg.n_cates, d),
        # attention MLP input: [h, t, h - t, h * t]
        "attn": mlp_init(generator, (4 * de,) + cfg.attn_hidden + (1,)),
        # final MLP input: [pooled, target, pooled * target]
        "mlp": mlp_init(generator, (3 * de,) + cfg.mlp_hidden + (1,)),
    }


def init_params(generator: torch.Generator, cfg: DINConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn on the CPU from ``generator`` (a CPU
    generator), then moved to ``device`` (``None``: the GPU), so one seed
    gives the same values on either device."""
    dev = resolve_device(device)
    return tree_to(_draw(generator, cfg), dev)


def param_shapes(cfg: DINConfig) -> Params:
    """The parameters as ``meta`` tensors: shapes and dtypes, no storage
    (what ``jax.eval_shape(init_params)`` gives the reference)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


def _embed_items(params: Params, items: torch.Tensor, cfg: DINConfig,
                 mesh=None):
    """(..., ) item ids -> (..., 2*embed_dim) item||category embedding.

    An item id outside ``[-V, V)`` embeds as NaN, as the reference's
    ``jnp.take`` fills it; ids in range wrap (``nn.lookup``).  The
    EmbeddingBag op (``kernels.segment_bag``) keeps the same rule: its
    plain version clamps and fills the same way, and K10 wraps an id in
    ``[-V, 0)`` and adds NaN for one outside."""
    cates = items % cfg.n_cates
    ie = lookup(params["item_emb"]["emb"], items, cfg.n_items, mesh)
    ce = lookup(params["cate_emb"]["emb"], cates, cfg.n_cates, mesh)
    return torch.cat([ie, ce], dim=-1)


def target_attention(params, hist_e, target_e, hist_mask, mesh=None):
    """DIN's local activation unit.

    hist_e (B, S, de), target_e (B, de) -> pooled (B, de)."""
    B, S, de = hist_e.shape
    t = target_e[:, None, :].expand(B, S, de)
    feats = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    logits = mlp(params["attn"], feats, act="sigmoid",
                 mesh=mesh)[..., 0]                              # (B, S)
    logits = torch.where(hist_mask, logits, -1e30)
    # DIN uses un-normalised activation weights (no softmax) per the paper;
    # softmax stays off, masked entries get weight 0
    w = torch.where(hist_mask, torch.sigmoid(logits), 0.0)
    return torch.einsum("bs,bsd->bd", w, hist_e)


def apply(params: Params, batch: Dict, cfg: DINConfig, mesh=None
          ) -> torch.Tensor:
    """Returns click logits (B,) (under a mesh, this rank's rows')."""
    params = local_tree(params)
    hist_e = _embed_items(params, batch["hist_items"], cfg, mesh)
    target_e = _embed_items(params, batch["target_item"], cfg, mesh)
    pooled = target_attention(params, hist_e, target_e, batch["hist_mask"],
                              mesh)
    feats = torch.cat([pooled, target_e, pooled * target_e], -1)
    return mlp(params["mlp"], feats, act="sigmoid", mesh=mesh)[..., 0]


def loss_fn(params: Params, batch: Dict, cfg: DINConfig, mesh=None
            ) -> torch.Tensor:
    """The mean binary cross-entropy of the logits (under a mesh, of
    every rank's rows)."""
    logits = apply(params, batch, cfg, mesh)
    y = batch["label"]
    return data_mean(
        torch.clamp(logits, min=0) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits))), mesh)


def score_candidates(
    params: Params, batch: Dict, cfg: DINConfig, chunk: int = 8192,
    mesh=None,
) -> torch.Tensor:
    """retrieval_cand: one user, (C,) candidate items -> (C,) scores.

    The target-attention features depend on the candidate, so the exact
    DIN score is O(C*S); candidates are scored in C/chunk batched
    products, one chunk at a time, so the (chunk, S, 4*de) feature
    tensor (not the (C, S, 4*de) one) bounds memory.  ``C`` (under a
    mesh, every rank's candidates together) must be a multiple of
    ``chunk`` (or at most ``chunk``), as the reference asserts; a rank
    scores its block, its last chunk partial where ``chunk`` does not
    divide the block."""
    params = local_tree(params)
    cand = batch["candidates"]                                   # (C,)
    hist = batch["hist_items"]                                   # (S,)
    mask = batch["hist_mask"]                                    # (S,)
    hist_e = _embed_items(params, hist, cfg, mesh)               # (S, de)
    S, de = hist_e.shape
    C = cand.shape[0]
    total = C * CO.axis_size(CO.process_mesh(mesh), DATA)
    chunk = min(chunk, total)
    if total % chunk:
        raise ValueError(f"{total} candidates are not a multiple of the "
                         f"chunk {chunk}")

    def score_chunk(cand_c):
        cand_e = _embed_items(params, cand_c, cfg, mesh)         # (c, de)
        c = cand_e.shape[0]
        h = hist_e[None].expand(c, S, de)
        t = cand_e[:, None].expand(c, S, de)
        feats = torch.cat([h, t, h - t, h * t], dim=-1)
        logits = mlp(params["attn"], feats, act="sigmoid",
                     mesh=mesh)[..., 0]
        w = torch.where(mask[None], torch.sigmoid(logits), 0.0)
        pooled = torch.einsum("cs,sd->cd", w, hist_e)
        f2 = torch.cat([pooled, cand_e, pooled * cand_e], -1)
        return mlp(params["mlp"], f2, act="sigmoid", mesh=mesh)[..., 0]

    return torch.cat([score_chunk(c) for c in cand.split(chunk)])
