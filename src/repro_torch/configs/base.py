"""Architecture/cell registry (the port of ``repro.configs.base``: the
LM, GNN and recsys families).

An ``ArchSpec`` names an architecture, its family, a config factory (full
or reduced), and its shape cells.  A ``Cell`` knows how to produce, for
one device:

    fn         — the step to run (train step / prefill / decode step /
                 serve / retrieval scoring)
    args       — its inputs as ``meta`` tensors: shapes and dtypes, no
                 storage (the reference's ``ShapeDtypeStruct``s); a train
                 cell's are the parameters, the AdamW state and a batch

The reference attaches a mesh sharding to each input.  A cell built
with no mesh is the whole step on one device; a cell built with a
process or counting mesh (``build(mesh)``: ``collectives.CountingMesh``
for rank 0 of the production mesh) is one rank's step, its parameters
``reshard``ed by the family's rule (this rank's blocks) and a train
cell's AdamW moments by ``opt_state_specs`` (ZeRO-1):

* an LM cell under ``lm_param_spec``: a train cell's whole batch (the
  step cuts its rows), a serving cell's tokens and cache cut to this
  rank's rows where the data axes divide the batch (the reference's
  token spec), the cache in the port's layout under the mesh
  (``init_cache``);
* a GNN cell under ``mlp_param_spec``: its whole batch, which the step
  cuts by the reference's ``_gnn_batch_sds`` specs
  (:func:`gnn_batch_specs`): a batch of molecules by molecule, a full
  graph's nodes, edges and triplets each into their blocks over the
  data axes, its energy whole;
* a recsys cell under ``mlp_param_spec``: the train cell's whole batch
  (the step cuts its rows), a serving cell's rows and the retrieval
  cell's candidates cut to this rank's block over the data axes (the
  reference's ``_din_batch_sds`` and candidate specs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


def round_up(x: int, k: int = 512) -> int:
    return ((x + k - 1) // k) * k


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    builder: Callable[..., Tuple[Callable, Tuple]]

    def build(self, mesh=None):
        """(step, inputs) on one device, or with ``mesh`` one rank's."""
        return self.builder() if mesh is None else self.builder(mesh)


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                       # lm | gnn | recsys
    make_config: Callable[..., Any]   # make_config(reduced=False)
    cells: Dict[str, Cell]
    notes: str = ""


# ==========================================================================
# LM family
# ==========================================================================

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _lm_params(cfg, mesh):
    """The parameters on meta: whole, or this rank's blocks under
    ``lm_param_spec`` (and their specs)."""
    from ..distributed import lm_param_spec
    from ..models.lm import param_shapes

    return _placed(param_shapes(cfg), lm_param_spec, mesh)


def _placed(p_meta, rule, mesh):
    """(the whole parameters, this rank's blocks under ``rule``, their
    specs); with no mesh the whole ones twice and no specs."""
    from ..distributed import param_specs, reshard

    if mesh is None:
        return p_meta, p_meta, None
    specs = param_specs(p_meta, rule, _axes(mesh), mesh)
    return p_meta, reshard(p_meta, mesh, specs), specs


def train_state(params, rule, mesh):
    """(parameters, AdamW's zero state) of a train cell: ``params``
    (``meta`` tensors for shapes, or values) whole with no mesh, or
    this rank's blocks under ``rule`` on ``mesh`` (a process or counting
    mesh) with the moments placed by ``opt_state_specs`` (ZeRO-1: split
    over the data axes too)."""
    from ..distributed import opt_state_specs, reshard
    from ..train import adamw_init

    whole, placed, specs = _placed(params, rule, mesh)
    opt = adamw_init(whole)
    if mesh is not None:
        opt = reshard(opt, mesh, opt_state_specs(
            opt, whole, specs, _axes(mesh), mesh))
    return placed, opt


def _axes(mesh):
    from ..distributed import MeshAxes

    names = mesh.mesh_dim_names
    return MeshAxes(data=tuple(a for a in ("pod", "data") if a in names))


def _rows(batch: int, mesh) -> int:
    """A serving batch's rows on one rank: split over the data axes where
    they divide it (the reference's token spec), else all of them."""
    if mesh is None:
        return batch
    n = _axes(mesh).data_size(mesh)
    return batch // n if batch % n == 0 and batch >= n else batch


def _block_rows(n: int, mesh) -> int:
    """A batch's rows (or candidates) on one rank: split over the data
    axes, which must divide them (the reference's ``P(data)``)."""
    if mesh is None:
        return n
    k = _axes(mesh).data_size(mesh)
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} data ranks")
    return n // k


def _lm_train_builder(cfg_fn, seq, batch):
    def build(mesh=None):
        from ..distributed import lm_param_spec
        from ..models.lm import lm_loss, param_shapes
        from ..train import AdamWConfig, make_train_step

        cfg = cfg_fn()
        params, opt = train_state(param_shapes(cfg), lm_param_spec, mesh)
        b_meta = {"tokens": _meta((batch, seq), torch.int32),
                  "labels": _meta((batch, seq), torch.int32)}
        step = make_train_step(
            lambda p, b: lm_loss(p, b, cfg, mesh=mesh, remat=True),
            AdamWConfig(), mesh=mesh)
        return step, (params, opt, b_meta)

    return build


def _lm_prefill_builder(cfg_fn, seq, batch):
    def build(mesh=None):
        from ..models.lm import prefill

        cfg = cfg_fn()

        def fn(params, tokens):
            return prefill(params, tokens, cfg, max_len=seq, mesh=mesh)

        return fn, (_lm_params(cfg, mesh)[1],
                    _meta((_rows(batch, mesh), seq), torch.int32))

    return build


def _lm_decode_builder(cfg_fn, seq, batch):
    def build(mesh=None):
        from ..models.lm import cache_shapes, decode_step

        cfg = cfg_fn()

        def fn(params, cache, token):
            return decode_step(params, cache, token, cfg, mesh=mesh)

        b = _rows(batch, mesh)
        return fn, (_lm_params(cfg, mesh)[1],
                    cache_shapes(cfg, b, seq, mesh),
                    _meta((b,), torch.int32))

    return build


def lm_cells(name: str, cfg_fn) -> Dict[str, Cell]:
    out = {}
    for shape, s in LM_SHAPES.items():
        if s["kind"] == "train":
            b = _lm_train_builder(cfg_fn, s["seq"], s["batch"])
        elif s["kind"] == "prefill":
            b = _lm_prefill_builder(cfg_fn, s["seq"], s["batch"])
        else:
            b = _lm_decode_builder(cfg_fn, s["seq"], s["batch"])
        out[shape] = Cell(arch=name, shape=shape, kind=s["kind"], builder=b)
    return out


# ==========================================================================
# GNN family
# ==========================================================================

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n=2708, e=10556, f=1433,
                          batched=False),
    "minibatch_lg": dict(kind="train", n=1024 + 1024 * 15 + 1024 * 15 * 10,
                         e=1024 * 15 + 1024 * 15 * 10, f=602,
                         batched=False, sampled=True),
    "ogb_products": dict(kind="train", n=2_449_029, e=61_859_140, f=100,
                         batched=False),
    "molecule": dict(kind="train", n=30, e=64, f=None, batched=True,
                     batch=128),
}
MOLECULE_TRIPLETS = 256    # DimeNet's triplet budget a molecule
MOLECULE_VARS = 16         # GraphCast's n_vars on the molecule cell


def gnn_triplets(e: int, triplet_factor: int = 2) -> int:
    """DimeNet's triplet budget on a graph cell of ``e`` edges."""
    return round_up(min(triplet_factor * e, 1 << 26))


def _gnn_batch_meta(arch: str, s: Dict, triplet_factor: int = 2):
    """The batch of a GNN cell as ``meta`` tensors (the reference's
    ``_gnn_batch_sds`` without its shardings): graph dims rounded up to
    multiples of 512, padding masked."""
    if s["batched"]:
        B, n, e = s["batch"], s["n"], s["e"]

        def bs(shape, dtype):
            return _meta((B,) + shape, dtype)

        batch = {
            "pos": bs((n, 3), torch.float32),
            "species": bs((n,), torch.int32),
            "edge_src": bs((e,), torch.int32),
            "edge_dst": bs((e,), torch.int32),
            "edge_mask": bs((e,), torch.bool),
            "node_mask": bs((n,), torch.bool),
            "energy": bs((), torch.float32),
        }
        if arch == "dimenet":
            T = MOLECULE_TRIPLETS
            batch["id_kj"] = bs((T,), torch.int32)
            batch["id_ji"] = bs((T,), torch.int32)
            batch["triplet_mask"] = bs((T,), torch.bool)
        if arch == "graphcast":
            f = MOLECULE_VARS
            batch["feat"] = bs((n, f), torch.float32)
            batch["target"] = bs((n, f), torch.float32)
            batch.pop("energy")
        return batch
    n, e, f = round_up(s["n"]), round_up(s["e"]), s["f"]
    batch = {
        "pos": _meta((n, 3), torch.float32),
        "feat": _meta((n, f), torch.float32),
        "edge_src": _meta((e,), torch.int32),
        "edge_dst": _meta((e,), torch.int32),
        "edge_mask": _meta((e,), torch.bool),
        "node_mask": _meta((n,), torch.bool),
    }
    if arch == "graphcast":
        batch["target"] = _meta((n, f), torch.float32)
    else:
        batch["energy"] = _meta((), torch.float32)
    if arch == "dimenet":
        T = gnn_triplets(e, triplet_factor)
        batch["id_kj"] = _meta((T,), torch.int32)
        batch["id_ji"] = _meta((T,), torch.int32)
        batch["triplet_mask"] = _meta((T,), torch.bool)
    return batch


def gnn_batch_specs(batch: Dict, batched: bool, mesh) -> Dict:
    """The reference's ``_gnn_batch_sds`` specs of a GNN batch: every
    leaf over the data axes on its leading dim (molecules, or a full
    graph's nodes, edges and triplets), a full graph's energy whole."""
    data = _axes(mesh).data
    return {k: () if not batched and k == "energy" else (data,)
            for k in batch}


def _gnn_loss(arch: str, module, cfg, batched: bool, mesh=None):
    def graph_energy_loss(params, batch):
        # geometric models on feature graphs: graph-scalar regression
        pred = module.apply(params, batch, cfg, mesh)
        return ((pred - batch["energy"]) ** 2, {})

    def graphcast_loss(params, batch):
        return (module.loss_fn(params, batch, cfg, mesh), {})

    def batched_loss(params, batch):
        if arch == "graphcast":
            return (module.molecule_loss(params, batch, cfg, mesh), {})
        # the molecular losses flatten the batch themselves
        return (module.loss_fn(params, batch, cfg, mesh), {})

    if batched:
        return batched_loss
    if arch == "graphcast":
        return graphcast_loss
    return graph_energy_loss


def _gnn_builder(name: str, module, cfg_fn, shape: str):
    s = GNN_SHAPES[shape]

    def build(mesh=None):
        from ..distributed import mlp_param_spec
        from ..train import AdamWConfig, make_train_step

        # feature-graph cells need d_feat wired into the config
        cfg = cfg_fn(d_feat=None if s["batched"] else s["f"], shape=shape)
        params, opt = train_state(module.param_shapes(cfg), mlp_param_spec,
                                  mesh)
        b_meta = _gnn_batch_meta(name, s)
        specs = (None if mesh is None
                 else gnn_batch_specs(b_meta, s["batched"], mesh))
        step = make_train_step(
            _gnn_loss(name, module, cfg, s["batched"], mesh),
            AdamWConfig(), mesh=mesh, batch_specs=specs)
        return step, (params, opt, b_meta)

    return build


def gnn_cells(name: str, module, cfg_fn) -> Dict[str, Cell]:
    return {
        shape: Cell(arch=name, shape=shape, kind=GNN_SHAPES[shape]["kind"],
                    builder=_gnn_builder(name, module, cfg_fn, shape))
        for shape in GNN_SHAPES
    }


# ==========================================================================
# RecSys family (DIN)
# ==========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


def _din_batch_meta(B, S, with_label=True):
    b = {
        "hist_items": _meta((B, S), torch.int32),
        "hist_mask": _meta((B, S), torch.bool),
        "target_item": _meta((B,), torch.int32),
    }
    if with_label:
        b["label"] = _meta((B,), torch.float32)
    return b


def _din_builder(cfg_fn, shape: str):
    s = RECSYS_SHAPES[shape]

    def build(mesh=None):
        from ..distributed import mlp_param_spec
        from ..models.recsys import din

        cfg = cfg_fn()
        p_meta = din.param_shapes(cfg)
        if s["kind"] == "train":
            from ..train import AdamWConfig, make_train_step

            params, opt = train_state(p_meta, mlp_param_spec, mesh)
            b_meta = _din_batch_meta(s["batch"], cfg.seq_len)
            step = make_train_step(
                lambda p, b: (din.loss_fn(p, b, cfg, mesh), {}),
                AdamWConfig(), mesh=mesh)
            return step, (params, opt, b_meta)
        params = _placed(p_meta, mlp_param_spec, mesh)[1]
        if s["kind"] == "serve":
            b_meta = _din_batch_meta(_block_rows(s["batch"], mesh),
                                     cfg.seq_len, with_label=False)
            return ((lambda p, b: din.apply(p, b, cfg, mesh)),
                    (params, b_meta))
        # retrieval: one user, C candidates split over the data axes
        C = round_up(s["n_candidates"], 8192)
        b_meta = {
            "hist_items": _meta((cfg.seq_len,), torch.int32),
            "hist_mask": _meta((cfg.seq_len,), torch.bool),
            "candidates": _meta((_block_rows(C, mesh),), torch.int32),
        }
        return ((lambda p, b: din.score_candidates(p, b, cfg, mesh=mesh)),
                (params, b_meta))

    return build


def recsys_cells(name: str, cfg_fn) -> Dict[str, Cell]:
    return {
        shape: Cell(arch=name, shape=shape,
                    kind=RECSYS_SHAPES[shape]["kind"],
                    builder=_din_builder(cfg_fn, shape))
        for shape in RECSYS_SHAPES
    }
