"""Roofline terms per (arch x shape x mesh) from the dry-run records (the
port of the reference's ``benchmarks/roofline.py``).

Hardware model: one NVIDIA H100 SXM, the data sheet's dense peaks at its
700 W limit (NVIDIA H100 Tensor Core GPU data sheet; published, not
measured):

    bf16 tensor-core compute   989 TFLOP/s  (the LM cells' products)
    float32 without TF32        67 TFLOP/s  (the GNN and recsys cells:
                                             cuBLAS float32, TF32 off)
    HBM3 bandwidth            3.35 TB/s
    NVLink                     450 GB/s a direction

The port's dry run counts each cell's whole step on one device
(``n_devices`` 1 in its records), so each term is value / that device's
peak, in seconds a step:

    compute    = flops / peak of the cell's compute dtype
    memory     = (argument + output bytes + hbm_floor_bytes) / HBM
    collective = collective_bytes / NVLink (0: one card)

MODEL_FLOPS (the "useful" compute) is analytic per family — 6*N_active*D
for LM training, 2*N_active*D for single-pass inference, operation counts
for GNN/recsys — divided by the device count for comparability.  The
formulas are the reference's, over the port's configs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from . import RESULTS

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9

RESULTS_DIR = os.path.join(RESULTS, "dryrun")


def peak_flops(dtype: str) -> float:
    """The data sheet's dense peak for products in ``dtype``."""
    return PEAK_FLOPS[dtype]


# --------------------------------------------------------------------------
# analytic MODEL_FLOPS per cell (global; caller divides by n_devices)
# --------------------------------------------------------------------------

def lm_model_flops(arch: str, shape: str) -> Optional[float]:
    from ..configs import get_arch
    from ..configs.base import LM_SHAPES

    cfg = get_arch(arch).make_config()
    n_active = cfg.param_counts()["active"]
    s = LM_SHAPES[shape]
    if s["kind"] == "train":
        tokens = s["seq"] * s["batch"]
        return 6.0 * n_active * tokens
    if s["kind"] == "prefill":
        tokens = s["seq"] * s["batch"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * s["batch"]


def gnn_model_flops(arch: str, shape: str) -> Optional[float]:
    from ..configs import get_arch
    from ..configs.base import GNN_SHAPES, round_up

    cfg = get_arch(arch).make_config()
    s = GNN_SHAPES[shape]
    if s["batched"]:
        N, E = s["n"] * s["batch"], s["e"] * s["batch"]
    else:
        N, E = round_up(s["n"]), round_up(s["e"])
    d = cfg.d_hidden
    if arch == "graphcast":
        fwd = cfg.n_layers * (E * (3 * d) * d * 2 + N * (2 * d) * d * 2)
    elif arch == "schnet":
        fwd = cfg.n_interactions * (
            E * (cfg.n_rbf * d + d * d) * 2 + N * 2 * d * d * 2)
    elif arch == "dimenet":
        T = min(2 * E, 1 << 26) if not s["batched"] else 256 * s["batch"]
        fwd = cfg.n_blocks * (
            T * (cfg.n_bilinear ** 2 * d) * 2 + E * 2 * d * d * 2)
    else:  # equiformer-v2
        # per edge: rotate in/out (block-diag Wigner matmuls over C
        # channels) + SO(2) linear maps (m=0 full, m>=1 complex pairs)
        wig = sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1))
        so2 = 2 * ((cfg.l_max + 1) * d) ** 2
        for m in range(1, cfg.m_max + 1):
            so2 += 2 * 4 * ((cfg.l_max + 1 - m) * d) ** 2
        fwd = cfg.n_layers * E * (2 * 2 * wig * d + so2)
    # fwd + bwd (train cells).  A count of what autograd runs is lower
    # for SchNet (~1.35x at ogb_products): its filter's first product
    # takes the RBF, which needs no input gradient.
    return 3.0 * fwd


def recsys_model_flops(arch: str, shape: str) -> Optional[float]:
    from ..configs import get_arch
    from ..configs.base import RECSYS_SHAPES

    cfg = get_arch(arch).make_config()
    s = RECSYS_SHAPES[shape]
    de = 2 * cfg.embed_dim
    attn = cfg.seq_len * (
        4 * de * cfg.attn_hidden[0]
        + cfg.attn_hidden[0] * cfg.attn_hidden[1] + cfg.attn_hidden[1]
    ) * 2
    out = (3 * de * cfg.mlp_hidden[0]
           + cfg.mlp_hidden[0] * cfg.mlp_hidden[1]
           + cfg.mlp_hidden[1]) * 2
    per_sample = attn + out
    if s["kind"] == "train":
        return 3.0 * per_sample * s["batch"]
    if s["kind"] == "retrieval":
        return float(per_sample) * s["n_candidates"]
    return float(per_sample) * s["batch"]


def model_flops(arch: str, shape: str) -> Optional[float]:
    from ..configs import get_arch

    fam = get_arch(arch).family
    try:
        if fam == "lm":
            return lm_model_flops(arch, shape)
        if fam == "gnn":
            return gnn_model_flops(arch, shape)
        return recsys_model_flops(arch, shape)
    except Exception:   # the reference's contract: None where it fails
        return None


# --------------------------------------------------------------------------
# table assembly
# --------------------------------------------------------------------------

def load_records(results_dir: Optional[str] = None) -> List[Dict]:
    """Every record under ``results_dir`` (default ``RESULTS_DIR``)."""
    results_dir = results_dir or RESULTS_DIR
    recs = []
    if not os.path.isdir(results_dir):
        return recs
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def hbm_bytes(stats: Dict, io_bytes: float) -> float:
    """The HBM traffic model: inputs and outputs (``io_bytes``) cross HBM
    once, plus the traffic of the ops a fused program still moves
    (products, gathers, scatters, cache writes).  The unfused count
    (``bytes``) is only a diagnostic: eager PyTorch moves it, a fused
    program would not."""
    return io_bytes + stats.get("hbm_floor_bytes", stats["bytes"])


def bound_terms(stats: Dict, io_bytes: float, dtype: str) -> Dict[str, float]:
    """Seconds of each roofline term for counts ``stats`` (``count_step``'s
    keys) whose inputs and outputs are ``io_bytes``, products in
    ``dtype``."""
    return {
        "compute": stats["flops"] / peak_flops(dtype),
        "memory": hbm_bytes(stats, io_bytes) / HBM_BW,
        "collective": stats["collective_bytes"] / NVLINK_BW,
    }


def roofline_row(rec: Dict) -> Optional[Dict]:
    if not rec.get("ok") or "hlo_stats" not in rec:
        return None
    st = rec["hlo_stats"]
    f, c = st["flops"], st["collective_bytes"]
    ma = rec.get("memory_analysis", {})
    io_bytes = ma.get("argument_size_in_bytes", 0) + ma.get(
        "output_size_in_bytes", 0)
    dtype = rec.get("compute_dtype", "bfloat16")
    terms = bound_terms(st, io_bytes, dtype)
    dom = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    mf_dev = mf / rec["n_devices"] if mf else None
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": dom,
        "bound_s": terms[dom],
        "model_flops_dev": mf_dev,
        "useful_ratio": (mf_dev / f) if (mf_dev and f) else None,
        "roofline_frac": (
            (mf_dev / peak_flops(dtype)) / terms[dom]
            if (mf_dev and terms[dom] > 0) else None
        ),
        "flops_dev": f,
        "bytes_dev": hbm_bytes(st, io_bytes),
        "bytes_unfused_dev": st["bytes"],
        "coll_dev": c,
    }


def table(results_dir: Optional[str] = None, mesh: str = "pod16x16"
          ) -> List[Dict]:
    rows = []
    for rec in load_records(results_dir):
        if rec.get("mesh") != mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':<28}{'shape':<15}{'comp(s)':>10}{'mem(s)':>10}"
           f"{'coll(s)':>10}{'dom':>6}{'useful':>8}{'roof%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        u = f"{r['useful_ratio']:.2f}" if r["useful_ratio"] else "-"
        rf = f"{100 * r['roofline_frac']:.1f}" if r["roofline_frac"] else "-"
        lines.append(
            f"{r['arch']:<28}{r['shape']:<15}{r['t_compute_s']:>10.4f}"
            f"{r['t_memory_s']:>10.4f}{r['t_collective_s']:>10.4f}"
            f"{r['dominant'][:4]:>6}{u:>8}{rf:>7}"
        )
    return "\n".join(lines)
