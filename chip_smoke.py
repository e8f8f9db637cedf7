#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of 2DReach serving, its baselines, its
device build and SCC, the recsys substrate's DIN serving and training
path, the LM family and the GNN family on one NVIDIA GPU, and count
the timed model cells' roofline bounds.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises, so the exit code is
not 0.  Where ``torch.cuda.is_available()`` is false, or the package is
not beside this script, it exits with code 2 and prints no result.

  device   the card's name and power limit (as ``nvidia-smi`` gives them)
  build    ``nvcc`` of every kernel source in the checkout
           (``_build.SOURCES``), one compiler per source, all started
           together; the ``ptxas`` register and spill lines per kernel
  kernels  each kernel against its plain PyTorch version on the card,
           exact equality.  Random arenas at the yelp x1.0 2dreach-comp
           shape and at an edge shape, B = 8 and 24 (at B = 24 the last
           query tile has only empty slices: a row of no candidate).
           Fused serve: every mode, kcap below, at and above the true
           candidate count and the tile count.  Tile prune, and the
           descent / count / collect scans with K below, at and above
           the true count and K = NTp.  The polygon scan on the same
           two arena sizes with 4- and 8-edge buckets (inert padded
           half-planes) and venues planted exactly on polygon vertices
           and edges.  The descent, count and polygon scans (K3, K4,
           K6: a thread block cluster per query tile) and the collect
           scan (K5: a warp per query tile and slot) on a 3,000-tile
           polygon arena at B = 8, 256 and 2048 (clusters of min(8, K),
           8 and 1 CTAs) and K = 1, 2, 3, 16 and 64, a row of padding
           only and tiles outside the arena; the polygon scan also at
           16 and 1024 half-planes; the closure product at the yelp
           x1.0 level-0 shape (17,878 x 90 words x 95 words) and at
           ragged small shapes
           with bit 31 set, and on BITSET_EDGE (f = 1, 7, 9, 4,099; Wm
           = 1, 3, 90, 200; W = 1 to 300) with dense rows, rows without
           a bit and bits at columns >= m; the segmented MBR at fan 16,
           128 and 8 with ragged N and inert slots; the full-arena leaf
           scan on
           random arenas of 12,204, 3 and 0 tiles (P = 0 padded to one
           inert tile) at dims 2 and 3 and B = 8, 24 and 33 (ragged),
           with tree ids of -1 and slices that start and end inside
           128-entry tiles, and on planes of P = 0, 1,001 (unaligned)
           and 40,000 entries at B = 1 to 2048 with slices of every
           start residue mod 4 and length 0 to 5,000, clipped, empty
           and reversed ones, hits planted at a slice's first or last
           entry or nowhere (``slice_edge_case``), each also on a copy
           of the planes at a misaligned base (the scalar
           instantiation); the fused EmbeddingBag (K10) at D = 18, 32
           and 128, tables of 10 to 1,000,000 rows in float32 and bf16,
           ragged bag counts, empty bags, an all-padding tail and L = 0
           (one inert tile), within the summation bound of its plain
           version on the card (``sum_error_bound``: 2 n_b 2^-24 times
           the bag's magnitude sum plus an ulp of it; the largest
           |diff| / bound is printed) and bit for bit equal to it on
           the CPU, also on ids -1,
           -V, -V - 1, V and the int32 extremes (NaN where the plain
           version has NaN), and ``embedding_bag`` giving the
           reference's rows for ids [0, 7], [-1, 0] and [0, -8].  The two pyramid
           prunes (fused serve K1 in every mode, tile prune K2) on
           slices of every kind per query tile (8 disjoint ones, nested
           and overlapping ones, degenerate ones beside a short one, one
           over the whole arena), on an arena of 3,000 tiles at B = 8,
           24, 256 and 2048 and on one of 77,390 tiles (NTp = 77,440, the
           yelp x0.5 base arena) at B = 8 and 256, kcap below, at and
           above the true count (and at nt for the small batches)
  main     the main paths: host build of yelp x1.0 2dreach-comp and
           2dreach-pointer and of yelp x0.5 2dreach (base, whose pyramid
           exceeds shared memory); for each, ``QueryEngine`` on the card
           answering 2048 queries (extent 5%) in batches of 256 with
           query_batch, count_batch and collect_batch(k=10), twice;
           equal to the host index and, on a 256-query sample, to the
           BFS oracle; the ratchet flat in the second pass.  Then the
           same 2048 queries, twice, through query/count/collect
           _batch_two_phase, equal to the host index and the fused
           answers.  Then kNN (k=8) for 256 queries at the workload's
           rect centres on yelp x1.0 comp, on the fused and the
           two-phase path, equal to the host best-first descent.  Every
           kernel's launch count is reset just before each path and read
           just after: fused serve once per batch plus ratchet re-runs;
           then a batch with a vertex id out of range (n, and -n - 1)
           raises IndexError on the host and the same engine answers the
           first batch as the host index does (the CUDA context lives);
           the prune once per two-phase batch, each scan once per batch
           of its mode; kNN launches the fused serve on the fused path,
           and the count and collect scans but no fused serve on the
           two-phase path.  Polygons: 2048 6-gons (extent 5%) per
           index in batches of 256, plus batches of 3-4-gons and of
           3-12-gons (edge buckets 8, 4 and 16), equal to the host
           polygon path and, on a 256-query sample, to the BFS oracle;
           the prune and the polygon scan launch once per batch
  obs      the observability hooks (``repro_torch.obs``) on main's
           engines at yelp x1.0 2dreach-comp and x0.5 2dreach: answers
           with obs on equal to those with it off (reach, count and
           collect on both paths, kNN k = 8, a 6-gon batch; B = 256);
           span coverage >= 0.95 of a traced mixed pass (fused reach,
           two-phase count, collect, kNN, polygons) with its stage
           totals, twice; ``engine.batch_us`` counting exactly the
           batches served, the ``engine.n_compiles`` gauge equal to the
           engine's and flat in the second pass; ``engine.upload.*`` and
           ``range_query.soa_builds`` moving as a second engine, a host
           build and a device build (yelp x0.1) predict; each engine's
           cost model; ``obs.dump`` parsing file by file;
           the exactness auditor over 2,048 answers (an eighth also
           against the BFS oracle) with no divergence, and one
           divergence and one flight bundle for an answer flipped by
           hand; e2e µs/query of fused and two-phase reach with obs off
           and on, in turns
  device_build  ``build_index(..., backend="device")`` on the card for
           the three main-path indexes: every index array equal to the
           host build of phase main, the engine adopts the forest (one
           adoption, no upload), its reach answers to the main-path
           batches equal the host-built engine's; host and device build
           seconds (closure, forest) and the closure-product and
           segmented-MBR launches per index; each closure-product
           launch's (f, Wm, m, W) and set bits of A.  Then the closure's
           gather arm (``kernel="gather"``): its bits and K7's equal to
           ``closure_np`` on the build's closure inputs, no kernel
           launched; ``device_kernel="gather"`` builds equal to the host
           build (K8 launched, no K7), adopted, answering as the host
           does; both arms' closure seconds (median of 3 after a
           warm-up) and aten ops a level step
  scc      the device SCC (``scc_torch``, trim + colouring) on the
           card: equal to its CPU run (labels and sweep counts) on the
           yelp x1.0 and x0.5 graphs, and at Yelp's real size
           (``get_dataset("yelp", scale=49.72)``: 2.14M vertices) to
           ``scc_np``'s partition labelled by each component's largest
           vertex id; card seconds beside ``scc_np``'s, the trim,
           propagate and mark sweeps, the colouring rounds and the peak
           bytes
  legacy   the leaf-scan engine (``range_query_forest``) serving the
           main workload of each index in batches of 256, for the host
           build and the device build: equal to the host index on every
           query whose vertex is not excluded, K9 launched once per
           batch, the entry planes neither uploaded nor adopted again
           but shared with the ``QueryEngine`` that uploaded (host
           build) or adopted (device build) them; the wavefront engine
           (``query_wavefront``, capacity 128, plain torch) on each host
           build, equal to the host index where it did not overflow,
           with the overflowed queries counted; 3DReach, 3DReach-Rev
           and GeoReach built on the host at yelp x1.0, their answers
           equal to 2dreach-comp's on the workload and to the BFS oracle
           on a 256-query sample, ``batch_query(engine="device",
           required=True)`` raising for each; K9 at dim 3 against its
           plain version on the leaf scan of the probe each 3DReach
           variant's ``query_batch`` hands ``query_host``; the index
           sizes (``index_nbytes``) and build seconds of all six methods
           at yelp x1.0
  main_batches  every kernel against its plain version on each index's
           first main-path batch (after the counts are read); K9 on the
           leaf-scan engine's first batch
  paper    the paper's harness (``repro_torch.benchmarks``) at a cut
           below ``run.py``'s default (the four datasets at x0.1, 200
           Figure 3 queries per parameter value; ``run.py``: x0.25,
           400): Tables 2-4, the claims' PASS /
           FAIL lines and Figure 3's sweep with its stability ratios
           (host builds and descents; each workload's oracle gate also on
           the 2DReach methods' engines on the card); ``perf_build`` at
           yelp x0.12 (every device build's forest and answers equal to
           the host build's, the engine adopting it; K7 and K8 counted);
           ``perf_queries``' class sweep at yelp x0.1 2dreach-comp (256
           queries, k = 8: reach, count, collect, kNN on the fused and
           the two-phase path, polygons, each equal to the host,
           ``n_compiles`` flat), then each class and path once more with
           its launches counted
  resilience  ``ResilientEngine`` over main's yelp x1.0 2dreach-comp
           engine, B = 256: healthy (every class equal to the host, no
           fallback, the bare engine's launches); one injected raise on
           ``engine.query_batch`` (one retry, exact, two attempts); the
           retries spent with ``degraded_path="two_phase"`` (as many
           fires as attempts, so the degraded call runs clean: exact, one
           K2 and one K3 launch, every query degraded); the breaker
           tripped (the host answers every class, nothing launches); a
           corrupt answer on ``engine.answer`` (the exactness auditor
           flags one divergence); a 0.5 s stall then an error past a
           0.1 s deadline (no retry, the host answers, bounded); the
           disabled fault hooks' crossings and cost per batch against
           ``obs_overhead``'s 2% gate
  dynamic  ``DynamicIndex(engine="device")`` on yelp x1.0 2dreach-comp,
           its base built on the card with the device backend and
           adopted (no upload), against the port's host-engine
           ``DynamicIndex`` fed the same updates (``streaming_workload``
           with perf_dynamic's mix: edges 0.6, vertices 0.2, check-ins
           0.2): main's 2,048 queries in batches of 256 at overlay
           sizes 0, 64, 256 and 1,024, every answer equal, 64 of them
           equal to the BFS oracle on ``snapshot_graph()``, the engine's
           shapes flat once warm, µs/query per overlay size; count,
           collect (k = 8) and a 6-gon batch at the largest overlay;
           one sync compaction, one background compaction while batches
           are served and 4 updates race each batch (the tail replayed,
           ``last_error`` None after ``join``), a third one, each with
           its K7 and K8 launches, seconds and device memory; a crash
           injected at ``dynamic.compaction.mid_swap`` rolls back (the
           same answers); device memory beyond the base's own tensors
           flat across the three swaps and the crash; no host upload
  cluster  ``ShardedEngine`` at 1, 4 and 8 shards on yelp x0.5 2dreach
           and at 1 and 4 on x1.0 2dreach-comp (main's indexes and
           workloads; 8 shards there cut for the script's time): the
           fused and the two-phase answers to all 2,048 queries equal to
           ``query_host`` and main's single-device engine; per batch S
           K1 launches (plus S per ratchet re-run), or S K2 and S K3;
           µs/query per S and path, the LPT balance, the common width
           Pp and the stacks' bytes; ``shard_arenas`` of phase
           device_build's forests equal to the host path's, K8 twice
           per shard, one adoption; a ``Frontend`` (max_batch 256) over
           2,048 submits from 4 threads, answers equal, its mean batch;
           ``DynamicIndex(engine="cluster", n_shards=4)`` on yelp x1.0
           2dreach-comp fed phase dynamic's updates, equal to its
           host-engine index before and after one compaction
  timing   the launch floor (the profiler's device time of a
           one-element ``add_``, printed beside the serving kernels'
           bounds); at B=256 on yelp x1.0 comp: device time per launch
           of each kernel and of its plain version (torch.profiler;
           CUDA-event times of the fused serve beside them as
           ``event_ms``), the bound counted from these inputs (the
           pyramid planes only within the batch's slice spans, the tiles
           a prune must read; in reach mode a query needs its worklist's
           slice entries only up to its first hit; the bound over whole
           worklists beside it), end-to-end microseconds per query per
           mode on both paths; the fused serve (every mode) and the
           prune also on the yelp x0.5 base batch, whose arena is 6x
           larger.  The polygon scan on the
           first polygon batch of yelp x1.0 comp, the closure product on
           the largest launch of that index's device build, the
           segmented MBR on the largest launch of the yelp x0.5 base
           device build (its R-tree leaf level, the node count padded
           to a power of two), each with its library
           yardstick where one exists, and end-to-end microseconds per
           polygon query; the closure product also summed over every
           launch of the three device builds (each distinct shape timed
           once), per index, against the sum of the launches' bounds
  timing_slice4  K9 on the first leaf-scan batch of yelp x1.0 comp and
           of yelp x0.5 base, and on a random arena of 12,204 tiles
           whose 256 queries probe distinct slices (dims 2 and 3):
           device ms, plain ms, the bound from these inputs (a query
           needs its slice up to its first hit); K9 summed over its 48
           main-path launches (each distinct set of operands timed
           once), per path, against the sum of their bounds; end-to-end
           µs per query of the leaf-scan, wavefront and fused engines on
           every index
  recsys   DIN at its published widths (1M items, d = 18, S = 100,
           attention MLP 80-40, MLP 200-80), parameters from a
           torch.Generator seed, batches from ``din_batches``, float32
           products without TF32: serve_p99 (B = 512) and serve_bulk
           (B = 262,144, about 36 GB at its peak) through ``apply``, the
           logits of 512 rows and the loss
           equal to ``apply`` on the CPU within 1e-4; retrieval_cand
           (one user, 1,007,616 candidates) through
           ``score_candidates``, its first two chunks equal to the CPU
           within 1e-4; per shape end-to-end µs per batch (host clock)
           and device busy µs, and serve_bulk's peak allocation.  Then
           the EmbeddingBag op over DIN's item table, the serve batches'
           histories as bags, sum and mean: one K10 launch each (counts
           reset just before, read just after), within 1e-5 of
           ``segment_bag_torch`` on the card; K10 timed on both batches'
           bags with its plain version, ``F.embedding_bag`` as the
           library yardstick, the bound from these inputs and the
           gather's 32-byte sector traffic beside it
  lm       the LM family (``repro_torch.models.lm``), float32 products
           without TF32: the five reduced configs (llama4-maverick,
           deepseek-v3 with MLA, MoE and MTP, gemma3, h2o-danube,
           gemma2) on the card against the CPU from the same
           parameters: prefill of 16 tokens, 4 decode steps, ``lm_loss``
           and one AdamW step, logits and losses within 1e-4 (1 +
           |CPU|), parameters within 1e-4 relative in norm; gemma2-2b
           at its published widths in float32 (10.5 GB): a prefill of
           4,608 tokens (past the 4,096 window: the local rings
           wrapped) and 512 teacher-forced decode steps, every step's
           logits within 2e-3 (1 + |forward|) of ``forward`` over all
           5,120 tokens; then gemma2-2b in bf16, timed: prefill_32k at
           B = 1, decode_32k at B = 16 from a cache filled to 32,767,
           long_500k at B = 1 from a cache filled to 524,287 (the cuts
           in ``reduced``): ms a prefill or decode step, tokens/s, peak
           bytes, a decode step's device busy µs and top operations.
           No kernel of the port lies on this path (counts read)
  gnn      the GNN family (``repro_torch.models.gnn``), float32 products
           without TF32: GraphCast, DimeNet, EquiformerV2 and SchNet
           reduced, on the launcher's molecules (8 of 12 atoms), on the
           card against the CPU from the same parameters: the forward
           outputs, the loss and one AdamW step (loss within 1e-5
           relative, outputs, parameters and moments within 1e-4
           relative in norm; EquiformerV2's last attention bias, whose
           gradient is zero in exact arithmetic, held to be noise); each
           at its published widths on the cells molecule (B = 128, 30
           atoms, 64 edges), full_graph_sm (2,708 nodes, 10,556 edges,
           f = 1,433) and minibatch_lg (``sample_blocks``, 1,024 seeds,
           fan-outs 15 and 10, over a seeded CSR of ogb_products' 2.45M
           nodes and mean degree; EquiformerV2 at 128 seeds, GraphCast
           at 640: ``reduced``), the cell's own step, 2 warm-up and 5
           timed AdamW steps, a new batch each: ms a step, graphs or
           edges a second, peak and base bytes, every loss finite and
           every parameter moved, one molecule step profiled per model
           (busy share, top operations); ogb_products' four cells on
           meta (parameter, AdamW and batch bytes) and SchNet on its
           nodes with 1/8 of its edges, 2 steps; EquiformerV2 at l_max
           6 on one molecule invariant under 3 rotations within 1e-3;
           the port's ``gnn_molecules`` example; the train launcher's
           crash and resume with SchNet (``--steps 30 --ckpt-every
           10``, resumed within 1e-5 of a clean run).  No kernel of the
           port lies on this path (counts read)
  profile  torch.profiler over one reach pass on each path (fused,
           two-phase, leaf scan, wavefront) and one polygon pass: device
           operations and busy time per batch, and the busy share of
           the end-to-end time
  obs_trace  last of the profiled windows (after one, later windows
           lost their device rows): ``device_trace`` around a fused and
           a two-phase reach pass of main's yelp x1.0 comp workload,
           holding one kernel event per K1, K2 and K3 launch and the
           ``annotate`` range (a window short of events traced again,
           up to three times)
  serve    the serving launcher (``python -m repro_torch.launch.serve``,
           run in-process) at phase main's scale: yelp x1.0
           2dreach-comp, 2,048 Zipf(1.2) queries, B = 256, ``--engine
           cluster --obs --audit-sample 0.05``: answers equal to the
           host's, the shapes served flat through the steady state, the
           exactness audit with no divergence, the obs artifacts
           written (to a temporary directory under ``build/``, removed
           after), p50 / p95 / p99 and the frontend's mean batch;
           ``serve_chunked`` over main's yelp x1.0 comp engine for the
           device (K1), kernel (K9) and wavefront arms, no second
           build, each equal to the host (the forest probes where the
           vertex is not excluded) with its p50 / p95 / p99; the
           launcher's ``--query-class knn --engine device`` at yelp
           x0.1 (1,024 queries, device equal to host and the BFS
           oracle on 64); ``perf_rangereach --smoke`` (its structural
           gates, and the regression sentinel's ratio gates on what it
           wrote, PASS or FAIL as measured); ``chaos_flight`` (an SLO
           burn freezes a bundle that replays complete, also through
           the CLI); each path's launches counted
  train    DIN's ``train_batch`` cell at its published widths (B =
           65,536, S = 100): the cell's step, 3 warm-up and 5 timed
           AdamW steps on the card, a new ``din_batches`` batch each
           (uploaded within the step's time), ms a step and the peak
           allocation, every loss finite and every parameter moved; the
           first step on 512 rows of the first batch against the same
           step on the CPU from the same parameters: the loss within
           1e-5 relative, every parameter and moment within 1e-4
           relative in norm (the embedding's backward adds with atomics
           on the card); then the training launcher in-process on the
           card with the reduced gemma2 (``--steps 30 --ckpt-every
           10``): a crash at step 15, ``--resume`` from step 10, and a
           clean run, the resumed step-30 loss within 1e-5 of the clean
           one (measured as the card runs by default, and again under
           ``torch.use_deterministic_algorithms(True)`` where the gap is
           larger); a checkpoint of the resumed run's card tensors and
           their bf16 casts restored onto the card bit for bit
  dryrun   each model cell timed above counted on meta tensors
           (``repro_torch.analysis.count_step``) at the shapes it was
           timed at: gemma2-2b prefill_32k (B = 1), decode_32k (B = 16)
           and long_500k, the four GNNs on molecule, full_graph_sm and
           minibatch_lg (GNN_CUTS' seeds, the padded sizes), DIN's
           train_batch: FLOPs, HBM-floor bytes, the roofline bound
           (``benchmarks.roofline``: the H100's data-sheet peak for the
           cell's dtype, HBM3) and the measured ms over it
  timers   the profiler's retries (a window with no device rows, or a
           row whose count is not a multiple of the calls, is profiled
           again), every time taken with CUDA events because no try was
           whole (``by_events``; empty when every time is the
           profiler's), and each timed window's device rows

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab SRC

runs only phase ``ab``, with the ``repro_torch`` package under ``SRC``
(for instance a parent commit's ``src``, unpacked with ``git archive``):
fused and two-phase reach end to end (µs/query, B = 256, obs off) on
yelp x1.0 2dreach-comp and x0.5 2dreach, K1 in every mode, K2 and the descent, count and collect scans (K3-K5)
on the first batch of yelp x1.0 2dreach-comp and of yelp x0.5 2dreach,
the polygon scan (K6) on the first 6-gon batch of yelp x1.0 comp,
K3, K4 and K6 also at thread block clusters of 1, 2, 4 and 8 CTAs and
K5 at 1, 2, 4 and 8 warps a CTA, K3 and K5 summed over their main-path
launches (each index's two-phase serving, twice, and the two-phase
kNN),
DIN's serve_p99 and serve_bulk end to end and device busy, the
device time of their histories' item embedding, the closure product
(K7) on every launch of the three device builds (summed per index,
with each index's largest launch), the leaf-scan probe (K9) on the
first leaf-scan batch of yelp x1.0 comp and x0.5 base and on the
random arena at dims 2 and 3, and summed over its 48 launches, with
the launch floor, the fused EmbeddingBag (K10) on the bags of
serve_p99's and serve_bulk's histories over DIN's item table, with its
plain version, ``F.embedding_bag``, its bound and the gather's 32-byte
sector traffic, also at 1 to 64 segments a warp and, on serve_bulk's
bags, over the table's first 10,000 to 700,000 rows, on inputs that
every checkout of the port makes alike; phase ``build`` first, for the
checkout's ``ptxas`` lines.
Run it for two checkouts in turns (parent, change, change, parent) in
one call to compare them on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks at 700 W.  The float32 rate outside the tensor cores,
# 67 TFLOP/s, counts an FMA as two operations on 128 FP32 lanes per SM; a
# compare is one instruction, so float32 compares run at half that rate,
# as do multiply-adds, and integer compares, on the SM's 64 INT32 lanes,
# at a quarter.
HBM_BYTES_PER_S = 3.35e12
F32_CMP_PER_S = 67e12 / 2
I32_CMP_PER_S = 67e12 / 4
F32_FMA_PER_S = 67e12 / 2
DEVICE = "cuda"
BATCH = 256
N_QUERIES = 2048
# main path: (dataset, scale, method)
CONFIGS = (("yelp", 1.0, "2dreach-comp"), ("yelp", 1.0, "2dreach-pointer"),
           ("yelp", 0.5, "2dreach"))
# random arenas: (leaf tiles, trees, batch sizes); 12,204 leaf tiles is
# the yelp x1.0 2dreach-comp arena
ARENAS = ((12204, 3000, (8, 24)), (3, 2, (8,)))
# the pyramid prunes' (K1, K2) slice cases: (leaf tiles, batch sizes,
# slice kinds); 77,390 leaf tiles (NTp = 77,440) is the yelp x0.5 2dreach
# arena
SLICE_KINDS = ("disjoint", "nested", "degenerate", "whole")
SLICE_CASES = ((3000, (8, 24, 256, 2048), SLICE_KINDS),
               (77390, (8, 256), ("disjoint", "whole")))
MODES = ("reach", "count", "collect")
COLLECT_K = 10
KNN_K = 8
KNN_QUERIES = 256
SCANS = {"reach": "descent_scan", "count": "count_scan",
         "collect": "collect_scan"}
POLY_EDGES = 6
# K3, K4 and K6 (a cluster per query tile) and K5 (a warp per query
# tile and slot): (B, Ks) on polygon arenas of CLUSTER_SCAN_TILES tiles;
# B = 8, 256 and 2048 give clusters of min(8, K), 8 and 1 CTAs on 132
# SMs
CLUSTER_SCAN_CASES = ((8, (1, 2, 3, 16, 64)), (256, (1, 2, 3, 16, 64)),
                      (2048, (1, 3, 16, 64)))
CLUSTER_SCAN_TILES = 3000
# (B, ne): the engine's edge buckets, then past the 128 half-planes K6
# keeps in shared memory
CLUSTER_NE = ((256, 4), (256, 8), (256, 16), (8, 512), (8, 1024), (8, 4096))
SWEEP_CLUSTERS = (1, 2, 4, 8)      # K3's, K4's and K6's clusters in --ab
SWEEP_WARPS = (1, 2, 4, 8)         # K5's warps per CTA in --ab
SWEEP_SEGMENTS = (1, 2, 4, 8, 16, 32, 64)   # K10's segments a warp
# K10 in --ab also on serve_bulk's bags over the item table's first rows
# only (each index taken modulo the rows): tables in and beyond L2
BAG_TABLE_ROWS = (10_000, 300_000, 500_000, 700_000)
POLY_MIXED = ((3, 4), (3, 12))     # extra batches: edge buckets 4 and 16
# K7's edge cases (f rows, m = 32*Wm - 3 columns so that A's last word
# holds bits at columns >= m, W words of out) and K9's (slice lengths,
# plane widths P, batches B), as in tests/test_torch_cuda.py
BITSET_EDGE = tuple((f, 32 * wm - 3, W) for f in (1, 7, 9, 4099)
                    for wm in (1, 3, 90, 200)
                    for W in (1, 31, 32, 33, 95, 128, 129, 300))
SLICE_LENGTHS = (0, 1, 3, 4, 5, 127, 128, 129, 1800, 5000)
EDGE_P = (0, 1001, 40000)
EDGE_B = (1, 8, 33, 256, 2048)
KERNELS = ("fused_serve", "prune_tiles", "descent_scan", "count_scan",
           "collect_scan", "polygon_scan", "bitset_mm", "seg_mbr",
           "range_query", "segment_bag")
# the kernels that serve queries: the launch floor is printed beside
# their bounds
SERVING = ("fused_serve", "prune_tiles", "descent_scan", "count_scan",
           "collect_scan", "polygon_scan", "range_query")
BASELINES = ("3dreach", "3dreach-rev", "georeach")
WAVEFRONT_CAPACITY = 128
CSRC = "src/repro_torch/kernels/"
RQ = "range_query/csrc/"
RECORD = {   # name -> (source, the TPU kernel it replaces)
    "fused_serve": (RQ + "fused_serve.cu",
                    "src/repro/kernels/range_query/fused.py:341"),
    "prune_tiles": (RQ + "prune_tiles.cu",
                    "src/repro/kernels/range_query/descent.py:149"),
    "descent_scan": (RQ + "leaf_scan.cu",
                     "src/repro/kernels/range_query/descent.py:236"),
    "count_scan": (RQ + "leaf_scan.cu",
                   "src/repro/kernels/range_query/analytics.py:92"),
    "collect_scan": (RQ + "leaf_scan.cu",
                     "src/repro/kernels/range_query/analytics.py:164"),
    "polygon_scan": (RQ + "leaf_scan.cu",
                     "src/repro/kernels/range_query/analytics.py:252"),
    "bitset_mm": ("bitset_mm/csrc/bitset_mm.cu",
                  "src/repro/kernels/bitset_mm/kernel.py:51"),
    "seg_mbr": ("forest_build/csrc/seg_mbr.cu",
                "src/repro/kernels/forest_build/kernel.py:44"),
    "range_query": (RQ + "range_query.cu",
                    "src/repro/kernels/range_query/kernel.py:59"),
    "segment_bag": ("segment_bag/csrc/segment_bag.cu",
                    "src/repro/kernels/segment_bag/kernel.py:54"),
}
# the recsys serving path: DIN's logits and scores on the card against
# the same parameters on the CPU (float32, no TF32; the products sum in
# another order), and K10 on DIN's table against its plain version on
# the card (whose index_add_ adds atomically, in any order), absolute
DIN_TOL = 1e-4
BAG_TOL = 1e-5
# K10 against the card's plain version: the largest |diff| / bound of
# ``sum_error_bound`` over phase kernels' cases, and where
BAG_BOUND = {"max_ratio": 0.0, "where": None}
# each kernel's tolerance against its plain version in the kernels line
TOLERANCE = dict.fromkeys(KERNELS, 0) | {"segment_bag": BAG_TOL}
BAG_CHECK_ROWS = 512     # serve_bulk rows and bags held against the CPU


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0,
                                                  1), **fields}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Kernels:
    """The port's kernel wrappers by name, with their plain versions and
    launch counters."""

    def __init__(self):
        from repro_torch.kernels import bitset_mm, forest_build, segment_bag
        from repro_torch.kernels.range_query import (
            analytics,
            descent,
            fused,
            leafscan,
        )

        self.fs, self.ds, self.an = fused, descent, analytics
        self.bm, self.fb, self.ls = bitset_mm, forest_build, leafscan
        self.sb = segment_bag
        self.wrap = {"fused_serve": fused.fused_serve,
                     "prune_tiles": descent.prune_tiles,
                     "descent_scan": descent.descent_scan,
                     "count_scan": analytics.count_scan,
                     "collect_scan": analytics.collect_scan,
                     "polygon_scan": analytics.polygon_scan,
                     "bitset_mm": bitset_mm.bitset_mm,
                     "seg_mbr": forest_build.seg_mbr,
                     "range_query": leafscan.range_query,
                     "segment_bag": segment_bag.segment_bag}
        self.plain = {"prune_tiles": descent.prune_tiles_torch,
                      "descent_scan": descent.descent_scan_torch,
                      "count_scan": analytics.count_scan_torch,
                      "collect_scan": analytics.collect_scan_torch,
                      "polygon_scan": analytics.polygon_scan_torch,
                      "bitset_mm": bitset_mm.bitset_mm_torch,
                      "seg_mbr": forest_build.seg_mbr_torch,
                      "range_query": leafscan.range_query_torch,
                      "segment_bag": segment_bag.segment_bag_torch}

    def reset(self) -> None:
        for fn in self.wrap.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {k: fn.launches for k, fn in self.wrap.items()}


# --------------------------------------------------------------------------
# Host references for count / collect (brute force over each tree slice)
# --------------------------------------------------------------------------

def host_count_collect(idx, us, rects, k):
    """Exact counts and the k smallest reachable venue ids per query,
    routed like the host index (Alg. 2 for spatial-sink vertices)."""
    us = np.asarray(us, np.int64)
    rects = np.asarray(rects, np.float32).reshape(len(us), 4)
    f = idx.forest
    exc = idx.excluded[us]
    tid = np.full(len(us), -1, np.int64)
    if (~exc).any():
        tid[~exc] = idx.lookup_tree(us[~exc])
    counts = np.zeros(len(us), np.int64)
    ids = np.full((len(us), k), -1, np.int32)
    for i, r in enumerate(rects):
        if exc[i]:
            p = idx.coords[us[i]]
            if p[0] >= r[0] and p[0] <= r[2] and p[1] >= r[1] and p[1] <= r[3]:
                counts[i], ids[i, 0] = 1, us[i]
        elif tid[i] >= 0:
            s, e = f.entry_off[tid[i]], f.entry_off[tid[i] + 1]
            b = f.entries[s:e]
            ok = ((b[:, 0] <= r[2]) & (b[:, 1] <= r[3])
                  & (b[:, 2] >= r[0]) & (b[:, 3] >= r[1]))
            hit = np.sort(f.entry_ids[s:e][ok])
            counts[i] = len(hit)
            ids[i, :min(k, len(hit))] = hit[:k]
    return counts, ids


# --------------------------------------------------------------------------
# Kernels against their plain versions
# --------------------------------------------------------------------------

def _diff(a, b) -> int:
    import torch

    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if a.shape != b.shape or not torch.equal(a, b):
        return max(err, 1)
    return err


def fused_args(eng, us, rects):
    """The fused serve's tensor inputs for one batch, as the engine
    assembles them (pad, route, quantize)."""
    _, us_dev, rsoa = eng._pad(us, rects)
    return eng._serve_args(rsoa, *eng._route(us_dev))[1]


def compare_fused(ks, args, nt, kcaps, where):
    """Exact equality of the fused kernel and its plain version, every
    mode and capacity; returns the largest absolute difference (0)."""
    fs = ks.fs
    err = 0
    for mode in MODES:
        for kcap in kcaps:
            ko, kc = fs.fused_serve(*args, mode=mode, kcap=kcap, nt=nt,
                                    device=DEVICE)
            po, pc = fs.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            e = max(_diff(ko, po), _diff(kc, pc))
            if e:
                raise AssertionError(
                    f"fused_serve kernel != plain version ({where}, "
                    f"mode={mode}, kcap={kcap})")
            err = max(err, e)
    return err


def compare_two_phase(ks, arena, rsoa, qs, qe, nt, Ks, where):
    """Exact equality of the prune kernel and of each scan kernel with
    their plain versions: the prune on this batch, the scans on its
    compacted candidates cut at each K.  Returns ``({kernel: largest
    absolute difference}, true candidate counts)``."""
    ds, an = ks.ds, ks.an
    fine, coarse, ent, ids = (arena["fine"], arena["coarse"], arena["esoa"],
                              arena["ids"])
    mask = ds.prune_tiles(fine, coarse, rsoa, qs, qe, device=DEVICE)
    pmask = ds.prune_tiles_torch(fine, coarse, rsoa, qs, qe)
    errs = {"prune_tiles": _diff(mask, pmask)}
    cand, cnt = ks.fs.compact_ascending(pmask, nt)
    for K in Ks:
        ck = ds.take_candidates(cand, K)
        args = {"descent_scan": (ck, ent, rsoa, qs, qe),
                "count_scan": (ck, ent, rsoa, qs, qe),
                "collect_scan": (ck, ent, ids, rsoa, qs, qe)}
        for name, a in args.items():
            got = ks.wrap[name](*a, device=DEVICE)
            e = _diff(got, ks.plain[name](*a))
            errs[name] = max(errs.get(name, 0), e)
    for name, e in errs.items():
        if e:
            raise AssertionError(f"{name} kernel != plain version ({where}, "
                                 f"K in {list(Ks)})")
    return errs, cnt


def random_arena(rng, n_tiles, n_trees, device):
    """Random serving inputs at a given arena size: clustered points cut
    into tree slices, each slice sorted along x for tile locality."""
    import torch
    from repro_torch.kernels.range_query import fused as fs
    from repro_torch.kernels.range_query.layout import TP, build_tile_pyramid

    P = n_tiles * TP - int(rng.integers(1, TP))
    cuts = np.sort(rng.choice(np.arange(1, P), n_trees - 1, replace=False))
    off = np.concatenate([[0], cuts, [P]]).astype(np.int64)
    pts = np.empty((P, 2), np.float32)
    for t in range(n_trees):
        s, e = off[t], off[t + 1]
        c = rng.random(2) * 100
        p = (c + rng.standard_normal((e - s, 2)) * rng.uniform(1, 20))
        pts[s:e] = np.clip(p[np.argsort(p[:, 0])], 0, 100)
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    ext = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64)
    grid = fs.make_quant_grid(ext, 2, device)
    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return dict(grid=grid, off=off, nt=nt, esoa=T(esoa), ids=T(ids),
                fine=T(fine), coarse=T(coarse),
                qfine=fs.quantize_fine(grid, T(fine), 2),
                qcoarse=fs.quantize_coarse(grid, T(coarse), 2))


def random_batch(rng, arena, B, device):
    """The fused serve's inputs for one random batch; where B > 8 the
    last query tile has only empty slices."""
    import torch
    from repro_torch.kernels.range_query import fused as fs
    from repro_torch.kernels.range_query.layout import TB

    t = rng.integers(0, len(arena["off"]) - 1, B)
    qs, qe = arena["off"][t], arena["off"][t + 1]
    empty = rng.random(B) < 0.2                    # empty arena slices
    if B > TB:
        empty[-TB:] = True                         # a row of no candidate
    qs[empty] = qe[empty] = 0
    side = rng.uniform(5, 30, (B, 1))
    lo = rng.uniform(-5, 100, (B, 2))
    rsoa = np.concatenate([lo, lo + side], 1).T.astype(np.float32)
    rsoa = torch.as_tensor(np.ascontiguousarray(rsoa), device=device)
    r16, r32 = fs.quantize_rects(arena["grid"], rsoa, 2)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa
    return (arena["qfine"], arena["qcoarse"], arena["esoa"], arena["ids"],
            r16, r32, rsoa, i32(qs), i32(qe))


def slice_arena(rng, n_tiles, device):
    """An arena of uniform points sorted along x (its leaf tiles are
    x-bands) for the slice cases, with its float32 and quantized
    pyramids."""
    import torch
    from repro_torch.kernels.range_query import fused as fs
    from repro_torch.kernels.range_query.layout import TP, build_tile_pyramid

    P = n_tiles * TP - 37
    pts = rng.uniform(0, 100, (P, 2)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    ext = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64)
    grid = fs.make_quant_grid(ext, 2, device)
    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return dict(grid=grid, P=P, pts=pts, nt=nt, esoa=T(esoa), ids=T(ids),
                fine=T(fine), coarse=T(coarse),
                qfine=fs.quantize_fine(grid, T(fine), 2),
                qcoarse=fs.quantize_coarse(grid, T(coarse), 2))


def slice_bounds(rng, P, B, kind):
    """Per query tile, slices of one kind: 8 disjoint ones; nested and
    overlapping ones; degenerate ones (qs == qe inside a tile and on a
    tile edge, [0, 0)) beside one short slice; one over the whole arena
    beside random ones."""
    from repro_torch.kernels.range_query.layout import TB, TP

    qs, qe = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for q0 in range(0, B, TB):
        s = slice(q0, q0 + TB)
        if kind == "disjoint":
            cuts = np.sort(rng.choice(P + 1, 2 * TB, replace=False))
            qs[s], qe[s] = cuts[0::2], cuts[1::2]
        elif kind == "nested":
            c = int(rng.integers(0, P))
            w = np.sort(rng.integers(1, max(2, P // 8), TB))[::-1]
            qs[s], qe[s] = np.clip(c - w, 0, P), np.clip(c + w, 0, P)
            qs[q0 + 6] = min(c + w[2] // 2, P)    # overlapping, not nested
            qe[q0 + 6] = min(c + 2 * w[0], P)
        elif kind == "degenerate":
            a = rng.integers(0, P, TB)
            a[:2] = a[:2] // TP * TP              # on a tile edge
            a[2] = 0
            qs[s], qe[s] = a, a
            qe[q0 + 3] = min(a[3] + 50, P)        # one short real slice
        else:
            a = np.sort(rng.integers(0, P + 1, (TB, 2)), axis=1)
            qs[s], qe[s] = a[:, 0], a[:, 1]
            qs[q0], qe[q0] = 0, P
    return qs, qe


def slice_batch(rng, arena, B, kind, device):
    """The fused serve's inputs for B queries with slices of one kind,
    each rect 0.5-40 leaf tiles wide around an entry of its slice
    (anywhere for an empty one) and tall."""
    import torch
    from repro_torch.kernels.range_query import fused as fs

    P = arena["P"]
    qs, qe = slice_bounds(rng, P, B, kind)
    live = qe > qs
    pick = rng.integers(0, P, B)
    pick[live] = rng.integers(qs[live], qe[live])
    c = arena["pts"][pick].astype(np.float64)
    half = np.stack([rng.uniform(0.25, 20, B) * 100 / arena["nt"],
                     rng.uniform(2, 25, B)], 1)
    rsoa = torch.as_tensor(np.ascontiguousarray(np.concatenate(
        [c - half, c + half], 1).T.astype(np.float32)), device=device)
    r16, r32 = fs.quantize_rects(arena["grid"], rsoa, 2)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa
    return (arena["qfine"], arena["qcoarse"], arena["esoa"], arena["ids"],
            r16, r32, rsoa, i32(qs), i32(qe))


def compare_prune(ks, fine, coarse, rsoa, qs, qe, where):
    """Exact equality of the tile prune (K2) and its plain version."""
    e = _diff(ks.ds.prune_tiles(fine, coarse, rsoa, qs, qe, device=DEVICE),
              ks.ds.prune_tiles_torch(fine, coarse, rsoa, qs, qe))
    if e:
        raise AssertionError(f"prune_tiles kernel != plain version ({where})")
    return e


def slice_cases(ks, rng, dev, errs, cases):
    """K1 (every mode; kcap below, at and above the true count, and at
    nt for B <= 24 on the small arena and B = 8 on the large) and K2 on
    SLICE_CASES, each bit for bit its plain version."""
    for n_tiles, Bs, kinds in SLICE_CASES:
        arena = slice_arena(rng, n_tiles, dev)
        nt = arena["nt"]
        for kind in kinds:
            for B in Bs:
                args = slice_batch(rng, arena, B, kind, dev)
                _, cnt = ks.fs.fused_serve_torch(*args, mode="reach", kcap=1,
                                                 nt=nt)
                mx = int(cnt.max())
                full = B <= (24 if n_tiles < ARENAS[0][0] else 8)
                kcaps = sorted({max(1, mx // 2), max(mx, 1), mx + 3}
                               | ({nt} if full else set()))
                where = f"slices {kind} nt={nt} B={B}"
                errs["fused_serve"] = max(errs["fused_serve"], compare_fused(
                    ks, args, nt, kcaps, where))
                errs["prune_tiles"] = max(errs["prune_tiles"], compare_prune(
                    ks, arena["fine"], arena["coarse"], *args[6:], where))
                cases.append({"slices": kind, "nt": nt, "B": B,
                              "max_cnt": mx, "kcaps": kcaps})


def polygon_arena(rng, n_tiles, B, ne, device):
    """Polygon-scan inputs at a given arena size: points sorted along x
    in three tree slices (plus empty slices), one small convex polygon
    of 3..ne vertices per query and, for about half of the queries, the
    polygon's vertices and points on its edges planted into the query's
    slice: where a fused multiply-add would flip an answer.  The
    half-planes are padded to the power-of-two edge bucket with inert
    ones (A = B = 0, C = +inf)."""
    import torch
    from repro_torch.core.polygon import convex_halfplanes, polygon_bbox
    from repro_torch.kernels.range_query.layout import TP, build_tile_pyramid

    P = n_tiles * TP - 5
    pts = (np.round(rng.uniform(0, 100, (P, 2)) * 4) / 4).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0])]
    off = np.array([0, P // 3, P // 2, P], np.int64)
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    qe[B // 4: B // 3] = qs[B // 4: B // 3]
    polys = []
    for b in range(B):
        k = int(rng.integers(3, ne + 1))
        ang = np.sort(rng.random(k) * 2 * np.pi) + np.arange(k) * 1e-6
        c, r = rng.uniform(5, 95, 2), rng.uniform(0.3, 3, 2)
        v = np.stack([c[0] + r[0] * np.cos(ang), c[1] + r[1] * np.sin(ang)],
                     1).astype(np.float32)
        polys.append(v)
        if qe[b] > qs[b] and rng.random() < 0.5:
            w = rng.random((k, 1))
            on = np.concatenate([v, (v * (1 - w) + np.roll(
                v, -1, 0).astype(np.float64) * w).astype(np.float32)])
            pts[rng.integers(qs[b], qe[b], len(on))] = on
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    neb = 4
    while neb < ne:
        neb *= 2
    rsoa = np.stack([polygon_bbox(p) for p in polys]).T
    hps = np.stack([convex_halfplanes(p, pad_to=neb) for p in polys])
    lines = hps.transpose(1, 2, 0).reshape(3 * neb, B)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  device=device)
    return dict(nt=nt, ne=neb, esoa=T(esoa), fine=T(fine), coarse=T(coarse),
                rsoa=T(rsoa), lines=T(lines), qs=T(qs.astype(np.int32)),
                qe=T(qe.astype(np.int32)))


def compare_polygon(ks, d, where):
    """Exact equality of the polygon scan kernel with its plain version
    on these inputs, K below, at and above the true candidate count;
    returns ``(largest absolute difference, true count, hits)``."""
    ds, an = ks.ds, ks.an
    args = (d["esoa"], d["rsoa"], d["lines"], d["qs"], d["qe"])
    mask = ds.prune_tiles_torch(d["fine"], d["coarse"], d["rsoa"], d["qs"],
                                d["qe"])
    cand, cnt = ks.fs.compact_ascending(mask, d["nt"])
    mx = int(cnt.max())
    err, hits = 0, 0
    for K in sorted({max(1, mx // 2), max(mx, 1), mx + 3}):
        ck = ds.take_candidates(cand, K)
        got = an.polygon_scan(ck, *args, ne=d["ne"], device=DEVICE)
        e = _diff(got, an.polygon_scan_torch(ck, *args, ne=d["ne"]))
        if e:
            raise AssertionError(f"polygon_scan kernel != plain version "
                                 f"({where}, K={K})")
        err, hits = max(err, e), int(got.sum())
    dense = an.polygon_scan_ref(*args, ne=d["ne"])
    if _diff(got, dense):
        raise AssertionError(f"polygon_scan != dense reference ({where})")
    return err, mx, hits


def bitset_operands(rng, f, m, W, device, bits_per_row=3):
    """Random closure-product operands: A (f, ceil(m/32)) with about
    ``bits_per_row`` set columns per row (a frontier row's out-degree),
    R (m, W) random words with bit 31 set in the first column; both as
    int32 tensors holding the uint32 bits."""
    from repro_torch.kernels.bitset_mm import uint32_bits

    Wm = (m + 31) // 32
    a = np.zeros((f, Wm), np.uint32)
    rows = np.repeat(np.arange(f), bits_per_row)
    cols = rng.integers(0, m, len(rows))
    cols[:: max(1, len(cols) // 7)] = m - 1           # the last column
    np.bitwise_or.at(a, (rows, cols // 32),
                     np.uint32(1) << (cols % 32).astype(np.uint32))
    r = rng.integers(0, 2 ** 32, (m, W), dtype=np.uint64).astype(np.uint32)
    r[:, 0] |= np.uint32(1 << 31)
    return uint32_bits(a, device), uint32_bits(r, device)


def bitset_edge_operands(rng, f, m, W, device):
    """K7's edge operands: random sparse rows, every fourth row from row
    1 fully dense and every fourth from row 2 without a bit below column
    m; the last column set in row 0; every row's bits at columns >= m
    set (the kernel must mask them); bit 31 in R's first and last
    column."""
    from repro_torch.kernels.bitset_mm import uint32_bits

    Wm = (m + 31) // 32
    a = rng.integers(0, 2 ** 32, (f, Wm), dtype=np.uint64).astype(np.uint32)
    a[rng.random((f, Wm)) < 0.7] = 0
    a[1::4] = 0xFFFFFFFF
    a[2::4] = 0
    a[0, -1] |= np.uint32(1 << ((m - 1) % 32))
    if m % 32:
        a[:, -1] |= np.uint32(0xFFFFFFFF << (m % 32) & 0xFFFFFFFF)
    r = rng.integers(0, 2 ** 32, (m, W), dtype=np.uint64).astype(np.uint32)
    r[:, 0] |= np.uint32(1 << 31)
    r[:, -1] |= np.uint32(1 << 31)
    return uint32_bits(a, device), uint32_bits(r, device)


def compare_bitset(ks, a, r, where):
    got = ks.bm.bitset_mm(a, r, device=DEVICE)
    e = _diff(got, ks.bm.bitset_mm_torch(a, r))
    if e or not bool((got < 0).any()):
        raise AssertionError(f"bitset_mm kernel != plain version or no "
                             f"bit 31 ({where})")
    return e


def compare_seg_mbr(ks, rng, fan, n, device):
    import torch

    c = rng.uniform(-50, 50, (fan, 4, n)).astype(np.float32)
    inert = np.broadcast_to((rng.random((fan, n)) < 0.3)[:, None],
                            (fan, 2, n))
    c[:, :2][inert] = np.inf
    c[:, 2:][inert] = -np.inf
    x = torch.as_tensor(c.reshape(fan * 4, n), device=device)
    e = _diff(ks.fb.seg_mbr(x, dim=2, fan=fan, device=DEVICE),
              ks.fb.seg_mbr_torch(x, dim=2, fan=fan))
    if e:
        raise AssertionError(f"seg_mbr kernel != plain version (fan={fan}, "
                             f"N={n})")
    return e


def leafscan_case(rng, n_tiles, n_trees, dim, B, device):
    """K9's inputs at an arena of ``n_tiles`` 128-entry tiles (P = 0 for
    0 tiles, padded to one inert tile): clustered entries (3-D boxes for
    dim 3) cut into ``n_trees`` slices that start and end inside tiles;
    per query a tree id in [-1, n_trees), query 0 with id -1 and query 1
    with its rect around an entry of its slice."""
    import torch
    from repro_torch.kernels.range_query.layout import TP

    P = max(0, n_tiles * TP - int(rng.integers(1, TP)))
    lo = (rng.random((P, dim)) * 100).astype(np.float32)
    lo[:, 0].sort()
    hi = lo + (0 if dim == 2 else (rng.random((P, dim)) * 3).astype(
        np.float32))
    Pp = max(TP, n_tiles * TP)
    esoa = np.empty((2 * dim, Pp), np.float32)
    esoa[:dim], esoa[dim:] = 1.0, 0.0
    esoa[:dim, :P], esoa[dim:, :P] = lo.T, hi.T
    cuts = np.sort(rng.integers(0, P + 1, n_trees - 1))
    off = np.concatenate([[0], cuts, [P]]).astype(np.int64)
    t = rng.integers(-1, n_trees, B)
    t[0], t[1] = -1, int(np.argmax(np.diff(off)))
    qs = np.where(t >= 0, off[np.maximum(t, 0)], 0)
    qe = np.where(t >= 0, off[np.maximum(t, 0) + 1], 0)
    c = rng.random((B, dim)) * 100
    if P:
        c[1] = lo[(qs[1] + qe[1]) // 2]
    r = rng.uniform(0.5, 10, (B, dim))
    rsoa = np.concatenate([c - r, c + r], 1).T.astype(np.float32)
    T = lambda a, d: torch.as_tensor(np.ascontiguousarray(a, d),  # noqa: E731
                                     device=device)
    return (T(esoa, np.float32), T(rsoa, np.float32), T(qs, np.int32),
            T(qe, np.int32))


def slice_edge_case(rng, dim, B, P, device):
    """K9's edge inputs on planes exactly P entries wide (P % 4 != 0
    leaves them unaligned): query b's slice has length
    SLICE_LENGTHS[(b + 8) % 10] and starts at b % 4 mod 4; every seventh
    query's slice starts below 0, ends past P, or is empty or reversed,
    in turn.  Entry p sits alone at (1000 + p, ...), so query b's rect
    hits exactly the first entry of its clipped slice, exactly the last,
    or nothing, as b % 3 is 0, 1, 2.  Returns the operands and the
    answers they must give."""
    import torch

    lo = rng.uniform(0, 100, (P, dim)).astype(np.float32)
    hi = lo + (0 if dim == 2 else rng.uniform(0, 3, (P, dim)).astype(
        np.float32))
    qs = np.zeros(B, np.int64)
    qe = np.zeros(B, np.int64)
    target = np.full(B, -1)
    for b in range(B):
        n = SLICE_LENGTHS[(b + 8) % 10]
        s = b % 4 + 4 * int(rng.integers(0, max(1, (P - n) // 4)))
        s, e = [(s, s + n), (-3, n - 3), (P - 2, P + 50), (s, s),
                (s + 5, s)][1 + (b // 7) % 4 if b % 7 == 6 else 0]
        qs[b], qe[b] = s, e
        cs, ce = max(s, 0), min(e, P)
        if ce > cs and b % 3 < 2:
            target[b] = cs if b % 3 == 0 else ce - 1
    hit = target >= 0
    lo[target[hit]] = hi[target[hit]] = 1000 + target[hit, None]
    c = np.broadcast_to(np.where(hit, 1000 + target, -500.0)[:, None],
                        (B, dim))
    rsoa = np.concatenate([c - 0.25, c + 0.25], 1).T
    esoa = np.concatenate([lo.T, hi.T]).reshape(2 * dim, P)
    T = lambda a, d: torch.as_tensor(np.ascontiguousarray(a, d),  # noqa: E731
                                     device=device)
    return (T(esoa, np.float32), T(rsoa, np.float32), T(qs, np.int32),
            T(qe, np.int32)), hit.astype(np.int32)


def shifted(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a
    16-byte boundary: K9 must take its scalar instantiation."""
    import torch

    spare = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return spare[1:].view(t.shape).copy_(t)


def compare_range_query(ks, args, dim, where):
    """Exact equality of K9 and its plain version on these inputs;
    returns ``(largest absolute difference, hits)``."""
    got = ks.ls.range_query(*args, dim=dim, device=DEVICE)
    e = _diff(got, ks.ls.range_query_torch(*args, dim=dim))
    if e:
        raise AssertionError(f"range_query kernel != plain version ({where})")
    return e, int(got.sum())


# K10's cases: (rows V, width D, bags B, longest bag); each with three
# empty bags at the end, float32 and bf16 tables; the edge cases
# (``bag_edges``) add the widths BAG_WIDTHS
BAG_CASES = ((10, 18, 1, 3), (1000, 32, 37, 100), (1_000_000, 18, 512, 100),
             (100_000, 128, 300, 40), (64, 128, 9, 0))
BAG_WIDTHS = (1, 2, 17, 18, 19, 32, 128, 129)
# a bag longer than this is held against the card's plain version also
# on exactly summable data (``bag_edge_operands(exact=True)``)
LONG_BAG = 1000


def bag_operands(rng, V, D, B, maxlen, dtype, device):
    """K10's packed operands for B random bags of 0..maxlen lookups into
    a (V, D) table (the last three bags empty, the packed tail padding),
    with random weights; maxlen = 0 gives L = 0, one inert tile."""
    lens = rng.integers(0, maxlen + 1, B)
    lens[max(B - 3, 0):] = 0
    return bag_edge_operands(rng, lens, V, D, dtype, device)


def compare_segment_bag(ks, ops, B, where):
    """K10 bit for bit against its plain version on the CPU, which adds
    the same products in the same ascending order, and against the
    plain version on the card, whose atomic adds take any order, within
    the summation bound ``sum_error_bound`` (2 n_b 2^-24 times the bag's
    magnitude sum, plus an ulp of it; NaN bags NaN in both).  Returns
    the largest absolute difference from the card's plain version (the
    CPU's is 0); the largest |difference| / bound goes to BAG_BOUND."""
    import torch

    sb = ks.sb
    got = sb.segment_bag(*ops, n_segments=B, device=DEVICE)
    plain = sb.segment_bag_torch(*ops, n_segments=B)
    bnd = sb.sum_error_bound(*ops, n_segments=B)
    torch.cuda.synchronize()
    nan = torch.isnan(plain)       # bags holding an id outside the table
    diff = (got - plain).abs().masked_fill(nan, 0)
    err = float(diff.max()) if got.numel() else 0.0
    ratio = (float((diff / bnd.masked_fill(nan, 1)).max())
             if got.numel() else 0.0)
    if ratio > BAG_BOUND["max_ratio"]:
        BAG_BOUND.update(max_ratio=ratio, where=where)
    if (got.dtype != torch.float32 or got.shape != plain.shape
            or not (torch.equal(torch.isnan(got), nan)
                    and bool((diff <= bnd.masked_fill(nan, 0)).all()))):
        raise AssertionError(f"segment_bag kernel != plain version ({where}: "
                             f"max_abs_err {err}, |diff| / bound {ratio})")
    if not nan_equal(got.cpu(), sb.segment_bag_torch(
            *(t.cpu() for t in ops), n_segments=B)):
        raise AssertionError(f"segment_bag kernel != plain version on the "
                             f"CPU ({where})")
    return err


def nan_equal(a, b):
    """Equal, NaN where the other is NaN (``equal_nan``)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0),
                                               b.masked_fill(nb, 0))


# ids of K10's bad-id cases: -1 and -V wrap, the rest lie outside the
# table (INT32_MIN and INT32_MAX too); "-V" etc. are read per table
BAD_BAG_IDS = (-1, "-V", "-V-1", "V", -2 ** 31, 2 ** 31 - 1)
# the reference's rows (``embedding_bag(use_ref=True)``) for one bag of
# two lookups into arange(28).reshape(7, 4), float32
F2_ROWS = (([0, 7], [[float("nan")] * 4]),
           ([-1, 0], [[24.0, 26.0, 28.0, 30.0]]),
           ([0, -8], [[float("nan")] * 4]))


def bad_id_operands(rng, V, D, dtype, device):
    """K10's operands for bags of 7 lookups and bags of one, each pair
    holding one of BAD_BAG_IDS, then two bags of good ids and 5 lookups
    of padding."""
    import torch

    lens = [7, 1] * len(BAD_BAG_IDS) + [40, 3]
    table, i, s, w = bag_edge_operands(rng, lens, V, D, dtype, device,
                                       pad=5)
    i = i.cpu().numpy().copy()
    offsets = np.concatenate([[0], np.cumsum(lens)])
    for b, bad in enumerate(BAD_BAG_IDS):
        bad = {"-V": -V, "-V-1": -V - 1, "V": V}.get(bad, bad)
        i[offsets[2 * b] + 3] = bad
        i[offsets[2 * b + 1]] = bad
    return (table, torch.as_tensor(i, device=device), s, w), len(lens)


def bag_edge_operands(rng, lens, V, D, dtype, device, pad=0, shift=False,
                      exact=False):
    """K10's packed operands for bags of the given lengths into a random
    (V, D) table, random weights, ``pad`` more lookups of padding at the
    end; ``shift`` puts the table one element past an aligned base (a
    narrower copy instantiation, ``copy_bytes``).  ``lens = None`` gives
    L = 0: no lookup and no padding either, for one bag.  ``exact``
    draws the table from the integers -8..8 and the weights from 0.5,
    1, 1.5 and 2: every product and every sum of up to 10^6 of them is
    exact in float32, in any order of the adds."""
    import torch
    from repro_torch.kernels.segment_bag import pack_bags

    if lens is None:
        i = s = np.zeros(0, np.int32)
        w = np.zeros(0, np.float32)
    else:
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        i, s, w = pack_bags(rng.integers(0, V, int(offsets[-1])), offsets)
        w[: int(offsets[-1])] = (
            rng.integers(1, 5, int(offsets[-1])) / 2 if exact
            else rng.uniform(0.5, 2.0, int(offsets[-1])))
        i = np.concatenate([i, np.zeros(pad, np.int32)])
        s = np.concatenate([s, np.full(pad, len(lens), np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    table = torch.as_tensor(
        rng.integers(-8, 9, (V, D)).astype(np.float32) if exact
        else rng.standard_normal((V, D), np.float32)).to(dtype).to(device)
    if shift:
        flat = torch.empty(V * D + 1, dtype=dtype, device=device)
        flat[1:].copy_(table.flatten())
        table = flat[1:].view(V, D)
    return (table, *(torch.as_tensor(a, device=device) for a in (i, s, w)))


def bag_edges(rng):
    """K10's edge cases, the kinds tests/test_torch_cuda.py's BAG_EDGES
    holds: (what, bag lengths or None for L = 0, V, D, padding lookups,
    shifted table)."""
    ragged = rng.integers(0, 101, 1001)
    ragged[200:700] = 0
    out = [("one bag of 5,000", [5000], 100_000, 18, 0, False),
           ("one bag of 200,000", [200_000], 1_000_000, 18, 0, False),
           ("empty stretches, a padding tail",
            [0] * 5000 + [40] * 50 + [0] * 20_000 + [3], 1000, 18, 1000,
            False),
           ("L = 0", None, 10, 18, 0, False),
           ("L = 33", [33], 50, 18, 0, False),
           ("L = 95", [31, 0, 64], 50, 18, 0, False),
           ("1,001 ragged bags", list(ragged), 5000, 18, 0, False)]
    out += [(f"D = {D}", list(rng.integers(0, 101, 301)), 5000, D, 0, False)
            for D in BAG_WIDTHS]
    out += [(f"D = {D} shifted", list(rng.integers(0, 41, 77)), 500, D, 0,
             True) for D in (18, 32, 128)]
    return out


def segment_bag_cases(ks, rng, dev, cases):
    """K10 on BAG_CASES and the edge cases of ``bag_edges``, float32 and
    bf16 tables; on ids outside the table or wrapping (BAD_BAG_IDS, D =
    18 and 128), NaN where the plain version has NaN; ``embedding_bag``
    on the card giving the reference's F2_ROWS; then the ragged edge
    case at every forced launch shape of SWEEP_SEGMENTS and a few more;
    each case's difference from the card's plain version recorded in
    ``cases``."""
    import torch
    from repro_torch.kernels.segment_bag import ops as sbo

    for V, D, B, maxlen in BAG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            ops = bag_operands(rng, V, D, B, maxlen, dtype, dev)
            where = f"V={V} D={D} B={B} maxlen={maxlen} {dtype}"
            cases.append({"segment_bag": [V, D, B, maxlen, str(dtype)],
                          "lookups": int((ops[3] > 0).sum()),
                          "cpu_plain_max_abs_err": 0,
                          "card_plain_max_abs_err": compare_segment_bag(
                              ks, ops, B, where)})
    edges = bag_edges(rng)
    for what, lens, V, D, pad, shift in edges:
        long = lens is not None and max(lens) > LONG_BAG
        for dtype in (torch.float32, torch.bfloat16):
            B = 1 if lens is None else len(lens)
            for exact in (False, True) if long else (False,):
                ops = bag_edge_operands(rng, lens, V, D, dtype, dev, pad,
                                        shift, exact)
                cases.append({"segment_bag_edge": what, "dtype": str(dtype),
                              "exact_data": exact,
                              "copy_bytes": sbo.copy_bytes(ops[0]),
                              "card_plain_max_abs_err": compare_segment_bag(
                                  ks, ops, B, f"{what} {dtype} exact={exact}")})
    for D in (18, 128):
        for dtype in (torch.float32, torch.bfloat16):
            ops, B = bad_id_operands(rng, 500, D, dtype, dev)
            err = compare_segment_bag(ks, ops, B, f"bad ids D={D} {dtype}")
            nan_bags = torch.isnan(ks.sb.segment_bag_torch(
                *(t.cpu() for t in ops), n_segments=B)).all(1)
            if nan_bags.tolist() != [False] * 4 + [True] * 8 + [False] * 2:
                raise AssertionError(f"segment_bag: bad ids D={D} {dtype}: "
                                     f"NaN bags {nan_bags.tolist()}")
            cases.append({"segment_bag_bad_ids": [str(i) for i in
                                                  BAD_BAG_IDS],
                          "D": D, "dtype": str(dtype),
                          "nan_bags": int(nan_bags.sum()),
                          "card_plain_max_abs_err": err})
    table = torch.arange(28, dtype=torch.float32, device=dev).reshape(7, 4)
    for idx, want in F2_ROWS:
        got = ks.sb.embedding_bag(table, np.array(idx), np.array([0, 2]),
                                  device=dev)
        if not nan_equal(got.cpu(), torch.tensor(want)):
            raise AssertionError(f"embedding_bag({idx}) on the card gave "
                                 f"{got.tolist()}, the reference {want}")
        cases.append({"embedding_bag_f2": idx, "rows": str(got.tolist())})
    pick = sbo.warp_segments
    what, lens, V, D, pad, _ = edges[6]
    try:
        for C in (*SWEEP_SEGMENTS, 3, 1000, 5000):
            sbo.warp_segments = lambda *_, C=C: C
            for dtype in (torch.float32, torch.bfloat16):
                ops = bag_edge_operands(rng, lens, V, D, dtype, dev, 77)
                cases.append({"segment_bag_edge": what, "dtype": str(dtype),
                              "warp_segments": C,
                              "card_plain_max_abs_err": compare_segment_bag(
                                  ks, ops, len(lens),
                                  f"{what} {dtype} warp_segments={C}")})
    finally:
        sbo.warp_segments = pick


def cluster_scan_cases(ks, rng, dev, errs, cases):
    """K3-K6 against their plain versions on ``polygon_arena`` inputs
    (venues on polygon edges and vertices; K5 with a permutation of
    payload ids) at each (B, K) of CLUSTER_SCAN_CASES, where B > 8 with
    the last row all padding (its first tile in every slot) and row 1
    holding a negative tile and one past the arena; then K6 at 4, 8 and
    16 half-planes (B = 256) and at 1024 (B = 8: 96 KB of half-planes in
    shared memory), K below, at and above the true count, and the dense
    reference."""
    import torch
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.range_query.layout import TB, TP

    an, ds = ks.an, ks.ds
    n_sms = sm_count(dev)
    for B, Ks in CLUSTER_SCAN_CASES:
        d = polygon_arena(rng, CLUSTER_SCAN_TILES, B, 8, dev)
        mask = ds.prune_tiles_torch(d["fine"], d["coarse"], d["rsoa"],
                                    d["qs"], d["qe"])
        cand, cnt = ks.fs.compact_ascending(mask, d["nt"])
        P = d["esoa"].shape[1]
        ids = torch.as_tensor(rng.permutation(P).astype(np.int32)[None],
                              device=dev)
        box = (d["esoa"], d["rsoa"], d["qs"], d["qe"])
        col = (d["esoa"], ids, d["rsoa"], d["qs"], d["qe"])
        poly = (d["esoa"], d["rsoa"], d["lines"], d["qs"], d["qe"])
        for K in Ks:
            ck = ds.take_candidates(cand, K).clone()
            if B > TB:
                ck[-1] = int(ck[-1, 0])
                ck[1, K // 2] = P // TP + 7
                ck[1, 0] = -1
            e = {"descent_scan": _diff(ds.descent_scan(ck, *box,
                                                       device=DEVICE),
                                       ds.descent_scan_torch(ck, *box)),
                 "count_scan": _diff(an.count_scan(ck, *box, device=DEVICE),
                                     an.count_scan_torch(ck, *box)),
                 "collect_scan": _diff(an.collect_scan(ck, *col,
                                                       device=DEVICE),
                                       an.collect_scan_torch(ck, *col)),
                 "polygon_scan": _diff(
                     an.polygon_scan(ck, *poly, ne=d["ne"], device=DEVICE),
                     an.polygon_scan_torch(ck, *poly, ne=d["ne"]))}
            if any(e.values()):
                raise AssertionError(f"kernel != plain version (cluster "
                                     f"case B={B} K={K}): {e}")
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            cases.append({"cluster_scan": [B, K], "max_cnt": int(cnt.max()),
                          "cluster": ds.scan_cluster_size(B // TB, K, n_sms),
                          "collect_warps": an.collect_warps(B // TB, K,
                                                            n_sms)})
    for B, ne in CLUSTER_NE:
        d = polygon_arena(rng, CLUSTER_SCAN_TILES, B, ne, dev)
        e, mx, hits = compare_polygon(ks, d, f"polygon ne={ne} B={B}")
        errs["polygon_scan"] = max(errs["polygon_scan"], e)
        cases.append({"polygon_nt": d["nt"], "B": B, "ne": d["ne"],
                      "max_cnt": mx, "hits": hits})


def phase_kernels(ks):
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    errs = dict.fromkeys(KERNELS, 0)
    cases = []
    for n_tiles, n_trees, Bs in ARENAS:
        arena = random_arena(rng, n_tiles, n_trees, dev)
        nt = arena["nt"]
        ntp = int(arena["fine"].shape[1])
        for B in Bs:
            args = random_batch(rng, arena, B, dev)
            _, cnt = ks.fs.fused_serve_torch(*args, mode="reach", kcap=1,
                                             nt=nt)
            mx = int(cnt.max())
            kcaps = sorted({max(1, mx // 2), max(mx, 1), nt, nt + 3})
            where = f"random nt={nt} B={B}"
            errs["fused_serve"] = max(errs["fused_serve"], compare_fused(
                ks, args, nt, kcaps, where))
            rsoa, qs, qe = args[6:]
            pmask = ks.ds.prune_tiles_torch(arena["fine"], arena["coarse"],
                                            rsoa, qs, qe)
            _, pcnt = ks.fs.compact_ascending(pmask, nt)
            pmx = int(pcnt.max())
            Ks = sorted({max(1, pmx // 2), max(pmx, 1), pmx + 3, ntp})
            e2, _ = compare_two_phase(ks, arena, rsoa, qs, qe, nt, Ks, where)
            for k, v in e2.items():
                errs[k] = max(errs[k], v)
            cases.append({"nt": nt, "B": B, "max_cnt": mx, "kcaps": kcaps,
                          "two_phase_max_cnt": pmx, "Ks": Ks,
                          "rows_without_candidates": int((pcnt == 0).sum())})
        for B in Bs:
            for ne in (4, 8):
                d = polygon_arena(rng, n_tiles, B, ne, dev)
                e, mx, hits = compare_polygon(
                    ks, d, f"polygon nt={d['nt']} B={B} ne={ne}")
                errs["polygon_scan"] = max(errs["polygon_scan"], e)
                cases.append({"polygon_nt": d["nt"], "B": B, "ne": ne,
                              "max_cnt": mx, "hits": hits})
    cluster_scan_cases(ks, rng, dev, errs, cases)
    slice_cases(ks, rng, dev, errs, cases)
    # the full-arena leaf scan: dims 2 and 3, ragged B, P = 0
    for n_tiles, n_trees in ((ARENAS[0][0], ARENAS[0][1]), (3, 2), (0, 1)):
        for dim in (2, 3):
            for B in (8, 24, 33):
                args = leafscan_case(rng, n_tiles, n_trees, dim, B, dev)
                e, hits = compare_range_query(
                    ks, args, dim, f"tiles={n_tiles} dim={dim} B={B}")
                errs["range_query"] = max(errs["range_query"], e)
                cases.append({"range_query": [n_tiles, dim, B],
                              "hits": hits})
    # unaligned, clipped and empty slices, hits at a slice's first and
    # last entry; at P = 1001 and on a shifted copy of the planes the
    # scalar instantiation, elsewhere the float4 one
    for dim in (2, 3):
        for P in EDGE_P:
            for B in EDGE_B:
                args, want = slice_edge_case(rng, dim, B, P, dev)
                for esoa in (args[0], shifted(args[0])):
                    a9 = (esoa, *args[1:])
                    where = f"edges dim={dim} P={P} B={B}"
                    e, hits = compare_range_query(ks, a9, dim, where)
                    if not np.array_equal(ks.ls.range_query_torch(
                            *a9, dim=dim).cpu().numpy(), want):
                        raise AssertionError(f"range_query != the planted "
                                             f"answers ({where})")
                    errs["range_query"] = max(errs["range_query"], e)
                    cases.append({"range_query_edges": [dim, P, B],
                                  "vector": ks.ls.vector_planes(esoa),
                                  "hits": hits})
    # the closure product: the yelp x1.0 comp level-0 shape, ragged ones
    for f, m, W in ((17878, 2880, 95), (1, 1, 1), (37, 64, 3),
                    (300, 33, 70)):
        a, r = bitset_operands(rng, f, m, W, dev)
        errs["bitset_mm"] = max(errs["bitset_mm"], compare_bitset(
            ks, a, r, f"f={f} m={m} W={W}"))
        cases.append({"bitset_mm": [f, m, W]})
    # dense rows, rows without a bit, bits at columns >= m, 1 to 3
    # blocks' spans of 128 output words; the launcher's instantiation,
    # then ROWWISE (0) and SPREAD at clusters of 1, 2 and 8 CTAs
    from repro_torch.kernels.bitset_mm import ops

    pick = ops.cluster_size
    try:
        for f, m, W in BITSET_EDGE:
            a, r = bitset_edge_operands(rng, f, m, W, dev)
            for C in (None, 0, 1, 2, 8):
                ops.cluster_size = pick if C is None else (
                    lambda *_, C=C: C)
                errs["bitset_mm"] = max(errs["bitset_mm"], compare_bitset(
                    ks, a, r, f"edges f={f} m={m} W={W} C={C}"))
    finally:
        ops.cluster_size = pick
    cases.append({"bitset_mm_edges": len(BITSET_EDGE),
                  "instantiations": ["launcher's", 0, 1, 2, 8]})
    # the segmented MBR: R-tree levels (16), fine (128) and coarse (8)
    for fan, n in ((16, 1000), (16, 1), (128, 12204), (8, 77)):
        errs["seg_mbr"] = max(errs["seg_mbr"], compare_seg_mbr(
            ks, rng, fan, n, dev))
        cases.append({"seg_mbr": [fan, n]})
    segment_bag_cases(ks, rng, dev, cases)     # 0 from the CPU's version
    emit("kernels", ok=True, max_abs_err=errs,
         segment_bag_bound=dict(BAG_BOUND), cases=cases,
         seconds=round(time.perf_counter() - t0, 3))
    return errs


# --------------------------------------------------------------------------
# Main path
# --------------------------------------------------------------------------

def serve_all(eng, us, rects, two_phase=False):
    """query/count/collect over the workload in batches of BATCH, on the
    fused path or through the ``*_two_phase`` methods."""
    sfx = "_two_phase" if two_phase else ""
    query, count, collect = (getattr(eng, f"{m}_batch{sfx}")
                             for m in ("query", "count", "collect"))
    reach, cnt, ids, tot = [], [], [], []
    for s in range(0, len(us), BATCH):
        u, r = us[s:s + BATCH], rects[s:s + BATCH]
        reach.append(query(u, r))
        cnt.append(count(u, r))
        col = collect(u, r, COLLECT_K)
        ids.append(col.ids)
        tot.append(col.counts)
    return (np.concatenate(reach), np.concatenate(cnt),
            np.concatenate(ids), np.concatenate(tot))


def same_answers(got, reach, cnt, ids):
    g_reach, g_cnt, g_ids, g_tot = got
    return bool((g_reach == reach).all() and (g_cnt == cnt).all()
                and (g_tot == cnt).all() and (g_ids == ids).all())


def check_index(ks, name, g, idx, us, rects):
    from repro_torch.core import QueryEngine, rangereach_oracle_batch

    host_reach = idx.query_batch(us, rects)
    host_cnt, host_ids = host_count_collect(idx, us, rects, COLLECT_K)
    eng = QueryEngine(idx)                 # device=None: the GPU
    ks.reset()                             # this path's counts only
    passes = []
    for p in range(2):                     # warm-up pass, then steady
        reruns = eng.stats["fused_reruns"]
        t0 = time.perf_counter()
        ans = serve_all(eng, us, rects)
        dt = time.perf_counter() - t0
        if not same_answers(ans, host_reach, host_cnt, host_ids):
            raise AssertionError(f"{name}: device answers != host index")
        passes.append({"seconds": round(dt, 3),
                       "fused_reruns": eng.stats["fused_reruns"] - reruns})
    launches = ks.counts()                 # read just after the serving
    want = eng.stats["batches"] + eng.stats["fused_reruns"]
    if launches["fused_serve"] <= 0 or launches["fused_serve"] != want:
        raise AssertionError(
            f"{name}: {launches['fused_serve']} fused_serve launches, "
            f"expected {want} (one per batch plus ratchet re-runs)")
    if passes[1]["fused_reruns"]:
        raise AssertionError(f"{name}: capacity ratchet re-ran in steady state")
    bad_ids = check_bad_ids(eng, g.n_nodes, us, rects, host_reach, name)
    sample = slice(0, BATCH)
    oracle = rangereach_oracle_batch(g, us[sample], rects[sample])
    if not (oracle == ans[0][sample]).all():
        raise AssertionError(f"{name}: device answers != BFS oracle")
    rec = {"index": name, "entries": int(len(idx.forest.entries)),
           "n_tiles": eng.n_tiles, "launches": launches["fused_serve"],
           "qfine_bytes": int(eng._qfine.numel() * 2),
           "kcap": min(eng._kb_hwm, eng.n_tiles), "passes": passes,
           "hit_rate": float(ans[0].mean()), "bad_ids": bad_ids,
           "stats": {k: int(v) for k, v in eng.stats.items()}}
    return eng, (host_reach, host_cnt, host_ids), ans, rec


def check_bad_ids(eng, n, us, rects, host_reach, name):
    """A batch with a vertex id out of range (n, and -n - 1) raises
    IndexError on the host, before a gather on the card could fire a
    device-side assert; the same engine then answers the first batch as
    the host index does."""
    import torch

    raised = []
    for bad in (np.full(3, n), np.array([0, -n - 1, 1])):
        try:
            eng.query_batch(bad, rects[:3])
        except IndexError as e:
            raised.append(str(e))
        else:
            raise AssertionError(f"{name}: vertex ids {bad} were served")
    torch.cuda.synchronize()
    if not np.array_equal(eng.query_batch(us[:BATCH], rects[:BATCH]),
                          host_reach[:BATCH]):
        raise AssertionError(f"{name}: answers after a bad batch != host")
    return raised


def check_two_phase(ks, name, eng, us, rects, host, fused):
    """The same workload through the ``*_two_phase`` methods, twice:
    equal to the host index and the fused answers; every kernel's count
    reset just before and read just after."""
    batches0 = eng.stats["batches"]
    ks.reset()
    passes = []
    for p in range(2):
        t0 = time.perf_counter()
        ans = serve_all(eng, us, rects, two_phase=True)
        dt = time.perf_counter() - t0
        if not same_answers(ans, *host):
            raise AssertionError(f"{name}: two-phase answers != host index")
        if not same_answers(ans, fused[0], fused[1], fused[2]):
            raise AssertionError(f"{name}: two-phase answers != fused path")
        passes.append({"seconds": round(dt, 3)})
    launches = ks.counts()
    batches = eng.stats["batches"] - batches0
    per_mode = batches // len(MODES)
    want = {**dict.fromkeys(KERNELS, 0), "prune_tiles": batches,
            **{SCANS[m]: per_mode for m in MODES}}
    if launches != want or batches <= 0:
        raise AssertionError(f"{name}: two-phase launches {launches}, "
                             f"expected {want}")
    return {"index": name, "batches": batches, "launches": launches,
            "kb": eng._kb_hwm, "passes": passes}


def check_knn(ks, name, idx, eng, us, rects):
    """kNN at the workload's rect centres on both paths, equal to the
    host best-first descent; the launches of each path."""
    from repro_torch.core import QueryEngine
    from repro_torch.queries import knn_reach_host

    u = us[:KNN_QUERIES]
    pts = ((rects[:KNN_QUERIES, :2] + rects[:KNN_QUERIES, 2:]) / 2).astype(
        np.float32)
    t0 = time.perf_counter()
    want = knn_reach_host(idx, u, pts, KNN_K)
    host_s = time.perf_counter() - t0
    out = {"index": name, "queries": len(u), "k": KNN_K,
           "host_seconds": round(host_s, 3),
           "found": int((want.ids >= 0).sum())}
    for path, e in (("fused", eng),
                    ("two_phase", QueryEngine(idx, path="two_phase"))):
        ks.reset()
        batches0 = e.stats["batches"]
        t0 = time.perf_counter()
        got = e.knn_batch(u, pts, KNN_K)
        dt = time.perf_counter() - t0
        launches = ks.counts()
        if not (np.array_equal(got.ids, want.ids)
                and np.array_equal(got.dist2, want.dist2)):
            raise AssertionError(f"{name}: kNN on the {path} path != host")
        if path == "fused":
            ok = launches["fused_serve"] >= 1
        else:
            ok = (launches["fused_serve"] == 0
                  and launches["count_scan"] >= 1
                  and launches["collect_scan"] >= 1)
        if not ok:
            raise AssertionError(f"{name}: kNN {path} launches {launches}")
        out[path] = {"seconds": round(dt, 3), "launches": launches,
                     "batches": e.stats["batches"] - batches0}
    return out


def mixed_polygons(g, lo, hi, seed):
    """One batch of BATCH queries whose polygons have lo..hi vertices
    (``polygon_workload`` per vertex count, interleaved)."""
    from repro_torch.data import polygon_workload

    parts = [polygon_workload(g, BATCH // (hi - lo + 1) + 1, n_edges=n,
                              extent_ratio=0.05, seed=seed + n)
             for n in range(lo, hi + 1)]
    us = np.stack([p[0] for p in parts], 1).reshape(-1)[:BATCH]
    polys = [q for row in zip(*[p[1] for p in parts]) for q in row][:BATCH]
    return us, tuple(polys)


def check_polygons(ks, name, g, idx, eng):
    """Polygon RangeReach on the card: the main workload's 6-gons in
    batches of BATCH, then a batch of 3-4-gons and one of 3-12-gons;
    equal to the host polygon path and, on a sample, to the BFS oracle.
    The prune and the polygon scan launch once per batch, nothing
    else."""
    from repro_torch.core import polygon_reach_oracle
    from repro_torch.core.engine import _bucket
    from repro_torch.data import polygon_workload
    from repro_torch.queries import polygon_reach_host

    us, polys = polygon_workload(g, N_QUERIES, n_edges=POLY_EDGES,
                                 extent_ratio=0.05, seed=0)
    batches = [(us[s:s + BATCH], polys[s:s + BATCH])
               for s in range(0, len(us), BATCH)]
    batches += [mixed_polygons(g, lo, hi, 10 * i)
                for i, (lo, hi) in enumerate(POLY_MIXED)]
    t0 = time.perf_counter()
    want = [polygon_reach_host(idx, u, p) for u, p in batches]
    host_s = time.perf_counter() - t0
    batches0 = eng.stats["batches"]
    ks.reset()
    t0 = time.perf_counter()
    got = [eng.polygon_batch(u, p) for u, p in batches]
    dt = time.perf_counter() - t0
    launches = ks.counts()
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{name}: polygon batch {i} != host path")
    n = len(batches)
    expect = {**dict.fromkeys(KERNELS, 0), "prune_tiles": n,
              "polygon_scan": n}
    if launches != expect or eng.stats["batches"] - batches0 != n:
        raise AssertionError(f"{name}: polygon launches {launches}, "
                             f"expected {expect}")
    oracle = [polygon_reach_oracle(g, int(u), p)
              for u, p in zip(us[:BATCH], polys[:BATCH])]
    if not np.array_equal(got[0], oracle):
        raise AssertionError(f"{name}: polygon answers != BFS oracle")
    return {"index": name, "queries": sum(len(u) for u, _ in batches),
            "batches": n, "launches": launches,
            "edge_buckets": sorted({_bucket(max(len(q) for q in p), 4)
                                    for _, p in batches}),
            "hit_rate": float(np.concatenate(got).mean()),
            "host_seconds": round(host_s, 3), "seconds": round(dt, 3)}, \
        (us, polys)


def phase_main(ks):
    from repro_torch.core import build_index
    from repro_torch.data import get_dataset, workload

    built = []
    for ds, scale, method in CONFIGS:
        g = get_dataset(ds, scale=scale)
        t0 = time.perf_counter()
        idx = build_index(g, method)
        built.append((f"{ds}x{scale} {method}", g, method, idx,
                      time.perf_counter() - t0))
    results, two_phase, polygons, engines, indexes = [], [], [], {}, {}
    knn = None
    for name, g, method, idx, build_s in built:
        us, rects = workload(g, N_QUERIES, extent_ratio=0.05)
        eng, host, fused, rec = check_index(ks, name, g, idx, us, rects)
        rec["build_seconds"] = round(build_s, 3)
        results.append(rec)
        two_phase.append(check_two_phase(ks, name, eng, us, rects, host,
                                         fused))
        if knn is None:                   # yelp x1.0 2dreach-comp
            knn = check_knn(ks, name, idx, eng, us, rects)
        prec, pwork = check_polygons(ks, name, g, idx, eng)
        polygons.append(prec)
        engines[name] = (eng, us, rects)
        indexes[name] = (g, method, idx, host[0], pwork)
    return results, two_phase, knn, polygons, engines, indexes


def phase_main_batches(ks, engines, leafscan_ops):
    """Every kernel against its plain version on each index's first
    main-path batch: the fused serve at the steady capacity and a
    truncating one, the prune and the scans at the steady K, and the
    full-arena leaf scan on the operands of the leaf-scan engine's first
    batch (``leafscan_ops``, from phase legacy)."""
    errs = dict.fromkeys(KERNELS, 0)
    for name, (args, dim) in leafscan_ops.items():
        e, _ = compare_range_query(ks, args, dim, f"{name} main-path batch")
        errs["range_query"] = max(errs["range_query"], e)
    for name, (eng, us, rects) in engines.items():
        args = fused_args(eng, us[:BATCH], rects[:BATCH])
        kcap = min(eng._kb_hwm, eng.n_tiles)
        kcaps = sorted({max(1, kcap // 2), kcap})
        errs["fused_serve"] = max(errs["fused_serve"], compare_fused(
            ks, args, eng.n_tiles, kcaps, f"{name} main-path batch"))
        rsoa, qs, qe = args[6:]
        e2, _ = compare_two_phase(ks, arena_of(eng), rsoa, qs, qe,
                                  eng.n_tiles, [eng._kb_hwm],
                                  f"{name} main-path batch")
        for k, v in e2.items():
            errs[k] = max(errs[k], v)
    emit("main_batches", ok=True, max_abs_err=errs)
    return errs


# --------------------------------------------------------------------------
# The paper's harness (repro_torch.benchmarks) and the resilience layer
# (repro_torch.resilience)
# --------------------------------------------------------------------------

# phase paper, cut to stay inside the script's time with phases dynamic
# and cluster: the four datasets at a tenth of their synthetic size
# (run.py: x0.25, --full: x0.5) and 200 Figure 3 queries per parameter
# value (run.py: 400, --full: 1,000); perf_build and perf_queries at
# their --smoke configs
PAPER_SCALE = 0.1
PAPER_QUERIES = 200
PERF_BUILD_CONFIG = ("yelp", 0.12)
PERF_QUERIES_CONFIG = dict(dataset="yelp", scale=0.1, n_q=256, k=8,
                           repeats=2)
# each perf_queries class and path: the kernels that must launch (at
# least once) and those that must not
PQ_KERNELS = {"fused": ({"fused_serve"}, {"prune_tiles"}),
              "two_phase": ({"prune_tiles"}, {"fused_serve"})}
PQ_SCANS = {"reach": "descent_scan", "count": "count_scan",
            "collect": "collect_scan", "knn": "count_scan",
            "polygon": "polygon_scan"}
HANG_S = 0.5          # the injected stall of phase resilience
HANG_DEADLINE_S = 0.1


def phase_paper(ks):
    """Tables 2-4, Figure 3 and the claims at PAPER_SCALE (run.report:
    host builds and descents, each Figure 3 workload's oracle gate also
    on the 2DReach methods' engines on the card); perf_build's smoke
    config (device build equal to the host build, zero-copy adoption;
    its K7, K8 launches); perf_queries' class sweep (every class and
    path equal to the host, n_compiles flat), then each class and path
    once more with the launches counted."""
    from repro_torch.benchmarks import perf_build, perf_queries, run
    from repro_torch.core import QueryEngine, build_2dreach
    from repro_torch.core.engine import engine_for
    from repro_torch.data import get_dataset

    out = {"cut": {"scale": PAPER_SCALE, "fig3_queries": PAPER_QUERIES,
                   "perf_build": list(PERF_BUILD_CONFIG),
                   "perf_queries": PERF_QUERIES_CONFIG}}
    rep = run.report(PAPER_SCALE, PAPER_QUERIES, device=DEVICE)
    out["tables"] = {k: rep[k] for k in ("table2", "table3", "table4",
                                         "claims", "seconds")}
    out["fig3"] = rep["fig3"]

    name = "x".join(map(str, PERF_BUILD_CONFIG))
    ks.reset()
    t0 = time.perf_counter()
    row = perf_build.bench_config(*PERF_BUILD_CONFIG, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = ks.counts()
    if not (launches["bitset_mm"] and launches["seg_mbr"]):
        raise AssertionError(f"perf_build {name}: launches {launches}")
    out["perf_build"] = {"config": name, "seconds": round(seconds, 3),
                         "launches": launches, "row": row,
                         "summary": perf_build.bench_summary([row])}

    t0 = time.perf_counter()
    rows = perf_queries.class_sweep(**PERF_QUERIES_CONFIG, device=DEVICE)
    summary = perf_queries.bench_summary(rows)
    if summary["steady_state_recompiles"] or set(summary["classes"]) != \
            set(perf_queries.CLASSES):
        raise AssertionError(f"perf_queries: {summary}")
    cfg = PERF_QUERIES_CONFIG
    g = get_dataset(cfg["dataset"], scale=cfg["scale"])
    idx = build_2dreach(g, variant="comp")
    eng = engine_for(idx, device=DEVICE)
    two = QueryEngine(idx, device=DEVICE, path="two_phase")
    cases = perf_queries.class_cases(
        idx, eng, two, perf_queries.class_workload(g, cfg["n_q"]),
        cfg["k"])
    per_path = {}
    for kind, (host_fn, paths) in cases.items():
        want = host_fn()
        for path, fn in paths.items():
            ks.reset()
            got = fn()
            n = ks.counts()
            need, never = PQ_KERNELS[path]
            need = need | ({PQ_SCANS[kind]} if path == "two_phase" else set())
            if not perf_queries._same(kind, want, got) or not all(
                    n[k] for k in need) or any(n[k] for k in never):
                raise AssertionError(f"perf_queries {kind} {path}: "
                                     f"launches {n}")
            per_path[f"{kind} {path}"] = {k: v for k, v in n.items() if v}
    out["perf_queries"] = {
        "config": f"{cfg['dataset']}x{cfg['scale']} 2dreach-comp",
        "seconds": round(time.perf_counter() - t0, 3), "summary": summary,
        "launches": per_path}
    return out


def phase_resilience(ks, engines, indexes):
    """``ResilientEngine`` over phase main's yelp x1.0 2dreach-comp engine
    on the first batch (B = BATCH) of its workload: healthy, one injected
    raise, retries spent with the two-phase path as the degradation
    target, the breaker tripped, a corrupt answer caught by the auditor,
    a stall past the deadline; each with its answers held to the host
    index and its launches counted; then the disabled fault hooks' cost
    (``obs_overhead``'s analytic gate)."""
    from repro_torch import obs
    from repro_torch.benchmarks import obs_overhead
    from repro_torch.obs.metrics import Registry
    from repro_torch.queries import knn_reach_host, polygon_reach_host
    from repro_torch.resilience import (
        FaultPlan,
        FaultSpec,
        ResilientEngine,
        RetryPolicy,
        inject,
    )

    name = "{}x{} {}".format(*CONFIGS[0])
    eng, us, rects = engines[name]
    g, _, idx, host_reach, (pus, polys) = indexes[name]
    u, r = us[:BATCH], rects[:BATCH]
    pts = ((r[:, :2] + r[:, 2:]) / 2).astype(np.float32)
    pu, pp = pus[:BATCH], polys[:BATCH]
    cnt, ids = host_count_collect(idx, u, r, COLLECT_K)
    want = {"reach": host_reach[:BATCH], "count": cnt, "collect": ids,
            "knn": knn_reach_host(idx, u, pts, KNN_K),
            "polygon": polygon_reach_host(idx, pu, pp)}

    def serve_classes(e):
        col = e.collect_batch(u, r, COLLECT_K)
        got = {"reach": e.query_batch(u, r), "count": e.count_batch(u, r),
               "collect": col.ids, "knn": e.knn_batch(u, pts, KNN_K),
               "polygon": e.polygon_batch(pu, pp)}
        for kind, w in want.items():
            a = got[kind]
            same = (np.array_equal(a.ids, w.ids)
                    and np.array_equal(a.dist2, w.dist2)
                    if kind == "knn" else np.array_equal(a, w))
            if not same or (kind == "collect"
                            and not np.array_equal(col.counts, cnt)):
                raise AssertionError(f"resilience: {kind} != host")

    def wrapper(**kw):
        kw.setdefault("retry", RetryPolicy(max_attempts=3, base_s=1e-4,
                                           cap_s=1e-3))
        return ResilientEngine(eng, idx, registry=Registry(), **kw)

    def counted(fn):
        """``fn()``, the launches it made and its seconds."""
        ks.reset()
        t0 = time.perf_counter()
        got = fn()
        return got, ks.counts(), time.perf_counter() - t0

    out = {"engine": name, "batch": BATCH}
    # healthy: the wrapper launches what the bare engine launches (once
    # its capacity ratchet has seen these batches)
    serve_classes(eng)
    _, bare, _ = counted(lambda: serve_classes(eng))
    res = wrapper()
    _, wrapped, _ = counted(lambda: serve_classes(res))
    if wrapped != bare or res.stats["fallback_queries"] or \
            res.stats["device_batches"] != len(want):
        raise AssertionError(f"resilience healthy: {wrapped} against the "
                             f"bare engine's {bare}, {res.stats}")
    out["healthy"] = {"launches": wrapped, "stats": dict(res.stats)}

    # one injected raise at the engine's entry: one retry, exact
    res = wrapper()
    with inject(FaultPlan(FaultSpec("engine.query_batch", kind="raise"),
                          seed=1)) as plan:
        got, n, _ = counted(lambda: res.query_batch(u, r))
    rep = res.last_report
    if not (np.array_equal(got, want["reach"])
            and (rep["attempts"] == 2).all() and rep["retries"] == 1
            and plan.fires_at("engine.query_batch") == 1
            and n["fused_serve"] == 1):
        raise AssertionError(f"resilience retry: {rep}, launches {n}")
    out["retry"] = {"launches": n, "retries": rep["retries"],
                    "attempts": int(rep["attempts"].max())}

    # retries spent, the two-phase path answers: as many fires as
    # attempts, so the degraded call (which re-enters query_batch) runs
    # clean
    res = wrapper(degraded_path="two_phase")
    with inject(FaultPlan(FaultSpec(
            "engine.query_batch", kind="raise",
            max_fires=res.retry.max_attempts), seed=2)):
        got, n, _ = counted(lambda: res.query_batch(u, r))
    rep = res.last_report
    expect = {**dict.fromkeys(KERNELS, 0), "prune_tiles": 1,
              "descent_scan": 1}
    if not (np.array_equal(got, want["reach"])
            and rep["degraded"].all() and n == expect
            and res.stats["fallback_queries"] == BATCH):
        raise AssertionError(f"resilience two_phase: launches {n}, {rep}")
    out["two_phase"] = {"launches": n, "retries": rep["retries"],
                        "stats": dict(res.stats)}

    # the breaker tripped: the host answers every class, nothing launches
    res = wrapper()
    res.trip()
    _, n, _ = counted(lambda: serve_classes(res))
    if any(n.values()) or res.stats["fallback_batches"] != len(want):
        raise AssertionError(f"resilience tripped: launches {n}")
    out["tripped"] = {"launches_total": sum(n.values()),
                      "stats": dict(res.stats)}

    # a corrupt answer, caught by the exactness auditor
    aud = obs.ExactnessAuditor(idx, sample=1.0)
    with inject(FaultPlan(FaultSpec("engine.answer", kind="corrupt"))):
        ans = eng.query_batch(u, r)
    aud.observe(u, r, ans)
    aud.drain()
    audit = aud.report()
    if audit["divergences"] != 1 or audit["kept"][0]["served"] == \
            audit["kept"][0]["expected"]:
        raise AssertionError(f"resilience corrupt: {audit}")
    out["corrupt"] = {k: audit[k] for k in ("checked", "divergences")}

    # a stall that ends in an error past the deadline: no retry, the
    # host answers, in bounded time
    res = wrapper()
    with inject(FaultPlan(
            FaultSpec("engine.query_batch", kind="hang", hang_s=HANG_S),
            FaultSpec("engine.route_prune", kind="raise"), seed=3)):
        got, n, dt = counted(
            lambda: res.query_batch(u, r, deadline=HANG_DEADLINE_S))
    rep = res.last_report
    if not (np.array_equal(got, want["reach"])
            and rep["degraded"].all() and (rep["attempts"] == 1).all()
            and not any(n.values()) and dt < HANG_S + 5.0):
        raise AssertionError(f"resilience hang: {dt} s, launches {n}, "
                             f"{rep}")
    out["hang"] = {"seconds": round(dt, 3), "hang_s": HANG_S,
                   "deadline_s": HANG_DEADLINE_S,
                   "attempts": int(rep["attempts"].max())}

    # the disabled fault hooks: crossings a batch, cost each, share of a
    # batch (obs_overhead's analytic gate, on this engine's batch)
    per_hook = obs_overhead.disabled_fault_point_cost_s()
    hooks = obs_overhead.fault_hooks_per_batch(eng, u, r)
    per_batch = obs_overhead.batch_time_s(eng, u, r)
    share = hooks * per_hook / per_batch
    if share >= obs_overhead.GATE:
        raise AssertionError(f"resilience: disabled fault hooks {share}")
    out["disabled_hooks"] = {"per_batch": hooks,
                             "ns_each": per_hook * 1e9,
                             "batch_us": per_batch * 1e6,
                             "share_of_batch": share}
    return out


# --------------------------------------------------------------------------
# The dynamic index (repro_torch.dynamic) and the cluster's sharded engine
# and frontend (repro_torch.cluster)
# --------------------------------------------------------------------------

DYN_CONFIG = ("yelp", 1.0, "2dreach-comp")
DYN_OVERLAYS = (0, 64, 256, 1024)     # perf_dynamic's checkpoints
DYN_MIX = dict(p_query=0.0, p_edge=0.6, p_vertex=0.2, p_spatial=0.2)
DYN_SEED = 7
DYN_ORACLE = 64                       # queries held to the BFS oracle
DYN_TAIL_OPS = 4                      # updates racing each served batch
DYN_PRE_BG_OPS = 64                   # updates before the background one
MEM_SLACK = 4 << 20                   # bytes "flat" allows beyond the base
# the shard counts per index; S = 8 on x1.0 comp is cut to keep the
# script inside its time
CLUSTER_CONFIGS = ((("yelp", 0.5, "2dreach"), (1, 4, 8)),
                   (("yelp", 1.0, "2dreach-comp"), (1, 4)))
FRONTEND_THREADS = 4
DYN_CLUSTER_SHARDS = 4


def served(fn, us, rects):
    """``fn`` over the workload in batches of BATCH, concatenated."""
    return np.concatenate([fn(us[s:s + BATCH], rects[s:s + BATCH])
                           for s in range(0, len(us), BATCH)])


def tensor_bytes(*objs) -> int:
    """Bytes of the distinct CUDA tensors among the attributes of
    ``objs`` (and of the dicts and tuples they hold, one level down)."""
    import torch

    seen, total = set(), 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor) and t.is_cuda \
                and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.untyped_storage().nbytes()

    for o in objs:
        for v in vars(o).values():
            add(v)
            for w in (v.values() if isinstance(v, dict) else
                      v if isinstance(v, (tuple, list)) else ()):
                for x in (w if isinstance(w, (tuple, list)) else (w,)):
                    add(x)
    return total


def base_bytes(dyn) -> int:
    """Device bytes of a dynamic index's base: its engine's arena,
    pyramid, quantized planes, ids, routing side and padding buffers,
    and its device build's handoff."""
    eng = dyn.base_engine
    return tensor_bytes(eng, eng._arena, eng._side, eng._padder,
                        dyn.base_index.forest.device)


def memory_level(dyn) -> dict:
    import torch

    torch.cuda.synchronize()
    total = torch.cuda.memory_allocated()
    base = base_bytes(dyn)
    return {"allocated": total, "base": base, "other": total - base}


def phase_dynamic(ks):
    """``DynamicIndex(engine="device")`` on yelp x1.0 2dreach-comp, built
    with the device backend on the card (adopted, no upload), against the
    port's host-engine ``DynamicIndex`` fed the same updates
    (``streaming_workload``, perf_dynamic's update mix): 2,048 queries in
    batches of BATCH at overlay sizes 0, 64, 256 and 1,024, every answer
    equal, DYN_ORACLE of them held to the BFS oracle on
    ``snapshot_graph()``, the engine's shapes flat once warm; count,
    collect (k = 8) and one polygon batch at the largest overlay; one
    sync compaction, one background compaction while batches are served
    and updates race it (the tail replayed), a third one, and a crash
    injected at ``dynamic.compaction.mid_swap`` (rolled back, the same
    answers); K7 and K8 launches per compaction, no upload, device
    memory beyond the base flat."""
    from repro_torch.core import rangereach_oracle_batch
    from repro_torch.core.engine import UPLOAD_COUNTERS
    from repro_torch.data import (
        apply_stream_op,
        get_dataset,
        polygon_workload,
        streaming_workload,
        workload,
    )
    from repro_torch.dynamic import NEVER, DynamicIndex
    from repro_torch.resilience import (
        FaultPlan,
        FaultSpec,
        InjectedFault,
        inject,
    )

    ds, scale, method = DYN_CONFIG
    name = f"{ds}x{scale} {method}"
    g = get_dataset(ds, scale=scale)
    us, rects = workload(g, N_QUERIES, extent_ratio=0.05)
    ops = iter(streaming_workload(g, n_steps=8 * max(DYN_OVERLAYS),
                                  seed=DYN_SEED, **DYN_MIX))
    applied = []
    uploads0 = UPLOAD_COUNTERS["host_uploads"]
    ks.reset()
    t0 = time.perf_counter()
    dev = DynamicIndex(g, method, policy=NEVER, engine="device")
    build_s = time.perf_counter() - t0
    build_launches = ks.counts()
    t0 = time.perf_counter()
    host = DynamicIndex(g, method, policy=NEVER)
    host_build_s = time.perf_counter() - t0
    if dev.base_engine.stats["adopted"] != 1 or not (
            build_launches["bitset_mm"] and build_launches["seg_mbr"]):
        raise AssertionError(f"dynamic: base not adopted from a device "
                             f"build: {build_launches}")
    def update(n):
        for _ in range(n):
            op = next(ops)
            apply_stream_op(dev, op)
            apply_stream_op(host, op)
            applied.append(op)

    def check(what, sample=False):
        got = served(dev.query_batch, us, rects)
        want = host.query_batch(us, rects)
        if not np.array_equal(got, want):
            raise AssertionError(f"dynamic {what}: device != host engine "
                                 f"({int((got != want).sum())} answers)")
        if sample:
            gm = dev.snapshot_graph()
            o = rangereach_oracle_batch(gm, us[:DYN_ORACLE],
                                        rects[:DYN_ORACLE])
            if not np.array_equal(o, got[:DYN_ORACLE]):
                raise AssertionError(f"dynamic {what}: != BFS oracle")
        return got

    overlays = []
    for target in DYN_OVERLAYS:
        while dev.overlay_size < target:
            update(1)
        ans = check(f"overlay {target}", sample=True)   # warm-up pass
        check(f"overlay {target} (2)")                  # ratchet settled
        warm = dev.base_engine.n_compiles
        ks.reset()
        t0 = time.perf_counter()
        served(dev.query_batch, us, rects)
        dt = time.perf_counter() - t0
        launches = ks.counts()
        t0 = time.perf_counter()
        host.query_batch(us, rects)
        host_dt = time.perf_counter() - t0
        if dev.base_engine.n_compiles != warm or not \
                launches["fused_serve"]:
            raise AssertionError(f"dynamic overlay {target}: shapes "
                                 f"{warm} -> {dev.base_engine.n_compiles}, "
                                 f"launches {launches}")
        overlays.append({
            "overlay_size": dev.overlay_size,
            "us_per_query": dt / len(us) * 1e6,
            "host_engine_us_per_query": host_dt / len(us) * 1e6,
            "fused_serve_launches": launches["fused_serve"],
            "n_compiles": warm, "hit_rate": float(ans.mean())})

    # the analytics classes over base and overlay
    pus, polys = polygon_workload(g, BATCH, n_edges=POLY_EDGES,
                                  extent_ratio=0.05, seed=3)
    u, r = us[:BATCH], rects[:BATCH]
    ks.reset()
    got = {"count": dev.count_batch(u, r),
           "collect": dev.collect_batch(u, r, KNN_K),
           "polygon": dev.polygon_batch(pus, list(polys))}
    classes = ks.counts()
    want = {"count": host.count_batch(u, r),
            "collect": host.collect_batch(u, r, KNN_K),
            "polygon": host.polygon_batch(pus, list(polys))}
    for kind in got:
        a, b = got[kind], want[kind]
        same = (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.counts, b.counts)
                if kind == "collect" else np.array_equal(a, b))
        if not same:
            raise AssertionError(f"dynamic {kind}: device != host engine")
    if not (classes["fused_serve"] and classes["prune_tiles"]
            and classes["polygon_scan"]):
        raise AssertionError(f"dynamic classes: launches {classes}")

    def compaction(background):
        """One compaction, with DYN_TAIL_OPS updates racing each batch
        served while a background build runs."""
        ks.reset()
        t0 = time.perf_counter()
        fg, tail = [], 0
        if not dev.compact(background=background):
            raise AssertionError("dynamic: a compaction was in flight")
        s = 0
        while dev.compacting:
            b0 = time.perf_counter()
            a = dev.query_batch(us[s:s + BATCH], rects[s:s + BATCH])
            fg.append((time.perf_counter() - b0) / BATCH * 1e6)
            if not np.array_equal(a, host.query_batch(
                    us[s:s + BATCH], rects[s:s + BATCH])):
                raise AssertionError("dynamic: answers during the build")
            update(DYN_TAIL_OPS)
            tail += DYN_TAIL_OPS
            s = (s + BATCH) % len(us)
        dev.join_compaction(timeout=600)        # re-raises a failure
        seconds = time.perf_counter() - t0
        if dev.compaction_error is not None:
            raise AssertionError(f"dynamic: {dev.compaction_error!r}")
        n = ks.counts()
        if len(dev._oplog) != tail or dev.base_engine.stats["adopted"] != 1:
            raise AssertionError(f"dynamic: tail {len(dev._oplog)} of "
                                 f"{tail} replayed")
        check("after the swap", sample=True)
        return {"seconds": seconds, "build_seconds":
                dev.stats["t_last_compaction"],
                "bitset_mm": n["bitset_mm"], "seg_mbr": n["seg_mbr"],
                "fused_serve_foreground": n["fused_serve"],
                "tail_replayed": tail, "foreground_batches": len(fg),
                "foreground_us_per_query": fg,
                "entries": int(len(dev.base_index.forest.entries)),
                "memory": memory_level(dev)}

    comps = [compaction(False)]
    update(DYN_PRE_BG_OPS)
    comps.append(compaction(True))
    if not comps[1]["foreground_batches"]:
        raise AssertionError("dynamic: no batch served during the build")
    comps.append(compaction(False))
    if any(not (c["bitset_mm"] and c["seg_mbr"]) for c in comps):
        raise AssertionError(f"dynamic: a compaction did not build on the "
                             f"card: {comps}")

    # a crash inside the swap rolls back: the same answers, the failed
    # swap's new engine freed
    update(DYN_PRE_BG_OPS)
    before = check("before the crash")
    mem_before = memory_level(dev)
    with inject(FaultPlan(FaultSpec("dynamic.compaction.mid_swap",
                                    kind="raise"))):
        try:
            dev.compact(background=False)
        except InjectedFault:
            pass
        else:
            raise AssertionError("dynamic: the injected crash did not fire")
    if not np.array_equal(check("after the crash"), before) or \
            dev.stats["n_compactions"] != len(comps):
        raise AssertionError("dynamic: the crashed swap changed answers")
    mem_crash = memory_level(dev)
    flat = [c["memory"]["other"] - comps[0]["memory"]["other"]
            for c in comps[1:]] + [mem_crash["other"]
                                   - comps[0]["memory"]["other"],
                                   mem_crash["allocated"]
                                   - mem_before["allocated"]]
    if max(flat) > MEM_SLACK:
        raise AssertionError(f"dynamic: device memory beyond the base "
                             f"grew {flat} bytes")
    uploads = UPLOAD_COUNTERS["host_uploads"] - uploads0
    if uploads:
        raise AssertionError(f"dynamic: {uploads} host uploads")
    out = {"config": name, "build_seconds": build_s,
           "host_engine_build_seconds": host_build_s,
           "build_launches": {k: v for k, v in build_launches.items() if v},
           "overlays": overlays, "class_launches": {
               k: v for k, v in classes.items() if v},
           "compactions": comps, "crash": {"memory_before": mem_before,
                                           "memory_after": mem_crash},
           "memory_growth_beyond_base": flat, "host_uploads": uploads,
           "stats": {k: v for k, v in dev.report().items()
                     if isinstance(v, (int, float))}}
    return out, host, applied


def phase_cluster(ks, engines, indexes, built, dyn_host, dyn_ops):
    """``ShardedEngine`` on the card at S = 1, 4 and 8 shards over yelp
    x0.5 2dreach (base) and at S = 1 and 4 over x1.0 2dreach-comp (phase
    main's indexes and workloads): fused and two-phase answers to all 2,048 queries equal to
    ``query_host`` and to main's single-device engine; per batch S K1
    launches (plus S per ratchet re-run), or S K2 and S K3; balance, the
    common width Pp and the stacks' bytes.  ``shard_arenas`` of the
    device-built forest (phase device_build) equal to the host path's:
    K8 twice per shard (the fine and the coarse level), one adoption.
    A ``Frontend`` (max_batch 256) over 2,048 submits from
    FRONTEND_THREADS threads.  ``DynamicIndex(engine="cluster")`` fed
    phase dynamic's updates, against its host-engine index, across one
    compaction."""
    import torch

    from repro_torch.cluster import (
        Frontend,
        ShardedEngine,
        partition_forest,
        shard_arenas,
    )
    from repro_torch.core import query_host
    from repro_torch.core.engine import UPLOAD_COUNTERS
    from repro_torch.data import (
        apply_stream_op,
        get_dataset,
        workload,
    )
    from repro_torch.dynamic import NEVER, DynamicIndex

    names = ["{}x{} {}".format(*c) for c, _ in CLUSTER_CONFIGS]
    out = {"engines": [], "shard_arenas": [], "frontend": None}
    for name, (_, shard_counts) in zip(names, CLUSTER_CONFIGS):
        g, method, idx, host_reach, _ = indexes[name]
        eng, us, rects = engines[name]
        exc = idx.excluded[us]
        tid = np.full(len(us), -1, np.int64)
        tid[~exc] = idx.lookup_tree(us[~exc])
        routed = tid >= 0
        if not np.array_equal(query_host(idx.forest, tid[routed],
                                         rects[routed]),
                              host_reach[routed]):
            raise AssertionError(f"cluster {name}: host index != query_host")
        single = served(eng.query_batch, us, rects)
        if not np.array_equal(single, host_reach):
            raise AssertionError(f"cluster {name}: QueryEngine != host")
        for S in shard_counts:
            t0 = time.perf_counter()
            se = ShardedEngine(idx, n_shards=S)
            rec = {"index": name, "shards": S,
                   "setup_seconds": time.perf_counter() - t0,
                   "balance": se.partition.balance(), "width": se.width,
                   "n_tiles": se.n_tiles,
                   "shard_entries": se.partition.shard_entries.tolist(),
                   "stack_bytes": se.nbytes_planes}
            for path, fn in (("fused", se.query_batch),
                             ("two_phase", se.query_batch_two_phase)):
                if not np.array_equal(served(fn, us, rects), host_reach):
                    raise AssertionError(f"cluster {name} S={S} {path}: "
                                         f"!= query_host")
                reruns = se.stats["fused_reruns"]
                ks.reset()
                t0 = time.perf_counter()
                got = served(fn, us, rects)
                dt = time.perf_counter() - t0
                n = ks.counts()
                batches = -(-len(us) // BATCH)
                reruns = se.stats["fused_reruns"] - reruns
                want = ({"fused_serve": S * (batches + reruns)}
                        if path == "fused" else
                        {"prune_tiles": S * batches,
                         "descent_scan": S * batches})
                want = {**dict.fromkeys(KERNELS, 0), **want}
                if not np.array_equal(got, single) or n != want:
                    raise AssertionError(f"cluster {name} S={S} {path}: "
                                         f"launches {n}, expected {want}")
                rec[path] = {"us_per_query": dt / len(us) * 1e6,
                             "launches": {k: v for k, v in n.items() if v},
                             "reruns": reruns}
            rec["stats"] = {k: int(v) for k, v in se.stats.items()}
            out["engines"].append(rec)
            del se
        # the device path of shard_arenas, from phase device_build's
        # forest
        dforest = built[name].forest
        for S in shard_counts:
            part = partition_forest(idx.forest, S)
            want = shard_arenas(idx.forest, part)
            before = dict(UPLOAD_COUNTERS)
            ks.reset()
            got = shard_arenas(dforest, partition_forest(dforest, S))
            torch.cuda.synchronize()
            n = ks.counts()
            moved = {k: UPLOAD_COUNTERS[k] - before[k] for k in before}
            if n["seg_mbr"] != 2 * S or moved != {"host_uploads": 0,
                                                   "device_adoptions": 1}:
                raise AssertionError(f"cluster {name} S={S} shard_arenas: "
                                     f"launches {n}, {moved}")
            for a, b in zip(got[:3], want[:3]):
                if not np.array_equal(a.cpu().numpy(), b):
                    raise AssertionError(f"cluster {name} S={S}: device "
                                         f"shard_arenas != host path")
            out["shard_arenas"].append({"index": name, "shards": S,
                                        "seg_mbr": n["seg_mbr"],
                                        "adoption": moved})
            del got, want

    # the frontend over the x1.0 comp sharded engine, four submitters
    name = names[1]
    eng, us, rects = engines[name]
    host_reach = indexes[name][3]
    se = ShardedEngine(indexes[name][2], n_shards=DYN_CLUSTER_SHARDS)
    answers = np.zeros(len(us), dtype=bool)
    errs = []

    with Frontend(se, max_batch=BATCH, max_delay=2e-3) as fe:
        fe.warmup(us[:BATCH], rects[:BATCH])

        def submit(k):
            try:
                sl = range(k, len(us), FRONTEND_THREADS)
                futs = [(i, fe.submit(int(us[i]), rects[i])) for i in sl]
                for i, f in futs:
                    answers[i] = f.result(timeout=120)
            except BaseException as e:       # raised below, in this thread
                errs.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(FRONTEND_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        dt = time.perf_counter() - t0
        stats = dict(fe.stats)
        mean_batch = fe.mean_batch
    if errs or any(t.is_alive() for t in threads) or \
            not np.array_equal(answers, host_reach):
        raise AssertionError(f"cluster frontend: {errs[:1]}, "
                             f"{int((answers != host_reach).sum())} wrong")
    out["frontend"] = {"index": name, "shards": se.n_shards,
                       "threads": FRONTEND_THREADS, "requests": len(us),
                       "seconds": dt, "mean_batch": mean_batch,
                       "stats": stats}
    del se

    # the dynamic index on the sharded base, fed phase dynamic's updates
    ds, scale, method = DYN_CONFIG
    g = get_dataset(ds, scale=scale)
    dus, drects = workload(g, N_QUERIES, extent_ratio=0.05)
    t0 = time.perf_counter()
    dyn = DynamicIndex(g, method, policy=NEVER, engine="cluster",
                       n_shards=DYN_CLUSTER_SHARDS)
    for op in dyn_ops:
        apply_stream_op(dyn, op)
    want = dyn_host.query_batch(dus, drects)
    ks.reset()
    before = served(dyn.query_batch, dus, drects)
    n_before = ks.counts()
    dyn.compact(background=False)
    after = served(dyn.query_batch, dus, drects)
    if not (np.array_equal(before, want) and np.array_equal(after, want)
            and n_before["fused_serve"]
            and dyn.base_engine.stats["adopted"] == 1):
        raise AssertionError(f"cluster dynamic: answers or launches "
                             f"{n_before}")
    out["dynamic"] = {"config": f"{ds}x{scale} {method}",
                      "shards": dyn.base_engine.n_shards,
                      "updates": len(dyn_ops),
                      "seconds": time.perf_counter() - t0,
                      "fused_serve_launches": n_before["fused_serve"],
                      "n_compactions": dyn.stats["n_compactions"]}
    return out


# --------------------------------------------------------------------------
# The observability hooks (repro_torch.obs) on the engines of phase main
# --------------------------------------------------------------------------

OBS_ORACLE_SAMPLE = 0.125    # of the auditor's 2,048 checked answers
# phase obs's dumps, traces and flight bundles, under the checkout's
# (git-ignored) build directory, removed at the phase's end
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
OBS_E2E_TURNS = 3            # times e2e_us runs obs off, on, on, off
E2E_REPEATS = 7              # --ab's e2e_us per path, in turns
OBS_TRACE_KERNELS = {"fused_serve": "fused_serve_kernel",
                     "prune_tiles": "prune_tiles_kernel",
                     "descent_scan": "leaf_scan_cluster_kernel"}
# one OpenMetrics sample line, and a TYPE line (the reference's test)
OM_SAMPLE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
             r'(,[a-zA-Z0-9_]+="[^"]*")*\})? -?[0-9].*$|'
             r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? (NaN|[+-]Inf)$')
OM_TYPE = r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary)$"


class counting:
    """Count the calls of an engine's batch entry points (instance
    attributes shadowing the methods while the block runs), those the
    engine makes itself (kNN's collect) included."""

    KINDS = {"query_batch": "reach", "count_batch": "count",
             "collect_batch": "collect", "polygon_batch": "polygon"}

    def __init__(self, eng):
        self.eng, self.calls = eng, dict.fromkeys(self.KINDS.values(), 0)

    def __enter__(self):
        for m, kind in self.KINDS.items():
            fn = getattr(self.eng, m)

            def wrap(*a, _fn=fn, _kind=kind):
                self.calls[_kind] += 1
                return _fn(*a)

            setattr(self.eng, m, wrap)
        return self.calls

    def __exit__(self, *exc):
        for m in self.KINDS:
            delattr(self.eng, m)
        return False


def obs_answers(eng, us, rects, knn_pts, polys):
    """Reach, count and collect on both paths, kNN (k = KNN_K) and a
    polygon batch, B = BATCH: the answers as plain arrays."""
    u, r = us[:BATCH], rects[:BATCH]
    out = []
    for sfx in ("", "_two_phase"):
        out.append(getattr(eng, f"query_batch{sfx}")(u, r))
        out.append(getattr(eng, f"count_batch{sfx}")(u, r))
        col = getattr(eng, f"collect_batch{sfx}")(u, r, COLLECT_K)
        out += [col.ids, col.counts, col.overflow]
    knn = eng.knn_batch(u, knn_pts, KNN_K)
    out += [knn.ids, knn.dist2, eng.polygon_batch(*polys)]
    return out


def mixed_pass(eng, us, rects, knn_pts, polys):
    """One mixed engine pass over the workload: per batch fused reach,
    two-phase count and fused collect; then kNN and a polygon batch."""
    for s in range(0, len(us), BATCH):
        u, r = us[s:s + BATCH], rects[s:s + BATCH]
        eng.query_batch(u, r)
        eng.count_batch_two_phase(u, r)
        eng.collect_batch(u, r, COLLECT_K)
    eng.knn_batch(us[:KNN_QUERIES], knn_pts, KNN_K)
    eng.polygon_batch(*polys)


def trace_kernels(path, want):
    """Device kernel events of a ``device_trace`` Chrome trace by kernel
    (OBS_TRACE_KERNELS), the annotation's events, and whether every
    kernel has as many events as its launch counter saw (``want``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    got = {k: sum(sub in n for n in kern)
           for k, sub in OBS_TRACE_KERNELS.items()}
    return got, len(kern), got == want


def check_dump(paths):
    """Every file of ``obs.dump`` parses: JSON, JSON lines, and the
    OpenMetrics text line by line."""
    import re

    for kind, path in paths.items():
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            json.loads(text)
        elif path.endswith(".jsonl"):
            for ln in text.splitlines():
                json.loads(ln)
        else:
            lines = text.splitlines()
            if lines[-1] != "# EOF":
                raise AssertionError(f"{kind}: no # EOF line")
            for ln in lines[:-1]:
                pat = OM_TYPE if ln.startswith("# TYPE") else OM_SAMPLE
                if not re.match(pat, ln):
                    raise AssertionError(f"{kind}: unparseable {ln!r}")
    return sorted(paths)


def upload_counts(obs):
    c = obs.REGISTRY.snapshot()["counters"]
    return {k: c[k] for k in ("engine.upload.host_uploads",
                              "engine.upload.device_adoptions",
                              "range_query.soa_builds")}


def check_upload_counters(obs, idx):
    """``engine.upload.*`` and ``range_query.soa_builds`` move as the
    builds predict: a second engine over a served index ``idx`` shares
    its planes (nothing moves), a host build served uploads once after
    one transposition, a device build is adopted with no
    transposition."""
    from repro_torch.core import QueryEngine, build_index
    from repro_torch.data import get_dataset

    g_small = get_dataset("yelp", scale=0.1)
    steps = []
    for what, make, want in (
            ("second engine over a served index",
             lambda: QueryEngine(idx), (0, 0, 0)),
            ("host build, then its engine",
             lambda: QueryEngine(build_index(g_small, "2dreach-comp")),
             (1, 0, 1)),
            ("device build, then its engine",
             lambda: QueryEngine(build_index(g_small, "2dreach-comp",
                                             backend="device")),
             (0, 1, 0))):
        before = upload_counts(obs)
        make()
        moved = {k: v - before[k] for k, v in upload_counts(obs).items()}
        if tuple(moved.values()) != want:
            raise AssertionError(f"obs: {what}: counters moved {moved}, "
                                 f"expected {want}")
        steps.append({"step": what, "moved": moved})
    return steps



def phase_obs(ks, engines, indexes):
    """The observability hooks on phase main's engines at yelp x1.0
    2dreach-comp and x0.5 2dreach: answers equal with obs on and off;
    span coverage of a mixed pass; the batch, compile and upload
    counters; the cost model; ``obs.dump``; the exactness auditor; e2e
    µs/query with obs off and on.  ``device_trace`` waits for
    ``phase_obs_trace``, after every other profiled window."""
    import shutil
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.obs import flight

    names = [f"{ds}x{scale} {m}" for ds, scale, m in (CONFIGS[0],
                                                      CONFIGS[-1])]
    work = {}
    for name in names:
        eng, us, rects = engines[name]
        g, _, idx, _, (pus, polys) = indexes[name]
        pts = ((rects[:KNN_QUERIES, :2] + rects[:KNN_QUERIES, 2:])
               / 2).astype(np.float32)
        work[name] = (eng, g, idx, us, rects, pts,
                      (pus[:BATCH], polys[:BATCH]))
    obs.disable()
    obs.reset()
    out = {"engines": names}
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="obs_", dir=SCRATCH)
    try:
        # 1. answers with obs on equal the answers with it off
        for name, (eng, g, idx, us, rects, pts, polys) in work.items():
            off = obs_answers(eng, us, rects, pts[:BATCH], polys)
            obs.enable()
            on = obs_answers(eng, us, rects, pts[:BATCH], polys)
            obs.disable()
            if not all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(off, on)):
                raise AssertionError(f"obs: {name}: answers with obs on "
                                     f"!= answers with it off")
        out["answers_equal"] = True
        obs.reset()

        # 2, 3. coverage of a traced mixed pass, the batch and compile
        # counters, twice over the same shapes
        eng, g, idx, us, rects, pts, polys = work[names[0]]
        passes = []
        obs.start_timeseries(interval=0.05)
        for p in range(2):
            obs.TRACER.clear()
            h0 = obs.REGISTRY.histogram("engine.batch_us").count
            obs.enable()
            with counting(eng) as calls:
                t0 = time.perf_counter()
                with obs.span("serve.mixed_pass", cat="serve"):
                    mixed_pass(eng, us, rects, pts, polys)
                t1 = time.perf_counter()
            obs.disable()
            cov = obs.coverage(t0, t1)
            traced = obs.REGISTRY.histogram("engine.batch_us").count - h0
            per_kind = {k: obs.REGISTRY.histogram(
                f"engine.{k}.query_us").count for k in calls}
            gauge = obs.REGISTRY.gauge("engine.n_compiles").value
            passes.append({"seconds": t1 - t0, "coverage": cov,
                           "batches_traced": traced, "calls": dict(calls),
                           "n_compiles": eng.n_compiles,
                           "n_compiles_gauge": gauge,
                           "stage_totals_us": obs.stage_totals()})
            if cov < 0.95:
                raise AssertionError(f"obs: span coverage {cov} < 0.95")
            if traced != sum(calls.values()) or gauge != eng.n_compiles:
                raise AssertionError(f"obs: {traced} batches recorded for "
                                     f"calls {calls}; n_compiles gauge "
                                     f"{gauge}, engine {eng.n_compiles}")
            if any(per_kind[k] != (p + 1) * calls[k] for k in calls):
                raise AssertionError(f"obs: per-kind batch counts "
                                     f"{per_kind} for calls {calls}")
        if passes[1]["n_compiles"] != passes[0]["n_compiles"]:
            raise AssertionError("obs: n_compiles moved in steady state")
        obs.stop_timeseries()
        out["mixed_passes"] = passes
        out["upload_counters"] = check_upload_counters(obs, idx)

        # 4. the cost model of each engine
        out["cost_model"] = {name: obs.engine_cost_model(w[0])
                             for name, w in work.items()}

        # 5. the dump parses
        obs.enable()
        eng.query_batch(us[:BATCH], rects[:BATCH])
        obs.disable()
        out["dump"] = check_dump(obs.dump(os.path.join(tmp, "dump")))

        # 6. the auditor: zero divergences over 2,048 answers, then one
        # flipped answer gives one divergence and one bundle
        aud = obs.ExactnessAuditor(idx, graph=g, sample=1.0,
                                   oracle_sample=OBS_ORACLE_SAMPLE)
        for s in range(0, len(us), BATCH):
            u, r = us[s:s + BATCH], rects[s:s + BATCH]
            aud.observe(u, r, eng.query_batch(u, r))
        aud.drain()
        clean = aud.report()
        if clean["divergences"] or clean["checked"] != len(us):
            raise AssertionError(f"obs: auditor {clean}")
        obs.FLIGHT.arm(os.path.join(tmp, "flight"), min_interval_s=0.0)
        flip = obs.ExactnessAuditor(idx, sample=1.0)
        ans = eng.query_batch(us[:BATCH], rects[:BATCH]).copy()
        ans[0] = not ans[0]
        flip.observe(us[:BATCH], rects[:BATCH], ans)
        flip.drain()
        bundles = os.listdir(os.path.join(tmp, "flight"))
        rep = flip.report()
        if rep["divergences"] != 1 or len(bundles) != 1:
            raise AssertionError(f"obs: flipped answer gave {rep} and "
                                 f"bundles {bundles}")
        data = flight.load_bundle(os.path.join(tmp, "flight", bundles[0]))
        out["auditor"] = {
            "clean": {k: clean[k] for k in ("checked", "oracle_checked",
                                            "divergences")},
            "flipped": {"divergences": rep["divergences"],
                        "bundle": bundles[0],
                        "reason": data["manifest"]["reason"]}}

        # 7. e2e µs/query, fused and two-phase reach at B = BATCH, with
        # obs off and on, in turns
        e2e = {"fused": {"off": [], "on": []},
               "two_phase": {"off": [], "on": []}}
        for state in ["off", "on", "on", "off"] * OBS_E2E_TURNS:
            for path, two in (("fused", False), ("two_phase", True)):
                if state == "on":
                    obs.enable()
                e2e[path][state].append(e2e_us(eng, us, rects, "reach",
                                               two_phase=two))
                obs.disable()
                obs.TRACER.clear()
        out["e2e_us_per_query"] = e2e
        torch.cuda.synchronize()
    finally:
        obs.disable()
        obs.FLIGHT.disarm()
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_obs_trace(ks, engines):
    """``device_trace`` around one fused and one two-phase reach pass of
    yelp x1.0 2dreach-comp's workload: its Chrome trace must hold one
    device kernel event per K1, K2 and K3 launch that the launch
    counters saw, and the ``annotate`` range; a window short of events
    is traced again, up to PROFILER_TRIES times.  Run last of all the
    profiled windows: after a ``device_trace`` capture, later
    ``torch.profiler`` windows of this process kept no device rows for
    most kernels (PERF.md section 7)."""
    import shutil
    import tempfile

    from repro_torch import obs

    eng, us, rects = engines[next(iter(engines))]
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="obs_trace_", dir=SCRATCH)
    try:
        for attempt in range(PROFILER_TRIES):
            logdir = os.path.join(tmp, f"trace{attempt}")
            ks.reset()
            with obs.device_trace(logdir):
                with obs.annotate("chip_smoke.obs.reach_passes"):
                    for s in range(0, len(us), BATCH):
                        eng.query_batch(us[s:s + BATCH], rects[s:s + BATCH])
                    for s in range(0, len(us), BATCH):
                        eng.query_batch_two_phase(us[s:s + BATCH],
                                                  rects[s:s + BATCH])
            launches = ks.counts()
            want_launch = {k: launches[k] for k in OBS_TRACE_KERNELS}
            path = os.path.join(logdir, obs.profiler.TRACE_FILE)
            if not os.path.exists(path):
                raise AssertionError("obs: device_trace wrote no trace")
            got, n_kern, whole = trace_kernels(path, want_launch)
            with open(path) as f:
                annotated = "chip_smoke.obs.reach_passes" in f.read()
            if whole and annotated:
                break
        TIMERS["device_trace_retries"] = attempt
        if not (whole and annotated):
            raise AssertionError(f"obs: device_trace kept {got} kernel "
                                 f"events for launches {want_launch} "
                                 f"(annotation {annotated})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": want_launch, "events": got, "kernel_events": n_kern,
            "annotation": annotated, "retries": attempt}


# --------------------------------------------------------------------------
# The leaf-scan and wavefront engines, the baselines
# --------------------------------------------------------------------------

def leafscan_pass(ls, idx, us, rects):
    """The leaf-scan engine over the workload in batches of BATCH."""
    return np.concatenate([
        ls.range_query_forest(idx.forest, idx.lookup_tree(us[s:s + BATCH]),
                              rects[s:s + BATCH])
        for s in range(0, len(us), BATCH)])


def wavefront_pass(idx, us, rects):
    """The wavefront engine over the workload in batches of BATCH:
    ``(hit, overflow)``."""
    from repro_torch.core import query_wavefront

    out = [query_wavefront(idx.forest, idx.lookup_tree(us[s:s + BATCH]),
                           rects[s:s + BATCH], capacity=WAVEFRONT_CAPACITY)
           for s in range(0, len(us), BATCH)]
    return (np.concatenate([h for h, _ in out]),
            np.concatenate([o for _, o in out]))


def check_leafscan(ks, name, idx, us, rects, host_reach, adopt, planes):
    """The leaf-scan engine on the card: equal to the host index on every
    query whose vertex is not excluded (the engine probes trees only, as
    ``launch/serve.py`` masks it); K9 once per batch and nothing else;
    no upload and no adoption of the entry planes, which are ``planes``,
    the copy that ``QueryEngine`` uploaded (host build) or adopted
    (device build) for this forest.  Returns the record and K9's
    operands of every batch."""
    import torch
    from repro_torch.kernels.range_query.layout import (
        UPLOAD_COUNTERS,
        forest_planes,
    )

    ls = ks.ls
    before = dict(UPLOAD_COUNTERS)
    with Capture(ls, "range_query", lambda *a: 0) as k9:
        ks.reset()
        t0 = time.perf_counter()
        got = leafscan_pass(ls, idx, us, rects)
        dt = time.perf_counter() - t0
        launches = ks.counts()
    moved = {k: UPLOAD_COUNTERS[k] - before[k] for k in before}
    batches = len(range(0, len(us), BATCH))
    want = {**dict.fromkeys(KERNELS, 0), "range_query": batches}
    shared = forest_planes(idx.forest, torch.device(DEVICE))[0] is planes
    if launches != want or any(moved.values()) or not shared:
        raise AssertionError(f"{name}: leaf-scan launches {launches}, "
                             f"planes {moved}, shared with the engine "
                             f"{shared}; expected {want}, no upload, "
                             f"shared")
    exc = idx.excluded[us]
    if not np.array_equal(got[~exc], host_reach[~exc]):
        raise AssertionError(f"{name}: leaf-scan answers != host index")
    return ({"index": name, "built_on": "device" if adopt else "host",
             "queries": len(us), "excluded": int(exc.sum()),
             "batches": batches, "launches": launches["range_query"],
             "planes": moved, "planes_shared_with_engine": shared,
             "seconds": round(dt, 3),
             "hit_rate": float(got.mean())},
            [(a, k["dim"]) for a, k in k9.calls])


def check_wavefront(ks, name, idx, us, rects, host_reach):
    """The wavefront engine on the card (plain torch, no kernel of the
    port): equal to the host index wherever it did not overflow and the
    vertex is not excluded; the overflowed queries are counted."""
    ks.reset()
    t0 = time.perf_counter()
    hit, over = wavefront_pass(idx, us, rects)
    dt = time.perf_counter() - t0
    launches = ks.counts()
    exc = idx.excluded[us]
    ok = ~over & ~exc
    if not np.array_equal(hit[ok], host_reach[ok]):
        raise AssertionError(f"{name}: wavefront answers != host index")
    if any(launches.values()):
        raise AssertionError(f"{name}: the wavefront launched {launches}")
    return {"index": name, "capacity": WAVEFRONT_CAPACITY,
            "queries": len(us), "overflowed": int(over.sum()),
            "compared": int(ok.sum()), "seconds": round(dt, 3)}


def check_baselines(ks, g, us, rects, host_reach):
    """3DReach, 3DReach-Rev and GeoReach built on the host: answers equal
    to the 2dreach-comp host index on the workload and to the BFS oracle
    on a sample; no device engine (``required=True`` raises).  K9 at
    dim 3 against its plain version on the operands of the leaf scan of
    the probe ``ThreeDReachIndex.query_batch`` hands ``query_host`` for
    the first batch, and that leaf scan equal to ``query_host``."""
    from repro_torch.core import (
        batch_query,
        build_index,
        index_nbytes,
        rangereach_oracle_batch,
        three_d_reach,
    )

    ls = ks.ls
    oracle = rangereach_oracle_batch(g, us[:BATCH], rects[:BATCH])
    recs, errs = {}, {"range_query": 0}
    for method in BASELINES:
        t0 = time.perf_counter()
        idx = build_index(g, method)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ans = idx.query_batch(us, rects)
        query_s = time.perf_counter() - t0
        if not np.array_equal(ans, host_reach):
            raise AssertionError(f"{method}: answers != 2dreach-comp")
        if not np.array_equal(ans[:BATCH], oracle):
            raise AssertionError(f"{method}: answers != BFS oracle")
        try:
            batch_query(idx, us[:8], rects[:8], engine="device",
                        required=True)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{method}: a device engine was found")
        rec = {"build_seconds": round(build_s, 3),
               "us_per_query": query_s / len(us) * 1e6,
               "hit_rate": float(ans.mean()), "nbytes": index_nbytes(idx)}
        if method != "georeach":
            with Capture(three_d_reach, "query_host",
                         lambda f, t, r: len(t)) as qh:
                idx.query_batch(us[:BATCH], rects[:BATCH])
            _, (forest, tids, rect3), _ = qh.best
            want = three_d_reach.query_host(forest, tids, rect3)
            with Capture(ls, "range_query", lambda *a: 0) as k9:
                got = ls.range_query_forest(forest, tids, rect3)
            _, args, kw = k9.best
            e, hits = compare_range_query(ks, args, kw["dim"],
                                          f"{method} dim 3 probe")
            if not np.array_equal(got, want):
                raise AssertionError(f"{method}: leaf scan != query_host")
            errs["range_query"] = max(errs["range_query"], e)
            rec.update(entries=int(len(forest.entries)),
                       probes=int(len(tids)), probe_hits=hits,
                       intervals=int(idx.labels.total_intervals))
        recs[method] = rec
        del idx
    return recs, errs


def phase_legacy(ks, indexes, built, results, engines):
    """The leaf-scan engine on each main-path index, host-built and
    device-built; the wavefront engine on each host-built index; the
    three baselines at yelp x1.0; index sizes of all six methods there.
    Returns the leaf-scan records, K9's first-batch operands per index,
    K9's operands of every launch per leaf-scan path and K9's largest
    difference from its plain version."""
    from repro_torch.core import build_index, index_nbytes

    leafscan, wavefront, ops, calls = [], [], {}, {}
    for name, (g, method, idx, host_reach, _) in indexes.items():
        eng, us, rects = engines[name]
        rec, calls[f"{name} host-built"] = check_leafscan(
            ks, name, idx, us, rects, host_reach, False, eng._arena.entries)
        ops[name] = calls[f"{name} host-built"][0]
        leafscan.append(rec)
        dev = built[name]
        rec, calls[f"{name} device-built"] = check_leafscan(
            ks, name, dev, us, rects, host_reach, True,
            dev.forest.device.entries)
        leafscan.append(rec)
        wavefront.append(check_wavefront(ks, name, idx, us, rects,
                                         host_reach))
    name = next(iter(indexes))                 # yelp x1.0 2dreach-comp
    g, _, _, host_reach, _ = indexes[name]
    _, us, rects = engines[name]
    baselines, errs = check_baselines(ks, g, us, rects, host_reach)
    sizes = {m: {"nbytes": r["nbytes"], "build_seconds": r["build_seconds"]}
             for m, r in baselines.items()}
    for (ds, scale, method), r in zip(CONFIGS, results):
        if (ds, scale) == CONFIGS[0][:2]:
            sizes[method] = {"nbytes": index_nbytes(indexes[r["index"]][2]),
                             "build_seconds": r["build_seconds"]}
    t0 = time.perf_counter()
    base = build_index(g, "2dreach")            # the one not yet at x1.0
    sizes["2dreach"] = {"nbytes": index_nbytes(base),
                        "build_seconds": round(time.perf_counter() - t0, 3)}
    del base
    emit("legacy", ok=True, leafscan=leafscan, wavefront=wavefront,
         baselines=baselines, sizes={
             "config": name.split()[0],
             **{m: sizes[m] for m in ("2dreach", "2dreach-comp",
                                      "2dreach-pointer", *BASELINES)}},
         max_abs_err=errs)
    return leafscan, ops, calls, errs


def arena_of(eng):
    return {"fine": eng._arena.fine, "coarse": eng._arena.coarse,
            "esoa": eng._arena.entries, "ids": eng._ids_row}


# --------------------------------------------------------------------------
# Device build
# --------------------------------------------------------------------------

class Capture:
    """Within ``with``, ``module.name`` is this object: it keeps the
    arguments ``(size, args, kwargs)`` of the call with the largest
    ``size(*args)`` (the first of equals) as ``best`` and ``(args,
    kwargs)`` of every call in order as ``calls``, and hands
    every call on to the kernel wrapper it replaced.  The wrapper counts
    its own launches; ``launches`` reads and writes the wrapper's count,
    so a wrapper that finds this object under its own name counts as
    before."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.fn = getattr(module, name)
        self.best = None
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        n = self.size(*args)
        if self.best is None or n > self.best[0]:
            self.best = (n, args, kw)
        return self.fn(*args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def same_index(a, b) -> bool:
    """Every serving array of two 2DReach indexes equal, dtype too."""
    fa, fb = a.forest, b.forest
    pairs = [(fa.entries, fb.entries), (fa.entry_ids, fb.entry_ids),
             (fa.entry_off, fb.entry_off), (a.comp_tree, b.comp_tree),
             (a.excluded, b.excluded), (a.vertex_comp, b.vertex_comp)]
    pairs += list(zip(fa.level_mbr + fa.tree_off, fb.level_mbr + fb.tree_off))
    if a.vertex_tree is not None:
        pairs.append((a.vertex_tree, b.vertex_tree))
    else:
        pairs += [(a.bitrank.bits, b.bitrank.bits),
                  (a.bitrank.rank, b.bitrank.rank),
                  (a.tree_ptrs, b.tree_ptrs)]
    return fa.depth == fb.depth and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in pairs)


def phase_device_build(ks, indexes, engines):
    """``backend="device"`` builds on the card: arrays equal to the host
    build, the forest adopted by the engine, the same reach answers; the
    closure-product and segmented-MBR launches per index (one per
    condensation level with edges; one per R-tree level plus the two
    pyramid planes), and the largest launch of each for the timing;
    each closure-product launch's (f, Wm, m, W) and set bits of A.
    Returns the records, those largest launches, the device-built
    indexes and every closure-product launch's operands per index."""
    import torch
    from repro_torch.core import QueryEngine, build_index
    from repro_torch.core import reachability, two_d_reach
    from repro_torch.core.engine import UPLOAD_COUNTERS
    from repro_torch.kernels.forest_build import ops as fb_ops

    recs, largest, built, k7_calls = [], {}, {}, {}
    for name, (g, method, idx, host_reach, _) in indexes.items():
        eng, us, rects = engines[name]
        cond = idx.cond
        want_k7 = (len(np.unique(cond.level[cond.dag_edges[:, 0]]))
                   if cond.dag_edges.size else 0)
        want_k8 = idx.forest.depth + 2
        with Capture(reachability, "bitset_mm",
                     lambda a, r: a.shape[0] * r.shape[1]) as k7, \
                Capture(fb_ops, "seg_mbr", lambda c: c.numel()) as k8, \
                Capture(two_d_reach, "closure_bitset_mm",
                        lambda *a, **kw: 0) as clo:
            ks.reset()
            t0 = time.perf_counter()
            dev = build_index(g, method, backend="device")
            dev_s = time.perf_counter() - t0
            launches = ks.counts()
        expect = {**dict.fromkeys(KERNELS, 0), "bitset_mm": want_k7,
                  "seg_mbr": want_k8}
        if launches != expect:
            raise AssertionError(f"{name}: device build launches "
                                 f"{launches}, expected {expect}")
        if not same_index(idx, dev) or dev.backend != "device":
            raise AssertionError(f"{name}: device build != host build")
        before = dict(UPLOAD_COUNTERS)
        deng = QueryEngine(dev)
        adopted = {k: UPLOAD_COUNTERS[k] - before[k] for k in before}
        if adopted != {"host_uploads": 0, "device_adoptions": 1} \
                or deng.stats["adopted"] != 1:
            raise AssertionError(f"{name}: engine did not adopt the device "
                                 f"forest: {adopted}")
        for attr in ("entries", "fine", "coarse", "entry_off"):
            if not torch.equal(getattr(deng._arena, attr),
                               getattr(eng._arena, attr)):
                raise AssertionError(f"{name}: adopted {attr} != upload")
        got = np.concatenate([deng.query_batch(us[s:s + BATCH],
                                               rects[s:s + BATCH])
                              for s in range(0, len(us), BATCH)])
        if not np.array_equal(got, host_reach):
            raise AssertionError(f"{name}: device-built engine answers != "
                                 f"host-built engine")
        largest[name] = (k7.best[1], k8.best[1])
        k7_calls[name] = [args for args, _ in k7.calls]
        hs, ds_ = idx.stats, dev.stats
        recs.append({
            "index": name, "launches": launches, "adoption": adopted,
            "condensation_levels_with_edges": want_k7,
            "forest_levels": idx.forest.depth,
            "level_nodes": [len(l) for l in idx.forest.level_mbr],
            "largest_bitset_mm": list(k7.best[1][0].shape)
            + [int(k7.best[1][1].shape[1])],
            "largest_seg_mbr": list(k8.best[1][0].shape),
            "bitset_mm_f_wm_m_w_set_bits": [
                [*a.shape, *r.shape, set_bits(ks.bm, a, r)]
                for a, r in k7_calls[name]],
            "host_seconds": {"closure": hs["t_closure"],
                             "forest": hs["t_forest"],
                             "total": hs["t_total"]},
            "device_seconds": {"closure": ds_["t_closure"],
                               "forest": ds_["t_forest"],
                               "total": ds_["t_total"],
                               "wall": dev_s}})
        recs[-1]["gather"] = gather_arm(
            ks, name, g, method, idx, clo.calls[0], want_k7, want_k8,
            us, rects, host_reach)
        built[name] = dev
        del deng
    emit("device_build", ok=True, indexes=recs)
    return recs, largest, built, k7_calls


CLOSURE_REPEATS = 3


def gather_arm(ks, name, g, method, idx, clo_call, want_k7, want_k8, us,
               rects, host_reach):
    """The device closure's gather arm (``kernel="gather"``, the
    reference's ``kernel="xla"``) beside K7's on one index: both arms'
    bits equal to ``closure_np``'s on the build's own closure inputs, the
    gather arm launching no kernel; ``build_index(...,
    device_kernel="gather")`` equal to the host build and adopted by an
    engine that answers as the host-built one (its K8 launches and its 0
    K7 counted); each arm's closure seconds (median of CLOSURE_REPEATS
    after a warm-up; host clock, the bits read back) and aten ops a
    level step (``repro_torch.analysis.OpStats`` over one more call)."""
    import torch
    from repro_torch.analysis.op_stats import OpStats
    from repro_torch.core import QueryEngine, build_index
    from repro_torch.core.engine import UPLOAD_COUNTERS
    from repro_torch.core.reachability import closure_bitset_mm, closure_np

    args, kw = clo_call
    extra = kw["extra_vertex_comp"]
    want = closure_np(*args, extra_vertex_comp=extra)
    rec = {"level_steps": want_k7}
    for arm in ("bitset_mm", "gather"):
        def call():
            return closure_bitset_mm(*args, extra_vertex_comp=extra,
                                     kernel=arm, device=DEVICE)
        ks.reset()
        got = call()                                       # warm-up
        launched = ks.counts()
        if not (np.array_equal(got.bits, want.bits)
                and np.array_equal(got.interior_row, want.interior_row)):
            raise AssertionError(f"{name}: closure kernel={arm} bits != "
                                 f"closure_np")
        expect = {**dict.fromkeys(KERNELS, 0),
                  "bitset_mm": want_k7 if arm == "bitset_mm" else 0}
        if launched != expect:
            raise AssertionError(f"{name}: closure kernel={arm} launched "
                                 f"{launched}, expected {expect}")
        secs = []
        for _ in range(CLOSURE_REPEATS):
            t0 = time.perf_counter()
            call()
            secs.append(time.perf_counter() - t0)
        with OpStats() as st:
            call()
        rec[arm] = {"closure_seconds": secs,
                    "closure_seconds_median": float(np.median(secs)),
                    "aten_ops": st.n_ops,
                    "aten_ops_per_level": st.n_ops / max(want_k7, 1)}
    ks.reset()
    dev = build_index(g, method, backend="device", device_kernel="gather",
                      device=DEVICE)
    launches = ks.counts()
    expect = {**dict.fromkeys(KERNELS, 0), "seg_mbr": want_k8}
    if launches != expect:
        raise AssertionError(f"{name}: gather build launches {launches}, "
                             f"expected {expect}")
    if not same_index(idx, dev) or dev.stats["closure_kernel"] != "gather":
        raise AssertionError(f"{name}: gather device build != host build")
    before = dict(UPLOAD_COUNTERS)
    deng = QueryEngine(dev, device=DEVICE)
    adopted = {k: UPLOAD_COUNTERS[k] - before[k] for k in before}
    if adopted != {"host_uploads": 0, "device_adoptions": 1}:
        raise AssertionError(f"{name}: gather build not adopted: "
                             f"{adopted}")
    got = np.concatenate([deng.query_batch(us[s:s + BATCH],
                                           rects[s:s + BATCH])
                          for s in range(0, len(us), BATCH)])
    if not np.array_equal(got, host_reach):
        raise AssertionError(f"{name}: gather-built engine answers != "
                             f"host-built engine")
    del deng, dev
    torch.cuda.empty_cache()
    rec.update(build_launches=launches, adoption=adopted,
               faster_arm=min(("bitset_mm", "gather"), key=lambda a: rec[
                   a]["closure_seconds_median"]))
    return rec


def set_bits(bm, a, r):
    """Set bits of A at its first ``m`` columns, the ones K7 reads."""
    return int(bm.unpack_bits(a, r.shape[0]).sum())


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

# device cycles (about 20 ms) that the stream spins before an event-timed
# window, so that the host queues the window's calls ahead of the device
QUEUE_SPIN_CYCLES = 40_000_000


def event_ms(fn, iters):
    """Milliseconds per call between CUDA events around back-to-back
    calls, queued behind a spin of the stream (``torch.cuda._sleep``):
    the device's time for the calls and the gaps between them while the
    host keeps ahead, the host's launch rate where the calls take longer
    to queue than the spin lasts."""
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# the profiler's retries, what it left without whole device rows on
# every try, and the device events of each timed window: the "timers"
# line
TIMERS = {"profiler_retries": 0, "by_events": [], "windows": []}
PROFILER_TRIES = 3


def device_rows(fn, iters):
    """torch.profiler over ``iters`` calls: (name, count, device µs) of
    every kernel and copy the device ran (device rows only, so an
    operator and the kernel it launched are not both counted).  Each
    call runs the same device operations, so a row whose count is not a
    multiple of ``iters`` means the profiler lost events; such a window,
    or one with no device rows, is profiled again, up to
    ``PROFILER_TRIES`` times, and ``[]`` is returned after that."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows and all(c % iters == 0 for _, c, _ in rows):
            TIMERS["profiler_retries"] += attempt
            return sorted(rows, key=lambda r: -r[2])
    return []


def device_ms(fn, iters, what):
    """Device milliseconds per call from the profiler.  Where it gave no
    whole device rows in any try, CUDA events around the same calls time
    them instead (``event_ms``: the device's time while the host keeps
    ahead of it, else the launch rate), and ``what`` is listed under
    ``by_events`` on the "timers" line."""
    rows = device_rows(fn, iters)
    TIMERS["windows"].append({"what": what, "iters": iters, "rows": [
        [k[:40], c, round(t, 3)] for k, c, t in rows]})
    if rows:
        return sum(t for _, _, t in rows) / iters / 1e3
    TIMERS["by_events"].append(what)
    return event_ms(fn, iters)


def slice_spans(qs, qe, width):
    """Per query, the blocks of ``width`` entries its arena slice
    [qs, qe) overlaps (0 for an empty slice)."""
    import torch

    s, e = qs.long(), qe.long()
    last = (e - 1).clamp(min=0)
    return torch.where(e > s, last // width - s // width + 1, 0)


def scan_work(ck, cnt, qs, qe, K):
    """What scanning the live slots of these candidate lists needs: the
    distinct leaf tiles, the live slots, and per query the entries of
    its slice in the tiles its query tile scans."""
    import torch
    from repro_torch.kernels.range_query.layout import TB, TP

    ck = ck.long()
    live = (torch.arange(ck.shape[1], device=ck.device)[None, :]
            < cnt.clamp(max=K)[:, None])
    tiles = int(torch.unique(ck[live]).numel())
    t0 = ck[:, None, :] * TP                                   # (nb, 1, k)
    lo = torch.maximum(t0, qs.long().reshape(-1, TB)[:, :, None])
    hi = torch.minimum(t0 + TP, qe.long().reshape(-1, TB)[:, :, None])
    in_slice = int(((hi - lo).clamp(min=0) * live[:, None, :]).sum())
    return tiles, int(live.sum()), in_slice


def reach_work(ck, cnt, esoa, rsoa, qs, qe):
    """What a reach scan of these candidate lists needs.  ``out[b]`` is
    an OR, so a query needs the entries of its slice in its query tile's
    live tiles, in the ascending order of the worklist, only up to and
    including its first hit (all of them where it misses).  Returns the
    distinct tiles those entries lie in, the needed entries, and the
    queries with a hit."""
    import torch
    from repro_torch.kernels.range_query.descent import tile_hits
    from repro_torch.kernels.range_query.layout import TB, TP

    nb, K = ck.shape
    hit, g = tile_hits(ck, esoa, rsoa, qs, qe)           # (nb, TB, K*TP)
    live = (torch.arange(K, device=ck.device)[None, :]
            < cnt.clamp(max=K)[:, None]).repeat_interleave(TP, dim=1)
    s = qs.long().reshape(nb, TB, 1)
    e = qe.long().reshape(nb, TB, 1)
    scanned = (g[:, None, :] >= s) & (g[:, None, :] < e) & live[:, None, :]
    hit = hit & live[:, None, :]
    h = hit.to(torch.int32)
    need = scanned & (torch.cumsum(h, dim=2) - h == 0)   # no hit before
    tiles = need.reshape(nb, TB, K, TP).any(dim=3).any(dim=1)   # (nb, K)
    return (int(torch.unique(ck.long()[tiles]).numel()), int(need.sum()),
            int(hit.any(dim=2).sum()))


def box_hits(ds, ck, cnt, esoa, rsoa, qs, qe):
    """Entries of each query's slice, in the live slots of its query
    tile's candidate list, that pass its bbox test."""
    import torch
    from repro_torch.kernels.range_query.layout import TP

    hit, _ = ds.tile_hits(ck, esoa, rsoa, qs, qe)
    K = ck.shape[1]
    live = (torch.arange(K, device=ck.device)[None, :]
            < cnt.clamp(max=K)[:, None]).repeat_interleave(TP, dim=1)
    return int((hit & live[:, None, :]).sum())


def bound(nbytes, int_cmp, f32_cmp, f32_fma=0, **terms):
    """The larger of the byte time and the operation time, and which."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = (int_cmp / I32_CMP_PER_S + f32_cmp / F32_CMP_PER_S
             + f32_fma / F32_FMA_PER_S) * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations",
            {"bytes": int(nbytes), "int_compares": int(int_cmp),
             "f32_compares": int(f32_cmp), "f32_fmas": int(f32_fma),
             "byte_ms": byte_ms, "op_ms": op_ms, **terms})


def span_planes(qs, qe, limit):
    """The distinct leaf tiles (below ``limit``) and coarse groups inside
    the batch's slice spans (``layout.slice_tile_spans``): the only part
    of the pyramid planes a prune needs, since every other tile fails the
    slice test of every query."""
    from repro_torch.kernels.range_query.layout import (
        COARSE_GROUP,
        slice_tile_spans,
    )

    cover = np.zeros(limit, bool)
    for iv in slice_tile_spans(qs.cpu().numpy(), qe.cpu().numpy(), limit):
        for lo, hi in iv:
            cover[lo:hi] = True
    tiles = np.flatnonzero(cover)
    return len(tiles), len(np.unique(tiles // COARSE_GROUP))


def kernel_bound(fs, args, nt, kcap, mode):
    """K1's least time on these inputs.  Bytes: the pyramid planes within
    the batch's slice spans (``span_planes``: 8 bytes of int16 codes per
    leaf tile, 16 of int32 per coarse group), the distinct leaf tiles its
    worklists scan (2 KB each, +512 B of ids in collect) and the query
    inputs read once, the outputs written once.
    Operations: per query, 4 integer compares for each fine tile and for
    each coarse group that its arena slice [qs, qe) overlaps (the slice
    range itself costs O(1)), and 4 float32 compares for each entry of
    its slice in the tiles its query tile scans.  In reach mode a query
    needs those entries only up to its first hit (``reach_work``), and
    the tiles only where they hold such entries; the bound over the
    whole worklists is kept beside it (``whole_worklists``)."""
    from repro_torch.kernels.range_query.layout import COARSE_GROUP, TP

    qf, qc, ent, ids, r16, r32, rsoa, qs, qe = args
    B = rsoa.shape[1]
    mask = fs.quantized_prune_mask(qf, qc, r16, r32, qs, qe)
    cand, cnt = fs.compact_ascending(mask, nt)
    k = min(kcap, nt)
    tiles, scanned, in_slice = scan_work(cand[:, :k], cnt, qs, qe, kcap)
    tile_b = 4 * TP * 4 + (TP * 4 if mode == "collect" else 0)
    out_b = B * kcap * TP * 4 if mode == "collect" else B * 4
    fine_tiles, groups = span_planes(qs, qe, nt)
    fixed = (fine_tiles * 4 * 2 + groups * 4 * 4
             + B * (4 * 2 + 4 * 4 + 4 * 4 + 4 + 4) + out_b + cnt.numel() * 4)
    int_cmp = 4 * int((slice_spans(qs, qe, TP)
                       + slice_spans(qs, qe, TP * COARSE_GROUP)).sum())
    whole = bound(fixed + tiles * tile_b, int_cmp, 4 * in_slice,
                  distinct_tiles=tiles, scanned_tiles=scanned,
                  scanned_entries=in_slice, span_fine_tiles=fine_tiles,
                  span_coarse_groups=groups)
    if mode != "reach":
        return whole
    tiles, needed, hits = reach_work(cand[:, :k], cnt, ent, rsoa, qs, qe)
    bms, by, work = bound(fixed + tiles * tile_b, int_cmp, 4 * needed,
                          distinct_tiles=tiles, scanned_tiles=scanned,
                          scanned_entries=in_slice, needed_entries=needed,
                          queries_with_hit=hits, span_fine_tiles=fine_tiles,
                          span_coarse_groups=groups)
    return bms, by, dict(work, whole_worklists={"bound_ms": whole[0],
                                                "bound_by": whole[1]})


def prune_bound(fine, coarse, rsoa, qs, qe):
    """K2's least time on these inputs.  Bytes: the float32 fine and
    coarse planes within the batch's slice spans (``span_planes``: 16
    bytes per leaf tile and per coarse group) and the query inputs read
    once, the whole int32 mask written once.  Operations: per query, 4
    float32 compares for each fine tile and each coarse group its slice
    overlaps (no other tile can pass the slice test)."""
    from repro_torch.kernels.range_query.layout import COARSE_GROUP, TB, TP

    B = rsoa.shape[1]
    ntp = fine.shape[1]
    mask_b = (B // TB) * ntp * 4
    fine_tiles, groups = span_planes(qs, qe, ntp)
    nbytes = fine_tiles * 16 + groups * 16 + B * (16 + 8) + mask_b
    f32_cmp = 4 * int((slice_spans(qs, qe, TP)
                       + slice_spans(qs, qe, TP * COARSE_GROUP)).sum())
    return bound(nbytes, 0, f32_cmp, mask_bytes=mask_b,
                 span_fine_tiles=fine_tiles, span_coarse_groups=groups)


def scan_bound(ck, cnt, esoa, rsoa, qs, qe, mode):
    """K3/K4/K5's least time on these inputs.  Bytes: the distinct leaf
    tiles of the live slots (2 KB each, +512 B of ids for collect), the
    candidate lists and query inputs read once, the output written once
    ((B,) int32, or (B, K*128) int32 for collect).  Operations: 4
    float32 compares per entry of each query's slice in the live tiles
    its query tile scans.  In reach mode (K3) a query needs those
    entries only up to its first hit (``reach_work``); the bound over
    the whole worklists is kept beside it (``whole_worklists``)."""
    from repro_torch.kernels.range_query.layout import TP

    B = qs.shape[0]
    K = ck.shape[1]
    tiles, scanned, in_slice = scan_work(ck, cnt, qs, qe, K)
    tile_b = 4 * TP * 4 + (TP * 4 if mode == "collect" else 0)
    out_b = B * K * TP * 4 if mode == "collect" else B * 4
    fixed = ck.numel() * 4 + B * (16 + 8) + out_b
    whole = bound(fixed + tiles * tile_b, 0, 4 * in_slice,
                  distinct_tiles=tiles, scanned_tiles=scanned,
                  scanned_entries=in_slice, out_bytes=out_b)
    if mode != "reach":
        return whole
    tiles, needed, hits = reach_work(ck, cnt, esoa, rsoa, qs, qe)
    bms, by, work = bound(fixed + tiles * tile_b, 0, 4 * needed,
                          distinct_tiles=tiles, scanned_tiles=scanned,
                          scanned_entries=in_slice, needed_entries=needed,
                          queries_with_hit=hits, out_bytes=out_b)
    return bms, by, dict(work, whole_worklists={"bound_ms": whole[0],
                                                "bound_by": whole[1]})


def e2e_us(eng, us, rects, mode, two_phase=False):
    """End-to-end µs per query over 3 passes of the workload."""
    sfx = "_two_phase" if two_phase else ""
    call = {"reach": getattr(eng, f"query_batch{sfx}"),
            "count": getattr(eng, f"count_batch{sfx}"),
            "collect": lambda u, r: getattr(eng, f"collect_batch{sfx}")(
                u, r, COLLECT_K)}[mode]
    t0 = time.perf_counter()
    for rep in range(3):
        for s in range(0, len(us), BATCH):
            call(us[s:s + BATCH], rects[s:s + BATCH])
    return (time.perf_counter() - t0) / (3 * len(us)) * 1e6


def launch_floor_ms():
    """The launch floor: the profiler's device time of a one-element
    ``add_``, timed as the kernels are."""
    import torch

    x = torch.zeros(1, device=DEVICE)
    return device_ms(lambda: x.add_(1), 50, "launch floor (add_, 1 element)")


def time_fused(ks, eng, us, rects, label, e2e=True):
    """K1 on the engine's first main-path batch at its steady capacity,
    every mode: device ms, plain ms (the profiler; CUDA events beside
    them), the bound from these inputs and, with ``e2e``, end-to-end µs
    per query."""
    fs = ks.fs
    args = fused_args(eng, us[:BATCH], rects[:BATCH])
    args = tuple(a.clone() for a in args)
    kcap = min(eng._kb_hwm, eng.n_tiles)
    nt = eng.n_tiles
    per_mode = {}
    for mode in MODES:
        kern = lambda: fs.fused_serve(                      # noqa: E731
            *args, mode=mode, kcap=kcap, nt=nt, device=DEVICE)
        plain = lambda: fs.fused_serve_torch(               # noqa: E731
            *args, mode=mode, kcap=kcap, nt=nt)
        k_dev = device_ms(kern, 50, f"fused_serve ({label} {mode})")
        p_dev = device_ms(plain, 10, f"fused_serve_torch ({label} {mode})")
        k_ev, p_ev = event_ms(kern, 50), event_ms(plain, 10)
        bms, by, work = kernel_bound(fs, args, nt, kcap, mode)
        per_mode[mode] = {
            "ms": k_dev, "plain_ms": p_dev,
            "event_ms": k_ev, "plain_event_ms": p_ev,
            "bound_ms": bms, "bound_by": by, "kcap": kcap, **work}
        if e2e:
            batches0, launches0 = eng.stats["batches"], fs.fused_serve.launches
            per_mode[mode]["e2e_us_per_query"] = e2e_us(eng, us, rects, mode)
            per_mode[mode]["launches_per_batch"] = (
                (fs.fused_serve.launches - launches0)
                / (eng.stats["batches"] - batches0))
    return per_mode, args, kcap


def phase_timing(ks, engines, card):
    from repro_torch.kernels._build import sm_count

    fs, ds = ks.fs, ks.ds
    name = next(iter(engines))           # the first main-path index
    eng, us, rects = engines[name]
    floor = launch_floor_ms()
    per_mode, args, kcap = time_fused(ks, eng, us, rects, name)
    nt = eng.n_tiles
    # the same on the largest index's first batch (yelp x0.5 base)
    big, (beng, bus, brects) = list(engines.items())[-1]
    per_mode_big, _, bkcap = time_fused(ks, beng, bus, brects, big, e2e=False)

    # the two-phase kernels on the same batch, at the steady K
    arena = arena_of(eng)
    rsoa, qs, qe = (a.clone() for a in args[6:])
    K = eng._kb_hwm
    mask = ds.prune_tiles_torch(arena["fine"], arena["coarse"], rsoa, qs, qe)
    cand, cnt = fs.compact_ascending(mask, nt)
    ck = ds.take_candidates(cand, K)
    two = {}
    prune_args = (arena["fine"], arena["coarse"], rsoa, qs, qe)
    bms, by, work = prune_bound(*prune_args)
    two["prune_tiles"] = {
        "ms": device_ms(lambda: ds.prune_tiles(*prune_args, device=DEVICE),
                        50, "prune_tiles"),
        "plain_ms": device_ms(lambda: ds.prune_tiles_torch(*prune_args), 10,
                              "prune_tiles_torch"),
        "bound_ms": bms, "bound_by": by, **work}
    for mode in MODES:
        kname = SCANS[mode]
        a = ((ck, arena["esoa"], arena["ids"], rsoa, qs, qe)
             if mode == "collect" else (ck, arena["esoa"], rsoa, qs, qe))
        bms, by, work = scan_bound(ck, cnt, arena["esoa"], rsoa, qs, qe,
                                   mode)
        two[kname] = {
            "ms": device_ms(lambda: ks.wrap[kname](*a, device=DEVICE), 50,
                            kname),
            "plain_ms": device_ms(lambda: ks.plain[kname](*a), 10,
                                  f"{kname} plain"),
            "bound_ms": bms, "bound_by": by, "K": K, **work}
        if kname == "collect_scan":    # warps per CTA
            two[kname]["warps"] = ks.an.collect_warps(
                BATCH // 8, K, sm_count(DEVICE))
        else:                          # CTAs per query tile
            two[kname]["cluster"] = ks.ds.scan_cluster_size(
                BATCH // 8, K, sm_count(DEVICE))
        two[kname]["e2e_us_per_query"] = e2e_us(eng, us, rects, mode,
                                                two_phase=True)
    # the prune's mask write grows with the arena: the same on the
    # largest index's first batch
    bargs = fused_args(beng, bus[:BATCH], brects[:BATCH])
    bprune = (beng._arena.fine, beng._arena.coarse,
              *(a.clone() for a in bargs[6:]))
    bms, by, work = prune_bound(*bprune)
    two["prune_tiles"]["largest_index"] = {
        "index": big, "n_tiles": beng.n_tiles,
        "ms": device_ms(lambda: ds.prune_tiles(*bprune, device=DEVICE), 50,
                        f"prune_tiles ({big})"),
        "bound_ms": bms, "bound_by": by, **work}
    emit("timing", index=name, B=BATCH, kcap=kcap, K=K, n_tiles=nt,
         query_tiles=BATCH // 8,
         fused_cluster=fs.cluster_size(BATCH // 8, sm_count(DEVICE)),
         card=card, launch_floor_ms=floor, per_mode=per_mode,
         largest_index={"index": big, "n_tiles": beng.n_tiles,
                        "kcap": bkcap, "per_mode": per_mode_big},
         two_phase=two,
         e2e_us_per_query={m: {"fused": per_mode[m]["e2e_us_per_query"],
                               "two_phase": two[SCANS[m]]["e2e_us_per_query"]}
                           for m in MODES})
    for path, query, mode_rec in (
            ("fused", eng.query_batch, per_mode["reach"]),
            ("two_phase", eng.query_batch_two_phase, two["descent_scan"])):
        phase_profile(query, us, rects, mode_rec["e2e_us_per_query"], path,
                      "reach")
    return per_mode, two, floor


def phase_timing_slice3(ks, engines, indexes, largest, k7_calls, card):
    """K6 on the first polygon batch of the first index, K7 on the
    largest closure-product launch of that index's device build and
    summed over every launch of the three device builds
    (``bitset_launch_sums``), K8 on
    the largest segmented-MBR launch of the last index's device build:
    device ms, plain ms, library ms where one PyTorch call computes the
    same function, the bound from these inputs; each kernel also held
    against its plain version on these inputs.  End-to-end µs per
    polygon query."""
    import torch
    from repro_torch.core import engine as core_engine
    from repro_torch.kernels._build import sm_count

    ds, an, fs, bm, fb = ks.ds, ks.an, ks.fs, ks.bm, ks.fb
    timed, errs = {}, {}
    name = next(iter(engines))
    eng, _, _ = engines[name]
    pus, ppolys = indexes[name][4]
    # K6's operands as the engine assembles them for its first batch
    with Capture(core_engine, "polygon_scan", lambda c, *a: c.numel()) as k6:
        eng.polygon_batch(pus[:BATCH], ppolys[:BATCH])
    _, args, kw = k6.best
    a6 = tuple(t.clone() for t in args)     # the engine reuses its buffers
    neb = kw["ne"]
    ck, esoa, rsoa, lines, qs, qe = a6
    errs["polygon_scan"] = _diff(an.polygon_scan(*a6, ne=neb, device=DEVICE),
                                 an.polygon_scan_torch(*a6, ne=neb))
    K = ck.shape[1]
    _, cnt = fs.compact_ascending(
        ds.prune_tiles_torch(eng._arena.fine, eng._arena.coarse, rsoa, qs,
                             qe), eng.n_tiles)
    tiles, scanned, in_slice = scan_work(ck, cnt, qs, qe, K)
    box = box_hits(ds, ck, cnt, esoa, rsoa, qs, qe)
    B = qs.shape[0]
    nbytes = (tiles * 4 * 128 * 4 + ck.numel() * 4 + B * (16 + 8)
              + lines.numel() * 4 + B * 4)
    # the box test on every slice entry; the half-planes (2 mul, add,
    # compare each) only where the box test passed
    f32_ops = in_slice * 4 + box * 4 * POLY_EDGES
    bms, by, work = bound(nbytes, 0, f32_ops, distinct_tiles=tiles,
                          scanned_tiles=scanned, box_hits=box, ne_bucket=neb)
    t0 = time.perf_counter()
    for rep in range(3):
        for s in range(0, len(pus), BATCH):
            eng.polygon_batch(pus[s:s + BATCH], ppolys[s:s + BATCH])
    e2e = (time.perf_counter() - t0) / (3 * len(pus)) * 1e6
    timed["polygon_scan"] = {
        "ms": device_ms(lambda: an.polygon_scan(*a6, ne=neb, device=DEVICE),
                        50, "polygon_scan"),
        "plain_ms": device_ms(lambda: an.polygon_scan_torch(*a6, ne=neb), 10,
                              "polygon_scan_torch"),
        "library_ms": None, "bound_ms": bms, "bound_by": by, "K": K,
        "cluster": an.scan_cluster_size(B // 8, K, sm_count(DEVICE)),
        "e2e_us_per_query": e2e, **work}

    a, r = largest[name][0]
    m, W = r.shape
    errs["bitset_mm"] = _diff(bm.bitset_mm(a, r, device=DEVICE),
                              bm.bitset_mm_torch(a, r))
    ab = bm.unpack_bits(a, m).to(torch.bfloat16)
    rb = bm.unpack_bits(r, W * 32).to(torch.bfloat16)
    bms, by, work = bitset_bound(bm, a, r)
    timed["bitset_mm"] = {
        "ms": device_ms(lambda: bm.bitset_mm(a, r, device=DEVICE), 50,
                        "bitset_mm"),
        "plain_ms": device_ms(lambda: bm.bitset_mm_torch(a, r), 10,
                              "bitset_mm_torch"),
        "library_ms": device_ms(lambda: torch.matmul(ab, rb), 10,
                                "torch.matmul bf16"),
        "library_note": "torch.matmul of the unpacked bf16 operands, "
                        "excluding unpack and pack",
        "bound_ms": bms, "bound_by": by, "index": name, **work,
        "launch_sums": bitset_launch_sums(bm, k7_calls)}

    last = list(engines)[-1]
    (c,) = largest[last][1]
    fan = c.shape[0] // 4
    n = c.shape[1]
    errs["seg_mbr"] = _diff(fb.seg_mbr(c, dim=2, fan=fan, device=DEVICE),
                            fb.seg_mbr_torch(c, dim=2, fan=fan))
    cv = c.view(fan, 4, n)
    bms, by, work = bound((fan + 1) * 4 * n * 4, 0, 0, fan=fan, nodes=n)
    timed["seg_mbr"] = {
        "ms": device_ms(lambda: fb.seg_mbr(c, dim=2, fan=fan, device=DEVICE),
                        50, "seg_mbr"),
        "plain_ms": device_ms(lambda: fb.seg_mbr_torch(c, dim=2, fan=fan), 10,
                              "seg_mbr_torch"),
        "library_ms": device_ms(
            lambda: (torch.amin(cv[:, :2], 0), torch.amax(cv[:, 2:], 0)), 10,
            "torch.amin + torch.amax"),
        "library_note": "torch.amin plus torch.amax over the (fan, 2*dim, "
                        "N) view: two calls",
        "bound_ms": bms, "bound_by": by, "index": last, **work}
    for k, e in errs.items():
        if e:
            raise AssertionError(f"{k} kernel != plain version on the main "
                                 f"path's operands")
    emit("timing_slice3", card=card, B=BATCH, kernels=timed,
         polygon_e2e_us_per_query=e2e, max_abs_err=errs)
    phase_profile(eng.polygon_batch, pus, ppolys, e2e, "two_phase", "polygon")
    return timed, errs


def bitset_bound(bm, a, r):
    """K7's least time on these operands: the bytes of A, R and out,
    against one integer OR per set bit of A and output word."""
    f, Wm = a.shape
    m, W = r.shape
    bits = set_bits(bm, a, r)
    nbytes = (a.numel() + r.numel() + f * W) * 4
    return bound(nbytes, bits * W, 0, set_bits_of_a=bits,
                 shape_f_wm_m_w=[f, Wm, m, W])


def bitset_launch_sums(bm, calls):
    """K7 summed over its launches, per index and in all: each distinct
    (f, Wm, m, W) timed once, on its first launch's operands; each
    launch's bound from its own operands.  Also the largest launch
    (f * W) of each index."""
    ms, rec = {}, {}
    for name, launches in calls.items():
        rows = []
        for a, r in launches:
            key = (*a.shape, *r.shape)
            if key not in ms:
                ms[key] = device_ms(
                    lambda a=a, r=r: bm.bitset_mm(a, r, device=DEVICE), 20,
                    f"bitset_mm {list(key)}")
            bms, _, work = bitset_bound(bm, a, r)
            rows.append([*key, work["set_bits_of_a"], ms[key], bms])
        big = max(rows, key=lambda x: x[0] * x[3]) if rows else None
        rec[name] = {"launches": len(rows),
                     "ms": sum(x[5] for x in rows),
                     "bound_ms": sum(x[6] for x in rows),
                     "largest_f_wm_m_w_bits_ms_bound": big,
                     "f_wm_m_w_bits_ms_bound": rows}
    rec["all"] = {k: sum(v[k] for v in rec.values())
                  for k in ("launches", "ms", "bound_ms")}
    rec["all"]["distinct_shapes"] = len(ms)
    return rec


def same_operands(a, b):
    """The same operands, value for value: slices and rects compared
    first, the planes last."""
    return all(x.shape == y.shape and bool((x == y).all())
               for x, y in zip(a[::-1], b[::-1]))


def range_query_launch_sums(ls, calls):
    """K9 summed over its launches, per leaf-scan path and in all: a
    launch whose operands equal an earlier one's (a device-built
    index's batch and the host-built index's) is timed once; each
    distinct one's bound from its own operands."""
    timed, rec = [], {}
    for path, launches in calls.items():
        tot = [0.0, 0.0]
        for args, dim in launches:
            one = next((t for t in timed
                        if t[1] == dim and same_operands(t[0], args)), None)
            if one is None:
                ms = device_ms(
                    lambda args=args, dim=dim: ls.range_query(
                        *args, dim=dim, device=DEVICE), 20,
                    f"range_query ({path}, launch {len(timed)})")
                one = (args, dim, ms, range_query_bound(args, dim)[0])
                timed.append(one)
            tot[0] += one[2]
            tot[1] += one[3]
        rec[path] = {"launches": len(launches), "ms": tot[0],
                     "bound_ms": tot[1]}
    rec["all"] = {k: sum(v[k] for v in rec.values())
                  for k in ("launches", "ms", "bound_ms")}
    rec["all"]["distinct_operands"] = len(timed)
    return rec


def range_query_bound(args, dim):
    """K9's least time on these inputs.  ``out[b]`` is an OR, so a query
    needs the entries of its slice up to and including its first hit,
    or its whole slice where it misses.  Bytes: the distinct entries
    those prefixes cover (2*dim float32 each), the rects and slices read
    once, the (B,) int32 output written once.  Operations: 2*dim float32
    compares per needed entry per query."""
    import torch

    esoa, rsoa, qs, qe = args
    P, B = esoa.shape[1], qs.shape[0]
    dev = esoa.device
    s, e = qs.long().clamp(0, P), qe.long().clamp(0, P)
    n = (e - s).clamp(min=0)
    live = n > 0
    # every (query, slice entry) pair, flat
    q = torch.repeat_interleave(torch.arange(B, device=dev), n)
    start = torch.cumsum(n, 0) - n
    pos = s[q] + torch.arange(q.numel(), device=dev) - start[q]
    hit = torch.ones_like(q, dtype=torch.bool)
    for a in range(dim):
        hit &= (esoa[a, pos] <= rsoa[dim + a, q]) \
            & (esoa[dim + a, pos] >= rsoa[a, q])
    first = torch.full((B,), P, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, q[hit], pos[hit], "amin")
    hits = first < e
    need = torch.where(hits, first - s + 1, n)
    cov = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    cov.index_add_(0, s[live], torch.ones_like(s[live]))
    cov.index_add_(0, (s + need)[live], -torch.ones_like(s[live]))
    distinct = int((cov.cumsum(0)[:P] > 0).sum())
    needed = int(need.sum())
    nbytes = distinct * 2 * dim * 4 + B * (2 * dim * 4 + 8) + B * 4
    return bound(nbytes, 0, 2 * dim * needed, distinct_entries=distinct,
                 needed_entries=needed, slice_entries=int(n.sum()),
                 queries_with_slice=int(live.sum()),
                 queries_with_hit=int(hits.sum()))


def passes_us(fn, n):
    """End-to-end µs per query over 3 calls of ``fn``, each serving
    ``n`` queries."""
    t0 = time.perf_counter()
    for rep in range(3):
        fn()
    return (time.perf_counter() - t0) / (3 * n) * 1e6


def range_query_cases(ops):
    """K9's four timed operand sets: the first leaf-scan batch of the
    first and the last index (``ops``: yelp x1.0 comp and x0.5 base),
    and a random arena of the comp arena's size (seed 4) whose 256
    queries probe distinct, mostly missed slices, at dims 2 and 3."""
    import torch

    first, last = next(iter(ops)), list(ops)[-1]
    rng = np.random.default_rng(4)
    cases = {name: ops[name] for name in (first, last)}
    for dim in (2, 3):
        cases[f"random {ARENAS[0][0]} tiles dim {dim}"] = (leafscan_case(
            rng, ARENAS[0][0], ARENAS[0][1], dim, BATCH,
            torch.device(DEVICE)), dim)
    return cases


def time_range_query(ks, cases):
    """K9 on each case, held against its plain version first: device
    ms, the plain version's ms and the bound from these inputs."""
    ls = ks.ls
    timed = {}
    for name, (args, dim) in cases.items():
        compare_range_query(ks, args, dim, f"{name} timing operands")
        bms, by, work = range_query_bound(args, dim)
        timed[name] = {
            "ms": device_ms(lambda: ls.range_query(*args, dim=dim,
                                                   device=DEVICE), 50,
                            f"range_query ({name})"),
            "plain_ms": device_ms(lambda: ls.range_query_torch(*args,
                                                               dim=dim), 5,
                                  f"range_query_torch ({name})"),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "operands": name, "dim": dim, **work}
    return timed


def phase_timing_slice4(ks, engines, indexes, ops, k9_calls, card):
    """K9 on ``range_query_cases``: device ms, plain ms, the bound from
    these inputs (no single PyTorch call computes a masked segmented
    any); each also held against its plain version.  K9 summed over
    every launch of the leaf-scan engine's main paths
    (``range_query_launch_sums``).  End-to-end µs per query of the
    leaf-scan, wavefront and fused engines on every main-path index, and
    the device's busy share of a leaf-scan and a wavefront pass."""
    from repro_torch.core import query_wavefront

    ls = ks.ls
    first = next(iter(engines))
    timed = time_range_query(ks, range_query_cases(ops))
    sums = range_query_launch_sums(ls, k9_calls)
    e2e = {}
    for name, (g, method, idx, _, _) in indexes.items():
        eng, us, rects = engines[name]
        e2e[name] = {
            "fused": e2e_us(eng, us, rects, "reach"),
            "leafscan": passes_us(lambda: leafscan_pass(ls, idx, us, rects),
                                  len(us)),
            "wavefront": passes_us(lambda: wavefront_pass(idx, us, rects),
                                   len(us))}
    emit("timing_slice4", card=card, B=BATCH, range_query=timed,
         launch_sums=sums, e2e_us_per_query=e2e)
    idx = indexes[first][2]
    _, us, rects = engines[first]
    phase_profile(lambda u, r: ls.range_query_forest(
        idx.forest, idx.lookup_tree(u), r), us, rects,
        e2e[first]["leafscan"], "leafscan", "reach")
    phase_profile(lambda u, r: query_wavefront(
        idx.forest, idx.lookup_tree(u), r, capacity=WAVEFRONT_CAPACITY),
        us, rects, e2e[first]["wavefront"], "wavefront", "reach")
    return timed, sums


def phase_profile(query, us, regions, e2e_us_per_query, path, mode):
    """Where a batch's time goes: device time by operation over one pass
    of the workload through ``query(us, regions)``, and the device's busy
    share of the unprofiled end-to-end time."""
    n_batches = len(range(0, len(us), BATCH))

    def one_pass():
        for s in range(0, len(us), BATCH):
            query(us[s:s + BATCH], regions[s:s + BATCH])

    rows = device_rows(one_pass, 1)
    if not rows:
        emit("profile", path=path, device_time="not measured: the profiler "
             "saw no device activity")
        return
    busy_us = sum(t for _, _, t in rows) / n_batches
    e2e_batch_us = e2e_us_per_query * BATCH
    emit("profile", path=path, mode=mode, B=BATCH,
         device_ops_per_batch=sum(c for _, c, _ in rows) / n_batches,
         device_busy_us_per_batch=busy_us,
         e2e_us_per_batch=e2e_batch_us,
         device_busy_share=busy_us / e2e_batch_us,
         top=[{"op": k[:60], "calls_per_batch": c / n_batches,
               "us_per_batch": t / n_batches} for k, c, t in rows[:8]])


# --------------------------------------------------------------------------
# The recsys serving path: DIN and the EmbeddingBag op (K10)
# --------------------------------------------------------------------------

def din_inputs(batch, device):
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def bag_inputs(batch):
    """A DIN batch's histories as EmbeddingBag bags: each row's items up
    to its length (``hist_mask`` is a prefix of each row)."""
    mask = batch["hist_mask"]
    offsets = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int64)
    return batch["hist_items"][mask], offsets


def busy_us(fn, iters):
    """The device's busy µs per call of ``fn`` (profiler rows summed) and
    its five largest device operations per call."""
    rows = device_rows(fn, iters)
    top = [{"op": k[:60], "calls": c / iters, "us": t / iters}
           for k, c, t in rows[:5]]
    return {"device_busy_us_per_batch": (sum(t for _, _, t in rows) / iters
                                         if rows else None),
            "device_top": top}


def serve_shape(ks, shape, params, cpu_params, cfg, batch):
    """One serve shape through ``din.apply`` on the card: logits of the
    right shape and finite, the first BAG_CHECK_ROWS rows (all of a
    smaller batch) equal to ``apply`` on the CPU with the same
    parameters within DIN_TOL, and the loss too where the batch has
    labels.  Every kernel count is reset just before and read just
    after: ``apply`` pools the history by target attention, as the
    reference does, and launches no kernel of the port.  End-to-end µs
    per batch (host clock: upload, apply, logits back) and the device's
    busy µs per batch."""
    import torch
    from repro_torch.models.recsys import din

    dev = torch.device(DEVICE)
    B = len(batch["target_item"])

    def serve():
        return din.apply(params, din_inputs(batch, dev), cfg).cpu()

    torch.cuda.reset_peak_memory_stats()
    ks.reset()
    logits = serve()
    launches = ks.counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B,) or not torch.isfinite(logits).all():
        raise AssertionError(f"{shape}: logits not finite or of shape "
                             f"{tuple(logits.shape)}")
    sub = {k: v[:BAG_CHECK_ROWS] for k, v in batch.items()}
    cpu_sub = din_inputs(sub, "cpu")
    err = float((logits[:BAG_CHECK_ROWS]
                 - din.apply(cpu_params, cpu_sub, cfg)).abs().max())
    loss_err = float(abs(din.loss_fn(params, din_inputs(sub, dev), cfg).cpu()
                         - din.loss_fn(cpu_params, cpu_sub, cfg)))
    if not (err <= DIN_TOL and loss_err <= DIN_TOL):
        raise AssertionError(f"{shape}: card != CPU (logits {err}, loss "
                             f"{loss_err})")
    reps = 20 if B <= 4096 else 3
    t0 = time.perf_counter()
    for _ in range(reps):
        serve()
    e2e = (time.perf_counter() - t0) / reps * 1e6
    return {"shape": shape, "B": B, "seq_len": cfg.seq_len,
            "checked_rows": len(sub["target_item"]), "max_abs_err": err,
            "loss_abs_err": loss_err, "launches": launches,
            "max_memory_allocated": int(peak), "e2e_us_per_batch": e2e,
            **busy_us(serve, 1 if B > 4096 else 5),
            "logit_mean": float(logits.mean())}


def retrieval_shape(ks, params, cpu_params, cfg):
    """retrieval_cand through ``din.score_candidates`` on the card: one
    user against round_up(1e6, 8192) random candidates; scores finite,
    the first two chunks equal to the CPU within DIN_TOL; counts reset
    just before and read just after; end-to-end µs and busy µs."""
    import torch
    from repro_torch.configs.base import RECSYS_SHAPES, round_up
    from repro_torch.data import din_batches
    from repro_torch.models.recsys import din

    dev = torch.device(DEVICE)
    chunk = 8192
    C = round_up(RECSYS_SHAPES["retrieval_cand"]["n_candidates"], chunk)
    user = next(din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, 1,
                            seed=2))
    batch = {"hist_items": user["hist_items"][0],
             "hist_mask": user["hist_mask"][0],
             "candidates": np.random.default_rng(2).integers(
                 0, cfg.n_items, C).astype(np.int32)}

    def score():
        return din.score_candidates(params, din_inputs(batch, dev), cfg,
                                    chunk=chunk).cpu()

    ks.reset()
    scores = score()
    launches = ks.counts()
    if tuple(scores.shape) != (C,) or not torch.isfinite(scores).all():
        raise AssertionError("retrieval_cand: scores not finite or of shape "
                             f"{tuple(scores.shape)}")
    sub = dict(batch, candidates=batch["candidates"][:2 * chunk])
    want = din.score_candidates(cpu_params, din_inputs(sub, "cpu"), cfg,
                                chunk=chunk)
    err = float((scores[:2 * chunk] - want).abs().max())
    if not err <= DIN_TOL:
        raise AssertionError(f"retrieval_cand: card != CPU ({err})")
    t0 = time.perf_counter()
    for _ in range(3):
        score()
    e2e = (time.perf_counter() - t0) / 3 * 1e6
    return {"shape": "retrieval_cand", "candidates": C, "chunk": chunk,
            "checked_candidates": 2 * chunk, "max_abs_err": err,
            "launches": launches, "e2e_us_per_batch": e2e,
            **busy_us(score, 1)}


def bag_path(ks, table, batch, mode):
    """K10 through ``embedding_bag`` over DIN's item table, the batch's
    histories as bags: the counts reset just before and read just after
    (one launch of K10, no other kernel), the result held against the
    plain version on the card on the same packed operands (and the same
    mean division) within BAG_TOL.  Returns the record and the packed
    operands."""
    import torch

    sb = ks.sb
    dev = torch.device(DEVICE)
    idx, offsets = bag_inputs(batch)
    B = len(offsets) - 1
    ks.reset()
    got = sb.embedding_bag(table, idx, offsets, mode)
    launches = ks.counts()
    ops = (table, *(torch.as_tensor(a, device=dev)
                    for a in sb.pack_bags(idx, offsets)))
    want = sb.segment_bag_torch(*ops, n_segments=B)
    if mode == "mean":
        cnt = np.maximum(np.diff(offsets), 1).astype(np.float32)
        want = want / torch.as_tensor(cnt, device=dev)[:, None]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    others = {k: n for k, n in launches.items() if k != "segment_bag" and n}
    if launches["segment_bag"] != 1 or others:
        raise AssertionError(f"embedding_bag B={B} {mode}: launches "
                             f"{launches}, expected one of segment_bag")
    if tuple(got.shape) != (B, table.shape[1]) or not err <= BAG_TOL:
        raise AssertionError(f"embedding_bag B={B} {mode}: kernel != plain "
                             f"version ({err})")
    return {"B": B, "mode": mode, "lookups": len(idx),
            "launches": launches["segment_bag"], "max_abs_err": err}, ops


def segment_bag_timing(sb, ops, offsets_np, B):
    """K10 on the packed operands of a serve batch's bags (sum): device
    ms, plain ms, ``F.embedding_bag`` with the same indices and
    per-sample weights (one PyTorch call for the same function, held
    equal within BAG_TOL first), and the bound from these inputs."""
    import torch
    import torch.nn.functional as F

    table, idx, seg, w = ops
    L = int(offsets_np[-1])
    D = table.shape[1]
    starts = torch.as_tensor(offsets_np[:-1].astype(np.int32),
                             device=table.device)
    kern = lambda: sb.segment_bag(*ops, n_segments=B, device=DEVICE)  # noqa
    lib = lambda: F.embedding_bag(idx[:L], table, starts,  # noqa: E731
                                  mode="sum", per_sample_weights=w[:L])
    lib_err = float((kern() - lib()).abs().max())
    if not lib_err <= BAG_TOL:
        raise AssertionError(f"F.embedding_bag != K10 ({lib_err}): not the "
                             f"same function")
    rows = int(torch.unique(idx[:L]).numel())
    nbytes = rows * D * table.element_size() + 12 * idx.numel() + B * D * 4
    # the 32-byte sectors the gather touches, each lookup's row at its
    # own address: what it moves through L2, whatever the bound counts
    row_bytes = D * table.element_size()
    start = table.data_ptr() + idx[:L].long() * row_bytes
    sectors = int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())
    bms, by, work = bound(nbytes, 0, 0, f32_fma=L * D, lookups=L,
                          padded_lookups=int(idx.numel()), distinct_rows=rows,
                          bags=B, D=D, gather_sector_bytes=32 * sectors,
                          gather_sector_ms=32 * sectors / HBM_BYTES_PER_S
                          * 1e3)
    return {"ms": device_ms(kern, 20, f"segment_bag (B={B})"),
            "plain_ms": device_ms(
                lambda: sb.segment_bag_torch(*ops, n_segments=B), 5,
                f"segment_bag_torch (B={B})"),
            "library_ms": device_ms(lib, 20, f"F.embedding_bag (B={B})"),
            "library_note": "F.embedding_bag(mode='sum', "
                            "per_sample_weights=w) on the same indices",
            "library_max_abs_diff": lib_err,
            "bound_ms": bms, "bound_by": by, **work}


def din_setup():
    """DIN at its published widths (configs.din.make_config()) with
    float32 products in full precision (no TF32): the config, the
    parameters from a torch.Generator seed on the card and on the CPU,
    and one ``din_batches`` batch per serve shape."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import din_batches
    from repro_torch.models.recsys import din

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_arch("din").make_config()
    params = din.init_params(torch.Generator().manual_seed(0), cfg)
    cpu_params = din.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    batches = {shape: next(din_batches(
        cfg.n_items, cfg.n_cates, cfg.seq_len,
        RECSYS_SHAPES[shape]["batch"], seed=seed))
        for seed, shape in enumerate(("serve_p99", "serve_bulk"))}
    return cfg, params, cpu_params, batches


def phase_recsys(ks, card):
    """DIN at its published widths (configs.din.make_config()) on the
    card, parameters from a torch.Generator seed, batches from
    ``din_batches``: serve_p99 and serve_bulk through ``apply``,
    retrieval_cand through ``score_candidates``; then K10 through
    ``embedding_bag`` over DIN's item table with the serve batches'
    histories as bags, sum and mean, and K10 timed on serve_bulk's
    bags.  float32 products in full precision (no TF32)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.nn import count_params, param_bytes

    t0 = time.perf_counter()
    spec = get_arch("din")
    cfg, params, cpu_params, batches = din_setup()
    shapes = [serve_shape(ks, shape, params, cpu_params, cfg, batch)
              for shape, batch in batches.items()]
    shapes.append(retrieval_shape(ks, params, cpu_params, cfg))
    bags, per_path, err, timed = [], {}, 0.0, {}
    table = params["item_emb"]["emb"]
    for shape, batch in batches.items():
        for mode in ("sum", "mean"):
            rec, ops = bag_path(ks, table, batch, mode)
            bags.append(dict(rec, shape=shape))
            per_path[f"din {shape} bags {mode}"] = rec["launches"]
            err = max(err, rec["max_abs_err"])
            if mode == "sum":
                timed[shape] = segment_bag_timing(
                    ks.sb, ops, bag_inputs(batch)[1], rec["B"])
    emit("recsys", ok=True, card=card, config=dataclasses.asdict(cfg),
         params=count_params(params), param_bytes=param_bytes(params),
         cells=list(spec.cells), shapes=shapes, bags=bags,
         bag_max_abs_err=err, tolerances={"din": DIN_TOL, "bags": BAG_TOL},
         segment_bag=timed, tf32=torch.backends.cuda.matmul.allow_tf32,
         seconds=round(time.perf_counter() - t0, 3))
    return per_path, err, timed["serve_bulk"]


# --------------------------------------------------------------------------
# Serving launcher and the remaining benches; DIN's train step
# --------------------------------------------------------------------------

# the launcher at phase main's scale, cluster arm, Zipf traffic, obs on
SERVE_CONFIG = ("yelp", 1.0, "2dreach-comp")
SERVE_ARGS = ("--engine", "cluster", "--zipf", "1.2", "--obs",
              "--audit-sample", "0.05")
SERVE_ARMS = ("device", "kernel", "wavefront")   # over phase main's engines
SERVE_KNN = ("yelp", 0.1, 1024)                  # --query-class knn
TRAIN_WARMUP = 3
TRAIN_STEPS = 5
TRAIN_CHECK_ROWS = 512     # the slice of the batch held against the CPU
TRAIN_TOL = 1e-4           # parameters and moments, relative in norm
TRAIN_LOSS_TOL = 1e-5      # the loss, relative


def served_launches(ks, fn):
    """``fn()`` with the kernel counts set to 0 just before and read just
    after: its result and the kernels it launched."""
    ks.reset()
    out = fn()
    return out, {k: n for k, n in ks.counts().items() if n}


def phase_serve(ks, engines, indexes):
    """The port's serving launcher (``repro_torch.launch.serve``) at phase
    main's scale on the cluster arm with Zipf traffic, obs and the
    exactness auditor; ``serve_chunked`` over phase main's yelp x1.0
    comp engine for the device, kernel and wavefront arms (no second
    build); a kNN query-class run at x0.1; ``perf_rangereach --smoke``
    with the regression sentinel's ratio gates on what it wrote; and
    ``chaos_flight``.  Every answer checked against the host, every
    path's launches counted.  The benches write under a temporary
    directory in ``build/``, removed after."""
    import shutil
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch import benchmarks as B
    from repro_torch.benchmarks import chaos_flight, perf_rangereach, regress
    from repro_torch.core import batch_query
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serve_", dir=SCRATCH)
    results, launches = B.RESULTS, {}
    try:
        ds, scale, method = SERVE_CONFIG
        obs_dir = os.path.join(tmp, "obs")
        argv = ["--dataset", ds, "--scale", str(scale), "--method", method,
                "--queries", str(N_QUERIES), "--batch", str(BATCH),
                *SERVE_ARGS, "--obs-dir", obs_dir, "--device", DEVICE]
        # a fresh registry, as a fresh launcher process has: the
        # auditor's report reads the global audit counters, which the
        # auditors of phases obs and resilience moved
        obs.disable()
        obs.reset()
        t1 = time.perf_counter()
        rep, launches["launcher cluster zipf"] = served_launches(
            ks, lambda: serve.main(argv))
        c, audit = rep["cluster"], rep["audit"]
        if not (np.array_equal(rep["answers"], rep["host"])
                and c["n_compiles"] == c["n_compiles_warm"]
                and audit["checked"] > 0 and audit["divergences"] == 0
                and not audit["kept"]):
            raise AssertionError(f"launcher cluster arm: {c}, {audit}")
        if obs.enabled() or obs.FLIGHT.armed:
            raise AssertionError("the launcher left obs on")
        artifacts = sorted(os.listdir(obs_dir))
        for name in ("trace.json", "metrics.json", "querylog.jsonl",
                     "placement_report.json"):
            if name not in artifacts:
                raise AssertionError(f"launcher --obs wrote no {name}")
        obs.reset()
        launcher = {"config": f"{ds}x{scale} {method}",
                    "argv": " ".join(argv[:-4]),
                    "us_per_query": rep["seconds"] / N_QUERIES * 1e6,
                    "percentiles_us": rep["percentiles"], "cluster": c,
                    "audit": {k: audit[k] for k in (
                        "sampled", "checked", "divergences")},
                    "positive": int(rep["answers"].sum()),
                    "obs_artifacts": artifacts,
                    "seconds": round(time.perf_counter() - t1, 3)}

        name = next(iter(engines))              # yelp x1.0 2dreach-comp
        eng, us, rects = engines[name]
        idx = indexes[name][2]
        host = batch_query(idx, us, rects)
        probe = ~idx.excluded[us]
        arms = []
        for arm in SERVE_ARMS:
            if arm == "device":
                fn, over = eng.query_batch, None
            else:
                fn, over = serve._forest_probe(idx, arm, dev)
            (ans, lats, total), n = served_launches(
                ks, lambda: serve._serve_batched(fn, us, rects, BATCH))
            launches[f"{name} serve_chunked {arm}"] = n
            m = slice(None) if arm == "device" else probe
            if not np.array_equal(ans[m], host[m]):
                raise AssertionError(f"serve_chunked {arm} != host ({name})")
            arms.append({"arm": arm, "us_per_query": total / len(us) * 1e6,
                         "percentiles_us": serve._percentiles(lats),
                         "probed": int(probe.sum()) if arm != "device"
                         else len(us),
                         **({"overflowed": over[0]} if arm == "wavefront"
                            else {}), "launches": n})

        kds, kscale, kn = SERVE_KNN
        knn, launches[f"{kds}x{kscale} launcher knn device"] = \
            served_launches(ks, lambda: serve.main([
                "--dataset", kds, "--scale", str(kscale), "--queries",
                str(kn), "--batch", str(BATCH), "--query-class", "knn",
                "--engine", "device", "--device", DEVICE]))
        if not (np.array_equal(knn["device"].ids, knn["host"].ids)
                and np.array_equal(knn["device"].dist2, knn["host"].dist2)):
            raise AssertionError("launcher knn: device != host")

        B.RESULTS = os.path.join(tmp, "results")
        t1 = time.perf_counter()
        pr, launches["perf_rangereach --smoke"] = served_launches(
            ks, lambda: perf_rangereach.main(["--smoke", "--device",
                                              DEVICE]))
        summary = pr["summary"]
        bench = os.path.join(B.RESULTS, "BENCH_rangereach.json")
        metrics = regress.extract(bench, summary)
        gates = regress.gate_rows(bench, metrics)
        sentinel_rc = regress.run_sentinel(
            [bench], history_path=os.path.join(B.RESULTS, "history.jsonl"),
            device=torch.cuda.get_device_name(dev))
        rangereach = {
            "engines_us_per_query": summary["engines"],
            "latency_percentiles_us": summary["latency_percentiles_us"],
            "device_engine": summary["hierarchical_device_engine"],
            "cluster_engine": summary["cluster_engine"],
            "closure": pr["rows"]["closure"],
            "wavefront_overflow": [r["overflow_frac"] for r in
                                   pr["rows"]["engine_sweep"]
                                   if r["engine"] == "wavefront"],
            "ratio_gates": [{k: r[k] for k in ("gate", "ratio", "limit",
                                               "verdict")} for r in gates],
            "sentinel_rc": sentinel_rc,
            "seconds": round(time.perf_counter() - t1, 3)}

        t1 = time.perf_counter()
        rc, launches["chaos_flight"] = served_launches(
            ks, lambda: chaos_flight.main(["--out", os.path.join(tmp, "chaos"),
                                           "--device", DEVICE]))
        if rc != 0 or obs.enabled():
            raise AssertionError(f"chaos_flight returned {rc}")
        chaos = {"rc": rc, "bundles": len(os.listdir(os.path.join(
            tmp, "chaos", "flightdump"))),
            "seconds": round(time.perf_counter() - t1, 3)}
    finally:
        B.RESULTS = results
        obs.disable()
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launcher": launcher, "arms": arms, "knn": {
        "config": f"{kds}x{kscale}", "queries": kn},
        "perf_rangereach": rangereach, "chaos_flight": chaos,
        "launches": launches, "seconds": round(time.perf_counter() - t0, 3)}


def phase_train(ks):
    """DIN's ``train_batch`` cell at its published widths: the cell's
    step on meta tensors, then TRAIN_WARMUP + TRAIN_STEPS AdamW steps at
    B = 65,536 on the card (a new ``din_batches`` batch each, uploaded in
    the step's time), every loss finite and every parameter moved; the
    first step on TRAIN_CHECK_ROWS rows of the first batch held against
    the same step on the CPU from the same parameters."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import din_batches
    from repro_torch.models.nn import count_params, tree_to
    from repro_torch.models.recsys import din
    from repro_torch.train import adamw_init
    from repro_torch.train.optim import tree_leaves

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    spec = get_arch("din")
    cfg = spec.make_config()
    step, (p_meta, o_meta, b_meta) = spec.cells["train_batch"].build()
    B = RECSYS_SHAPES["train_batch"]["batch"]
    cpu = din.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    if [x.shape for x in tree_leaves(cpu)] != [x.shape for x in
                                               tree_leaves(p_meta)]:
        raise AssertionError("train_batch cell: parameter shapes differ")
    data = din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, B)
    batches = [{k: torch.as_tensor(v) for k, v in next(data).items()}
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    if any(tuple(batches[0][k].shape) != tuple(v.shape)
           for k, v in b_meta.items()):
        raise AssertionError("train_batch cell: batch shapes differ")

    # the card against the CPU on a slice of the first batch
    part = {k: v[:TRAIN_CHECK_ROWS] for k, v in batches[0].items()}
    params = tree_to(cpu, dev)
    ks.reset()
    p1, o1, m1 = step(params, adamw_init(params), tree_to(part, dev))
    torch.cuda.synchronize()
    p0, o0, m0 = step(cpu, adamw_init(cpu), part)
    loss_err = abs(float(m1["loss"]) - float(m0["loss"])) / abs(
        float(m0["loss"]))
    worst = 0.0
    for got, want in zip(tree_leaves(p1) + tree_leaves(o1.m),
                         tree_leaves(p0) + tree_leaves(o0.m)):
        err = float((got.cpu().double() - want.double()).norm())
        worst = max(worst, err / max(float(want.double().norm()), 1e-30))
    if not (loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_TOL):
        raise AssertionError(f"train step on the card != CPU: loss "
                             f"{loss_err}, parameters {worst}")
    del p1, o1, p0, o0

    # the full-width steps
    opt = adamw_init(params)
    start = params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms, losses = [], []
    for i, b in enumerate(batches):
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, tree_to(b, dev))
        losses.append(float(m["loss"]))          # syncs with the card
        if i >= TRAIN_WARMUP:
            ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: n for k, n in ks.counts().items() if n}
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(start))]
    if not (all(np.isfinite(losses)) and all(moved) and int(opt.step)
            == len(batches)):
        raise AssertionError(f"train: losses {losses}, moved {moved}")
    del params, opt, start
    torch.cuda.empty_cache()
    resume = launcher_resume_check()
    return {"config": dataclasses.asdict(cfg), "batch": B,
            "params": count_params(cpu),
            "ms_per_step": ms, "ms_per_step_median": float(np.median(ms)),
            "samples_per_s": B / float(np.median(ms)) * 1e3,
            "peak_bytes": int(peak), "base_bytes": int(base),
            "losses": losses, "cpu_check": {
                "rows": TRAIN_CHECK_ROWS, "loss_rel_err": loss_err,
                "param_rel_err_norm": worst, "tolerance": TRAIN_TOL,
                "loss_tolerance": TRAIN_LOSS_TOL},
            "kernel_launches": launched,
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "launcher_resume": resume,
            "seconds": round(time.perf_counter() - t0, 3)}


RESUME_ARGS = ("--arch", "gemma2-2b", "--steps", "30", "--ckpt-every", "10")
RESUME_TOL = 1e-5     # the reference's test_crash_resume_end_to_end bound


def launcher_runs(tmp, tag, run_args=RESUME_ARGS):
    """The training launcher in-process on the card (``run_args``: the
    reduced gemma2, as ``examples/train_lm.py`` trains it, or phase
    gnn's SchNet): a crash at step 15, the resume, and a clean run.
    (resumed step-30 loss, clean loss, the resumed run's parameters and
    state, what it printed)."""
    import contextlib
    import io

    from repro_torch.distributed import latest_step
    from repro_torch.launch import train as LT

    d1 = os.path.join(tmp, f"{tag}_crash")
    d2 = os.path.join(tmp, f"{tag}_clean")
    args = [*run_args, "--device", DEVICE]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            LT.main([*args, "--ckpt-dir", d1, "--crash-at", "15"])
            raise AssertionError("the launcher did not crash at step 15")
        except RuntimeError as e:
            if "injected crash at step 15" not in str(e):
                raise
        if latest_step(d1) != 10:
            raise AssertionError(f"crash left step {latest_step(d1)}")
        params, opt, resumed = LT.main([*args, "--ckpt-dir", d1,
                                        "--resume"])
        _, _, clean = LT.main([*args, "--ckpt-dir", d2])
    text = buf.getvalue()
    if "[train] resumed from step 10" not in text or latest_step(d1) != 30:
        raise AssertionError(f"launcher resume: {text[-400:]}")
    return float(resumed["loss"]), float(clean["loss"]), params, opt, text


def launcher_resume_check(run_args=RESUME_ARGS):
    """The launcher's crash and resume on the card (``run_args``, the
    reduced gemma2 by default): the resumed run's
    step-30 loss within RESUME_TOL of a clean run's (measured first as
    the card runs by default; where the gap is larger, measured again
    with ``torch.use_deterministic_algorithms(True)``, and held there);
    then a checkpoint of the resumed run's card tensors (and of their
    bf16 casts) restored onto the card, bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.distributed import restore_checkpoint, save_checkpoint
    from repro_torch.distributed.tree import walk

    t0 = time.perf_counter()
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_", dir=SCRATCH)
    gaps = {}
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            try:
                r, c, params, opt, text = launcher_runs(
                    tmp, f"det{int(det)}", run_args)
            finally:
                torch.use_deterministic_algorithms(False)
            gaps["deterministic" if det else "default"] = {
                "resumed": r, "clean": c, "gap": abs(r - c)}
            if abs(r - c) <= RESUME_TOL:
                break
        else:
            raise AssertionError(f"resumed != clean past {RESUME_TOL}: "
                                 f"{gaps}")
        tree = {"params": params, "opt": opt,
                "bf16": {k.replace("/", "."): v.to(torch.bfloat16)
                         for k, v in walk(params)}}
        path = os.path.join(tmp, "bits")
        save_checkpoint(path, 30, tree)
        back, _ = restore_checkpoint(path, tree)
        pairs = list(zip(walk(tree), walk(back)))
        same = all(ka == kb and a.device == b.device and a.dtype == b.dtype
                   and torch.equal(a, b) for (ka, a), (kb, b) in pairs)
        if not same or any(a.device.type != torch.device(DEVICE).type
                           for (_, a), _ in pairs):
            raise AssertionError("checkpoint from card tensors != restored")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"args": " ".join(run_args), "tolerance": RESUME_TOL,
            "runs": gaps, "held_with": next(reversed(gaps)),
            "checkpoint_bit_exact_leaves": len(pairs),
            "printed": [ln for ln in text.splitlines()
                        if "step 30 loss" in ln or "resumed" in ln],
            "seconds": round(time.perf_counter() - t0, 3)}


# --------------------------------------------------------------------------
# The LM family: five reduced configs against the CPU, gemma2-2b at its
# published widths
# --------------------------------------------------------------------------

LM_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma3-12b",
            "h2o-danube-1.8b", "gemma2-2b")
LM_SMALL = dict(batch=2, seq=32, prompt=16, decode=4)
LM_TOL = 1e-4          # reduced configs, card against CPU: logits and
#                        losses within LM_TOL (1 + |CPU|); parameters after
#                        one step within LM_TOL relative in norm
LM_FULL = "gemma2-2b"
LM_SELF = dict(batch=2, prompt=4608, decode=512)   # past the 4,096 window;
#                        P + T = 5,120, a multiple of the 512 blocking
LM_SELF_TOL = 2e-3     # decode logits against forward's: the reference's
#                        own test_prefill_decode_matches_forward bound
#                        (atol and rtol), here over 26 float32 layers
LM_TIMED = (("prefill_32k", 1), ("decode_32k", 16), ("long_500k", 1))
LM_CUTS = {
    "prefill_32k": "batch 32 -> 1: at 32 the FFN's gate/up activations "
                   "alone are 32 x 32,768 x 18,432 x 2 B = 38.7 GB",
    "decode_32k": "batch 128 -> 16: the bf16 KV cache at 128 is 251 GB; "
                  "the cache is filled with random values to length "
                  "32,767, not by a prefill",
    "long_500k": "none (batch 1, the cell's); the cache filled with random "
                 "values to length 524,287, not by a prefill",
    "self_check": "float32 (10.5 GB of weights), B = 2, P = 4,608, "
                  "T = 512 teacher-forced steps",
}
LM_PREFILL_ITERS = 2
LM_DECODE_ITERS = 8


def lm_small_case(arch, dev):
    """``arch``'s reduced config (float32) on the card against the CPU
    from the same parameters (a CPU generator, seed 0) and batch:
    prefill of 16 tokens, 4 decode steps, ``lm_loss`` and one
    ``make_train_step`` step (the train_4k cell's AdamW settings).  The
    largest errors."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batches
    from repro_torch.models.lm import decode_step, init_params, lm_loss
    from repro_torch.models.lm import prefill
    from repro_torch.models.nn import tree_to
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.optim import tree_leaves

    cfg = get_arch(arch).make_config(reduced=True)
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = next(lm_batches(cfg.vocab, LM_SMALL["seq"], LM_SMALL["batch"],
                        seed=1))
    step = make_train_step(lambda p, bb: lm_loss(p, bb, cfg), AdamWConfig())
    P, T = LM_SMALL["prompt"], LM_SMALL["decode"]
    out = {}
    for where, params in (("cpu", cpu), ("card", tree_to(cpu, dev))):
        d = torch.device("cpu") if where == "cpu" else dev
        batch = {k: torch.as_tensor(v, device=d) for k, v in b.items()}
        toks = batch["tokens"]
        lg, cache = prefill(params, toks[:, :P], cfg, max_len=P + T + 2)
        seq = [lg]
        for i in range(T):
            lg, cache = decode_step(params, cache, toks[:, P + i], cfg)
            seq.append(lg)
        with torch.no_grad():
            loss = lm_loss(params, batch, cfg)[0]
        p1, _, m = step(params, adamw_init(params), batch)
        out[where] = (torch.stack(seq).cpu(), float(loss), float(m["loss"]),
                      float(m["grad_norm"]), [x.cpu() for x in
                                              tree_leaves(p1)])
    (l0, s0, t0, g0, p0), (l1, s1, t1, g1, p1) = out["cpu"], out["card"]
    if not torch.isfinite(l1).all():
        raise AssertionError(f"{arch}: logits on the card not finite")
    diff = (l1 - l0).abs()
    worst = max(float((b1.double() - b0.double()).norm())
                / max(float(b0.double().norm()), 1e-30)
                for b0, b1 in zip(p0, p1))
    rec = {"arch": arch, "logits_max_abs_err": float(diff.max()),
           "logits_ok": bool((diff <= LM_TOL * (1 + l0.abs())).all()),
           "loss_abs_err": abs(s1 - s0), "step_loss_abs_err": abs(t1 - t0),
           "grad_norm_rel_err": abs(g1 - g0) / max(abs(g0), 1e-30),
           "params_rel_err_norm": worst}
    ok = (rec["logits_ok"]
          and max(rec["loss_abs_err"], rec["step_loss_abs_err"])
          <= LM_TOL * (1 + abs(s0))
          and rec["grad_norm_rel_err"] <= LM_TOL and worst <= LM_TOL)
    if not ok:
        raise AssertionError(f"LM {arch} on the card != CPU: {rec}")
    return rec


def lm_self_check(dev):
    """gemma2-2b at its published widths in float32 on the card: prefill
    P tokens (the local layers' rings wrapped), decode T teacher-forced
    tokens, and hold every step's logits (and the prefill's last) to
    ``forward`` over all P + T tokens at the same positions."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batches
    from repro_torch.models.lm import (decode_step, forward, init_params,
                                       prefill)
    from repro_torch.models.lm.model import logits

    t0 = time.perf_counter()
    cfg = get_arch(LM_FULL).make_config(dtype="float32")
    B, P, T = LM_SELF["batch"], LM_SELF["prompt"], LM_SELF["decode"]
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    toks = torch.as_tensor(next(lm_batches(cfg.vocab, P + T, B, seed=2))[
        "tokens"], device=dev)
    with torch.no_grad():
        hidden, _ = forward(params, toks, cfg)
        want = logits(params, hidden[:, P - 1:P + T], cfg)   # (B, T+1, V)
    del hidden
    lg, cache = prefill(params, toks[:, :P], cfg, max_len=P + T)
    err = (lg - want[:, 0]).abs()
    ok = bool((err <= LM_SELF_TOL * (1 + want[:, 0].abs())).all())
    worst = float(err.max())
    for t in range(T):
        lg, cache = decode_step(params, cache, toks[:, P + t], cfg)
        err = (lg - want[:, t + 1]).abs()
        ok &= bool((err <= LM_SELF_TOL * (1 + want[:, t + 1].abs())).all())
        worst = max(worst, float(err.max()))
    rec = {"config": "gemma2-2b float32", "batch": B, "prompt": P,
           "decode": T, "window": cfg.window,
           "logits_max_abs_err": worst, "tolerance": LM_SELF_TOL,
           "cache_len": int(cache["len"]),
           "seconds": round(time.perf_counter() - t0, 3)}
    if not ok:
        raise AssertionError(f"gemma2-2b decode != forward: {rec}")
    del params, cache, want
    torch.cuda.empty_cache()
    return rec


def lm_filled_cache(cfg, B, seq, dev):
    """``init_cache`` for B sequences of ``seq`` tokens, filled with
    random values to length ``seq - 1`` (what a decode step reads and
    writes does not depend on the values)."""
    import torch
    from repro_torch.distributed.tree import walk
    from repro_torch.models.lm import init_cache

    cache = init_cache(cfg, B, seq, dev)
    gen = torch.Generator(dev).manual_seed(1)
    for key, x in walk(cache):
        if key != "len":
            x.normal_(generator=gen)
    cache["len"] = torch.tensor(seq - 1, dtype=torch.int32)
    return cache


def lm_cell(params, cfg, shape, B, dev):
    """One timed cell of LM_TIMED (see ``lm_timed``); every tensor it
    makes is freed when it returns."""
    import torch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data import lm_batches
    from repro_torch.distributed.tree import walk
    from repro_torch.models.lm import decode_step, prefill

    seq, kind = LM_SHAPES[shape]["seq"], LM_SHAPES[shape]["kind"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"batch": B, "cell_batch": LM_SHAPES[shape]["batch"], "seq": seq,
           "reduced": LM_CUTS[shape],
           "base_bytes": int(torch.cuda.memory_allocated(dev))}
    if kind == "prefill":
        toks = torch.as_tensor(next(lm_batches(cfg.vocab, seq, B))[
            "tokens"], device=dev)

        def call():
            return prefill(params, toks, cfg, max_len=seq)[0]
        iters = LM_PREFILL_ITERS
    else:
        cache = lm_filled_cache(cfg, B, seq, dev)
        tok = torch.randint(0, cfg.vocab, (B,), device=dev)
        rec["cache_bytes"] = sum(x.numel() * x.element_size()
                                 for k, x in walk(cache) if k != "len")

        def call():
            return decode_step(params, cache, tok, cfg)[0]
        iters = LM_DECODE_ITERS
    lg = call()                                            # warm-up
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t1 = time.perf_counter()
        lg = call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    if tuple(lg.shape) != (B, cfg.vocab) or not torch.isfinite(lg).all():
        raise AssertionError(f"{shape}: logits {tuple(lg.shape)}")
    med = float(np.median(ms))
    rec.update(ms=ms, ms_median=med,
               tokens_per_s=(seq * B if kind == "prefill" else B) / med
               * 1e3, peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
    if kind == "decode":
        busy = busy_us(call, 1)
        rec.update(busy)
        if busy["device_busy_us_per_batch"] is not None:
            rec["busy_share"] = busy["device_busy_us_per_batch"] / (
                med * 1e3)
    return rec


def lm_timed(dev):
    """gemma2-2b in bf16 (its published dtype) on the card: prefill_32k,
    decode_32k and long_500k at the batches of LM_TIMED, each after a
    warm-up: ms per prefill or decode step (host clock around
    synchronised calls), tokens/s, the bytes allocated before the cell
    and its peak, and for a decode step the device's busy µs and top
    operations (torch.profiler)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import init_params
    from repro_torch.models.nn import param_bytes

    cfg = get_arch(LM_FULL).make_config()
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    out = {"config": "gemma2-2b bfloat16", "param_bytes":
           param_bytes(params), "cells": {
               shape: lm_cell(params, cfg, shape, B, dev)
               for shape, B in LM_TIMED}}
    del params
    torch.cuda.empty_cache()
    return out


def phase_lm(ks, card):
    """The LM family on the card: the five reduced configs against the
    CPU, gemma2-2b's decode against its own forward at the published
    widths in float32, and gemma2-2b timed in bf16 on prefill_32k,
    decode_32k and long_500k (cut as LM_CUTS says).  float32 products in
    full precision (no TF32).  No kernel of the port lies on this path:
    the counts are reset before and read after."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    ks.reset()
    small = [lm_small_case(a, dev) for a in LM_ARCHS]
    t1 = time.perf_counter()
    self_check = lm_self_check(dev)
    timed = lm_timed(dev)
    launched = {k: n for k, n in ks.counts().items() if n}
    return {"card": card, "reduced_vs_cpu": small, "tolerance": LM_TOL,
            "reduced_seconds": round(t1 - t0, 3),
            "largest_err": max(r["logits_max_abs_err"] for r in small),
            "self_check": self_check, "timed": timed,
            "reduced": LM_CUTS, "kernel_launches": launched,
            "seconds": round(time.perf_counter() - t0, 3)}


# --------------------------------------------------------------------------
# The GNN family: four reduced configs against the CPU, each at its
# published widths on three cells, SchNet on ogb_products' nodes
# --------------------------------------------------------------------------

GNN_ARCHS = ("graphcast", "dimenet", "equiformer-v2", "schnet")
GNN_LOSS_TOL = 1e-5    # reduced configs, card against CPU: the loss,
#                        relative (DIN's bound in phase train)
GNN_TOL = 1e-4         # the forward outputs, and every parameter and
#                        moment after one AdamW step, relative in norm
# a leaf whose CPU gradient is not zero but below GNN_NOISE times the
# largest is rounding noise, held to stay noise on the card (see
# gnn_small_case)
GNN_NOISE = 1e-6
GNN_CELLS = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_WARMUP = 2
GNN_STEPS = 5
GNN_SEED = 3
GNN_FANOUTS = (15, 10)
GNN_SEEDS = 1024       # minibatch_lg's seed nodes a step
# (arch, cell) -> seed nodes a step where the cell's 1,024 do not fit,
# chosen by the peaks measured on the card (the bytes a node and an
# edge that autograd saves, counted once per save on the CPU, are an
# upper bound beside them)
GNN_CUTS = {
    ("equiformer-v2", "minibatch_lg"): (
        128, "seeds 1,024 -> 128: 29.6 GB measured at 64 seeds on an "
             "H100 80GB, ~59 GB at 128; 2.49 MB a node and 1.49 MB an "
             "edge of saved activations (12 layers of (49, 128) irreps) "
             "is ~660 GB at 1,024 seeds"),
    ("graphcast", "minibatch_lg"): (
        640, "seeds 1,024 -> 640: 49.0 GB measured at 512 seeds on an "
             "H100 80GB, ~61 GB at 640; 251 KB a node and 306 KB an edge "
             "of saved activations (16 layers of 512-wide MLPs on (E, "
             "1,536) concatenations) is ~92 GB at 1,024 seeds"),
}
OGB_CELL = "ogb_products"
OGB_EDGE_CUT = 8       # SchNet on ogb_products: 1/8 of its edges
OGB_STEPS = 2
OGB_CUT = ("edges 61,859,140 -> 7,732,736 (1/8, rounded up to 512): "
           "46.6 GB measured at 1/10 on an H100 80GB, ~57 GB at 1/8; "
           "8.3 KB an edge and 4.0 KB a node of saved activations at f = "
           "100 (the (E, 300) RBF and three (E, 64) filter MLPs) is ~520 "
           "GB whole; nodes (2,449,029) whole")
GNN_ROTATIONS = 3
GNN_INVARIANCE_TOL = 1e-3   # the reference's test_equiformer_invariance
GNN_RESUME_ARGS = ("--arch", "schnet", "--steps", "30", "--ckpt-every",
                   "10")


def gnn_module(arch):
    import importlib

    return importlib.import_module(
        f"repro_torch.models.gnn.{arch.replace('-', '_')}")


def gnn_small_case(arch, dev):
    """``arch``'s reduced config on the launcher's molecules
    (``launch.train.build``: parameters from a CPU generator, seed 0,
    ``molecule_batches(12, 32, 8)``, GraphCast's features as its
    ``to_dev`` attaches them) on the card against the CPU: the forward
    outputs, the loss and one AdamW step (the launcher's settings).  The
    largest errors, the leaf that has the largest state error, and that
    leaf's error on the CPU in float32 against the same step from a
    float64 gradient (``worst_leaf_float32_err``): what the format
    alone moves it by on one device.

    A leaf whose CPU gradient is not zero but below GNN_NOISE times the
    largest of any leaf (``exempt_leaves``; EquiformerV2's last
    attention biases, per-head shifts of logits that a softmax over
    edges normalises away, are zero in exact arithmetic) is rounding
    noise on either device, and Adam's normalised step moves it by about
    +-lr in no common direction: such a leaf is held instead to be noise
    on the card too, its largest moment below GNN_NOISE times the
    largest of any leaf.  A leaf whose CPU gradient is exactly zero is
    compared as every other leaf is."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.tree import map_leaves, walk
    from repro_torch.launch import train as LT
    from repro_torch.models.gnn.common import flatten_molecules
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    mod = gnn_module(arch)
    cfg = get_arch(arch).make_config(reduced=True)
    cpu = torch.device("cpu")
    out = {}
    for where, d in (("cpu", cpu), ("card", dev), ("float64", cpu)):
        params, loss_fn, data, to_dev = LT.build(arch, device=d)
        b = to_dev(next(data))
        if where == "float64":
            params = map_leaves(lambda _, x: x.double(), params)
            b = {k: x.double() if x.is_floating_point() else x
                 for k, x in b.items()}
        with torch.no_grad():
            fwd = mod.apply(params, flatten_molecules(b), cfg)
        step = make_train_step(loss_fn, AdamWConfig(
            lr=3e-3, warmup_steps=10, total_steps=100))
        p1, o1, m = step(params, adamw_init(params), b)
        out[where] = (fwd.cpu().double(), float(m["loss"]), {
            k: x.cpu().double()
            for k, x in walk({"params": p1, "m": o1.m, "v": o1.v})})
    (f0, l0, t0), (f1, l1, t1) = out["cpu"], out["card"]
    t64 = out["float64"][2]

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    def peak(t, k):
        return float(t[k].abs().max())

    # one step from zero moments: m = (1 - b1) g, the CPU's gradient
    m_max = max(peak(t, k) for t in (t0, t1) for k in t
                if k.startswith("m/"))
    g_max = max(peak(t0, k) for k in t0 if k.startswith("m/"))
    exempt = [k[2:] for k in t0 if k.startswith("m/")
              and 0 < peak(t0, k) < GNN_NOISE * g_max]
    noisy = [f"{s}/{k}" for k in exempt for s in ("params", "m", "v")]
    errs = {k: rel(t1[k], t0[k]) for k in t0 if k not in noisy}
    worst = max(errs, key=errs.get)
    noise = max([peak(t, f"m/{k}") / m_max for t in (t0, t1)
                 for k in exempt], default=0.0)
    rec = {"arch": arch, "forward_rel_err_norm": rel(f1, f0),
           "loss_rel_err": abs(l1 - l0) / max(abs(l0), 1e-30),
           "state_rel_err_norm": errs[worst], "worst_leaf": worst,
           "worst_leaf_float32_err": rel(t0[worst], t64[worst]),
           "exempt_leaves": exempt, "exempt_moment_share": noise,
           "loss": l0}
    if not (np.isfinite(l1) and rec["forward_rel_err_norm"] <= GNN_TOL
            and rec["loss_rel_err"] <= GNN_LOSS_TOL
            and rec["state_rel_err_norm"] <= GNN_TOL
            and noise <= GNN_NOISE):
        raise AssertionError(f"GNN {arch} on the card != CPU: {rec}")
    return rec


def products_csr(seed=GNN_SEED):
    """A seeded CSR with ogb_products' 2,449,029 nodes and its mean
    degree (25.3): Poisson degrees, uniform neighbours."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.core.graph import CSR

    n, e = GNN_SHAPES[OGB_CELL]["n"], GNN_SHAPES[OGB_CELL]["e"]
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(rng.poisson(e / n, n), out=indptr[1:])
    return CSR(indptr, rng.integers(0, n, int(indptr[-1]), dtype=np.int32))



def cut_edges(seeds):
    """Edges of a minibatch_lg block at ``seeds`` seed nodes (GNN_FANOUTS:
    every seed's 15 neighbours and their 10 each)."""
    return seeds * GNN_FANOUTS[0] * (1 + GNN_FANOUTS[1])


def cut_cell(arch, cell, b_meta):
    """(seeds, batch layout) of ``arch`` on ``cell`` as timed: GNN_CUTS'
    seeds and the cell's layout at that many seeds, or GNN_SEEDS and
    ``b_meta`` (the cell's own) where the cell is not cut."""
    from repro_torch.configs.base import GNN_SHAPES, _gnn_batch_meta

    seeds = GNN_CUTS.get((arch, cell), (GNN_SEEDS, None))[0]
    if seeds == GNN_SEEDS:
        return seeds, b_meta
    e = cut_edges(seeds)
    return seeds, _gnn_batch_meta(arch, dict(GNN_SHAPES[cell],
                                             n=seeds + e, e=e))

def gnn_graph(cell, step, seeds, csr):
    """Step ``step``'s graph of a graph cell as host arrays: positions
    and features synthesised from the seed, full_graph_sm's 2,708 nodes
    and 10,556 random edges, or minibatch_lg's block of ``seeds`` seed
    nodes sampled over ``csr`` (``sample_blocks``, fan-outs 15 and 10),
    both padded to the cell's shape (at ``seeds``) with masked edges on
    the last node.  (arrays, real edges, real nodes)."""
    from repro_torch.configs.base import GNN_SHAPES, round_up
    from repro_torch.data import sample_blocks

    s = GNN_SHAPES[cell]
    rng = np.random.default_rng([GNN_SEED, step])
    if cell == "minibatch_lg":
        blk = sample_blocks(csr, rng.choice(csr.n, seeds, replace=False),
                            GNN_FANOUTS, rng)
        src = np.concatenate([l[0] for l in blk.layers])
        dst = np.concatenate([l[1] for l in blk.layers])
        n_real = blk.n_nodes
        e_cell = cut_edges(seeds)
        n_pad, e_pad = round_up(seeds + e_cell), round_up(e_cell)
    else:
        n_real, e_real = s["n"], s["e"]
        src = rng.integers(0, n_real, e_real)
        dst = (src + 1 + rng.integers(0, n_real - 1, e_real)) % n_real
        n_pad, e_pad = round_up(n_real), round_up(e_real)
    E = len(src)
    edge_src = np.full(e_pad, n_pad - 1, np.int32)
    edge_dst = np.full(e_pad, n_pad - 1, np.int32)
    edge_src[:E], edge_dst[:E] = src, dst
    return {"pos": rng.standard_normal((n_pad, 3), dtype=np.float32) * 2,
            "feat": rng.standard_normal((n_pad, s["f"]), dtype=np.float32),
            "edge_src": edge_src, "edge_dst": edge_dst,
            "edge_mask": np.arange(e_pad) < E,
            "node_mask": np.arange(n_pad) < n_real,
            "energy": np.float32(rng.standard_normal())}, E, n_real


def gnn_batch(arch, graph, E, step):
    """``graph`` (a molecule batch or ``gnn_graph``'s arrays of step
    ``step``) with what ``arch``'s loss reads: DimeNet's triplets over
    the ``E`` real edges (256 a molecule; 2 E rounded up to 512 on a
    graph), GraphCast's target (0.9 times its features, the launcher's
    rule; on molecules, features of 16 a node drawn from the seed)."""
    from repro_torch.configs.base import (MOLECULE_TRIPLETS, MOLECULE_VARS,
                                          gnn_triplets)
    from repro_torch.models.gnn.dimenet import build_triplets

    b = dict(graph)
    molecule = b["pos"].ndim == 3
    if arch == "dimenet":
        if molecule:
            trip = [build_triplets(s, d, b["pos"].shape[1],
                                   MOLECULE_TRIPLETS)
                    for s, d in zip(b["edge_src"], b["edge_dst"])]
            trip = [np.stack(t) for t in zip(*trip)]
        else:
            T = gnn_triplets(len(b["edge_src"]))
            trip = build_triplets(b["edge_src"][:E], b["edge_dst"][:E],
                                  len(b["pos"]), T)
        b.update(zip(("id_kj", "id_ji", "triplet_mask"), trip))
    if arch == "graphcast":
        if molecule:
            rng = np.random.default_rng([GNN_SEED, step, 1])
            b["feat"] = rng.standard_normal(
                b["pos"].shape[:2] + (MOLECULE_VARS,)).astype(np.float32)
        b["target"] = b["feat"] * np.float32(0.9)
        b.pop("energy")
    return b


def gnn_cell(arch, cell, dev, graphs, prof):
    """``arch`` at its published widths on ``cell``: the cell's step
    (``Cell.build``), parameters from a CPU generator (seed 0),
    GNN_WARMUP + GNN_STEPS AdamW steps on the card, a new batch each
    (uploaded within the step's time): ms a step (host clock; the loss
    read back syncs), graphs or real edges a second, the bytes allocated
    before and at the peak, every loss finite and every parameter moved;
    ``prof``: one more step under torch.profiler (busy µs, top
    operations)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models.nn import count_params, tree_to
    from repro_torch.train import adamw_init
    from repro_torch.train.optim import tree_leaves

    s = GNN_SHAPES[cell]
    spec = get_arch(arch)
    step, (p_meta, _, b_meta) = spec.cells[cell].build()
    cfg = spec.make_config(d_feat=None if s["batched"] else s["f"],
                           shape=cell)
    cut = GNN_CUTS.get((arch, cell), (None, None))[1]
    seeds, b_meta = cut_cell(arch, cell, b_meta)
    batches = [gnn_batch(arch, g, E, i) for i, (g, E, _) in
               enumerate(graphs)]
    got = {k: (tuple(np.shape(v)), np.asarray(v).dtype.name)
           for k, v in batches[0].items()}
    want = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in b_meta.items()}
    if got != want:
        raise AssertionError(f"{arch} {cell}: batch {got} != cell {want}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = start = gnn_module(arch).init_params(
        torch.Generator().manual_seed(0), cfg, device=dev)
    if [x.shape for x in tree_leaves(params)] != [
            x.shape for x in tree_leaves(p_meta)]:
        raise AssertionError(f"{arch} {cell}: parameter shapes differ")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    ms, losses = [], []
    for i, b in enumerate(batches):
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, tree_to(
            {k: torch.as_tensor(v) for k, v in b.items()}, dev))
        losses.append(float(m["loss"]))          # syncs with the card
        if i >= GNN_WARMUP:
            ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(start))]
    if not (all(np.isfinite(losses)) and all(moved)
            and int(opt.step) == len(batches)):
        raise AssertionError(f"{arch} {cell}: losses {losses}, moved "
                             f"{sum(moved)} of {len(moved)}")
    med = float(np.median(ms))
    rec = {"params": count_params(params), "ms_per_step": ms,
           "ms_per_step_median": med, "peak_bytes": int(peak),
           "base_bytes": int(base), "losses": losses}
    if s["batched"]:
        rec["graphs_per_s"] = s["batch"] / med * 1e3
    else:
        rec.update(nodes=int(graphs[0][2]), edges=int(graphs[0][1]),
                   padded_edges=int(len(batches[0]["edge_src"])),
                   edges_per_s=float(np.mean([E for _, E, _ in graphs[
                       GNN_WARMUP:]])) / med * 1e3)
    if cut:
        rec.update(seeds=seeds, reduced=cut)
    if prof:
        dev_b = tree_to({k: torch.as_tensor(v) for k, v in
                         batches[-1].items()}, dev)
        busy = busy_us(lambda: step(params, opt, dev_b), 1)
        rec.update(busy)
        if busy["device_busy_us_per_batch"] is not None:
            rec["busy_share"] = busy["device_busy_us_per_batch"] / (
                med * 1e3)
    del params, opt, start
    torch.cuda.empty_cache()
    return rec


def gnn_products(dev):
    """ogb_products: the four cells built on meta (the bytes of the
    parameters, the AdamW state and the batch); then SchNet on the
    card at ogb_products' nodes (f = 100) with its edges cut
    (OGB_CUT), graph and features made on the card from a seed,
    OGB_STEPS steps: ms each, the peak."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES, round_up
    from repro_torch.models.nn import tree_to
    from repro_torch.train import adamw_init
    from repro_torch.train.optim import tree_leaves

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    meta = {}
    for arch in GNN_ARCHS:
        _, (p, o, b) = get_arch(arch).cells[OGB_CELL].build()
        meta[arch] = {"param_bytes": nbytes(p),
                      "opt_bytes": nbytes(o._asdict()),
                      "batch_bytes": nbytes(b)}
    s = GNN_SHAPES[OGB_CELL]
    spec = get_arch("schnet")
    step = spec.cells[OGB_CELL].build()[0]
    cfg = spec.make_config(d_feat=s["f"], shape=OGB_CELL)
    N, E = round_up(s["n"]), round_up(-(-s["e"] // OGB_EDGE_CUT))
    gen = torch.Generator(dev).manual_seed(GNN_SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = {"pos": torch.randn((N, 3), generator=gen, device=dev) * 2,
         "feat": torch.randn((N, s["f"]), generator=gen, device=dev),
         "edge_src": torch.randint(0, s["n"], (E,), generator=gen,
                                   device=dev, dtype=torch.int32),
         "edge_dst": torch.randint(0, s["n"], (E,), generator=gen,
                                   device=dev, dtype=torch.int32),
         "edge_mask": torch.ones(E, dtype=torch.bool, device=dev),
         "node_mask": torch.arange(N, device=dev) < s["n"],
         "energy": torch.randn((), generator=gen, device=dev)}
    params = gnn_module("schnet").init_params(
        torch.Generator().manual_seed(0), cfg, device=dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    ms, losses = [], []
    for _ in range(OGB_STEPS):
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ogb_products schnet: losses {losses}")
    del params, opt, b
    torch.cuda.empty_cache()
    return {"meta": meta, "schnet": {
        "nodes": s["n"], "edges": E, "cell_edges": s["e"], "f": s["f"],
        "reduced": OGB_CUT, "ms_per_step": ms, "losses": losses,
        "edges_per_s": E / ms[-1] * 1e3, "peak_bytes": int(peak),
        "base_bytes": int(base)}}


def gnn_invariance(dev):
    """EquiformerV2 at its published widths (l_max 6, 12 layers) on the
    card: one molecule of the molecule cell's stream, its energy under
    GNN_ROTATIONS random rotations within GNN_INVARIANCE_TOL relative."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data import molecule_batches

    s = GNN_SHAPES["molecule"]
    cfg = get_arch("equiformer-v2").make_config()
    mod = gnn_module("equiformer-v2")
    params = mod.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    m = next(molecule_batches(s["n"], s["e"], 1, seed=GNN_SEED))
    b = {k: torch.as_tensor(v[0], device=dev) for k, v in m.items()}
    rng = np.random.default_rng(GNN_SEED)
    with torch.no_grad():
        e0 = float(mod.apply(params, b, cfg))
        es = []
        for _ in range(GNN_ROTATIONS):
            Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            if np.linalg.det(Q) < 0:
                Q[:, 0] *= -1
            q = torch.as_tensor(Q.T, dtype=torch.float32, device=dev)
            es.append(float(mod.apply(params, dict(b, pos=b["pos"] @ q),
                                      cfg)))
    worst = max(abs(e - e0) for e in es) / max(1.0, abs(e0))
    rec = {"config": "equiformer-v2 l_max 6, 12 layers", "energy": e0,
           "rotated": es, "rel_err": worst, "tolerance": GNN_INVARIANCE_TOL}
    if not worst < GNN_INVARIANCE_TOL:
        raise AssertionError(f"EquiformerV2 not invariant: {rec}")
    del params
    torch.cuda.empty_cache()
    return rec


def gnn_example():
    """The port's ``examples/gnn_molecules.py`` on the card (its own
    asserts: SchNet's MSE descends, EquiformerV2's energy invariant)."""
    import contextlib
    import io

    from repro_torch.examples import gnn_molecules

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        losses, (e0, e1) = gnn_molecules.main(["--device", DEVICE])
    return {"mse_first5": float(np.mean(losses[:5])),
            "mse_last5": float(np.mean(losses[-5:])),
            "equiformer_delta": abs(e0 - e1),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_gnn(ks, card):
    """The GNN family on the card, float32 products without TF32: the
    four reduced configs against the CPU (``gnn_small_case``); each at
    its published widths on molecule, full_graph_sm and minibatch_lg
    (``gnn_cell``, cut as GNN_CUTS says; one step profiled at
    molecule); ogb_products on meta and SchNet on its nodes
    (``gnn_products``); EquiformerV2's invariance at l_max 6, the
    ``gnn_molecules`` example, and the train launcher's crash and resume
    on SchNet.  No kernel of the port lies on this path: the counts are
    reset before and read after."""
    import torch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data import molecule_batches

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    ks.reset()
    small = [gnn_small_case(a, dev) for a in GNN_ARCHS]
    t1 = time.perf_counter()
    csr = products_csr()
    t_csr = time.perf_counter() - t1
    ms = GNN_SHAPES["molecule"]
    mol = molecule_batches(ms["n"], ms["e"], ms["batch"], seed=GNN_SEED)
    graphs = {"molecule": [
        (dict(b, node_mask=np.ones(b["pos"].shape[:2], bool)), None, None)
        for b in (next(mol) for _ in range(GNN_WARMUP + GNN_STEPS))]}
    cells, host_s = {}, {}
    for arch in GNN_ARCHS:
        for cell in GNN_CELLS:
            seeds = GNN_CUTS.get((arch, cell), (GNN_SEEDS, None))[0]
            key = (cell, seeds) if cell == "minibatch_lg" else cell
            if key not in graphs:
                t2 = time.perf_counter()
                graphs[key] = [gnn_graph(cell, i, seeds, csr) for i in
                               range(GNN_WARMUP + GNN_STEPS)]
                host_s[str(key)] = round(time.perf_counter() - t2, 3)
            cells.setdefault(arch, {})[cell] = gnn_cell(
                arch, cell, dev, graphs[key], prof=cell == "molecule")
    del graphs, csr
    t3 = time.perf_counter()
    products = gnn_products(dev)
    t4 = time.perf_counter()
    invariance = gnn_invariance(dev)
    example = gnn_example()
    resume = launcher_resume_check(GNN_RESUME_ARGS)
    launched = {k: n for k, n in ks.counts().items() if n}
    return {"card": card, "reduced_vs_cpu": small,
            "tolerance": GNN_TOL, "loss_tolerance": GNN_LOSS_TOL,
            "cells": cells, "reduced": {f"{a} {c}": why for (a, c), (_, why)
                                        in GNN_CUTS.items()},
            "ogb_products": products, "invariance": invariance,
            "example": example, "launcher_resume": resume,
            "kernel_launches": launched,
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "seconds": {"reduced": round(t1 - t0, 3),
                        "products_csr": round(t_csr, 3),
                        "host_batches": host_s,
                        "cells": round(t3 - t1 - t_csr - sum(
                            host_s.values()), 3),
                        "ogb_products": round(t4 - t3, 3),
                        "total": round(time.perf_counter() - t0, 3)}}


# --------------------------------------------------------------------------
# The device SCC
# --------------------------------------------------------------------------

SCC_REAL = ("yelp", 49.72)   # SPECS["yelp"].ref: 2,138,003 vertices


def scc_card(n, edges, dev):
    """``scc_torch`` on the card: labels, counts, seconds (host clock,
    the labels read back), peak bytes beyond those allocated before."""
    import torch
    from repro_torch.core import scc_torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    counts = {}
    t0 = time.perf_counter()
    labels = scc_torch(n, edges, device=dev, counts=counts)
    secs = time.perf_counter() - t0
    return labels, counts, secs, int(torch.cuda.max_memory_allocated(dev)
                                     - base)


def phase_scc(ks, indexes):
    """``scc_torch`` on the card against its CPU run on the yelp x1.0
    and x0.5 graphs of phase main (labels and counts equal), then at
    Yelp's real size against ``scc_np``'s components, each labelled by
    its largest vertex id (``np.maximum.at`` on the host).  No kernel of
    the port lies on this path (counts read)."""
    import torch
    from repro_torch.core import scc_np, scc_torch
    from repro_torch.data import get_dataset

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    ks.reset()
    graphs = {}
    for name, (g, *_rest) in indexes.items():
        graphs.setdefault(name.split(" ")[0], g)
    recs = []
    for name, g in graphs.items():
        cpu_counts = {}
        t1 = time.perf_counter()
        want = scc_torch(g.n_nodes, g.edges, device="cpu",
                         counts=cpu_counts)
        cpu_s = time.perf_counter() - t1
        scc_card(g.n_nodes, g.edges, dev)                  # warm-up
        got, counts, secs, peak = scc_card(g.n_nodes, g.edges, dev)
        if not np.array_equal(got, want) or counts != cpu_counts:
            raise AssertionError(f"scc {name}: card != CPU ({counts} / "
                                 f"{cpu_counts})")
        recs.append({"graph": name, "nodes": g.n_nodes,
                     "edges": len(g.edges), "counts": counts,
                     "card_seconds": secs, "cpu_seconds": cpu_s,
                     "peak_bytes": peak})
    t1 = time.perf_counter()
    g = get_dataset(SCC_REAL[0], scale=SCC_REAL[1])
    gen_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    comp = scc_np(g.n_nodes, g.edges)
    np_s = time.perf_counter() - t1
    top = np.full(int(comp.max()) + 1, -1, np.int64)
    np.maximum.at(top, comp, np.arange(g.n_nodes))
    got, counts, secs, peak = scc_card(g.n_nodes, g.edges, dev)
    if not np.array_equal(got, top[comp]):
        raise AssertionError("scc at Yelp's real size: card labels != "
                             "scc_np's largest ids")
    launched = {k: n for k, n in ks.counts().items() if n}
    return {"graphs": recs, "real": {
        "dataset": f"{SCC_REAL[0]} x{SCC_REAL[1]}", "nodes": g.n_nodes,
        "edges": len(g.edges), "sccs": int(comp.max()) + 1,
        "counts": counts, "card_seconds": secs, "scc_np_seconds": np_s,
        "generate_seconds": gen_s, "peak_bytes": peak},
        "kernel_launches": launched,
        "seconds": round(time.perf_counter() - t0, 3)}


# --------------------------------------------------------------------------
# The dry run of the timed model cells
# --------------------------------------------------------------------------

def dryrun_row(label, fn, args, dtype, measured_ms):
    """``fn(*args)`` counted on meta, and two floors for it on the H100
    (data-sheet peaks): ``bound_ms``, the step as a function (its FLOPs
    at the dtype's peak, or its inputs read once and its outputs written
    once at HBM's rate, whichever is longer), and ``roofline_ms``, the
    dry run's roofline (``benchmarks.roofline``: the inputs and outputs
    plus the HBM floor, the traffic of the products, gathers and
    scatters as the port's aten ops issue them); the measured ms over
    each."""
    from repro_torch.analysis.op_stats import OpStats, io_bytes
    from repro_torch.benchmarks.roofline import HBM_BW, bound_terms

    t0 = time.perf_counter()
    with OpStats() as st:
        out = fn(*args)
    stats = st.stats()
    io = sum(io_bytes(args, out).values())
    terms = bound_terms(stats, io, dtype)
    own = {"operations": terms["compute"], "bytes": io / HBM_BW}
    by = max(own, key=own.get)
    roof = max(terms, key=terms.get)
    bound_ms, roof_ms = own[by] * 1e3, terms[roof] * 1e3
    return {"cell": label, "dtype": dtype, "flops": stats["flops"],
            "hbm_floor_bytes": stats["hbm_floor_bytes"], "io_bytes": io,
            "aten_ops": stats["n_ops"], "bound_ms": bound_ms,
            "bound_by": by, "roofline_ms": roof_ms, "roofline_by": roof,
            "measured_ms": measured_ms,
            "measured_over_bound": measured_ms / bound_ms,
            "measured_over_roofline": measured_ms / roof_ms,
            "count_seconds": round(time.perf_counter() - t0, 3)}


def phase_dryrun(lm, gnn, train):
    """Every model cell timed in phases lm, gnn and train, counted on
    meta at the shapes it was timed at (the cells' own builders; the
    GNN cuts of GNN_CUTS), with its roofline bound and measured / bound.
    Nothing runs on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import (LM_SHAPES, _lm_decode_builder,
                                          _lm_prefill_builder)

    t0 = time.perf_counter()
    rows = []
    spec = get_arch(LM_FULL)
    dtype = spec.make_config().dtype
    for shape, B in LM_TIMED:
        s = LM_SHAPES[shape]
        make = (_lm_prefill_builder if s["kind"] == "prefill"
                else _lm_decode_builder)
        fn, args = make(spec.make_config, s["seq"], B)()
        rows.append(dryrun_row(
            f"{LM_FULL} {shape} B={B}", fn, args, dtype,
            lm["timed"]["cells"][shape]["ms_median"]))
    for arch in GNN_ARCHS:
        for cell in GNN_CELLS:
            step, (p, o, b) = get_arch(arch).cells[cell].build()
            seeds, b = cut_cell(arch, cell, b)
            label = f"{arch} {cell}" + (f" seeds={seeds}"
                                        if cell == "minibatch_lg" else "")
            rows.append(dryrun_row(
                label, step, (p, o, b), "float32",
                gnn["cells"][arch][cell]["ms_per_step_median"]))
    step, args = get_arch("din").cells["train_batch"].build()
    rows.append(dryrun_row(f"din train_batch B={train['batch']}", step,
                           args, "float32", train["ms_per_step_median"]))
    return {"cells": rows, "peaks": "H100 SXM data sheet: bf16 989, "
            "float32 67 TFLOP/s, HBM3 3.35 TB/s (at 700 W)",
            "seconds": round(time.perf_counter() - t0, 3)}


# --------------------------------------------------------------------------
# Two checkouts in turns
# --------------------------------------------------------------------------

def cluster_sweep(module, choice, sizes, fn, K, what):
    """{C: ms} of ``fn``, a call of a kernel whose launch shape
    ``module.choice`` picks (K3's, K4's or K6's cluster, K5's warps per
    CTA), with that choice set to each C of ``sizes`` up to K; {} for a
    package without that choice (one from before the redesign)."""
    pick = getattr(module, choice, None)
    if pick is None:
        return {}
    out = {}
    try:
        for C in sizes:
            if C <= K:
                setattr(module, choice, lambda *_, C=C: C)
                out[C] = device_ms(fn, 50, f"{what} C={C}")
    finally:
        setattr(module, choice, pick)
    return out


def phase_ab(ks, card, src):
    """``--ab SRC``: on the first main-path batch of yelp x1.0
    2dreach-comp and yelp x0.5 2dreach at their steady capacity, K1 in
    every mode, K2, and the descent, count and collect scans (K3-K5) on
    ``phase_timing``'s operands; fused and two-phase reach end to end
    (``e2e_us``, obs off); K6 on the first 6-gon batch of yelp
    x1.0 comp (``phase_timing_slice3``'s operands); DIN's serve shapes
    end to end (``serve_shape``) and the history's item embedding
    (``din._embed_items``) alone, with the ``repro_torch`` package under
    ``src``.  The inputs are made the same way by any checkout of the
    port, so two checkouts can be timed in turns on one card (parent,
    change, change, parent).  K4 and K6 are also timed at each cluster
    size of SWEEP_CLUSTERS (``cluster_sweep``).  Before all of these,
    ``ab_build_scan``: K7 and K9 per launch and summed; then K10 on both
    serve batches' bags and at each segments-a-warp of SWEEP_SEGMENTS
    (``ab_bags``); then the launch floor."""
    from repro_torch.core import QueryEngine, build_index
    from repro_torch.core import engine as core_engine
    from repro_torch.data import get_dataset, polygon_workload, workload

    indexes = {}
    for ds, scale, method in CONFIGS:
        g = get_dataset(ds, scale=scale)
        us, rects = workload(g, N_QUERIES, extent_ratio=0.05)
        indexes[f"{ds}x{scale} {method}"] = (g, method, build_index(
            g, method), us, rects)
    # K7, K9 and K10 first, as in the full run, where every kernel has
    # run before the first profiled window: in a run that first launched
    # K7 and K9 after K1-K6's windows, the profiler kept no device event
    # of most of their windows
    bitset, range_query = ab_build_scan(ks, indexes)
    cfg, params, cpu_params, recsys_batches = din_setup()
    bags = ab_bags(ks, params, recsys_batches)
    floor = launch_floor_ms()
    scan_sums = scan_launch_sums(ks, indexes)
    fused, prune, kcaps, scans, polygon, e2e = {}, {}, {}, {}, {}, {}
    for name in (next(iter(indexes)), list(indexes)[-1]):
        g, method, idx, us, rects = indexes[name]
        eng = QueryEngine(idx)
        serve_all(eng, us, rects)              # to the steady capacity
        args = fused_args(eng, us[:BATCH], rects[:BATCH])
        args = tuple(a.clone() for a in args)
        kcap = kcaps[name] = min(eng._kb_hwm, eng.n_tiles)
        nt = eng.n_tiles
        fused[name] = {}
        for mode in MODES:
            fused[name][mode] = device_ms(
                lambda: ks.fs.fused_serve(*args, mode=mode, kcap=kcap, nt=nt,
                                          device=DEVICE),
                50, f"fused_serve ({name} {mode})")
        pargs = (eng._arena.fine, eng._arena.coarse, *args[6:])
        prune[name] = device_ms(
            lambda: ks.ds.prune_tiles(*pargs, device=DEVICE), 50,
            f"prune_tiles ({name})")
        # the scans on the plain prune's candidates at the two-phase
        # path's steady K
        serve_all(eng, us, rects, two_phase=True)
        # end to end with the package's obs hooks off (the default): their
        # disabled cost, against a parent without them; E2E_REPEATS times
        # each, in turns, the host's spread beside the median
        e2e[name] = {"fused": [], "two_phase": []}
        for _ in range(E2E_REPEATS):
            for path in e2e[name]:
                e2e[name][path].append(e2e_us(
                    eng, us, rects, "reach", two_phase=path == "two_phase"))
        for path, runs in list(e2e[name].items()):
            e2e[name][path] = {"median": float(np.median(runs)),
                               "runs": runs}
        arena = arena_of(eng)
        rsoa, qs, qe = args[6:]
        K = eng._kb_hwm
        cand, _ = ks.fs.compact_ascending(ks.ds.prune_tiles_torch(*pargs), nt)
        ck = ks.ds.take_candidates(cand, K)
        scans[name] = {"K": K}
        for mode in MODES:
            kname = SCANS[mode]
            a = ((ck, arena["esoa"], arena["ids"], rsoa, qs, qe)
                 if mode == "collect" else (ck, arena["esoa"], rsoa, qs, qe))
            scans[name][kname] = device_ms(
                lambda: ks.wrap[kname](*a, device=DEVICE), 50,
                f"{kname} ({name})")
        a = (ck, arena["esoa"], rsoa, qs, qe)
        a5 = (ck, arena["esoa"], arena["ids"], rsoa, qs, qe)
        scans[name]["count_scan_by_cluster"] = cluster_sweep(
            ks.an, "scan_cluster_size", SWEEP_CLUSTERS,
            lambda: ks.an.count_scan(*a, device=DEVICE), K,
            f"count_scan ({name})")
        scans[name]["descent_scan_by_cluster"] = cluster_sweep(
            ks.ds, "scan_cluster_size", SWEEP_CLUSTERS,
            lambda: ks.ds.descent_scan(*a, device=DEVICE), K,
            f"descent_scan ({name})")
        scans[name]["collect_scan_by_warps"] = cluster_sweep(
            ks.an, "collect_warps", SWEEP_WARPS,
            lambda: ks.an.collect_scan(*a5, device=DEVICE), K,
            f"collect_scan ({name})")
        if polygon:
            continue
        # K6: the main path's polygon batches, then the first one's
        # operands as the engine assembles them
        pus, ppolys = polygon_workload(g, N_QUERIES, n_edges=POLY_EDGES,
                                       extent_ratio=0.05, seed=0)
        batches = [(pus[s:s + BATCH], ppolys[s:s + BATCH])
                   for s in range(0, len(pus), BATCH)]
        batches += [mixed_polygons(g, lo, hi, 10 * i)
                     for i, (lo, hi) in enumerate(POLY_MIXED)]
        for u, p in batches:
            eng.polygon_batch(u, p)
        with Capture(core_engine, "polygon_scan",
                     lambda c, *a: c.numel()) as k6:
            eng.polygon_batch(*batches[0])
        _, a6, kw = k6.best
        a6 = tuple(t.clone() for t in a6)
        run6 = lambda: ks.an.polygon_scan(*a6, ne=kw["ne"], device=DEVICE)
        polygon = {"index": name, "K": a6[0].shape[1], "ne": kw["ne"],
                   "ms": device_ms(run6, 50, f"polygon_scan ({name})"),
                   "by_cluster": cluster_sweep(
                       ks.an, "scan_cluster_size", SWEEP_CLUSTERS, run6,
                       a6[0].shape[1], f"polygon_scan ({name})")}
    import torch
    from repro_torch.models.recsys import din

    serve = {}
    for shape, batch in recsys_batches.items():
        rec = serve_shape(ks, shape, params, cpu_params, cfg, batch)
        serve[shape] = {k: rec[k] for k in ("e2e_us_per_batch",
                                            "device_busy_us_per_batch",
                                            "device_top", "max_abs_err")}
        items = torch.as_tensor(batch["hist_items"], device=DEVICE)
        serve[shape]["embed_history_ms"] = device_ms(
            lambda: din._embed_items(params, items, cfg), 5,
            f"_embed_items ({shape} history)")
    emit("ab", src=src, card=card, B=BATCH, kcap=kcaps,
         e2e_reach_us_per_query=e2e, fused_serve=fused,
         prune_tiles=prune, scans=scans, scan_sums=scan_sums,
         polygon_scan=polygon, din=serve, segment_bag=bags,
         bitset_mm=bitset, range_query=range_query, launch_floor_ms=floor,
         timers=TIMERS)


def ab_bags(ks, params, batches):
    """``--ab``'s K10: ``segment_bag_timing`` on the packed bags of each
    serve batch's histories over DIN's item table (``bag_inputs``, as
    ``bag_path`` packs them), and K10 at each forced segments-a-warp of
    SWEEP_SEGMENTS (``cluster_sweep``; {} for a package without
    ``warp_segments``); on serve_bulk's bags also over the table's first
    BAG_TABLE_ROWS rows (0.7 to 50 MB against the 72 MB table and the 50
    MB L2), the same bags with each index modulo the rows."""
    import torch
    from repro_torch.kernels.segment_bag import ops as sbo

    table = params["item_emb"]["emb"]
    out = {}
    for shape, batch in batches.items():
        idx, offsets = bag_inputs(batch)
        B = len(offsets) - 1
        ops = (table, *(torch.as_tensor(a, device=DEVICE)
                        for a in ks.sb.pack_bags(idx, offsets)))
        out[shape] = segment_bag_timing(ks.sb, ops, offsets, B)
        out[shape]["by_warp_segments"] = cluster_sweep(
            sbo, "warp_segments", SWEEP_SEGMENTS,
            lambda: ks.sb.segment_bag(*ops, n_segments=B, device=DEVICE), B,
            f"segment_bag ({shape})")
        if shape != "serve_bulk":
            continue
        out[shape]["by_table_rows"] = {}
        for V in BAG_TABLE_ROWS:
            cut = (table[:V], ops[1] % V, *ops[2:])
            out[shape]["by_table_rows"][V] = device_ms(
                lambda: ks.sb.segment_bag(*cut, n_segments=B,
                                          device=DEVICE), 20,
                f"segment_bag ({shape}, {V} rows)")
    return out


def scan_launch_sums(ks, indexes):
    """``--ab``'s K3 and K5 summed over their main-path launches: each
    index's two-phase serving of the workload, twice, after two fused
    passes, and the two-phase kNN on the first index, as phase main
    serves them; every launch captured (``Capture``), then all of a
    kernel's launches run again in order in one profiled window, whose
    device time is their sum.  Each launch's bound from its own
    operands (the true candidate counts from the plain prune), summed
    beside it."""
    from repro_torch.core import QueryEngine
    from repro_torch.core import engine as core_engine

    modes = {"descent_scan": "reach", "collect_scan": "collect"}
    calls = {k: [] for k in modes}
    for i, (name, (g, method, idx, us, rects)) in enumerate(
            indexes.items()):
        eng = QueryEngine(idx)
        for _ in range(2):
            serve_all(eng, us, rects)
        with Capture(core_engine, "descent_scan", lambda *a: 0) as k3, \
                Capture(core_engine, "collect_scan", lambda *a: 0) as k5:
            for _ in range(2):
                serve_all(eng, us, rects, two_phase=True)
            if i == 0:
                u, r = us[:KNN_QUERIES], rects[:KNN_QUERIES]
                pts = ((r[:, :2] + r[:, 2:]) / 2).astype(np.float32)
                QueryEngine(idx, path="two_phase").knn_batch(u, pts, KNN_K)
        for kname, cap in (("descent_scan", k3), ("collect_scan", k5)):
            calls[kname] += [(eng, a, kw) for a, kw in cap.calls]
    rec = {}
    for kname, launches in calls.items():
        fn = ks.wrap[kname]
        bms = 0.0
        for eng, a, _ in launches:
            ck, (rsoa, qs, qe) = a[0], a[-3:]
            _, cnt = ks.fs.compact_ascending(ks.ds.prune_tiles_torch(
                eng._arena.fine, eng._arena.coarse, rsoa, qs, qe),
                eng.n_tiles)
            bms += scan_bound(ck, cnt, eng._arena.entries, rsoa, qs, qe,
                              modes[kname])[0]
        rec[kname] = {
            "launches": len(launches),
            "ms": device_ms(lambda fn=fn, launches=launches: [
                fn(*a, **kw) for _, a, kw in launches], 5,
                f"{kname} (main-path launches)"),
            "bound_ms": bms, "K": sorted({a[0].shape[1]
                                          for _, a, _ in launches})}
    return rec


def ab_build_scan(ks, indexes):
    """``--ab``'s K7 and K9: each index built again with
    ``backend="device"``, every closure-product launch captured
    (``Capture``, as ``phase_device_build`` does) and summed
    (``bitset_launch_sums``, with each index's largest launch); the
    leaf-scan engine over each index's workload, host- and device-built,
    every K9 launch captured and summed (``range_query_launch_sums``),
    and K9 on ``range_query_cases`` (the first batch of yelp x1.0 comp
    and x0.5 base, the random arena at dims 2 and 3)."""
    from repro_torch.core import build_index
    from repro_torch.core import reachability

    k7_calls, k9_calls, ops = {}, {}, {}
    for name, (g, method, idx, us, rects) in indexes.items():
        with Capture(reachability, "bitset_mm",
                     lambda a, r: a.shape[0] * r.shape[1]) as k7:
            dev = build_index(g, method, backend="device")
        k7_calls[name] = [args for args, _ in k7.calls]
        for built_on, ix in (("host", idx), ("device", dev)):
            with Capture(ks.ls, "range_query", lambda *a: 0) as k9:
                leafscan_pass(ks.ls, ix, us, rects)
            k9_calls[f"{name} {built_on}-built"] = [
                (a, k["dim"]) for a, k in k9.calls]
        ops[name] = k9_calls[f"{name} host-built"][0]
    bitset = bitset_launch_sums(ks.bm, k7_calls)
    range_query = {"cases": time_range_query(ks, range_query_cases(ops)),
                   "launch_sums": range_query_launch_sums(ks.ls, k9_calls)}
    return bitset, range_query


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def phase_build(_build):
    """Every kernel source of the checkout, one ``nvcc`` each, all
    started together."""
    def one(name):
        t0 = time.perf_counter()
        lib, log = _build.build(name)
        return {"library": lib.name, "seconds": round(time.perf_counter()
                                                      - t0, 3),
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Compiling entry" in ln]}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        futs = {name: ex.submit(one, name) for name in _build.SOURCES}
        built = {name: f.result() for name, f in futs.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3), sources=built)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="SRC",
                    help="time K1-K7, K9, K10 and DIN's serving with "
                         "the package under SRC only (phase_ab)")
    a = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.ab) if a.ab else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    ks = Kernels()

    card = card_line()
    print(card, flush=True)
    if a.ab:
        phase_build(_build)
        phase_ab(ks, card, a.ab)
        return 0
    import scipy

    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         scipy=scipy.__version__, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    phase_build(_build)

    errs = phase_kernels(ks)
    results, two_phase, knn, polygons, engines, indexes = phase_main(ks)
    emit("main", launches={r["index"]: r["launches"] for r in results},
         indexes=results, two_phase=two_phase, knn=knn, polygons=polygons)
    emit("obs", ok=True, **phase_obs(ks, engines, indexes))
    builds, largest, built, k7_calls = phase_device_build(ks, indexes,
                                                          engines)
    scc = phase_scc(ks, indexes)
    emit("scc", ok=True, **scc)
    leafscan, ls_ops, k9_calls, errs4 = phase_legacy(ks, indexes, built,
                                                     results, engines)
    for k, v in (*errs4.items(),
                 *phase_main_batches(ks, engines, ls_ops).items()):
        errs[k] = max(errs[k], v)
    paper = phase_paper(ks)
    emit("paper", ok=True, **paper)
    resil = phase_resilience(ks, engines, indexes)
    emit("resilience", ok=True, **resil)
    dyn, dyn_host, dyn_ops = phase_dynamic(ks)
    emit("dynamic", ok=True, **dyn)
    clu = phase_cluster(ks, engines, indexes, built, dyn_host, dyn_ops)
    emit("cluster", ok=True, **clu)
    del built, dyn_host, dyn_ops

    per_mode, two, floor = phase_timing(ks, engines, card)
    slice3, errs3 = phase_timing_slice3(ks, engines, indexes, largest,
                                        k7_calls, card)
    for k, v in errs3.items():
        errs[k] = max(errs[k], v)
    slice4, k9_sums = phase_timing_slice4(ks, engines, indexes, ls_ops,
                                          k9_calls, card)
    bag_paths, bag_err, bag_timed = phase_recsys(ks, card)
    errs["segment_bag"] = max(errs["segment_bag"], bag_err)
    lm = phase_lm(ks, card)
    emit("lm", ok=True, **lm)
    gnn = phase_gnn(ks, card)
    emit("gnn", ok=True, **gnn)
    emit("obs_trace", ok=True, **phase_obs_trace(ks, engines))
    srv = phase_serve(ks, engines, indexes)
    emit("serve", ok=True, **srv)
    train = phase_train(ks)
    emit("train", ok=True, **train)
    emit("dryrun", ok=True, **phase_dryrun(lm, gnn, train))
    # launches on the main path, per path: each index's fused serving,
    # its two-phase serving, polygons, device build and leaf-scan
    # serving (host- and device-built), the two kNN runs, perf_build's
    # device builds, each perf_queries class and path, and the resilient
    # engine's healthy, retried and two-phase batches
    per_path = {k: {} for k in KERNELS}
    for r in results:
        per_path["fused_serve"][f"{r['index']} fused"] = r["launches"]
    for r in two_phase:
        for k in ("prune_tiles", *SCANS.values()):
            per_path[k][f"{r['index']} two_phase"] = r["launches"][k]
    for r in polygons:
        for k in ("prune_tiles", "polygon_scan"):
            per_path[k][f"{r['index']} polygon"] = r["launches"][k]
    for r in builds:
        for k in ("bitset_mm", "seg_mbr"):
            per_path[k][f"{r['index']} device_build"] = r["launches"][k]
            per_path[k][f"{r['index']} device_build gather"] = r[
                "gather"]["build_launches"][k]
    for path in ("fused", "two_phase"):
        for k, n in knn[path]["launches"].items():
            if n:
                per_path[k][f"{knn['index']} knn {path}"] = n
    for r in leafscan:
        per_path["range_query"][
            f"{r['index']} leafscan {r['built_on']}-built"] = r["launches"]
    pb, pq = paper["perf_build"], paper["perf_queries"]
    for k, n in pb["launches"].items():
        if n:
            per_path[k][f"{pb['config']} perf_build device_build"] = n
    for case, counts in pq["launches"].items():
        for k, n in counts.items():
            per_path[k][f"{pq['config']} perf_queries {case}"] = n
    for case in ("healthy", "retry", "two_phase"):
        for k, n in resil[case]["launches"].items():
            if n:
                per_path[k][f"{resil['engine']} resilience {case}"] = n
    for k, n in dyn["build_launches"].items():
        per_path[k][f"{dyn['config']} dynamic build"] = n
    for r in dyn["overlays"]:
        per_path["fused_serve"][
            f"{dyn['config']} dynamic overlay {r['overlay_size']}"] = \
            r["fused_serve_launches"]
    for k, n in dyn["class_launches"].items():
        per_path[k][f"{dyn['config']} dynamic count/collect/polygon"] = n
    for i, c in enumerate(dyn["compactions"]):
        per_path["bitset_mm"][f"{dyn['config']} dynamic compaction {i}"] = \
            c["bitset_mm"]
        per_path["seg_mbr"][f"{dyn['config']} dynamic compaction {i}"] = \
            c["seg_mbr"]
        if c["fused_serve_foreground"]:
            per_path["fused_serve"][
                f"{dyn['config']} dynamic compaction {i} foreground"] = \
                c["fused_serve_foreground"]
    for r in clu["engines"]:
        for path in ("fused", "two_phase"):
            for k, n in r[path]["launches"].items():
                per_path[k][f"{r['index']} cluster S={r['shards']} "
                            f"{path}"] = n
    for r in clu["shard_arenas"]:
        per_path["seg_mbr"][f"{r['index']} shard_arenas S={r['shards']}"] = \
            r["seg_mbr"]
    per_path["fused_serve"][f"{clu['dynamic']['config']} cluster dynamic"] \
        = clu["dynamic"]["fused_serve_launches"]
    for path, counts in srv["launches"].items():
        for k, n in counts.items():
            per_path[k][f"serve {path}"] = n
    per_path["segment_bag"] = bag_paths
    for k in KERNELS:   # the SCC and model paths launch no kernel
        per_path[k]["scc"] = scc["kernel_launches"].get(k, 0)
        per_path[k]["lm"] = lm["kernel_launches"].get(k, 0)
        per_path[k]["gnn"] = gnn["kernel_launches"].get(k, 0)
    emit("timers", **TIMERS)
    timed = {"fused_serve": per_mode["reach"], **two, **slice3,
             "range_query": {**slice4[next(iter(engines))],
                             "launch_sums": k9_sums},
             "segment_bag": bag_timed}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": CSRC + RECORD[k][0],
        "replaces": RECORD[k][1],
        "launches": sum(per_path[k].values()),
        "launches_per_path": per_path[k],
        "max_abs_err": errs[k], "tolerance": TOLERANCE[k],
        "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
        "bound_ms": timed[k]["bound_ms"], "bound_by": timed[k]["bound_by"],
        "library_ms": timed[k].get("library_ms"),
        **({"launch_floor_ms": floor} if k in SERVING else {}),
        **({"launch_sums": timed[k]["launch_sums"]["all"]}
           if "launch_sums" in timed[k] else {})}
        for k in KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
