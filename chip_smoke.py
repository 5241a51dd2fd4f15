#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (capital_tpu_torch) on one card.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with one NVIDIA H100.  It

1. builds the port's CUDA kernels from the checkout (nvcc, sm_90a) and
   prints the card (name and power limit, from nvidia-smi), the torch and
   CUDA versions and the build time;
2. holds every kernel of the cholinv path against its plain PyTorch version
   on the card, at the path's shapes (n=16384, bc=512: 8192-wide trmm/syrk
   windows, 512-wide leaves), in bf16 and f32 (f64: tri_matmul only), and
   times kernel, plain version and the nearest single PyTorch call with
   CUDA events beside the kernel's bound — tri_matmul in each call the path
   makes (CI::trsm in place, CI::inv's two steps, the second side R in
   place, CI::tmu's syrk) and in its dense form, each dtype on both its
   routes in the same run, interleaved (bf16 wgmma / wmma, f32 fma / simt,
   f64 dmma / simt); then NaN in the dead triangles on the wgmma route and
   an unaligned window, which must take the wmma route; the transposes and
   `copy_` with the per-call wall of back-to-back calls beside the kernels'
   own device time from a torch.profiler trace of the same calls;
3. drives the cholinv path, `models/cholesky.factor` in mode 'pallas':
   n=16384 bf16 (against the same factor through the plain versions, plus
   residual gates), n=8192 f32 (residual gates, timed), the n=49152 bf16
   flagship with bc=384 (timed, probe-vector residual gates, and one factor
   traced with torch.profiler: device time by CI:: phase and kernel, idle
   share), the same flagship with tail_fuse_depth=1 (its 128 leaves of 384
   each one fused_tail launch on the cluster route: the plan, the probe
   gates, within 2e-2 of the unfused factor, timed beside it), and (3d) n=16384 f64 bc=512, the reference's own precision
   (residual gates 1e-13, against the same factor through the plain
   versions, timed, profiled by CI:: phase) — each with the launch counters
   set to 0 just before and checked just after against what the plan
   predicts;
4. holds the CholeskyQR2 kernels (gram_blocked, scale_gram, scale_blocked)
   against their plain versions at the 2,097,152 x 1024 QR flagship (bf16
   and f64) and at 65536 x 512 f32 and f64, timed beside their bounds and
   library calls (at 65536 x 512: kernel and library call timed twice, in
   turns), every launch on its dtype's route (bf16 wgmma, f32 fma, f64
   dmma);
5. drives the CholeskyQR2 path, `models/qr.factor` in mode 'pallas': the
   2,097,152 x 1024 bf16 flagship (timed, gated, and profiled: the trace's
   launches of the gram and scale kernels must equal the counted run's),
   65536 x 512 f32 and f64 (also against the same factor through the
   plain versions), 2,097,152 x 1024 f64 (the reference's precision at
   the flagship's shape: timed, peak memory, profiled by CQR:: phase),
   65536 x 4096 bf16 (both grams through cholinv at bc=128), CQR1 at
   65536 x 1024 bf16, and a robust f32 run with a rank-deficient gram
   injected — each with the counters set to 0 just before and checked just
   after against the plan, and the orthogonality and residual gates of
   bench/drivers.py (5e-2 bf16, 5e-5 f32, 1e-13 f64);
6. holds the small-N batched kernels (potrf, potrs, posv, lstsq) against
   their plain versions, timed beside their bounds and library calls, at
   the serve latency bucket (8 problems, n=128, 8 right-hand sides, f32)
   and at a throughput batch (8192 problems of n=128; lstsq 2048 of
   512 x 128), f32 and bf16; potrf, potrs and posv also by their device
   time from a trace, beside cholesky_ex's, cholesky_solve's and
   linalg.solve's; posv bit for bit potrs(potrf(A), B), timed beside that
   pair; potrs also on the lower factor (bit for bit the upper one's
   answer) and, at the latency batch, with k = n = 128 (serve's inv) on
   both uplo;
7. drives the small-N serve path: ragged posv / lstsq / inv requests
   through `batching.bucket_for` -> `pad_operands` -> `assemble` ->
   `api.batched` -> `crop` under impl auto, pallas and pallas_split (and
   one f64 bucket each, which takes the library route), with the counters
   set to 0 just before each call and checked just after, the residual
   gates of bench/drivers.py against an f64 host reference, the pallas
   and vmap routes against each other, identity-tail exactness and NaN
   containment;
7b. drives the port's serve engine, `serve.SolveEngine` on the card, at
   the reference serve smoke's configuration (capital_tpu/serve/__main__.py
   :146-172) at phase 7's widths: 252 seeded requests (ragged f32 posv /
   lstsq / inv, posv_blocktri, posv_arrowhead, f64 posv on the library
   route, guaranteed f64 posv, four oversize n = 1024 posv on the single
   route), warmed up, then sent in turns through a continuous and a sync
   engine (continuous, sync, sync, continuous), sleeping past max_delay_s
   and pumping every 7th submit; every bucket program one CUDA graph,
   its launches and routes at capture held to its plan; every response
   ok under the drivers' residual gates; no build after warm-up; one
   continuous turn profiled, whose trace must hold replays x plan
   records of each kernel; 100 % complete span chains; every program's
   replay bit for bit its eager `api.batched` program on one assembled
   batch, both timed in turns; prints the latency split, occupancy, idle
   share and the replay / eager walls;
7c. drives factor residency and streaming sessions through the engine:
   a seeded 50-request residency stream shaped like the reference's
   residency smoke (capital_tpu/bench/drivers.py:1578: posv_cached misses
   seed five tokens, then chol_update / chol_downdate / posv_cached hits)
   at n = 128 f32 with k 1 and 8 and one f64 token on the library route,
   a poisoned update (refused, the resident R bit for bit unchanged),
   downdates at the edge of definiteness that the f32 sweep flags and the
   engine degrades to a refactor, one beyond it (fails loudly), and a pool
   small enough to evict (an evicted token's update fails loudly, a miss
   reseeds it); then the session flagship of Makefile:164-169 through
   `SessionManager`: a 64-block window of 128, f32, open, a cycle of
   append 8 + contract 8 + solve at each of the 'balanced', 'fast' and
   'guaranteed' tiers (solve and reconstruction residuals against the
   marginalized window in f64 numpy under the f32 gate), extend from the
   resident carry bit for bit the refactor of the whole chain, one
   eviction (SessionEvicted) and its reseed.  The six kernels of these
   programs (small.potrf, small.potrs, up.sweep, bt.factor,
   bt.forward_solve, bt.solve_backward) launch, every program is captured
   with the plan it predicts, each replay is bit for bit its eager
   program, the same streams on the plain versions agree within the f32
   tolerance, and a profiled turn's trace holds replays x plan records;
   prints the sliding cycle against a full refactor of the window, the
   factor_cache and session_stats blocks and the idle share;
7d. drives the serve front end through its entry points: the CLI
   (`python -m capital_tpu_torch.serve smoke --trace`, in process) at the
   reference smoke's configuration, cold and then warm on one persist_dir
   (the warm run builds only what the warm-up manifest foresaw:
   `--max-compiles 0`; profiled, its chain kernels counted); the
   single-engine A/B `loadgen.compare` (sync against continuous, 256
   closed-loop requests from 16 clients, posv / lstsq at n 32/64/128,
   nrhs 1/8/64, phase 7b's ladders, 50 ms telemetry windows, traces) with
   every response under the residual gates, no build after warm-up, valid
   windows and complete chains; one continuous run profiled (trace records
   = replays x plan, idle share) and one under cProfile (host time a
   request by engine stage); `loadgen.compare_replicas` with one and two
   process replicas on the card and process clients (scaling efficiency,
   no drop, no build after warm-up); and the `replicas` CLI — a cold run of
   thread replicas (profiled: the guaranteed quarter of the posv requests
   runs potrf and potrs) warming the manifest, then two process replicas
   on the warm directory with a kill (the replacement warms from the
   manifest and serves with no build) and a drain + resume; then hands
   the phase's ledgers to the port's obs CLI (`python -m
   capital_tpu_torch.obs`, in process) under the reference Makefile's
   gates: serve-report on the smoke (hit rate 1.0, small-bucket p99 and
   queue wait under 30 s), on the A/B (hit rate 1.0, occupancy 0.25 —
   reported when it fails, as the A/B's many small buckets make it —
   queue wait under 60 s; every chain complete, at least 3 windows) and
   --aggregate on both router ledgers (2 replicas, hit rate 1.0); the
   timeline's Chrome export of the smoke and the A/B, span for span the
   traced requests' chains; robust-gate; the A/B's diff against itself;
   each command's report on a line with the card;
8. holds the four kernels of the triangular-inversion slice against their
   plain versions, timed beside their bounds and library calls:
   write_diag_blocks (96 blocks of 512² bf16 into a NaN-filled 49152²
   buffer, 16 of 512² f32 into 8192², f32 into bf16 at 96 x 512², and
   s = 100 bf16 on the 'elem' route; every launch on its route, the
   buffer bit for bit the plain version's, the 'elem' route through the C
   entry bit for bit the same; wall and device time beside copy_),
   fused_tail (windows of 128 on the block route and of 256, 384
   and 512 on the cluster route, bf16 and f32, healthy — bit for bit the
   kernel's own column-sweep path — and with faults, every launch on its
   route; timed, also by device time), batched trsm (8 and 8192 problems of n=128, k=8, f32, every
   uplo x trans) and the TSQR panel QR (8192 panels of 256 x 128 f32);
9. drives the rectri path, `models/inverse.rectri` in mode 'pallas': the
   n=49152 bf16 flagship with bc=512 (timed, row-blocked inverse-residual
   gate, one run profiled by RT:: phase), n=8192 f32 against the same
   inverse through the plain versions, and uplo 'U' once;
10. drives `models/trsm.solve` at n=32768 with 8192 bf16 right-hand sides
    (invert leaves, mode 'xla'; timed, the five gates of bench/drivers.py) and
    `inverse.newton` at n=8192 f32 (iterations, residual gate) — neither
    launches a kernel of the port;
11. drives cholinv with the fused tail at n=16384 bf16: bc=128 at depth 2
    (32 windows of 512 on the cluster route) and bc=64 at depth 1 (128
    windows of 128 on the block route), each against the unfused factor
    (bc=128), residual gates, timed beside it, and a robust run with a bad
    pivot planted in one leaf window whose info must equal the unfused
    factor's;
12. drives `ops/tsqr.tsqr(impl='auto')` at 2,097,152 x 128 f32 (14 panel
    kernel launches; orthogonality, residual, R against the library
    route's up to row signs; timed beside that route);
13. holds the four block-tridiagonal scan-step kernels (fused_forward,
    factor, forward_solve, solve_backward) against their plain versions:
    chain blocks of 128 with seg = 8 at k = 1, 64, 33 (the arrowhead's
    k + s) and 257 (the Spike interiors' k + 2b), b = 16 at the Spike
    flagship's k + 2b = 34, 8 and 264 problems, f32 and bf16, every
    step's launch on its route (`blocktri_small.chain_route`: 'blocked')
    and column split (`rhs_splits`), each bit for bit its 'sweep' route
    through the C entry and the solve steps also unsplit; timed beside
    bound, plain version and the library route, and by device time and
    `queued_ms`; NaN, −inf and indefinite blocks injected into one problem
    of the factor steps, NaN / −inf right-hand sides, zero / NaN diagonals
    of L and NaN couplings into the solve steps, on both routes (bit for
    bit the same);
14. drives the structured path through its entry points: blocktri.posv at
    the flagship (64 blocks of 128, f32, one problem, one RHS) under
    'pallas', 'auto' (partitioned) and 'xla' (one run profiled by BT::
    phase), factor / solve / extend / contract there, 128 such problems
    (pallas and xla), arrowhead.posv at s = 32 (pallas and auto), the
    Spike flagship (64 blocks of 16, two problems, two RHS),
    banded.solveh_banded at n = 8192, u = 128 (profiled by BT:: phase),
    and the serve ops posv_blocktri and posv_arrowhead (ragged requests
    through bucketing, auto / pallas / vmap, f64 buckets, a poisoned
    problem) — each with the drivers' residual gates, every factor step's
    launch on the blocked route; then the flagship (64 blocks of 128) and
    the Spike geometry (64 blocks of 16) on the kernel and library routes
    in turns, each with a profiled call's idle share;
15. holds the rank-k update's rotation-sweep kernel against its plain
    version bit for bit (R' and info): update and downdate, f32 and bf16,
    at (8, 128, k) for k = 1, 8, 64 and (8192, 128, 8), each through the
    wrapper (its launch checked on `update_small.sweep_route`'s route) and
    the other route through the C entry, with the f64 residual gate of
    bench update, timed (wall and device time, both routes) beside bound,
    plain version and the refactor from the resident state; NaN / ±inf on
    R's diagonal, in its dead lower triangle and in V, and an infeasible
    downdate, each in one problem of 8 and of 1056, on both routes;
16. drives the update and refinement paths: the bench-update flagship
    (n = 1024, k = 16, batch 2, f32: the panel scan, no kernel) against
    the refactor, `api.batched("chol_update" | "chol_downdate")` at
    (8, 128, 8) f32 on 'auto', 'pallas' (the sweep on its 'wave' route),
    'vmap' and f64 (plus a padded bucket cropped), the bench-refine
    flagship (batch 4, n = 1024, nrhs 4, f64 at cond 1e5, tier
    'guaranteed' against the straight f64 solve,
    each problem's backward error also recomputed in NumPy on the host;
    profiled by IR:: phase), guaranteed posv and lstsq and the fast tier
    at the serve bucket, and guaranteed posv_blocktri on the scan route;
17. holds the mesh schedule's per-rank kernel, sched_matmul, against its
    plain version: the cholinv flagship's top-node slabs of one rank of a
    2x2x1 mesh (4096 x 8192 @ 8192 x 4096, blocks 512³) and a 128-block
    case (256 x 512 @ 512 x 256), bf16, f32 and f64 each on both its routes,
    tri_side 'a' and 'b', the padded rank and the full one; timed (the full
    rank; both routes, interleaved) beside its bound, the plain version and
    one torch.matmul of the pre-masked slabs;
18. drives the mesh path on a 2x2x1 in-process mesh of the card
    (`Grid.rect(2, 2, 1, devices=[cuda] * 4)`, mode 'explicit'; its
    collectives are copies and sums inside the one card, so no
    communication is measured): (a) cholinv n=16384 bf16 bc=512 (BASELINE
    row "2x2 MPI grid, N=16384": residual gates, against the single-device
    factor, timed beside it, peak memory, one run profiled by CI::
    phase), (b)
    cholinv n=8192 f32 bc=256 against the same factor through the plain
    versions, (c) rectri n=16384 bf16 bc=512, (d) cholinv n=2048 f32 on a
    2x2x2 mesh (the c > 1 route, no kernel), and (e) cholinv n=16384 f64
    bc=512 (residual gates 1e-13, against the single-device f64 factor,
    timed beside it) — each with the counters set to 0 just before and
    checked just after: sched_matmul launches d² = 4 per trmm that the
    sched gate routes, every other kernel 0;
19. prints the `kernels` JSON line (each bt.* kernel's launches from the
    main path's own run: the flagship 'pallas' posv for fused_forward and
    solve_backward, the factor for factor, the solve for forward_solve;
    up.sweep's from the api.batched("chol_update") 'auto' call;
    sched_matmul's from phase 18a's counted run; the dense tri_matmul, on
    no path, with 0), the nvidia-smi line, and last
    {"ok": true, "device": {...}}.

Phases 3, 5, 7, 7b, 7d, 9–12, 14, 16 and 18 set every launch counter to 0 just
before their runs and check the counts just after against the plan (7b:
the counts move at capture, not at a replay; the trace counts the replays);
phases 3, 4, 5, 9, 11, 17 and 18 also check that every tri_matmul and
sched_matmul and qr_fused launch took its dtype's route (bf16 wgmma, f32
fma, f64 dmma), phases 3, 8 and 11 that every fused_tail launch took
its window's route (block or cluster), and phases 15 and 16 that every
up.sweep launch took `update_small.sweep_route`'s (row or wave).

Any failed check raises, and the script exits non-zero without the last
line; so does a machine without CUDA or a directory without the package.
f32 matmuls run in full IEEE f32: TF32 is switched off below.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# dense bf16 tensor / f32 FMA / f64 tensor-core rate (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.float64: 67e12}
PATH_KERNELS = ("tri_matmul.trmm", "tri_matmul.syrk", "transpose", "transpose_pair",
                "zeros_dead_lower")
QR_KERNELS = ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked")
SMALL_KERNELS = ("small.potrf", "small.potrs", "small.posv", "small.lstsq")
#: the triangular-inversion slice's kernels
INV_KERNELS = ("write_diag_blocks", "fused_tail", "small.trsm", "tsqr.panel_qr")
#: the block-tridiagonal slice's kernels
BT_KERNELS = ("bt.fused_forward", "bt.factor", "bt.forward_solve", "bt.solve_backward")
#: the chain's scan steps, whose launches take a route (blocked / sweep)
CHAIN_ROUTED = BT_KERNELS
#: the update / refinement slice's kernel
UP_KERNELS = ("up.sweep",)
#: the mesh slice's kernel
MESH_KERNELS = ("sched_matmul",)
#: kernels whose launches are tallied by route; the route each dtype's
#: aligned windows take in tri_matmul and sched_matmul (and every launch of
#: the CholeskyQR2 kernels), and the element-load loop each dtype's other
#: tri_matmul and sched_matmul windows take
ROUTED = ("tri_matmul.trmm", "tri_matmul.syrk", "tri_matmul.dense", "sched_matmul") + QR_KERNELS
ROUTE_OF = {torch.bfloat16: "wgmma", torch.float32: "fma", torch.float64: "dmma"}
ELEM_OF = {torch.bfloat16: "wmma", torch.float32: "simt", torch.float64: "simt"}
DTYPE_BY_NAME = {"f32": torch.float32, "bf16": torch.bfloat16}
#: phase 15's sweeps (batch, n, k): the serve bucket's largest small-N n
#: over the nrhs_buckets rungs, and the throughput batch
UP_SHAPES = ((8, 128, 1), (8, 128, 8), (8, 128, 64), (8192, 128, 8))
#: phase 15's faults, each in problem 3 of (8, 128, 8) f32 and in problem
#: 1050 of (1056, 128, 8), whose block holds seven healthy problems:
#: (operand, index, value, sign); 'infeasible' scales that problem's V by 40
UP_FAULTS = {"nan_diag": ("R", (40, 40), float("nan"), 1.0), "inf_diag": ("R", (7, 7), float("inf"), 1.0),
             "-inf_diag": ("R", (90, 90), float("-inf"), 1.0), "nan_lower": ("R", (100, 3), float("nan"), 1.0),
             "inf_lower": ("R", (127, 64), float("inf"), 1.0), "nan_V": ("V", (55, 2), float("nan"), 1.0),
             "-inf_V": ("V", (0, 7), float("-inf"), -1.0), "infeasible": ("V", None, None, -1.0)}
#: phase 16: the bench-update flagship (n, k, batch; Makefile:117-121) and
#: the bench-refine flagship (batch, n, nrhs; Makefile:142-147)
UP_FLAGSHIP = (1024, 16, 2)
REFINE_FLAGSHIP = (4, 1024, 4)
#: phase 13's scan steps (batch, seg, b, k, dtypes, timed): chain blocks of
#: 128 with seg = 8 at k = 1 (the flagship posv's step, 8 problems), k = 64
#: (posv_blocktri's top nrhs rung), k + s = 33 (the arrowhead flagship's
#: widened RHS) and k + 2b = 257 (Spike interiors at b = 128); the Spike
#: flagship's interiors (2 problems x 8 partitions of 7 blocks of 16, k + 2b
#: = 34); and 264 = 132·2 problems (the step's full-wave batch)
BT_GEOMS = ((8, 8, 128, 1, ("f32", "bf16"), True), (8, 8, 128, 64, ("f32", "bf16"), False),
            (8, 8, 128, 33, ("f32",), False), (8, 8, 128, 257, ("f32", "bf16"), True),
            (16, 7, 16, 34, ("f32", "bf16"), True), (264, 8, 128, 1, ("f32", "bf16"), True),
            (264, 8, 128, 33, ("f32",), True))
#: phase 14: the blocktri flagship (nblocks, b, batch, nrhs) of Makefile:63,
#: its throughput batch, the arrowhead flagship's border (Makefile:83), the
#: Spike flagship (Makefile:100) and the banded solve (n, u)
BT_FLAGSHIP = (64, 128, 1, 1)
BT_THROUGHPUT = 128
BT_BORDER = 32
BT_SPIKE = (64, 16, 2, 2)
BT_BANDED = (8192, 128)
#: the small-N shapes, (batch, m, n, k): the serve latency bucket
#: (ServeConfig.max_batch problems) and the throughput batches (A is
#: 537 MB either way; lstsq at the bench drivers' m = 4n)
SMALL_SHAPES = {
    "latency": {"square": (8, 128, 128, 8), "tall": (8, 512, 128, 8)},
    "throughput": {"square": (8192, 128, 128, 8), "tall": (2048, 512, 128, 8)},
}
#: (m, n) of each CholeskyQR2 run: the BASELINE.md "CAQR2 ... 2M x 1024"
#: flagship (bf16 and f64), its single-rank 65536 x 512 row (f32 and f64),
#: a wide gram whose factor goes through cholinv (n=4096, bc=128), CQR1 and
#: the robust run (n=1024)
QR_SHAPES = {"flagship": (2_097_152, 1024), "single_rank": (65536, 512), "wide": (65536, 4096),
             "cqr1": (65536, 1024)}
#: the inversion slice's shapes: write_diag_blocks (count, s) as the rectri
#: flagship writes them; the fused_tail windows (n, off, dest, buffer
#: edge), one per route and cluster window — 128 on the block route (the
#: leaves of bc=128 depth 0 and of bc=64 depth 1), 256–512 on the cluster
#: route (384 the flagship's leaves at depth 1, 512 the bc=128 depth-2
#: windows of phase 11, the main path's);
#: the TSQR panels (count, rows, n) of the QR flagship's leaves; rectri
#: (n, bc) — the bench flagship (drivers.pick_bc for rectri: 512) and the
#: f32 row; trsm (n, nrhs, bc, gate rhs); newton n; the fused-tail factor
#: (n, bc); tsqr (m, n)
INV_SHAPES = {"write_diag": (96, 512),
              "tail": ((128, 256, 384, 1024), (256, 256, 0, 512), (384, 384, 768, 1536), (512, 512, 0, 1024)),
              "panel": (8192, 256, 128),
              "rectri": (49152, 512), "rectri_f32": (8192, 512), "trsm": (32768, 8192, 512, 4096),
              "newton": 8192, "tail_factor": (16384, 128), "tsqr": (2_097_152, 128)}


#: write_diag_blocks' cases (count, s, W dtype, out dtype): the rectri
#: flagship's write-back (INV_SHAPES["write_diag"]; first), the f32 rectri cell's
#: (16 x 512² f32 into 8192²), f32 W cast into bf16 at the flagship's
#: size, and s = 100 bf16, which takes the 'elem' route
WRITE_DIAG_CASES = ((96, 512, torch.bfloat16, torch.bfloat16), (16, 512, torch.float32, torch.float32),
                    (96, 512, torch.float32, torch.bfloat16), (96, 100, torch.bfloat16, torch.bfloat16))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("FAIL: " + msg)


def same_bits(got, want) -> bool:
    """Bitwise equality with the same NaN pattern (a NaN's payload aside):
    the blocked kernels against the column sweeps they replaced."""
    nan = torch.isnan(got)
    if got.dtype != want.dtype or not torch.equal(nan, torch.isnan(want)):
        return False
    view = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int32: torch.int32}[got.dtype]
    return torch.equal(got.masked_fill(nan, 0).view(view), want.masked_fill(nan, 0).view(view))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over memory
    rate and operations over peak rate (`dtype` names the operations' type:
    the small-N kernels compute f32 whatever they store)."""
    tb, tf = nbytes / MEM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def spd_hash(n: int, dtype, salt: int, device) -> torch.Tensor:
    """Deterministic well-conditioned SPD matrix made on the card: a
    symmetric hash of (min(i, j), max(i, j), salt) mapped to U[-1, 1]/√n,
    plus 3I (spectrum ≈ [1.8, 4.2]).  Built in row blocks (uint32 arithmetic
    emulated in int64)."""
    m32 = 0xFFFFFFFF
    out = torch.empty((n, n), dtype=dtype, device=device)
    c = torch.arange(n, device=device, dtype=torch.int64)[None, :]
    for r0 in range(0, n, 2048):
        r = torch.arange(r0, min(n, r0 + 2048), device=device, dtype=torch.int64)[:, None]
        lo, hi = torch.minimum(r, c), torch.maximum(r, c)
        h = ((lo * 0x9E3779B1) & m32) ^ ((hi * 0x85EBCA77) & m32)
        h = (h + salt * 0xC2B2AE3D) & m32
        h = ((h ^ (h >> 16)) * 0x7FEB352D) & m32
        h = ((h ^ (h >> 15)) * 0x846CA68B) & m32
        h = h ^ (h >> 16)
        v = (h.to(torch.float32) * 2.0**-32 * 2.0 - 1.0) / math.sqrt(n)
        v = v + 3.0 * (r == c)
        out[r0:r0 + r.shape[0]] = v.to(dtype)
        del lo, hi, h, v
    return out


def check_close(name, got, want, dtype, mask=None) -> float:
    """Kernel against plain version.  Tolerance: bf16, one bf16 ulp of each
    entry plus 1e-5 of the largest (both accumulate in f32 and round once);
    f32, 3e-5 of the largest entry (8192-long IEEE sums in another order);
    f64, 1e-12 of the largest entry.
    The QR kernels' Q is held the same way; their gram G by relative
    Frobenius (`check_gram`)."""
    up = torch.float64 if dtype == torch.float64 else torch.float32
    if mask is not None:
        got, want = got[mask], want[mask]
    # in slices of 2^26 entries: a 2,097,152 x 1024 f64 Q is 17.2 GB, and the
    # card holds A and both Qs beside the differences only a slice at a time
    got, want = got.reshape(-1), want.reshape(-1)
    step = 1 << 26
    parts = range(0, want.numel(), step)
    scale = float(torch.stack([want[i:i + step].to(up).abs().max() for i in parts]).max())
    ok, worst = True, []
    for i in parts:
        g, w = got[i:i + step].to(up), want[i:i + step].to(up)
        err = (g - w).abs()
        worst.append(err.max())
        if dtype == torch.bfloat16:
            ok &= bool((err <= 2.0**-7 * w.abs() + 1e-5 * scale).all())
    worst = float(torch.stack(worst).max())
    if dtype != torch.bfloat16:
        ok = worst <= (1e-12 if dtype == torch.float64 else 3e-5) * scale
    check(ok and math.isfinite(worst), f"{name} {dtype}: kernel vs plain max err {worst} (scale {scale})")
    return worst


def check_gram(name, got, want, dtype, g) -> float:
    """Gram kernel against plain version: relative Frobenius <= 1e-3 from
    bf16 input (scale_gram's two grams are of two Qs that may differ by an
    ulp), 1e-5 from f32 input and 1e-12 from f64 input (long IEEE sums in
    another order); the strictly lower block triangle must be exactly zero."""
    n = got.shape[0]
    rel = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
    tol = {torch.bfloat16: 1e-3, torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    check(rel <= tol, f"{name} {dtype}: gram kernel vs plain relative Frobenius {rel} > {tol}")
    t = torch.arange(n, device=got.device) // (n // g)
    check(bool((got[t[:, None] > t[None, :]] == 0).all()), f"{name} {dtype}: dead block triangle not zero")
    print(json.dumps({"gram": name, "dtype": str(dtype), "rel_fro_vs_plain": rel}), flush=True)
    return float((got - want).abs().max())


def mm_calls(RIp, Rp, buf, T, W: int) -> dict:
    """The main path's tri_matmul calls at the top window W of n = 2W, as
    (A, B, keywords, where the result goes): CI::trsm in place into Rp,
    CI::inv step one into a fresh T, CI::inv step two (side R) in place into
    RIp, CI::tmu (the syrk form, fused beta*C), and the dense form (off the
    path) at W/2."""
    D = W // 2
    return {
        "tri_matmul.trmm": (RIp, buf, dict(a_uplo="U", a_trans=True, a_view=(0, 0, W, W),
                                           b_view=(0, W, W, W), out_off=(0, W)), "Rp"),
        "tri_matmul.trmm inv1": (RIp, Rp, dict(a_uplo="U", a_view=(0, 0, W, W), b_view=(0, W, W, W)), None),
        "tri_matmul.trmm side R": (T, RIp, dict(b_uplo="U", alpha=-1.0, b_view=(W, W, W, W),
                                                out_off=(0, W)), "B"),
        "tri_matmul.syrk": (Rp, Rp, dict(a_trans=True, out_uplo="U", alpha=-1.0, beta=1.0,
                                         a_view=(0, W, W, W), b_view=(0, W, W, W), c=buf,
                                         c_view=(W, W, W, W)), None),
        "tri_matmul.dense": (buf, Rp, dict(b_trans=True, a_view=(0, 0, D, D), b_view=(D, 0, D, D)), None),
    }


def mm_library(name, A, B, kw, W):
    """One PyTorch call computing the same function on the same windows."""
    D = W // 2
    if name == "tri_matmul.trmm":
        A11t = torch.triu(A[:W, :W]).t().contiguous()
        B12 = B[:W, W:].contiguous()
        return lambda: torch.matmul(A11t, B12)
    if name == "tri_matmul.trmm inv1":
        A11 = torch.triu(A[:W, :W]).contiguous()
        B12 = B[:W, W:].contiguous()
        return lambda: torch.matmul(A11, B12)
    if name == "tri_matmul.trmm side R":
        U = torch.triu(B[W:, W:]).contiguous()
        return lambda: torch.addmm(A, A, U, beta=0.0, alpha=-1.0)
    if name == "tri_matmul.syrk":
        R12 = A[:W, W:].contiguous()
        C22 = kw["c"][W:, W:].contiguous()
        return lambda: torch.addmm(C22, R12.t(), R12, beta=1.0, alpha=-1.0)
    Ad, Bd = A[:D, :D].contiguous(), B[D:2 * D, :D].contiguous()
    return lambda: torch.matmul(Ad, Bd.t())


def mm_work(name, W, item) -> tuple[float, float]:
    """(bytes, flops) of one call: a W-wide triangle times a W x W operand
    (trmm), the upper half of a W x W product with fused C (syrk), W/2
    cubed (dense)."""
    if name == "tri_matmul.dense":
        D = W // 2
        return 3 * D * D * item, 2.0 * D**3
    if name == "tri_matmul.syrk":
        return (W * W + W * (W + 1)) * item, W * W * (W + 1)
    return (W * (W + 1) / 2 + 2 * W * W) * item, W * W * (W + 1)


def mm_phase(hopper, dtype, dev, RIp, Rp, buf, W: int) -> dict:
    """Every tri_matmul call of the path against its plain version and timed
    beside its bound and library call, on both of the dtype's routes in the
    same run and interleaved (fast, element-load, element-load, fast: bf16
    wgmma / wmma, f32 fma / simt, f64 dmma / simt); then, for bf16, NaN in
    the dead triangles on the wgmma route, and an unaligned window, which
    must take the wmma route."""
    item = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(8)
    T = torch.randn(W, W, generator=g, device=dev, dtype=torch.float32).to(dtype)
    bf16 = dtype == torch.bfloat16
    routes = (ROUTE_OF[dtype], ELEM_OF[dtype])
    live = torch.triu(torch.ones(W, W, dtype=torch.bool, device=dev))
    res = {}
    for name, (A, B, kw, where) in mm_calls(RIp, Rp, buf, T, W).items():
        outs = {"Rp": Rp, "B": B}

        def run(route, out=None):
            return hopper.tri_matmul(A, B if where != "B" else out, out=out, _route=route, **kw)

        def fresh():  # the in-place call's buffer, as the path hands it over
            return outs[where].clone() if where else None

        want = fresh()
        want = hopper.tri_matmul_plain(A, B if where != "B" else want, out=want, **kw)
        mask = live if "syrk" in name else None
        err = 0.0
        for route in routes:
            got = fresh()
            got = run(route, out=got)
            torch.cuda.synchronize()
            err = max(err, check_close(f"{name} {route}", got, want, dtype, mask))
            del got
        del want
        out = fresh()
        iters = 3 if bf16 else 2
        t = {r: [] for r in routes}
        for r in routes + routes[::-1]:  # interleaved: fast, element-load, element-load, fast
            t[r].append(time_ms(lambda: run(r, out=out), iters))
        ms, extra = sum(t[routes[0]]) / 2, {f"{routes[1]}_ms": sum(t[routes[1]]) / 2}
        plain_out = fresh()
        res[name] = dict(
            max_abs_err=err, ms=ms, **extra,
            plain_ms=time_ms(lambda: hopper.tri_matmul_plain(
                A, B if where != "B" else plain_out, out=plain_out, **kw), 2),
            library_ms=time_ms(mm_library(name, A, B, kw, W), 5),
            shape=f"window {W}" if name != "tri_matmul.dense" else f"{W // 2}^3",
            bound=bound_ms(*mm_work(name, W, item), dtype),
        )
        del out, plain_out
    del T
    if bf16:
        res["nan_dead_triangle"] = nan_and_unaligned(hopper, dtype, dev, RIp, buf, W)
    return res


def nan_and_unaligned(hopper, dtype, dev, RIp, buf, W: int) -> dict:
    """NaN in the dead triangle of the trsm and side-R operands, on the wgmma
    route, against the plain version; then a window at an odd column offset,
    which TMA cannot read: it must take the wmma route."""
    tri = RIp.clone()
    lower = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev), -1)
    for off in (0, W):
        tri[off:off + W, off:off + W].masked_fill_(lower, float("nan"))
    out = {}
    for label, (A, B, kw, where) in (
        ("trsm", (tri, buf, dict(a_uplo="U", a_trans=True, a_view=(0, 0, W, W),
                                 b_view=(0, W, W, W), out_off=(0, W)), "buf")),
        ("side R", (buf, tri, dict(b_uplo="U", alpha=-1.0, a_view=(0, 0, W, W), b_view=(W, W, W, W)), None)),
    ):
        o1, o2 = (buf.clone(), buf.clone()) if where else (None, None)
        hopper.reset_counts()
        got = hopper.tri_matmul(A, B, out=o1, **kw)
        rc = hopper.route_counts()
        check(rc == {"tri_matmul.trmm": {"wgmma": 1}}, f"NaN {label}: route {rc}")
        want = hopper.tri_matmul_plain(A, B, out=o2, **kw)
        torch.cuda.synchronize()
        out[label] = check_close(f"trmm NaN dead triangle {label}", got, want, dtype)
        del o1, o2, got, want
    del tri
    kw = dict(a_uplo="L", a_view=(3, 5, 300, 300), b_view=(8, 16, 300, 200))
    hopper.reset_counts()
    got = hopper.tri_matmul(buf, buf, **kw)
    rc = hopper.route_counts()
    check(rc == {"tri_matmul.trmm": {"wmma": 1}}, f"unaligned window: route {rc}")
    out["unaligned"] = check_close("trmm unaligned window", got, hopper.tri_matmul_plain(buf, buf, **kw), dtype)
    print(json.dumps({"kernel": "tri_matmul NaN / unaligned", **out}), flush=True)
    return out


def kernel_phase(hopper, dtype, dev, W: int = 8192, bc: int = 512) -> dict:
    """Every kernel against its plain version at the main path's shapes
    (the top-level window W and the leaf bc of n=16384, bc=512); f64 the
    tri_matmul calls only (its leaves' transposes run in phase 3d's factor,
    which is held to the same factor through the plain versions)."""
    p = 2 * W
    item = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.float32).to(dtype)
    RIp, Rp, buf = rnd(p, p), rnd(p, p), rnd(p, p)
    res = mm_phase(hopper, dtype, dev, RIp, Rp, buf, W)
    if dtype == torch.float64:
        del RIp, Rp, buf
        torch.cuda.empty_cache()
        return res

    # transpose, the leaf read: window -> lower f32 panel
    kw = dict(in_view=(bc, bc, bc, bc), out_uplo="L", out_dtype=torch.float32)
    check(torch.equal(hopper.transpose(buf, **kw), hopper.transpose_plain(buf, **kw)),
          f"transpose {dtype}: kernel differs from plain")
    panel = torch.empty((bc, bc), dtype=torch.float32, device=dev)
    win = buf[bc:2 * bc, bc:2 * bc]
    # ms / library_ms: per-call wall of 200 back-to-back calls (host and
    # device); device_ms / library_device_ms: the kernels' own time in a
    # trace of 50 such calls
    res["transpose"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.transpose(buf, **kw), 200),
        plain_ms=time_ms(lambda: hopper.transpose_plain(buf, **kw), 200),
        library_ms=time_ms(lambda: panel.copy_(win.t()), 200),
        device_ms=device_ms(lambda: hopper.transpose(buf, **kw), 50),
        library_device_ms=device_ms(lambda: panel.copy_(win.t()), 50),
        shape=f"{bc}x{bc} {dtype} -> f32 lower",
        bound=bound_ms((bc * (bc + 1) / 2) * item + bc * bc * 4, 0.0, dtype),
    )

    # transpose_pair, the leaf write-back: two f32 panels -> Rp, RIp
    L = torch.tril(rnd(bc, bc).float())
    Li = torch.tril(rnd(bc, bc).float())
    pk = hopper.transpose_pair(L, Li, Rp.clone(), RIp.clone(), dest=bc)
    pp = hopper.transpose_pair_plain(L, Li, Rp.clone(), RIp.clone(), dest=bc)
    check(torch.equal(pk[0], pp[0]) and torch.equal(pk[1], pp[1]),
          f"transpose_pair {dtype}: kernel differs from plain")
    del pk, pp
    res["transpose_pair"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.transpose_pair(L, Li, Rp, RIp, dest=bc), 200),
        plain_ms=time_ms(lambda: hopper.transpose_pair_plain(L, Li, Rp, RIp, dest=bc), 200),
        device_ms=device_ms(lambda: hopper.transpose_pair(L, Li, Rp, RIp, dest=bc), 50),
        library_ms=None,
        shape=f"2 x {bc}x{bc} f32 -> {dtype} upper",
        bound=bound_ms(2 * (bc * (bc + 1) / 2 * 4 + bc * bc * item), 0.0, dtype),
    )
    del RIp, Rp, buf

    # zeros_dead_lower into a NaN-prefilled buffer (the caching allocator
    # hands the freed block back): dead tiles zero, every other tile intact
    tile = bc
    nanbuf = torch.full((p, p), float("nan"), dtype=dtype, device=dev)
    ptr = nanbuf.data_ptr()
    del nanbuf
    z = hopper.zeros_dead_lower(p, dtype, tile, device=dev)
    check(z.data_ptr() == ptr, "zeros_dead_lower: NaN-prefilled block was not reused")
    zp = hopper.zeros_dead_lower_plain(p, dtype, tile, device=dev)
    check(torch.equal(torch.isnan(z), torch.isnan(zp)) and bool((z[~torch.isnan(zp)] == 0).all()),
          f"zeros_dead_lower {dtype}: kernel's zero set differs from plain")
    del z, zp
    nt = p // tile
    dead_bytes = nt * (nt - 1) / 2 * tile * tile * item
    full = torch.empty((p, p), dtype=dtype, device=dev)
    res["zeros_dead_lower"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.zeros_dead_lower(p, dtype, tile, device=dev), 20),
        plain_ms=time_ms(lambda: hopper.zeros_dead_lower_plain(p, dtype, tile, device=dev), 20),
        library_ms=time_ms(lambda: full.zero_(), 20),
        shape=f"{p}x{p} tile {tile}",
        bound=bound_ms(dead_bytes, 0.0, dtype),
    )
    del full
    torch.cuda.empty_cache()
    return res


def check_routes(hopper, counts: dict, route, label: str, extra=None) -> dict:
    """Every counted launch of a routed kernel took its route: `route`
    names one for all of them, or is a dtype (its ROUTE_OF); `extra` gives
    the tallies of the other kernels with routes (fused_tail's)."""
    name = route if isinstance(route, str) else ROUTE_OF[route]
    got = hopper.route_counts()
    want = {**{k: {name: counts[k]} for k in ROUTED if counts.get(k)}, **(extra or {})}
    check(got == want, f"{label}: launches by route {got} != {want}")
    return got


def predicted_counts(leaves: int) -> dict:
    """Launches of one cholinv factor with split=1 and `leaves` leaves."""
    return {
        "tri_matmul.trmm": 3 * (leaves - 1), "tri_matmul.syrk": leaves - 1,
        "tri_matmul.dense": 0, "transpose": leaves, "transpose_pair": leaves,
        "zeros_dead_lower": 2, **dict.fromkeys(QR_KERNELS, 0),
        **dict.fromkeys(SMALL_KERNELS, 0), **dict.fromkeys(INV_KERNELS, 0),
        **dict.fromkeys(BT_KERNELS, 0), **dict.fromkeys(UP_KERNELS, 0),
        **dict.fromkeys(MESH_KERNELS, 0),
    }


HOPPER_WRAPPERS = ("tri_matmul", "transpose", "transpose_pair", "zeros_dead_lower",
                   "write_diag_blocks", "fused_tail", "sched_matmul")
BT_WRAPPERS = ("fused_forward_step", "factor_step", "forward_solve_step", "solve_backward_step")


@contextmanager
def plain_versions(module, names=HOPPER_WRAPPERS):
    """Route a path through the plain versions (for the comparison run
    only): swap the wrappers in the module namespace and restore them."""
    saved = {n: getattr(module, n) for n in names}
    try:
        for n in names:
            setattr(module, n, getattr(module, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def drive(cholesky, hopper, grid, n, dtype, bc, precision):
    """One factor through the kernels with the counters set to 0 just
    before and read just after; returns (R, Rinv, A, cfg, counts, seconds)."""
    cfg = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, precision=precision)
    A = spd_hash(n, dtype, salt=1, device=grid.device)
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    R, Ri = cholesky.factor(grid, A, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = hopper.counts()
    want = predicted_counts(cholesky.padded_dim(n, bc) // bc)
    check(counts == want, f"n={n} launch counts {counts} != predicted {want}")
    check_routes(hopper, counts, dtype, f"n={n} {dtype}")
    return R, Ri, A, cfg, counts, secs


def rel_fro_rows(X, Y, rows: int = 4096) -> float:
    """‖X − Y‖_F / ‖Y‖_F in f64 sums, a block of rows at a time (two
    n = 49152 factors widened whole would need ~30 GB of temporaries)."""
    num = den = 0.0
    for r0 in range(0, Y.shape[0], rows):
        x, y = X[r0:r0 + rows].float(), Y[r0:r0 + rows].float()
        num += float(torch.linalg.norm(x - y).double() ** 2)
        den += float(torch.linalg.norm(y).double() ** 2)
    return math.sqrt(num / den)


#: rounds of turns that time the flagship fused and unfused (phase 3c'),
#: and the fused tail cell's factors (phase 11)
FLAGSHIP_TURNS = 5
TAIL_TURNS = 7


def fused_flagship(cholesky, hopper, grid, A, cfg, residual) -> dict:
    """Phase 3c': the flagship with tail_fuse_depth=1 — its 128 leaves of
    384 each one cluster-route fused_tail launch, nothing above them —
    counted against the plan, under the flagship's probe-residual gates,
    within 2e-2 of the unfused factor, timed beside it in turns (medians of
    FLAGSHIP_TURNS rounds) and profiled once."""
    import dataclasses

    n, bc = A.shape[0], cfg.base_case_dim
    cfgf = dataclasses.replace(cfg, tail_fuse_depth=1)
    leaves = n // bc
    want = {"fused_tail": leaves, "tri_matmul.trmm": 3 * (leaves - 1), "tri_matmul.syrk": leaves - 1,
            "zeros_dead_lower": 2}
    (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(grid, A, cfgf), want,
                                          "fused flagship", torch.bfloat16,
                                          extra_routes={"fused_tail": {hopper.tail_route(bc): leaves}})
    v = torch.randn(n, 4, generator=torch.Generator(device=A.device).manual_seed(3), device=A.device)
    pr = float(residual.cholesky_probe_residual(A, R, v))
    pi = float(residual.inverse_probe_residual(R, Ri, v))
    check(pr < 1e-2 and pi < 1e-2, f"fused flagship probe residuals {pr}, {pi}")
    R0, Ri0 = cholesky.factor(grid, A, cfg)
    dR, dRi = rel_fro_rows(R, R0), rel_fro_rows(Ri, Ri0)
    check(dR < 2e-2 and dRi < 2e-2, f"fused flagship vs unfused: {dR}, {dRi}")
    del R, Ri, R0, Ri0
    t = turns_s({"unfused": lambda: cholesky.factor(grid, A, cfg),
                 "fused": lambda: cholesky.factor(grid, A, cfgf)}, FLAGSHIP_TURNS)
    fused_s = t["fused"]["median"]
    res = dict(n=n, bc=bc, tail_fuse_depth=1, counts=counts, seconds_first=secs,
               seconds=fused_s, seconds_unfused=t["unfused"]["median"], turns=t,
               tflops=(2 * n**3 / 3) / fused_s / 1e12, probe_residual=pr,
               probe_inverse_residual=pi, vs_unfused=[dR, dRi],
               profile=profile(lambda: cholesky.factor(grid, A, cfgf), "CI::"))
    print(json.dumps({"factor": "flagship fused tail", **res}), flush=True)
    torch.cuda.empty_cache()
    return res


#: phase 3d and 18e: the reference's N=16384 row in f64, its own precision
F64_FACTOR = (16384, 512)


def f64_factor_phase(cholesky, hopper, grid, residual) -> dict:
    """Phase 3d: cholinv n=16384 f64 bc=512 — every tri_matmul launch on
    dmma, residual and inverse residual <= 1e-13 (the bench drivers' f64
    gate, `drivers._tolerance`), against the same factor through the plain
    versions, timed by CUDA events after the counted run, and profiled by
    CI:: phase."""
    n, bc = F64_FACTOR
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, n, torch.float64, bc, None)
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    check(res_r <= 1e-13 and res_i <= 1e-13, f"n={n} f64 residuals {res_r}, {res_i}")
    with plain_versions(hopper):
        Rq, Riq = cholesky.factor(grid, A, cfg)
    dR = float(residual.rel_fro(R - Rq, Rq))
    dRi = float(residual.rel_fro(Ri - Riq, Riq))
    # f64: the kernels and torch.matmul sum in other orders; 1e-12 relative
    check(dR < 1e-12 and dRi < 1e-12, f"n={n} f64 kernels vs plain: {dR}, {dRi}")
    del R, Ri, Rq, Riq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = timed_s(lambda: cholesky.factor(grid, A, cfg), 2)
    res = dict(n=n, bc=bc, dtype="float64", seconds=t, tflops=(2 * n**3 / 3) / t / 1e12,
               peak_bytes=torch.cuda.max_memory_allocated(), seconds_first=secs, counts=counts,
               vs_plain=[dR, dRi], residual=res_r, inverse_residual=res_i)
    print(json.dumps({"factor": f"n={n} f64 bc={bc}", **res}), flush=True)
    res["profile"] = profile(lambda: cholesky.factor(grid, A, cfg), "CI::")
    print(json.dumps({"profile": f"n={n} f64", **res["profile"]}), flush=True)
    del A
    torch.cuda.empty_cache()
    return res


#: warm-up pairs (a fill and an add) at the start of every trace (`profile`)
TRACE_PAD = 32


def profile(run, prefix: str, sequence: bool = False) -> dict:
    """One call of `run` under torch.profiler: wall time, device time and
    launches (trace events) by kernel name and device time by phase (scopes
    whose tag starts with `prefix`), and the share of the wall the device
    was idle (no kernel running); with `sequence`, every kernel's name and
    device time in the order the kernels started.  `records_lost`: the
    timed call's kernel launches on the host that left no kernel record on
    the device timeline — late in a long process a trace loses the first of
    its session's device records (PERF.md §6, PR 15); `complete_profile`
    takes the trace again."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from capital_tpu_torch.ops import hopper
    from capital_tpu_torch.utils import tracing

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        # a trace loses the first device records of its session, more of
        # them the more traces the process has taken (up to seven in
        # chip_smoke's phase 13; PERF.md §6, PR 15): spend them on
        # 2·TRACE_PAD + 1 tiny warm-ups, one the port's own, and start the
        # timed call 50 ms later; only records from 25 ms on are counted
        # (`first_kernels` shows which warm-ups the trace kept)
        for _ in range(TRACE_PAD):
            torch.ones(1, device="cuda").add_(1)
        hopper.zeros_dead_lower(256, torch.float32, 128, device="cuda")
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del res

    phases = {  # device time of the kernels launched inside each scope
        evt.key: float(evt.device_time_total) / 1e3
        for evt in prof.key_averages() if evt.key.startswith(prefix)
    }
    kernels: dict[str, float] = {}
    launches: dict[str, int] = {}
    spans = []
    api = traced = 0  # kernel launches after the warm-ups: host calls, device records
    for e in prof.events():
        timed = e.time_range.start >= 25e3  # us; the warm-ups end a few ms in
        if e.device_type != torch.autograd.DeviceType.CUDA:
            api += timed and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperative"))
            continue
        if e.time_range.end <= e.time_range.start:
            continue
        if getattr(e, "is_user_annotation", False) or e.name in tracing.PHASE_REGISTRY:
            continue  # a scope's range on the device timeline, not a kernel
        spans.append((e.time_range.start, e.time_range.end, e.name[:40], timed))
        if not timed:
            continue  # a warm-up
        traced += not e.name.startswith(("Memcpy", "Memset"))
        kernels[e.name[:80]] = kernels.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
        launches[e.name[:80]] = launches.get(e.name[:80], 0) + 1
    spans.sort()
    # the trace's earliest kernels and their start (ms after the trace's):
    # which warm-ups it kept
    first = [[name, s / 1e3] for s, _, name, _ in spans[:3]]
    spans = [(s, e, name) for s, e, name, timed in spans if timed]
    # busy time: the union of kernel intervals on the device timeline
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
               idle_share=max(0.0, 1.0 - busy / 1e3 / (wall * 1e3)),
               phases_device_ms=phases, top_kernels_device_ms=top, launches=launches,
               first_kernels=first, records_lost=api - traced)
    if sequence:
        out["sequence"] = [[name, (e - s) / 1e3] for s, e, name in spans]
    return out


def complete_profile(run, prefix: str, tries: int = 3, complete=None) -> dict:
    """`profile` taken up to `tries` times, until a trace kept a device
    record of every launch (`records_lost` 0, or `complete(prof)` where a
    run replays CUDA graphs, whose kernels have no host launch of their
    own); the last trace otherwise.  `tries`: the traces taken."""
    for n in range(1, tries + 1):
        prof = profile(run, prefix)
        if (complete(prof) if complete is not None else not prof["records_lost"]):
            break
    return dict(prof, tries=n)


def device_ms(run, iters: int) -> float | None:
    """Device time per call of the kernels `run` launches, from a
    torch.profiler trace of `iters` back-to-back calls that kept every
    launch (`complete_profile`): the kernels the trace saw at least `iters`
    times, summed, over `iters` (the trace's one-off warm-ups fall out).
    None (not measured) when no trace kept them all: late in the whole
    run, phase 13's traces of five chain-step calls kept only the last one
    to three (PERF.md §6, PR 15), so the chain rows read `queued_ms` too."""
    prof = complete_profile(lambda: [run() for _ in range(iters)], "\0")
    if prof["records_lost"]:
        return None
    return sum(ms for k, ms in prof["top_kernels_device_ms"].items() if prof["launches"][k] >= iters) / iters


def queued_ms(run, iters: int) -> float:
    """Device time per call of `run` without a trace: CUDA events around
    `iters` calls queued behind a spin kernel (`torch.cuda._sleep`) that
    outlasts their launch on the host, so the events read the device's
    span from the first kernel's start to the last one's end — the host's
    launch gaps hidden, the short gaps between queued kernels counted.  For
    a `run` that waits on the device inside (a library call reading info
    back), the gaps after the wait count too."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # twice the host's time at <= 2 GHz
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_qr_trace(prof: dict, counts: dict, dtype) -> dict:
    """The QR profile saw every launch of the tall-pass kernels that one
    factor makes (`counts`, the counted run's): each gram_blocked and
    scale_gram runs the gram kernel of the dtype's route (gram_wgmma,
    gram_fma, gram_dmma) and its finalize, each scale_gram and
    scale_blocked the scale kernel of that route."""
    grams = counts["qr.gram_blocked"] + counts["qr.scale_gram"]
    route = ROUTE_OF[dtype]
    want = {f"gram_{route}": grams, "gram_finalize": grams,
            f"scale_{route}": counts["qr.scale_gram"] + counts["qr.scale_blocked"]}
    got = {k: sum(v for name, v in prof["launches"].items() if k in name) for k in want}
    check(got == want, f"QR profile: trace launches {got} != counted {want}")
    return got


def tall_randn(m: int, n: int, dtype, seed: int, device) -> torch.Tensor:
    """Gaussian m x n operand made on the card from a seed (well
    conditioned: cond ~ (1 + sqrt(n/m)) / (1 - sqrt(n/m)))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((m, n), generator=gen, device=device, dtype=dtype)


def qr_kernel_phase(qr_fused, hopper, m: int, n: int, dtype, dev) -> dict:
    """The three CholeskyQR2 kernels against their plain versions at (m, n)
    and its column split, timed beside bound and library call; every launch
    on the dtype's route (bf16 wgmma, f32 fma, f64 dmma).  Below the
    flagship's size, where library calls swing ±20 % between runs, the
    gram and scale are timed twice beside their library calls, in turns
    (`pairs`: [kernel ms, library ms] each turn; `ms` and `library_ms` their
    means)."""
    hopper.reset_counts()
    g = qr_fused.pick_g(n)
    live = qr_fused.live_fraction(g)
    item = torch.tensor([], dtype=dtype).element_size()
    A = tall_randn(m, n, dtype, 11, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    Rinv = torch.triu(torch.randn((n, n), generator=gen, device=dev) * (0.1 / math.sqrt(n))
                      + torch.eye(n, device=dev)).to(dtype)
    flops = 2.0 * m * n * n * live
    big = m * n > 1 << 28
    res, iters = {}, 3 if big else 10
    pi = 1 if big else 3  # the plain versions loop over row blocks
    acc_item = 8 if dtype == torch.float64 else 4  # G's element

    def timed(kernel, library) -> dict:
        pairs = [[time_ms(kernel, iters), time_ms(library, iters)] for _ in range(1 if big else 2)]
        return dict(ms=sum(p[0] for p in pairs) / len(pairs),
                    library_ms=sum(p[1] for p in pairs) / len(pairs), pairs=pairs)

    Gk, Gp = qr_fused.gram_blocked(A, g=g), qr_fused.gram_blocked_plain(A, g=g)
    err = check_gram("gram_blocked", Gk, Gp, dtype, g)
    del Gk, Gp
    res["qr.gram_blocked"] = dict(
        max_abs_err=err,
        **timed(lambda: qr_fused.gram_blocked(A, g=g), lambda: torch.mm(A.t(), A)),
        plain_ms=time_ms(lambda: qr_fused.gram_blocked_plain(A, g=g), pi, warmup=1),
        shape=f"{m}x{n} {dtype} g={g}", splits=qr_fused.gram_splits(m, n, g, dtype),
        bound=bound_ms(m * n * item + acc_item * n * n, flops, dtype),
    )

    Qk, Qp = qr_fused.scale_blocked(A, Rinv, g=g), qr_fused.scale_blocked_plain(A, Rinv, g=g)
    err = check_close("scale_blocked", Qk, Qp, dtype)
    del Qk, Qp
    Rt = torch.triu(Rinv)
    res["qr.scale_blocked"] = dict(
        max_abs_err=err,
        **timed(lambda: qr_fused.scale_blocked(A, Rinv, g=g), lambda: A @ Rt),
        plain_ms=time_ms(lambda: qr_fused.scale_blocked_plain(A, Rinv, g=g), pi, warmup=1),
        shape=f"{m}x{n} {dtype} g={g}",
        bound=bound_ms(2.0 * m * n * item + n * n * item, flops, dtype),
    )
    del Rt

    (Qk, Gk), (Qp, Gp) = qr_fused.scale_gram(A, Rinv, g=g), qr_fused.scale_gram_plain(A, Rinv, g=g)
    err = max(check_close("scale_gram Q", Qk, Qp, dtype), check_gram("scale_gram", Gk, Gp, dtype, g))
    del Qk, Gk, Qp, Gp
    res["qr.scale_gram"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qr_fused.scale_gram(A, Rinv, g=g), iters),
        plain_ms=time_ms(lambda: qr_fused.scale_gram_plain(A, Rinv, g=g), pi, warmup=1),
        library_ms=None,  # no single PyTorch call computes it
        shape=f"{m}x{n} {dtype} g={g}",
        bound=bound_ms(2.0 * m * n * item + n * n * item + acc_item * n * n, 2 * flops, dtype),
    )
    del A, Rinv
    torch.cuda.empty_cache()
    routes = hopper.route_counts()
    check(set(routes) == set(QR_KERNELS) and all(set(v) == {ROUTE_OF[dtype]} for v in routes.values()),
          f"QR kernels {m}x{n} {dtype}: launches by route {routes}")
    print(json.dumps({"qr_routes": f"{m}x{n} {dtype} g={g}", **routes}), flush=True)
    return res


def predicted_qr_counts(n: int, bc: int, num_iter: int, shifted: int = 0) -> dict:
    """Launches of one qr.factor in mode 'pallas' on one device: CQR2 runs
    the three fused kernels and factors both grams through cholinv
    (n >= 2048) or potrf_trtri_upper (three transposes each, once more per
    shifted retry); CQR1 runs one tri_matmul trmm."""
    counts = dict.fromkeys(predicted_counts(1), 0)
    if num_iter == 1:
        counts["tri_matmul.trmm"] = 1
        return counts
    if n >= 2048:
        counts = {k: 2 * v for k, v in predicted_counts(n // bc).items()}
    else:
        counts["transpose"] = 3 * (2 + shifted)
    counts.update(dict.fromkeys(QR_KERNELS, 1))
    return counts


@contextmanager
def plain_qr_versions(hopper, qr_fused):
    """Route a QR factor through the plain versions (comparison run only)."""
    names = ("gram_blocked", "scale_gram", "scale_blocked")
    saved = {n: getattr(qr_fused, n) for n in names}
    try:
        for n in names:
            setattr(qr_fused, n, getattr(qr_fused, n + "_plain"))
        with plain_versions(hopper):
            yield
    finally:
        for n, f in saved.items():
            setattr(qr_fused, n, f)


def qr_gates(residual, A, Q, R, label) -> dict:
    """The gates of capital_tpu/bench/drivers.py (`_tolerance`, by element
    size): ‖I − QᵀQ‖ and the row-blocked ‖A − QR‖/‖A‖ < 5e-2 (bf16), 5e-5
    (f32), 1e-13 (f64)."""
    tol = {2: 5e-2, 4: 5e-5, 8: 1e-13}[A.element_size()]
    orth = float(residual.qr_orthogonality(Q))
    res = float(residual.qr_residual_blocked(A, Q, R))
    check(orth < tol and res < tol, f"{label}: orthogonality {orth}, residual {res} (tol {tol})")
    return dict(orthogonality=orth, residual=res)


def drive_qr(qr, hopper, grid, A, cfg, want, label):
    """One qr.factor with the counters set to 0 just before and read just
    after, held to the plan's launch counts, every routed launch on A's
    dtype's route (the grams are factored in A's dtype)."""
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = qr.factor(grid, A, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = hopper.counts()
    if callable(want):
        want = want(out)
    check(counts == want, f"{label}: launch counts {counts} != predicted {want}")
    check_routes(hopper, counts, A.dtype, label)
    return out, counts, secs


def qr_path(hopper, dev, grid) -> dict:
    """The CholeskyQR2 runs of the path table."""
    from capital_tpu_torch.models import cholesky, qr
    from capital_tpu_torch.ops import qr_fused
    from capital_tpu_torch.robust import faultinject
    from capital_tpu_torch.robust.config import RobustConfig
    from capital_tpu_torch.utils import residual

    out = {}

    def cfg_for(dtype, bc=128, **kw):
        prec = "highest" if dtype == torch.float32 else None
        return qr.CacqrConfig(regime="1d", mode="pallas", precision=prec,
                              cholinv=cholesky.CholinvConfig(base_case_dim=bc, mode="pallas"), **kw)

    # ---- the QR flagship: 2,097,152 x 1024 bf16, g=8, plan 'full' ---------
    m, n = QR_SHAPES["flagship"]
    A = tall_randn(m, n, torch.bfloat16, 1, dev)
    cfg = cfg_for(torch.bfloat16)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg, predicted_qr_counts(n, 128, 2),
                                    "QR flagship")
    gates = qr_gates(residual, A, Q, R, "QR flagship")
    del Q, R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        Q = R = None  # free the previous result: peak memory of one factor
        Q, R = qr.factor(grid, A, cfg)
    end.record()
    end.synchronize()
    t = start.elapsed_time(end) / 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    del Q, R
    out["flagship"] = dict(m=m, n=n, dtype="bfloat16", g=qr_fused.pick_g(n), plan="full",
                           seconds=t, tflops=2.0 * m * n * n * 2 / t / 1e12, peak_bytes=peak,
                           seconds_first=secs, counts=counts, **gates)
    print(json.dumps({"qr": "flagship", **out["flagship"]}), flush=True)
    out["profile"] = profile(lambda: qr.factor(grid, A, cfg), "CQR::")
    out["profile"]["trace_vs_counts"] = check_qr_trace(out["profile"], counts, torch.bfloat16)
    print(json.dumps({"profile": "QR flagship", **out["profile"]}), flush=True)
    del A
    torch.cuda.empty_cache()

    # ---- 65536 x 512 f32 (precision 'highest') and f64, g=4: also vs plain
    for key, dtype, seed in (("f32", torch.float32, 2), ("f64", torch.float64, 6)):
        m, n = QR_SHAPES["single_rank"]
        A = tall_randn(m, n, dtype, seed, dev)
        cfg = cfg_for(dtype)
        (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg, predicted_qr_counts(n, 128, 2),
                                        f"QR {key}")
        gates = qr_gates(residual, A, Q, R, f"QR {key}")
        t = timed_s(lambda: qr.factor(grid, A, cfg), 5)
        with plain_qr_versions(hopper, qr_fused):
            Qp, Rp = qr.factor(grid, A, cfg)
        dQ = float(residual.rel_fro(Q - Qp, Qp))
        dR = float(residual.rel_fro(R - Rp, Rp))
        # the kernels and the plain versions sum in other orders: 1e-5 in
        # f32, 1e-12 in f64 (the kernel gates of check_close / check_gram)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        check(dQ < tol and dR < tol, f"QR {key} kernels vs plain: Q {dQ}, R {dR}")
        out[key] = dict(m=m, n=n, counts=counts, seconds=t, tflops=2.0 * m * n * n * 2 / t / 1e12,
                        seconds_first=secs, vs_plain=[dQ, dR], **gates)
        print(json.dumps({"qr": f"{m}x{n} {key}", **out[key]}), flush=True)
        del A, Q, R, Qp, Rp

    # ---- 2,097,152 x 1024 f64: the flagship's shape in the reference's
    # precision.  No plain factor beside it: with A, Q, R and the plain Q and
    # R at 17.2 GB an operand the card would need more than its 80 GB (phase
    # 4 holds each kernel against its plain version at this shape) --------
    m, n = QR_SHAPES["flagship"]
    A = tall_randn(m, n, torch.float64, 7, dev)
    cfg = cfg_for(torch.float64)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg, predicted_qr_counts(n, 128, 2),
                                    "QR flagship f64")
    gates = qr_gates(residual, A, Q, R, "QR flagship f64")
    del Q, R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = timed_s(lambda: qr.factor(grid, A, cfg), 3)  # peak memory of one factor
    peak = torch.cuda.max_memory_allocated()
    out["flagship_f64"] = dict(m=m, n=n, dtype="float64", g=qr_fused.pick_g(n), plan="full",
                               seconds=t, tflops=2.0 * m * n * n * 2 / t / 1e12, peak_bytes=peak,
                               seconds_first=secs, counts=counts, **gates)
    print(json.dumps({"qr": "flagship f64", **out["flagship_f64"]}), flush=True)
    prof = profile(lambda: qr.factor(grid, A, cfg), "CQR::")
    prof["trace_vs_counts"] = check_qr_trace(prof, counts, torch.float64)
    out["flagship_f64"]["profile"] = prof
    print(json.dumps({"profile": "QR flagship f64", **prof}), flush=True)
    del A
    torch.cuda.empty_cache()

    # ---- 65536 x 4096 bf16: both grams through cholinv at bc=128 ----------
    (m, n), bc = QR_SHAPES["wide"], 128
    A = tall_randn(m, n, torch.bfloat16, 3, dev)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg_for(torch.bfloat16, bc),
                                    predicted_qr_counts(n, bc, 2), "QR wide gram")
    out["wide_gram"] = dict(m=m, n=n, bc=bc, counts=counts, seconds_first=secs,
                            **qr_gates(residual, A, Q, R, "QR wide gram"))
    print(json.dumps({"qr": "65536x4096 bf16", **out["wide_gram"]}), flush=True)
    del A, Q, R

    # ---- CQR1, 65536 x 1024 bf16: the sweep's tri_matmul trmm -------------
    m, n = QR_SHAPES["cqr1"]
    A = tall_randn(m, n, torch.bfloat16, 4, dev)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg_for(torch.bfloat16, num_iter=1),
                                    predicted_qr_counts(n, 128, 1), "CQR1")
    out["cqr1"] = dict(m=m, n=n, counts=counts, seconds_first=secs,
                       **qr_gates(residual, A, Q, R, "CQR1"))
    print(json.dumps({"qr": "CQR1 65536x1024 bf16", **out["cqr1"]}), flush=True)
    del A, Q, R

    # ---- robust: 65536 x 1024 f32, rank-deficient gram injected -----------
    # exempt from the orthogonality gate: the corrupted gram no longer
    # describes A; the ladder's flags and a finite Q are the contract
    A = tall_randn(m, n, torch.float32, 5, dev)
    with faultinject.active_plan(faultinject.Fault(tag="CQR::gram", kind="rank_deficient")) as plan:
        (Q, R, ri), counts, secs = drive_qr(
            qr, hopper, grid, A, cfg_for(torch.float32, robust=RobustConfig()),
            lambda res: predicted_qr_counts(n, 128, 2, shifted=int(res[2].shifted)), "QR robust")
    info = {k: float(v) for k, v in ri._asdict().items()}
    check(info["breakdown"] >= 1 and info["shifted"] >= 1, f"QR robust: no breakdown seen {info}")
    check(bool(torch.isfinite(Q).all()), "QR robust: Q not finite")
    check(info["info"] in (0, n + 2), f"QR robust: info {info['info']}")
    check(plan.fired == [("CQR::gram", 0)], f"QR robust: fired {plan.fired}")
    out["robust"] = dict(m=m, n=n, counts=counts, seconds_first=secs, robust_info=info)
    print(json.dumps({"qr": "robust 65536x1024 f32", **out["robust"]}), flush=True)
    del A, Q, R
    torch.cuda.empty_cache()
    return out


def small_flops(name: str, m: int, n: int, k: int) -> float:
    """Useful f32 operations of one problem: Cholesky n³/3, a triangular
    solve n²k per sweep; lstsq the kernel's CholeskyQR2 normal equations —
    the gram's lower triangle m·n·(n+1), AᵀB 2mnk, two Choleskys, the
    R1⁻ᵀ·G·R1⁻¹ correction (two n-wide sweeps), the R2·R1 product n³/3 and
    four k-wide sweeps."""
    if name == "small.potrf":
        return n**3 / 3.0
    if name == "small.potrs":
        return 2.0 * n * n * k
    if name == "small.posv":
        return n**3 / 3.0 + 2.0 * n * n * k
    return m * n * (n + 1) + 2.0 * m * n * k + 3.0 * n**3 + 4.0 * n * n * k


def small_bytes(name: str, m: int, n: int, k: int, item: int) -> float:
    """Bytes of one problem: each input read once, each output written once
    (info 4 bytes)."""
    if name == "small.potrf":
        return 2.0 * n * n * item + 4
    if name == "small.potrs":  # the factor's live triangle only
        return (n * (n + 1) / 2.0 + 2.0 * n * k) * item
    if name == "small.posv":
        return (n * n + 2.0 * n * k) * item + 4
    return (m * n + m * k + n * k) * item + 4


def time_budget_ms(fn, budget_ms: float = 300.0, most: int = 20) -> float:
    """Mean milliseconds per call of a call whose time may be anywhere from
    microseconds to seconds: one warm-up call, timed, sets how many calls
    fit the budget (1 to `most`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    return time_ms(fn, max(1, min(most, int(budget_ms / max(first, 1e-3)))), warmup=0)


def small_close(name, got, want, dtype) -> float:
    """Kernel against plain version: f32 1e-5 of the largest entry (IEEE
    f32 in both, sums in another order; lstsq 1e-4, the gram squares the
    condition number); bf16 one bf16 ulp of each entry plus that."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    scale = float(w.abs().max())
    rel = 1e-4 if name == "small.lstsq" else 1e-5
    bound = rel * scale + (2.0**-7 * w.abs() if dtype == torch.bfloat16 else 0.0)
    worst = float(err.max())
    check(bool((err <= bound).all()) and math.isfinite(worst),
          f"{name} {dtype}: kernel vs plain max err {worst} (scale {scale})")
    return worst


def small_kernel_phase(batched_small, size: str, dtype, dev, names=SMALL_KERNELS) -> dict:
    """The small-N kernels against their plain versions at one of
    SMALL_SHAPES, timed beside bound, plain version and library call."""
    item = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(21)
    b, _, n, k = SMALL_SHAPES[size]["square"]
    X = torch.randn((b, n, n), generator=gen, device=dev)
    A = (X @ X.mT / n + 3.0 * torch.eye(n, device=dev)).to(dtype)
    del X
    B = torch.randn((b, n, k), generator=gen, device=dev).to(dtype)
    iters = 3 if size == "throughput" else 20
    f32 = dtype == torch.float32
    res = {}

    def record(name, got, want, info_k, info_p, run, plain, library, shape):
        err = small_close(name, got, want, dtype)
        if info_k is not None:
            check(torch.equal(info_k, info_p), f"{name} {dtype}: info differs from plain")
            check(not bool(info_k.any()), f"{name} {dtype}: info nonzero on SPD input")
        bm, mm, nn, kk = shape
        res[name] = dict(
            max_abs_err=err, ms=time_ms(run, iters),
            plain_ms=time_budget_ms(plain),
            library_ms=time_budget_ms(library) if library is not None else None,
            shape=f"batch {bm} m {mm} n {nn} k {kk} {dtype}",
            bound=bound_ms(bm * small_bytes(name, mm, nn, kk, item),
                           bm * small_flops(name, mm, nn, kk), torch.float32),
        )

    if "small.potrf" in names:
        R, info = batched_small.potrf(A)
        Rp, infop = batched_small.potrf_plain(A)
        Af = A.float()
        chol_ex = (lambda: torch.linalg.cholesky_ex(Af, upper=True)) if f32 else None
        record("small.potrf", R, Rp, info, infop, lambda: batched_small.potrf(A),
               lambda: batched_small.potrf_plain(A), chol_ex, (b, n, n, k))
        res["small.potrf"]["device_ms"] = device_ms(lambda: batched_small.potrf(A), iters)
        if chol_ex is not None:
            res["small.potrf"]["library_device_ms"] = device_ms(chol_ex, iters)
            res["small.potrf"]["ms_over_library_ms"] = res["small.potrf"]["ms"] / res["small.potrf"]["library_ms"]
        del Rp
        Xk = batched_small.potrs(R, B)
        Xp = batched_small.potrs_plain(R, B)
        Rf, Bf = R.float(), B.float()
        record("small.potrs", Xk, Xp, None, None, lambda: batched_small.potrs(R, B),
               lambda: batched_small.potrs_plain(R, B),
               (lambda: torch.cholesky_solve(Bf, Rf, upper=True)) if f32 else None, (b, n, n, k))
        res["small.potrs"]["device_ms"] = device_ms(lambda: batched_small.potrs(R, B), iters)
        if f32:
            res["small.potrs"]["library_device_ms"] = device_ms(
                lambda: torch.cholesky_solve(Bf, Rf, upper=True), iters)
        # the lower factor L = Rᵀ ('L': the same tile after the load, so the
        # same bits), and k = n right-hand sides (serve's inv) on both uplo
        Lf = R.mT.contiguous()
        XL = batched_small.potrs(Lf, B, uplo="L")
        small_close("small.potrs", XL, batched_small.potrs_plain(Lf, B, uplo="L"), dtype)
        check(torch.equal(XL, Xk), f"small.potrs {dtype}: 'L' on Rᵀ differs from 'U' on R")
        if size == "latency":
            Bn = torch.randn((b, n, n), generator=gen, device=dev).to(dtype)
            for T, uplo in ((R, "U"), (Lf, "L")):
                small_close("small.potrs", batched_small.potrs(T, Bn, uplo=uplo),
                            batched_small.potrs_plain(T, Bn, uplo=uplo), dtype)
            res["small.potrs"]["k128_ms"] = time_ms(lambda: batched_small.potrs(R, Bn), iters)
            del Bn
        del R, Xk, Xp, Rf, Bf, Af, Lf, XL
    if "small.posv" in names:
        Xk, info = batched_small.posv(A, B)
        Xp, infop = batched_small.posv_plain(A, B)
        record("small.posv", Xk, Xp, info, infop, lambda: batched_small.posv(A, B),
               lambda: batched_small.posv_plain(A, B),
               (lambda: torch.linalg.solve(A, B)) if f32 else None, (b, n, n, k))
        # the blocked factor and solves in one block: potrs(potrf(A), B) bit
        # for bit (bf16 through the f32 factor posv keeps), and its time
        split = lambda: batched_small.potrs(batched_small.potrf(A.float())[0], B.float())  # noqa: E731
        check(same_bits(Xk, split().to(dtype)), f"small.posv {dtype}: not potrs(potrf(A), B) bit for bit")
        res["small.posv"]["device_ms"] = device_ms(lambda: batched_small.posv(A, B), iters)
        res["small.posv"]["queued_ms"] = queued_ms(lambda: batched_small.posv(A, B), iters)
        if f32:
            res["small.posv"]["potrf_potrs_ms"] = time_ms(split, iters)
            res["small.posv"]["library_device_ms"] = device_ms(lambda: torch.linalg.solve(A, B), iters)
        if size == "throughput" and f32:
            res["small.posv"]["profile"] = profile(lambda: batched_small.posv(A, B), "SV::")
        del Xk, Xp
    del A, B
    if "small.lstsq" in names:
        b, m, n, k = SMALL_SHAPES[size]["tall"]
        At = torch.randn((b, m, n), generator=gen, device=dev).to(dtype)
        Bt = torch.randn((b, m, k), generator=gen, device=dev).to(dtype)
        Xk, info = batched_small.lstsq(At, Bt)
        Xp, infop = batched_small.lstsq_plain(At, Bt)
        record("small.lstsq", Xk, Xp, info, infop, lambda: batched_small.lstsq(At, Bt),
               lambda: batched_small.lstsq_plain(At, Bt),
               (lambda: torch.linalg.lstsq(At, Bt)) if f32 else None, (b, m, n, k))
        del At, Bt, Xk, Xp
    torch.cuda.empty_cache()
    return res


#: launches of one api.batched call, by (op, impl), on an f32 bucket
SERVE_LAUNCHES = {
    ("posv", "auto"): {"small.posv": 1}, ("posv", "pallas"): {"small.posv": 1},
    ("posv", "pallas_split"): {"small.potrf": 1, "small.potrs": 1},
    ("lstsq", "auto"): {"small.lstsq": 1}, ("lstsq", "pallas"): {"small.lstsq": 1},
    ("lstsq", "pallas_split"): {"small.lstsq": 1},
    ("inv", "auto"): {"small.posv": 1}, ("inv", "pallas"): {"small.posv": 1},
    ("inv", "pallas_split"): {"small.potrf": 1, "small.potrs": 1},
}


def serve_requests(op: str, count: int, dtype, seed: int):
    """Ragged requests made on the host from a seed: n in {40, 64, 100,
    128}, k in {1, 3, 8}; SPD operands for posv and inv, Gaussian (4n, n)
    ones for lstsq."""
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for _ in range(count):
        n = (40, 64, 100, 128)[int(torch.randint(4, (1,), generator=gen))]
        k = (1, 3, 8)[int(torch.randint(3, (1,), generator=gen))]
        if op == "lstsq":
            A = torch.randn((4 * n, n), generator=gen, dtype=torch.float64)
            B = torch.randn((4 * n, k), generator=gen, dtype=torch.float64)
        else:
            X = torch.randn((n, n), generator=gen, dtype=torch.float64)
            A = X @ X.T / n + 3.0 * torch.eye(n, dtype=torch.float64)
            B = None if op == "inv" else torch.randn((n, k), generator=gen, dtype=torch.float64)
        reqs.append((A.to(dtype), None if B is None else B.to(dtype)))
    return reqs


def serve_residual(op: str, A, B, X) -> float:
    """The drivers' residual (bench/drivers.py:_small_residual) in f64 on
    the host: ‖AX − B‖/‖B‖ for posv (B = I for inv), the normal-equations
    ‖Aᵀ(AX − B)‖/‖AᵀB‖ for lstsq."""
    A, X = A.double().cpu(), X.double().cpu()
    if op == "inv":
        B = torch.eye(A.shape[0], dtype=torch.float64)
    B = B.double().cpu()
    if op == "lstsq":
        return float(torch.linalg.norm(A.T @ (A @ X - B)) / torch.linalg.norm(A.T @ B))
    return float(torch.linalg.norm(A @ X - B) / torch.linalg.norm(B))


def serve_phase(hopper, dev) -> dict:
    """The small-N serve path, request to response, with the counters set
    to 0 just before each batched call and checked just after."""
    from capital_tpu_torch.serve import api, batching
    from capital_tpu_torch.serve.engine import ServeConfig

    cfg = ServeConfig(buckets=(32, 64, 128), rows_buckets=(128, 256, 512),
                      nrhs_buckets=(1, 8), max_batch=8)
    launches = dict.fromkeys(SMALL_KERNELS, 0)
    out = {"calls": 0, "worst_residual": {}, "pallas_vs_vmap": {}}
    tol32 = 5e-5  # bench/drivers.py:_tolerance, f32; 10x for lstsq

    def run(op, impl, Ab, Bb):
        torch.cuda.synchronize()
        hopper.reset_counts()
        f = api.batched(op, "highest", impl)
        X, info = f(Ab) if Bb is None else f(Ab, Bb)
        torch.cuda.synchronize()
        return X, info, hopper.counts()

    for op in ("posv", "lstsq", "inv"):
        for dtype in (torch.float32, torch.float64):
            reqs = serve_requests(op, 12 if dtype == torch.float32 else 3, dtype, seed=len(op))
            groups: dict = {}
            for A, B in reqs:
                bk = batching.bucket_for(op, tuple(A.shape), None if B is None else tuple(B.shape),
                                         str(dtype).replace("torch.", ""), cfg)
                check(bk is not None, f"serve {op}: request {tuple(A.shape)} has no bucket")
                groups.setdefault(bk, []).append((A.to(dev), None if B is None else B.to(dev)))
            impls = ("auto", "pallas", "pallas_split") if dtype == torch.float32 else ("pallas",)
            tol = (10 * tol32 if op == "lstsq" else tol32) if dtype == torch.float32 else (
                1e-12 if op == "lstsq" else 1e-13)
            worst, agree = 0.0, 0.0
            for bk, members in groups.items():
                for c0 in range(0, len(members), bk.capacity):
                    chunk = members[c0:c0 + bk.capacity]
                    padded = [batching.pad_operands(op, A, B, bk) for A, B in chunk]
                    Ab, Bb, _ = batching.assemble([p[0] for p in padded], [p[1] for p in padded],
                                                  bk, device=dev)
                    Xv, infov, _ = run(op, "vmap", Ab, Bb)
                    for impl in impls:
                        X, info, counts = run(op, impl, Ab, Bb)
                        want = dict.fromkeys(counts, 0)
                        if dtype == torch.float32:
                            want.update(SERVE_LAUNCHES[(op, impl)])
                        check(counts == want, f"serve {op} {impl} {dtype}: launches {counts} != {want}")
                        for name in SMALL_KERNELS:
                            launches[name] += counts[name]
                        out["calls"] += 1
                        check(not bool(info.any()), f"serve {op} {impl}: info {info.tolist()}")
                        for i, (A, B) in enumerate(chunk):
                            xi = batching.crop(op, X[i], tuple(A.shape),
                                               None if B is None else tuple(B.shape))
                            r = serve_residual(op, A, B, xi)
                            check(r < tol, f"serve {op} {impl} {dtype}: residual {r} >= {tol}")
                            worst = max(worst, r)
                            # the identity tail: padded rows and columns exactly zero
                            tail = X[i].clone()
                            tail[: xi.shape[0], : xi.shape[1]] = 0
                            if op != "inv":
                                check(not bool(tail.any()), f"serve {op} {impl}: padded tail not zero")
                        fill = X[len(chunk):]
                        want_fill = (torch.eye(fill.shape[-1], dtype=dtype, device=dev).expand(fill.shape)
                                     if op == "inv" else torch.zeros_like(fill))
                        check(torch.equal(fill, want_fill), f"serve {op} {impl}: fill slots not exact")
                        d = float((X.double() - Xv.double()).abs().max() / Xv.double().abs().max())
                        check(d < 1e-4, f"serve {op} {impl}: pallas vs vmap {d}")
                        agree = max(agree, d)
            out["worst_residual"][f"{op} {dtype}"] = worst
            out["pallas_vs_vmap"][f"{op} {dtype}"] = agree

    # NaN containment through a fused batch: one poisoned problem
    reqs = serve_requests("posv", 8, torch.float32, seed=99)
    bk = batching.bucket_for("posv", (128, 128), (128, 8), "float32", cfg)
    padded = [batching.pad_operands("posv", A.to(dev), B.to(dev), bk) for A, B in reqs]
    Ab, Bb, _ = batching.assemble([p[0] for p in padded], [p[1] for p in padded], bk, device=dev)
    Xc, ic, cc = run("posv", "pallas", Ab, Bb)
    Ap = Ab.clone()
    Ap[3, 10, 10] = float("nan")
    Xn, inn, cn = run("posv", "pallas", Ap, Bb)
    for counts in (cc, cn):
        check(counts["small.posv"] == 1 and sum(counts.values()) == 1,
              f"serve containment: launches {counts}")
        launches["small.posv"] += 1
    others = [i for i in range(8) if i != 3]
    check(int(inn[3]) != 0 and not bool(inn[others].any()) and not bool(ic.any()),
          f"serve containment: info {inn.tolist()}")
    check(all(torch.equal(Xn[i], Xc[i]) for i in others), "serve containment: a neighbour changed")
    out["containment_info"] = inn.tolist()

    # per-call latency of the (8, 128, 8) f32 bucket: host clock around a
    # synchronised call, the fused kernel against the library route
    lat = {}
    for impl in ("pallas", "vmap"):
        f = api.batched("posv", "highest", impl)
        for _ in range(3):
            f(Ab, Bb)
        samples = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(Ab, Bb)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
        lat[impl] = dict(p50_ms=samples[len(samples) // 2], p90_ms=samples[int(0.9 * len(samples))])
    out["latency_posv_8x128x8_f32"] = lat
    for impl in ("pallas", "vmap"):
        f = api.batched("posv", "highest", impl)
        out[f"profile_posv_8x128x8_{impl}"] = profile(lambda: f(Ab, Bb), "SV::" if impl == "pallas" else "serve::")
    out["launches"] = launches
    return out


# ---- the serve engine (phase 7b) -------------------------------------------

#: the reference's serve smoke (capital_tpu/serve/__main__.py:146-172) at the
#: port's small-N widths: serve_phase's ladders, the default structured ones
ENGINE_CFG = dict(buckets=(32, 64, 128), rows_buckets=(128, 256, 512), nrhs_buckets=(1, 8, 64),
                  max_batch=8)
#: requests of the seeded stream, by kind
ENGINE_MIX = {"posv": 64, "lstsq": 48, "inv": 32, "posv_blocktri": 48, "posv_arrowhead": 24,
              "posv f64": 16, "posv f64 guaranteed": 16, "posv oversize": 4}
#: the kernels the stream's bucket programs run (f32 dense on the fused
#: kernels, guaranteed f64 on potrf + potrs, the chains' scan steps)
ENGINE_KERNELS = ("small.posv", "small.lstsq", "small.potrf", "small.potrs", "bt.fused_forward",
                  "bt.solve_backward")
#: the turns of the stream, by scheduler
ENGINE_TURNS = ("continuous", "sync", "sync", "continuous")
#: each captured program's replay against its eager program: calls of each, in turns
ENGINE_REPLAY_CALLS = 5
#: the CUDA kernel each counted kernel of the engine's programs runs, as
#: its name reads in a trace (regular expressions; the chain's solve steps
#: on either route, in either dtype)
ENGINE_TRACE_NAMES = {
    "small.posv": ("posv_kernel<",), "small.potrf": ("potrf_kernel<",),
    "small.potrs": ("potrs_kernel<",), "small.lstsq": ("lstsq_kernel<",),
    "bt.fused_forward": ("fused_forward_sweep_kernel<", "fused_forward_blocked_kernel<"),
    "bt.factor": ("factor_kernel<",),
    "bt.forward_solve": ("forward_solve_kernel<", r"solve_blocked_kernel<[^,>]*, true>"),
    "bt.solve_backward": ("solve_backward_kernel<", r"solve_blocked_kernel<[^,>]*, false>"),
    "up.sweep": ("sweep_kernel<", "sweep_wave_kernel<"),
}


def engine_requests(seed: int, dev):
    """The engine phase's seeded stream, made on the card: ragged f32 posv
    / lstsq / inv (n 17-128, nrhs 1-64; lstsq m 2n-3n), f32 posv_blocktri
    (nblocks 8-64, b 32-128, nrhs 1-8), posv_arrowhead (8 blocks of 32,
    border s 8-32, nrhs 1-8), f64 posv (the library route) and guaranteed
    f64 posv (n 17-128, nrhs 1-8), and four f32 posv at n = 1024 (the
    oversize single route), shuffled.  Returns [(op, A, B, tier)]."""
    from capital_tpu_torch.models import arrowhead

    host = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = lambda lo, hi: int(torch.randint(lo, hi + 1, (1,), generator=host))  # noqa: E731

    def spd(n, dtype):
        G = torch.randn((n, n), generator=gen, device=dev, dtype=torch.float64)
        return (G @ G.T / n + 3.0 * torch.eye(n, device=dev, dtype=torch.float64)).to(dtype)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64).to(dtype)

    f32, f64 = torch.float32, torch.float64
    reqs = []
    for kind, count in ENGINE_MIX.items():
        for _ in range(count):
            n = pick(17, 128)
            if kind == "posv":
                reqs.append(("posv", spd(n, f32), randn(n, pick(1, 64)), "balanced"))
            elif kind == "lstsq":
                m = pick(2 * n, 3 * n)
                reqs.append(("lstsq", randn(m, n), randn(m, pick(1, 64)), "balanced"))
            elif kind == "inv":
                reqs.append(("inv", spd(n, f32), None, "balanced"))
            elif kind in ("posv f64", "posv f64 guaranteed"):
                tier = "guaranteed" if kind.endswith("guaranteed") else "balanced"
                reqs.append(("posv", spd(n, f64), randn(n, pick(1, 8), dtype=f64), tier))
            elif kind == "posv oversize":
                reqs.append(("posv", spd(1024, f32), randn(1024, 4), "balanced"))
            else:
                nblocks, b = (pick(8, 64), pick(32, 128)) if kind == "posv_blocktri" else (8, 32)
                D, C, B = chain_operands(1, nblocks, b, pick(1, 8), pick(0, 1 << 30), dev)
                A = torch.stack([D[0], C[0]])
                if kind == "posv_blocktri":
                    reqs.append(("posv_blocktri", A, B[0], "balanced"))
                else:
                    s = pick(8, 32)
                    _, _, F, S, _, Bs = arrowhead_operands(1, nblocks, b, s, B.shape[-1], pick(0, 1 << 30),
                                                           dev)
                    reqs.append(("posv_arrowhead", A, arrowhead.pack(F, S, B, Bs)[0], "balanced"))
    order = torch.randperm(len(reqs), generator=host).tolist()
    return [reqs[i] for i in order]


def engine_residual(op: str, A, B, X) -> float:
    """One response's residual in f64 on the card, the reference smoke's
    (capital_tpu/serve/__main__.py `_residual`): ‖AX − B‖/‖B‖ (posv, and the
    chain ops blockwise), the normal equations' for lstsq, ‖AX − I‖/√n for
    inv."""
    from capital_tpu_torch.models import arrowhead

    if op == "posv_blocktri":
        return chain_residual(A[0][None], A[1][None], B[None], X[None])
    if op == "posv_arrowhead":
        nblocks, b = A.shape[1], A.shape[2]
        F, S, Bc, Bs = arrowhead.unpack(B[None], nblocks, b)
        n_t = nblocks * b
        Xc = X[:n_t].reshape(1, nblocks, b, -1)
        return arrowhead_residual(A[0][None], A[1][None], F, S, Bc, Bs, Xc, X[n_t:][None])
    A, X = A.double(), X.double()
    if op == "inv":
        n = A.shape[0]
        return float(torch.linalg.norm(A @ X - torch.eye(n, dtype=torch.float64, device=A.device))
                     / math.sqrt(n))
    B = B.double()
    if op == "lstsq":
        return float(torch.linalg.norm(A.T @ (A @ X - B)) / torch.linalg.norm(A.T @ B))
    return float(torch.linalg.norm(A @ X - B) / torch.linalg.norm(B))


def engine_turn(eng, reqs) -> dict:
    """One pass of the stream through `eng`, the reference smoke's loop:
    every 7th submit sleeps past max_delay_s and pumps (the deadline path),
    then drain.  Returns the responses, the wall and the batches' mean
    occupancy."""
    occ0 = len(eng.stats.occupancies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = []
    for i, (op, A, B, tier) in enumerate(reqs):
        tickets.append(eng.submit(op, A, B, accuracy_tier=tier))
        if i % 7 == 6:
            time.sleep(eng.cfg.max_delay_s)
            eng.pump()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    occ = eng.stats.occupancies[occ0:]
    return dict(responses=[t.result() for t in tickets], wall_s=wall,
                batches=len(occ), occupancy=sum(occ) / len(occ))


def latency_split(responses) -> dict:
    """p50 / p99 of the latency and of its queue-wait and device halves,
    ms, over the batched responses (nearest rank, stats.percentiles)."""
    from capital_tpu_torch.serve import stats

    batched = [r for r in responses if r.batched]
    out = {}
    for name in ("latency_s", "queue_wait_s", "device_s"):
        p = stats.percentiles([getattr(r, name) for r in batched], (50.0, 99.0))
        out[name.replace("_s", "_ms")] = {k: v * 1e3 for k, v in p.items()}
    return out


def engine_plan(bucket, cfg) -> tuple[dict, dict]:
    """A bucket program's launches and route tallies at capture: the
    serve_phase plans for the f32 dense buckets, nothing for the f64
    library route, potrf once and potrs once a sweep (the cap, and the
    start) for guaranteed f64 posv, and `bt_posv_plan` on the blocked
    route for the chain ops."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.robust import refine
    from capital_tpu_torch.serve import program

    if bucket.op in ("posv_blocktri", "posv_arrowhead"):
        nbb = bucket.a_shape[1]
        plan = bt_posv_plan(blocktri, nbb, program.blocktri_algorithm(nbb, bucket.dtype, cfg))
        return plan, {k: {"blocked": v} for k, v in plan.items()}
    if bucket.tier == "guaranteed":
        sweeps = refine.plan("guaranteed", torch.float64).max_iters + 1
        return {"small.potrf": 1, "small.potrs": sweeps}, {}
    if bucket.dtype == "float64":
        return {}, {}
    return dict(SERVE_LAUNCHES[(bucket.op, "auto")]), {}


def engine_trace_counts(launches: dict) -> dict:
    """A trace's kernel records by counted kernel (ENGINE_TRACE_NAMES; a
    pattern matches at a name boundary, so 'sweep_kernel<' is not the
    chain's fused_forward_sweep_kernel)."""
    pats = {k: [re.compile(r"(?<![\w])" + p) for p in ps] for k, ps in ENGINE_TRACE_NAMES.items()}
    return {k: sum(n for name, n in launches.items() if any(p.search(name) for p in ps))
            for k, ps in pats.items()}


def engine_replays(eng, reqs, cfg) -> dict:
    """Each captured program against an eager call of its `api.batched`
    program on one assembled batch of its own requests: bit for bit, and
    the host wall of a synchronized call of each, in turns."""
    from capital_tpu_torch.serve import api, batching

    groups: dict = {}
    for op, A, B, tier in reqs:
        bk = batching.bucket_for(op, tuple(A.shape), None if B is None else tuple(B.shape),
                                 str(A.dtype).replace("torch.", ""), eng.cfg, tier=tier)
        if bk is not None:
            groups.setdefault(bk, []).append(batching.pad_operands(op, A, B, bk))
    out = {}
    for key, prog in eng.cache.programs().items():
        bk = prog.bucket
        members = groups[bk][: bk.capacity]
        Ab, Bb, _ = batching.assemble([p[0] for p in members], [p[1] for p in members], bk,
                                      device=eng.grid.device)
        ins = (Ab,) if Bb is None else (Ab, Bb)
        fn = api.batched(bk.op, cfg.precision, cfg.small_n_impl, blocktri_impl=cfg.blocktri_impl,
                         tier=bk.tier)
        got = prog(*ins)
        want = tuple(fn(*(x.clone() for x in ins)))
        torch.cuda.synchronize()
        label = batching.bucket_label(bk)
        check(len(got) == len(want) and all(same_bits(g, w) for g, w in zip(got, want)),
              f"engine: {label} replay differs from the eager program on the same batch")
        walls = {"replay": [], "eager": []}
        for i in range(ENGINE_REPLAY_CALLS):
            for name in (("replay", "eager") if i % 2 == 0 else ("eager", "replay")):
                f = (lambda: prog(*ins)) if name == "replay" else (lambda: fn(*ins))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        out[label] = dict(problems=len(members), replay_ms=statistics.median(walls["replay"]),
                          eager_ms=statistics.median(walls["eager"]))
    return out


def engine_phase(hopper, dev) -> dict:
    """The port's SolveEngine on the card (module docstring, phase 7b)."""
    from capital_tpu_torch.obs import ledger, spans
    from capital_tpu_torch.serve import ServeConfig, SolveEngine

    reqs = engine_requests(19, dev)
    tol32, tol64 = 5e-5, 1e-13  # bench/drivers.py:_tolerance; lstsq 10x
    engines, out = {}, {"requests": len(reqs), "turns": []}
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    for sched in dict.fromkeys(ENGINE_TURNS):
        cfg = ServeConfig(scheduler=sched, **ENGINE_CFG)
        eng = engines[sched] = SolveEngine(cfg=cfg)
        built = eng.warmup((op, tuple(A.shape), None if B is None else tuple(B.shape), A.dtype, tier)
                           for op, A, B, tier in reqs)
        out[f"warmup_{sched}"] = dict(builds=built, cache=eng.cache_stats())
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    out["warmup_counts"] = {k: v for k, v in hopper.counts().items() if v}
    missing = [k for k in ENGINE_KERNELS if not out["warmup_counts"].get(k)]
    check(not missing, f"engine: kernels of the engine's programs never launched: {missing}")
    # the captured programs' plans, at capture
    for sched, eng in engines.items():
        progs = eng.cache.programs()
        check(progs and all(p.captured for p in progs.values()),
              f"engine {sched}: a bucket program was not captured")
        for prog in progs.values():
            plan, routes = engine_plan(prog.bucket, eng.cfg)
            check(prog.capture_counts == plan and prog.capture_routes == routes,
                  f"engine {sched} {prog.bucket}: capture launched {prog.capture_counts} "
                  f"{prog.capture_routes}, plan {plan} {routes}")
        out[f"programs_{sched}"] = len(progs)
    # the stream, continuous against sync in turns
    for sched in ENGINE_TURNS:
        eng = engines[sched]
        turn = engine_turn(eng, reqs)
        worst: dict = {}
        for (op, A, B, tier), r in zip(reqs, turn["responses"]):
            check(r.ok and r.x is not None, f"engine {sched}: request {r.request_id} ({op}) failed: {r.error}")
            res = engine_residual(op, A, B, r.x)
            tol = tol64 if A.dtype == torch.float64 else tol32
            gate = 10 * tol if op == "lstsq" else tol
            check(res < gate, f"engine {sched}: request {r.request_id} ({op} {tuple(A.shape)} {tier}) "
                              f"residual {res} >= {gate}")
            name = f"{op} {str(A.dtype)[6:]} {tier}"
            worst[name] = max(worst.get(name, 0.0), res)
        line = dict(scheduler=sched, wall_s=turn["wall_s"], batches=turn["batches"],
                    occupancy=turn["occupancy"], **latency_split(turn["responses"]), worst_residual=worst)
        out["turns"].append(line)
        print(json.dumps({"engine_turn": sched, **{k: v for k, v in line.items() if k != "worst_residual"}}),
              flush=True)
    for sched, eng in engines.items():
        cache = eng.cache_stats()
        warm = out[f"warmup_{sched}"]["cache"]
        check(cache["misses"] == 0 and cache["compiles"] == warm["compiles"],
              f"engine {sched}: built after warm-up: {cache} (warm-up {warm})")
    # one continuous turn under the profiler: the replays ran their plans
    eng = engines["continuous"]
    for n in range(1, 4):
        before = eng.cache.replays()
        hopper.reset_counts()
        prof = profile(lambda: engine_turn(eng, reqs), "SV::")
        eager = hopper.counts()
        want = dict.fromkeys(ENGINE_TRACE_NAMES, 0)
        for key, prog in eng.cache.programs().items():
            for k, v in prog.capture_counts.items():
                want[k] += (prog.replays - before.get(key, 0)) * v
        for k in want:
            want[k] += eager.get(k, 0)
        got = engine_trace_counts(prof["launches"])
        if got == want:
            break
    check(got == want, f"engine: the trace's kernel records {got} != replays x plan {want}")
    # launches outside the graphs: the oversize singles' (the models' own route)
    out["profile"] = dict(tries=n, kernels=got, eager_counts={k: v for k, v in eager.items() if v},
                          wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                          idle_share=prof["idle_share"], top_kernels_device_ms=prof["top_kernels_device_ms"])
    print(json.dumps({"engine_profile": "continuous turn", **out["profile"]}), flush=True)
    # the records: complete chains, the reference's schema
    for sched, eng in engines.items():
        st = eng.emit_trace()["serve_trace"]
        bad = [p for t in st["traces"] for p in spans.trace_dict_problems(t)]
        check(st["requests"] == st["complete"] == eng.stats.requests and not st["dropped"] and not bad,
              f"engine {sched}: {st['complete']} of {st['requests']} trace chains complete "
              f"({eng.stats.requests} requests): {bad[:3]}")
        rec = eng.emit_stats()
        check(rec["manifest"]["platform"] == "cuda" and rec["record"] == "capital_tpu.ledger",
              f"engine {sched}: record {rec['manifest']}")
        out[f"stats_{sched}"] = {k: rec["request_stats"][k] for k in
                                 ("requests", "ok", "batches", "batch_occupancy_mean", "latency_ms",
                                  "queue_wait_ms", "device_ms", "cache")}
        out[f"trace_{sched}"] = dict(requests=st["requests"], complete=st["complete"])
    out["ledger_schema"] = ledger.SCHEMA_VERSION
    # every captured program against its eager program
    rep = engine_replays(engines["continuous"], reqs, engines["continuous"].cfg)
    out["replay_vs_eager"] = rep
    tot_r = sum(r["replay_ms"] for r in rep.values())
    tot_e = sum(r["eager_ms"] for r in rep.values())
    print(json.dumps({"engine_replay_vs_eager": {"programs": len(rep), "replay_ms_sum": tot_r,
                                                 "eager_ms_sum": tot_e}}), flush=True)
    for label, r in sorted(rep.items()):
        print(json.dumps({"engine_program": label, **r}), flush=True)
    return out


# ---- factor residency and streaming sessions (phase 7c) ----------------------

#: the residency stream's engine: phase 7b's ladders, robust flagging on,
#: and a factor pool of ten 128 x 128 f32 factors, so the stream evicts
RESIDENCY_CFG = dict(ENGINE_CFG, factor_cache_bytes=10 * 128 * 128 * 4)
#: the session flagship (Makefile:164-169, bench-session): a window of 64
#: blocks of 128, slid by 8, two RHS columns, one problem, f32
SESSION_FLAGSHIP = (64, 128, 8, 2)
#: the session engine: phase 7b's ladders with the window's chain rungs and
#: a pool that holds one session (a 72-block chain is 9.1 MB), not two
SESSION_CFG = dict(ENGINE_CFG, nblocks_buckets=(8, 64), block_buckets=(128,),
                   factor_cache_bytes=12 << 20)
#: the sliding cycles, by the tier of their solve (the plain versions'
#: run of the same stream is most of the phase's time: one cycle a tier)
SESSION_TIERS = ("balanced", "fast", "guaranteed")
#: the kernels of the residency and session programs
RESIDENCY_KERNELS = ("small.potrf", "small.potrs", "up.sweep", "bt.factor", "bt.forward_solve",
                     "bt.solve_backward")


@contextmanager
def eager_programs():
    """Build every bucket program as its eager closure (for the comparison
    run on the plain versions only): `program.capturable` answers False."""
    from capital_tpu_torch.serve import program

    saved = program.capturable
    program.capturable = lambda bucket, cfg: False
    try:
        yield
    finally:
        program.capturable = saved


def residency_plan(bucket, cfg) -> tuple[dict, dict]:
    """A residency or session bucket program's launches and route tallies
    at capture: potrs (hit) or potrf + potrs (miss) for f32 posv_cached,
    one sweep for an f32 update on `update_small.sweep_route`, nbb/seg
    factor steps for an extend, nbb/seg forward and backward steps a sweep
    for a session solve (the guaranteed tier's sweep cap and its start),
    all on the blocked chain route; nothing for the f64 library route."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.ops import update_small
    from capital_tpu_torch.robust import refine

    if bucket.dtype == "float64":
        return {}, {}
    if bucket.op == "posv_cached":
        return {"small.potrs": 1}, {}
    if bucket.op == "posv_cached_miss":
        return {"small.potrf": 1, "small.potrs": 1}, {}
    if bucket.op in ("chol_update", "chol_downdate"):
        return {"up.sweep": 1}, {"up.sweep": {update_small.sweep_route(bucket.capacity, bucket.b_shape[1]): 1}}
    steps = bucket.a_shape[1] // blocktri.resolve_seg(bucket.a_shape[1])
    if bucket.op in ("blocktri_extend", "session_extend"):
        plan = {"bt.factor": steps}
    else:
        sweeps = refine.DEFAULT_MAX_ITERS + 1 if bucket.tier == "guaranteed" else 1
        plan = {"bt.forward_solve": sweeps * steps, "bt.solve_backward": sweeps * steps}
    return plan, {k: {"blocked": v} for k, v in plan.items()}


def residency_data(dev) -> dict:
    """The residency stream's operands, made on the card from a seed: the
    reference's 50-request residency smoke (capital_tpu/bench/drivers.py
    `_update_serve_smoke`: seed tokens with posv_cached misses, then
    chol_update / posv_cached hits) at n = 128 f32 with k 1 and 8, plus
    one f64 token (the library route); downdates at the edge of
    definiteness (A − VVᵀ = Rᵀ(I − PPᵀ)R with ‖P‖₂² = 1 − 3e-7, which the
    f32 sweep flags for most seeds while the refactor of S = RᵀR − VVᵀ
    succeeds) and one beyond it (‖P‖₂ = 1.5, where the degrade fails)."""
    gen = torch.Generator(device=dev).manual_seed(20)
    f64 = torch.float64

    def spd(n, dtype=torch.float32):
        G = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
        return (G @ G.T / n + 3.0 * torch.eye(n, device=dev, dtype=f64)).to(dtype)

    def panel(A, k, scale):
        R = torch.linalg.cholesky(A.double()).T
        Q, _ = torch.linalg.qr(torch.randn((128, k), generator=gen, device=dev, dtype=f64))
        sig = torch.full((k,), 0.5, device=dev, dtype=f64)
        sig[0] = scale
        return (R.T @ (Q * sig)).float()

    toks = {f"tok{i}": spd(128) for i in range(4)}
    toks["tok64"] = spd(128, f64)
    edge = {f"edge{i}": spd(128) for i in range(4)}
    over = spd(128)
    Dc, Cc, _ = chain_operands(1, 16, 128, 1, 24, dev)
    return dict(chain=(Dc[0], Cc[0]),
        A=toks, B={t: torch.randn((128, 4), generator=gen, device=dev, dtype=A.dtype) for t, A in toks.items()},
        V={k: 0.05 / math.sqrt(128) * torch.randn((128, k), generator=gen, device=dev) for k in (1, 8)},
        V64=0.05 / math.sqrt(128) * torch.randn((128, 8), generator=gen, device=dev, dtype=f64),
        edge=edge, edge_V={t: panel(A, 1, math.sqrt(1.0 - 3e-7)) for t, A in edge.items()},
        over=over, over_V=panel(over, 8, 1.5), Bf=torch.randn((128, 4), generator=gen, device=dev))


def residency_turn(eng, data, faultinject) -> dict:
    """The residency stream through `eng` (module docstring, phase 7c):
    requests are issued a round at a time (one per token, so a batch holds
    several tokens' requests) and each round drains, because an update
    reads the resident factor at submit.  Returns the responses by step,
    the tracked matrices and what the checks read."""
    A = {t: a.double() for t, a in {**data["A"], **data["edge"], "over": data["over"]}.items()}
    steps, flagged = [], {}

    def round_(reqs):
        # each step keeps the matrix a solve answers for (tracked in f64)
        ts = [(label, eng.submit(op, X, Y, factor_token=tok), A.get(tok) if op == "posv_cached" else None)
              for label, op, X, Y, tok in reqs]
        eng.drain()
        for label, t, ref in ts:
            steps.append((label, t.result(), ref))
        return [t.result() for _, t, _ in ts]

    toks = list(data["A"])
    round_([(f"seed {t}", "posv_cached", data["A"][t], data["B"][t], t) for t in toks])  # 5 misses
    n_req = len(toks)
    i = 0
    while n_req < 50:  # 45 hits: updates, downdates back, solves
        reqs = []
        for t in toks:
            f64 = t == "tok64"
            kind = (i + toks.index(t)) % 3
            V = data["V64"] if f64 else data["V"][1 if i % 2 else 8]
            if kind == 0:
                reqs.append((f"update {t}", "chol_update", V, None, t))
                A[t] = A[t] + V.double() @ V.double().T
            elif kind == 1 and i >= 1:
                reqs.append((f"downdate {t}", "chol_downdate", V, None, t))
                A[t] = A[t] - V.double() @ V.double().T
            else:
                reqs.append((f"solve {t}", "posv_cached", A[t].to(data["A"][t].dtype), data["B"][t], t))
        for (label, op, X, Y, t), r in zip(reqs, round_(reqs)):
            check(r.ok, f"residency: {label} failed: {r.error}")
        n_req += len(reqs)
        i += 1
    # a flagged update: a NaN planted in V at ingest; the resident R is
    # left bit for bit as it was
    R0 = eng.factors.peek("tok0").arrays[0].clone()
    with faultinject.active_plan(faultinject.Fault(tag="serve::ingest", kind="nan")):
        (r,) = round_([("poisoned update tok0", "chol_update", data["V"][8], None, "tok0")])
    flagged_ok = (not r.ok and "left unchanged" in (r.error or "")
                  and torch.equal(eng.factors.peek("tok0").arrays[0], R0))
    # downdates at the edge of definiteness: the f32 sweep flags, the
    # engine degrades to the refactor from the resident factor
    round_([(f"seed {t}", "posv_cached", a, data["Bf"], t) for t, a in data["edge"].items()])
    d0 = eng.factor_stats()["downdate_degrades"]
    edge = round_([(f"edge downdate {t}", "chol_downdate", data["edge_V"][t], None, t) for t in data["edge"]])
    for t, r in zip(data["edge"], edge):
        A[t] = data["edge"][t].double() - data["edge_V"][t].double() @ data["edge_V"][t].double().T
        flagged[t] = bool(r.info is not None and int(r.info.escalated) == 1)
    degrades = eng.factor_stats()["downdate_degrades"] - d0
    # beyond definiteness: the degrade fails too, loudly; R stays
    round_([("seed over", "posv_cached", data["over"], data["Bf"], "over")])
    R1 = eng.factors.peek("over").arrays[0].clone() if eng.factors.peek("over") is not None else None
    (r_over,) = round_([("infeasible downdate over", "chol_downdate", data["over_V"], None, "over")])
    over_ok = (not r_over.ok and "ALSO failed" in (r_over.error or "")
               and R1 is not None and torch.equal(eng.factors.peek("over").arrays[0], R1))
    # the pool is over budget by now: traffic to an evicted token fails
    # loudly, and a posv_cached miss reseeds it
    gone = [t for t in toks + list(data["edge"]) if eng.factors.evicted(t)]
    evict = {}
    if gone:
        t = gone[0]
        V = data["V64"] if t == "tok64" else data["V"][8]
        (r_ev,) = round_([(f"evicted update {t}", "chol_update", V, None, t)])
        At = A[t].to(data["A"].get(t, data["Bf"]).dtype)
        (r_re,) = round_([(f"reseed {t}", "posv_cached", At, data["B"].get(t, data["Bf"]), t)])
        evict = dict(token=t, failed_loud=not r_ev.ok and "evicted" in (r_ev.error or ""), reseeded=r_re.ok)
    # every resident factor against its tracked matrix, before the chain
    # below evicts them
    resident = {}
    for tok, At in A.items():
        ent = eng.factors.peek(tok)
        if ent is not None:
            R = ent.arrays[0].double()
            resident[tok] = (float(torch.linalg.norm(R.T @ R - At) / torch.linalg.norm(At)),
                             ent.arrays[0].dtype == torch.float64)
    # a chain of 16 blocks of 128 extended 8 at a time from its resident
    # carry (1 MiB: over the pool's budget alone, so it is the newest entry
    # kept and evicts the rest): bit for bit the whole chain's refactor
    from capital_tpu_torch.models import blocktri

    Dc, Cc = data["chain"]
    for lo in (0, 8):
        (r,) = round_([("extend chain", "blocktri_extend", torch.stack([Dc[lo:lo + 8], Cc[lo:lo + 8]]), None,
                        "chain")])
        check(r.ok, f"residency: extend chain failed: {r.error}")
    L, Wt, info = blocktri.factor(Dc[None], Cc[None])
    ent = eng.factors.peek("chain")
    extend_ok = bool(ent is not None and not info.any() and torch.equal(ent.arrays[0], L[0])
                     and torch.equal(ent.arrays[1], Wt[0]) and torch.equal(ent.arrays[2], L[0, -1]))
    return dict(steps=steps, A=A, flagged_ok=flagged_ok, edge_flagged=flagged, degrades=degrades,
                over_ok=over_ok, gone=gone, evict=evict, extend_equals_refactor=extend_ok, resident=resident)


def residency_checks(data, turn) -> dict:
    """The stream's gates: every solve's ‖AX − B‖/‖B‖ and every resident
    factor's ‖RᵀR − A‖/‖A‖ (before the chain evicts them; the degraded
    ones too) against the tracked matrix (f64 on the card) under the bench
    gate (5e-5 f32, 1e-12 f64: bench/drivers.py `_tolerance`)."""
    worst: dict = {}
    for label, r, A in turn["steps"]:
        kind, tok = label.rsplit(" ", 1)
        if not r.ok or A is None:
            continue
        B = data["B"].get(tok, data["Bf"]).double()
        res = float(torch.linalg.norm(A @ r.x.double() - B) / torch.linalg.norm(B))
        tol = 1e-12 if r.x.dtype == torch.float64 else 5e-5
        check(res < tol, f"residency: {label} residual {res} >= {tol}")
        worst[f"{kind} {str(r.x.dtype)[6:]}"] = max(worst.get(f"{kind} {str(r.x.dtype)[6:]}", 0.0), res)
    for tok, (res, f64) in turn["resident"].items():
        tol = 1e-12 if f64 else 5e-5
        check(res < tol, f"residency: resident factor {tok} residual {res} >= {tol}")
        worst["factor"] = max(worst.get("factor", 0.0), res)
    return worst


def session_data(dev) -> dict:
    """The session stream's chain, made on the card from a seed (the bench
    drivers' chain, `chain_operands`): the 64-block window and a slide of 8
    blocks a cycle, C[0] live in each slide; one RHS per cycle."""
    nblocks, b, slide, nrhs = SESSION_FLAGSHIP
    total = nblocks + slide * len(SESSION_TIERS)
    D, C, _ = chain_operands(1, total, b, 1, 21, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    return dict(D=D[0], C=C[0], B=[torch.randn((nblocks, b, nrhs), generator=gen, device=dev)
                                   for _ in SESSION_TIERS])


def np_window_residuals(D, C, L, Wt, B, X) -> tuple[float, float]:
    """The slid window's solve residual ‖A·X − B‖/‖B‖ and reconstruction
    residual ‖A − L̃·L̃ᵀ‖/‖A‖, blockwise in f64 numpy on the host, against
    the marginalized window (D, C) the session mirror holds."""
    import numpy as np

    D, C, L, Wt, B, X = (t.double().cpu().numpy() for t in (D, C, L, Wt, B, X))
    Y = D @ X
    Y[1:] += C[1:] @ X[:-1]
    Y[:-1] += C[1:].transpose(0, 2, 1) @ X[1:]
    solve = float(np.linalg.norm(Y - B) / np.linalg.norm(B))
    W = Wt.transpose(0, 2, 1)
    diag = L @ L.transpose(0, 2, 1)
    diag[1:] += W[1:] @ W[1:].transpose(0, 2, 1)
    off = W[1:] @ L[:-1].transpose(0, 2, 1)
    num = np.square(diag - D).sum() + 2.0 * np.square(off - C[1:]).sum()
    den = np.square(D).sum() + 2.0 * np.square(C[1:]).sum()
    return solve, float(np.sqrt(num / den))


def session_turn(eng, mgr, data, SessionEvicted) -> dict:
    """The session stream (phase 7c): open the 64-block window, then per
    cycle append 8 + contract 8 + solve at the cycle's tier, each solve and
    the resident factor held to the slid window; after the first append
    the resident 72-block chain against a refactor of the whole chain,
    bit for bit; then a second session evicts the first, whose next solve
    raises SessionEvicted, and open reseeds it."""
    from capital_tpu_torch.models import blocktri

    nblocks, _, slide, _ = SESSION_FLAGSHIP
    D, C = data["D"], data["C"]
    out = {"cycles": []}
    r = mgr.open("s", D[:nblocks], C[:nblocks])
    check(r.ok, f"session: open failed: {r.error}")
    for i, tier in enumerate(SESSION_TIERS):
        lo = nblocks + i * slide
        r = mgr.append("s", D[lo:lo + slide], C[lo:lo + slide])
        check(r.ok, f"session: append {i} failed: {r.error}")
        if i == 0:
            ent = eng.factors.peek("s")
            L, Wt, info = blocktri.factor(D[None, :lo + slide], C[None, :lo + slide])
            out["extend_equals_refactor"] = bool(not info.any() and torch.equal(ent.arrays[0], L[0])
                                                 and torch.equal(ent.arrays[1], Wt[0]))
        r = mgr.contract("s", slide)
        check(r.ok, f"session: contract {i} failed: {r.error}")
        r = mgr.solve("s", data["B"][i], accuracy_tier=tier)
        check(r.ok, f"session: {tier} solve {i} failed: {r.error}")
        Dw, Cw = mgr.window("s")
        ent = eng.factors.peek("s")
        solve, recon = np_window_residuals(Dw, Cw, ent.arrays[0], ent.arrays[1], data["B"][i], r.x)
        out["cycles"].append(dict(tier=tier, solve_residual=solve, reconstruction_residual=recon, x=r.x))
    # eviction: a second window evicts the first; the reseed is open
    r = mgr.open("s2", D[:nblocks], C[:nblocks])
    check(r.ok, f"session: open s2 failed: {r.error}")
    try:
        mgr.solve("s", data["B"][0])
        out["evicted_raised"] = False
    except SessionEvicted:
        out["evicted_raised"] = True
    r = mgr.open("s", D[:nblocks], C[:nblocks])
    out["reseeded"] = r.ok and mgr.solve("s", data["B"][0]).ok
    return out


def residency_replays(eng, cfg, dev) -> dict:
    """Each captured program of `eng` against an eager call of its
    `api.batched` program on one seeded batch of well-posed problems at the
    bucket's shapes: bit for bit, and the host wall of a synchronized call
    of each, in turns."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.serve import api, batching

    gen = torch.Generator(device=dev).manual_seed(23)
    f64 = torch.float64
    out = {}
    for prog in eng.cache.programs().values():
        bk = prog.bucket
        cap, dt = bk.capacity, batching._dtype(bk.dtype)

        def spd(*shape):
            G = torch.randn(shape, generator=gen, device=dev, dtype=f64)
            return G @ G.mT / shape[-1] + 3.0 * torch.eye(shape[-1], device=dev, dtype=f64)

        if bk.op in ("posv_cached", "posv_cached_miss", "chol_update", "chol_downdate"):
            n = bk.a_shape[0]
            A = spd(cap, n, n)
            if bk.op != "posv_cached_miss":
                A = torch.linalg.cholesky(A).mT.contiguous()
            B = torch.randn((cap,) + bk.b_shape, generator=gen, device=dev, dtype=f64)
            if bk.op in ("chol_update", "chol_downdate"):
                B = 0.05 / math.sqrt(n) * B
        else:
            nb, b = bk.a_shape[1], bk.a_shape[2]
            D = spd(cap, nb, b, b)
            C = 0.3 / math.sqrt(b) * torch.randn((cap, nb, b, b), generator=gen, device=dev, dtype=f64)
            if bk.op in ("blocktri_extend", "session_extend"):
                A, B = torch.stack([D, C], dim=1), torch.linalg.cholesky(spd(cap, b, b))
            else:
                C[:, 0] = 0
                L, Wt, _ = blocktri.factor(D, C, impl="xla")
                A = torch.stack([D, C, L, Wt], dim=1)
                B = torch.randn((cap,) + bk.b_shape, generator=gen, device=dev, dtype=f64)
        ins = (A.to(dt), B.to(dt))
        fn = api.batched(bk.op, cfg.precision, cfg.small_n_impl, tier=bk.tier)
        got = prog(*ins)
        want = tuple(fn(*(x.clone() for x in ins)))
        torch.cuda.synchronize()
        label = batching.bucket_label(bk)
        check(len(got) == len(want) and all(same_bits(g, w) for g, w in zip(got, want)),
              f"residency: {label} replay differs from the eager program on the same batch")
        walls = {"replay": [], "eager": []}
        for i in range(ENGINE_REPLAY_CALLS):
            for name in (("replay", "eager") if i % 2 == 0 else ("eager", "replay")):
                f = (lambda: prog(*ins)) if name == "replay" else (lambda: fn(*ins))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        out[label] = dict(outputs=len(got), replay_ms=statistics.median(walls["replay"]),
                          eager_ms=statistics.median(walls["eager"]))
    return out


def check_plans(eng, label: str) -> None:
    """Every program of `eng` captured, each with the launches and route
    tallies `residency_plan` (or phase 7b's `engine_plan`) predicts."""
    progs = eng.cache.programs()
    check(progs and all(p.captured for p in progs.values()), f"{label}: a bucket program was not captured")
    for prog in progs.values():
        plan, routes = residency_plan(prog.bucket, eng.cfg)
        check(prog.capture_counts == plan and prog.capture_routes == routes,
              f"{label} {prog.bucket}: capture launched {prog.capture_counts} {prog.capture_routes}, "
              f"plan {plan} {routes}")


def traced_turn(hopper, engines, run, label: str) -> dict:
    """`run` under the profiler (`complete_profile`), retaken until the
    trace's kernel records equal the replays it made times each program's
    plan at capture, plus the launches made eagerly (the degrade's library
    work launches none of the counted kernels)."""
    state = {}

    def turn():
        state["before"] = [eng.cache.replays() for eng in engines]
        hopper.reset_counts()
        res = run()
        state["eager"] = hopper.counts()
        return res

    def want_counts():
        want = dict.fromkeys(ENGINE_TRACE_NAMES, 0)
        for eng, before in zip(engines, state["before"]):
            for key, prog in eng.cache.programs().items():
                for k, v in prog.capture_counts.items():
                    want[k] += (prog.replays - before.get(key, 0)) * v
        for k in want:
            want[k] += state["eager"].get(k, 0)
        return want

    prof = complete_profile(turn, ("SS::", "SV::", "UP::"),
                            complete=lambda p: engine_trace_counts(p["launches"]) == want_counts())
    got, want = engine_trace_counts(prof["launches"]), want_counts()
    check(got == want, f"{label}: the trace's kernel records {got} != replays x plan {want}")
    return dict(tries=prof["tries"], kernels=got, wall_ms=prof["wall_ms"],
                device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                top_kernels_device_ms=prof["top_kernels_device_ms"])


def residency_phase(hopper, dev, smi: str) -> dict:
    """Phase 7c: factor residency and streaming sessions through the
    port's SolveEngine and SessionManager on the card (module docstring)."""
    from capital_tpu_torch.ops import batched_small, blocktri_small, update_small
    from capital_tpu_torch.robust import faultinject
    from capital_tpu_torch.robust.config import RobustConfig
    from capital_tpu_torch.serve import ServeConfig, SessionEvicted, SessionManager, SolveEngine

    out = {"card": smi, "seconds": {}}
    t_phase = time.perf_counter()
    rdata, sdata = residency_data(dev), session_data(dev)
    rcfg = ServeConfig(robust=RobustConfig(), **RESIDENCY_CFG)
    scfg = ServeConfig(**SESSION_CFG)
    nblocks, _, slide, _ = SESSION_FLAGSHIP

    def streams():
        eng = SolveEngine(cfg=rcfg)
        seng = SolveEngine(cfg=scfg)
        mgr = SessionManager(seng)
        res = residency_turn(eng, rdata, faultinject)
        ses = session_turn(seng, mgr, sdata, SessionEvicted)
        return eng, seng, mgr, res, ses

    # the main path: counters at 0 just before, read just after (captures
    # count at build time; replays launch without the wrappers)
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    eng, seng, mgr, res, ses = streams()
    torch.cuda.synchronize()
    out["seconds_first"] = time.perf_counter() - t0
    counts = hopper.counts()
    out["counts"] = {k: counts[k] for k in RESIDENCY_KERNELS}
    missing = [k for k in RESIDENCY_KERNELS if not counts.get(k)]
    check(not missing, f"residency: kernels of the residency and session programs never launched: {missing}")
    check_plans(eng, "residency")
    check_plans(seng, "session")
    # the residency gates
    worst = residency_checks(rdata, res)
    check(res["flagged_ok"], "residency: the poisoned update was not refused with the resident R unchanged")
    check(res["over_ok"], "residency: the infeasible downdate did not fail loudly with R unchanged")
    check(res["extend_equals_refactor"], "residency: extend from the resident carry differs from the refactor")
    nflag = sum(res["edge_flagged"].values())
    check(nflag >= 1 and res["degrades"] == nflag,
          f"residency: edge downdates degraded {res['degrades']}, flagged {res['edge_flagged']}")
    check(bool(res["gone"]) and res["evict"].get("failed_loud") and res["evict"].get("reseeded"),
          f"residency: eviction {res['gone']} {res['evict']}")
    fstats = eng.factor_stats()
    check(fstats["evictions"] >= 1 and sum(fstats["eviction_age_hist"].values()) == fstats["evictions"],
          f"residency: factor_cache {fstats}")
    out["residency"] = dict(requests=len(res["steps"]), worst_residual=worst, edge_flagged=res["edge_flagged"],
                            extend_equals_refactor=res["extend_equals_refactor"],
                            degrades=res["degrades"], evicted=res["gone"], evict=res["evict"],
                            factor_cache=fstats, cache=eng.cache_stats())
    print(json.dumps({"residency": "stream", "card": smi, **out["residency"]}), flush=True)
    # the session gates: f32 for the balanced and guaranteed solves and the
    # reconstruction, the repo's bf16 gate for the fast tier (a bf16 factor)
    for c in ses["cycles"]:
        gate = 5e-2 if c["tier"] == "fast" else 5e-5
        check(c["solve_residual"] < gate and c["reconstruction_residual"] < 5e-5,
              f"session: {c['tier']} cycle residuals {c['solve_residual']}, {c['reconstruction_residual']}")
    check(ses["extend_equals_refactor"], "session: extend from the resident carry differs from the refactor")
    check(ses["evicted_raised"] and ses["reseeded"], f"session: eviction {ses['evicted_raised']} {ses['reseeded']}")
    sstats = mgr.stats()
    check(sstats["evicted_failures"] == 1 and sstats["reseeds"] == 1, f"session: stats {sstats}")
    out["session"] = dict(cycles=[{k: v for k, v in c.items() if k != "x"} for c in ses["cycles"]],
                          extend_equals_refactor=ses["extend_equals_refactor"], session_stats=sstats,
                          factor_cache=seng.factor_stats())
    print(json.dumps({"session": "flagship 64x128 slide 8 f32", "card": smi, **out["session"]}), flush=True)
    # the same streams on the plain versions, their programs eager (a
    # capture of the plain versions' column loops would cost more than the
    # stream): the kernels' answers within the f32 tolerance (bf16 for the
    # fast tier)
    t0 = time.perf_counter()
    with plain_versions(batched_small, ("potrf", "potrs")), plain_versions(update_small, ("sweep",)), \
            plain_versions(blocktri_small, BT_WRAPPERS), eager_programs():
        peng, pseng, pmgr, pres, pses = streams()
    out["seconds"]["plain_streams"] = time.perf_counter() - t0
    worst_plain = 0.0
    for (label, r, _), (plabel, p, _) in zip(res["steps"], pres["steps"]):
        check(label == plabel and r.ok == p.ok, f"residency: plain stream diverged at {label} / {plabel}")
        if r.ok and p.ok:
            worst_plain = max(worst_plain, bt_rel(r.x, p.x))
    check(worst_plain < 1e-4, f"residency: kernels vs plain {worst_plain}")
    ses_plain = max(bt_rel(c["x"], pc["x"]) / (50.0 if c["tier"] == "fast" else 1.0)
                    for c, pc in zip(ses["cycles"], pses["cycles"]))
    check(ses_plain < 1e-4, f"session: kernels vs plain {ses_plain}")
    out["vs_plain"] = dict(residency=worst_plain, session=ses_plain)
    del peng, pseng, pmgr, pres, pses
    # every captured program against its eager program
    t0 = time.perf_counter()
    rep = {**residency_replays(eng, rcfg, dev), **residency_replays(seng, scfg, dev)}
    out["seconds"]["replays"] = time.perf_counter() - t0
    out["replay_vs_eager"] = rep
    for label, r in sorted(rep.items()):
        print(json.dumps({"residency_program": label, **r}), flush=True)
    # the sliding cycle against a full refactor of the 64-block window, both
    # through the engine (captured programs), in turns; the window opens as
    # "t" (one session resident: the pool holds one)
    D, C = sdata["D"], sdata["C"]
    mgr.close("s")
    mgr.close("s2")
    mgr.open("t", D[:nblocks], C[:nblocks])
    walls = {"cycle": [], "refactor": []}
    for i in range(5):
        for name in (("cycle", "refactor") if i % 2 == 0 else ("refactor", "cycle")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "refactor":
                r = mgr.open("t", D[:nblocks], C[:nblocks])
            else:
                r = mgr.append("t", D[nblocks:nblocks + slide], C[nblocks:nblocks + slide])
                r = r.ok and mgr.contract("t", slide)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            check(bool(r) and getattr(r, "ok", True), f"session timing: {name} failed")
    cyc, ref = statistics.median(walls["cycle"]), statistics.median(walls["refactor"])
    out["sliding"] = dict(cycle_ms=cyc, refactor_ms=ref, refactor_over_cycle=ref / cyc,
                          structural=nblocks / slide, card=smi)
    print(json.dumps({"session_sliding": "append 8 + contract 8 vs open 64", **out["sliding"]}), flush=True)
    # one profiled turn: a sliding cycle and a solve, and a round of solves,
    # updates and downdates on the resident f32 tokens; the trace's kernel
    # records against replays x plan, and the idle share
    V = rdata["V"][8]

    def turn():
        mgr.append("t", D[nblocks:nblocks + slide], C[nblocks:nblocks + slide])
        mgr.contract("t", slide)
        mgr.solve("t", sdata["B"][0])
        # a miss reseeds each token (the chain evicted them), an update, a
        # downdate back and a hit
        for op in ("posv_cached", "chol_update", "chol_downdate", "posv_cached"):
            for t in ("tok0", "tok1"):
                At = res["A"][t].float()
                eng.submit(op, At if op == "posv_cached" else V, rdata["B"][t] if op == "posv_cached" else None,
                           factor_token=t)
            eng.drain()

    out["profile"] = traced_turn(hopper, [eng, seng], turn, "residency turn")
    print(json.dumps({"residency_profile": "session cycle + solve, residency round", "card": smi,
                      **out["profile"]}), flush=True)
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"residency_seconds": out["seconds"]}), flush=True)
    return out


# ---- the serve front end (phase 7d) ---------------------------------------------

#: phase 7b's ladders under the front end's closed loop
FRONT_CFG = dict(buckets=(32, 64, 128), rows_buckets=(128, 256, 512), nrhs_buckets=(1, 8, 64),
                 max_batch=8, max_delay_s=0.005)
#: the single-engine A/B's workload (requests and clients scale with the
#: replica count in compare_replicas)
FRONT_WORKLOAD = dict(requests=256, concurrency=16, ops=("posv", "lstsq"), ns=(32, 64, 128),
                      nrhs=(1, 8, 64))
#: the kernels the front end's in-process runs launch: the dense buckets,
#: the CLI smoke's chains, the router's guaranteed share
FRONT_KERNELS = ("small.posv", "small.lstsq", "bt.fused_forward", "bt.solve_backward", "small.potrf",
                 "small.potrs")
@contextmanager
def spawn_light_main():
    """Spawned children (process replicas, loadgen clients) import the
    parent's main module unless its name ends in `.__main__`; this script
    imports torch at its top, so while a phase spawns, the serve CLI's
    module (standard library only at import) stands in as the main module
    and the children import nothing of this script."""
    from capital_tpu_torch.serve import __main__ as light

    saved = sys.modules["__main__"]
    sys.modules["__main__"] = light
    try:
        yield
    finally:
        sys.modules["__main__"] = saved


def host_profile(eng, reqs, concurrency: int) -> dict:
    """One closed-loop run through `eng` under cProfile: host time a
    request by the engine's stage, each from the profile's
    cumulative (`ct`), inline (`tt`) and caller-edge times so that no stage
    holds another: submit less the flushes its admissions make; the pump's
    own code and its readiness probes; every flush less the landings it
    forces; every landing less its wait on the batch's event; the client's
    sleeps; the rest of the wall is the client's own loop.  cProfile's own
    overhead inflates every Python stage: `wall_s` beside
    `unprofiled_wall_s` of the same run says by how much."""
    import cProfile
    import pstats

    from capital_tpu_torch.serve import loadgen
    from capital_tpu_torch.serve.engine import SolveEngine
    from capital_tpu_torch.serve.executor import Executor
    from capital_tpu_torch.serve.scheduler import Scheduler

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loadgen.run_closed_loop(eng, reqs, concurrency)
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    t0 = time.perf_counter()
    res = loadgen.run_closed_loop(eng, reqs, concurrency)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.disable()
    st = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)

    def key(fn):
        code = fn.__code__
        return code.co_filename, code.co_firstlineno, code.co_name

    def tt(fn) -> float:
        return st.get(key(fn), (0, 0, 0.0, 0.0, {}))[2]

    def ct(fn) -> float:
        return st.get(key(fn), (0, 0, 0.0, 0.0, {}))[3]

    def edge(callee, caller) -> float:  # callee's cumulative time under this caller
        entry = st.get(key(callee))
        return entry[4].get(key(caller), (0, 0, 0.0, 0.0))[3] if entry else 0.0

    sleeps = sum(v[3] for k, v in st.items() if k[0] == "~" and "time.sleep" in k[2])
    wait = edge(torch.cuda.Event.synchronize, Executor.land)
    stages = {
        "submit/bucketing/padding": ct(SolveEngine.submit) - edge(Scheduler.flush, Scheduler.admit),
        "scheduler pump": tt(SolveEngine.pump) + tt(Scheduler.pump) + tt(Scheduler.reap) + ct(Executor.ready),
        "dispatch/replay": ct(Scheduler.flush) - edge(Scheduler.land, Scheduler.flush),
        "landing/crop/stats": ct(Executor.land) - wait,
        "device wait (landing)": wait,
        "client sleeps": sleeps,
    }
    stages["closed-loop client"] = wall - sum(stages.values())
    n = res["requests"]
    top = sorted(((v[2], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})") for k, v in st.items()), reverse=True)
    return dict(requests=n, wall_s=wall, unprofiled_wall_s=plain,
                us_per_request={k: v / n * 1e6 for k, v in stages.items()},
                share={k: v / wall for k, v in stages.items()},
                top_inline_us_per_request={name: t / n * 1e6 for t, name in top[:15]})


def cli_turn(hopper, argv: list, label: str) -> dict:
    """One in-process run of the serve CLI (`python -m
    capital_tpu_torch.serve ...`) under the profiler: its exit code, the
    trace's kernel records, and the launches the served requests made.
    Every bucket program of these runs is captured at warm-up (phase 7b
    holds each of these ops' programs to capture): one eager call, then
    the capture — the counters move twice, the card runs the plan once — so
    the requests' launches are the records less half the counters' move."""
    from capital_tpu_torch.serve import __main__ as cli

    state = {}

    def run():
        hopper.reset_counts()
        state["rc"] = cli.main(argv)
        state["counts"] = hopper.counts()

    prof = profile(run, "SV::")
    check(state["rc"] == 0, f"{label}: `python -m capital_tpu_torch.serve {' '.join(argv)}` exited {state['rc']}")
    got, counts = engine_trace_counts(prof["launches"]), state["counts"]
    check(all(counts.get(k, 0) % 2 == 0 for k in got),
          f"{label}: odd launch counts {counts}: a bucket program ran eagerly")
    served = {k: got[k] - counts.get(k, 0) // 2 for k in got}
    check(all(v >= 0 for v in served.values()), f"{label}: trace {got} < warm-up launches {counts}")
    return dict(counts={k: v for k, v in counts.items() if v}, trace=got,
                served={k: v for k, v in served.items() if v}, wall_ms=prof["wall_ms"],
                device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"])


#: the reference Makefile's serve-bench occupancy gate: phase 7d's A/B
#: (18 buckets of capacity 8, 16 clients) flushes most batches at the
#: deadline below it, so its failure is reported, never loosened
OCCUPANCY_FAIL = re.compile(r"^serve-report gate FAIL: record #\d+: batch occupancy [0-9.]+ < 0\.25 ")


def obs_gates(root: str, smi: str) -> dict:
    """Phase 7d's ledgers through the port's obs CLI (`python -m
    capital_tpu_torch.obs`, in process) under the reference Makefile's own
    gates: serve-smoke's on the CLI smoke, serve-bench's and serve-trace's
    on the A/B, serve-replicas' on both router ledgers; the Chrome-trace
    export of the smoke and the A/B (one complete chain a traced request,
    every span of it in the export), the robustness self-check and the
    A/B's diff against itself.  Every exit code goes through `check`; the
    one admitted failure is serve-bench's occupancy gate, at its own
    number (`OCCUPANCY_FAIL`), which the run reports."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    from capital_tpu_torch.obs import __main__ as obs
    from capital_tpu_torch.obs import ledger, spans

    res = {}

    def run(label: str, argv: list) -> tuple[int, list]:
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = obs.main(argv)
        lines = out.getvalue().splitlines() + err.getvalue().splitlines()
        res[label] = dict(argv=[a.replace(root + "/", "") for a in argv], rc=rc, report=lines)
        print(json.dumps({"obs": label, **res[label], "card": smi}), flush=True)
        return rc, err.getvalue().splitlines()

    smoke, ab = f"{root}/smoke.jsonl", f"{root}/ab.jsonl"
    rc, _ = run("serve-smoke", ["serve-report", smoke, "--min-hit-rate", "1.0",
                                "--max-p99-ms-small", "30000", "--max-queue-wait-ms", "30000"])
    check(rc == 0, f"obs: serve-report on the CLI smoke's ledger exited {rc}")
    rc, err = run("serve-bench", ["serve-report", ab, "--min-hit-rate", "1.0", "--min-occupancy", "0.25",
                                  "--max-queue-wait-ms", "60000"])
    check(rc == 0 or (rc == 1 and err and all(OCCUPANCY_FAIL.match(line) for line in err)),
          f"obs: serve-report on the A/B ledger exited {rc}: {err}")
    res["serve-bench"]["occupancy_gate"] = "fail" if rc else "pass"
    rc, _ = run("serve-trace", ["serve-report", ab, "--min-trace-complete", "1.0", "--min-windows", "3"])
    check(rc == 0, f"obs: serve-report's trace and window gates on the A/B ledger exited {rc}")
    for name in ("replicas_cli", "replicas"):
        rc, _ = run(f"serve-replicas {name}", ["serve-report", f"{root}/{name}.jsonl", "--aggregate",
                                               "--min-replicas", "2", "--min-hit-rate", "1.0"])
        check(rc == 0, f"obs: serve-report --aggregate on {name}.jsonl exited {rc}")
    for name, path in (("smoke", smoke), ("ab", ab)):
        chrome = f"{root}/{name}_chrome.json"
        rc, _ = run(f"timeline {name}", ["timeline", path, "--chrome", chrome])
        check(rc == 0, f"obs: timeline of {name}.jsonl exited {rc}")
        traces = [t for r in ledger.read(path) if r.get("serve_trace") for t in r["serve_trace"]["traces"]]
        with open(chrome) as f:
            events = [(e["name"], e["tid"]) for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        bad = [p for t in traces for p in spans.trace_dict_problems(t)]
        check(traces and not bad and events == [(sp["name"], t["request_id"]) for t in traces
                                                for sp in t["spans"]],
              f"obs: {name}'s Chrome export: {len(traces)} traces, {len(events)} spans, {bad[:3]}")
        res[f"timeline {name}"].update(traces=len(traces), spans=len(events))
    rc, _ = run("robust-gate", ["robust-gate"])
    check(rc == 0, f"obs: robust-gate exited {rc}")
    rc, _ = run("diff ab", ["diff", ab, ab])
    check(rc == 0, f"obs: diff of the A/B ledger against itself exited {rc}")
    return res


def frontend_phase(hopper, dev, smi: str) -> dict:
    """Phase 7d: the serve front end on the card (module docstring): the
    CLI smoke cold and warm on one persist_dir, the single-engine A/B
    through `loadgen.compare`, a profiled continuous run, the host profile,
    the router A/B with process replicas and process clients, and the
    `replicas` CLI with a kill and a drain on a warm persist_dir."""
    import tempfile
    from collections import Counter

    from capital_tpu_torch.obs import ledger, spans
    from capital_tpu_torch.serve import ServeConfig, loadgen

    out = {"card": smi, "seconds": {}}
    t_phase = time.perf_counter()
    tol32 = 5e-5  # bench/drivers.py:_tolerance; lstsq 10x
    # this slice's main path: the counters set to 0 here and read after
    # each in-process run (the process replicas count in their own
    # processes), summed in `launched`
    hopper.reset_counts()
    launched = Counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_7d_")
    root = tmp.name

    # ---- (a) the CLI smoke, cold then warm on one persist_dir ------------------
    t0 = time.perf_counter()
    smoke_dir, smoke_led = f"{root}/smoke_cache", f"{root}/smoke.jsonl"
    argv = ["smoke", "--trace", "--persist-dir", smoke_dir, "--ledger", smoke_led, "--device", dev.type]
    from capital_tpu_torch.serve import __main__ as cli

    check(cli.main(argv) == 0, "front end: the cold CLI smoke failed")
    launched.update(hopper.counts())
    out["smoke_warm"] = cli_turn(hopper, argv + ["--max-compiles", "0"], "front end warm smoke")
    launched.update(out["smoke_warm"]["counts"])
    recs = [r["request_stats"] for r in ledger.read(smoke_led) if r["kind"] == "serve:request_stats"]
    check(len(recs) == 2, f"front end: {len(recs)} smoke records, want 2")
    cold, warm = recs[0]["cache"], recs[1]["cache"]
    check(cold["compiles"] == cold["disk"]["misses"] > 0 and cold["disk"]["hits"] == 0,
          f"front end: cold smoke cache {cold}")
    check(warm["compiles"] == 0 and warm["misses"] == 0 and warm["disk"]["hits"] == cold["compiles"]
          and not warm["disk"]["errors"], f"front end: warm smoke cache {warm} (cold {cold})")
    out["smoke"] = dict(cold=cold, warm=warm, requests=recs[1]["requests"], ops=recs[1]["ops"],
                        seconds=time.perf_counter() - t0)
    print(json.dumps({"frontend_smoke": "cold + warm", "card": smi, **out["smoke"],
                      "warm_turn": out["smoke_warm"]}), flush=True)

    # ---- (b) the single-engine A/B: sync against continuous ---------------------
    t0 = time.perf_counter()
    cfg = ServeConfig(**FRONT_CFG)
    wl = loadgen.Workload(**FRONT_WORKLOAD)
    reqs = loadgen.build_requests(wl)
    ab_led, engines = f"{root}/ab.jsonl", {}
    hopper.reset_counts()
    res = loadgen.compare(cfg, wl, device=dev.type, ledger_path=ab_led, window_s=0.05, trace=True,
                          engines=engines)
    recs = ledger.read(ab_led)
    for mode, (eng, tickets) in engines.items():
        r = res[mode]
        check(r["requests"] == r["ok"] == len(reqs) and not r["failed"], f"front end {mode}: {r}")
        check(r["cache"]["misses"] == 0, f"front end {mode}: built after warm-up: {r['cache']}")
        worst: dict = {}
        for (op, A, B), t in zip(reqs, tickets):
            x = t.result()
            check(x.ok, f"front end {mode}: request {x.request_id} ({op}) failed: {x.error}")
            At, Bt = torch.as_tensor(A, device=dev), torch.as_tensor(B, device=dev)
            resid = engine_residual(op, At, Bt, x.x)
            gate = 10 * tol32 if op == "lstsq" else tol32
            check(resid < gate, f"front end {mode}: request {x.request_id} ({op} {A.shape}) residual {resid}")
            worst[op] = max(worst.get(op, 0.0), resid)
        st = r["trace_record"]["serve_trace"]
        bad = [p for t in st["traces"] for p in spans.trace_dict_problems(t)]
        check(st["requests"] == st["complete"] == len(reqs) and not st["dropped"] and not bad,
              f"front end {mode}: {st['complete']} of {st['requests']} chains complete: {bad[:3]}")
        wins = [rec["serve_window"] for rec in recs
                if rec["kind"] == "serve:window" and rec["loadgen"]["mode"] == mode]
        wbad = [p for w in wins for p in ledger.validate_serve_window(w)]
        check(wins and not wbad and sum(w["requests"] for w in wins) == len(reqs),
              f"front end {mode}: windows {len(wins)}: {wbad[:3]}")
        rs = r["record"]["request_stats"]
        out[f"ab_{mode}"] = dict(qps=r["qps"], wall_s=r["wall_s"], windows=len(wins),
                                 latency_ms=rs["latency_ms"], queue_wait_ms=rs["queue_wait_ms"],
                                 device_ms=rs["device_ms"], occupancy=rs["batch_occupancy_mean"],
                                 batches=rs["batches"], programs=len(eng.cache.programs()),
                                 worst_residual=worst)
        print(json.dumps({"frontend_ab": mode, "card": smi, **out[f"ab_{mode}"]}), flush=True)
    out["ab_speedup"] = res["speedup"]
    # one continuous run profiled: the replays ran their plans, the idle share
    eng = engines["continuous"][0]
    launched.update(hopper.counts())  # the two engines' warm-ups: eager call + capture
    progs = eng.cache.programs()
    check(progs and all(p.captured for p in progs.values()), "front end: a bucket program was not captured")
    for prog in progs.values():
        plan, routes = engine_plan(prog.bucket, eng.cfg)
        check(prog.capture_counts == plan and prog.capture_routes == routes,
              f"front end {prog.bucket}: capture launched {prog.capture_counts}, plan {plan}")
    out["ab_profile"] = traced_turn(hopper, [eng], lambda: loadgen.run_closed_loop(eng, reqs, wl.concurrency),
                                    "front end continuous run")
    print(json.dumps({"frontend_ab_speedup": res["speedup"], "card": smi,
                      "profile": out["ab_profile"]}), flush=True)
    # ---- (d) the host profile of one continuous run ------------------------------
    out["host_profile"] = host_profile(eng, reqs, wl.concurrency)
    print(json.dumps({"frontend_host_profile": "continuous closed loop", "card": smi,
                      **out["host_profile"]}), flush=True)
    out["seconds"]["ab"] = time.perf_counter() - t0
    del engines, eng

    # ---- (c) the router: process replicas, process clients -----------------------
    t0 = time.perf_counter()
    rcfg = ServeConfig(persist_dir=f"{root}/router_cache", **FRONT_CFG)
    with spawn_light_main():
        rres = loadgen.compare_replicas(rcfg, wl, replica_counts=(1, 2), replica_mode="process",
                                        client_mode="process", device=dev.type,
                                        ledger_path=f"{root}/replicas.jsonl")
    for n in (1, 2):
        r = rres[n]
        agg = r["records"][-1]["request_stats"]
        check(r["requests"] == r["ok"] == wl.requests * n and not r["failed"],
              f"front end router x{n}: {r['requests']} landed, {r['failed']} failed")
        c = r["counters"]
        check(c["completed"] == c["dispatched"] == wl.requests * n and not c["parked"],
              f"front end router x{n}: dropped requests: {c}")
        check(agg["cache"]["misses"] == 0, f"front end router x{n}: built after warm-up: {agg['cache']}")
        check(all(v is not None for v in r["warmup_fresh"].values()),
              f"front end router x{n}: a replica did not warm up: {r['warmup_fresh']}")
        out[f"router_x{n}"] = dict(qps=r["qps"], wall_s=r["wall_s"], clients=r["clients"],
                                   warmup_fresh=r["warmup_fresh"], latency_ms=agg["latency_ms"],
                                   queue_wait_ms=agg.get("queue_wait_ms"), device_ms=agg.get("device_ms"),
                                   per_replica=c["per_replica"], disk=agg["cache"].get("disk"))
        print(json.dumps({"frontend_router": n, "card": smi, **out[f"router_x{n}"]}), flush=True)
    out["scaling_efficiency"] = rres["scaling_efficiency"]
    out["router_speedup"] = rres["speedup"]
    print(json.dumps({"frontend_scaling": {"efficiency": rres["scaling_efficiency"],
                                           "speedup": rres["speedup"],
                                           "qps": {n: rres[n]["qps"] for n in (1, 2)}}, "card": smi}),
          flush=True)
    out["seconds"]["router"] = time.perf_counter() - t0

    # the replicas CLI: a cold thread-replica run warms the manifest (and,
    # profiled, counts the guaranteed share's kernels), then two process
    # replicas on the warm directory take a kill and a drain
    t0 = time.perf_counter()
    rep_dir = f"{root}/replicas_cache"
    base = ["replicas", "--persist-dir", rep_dir, "--guaranteed-share", "0.25", "--requests", "96",
            "--device", dev.type]
    out["replicas_cold"] = cli_turn(hopper, base + ["--replica-mode", "thread"], "front end replicas (thread)")
    launched.update(out["replicas_cold"]["counts"])
    led = f"{root}/replicas_cli.jsonl"
    with spawn_light_main():
        rc = cli.main(base + ["--replica-mode", "process", "--kill-one", "--drain-one", "--max-compiles", "0",
                              "--ledger", led])
    check(rc == 0, "front end: the replicas CLI (process, kill, drain) failed")
    recs = ledger.read(led)
    agg = recs[-1]
    check(agg["router"]["failed_replicas"] == 1 and agg["router"]["completed"] == 96
          and not agg["router"]["parked"], f"front end replicas: {agg['router']}")
    check(agg["request_stats"]["cache"]["misses"] == 0 and agg["request_stats"]["cache"]["compiles"] == 0,
          f"front end replicas: {agg['request_stats']['cache']}")
    per = {r["request_stats"]["replica_id"]: r["request_stats"] for r in recs[:-1]}
    check("r2" in per and per["r2"]["cache"]["compiles"] == 0 and per["r2"]["cache"]["misses"] == 0
          and per["r2"]["requests"] > 0, f"front end replicas: the replacement {per.get('r2')}")
    ref = agg["request_stats"].get("refine", {})
    check(ref.get("requests", 0) > 0 and ref["converged"] == ref["requests"],
          f"front end replicas: the guaranteed share {ref}")
    out["replicas_warm"] = dict(router=agg["router"], cache=agg["request_stats"]["cache"], refine=ref,
                                replacement=per["r2"]["cache"], latency_ms=agg["request_stats"]["latency_ms"])
    print(json.dumps({"frontend_replicas": "cold thread + warm process, kill + drain", "card": smi,
                      "cold": out["replicas_cold"], **out["replicas_warm"]}), flush=True)
    out["seconds"]["replicas"] = time.perf_counter() - t0

    # every kernel of the path launched (counted) and ran for the served
    # requests (trace records)
    out["counts"] = dict(launched)
    served = {k: out["smoke_warm"]["served"].get(k, 0) + out["replicas_cold"]["served"].get(k, 0)
              + out["ab_profile"]["kernels"].get(k, 0) for k in FRONT_KERNELS}
    out["served"] = served
    missing = [k for k in FRONT_KERNELS if not launched.get(k) or not served[k]]
    check(not missing, f"front end: kernels never launched on the front end's path: {missing}")
    # ---- (e) the ledgers through the port's obs gates ----------------------------
    t0 = time.perf_counter()
    out["obs"] = obs_gates(root, smi)
    out["seconds"]["obs"] = time.perf_counter() - t0
    tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"frontend_seconds": out["seconds"]}), flush=True)
    return out


# ---- the triangular-inversion slice (phases 8-12) --------------------------


def tri_operand(n: int, dtype, seed: int, device) -> torch.Tensor:
    """The rectri/trsm bench operand (capital_tpu/bench/drivers.py
    `_tri_operand`): tril(G, −1)/√n + 3I with G Gaussian, made on the card
    from a seed in row blocks (κ ≈ 2 at every n)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, n), dtype=dtype, device=device)
    c = torch.arange(n, device=device)[None, :]
    for r0 in range(0, n, 4096):
        r = torch.arange(r0, min(n, r0 + 4096), device=device)[:, None]
        G = torch.randn((r.shape[0], n), generator=gen, device=device)
        out[r0:r0 + r.shape[0]] = (torch.where(c < r, G / math.sqrt(n), 0.0) + 3.0 * (c == r)).to(dtype)
        del G
    return out


def write_diag_case(hopper, count, s, dt_w, dt_out, gen, dev) -> dict:
    """write_diag_blocks of a (count, s, s) stack into a NaN-filled
    (count·s)² buffer: the launch on `write_diag_route`'s route ('vec'
    where s is a multiple of the 16-byte vector, else 'elem'), the whole
    buffer bit for bit the plain version's (NaN outside the blocks), and
    the 'elem' route through the C entry (uncounted) bit for bit the same;
    timed by wall and device time beside `copy_` into the blocks view."""
    from capital_tpu_torch.ops import _build

    p = count * s
    W = torch.randn((count, s, s), generator=gen, device=dev).to(dt_w)
    out = torch.full((p, p), float("nan"), dtype=dt_out, device=dev)
    route = hopper.write_diag_route(out, W)
    label = f"write_diag_blocks {count}x{s}² {dt_w} into {dt_out}"
    check(route == ("elem" if s % (16 // W.element_size()) else "vec"), f"{label}: route {route}")
    hopper.reset_counts()
    hopper.write_diag_blocks(out, W)
    check(hopper.route_counts() == {"write_diag_blocks": {route: 1}}, f"{label}: {hopper.route_counts()}")
    want = hopper.write_diag_blocks_plain(torch.full_like(out, float("nan")), W)
    torch.cuda.synchronize()
    check(same_bits(out, want), f"{label}: not bit for bit the plain version")
    nan = int(torch.isnan(out).sum())
    check(nan == p * p - count * s * s, f"{label}: {p * p - count * s * s - nan} elements outside the "
          "blocks were written")
    del want
    blocks = out.as_strided((count, s, s), (s * p + s, p, 1))
    kept = blocks.clone()
    blocks.fill_(float("nan"))
    entry = _build.entry("capital_write_diag")
    args = (hopper._DTYPE_CODE[dt_w], hopper._DTYPE_CODE[dt_out], W.data_ptr(), out.data_ptr(), p, count, s,
            hopper.WRITE_DIAG_ROUTES["elem"])

    def elem():
        check(entry(*args, hopper._stream()) == 0, f"{label}: the 'elem' launch failed")

    elem()
    torch.cuda.synchronize()
    check(same_bits(blocks, kept), f"{label}: the 'elem' route's bits differ")
    check(hopper.counts()["write_diag_blocks"] == 1, f"{label}: a direct C entry call was counted")
    del kept
    run, lib = (lambda: hopper.write_diag_blocks(out, W)), (lambda: blocks.copy_(W))
    res = dict(
        route=route, max_abs_err=0.0,
        ms=time_ms(run, 20), device_ms=device_ms(run, 20),
        plain_ms=time_ms(lambda: hopper.write_diag_blocks_plain(out, W), 5),
        library_ms=time_ms(lib, 20), library_device_ms=device_ms(lib, 20),
        shape=f"{count} x {s}x{s} {dt_w} into {p}x{p} {dt_out}",
        bound=bound_ms(float(count * s * s * (W.element_size() + out.element_size())), 0.0, dt_out),
    )
    if route != "elem":  # the replaced kernel, on the same operands
        res.update(elem_ms=time_ms(elem, 20), elem_device_ms=device_ms(elem, 20))
    del out, blocks, W
    torch.cuda.empty_cache()
    return res


def inv_kernel_phase(hopper, batched_small, tsqr, dev) -> dict:
    """The four kernels of the triangular-inversion slice against their
    plain versions at the shapes their paths give them."""
    res = {}
    gen = torch.Generator(device=dev).manual_seed(31)

    # write_diag_blocks: the rectri flagship's write-back (96 x 512² bf16
    # into a NaN-filled 49152² buffer), the f32 cell's, a cast and an
    # 'elem' size, each on its route and bit for bit the plain version; the
    # kernels line reads the first (the flagship's)
    for i, (count, s, dt_w, dt_out) in enumerate(WRITE_DIAG_CASES):
        key = "write_diag_blocks" + (f" {count}x{s} {dt_w} into {dt_out}" if i else "")
        res[key] = write_diag_case(hopper, count, s, dt_w, dt_out, gen, dev)

    # fused_tail: each window of INV_SHAPES["tail"] inside a larger operand
    # (its lower half NaN: never read) into NaN-filled Rp / RIp, healthy and
    # with faults; every launch on its route, nothing outside the window
    # written, the healthy window bit for bit the kernel's column-sweep path
    for n, off, dest, P in INV_SHAPES["tail"]:
        route = hopper.tail_route(n)
        for dtype in (torch.bfloat16, torch.float32):
            A = spd_hash(P, torch.float32, salt=5, device=dev)
            A[off:off + n, off:off + n] = torch.triu(A[off:off + n, off:off + n]) + torch.tril(
                torch.full((n, n), float("nan"), device=dev), -1)
            A = A.to(dtype)
            err = 0.0
            for fault, want_info in ((None, 0), ((5, 5, -1.0), 6), ((0, 7, float("nan")), 1),
                                     ((3, 9, float("inf")), 2)):
                buf = A.clone()
                if fault is not None:
                    buf[off + fault[0], off + fault[1]] = fault[2]
                outs = []
                for fn in (hopper.fused_tail, hopper.fused_tail_plain):
                    Rp = torch.full((P, P), float("nan"), dtype=dtype, device=dev)
                    RIp = torch.full((P, P), float("nan"), dtype=dtype, device=dev)
                    hopper.reset_counts()
                    outs.append(fn(buf, Rp, RIp, off=off, n=n, dest=dest))
                    if fn is hopper.fused_tail:
                        got = hopper.route_counts().get("fused_tail")
                        check(got == {route: 1}, f"fused_tail {n} {dtype}: launches by route {got}, want {route}")
                torch.cuda.synchronize()
                (Rk, RIk, ik), (Rq, RIq, iq) = outs
                check(int(ik) == int(iq) == want_info,
                      f"fused_tail {n} {dtype} fault {fault}: info {int(ik)}, plain {int(iq)}, want {want_info}")
                for X in (Rk, RIk):
                    outside = torch.isnan(X).sum() - (torch.isnan(X[dest:dest + n, dest:dest + n])).sum()
                    check(int(outside) == P * P - n * n, f"fused_tail {n} {dtype}: wrote outside its window")
                if fault is None:
                    w = (slice(dest, dest + n), slice(dest, dest + n))
                    err = max(check_close(f"fused_tail {n} R", Rk[w], Rq[w], dtype),
                              check_close(f"fused_tail {n} R^-1", RIk[w], RIq[w], dtype))
                    Rs = torch.zeros((P, P), dtype=dtype, device=dev)
                    RIs = torch.zeros((P, P), dtype=dtype, device=dev)
                    _, _, i_s = hopper.fused_tail(buf, Rs, RIs, off=off, n=n, dest=dest, _sweep=True)
                    check(int(i_s) == 0 and torch.equal(Rk[w], Rs[w]) and torch.equal(RIk[w], RIs[w]),
                          f"fused_tail {n} {dtype}: the blocked path differs from the column sweeps")
                    del Rs, RIs
            Rp = torch.zeros((P, P), dtype=dtype, device=dev)
            RIp = torch.zeros((P, P), dtype=dtype, device=dev)
            item = torch.tensor([], dtype=dtype).element_size()
            run = (lambda: hopper.fused_tail(A, Rp, RIp, off=off, n=n, dest=dest))
            res[f"fused_tail {n} {dtype}"] = dict(
                max_abs_err=err, route=route,
                blocks=hopper.TAIL_CLUSTER_BLOCKS.get(n, 1),
                ms=time_ms(run, 50 if n <= 128 else 20),
                device_ms=device_ms(run, 20),
                plain_ms=time_budget_ms(lambda: hopper.fused_tail_plain(A, Rp, RIp, off=off, n=n, dest=dest),
                                        most=5),
                library_ms=None,  # no single PyTorch call factors and inverts
                shape=f"window {n} {dtype}",
                # bytes: the upper half of the window read, triu(R) and triu(R⁻¹)
                # written as whole windows, info; useful work: potrf n³/3 and
                # the triangular inverse n³/3, f32
                bound=bound_ms((n * (n + 1) / 2.0 + 2.0 * n * n) * item + 4, 2.0 * n**3 / 3.0,
                               torch.float32),
            )
            del A, buf, Rp, RIp, outs
    # the main path's window: phase 11's bc=128 depth-2 factor fuses 512s
    res["fused_tail"] = res[f"fused_tail 512 {torch.bfloat16}"]

    # batched trsm: the serve latency shape and the throughput shape, f32,
    # every uplo x trans; timed at the throughput shape, uplo 'U'
    for size in ("latency", "throughput"):
        b, _, n, k = SMALL_SHAPES[size]["square"]
        T = torch.randn((b, n, n), generator=gen, device=dev) / math.sqrt(n) + 3.0 * torch.eye(n, device=dev)
        B = torch.randn((b, n, k), generator=gen, device=dev)
        err = 0.0
        for uplo in ("U", "L"):
            for trans in (False, True):
                Xk = batched_small.trsm(T, B, uplo=uplo, trans=trans)
                Xp = batched_small.trsm_plain(T, B, uplo=uplo, trans=trans)
                err = max(err, small_close("small.trsm", Xk, Xp, torch.float32))
        Tu = torch.triu(T)
        it = 3 if size == "throughput" else 20
        res[f"small.trsm {size}"] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: batched_small.trsm(T, B), it),
            device_ms=device_ms(lambda: batched_small.trsm(T, B), it),
            plain_ms=time_budget_ms(lambda: batched_small.trsm_plain(T, B)),
            library_ms=time_budget_ms(lambda: torch.linalg.solve_triangular(Tu, B, upper=True)),
            library_device_ms=device_ms(lambda: torch.linalg.solve_triangular(Tu, B, upper=True), it),
            shape=f"batch {b} n {n} k {k} float32",
            # bytes: T's live triangle and B read, X written
            bound=bound_ms(b * (n * (n + 1) / 2.0 + 2.0 * n * k) * 4, b * float(n * n * k),
                           torch.float32),
        )
        del T, B, Tu, Xk, Xp
    res["small.trsm"] = res["small.trsm throughput"]

    # TSQR panel QR: the QR flagship's 8192 leaf panels of 256 x 128 f32
    batch, pr, n = INV_SHAPES["panel"]
    Pn = torch.randn((batch, pr, n), generator=gen, device=dev)
    Qk, Rk = tsqr.panel_qr(Pn)
    Qq, Rq = tsqr.panel_qr_plain(Pn)
    err = max(check_close("panel_qr Q", Qk, Qq, torch.float32), check_close("panel_qr R", Rk, Rq, torch.float32))
    check(bool((torch.tril(Rk, -1) == 0).all()), "panel_qr: R not upper triangular")
    del Qk, Rk, Qq, Rq
    res["tsqr.panel_qr"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tsqr.panel_qr(Pn), 3),
        plain_ms=time_budget_ms(lambda: tsqr.panel_qr_plain(Pn), most=2),
        library_ms=time_budget_ms(lambda: torch.linalg.qr(Pn), most=2),
        shape=f"{batch} panels {pr}x{n} float32",
        bound=bound_ms(batch * (2.0 * pr * n + n * n) * 4, batch * (4.0 * pr * n * n - 4.0 * n**3 / 3),
                       torch.float32),
    )
    del Pn
    torch.cuda.empty_cache()
    return res


def drive_counted(hopper, run, want: dict, label: str, route=None, extra_routes=None, sweep_route=None):
    """One call of `run` with the counters set to 0 just before and read
    just after, held to `want` (every kernel not named there: 0) and, where
    `route` (a route or a dtype, as `check_routes` takes) is given, every
    routed launch to its route (`extra_routes`: the tallies of kernels
    outside ROUTED, such as fused_tail's); the rank-k sweep's launches all
    on `sweep_route` (`update_small.sweep_route` of the call)."""
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = hopper.counts()
    full = {**dict.fromkeys(counts, 0), **want}
    check(counts == full, f"{label}: launch counts {counts} != predicted {full}")
    if route is not None:
        check_routes(hopper, counts, route, label, extra_routes)
    # every chain this script drives has blocks of at most 128: every scan
    # step's blocked route (blocktri_small.chain_route)
    chain = {k: {"blocked": counts[k]} for k in CHAIN_ROUTED if counts[k]}
    got = {k: v for k, v in hopper.route_counts().items() if k in CHAIN_ROUTED}
    check(got == chain, f"{label}: chain launches by route {got} != {chain}")
    sweep = {sweep_route: counts["up.sweep"]} if counts["up.sweep"] else {}
    got = hopper.route_counts().get("up.sweep", {})
    check(got == sweep, f"{label}: up.sweep launches by route {got} != {sweep}")
    return out, counts, secs


def timed_s(run, iters: int) -> float:
    """Seconds per call by CUDA events around `iters` calls (each call's
    result freed before the next)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def turns_s(runs: dict, rounds: int, iters: int = 2) -> dict:
    """Seconds per call of each of `runs` timed in turns (`timed_s`): every
    run once a round, the order reversed every other round; each run's
    readings and their median (the host's gaps move a launch-bound factor
    from one reading to the next)."""
    names = list(runs)
    t = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            t[k].append(timed_s(runs[k], iters))
    return {k: dict(median=statistics.median(v), runs=v) for k, v in t.items()}


def rectri_phase(hopper, grid, dev) -> dict:
    """Phase 9: the rectri path at the bench flagship and at n=8192 f32."""
    from capital_tpu_torch.models import inverse
    from capital_tpu_torch.utils import residual

    out = {}
    n, bc = INV_SHAPES["rectri"]
    nb = n // bc
    # 96 blocks is not a power of two: the prefix is base-only (t = bc)
    want = {"zeros_dead_lower": 1, "write_diag_blocks": 1, "tri_matmul.trmm": 2 * (nb - 1)}
    L = tri_operand(n, torch.bfloat16, 0, dev)
    cfg = inverse.RectriConfig(base_case_dim=bc, mode="pallas", precision=None)
    # its one write-back on the 'vec' route (hopper.write_diag_route)
    vec = {"write_diag_blocks": {"vec": 1}}
    Li, counts, secs = drive_counted(hopper, lambda: inverse.rectri(grid, L, "L", cfg), want,
                                     "rectri flagship", "wgmma", extra_routes=vec)
    gate = float(residual.inverse_residual_blocked(L, Li))
    check(gate < 5e-2, f"rectri flagship: inverse residual {gate} >= 5e-2")
    del Li
    torch.cuda.empty_cache()
    t = timed_s(lambda: inverse.rectri(grid, L, "L", cfg), 2)
    out["flagship"] = dict(n=n, bc=bc, dtype="bfloat16", seconds=t, tflops=n**3 / 3.0 / t / 1e12,
                           inverse_residual=gate, seconds_first=secs, counts=counts)
    print(json.dumps({"rectri": "flagship", **out["flagship"]}), flush=True)
    out["profile"] = profile(lambda: inverse.rectri(grid, L, "L", cfg), "RT::")
    print(json.dumps({"profile": "rectri flagship", **out["profile"]}), flush=True)
    del L
    torch.cuda.empty_cache()

    # n=8192 f32: kernels against the plain versions through the whole path
    n, bc = INV_SHAPES["rectri_f32"]
    want = {"zeros_dead_lower": 1, "write_diag_blocks": 1, "tri_matmul.trmm": 2 * (n // bc - 1)}
    L = tri_operand(n, torch.float32, 1, dev)
    cfg = inverse.RectriConfig(base_case_dim=bc, mode="pallas", precision="highest")
    Li, counts, secs = drive_counted(hopper, lambda: inverse.rectri(grid, L, "L", cfg), want, "rectri f32",
                                     torch.float32, extra_routes=vec)
    with plain_versions(hopper):
        Lq = inverse.rectri(grid, L, "L", cfg)
    d = float(residual.rel_fro(Li - Lq, Lq))
    gate = float(residual.inverse_residual(L, Li))
    # f32: the kernel and torch.matmul sum in other orders; 1e-5
    check(d < 1e-5 and gate < 5e-5, f"rectri f32: vs plain {d}, inverse residual {gate}")
    U = L.T.contiguous()
    Ui, ucounts, _ = drive_counted(hopper, lambda: inverse.rectri(grid, U, "U", cfg), want, "rectri U",
                                   torch.float32, extra_routes=vec)
    ugate = float(residual.inverse_residual(U, Ui))
    check(ugate < 5e-5 and float(torch.tril(Ui, -1).abs().max()) == 0.0, f"rectri U: residual {ugate}")
    out["f32"] = dict(n=n, bc=bc, counts=counts, seconds_first=secs, vs_plain=d, inverse_residual=gate,
                      upper_inverse_residual=ugate)
    print(json.dumps({"rectri": "n=8192 f32", **out["f32"]}), flush=True)
    del L, Li, Lq, U, Ui
    torch.cuda.empty_cache()
    return out


def trsm_newton_phase(hopper, grid, dev) -> dict:
    """Phase 10: trsm.solve and inverse.newton (no kernel of the port)."""
    from capital_tpu_torch.models import inverse, trsm
    from capital_tpu_torch.utils import residual

    out = {}
    n, nrhs, bc, gate_rhs = INV_SHAPES["trsm"]
    L = tri_operand(n, torch.bfloat16, 0, dev)
    B = torch.randn((n, nrhs), generator=torch.Generator(device=dev).manual_seed(1), device=dev,
                    dtype=torch.bfloat16)
    # mode 'xla': bench/drivers.py resolves 'auto' so for the invert leaf
    cfg = trsm.TrsmConfig(base_case_dim=bc, mode="xla", precision=None, leaf="invert")
    X, counts, secs = drive_counted(hopper, lambda: trsm.solve(grid, L, B, "L", "L", cfg=cfg), {},
                                    "trsm")
    del X
    t = timed_s(lambda: trsm.solve(grid, L, B, "L", "L", cfg=cfg), 3)
    gates = {}
    Bv = B[:, :gate_rhs]
    tf = L.float()
    for side, uplo, unit in (("L", "L", False), ("L", "U", False), ("R", "L", False),
                             ("R", "U", False), ("L", "L", True)):
        # the gates of bench/drivers.py: op = tril(L) / triu(Lᵀ), or the raw
        # operand under unit_diag against tril(L, −1) + I
        if unit:
            Tf = torch.tril(tf, -1) + torch.eye(n, device=dev)
            op = L
        else:
            Tf = torch.tril(tf) if uplo == "L" else torch.triu(tf.T)
            op = Tf.to(torch.bfloat16)
        b = Bv if side == "L" else Bv.T.contiguous()
        Xs = trsm.solve(grid, op, b, side, uplo, cfg=cfg, unit_diag=unit)
        got = Tf @ Xs.float() if side == "L" else Xs.float() @ Tf
        err = float(residual.rel_fro(got - b.float(), b.float()))
        name = f"trsm_residual_{'unit_diag' if unit else side + uplo}"
        check(err < 5e-2, f"{name}: {err} >= 5e-2")
        gates[name] = err
        del Tf, op, b, Xs, got
    out["trsm"] = dict(n=n, nrhs=nrhs, bc=bc, dtype="bfloat16", seconds=t, tflops=n * n * nrhs / t / 1e12,
                       seconds_first=secs, counts=counts, **gates)
    print(json.dumps({"trsm": "n=32768 nrhs=8192 bf16", **out["trsm"]}), flush=True)
    del L, B, Bv, tf
    torch.cuda.empty_cache()

    n = INV_SHAPES["newton"]
    A = spd_hash(n, torch.float32, salt=2, device=dev)
    ncfg = inverse.NewtonConfig(max_iter=30, mode="xla", precision="highest")  # bench/drivers.py --newton-iters
    (X, iters), counts, secs = drive_counted(hopper, lambda: inverse.newton(grid, A, ncfg), {}, "newton")
    gate = float(residual.inverse_residual(A, X))
    check(gate < 5e-4, f"newton: inverse residual {gate} >= 5e-4")
    out["newton"] = dict(n=n, dtype="float32", iters_executed=iters, seconds=secs,
                         tflops=2.0 * n**3 * (2 * iters + 1) / secs / 1e12, inverse_residual=gate,
                         counts=counts)
    print(json.dumps({"newton": "n=8192 f32", **out["newton"]}), flush=True)
    del A, X
    torch.cuda.empty_cache()
    return out


def tail_phase(hopper, grid, dev) -> dict:
    """Phase 11: cholinv with the fused tail at n=16384 bf16 — bc=128 at
    depth 2 (32 windows of 512 on the cluster route) and bc=64 at depth 1
    (128 windows of 128 on the block route) — beside the unfused factor at
    bc=128 and at bc=256 and 512 (512 is `pick_bc`'s base case for this n),
    timed in turns (medians of TAIL_TURNS rounds) and each profiled once."""
    import dataclasses

    from capital_tpu_torch.models import cholesky
    from capital_tpu_torch.robust.config import RobustConfig
    from capital_tpu_torch.utils import residual

    n, bc = INV_SHAPES["tail_factor"]
    cfg0 = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, precision=None)
    A = spd_hash(n, torch.bfloat16, salt=1, device=dev)
    (R0, Ri0), _, secs0 = drive_counted(
        hopper, lambda: cholesky.factor(grid, A, cfg0),
        {**predicted_counts(n // bc), "zeros_dead_lower": 2}, "unfused factor", torch.bfloat16)
    cfgs = {"unfused": cfg0}
    for b in (256, 512):
        cfgs[f"unfused_bc{b}"] = dataclasses.replace(cfg0, base_case_dim=b)
        drive_counted(hopper, lambda: cholesky.factor(grid, A, cfgs[f"unfused_bc{b}"]),
                      {**predicted_counts(n // b), "zeros_dead_lower": 2}, f"unfused factor bc={b}",
                      torch.bfloat16)
    out = dict(n=n, dtype="bfloat16", seconds_first_unfused=secs0, bc_unfused=bc)
    for label, b, depth in (("d2", bc, 2), ("bc64_d1", 64, 1)):
        cfg = cfgs[label] = dataclasses.replace(cfg0, base_case_dim=b, tail_fuse_depth=depth)
        win = b << depth
        windows = n // win
        route = hopper.tail_route(win)
        # every window of b << depth fuses on its route; nothing above it
        want = {"fused_tail": windows, "tri_matmul.trmm": 3 * (windows - 1),
                "tri_matmul.syrk": windows - 1, "zeros_dead_lower": 2}
        (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(grid, A, cfg), want,
                                              f"fused-tail factor {label}", torch.bfloat16,
                                              extra_routes={"fused_tail": {route: windows}})
        dR = float(residual.rel_fro(R.float() - R0.float(), R0.float()))
        dRi = float(residual.rel_fro(Ri.float() - Ri0.float(), Ri0.float()))
        check(dR < 2e-2 and dRi < 2e-2, f"fused tail {label} vs unfused: {dR}, {dRi}")
        Af = A.float()
        res_r = float(residual.cholesky_residual(Af, R.float()))
        res_i = float(residual.cholesky_inverse_residual(R.float(), Ri.float()))
        del Af, R, Ri
        check(res_r < 1e-2 and res_i < 1e-2, f"fused tail {label} residuals {res_r}, {res_i}")
        out[label] = dict(bc=b, tail_fuse_depth=depth, window=win, route=route, counts=counts,
                          seconds_first=secs, vs_unfused=[dR, dRi], residual=res_r,
                          inverse_residual=res_i)
    del R0, Ri0
    out["counts"] = out["d2"]["counts"]
    t = turns_s({k: (lambda c=c: cholesky.factor(grid, A, c)) for k, c in cfgs.items()}, TAIL_TURNS)
    out["turns"] = t
    out["seconds_unfused"] = t["unfused"]["median"]
    for label in ("d2", "bc64_d1"):
        out[label]["seconds"] = t[label]["median"]
    for b in (256, 512):
        out[f"seconds_unfused_bc{b}"] = t[f"unfused_bc{b}"]["median"]
    # wall, device busy time and idle share of one call of each: whether a
    # factor is held by its kernels or by the host between them
    out["profiles"] = {k: {f: v for f, v in profile(lambda c=c: cholesky.factor(grid, A, c), "CI::").items()
                           if f in ("wall_ms", "device_busy_ms", "idle_share", "top_kernels_device_ms")}
                       for k, c in cfgs.items()}
    # a bad pivot at the first column of leaf 37: the fused window's sweep
    # (the cluster route's fault path) and the unfused leaf's library factor
    # both report it there
    j = (37 % (n // bc)) * bc
    Ab = A.clone()
    Ab[j, j] = -1.0
    infos = []
    for c in (dataclasses.replace(cfg0, tail_fuse_depth=2), cfg0):
        _, _, info = cholesky.factor(grid, Ab, dataclasses.replace(c, robust=RobustConfig()))
        infos.append(int(info))
    check(infos[0] == infos[1] == j + 1, f"fused tail robust info {infos[0]}, unfused {infos[1]}, want {j + 1}")
    out["robust_info"] = infos
    print(json.dumps({"factor": "fused tail n=16384 bf16", **out}), flush=True)
    del A, Ab
    torch.cuda.empty_cache()
    return out


def tsqr_phase(hopper, dev) -> dict:
    """Phase 12: tsqr(impl='auto') at 2,097,152 x 128 f32."""
    from capital_tpu_torch.ops import tsqr
    from capital_tpu_torch.utils import residual

    m, n = INV_SHAPES["tsqr"]  # the QR flagship's rows; 128 is the widest 'auto' sends to the kernel
    leaves = tsqr.resolve_leaves(m, n)
    A = tall_randn(m, n, torch.float32, 6, dev)
    (Q, R), counts, secs = drive_counted(
        hopper, lambda: tsqr.tsqr(A, impl="auto"),
        {"tsqr.panel_qr": leaves.bit_length()}, "tsqr")  # leaves, then log2(leaves) levels
    ortho = float(tsqr.ortho_gate(Q))
    res = float(residual.qr_residual_blocked(A, Q, R))
    check(ortho < 5e-5 and res < 5e-5, f"tsqr: orthogonality {ortho}, residual {res} (tol 5e-5)")
    del Q
    t0 = time.perf_counter()
    Qx, Rx = tsqr.tsqr(A, impl="xla")
    torch.cuda.synchronize()
    secs_xla = time.perf_counter() - t0
    del Qx
    sgn = torch.sign(torch.diagonal(R)) * torch.sign(torch.diagonal(Rx))
    dR = float(residual.rel_fro(R - sgn[:, None] * Rx, Rx))
    check(dR < 1e-5, f"tsqr: R against the library route's {dR}")
    del R, Rx
    t = timed_s(lambda: tsqr.tsqr(A, impl="auto"), 3)
    t_xla = timed_s(lambda: tsqr.tsqr(A, impl="xla"), 1)
    for _ in range(3):  # a trace may drop a launch: up to three tries for one that holds all
        prof = profile(lambda: tsqr.tsqr(A, impl="auto"), "QR::", sequence=True)
        seq = prof.pop("sequence")
        if sum("panel_qr_kernel" in name for name, _ in seq) == leaves.bit_length():
            break
    levels = tsqr_levels(seq, leaves.bit_length())
    out = dict(m=m, n=n, leaves=leaves, panel=tsqr.resolve_panel(m, n), counts=counts, seconds_first=secs,
               seconds=t, seconds_xla=t_xla, seconds_first_xla=secs_xla, orthogonality=ortho, residual=res,
               r_vs_xla=dR, profile=prof, levels=levels)
    print(json.dumps({"tsqr": "2097152x128 f32", **out}), flush=True)
    del A
    torch.cuda.empty_cache()
    return out


def tsqr_levels(seq: list, want: int) -> list:
    """The TSQR profile by tree level: level 0 the leaf panels, level i > 0
    the i-th reduction panels; each level's panel launch, then the kernels
    up to the next panel launch (its Q-factor stack and the Q accumulators'
    torch.matmul), summed, with the largest of them named.  The launch
    count is checked on the counted run; a trace can drop a launch (its
    first milliseconds), so the levels are aligned from the root, and a
    level whose panel launch the trace does not hold says so."""
    starts = [i for i, (name, _) in enumerate(seq) if "panel_qr_kernel" in name][-want:]
    levels = [dict(level=lv, panel_ms=None, note="not in the trace") for lv in range(want - len(starts))]
    for k, i in enumerate(starts):
        rest = seq[i + 1:starts[k + 1]] if k + 1 < len(starts) else seq[i + 1:]
        big = max(rest, key=lambda kv: kv[1]) if rest else ["", 0.0]
        levels.append(dict(level=want - len(starts) + k, panel_ms=seq[i][1], other_ms=sum(ms for _, ms in rest),
                           largest_other=big[0], largest_other_ms=big[1]))
    return levels


# ---- the block-tridiagonal slice (phases 13-14) ----------------------------


def bt_operands(batch, seg, b, k, dtype, seed, dev):
    """One scan step's operands, made on the card from a seed: SPD diagonal
    blocks (gram/b + 3I), couplings at 0.3/√b, a Gaussian RHS, a carried
    factor with a dominant diagonal and a Gaussian carried solution."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((batch, seg, b, b), generator=gen, device=dev)
    D = (G @ G.mT / b + 3.0 * torch.eye(b, device=dev)).to(dtype)
    del G
    C = (0.3 / math.sqrt(b) * torch.randn((batch, seg, b, b), generator=gen, device=dev)).to(dtype)
    B = torch.randn((batch, seg, b, k), generator=gen, device=dev).to(dtype)
    Lc = (torch.tril(0.2 * torch.randn((batch, b, b), generator=gen, device=dev), -1)
          + 2.0 * torch.eye(b, device=dev)).to(dtype)
    yc = torch.randn((batch, b, k), generator=gen, device=dev).to(dtype)
    return D, C, B, Lc, yc


def bt_bytes(name: str, seg: int, b: int, k: int, item: int) -> float:
    """Bytes of one problem of a scan step: the carried factor's live
    triangle read, the full tiles of D, C, B, L, Wt and y moved once each,
    info 4 bytes per block."""
    tri = b * (b + 1) / 2.0
    if name == "bt.fused_forward":
        return (seg * (4.0 * b * b + 2.0 * b * k) + tri + b * k) * item + 4.0 * seg
    if name == "bt.factor":
        return (seg * 4.0 * b * b + tri) * item + 4.0 * seg
    return (seg * (tri + b * b + 2.0 * b * k) + b * k) * item  # the two sweeps


def bt_flops(name: str, seg: int, b: int, k: int) -> float:
    """Useful f32 operations of one problem: per chain block the factor
    recurrence 7b³/3 (Wt = L⁻¹Cᵀ b³, the symmetric Wtᵀ·Wt b³, Cholesky
    b³/3) and a sweep 3b²k (the coupling product 2b²k, the triangular solve
    b²k)."""
    fac, sweep = 7.0 * b**3 / 3.0, 3.0 * b * b * k
    return seg * {"bt.fused_forward": fac + sweep, "bt.factor": fac}.get(name, sweep)


def bt_library_step(blocktri, name, D, C, B, Lc, L, Wt):
    """The library route (models/blocktri's xla loop: batched torch.linalg
    per chain block) over the same `seg` blocks — the library column: no
    single PyTorch call computes a scan step."""
    if name == "bt.fused_forward":
        Lx, Wx, _ = blocktri._xla_factor_scan(D, C, Lc)
        return blocktri._xla_forward_scan(Lx, Wx, B)
    if name == "bt.factor":
        return blocktri._xla_factor_scan(D, C, Lc)
    if name == "bt.forward_solve":
        return blocktri._xla_forward_scan(L, Wt, B)
    return blocktri._xla_backward_scan(L, Wt, B)


def bt_rel(got, want) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm((g - w).flatten()) / torch.linalg.norm(w.flatten()))


def bt_entry(name: str, args, route: str = "sweep", splits: int = 1, kc: int | None = None):
    """A scan step through its C entry on `route` with its right-hand
    sides split `splits` ways and staged kc columns at a time (default:
    `stage_cols` on that route and split), uncounted — the wrapper always
    takes the rules' route and split: the wrapper's outputs from the
    wrapper's arguments ((D, C, B, Lc, yc), (D, C, Lc), or (L, Wt, B, carry)
    for the solve steps).  The solve steps always get a scratch, so a kc
    narrower than a block's columns runs the carry through it."""
    from capital_tpu_torch.ops import _build, blocktri_small, hopper

    kernel = name.removeprefix("bt.")
    code = {"sweep": 0, "blocked": 1}[route]
    D, C = args[0], args[1]
    batch, seg, b, _ = D.shape
    dt = hopper._DTYPE_CODE[D.dtype]
    if name == "bt.factor":
        L, Wt = torch.empty_like(D), torch.empty_like(D)
        info = torch.empty((batch, seg), dtype=torch.int32, device=D.device)
        rc = _build.entry("capital_bt_factor")(dt, D.data_ptr(), C.data_ptr(), args[2].data_ptr(), L.data_ptr(),
                                               Wt.data_ptr(), info.data_ptr(), batch, seg, b, code,
                                               hopper._stream())
        check(rc == 0, f"{name} {route} route: rc {rc}")
        return L, Wt, info
    B = args[2]
    k = B.shape[-1]
    kc = blocktri_small._stage_cols(kernel, b, k, splits, route) if kc is None else kc
    scratch = torch.empty((batch, b, k), dtype=torch.float32, device=D.device)
    out = torch.empty_like(B)
    if name == "bt.fused_forward":
        Lc, yc = args[3:]
        L, Wt = torch.empty_like(D), torch.empty_like(D)
        info = torch.empty((batch, seg), dtype=torch.int32, device=D.device)
        rc = _build.entry("capital_bt_fused_forward")(
            dt, D.data_ptr(), C.data_ptr(), B.data_ptr(), Lc.data_ptr(), yc.data_ptr(), L.data_ptr(),
            Wt.data_ptr(), out.data_ptr(), info.data_ptr(), scratch.data_ptr(), batch, seg, b, k, kc, splits,
            code, hopper._stream())
        check(rc == 0, f"{name} {route} route: rc {rc}")
        return L, Wt, out, info
    rc = _build.entry("capital_bt_" + kernel)(
        dt, D.data_ptr(), C.data_ptr(), B.data_ptr(), args[3].data_ptr(), out.data_ptr(), scratch.data_ptr(),
        batch, seg, b, k, kc, splits, code, hopper._stream())
    check(rc == 0, f"{name} {route} route: rc {rc}")
    return out


def bt_sweep_route(name: str, args):
    """A scan step on its 'sweep' route (route code 0, one CUDA block a
    problem) through the C entry, uncounted (`bt_entry`)."""
    return bt_entry(name, args, "sweep")


def bt_same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(same_bits(x, y) for x, y in zip(got, want))


def bt_kernel_phase(hopper, blocktri_small, blocktri, dev) -> dict:
    """Phase 13: the four scan-step kernels against their plain versions at
    BT_GEOMS, timed beside bound, plain version and the library route; then
    injected faults, whose per-block info must equal the plain version's."""
    res = {}
    for gi, (batch, seg, b, k, dts, timed) in enumerate(BT_GEOMS):
        for dtn in dts:
            dtype = DTYPE_BY_NAME[dtn]
            item = torch.tensor([], dtype=dtype).element_size()
            D, C, B, Lc, yc = bt_operands(batch, seg, b, k, dtype, 60 + gi, dev)
            L, Wt, _, _ = blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)
            steps = {"bt.fused_forward": (blocktri_small.fused_forward_step, (D, C, B, Lc, yc)),
                     "bt.factor": (blocktri_small.factor_step, (D, C, Lc)),
                     "bt.forward_solve": (blocktri_small.forward_solve_step, (L, Wt, B, yc)),
                     "bt.solve_backward": (blocktri_small.solve_backward_step, (L, Wt, B, yc))}
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            for name, (fn, args) in steps.items():
                plain = getattr(blocktri_small, fn.__name__ + "_plain")
                hopper.reset_counts()
                got, want = fn(*args), plain(*args)
                torch.cuda.synchronize()
                kernel = name.removeprefix("bt.")
                check(hopper.route_counts() == {name: {blocktri_small.chain_route(b, kernel): 1}},
                      f"{name} b={b}: launched by route {hopper.route_counts()}")
                check(bt_same(got, bt_sweep_route(name, args)),
                      f"{name} {batch}x{seg}x{b}x{k} {dtn}: the blocked and sweep routes differ")
                if name in ("bt.forward_solve", "bt.solve_backward"):
                    # unsplit, and with the carry through the scratch (a
                    # stage narrower than a block's columns)
                    splits = blocktri_small.rhs_splits(kernel, batch, b, k)
                    check(bt_same(got, bt_entry(name, args, "blocked", 1)),
                          f"{name} {batch}x{seg}x{b}x{k} {dtn}: split {splits} and unsplit launches differ")
                    if k > 1:
                        kc = min(-(-k // splits) - 1, blocktri_small.stage_cols(kernel, b, k, splits))
                        check(bt_same(got, bt_entry(name, args, "blocked", splits, max(1, kc))),
                              f"{name} {batch}x{seg}x{b}x{k} {dtn}: the scratch carry differs")
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = 0.0
                for g, w in zip(got, want):
                    if w.dtype == torch.int32:
                        check(torch.equal(g, w) and not bool(g.any()), f"{name} {dtn}: info {g.tolist()}")
                        continue
                    rel = bt_rel(g, w)
                    check(rel <= tol and bool(torch.isfinite(g).all()),
                          f"{name} {batch}x{seg}x{b}x{k} {dtn}: kernel vs plain {rel} > {tol}")
                    err = max(err, float((g.double() - w.double()).abs().max()))
                row = dict(max_abs_err=err, shape=f"batch {batch} seg {seg} b {b} k {k} {dtn}")
                if timed:
                    row.update(
                        ms=time_ms(lambda: fn(*args), 5), plain_ms=time_budget_ms(lambda: plain(*args), 200, 2),
                        library_ms=time_budget_ms(lambda: bt_library_step(blocktri, name, D, C, B, Lc, L, Wt),
                                                  200, 3),
                        bound=bound_ms(batch * bt_bytes(name, seg, b, k, item), batch * bt_flops(name, seg, b, k),
                                       torch.float32))
                    if name in CHAIN_ROUTED:
                        row["device_ms"] = device_ms(lambda: fn(*args), 5)
                        row["queued_ms"] = queued_ms(lambda: fn(*args), 5)
                res[f"{name} {batch}x{seg}x{b}x{k} {dtn}"] = row
            del D, C, B, Lc, yc, L, Wt
        torch.cuda.empty_cache()

    # faults in problem 3, chain block 2 of 8: per-block info equal to the
    # plain version's, the global pivot (`blocktri._combine`) too, and no
    # other problem flagged; L, Wt, y and info the same bits on both routes
    faults = {}
    for dtn in ("f32", "bf16"):
        D, C, B, _, yc = bt_operands(8, 8, 128, 2, DTYPE_BY_NAME[dtn], 70, dev)
        Lc = torch.eye(128, device=dev, dtype=D.dtype).expand(8, 128, 128).contiguous()
        for fault in ("nan", "-inf", "indefinite"):
            Df, Cf = D.clone(), C.clone()
            if fault == "nan":
                Df[3, 2, 5, 7] = float("nan")
            elif fault == "-inf":
                Df[3, 2, 0, 0] = -float("inf")
            else:
                Df[3, 2] = torch.diag(torch.tensor([1.0] * 40 + [-5.0] + [1.0] * 87, device=dev))
                Cf[3, 2] = 0
            out = blocktri_small.fused_forward_step(Df, Cf, B, Lc, yc)
            swept = bt_sweep_route("bt.fused_forward", (Df, Cf, B, Lc, yc))
            check(all(same_bits(x, y) for x, y in zip(out, swept)),
                  f"fault {fault} {dtn}: the blocked and sweep routes differ")
            ik = out[3]
            ip = blocktri_small.fused_forward_step_plain(Df, Cf, B, Lc, yc)[3]
            gk, gp = blocktri._combine(ik, 8, 128), blocktri._combine(ip, 8, 128)
            check(torch.equal(ik, ip) and torch.equal(gk, gp),
                  f"fault {fault} {dtn}: info {ik[3].tolist()} vs plain {ip[3].tolist()}")
            others = [i for i in range(8) if i != 3]
            check(int(gk[3]) > 2 * 128 and not bool(gk[others].any()), f"fault {fault} {dtn}: pivots {gk.tolist()}")
            faults[f"{fault} {dtn}"] = int(gk[3])
        # the right-hand sides' faults: the fused step with a NaN in B, the
        # solve steps with a NaN / −inf in Y, a zero diagonal of L (safe_div's
        # guarded divisor), a NaN one and a NaN coupling, each in problem 3's
        # chain block 2 — the wrappers (blocked, split) bit for bit the sweep
        # route and the unsplit launch
        Bf = B.clone()
        Bf[3, 2, 5, 0] = float("nan")
        args = (D, C, Bf, Lc, yc)
        check(bt_same(blocktri_small.fused_forward_step(*args), bt_sweep_route("bt.fused_forward", args)),
              f"fault nan_rhs {dtn}: the fused step's blocked and sweep routes differ")
        L, Wt, _, _ = blocktri_small.fused_forward_step(D, C, B, Lc, yc)
        for fault in ("nan_rhs", "-inf_rhs", "zero_diag", "nan_diag", "nan_coupling"):
            Lf, Wf, Yf = L.clone(), Wt.clone(), B.clone()
            if fault == "nan_rhs":
                Yf[3, 2, 5, 0] = float("nan")
            elif fault == "-inf_rhs":
                Yf[3, 2, 0, 1] = -float("inf")
            elif fault == "zero_diag":
                Lf[3, 2, 40, 40] = 0
            elif fault == "nan_diag":
                Lf[3, 2, 7, 7] = float("nan")
            else:
                Wf[3, 2, 9, 4] = float("nan")
            for name, fn in (("bt.forward_solve", blocktri_small.forward_solve_step),
                             ("bt.solve_backward", blocktri_small.solve_backward_step)):
                args = (Lf, Wf, Yf, yc)
                got = fn(*args)
                check(bt_same(got, bt_sweep_route(name, args)) and bt_same(got, bt_entry(name, args, "blocked")),
                      f"fault {fault} {dtn}: {name}'s blocked, unsplit and sweep launches differ")
                nans = torch.isnan(got).flatten(2).any(-1)
                check(not bool(nans[[0, 1, 2, 4, 5, 6, 7]].any()), f"fault {fault} {dtn}: {name} spread past problem 3")
        del D, C, B, Bf, yc, Lc, L, Wt
    res["faults_global_pivot"] = faults
    print(json.dumps({"blocktri faults": faults}), flush=True)
    torch.cuda.empty_cache()
    return res


def chain_operands(batch, nblocks, b, k, seed, dev):
    """The bench drivers' chain (capital_tpu/bench/drivers.py
    `_blocktri_batch`), made on the card from a seed in f32: D_i =
    G·Gᵀ/b + 3I, couplings at 0.3/√b with C[:, 0] = 0, a Gaussian RHS."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((batch, nblocks, b, b), generator=gen, device=dev)
    D = G @ G.mT / b + 3.0 * torch.eye(b, device=dev)
    del G
    C = 0.3 / math.sqrt(b) * torch.randn((batch, nblocks, b, b), generator=gen, device=dev)
    C[:, 0] = 0
    B = torch.randn((batch, nblocks, b, k), generator=gen, device=dev)
    return D, C, B


def chain_matvec(D, C, X):
    """A·X blockwise in f64: D_i·x_i + C_i·x_{i−1} + C_{i+1}ᵀ·x_{i+1}."""
    D, C, X = D.double(), C.double(), X.double()
    Y = D @ X
    Y[:, 1:] += C[:, 1:] @ X[:, :-1]
    Y[:, :-1] += C[:, 1:].mT @ X[:, 1:]
    return Y


def chain_residual(D, C, B, X) -> float:
    """The drivers' solve gate: worst ‖A·X − B‖/‖B‖ over the batch, in f64
    on the card."""
    R = chain_matvec(D, C, X) - B.double()
    return float((R.flatten(1).norm(dim=1) / B.double().flatten(1).norm(dim=1)).max())


def factor_residual(D, C, L, Wt) -> float:
    """The drivers' factor gate: ‖A − L̃·L̃ᵀ‖_F/‖A‖_F blockwise in f64
    (A_ii = L_i·L_iᵀ + W_i·W_iᵀ, A_{i,i−1} = W_i·L_{i−1}ᵀ)."""
    L, W, D, C = L.double(), Wt.double().mT, D.double(), C.double()
    diag = L @ L.mT
    diag[:, 1:] += W[:, 1:] @ W[:, 1:].mT
    off = W[:, 1:] @ L[:, :-1].mT
    num = (diag - D).square().sum() + 2.0 * (off - C[:, 1:]).square().sum()
    den = D.square().sum() + 2.0 * C[:, 1:].square().sum()
    return float((num / den).sqrt())


def bt_posv_plan(blocktri, nblocks: int, algorithm: str) -> dict:
    """Launches of one blocktri.posv on the kernel route: 'scan' runs
    nblocks/seg fused forward steps and as many backward steps;
    'partitioned' runs the P interiors of m − 1 blocks (one batch) and the
    P-block reduced chain, each a fused + backward loop."""
    if algorithm == "xla":
        return {}
    if algorithm == "scan":
        n = nblocks // blocktri.resolve_seg(nblocks)
    else:
        P = blocktri.resolve_partitions(nblocks)
        m = nblocks // P
        n = (m - 1) // blocktri.resolve_seg(m - 1) + P // blocktri.resolve_seg(P)
    return {"bt.fused_forward": n, "bt.solve_backward": n}


def arrowhead_operands(batch, nblocks, b, s, k, seed, dev):
    """The drivers' arrowhead (`_arrowhead_batch`): the chain above, a
    border at 0.3/√(nblocks·b), a corner S0·S0ᵀ/s + 5I, Gaussian RHS."""
    D, C, B = chain_operands(batch, nblocks, b, k, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    F = 0.3 / math.sqrt(nblocks * b) * torch.randn((batch, nblocks, s, b), generator=gen, device=dev)
    S0 = torch.randn((batch, s, s), generator=gen, device=dev)
    S = S0 @ S0.mT / s + 5.0 * torch.eye(s, device=dev)
    Bs = torch.randn((batch, s, k), generator=gen, device=dev)
    return D, C, F, S, B, Bs


def arrowhead_residual(D, C, F, S, B, Bs, X, Xs) -> float:
    """The arrowhead driver's solve gate (drivers.arrowhead), blockwise f64:
    chain rows A_T·x + Fᵀ·x_s − b, corner rows Σ F_i·x_i + S·x_s − b_s."""
    F, S, Bs, Xs = F.double(), S.double(), Bs.double(), Xs.double()
    Rc = chain_matvec(D, C, X) - B.double() + torch.einsum("znsb,zsk->znbk", F, Xs)
    Rs = torch.einsum("znsb,znbk->zsk", F, X.double()) + S @ Xs - Bs
    num = Rc.flatten(1).square().sum(1) + Rs.flatten(1).square().sum(1)
    den = B.double().flatten(1).square().sum(1) + Bs.flatten(1).square().sum(1)
    return float((num / den).sqrt().max())


def bt_serve_requests(op, count, dtype, seed):
    """Ragged chain requests made on the host from a seed: nblocks in {5, 8,
    20, 32}, b in {24, 32, 50, 64}, k in {1, 3, 8}, border s in {4, 8, 20}
    (posv_arrowhead's packed tail operand)."""
    from capital_tpu_torch.models import arrowhead

    gen = torch.Generator().manual_seed(seed)
    pick = lambda xs: xs[int(torch.randint(len(xs), (1,), generator=gen))]  # noqa: E731
    reqs = []
    for _ in range(count):
        nblocks, b, k = pick((5, 8, 20, 32)), pick((24, 32, 50, 64)), pick((1, 3, 8))
        G = torch.randn((nblocks, b, b), generator=gen, dtype=torch.float64)
        D = G @ G.mT / b + 3.0 * torch.eye(b, dtype=torch.float64)
        C = 0.3 / math.sqrt(b) * torch.randn((nblocks, b, b), generator=gen, dtype=torch.float64)
        C[0] = 0
        A = torch.stack([D, C])
        B = torch.randn((nblocks, b, k), generator=gen, dtype=torch.float64)
        if op == "posv_arrowhead":
            s = pick((4, 8, 20))
            F = 0.3 / math.sqrt(nblocks * b) * torch.randn((1, nblocks, s, b), generator=gen,
                                                          dtype=torch.float64)
            S0 = torch.randn((1, s, s), generator=gen, dtype=torch.float64)
            S = S0 @ S0.mT / s + 5.0 * torch.eye(s, dtype=torch.float64)
            Bs = torch.randn((1, s, k), generator=gen, dtype=torch.float64)
            B = arrowhead.pack(F, S, B[None], Bs)[0]
        reqs.append((A.to(dtype), B.to(dtype)))
    return reqs


def bt_serve_residual(op, A, B, X, Xs=None) -> float:
    """One request's residual in f64 on its own (unpadded) operands."""
    from capital_tpu_torch.models import arrowhead

    D, C = A[0][None], A[1][None]
    if op == "posv_blocktri":
        return chain_residual(D, C, B[None], X[None])
    nblocks, b = A.shape[1], A.shape[2]
    F, S, Bc, Bs = arrowhead.unpack(B[None], nblocks, b)
    return arrowhead_residual(D, C, F, S, Bc, Bs, X[None], Xs[None])


def bt_serve_phase(hopper, dev) -> dict:
    """The structured serve path, request to response: ragged posv_blocktri
    and posv_arrowhead requests through bucket_for -> pad_operands ->
    assemble -> api.batched -> crop under impl auto, pallas and vmap, and
    one f64 bucket each (the library route), with the counters set to 0
    just before each call and checked just after; the drivers' residual
    gates, pallas against vmap, exact pads and fills, one poisoned problem."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.serve import api, batching
    from capital_tpu_torch.serve.engine import ServeConfig

    cfg = ServeConfig()  # the default ladders: nblocks 8/32/64, b 32/64/128, s 8/16/32, nrhs 1/8/64
    out = {"calls": 0, "worst_residual": {}, "pallas_vs_vmap": {}}
    for op in ("posv_blocktri", "posv_arrowhead"):
        for dtype in (torch.float32, torch.float64):
            reqs = bt_serve_requests(op, 10 if dtype == torch.float32 else 2, dtype, seed=len(op))
            groups: dict = {}
            for A, B in reqs:
                bk = batching.bucket_for(op, tuple(A.shape), tuple(B.shape), str(dtype).replace("torch.", ""),
                                         cfg)
                check(bk is not None, f"serve {op}: request {tuple(A.shape)} has no bucket")
                groups.setdefault(bk, []).append((A.to(dev), B.to(dev)))
            impls = ("auto", "pallas", "vmap") if dtype == torch.float32 else ("pallas",)
            tol = 5e-5 if dtype == torch.float32 else 1e-13
            worst, agree = 0.0, 0.0
            for bk, members in groups.items():
                chunk = members[:bk.capacity]
                padded = [batching.pad_operands(op, A, B, bk) for A, B in chunk]
                Ab, Bb, _ = batching.assemble([p[0] for p in padded], [p[1] for p in padded], bk, device=dev)
                results = {}
                for impl in impls:
                    algo = "xla" if impl == "vmap" or dtype != torch.float32 else (
                        blocktri.posv_algorithm(bk.a_shape[1], dtype) if impl == "auto" else "scan")
                    want = bt_posv_plan(blocktri, bk.a_shape[1], algo)
                    got, _, _ = drive_counted(hopper, lambda: api.batched(op, "highest", impl)(Ab, Bb), want,
                                              f"serve {op} {impl} {bk.a_shape}")
                    out["calls"] += 1
                    X, info = got[0], got[-1]
                    check(not bool(info.any()), f"serve {op} {impl}: info {info.tolist()}")
                    for i, (A, B) in enumerate(chunk):
                        xi = batching.crop(op, X[i], tuple(A.shape), tuple(B.shape))
                        Xs = None
                        if op == "posv_arrowhead":
                            s = B.shape[0] - A.shape[1] * A.shape[2]
                            Xs = got[1][i][:s, :xi.shape[-1]]
                            tail_s = got[1][i].clone()
                            tail_s[:s, :xi.shape[-1]] = 0
                            check(not bool(tail_s.any()), f"serve {op} {impl}: padded corner rows not zero")
                        r = bt_serve_residual(op, A, B, xi, Xs)
                        check(r < tol, f"serve {op} {impl} {dtype}: residual {r} >= {tol}")
                        worst = max(worst, r)
                        tail = X[i].clone()
                        tail[:xi.shape[0], :xi.shape[1], :xi.shape[2]] = 0
                        check(not bool(tail.any()), f"serve {op} {impl}: padded chain rows not zero")
                    for part in got[:-1]:
                        check(not bool(part[len(chunk):].any()), f"serve {op} {impl}: fill slots not zero")
                    results[impl] = X
                if "vmap" in results:
                    for impl in ("auto", "pallas"):
                        d = bt_rel(results[impl], results["vmap"])
                        check(d < 1e-4, f"serve {op} {impl}: against vmap {d}")
                        agree = max(agree, d)
            out["worst_residual"][f"{op} {dtype}"] = worst
            out["pallas_vs_vmap"][f"{op} {dtype}"] = agree

    # containment: a NaN in problem 1 of a full posv_blocktri bucket
    reqs = bt_serve_requests("posv_blocktri", 8, torch.float32, seed=99)
    bk = batching.bucket_for("posv_blocktri", (2, 32, 64, 64), (32, 64, 8), "float32", cfg)
    padded = [batching.pad_operands("posv_blocktri", A.to(dev), B.to(dev), bk) for A, B in reqs]
    Ab, Bb, _ = batching.assemble([p[0] for p in padded], [p[1] for p in padded], bk, device=dev)
    plan = bt_posv_plan(blocktri, bk.a_shape[1], "scan")
    run = api.batched("posv_blocktri", "highest", "pallas")
    (Xc, ic), _, _ = drive_counted(hopper, lambda: run(Ab, Bb), plan, "containment")
    Ap = Ab.clone()
    Ap[1, 0, 3, 10, 10] = float("nan")
    (Xn, inn), _, _ = drive_counted(hopper, lambda: run(Ap, Bb), plan, "containment poisoned")
    others = [i for i in range(8) if i != 1]
    check(int(inn[1]) != 0 and not bool(inn[others].any()) and not bool(ic.any()),
          f"serve containment: info {inn.tolist()}")
    check(all(torch.equal(Xn[i], Xc[i]) for i in others), "serve containment: a neighbour changed")
    out["containment_info"] = inn.tolist()
    return out


def structured_phase(hopper, dev) -> dict:
    """Phase 14: the structured solvers through their entry points at full
    width, every run counted against its plan and gated."""
    from capital_tpu_torch.models import arrowhead, banded, blocktri
    from capital_tpu_torch.ops import blocktri_small

    out = {}
    tol = 5e-5  # bench/drivers.py:_tolerance, f32

    def bt_counts(counts):
        return {k: counts[k] for k in BT_KERNELS if counts[k]}

    # -- the blocktri.posv flagship (Makefile:63): three routes ---------------
    nblocks, b, batch, k = BT_FLAGSHIP
    D, C, B = chain_operands(batch, nblocks, b, k, 5, dev)
    flag, Xs = {}, {}
    for impl, algo in (("pallas", "scan"), ("auto", "partitioned"), ("xla", "xla")):
        (X, info), counts, secs = drive_counted(hopper, lambda: blocktri.posv(D, C, B, impl=impl),
                                                bt_posv_plan(blocktri, nblocks, algo), f"blocktri posv {impl}")
        r = chain_residual(D, C, B, X)
        check(not bool(info.any()) and r < tol, f"blocktri posv {impl}: info {info.tolist()}, residual {r}")
        flag[impl] = dict(seconds=timed_s(lambda: blocktri.posv(D, C, B, impl=impl), 3), seconds_first=secs,
                          residual=r, counts=bt_counts(counts))
        Xs[impl] = X
    with plain_versions(blocktri_small, BT_WRAPPERS):
        Xq, _ = blocktri.posv(D, C, B, impl="pallas")
    flag["pallas_vs_plain"] = bt_rel(Xs["pallas"], Xq)
    flag["auto_vs_xla"] = bt_rel(Xs["auto"], Xs["xla"])
    flag["pallas_vs_xla"] = bt_rel(Xs["pallas"], Xs["xla"])
    check(flag["pallas_vs_plain"] < 1e-5 and flag["auto_vs_xla"] < 1e-4 and flag["pallas_vs_xla"] < 1e-4,
          f"blocktri posv flagship: routes disagree {flag}")
    out["posv_flagship"] = flag
    print(json.dumps({"blocktri": "posv nblocks=64 b=128 f32 batch 1", **flag}), flush=True)
    out["profile"] = profile(lambda: blocktri.posv(D, C, B, impl="pallas"), "BT::")
    print(json.dumps({"profile": "blocktri posv pallas", **out["profile"]}), flush=True)

    # -- factor + solve + extend + contract at the same geometry --------------
    fs = {}
    (L, Wt, info), counts, secs = drive_counted(hopper, lambda: blocktri.factor(D, C, impl="pallas"),
                                                {"bt.factor": 8}, "blocktri factor")
    fs["counts"] = bt_counts(counts)
    fs["factor_residual"] = factor_residual(D, C, L, Wt)
    check(not bool(info.any()) and fs["factor_residual"] < tol, f"factor: residual {fs['factor_residual']}")
    fs["factor_seconds"] = timed_s(lambda: blocktri.factor(D, C, impl="pallas"), 3)
    X, counts, _ = drive_counted(hopper, lambda: blocktri.solve(L, Wt, B, impl="pallas"),
                                 {"bt.forward_solve": 8, "bt.solve_backward": 8}, "blocktri solve")
    fs["solve_counts"] = bt_counts(counts)
    fs["solve_residual"] = chain_residual(D, C, B, X)
    check(fs["solve_residual"] < tol, f"solve: residual {fs['solve_residual']}")
    fs["solve_seconds"] = timed_s(lambda: blocktri.solve(L, Wt, B, impl="pallas"), 3)
    fs["solve_seconds_xla"] = timed_s(lambda: blocktri.solve(L, Wt, B, impl="xla"), 3)
    D2, C2, _ = chain_operands(batch, nblocks, b, k, 6, dev)
    C2[:, 0] = 0.3 / math.sqrt(b) * torch.randn((batch, b, b), generator=torch.Generator(device=dev).manual_seed(7),
                                                device=dev)  # live: couples to the prefix's tail
    (L2, Wt2, info2), _, _ = drive_counted(hopper, lambda: blocktri.extend(D2, C2, L[:, -1], impl="pallas"),
                                           {"bt.factor": 8}, "blocktri extend")
    Lf, Wtf, _ = blocktri.factor(torch.cat([D, D2], 1), torch.cat([C, C2], 1), impl="pallas")
    fs["extend_bitwise"] = bool(torch.equal(torch.cat([L, L2], 1), Lf) and torch.equal(torch.cat([Wt, Wt2], 1), Wtf))
    check(fs["extend_bitwise"] and not bool(info2.any()), "extend: not bitwise the full refactor")
    del Lf, Wtf, L2, Wt2, D2, C2
    Lk, Wtk = blocktri.contract(L, Wt, 16)
    Xk, _, _ = drive_counted(hopper, lambda: blocktri.solve(Lk, Wtk, B[:, 16:], impl="pallas"),
                             {"bt.forward_solve": 6, "bt.solve_backward": 6}, "blocktri contract + solve")
    Dm, Cm = D[:, 16:].clone(), C[:, 16:].clone()
    Dm[:, 0] = L[:, 16] @ L[:, 16].mT  # the marginal window's head
    Cm[:, 0] = 0
    fs["contract_residual"] = chain_residual(Dm, Cm, B[:, 16:], Xk)
    check(fs["contract_residual"] < tol, f"contract: residual {fs['contract_residual']}")
    out["factor_solve"] = fs
    print(json.dumps({"blocktri": "factor/solve/extend/contract", **fs}), flush=True)
    del L, Wt, X, Xk, Dm, Cm, D, C, B, Xs, Xq
    torch.cuda.empty_cache()

    # -- the throughput batch: 128 problems of the flagship geometry ----------
    D, C, B = chain_operands(BT_THROUGHPUT, nblocks, b, k, 8, dev)
    tp = {}
    for impl, algo in (("pallas", "scan"), ("xla", "xla")):
        (X, info), counts, secs = drive_counted(hopper, lambda: blocktri.posv(D, C, B, impl=impl),
                                                bt_posv_plan(blocktri, nblocks, algo), f"throughput posv {impl}")
        r = chain_residual(D, C, B, X)
        check(not bool(info.any()) and r < tol, f"throughput {impl}: residual {r}")
        tp[impl] = dict(seconds=timed_s(lambda: blocktri.posv(D, C, B, impl=impl), 2), residual=r,
                        counts=bt_counts(counts))
        tp[impl + "_X"] = X
    tp["pallas_vs_xla"] = bt_rel(tp.pop("pallas_X"), tp.pop("xla_X"))
    check(tp["pallas_vs_xla"] < 1e-4, f"throughput: pallas vs xla {tp['pallas_vs_xla']}")
    out["throughput"] = dict(batch=BT_THROUGHPUT, **tp)
    print(json.dumps({"blocktri": f"posv throughput batch {BT_THROUGHPUT}", **out["throughput"]}), flush=True)
    del D, C, B, X
    torch.cuda.empty_cache()

    # -- the arrowhead flagship (Makefile:83) ---------------------------------
    s = BT_BORDER
    D, C, F, S, B, Bs = arrowhead_operands(batch, nblocks, b, s, k, 9, dev)
    ah = {}
    for impl, algo in (("pallas", "scan"), ("auto", "partitioned")):
        (X, Xsol, info), counts, secs = drive_counted(hopper, lambda: arrowhead.posv(D, C, F, S, B, Bs, impl=impl),
                                                      bt_posv_plan(blocktri, nblocks, algo), f"arrowhead posv {impl}")
        r = arrowhead_residual(D, C, F, S, B, Bs, X, Xsol)
        check(not bool(info.any()) and r < tol, f"arrowhead {impl}: residual {r}")
        ah[impl] = dict(seconds=timed_s(lambda: arrowhead.posv(D, C, F, S, B, Bs, impl=impl), 3),
                        seconds_first=secs, residual=r, counts=bt_counts(counts))
    (_, _, Ls, info), _, _ = drive_counted(hopper, lambda: arrowhead.schur(D, C, F, S, impl="pallas"),
                                           bt_posv_plan(blocktri, nblocks, "scan"), "arrowhead schur")
    Zb, _ = blocktri.posv(D.double(), C.double(), F.mT.double(), impl="xla")  # f64 reference chain solve
    St = S.double() - torch.einsum("znsb,znbt->zst", F.double(), Zb)
    Lsd = Ls.double()
    ah["factor_residual"] = float(torch.linalg.norm((Lsd @ Lsd.mT - St).flatten()) / torch.linalg.norm(St.flatten()))
    check(not bool(info.any()) and ah["factor_residual"] < tol, f"arrowhead factor gate {ah['factor_residual']}")
    ah["seconds_xla"] = timed_s(lambda: arrowhead.posv(D, C, F, S, B, Bs, impl="xla"), 3)
    out["arrowhead"] = ah
    print(json.dumps({"arrowhead": "nblocks=64 b=128 s=32 f32", **ah}), flush=True)
    del D, C, F, S, B, Bs, X, Xsol, Zb, St
    torch.cuda.empty_cache()

    # -- the Spike flagship (Makefile:100): nblocks 64, b 16, batch 2, nrhs 2 --
    sn, sb, sbatch, sk = BT_SPIKE
    D, C, B = chain_operands(sbatch, sn, sb, sk, 10, dev)
    sp = {}
    for impl, algo in (("partitioned", "partitioned"), ("pallas", "scan"), ("xla", "xla")):
        (X, info), counts, secs = drive_counted(hopper, lambda: blocktri.posv(D, C, B, impl=impl),
                                                bt_posv_plan(blocktri, sn, algo), f"spike posv {impl}")
        r = chain_residual(D, C, B, X)
        check(not bool(info.any()) and r < tol, f"spike {impl}: residual {r}")
        sp[impl] = dict(seconds=timed_s(lambda: blocktri.posv(D, C, B, impl=impl), 5), residual=r,
                        counts=bt_counts(counts))
    depth = (sum(sp["pallas"]["counts"].values()) / sum(sp["partitioned"]["counts"].values()))
    check(depth >= 4, f"spike: launch-depth reduction {depth} < 4")
    sp["launch_depth_reduction"] = depth
    out["spike"] = sp
    print(json.dumps({"blocktri": "spike nblocks=64 b=16 batch 2 nrhs 2", **sp}), flush=True)

    # -- banded.solveh_banded at n = 8192, u = 128 ----------------------------
    n, u = BT_BANDED
    gen = torch.Generator(device=dev).manual_seed(11)
    ab = torch.rand((u + 1, n), generator=gen, device=dev) * 2.0 - 1.0
    ab[0] = 2.0 * u + 2.0 + torch.rand(n, generator=gen, device=dev)  # diagonally dominant: SPD
    for d in range(1, u + 1):
        ab[d, n - d:] = 0
    rhs = torch.randn((n, 2), generator=gen, device=dev)
    plan = bt_posv_plan(blocktri, n // u, blocktri.posv_algorithm(n // u, torch.float32))
    x, counts, secs = drive_counted(hopper, lambda: banded.solveh_banded(ab, rhs, lower=True), plan,
                                    "solveh_banded")
    abd, xd = ab.double(), x.double()
    Ax = abd[0] * xd.T
    for d in range(1, u + 1):
        Ax[:, :n - d] += abd[d, :n - d] * xd.T[:, d:]
        Ax[:, d:] += abd[d, :n - d] * xd.T[:, :n - d]
    r = float(torch.linalg.norm(Ax.T - rhs.double()) / torch.linalg.norm(rhs.double()))
    x64 = banded.solveh_banded(abd, rhs.double(), lower=True)
    dx = bt_rel(x, x64)
    check(r < tol and dx < 1e-4, f"solveh_banded: residual {r}, against f64 {dx}")
    out["banded"] = dict(n=n, u=u, residual=r, vs_f64=dx, seconds_first=secs, counts=bt_counts(counts),
                         seconds=timed_s(lambda: banded.solveh_banded(ab, rhs, lower=True), 3),
                         seconds_f64=timed_s(lambda: banded.solveh_banded(abd, rhs.double(), lower=True), 2))
    print(json.dumps({"banded": "n=8192 u=128 f32", **out["banded"]}), flush=True)
    out["banded_profile"] = profile(lambda: banded.solveh_banded(ab, rhs, lower=True), "BT::")
    print(json.dumps({"profile": "solveh_banded f32", **out["banded_profile"]}), flush=True)
    del ab, abd, rhs, x, x64, Ax, D, C, B
    torch.cuda.empty_cache()

    # -- the flagship and the Spike geometry on the kernel and library routes,
    #    in turns, each with one profiled call's idle share ------------------
    turns = {}
    for label, (nb, bb, bt, kk) in (("b128", BT_FLAGSHIP), ("b16", BT_SPIKE)):
        D, C, B = chain_operands(bt, nb, bb, kk, 12, dev)
        impls = ("pallas", "auto", "xla") if bb == 128 else ("pallas", "partitioned", "xla")
        runs = {impl: (lambda impl=impl: blocktri.posv(D, C, B, impl=impl)) for impl in impls}
        t = turns_s(runs, 5, 3)
        for impl in impls:
            prof = complete_profile(runs[impl], "BT::")
            t[impl].update(idle_share=prof["idle_share"], wall_ms=prof["wall_ms"],
                           device_busy_ms=prof["device_busy_ms"], records_lost=prof["records_lost"],
                           tries=prof["tries"])
        turns[label] = dict(nblocks=nb, b=bb, batch=bt, nrhs=kk, **t)
        del D, C, B
    out["routes_in_turns"] = turns
    print(json.dumps({"blocktri": "flagship routes in turns", **turns}), flush=True)
    torch.cuda.empty_cache()

    # -- the serve ops -----------------------------------------------------------
    out["serve"] = bt_serve_phase(hopper, dev)
    print(json.dumps({"serve": "posv_blocktri/posv_arrowhead", **out["serve"]}), flush=True)
    torch.cuda.empty_cache()
    return out


# ---- the update / refinement slice (phases 15-16) --------------------------


def up_operands(batch, n, k, dtype, down, seed, dev):
    """Upper factors of G·Gᵀ/n + 3I and a rank-k panel, made on the card
    from a seed; a downdate's V is scaled to 0.1/√n so A − VVᵀ stays SPD
    (tests/test_update.py).  Returns (A f64, R, V) with R, V at `dtype`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((batch, n, n), generator=gen, device=dev, dtype=torch.float64)
    A = G @ G.mT / n + 3.0 * torch.eye(n, device=dev, dtype=torch.float64)
    del G
    R = torch.linalg.cholesky(A).mT.contiguous().to(dtype)
    V = (torch.randn((batch, n, k), generator=gen, device=dev, dtype=torch.float64)
         * ((0.1 / math.sqrt(n)) if down else 0.3)).to(dtype)
    return A, R, V


def up_residual(R, V, R1, sign) -> float:
    """max over problems of ‖R′ᵀR′ − (RᵀR ± VVᵀ)‖_F / ‖RᵀR ± VVᵀ‖_F in f64
    (the bench-update gate), from the factor as stored."""
    R, V, R1 = R.double(), V.double(), R1.double()
    A1 = R.mT @ R + sign * (V @ V.mT)
    return float((torch.linalg.norm(R1.mT @ R1 - A1, dim=(1, 2)) / torch.linalg.norm(A1, dim=(1, 2))).max())


def up_refactor(R, V):
    """The library alternative to a rank-k update (bench update's
    baseline): refactor from the resident state, S = RᵀR + VVᵀ, then
    cholesky_ex."""
    return torch.linalg.cholesky_ex(R.mT @ R + V @ V.mT)


def up_entry(update_small, R, V, sign, route):
    """One rank-k sweep through the kernel's C entry on `route`, uncounted
    (the wrapper takes `update_small.sweep_route`): (R', info)."""
    out, info = torch.empty_like(R), torch.empty(R.shape[0], dtype=torch.int32, device=R.device)
    rc = update_small._sweep_launch(R, V, out, info, sign, route, update_small.problems_per_block(R.shape[0]))
    check(rc == 0, f"up.sweep C entry on route {route}: error {rc}")
    return out, info


def up_kernel_phase(update_small, dev) -> dict:
    """Phase 15: the rotation-sweep kernel against its plain version, bit
    for bit (R' and info), at the serve latency bucket's n = 128 over the
    nrhs rungs k = 1, 8, 64 and at the throughput batch (8192 problems,
    k = 8), update and downdate, f32 and bf16; the updates timed (wall and
    device time) beside bound, and at k = 8 beside the plain version (f32)
    and the refactor (f32: cusolver's Cholesky takes no bf16); then the
    fault cases, each poisoning one problem of eight (a block each) and one
    of 1056 (eight a block, beside seven healthy ones).  Each shape runs
    the wrapper (its launch on `sweep_route`'s route, checked) and the other
    route through the C entry (`up_entry`), both held to the plain version;
    the other route is timed too."""
    from capital_tpu_torch.ops import hopper

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for batch, n, k in UP_SHAPES:
            rule = update_small.sweep_route(batch, k)
            other = {"row": "wave", "wave": "row"}[rule] if k >= 2 else None
            for op, sign in (("update", 1.0), ("downdate", -1.0)):
                _, R, V = up_operands(batch, n, k, dtype, sign < 0, 31 + k, dev)
                hopper.reset_counts()
                Rk, ik = update_small.sweep(R, V, sign)
                tally = hopper.route_counts().get("up.sweep")
                check(tally == {rule: 1}, f"up.sweep {batch}x{n}x{k}: launches by route {tally}, rule {rule}")
                Rp, ip = update_small.sweep_plain(R, V, sign)
                torch.cuda.synchronize()
                check(torch.equal(ik, ip) and not bool(ik.any()), f"up.sweep {op} {dtype}: info {ik.tolist()[:8]}")
                check(same_bits(Rk, Rp), f"up.sweep {op} {dtype} {batch}x{n}x{k}: not bit for bit the plain version")
                if other:
                    Ro, io = up_entry(update_small, R, V, sign, other)
                    check(torch.equal(io, ip) and same_bits(Ro, Rp),
                          f"up.sweep {op} {dtype} {batch}x{n}x{k} route {other}: not bit for bit the plain version")
                err = small_close("up.sweep", Rk, Rp, dtype)
                r = up_residual(R, V, Rk, sign)
                gate = 5e-5 if dtype == torch.float32 else 1e-2
                check(r < gate, f"up.sweep {op} {dtype} {batch}x{n}x{k}: residual {r} >= {gate}")
                key = f"{op} {batch}x{n}x{k} {'f32' if dtype == torch.float32 else 'bf16'}"
                it = 10 if batch == 8 else 3
                row = dict(max_abs_err=err, residual=r, route=rule,
                           ms=time_ms(lambda: update_small.sweep(R, V, sign), it),
                           bound=bound_ms(batch * (2.0 * n * n + n * k) * item, batch * 4.5 * k * n * n,
                                          torch.float32))
                if op == "update":
                    row["device_ms"] = device_ms(lambda: update_small.sweep(R, V, sign), it)
                    if other:
                        row[f"{other}_route_ms"] = time_ms(lambda: up_entry(update_small, R, V, sign, other), it)
                # the plain version is launch-bound (~1 ms a column step): time it
                # for the f32 update at the serve bucket and the throughput batch
                if op == "update" and k == 8:
                    row["library_ms"] = None
                    if dtype == torch.float32:
                        row["plain_ms"] = time_budget_ms(lambda: update_small.sweep_plain(R, V, sign), most=3)
                        row["library_ms"] = time_budget_ms(lambda: up_refactor(R, V))
                        row["library_device_ms"] = device_ms(lambda: up_refactor(R, V), it)
                res[key] = row
                del R, V, Rk, Rp
    torch.cuda.empty_cache()

    # faults: one problem of eight, and one of 1056, poisoned, on both
    # routes; info, NaN and inf patterns and every finite bit equal to the
    # plain version's, and only that problem flagged
    faults = {}
    for case, (where, idx, val, sign) in UP_FAULTS.items():
        for batch, p in ((8, 3), (1056, 1050)):
            _, R, V = up_operands(batch, 128, 8, torch.float32, sign < 0, 41, dev)
            if case == "infeasible":
                V[p] *= 40.0
            else:
                (R if where == "R" else V)[(p, *idx)] = val
            Rp, ip = update_small.sweep_plain(R, V, sign)
            for route in ("row", "wave"):
                Rk, ik = up_entry(update_small, R, V, sign, route)
                flagged = torch.nonzero(ik).flatten().tolist()
                check(torch.equal(ik, ip) and same_bits(Rk, Rp) and flagged == [p],
                      f"up.sweep fault {case} batch {batch} route {route}: info {ik[p].tolist()} vs plain "
                      f"{ip[p].tolist()}, flagged {flagged[:8]}")
            if batch == 8:
                fin = torch.isfinite(Rk) & torch.isfinite(Rp)
                faults[case] = dict(info=int(ik[p]), max_abs_err=float((Rk[fin] - Rp[fin]).abs().max()))
    res["faults"] = faults
    return res


def update_refine_phase(hopper, dev) -> dict:
    """Phase 16: the slice's paths through their entry points at full width,
    every run counted against its plan (PERF.md §3) and gated."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.ops import batched_small, lapack, update_small
    from capital_tpu_torch.robust import refine
    from capital_tpu_torch.serve import api, batching
    from capital_tpu_torch.serve.engine import ServeConfig

    out = {}
    tol = 5e-5  # bench/drivers.py:_tolerance, f32

    # -- the bench-update flagship (Makefile:117-121): 'auto' takes the panel scan
    n, k, batch = UP_FLAGSHIP
    A, R, V = up_operands(batch, n, k, torch.float32, True, 11, dev)
    (R1, i1), _, secs = drive_counted(hopper, lambda: update_small.chol_update(R, V), {}, "chol_update n=1024")
    (R2, i2), _, _ = drive_counted(hopper, lambda: update_small.chol_downdate(R1, V), {}, "chol_downdate n=1024")
    ru, rd = up_residual(R, V, R1, 1.0), up_residual(R1, V, R2, -1.0)
    check(not bool(i1.any()) and not bool(i2.any()) and ru < tol and rd < tol,
          f"update flagship: info {i1.tolist()} {i2.tolist()}, residuals {ru}, {rd}")
    t_up = time_ms(lambda: update_small.chol_update(R, V), 5)
    t_ref = time_ms(lambda: up_refactor(R, V), 5)
    out["update_flagship"] = dict(
        n=n, k=k, batch=batch, route=update_small.default_impl(n, k, torch.float32, interpret=False),
        kernels="none (the panel scan is library work)", update_residual=ru, downdate_residual=rd,
        ms_per_problem=t_up / batch, refactor_ms_per_problem=t_ref / batch, refactor_over_update=t_ref / t_up,
        seconds_first=secs)
    print(json.dumps({"update": "flagship n=1024 k=16 batch 2 f32", **out["update_flagship"]}), flush=True)
    del A, R, V, R1, R2

    # -- api.batched chol_update / chol_downdate at the serve bucket (8, 128, 8)
    cfg = ServeConfig(buckets=(32, 64, 128), nrhs_buckets=(1, 8, 64), max_batch=8)
    srv = {}
    for op, sign in (("chol_update", 1.0), ("chol_downdate", -1.0)):
        _, R, V = up_operands(8, 128, 8, torch.float32, sign < 0, 12, dev)
        got = {}
        for impl in ("auto", "pallas", "vmap"):
            want = {"up.sweep": 1} if impl != "vmap" else {}
            (Rx, ix), counts, _ = drive_counted(hopper, lambda: api.batched(op, "highest", impl)(R, V), want,
                                                f"{op} {impl}", sweep_route=update_small.sweep_route(8, 8))
            check(not bool(ix.any()) and up_residual(R, V, Rx, sign) < tol, f"{op} {impl}: info {ix.tolist()}")
            got[impl] = Rx
            if op == "chol_update" and impl == "auto":
                up_launches = counts["up.sweep"]  # the kernels line's count
        d = bt_rel(got["auto"], got["vmap"])
        check(d < 1e-4, f"{op}: sweep vs panel scan {d}")
        R64, V64 = R.double(), V.double()
        drive_counted(hopper, lambda: api.batched(op, "highest", "auto")(R64, V64), {}, f"{op} f64")
        # a ragged request padded to the bucket crops bitwise to the unpadded sweep
        nr, kr = 100, 5
        Rr = R[0, :nr, :nr].contiguous()  # the factor of A's leading block
        Vr = V[0, :nr, :kr].contiguous()
        bk = batching.bucket_for(op, (nr, nr), (nr, kr), "float32", cfg)
        pr, pv = batching.pad_operands(op, Rr, Vr, bk)
        Ab, Vb, _ = batching.assemble([pr], [pv], bk, device=dev)
        Rb, ib = api.batched(op, "highest", "auto")(Ab, Vb)
        R1u, _ = api.batched(op, "highest", "auto")(Rr[None], Vr[None])
        check(torch.equal(batching.crop(op, Rb[0], (nr, nr), (nr, kr)), R1u[0]) and not bool(ib.any()),
              f"{op}: padded bucket does not crop to the unpadded answer")
        lat = []
        f = api.batched(op, "highest", "auto")
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(R, V)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        srv[op] = dict(auto_vs_vmap=d, p50_ms=lat[15], vmap_ms=time_ms(lambda: api.batched(op, "highest", "vmap")(R, V), 10))
    out["serve_update"] = srv
    out["up_launches"] = up_launches
    print(json.dumps({"serve": "chol_update/chol_downdate 8x128x8 f32", **srv}), flush=True)

    # -- the bench-refine flagship (Makefile:142-147): f64 request, cond ~1e5
    batch, n, nrhs = REFINE_FLAGSHIP
    gen = torch.Generator(device=dev).manual_seed(17)
    Q, _ = torch.linalg.qr(torch.randn((batch, n, n), generator=gen, device=dev, dtype=torch.float64))
    eigs = torch.logspace(0.0, -5.0, n, device=dev, dtype=torch.float64)
    A = (Q * eigs) @ Q.mT
    A = 0.5 * (A + A.mT)
    B = torch.randn((batch, n, nrhs), generator=gen, device=dev, dtype=torch.float64)
    del Q
    base = api.batched("posv", "highest", "vmap")
    guar = api.batched("posv", "highest", "vmap", tier="guaranteed")
    (Xb, ib), _, _ = drive_counted(hopper, lambda: base(A, B), {}, "refine flagship f64 base")
    (Xr, it, conv, resid, ir), _, _ = drive_counted(hopper, lambda: guar(A, B), {}, "refine flagship guaranteed")

    def bwerr(X):
        r = A @ X.double() - B
        den = torch.linalg.norm(A, dim=(1, 2)) * torch.linalg.norm(X.double(), dim=(1, 2)) \
            + torch.linalg.norm(B, dim=(1, 2))
        return float((torch.linalg.norm(r, dim=(1, 2)) / den).max())

    eb, er = bwerr(Xb), bwerr(Xr)
    tol64 = refine.tolerance(n, torch.float64)
    # ROADMAP Queue C item 3: each problem's backward error recomputed on the
    # host in NumPy (f64, the host BLAS's summation order) from the X the
    # card returns, beside the loop's own f32 reading and the tolerance
    import numpy as np

    An, Bn, Xn = (t.double().cpu().numpy() for t in (A, B, Xr))
    host = [float(np.linalg.norm(Bn[i] - An[i] @ Xn[i])
                  / (np.linalg.norm(An[i]) * np.linalg.norm(Xn[i]) + np.linalg.norm(Bn[i])))
            for i in range(batch)]
    # the gate is the tier's contract: every problem converged to the f64
    # tolerance 0.5·sqrt(n)·u.  The refined/straight ratio is reported, not
    # gated: a problem freezes at its first sweep under the tolerance, and
    # on this card's f32 factor the second sweep lands on either side of it
    # (3.3e-15 to 4.0e-15 against 3.55e-15), so the ratio is ~1 or ~130 by
    # which side — the reference's loop, exactly (PERF.md §6).
    check(bool(conv.all()) and not bool(ir.any()) and not bool(ib.any()) and er <= tol64,
          f"refine flagship: converged {conv.tolist()}, refined {er} vs f64 {eb}, tolerance {tol64}")
    A32 = A.float()
    t_f64 = time_ms(lambda: lapack.potrf(A, uplo="U", with_info=True), 5)
    t_f32 = time_ms(lambda: lapack.potrf(A32, uplo="U", with_info=True), 5)
    out["refine_flagship"] = dict(
        batch=batch, n=n, nrhs=nrhs, kernels="none (library factor and sweeps)", iters=it.tolist(),
        resid=resid.tolist(), refined_backward_error=er, f64_backward_error=eb, refined_over_f64=er / eb,
        tolerance=tol64, host_backward_error=host, host_within_tolerance=[h <= tol64 for h in host],
        factor_ms_f32=t_f32, factor_ms_f64=t_f64, factor_f64_over_f32=t_f64 / t_f32,
        guaranteed_ms=time_ms(lambda: guar(A, B), 3), f64_posv_ms=time_ms(lambda: base(A, B), 3))
    print(json.dumps({"refine": "flagship batch 4 n=1024 nrhs 4 f64 cond 1e5", **out["refine_flagship"]}),
          flush=True)
    out["refine_profile"] = profile(lambda: guar(A, B), ("IR::", "serve::"))
    print(json.dumps({"profile": "refine flagship guaranteed", **out["refine_profile"]}), flush=True)
    del A, A32, B, Xb, Xr

    # -- guaranteed posv at the serve bucket (8, 128, 8), f32 request
    sweeps = 1 + refine.DEFAULT_MAX_ITERS
    gen = torch.Generator(device=dev).manual_seed(18)
    X = torch.randn((8, 128, 128), generator=gen, device=dev)
    A = X @ X.mT / 128 + 3.0 * torch.eye(128, device=dev)
    B = torch.randn((8, 128, 8), generator=gen, device=dev)
    guar = api.batched("posv", "highest", "auto", tier="guaranteed")
    (Xg, itg, cg, _, ig), _, _ = drive_counted(hopper, lambda: guar(A, B),
                                               {"small.potrf": 1, "small.potrs": sweeps}, "guaranteed posv")
    with plain_versions(batched_small, ("potrf", "potrs")):
        Xq, itq, cq, _, _ = guar(A, B)
    d = bt_rel(Xg, Xq)
    check(Xg.dtype == torch.float32 and d < 1e-6 and torch.equal(itg, itq) and torch.equal(cg, cq)
          and bool(cg.all()) and not bool(ig.any()), f"guaranteed posv: kernel vs plain {d}, iters {itg.tolist()}")
    lat = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        guar(A, B)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    out["guaranteed_posv"] = dict(iters=itg.tolist(), kernel_vs_plain=d, p50_ms=lat[15],
                                  residual=serve_residual("posv", A[0], B[0], Xg[0]))

    # -- the fast tier at the same bucket: the bf16 kernel, answers back in f32
    fast = api.batched("posv", "highest", "auto", tier="fast")
    (Xf, if_), _, _ = drive_counted(hopper, lambda: fast(A, B), {"small.posv": 1}, "fast posv")
    rf = max(serve_residual("posv", A[i], B[i], Xf[i]) for i in range(8))
    check(Xf.dtype == torch.float32 and not bool(if_.any()) and rf < 5e-2, f"fast posv: residual {rf}")
    out["fast_posv"] = dict(residual=rf, ms=time_ms(lambda: fast(A, B), 10))

    # -- guaranteed lstsq (8, 512, 128, 8): library gram, small.* factor and sweeps
    At = torch.randn((8, 512, 128), generator=gen, device=dev)
    Bt = torch.randn((8, 512, 8), generator=gen, device=dev)
    gl = api.batched("lstsq", "highest", "auto", tier="guaranteed")
    (Xl, itl, cl, _, il), _, _ = drive_counted(hopper, lambda: gl(At, Bt),
                                               {"small.potrf": 1, "small.potrs": sweeps}, "guaranteed lstsq")
    rl = max(serve_residual("lstsq", At[i], Bt[i], Xl[i]) for i in range(8))
    check(bool(cl.all()) and not bool(il.any()) and rl < tol, f"guaranteed lstsq: residual {rl}")
    out["guaranteed_lstsq"] = dict(iters=itl.tolist(), residual=rl, ms=time_ms(lambda: gl(At, Bt), 5))
    print(json.dumps({"refine": "serve bucket tiers", **{k: out[k] for k in
                                                           ("guaranteed_posv", "fast_posv", "guaranteed_lstsq")}}),
          flush=True)
    del A, B, At, Bt, X

    # -- guaranteed posv_blocktri: 64 blocks of 128, f32, the scan route
    nblocks, b, batch, k = BT_FLAGSHIP
    D, C, B = chain_operands(batch, nblocks, b, k, 19, dev)
    seg = blocktri.resolve_seg(nblocks)
    kw = dict(factor_dtype=torch.float32, correction_dtype=torch.float64)
    want = {"bt.factor": nblocks // seg, "bt.forward_solve": sweeps * nblocks // seg,
            "bt.solve_backward": sweeps * nblocks // seg}
    (Xc, ic, ri), _, _ = drive_counted(hopper, lambda: refine.posv_blocktri(D, C, B, impl="pallas", **kw), want,
                                       "guaranteed posv_blocktri")
    Xv, _, riv = refine.posv_blocktri(D, C, B, impl="xla", **kw)
    d = bt_rel(Xc, Xv)
    r = chain_residual(D, C, B, Xc)
    check(bool(ri.converged.all()) and not bool(ic.any()) and d < 1e-6 and r < tol,
          f"guaranteed posv_blocktri: converged {ri.converged.tolist()}, pallas vs xla {d}, residual {r}")
    out["guaranteed_blocktri"] = dict(iters=ri.iters.tolist(), xla_iters=riv.iters.tolist(), pallas_vs_xla=d,
                                      residual=r,
                                      seconds=timed_s(lambda: refine.posv_blocktri(D, C, B, impl="pallas", **kw), 2))
    print(json.dumps({"refine": "posv_blocktri 64x128 f32", **out["guaranteed_blocktri"]}), flush=True)
    del D, C, B
    torch.cuda.empty_cache()
    return out


# ---- the mesh slice (phases 17-18) -----------------------------------------

#: phase 17's cases: the per-rank slabs (mb, K, nb) of a 2x2x1 trmm — the
#: n=16384 cholinv flagship's top node (blocks 512³) and a 128-block case
SCHED_SHAPES = {"flagship": (4096, 8192, 4096), "b128": (256, 512, 256)}
#: phase 18's runs: (n, dtype, bc) on 2x2x1, the rectri one, the 2x2x2 one
MESH_RUNS = {"cholinv": (16384, torch.bfloat16, 512), "cholinv_f32": (8192, torch.float32, 256),
             "rectri": (16384, torch.bfloat16, 512), "cholinv_c2": (2048, torch.float32, 256),
             "cholinv_f64": (16384, torch.float64, 512)}


def sched_operands(mb, K, nb, side, dtype, dev, seed):
    """Both ranks' slabs of a d = 2 trmm: the triangular operand masked
    ('L' for side 'a', 'U' for side 'b', as the recursion's trsm and
    completion trmms pass them) and cut into rank rows / columns."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=dev, dtype=torch.float32).to(dtype)
    if side == "a":
        T = torch.tril(rnd(2 * mb, K))
        return [T[r * mb:(r + 1) * mb].contiguous() for r in range(2)], [rnd(K, nb)] * 2
    T = torch.triu(rnd(K, 2 * nb))
    return [rnd(mb, K)] * 2, [T[:, r * nb:(r + 1) * nb].contiguous() for r in range(2)]


def sched_work(sched_row, blocks, mb, K, nb, side, item) -> tuple[float, float]:
    """(bytes, flops) one rank's launch needs: each executed pair's
    2·bm·bn·bk over the dense side's tiles; every listed tile of the
    triangular operand read once, the dense operand's listed k-tiles read
    once, the output written once."""
    to, ko, fi, la = (x.tolist() for x in sched_row)
    bm, bn, bk = blocks
    run, pairs = False, 0
    for f, l in zip(fi, la):
        run = run or f == 1
        pairs += run
        run = run and l != 1
    outer = nb // bn if side == "a" else mb // bm
    flops = 2.0 * bm * bn * bk * pairs * outer
    dense = (bk * nb) if side == "a" else (mb * bk)
    nbytes = (pairs * (bm if side == "a" else bn) * bk + len(set(ko)) * dense + mb * nb) * item
    return nbytes, flops


def sched_kernel_phase(hopper, summa, dev) -> dict:
    """Phase 17: sched_matmul against its plain version (see the module
    docstring).  The padded rank is checked; the full rank is checked and
    timed — it is the one a mesh step waits for."""
    res = {}
    for name, (mb, K, nb) in SCHED_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32, torch.float64):
            item = torch.tensor([], dtype=dtype).element_size()
            for side, uplo in (("a", "L"), ("b", "U")):
                au, bu = (uplo, None) if side == "a" else (None, uplo)
                (TO, KO, FI, LA), _, blocks = summa._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
                As, Bs = sched_operands(mb, K, nb, side, dtype, dev, seed=17)
                rows = [[torch.from_numpy(x[r].copy()).to(dev) for x in (TO, KO, FI, LA)]
                        for r in range(2)]
                check(int(FI[0, -1]) == 0 and int(LA[0, -1]) == 0, f"sched {name}: rank 0 has no pads")
                err = 0.0
                routes = (ROUTE_OF[dtype], ELEM_OF[dtype])
                for r in range(2):
                    kw = dict(tri_side=side, blocks=blocks)
                    want = hopper.sched_matmul_plain(As[r], Bs[r], *rows[r], **kw)
                    for route in routes:
                        hopper.reset_counts()
                        got = hopper.sched_matmul(As[r], Bs[r], *rows[r], _route=route, **kw)
                        check_routes(hopper, hopper.counts(), route, f"sched_matmul {name}")
                        torch.cuda.synchronize()
                        err = max(err, check_close(f"sched_matmul {name} {side} rank {r} {route}", got,
                                                   want, dtype))
                        del got
                    del want
                A, B, row = As[1], Bs[1], rows[1]
                nbytes, flops = sched_work(row, blocks, mb, K, nb, side, item)
                iters = 5 if name == "flagship" else 50
                key = f"{name} {side} {str(dtype).split('.')[-1]}"
                t = {r: [] for r in routes}
                for r in routes + routes[::-1]:  # interleaved: fast, element-load, element-load, fast
                    t[r].append(time_ms(lambda: hopper.sched_matmul(A, B, *row, tri_side=side,
                                                                    blocks=blocks, _route=r), iters))
                extra = {f"{routes[1]}_ms": sum(t[routes[1]]) / 2}
                res[key] = dict(
                    max_abs_err=err, blocks=list(blocks), runs=[int(FI[r].sum()) for r in range(2)],
                    ms=sum(t[routes[0]]) / 2, **extra,
                    plain_ms=time_ms(lambda: hopper.sched_matmul_plain(A, B, *row, tri_side=side,
                                                                       blocks=blocks), 2),
                    library_ms=time_ms(lambda: torch.matmul(A, B), iters),
                    shape=f"{mb}x{K} @ {K}x{nb}",
                    bound=bound_ms(nbytes, flops, dtype),
                )
                del As, Bs, A, B
            torch.cuda.empty_cache()
    return res


def mesh_plan(summa, cholesky, grid, n: int, bc: int, rectri: bool = False) -> int:
    """sched_matmul launches of one cholinv (complete_inv) or rectri on
    `grid`: d² for every trmm of the plan that the sched gate routes (both
    recursions halve a padded bc·2^k window alike)."""
    d2 = grid.dx * grid.dy
    routed = 0

    def walk(node):
        nonlocal routed
        if node.is_base:
            return
        n1, n2 = node.top[0].n, node.top[1].n
        if rectri:  # side R (n2 x n1 @ tri n1), then side L (tri n2 @ n2 x n1)
            shapes = [(n2, n1, n1, None, "L"), (n2, n2, n1, "L", None)]
        else:  # trsm, then the two completion trmms
            shapes = [(n1, n1, n2, "L", None), (n1, n1, n2, "U", None), (n1, n2, n2, None, "U")]
        for M, K, N, au, bu in shapes:
            routed += summa._shard_sched_gate(grid, M, K, N, au, bu, None) is not None
        walk(node.top[0])
        walk(node.top[1])

    walk(cholesky.plan(cholesky.padded_dim(n, bc), cholesky.CholinvConfig(base_case_dim=bc)))
    return d2 * routed


def mesh_phase(hopper, dev) -> dict:
    """Phase 18: the mesh path (see the module docstring)."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.models import cholesky, inverse
    from capital_tpu_torch.parallel import summa
    from capital_tpu_torch.utils import residual

    out = {}
    mesh = Grid.rect(2, 2, 1, devices=[dev] * 4)
    single = Grid.square(device=dev)

    # (a) cholinv at BASELINE's 2x2 width, n=16384 bf16
    n, dtype, bc = MESH_RUNS["cholinv"]
    cfg = cholesky.CholinvConfig(mode="explicit", base_case_dim=bc, precision=None)
    plan = mesh_plan(summa, cholesky, mesh, n, bc)
    A = spd_hash(n, dtype, salt=1, device=dev)
    (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(mesh, A, cfg),
                                          {"sched_matmul": plan}, "mesh cholinv n=16384 bf16", "wgmma")
    Af = A.float()
    res_r = float(residual.cholesky_residual(Af, R.float()))
    res_i = float(residual.cholesky_inverse_residual(R.float(), Ri.float()))
    del Af
    check(res_r < 1e-2 and res_i < 1e-2, f"mesh n=16384 bf16 residuals {res_r}, {res_i}")
    cfg1 = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, precision=None)
    R1, Ri1 = cholesky.factor(single, A, cfg1)
    dR = float(residual.rel_fro(R.float() - R1.float(), R1.float()))
    dRi = float(residual.rel_fro(Ri.float() - Ri1.float(), Ri1.float()))
    check(dR < 2e-2 and dRi < 2e-2, f"mesh n=16384 bf16 vs the single-device factor: {dR}, {dRi}")
    del R, Ri, R1, Ri1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = timed_s(lambda: cholesky.factor(mesh, A, cfg), 2)
    peak = torch.cuda.max_memory_allocated()
    t1 = timed_s(lambda: cholesky.factor(single, A, cfg1), 2)  # the same A on one device
    out["cholinv"] = dict(n=n, bc=bc, dtype="bfloat16", grid="2x2x1", seconds=t,
                          seconds_single_device=t1,
                          tflops=(2 * n**3 / 3) / t / 1e12, peak_bytes=peak, seconds_first=secs,
                          residual=res_r, inverse_residual=res_i, vs_single_device=[dR, dRi],
                          plan=plan, counts=counts)
    print(json.dumps({"mesh": "cholinv n=16384 bf16", **out["cholinv"]}), flush=True)
    out["profile"] = profile(lambda: cholesky.factor(mesh, A, cfg), "CI::")
    print(json.dumps({"profile": "mesh cholinv", **out["profile"]}), flush=True)
    del A
    torch.cuda.empty_cache()

    # (b) n=8192 f32: kernels against the plain versions through the path
    n, dtype, bc = MESH_RUNS["cholinv_f32"]
    cfg = cholesky.CholinvConfig(mode="explicit", base_case_dim=bc, precision="highest")
    plan = mesh_plan(summa, cholesky, mesh, n, bc)
    A = spd_hash(n, dtype, salt=2, device=dev)
    (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(mesh, A, cfg),
                                          {"sched_matmul": plan}, "mesh cholinv n=8192 f32", torch.float32)
    with plain_versions(hopper):
        Rq, Riq = cholesky.factor(mesh, A, cfg)
    d = max(float(residual.rel_fro(R - Rq, Rq)), float(residual.rel_fro(Ri - Riq, Riq)))
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    # f32: the kernel and torch.matmul sum in other orders; gates as phase 3b
    check(d < 1e-5 and res_r < 5e-6 and res_i < 5e-6,
          f"mesh n=8192 f32: vs plain {d}, residuals {res_r}, {res_i}")
    out["cholinv_f32"] = dict(n=n, bc=bc, plan=plan, counts=counts, seconds_first=secs, vs_plain=d,
                              residual=res_r, inverse_residual=res_i)
    print(json.dumps({"mesh": "cholinv n=8192 f32", **out["cholinv_f32"]}), flush=True)
    del A, R, Ri, Rq, Riq
    torch.cuda.empty_cache()

    # (c) rectri n=16384 bf16
    n, dtype, bc = MESH_RUNS["rectri"]
    rcfg = inverse.RectriConfig(base_case_dim=bc, mode="explicit", precision=None)
    plan = mesh_plan(summa, cholesky, mesh, n, bc, rectri=True)
    L = tri_operand(n, dtype, 2, dev)
    Li, counts, secs = drive_counted(hopper, lambda: inverse.rectri(mesh, L, "L", rcfg),
                                     {"sched_matmul": plan}, "mesh rectri n=16384 bf16", "wgmma")
    gate = float(residual.inverse_residual_blocked(L, Li))
    check(gate < 5e-2, f"mesh rectri: inverse residual {gate} >= 5e-2")
    del Li
    t = timed_s(lambda: inverse.rectri(mesh, L, "L", rcfg), 2)
    out["rectri"] = dict(n=n, bc=bc, dtype="bfloat16", grid="2x2x1", seconds=t,
                         tflops=n**3 / 3.0 / t / 1e12, inverse_residual=gate, seconds_first=secs,
                         plan=plan, counts=counts)
    print(json.dumps({"mesh": "rectri n=16384 bf16", **out["rectri"]}), flush=True)
    del L
    torch.cuda.empty_cache()

    # (d) the c > 1 route on 2x2x2: masked-psum panels, no kernel
    n, dtype, bc = MESH_RUNS["cholinv_c2"]
    cube = Grid.square(c=2, devices=[dev] * 8)
    cfg = cholesky.CholinvConfig(mode="explicit", base_case_dim=bc, precision="highest")
    A = spd_hash(n, dtype, salt=3, device=dev)
    (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(cube, A, cfg), {},
                                          "mesh cholinv 2x2x2")
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    check(res_r < 5e-6 and res_i < 5e-6, f"2x2x2 cholinv residuals {res_r}, {res_i}")
    out["cholinv_c2"] = dict(n=n, bc=bc, grid="2x2x2", seconds_first=secs, residual=res_r,
                             inverse_residual=res_i)
    print(json.dumps({"mesh": "cholinv n=2048 f32 2x2x2", **out["cholinv_c2"]}), flush=True)
    del A, R, Ri
    torch.cuda.empty_cache()

    # (e) cholinv n=16384 f64 bc=512: every sched_matmul launch on dmma
    n, dtype, bc = MESH_RUNS["cholinv_f64"]
    cfg = cholesky.CholinvConfig(mode="explicit", base_case_dim=bc, precision=None)
    plan = mesh_plan(summa, cholesky, mesh, n, bc)
    A = spd_hash(n, dtype, salt=1, device=dev)
    (R, Ri), counts, secs = drive_counted(hopper, lambda: cholesky.factor(mesh, A, cfg),
                                          {"sched_matmul": plan}, "mesh cholinv n=16384 f64", dtype)
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    check(res_r <= 1e-13 and res_i <= 1e-13, f"mesh n=16384 f64 residuals {res_r}, {res_i}")
    cfg1 = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, precision=None)
    R1, Ri1 = cholesky.factor(single, A, cfg1)
    dR = float(residual.rel_fro(R - R1, R1))
    dRi = float(residual.rel_fro(Ri - Ri1, Ri1))
    # f64: the mesh's per-rank products and the single device's sum in
    # other orders; 1e-12 relative
    check(dR < 1e-12 and dRi < 1e-12, f"mesh n=16384 f64 vs the single-device factor: {dR}, {dRi}")
    del R, Ri, R1, Ri1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = timed_s(lambda: cholesky.factor(mesh, A, cfg), 2)
    peak = torch.cuda.max_memory_allocated()
    t1 = timed_s(lambda: cholesky.factor(single, A, cfg1), 2)
    out["cholinv_f64"] = dict(n=n, bc=bc, dtype="float64", grid="2x2x1", seconds=t,
                              seconds_single_device=t1, tflops=(2 * n**3 / 3) / t / 1e12,
                              peak_bytes=peak, seconds_first=secs, residual=res_r,
                              inverse_residual=res_i, vs_single_device=[dR, dRi], plan=plan,
                              counts=counts)
    print(json.dumps({"mesh": "cholinv n=16384 f64", **out["cholinv_f64"]}), flush=True)
    del A
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from capital_tpu_torch import Grid
    from capital_tpu_torch.models import cholesky
    from capital_tpu_torch.ops import _build, hopper
    from capital_tpu_torch.utils import residual

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 is IEEE f32 throughout
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    build_s = _build.build()
    print(json.dumps({"env": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "build_s": round(build_s, 2)}), flush=True)
    for src, log in sorted(_build.build_logs().items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {src}: {line.strip()}")
    dev = torch.device("cuda")
    out = {"env": smi, "build_s": build_s, "kernels": {}, "factor": {}}

    # ---- phase 2: kernels against their plain versions -------------------
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        res = kernel_phase(hopper, dtype, dev)
        for name, r in res.items():
            if "bound" in r:
                b, by = r.pop("bound")
                r.update(bound_ms=b, bound_by=by)
                print(json.dumps({"kernel": name, "dtype": str(dtype), **r}), flush=True)
        out["kernels"][str(dtype)] = res

    grid = Grid.square()

    # ---- phase 3a: n=16384 bf16, kernels against plain versions ----------
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, 16384, torch.bfloat16, 512, None)
    with plain_versions(hopper):
        Rq, Riq = cholesky.factor(grid, A, cfg)
    torch.cuda.synchronize()
    dR = float(residual.rel_fro(R.float() - Rq.float(), Rq.float()))
    dRi = float(residual.rel_fro(Ri.float() - Riq.float(), Riq.float()))
    del Rq, Riq
    # bf16 tolerance: R is rounded to bf16 at every level; 2e-2 relative
    check(dR < 2e-2 and dRi < 2e-2, f"n=16384 bf16 kernels vs plain: {dR}, {dRi}")
    Af = A.float()
    res_r = float(residual.cholesky_residual(Af, R.float()))
    res_i = float(residual.cholesky_inverse_residual(R.float(), Ri.float()))
    del Af
    # gates: bf16 keeps 8 significant bits (2^-8 ≈ 4e-3 per entry)
    check(res_r < 1e-2 and res_i < 1e-2, f"n=16384 bf16 residuals {res_r}, {res_i}")
    out["factor"]["n16384_bf16"] = dict(counts=counts, seconds_first=secs, vs_plain=[dR, dRi],
                                        residual=res_r, inverse_residual=res_i)
    print(json.dumps({"factor": "n=16384 bf16 bc=512", **out["factor"]["n16384_bf16"]}), flush=True)
    del R, Ri, A
    torch.cuda.empty_cache()

    # ---- phase 3b: n=8192 f32, every tri_matmul launch on fma ------------
    n = 8192
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, n, torch.float32, 256, "highest")
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    # f32 gates (the reference's f32 class, ~1e-6), with room for n=8192
    check(res_r < 5e-6 and res_i < 5e-6, f"n=8192 f32 residuals {res_r}, {res_i}")
    del R, Ri
    t = timed_s(lambda: cholesky.factor(grid, A, cfg), 2)
    out["factor"]["n8192_f32"] = dict(counts=counts, seconds=t, tflops=(2 * n**3 / 3) / t / 1e12,
                                      seconds_first=secs, residual=res_r, inverse_residual=res_i)
    print(json.dumps({"factor": "n=8192 f32 bc=256", **out["factor"]["n8192_f32"]}), flush=True)
    del A
    torch.cuda.empty_cache()

    # ---- phase 3c: the n=49152 bf16 flagship, bc=384 ---------------------
    n, bc = 49152, 384
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, n, torch.bfloat16, bc, None)
    path_counts = counts
    del R, Ri
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 2
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        R = Ri = None  # free the previous result: peak memory of one factor
        R, Ri = cholesky.factor(grid, A, cfg)
    end.record()
    end.synchronize()
    t = start.elapsed_time(end) / 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    v = torch.randn(n, 4, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    pr = float(residual.cholesky_probe_residual(A, R, v))
    pi = float(residual.inverse_probe_residual(R, Ri, v))
    check(pr < 1e-2 and pi < 1e-2, f"flagship probe residuals {pr}, {pi}")
    flag = dict(n=n, bc=bc, dtype="bfloat16", seconds=t, tflops=(2 * n**3 / 3) / t / 1e12,
                peak_bytes=peak, probe_residual=pr, probe_inverse_residual=pi,
                seconds_first=secs, counts=path_counts, card=smi)
    out["factor"]["flagship"] = flag
    print(json.dumps({"factor": "flagship", **flag}), flush=True)
    del R, Ri
    out["profile"] = profile(lambda: cholesky.factor(grid, A, cfg), "CI::")
    print(json.dumps({"profile": "flagship", **out["profile"]}), flush=True)
    out["factor"]["flagship_fused"] = fused_flagship(cholesky, hopper, grid, A, cfg, residual)
    del A

    missing = [k for k in PATH_KERNELS if path_counts.get(k, 0) < 1]
    check(not missing, f"kernels of the path never launched: {missing}")

    # ---- phase 3d: n=16384 f64 bc=512, the reference's own precision -------
    out["factor"]["n16384_f64"] = f64_factor_phase(cholesky, hopper, grid, residual)

    # ---- phase 4: the CholeskyQR2 kernels against their plain versions ----
    from capital_tpu_torch.ops import qr_fused

    qr_kernels = out["kernels"]["qr"] = {}
    for run, dtype in (("flagship", torch.bfloat16), ("single_rank", torch.float32),
                       ("single_rank", torch.float64), ("flagship", torch.float64)):
        m, n = QR_SHAPES[run]
        res = qr_kernel_phase(qr_fused, hopper, m, n, dtype, dev)
        for name, r in res.items():
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
            print(json.dumps({"kernel": name, "dtype": str(dtype), **r}), flush=True)
        qr_kernels[f"{run} {dtype}"] = res

    # ---- phase 5: the CholeskyQR2 path ------------------------------------
    out["qr"] = qr_path(hopper, dev, grid)
    qr_counts = out["qr"]["flagship"]["counts"]
    missing = [k for k in QR_KERNELS if qr_counts.get(k, 0) < 1]
    check(not missing, f"kernels of the QR path never launched: {missing}")

    # ---- phase 6: the small-N batched kernels against their plain versions
    from capital_tpu_torch.ops import batched_small

    small = {}
    for size, dtype, names in (("latency", torch.float32, SMALL_KERNELS),
                               ("throughput", torch.float32, SMALL_KERNELS),
                               ("latency", torch.bfloat16, ("small.potrf",)),
                               ("throughput", torch.bfloat16, SMALL_KERNELS)):
        res = small_kernel_phase(batched_small, size, dtype, dev, names)
        for name, r in res.items():
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
            print(json.dumps({"kernel": name, "size": size, "dtype": str(dtype), **r}), flush=True)
        small[f"{size} {dtype}"] = res
    out["kernels"]["small"] = small

    # ---- phase 7: the small-N serve path ----------------------------------
    out["serve"] = serve_phase(hopper, dev)
    print(json.dumps({"serve": "small-N posv/lstsq/inv", **out["serve"]}), flush=True)
    serve_counts = out["serve"]["launches"]
    missing = [k for k in SMALL_KERNELS if serve_counts.get(k, 0) < 1]
    check(not missing, f"kernels of the serve path never launched: {missing}")

    # ---- phase 7b: the serve engine ----------------------------------------
    out["engine"] = engine_phase(hopper, dev)

    # ---- phase 7c: factor residency and streaming sessions ------------------
    out["residency"] = residency_phase(hopper, dev, smi)

    # ---- phase 7d: the serve front end ---------------------------------------
    out["frontend"] = frontend_phase(hopper, dev, smi)

    # ---- phase 8: the inversion slice's kernels against plain versions ---
    from capital_tpu_torch.ops import tsqr

    inv = inv_kernel_phase(hopper, batched_small, tsqr, dev)
    for name, r in inv.items():
        if "bound" in r:
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
        print(json.dumps({"kernel": name, **r}), flush=True)
    out["kernels"]["inversion"] = inv

    # ---- phases 9-12: rectri, TRSM and Newton, the fused tail, TSQR -------
    out["rectri"] = rectri_phase(hopper, grid, dev)
    out["trsm_newton"] = trsm_newton_phase(hopper, grid, dev)
    out["tail"] = tail_phase(hopper, grid, dev)
    out["tsqr"] = tsqr_phase(hopper, dev)
    inv_counts = {"write_diag_blocks": out["rectri"]["flagship"]["counts"]["write_diag_blocks"],
                  "fused_tail": out["tail"]["counts"]["fused_tail"],
                  "tsqr.panel_qr": out["tsqr"]["counts"]["tsqr.panel_qr"],
                  # no program of either package calls it: 0 in every counted run
                  "small.trsm": out["rectri"]["flagship"]["counts"]["small.trsm"]}
    missing = [k for k in ("write_diag_blocks", "fused_tail", "tsqr.panel_qr") if inv_counts[k] < 1]
    check(not missing, f"kernels of the inversion paths never launched: {missing}")

    # ---- phase 13: the blocktri scan-step kernels against plain versions --
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.ops import blocktri_small
    bt = bt_kernel_phase(hopper, blocktri_small, blocktri, dev)
    for name, r in bt.items():
        if isinstance(r, dict) and "bound" in r:
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
        print(json.dumps({"kernel": name, **r} if "max_abs_err" in r else {name: r}), flush=True)
    out["kernels"]["blocktri"] = bt

    # ---- phase 14: the structured path ------------------------------------
    out["structured"] = structured_phase(hopper, dev)
    # each kernel's launches on the main path's own counted run: the
    # flagship 'pallas' posv, the factor, the solve from that factor
    st = out["structured"]
    bt_counts = {"bt.fused_forward": st["posv_flagship"]["pallas"]["counts"].get("bt.fused_forward", 0),
                 "bt.factor": st["factor_solve"]["counts"].get("bt.factor", 0),
                 "bt.forward_solve": st["factor_solve"]["solve_counts"].get("bt.forward_solve", 0),
                 "bt.solve_backward": st["posv_flagship"]["pallas"]["counts"].get("bt.solve_backward", 0)}
    missing = [k for k in BT_KERNELS if bt_counts[k] < 1]
    check(not missing, f"kernels of the structured path never launched: {missing}")

    # ---- phase 15: the rotation-sweep kernel against its plain version ---
    from capital_tpu_torch.ops import update_small

    up = up_kernel_phase(update_small, dev)
    for name, r in up.items():
        if "bound" in r:
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
        print(json.dumps({"kernel": "up.sweep", "case": name, **r}), flush=True)
    out["kernels"]["update"] = up

    # ---- phase 16: the update and refinement paths -------------------------
    out["update_refine"] = update_refine_phase(hopper, dev)
    up_counts = {"up.sweep": out["update_refine"]["up_launches"]}
    check(up_counts["up.sweep"] >= 1, "the sweep kernel never launched on api.batched('chol_update')")

    # ---- phase 17: the mesh schedule's kernel against its plain version --
    from capital_tpu_torch.parallel import summa

    sched = sched_kernel_phase(hopper, summa, dev)
    for name, r in sched.items():
        b, by = r.pop("bound")
        r.update(bound_ms=b, bound_by=by)
        print(json.dumps({"kernel": "sched_matmul", "case": name, **r}), flush=True)
    out["kernels"]["sched"] = sched

    # ---- phase 18: the mesh path -----------------------------------------
    out["mesh"] = mesh_phase(hopper, dev)
    mesh_counts = {"sched_matmul": out["mesh"]["cholinv"]["counts"]["sched_matmul"]}
    check(mesh_counts["sched_matmul"] >= 1, "sched_matmul never launched on the mesh cholinv")

    bf = out["kernels"][str(torch.bfloat16)]
    # the small-N kernels report their f32 throughput batch; the blocktri
    # steps the flagship's step (8 problems, seg 8, b 128, k 1, f32); the
    # sweep its f32 update throughput batch
    measured = {**bf, **out["kernels"]["qr"][f"flagship {torch.bfloat16}"], **small[f"throughput {torch.float32}"], **inv,
                **{k: bt[f"{k} 8x8x128x1 f32"] for k in BT_KERNELS},
                "up.sweep": up["update 8192x128x8 f32"],
                "sched_matmul": sched["flagship a bfloat16"]}
    # tri_matmul.dense is on no path: 0 in the cholinv path's counted run
    launches = {**{k: path_counts[k] for k in PATH_KERNELS + ("tri_matmul.dense",)},
                **{k: qr_counts[k] for k in QR_KERNELS},
                **serve_counts, **inv_counts, **bt_counts, **up_counts, **mesh_counts}
    line = {"kernels": [
        {"name": k, "route": hopper.KERNELS[k].route, "source": hopper.KERNELS[k].source,
         "replaces": hopper.KERNELS[k].replaces, "launches": launches[k],
         "max_abs_err": measured[k]["max_abs_err"], "ms": measured[k]["ms"],
         "plain_ms": measured[k]["plain_ms"], "bound_ms": measured[k]["bound_ms"],
         "bound_by": measured[k]["bound_by"], "library_ms": measured[k]["library_ms"]}
        for k in PATH_KERNELS + ("tri_matmul.dense",) + QR_KERNELS + SMALL_KERNELS + INV_KERNELS
        + BT_KERNELS + UP_KERNELS + MESH_KERNELS
    ]}
    check(sorted(e["name"] for e in line["kernels"]) == sorted(hopper.KERNELS),
          "the kernels line does not cover every registered kernel")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
