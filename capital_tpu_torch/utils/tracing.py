"""Phase scopes and the analytic cost model (the subset of
capital_tpu/utils/tracing.py that cholinv, CholeskyQR2, the small-N batched
solves, rectri, TRSM, the block-tridiagonal chain solvers and the mesh
schedule call).

Phase tags keep the reference's critter symbol names (``CI::trsm`` ...) so
phase tables compare across the two packages.  `scope` pushes the tag for
cost attribution and opens a `torch.profiler.record_function` region, so a
`torch.profiler` trace of the card groups kernels by phase.  `emit` and
`note` are no-ops unless a `Recorder` is active.

PyTorch runs eagerly, so unlike the JAX package (which emits once per
trace) every call emits: a Recorder around one `factor` call captures
exactly that call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch

#: Registered phase tags — the cholinv and cacqr subsets of the JAX
#: package's registry, names unchanged.  `scope()` refuses any other tag.
#: CQR::scale is historical (kept so phase tables still line up);
#: CQR::recover is the shifted-CholeskyQR escalation path.
PHASE_REGISTRY: tuple[str, ...] = (
    "CI::factor_diag", "CI::trsm", "CI::tmu", "CI::inv", "CI::buffers",
    "CI::tail_fused",
    "CQR::gram", "CQR::chol", "CQR::scale", "CQR::merge", "CQR::fused",
    "CQR::formR", "CQR::recover",
    "QR::tsqr",
    # rectri (models/inverse.py); RT::buffers is the output-buffer init
    "RT::base", "RT::merge", "RT::batch_base", "RT::batch_merge",
    "RT::batch_write", "RT::buffers",
    # trsm (models/trsm.py)
    "TS::dinv", "TS::leaf", "TS::update",
    # serve (serve/): serve::ingest is the engine's host-side per-request
    # fault tap, serve::pad wraps bucket padding, serve::solve the
    # per-problem library solves of the vmap route; SV::stage wraps the
    # staging of padded operands onto the device at admission, SV::dispatch
    # the bucket program's call
    "serve::ingest", "serve::pad", "serve::solve", "SV::stage", "SV::dispatch",
    # batched small-N kernels (ops/batched_small.py): OP::batched_small
    # wraps the standalone potrf/potrs kernels, SV::fused_* the fused
    # factor+solve kernels (one phase: the factor never leaves the block)
    "OP::batched_small", "SV::fused_posv", "SV::fused_lstsq",
    # block-tridiagonal chain (models/blocktri.py): BT::factor wraps the
    # factor scan (the fused forward sweep included for posv), BT::solve
    # the substitution sweeps, BT::partition / BT::reduce the Spike
    # driver's interiors and reduced chain, UP::extend the appended-block
    # factor; the arrowhead completion (models/arrowhead.py)
    "BT::factor", "BT::solve", "BT::partition", "BT::reduce", "UP::extend",
    "AH::schur", "AH::border",
    # rank-k Cholesky update / downdate (ops/update_small.py) and the
    # refinement sweeps (robust/refine.py): IR::residual wraps the
    # high-precision residual product, IR::correct the correction solve
    "UP::update", "UP::downdate", "IR::residual", "IR::correct",
    # streaming sessions (serve/sessions.py): SS::extend wraps the session
    # open / append chain-extension program, SS::solve the resident-factor
    # sweeps; the chain work inside is priced once, under these tags
    "SS::extend", "SS::solve",
)
_PHASE_SET: set[str] = set(PHASE_REGISTRY)


def register_phase(tag: str) -> str:
    """Register an out-of-tree phase tag so `scope()` accepts it."""
    global PHASE_REGISTRY
    if tag not in _PHASE_SET:
        PHASE_REGISTRY = PHASE_REGISTRY + (tag,)
        _PHASE_SET.add(tag)
    return tag


_SCOPE_STACK: list[str] = []
_ACTIVE: list["Recorder"] = []
_MUTED: list[bool] = []


def current_scope() -> str | None:
    """Innermost active phase tag, or None outside every scope() — the key
    the fault-injection taps (robust/faultinject.py) resolve against."""
    return _SCOPE_STACK[-1] if _SCOPE_STACK else None


@contextlib.contextmanager
def muted():
    """Suppress emit()/note() attribution inside the block: the robust
    recovery work (robust/recovery.guarded_chol, the sCQR3 escalation) is
    priced out of the model, which describes the healthy path."""
    _MUTED.append(True)
    try:
        yield
    finally:
        _MUTED.pop()


@dataclasses.dataclass
class PhaseStats:
    """Accumulated model costs for one phase tag.  `flops` is the
    homogeneous model count; `flops_vol` / `flops_max` the executed views
    (dead-tile skipping counts there)."""

    calls: int = 0
    flops: float = 0.0
    comm_bytes: float = 0.0
    collectives: int = 0
    flops_vol: float = 0.0
    flops_max: float = 0.0
    copy_bytes: float = 0.0

    def merge(self, other: "PhaseStats") -> None:
        self.calls += other.calls
        self.flops += other.flops
        self.comm_bytes += other.comm_bytes
        self.collectives += other.collectives
        self.flops_vol += other.flops_vol
        self.flops_max += other.flops_max
        self.copy_bytes += other.copy_bytes


@contextlib.contextmanager
def scope(tag: str):
    """Enter an algorithm phase: profiler region + cost attribution."""
    if tag not in _PHASE_SET:
        raise ValueError(
            f"unregistered phase tag {tag!r}: add it to "
            "tracing.PHASE_REGISTRY (or register_phase)"
        )
    _SCOPE_STACK.append(tag)
    try:
        with torch.profiler.record_function(tag):
            yield
    finally:
        _SCOPE_STACK.pop()


def emit(
    flops: float = 0.0,
    comm_bytes: float = 0.0,
    collectives: int = 0,
    flops_vol: float | None = None,
    flops_max: float | None = None,
    copy_bytes: float = 0.0,
) -> None:
    """Attribute model costs to the innermost active phase."""
    if not _ACTIVE or _MUTED:
        return
    tag = _SCOPE_STACK[-1] if _SCOPE_STACK else "<top>"
    for rec in _ACTIVE:
        st = rec.stats[tag]
        st.calls += 1
        st.flops += flops
        st.comm_bytes += comm_bytes
        st.collectives += collectives
        st.flops_vol += flops if flops_vol is None else flops_vol
        st.flops_max += flops if flops_max is None else flops_max
        st.copy_bytes += copy_bytes


def note(tag: str) -> None:
    """Count-only event under its own tag (not the scope stack)."""
    if _MUTED:
        return
    for rec in _ACTIVE:
        rec.stats[tag].calls += 1


class Recorder:
    """Collects per-phase model costs while active::

        with tracing.Recorder() as rec:
            cholesky.factor(grid, A, cfg)
        rec.stats["CI::trsm"].flops
    """

    def __init__(self) -> None:
        self.stats: dict[str, PhaseStats] = defaultdict(PhaseStats)

    def __enter__(self) -> "Recorder":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def total(self) -> PhaseStats:
        t = PhaseStats()
        for s in self.stats.values():
            t.merge(s)
        return t


def _ring_bytes(block_bytes: float, p: int) -> float:
    """Bytes per device for a ring broadcast/allgather of `block_bytes` over
    an axis of p devices: (p-1)/p * total."""
    return block_bytes * (p - 1) / p if p > 1 else 0.0


def _allreduce_bytes(block_bytes: float, p: int) -> float:
    """Ring allreduce: 2(p-1)/p * bytes (reduce-scatter + allgather)."""
    return 2.0 * block_bytes * (p - 1) / p if p > 1 else 0.0


def gemm_cost(grid, M: int, N: int, K: int, dtype) -> tuple[float, float, int]:
    """(flops, comm_bytes, collectives) per device for C[M,N] = A[M,K] @
    B[K,N] under the explicit SUMMA schedule on a dx x dy x c grid
    (parallel/summa.py:_explicit_matmul).  c == 1: a ring all_gather of the
    A block row over 'y' and of the B block column over 'x'.  c > 1:
    per-step masked-psum broadcasts of this layer's d/c panels, plus a ring
    allreduce of the C block over depth.  num_chunks splits each into that
    many collectives (same bytes).  The model prices what a mesh would
    move; the virtual mesh (parallel/mesh.py) moves it inside one device."""
    dx, dy, c = grid.dx, grid.dy, grid.c
    item = dtype.itemsize
    p = dx * dy * c
    flops = 2.0 * M * N * K / p
    q = max(1, getattr(grid, "num_chunks", 0))
    d = max(dx, dy)
    c_blk = (M / dx) * (N / dy) * item
    if c == 1:
        a_row = (M / dx) * K * item  # gathered block row per device
        b_col = K * (N / dy) * item  # gathered block column per device
        comm = _ring_bytes(a_row, dy) + _ring_bytes(b_col, dx)
        ncoll = (q if dy > 1 else 0) + (q if dx > 1 else 0)
    else:
        steps = max(1, d // c)  # this layer's K-steps
        a_pan = (M / dx) * (K / d) * item
        b_pan = (K / d) * (N / dy) * item
        comm = steps * (_allreduce_bytes(a_pan, dy) + _allreduce_bytes(b_pan, dx))
        ncoll = steps * ((q if dy > 1 else 0) + (q if dx > 1 else 0))
    comm += _allreduce_bytes(c_blk, c)
    # the collect splits into q column slices, never more than the block
    # has columns (zero-width tails are skipped by the schedule)
    ncoll += min(q, max(1, int(N // max(1, dy)))) if c > 1 else 0
    return flops, comm, ncoll


def transpose_cost(grid, m: int, n: int, dtype) -> tuple[float, int]:
    """(comm_bytes, collectives) per device for a grid transpose: each
    device exchanges its (m/dx, n/dy) block with the mirrored coordinate."""
    dx, dy = grid.dx, grid.dy
    if dx == 1 and dy == 1:
        return 0.0, 0
    return (m / dx) * (n / dy) * dtype.itemsize, 1


def replicate_cost(grid, m: int, n: int, dtype) -> tuple[float, int]:
    """(comm_bytes, collectives) to replicate an m x n panel to every device
    (all_gather over the whole mesh) — the base-case gather."""
    p = grid.num_devices
    return _ring_bytes(m * n * dtype.itemsize, p), 1 if p > 1 else 0


def allreduce_cost(grid, m: int, n: int, dtype, axes: str = "all") -> tuple[float, int]:
    """(comm_bytes, collectives) for psum of an m x n value over the whole
    mesh (axes='all') or over depth (axes='z')."""
    p = grid.num_devices if axes == "all" else grid.c
    return _allreduce_bytes(m * n * dtype.itemsize, p), 1 if p > 1 else 0


def potrf_trtri_flops(n: int) -> float:
    """Local panel factor + triangular inverse: n³/3 + n³/3."""
    return 2.0 * n**3 / 3.0


def tsqr_flops(m: int, n: int, leaves: int) -> float:
    """Blocked Householder TSQR (QR::tsqr): leaf panel QRs ≈ 4·m·n², the
    leaves − 1 pairwise (2n, n) reduction QRs ≈ 8n³ each, and the per-level
    Q-assembly products ≈ 2·m·n² per level."""
    leaves = max(int(leaves), 1)
    levels = max(leaves.bit_length() - 1, 0)
    return 4.0 * m * n**2 + 8.0 * (leaves - 1) * n**3 + 2.0 * levels * m * n**2


# -- batched small-N kernel pricing (ops/batched_small.py) -----------------
# Copied unchanged from the JAX package so Recorder totals agree across the
# two: they count the TPU column sweep's EXECUTED flops (full-matrix rank-1
# updates, one-hot extractions), not useful flops.  The CUDA kernels do the
# useful work only (n³/3 for a Cholesky); their bound on the card is
# computed from useful flops (chip_smoke.py).


def batched_chol_flops(n: int) -> float:
    """Full-matrix rank-1 sweep Cholesky, per problem: ≈ 6n³ executed."""
    return 6.0 * n**3


def batched_trsm_flops(n: int, k: int) -> float:
    """One masked substitution sweep, per problem: 2n³ + 4n²k executed."""
    return 2.0 * n**3 + 4.0 * n**2 * k


def fused_posv_flops(n: int, k: int) -> float:
    """Fused factor + two substitution sweeps, per problem (SV::fused_posv)."""
    return batched_chol_flops(n) + 2.0 * batched_trsm_flops(n, k)


def fused_tail_flops(n: int) -> float:
    """Fused recursion-tail kernel, whole subtree (CI::tail_fused): the
    column-sweep factor of the (n, n) window (executed flops, like
    batched_chol_flops) plus the back-substitution inverse of the n-wide
    identity (one sweep at k = n)."""
    return batched_chol_flops(n) + batched_trsm_flops(n, n)


def fused_lstsq_flops(m: int, n: int, k: int) -> float:
    """Fused batched CholeskyQR2 lstsq, per problem (SV::fused_lstsq):
    gram 2mn² + AᵀB 2mnk, two sweep factors, the R1⁻ᵀ·G·R1⁻¹ correction
    (2 trsm sweeps at k=n), the RHS sweeps and the R2·R1 product."""
    return (
        2.0 * m * n * (n + k)
        + 2.0 * batched_chol_flops(n)
        + 2.0 * batched_trsm_flops(n, n)
        + 4.0 * batched_trsm_flops(n, k)
        + 2.0 * n**3
    )


# -- block-tridiagonal chain and arrowhead pricing (models/blocktri.py,
# models/arrowhead.py), copied unchanged from the JAX package: executed
# flops of the TPU sweeps, like the batched-small prices above.


def blocktri_chol_flops(nblocks: int, b: int) -> float:
    """Block-tridiagonal factor chain, per problem (BT::factor): per chain
    block one sweep Cholesky of the (b, b) Schur complement, one forward
    sweep for Wt = L⁻¹·Cᵀ at k = b, the identity-contraction transpose of C
    (2b³) and the Wtᵀ·Wt Schur update (2b³).  The useful count is
    nblocks·(b³/3 + 3b³)."""
    return nblocks * (batched_chol_flops(b) + batched_trsm_flops(b, b)
                      + 4.0 * b**3)


def blocktri_solve_flops(nblocks: int, b: int, k: int) -> float:
    """ONE block-bidiagonal substitution sweep (forward or backward), per
    problem (BT::solve): per chain block one (b, b) triangular sweep at
    width k plus the 2b²k coupling product."""
    return nblocks * (batched_trsm_flops(b, k) + 2.0 * b**2 * k)


def blocktri_partition_flops(nblocks: int, b: int, k: int,
                             partitions: int) -> float:
    """Per-partition side of the partitioned (Spike) chain solve, per
    problem (BT::partition): the nblocks − P interior blocks factor once
    and run both sweeps at the widened k + 2b columns, and the
    back-substitution applies the two (b, b) spike blocks to each interior
    solution (4b²k per block)."""
    interior = nblocks - partitions
    return (blocktri_chol_flops(interior, b)
            + 2.0 * blocktri_solve_flops(interior, b, k + 2 * b)
            + 4.0 * interior * b**2 * k)


def blocktri_reduce_flops(partitions: int, b: int, k: int) -> float:
    """Reduced interface system of the partitioned chain solve, per
    problem (BT::reduce): per separator the Schur assembly products (6b³
    plus 4b²k), then the P-block reduced chain's factor and both sweeps."""
    asm = partitions * (6.0 * b**3 + 4.0 * b**2 * k)
    return (asm + blocktri_chol_flops(partitions, b)
            + 2.0 * blocktri_solve_flops(partitions, b, k))


def arrowhead_schur_flops(nblocks: int, b: int, s: int) -> float:
    """Schur-complement completion of the arrowhead corner, per problem
    (AH::schur): the border reduction B·Z_B over the chain (2·nblocks·b·s²)
    plus the dense corner Cholesky (s³/3)."""
    return 2.0 * nblocks * b * s * s + s**3 / 3.0


def arrowhead_border_flops(nblocks: int, b: int, s: int, k: int) -> float:
    """Corner solve and chain back-substitution of the arrowhead
    completion, per problem (AH::border): the corner RHS correction
    (2·n·s·k), the two (s, s) triangular corner solves (2s²k) and
    x_T = Z_rhs − Z_B·x_S (2·n·s·k)."""
    n = nblocks * b
    return 4.0 * n * s * k + 2.0 * s * s * k


def chol_update_flops(n: int, k: int) -> float:
    """Rank-k Cholesky update/downdate sweep, per problem (UP::update /
    UP::downdate): the reference's executed count on its masked one-hot
    sweep, 4kn³ (the useful count is ~4.5kn², the rotation recurrence's;
    chip_smoke's bound uses that one)."""
    return 4.0 * k * n**3


def refine_sweep_flops(n: int, k: int) -> float:
    """One iterative-refinement sweep over a dense SPD solve, per problem
    (IR::residual + IR::correct): the residual product r = B − A·X (2n²k),
    the two triangular correction sweeps and the X += d axpy."""
    return 2.0 * n * n * k + 2.0 * batched_trsm_flops(n, k) + 2.0 * n * k


def refine_sweeps_from_stats(refine_block: dict | None) -> float:
    """Mean executed refinement sweeps per request, read from a serve
    stats `refine` block (serve/stats.Collector): the iters p50, floored at
    1.0 (every refined request runs at least the residual check sweep); an
    absent or malformed block gives the one-sweep default."""
    if not refine_block:
        return 1.0
    iters = refine_block.get("iters") or {}
    try:
        return max(float(iters.get("p50", 1.0)), 1.0)
    except (TypeError, ValueError):
        return 1.0


def refine_lstsq_sweep_flops(m: int, n: int, k: int) -> float:
    """One semi-normal-equation refinement sweep over lstsq, per problem:
    r = B − A·X (2mnk), g = Aᵀr (2mnk), the two triangular sweeps of
    d = R⁻¹R⁻ᵀg and the update axpy."""
    return 4.0 * m * n * k + 2.0 * batched_trsm_flops(n, k) + 2.0 * n * k
