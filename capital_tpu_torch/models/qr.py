"""cacqr: CholeskyQR2 for tall-skinny QR on one device or a mesh
(counterpart of capital_tpu/models/qr.py; CA-CQR2, IPDPS'19,
arXiv:1710.08471).

For tall-skinny A (m x n, m >> n) one sweep is

    G = AᵀA          (gram)
    R = chol(G)      (small n x n factorization)
    Q = A · R⁻¹      (tall scaling)

and CQR2 runs two sweeps and merges R = R2·R1.  Regime '1d' (A's rows
over every rank) on one device:

* the fused tier (`_cqr2_fused`, plan 'full'): gram_blocked, scale_gram and
  scale_blocked, the hand-written kernels of ops/qr_fused.py, in mode
  'pallas' wherever the column split is eligible (every CQR2 shape on the
  card; the 'split' tier stays callable directly);
* the panel tier (`_cqr2_panels`, on torch.matmul);
* the sweeps (`_sweep_1d`) for CQR1 and the other modes, whose scale runs
  the tri_matmul trmm kernel in mode 'pallas';
* grams with n >= GRAM_CHOLINV_MIN factor through the recursive cholinv
  (models/cholesky.py), smaller ones through the LAPACK seam;
* the robust ladder (`RobustConfig`): guarded Cholesky sites, the shifted
  retry, the sCQR3 third sweep and the f64 TSQR rung.  The JAX package
  branches with lax.cond; here the branches are taken on the host, which
  reads the status scalars — only under cfg.robust, so the default path
  never synchronises.

On a mesh (parallel/topology.py), regime '1d' runs the fused tier PER RANK
on the rank's rows (`_cqr2_fused_sharded`: the three kernels once per rank,
the grams summed over the mesh by `mesh.psum`), or — rows that do not
divide, other modes, CQR1, and every robust run — the sweeps on the whole
operand with the model priced per rank.  Regime 'dist' (`_sweep_dist`, on
one device too) forms the gram with summa.syrk, factors it with the nested
cholinv and scales with summa.trmm side R (mode 'explicit' on a mesh: the
per-rank `sched_matmul`), or with `solve_blocked` when the nested cholinv
skips the top-level inverse block.
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.models import cholesky
from capital_tpu_torch.models.cholesky import CholinvConfig
from capital_tpu_torch.ops import hopper, lapack, qr_fused, tsqr
from capital_tpu_torch.parallel import mesh, summa
from capital_tpu_torch.parallel.summa import GemmArgs, SyrkArgs, TrmmArgs
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.robust import config as config_mod
from capital_tpu_torch.robust import faultinject, recovery
from capital_tpu_torch.robust.config import RobustConfig, RobustInfo
from capital_tpu_torch.utils import tracing

#: grams at least this wide factor through the recursive cholinv on one
#: device; narrower ones (and every gram on a mesh) through
#: lapack.potrf_trtri_upper
GRAM_CHOLINV_MIN = 2048


@dataclasses.dataclass(frozen=True)
class CacqrConfig:
    """Field for field the JAX package's CacqrConfig.

    num_iter: 1 = CholeskyQR, 2 = CholeskyQR2.
    regime: '1d' | 'dist' | 'auto' ('auto' is '1d' on a flat grid, else
        '1d' for n <= dist_threshold).
    dist_threshold: in 'auto', gram sizes above this go distributed.
    cholinv: configuration of the nested cholinv: regime 'dist''s gram
        factor, and regime '1d''s grams with n >= GRAM_CHOLINV_MIN on one
        device (its base_case_dim is the bench's --bc).
    mode: 'pallas' runs the hand-written kernels, 'xla' plain torch.matmul.
    precision: f32 at 'high' runs the kernels' products (the fused passes
        and the nested cholinv's in mode 'pallas') as the JAX package's
        bf16x3 split (hopper.split_high); torch.matmul products (mode
        'xla') and every other dtype and precision are full precision.
    fused_g: column split of the fused passes; 0 = auto (qr_fused.pick_g).
    robust: with a RobustConfig factor() returns (Q, R, RobustInfo), every
        Cholesky site is guarded, and a breakdown runs the recovery ladder.
    """

    num_iter: int = 2
    regime: str = "auto"
    dist_threshold: int = 4096
    cholinv: CholinvConfig = CholinvConfig()
    mode: str = "xla"
    precision: str | None = "highest"
    fused_g: int = 0
    robust: RobustConfig | None = None


# --------------------------------------------------------------------------
# robust session: collects the CholEvents of one factor() call
# --------------------------------------------------------------------------


class _Session:
    """One robust factor() call: its RobustConfig and the CholEvents its
    guarded sites record, in call order."""

    def __init__(self, rcfg: RobustConfig):
        self.rcfg = rcfg
        self.events: list = []


_ROBUST: list[_Session] = []


def _chol_site(G: torch.Tensor, m_rows: int, chol_fn):
    """Factor a gram at one Cholesky site: chol_fn(G) verbatim outside a
    robust session, recovery.guarded_chol inside one."""
    if not _ROBUST:
        return chol_fn(G)
    ses = _ROBUST[-1]
    R, Rinv, ev = recovery.guarded_chol(G, m_rows, ses.rcfg, chol_fn)
    ses.events.append(ev)
    return R, Rinv


# --------------------------------------------------------------------------
# sweeps
# --------------------------------------------------------------------------


def _col_blocks(n: int) -> int:
    """Column blocks of the sweeps' gram and scale: 2 where n/2 is a
    128-multiple of at least 256, else 1."""
    if n % 2 == 0 and (n // 2) % 128 == 0 and n // 2 >= 256:
        return 2
    return 1


def _sweep_1d(grid: Grid, A: torch.Tensor, cfg: CacqrConfig):
    """One CQR sweep: the gram from g block rows (only the upper ones are
    multiplied, the lower blocks are their transposes), the LAPACK-seam
    factor pair, and the scale — the tri_matmul trmm kernel with an upper
    R⁻¹ in mode 'pallas', else a dense product with triu(R⁻¹)."""
    m, n = A.shape
    g = _col_blocks(n)
    nb = n // g
    live_frac = qr_fused.live_fraction(g)
    per = 2.0 * m * n * n / grid.num_devices  # the model is per rank
    with tracing.scope("CQR::gram"):
        comm, ncoll = tracing.allreduce_cost(grid, n, n, A.dtype, axes="all")
        tracing.emit(flops=per * live_frac, comm_bytes=comm * live_frac, collectives=ncoll * g)
        if g > 1:
            grows = [A[:, i * nb:(i + 1) * nb].T @ A[:, i * nb:] for i in range(g)]
            G = torch.cat([
                torch.cat([grows[j][:, (i - j) * nb:(i - j + 1) * nb].T for j in range(i)]
                          + [grows[i]], dim=1)
                for i in range(g)
            ], dim=0)
        else:
            G = A.T @ A
        G = faultinject.tap(G)
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R, Rinv = _chol_site(G, m, lambda g_: lapack.potrf_trtri(g_, uplo="U"))
    with tracing.scope("CQR::formR"):
        tri_kernel = g > 1 and grid.num_devices == 1 and cfg.mode == "pallas" and nb <= 2048
        tracing.emit(flops=per * (live_frac if tri_kernel else 1.0))
        if tri_kernel:
            # torch.linalg hands back a column-major R⁻¹; the kernel reads
            # row-major buffers (an n x n copy)
            Q = hopper.tri_matmul(A, Rinv.contiguous(), b_uplo="U", precision=cfg.precision)
        else:
            Q = A @ torch.triu(Rinv)
    return Q, R


def _gram_chol(grid: Grid, G: torch.Tensor, cfg: CacqrConfig, m_rows: int):
    """(R, R⁻¹) of an upper-valid gram: the recursive cholinv for
    n >= GRAM_CHOLINV_MIN on one device (robust=None on the nested config: the session's
    guarded_chol owns detection; complete_inv forced, these tiers multiply
    by the whole inverse), else lapack.potrf_trtri_upper.  Both read only
    the upper triangle."""
    n = G.shape[0]
    if n >= GRAM_CHOLINV_MIN and grid.num_devices == 1:
        ccfg = dataclasses.replace(
            cfg.cholinv, mode=cfg.mode, precision=cfg.precision,
            complete_inv=True, robust=None,
        )
        return _chol_site(G, m_rows, lambda g_: cholesky.factor(grid, g_, ccfg))
    return _chol_site(G, m_rows, lapack.potrf_trtri_upper)


def _cqr2_fused(grid: Grid, A: torch.Tensor, cfg: CacqrConfig, g: int, plan: str = "full"):
    """CQR2 through the fused tall passes (ops/qr_fused.py): sweep 1's gram,
    then sweep 1's scale with sweep 2's gram (one scale_gram call on plan
    'full'; scale_blocked then gram_blocked of the written Q1 on 'split'),
    then the final scale and the triangular merge."""
    m, n = A.shape
    precision = cfg.precision
    live = qr_fused.live_fraction(g)

    def _chol(G):
        return _gram_chol(grid, G, cfg, m)

    def _gram_out(Gu):
        # both factor routes read only the valid upper triangle: no
        # symmetric assembly
        return faultinject.tap(Gu.to(A.dtype))

    with tracing.scope("CQR::gram"):
        tracing.emit(flops=2.0 * m * n * n * live)
        G1 = _gram_out(qr_fused.gram_blocked(A, g=g, precision=precision))
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R1, R1inv = _chol(G1)
    with tracing.scope("CQR::fused"):
        tracing.emit(flops=2.0 * m * n * n * (live + live))
        if plan == "split":
            Q1 = qr_fused.scale_blocked(A, torch.triu(R1inv), g=g, precision=precision)
            G2 = qr_fused.gram_blocked(Q1, g=g, precision=precision)
        else:
            Q1, G2 = qr_fused.scale_gram(A, torch.triu(R1inv), g=g, precision=precision)
        G2 = _gram_out(G2)
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R2, R2inv = _chol(G2)
    with tracing.scope("CQR::formR"):
        tracing.emit(flops=2.0 * m * n * n * live)
        Q = qr_fused.scale_blocked(Q1, torch.triu(R2inv), g=g, precision=precision)
    with tracing.scope("CQR::merge"):
        tracing.emit(flops=2.0 * n**3)
        R = torch.triu(R2) @ torch.triu(R1)
    return Q, R


def _cqr2_panels(grid: Grid, A: torch.Tensor, cfg: CacqrConfig, c: int = 512):
    """CQR2 as column panels of width c on torch.matmul (the JAX package's
    tier past every kernel's VMEM envelope; it has no kernel there either):
    gram panel j is X[:, :(j+1)c]ᵀ · X[:, jc:(j+1)c] zero-padded below (the
    upper-valid gram), scale panel j is X[:, :(j+1)c] · R⁻¹[:(j+1)c, jc:(j+1)c]."""
    m, n = A.shape
    g = n // c
    live = qr_fused.live_fraction(g)

    def _chol(G):
        return _gram_chol(grid, G, cfg, m)

    def gram(X):
        cols = [
            torch.nn.functional.pad(
                X[:, :(j + 1) * c].T @ X[:, j * c:(j + 1) * c], (0, 0, 0, n - (j + 1) * c)
            )
            for j in range(g)
        ]
        return faultinject.tap(torch.cat(cols, dim=1).to(A.dtype))

    def scale(X, Rinv):
        Rt = torch.triu(Rinv)
        return torch.cat(
            [X[:, :(j + 1) * c] @ Rt[:(j + 1) * c, j * c:(j + 1) * c] for j in range(g)], dim=1
        ).to(A.dtype)

    with tracing.scope("CQR::gram"):
        tracing.emit(flops=2.0 * m * n * n * live)
        G1 = gram(A)
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R1, R1inv = _chol(G1)
    with tracing.scope("CQR::fused"):
        tracing.emit(flops=2.0 * m * n * n * (live + live))
        Q1 = scale(A, R1inv)
        G2 = gram(Q1)
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R2, R2inv = _chol(G2)
    with tracing.scope("CQR::formR"):
        tracing.emit(flops=2.0 * m * n * n * live)
        Q = scale(Q1, R2inv)
    with tracing.scope("CQR::merge"):
        tracing.emit(flops=2.0 * n**3)
        R = torch.triu(R2) @ torch.triu(R1)
    return Q, R


def _cqr2_fused_sharded(grid: Grid, A: torch.Tensor, cfg: CacqrConfig, g: int,
                        plan: str = "full"):
    """The fused CQR2 pipeline on a mesh: the same three kernels, run once
    per rank on the rank's rows (`mesh.rows`, contiguous views read in
    place):

        G1 = psum(gram_blocked(A_r));  (R1, R1⁻¹) replicated
        (Q1_r, G2_r) = scale_gram(A_r, R1⁻¹);  G2 = psum(G2_r);  (R2, R2⁻¹)
        Q_r = scale_blocked(Q1_r, R2⁻¹);  R = R2·R1

    The two psums are the pipeline's only collectives.  The factor pair of
    a summed gram is the same on every rank, so it is computed once; the
    model is priced per rank, as the JAX package's shard_map body
    emits it."""
    n = A.shape[1]
    precision = cfg.precision
    live = qr_fused.live_fraction(g)
    axes = ("x", "y", "z")
    parts = mesh.rows(grid, A)
    m_loc = parts[0].shape[0]
    comm, ncoll = tracing.allreduce_cost(grid, n, n, torch.float32, axes="all")

    def psum(vals):
        return mesh.replicated(grid, mesh.psum(grid, vals, axes)).to(A.dtype)

    with tracing.scope("CQR::gram"):
        tracing.emit(flops=2.0 * m_loc * n * n * live, comm_bytes=comm, collectives=ncoll)
        G1 = psum([qr_fused.gram_blocked(a, g=g, precision=precision) for a in parts])
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R1, R1inv = lapack.potrf_trtri_upper(G1)
    with tracing.scope("CQR::fused"):
        tracing.emit(flops=2.0 * m_loc * n * n * (live + live), comm_bytes=comm, collectives=ncoll)
        R1t = torch.triu(R1inv)
        if plan == "split":
            Q1 = [qr_fused.scale_blocked(a, R1t, g=g, precision=precision) for a in parts]
            G2u = [qr_fused.gram_blocked(q, g=g, precision=precision) for q in Q1]
        else:
            Q1, G2u = zip(*(qr_fused.scale_gram(a, R1t, g=g, precision=precision) for a in parts))
        G2 = psum(list(G2u))
    with tracing.scope("CQR::chol"):
        tracing.emit(flops=tracing.potrf_trtri_flops(n))
        R2, R2inv = lapack.potrf_trtri_upper(G2)
    with tracing.scope("CQR::formR"):
        tracing.emit(flops=2.0 * m_loc * n * n * live)
        R2t = torch.triu(R2inv)
        Q = mesh.assemble_rows(grid, [qr_fused.scale_blocked(q, R2t, g=g, precision=precision)
                                      for q in Q1])
    with tracing.scope("CQR::merge"):
        tracing.emit(flops=2.0 * n**3)
        R = torch.triu(R2) @ torch.triu(R1)
    return Q, R


def _sweep_dist(grid: Grid, A: torch.Tensor, cfg: CacqrConfig):
    """One CQR sweep, distributed regime (reference sweep_3d,
    cacqr.hpp:82-116): the gram by summa.syrk, cholinv on the gram (the
    nested cfg.cholinv), then Q = A·R⁻¹ by summa.trmm side R — or the
    blocked solve when the nested cholinv skips the top-level inverse
    block."""
    with tracing.scope("CQR::gram"):
        G = summa.syrk(grid, A, args=SyrkArgs(trans=True, precision=cfg.precision), mode=cfg.mode)
        G = faultinject.tap(G)
    with tracing.scope("CQR::chol"):
        ccfg = dataclasses.replace(cfg.cholinv, robust=None)
        R, Rinv = _chol_site(G, A.shape[0], lambda g_: cholesky.factor(grid, g_, ccfg))
    with tracing.scope("CQR::formR"):
        if cfg.cholinv.complete_inv:
            Q = summa.trmm(grid, Rinv, A, TrmmArgs(side="R", uplo="U", precision=cfg.precision),
                           mode=cfg.mode)
        else:
            Q = solve_blocked(grid, A, R, Rinv, cfg)
    return Q, R


def solve_blocked(grid: Grid, A, R, Rinv, cfg: CacqrConfig):
    """X = A·R⁻¹ from cholinv's PARTIAL inverse (complete_inv=False: only
    R11⁻¹ and R22⁻¹ are valid) — the 2x2 blocked triangular solve of
    reference cacqr.hpp:46-73:

        X1 = A1 · R11⁻¹
        X2 = (A2 − X1·R12) · R22⁻¹
    """
    n = R.shape[0]
    n1 = cholesky.top_split(n, cfg.cholinv)
    targs = TrmmArgs(side="R", uplo="U", precision=cfg.precision)
    if n1 == n:
        # one base-case window: Rinv is already the whole inverse
        return summa.trmm(grid, Rinv, A, targs, mode=cfg.mode)
    A1, A2 = A[:, :n1], A[:, n1:]
    X1 = summa.trmm(grid, Rinv[:n1, :n1], A1, targs, mode=cfg.mode)
    A2p = summa.gemm(grid, X1, R[:n1, n1:], A2,
                     GemmArgs(alpha=-1.0, beta=1.0, precision=cfg.precision), mode=cfg.mode)
    X2 = summa.trmm(grid, Rinv[n1:, n1:], A2p, targs, mode=cfg.mode)
    return torch.cat([X1, X2], dim=1)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def pallas_coupled(grid: Grid, n: int, mode: str, m: int | None = None, dtype=None) -> bool:
    """True when a 1d factor's outputs come out of the kernels (the fused
    tier, or the sweeps' trmm kernel) — mirrors the routing of
    `_factor_core`, so it changes with it.  On a mesh only the per-rank
    fused tier counts, which needs (m, dtype) to decide; without them the
    answer is False."""
    plan = None
    if m is not None and dtype is not None:
        g = qr_fused.pick_g(n)
        plan = qr_fused.fused_plan(grid, m, n, mode, g=g, dtype=dtype) if g else None
    if plan is not None:
        return plan != "panels"
    if grid.num_devices != 1 or mode != "pallas":
        return False
    return _col_blocks(n) > 1 and n // _col_blocks(n) <= 2048


def _pick_regime(grid: Grid, n: int, cfg: CacqrConfig) -> str:
    if cfg.regime not in ("1d", "dist", "auto"):
        raise ValueError(f"unknown regime {cfg.regime!r}; expected '1d', 'dist' or 'auto'")
    if cfg.regime != "auto":
        return cfg.regime
    if grid.dy == 1 and grid.c == 1:
        return "1d"
    return "1d" if n <= cfg.dist_threshold else "dist"


def _factor_core(grid: Grid, A: torch.Tensor, cfg: CacqrConfig, regime: str):
    """The regime dispatch and sweep pipeline shared by the plain and the
    robust entry (factor).  On a mesh a robust run takes the guarded sweeps
    unfused, as the JAX package must (its traced status values cannot
    leave the shard_map body) — kept so the launch plan and the results
    stay the reference's."""
    m, n = A.shape
    if regime == "dist":
        Q, R = _sweep_dist(grid, A, cfg)
        if cfg.num_iter == 2:
            Q, R2 = _sweep_dist(grid, Q, cfg)
            # R = R2 · R1: a small distributed trmm (cacqr.hpp:181-189)
            with tracing.scope("CQR::merge"):
                R = summa.trmm(grid, R2, R, TrmmArgs(side="L", uplo="U", precision=cfg.precision),
                               mode=cfg.mode)
        return Q, R
    g = qr_fused.pick_g(n, cfg.fused_g)
    plan = (
        qr_fused.fused_plan(grid, m, n, cfg.mode, g=g, dtype=A.dtype)
        if cfg.num_iter == 2 and g
        else None
    )
    if plan == "panels":
        if grid.num_devices == 1:
            return _cqr2_panels(grid, A, cfg)
    elif plan:
        if grid.num_devices == 1:
            return _cqr2_fused(grid, A, cfg, g, plan)
        if not _ROBUST:
            return _cqr2_fused_sharded(grid, A, cfg, g, plan)
    Q, R = _sweep_1d(grid, A, cfg)
    if cfg.num_iter == 2:
        Q, R2 = _sweep_1d(grid, Q, cfg)
        with tracing.scope("CQR::merge"):
            tracing.emit(flops=2.0 * R.shape[0] ** 3)
            R = torch.triu(R2) @ torch.triu(R)
    return Q, R


def _finish_robust(grid: Grid, A, Q, R, cfg: CacqrConfig, ses: _Session):
    """Aggregate the session's CholEvents into a RobustInfo and, after a
    breakdown, run the escalation ladder: the sCQR3 third sweep (muted
    gram, guarded chol, scale) when the recovered Q's orthogonality gate
    still exceeds tolerance, then — under rcfg.tsqr — the blocked
    Householder TSQR at f64 when even sCQR3 leaves the gate failing."""
    rcfg = ses.rcfg
    m, n = Q.shape[0], R.shape[0]
    dev = Q.device

    def i32(v):
        return torch.as_tensor(v, device=dev).to(torch.int32)

    def f32(v):
        return torch.as_tensor(v, device=dev).to(torch.float32)

    if ses.events:
        infos = torch.stack([i32(ev.info) for ev in ses.events])
        sigmas = torch.stack([f32(ev.sigma) for ev in ses.events])
        breakdown = i32((infos != 0).sum())
        shifted = i32((sigmas > 0).sum())
        sigma = sigmas.max()
        info = torch.stack([i32(ev.info_after) for ev in ses.events]).max()
    else:
        breakdown, shifted, sigma, info = i32(0), i32(0), f32(0.0), i32(0)
    escalated, ortho, info3, ortho_failed = i32(0), f32(-1.0), i32(0), False
    if rcfg.escalate and ses.events:
        tol = rcfg.ortho_tol
        if tol is None:
            tol = 100.0 * n * recovery.unit_roundoff(Q.dtype)
        if int(breakdown) > 0:
            with tracing.scope("CQR::recover"), tracing.muted():
                G3 = Q.T @ Q
                ortho = tsqr.gram_gate(G3)
                if float(ortho) > tol:
                    R3, R3inv, ev3 = recovery.guarded_chol(
                        G3, m, rcfg, lambda g_: lapack.potrf_trtri(g_, uplo="U")
                    )
                    Q = Q @ torch.triu(R3inv)
                    R = torch.triu(R3) @ torch.triu(R)
                    # re-measure after the third sweep: ortho reports the Q returned
                    escalated, info3, ortho = i32(1), i32(ev3.info_after), tsqr.ortho_gate(Q)
        unrecovered = int(escalated) > 0 and float(ortho) > tol
        if rcfg.tsqr:
            ct = recovery.escalation_dtype(Q.dtype)
            if unrecovered:
                with tracing.scope("CQR::recover"), tracing.muted():
                    Qt, Rt = tsqr.tsqr(A.to(ct), precision=cfg.precision)
                    ortho = tsqr.ortho_gate(Qt, cfg.precision)
                    Q, R, escalated = Qt.to(Q.dtype), Rt.to(R.dtype), i32(2)
            # recovered iff the f64-measured gate passes the f64 tolerance
            unrecovered = unrecovered and float(ortho) > 100.0 * n * recovery.unit_roundoff(ct)
        ortho_failed = unrecovered
        info = torch.maximum(torch.maximum(info, info3), i32(n + 2 if unrecovered else 0))
    if ortho_failed:
        gate = config_mod.GATE_ORTHO
    elif int(info) > 0:  # info already holds the third sweep's status
        gate = config_mod.GATE_RESIDUAL
    else:
        gate = config_mod.GATE_NONE
    return Q, R, RobustInfo(
        info=info, breakdown=breakdown, shifted=shifted, sigma=sigma,
        escalated=escalated, ortho=ortho, gate=i32(gate),
    )


def factor(grid: Grid, A: torch.Tensor, cfg: CacqrConfig = CacqrConfig()):
    """QR of tall-skinny A: (Q, R) with A = QR, R upper triangular
    (qr::cacqr::factor, cacqr.hpp:216-245).  num_iter=2 merges the sweeps'
    factors, R = R2·R1.  With cfg.robust the return is (Q, R, RobustInfo);
    RobustInfo.info != 0 means the result must not be trusted."""
    if A.dim() != 2:
        raise ValueError(f"cacqr expects a matrix, got shape {tuple(A.shape)}")
    m, n = A.shape
    if m < n:
        raise ValueError(f"cacqr expects tall-skinny input, got {tuple(A.shape)}")
    if cfg.num_iter not in (1, 2):
        raise ValueError(f"num_iter must be 1 (CQR) or 2 (CQR2), got {cfg.num_iter}")
    if A.device.type != grid.device.type:
        raise ValueError(f"A is on {A.device}, the grid on {grid.device}")
    regime = _pick_regime(grid, n, cfg)
    if cfg.robust is None:
        return _factor_core(grid, A, cfg, regime)
    ses = _Session(cfg.robust)
    _ROBUST.append(ses)
    try:
        Q, R = _factor_core(grid, A, cfg, regime)
    finally:
        _ROBUST.pop()
    return _finish_robust(grid, A, Q, R, cfg, ses)


def apply_Q(grid: Grid, Q, X, mode: str = "xla", precision: str | None = "highest"):
    """Q @ X (the reference's apply_Q, a gemm)."""
    return summa.gemm(grid, Q, X, args=GemmArgs(precision=precision), mode=mode)


def apply_QT(grid: Grid, Q, X, mode: str = "xla", precision: str | None = "highest"):
    """Qᵀ @ X (the transposed gemm)."""
    return summa.gemm(grid, Q, X, args=GemmArgs(trans_a=True, precision=precision), mode=mode)
