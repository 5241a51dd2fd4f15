"""Rank-k Cholesky update / downdate (counterpart of
capital_tpu/ops/update_small.py): online factor maintenance.

Given the upper factor R of A = RᵀR and a rank-k perturbation
A' = A ± V·Vᵀ, the factor R' of A' is reachable in O(kn²) by a sweep of
(hyperbolic) rotations instead of an O(n³/3) refactor.  Two routes:

* ``impl='pallas'`` (the reference's name; on the card the CUDA kernel of
  ops/csrc/update_small.cu) — the rotation sweep, one launch over the
  batch, a warp per problem, f32 compute.  Per rank q and column j:

      t  = v_j / R_jj
      c  = sqrt(1 + σ·t²)            σ = +1 update, −1 downdate
      R'_j,: = (R_j,: + σ·t·v) / c   (columns >= j)
      v' = (v − t·R_j,:) / c

  The kernel streams R by rows and applies up to 8 ranks to a row before
  the next (`passes`), which applies the same operations to the same
  values as the rank-major order above.  A downdate loses
  positive-definiteness where c² = 1 − t² <= 0; `info`
  follows the potrf convention (0 healthy, j + 1 at the first bad
  rotation column in rank-major order, n + 1 for a non-finite entry
  elsewhere) and the guarded divisor keeps the sweep total.

* ``impl='xla'`` — the blocked J-orthogonal panel scan in the operand's
  own dtype (the f64 route: `dtype_capable` keeps f64 off the kernel even
  under a forced 'pallas').  A host loop over row panels of width p of
  batched `torch.linalg` calls:

      M  = PᵀP + σ·PvᵀPv,  Lm = chol(M)
      R'[j:j+p, :] = Lm⁻¹ · (Pᵀ·R[j:j+p, :] + σ·Pvᵀ·Vᵀ)
      K  = I − σ·QᵀQ,  Q = Lm⁻¹·Pvᵀ,  Vᵀ' = chol(K)⁻¹ · (Vᵀ − Qᵀ·R'[j:j+p, :])

  Breakdown surfaces through chol(M) / chol(K) (`detect.factor_info` per
  panel, mapped to a global index at panel resolution).

The sweep is a wrapper, a plain version and a launch counter
(`hopper.KERNELS["up.sweep"]`), as in ops/hopper.py.  The plain version
follows the reference kernel's arithmetic, including where its one-hot
contractions spread a non-finite value (NaN·0 is NaN) and where XLA turns
a one-hot product into a select that does not (measured against the
reference in interpret mode, pinned by tests/test_torch_update.py):

* the extracted row entry c is NaN when column c of the working tile holds
  a non-finite value in a row other than j (the dead lower triangle and
  rows already rotated included); the pivot d is the extracted entry j;
* v_i is NaN when row i of V holds a non-finite value in any column; v_j
  is read as it stands;
* the mask of columns < j is a select: those entries of the new row are
  0 whatever they held;
* a non-finite row delta turns the whole column c NaN in the write-back;
* the final n + 1 test reads the whole tile before `triu`.

The row-streamed order is exact only while everything read and made is
finite: the kernel checks that as it goes and sweeps a problem that fails
a check again, in the same launch, by the resident algorithm, which keeps
a non-finite count per column of an f32 tile and per row of V to give the
same answers without the contractions.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.ops import _build, batched_small, hopper, lapack
from capital_tpu_torch.ops.batched_small import SMALL_N_MAX, dtype_capable
from capital_tpu_torch.robust import detect
from capital_tpu_torch.utils import tracing

IMPLS = ("auto", "pallas", "xla")

__all__ = [
    "IMPLS",
    "chol_update",
    "chol_downdate",
    "eligible",
    "default_impl",
    "resolve_panel",
    "dtype_capable",
    "passes",
    "problems_per_block",
    "smem_bytes",
    "sweep_route",
    "sweep",
    "sweep_plain",
]


#: problems a block of the sweep kernel's row route takes, at most (csrc
#: MAX_WARPS)
MAX_WARPS = 8
#: ranks one pass of the sweep kernel applies to a row, at most (csrc KC)
PASS_RANKS = 8
#: row groups in flight between two rank warps of the wave route (csrc
#: RING), and rows a group (csrc HOP)
RING = 4
HOP = 4
#: streaming multiprocessors of the card (H100 SXM)
SMS = 132
#: the sweep kernel's routes and their C codes (csrc Route)
ROUTES = {"row": 0, "wave": 1}
#: the largest batch the wave route takes: a block a problem, and at
#: n = 128, k = 8 it was ahead of the row route up to 528 problems and
#: behind from 1056 (H100)
WAVE_BATCH_MAX = 4 * SMS


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block of the sweep kernel for problems
    of order n, the larger of its two routes' (csrc smem_bytes): the fault
    path's f32 working tile (n, n + 1), rotated vector v (n) and two int
    counts of n each (non-finite entries per tile column and per row of
    V) — 4·(n·(n + 1) + 3n), 67,584 bytes at n = 128 — or, where larger
    (n <= 117 and 129..132), the wave route's rings (7 links of RING groups
    of HOP rows of 32·ceil(n/32) floats) and their 56 flags, which lie over
    the tile.  The fast paths keep a
    problem in registers; a block's problems that fail a finiteness check
    take the tile in turn.  V streams one column per rank, so k does not
    enter."""
    tile = n * (n + 1) + 3 * n
    rings = (PASS_RANKS - 1) * RING * HOP * 32 * -(-n // 32) + 2 * (PASS_RANKS - 1) * RING
    return 4 * max(tile, rings)


def eligible(n: int, k: int, dtype, *, interpret: bool) -> bool:
    """Whether the sweep kernel takes ONE problem of order n at rank k: the
    fault path's working set (`smem_bytes`) must fit one block's shared
    memory, 232,448 bytes less a 1,024-byte reserve (n up to 238 at any k
    and dtype; the fast path's registers would hold 256).
    interpret=True (the operands lie on the CPU) answers True: the plain
    version has no envelope, as the JAX kernel in interpret mode has
    none."""
    del k, dtype  # V streams; the tile is f32 whatever the storage dtype
    if interpret:
        return True
    return smem_bytes(n) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE


def sweep_route(batch: int, k: int) -> str:
    """The sweep kernel's route for a call: 'wave' (a block a problem, a
    warp a rank: a pass is a chain of about n + 8 steps) for k >= 2 at
    batches up to WAVE_BATCH_MAX = 528, else 'row' (a warp a problem, the
    throughput route; k = 1 has no ranks to pipeline)."""
    return "wave" if k >= 2 and batch <= WAVE_BATCH_MAX else "row"


def passes(k: int, route: str = "row") -> list[int]:
    """The ranks of each pass of the sweep kernel over R (csrc): on the row
    route passes of PASS_RANKS, then the remainder's 4, 2 and 1 in that
    order (k = 0: one pass that copies and checks); on the wave route
    passes of PASS_RANKS and the remainder whole."""
    if route == "wave":
        return [min(PASS_RANKS, k - q0) for q0 in range(0, k, PASS_RANKS)]
    if k == 0:
        return [0]
    out = [PASS_RANKS] * (k // PASS_RANKS)
    return out + [w for w in (4, 2, 1) if (k % PASS_RANKS) & w]


def problems_per_block(batch: int) -> int:
    """Warps (problems) a block of the row route: enough blocks to give
    every SM one before a block takes two problems, at most MAX_WARPS
    (the throughput batch runs eight problems a block)."""
    return max(1, min(MAX_WARPS, -(-batch // SMS)))


def default_impl(n: int, k: int, dtype, *, interpret: bool) -> str:
    """Resolve impl='auto': 'pallas' (the sweep kernel) at n <= SMALL_N_MAX
    in bf16 or f32 within the envelope, else 'xla'.  f64 always takes xla
    (`dtype_capable`).  Every n <= 128 bucket is eligible, so 'auto'
    resolves as the JAX package does there."""
    if not dtype_capable(dtype):
        return "xla"
    if n > SMALL_N_MAX:
        return "xla"
    return "pallas" if eligible(n, k, dtype, interpret=interpret) else "xla"


def resolve_panel(n: int, k: int, panel: int = 0) -> int:
    """Panel width of the panel scan: ~2k rows, clamped to [4, 64] and
    decremented to the nearest divisor of n so the scan is rectangular."""
    p = min(panel or max(4, min(64, 2 * k)), n)
    while n % p:
        p -= 1
    return max(p, 1)


def _check_update(R, V, op):
    if R.ndim != 3 or R.shape[1] != R.shape[2]:
        raise ValueError(
            f"{op}: factor batch must be (batch, n, n), got {R.shape}")
    if V.ndim != 3 or V.shape[:2] != R.shape[:2]:
        raise ValueError(
            f"{op}: rank-k batch must be (batch, n, k) riding factor "
            f"{R.shape}, got {V.shape}")


def _resolve_impl(impl: str, dtype, n: int, k: int, interpret: bool) -> str:
    if impl not in IMPLS:
        raise ValueError(f"update impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return default_impl(n, k, dtype, interpret=interpret)
    if impl == "pallas" and not dtype_capable(dtype):
        # the kernel computes in f32: a forced 'pallas' on f64 would
        # downgrade the precision the caller asked for
        return "xla"
    return impl


def _check_sweep(R, V):
    _check_update(R, V, "rotation sweep")
    for t in (R, V):
        if not dtype_capable(t.dtype):
            raise TypeError(
                f"rotation sweep: takes bf16 or f32, got {t.dtype} (the kernel "
                "computes in f32; f64 takes the panel scan)")
    if R.dtype != V.dtype:
        raise TypeError(f"rotation sweep: R and V of one dtype, got {R.dtype} and {V.dtype}")


# --------------------------------------------------------------------------
# the rotation sweep: plain version and wrapper
# --------------------------------------------------------------------------


def sweep_plain(R, V, sign: float, *, block: int = 0, precision=None):
    """Plain PyTorch version of `sweep`: the reference kernel's recurrence,
    a Python loop over ranks and columns of batched f32 tensor ops, with
    the one-hot contractions' NaN spread written out through non-finite
    counts (module docstring).  Returns (R', info)."""
    del precision  # f32 is IEEE f32 here
    _check_sweep(R, V)
    batched_small._resolve_block(R.shape[-1], block)  # validated, changes nothing
    batch, n, _ = R.shape
    k = V.shape[-1]
    s = float(sign)
    Rc = R.float().clone()
    Vm = V.float()
    dev = Rc.device
    nan = float("nan")
    after = torch.ones((n, n), dtype=torch.bool, device=dev).triu()  # row j: columns >= j
    offrow = ~torch.eye(n, dtype=torch.bool, device=dev)  # row j: rows != j
    goods = torch.ones((batch, k * n + 1), dtype=torch.bool, device=dev)  # + a good sentinel
    colcnt = (~torch.isfinite(Rc)).sum(1)  # non-finite entries per tile column
    vrow = (~torch.isfinite(Vm)).sum(-1)  # per row of V
    for q in range(k):
        x = Vm[:, :, q]
        v = x.masked_fill(vrow > ~torch.isfinite(x), nan)
        for j in range(n):
            row = Rc[:, j, :]
            row_nf = ~torch.isfinite(row)
            # R[j, :] through the one-hot: NaN where the column is bad elsewhere
            rrow = row.masked_fill(colcnt > row_nf, nan)
            d, vj = rrow[:, j], v[:, j]
            fd = torch.isfinite(d)
            t = vj / torch.where((d != 0) & fd, d, 1.0)
            st = s * t
            c2 = 1.0 + st * t
            good = fd & (d > 0) & torch.isfinite(c2) & (c2 > 0)
            goods[:, q * n + j] = good
            cinv = 1.0 / torch.sqrt(torch.where(good, c2, 1.0))
            newrow = torch.where(after[j], (rrow + st[:, None] * v) * cinv[:, None], 0.0)
            v = (v - t[:, None] * rrow) * cinv[:, None]
            delta = newrow - rrow
            new = row + delta
            Rc[:, j, :] = new
            spread = ~torch.isfinite(delta)  # the write-back's 0·delta is NaN
            colcnt = torch.where(spread, n - 1, colcnt - row_nf.long()) + ~torch.isfinite(new)
            Rc.masked_fill_(spread[:, None, :] & offrow[j][None, :, None], nan)
    # info: the column of the first bad step (rank-major order), else n + 1
    # for a non-finite entry anywhere in the tile
    bad = ~goods
    first = torch.argmax(bad.to(torch.int32), dim=1) % n + 1
    info = torch.where(bad.any(1), first, 0)
    off_bad = ~torch.isfinite(Rc).all(-1).all(-1)
    info = torch.where((info == 0) & off_bad, n + 1, info).to(torch.int32)
    return torch.triu(Rc).to(R.dtype), info


def sweep(R, V, sign: float, *, block: int = 0, precision: str | None = "highest"):
    """The rotation sweep over a (batch, n, n) upper factor and a
    (batch, n, k) rank-k panel, σ = `sign` (+1 update, −1 downdate): one
    launch (ops/csrc/update_small.cu) on the route `sweep_route` picks —
    'row': a warp per problem (`problems_per_block` a block); 'wave': a
    block per problem, a warp per rank, rows passed from rank to rank —
    R streamed by rows with up to 8 ranks applied to a row (`passes`), V
    in registers, tallied by route in `hopper.route_counts()`; a problem
    whose operands or intermediates are not all finite is swept again in
    the same launch by the resident algorithm, from its inputs.  Between
    passes R stays in f32: in the output for f32, in an f32 scratch for
    bf16.  Returns (R', info): R' upper at R's dtype (the strict lower
    triangle exactly zero), info (batch,) int32."""
    _check_sweep(R, V)
    batched_small._resolve_block(R.shape[-1], block)
    batch, n, _ = R.shape
    k = V.shape[-1]
    if not hopper._on_card(R, V):
        return sweep_plain(R, V, sign)
    need, have = smem_bytes(n), hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    if need > have:
        raise ValueError(
            f"rotation sweep: one problem of order {n} needs {need} bytes of shared "
            f"memory, a block has {have}")
    R, V = R.contiguous(), V.contiguous()
    out = torch.empty_like(R)
    info = torch.empty(batch, dtype=torch.int32, device=R.device)
    if batch:
        route = sweep_route(batch, k)
        rc = _sweep_launch(R, V, out, info, sign, route, problems_per_block(batch))
        hopper._launched(rc, hopper.KERNELS["up.sweep"], route)
    return out, info


def _sweep_launch(R, V, out, info, sign: float, route: str, warps: int) -> int:
    """One launch of the sweep kernel's C entry on `route` (uncounted); the
    f32 scratch for bf16 R between passes.  Returns the entry's code."""
    batch, n, _ = R.shape
    k = V.shape[-1]
    work = None
    if R.dtype == torch.bfloat16 and len(passes(k, route)) > 1:
        work = torch.empty((batch, n, n), dtype=torch.float32, device=R.device)
    return _build.entry("capital_up_sweep")(
        hopper._DTYPE_CODE[R.dtype], R.data_ptr(), V.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), info.data_ptr(), batch, n, k, ROUTES[route], warps,
        float(sign), hopper._stream())


# --------------------------------------------------------------------------
# the blocked J-orthogonal panel scan (exact dtype: the f64 route)
# --------------------------------------------------------------------------


def _tri_lsolve(L, B):
    """Batched lower-triangular left solve L·X = B (the >= f32 compute
    dtype, cast back once)."""
    ct = lapack._compute_dtype(B.dtype)
    X = torch.linalg.solve_triangular(L.to(ct), B.to(ct), upper=False)
    return X.to(B.dtype)


def _chol(M):
    """`jnp.linalg.cholesky` of a stack: symmetrised input, the reference's
    breakdown pattern (`lapack.cholesky_lower`)."""
    ct = lapack._compute_dtype(M.dtype)
    return lapack.cholesky_lower(M.to(ct), symmetrize=True).to(M.dtype)


def _xla_panel_scan(R, V, sign: float, *, panel):
    batch, n, _ = R.shape
    k = V.shape[-1]
    p = resolve_panel(n, k, panel)
    Vt = V.mT  # (batch, k, n)
    eye_k = torch.eye(k, dtype=R.dtype, device=R.device)
    rows, Lms, Lks = [], [], []
    # panel i's rows are untouched until the scan reaches it: each rotation
    # modifies only the current row and v
    for j0 in range(0, n, p):
        rp = R[:, j0:j0 + p, :]
        Pp = rp[:, :, j0:j0 + p]
        Pv = Vt[:, :, j0:j0 + p]
        Lm = _chol(Pp.mT @ Pp + sign * (Pv.mT @ Pv))
        newrows = _tri_lsolve(Lm, Pp.mT @ rp + sign * (Pv.mT @ Vt))
        # with Q = Lm⁻¹Pvᵀ: K = I − σ·PvM⁻¹Pvᵀ = I − σ·QᵀQ and the carry
        # correction Pv·M⁻¹·Z = Qᵀ·newrows (Lm reused, no second factor)
        Q = _tri_lsolve(Lm, Pv.mT)
        Lk = _chol(eye_k - sign * (Q.mT @ Q))
        Vt = _tri_lsolve(Lk, Vt - Q.mT @ newrows)
        rows.append(newrows), Lms.append(Lm), Lks.append(Lk)
    # the per-panel info in one pass over the stacked factors (a host loop
    # pays per launch): chol(M)'s local pivot maps to the global column
    # j0 + li, a chol(K) failure implicates the panel's first column, and
    # the first failing panel wins
    li = detect.factor_info(torch.stack(Lms))  # (npan, batch)
    ki = detect.factor_info(torch.stack(Lks))
    j0 = torch.arange(0, n, p, device=R.device)[:, None]
    gi = torch.where(li == 0, 0, torch.where(li <= p, j0 + li, n + 1))
    gi = torch.where((gi == 0) & (ki != 0), j0 + 1, gi)
    hit = gi != 0
    first = gi.gather(0, torch.argmax(hit.to(torch.int32), dim=0)[None])[0]
    R2 = torch.triu(torch.cat(rows, dim=1))
    off_bad = ~torch.isfinite(R2).all(-1).all(-1)
    info = torch.where(hit.any(0), first, torch.where(off_bad, n + 1, 0))
    return R2, info.to(torch.int32)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def _apply(R, V, sign: float, tag: str, op: str, *, block, panel, precision, impl):
    _check_update(R, V, op)
    batch, n, _ = R.shape
    k = V.shape[-1]
    impl = _resolve_impl(impl, R.dtype, n, k, interpret=not hopper._on_card(R, V))
    with tracing.scope(tag):
        tracing.emit(flops=batch * tracing.chol_update_flops(n, k))
        if impl == "pallas":
            return sweep(R, V, sign, block=block, precision=precision)
        return _xla_panel_scan(R, V, sign, panel=panel)


def chol_update(R, V, *, block: int = 0, panel: int = 0,
                precision: str | None = "highest", impl: str = "auto"):
    """Rank-k Cholesky UPDATE: given upper R with A = RᵀR, return
    (R', info) with R'ᵀR' = A + V·Vᵀ.  R (batch, n, n) upper, V
    (batch, n, k).  info (batch,) int32, potrf convention — an update of
    a healthy factor cannot break down, so nonzero info means the input
    factor was already bad."""
    return _apply(R, V, +1.0, "UP::update", "chol_update", block=block,
                  panel=panel, precision=precision, impl=impl)


def chol_downdate(R, V, *, block: int = 0, panel: int = 0,
                  precision: str | None = "highest", impl: str = "auto"):
    """Rank-k Cholesky DOWNDATE: (R', info) with R'ᵀR' = A − V·Vᵀ.  When
    A − V·Vᵀ is not SPD, info flags the first bad rotation column (sweep)
    or panel pivot (panel scan) and R' is garbage from there on."""
    return _apply(R, V, -1.0, "UP::downdate", "chol_downdate", block=block,
                  panel=panel, precision=precision, impl=impl)
