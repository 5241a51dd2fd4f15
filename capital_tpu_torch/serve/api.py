"""The served solves: posv / lstsq / inv and the block-tridiagonal
posv_blocktri / posv_arrowhead, batched and single-problem (counterpart of
capital_tpu/serve/api.py).

* **batched** — the whole bucket batch in one program, behind the `impl`
  switch (batched_small.IMPLS, the ServeConfig.small_n_impl vocabulary):

  - ``vmap`` — the pure-library route: the reference's vmap over the
    per-problem LAPACK seam becomes a batch axis written out over
    ops/lapack (batched `torch.linalg`):

        posv   potrf(A) + the two triangular sweeps of potrs
        lstsq  CholeskyQR2 on the gram + triangular solve
        inv    potrf_trtri + R⁻¹·R⁻ᵀ

  - ``pallas`` — the batched-grid kernels of ops/batched_small (the names
    are the config vocabulary; on the card they are the CUDA kernels): one
    fused launch per bucket batch (posv, lstsq).  ``pallas_split`` runs the
    factor and the solve as two launches (potrf + potrs); lstsq has no
    split form and takes the fused kernel.  ``auto`` resolves per bucket
    from the batch shapes (batched_small.default_impl: pallas for posv /
    lstsq at n <= SMALL_N_MAX within the envelope, else vmap).

    inv rides the posv kernel against the identity RHS (the serve contract
    guarantees an SPD operand); its auto resolution asks posv's question
    with k = n.

  f64 buckets always take vmap, even under a forced impl: the kernels
  compute in f32.  Every batched program returns (X, info), info the
  per-problem int32 potrf status (0 / j / n+1).

  posv_blocktri and posv_arrowhead run models/blocktri.posv (and
  models/arrowhead.posv) on the unpacked chain; the impl vocabulary maps
  onto blocktri's: 'vmap' is the library route 'xla', 'pallas_split' is
  'pallas' (the chain has no split form), and `blocktri_impl`
  (ServeConfig.blocktri_impl) picks the algorithm: 'partitioned' forces
  the Spike driver, 'scan' pins the sequential loop, 'auto' leaves the
  choice to blocktri.  posv_arrowhead returns (X_chain, X_corner, info).

  chol_update / chol_downdate run ops/update_small on (resident factor,
  rank-k panel) batches and return (R', info); 'vmap' is its panel scan,
  'pallas' / 'pallas_split' its sweep kernel (f64 always the panel scan).

  The factor-residency and session programs run against a resident
  factor that the engine composes into the batch: posv_cached is potrs
  alone (info ≡ 0); its miss program posv_cached_miss is potrf + potrs
  with three outputs (X, R, info) so landing can install R;
  blocktri_extend and session_extend extend a chain from its resident
  carry (models/blocktri.extend), returning the stacked [L; Wt];
  session_solve runs both block sweeps against the resident (L, Wt) of
  the 4-stack [D; C; L; Wt] (info ≡ 0).

  `tier` (robust/refine.TIERS) reaches posv, lstsq, posv_blocktri and
  session_solve: 'fast' runs the program with the factor dtype one notch
  down and casts the answer back; 'guaranteed' runs the refinement program
  (`_batched_refine`), five outputs (X, iters, converged, resid, info);
  session_solve's refines against its resident factor (refine's
  ``factor=`` seam).

* **single** — a request beyond every ladder runs unbatched through the
  models: cholesky.solve, qr.factor + apply_QT + a triangular solve,
  cholesky.factor + summa.gemm, and the chain ops as a batch of one.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.models import arrowhead, blocktri, cholesky, qr
from capital_tpu_torch.ops import batched_small, blocktri_small, lapack, update_small
from capital_tpu_torch.parallel import summa
from capital_tpu_torch.robust import refine
from capital_tpu_torch.serve import batching
from capital_tpu_torch.utils import tracing


def _tri_solve_upper(R, B, precision):
    """R·X = B for upper-triangular R (or a stack) at the >= f32 compute
    dtype."""
    del precision  # a triangular solve has no precision knob
    ct = lapack._compute_dtype(R.dtype)
    X = torch.linalg.solve_triangular(R.to(ct), B.to(ct), upper=True)
    return X.to(B.dtype)


def _one_posv(precision):
    def f(a, b):
        with tracing.scope("serve::solve"):
            R, info = lapack.potrf(a, uplo="U", with_info=True)
            return lapack.potrs(R, b, uplo="U"), info

    return f


def _one_lstsq(precision):
    def f(a, b):
        with tracing.scope("serve::solve"):
            # CQR2 (models/qr.py single-problem form): two gram-Cholesky
            # sweeps; Q = A·R1⁻¹·R2⁻¹, R = R2·R1; then solve R·X = QᵀB.
            g = a.mT @ a
            r1, r1i, i1 = lapack.potrf_trtri(g, uplo="U", with_info=True)
            q1 = a @ torch.triu(r1i)
            g2 = q1.mT @ q1
            r2, r2i, i2 = lapack.potrf_trtri(g2, uplo="U", with_info=True)
            R = torch.triu(r2) @ torch.triu(r1)
            qtb = torch.triu(r2i).mT @ (q1.mT @ b)
            return _tri_solve_upper(R, qtb, precision), torch.maximum(i1, i2)

    return f


def _one_inv(precision):
    def f(a):
        with tracing.scope("serve::solve"):
            _, rinv, info = lapack.potrf_trtri(a, uplo="U", with_info=True)
            tri = torch.triu(rinv)
            return tri @ tri.mT, info

    return f


def _batched_vmap(op: str, precision):
    """The library batch program: correctness reference and the f64 route.
    The per-problem functions above take a stack as they stand."""
    if op == "inv":
        return _one_inv(precision)
    return {"posv": _one_posv, "lstsq": _one_lstsq}[op](precision)


def _batched_pallas(op: str, precision, split: bool):
    """The batched-grid route: the whole bucket batch in one (fused) or two
    (split) kernel launches.  `_dense_route` sends the dtypes the kernels
    cannot take (f64) to the library program instead."""
    if op == "inv":
        def kernel(a):
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
            if split:
                R, info = batched_small.potrf(a, uplo="U", precision=precision)
                return batched_small.potrs(R, eye, uplo="U", precision=precision), info
            return batched_small.posv(a, eye, uplo="U", precision=precision)

        return kernel
    if op == "lstsq":
        def kernel(a, b):
            return batched_small.lstsq(a, b, precision=precision)
    elif split:
        def kernel(a, b):
            R, info = batched_small.potrf(a, uplo="U", precision=precision)
            return batched_small.potrs(R, b, uplo="U", precision=precision), info
    else:
        def kernel(a, b):
            return batched_small.posv(a, b, uplo="U", precision=precision)

    return kernel


def _dense_route(op: str, impl: str, kernel_f, library_f):
    """The route rule of every program at the dense geometry: 'vmap' is the
    library program; 'pallas' / 'pallas_split' the kernels, save for a
    dtype they cannot take (f64), which takes the library program; 'auto'
    asks batched_small.default_impl(op) at the batch shapes (inv asks
    posv's question with b's shape a's; the residency programs ask
    posv's)."""
    if impl == "vmap":
        return library_f

    def f(a, *b):
        if impl == "auto":
            rhs = (b[0] if b else a).shape
            use = batched_small.default_impl(op, a.shape, rhs, a.dtype,
                                             interpret=_host_side(a)) != "vmap"
        else:
            use = batched_small.dtype_capable(a.dtype)
        return kernel_f(a, *b) if use else library_f(a, *b)

    return f


def _host_side(a) -> bool:
    """The envelope question is the card's only for CUDA operands (the
    plain versions have none)."""
    return a.device.type != "cuda"


#: serve-wide impl vocabulary -> the two-impl modules' own ('vmap' is the
#: library route; neither the update sweep nor the chain has a split form)
_TWO_IMPL_MAP = {"auto": "auto", "pallas": "pallas", "pallas_split": "pallas", "vmap": "xla"}


def _check_algorithm(blocktri_impl: str) -> None:
    if blocktri_impl not in blocktri.ALGORITHMS:
        raise ValueError(
            f"unknown blocktri_impl {blocktri_impl!r}: expected one of {blocktri.ALGORITHMS}")


def _chain_algorithm(mapped: str, blocktri_impl: str, partitions: int, a, k: int) -> dict:
    """The chain solve's algorithm keywords for one bucket (A the chain
    pack, k the chain solve's RHS width): the partitioned driver with
    `mapped` inside; the sequential scan with the kernel picked per bucket
    when both are left to 'auto' on the scan; else `mapped` as posv's impl."""
    if blocktri_impl == "partitioned":
        return dict(impl="partitioned", partitions=partitions, partition_inner=mapped)
    if blocktri_impl == "scan" and mapped == "auto":
        nblocks, bs = a.shape[2], a.shape[3]
        return dict(impl=blocktri_small.default_impl(bs, k, blocktri.resolve_seg(nblocks), a.dtype,
                                                     interpret=_host_side(a)))
    return dict(impl=mapped, partitions=partitions)


def _batched_blocktri(precision, impl: str, blocktri_impl: str = "auto", partitions: int = 0):
    """The block-tridiagonal bucket program: unpack the (batch, 2, nblocks,
    b, b) chain pack (A[:, 0] diagonal blocks, A[:, 1] sub-diagonal ones)
    and run blocktri.posv (`_chain_algorithm` maps impl and algorithm)."""
    mapped = _TWO_IMPL_MAP[impl]
    _check_algorithm(blocktri_impl)

    def f(a, b):
        kw = _chain_algorithm(mapped, blocktri_impl, partitions, a, b.shape[-1])
        return blocktri.posv(a[:, 0], a[:, 1], b, precision=precision, **kw)

    return f


def _batched_arrowhead(precision, impl: str, blocktri_impl: str = "auto", partitions: int = 0):
    """The block-arrowhead bucket program: the chain pack A like
    posv_blocktri's plus the packed tail operand B = (batch, nblocks·b + s,
    s + k) (models/arrowhead.pack).  Three outputs (X_chain, X_corner,
    info): the chain half stays blocked (batch, nblocks, b, k) so
    `batching.crop` unpads it by slicing.  The impl and algorithm maps are
    `_batched_blocktri`'s; they reach the one widened chain solve (k + s
    columns)."""
    mapped = _TWO_IMPL_MAP[impl]
    _check_algorithm(blocktri_impl)

    def f(a, b):
        F, S, B, Bs = arrowhead.unpack(b, a.shape[2], a.shape[3])
        kw = _chain_algorithm(mapped, blocktri_impl, partitions, a, B.shape[-1] + F.shape[2])
        return arrowhead.posv(a[:, 0], a[:, 1], F, S, B, Bs, precision=precision, **kw)

    return f


def _batched_update(op: str, precision, impl: str):
    """chol_update / chol_downdate bucket program: (factor batch, rank-k
    panel batch) -> (R', info); update_small resolves the route (f64
    always the panel scan)."""
    mapped = _TWO_IMPL_MAP[impl]
    fn = update_small.chol_update if op == "chol_update" else update_small.chol_downdate

    def f(r, v):
        return fn(r, v, precision=precision, impl=mapped)

    return f


def _batched_posv_cached(precision, impl: str):
    """Solve against a resident factor: (R, B) -> (X, info ≡ 0).  No
    factorization happens (landing installs only healthy factors), so the
    program is potrs alone."""

    def zero(r):
        return torch.zeros(r.shape[0], dtype=torch.int32, device=r.device)

    def pallas_f(r, b):
        return batched_small.potrs(r, b, uplo="U", precision=precision), zero(r)

    def vmap_f(r, b):
        with tracing.scope("serve::solve"):
            X = lapack.potrs(r, b, uplo="U")
        return X, zero(r)

    return _dense_route("posv", impl, pallas_f, vmap_f)


def _batched_posv_cached_miss(precision, impl: str):
    """The residency-miss (seeding) program: full (A, B) operands, three
    outputs (X, R, info) so landing can install the fresh factor under the
    request's token."""

    def pallas_f(a, b):
        R, info = batched_small.potrf(a, uplo="U", precision=precision)
        return batched_small.potrs(R, b, uplo="U", precision=precision), R, info

    def vmap_f(a, b):
        with tracing.scope("serve::solve"):
            R, info = lapack.potrf(a, uplo="U", with_info=True)
            return lapack.potrs(R, b, uplo="U"), R, info

    return _dense_route("posv", impl, pallas_f, vmap_f)


def _batched_extend(precision, impl: str):
    """The chain-extension program: (appended chain pack (batch, 2,
    nblocks, b, b), resident carry (batch, b, b)) -> (stacked [L; Wt]
    (batch, 2, nblocks, b, b), info).  C[:, 0] arrives live (the engine
    zeroes it for a fresh token's seed, so one program serves both)."""
    mapped = _TWO_IMPL_MAP[impl]

    def f(a, carry):
        L, Wt, info = blocktri.extend(a[:, 0], a[:, 1], carry, precision=precision, impl=mapped)
        return torch.stack([L, Wt], dim=1), info

    return f


def _batched_session_extend(precision, impl: str):
    """The session open / append program: `_batched_extend` (the engine
    seeds an identity carry and zeroes C[:, 0] for an open), the chain
    work priced once under SS::extend."""
    extend = _batched_extend(precision, impl)

    def f(a, carry):
        with tracing.scope("SS::extend"):
            tracing.emit(flops=a.shape[0] * tracing.blocktri_chol_flops(a.shape[2], a.shape[3]))
            with tracing.muted():
                return extend(a, carry)

    return f


def _batched_session_solve(precision, impl: str):
    """The resident-factor session solve: the 4-stack A = (batch, 4,
    nblocks, b, b) = [D; C; L; Wt] carries the window (for the guaranteed
    tier's residual) and the resident factor; the balanced program reads
    the factor half only — both block sweeps, info ≡ 0."""
    mapped = _TWO_IMPL_MAP[impl]

    def f(a, b):
        nblocks, bs = a.shape[2], a.shape[3]
        with tracing.scope("SS::solve"):
            tracing.emit(flops=a.shape[0] * 2 * tracing.blocktri_solve_flops(nblocks, bs, b.shape[-1]))
            with tracing.muted():
                X = blocktri.solve(a[:, 2], a[:, 3], b, precision=precision, impl=mapped)
        return X, torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)

    return f


def _batched_refine(op: str, precision, impl: str, tier: str):
    """The guaranteed-tier bucket program: mixed-precision iterative
    refinement (robust/refine) over the solve, five outputs (X, iters,
    converged, resid, info).  The dtypes resolve from the operand dtype
    alone (`refine.plan`).  session_solve refines against the resident
    (L, Wt) of its 4-stack, cast to the plan's factor dtype (refine's
    ``factor=`` seam): the window half drives the residual and nothing is
    refactored."""

    def f(a, b):
        p = refine.plan(tier, a.dtype)
        kw = dict(factor_dtype=p.factor_dtype, correction_dtype=p.correction_dtype,
                  max_iters=p.max_iters, impl=impl, precision=precision)
        if op == "posv":
            X, info, ri = refine.posv(a, b, **kw)
        elif op == "lstsq":
            X, info, ri = refine.lstsq(a, b, **kw)
        elif op == "session_solve":
            X, info, ri = refine.posv_blocktri(
                a[:, 0], a[:, 1], b,
                factor=(a[:, 2].to(p.factor_dtype), a[:, 3].to(p.factor_dtype)), **kw)
        else:  # posv_blocktri (bucket packing: a[:, 0] = D, a[:, 1] = C)
            X, info, ri = refine.posv_blocktri(a[:, 0], a[:, 1], b, **kw)
        return X, ri.iters, ri.converged, ri.resid, info

    return f


#: the ops the accuracy-tier vocabulary applies to (session_solve's
#: guaranteed tier refines against the resident factor); every other op
#: refuses a tier other than 'balanced'
TIER_OPS = ("posv", "lstsq", "posv_blocktri", "session_solve")


def batched(op: str, precision: str | None = "highest",
            impl: str = "auto", *, blocktri_impl: str = "auto",
            blocktri_partitions: int = 0, tier: str = "balanced"):
    """The program for one bucket: maps the fixed (capacity, *problem)
    batch through the solve, returning (X, info) stacks.  `impl` picks the
    batch program ('vmap', 'pallas', 'pallas_split' or 'auto', resolved per
    bucket from the batch shapes); `blocktri_impl` / `blocktri_partitions`
    reach only the chain programs.  `tier` ('balanced', 'fast' or
    'guaranteed', TIER_OPS only): 'fast' runs the program at the factor
    dtype one notch down (no refinement) and casts X back to the request's
    dtype; 'guaranteed' returns the five-output refinement program."""
    if impl not in batched_small.IMPLS:
        raise ValueError(
            f"unknown batched impl {impl!r}: expected one of "
            f"{batched_small.IMPLS}"
        )
    batching.check_op(op)
    if tier != "balanced":
        batching._check_tier(tier)
        if op not in TIER_OPS:
            raise ValueError(
                f"accuracy_tier={tier!r} applies only to {TIER_OPS}; "
                f"op {op!r} serves the balanced program only")
        if tier == "guaranteed":
            return _batched_refine(op, precision, impl, tier)
        inner = batched(op, precision, impl, blocktri_impl=blocktri_impl,
                        blocktri_partitions=blocktri_partitions)

        def fast(a, b):
            fd = refine.plan("fast", a.dtype).factor_dtype
            X, info = inner(a.to(fd), b.to(fd))
            return X.to(a.dtype), info

        return fast
    if op in batching.UPDATE_OPS:
        return _batched_update(op, precision, impl)
    if op == "posv_cached":
        return _batched_posv_cached(precision, impl)
    if op == "posv_cached_miss":
        return _batched_posv_cached_miss(precision, impl)
    if op == "blocktri_extend":
        return _batched_extend(precision, impl)
    if op == "session_extend":
        return _batched_session_extend(precision, impl)
    if op == "session_solve":
        return _batched_session_solve(precision, impl)
    if op == "posv_blocktri":
        return _batched_blocktri(precision, impl, blocktri_impl, blocktri_partitions)
    if op == "posv_arrowhead":
        return _batched_arrowhead(precision, impl, blocktri_impl, blocktri_partitions)
    return _dense_route("posv" if op == "inv" else op, impl,
                        _batched_pallas(op, precision, split=(impl == "pallas_split")),
                        _batched_vmap(op, precision))


def single(op: str, grid, precision: str | None = "highest", robust=None,
           tail_fuse_depth: int = 0):
    """The oversize route: one exact-shape problem through the models on
    `grid`.  Returns (X, info): info is a scalar int32 (posv/inv) or a
    RobustInfo (lstsq under robust); int32 0 when robust is None."""

    def zero():
        return torch.zeros((), dtype=torch.int32, device=grid.device)

    if op == "posv":
        ccfg = cholesky.CholinvConfig(precision=precision, robust=robust,
                                      tail_fuse_depth=tail_fuse_depth)

        def f(a, b):
            out = cholesky.solve(grid, a, b, ccfg)
            return out if robust is not None else (out, zero())

        return f
    if op == "lstsq":
        qcfg = qr.CacqrConfig(
            precision=precision, robust=robust,
            cholinv=cholesky.CholinvConfig(precision=precision,
                                           tail_fuse_depth=tail_fuse_depth),
        )

        def f(a, b):
            out = qr.factor(grid, a, qcfg)
            if robust is not None:
                Q, R, rinfo = out
            else:
                (Q, R), rinfo = out, zero()
            qtb = qr.apply_QT(grid, Q, b, precision=precision)
            return _tri_solve_upper(R, qtb, precision), rinfo

        return f
    if op == "inv":
        ccfg = cholesky.CholinvConfig(precision=precision, robust=robust,
                                      tail_fuse_depth=tail_fuse_depth)

        def f(a):
            if robust is not None:
                _, rinv, info = cholesky.factor(grid, a, ccfg)
            else:
                _, rinv = cholesky.factor(grid, a, ccfg)
                info = zero()
            ainv = summa.gemm(
                grid, rinv, rinv,
                args=summa.GemmArgs(trans_b=True, precision=precision),
                mode=ccfg.mode,
            )
            return ainv, info

        return f
    if op == "posv_blocktri":
        # a batch of one through the models' dispatch: 'auto' picks the
        # partitioned driver from PARTITION_MIN_NBLOCKS on, where oversize
        # chains live (`grid` is taken for a uniform signature)
        def f(a, b):
            X, info = blocktri.posv(a[None, 0], a[None, 1], b[None], precision=precision)
            return X[0], (info[0] if robust is not None else zero())

        return f
    if op == "posv_arrowhead":
        # a batch of one; the flat (nblocks·b + s, k) solution is assembled
        # here (the single route has no second output)
        def f(a, b):
            nblocks, bs = a.shape[1], a.shape[2]
            F, S, B, Bs = arrowhead.unpack(b[None], nblocks, bs)
            X, Xs, info = arrowhead.posv(a[None, 0], a[None, 1], F, S, B, Bs,
                                         precision=precision)
            flat = torch.cat([X[0].reshape(nblocks * bs, X.shape[-1]), Xs[0]], dim=0)
            return flat, (info[0] if robust is not None else zero())

        return f
    raise ValueError(f"unknown serve op {op!r}")
