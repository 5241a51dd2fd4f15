"""Mixed-precision iterative refinement (counterpart of
capital_tpu/robust/refine.py): correction-dtype answers at factor-dtype
throughput.

Factor once at a low dtype, then iterate

    r = B − A·X          (residual at the correction dtype, IR::residual)
    d = solve(factor, r) (correction against the factor, IR::correct)
    X = X + d

Each sweep contracts the error by about cond(A)·u_factor, so inside the
factor dtype's envelope a few sweeps reach the correction dtype's backward
error.  Per problem the loop tests the normwise backward error
‖r‖ / (‖A‖·‖X‖ + ‖B‖) against a dtype-derived tolerance, and a problem
freezes the moment it converges, stops improving (its error not halved) or
reaches the cap.

The loop is `max_iters` masked sweeps with the freeze mask kept on the
device: no host sync, so a CUDA graph can capture it.  A sweep in which no
problem is active changes none of X, r, e, prev or iters, so the result is
exactly the reference's `lax.while_loop`'s; the cost is `max_iters`
corrections on every call, whatever the convergence.

Three drivers, all batched (leading batch axis, the serve bucket layout):

* ``posv`` — dense SPD: the factor on ops/batched_small's kernels (n <= 128
  at bf16 / f32) or the library route, corrections two triangular sweeps.
* ``lstsq`` — least squares through the gram's Cholesky factor R and
  semi-normal corrections d = R⁻¹R⁻ᵀ·Aᵀr.
* ``posv_blocktri`` — the chain factors once (or takes a resident factor
  through ``factor=``) and each correction is the block-bidiagonal
  substitution.

`plan` resolves the serve tiers: 'balanced' runs the plain program, 'fast'
factors one dtype down without refinement, 'guaranteed' pairs a low factor
dtype with an upgraded correction dtype and the sweep cap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from capital_tpu_torch.models import blocktri
from capital_tpu_torch.ops import batched_small, lapack
from capital_tpu_torch.utils import tracing

TIERS = ("fast", "balanced", "guaranteed")

#: Sweep cap of the guaranteed tier: inside the envelope refinement
#: converges in 2-4 sweeps; 8 leaves margin near the envelope's edge.
DEFAULT_MAX_ITERS = 8

_F32_TINY = torch.finfo(torch.float32).tiny


class RefineInfo(NamedTuple):
    """Per-problem refinement outcome, (batch,) tensors."""

    iters: torch.Tensor  # int32: correction sweeps executed
    converged: torch.Tensor  # int32: 1 = backward error met tolerance
    resid: torch.Tensor  # float32: final normwise backward error


class TierPlan(NamedTuple):
    """Static resolution of one accuracy tier at one request dtype."""

    factor_dtype: torch.dtype
    correction_dtype: torch.dtype
    max_iters: int  # 0 = no refinement


def _down1(dtype: torch.dtype) -> torch.dtype:
    """One notch down the factor ladder: f64→f32, f32→bf16, bf16 floors."""
    return torch.float32 if dtype == torch.float64 else torch.bfloat16


def _up(dtype: torch.dtype) -> torch.dtype:
    """One notch up for corrections: bf16→f32, f32→f64, f64 ceils (torch
    always has f64)."""
    return torch.float32 if dtype.itemsize < 4 else torch.float64


def plan(tier: str, dtype: torch.dtype) -> TierPlan:
    """Resolve accuracy_tier → (factor dtype, correction dtype, sweep cap)
    for one request dtype.

    * balanced — the plain program (no refinement).
    * fast — factor one notch down, no refinement.
    * guaranteed — f64 requests factor in f32 and correct in f64, f32
      factors in f32 and corrects in f64, bf16 factors in bf16 and
      corrects in f32; `DEFAULT_MAX_ITERS` sweeps at most.
    """
    if tier not in TIERS:
        raise ValueError(f"accuracy_tier must be one of {TIERS}, got {tier!r}")
    if tier == "balanced":
        return TierPlan(dtype, dtype, 0)
    if tier == "fast":
        fd = _down1(dtype)
        return TierPlan(fd, fd, 0)
    fd = torch.float32 if dtype == torch.float64 else dtype
    return TierPlan(fd, _up(dtype), DEFAULT_MAX_ITERS)


def tolerance(n: int, correction_dtype: torch.dtype) -> float:
    """Convergence tolerance on the normwise backward error:
    0.5·sqrt(n)·u at the correction dtype, well above the refined error's
    floor (the rounding of the residual product), so the progress guard
    does not fire false failures at the last sweep."""
    return 0.5 * float(n) ** 0.5 * float(torch.finfo(correction_dtype).eps)


def _pnorm(X: torch.Tensor) -> torch.Tensor:
    """Per-problem Frobenius norm of a (batch, ...) stack, as f32."""
    flat = X.reshape(X.shape[0], -1)
    return torch.sqrt(torch.sum(torch.square(flat), dim=-1)).to(torch.float32)


def _refine_loop(X0, resid_fn, err_fn, correct_fn, *, max_iters: int, tol: float):
    """The shared sweep loop.  resid_fn(X) -> r at the correction dtype;
    err_fn(X, r) -> (batch,) f32 backward error; correct_fn(r) -> d.  A
    problem is active while its error is above `tol`, was at least halved
    by its last sweep and its count is below `max_iters`; an inactive
    problem never becomes active again.  `max_iters` masked sweeps, no host
    sync.  Returns (X, RefineInfo)."""
    batch = X0.shape[0]
    dev = X0.device
    X, r = X0, resid_fn(X0)
    e = err_fn(X, r)
    prev = torch.full((batch,), float("inf"), dtype=torch.float32, device=dev)
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        act = (e > tol) & (e < 0.5 * prev) & (it < max_iters)
        mask = act.reshape((batch,) + (1,) * (X.dim() - 1))
        Xn = torch.where(mask, X + correct_fn(r), X)
        rn = resid_fn(Xn)
        en = err_fn(Xn, rn)
        X, r = Xn, torch.where(mask, rn, r)
        e, prev = torch.where(act, en, e), torch.where(act, e, prev)
        it = it + act.to(torch.int32)
    return X, RefineInfo(iters=it, converged=(e <= tol).to(torch.int32), resid=e)


# --------------------------------------------------------------------------
# factor / solve routing at the factor dtype
# --------------------------------------------------------------------------


def _potrf_route(Af, k: int, impl: str, precision):
    """Batched potrf at the factor dtype behind batched_small's resolver:
    (R, info, solve) with R upper.  f64 factors always take the library
    route (`batched_small.dtype_capable`)."""
    batch, n, _ = Af.shape
    pick = impl
    if impl == "auto":
        pick = batched_small.default_impl("posv", Af.shape, (batch, n, k), Af.dtype,
                                          interpret=Af.device.type != "cuda")
    elif impl in ("pallas", "pallas_split") and not batched_small.dtype_capable(Af.dtype):
        pick = "vmap"
    if pick in ("pallas", "pallas_split"):
        R, info = batched_small.potrf(Af, uplo="U", precision=precision)

        def solve(rr, bb):
            return batched_small.potrs(rr, bb, uplo="U", precision=precision)

        return R, info, solve
    with tracing.scope("serve::solve"):
        R, info = lapack.potrf(Af, uplo="U", with_info=True)
    return R, info, lambda rr, bb: lapack.potrs(rr, bb, uplo="U")


def _emit(batch: int, residual_flops: float, sweep_flops: float) -> None:
    """One sweep's modelled flops, split between the two IR phases."""
    with tracing.scope("IR::residual"):
        tracing.emit(flops=batch * residual_flops)
    with tracing.scope("IR::correct"):
        tracing.emit(flops=batch * (sweep_flops - residual_flops))


# --------------------------------------------------------------------------
# the three drivers
# --------------------------------------------------------------------------


def posv(A, B, *, factor_dtype, correction_dtype, max_iters: int = DEFAULT_MAX_ITERS,
         tol: float | None = None, impl: str = "auto", precision: str | None = "highest"):
    """Refined batched SPD solve: (batch, n, n) × (batch, n, k) →
    (X, info, RefineInfo) with X at B's dtype and info the (batch,) int32
    factor status (refinement reports a broken factor, it cannot repair
    it)."""
    batch, n, _ = A.shape
    k = B.shape[-1]
    fd, cd = factor_dtype, correction_dtype
    if tol is None:
        tol = tolerance(n, cd)
    R, info, solve = _potrf_route(A.to(fd), k, impl, precision)
    Ac, Bc = A.to(cd), B.to(cd)
    anorm, bnorm = _pnorm(Ac), _pnorm(Bc)
    _emit(batch, 2.0 * n * n * k, tracing.refine_sweep_flops(n, k))

    def resid(X):
        with tracing.scope("IR::residual"):
            return Bc - Ac @ X

    def err(X, r):
        return _pnorm(r) / (anorm * _pnorm(X) + bnorm + _F32_TINY)

    def correct(r):
        with tracing.scope("IR::correct"):
            return solve(R, r.to(fd)).to(cd)

    X0 = correct(Bc)  # the first solve is a correction of X = 0
    X, rinfo = _refine_loop(X0, resid, err, correct, max_iters=max_iters, tol=tol)
    return X.to(B.dtype), info, rinfo


def lstsq(A, B, *, factor_dtype, correction_dtype, max_iters: int = DEFAULT_MAX_ITERS,
          tol: float | None = None, impl: str = "auto", precision: str | None = "highest"):
    """Refined batched least squares: the gram's Cholesky factor R (A's
    triangular factor up to signs) at the factor dtype, once; every sweep
    solves d = R⁻¹R⁻ᵀ·Aᵀr.  Convergence is measured on the normal-equation
    residual Aᵀ(B − A·X)."""
    batch, m, n = A.shape
    k = B.shape[-1]
    fd, cd = factor_dtype, correction_dtype
    if tol is None:
        tol = tolerance(n, cd)
    Af = A.to(fd)
    with tracing.scope("CQR::gram"):
        G = Af.mT @ Af
    R, info, solve = _potrf_route(G, k, impl, precision)
    Ac, Bc = A.to(cd), B.to(cd)
    At = Ac.mT
    C0 = At @ Bc
    anorm2, cnorm = torch.square(_pnorm(Ac)), _pnorm(C0)
    _emit(batch, 4.0 * m * n * k, tracing.refine_lstsq_sweep_flops(m, n, k))

    def resid(X):
        with tracing.scope("IR::residual"):
            return At @ (Bc - Ac @ X)

    def err(X, g):
        return _pnorm(g) / (anorm2 * _pnorm(X) + cnorm + _F32_TINY)

    def correct(g):
        with tracing.scope("IR::correct"):
            return solve(R, g.to(fd)).to(cd)

    X0 = correct(C0)
    X, rinfo = _refine_loop(X0, resid, err, correct, max_iters=max_iters, tol=tol)
    return X.to(B.dtype), info, rinfo


def _chain_matvec(D, Cz, X):
    """y = A·X for the block-tridiagonal chain (D diagonal blocks, Cz
    sub-diagonal blocks with block 0 zeroed): y_i = D_i·X_i + C_i·X_{i−1}
    + C_{i+1}ᵀ·X_{i+1}."""
    zero = torch.zeros_like(X[:, :1])
    y = D @ X + Cz @ torch.cat([zero, X[:, :-1]], dim=1)
    CzT = Cz.mT
    CzTup = torch.cat([CzT[:, 1:], torch.zeros_like(CzT[:, :1])], dim=1)
    return y + CzTup @ torch.cat([X[:, 1:], zero], dim=1)


def posv_blocktri(D, C, B, *, factor_dtype, correction_dtype,
                  max_iters: int = DEFAULT_MAX_ITERS, tol: float | None = None,
                  impl: str = "auto", precision: str | None = "highest", factor=None):
    """Refined block-tridiagonal SPD solve: the chain factors once at the
    factor dtype, or takes a resident (L, Wt) through ``factor=`` (then
    refinement never refactors and info is 0), and every correction is the
    block-bidiagonal substitution (models/blocktri.solve).  Shapes as
    models/blocktri: D, C (batch, nblocks, b, b), B (batch, nblocks, b, k)."""
    batch, nblocks, b, _ = D.shape
    k = B.shape[-1]
    n = nblocks * b
    fd, cd = factor_dtype, correction_dtype
    if tol is None:
        tol = tolerance(n, cd)
    mapped = {"auto": "auto", "pallas": "pallas", "pallas_split": "pallas",
              "vmap": "xla", "xla": "xla"}[impl]
    if factor is None:
        L, Wt, info = blocktri.factor(D.to(fd), C.to(fd), precision=precision, impl=mapped)
    else:
        L, Wt = factor
        info = torch.zeros(batch, dtype=torch.int32, device=D.device)
    Dc, Cc = D.to(cd), C.to(cd)
    Cz = torch.cat([torch.zeros_like(Cc[:, :1]), Cc[:, 1:]], dim=1)
    Bc = B.to(cd)
    anorm = torch.sqrt(torch.square(_pnorm(Dc)) + 2.0 * torch.square(_pnorm(Cz)))
    bnorm = _pnorm(Bc)
    residual_flops = nblocks * 2.0 * b * b * k * 3.0
    _emit(batch, residual_flops,
          residual_flops + 2.0 * tracing.blocktri_solve_flops(nblocks, b, k))

    def resid(X):
        with tracing.scope("IR::residual"):
            return Bc - _chain_matvec(Dc, Cz, X)

    def err(X, r):
        return _pnorm(r) / (anorm * _pnorm(X) + bnorm + _F32_TINY)

    def correct(r):
        with tracing.scope("IR::correct"):
            return blocktri.solve(L, Wt, r.to(fd), precision=precision, impl=mapped).to(cd)

    X0 = correct(Bc)
    X, rinfo = _refine_loop(X0, resid, err, correct, max_iters=max_iters, tol=tol)
    return X.to(B.dtype), info, rinfo
