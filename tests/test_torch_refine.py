"""The port's mixed-precision iterative refinement (capital_tpu_torch/robust/
refine.py) and serve's accuracy tiers against the JAX package's, on the CPU.

The same numpy operands, made from a seed, go through `capital_tpu.robust.
refine` (jitted once per shape and route; its 'vmap' / 'xla' library routes,
and Pallas in interpret mode on 'pallas') and through the port.  Operands
sit well inside the envelope (cond ≈ 10), so no problem converges at the
tolerance's edge.  X agrees within 1e-10 relative (f64 requests: f32 factor,
f64 corrections) or 1e-6 (f32 requests, whose answer is cast back to f32);
`iters` and `converged` exactly; `info` exactly.  `resid` within 10 %, or
both at or below the tolerance: a converged problem's final backward error
is the rounding of the f64 residual product itself (~0.02·sqrt(n)·u), and
two libraries' products round differently (measured 25-60 % apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.robust import refine as jref
from capital_tpu.serve import api as rapi
from capital_tpu_torch.models import blocktri
from capital_tpu_torch.robust import refine
from capital_tpu_torch.serve import api

DT = {"f64": (np.float64, torch.float64, jnp.float64), "f32": (np.float32, torch.float32, jnp.float32),
      "bf16": (None, torch.bfloat16, jnp.bfloat16)}
X_TOL = {"f64": 1e-10, "f32": 1e-6}


def _spd(rng, batch, n):
    G = rng.standard_normal((batch, n, n))
    return G @ G.transpose(0, 2, 1) / n + 3.0 * np.eye(n)


def _operands(kind, dt, seed=0, batch=3):
    rng = np.random.default_rng(seed)
    npdt = DT[dt][0]
    if kind == "posv":
        A, B = _spd(rng, batch, 24), rng.standard_normal((batch, 24, 2))
    elif kind == "lstsq":
        A, B = rng.standard_normal((batch, 40, 12)), rng.standard_normal((batch, 40, 2))
    else:  # a block-tridiagonal chain of 4 blocks of 8, diagonally dominant
        D = _spd(rng, batch * 4, 8).reshape(batch, 4, 8, 8) + 2.0 * np.eye(8)
        C = 0.3 * rng.standard_normal((batch, 4, 8, 8))
        A, B = (D, C), rng.standard_normal((batch, 4, 8, 2))
    if kind == "posv_blocktri":
        return tuple(a.astype(npdt) for a in A), B.astype(npdt)
    return A.astype(npdt), B.astype(npdt)


@functools.lru_cache(maxsize=None)
def _ref_fn(kind, dt, impl, max_iters):
    p = jref.plan("guaranteed", DT[dt][2])
    kw = dict(factor_dtype=p.factor_dtype, correction_dtype=p.correction_dtype,
              max_iters=max_iters, impl=impl)
    if kind == "posv_blocktri":
        return jax.jit(lambda D, C, B: jref.posv_blocktri(D, C, B, **kw))
    return jax.jit(lambda A, B: getattr(jref, kind)(A, B, **kw))


def _both(kind, dt, A, B, impl, max_iters=refine.DEFAULT_MAX_ITERS, port_impl=None):
    args = A if kind == "posv_blocktri" else (A,)
    X, info, ri = _ref_fn(kind, dt, impl, max_iters)(*map(jnp.asarray, args), jnp.asarray(B))
    p = refine.plan("guaranteed", DT[dt][1])
    kw = dict(factor_dtype=p.factor_dtype, correction_dtype=p.correction_dtype,
              max_iters=max_iters, impl=port_impl or impl)
    Xp, infop, rip = getattr(refine, kind)(*map(torch.from_numpy, args), torch.from_numpy(B), **kw)
    return (np.asarray(X), np.asarray(info), ri), (Xp.numpy(), infop.numpy(), rip)


def _agree(ref, got, dt, tol):
    (X, info, ri), (Xp, infop, rip) = ref, got
    assert Xp.dtype == X.dtype
    assert np.abs(Xp - X).max() <= X_TOL[dt] * np.abs(X).max()
    assert np.array_equal(infop, info.astype(np.int32))
    assert np.array_equal(rip.iters.numpy(), np.asarray(ri.iters))
    assert np.array_equal(rip.converged.numpy(), np.asarray(ri.converged))
    r, rp = np.asarray(ri.resid, np.float64), rip.resid.double().numpy()
    assert np.array_equal(np.isnan(rp), np.isnan(r))
    close = np.abs(rp - r) <= 0.1 * r
    assert np.all(np.isnan(r) | close | ((rp <= tol) & (r <= tol)))


def test_plan_and_tolerance_match_reference():
    for tier in refine.TIERS:
        for dt in ("f64", "f32", "bf16"):
            p, q = refine.plan(tier, DT[dt][1]), jref.plan(tier, DT[dt][2])
            assert str(p.factor_dtype).split(".")[-1] == jnp.dtype(q.factor_dtype).name
            assert str(p.correction_dtype).split(".")[-1] == jnp.dtype(q.correction_dtype).name
            assert p.max_iters == q.max_iters
    for n in (8, 128, 1024):
        for dt in ("f64", "f32", "bf16"):
            assert refine.tolerance(n, DT[dt][1]) == jref.tolerance(n, DT[dt][2])
    with pytest.raises(ValueError, match="accuracy_tier"):
        refine.plan("exact", torch.float32)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("impl", ["vmap", "pallas"])
def test_refined_posv_matches_reference(impl, dt):
    A, B = _operands("posv", dt, seed=1)
    ref, got = _both("posv", dt, A, B, impl)
    _agree(ref, got, dt, refine.tolerance(24, torch.float64))
    assert np.all(got[2].converged.numpy() == 1) and np.all(got[2].iters.numpy() >= 1)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_refined_lstsq_matches_reference(dt):
    A, B = _operands("lstsq", dt, seed=2)
    ref, got = _both("lstsq", dt, A, B, "vmap")
    _agree(ref, got, dt, refine.tolerance(12, torch.float64))
    assert np.all(got[2].converged.numpy() == 1)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_refined_posv_blocktri_matches_reference(dt):
    A, B = _operands("posv_blocktri", dt, seed=3)
    ref, got = _both("posv_blocktri", dt, A, B, "xla")
    _agree(ref, got, dt, refine.tolerance(32, torch.float64))
    assert np.all(got[2].converged.numpy() == 1)
    # the scan route (plain kernel versions here) lands on the same answer
    Xk, infok, rik = refine.posv_blocktri(*map(torch.from_numpy, (*A, B)),
                                          factor_dtype=torch.float32,
                                          correction_dtype=torch.float64, impl="pallas")
    assert np.abs(Xk.numpy() - ref[0]).max() <= X_TOL[dt] * np.abs(ref[0]).max()
    assert np.array_equal(rik.iters.numpy(), np.asarray(ref[2].iters))


def test_per_problem_freeze_and_nan_freeze_at_once():
    """A zero right-hand side converges before any sweep (0 iterations); a
    NaN operand breaks its factor and freezes at once, unconverged; the
    others refine as alone.  The cap-bounded loop gives the reference's
    counts exactly."""
    A, B = _operands("posv", "f64", seed=4, batch=4)
    B[1] = 0.0
    A[2, 5, 5] = np.nan
    ref, got = _both("posv", "f64", A, B, "vmap")
    (X, info, ri), (Xp, infop, rip) = ref, got
    assert rip.iters.tolist() == np.asarray(ri.iters).tolist()
    assert rip.iters[1] == 0 and rip.iters[2] == 0 and rip.converged[2] == 0
    assert infop.tolist() == np.asarray(info).tolist() and infop[2] == 6
    assert rip.converged[[0, 1, 3]].tolist() == [1, 1, 1]
    keep = [0, 1, 3]
    assert np.abs(Xp[keep] - X[keep]).max() <= 1e-10 * np.abs(X[keep]).max()
    assert np.all(Xp[1] == 0)
    # a cap of 1 freezes every problem after one sweep, as the reference's
    ref1, got1 = _both("posv", "f64", A[[0, 3]], B[[0, 3]], "vmap", max_iters=1)
    _agree(ref1, got1, "f64", refine.tolerance(24, torch.float64))
    assert got1[2].iters.tolist() == [1, 1]


def test_resident_factor_reuse_is_bitwise():
    (D, C), B = _operands("posv_blocktri", "f64", seed=5)
    Dt, Ct, Bt = map(torch.from_numpy, (D, C, B))
    kw = dict(factor_dtype=torch.float32, correction_dtype=torch.float64, impl="xla")
    X, info, ri = refine.posv_blocktri(Dt, Ct, Bt, **kw)
    L, Wt, finfo = blocktri.factor(Dt.float(), Ct.float(), impl="xla")
    Xr, infor, rir = refine.posv_blocktri(Dt, Ct, Bt, factor=(L, Wt), **kw)
    assert torch.equal(X, Xr) and torch.equal(ri.iters, rir.iters)
    assert not info.any() and not finfo.any() and not infor.any()


@pytest.mark.parametrize("op", ["posv", "lstsq"])
def test_batched_guaranteed_tier_matches_reference(op):
    A, B = _operands(op, "f32", seed=6)
    ref = jax.jit(rapi.batched(op, "highest", "auto", tier="guaranteed"))(jnp.asarray(A), jnp.asarray(B))
    got = api.batched(op, "highest", "auto", tier="guaranteed")(torch.from_numpy(A), torch.from_numpy(B))
    assert len(got) == len(ref) == 5
    X, iters, conv, resid, info = got
    assert X.dtype == torch.float32
    assert np.abs(X.numpy() - np.asarray(ref[0])).max() <= 1e-6 * np.abs(np.asarray(ref[0])).max()
    assert iters.tolist() == np.asarray(ref[1]).tolist() and conv.tolist() == np.asarray(ref[2]).tolist()
    tol = refine.tolerance(A.shape[-1], torch.float64)
    r, rp = np.asarray(ref[3], np.float64), resid.double().numpy()
    assert np.all((np.abs(rp - r) <= 0.1 * r) | ((rp <= tol) & (r <= tol)))
    assert info.tolist() == np.asarray(ref[4]).tolist() == [0, 0, 0]


def test_batched_fast_tier_matches_reference():
    """'fast' runs the bf16 program and casts the answer back to f32."""
    A, B = _operands("posv", "f32", seed=7)
    Xr, ir = jax.jit(rapi.batched("posv", "highest", "pallas", tier="fast"))(jnp.asarray(A), jnp.asarray(B))
    X, info = api.batched("posv", "highest", "pallas", tier="fast")(torch.from_numpy(A), torch.from_numpy(B))
    assert X.dtype == torch.float32 and not info.any() and not np.asarray(ir).any()
    Xr = np.asarray(Xr)
    assert np.abs(X.numpy() - Xr).max() <= 2e-2 * np.abs(Xr).max()
    res = np.linalg.norm(A @ X.numpy().astype(np.float64) - B) / np.linalg.norm(B)
    assert res < 5e-2  # a bf16 factor's answer


def test_batched_guaranteed_posv_blocktri_five_outputs():
    (D, C), B = _operands("posv_blocktri", "f32", seed=8)
    A = np.stack([D, C], axis=1)
    out = api.batched("posv_blocktri", "highest", "vmap", tier="guaranteed")(
        torch.from_numpy(A), torch.from_numpy(B))
    ref = jax.jit(rapi.batched("posv_blocktri", "highest", "vmap", tier="guaranteed"))(
        jnp.asarray(A), jnp.asarray(B))
    assert len(out) == 5
    assert np.abs(out[0].numpy() - np.asarray(ref[0])).max() <= 1e-6 * np.abs(np.asarray(ref[0])).max()
    assert out[1].tolist() == np.asarray(ref[1]).tolist()
