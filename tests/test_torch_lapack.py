"""The port's LAPACK seam (capital_tpu_torch/ops/lapack.py) against the JAX
package's (capital_tpu/ops/lapack.py) on broken operands, on the CPU.

The reference's CPU potrf runs on through a NaN pivot (NaN fails its
`<= 0` test) and NaN-fills the whole factor on a non-positive one; the
port's `cholesky_lower` rebuilds that pattern from torch's breakdown
report.  Both `info` and the NaN pattern of every returned factor are
compared exactly, at every pivot of an n = 8 and an n = 40 matrix (the
latter crosses the library's blocking), in f32 and f64.  Finite entries
agree to 1e-5 (f32) / 1e-12 (f64) relative where both are finite on the
intact leading columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import lapack as jlapack
from capital_tpu_torch.ops import lapack as tlapack

DT = {"f32": np.float32, "f64": np.float64}


def _spd(n, seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return g @ g.T / n + 3.0 * np.eye(n)


def _outputs(mod, fn, A, uplo):
    conv = jnp.asarray if mod is jlapack else torch.from_numpy
    if fn == "potrf":
        return getattr(mod, fn)(conv(A), uplo=uplo, with_info=True)
    if fn == "potrf_trtri":
        return getattr(mod, fn)(conv(A), uplo=uplo, with_info=True)
    return getattr(mod, fn)(conv(A), with_info=True)


def _same_breakdown(A, fn, uplo, dt):
    ref = [np.asarray(x) for x in _outputs(jlapack, fn, A, uplo)]
    got = [x.numpy() for x in _outputs(tlapack, fn, A, uplo)]
    assert int(got[-1]) == int(ref[-1])
    R, Rr = got[0], ref[0]
    assert np.array_equal(np.isnan(R), np.isnan(Rr))
    assert np.array_equal(np.isinf(R), np.isinf(Rr))
    ok = np.isfinite(R) & np.isfinite(Rr)
    tol = 1e-5 if dt == "f32" else 1e-12
    assert np.abs(R[ok] - Rr[ok]).max(initial=0.0) <= tol * max(np.abs(Rr[ok]).max(initial=1.0), 1.0)
    return int(got[-1])


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("fn,uplo", [("potrf", "U"), ("potrf", "L"), ("potrf_trtri", "U"),
                                     ("potrf_trtri", "L"), ("potrf_trtri_upper", None)])
def test_nan_pivot_info_and_pattern_match_reference(fn, uplo, dt):
    for n in (8, 40):
        for r in range(n) if n == 8 else (0, 17, 33, 39):
            A = _spd(n, seed=r).astype(DT[dt])
            A[r, r] = np.nan
            assert _same_breakdown(A, fn, uplo, dt) == r + 1


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("fn", ["potrf", "potrf_trtri", "potrf_trtri_upper"])
def test_non_positive_pivot_and_off_diagonal_nan_match_reference(fn, dt):
    uplo = None if fn == "potrf_trtri_upper" else "U"
    A = _spd(8, seed=1).astype(DT[dt])
    A[3, 3] = -1.0
    assert _same_breakdown(A, fn, uplo, dt) == 1  # the whole factor is NaN
    A = _spd(8, seed=2).astype(DT[dt])
    A[5, 2] = A[2, 5] = np.nan  # row 5 spreads into its pivot
    assert _same_breakdown(A, fn, uplo, dt) == 6


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_symmetrization_follows_the_reference(dt):
    """potrf and potrf_trtri read (A + Aᵀ)/2 (lax.linalg.cholesky's
    default), potrf_trtri_upper reads only the upper triangle: a NaN in
    the strict upper triangle breaks the first two and not the third."""
    A = _spd(8, seed=3).astype(DT[dt])
    A[2, 5] = np.nan
    assert _same_breakdown(A, "potrf", "U", dt) == 6
    assert _same_breakdown(A, "potrf_trtri", "L", dt) == 6
    B = _spd(8, seed=3).astype(DT[dt])
    B[5, 2] = np.nan  # potrf_trtri_upper's dead lower half
    assert _same_breakdown(B, "potrf_trtri_upper", None, dt) == 0


#: seeds of the known +inf-pivot difference (ROADMAP Queue C item 2)
INF_PIVOT_SEEDS = (0, 1, 2)


@pytest.mark.parametrize("seed", INF_PIVOT_SEEDS)
def test_inf_pivot_difference_is_pinned(seed):
    """+inf exactly on a pivot.  f64: both libraries run on with zeros
    below it and the factors agree.  f32: torch's CPU spotrf writes NaN
    below the pivot and stops at the next one, where jaxlib's runs on with
    zeros.  `info` still agrees (the inf diagonal is the first bad pivot);
    the NaN pattern below and after it does not."""
    n, r = 8, 3
    A = _spd(n, seed=seed)
    A[r, r] = np.inf
    assert _same_breakdown(A, "potrf", "L", "f64") == r + 1
    A32 = A.astype(np.float32)
    (Rr, ir), (R, i) = (jlapack.potrf(jnp.asarray(A32), uplo="L", with_info=True),
                        tlapack.potrf(torch.from_numpy(A32), uplo="L", with_info=True))
    Rr, R = np.asarray(Rr), R.numpy()
    assert int(i) == int(ir) == r + 1
    assert np.all(Rr[r + 1:, r] == 0) and np.isfinite(Rr[r + 1:, r + 1:]).all()
    assert np.isnan(R[r + 1:, r]).all() and np.isnan(np.diag(R)[r + 1:]).all()
