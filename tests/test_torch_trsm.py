"""The port's blocked TRSM (capital_tpu_torch.models.trsm.solve) against
the JAX package's (capital_tpu.models.trsm.solve), on the CPU.

Every side × uplo × trans_a × unit_diag combination, leaf 'invert' (with
the diag(A, I) pad to a multiple of bc: n = 300 at bc = 128 pads to 384)
and leaf 'solve', at an odd n.  The JAX side runs under jit on a one-device
CPU grid.  Operands are made with numpy from a seed: a triangular factor
with diagonal 3 and off-diagonal entries N(0, 1)/√n (κ ≈ 2), with finite
garbage in the dead triangle (never read) and a NaN diagonal under
unit_diag (never read either).

Tolerances (relative Frobenius difference against JAX): f64 1e-12, f32
1e-5 (products in other orders), bf16 2e-2 (the updated right-hand sides
are rounded to bf16 at every level).  Residual gate ‖op(T)·X − B‖/‖B‖ in
f64: f64 1e-13, f32 2e-6, bf16 5e-2 (`_tolerance` of bench/drivers.py).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import trsm as jtrsm
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu_torch import Grid
from capital_tpu_torch.models import trsm as ttrsm
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import tensor_from_numpy, trsm_config_from_fields

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 2e-6, "bf16": 5e-2}
N, NRHS, BC = 300, 5, 128


@pytest.fixture(scope="module")
def jgrid():
    return JGrid.square(c=1, devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def tgrid():
    return Grid.square(device="cpu")


def _operands(uplo, side, unit, dt, seed=0, n=N):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + 3.0 * np.eye(n)
    L += np.triu(rng.standard_normal((n, n)), 1)  # the dead triangle: never read
    T = L if uplo == "L" else L.T.copy()
    if unit:
        T[np.arange(n), np.arange(n)] = np.nan
    B = rng.standard_normal((n, NRHS) if side == "L" else (NRHS, n))
    return T.astype(NP_DT[dt]), B.astype(NP_DT[dt])


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _residual(T, B, X, side, uplo, trans, unit):
    n = T.shape[0]
    T = _f64(T)
    op = np.tril(T) if uplo == "L" else np.triu(T)
    if unit:
        op[np.arange(n), np.arange(n)] = 1.0
    op = op.T if trans else op
    got = op @ _f64(X) if side == "L" else _f64(X) @ op
    return float(np.linalg.norm(got - _f64(B)) / np.linalg.norm(_f64(B)))


def _check(jgrid, tgrid, side, uplo, trans, unit, dt, leaf):
    T, B = _operands(uplo, side, unit, dt, seed=hash((side, uplo, trans, unit)) % 1000)
    jcfg = jtrsm.TrsmConfig(base_case_dim=BC, leaf=leaf)
    want = jax.jit(lambda a, b: jtrsm.solve(jgrid, a, b, side, uplo, trans, jcfg, unit_diag=unit))(
        jnp.asarray(T), jnp.asarray(B))
    cfg = trsm_config_from_fields(dataclasses.asdict(jcfg))
    got = ttrsm.solve(tgrid, tensor_from_numpy(T), tensor_from_numpy(B), side, uplo, trans, cfg,
                      unit_diag=unit)
    assert got.shape == B.shape
    assert _rel(got, want) < VS_JAX[dt]
    assert _residual(T, B, got, side, uplo, trans, unit) < GATE[dt]


@pytest.mark.parametrize("side,uplo,trans,unit", list(itertools.product("LR", "LU", (False, True),
                                                                         (False, True))))
def test_solve_invert_leaf_matches_jax(jgrid, tgrid, side, uplo, trans, unit):
    _check(jgrid, tgrid, side, uplo, trans, unit, "f64", "invert")


@pytest.mark.parametrize("side,uplo,trans", list(itertools.product("LR", "LU", (False, True))))
def test_solve_leaf_matches_jax(jgrid, tgrid, side, uplo, trans):
    _check(jgrid, tgrid, side, uplo, trans, False, "f64", "solve")


@pytest.mark.parametrize("side,uplo,trans,dt", [("L", "L", False, "f32"), ("R", "U", True, "f32"),
                                                ("L", "U", False, "bf16"), ("R", "L", True, "bf16")])
def test_solve_narrow_dtypes_match_jax(jgrid, tgrid, side, uplo, trans, dt):
    _check(jgrid, tgrid, side, uplo, trans, False, dt, "invert")


def test_phases_and_refusals(tgrid):
    T, B = _operands("L", "L", False, "f64")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ttrsm.solve(tgrid, torch.from_numpy(T), torch.from_numpy(B))
    assert {e.key for e in prof.key_averages() if e.key.startswith("TS::")} == {
        "TS::dinv", "TS::leaf", "TS::update"}
    with pytest.raises(ValueError, match="side"):
        ttrsm.solve(tgrid, torch.from_numpy(T), torch.from_numpy(B), side="X")
    with pytest.raises(ValueError, match="leaf"):
        ttrsm.solve(tgrid, torch.from_numpy(T), torch.from_numpy(B), cfg=ttrsm.TrsmConfig(leaf="lu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ttrsm.solve(tgrid, torch.from_numpy(T), torch.from_numpy(B.T.copy()))
    assert tracing.PHASE_REGISTRY.count("TS::dinv") == 1
