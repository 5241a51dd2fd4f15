"""TRSM, Newton and CholeskyQR2 on the mesh: the port's (capital_tpu_torch,
an in-process mesh of CPU ranks) against the JAX package's (the conftest's
virtual CPU devices, Pallas interpreted, under jit), operand for operand.

* trsm.solve on 2x2x1 and 2x2x2 (the bc·2^k pad, mode 'explicit');
* inverse.newton on 2x2x1 and 2x2x2;
* qr.factor regime '1d' on a flat mesh of 8 and of 4 ranks: the fused tier
  per rank (`_cqr2_fused_sharded`), uneven rows falling back to the sweeps,
  and a robust run taking the guarded sweeps unfused;
* qr.factor regime 'dist' with the nested cholinv's complete_inv True and
  False (`solve_blocked`), the single-base-window solve, and 'dist' on one
  device; fused_plan and pallas_coupled on a mesh.

Every parity test also holds the Recorder's note set and per-scope flops,
comm_bytes and copy_bytes to the JAX package's (Newton: per executed step —
the JAX while_loop traces its body once).  Tolerances, relative Frobenius
difference against JAX: f64 1e-10, f32 1e-5, bf16 2e-2.  The sizes follow
tests/test_qr_fused.py TestFusedSharded and tests/test_cacqr.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.models import inverse as jinv
from capital_tpu.models import qr as jqr
from capital_tpu.models import trsm as jtrsm
from capital_tpu.ops import qr_fused as jqf
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.robust.config import RobustConfig as JRobust
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.models import inverse as tinv
from capital_tpu_torch.models import qr as tqr
from capital_tpu_torch.models import trsm as ttrsm
from capital_tpu_torch.ops import qr_fused as tqf
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils import tracing as ttracing
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-10, "f32": 1e-5, "bf16": 2e-2}
FIELDS = ("flops", "comm_bytes", "copy_bytes", "collectives", "flops_vol", "flops_max")


def _grids(kind):
    """('2x2x1' | '2x2x2' | 'flat8' | 'flat4' | 'one') -> (JAX grid, port grid)."""
    devs = jax.devices("cpu")
    if kind == "one":
        return JGrid.square(c=1, devices=devs[:1]), Grid.square(device="cpu")
    if kind.startswith("flat"):
        k = int(kind[4:])
        return JGrid.flat(devices=devs[:k]), Grid.flat(devices=["cpu"] * k)
    c = int(kind[-1])
    return JGrid.square(c=c, devices=devs[:4 * c]), Grid.square(c=c, devices=["cpu"] * (4 * c))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_model(jrec, trec):
    assert set(trec.stats) == set(jrec.stats)
    for tag, want in jrec.stats.items():
        got = trec.stats[tag]
        assert got.calls == want.calls, tag
        for f in FIELDS:
            assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9), (tag, f)


def _both(jfn, tfn, *arrays):
    with jtracing.Recorder() as jrec:
        want = jax.jit(jfn)(*(jnp.asarray(a) for a in arrays))
    with ttracing.Recorder() as trec:
        got = tfn(*(tensor_from_numpy(a) for a in arrays))
    _same_model(jrec, trec)
    return got, want, trec


def _tall(m, n, dt="f64", seed=11):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(NP_DT[dt])


def _tri(n, uplo, dt="f64", seed=3):
    g = np.random.default_rng(seed).standard_normal((n, n)) / np.sqrt(n)
    T = (np.tril(g, -1) if uplo == "L" else np.triu(g, 1)) + 3.0 * np.eye(n)
    return (T + (np.triu(g, 1) if uplo == "L" else np.tril(g, -1))).astype(NP_DT[dt])  # junk


# ---- TRSM and Newton --------------------------------------------------------


@pytest.mark.parametrize("kind,side,uplo,trans,dt,leaf", [
    ("2x2x1", "L", "L", False, "f64", "invert"), ("2x2x1", "R", "U", True, "f64", "invert"),
    ("2x2x1", "L", "U", False, "f32", "solve"), ("2x2x2", "R", "L", False, "f64", "invert"),
])
def test_trsm_on_a_mesh_matches_jax(kind, side, uplo, trans, dt, leaf):
    """n = 384 pads to 512 (diag(A, I)) at bc 128, as the JAX package
    pads a mesh solve."""
    jg, tg = _grids(kind)
    n, k = 384, 48
    A = _tri(n, uplo, dt)
    B = _tall(n, k, dt, seed=5) if side == "L" else _tall(k, n, dt, seed=5)
    kw = dict(base_case_dim=128, mode="explicit", leaf=leaf)
    X, want, _ = _both(
        lambda a, b: jtrsm.solve(jg, a, b, side, uplo, trans, jtrsm.TrsmConfig(**kw)),
        lambda a, b: ttrsm.solve(tg, a, b, side, uplo, trans, ttrsm.TrsmConfig(**kw)), A, B)
    assert X.shape == B.shape and _rel(X, want) < VS_JAX[dt]
    T = (np.tril if uplo == "L" else np.triu)(_f64(A))
    T = T.T if trans else T
    lhs = T @ _f64(X) if side == "L" else _f64(X) @ T
    assert np.linalg.norm(lhs - _f64(B)) / np.linalg.norm(_f64(B)) < {"f64": 1e-13, "f32": 1e-5}[dt]


@pytest.mark.parametrize("kind,dt", [("2x2x1", "f64"), ("2x2x2", "f64"), ("2x2x1", "f32")])
def test_newton_on_a_mesh_matches_jax(kind, dt):
    jg, tg = _grids(kind)
    n = 256
    A = (np.random.default_rng(4).standard_normal((n, n)) / 16 + 2 * np.eye(n)).astype(NP_DT[dt])
    cfg = dict(mode="explicit")
    with jtracing.Recorder() as jrec:
        want, jit_ = jax.jit(lambda a: jinv.newton(jg, a, jinv.NewtonConfig(**cfg)))(jnp.asarray(A))
    with ttracing.Recorder() as trec:
        X, it = tinv.newton(tg, torch.from_numpy(A), tinv.NewtonConfig(**cfg))
    assert it == int(jit_) and _rel(X, want) < VS_JAX[dt]
    # JAX prices the initial product and one traced body (two products);
    # the host loop prices every step it runs
    j, t = jrec.stats["<top>"], trec.stats["<top>"]
    assert j.calls == 3 and t.calls == 1 + 2 * it
    for f in FIELDS:
        assert getattr(t, f) == pytest.approx(getattr(j, f) / 3 * (1 + 2 * it), rel=1e-9), f
    err = np.linalg.norm(np.eye(n) - _f64(A) @ _f64(X)) / np.sqrt(n)
    assert err < {"f64": 1e-12, "f32": 1e-4}[dt]


# ---- CholeskyQR2 regime '1d' -----------------------------------------------


def _qr_both(kind, A, **kw):
    jg, tg = _grids(kind)
    jkw = dict(kw)
    if "robust" in jkw:
        jkw["robust"] = JRobust()
    if "cholinv" in jkw:
        jkw["cholinv"] = jchol.CholinvConfig(**jkw["cholinv"])
        kw["cholinv"] = tchol.CholinvConfig(**kw["cholinv"])
    return _both(lambda a: jqr.factor(jg, a, jqr.CacqrConfig(**jkw)),
                 lambda a: tqr.factor(tg, a, tqr.CacqrConfig(**kw)), A)


def _qr_gates(A, Q, R, dt):
    A64, Q64, R64 = (torch.tensor(_f64(x)) for x in (A, Q, R))
    gate = {"f64": 1e-13, "f32": 5e-5, "bf16": 5e-2}[dt]
    assert float(tres.qr_orthogonality(Q64)) < gate
    assert float(tres.qr_residual(A64, Q64, R64)) < gate


@pytest.mark.parametrize("kind,dt", [("flat8", "f64"), ("flat4", "f32"), ("flat8", "bf16")])
def test_cqr2_fused_per_rank_matches_jax(kind, dt):
    """4096 x 512 over 8 (or 4) ranks: each rank's 512 (1024) rows through
    gram_blocked, scale_gram and scale_blocked, the grams summed over the
    mesh."""
    A = _tall(4096, 512, dt)
    (Q, R), (jQ, jR), trec = _qr_both(kind, A, regime="1d", mode="pallas")
    assert _rel(Q, jQ) < VS_JAX[dt] and _rel(R, jR) < VS_JAX[dt]
    assert trec.stats["CQR::fused"].calls == 1  # the fused tier's one priced pass
    _qr_gates(A, Q, R, dt)


def test_cqr2_fused_per_rank_matches_the_single_device_factor():
    A = _tall(4096, 512)
    _, tg = _grids("flat8")
    _, t1 = _grids("one")
    cfg = tqr.CacqrConfig(regime="1d", mode="pallas")
    Qm, Rm = tqr.factor(tg, torch.from_numpy(A), cfg)
    Q1, R1 = tqr.factor(t1, torch.from_numpy(A), cfg)
    assert _rel(Qm, Q1) < 1e-12 and _rel(Rm, R1) < 1e-12


def test_uneven_rows_fall_back_to_the_sweeps_like_jax():
    A = _tall(4100, 512)
    jg, tg = _grids("flat8")
    assert not tqf.fused_ok(tg, 4100, 512, "pallas", dtype=torch.float64)
    (Q, R), (jQ, jR), trec = _qr_both("flat8", A, regime="1d", mode="pallas")
    assert "CQR::fused" not in trec.stats
    assert _rel(Q, jQ) < VS_JAX["f64"] and _rel(R, jR) < VS_JAX["f64"]
    _qr_gates(A, Q, R, "f64")


def test_robust_on_a_mesh_runs_the_sweeps_unfused_like_jax():
    A = _tall(4096, 512)
    (Q, R, info), (jQ, jR, jinfo), trec = _qr_both("flat8", A, regime="1d", mode="pallas",
                                                      robust=RobustConfig())
    assert "CQR::fused" not in trec.stats and trec.stats["CQR::chol"].calls == 2
    assert int(info.info) == int(jinfo.info) == 0
    assert _rel(Q, jQ) < VS_JAX["f64"] and _rel(R, jR) < VS_JAX["f64"]


@pytest.mark.parametrize("kind,m,n", [("flat8", 4096, 512), ("flat8", 4100, 512), ("flat4", 2048, 1024),
                                      ("2x2x2", 8192, 256)])
def test_fused_plan_and_pallas_coupled_on_a_mesh_match_jax(kind, m, n):
    jg, tg = _grids(kind)
    for mode in ("pallas", "xla"):
        g = jqf.pick_g(n)
        assert tqf.fused_plan(tg, m, n, mode, g=g, dtype=torch.float64) == \
            jqf.fused_plan(jg, m, n, mode, g=g, dtype=jnp.float64)
        assert tqr.pallas_coupled(tg, n, mode, m=m, dtype=torch.float64) == \
            jqr.pallas_coupled(jg, n, mode, m=m, dtype=jnp.float64)
        assert tqr.pallas_coupled(tg, n, mode) == jqr.pallas_coupled(jg, n, mode) is False


# ---- CholeskyQR2 regime 'dist' ---------------------------------------------


@pytest.mark.parametrize("kind,complete_inv,dt", [("2x2x1", True, "f64"), ("2x2x1", False, "f64"),
                                                  ("2x2x2", True, "f64"), ("2x2x1", True, "f32")])
def test_dist_regime_matches_jax(kind, complete_inv, dt):
    """The gram by summa.syrk, cholinv on the gram (bc 32: a 64-wide gram
    recurses once), Q by summa.trmm side R — or, without the top inverse
    block, by solve_blocked."""
    A = _tall(512, 64, dt)
    (Q, R), (jQ, jR), trec = _qr_both(
        kind, A, regime="dist", mode="explicit",
        cholinv=dict(base_case_dim=32, mode="explicit", complete_inv=complete_inv))
    assert _rel(Q, jQ) < VS_JAX[dt] and _rel(R, jR) < VS_JAX[dt]
    assert trec.stats["CQR::merge"].calls >= 1
    _qr_gates(A, Q, R, dt)


def test_dist_single_base_window_solve_matches_jax():
    """complete_inv=False on a gram of one base-case window: the inverse is
    whole, solve_blocked is one trmm."""
    A = _tall(128, 16)
    (Q, R), (jQ, jR), _ = _qr_both("2x2x1", A, regime="dist",
                                      cholinv=dict(base_case_dim=32, complete_inv=False))
    assert _rel(Q, jQ) < VS_JAX["f64"] and _rel(R, jR) < VS_JAX["f64"]
    _qr_gates(A, Q, R, "f64")


def test_dist_regime_on_one_device_matches_jax():
    A = _tall(512, 64)
    (Q, R), (jQ, jR), _ = _qr_both("one", A, regime="dist", mode="pallas",
                                      cholinv=dict(base_case_dim=32, mode="pallas"))
    assert _rel(Q, jQ) < VS_JAX["f64"] and _rel(R, jR) < VS_JAX["f64"]
    _qr_gates(A, Q, R, "f64")


def test_solve_blocked_direct_matches_jax():
    jg, tg = _grids("2x2x1")
    A = _tall(256, 64, seed=12)
    G = A.T @ A
    ccfg = dict(base_case_dim=32, mode="explicit", complete_inv=False)
    jcfg = jqr.CacqrConfig(mode="explicit", cholinv=jchol.CholinvConfig(**ccfg))
    want = jax.jit(lambda a, g_: jqr.solve_blocked(
        jg, a, *jchol.factor(jg, g_, jcfg.cholinv), jcfg))(jnp.asarray(A), jnp.asarray(G))
    R, Ri = tchol.factor(tg, torch.from_numpy(G), tchol.CholinvConfig(**ccfg))
    got = tqr.solve_blocked(tg, torch.from_numpy(A), R, Ri,
                            tqr.CacqrConfig(mode="explicit", cholinv=tchol.CholinvConfig(**ccfg)))
    assert _rel(got, want) < VS_JAX["f64"]
