"""The port's CholeskyQR2 (capital_tpu_torch.models.qr) and its robust ladder
against the JAX package's (capital_tpu.models.qr), on the CPU.

The JAX side runs as its own tests run it: a one-device CPU grid, Pallas in
interpret mode, x64 on.  The port runs its plain kernel versions on a CPU
grid.  Operands are made with numpy from a seed; bf16 crosses bitwise.

Tolerances (stated per dtype), relative Frobenius against the JAX result:
* f64 1e-12, f32 1e-5: the same pipeline, sums in other orders;
* bf16 2e-2: Q and the grams round to bf16 at every pass, and a one-ulp
  difference early moves the later factors by a few ulps.
Gates on the port's own result: ‖I − QᵀQ‖ and ‖A − QR‖/‖A‖ below the values
of capital_tpu/bench/drivers.py, 1e-13 (f64), 5e-5 (f32), 5e-2 (bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import qr as jqr
from capital_tpu.models.cholesky import CholinvConfig as JCholinv
from capital_tpu.ops import lapack as jlapack
from capital_tpu.ops import tsqr as jtsqr
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.robust import faultinject as jfi
from capital_tpu.robust import recovery as jrec
from capital_tpu.robust.config import RobustConfig as JRobust
from capital_tpu.robust.config import RobustInfo as JInfo
from capital_tpu.utils import residual as jres
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import qr as tqr
from capital_tpu_torch.models.cholesky import CholinvConfig
from capital_tpu_torch.ops import lapack as tlapack
from capital_tpu_torch.ops import tsqr as ttsqr
from capital_tpu_torch.robust import config as tconfig
from capital_tpu_torch.robust import faultinject as tfi
from capital_tpu_torch.robust import recovery as trec
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils import tracing as ttracing
from capital_tpu_torch.utils.interop import (
    cacqr_config_from_fields,
    robust_info_to_numpy,
    tensor_from_numpy,
)

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 5e-5, "bf16": 5e-2}


@pytest.fixture(scope="module")
def jgrid():
    return JGrid.square(c=1, devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def tgrid():
    return Grid.square(device="cpu")


def _tall(m, n, dt, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) / np.sqrt(m)).astype(NP_DT[dt])


def _illcond(m, n, cond, dtype, seed=0):
    """Tall matrix with a log-spaced spectrum spanning exactly `cond` (the
    JAX package's robust tests' operand)."""
    rng = np.random.default_rng(seed)
    Q0, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q0 @ np.diag(np.logspace(0, -np.log10(cond), n)) @ V.T).astype(dtype)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_qr(A, got, want, dt):
    """Q and R against JAX, then the gates on the port's own result."""
    (Qt, Rt), (Qj, Rj) = got, want
    assert tuple(Qt.shape) == Qj.shape and tuple(Rt.shape) == Rj.shape
    assert _rel(Qt, Qj) < VS_JAX[dt]
    assert _rel(np.triu(_f64(Rt)), np.triu(_f64(Rj))) < VS_JAX[dt]
    At = tensor_from_numpy(A)
    assert float(tres.qr_orthogonality(Qt).double()) < GATE[dt]
    assert float(tres.qr_residual(At, Qt, Rt)) < GATE[dt]


def _both(jgrid, tgrid, A, jcfg, tcfg):
    want = jqr.factor(jgrid, jnp.asarray(A), jcfg)
    got = tqr.factor(tgrid, tensor_from_numpy(A), tcfg)
    return got, want


# --------------------------------------------------------------------------
# qr.factor
# --------------------------------------------------------------------------

CQR2_CASES = {  # name: (m, n, dtype, mode)
    "full_f64": (1024, 512, "f64", "pallas"),
    "full_f32": (1024, 512, "f32", "pallas"),
    "full_bf16": (1024, 512, "bf16", "pallas"),
    "full_g8_f32": (1024, 1024, "f32", "pallas"),
    "xla_f32": (1024, 512, "f32", "xla"),
    "xla_bf16": (1024, 512, "bf16", "xla"),
    "sweeps_unaligned_f64": (512, 192, "f64", "pallas"),  # no g-split: the sweeps
}


@pytest.mark.parametrize("case", list(CQR2_CASES))
def test_cqr2_matches_jax(jgrid, tgrid, case):
    m, n, dt, mode = CQR2_CASES[case]
    A = _tall(m, n, dt, seed=1)
    prec = None if dt == "bf16" else "highest"
    kw = dict(num_iter=2, regime="1d", mode=mode, precision=prec)
    got, want = _both(jgrid, tgrid, A, jqr.CacqrConfig(**kw), tqr.CacqrConfig(**kw))
    _check_qr(A, got, want, dt)


@pytest.mark.parametrize("dt", ["f64", "bf16"])
def test_cqr1_trmm_route_matches_jax(jgrid, tgrid, dt):
    # n=512: the sweep's g=2 split engages the tri_matmul trmm kernel
    A = _tall(1024, 512, dt, seed=2)
    kw = dict(num_iter=1, regime="1d", mode="pallas", precision=None if dt == "bf16" else "highest")
    assert tqr.pallas_coupled(tgrid, 512, "pallas")
    got, want = _both(jgrid, tgrid, A, jqr.CacqrConfig(**kw), tqr.CacqrConfig(**kw))
    (Qt, Rt), (Qj, Rj) = got, want
    assert _rel(Qt, Qj) < VS_JAX[dt] and _rel(Rt, Rj) < VS_JAX[dt]
    assert float(tres.qr_residual(tensor_from_numpy(A), Qt, Rt)) < GATE[dt]


@pytest.mark.parametrize("plan", ["full", "split"])
def test_fused_tiers_called_directly(jgrid, tgrid, plan):
    A = _tall(1024, 512, "f64", seed=3)
    jcfg = jqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas")
    tcfg = tqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas")
    want = jqr._cqr2_fused(jgrid, jnp.asarray(A), jcfg, 4, plan)
    got = tqr._cqr2_fused(tgrid, tensor_from_numpy(A), tcfg, 4, plan)
    _check_qr(A, got, want, "f64")
    if plan == "split":  # the gram of the same rounded Q1 either way
        full = tqr._cqr2_fused(tgrid, tensor_from_numpy(A), tcfg, 4, "full")
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])


def test_panels_tier_matches_jax(jgrid, tgrid):
    A = _tall(1024, 1024, "f64", seed=4)
    jcfg = jqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas")
    tcfg = tqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas")
    want = jqr._cqr2_panels(jgrid, jnp.asarray(A), jcfg, 256)
    got = tqr._cqr2_panels(tgrid, tensor_from_numpy(A), tcfg, 256)
    _check_qr(A, got, want, "f64")


def test_gram_cholinv_route_matches_lapack_route(jgrid, tgrid, monkeypatch):
    # the port's grams from n >= GRAM_CHOLINV_MIN factor through cholinv;
    # lowered to 512 here, against the JAX package's LAPACK route at n=512
    monkeypatch.setattr(tqr, "GRAM_CHOLINV_MIN", 512)
    A = _tall(2048, 512, "f64", seed=5)
    jcfg = jqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas",
                           cholinv=JCholinv(base_case_dim=128))
    tcfg = tqr.CacqrConfig(num_iter=2, regime="1d", mode="pallas",
                           cholinv=CholinvConfig(base_case_dim=128))
    with ttracing.Recorder() as rec:
        got, want = _both(jgrid, tgrid, A, jcfg, tcfg)
    assert rec.stats["CI::trsm"].calls > 0  # cholinv ran on the grams
    _check_qr(A, got, want, "f64")


def test_apply_q_and_qt_match_jax(jgrid, tgrid):
    A = _tall(1024, 512, "f64", seed=6)
    X = np.random.default_rng(7).standard_normal((512, 3))
    Y = np.random.default_rng(8).standard_normal((1024, 3))
    Qj, _ = jqr.factor(jgrid, jnp.asarray(A), jqr.CacqrConfig(regime="1d"))
    Qt, _ = tqr.factor(tgrid, tensor_from_numpy(A), tqr.CacqrConfig(regime="1d"))
    got = tqr.apply_Q(tgrid, Qt, torch.from_numpy(X))
    assert _rel(got, jqr.apply_Q(jgrid, Qj, jnp.asarray(X))) < 1e-12
    got = tqr.apply_QT(tgrid, Qt, torch.from_numpy(Y))
    assert _rel(got, jqr.apply_QT(jgrid, Qj, jnp.asarray(Y))) < 1e-12


BAD = {
    "wide": ((16, 32), dict()),
    "num_iter": ((64, 16), dict(num_iter=3)),
    "regime": ((64, 16), dict(regime="1D")),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_inputs_raise_like_jax(jgrid, tgrid, case):
    shape, kw = BAD[case]
    A = np.zeros(shape)
    with pytest.raises(ValueError) as want:
        jqr.factor(jgrid, jnp.asarray(A), jqr.CacqrConfig(**kw))
    with pytest.raises(ValueError) as got:
        tqr.factor(tgrid, torch.from_numpy(A), tqr.CacqrConfig(**kw))
    assert str(got.value) == str(want.value)


def test_deferred_variants_raise(jgrid, tgrid):
    """The once-deferred variants are ported: regime 'dist' and
    solve_blocked against the JAX package; a grid on another device still
    raises."""
    An = _tall(256, 64, "f64")
    A = torch.from_numpy(An)
    jQ, jR = jax.jit(lambda a: jqr.factor(jgrid, a, jqr.CacqrConfig(regime="dist")))(jnp.asarray(An))
    Q, R = tqr.factor(tgrid, A, tqr.CacqrConfig(regime="dist"))
    assert _rel(Q, jQ) < VS_JAX["f64"] and _rel(R, jR) < VS_JAX["f64"]
    G = An.T @ An
    ccfg = dict(base_case_dim=32, complete_inv=False)
    jcfg = jqr.CacqrConfig(cholinv=JCholinv(**ccfg))
    want = jax.jit(lambda a, g_: jqr.solve_blocked(
        jgrid, a, *jqr.cholesky.factor(jgrid, g_, jcfg.cholinv), jcfg))(jnp.asarray(An), jnp.asarray(G))
    R2, Ri2 = tqr.cholesky.factor(tgrid, torch.from_numpy(G), CholinvConfig(**ccfg))
    got = tqr.solve_blocked(tgrid, A, R2, Ri2, tqr.CacqrConfig(cholinv=CholinvConfig(**ccfg)))
    assert _rel(got, want) < VS_JAX["f64"]
    with pytest.raises(ValueError, match="the grid on"):
        tqr.factor(Grid(device=torch.device("meta")), A, tqr.CacqrConfig())


@pytest.mark.parametrize("n,mode,m", [(1024, "pallas", 1 << 20), (512, "pallas", None),
                                      (256, "pallas", 4096), (1024, "xla", 4096)])
def test_pallas_coupled_agrees(jgrid, tgrid, n, mode, m):
    kw = dict(m=m, dtype=jnp.float32) if m else {}
    tkw = dict(m=m, dtype=torch.float32) if m else {}
    assert tqr.pallas_coupled(tgrid, n, mode, **tkw) == jqr.pallas_coupled(jgrid, n, mode, **kw)


def test_recorder_prices_cqr_phases(tgrid):
    A = torch.from_numpy(_tall(1024, 512, "f64"))
    with ttracing.Recorder() as rec:
        tqr.factor(tgrid, A, tqr.CacqrConfig(regime="1d", mode="pallas"))
    live = 0.625  # g=4 at n=512
    assert rec.stats["CQR::gram"].flops == pytest.approx(2 * 1024 * 512**2 * live)
    assert rec.stats["CQR::fused"].flops == pytest.approx(4 * 1024 * 512**2 * live)
    assert rec.stats["CQR::chol"].calls == 2 and rec.stats["CQR::merge"].calls == 1
    with ttracing.Recorder() as rec, ttracing.muted():
        ttracing.emit(flops=1.0)
        ttracing.note("x")
    assert not rec.stats
    assert ttracing.tsqr_flops(4096, 64, 16) == jtracing.tsqr_flops(4096, 64, 16)


# --------------------------------------------------------------------------
# the robust ladder
# --------------------------------------------------------------------------

M, N = 384, 48


def _robust_pair(jgrid, tgrid, A, **kw):
    jr = jqr.factor(jgrid, jnp.asarray(A), jqr.CacqrConfig(regime="1d", robust=JRobust(**kw)))
    tr = tqr.factor(tgrid, tensor_from_numpy(A), tqr.CacqrConfig(regime="1d",
                                                                   robust=RobustConfig(**kw)))
    return tr, jr


def _same_info(got, want, *, ortho=True):
    g, w = robust_info_to_numpy(got), robust_info_to_numpy(want)
    for k in ("info", "breakdown", "shifted", "escalated", "gate"):
        assert g[k] == w[k], (k, g, w)
    assert g["sigma"] == pytest.approx(w["sigma"], rel=1e-6)
    if ortho:
        assert (g["ortho"] < 0) == (w["ortho"] < 0)


@pytest.mark.parametrize("cond,dt", [(1e3, np.float32), (1e6, np.float64)])
def test_robust_healthy_equals_unguarded(jgrid, tgrid, cond, dt):
    A = _illcond(M, N, cond, dt)
    (Q, R, ri), (_, _, rj) = _robust_pair(jgrid, tgrid, A)
    _same_info(ri, rj)
    assert int(ri.breakdown) == 0 and float(ri.sigma) == 0.0
    Q0, R0 = tqr.factor(tgrid, tensor_from_numpy(A), tqr.CacqrConfig(regime="1d"))
    assert torch.equal(Q, Q0) and torch.equal(R, R0)


@pytest.mark.parametrize("mode,shape", [("xla", (M, N)), ("pallas", (1024, 512))])
def test_rank_deficient_gram_fault_matches_jax(jgrid, tgrid, mode, shape):
    A = _tall(*shape, "f32", seed=9)
    fault = dict(tag="CQR::gram", kind="rank_deficient")
    with jfi.active_plan(jfi.Fault(**fault)) as jplan:
        _, _, rj = jqr.factor(jgrid, jnp.asarray(A),
                              jqr.CacqrConfig(regime="1d", mode=mode, robust=JRobust()))
    with tfi.active_plan(tfi.Fault(**fault)) as tplan:
        Q, _, ri = tqr.factor(tgrid, tensor_from_numpy(A),
                              tqr.CacqrConfig(regime="1d", mode=mode, robust=RobustConfig()))
    assert tplan.fired == jplan.fired == [("CQR::gram", 0)]
    _same_info(ri, rj)
    assert int(ri.breakdown) >= 1 and int(ri.shifted) >= 1
    assert bool(torch.isfinite(Q).all()) and int(ri.info) in (0, shape[1] + 2)


def test_f64_breakdown_recovers_like_jax(jgrid, tgrid):
    A = _illcond(M, N, 1e12, np.float64)
    (Q, R, ri), (_, _, rj) = _robust_pair(jgrid, tgrid, A)
    _same_info(ri, rj)
    assert int(ri.escalated) == 1 and int(ri.info) == 0
    assert 0.0 <= float(ri.ortho) <= 100 * N * trec.unit_roundoff(torch.float64)


def test_beyond_envelope_sentinel_matches_jax(jgrid, tgrid):
    A = _illcond(M, N, 1e6, np.float32)
    (Q, _, ri), (_, _, rj) = _robust_pair(jgrid, tgrid, A)
    _same_info(ri, rj)
    assert int(ri.info) == N + 2 and int(ri.gate) == tconfig.GATE_ORTHO
    assert bool(torch.isfinite(Q).all())
    assert float(ri.ortho) == pytest.approx(float(rj.ortho), rel=1e-4)


def test_tsqr_rung_matches_jax(jgrid, tgrid):
    A = _illcond(M, N, 1e12, np.float32)
    (Q, R, ri), (Qj, Rj, rj) = _robust_pair(jgrid, tgrid, A, tsqr=True)
    _same_info(ri, rj)
    assert int(ri.escalated) == 2 and int(ri.info) == 0
    assert int(ri.gate) == tconfig.GATE_NONE
    A64 = A.astype(np.float64)
    assert np.linalg.norm(A64 - _f64(Q) @ _f64(R)) / np.linalg.norm(A64) < 1e-4


def test_tsqr_matches_jax_at_f64():
    A = _tall(1024, 64, "f64", seed=12)
    Qj, Rj = jtsqr.tsqr(jnp.asarray(A))
    Qt, Rt = ttsqr.tsqr(torch.from_numpy(A))
    for m, n, panel in ((1024, 64, 0), (1000, 64, 100), (100, 64, 0)):
        assert ttsqr.resolve_leaves(m, n, panel) == jtsqr.resolve_leaves(m, n, panel)
        assert ttsqr.resolve_panel(m, n, panel) == jtsqr.resolve_panel(m, n, panel)
    # Householder QR is unique up to column signs: compare sign-normalised
    s = np.sign(np.diag(_f64(Rt))) * np.sign(np.diag(_f64(Rj)))
    assert _rel(_f64(Qt) * s, Qj) < 1e-12 and _rel(_f64(Rt) * s[:, None], Rj) < 1e-12
    # at cond 1e12 the escalation still lands at f64 orthogonality
    A = _illcond(1024, 64, 1e12, np.float64)
    assert float(ttsqr.ortho_gate(ttsqr.tsqr(torch.from_numpy(A))[0])) <= 1e-13
    Qe, Re, ortho = trec.tsqr_escalate(torch.from_numpy(A.astype(np.float32)))
    assert Qe.dtype == trec.escalation_dtype(torch.float32) == torch.float64
    assert float(ortho) <= 1e-13


def test_tsqr_library_route_where_jax_takes_it():
    A = torch.from_numpy(_tall(512, 64, "f64"))
    Q, R = ttsqr.tsqr(A, impl="pallas")  # f64 never takes the f32 kernel
    assert ttsqr.default_impl(128, 64, torch.float64, interpret=True) == "xla"
    assert ttsqr.default_impl(512, 256, torch.float32, interpret=True) == "xla"
    assert ttsqr.default_impl(256, 128, torch.bfloat16, interpret=True) == "pallas"
    assert _rel(Q @ R, A) < 1e-13
    Q, R = ttsqr.tsqr(A.float(), impl="xla")
    assert _rel(Q @ R, A) < 1e-6


def _jax_potrf_trtri(g):
    return jlapack.potrf_trtri(g, uplo="U")


def _port_potrf_trtri(g):
    return tlapack.potrf_trtri(g, uplo="U")


def test_guarded_chol_and_shift_match_jax():
    A = _illcond(64, 8, 1e12, np.float64)
    G = A.T @ A
    want = jrec.guarded_chol(jnp.asarray(G), 64, JRobust(), _jax_potrf_trtri)
    got = trec.guarded_chol(torch.from_numpy(G), 64, RobustConfig(), _port_potrf_trtri)
    assert int(got[2].info) == int(want[2].info) != 0
    assert float(got[2].sigma) == pytest.approx(float(want[2].sigma), rel=1e-12)
    assert int(got[2].info_after) == int(want[2].info_after) == 0
    assert float(trec.sigma_shift(torch.from_numpy(G), 64)) == pytest.approx(
        float(jrec.sigma_shift(jnp.asarray(G), 64)), rel=1e-12)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
                    (torch.float64, jnp.float64)):
        assert trec.unit_roundoff(dt) == jrec.unit_roundoff(jdt)
    detect_only = trec.guarded_chol(torch.from_numpy(G), 64, RobustConfig(recover=False),
                                    _port_potrf_trtri)
    assert float(detect_only[2].sigma) == 0.0 and int(detect_only[2].info_after) != 0


# --------------------------------------------------------------------------
# faultinject, residual gates, interop
# --------------------------------------------------------------------------


def test_faultinject_mechanics():
    assert tfi.tap(torch.ones(2)) is not None
    x = torch.ones(2, 2)
    assert tfi.tap(x) is x
    with pytest.raises(ValueError, match="not in tracing.PHASE_REGISTRY"):
        tfi.Fault(tag="CQR::nope")
    with pytest.raises(ValueError, match="fault kind"):
        tfi.Fault(tag="CQR::gram", kind="meteor")
    with tfi.active_plan(tfi.Fault(tag="CQR::gram", kind="nan", index=1)) as plan:
        y0 = tfi.tap(x, point="CQR::gram")
        y1 = tfi.tap(x, point="CQR::gram")
    assert bool(torch.isfinite(y0).all()) and not bool(torch.isfinite(y1).all())
    assert plan.fired == [("CQR::gram", 1)] and bool(torch.isfinite(x).all())
    assert issubclass(tfi.FaultInjected, RuntimeError)
    with tfi.active_plan(tfi.Fault(tag="CQR::chol", kind="raise")):
        with ttracing.scope("CQR::chol"), pytest.raises(tfi.FaultInjected):
            tfi.tap(x)
    with tfi.active_plan(tfi.Fault(tag="CQR::gram", kind="rank_deficient")):
        y = tfi.tap(torch.ones(4, 4), point="CQR::gram")
    assert bool((y[-1] == 0).all() and (y[:, -1] == 0).all() and (y[:-1, :-1] == 1).all())


def test_without_robust_nan_gram_propagates(tgrid):
    A = torch.from_numpy(_tall(256, 32, "f64", seed=10))
    with tfi.active_plan(tfi.Fault(tag="CQR::gram", kind="nan")):
        Q, _ = tqr.factor(tgrid, A, tqr.CacqrConfig(regime="1d"))
    assert not bool(torch.isfinite(Q).all())


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_qr_gates_match_jax(dt):
    A = _tall(4096, 256, dt, seed=11)
    Qj, Rj = jnp.linalg.qr(jnp.asarray(A).astype(jnp.float32))
    Qn, Rn = np.asarray(Qj).astype(NP_DT[dt]), np.asarray(Rj).astype(NP_DT[dt])
    At, Qt, Rt = (tensor_from_numpy(x) for x in (A, Qn, Rn))
    tol = {"f64": 1e-6, "f32": 1e-4, "bf16": 5e-2}[dt]
    want = float(jres.qr_residual(jnp.asarray(A), jnp.asarray(Qn), jnp.asarray(Rn)))
    assert float(tres.qr_residual(At, Qt, Rt)) == pytest.approx(want, rel=tol)
    blocked = float(tres.qr_residual_blocked(At, Qt, Rt, block_rows=1024))
    assert blocked == pytest.approx(want, rel=tol)
    want = float(jres.qr_orthogonality(jnp.asarray(Qn)))
    assert float(tres.qr_orthogonality(Qt).double()) == pytest.approx(want, rel=tol, abs=1e-3)


def test_cacqr_config_from_fields():
    jcfg = jqr.CacqrConfig(num_iter=1, regime="1d", mode="pallas", precision=None, fused_g=4,
                           cholinv=JCholinv(base_case_dim=128, complete_inv=False,
                                            base_case_dtype=jnp.float32, robust=JRobust()),
                           robust=JRobust(shift_c=7.0, tsqr=True))
    tcfg = cacqr_config_from_fields(dataclasses.asdict(jcfg))
    assert tcfg == tqr.CacqrConfig(
        num_iter=1, regime="1d", mode="pallas", precision=None, fused_g=4,
        cholinv=CholinvConfig(base_case_dim=128, complete_inv=False,
                              base_case_dtype=torch.float32, robust=RobustConfig()),
        robust=RobustConfig(shift_c=7.0, tsqr=True))
    assert cacqr_config_from_fields(dataclasses.asdict(jqr.CacqrConfig())) == tqr.CacqrConfig()


def test_robust_info_to_numpy():
    ri = tconfig.RobustInfo(info=torch.tensor(50, dtype=torch.int32), breakdown=torch.tensor(2),
                            shifted=2, sigma=torch.tensor(0.5), escalated=1,
                            ortho=torch.tensor(0.25, dtype=torch.float64), gate=1)
    out = robust_info_to_numpy(ri)
    assert list(out) == list(tconfig.RobustInfo._fields)
    assert out["info"] == 50 and out["info"].dtype == np.int32
    assert out["sigma"] == 0.5 and out["sigma"].dtype == np.float32
    assert out["ortho"].dtype == np.float32 and out["gate"] == 1
    # a JAX RobustInfo converts the same way
    jout = robust_info_to_numpy(JInfo(*(jnp.asarray(v) for v in (50, 2, 2, 0.5, 1, 0.25, 1))))
    assert jout == out
