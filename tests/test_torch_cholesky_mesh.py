"""cholinv and rectri on a mesh: the port's (capital_tpu_torch, in-process
mesh of CPU ranks) against the JAX package's (the conftest's virtual CPU
devices, Pallas in interpret mode, under jit), with mode 'explicit'.

At n = 1024, bc = 256 on 2x2x1 the top node's three trmms take the sched
route (per-rank `sched_matmul`) and every smaller node the K-segment
fallback (a 256-wide shard tiles to one k-tile: nothing to skip).

Tolerances, relative Frobenius difference of R and R⁻¹ against JAX: f64
1e-10, f32 1e-5 (sums in a different order), bf16 2e-2 (R is rounded to
bf16 at every recursion level) — the VS_JAX class of test_torch_cholesky.
Residual gates in f64 on the returned factors: f64 1e-13, f32 2e-6, bf16
1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.models import inverse as jinv
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.robust.config import RobustConfig as JRobust
from capital_tpu.utils import tracing as jtracing
from capital_tpu.utils.config import BaseCasePolicy as JPolicy
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.models import inverse as tinv
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils import tracing as ttracing
from capital_tpu_torch.utils.config import BaseCasePolicy
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-10, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 2e-6, "bf16": 1e-2}


def _grids(c):
    return (JGrid.square(c=c, devices=jax.devices("cpu")[: 4 * c]),
            Grid.square(c=c, devices=["cpu"] * (4 * c)))


def _spd(n, dt, seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + 3.0 * np.eye(n)).astype(NP_DT[dt])


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _sched_notes(rec):
    return rec.stats["explicit::shard_sched"].calls if "explicit::shard_sched" in rec.stats else 0


def _factor_both(c, A, **kw):
    """The JAX and the port factor of A on a 2x2xc grid, mode 'explicit',
    with the explicit::shard_sched note counts of each."""
    jg, tg = _grids(c)
    jkw = dict(kw)
    if "policy" in jkw:
        jkw["policy"] = JPolicy[jkw["policy"].name]
    if "robust" in jkw:
        jkw["robust"] = JRobust()
    jcfg = jchol.CholinvConfig(mode="explicit", **jkw)
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda a: jchol.factor(jg, a, jcfg))(jnp.asarray(A))
    with ttracing.Recorder() as trec:
        got = tchol.factor(tg, tensor_from_numpy(A), tchol.CholinvConfig(mode="explicit", **kw))
    return got, want, _sched_notes(trec), _sched_notes(jrec)


def _gates(A, R, Rinv, dt):
    A64, R64, RI64 = (torch.tensor(_f64(x)) for x in (A, R, Rinv))
    assert float(tres.cholesky_residual(A64, R64)) < GATE[dt]
    assert float(tres.cholesky_inverse_residual(R64, RI64)) < GATE[dt]


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_cholinv_2x2x1_matches_jax(dt):
    A = _spd(1024, dt)
    (R, Ri), (jR, jRi), tn, jn = _factor_both(1, A, base_case_dim=256)
    assert R.shape == (1024, 1024)
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    assert tn == jn == 3  # the top node's three trmms
    _gates(A, R, Ri, dt)


@pytest.mark.parametrize("c,policy", [(1, "NO_REPLICATION"), (2, "REPLICATE_COMP"),
                                      (2, "NO_REPLICATION_OVERLAP")])
def test_base_case_policies_match_jax(c, policy):
    n = 512 if c == 1 else 256
    A = _spd(n, "f64", seed=3)
    (R, Ri), (jR, jRi), tn, jn = _factor_both(c, A, base_case_dim=n // 4,
                                               policy=BaseCasePolicy[policy])
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]
    assert tn == jn
    _gates(A, R, Ri, "f64")


def test_cholinv_2x2x2_matches_jax():
    """c > 1: every product on the masked-psum route, no kernel."""
    A = _spd(256, "f64", seed=4)
    (R, Ri), (jR, jRi), tn, jn = _factor_both(2, A, base_case_dim=64)
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]
    assert tn == jn == 0
    _gates(A, R, Ri, "f64")


def test_padding_and_complete_inv_false_match_jax():
    """n = 768 pads to 1024 (diag(A, I)); the top-level R⁻¹ block stays
    zero with complete_inv=False."""
    A = _spd(768, "f64", seed=5)
    (R, Ri), (jR, jRi), tn, jn = _factor_both(1, A, base_case_dim=256, complete_inv=False)
    assert R.shape == (768, 768)
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]
    assert tn == jn == 1  # the top node's trsm only: its completion is skipped
    assert float(Ri[:512, 512:].abs().max()) == 0.0


@pytest.mark.parametrize("where", [5, 600])
def test_info_on_a_nan_pivot_matches_jax(where):
    A = _spd(1024, "f32", seed=6)
    A[where, where] = np.nan
    (_, _, info), (_, _, jinfo), _, _ = _factor_both(1, A, base_case_dim=256, robust=RobustConfig())
    assert int(info) == int(jinfo) != 0


@pytest.mark.parametrize("dt", ["f64", "bf16"])
def test_rectri_2x2x1_matches_jax(dt):
    n = 1024
    rng = np.random.default_rng(7)
    L = (np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + 3.0 * np.eye(n)
         + np.triu(rng.standard_normal((n, n)), 1)).astype(NP_DT[dt])  # garbage above
    jg, tg = _grids(1)
    jcfg = jinv.RectriConfig(base_case_dim=256, mode="explicit")
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda t: jinv.rectri(jg, t, "L", jcfg))(jnp.asarray(L))
    with ttracing.Recorder() as trec:
        got = tinv.rectri(tg, tensor_from_numpy(L), "L",
                          tinv.RectriConfig(base_case_dim=256, mode="explicit"))
    assert _rel(got, want) < VS_JAX[dt]
    assert _sched_notes(trec) == _sched_notes(jrec) == 2  # the top merge's two trmms
    L64 = np.tril(_f64(L))
    err = np.linalg.norm(np.eye(n) - L64 @ _f64(got)) / np.sqrt(n)
    assert err < {"f64": 1e-13, "bf16": 5e-2}[dt]


def test_rectri_refuses_the_tile_cyclic_layout_and_newton_the_mesh():
    """Both are ported: rectri with balance='tile_cyclic' and newton on a
    2x2x1 mesh, each against the JAX package (the name is the test's
    history; it no longer refuses)."""
    jg, tg = _grids(1)
    n = 512
    rng = np.random.default_rng(8)
    L = np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + 3.0 * np.eye(n)
    kw = dict(base_case_dim=64, mode="explicit", balance="tile_cyclic", balance_min_window=64)
    want = jax.jit(lambda t: jinv.rectri(jg, t, "L", jinv.RectriConfig(**kw)))(jnp.asarray(L))
    got = tinv.rectri(tg, torch.from_numpy(L), "L", tinv.RectriConfig(**kw))
    assert _rel(got, want) < VS_JAX["f64"]
    A = L + L.T
    jX, jit_ = jax.jit(lambda a: jinv.newton(jg, a, jinv.NewtonConfig(mode="explicit")))(jnp.asarray(A))
    X, it = tinv.newton(tg, torch.from_numpy(A), tinv.NewtonConfig(mode="explicit"))
    assert it == int(jit_) and _rel(X, jX) < VS_JAX["f64"]
