"""The port's cholinv (capital_tpu_torch.models.cholesky) against the JAX
package's (capital_tpu.models.cholesky), on the CPU.

The JAX side runs as its own tests run it: Pallas in interpret mode on a
one-device CPU grid, under jit.  The port runs its plain kernel versions on
the CPU, where the plain zeros_dead_lower leaves NaN in every tile the
recursion should write — so any live tile left unwritten shows up here.
Inputs are SPD matrices made with numpy from a seed.

Tolerances (stated per dtype):
* against JAX, relative Frobenius difference of R and of R⁻¹: f64 1e-12,
  f32 1e-5 (sums in a different order), bf16 2e-2 (R is rounded to bf16 at
  every recursion level, and one-ulp differences in an early level carry
  through the Schur chain);
* residual gates, computed in f64 on the returned factors: f64 1e-13 (the
  reference's 1e-14 class, with room for n up to 512), f32 2e-6, bf16 1e-2
  (bf16 keeps 8 significant bits: 2^-8 ≈ 4e-3 per entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.robust.config import RobustConfig as JRobust
from capital_tpu.utils import residual as jres
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils import tracing as ttracing
from capital_tpu_torch.utils.interop import config_from_fields, tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 2e-6, "bf16": 1e-2}

_JAX_CACHE: dict = {}


@pytest.fixture(scope="module")
def jgrid():
    return JGrid.square(c=1, devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def tgrid():
    return Grid.square(device="cpu")


def _spd(n: int, dt: str, seed: int = 0) -> np.ndarray:
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + 3.0 * np.eye(n)).astype(NP_DT[dt])


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_factor(jgrid, A: np.ndarray, **cfg_kw):
    """JAX reference factor, cached by operand and config (one jit compile
    per distinct config keeps this file's run time down)."""
    key = (A.tobytes(), A.dtype.str, tuple(sorted(cfg_kw.items())))
    if key not in _JAX_CACHE:
        cfg = jchol.CholinvConfig(mode=cfg_kw.pop("mode", "pallas"), **cfg_kw)
        _JAX_CACHE[key] = jax.jit(lambda a: jchol.factor(jgrid, a, cfg))(jnp.asarray(A))
    return _JAX_CACHE[key]


def _port_cfg(**kw):
    return tchol.CholinvConfig(mode=kw.pop("mode", "pallas"), **kw)


def _gates(A: np.ndarray, R, Rinv, dt: str) -> None:
    A64 = torch.tensor(_f64(A))
    R64, RI64 = torch.tensor(_f64(R)), torch.tensor(_f64(Rinv))
    assert float(tres.cholesky_residual(A64, R64)) < GATE[dt]
    assert float(tres.cholesky_inverse_residual(R64, RI64)) < GATE[dt]


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("n,bc,split", [(256, 128, 1), (384, 256, 1), (512, 128, 1), (512, 128, 2)])
def test_factor_matches_jax(jgrid, tgrid, n, bc, split, dt):
    """mode='pallas' across base_case_dim, split and padding (384 pads to
    512 with bc=256)."""
    A = _spd(n, dt)
    jR, jRi = _jax_factor(jgrid, A, base_case_dim=bc, split=split)
    R, Ri = tchol.factor(tgrid, tensor_from_numpy(A), _port_cfg(base_case_dim=bc, split=split))
    assert R.shape == (n, n) and Ri.shape == (n, n)
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    _gates(A, R, Ri, dt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_xla_mode_matches_jax(jgrid, tgrid, dt):
    A = _spd(384, dt, seed=1)
    jR, jRi = _jax_factor(jgrid, A, base_case_dim=128, mode="xla")
    R, Ri = tchol.factor(tgrid, tensor_from_numpy(A), _port_cfg(base_case_dim=128, mode="xla"))
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    _gates(A, R, Ri, dt)


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_schur_in_place(jgrid, tgrid, dt):
    """schur_in_place writes into the operand: the port gets a copy."""
    A = _spd(512, dt, seed=2)
    jR, jRi = _jax_factor(jgrid, A, base_case_dim=128, schur_in_place=True)
    At = tensor_from_numpy(A)
    work = At.clone()
    R, Ri = tchol.factor(tgrid, work, _port_cfg(base_case_dim=128, schur_in_place=True))
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    assert not torch.equal(work, At)  # the copy really was written into
    _gates(A, R, Ri, dt)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_operand_unchanged_without_schur_in_place(tgrid, mode):
    A = tensor_from_numpy(_spd(512, "f32", seed=3))
    before = A.clone()
    tchol.factor(tgrid, A, _port_cfg(base_case_dim=128, mode=mode))
    assert torch.equal(A, before)


@pytest.mark.parametrize("dt", ["f64", "bf16"])
def test_out_buffers_reuse(jgrid, tgrid, dt):
    """Two iterations factoring into the previous outputs give the fresh
    factor of each operand."""
    cfg = _port_cfg(base_case_dim=128)
    A1, A2 = _spd(512, dt, seed=4), _spd(512, dt, seed=5)
    bufs = tchol.factor_buffers(tgrid, 512, tensor_from_numpy(A1).dtype, cfg)
    R1, Ri1 = tchol.factor(tgrid, tensor_from_numpy(A1), cfg, out_buffers=bufs)
    assert R1 is bufs[0] and Ri1 is bufs[1]
    R2, Ri2 = tchol.factor(tgrid, tensor_from_numpy(A2), cfg, out_buffers=(R1, Ri1))
    jR, jRi = _jax_factor(jgrid, A2, base_case_dim=128)
    assert _rel(R2, jR) < VS_JAX[dt] and _rel(Ri2, jRi) < VS_JAX[dt]
    _gates(A2, R2, Ri2, dt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_complete_inv_false(jgrid, tgrid, dt):
    A = _spd(512, dt, seed=6)
    jR, jRi = _jax_factor(jgrid, A, base_case_dim=128, complete_inv=False)
    R, Ri = tchol.factor(tgrid, tensor_from_numpy(A), _port_cfg(base_case_dim=128, complete_inv=False))
    k = tchol.top_split(512, _port_cfg(base_case_dim=128))
    assert k == 256
    assert torch.all(Ri[:k, k:] == 0)
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]


def test_base_prefetch_bitwise(tgrid):
    A = tensor_from_numpy(_spd(512, "bf16", seed=7))
    R2, Ri2 = tchol.factor(tgrid, A, _port_cfg(base_case_dim=128, base_prefetch=2))
    R1, Ri1 = tchol.factor(tgrid, A, _port_cfg(base_case_dim=128, base_prefetch=1))
    assert torch.equal(R1, R2) and torch.equal(Ri1, Ri2)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("where", [40, 200])
def test_robust_info_matches_jax(jgrid, tgrid, where, dt):
    """A broken SPD matrix gives the same LAPACK-style info in both."""
    A = _spd(256, dt, seed=8)
    A[where, where] = -50.0
    jR, jRi, jinfo = _jax_factor(jgrid, A, base_case_dim=128, robust=JRobust())
    R, Ri, info = tchol.factor(tgrid, tensor_from_numpy(A),
                               _port_cfg(base_case_dim=128, robust=RobustConfig()))
    assert int(info) == int(jinfo) != 0
    clean = _spd(256, dt, seed=8)
    _, _, info0 = tchol.factor(tgrid, tensor_from_numpy(clean),
                               _port_cfg(base_case_dim=128, robust=RobustConfig()))
    assert int(info0) == 0


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("where", [5, 40])
def test_robust_info_on_a_nan_pivot_matches_jax(jgrid, tgrid, where, mode):
    """A NaN pivot does not stop the reference's potrf: its factor stays
    finite before the pivot, so info names the pivot (6, 41), not the
    leaf's first row."""
    A = _spd(64, "f32", seed=9)
    A[where, where] = np.nan
    _, _, jinfo = _jax_factor(jgrid, A, base_case_dim=16, mode=mode, robust=JRobust())
    _, _, info = tchol.factor(tgrid, tensor_from_numpy(A),
                              _port_cfg(base_case_dim=16, mode=mode, robust=RobustConfig()))
    assert int(info) == int(jinfo) == where + 1


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_solve_and_spd_inverse(jgrid, tgrid, dt):
    A = _spd(384, dt, seed=9)
    B = np.random.default_rng(10).standard_normal((384, 3)).astype(NP_DT[dt])
    jcfg = jchol.CholinvConfig(mode="pallas", base_case_dim=128)
    cfg = _port_cfg(base_case_dim=128)
    jX = jax.jit(lambda a, b: jchol.solve(jgrid, a, b, jcfg))(jnp.asarray(A), jnp.asarray(B))
    X = tchol.solve(tgrid, tensor_from_numpy(A), tensor_from_numpy(B), cfg)
    assert _rel(X, jX) < VS_JAX[dt]
    jinv = jax.jit(lambda a: jchol.spd_inverse(jgrid, a, jcfg))(jnp.asarray(A))
    inv = tchol.spd_inverse(tgrid, tensor_from_numpy(A), cfg)
    assert _rel(inv, jinv) < VS_JAX[dt]
    # the f32-floor gate of the reference, in both packages
    got = float(tres.inverse_residual(tensor_from_numpy(A), inv))
    want = float(jres.inverse_residual(jnp.asarray(A), jinv))
    assert got < 100 * GATE[dt] and want < 100 * GATE[dt]


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_residual_gates_match_jax(dt):
    """utils/residual against capital_tpu/utils/residual on one factor."""
    A = _spd(256, dt, seed=11)
    R = np.linalg.cholesky(_spd(256, "f64", seed=11)).T.astype(NP_DT[dt])
    Ri = np.linalg.inv(R.astype(np.float64)).astype(NP_DT[dt])
    Ai = np.linalg.inv(A.astype(np.float64)).astype(NP_DT[dt])
    tA, tR, tRi, tAi = (tensor_from_numpy(x) for x in (A, R, Ri, Ai))
    jA, jR, jRi, jAi = (jnp.asarray(x) for x in (A, R, Ri, Ai))
    tol = {"f64": 1e-6, "f32": 1e-3, "bf16": 0.5}[dt]  # residuals of residuals
    for got, want in (
        (tres.cholesky_residual(tA, tR), jres.cholesky_residual(jA, jR)),
        (tres.cholesky_inverse_residual(tR, tRi), jres.cholesky_inverse_residual(jR, jRi)),
        (tres.inverse_residual(tA, tAi), jres.inverse_residual(jA, jAi)),
        (tres.rel_fro(tR, tA), jres.rel_fro(jR, jA)),
    ):
        g, w = float(got), float(want)
        assert abs(g - w) <= tol * max(abs(w), 1e-30) + 1e-15


def test_probe_residuals_track_dense_gates(tgrid):
    A = tensor_from_numpy(_spd(256, "f64", seed=12))
    R, Ri = tchol.factor(tgrid, A, _port_cfg(base_case_dim=128))
    v = torch.from_numpy(np.random.default_rng(13).standard_normal((256, 4)))
    assert float(tres.cholesky_probe_residual(A, R, v)) < 1e-13
    assert float(tres.inverse_probe_residual(R, Ri, v)) < 1e-13
    Rbad = R.clone()
    Rbad[3, 100] += 1e-3
    assert float(tres.cholesky_probe_residual(A, Rbad, v)) > 1e-6


def test_config_from_jax_fields(jgrid, tgrid):
    """A JAX CholinvConfig crosses over through dataclasses.asdict."""
    jcfg = jchol.CholinvConfig(
        mode="pallas", base_case_dim=128, base_case_dtype=jnp.float32,
        schur_in_place=True, robust=JRobust(),
    )
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.base_case_dtype == torch.float32
    assert cfg.policy.name == jcfg.policy.name
    assert cfg.robust == RobustConfig()
    assert {f.name for f in dataclasses.fields(cfg)} == {
        f.name for f in dataclasses.fields(jcfg)
    }
    A = _spd(256, "bf16", seed=14)
    jR, jRi, _ = jax.jit(lambda a: jchol.factor(jgrid, a, jcfg))(jnp.asarray(A))
    R, Ri, info = tchol.factor(tgrid, tensor_from_numpy(A), cfg)
    assert int(info) == 0
    assert _rel(R, jR) < VS_JAX["bf16"] and _rel(Ri, jRi) < VS_JAX["bf16"]


@pytest.mark.parametrize("kw,match", [(dict(balance="tile_cyclic"), "requires mode='explicit'")])
def test_unported_options_raise(jgrid, tgrid, kw, match):
    """The balanced layouts are ported: outside mode 'explicit' both
    packages refuse them with one message; in mode 'explicit' on one device
    the kernels skip dead tiles themselves, and both factor alike and note
    the fallback."""
    A = _spd(256, "f32")
    with pytest.raises(ValueError, match=match) as want:
        jchol.factor(jgrid, jnp.asarray(A), jchol.CholinvConfig(mode="pallas", base_case_dim=128, **kw))
    with pytest.raises(ValueError, match=match) as got:
        tchol.factor(tgrid, tensor_from_numpy(A), _port_cfg(base_case_dim=128, **kw))
    assert str(got.value) == str(want.value)
    kw = dict(kw, mode="explicit", base_case_dim=128, balance_min_window=128)
    with jtracing.Recorder() as jrec:
        jR, jRi = jax.jit(lambda a: jchol.factor(jgrid, a, jchol.CholinvConfig(**kw)))(jnp.asarray(A))
    with ttracing.Recorder() as trec:
        R, Ri = tchol.factor(tgrid, tensor_from_numpy(A), _port_cfg(**kw))
    assert _rel(R, jR) < VS_JAX["f32"] and _rel(Ri, jRi) < VS_JAX["f32"]
    for note in ("trmm::tile_cyclic_fallback", "syrk::tile_cyclic_fallback"):
        assert trec.stats[note].calls == jrec.stats[note].calls >= 1
