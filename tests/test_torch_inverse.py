"""The port's triangular inversion (capital_tpu_torch.models.inverse:
rectri, newton), its LAPACK-seam helpers (ops/lapack: trtri_newton,
diag_block_stack, trtri_stack) and the write_diag_blocks kernel's plain
version, against the JAX package on the CPU.

The JAX side runs as its own tests run it: under jit on a one-device CPU
grid, Pallas kernels in interpret mode.  The port runs its plain kernel
versions on the CPU; its zeros_dead_lower leaves NaN in every tile it does
not zero, so a window the recursion should write and does not shows up.
Operands are made with numpy from a seed: tril(G, −1)/√n + 3I (the rectri
operand of bench/drivers.py, κ ≈ 2) with finite garbage in the strict upper
triangle, which neither package may read.

Tolerances (relative Frobenius difference against JAX): f64 1e-12, f32 1e-5
(products summed in other orders), bf16 2e-2 (the inverse blocks are
rounded to bf16 before each merge).  Residual gates ‖I − L·L⁻¹‖/‖I‖ in f64
on the returned inverse: f64 1e-13, f32 2e-6, bf16 5e-2 (the bf16
`_tolerance` of bench/drivers.py).  write_diag_blocks is compared bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import inverse as jinv
from capital_tpu.ops import lapack as jlapack
from capital_tpu.ops import pallas_tpu
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu_torch import Grid
from capital_tpu_torch.models import inverse as tinv
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.ops import lapack as tlapack
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import (
    newton_config_from_fields,
    rectri_config_from_fields,
    tensor_from_numpy,
    tensor_to_numpy,
)

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 2e-6, "bf16": 5e-2}


@pytest.fixture(scope="module")
def jgrid():
    return JGrid.square(c=1, devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def tgrid():
    return Grid.square(device="cpu")


def _tri(n, dt, seed=0, uplo="L"):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + 3.0 * np.eye(n)
    L += np.triu(rng.standard_normal((n, n)), 1)  # garbage in the dead triangle
    return (L if uplo == "L" else L.T.copy()).astype(NP_DT[dt])


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _gate(T, Tinv, uplo, dt):
    T64 = np.tril(_f64(T)) if uplo == "L" else np.triu(_f64(T))
    n = T64.shape[0]
    err = np.linalg.norm(np.eye(n) - T64 @ _f64(Tinv)) / np.sqrt(n)
    assert err < GATE[dt], err


def _jax_rectri(jgrid, T, uplo, **kw):
    cfg = jinv.RectriConfig(**kw)
    return jax.jit(lambda a: jinv.rectri(jgrid, a, uplo, cfg))(jnp.asarray(T))


# (n, bc, batch_below): base-only prefixes (4 blocks, and 384 → p = 512),
# a merge level in the prefix (256), the prefix off (0), and p % bc != 0
# (500 at bc=160 → p = 512: no prefix, uneven halving down to 128 leaves)
# — every case in f64, a spread of them in f32 and bf16
CASES = [(n, bc, bb, "f64") for n, bc, bb in [(256, 128, -1), (384, 128, -1), (512, 128, -1),
                                             (512, 128, 256), (512, 128, 0), (500, 160, -1)]]
CASES += [(384, 128, -1, "f32"), (512, 128, 256, "f32"), (500, 160, -1, "f32"),
          (256, 128, -1, "bf16"), (512, 128, 0, "bf16")]


@pytest.mark.parametrize("n,bc,bb,dt", CASES)
def test_rectri_matches_jax(jgrid, tgrid, n, bc, bb, dt):
    T = _tri(n, dt, seed=n + bc)
    want = _jax_rectri(jgrid, T, "L", base_case_dim=bc, mode="pallas", batch_below=bb)
    cfg = tinv.RectriConfig(base_case_dim=bc, mode="pallas", batch_below=bb)
    got = tinv.rectri(tgrid, tensor_from_numpy(T), "L", cfg)
    assert got.shape == (n, n) and got.dtype == tensor_from_numpy(T).dtype
    assert _rel(got, want) < VS_JAX[dt]
    assert not torch.triu(got, 1).any()  # the dead triangle is exactly zero
    _gate(T, got, "L", dt)


@pytest.mark.parametrize("n,bc,dt", [(256, 128, "f64"), (500, 160, "f32"), (256, 128, "bf16")])
def test_rectri_upper_matches_jax(jgrid, tgrid, n, bc, dt):
    T = _tri(n, dt, seed=7, uplo="U")
    want = _jax_rectri(jgrid, T, "U", base_case_dim=bc, mode="pallas")
    got = tinv.rectri(tgrid, tensor_from_numpy(T), "U", tinv.RectriConfig(base_case_dim=bc, mode="pallas"))
    assert got.is_contiguous() and not torch.tril(got, -1).any()
    assert _rel(got, want) < VS_JAX[dt]
    _gate(T, got, "U", dt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_rectri_xla_mode_matches_jax(jgrid, tgrid, dt):
    T = _tri(384, dt, seed=8)
    want = _jax_rectri(jgrid, T, "L", base_case_dim=128, mode="xla")
    got = tinv.rectri(tgrid, tensor_from_numpy(T), "L", tinv.RectriConfig(base_case_dim=128, mode="xla"))
    assert _rel(got, want) < VS_JAX[dt]


def test_rectri_phases_and_prefix_plan(tgrid):
    T = tensor_from_numpy(_tri(512, "f32", seed=9))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.Recorder() as rec:
            tinv.rectri(tgrid, T, "L", tinv.RectriConfig(base_case_dim=128, mode="pallas"))
    scopes = {e.key for e in prof.key_averages() if e.key.startswith("RT::")}
    assert scopes == {"RT::buffers", "RT::batch_base", "RT::batch_write", "RT::merge"}
    assert rec.stats["RT::merge"].calls == 2 * 3  # two trmms per merge, 4 blocks
    jg = JGrid.square(c=1, devices=jax.devices("cpu")[:1])
    for p, bc, bb in [(49152, 512, -1), (4096, 512, -1), (4096, 512, 2048), (4096, 512, 0),
                      (4000, 512, -1), (1024, 128, 100)]:
        want = jinv._batched_prefix_size(jg, p, jinv.RectriConfig(base_case_dim=bc, batch_below=bb))
        got = tinv._batched_prefix_size(tgrid, p, tinv.RectriConfig(base_case_dim=bc, batch_below=bb))
        assert got == want, (p, bc, bb)


def test_rectri_refuses(jgrid, tgrid):
    # balance='tile_cyclic' is ported: on one device it has no balanced
    # schedule and inverts as the JAX package does
    T = _tri(64, "f32")
    want = _jax_rectri(jgrid, T, "L", balance="tile_cyclic")
    got = tinv.rectri(tgrid, tensor_from_numpy(T), "L", tinv.RectriConfig(balance="tile_cyclic"))
    assert _rel(got, want) < VS_JAX["f32"]
    T = tensor_from_numpy(T)
    with pytest.raises(ValueError, match="uplo"):
        tinv.rectri(tgrid, T, "X")
    with pytest.raises(ValueError, match="square"):
        tinv.rectri(tgrid, T[:, :32])


# ---- write_diag_blocks: the plain version against the Pallas kernel -------


@pytest.mark.parametrize("s,dts", [(128, ("bf16", "bf16")), (128, ("f32", "bf16")),
                                   (256, ("f64", "f64")), (48, ("f32", "f32")),
                                   # sizes the card's route rule (hopper.write_diag_route)
                                   # sends to 'vec' at several store widths, and 100: 'elem'
                                   (24, ("f64", "bf16")), (40, ("bf16", "f32")),
                                   (64, ("f32", "f64")), (100, ("bf16", "bf16"))])
def test_write_diag_blocks_matches_jax_bitwise(s, dts):
    count, p = 3, 3 * s + 64
    rng = np.random.default_rng(s)
    W = rng.standard_normal((count, s, s)).astype(NP_DT[dts[0]])
    out = np.full((p, p), np.nan).astype(NP_DT[dts[1]])
    want = pallas_tpu.write_diag_blocks(jnp.asarray(out), jnp.asarray(W), interpret=True)
    got = hopper.write_diag_blocks(tensor_from_numpy(out), tensor_from_numpy(W))
    want_bits = np.asarray(want).view(np.uint16) if dts[1] == "bf16" else np.asarray(want)
    got_np = tensor_to_numpy(got)
    if dts[1] == "bf16":
        assert np.array_equal(got_np, want_bits)
    else:
        assert np.array_equal(got_np, want_bits, equal_nan=True)
    assert int(np.isnan(_f64(got)).sum()) == p * p - count * s * s


def test_write_diag_blocks_refuses_what_jax_clips():
    W = torch.zeros((3, 16, 16))
    with pytest.raises(ValueError, match="do not fit"):
        hopper.write_diag_blocks(torch.zeros((40, 40)), W)
    with pytest.raises(ValueError, match="square"):
        hopper.write_diag_blocks(torch.zeros((48, 64)), W)
    with pytest.raises(ValueError, match="stack"):
        hopper.write_diag_blocks(torch.zeros((48, 48)), W[0])


# ---- the LAPACK-seam helpers ------------------------------------------------


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("unit", [False, True])
def test_trtri_newton_matches_jax(dt, unit):
    D = np.stack([_tri(64, dt, seed=s) for s in range(3)])
    if unit:
        D[:, np.arange(64), np.arange(64)] = np.nan  # never read
    want = jlapack.trtri_newton(jnp.asarray(D), unit_diag=unit)
    got = tlapack.trtri_newton(tensor_from_numpy(D), unit_diag=unit)
    assert got.dtype == tensor_from_numpy(D).dtype
    assert _rel(got, want) < VS_JAX[dt]


@pytest.mark.parametrize("o,s,stride", [(0, 32, 32), (32, 32, 64), (0, 64, 64)])
def test_diag_block_stack_matches_jax(o, s, stride):
    X = np.random.default_rng(o + s).standard_normal((2, 256, 256))
    assert np.array_equal(tlapack.diag_block_stack(torch.from_numpy(X[0]), o, s, stride).numpy(),
                          np.asarray(jlapack.diag_block_stack(jnp.asarray(X[0]), o, s, stride)))
    assert np.array_equal(tlapack.diag_block_stack(torch.from_numpy(X), o, s, stride).numpy(),
                          np.asarray(jlapack.diag_block_stack(jnp.asarray(X), o, s, stride)))


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("uplo,bc,inner,unit", [("L", 256, 128, False), ("U", 256, 64, True),
                                                ("L", 96, 128, False)])
def test_trtri_stack_matches_jax(dt, uplo, bc, inner, unit):
    D = np.stack([_tri(bc, dt, seed=s, uplo=uplo) for s in range(2)])
    want = jlapack.trtri_stack(jnp.asarray(D), uplo=uplo, unit_diag=unit, inner=inner)
    got = tlapack.trtri_stack(tensor_from_numpy(D), uplo=uplo, unit_diag=unit, inner=inner)
    assert _rel(got, want) < VS_JAX[dt]


# ---- newton -----------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_newton_matches_jax(jgrid, tgrid, dt, tol):
    g = np.random.default_rng(11).standard_normal((64, 64))
    A = (g @ g.T / 64 + 3 * np.eye(64)).astype(NP_DT[dt])
    cfg = jinv.NewtonConfig(tol=tol)
    jX, jit_ = jax.jit(lambda a: jinv.newton(jgrid, a, cfg))(jnp.asarray(A))
    X, it = tinv.newton(tgrid, torch.from_numpy(A), newton_config_from_fields(dataclasses.asdict(cfg)))
    assert it == int(jit_) and it < cfg.max_iter
    assert _rel(X, jX) < VS_JAX[dt]


def test_newton_budget_stops_the_loop(tgrid):
    A = torch.eye(16, dtype=torch.float64) * 2.0
    A[0, 1] = 0.5
    X, it = tinv.newton(tgrid, A, tinv.NewtonConfig(tol=0.0, max_iter=3))
    assert it == 3


def test_config_from_fields_round_trip():
    j = jinv.RectriConfig(base_case_dim=512, mode="pallas", batch_below=0)
    assert dataclasses.asdict(rectri_config_from_fields(dataclasses.asdict(j))) == dataclasses.asdict(j)
    j = jinv.NewtonConfig(tol=1e-3, max_iter=7)
    assert dataclasses.asdict(newton_config_from_fields(dataclasses.asdict(j))) == dataclasses.asdict(j)
