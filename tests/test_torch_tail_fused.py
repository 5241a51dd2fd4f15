"""The fused cholinv tail of the port (capital_tpu_torch.ops.hopper.
fused_tail and cholesky.factor with tail_fuse_depth > 0) against the JAX
package's (pallas_tpu.fused_tail in interpret mode, cholesky.factor), on
the CPU.

On the CPU the port's fused_tail runs its plain version, which has no
shared-memory envelope (`hopper.tail_eligible` answers True for CPU
buffers, as interpret mode does for the JAX kernel), so the same subtrees
fuse in both packages; on the card the kernel takes windows up to 168 on
its block route and of 256, 384 and 512 on its cluster route
(tests/test_torch_gpu.py and chip_smoke.py hold that).  Operands are SPD
matrices made with numpy from a seed.

Tolerances: the kernel's window against JAX, relative to the largest
|reference| entry, f32 1e-5 (the port divides by sqrt(d) where the
reference multiplies by rsqrt(d), and sums in another order) and bf16 one
bf16 ulp per entry plus 1e-5 (both compute in f32 and round once); `info`
exactly.  Whole factors, relative Frobenius: f32 1e-5, bf16 2e-2 (as in
tests/test_torch_cholesky.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.ops import pallas_tpu
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.robust.config import RobustConfig as JRobust
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def jgrid():
    return JGrid.square(c=1, devices=jax.devices("cpu")[:1])


@pytest.fixture(scope="module")
def tgrid():
    return Grid.square(device="cpu")


def _spd(n, dt="f32", seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + 3.0 * np.eye(n)).astype(NP_DT[dt])


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, dt):
    got, want = _f64(got), _f64(want)
    scale = np.abs(want).max()
    if dt == "bf16":
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-5 * scale)
    else:
        assert np.abs(got - want).max() <= 1e-5 * scale


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _both(buf, n, off, dest, P, dt):
    zeros = np.zeros((P, P), NP_DT[dt])
    jR, jRI, jinfo = pallas_tpu.fused_tail(jnp.asarray(buf), jnp.asarray(zeros), jnp.asarray(zeros),
                                           off=off, n=n, dest=dest, interpret=True)
    R, RI, info = hopper.fused_tail(tensor_from_numpy(buf), tensor_from_numpy(zeros),
                                    tensor_from_numpy(zeros.copy()), off=off, n=n, dest=dest)
    return (jR, jRI, int(jinfo)), (R, RI, int(info))


# 384 and 512: windows the card's cluster route takes
@pytest.mark.parametrize("n,dt", [(128, "f32"), (256, "f32"), (128, "bf16"), (384, "bf16"), (512, "f32")])
def test_fused_tail_matches_jax(n, dt):
    P, off, dest = 2 * n, n, 0
    buf = _spd(P, dt, seed=n)
    (jR, jRI, ji), (R, RI, i) = _both(buf, n, off, dest, P, dt)
    assert i == ji == 0
    _close(R, jR, dt)
    _close(RI, jRI, dt)
    assert not R[n:].any() and not RI[:, n:].any()  # only the dest window is written


def test_garbage_lower_half_ignored():
    A = _spd(128)
    bad = A.copy()
    bad[np.tril_indices(128, -1)] = np.nan
    outs = [hopper.fused_tail(tensor_from_numpy(w), torch.zeros(128, 128), torch.zeros(128, 128),
                              off=0, n=128, dest=0) for w in (A, bad)]
    assert int(outs[0][2]) == int(outs[1][2]) == 0
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_fused_tail_cluster_window_fault_info_matches_jax():
    buf = _spd(512, seed=9)
    buf[300, 300] = -1.0
    (_, _, ji), (_, _, i) = _both(buf, 512, 0, 0, 512, "f32")
    assert i == ji == 301


@pytest.mark.parametrize("fault", [(40, 40, -1.0), (0, 7, np.nan), (3, 9, np.inf), (5, 5, -np.inf),
                                   (127, 127, 0.0)])
def test_fused_tail_info_matches_jax(fault):
    buf = _spd(128, seed=3)
    buf[fault[0], fault[1]] = fault[2]
    (_, _, ji), (_, _, i) = _both(buf, 128, 0, 0, 128, "f32")
    assert i == ji and i > 0


# ---- the factor ---------------------------------------------------------------


def _factor_pair(jgrid, tgrid, A, robust=False, **kw):
    jcfg = jchol.CholinvConfig(mode="pallas", robust=JRobust() if robust else None, **kw)
    want = jax.jit(lambda a: jchol.factor(jgrid, a, jcfg))(jnp.asarray(A))
    cfg = tchol.CholinvConfig(mode="pallas", robust=RobustConfig() if robust else None, **kw)
    return want, tchol.factor(tgrid, tensor_from_numpy(A), cfg)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_factor_depth2_matches_jax_and_unfused(jgrid, tgrid, dt):
    A = _spd(512, dt, seed=4)
    (jR, jRi), (R, Ri) = _factor_pair(jgrid, tgrid, A, base_case_dim=128, tail_fuse_depth=2)
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    R0, Ri0 = tchol.factor(tgrid, tensor_from_numpy(A), tchol.CholinvConfig(mode="pallas", base_case_dim=128))
    assert _rel(R, R0) < VS_JAX[dt] and _rel(Ri, Ri0) < VS_JAX[dt]


def test_partial_depth_and_complete_inv(jgrid, tgrid):
    # depth 1 at n = 512: the two 256 subtrees fuse, the root does not;
    # complete_inv=False keeps a top-level window unfused (depth 2 at 256)
    A = _spd(512, seed=5)
    with tracing.Recorder() as rec:
        (jR, jRi), (R, Ri) = _factor_pair(jgrid, tgrid, A, base_case_dim=128, tail_fuse_depth=1)
    assert rec.stats["CI::tail_fused"].calls == 2
    assert rec.stats["CI::tail_fused"].flops == 2 * jtracing.fused_tail_flops(256)
    assert _rel(R, jR) < 1e-5 and _rel(Ri, jRi) < 1e-5
    B = _spd(256, seed=6)
    with tracing.Recorder() as rec:
        (jR, jRi), (R, Ri) = _factor_pair(jgrid, tgrid, B, base_case_dim=128, tail_fuse_depth=2,
                                          complete_inv=False)
    assert rec.stats["CI::tail_fused"].calls == 2
    assert _rel(R, jR) < 1e-5 and _rel(Ri, jRi) < 1e-5


@pytest.mark.parametrize("depth,where", [(1, None), (1, 40), (1, 200), (0, 40), (2, 300)])
def test_robust_info_matches_jax(jgrid, tgrid, depth, where):
    # the faults of tests/test_tail_fused.py::TestRobustInfo; the fused
    # window's in-kernel info reports the true pivot, the unfused factor the
    # leaf's NaN-filled one
    A = _spd(256 if where is None or where < 256 else 512, seed=7)
    if where is not None:
        A[where, where] = -1.0
    (_, _, jinfo), (R, Ri, info) = _factor_pair(jgrid, tgrid, A, base_case_dim=128,
                                                tail_fuse_depth=depth, robust=True)
    assert int(info) == int(jinfo)
    if where is not None and depth:
        assert int(info) == where + 1
        for X in (R, Ri):  # the dead lower triangle stays exactly zero
            assert not torch.tril(X, -1).any()


def test_factor_fuses_384_windows_like_jax(jgrid, tgrid):
    # the cluster route's middle window: depth 1 at bc = 384 fuses the two
    # 384 children of n = 768 (complete_inv=False keeps the root unfused)
    A = _spd(768, seed=10)
    with tracing.Recorder() as rec:
        (jR, jRi), (R, Ri) = _factor_pair(jgrid, tgrid, A, base_case_dim=384, tail_fuse_depth=1,
                                          complete_inv=False)
    assert rec.stats["CI::tail_fused"].calls == 2
    assert rec.stats["CI::tail_fused"].flops == 2 * jtracing.fused_tail_flops(384)
    assert _rel(R, jR) < 1e-5 and _rel(Ri, jRi) < 1e-5


def test_f64_is_gated_out(tgrid):
    A = tensor_from_numpy(_spd(256, "f64", seed=8))
    cfg = tchol.CholinvConfig(mode="pallas", base_case_dim=128, tail_fuse_depth=2)
    node = tchol.plan(256, cfg)
    assert not tchol._tail_fusible(tgrid, A, 0, node, cfg, True, torch.zeros(256, 256, dtype=A.dtype))
    R1, Ri1 = tchol.factor(tgrid, A, cfg)
    R0, Ri0 = tchol.factor(tgrid, A, tchol.CholinvConfig(mode="pallas", base_case_dim=128))
    assert torch.equal(R1, R0) and torch.equal(Ri1, Ri0)


def test_tail_eligible_envelope():
    # the card's routes: one block holds the window's two f32 tiles up to
    # round4(n) = 168; a cluster takes 256, 384 and 512; f64 stays unfused
    for n, ok in ((128, True), (168, True), (169, False), (170, False), (256, True), (384, True),
                  (512, True), (640, False), (1024, False)):
        for dt in (torch.float32, torch.bfloat16):
            assert hopper.tail_eligible(n, dt, interpret=False) == ok, (n, dt)
    for n in (128, 256, 512):
        assert not hopper.tail_eligible(n, torch.float64, interpret=False)
    assert hopper.tail_eligible(512, torch.bfloat16, interpret=True)
    assert hopper.tail_eligible(640, torch.float32, interpret=True)
    assert tracing.fused_tail_flops(128) == jtracing.fused_tail_flops(128)


def test_tail_route_and_cluster_shape():
    assert [hopper.tail_route(n) for n in (1, 16, 128, 160, 168, 169, 255, 256, 384, 512, 640)] == [
        "block", "block", "block", "block", "block", None, None, "cluster", "cluster", "cluster", None]
    room = hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    # block route: two tiles of round4(n) rows, 16-byte rows 4 mod 8 where both fit
    assert hopper.tail_smem_bytes(128) == 2 * 4 * 128 * 132
    assert hopper.tail_smem_bytes(168) == 2 * 4 * 168 * 172 <= room < hopper.tail_smem_bytes(169)
    assert hopper.tail_smem_bytes(130) == 2 * 4 * 132 * 132
    # cluster route: n / blocks rows of the square (ld n + 4 when n is 0 mod 8),
    # the 16 x n panel, R⁻¹'s diagonal, L11ᵀ, two sets of 16 roots and a flag
    assert hopper.tail_cluster_smem_bytes(512, 8) == 4 * (64 * 516 + 16 * 512 + 64 + 256 + 32 + 4)
    assert hopper.tail_cluster_smem_bytes(384, 4) == 4 * (96 * 388 + 16 * 384 + 96 + 256 + 32 + 4)
    # the cluster sizes the kernel takes (2, 4 or 8 blocks splitting the
    # 16-row panels evenly, their rows in a block); each window's is one of them
    fits = {(n, b) for n in (256, 384, 512) for b in (2, 4, 8)
            if n % (16 * b) == 0 and hopper.tail_cluster_smem_bytes(n, b) <= room}
    assert fits == {(256, 2), (256, 4), (256, 8), (384, 4), (384, 8), (512, 8)}
    assert hopper.TAIL_CLUSTER_WINDOWS == (256, 384, 512)
    assert {(n, b) for n, b in hopper.TAIL_CLUSTER_BLOCKS.items()} <= fits


def test_fused_tail_refuses_misaligned_windows():
    buf = torch.zeros(256, 256)
    with pytest.raises(ValueError, match="alignment"):
        hopper.fused_tail(buf, torch.zeros(256, 256), torch.zeros(256, 256), off=64, n=128, dest=0)
    with pytest.raises(ValueError, match="alignment"):
        hopper.fused_tail(buf, torch.zeros(256, 256), torch.zeros(256, 128), off=0, n=128, dest=0)
    with pytest.raises(ValueError, match="overlap"):
        hopper.fused_tail(buf, buf, torch.zeros(256, 256), off=0, n=128, dest=0)
    # the JAX package's message for the same misalignment
    with pytest.raises(ValueError, match="alignment"):
        pallas_tpu.fused_tail(jnp.zeros((256, 256)), jnp.zeros((256, 256)), jnp.zeros((256, 256)),
                              off=64, n=128, dest=0, interpret=True)

