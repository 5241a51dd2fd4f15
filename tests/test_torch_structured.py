"""The port's block-arrowhead and banded solvers (capital_tpu_torch/models/
arrowhead.py, banded.py) against the JAX package's
(capital_tpu/models/arrowhead.py, banded.py), and against
scipy.linalg.solveh_banded and dense numpy solves.

Operands are made with numpy from a seed; the JAX side runs its Pallas
steps in interpret mode, jitted once per geometry.  Shapes stay small
(b <= 8, nblocks <= 8, n <= 40).  Tolerances, relative to the largest
|reference| entry: f64 1e-10, f32 1e-5, bf16 2e-2; `info` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from capital_tpu.models import arrowhead as rah
from capital_tpu.models import banded as rbd
from capital_tpu_torch.models import arrowhead, banded
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import tensor_from_numpy

TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _arrow(seed, batch, nblocks, b, s, k):
    """tests/test_arrowhead.py's recipe: the blocktri chain family, a border
    at 0.3/√(nblocks·b), a corner with a 5I margin."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, nblocks, b, b))
    D = G @ G.transpose(0, 1, 3, 2) / b + 3.0 * np.eye(b)
    C = 0.3 / np.sqrt(b) * rng.standard_normal((batch, nblocks, b, b))
    C[:, 0] = 0.0
    F = 0.3 / np.sqrt(nblocks * b) * rng.standard_normal((batch, nblocks, s, b))
    S0 = rng.standard_normal((batch, s, s))
    S = S0 @ S0.transpose(0, 2, 1) / s + 5.0 * np.eye(s)
    B = rng.standard_normal((batch, nblocks, b, k))
    Bs = rng.standard_normal((batch, s, k))
    return D, C, F, S, B, Bs


def _dense(D, C, F, S):
    nblocks, b, s = D.shape[0], D.shape[1], F.shape[1]
    n_t = nblocks * b
    A = np.zeros((n_t + s, n_t + s))
    for i in range(nblocks):
        sl = slice(i * b, (i + 1) * b)
        A[sl, sl] = D[i]
        if i:
            up = slice((i - 1) * b, i * b)
            A[sl, up] = C[i]
            A[up, sl] = C[i].T
        A[n_t:, sl] = F[i]
        A[sl, n_t:] = F[i].T
    A[n_t:, n_t:] = S
    return A


@functools.lru_cache(maxsize=None)
def _ref(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def _j(x, dt):
    return jnp.asarray(np.asarray(x)).astype(JDT[dt])


def _t(x, dt):
    return tensor_from_numpy(np.array(jnp.asarray(np.asarray(x)).astype(JDT[dt])))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, dt):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL[dt] * scale, np.abs(got - want).max() / scale


# ---------------------------------------------------------------------------
# arrowhead
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,dt,kw", [
    ("pallas", "float32", dict(seg=2)),
    ("pallas", "bfloat16", dict(seg=2)),
    ("xla", "float64", {}),
    ("partitioned", "float32", dict(partitions=2, partition_inner="pallas")),
    ("partitioned", "float64", dict(partitions=2)),
])
def test_arrowhead_posv_matches_reference(impl, dt, kw):
    D, C, F, S, B, Bs = _arrow(60, 2, 4, 4, 3, 2)
    # the reference's corner Cholesky takes no bf16 on the CPU: a bf16 port
    # run is held to the reference's f32 run on the same (rounded) operands
    rdt = "float32" if dt == "bfloat16" else dt
    X, Xs, info = _ref(rah.posv, impl=impl, **kw)(
        *(_j(_f64(_j(o, dt)), rdt) for o in (D, C, F, S, B, Bs)))
    Xp, Xsp, infop = arrowhead.posv(*(_t(o, dt) for o in (D, C, F, S, B, Bs)), impl=impl, **kw)
    assert Xp.dtype == Xsp.dtype == _t(D, dt).dtype
    _close(Xp, X, dt)
    _close(Xsp, Xs, dt)
    assert np.array_equal(infop.numpy(), np.asarray(info).astype(np.int32)) and not infop.any()
    ref = np.linalg.solve(_dense(D[0], C[0], F[0], S[0]),
                          np.concatenate([B[0].reshape(-1, 2), Bs[0]]))
    got = np.concatenate([_f64(Xp[0]).reshape(-1, 2), _f64(Xsp[0])])
    assert np.abs(got - ref).max() <= max(TOL[dt], 1e-4) * 10 * np.abs(ref).max()


@pytest.mark.parametrize("impl,dt", [("pallas", "float32"), ("xla", "float64")])
def test_arrowhead_schur_matches_reference(impl, dt):
    D, C, F, S, _, _ = _arrow(61, 2, 4, 4, 3, 1)
    want = _ref(rah.schur, impl=impl)(*(_j(o, dt) for o in (D, C, F, S)))
    got = arrowhead.schur(*(_t(o, dt) for o in (D, C, F, S)), impl=impl)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, dt)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]).astype(np.int32))
    Ls = _f64(got[2])
    assert np.abs(Ls @ Ls.transpose(0, 2, 1) - _f64(got[1])).max() < 1e-5


@pytest.mark.parametrize("case", ["corner", "chain", "contained"])
def test_arrowhead_info_in_whole_matrix_coordinates(case):
    D, C, F, S, B, Bs = _arrow(62, 2, 3, 4, 3, 1)
    if case == "corner":
        S[0] = np.diag([4.0, -50.0, 4.0])
        F[0] = 0.0
    elif case == "chain":
        D[0, 1] = np.diag([1.0, 1.0, -5.0, 1.0])
        C[0, 1] = C[0, 2] = 0.0
    else:
        S[1] = -np.eye(3)
    for impl, dt in (("xla", "float64"), ("pallas", "float32")):
        *_, info = _ref(rah.posv, impl=impl)(*(_j(o, dt) for o in (D, C, F, S, B, Bs)))
        X, Xs, infop = arrowhead.posv(*(_t(o, dt) for o in (D, C, F, S, B, Bs)), impl=impl)
        assert np.array_equal(infop.numpy(), np.asarray(info).astype(np.int32))
        bad = 1 if case == "contained" else 0
        assert infop[1 - bad] == 0
        assert (12 < int(infop[bad]) <= 16) if case != "chain" else (4 < int(infop[bad]) <= 8)


def test_arrowhead_pack_unpack_assemble_match_reference():
    D, C, F, S, B, Bs = _arrow(63, 2, 3, 4, 2, 3)
    P = arrowhead.pack(*(torch.from_numpy(o) for o in (F, S, B, Bs)))
    assert np.array_equal(P.numpy(), np.asarray(rah.pack(*(jnp.asarray(o) for o in (F, S, B, Bs)))))
    for got, want in zip(arrowhead.unpack(P, 3, 4), (F, S, B, Bs)):
        assert np.array_equal(got.numpy(), want)
    A = rah.assemble(*(jnp.asarray(o) for o in (D, C, F, S)))
    assert np.array_equal(arrowhead.assemble(*(torch.from_numpy(o) for o in (D, C, F, S))).numpy(),
                          np.asarray(A))
    with pytest.raises(ValueError) as r:
        rah.unpack(jnp.asarray(P.numpy()), 3, 5)
    with pytest.raises(ValueError) as p:
        arrowhead.unpack(P, 3, 5)
    assert str(p.value).split(":")[0] == str(r.value).split(":")[0]
    with pytest.raises(ValueError, match="S must be"):
        arrowhead.posv(*(torch.from_numpy(o) for o in (D, C, F, S[:, :1], B, Bs)))


def test_arrowhead_phases():
    D, C, F, S, B, Bs = (torch.from_numpy(o) for o in _arrow(64, 2, 4, 4, 3, 2))
    with tracing.Recorder() as rec:
        arrowhead.posv(D, C, F, S, B, Bs, impl="xla")
    assert rec.stats["AH::schur"].flops == 2 * tracing.arrowhead_schur_flops(4, 4, 3)
    assert rec.stats["AH::border"].flops == 2 * tracing.arrowhead_border_flops(4, 4, 3, 2)


# ---------------------------------------------------------------------------
# banded
# ---------------------------------------------------------------------------


def _spd_band(seed, n, u):
    """tests/test_banded.py's recipe (lower-form storage)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(u + 1):
        A += np.diag(rng.standard_normal(n - d) * (0.4 ** d), -d)
    A = A @ A.T + (u + 1) * np.eye(n)
    ab = np.zeros((u + 1, n))
    for d in range(u + 1):
        ab[d, : n - d] = np.diag(A, -d)
    return ab, A


def _upper_form(ab):
    u, n = ab.shape[0] - 1, ab.shape[1]
    up = np.zeros_like(ab)
    for d in range(u + 1):
        up[u - d, d:] = ab[d, : n - d]
    return up


@pytest.mark.parametrize("n,u,block", [(32, 3, 0), (30, 5, 8), (17, 2, 4), (8, 1, 0)])
@pytest.mark.parametrize("lower", [True, False])
def test_to_blocktri_matches_reference(n, u, block, lower):
    ab, _ = _spd_band(140, n, u)
    store = ab if lower else _upper_form(ab)
    D, C, n_out = rbd.to_blocktri(jnp.asarray(store), lower=lower, block=block)
    Dp, Cp, np_out = banded.to_blocktri(torch.from_numpy(store), lower=lower, block=block)
    assert np_out == n_out == n
    assert np.array_equal(Dp.numpy(), np.asarray(D)) and np.array_equal(Cp.numpy(), np.asarray(C))


@pytest.mark.parametrize("n,u", [(32, 3), (30, 5), (17, 2)])
@pytest.mark.parametrize("lower", [True, False])
def test_solveh_banded_matches_scipy_and_reference(n, u, lower):
    ab, _ = _spd_band(142, n, u)
    rhs = np.random.default_rng(1).standard_normal((n, 2))
    store = ab if lower else _upper_form(ab)
    want = scipy.linalg.solveh_banded(store, rhs, lower=lower)
    x = banded.solveh_banded(store, rhs, lower=lower, device="cpu")
    assert x.dtype == torch.float64 and np.abs(x.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    xr = rbd.solveh_banded(jnp.asarray(store), jnp.asarray(rhs), lower=lower)
    assert np.abs(x.numpy() - np.asarray(xr)).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("kw", [dict(impl="partitioned", partitions=2, partition_inner="xla"),
                                dict(impl="pallas")])
def test_solveh_banded_rides_every_route(kw):
    n, u = 64, 3
    ab, _ = _spd_band(146, n, u)
    rhs = np.random.default_rng(2).standard_normal(n)
    want = scipy.linalg.solveh_banded(ab, rhs, lower=True)
    if kw["impl"] == "pallas":  # the kernel route is f32
        x = banded.solveh_banded(torch.from_numpy(ab).float(), torch.from_numpy(rhs).float(),
                                 lower=True, **kw)
        tol = 1e-5
    else:
        x = banded.solveh_banded(ab, rhs, lower=True, device="cpu", **kw)
        tol = 1e-10
    assert x.shape == (n,) and np.abs(x.double().numpy() - want).max() <= tol * np.abs(want).max()


def test_solveh_banded_rejects_and_raises():
    ab, _ = _spd_band(144, 16, 2)
    with pytest.raises(ValueError, match="rows"):
        banded.solveh_banded(ab, np.zeros((8, 1)), lower=True, device="cpu")
    with pytest.raises(ValueError, match="below the bandwidth"):
        banded.to_blocktri(torch.from_numpy(ab), lower=True, block=1)
    bad = ab.copy()
    bad[0, 5] = -100.0
    with pytest.raises(ValueError, match="positive definite") as p:
        banded.solveh_banded(bad, np.ones(16), lower=True, device="cpu")
    with pytest.raises(ValueError, match="positive definite") as r:
        rbd.solveh_banded(jnp.asarray(bad), jnp.ones(16), lower=True)
    assert str(p.value) == str(r.value)
    for args in ((3, 64), (12, 64), (3, 64, 16), (1, 4)):
        assert banded.resolve_block(*args) == rbd.resolve_block(*args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            banded.solveh_banded(ab, np.ones(16), lower=True)


def _bordered(seed, n=23, u=2, s=3, k=2):
    """tests/test_arrowhead.py's bordered-banded system and its dense f64
    solution."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(1, u + 1):
        v = 0.3 * rng.standard_normal(n - d)
        A[np.arange(n - d) + d, np.arange(n - d)] = v
        A[np.arange(n - d), np.arange(n - d) + d] = v
    A[np.diag_indices(n)] = 4.0 + rng.random(n)
    ab = np.zeros((u + 1, n))
    for d in range(u + 1):
        ab[d, :n - d] = A[np.arange(n - d) + d, np.arange(n - d)]
    Bd = 0.2 * rng.standard_normal((s, n))
    S0 = rng.standard_normal((s, s))
    S = S0 @ S0.T / s + 5.0 * np.eye(s)
    rhs, rhs_c = rng.standard_normal((n, k)), rng.standard_normal((s, k))
    ref = np.linalg.solve(np.block([[A, Bd.T], [Bd, S]]), np.concatenate([rhs, rhs_c]))
    return ab, Bd, S, rhs, rhs_c, ref


@pytest.mark.parametrize("lower", [True, False])
def test_solveh_bordered_matches_dense_and_reference(lower):
    ab, Bd, S, rhs, rhs_c, ref = _bordered(70)
    store = ab if lower else _upper_form(ab)
    x, xs = banded.solveh_bordered(store, Bd, S, rhs, rhs_c, lower=lower, device="cpu")
    got = np.concatenate([x.numpy(), xs.numpy()])
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    xr, xsr = rbd.solveh_bordered(jnp.asarray(store), Bd, S, rhs, rhs_c, lower=lower)
    assert np.abs(got - np.concatenate([np.asarray(xr), np.asarray(xsr)])).max() <= 1e-10 * np.abs(ref).max()
    # the banded part alone against scipy: the border set to zero and the
    # corner solved on its own
    xb, xsb = banded.solveh_bordered(store, 0 * Bd, S, rhs, rhs_c, lower=lower, device="cpu")
    want = scipy.linalg.solveh_banded(store, rhs, lower=lower)
    assert np.abs(xb.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(xsb.numpy() - np.linalg.solve(S, rhs_c)).max() <= 1e-10


def test_solveh_bordered_vector_rhs_and_breakdown():
    ab, Bd, S, rhs, rhs_c, ref = _bordered(71, k=1)
    x, xs = banded.solveh_bordered(ab, Bd, S, rhs[:, 0], rhs_c[:, 0], lower=True, device="cpu")
    assert x.shape == (23,) and xs.shape == (3,)
    assert np.abs(np.concatenate([x.numpy(), xs.numpy()]) - ref[:, 0]).max() < 1e-11
    Sbad = S.copy()
    Sbad[0, 0] = -99.0
    with pytest.raises(ValueError, match="order 24"):
        banded.solveh_bordered(ab, Bd, Sbad, rhs[:, 0], rhs_c[:, 0], lower=True, device="cpu")
    with pytest.raises(ValueError, match="dense rows"):
        banded.solveh_bordered(ab, Bd[:, :-1], S, rhs[:, 0], rhs_c[:, 0], lower=True, device="cpu")
