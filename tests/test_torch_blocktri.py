"""The port's block-tridiagonal chain driver (capital_tpu_torch/models/
blocktri.py) against the JAX package's (capital_tpu/models/blocktri.py):
`posv` in every impl (the kernel loop, the partitioned Spike driver, the
library route, auto), `factor` / `solve` / `extend` / `contract`, the
dispatch rules and the breakdown `info`.

Operands are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas steps in interpret mode, as tests/test_blocktri.py
runs them, jitted once per geometry at module level.  On the CPU the port's
kernel route runs the kernels' plain versions.  Shapes stay small (b = 4,
nblocks <= 8; 16 for the auto-partitioned case).

Tolerances, relative to the largest |reference| entry: f64 1e-10, f32
1e-5, bf16 2e-2.  `info` is compared exactly, under the faults of
tests/test_blocktri.py and the partitioned backward-pollution case of
tests/test_blocktri_par.py too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import blocktri as ref
from capital_tpu.robust import detect as detect_ref
from capital_tpu_torch.models import blocktri as bt
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.robust import detect
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import tensor_from_numpy

TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _chain(seed, batch, nblocks, b, k):
    """tests/test_blocktri.py's operand recipe: gram/b + 3I diagonals,
    0.3/√b couplings, C[:, 0] dead."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, nblocks, b, b))
    D = G @ G.transpose(0, 1, 3, 2) / b + 3.0 * np.eye(b)
    C = 0.3 / np.sqrt(b) * rng.standard_normal((batch, nblocks, b, b))
    C[:, 0] = 0.0
    B = rng.standard_normal((batch, nblocks, b, k))
    return D, C, B


def _dense_solve(D, C, B):
    out = []
    for j in range(D.shape[0]):
        nblocks, b = D.shape[1], D.shape[2]
        A = np.zeros((nblocks * b, nblocks * b))
        for i in range(nblocks):
            sl = slice(i * b, (i + 1) * b)
            A[sl, sl] = D[j, i]
            if i:
                up = slice((i - 1) * b, i * b)
                A[sl, up] = C[j, i]
                A[up, sl] = C[j, i].T
        out.append(np.linalg.solve(A, B[j].reshape(nblocks * b, -1)).reshape(B.shape[1:]))
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _ref(name, **kw):
    return jax.jit(functools.partial(getattr(ref, name), **kw))


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


def _posv_both(D, C, B, dt, **kw):
    X, info = _ref("posv", **kw)(_j(D, dt), _j(C, dt), _j(B, dt))
    Xp, infop = bt.posv(_t(D, dt), _t(C, dt), _t(B, dt), **kw)
    return (np.asarray(X), np.asarray(info)), (Xp, infop)


@pytest.mark.parametrize("impl,dt,nblocks,kw", [
    ("pallas", "float32", 4, dict(seg=2)),
    ("pallas", "bfloat16", 4, dict(seg=2)),
    ("xla", "float32", 4, {}),
    ("xla", "float64", 4, {}),
    ("pallas", "float64", 4, {}),          # forced pallas never downgrades f64
    ("partitioned", "float32", 8, dict(partitions=2, partition_inner="pallas")),
    ("partitioned", "float64", 8, dict(partitions=2)),
    ("partitioned", "float32", 8, dict(partitions=4, partition_inner="xla")),
    ("auto", "float32", 4, {}),            # below PARTITION_MIN_NBLOCKS: the kernel loop
    ("auto", "float32", 16, {}),           # from it on: partitioned, pallas inside
])
def test_posv_matches_reference(impl, dt, nblocks, kw):
    D, C, B = _chain(10 + nblocks, 2, nblocks, 4, 2)
    (X, info), (Xp, infop) = _posv_both(D, C, B, dt, impl=impl, **kw)
    assert str(Xp.dtype).endswith(dt)
    _close(Xp, X, dt)
    assert np.array_equal(infop.numpy(), info.astype(np.int32)) and not info.any()
    ref64 = _dense_solve(D, C, B)
    assert np.abs(_f64(Xp) - ref64).max() <= max(TOL[dt], 5e-5 if dt != "bfloat16" else 5e-2) * 10 * np.abs(ref64).max()


def test_auto_at_the_flagship_length_is_partitioned():
    assert bt.posv_algorithm(64, torch.float32) == ref.posv_algorithm(64, jnp.float32) == "partitioned"
    assert bt.posv_algorithm(64, torch.float64) == ref.posv_algorithm(64, jnp.float64) == "scan"


@pytest.mark.parametrize("impl,dt", [("pallas", "float32"), ("xla", "float64"), ("xla", "float32")])
def test_factor_and_solve_match_reference(impl, dt):
    D, C, B = _chain(20, 2, 4, 4, 3)
    L, Wt, info = _ref("factor", impl=impl, seg=2)(_j(D, dt), _j(C, dt))
    Lp, Wtp, infop = bt.factor(_t(D, dt), _t(C, dt), impl=impl, seg=2)
    _close(Lp, L, dt)
    _close(Wtp, Wt, dt)
    assert np.array_equal(infop.numpy(), np.asarray(info).astype(np.int32)) and not infop.any()
    assert torch.equal(Lp, torch.tril(Lp)) and not Wtp[:, 0].any()
    # the factor gate: L_i·L_iᵀ + W_i·W_iᵀ rebuilds D_i, W_i·L_{i−1}ᵀ rebuilds C_i
    Ln, Wn = _f64(Lp), _f64(Wtp).transpose(0, 1, 3, 2)
    for i in range(4):
        Di = Ln[:, i] @ Ln[:, i].transpose(0, 2, 1) + (Wn[:, i] @ Wn[:, i].transpose(0, 2, 1) if i else 0)
        assert np.abs(Di - D[:, i]).max() < 1e-5 * np.abs(D).max()
        if i:
            assert np.abs(Wn[:, i] @ Ln[:, i - 1].transpose(0, 2, 1) - C[:, i]).max() < 1e-5
    X = _ref("solve", impl=impl, seg=2)(L, Wt, _j(B, dt))
    Xp = bt.solve(Lp, Wtp, _t(B, dt), impl=impl, seg=2)
    _close(Xp, X, dt)
    Xposv, _ = bt.posv(_t(D, dt), _t(C, dt), _t(B, dt), impl=impl, seg=2)
    _close(Xp, Xposv.numpy(), dt)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_extend_is_bitwise_a_full_refactor(impl):
    D, C, _ = _chain(30, 2, 8, 4, 1)
    Dt, Ct = torch.from_numpy(D).float(), torch.from_numpy(C).float()
    L, Wt, info = bt.factor(Dt, Ct, impl=impl, seg=2)
    L1, Wt1, _ = bt.factor(Dt[:, :4], Ct[:, :4], impl=impl, seg=2)
    L2, Wt2, info2 = bt.extend(Dt[:, 4:], Ct[:, 4:], L1[:, -1], impl=impl, seg=2, offset=16)
    assert torch.equal(torch.cat([L1, L2], 1), L) and torch.equal(torch.cat([Wt1, Wt2], 1), Wt)
    assert not info2.any() and not info.any()
    Lr, Wtr, infor = _ref("extend", impl=impl, seg=2, offset=16)(
        jnp.asarray(D[:, 4:], jnp.float32), jnp.asarray(C[:, 4:], jnp.float32), jnp.asarray(L1[:, -1].numpy()))
    _close(L2, Lr, "float32")
    _close(Wt2, Wtr, "float32")
    with pytest.raises(ValueError, match="L_last must be"):
        bt.extend(Dt[:, 4:], Ct[:, 4:], L1[:1, -1])


def test_extend_info_offset_matches_reference():
    D, C, _ = _chain(31, 1, 4, 4, 1)
    D[0, 2] = np.diag([1.0, 1.0, -5.0, 1.0])
    C[0, 2] = 0.0
    Lc = np.broadcast_to(np.eye(4), (1, 4, 4)).astype(np.float32)
    for offset in (0, 12):
        _, _, info = _ref("extend", impl="pallas", offset=offset)(
            jnp.asarray(D, jnp.float32), jnp.asarray(C, jnp.float32), jnp.asarray(Lc))
        _, _, infop = bt.extend(torch.from_numpy(D).float(), torch.from_numpy(C).float(),
                                torch.from_numpy(Lc), impl="pallas", offset=offset)
        assert int(infop[0]) == int(info[0]) == offset + 2 * 4 + 3


def test_contract_then_solve_matches_reference():
    D, C, B = _chain(32, 2, 8, 4, 2)
    L, Wt, _ = bt.factor(torch.from_numpy(D).float(), torch.from_numpy(C).float(), impl="pallas", seg=4)
    Lk, Wtk = bt.contract(L, Wt, 3)
    assert torch.equal(Lk, L[:, 3:]) and torch.equal(Wtk, Wt[:, 3:])
    # bitwise what extend replays from the dropped prefix's last factor
    Le, Wte, _ = bt.extend(torch.from_numpy(D[:, 3:]).float(), torch.from_numpy(C[:, 3:]).float(),
                           L[:, 2], impl="pallas", seg=5)
    assert torch.equal(Le, Lk) and torch.equal(Wte, Wtk)
    X = _ref("solve", impl="pallas", seg=5)(jnp.asarray(Lk.numpy()), jnp.asarray(Wtk.numpy()),
                                           jnp.asarray(B[:, 3:], jnp.float32))
    Xp = bt.solve(Lk, Wtk, torch.from_numpy(B[:, 3:]).float(), impl="pallas", seg=5)
    _close(Xp, X, "float32")
    for k in (-1, 8):
        with pytest.raises(ValueError, match="k must be in"):
            bt.contract(L, Wt, k)


# ---------------------------------------------------------------------------
# breakdown info
# ---------------------------------------------------------------------------


def test_negative_pivot_exact_global_index():
    D, C, B = _chain(40, 1, 4, 4, 1)
    D[0, 2] = np.diag([1.0, 1.0, -5.0, 1.0])
    C[0, 2] = 0.0
    _, _, info = _ref("factor", impl="pallas")(jnp.asarray(D, jnp.float32), jnp.asarray(C, jnp.float32))
    _, _, infop = bt.factor(torch.from_numpy(D).float(), torch.from_numpy(C).float(), impl="pallas")
    assert int(infop[0]) == int(info[0]) == 2 * 4 + 3
    _, _, info = _ref("factor", impl="xla")(jnp.asarray(D), jnp.asarray(C))
    _, _, infop = bt.factor(torch.from_numpy(D), torch.from_numpy(C), impl="xla")
    assert int(infop[0]) == int(info[0]) and 2 * 4 + 1 <= int(infop[0]) <= 3 * 4


@pytest.mark.parametrize("impl,dt", [("xla", "float64"), ("pallas", "float32"), ("pallas", "bfloat16")])
@pytest.mark.parametrize("fault", ["nan", "inf_offdiag", "nan_coupling"])
def test_fault_contained_to_its_problem(impl, dt, fault):
    D, C, B = _chain(41, 2, 4, 4, 2)
    clean = bt.posv(_t(D, dt), _t(C, dt), _t(B, dt), impl=impl, seg=2)[0]
    if fault == "nan":
        D[1, 1, 0, 0] = np.nan
    elif fault == "inf_offdiag":
        D[1, 2, 1, 3] = np.inf
    else:
        C[1, 3, 2, 0] = np.nan
    (X, info), (Xp, infop) = _posv_both(D, C, B, dt, impl=impl, seg=2)
    assert np.array_equal(infop.numpy(), info.astype(np.int32))
    assert infop[0] == 0 and infop[1] != 0
    assert torch.equal(Xp[0], clean[0])


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, -50.0])
def test_library_block_cholesky_breakdown_matches_reference(value):
    # the library route's block Cholesky against jnp.linalg.cholesky: a NaN
    # pivot runs on (NaN trailing triangle), any other breakdown NaN-fills;
    # the info and the NaN pattern agree, symmetric and one-sided faults
    rng = np.random.default_rng(17)
    for _ in range(40):
        n = int(rng.integers(2, 9))
        G = rng.standard_normal((n, n))
        S = G @ G.T / n + rng.uniform(-0.5, 2.0) * np.eye(n)
        r, c = (int(x) for x in rng.integers(0, n, 2))
        S[r, c] = value
        if rng.random() < 0.5:
            S[c, r] = value
        L = np.asarray(jnp.linalg.cholesky(jnp.asarray(S)))
        Lp = bt._chol_block(torch.from_numpy(S)[None])[0].numpy()
        assert np.array_equal(np.isnan(Lp), np.isnan(L))
        assert int(detect_ref.factor_info(jnp.asarray(L))) == int(detect.factor_info(torch.from_numpy(Lp)))


@pytest.mark.parametrize("dt,inner", [("float64", "auto"), ("float32", "pallas")])
@pytest.mark.parametrize("where", [("nan", 4), ("nan", 3), ("neg", 5)])
def test_partitioned_info_matches_reference(dt, inner, where):
    # an identity chain (zero couplings), P = 2, m = 4: separators at
    # blocks 3 and 7.  A NaN in interior 1 (block 4) pollutes separator 0's
    # reduced diagonal backwards; the combine masks that edge
    kind, g = where
    D = np.broadcast_to(np.eye(4), (2, 8, 4, 4)).copy()
    C = np.zeros((2, 8, 4, 4))
    B = np.ones((2, 8, 4, 1))
    if kind == "nan":
        D[1, g, 0, 0] = np.nan
    else:
        D[0, g, 2, 2] = -1.0
    (X, info), (Xp, infop) = _posv_both(D, C, B, dt, impl="partitioned", partitions=2,
                                        partition_inner=inner)
    assert np.array_equal(infop.numpy(), info.astype(np.int32))
    bad = 1 if kind == "nan" else 0
    assert infop[1 - bad] == 0 and infop[bad] >= g * 4 + 1
    if kind == "neg":
        assert g * 4 < int(infop[0]) <= (g + 1) * 4


# ---------------------------------------------------------------------------
# dispatch, assembly, phases
# ---------------------------------------------------------------------------


def test_dispatch_rules_match_reference():
    for n in range(1, 70):
        for s in (0, 1, 3, 8, 16):
            assert bt.resolve_seg(n, s) == ref.resolve_seg(n, s)
        for p in (0, 2, 3, 8):
            assert bt.resolve_partitions(n, p) == ref.resolve_partitions(n, p)
    for impl in bt.IMPLS:
        for n in (4, 7, 16, 64):
            for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
                assert bt.posv_algorithm(n, dt, impl=impl) == ref.posv_algorithm(n, jdt, impl=impl)
                got = bt._resolve_impl(impl, dt, 4, 2, 2, True, "fused_forward", nblocks=n,
                                       allow_partitioned=True)
                want = ref._resolve_impl(impl, jdt, 4, 2, 2, True, nblocks=n, allow_partitioned=True)
                assert got == want
    assert bt.IMPLS == ref.IMPLS and bt.ALGORITHMS == ref.ALGORITHMS
    assert bt.PARTITION_MIN_NBLOCKS == ref.PARTITION_MIN_NBLOCKS
    D = torch.zeros((1, 4, 4, 4))
    for fn in ("factor", "posv"):
        with pytest.raises(ValueError) as r:
            getattr(ref, fn)(*[jnp.zeros((1, 4, 4, 4))] * (2 if fn == "factor" else 3), impl="cuda")
        with pytest.raises(ValueError) as p:
            getattr(bt, fn)(*[D] * (2 if fn == "factor" else 3), impl="cuda")
        assert str(p.value) == str(r.value)
    with pytest.raises(ValueError, match="posv-only"):
        bt.factor(D, D, impl="partitioned")
    with pytest.raises(ValueError, match="partition_inner"):
        bt.posv(D, D, D, impl="partitioned", partition_inner="cuda")
    with pytest.raises(ValueError, match="must match D"):
        bt.posv(D, D[:, :2], D)


def test_assemble_and_dead_coupling():
    D, C, B = _chain(50, 2, 3, 4, 1)
    C[:, 0] = 7.0  # dead: ignored, and the caller's C is not written
    A = ref.assemble(jnp.asarray(D), jnp.asarray(C))
    Ct = torch.from_numpy(C)
    assert np.array_equal(bt.assemble(torch.from_numpy(D), Ct).numpy(), np.asarray(A))
    X, _ = bt.posv(torch.from_numpy(D), Ct, torch.from_numpy(B), impl="xla")
    C0 = C.copy()
    C0[:, 0] = 0
    X0, _ = bt.posv(torch.from_numpy(D), torch.from_numpy(C0), torch.from_numpy(B), impl="xla")
    assert torch.equal(X, X0) and bool((Ct[:, 0] == 7).all())


def test_phases_price_the_chain():
    D, C, B = _chain(51, 2, 8, 4, 2)
    Dt, Ct, Bt = (torch.from_numpy(x).float() for x in (D, C, B))
    hopper.reset_counts()
    with tracing.Recorder() as rec:
        bt.posv(Dt, Ct, Bt, impl="pallas")
    assert rec.stats["BT::factor"].flops == 2 * (tracing.blocktri_chol_flops(8, 4)
                                                 + tracing.blocktri_solve_flops(8, 4, 2))
    assert rec.stats["BT::solve"].flops == 2 * tracing.blocktri_solve_flops(8, 4, 2)
    with tracing.Recorder() as rec:
        bt.posv(Dt, Ct, Bt, impl="partitioned", partitions=2)
    assert rec.stats["BT::partition"].flops == 2 * tracing.blocktri_partition_flops(8, 4, 2, 2)
    assert rec.stats["BT::reduce"].flops == 2 * tracing.blocktri_reduce_flops(2, 4, 2)
    assert not any(hopper.counts().values())  # CPU tensors launch nothing


def test_vectorized_combine_is_the_window_fold():
    # every local status a block can report (0, a pivot, the b + 1 sentinel,
    # out-of-range garbage), at random, against the reference's fold
    from capital_tpu.robust import detect as rdetect
    from capital_tpu_torch.robust import detect

    rng = np.random.default_rng(52)
    for nblocks, b, offset in ((8, 4, 0), (5, 16, 48), (64, 128, 0)):
        infos = rng.choice([0, 0, 0, 1, 2, b, b + 1, b + 2], size=(64, nblocks)).astype(np.int32)
        n = offset + nblocks * b
        got = detect.combine_window_infos(torch.from_numpy(infos), b, n, offset)
        want = rdetect.combine_block_infos(jnp.zeros(64, jnp.int32),
                                           [(offset + i * b, b, jnp.asarray(infos[:, i])) for i in range(nblocks)], n)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(bt._combine(torch.from_numpy(infos), nblocks, b, offset).numpy(), np.asarray(want))
