"""The port's rank-k Cholesky update / downdate (capital_tpu_torch/ops/
update_small.py) against the JAX package's (capital_tpu/ops/update_small.py),
on the CPU.

The reference's rotation sweep runs in Pallas interpret mode (as
tests/test_update.py runs it), the port's through its plain version; the
panel scans run on both libraries' routes.  Operands are made with numpy
from a seed.  Tolerances, relative to the largest |reference| entry of a
healthy problem: sweep f32 1e-5 (the reference's rsqrt and one-hot
write-back round differently), bf16 1e-2 (R' rounds to bf16 once); panel
scan f32 1e-5, f64 1e-12.  `info` and the NaN / inf pattern of R' are
compared exactly; after a fault the finite garbage of the broken problem
is not compared.  Interpret-mode sweeps cost n·k steps, so n <= 16,
k <= 3, and one n = 33, k = 5 case crosses the card kernel's 32-column
lane boundary.  The card kernel's row-streamed order is held to the plain
version bit for bit here, written out with torch f32 ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import update_small as jup
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.ops import update_small as up
from capital_tpu_torch.serve import batching
from capital_tpu_torch.serve.engine import ServeConfig
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
TOL = {"sweep": {"f32": 1e-5, "bf16": 1e-2}, "xla": {"f32": 1e-5, "f64": 1e-12}}
OPS = {"update": (jup.chol_update, up.chol_update, 1.0),
       "downdate": (jup.chol_downdate, up.chol_downdate, -1.0)}


def _operands(batch, n, k, dt, down, seed=0):
    """Upper factors of SPD matrices and a rank-k panel; a downdate's V is
    scaled into the feasible region (tests/test_update.py's 0.1/√n)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, n, n))
    A = G @ G.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    R = np.linalg.cholesky(A).transpose(0, 2, 1)
    V = rng.standard_normal((batch, n, k)) * ((0.1 / np.sqrt(n)) if down else 0.3)
    return R.astype(NP_DT[dt]), V.astype(NP_DT[dt])


def _run(op, R, V, impl):
    jf, tf, _ = OPS[op]
    Rr, ir = jf(jnp.asarray(R), jnp.asarray(V), impl=impl, interpret=True)
    Rp, ip = tf(tensor_from_numpy(R), tensor_from_numpy(V), impl=impl)
    return (np.asarray(jnp.asarray(Rr).astype(jnp.float64)), np.asarray(ir),
            Rp.double().numpy(), ip.numpy())


def _same(ref, got, tol, healthy=None):
    (Rr, ir), (Rp, ip) = ref, got
    assert Rp.shape == Rr.shape
    assert np.array_equal(ip, ir.astype(np.int32))
    assert np.array_equal(np.isnan(Rp), np.isnan(Rr))
    assert np.array_equal(np.isinf(Rp), np.isinf(Rr))
    keep = ir == 0 if healthy is None else healthy
    if keep.any():
        a, b = Rp[keep], Rr[keep]
        assert np.abs(a - b).max() <= tol * np.abs(b).max()
    assert np.all(np.tril(Rp, -1) == 0)  # exactly upper


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["update", "downdate"])
@pytest.mark.parametrize("n,k", [(8, 1), (16, 3), (33, 5)])
def test_sweep_plain_matches_reference(op, dt, n, k):
    R, V = _operands(3, n, k, dt, op == "downdate", seed=n + k)
    Rr, ir, Rp, ip = _run(op, R, V, "pallas")
    assert not ir.any()
    _same((Rr, ir), (Rp, ip), TOL["sweep"][dt])
    # the update really moved the factor: R'ᵀR' = A ± VVᵀ in f64
    R64, V64 = R.astype(np.float64), V.astype(np.float64)
    A1 = R64.transpose(0, 2, 1) @ R64 + OPS[op][2] * V64 @ V64.transpose(0, 2, 1)
    res = np.linalg.norm(Rp.transpose(0, 2, 1) @ Rp - A1) / np.linalg.norm(A1)
    assert res < {"f32": 5e-6, "bf16": 2e-2}[dt]


def _row_streamed(R, V, sign, chunk):
    """The card kernel's order, written out with torch f32 ops: ranks in
    passes of `chunk`, each pass a walk over the rows that applies its
    ranks to a row before the next; a row's dead columns (c < j) are not
    updated, in the row or in v.  info is the first bad step in rank-major
    order, min(q·n + j) % n + 1."""
    batch, n, _ = R.shape
    k = V.shape[-1]
    W = R.float().clone()
    cols = torch.arange(n)
    one = torch.ones(batch)
    key = torch.full((batch,), k * n, dtype=torch.int64)
    for q0 in range(0, k, chunk):
        ranks = range(q0, min(k, q0 + chunk))
        v = {q: V[:, :, q].float().clone() for q in ranks}
        for j in range(n):
            row, live = W[:, j, :].clone(), cols >= j
            for q in ranks:
                d = row[:, j]
                t = v[q][:, j] / torch.where(d != 0, d, one)
                st = sign * t
                c2 = 1.0 + st * t
                good = (d > 0) & (c2 > 0)
                key = torch.where(good, key, torch.clamp(key, max=q * n + j))
                cinv = 1.0 / torch.sqrt(torch.where(good, c2, one))
                nr = torch.where(live, (row + st[:, None] * v[q]) * cinv[:, None], 0.0)
                v[q] = torch.where(live, (v[q] - t[:, None] * row) * cinv[:, None], v[q])
                row = row + (nr - row)
            W[:, j, :] = row
    info = torch.where(key < k * n, key % n + 1, 0).to(torch.int32)
    return torch.triu(W).to(R.dtype), info


@pytest.mark.parametrize("op", ["update", "downdate"])
@pytest.mark.parametrize("chunk", [1, 2, "k"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("n", [8, 33, 37])
def test_row_streamed_order_is_the_sweep_bitwise(n, k, chunk, op):
    """The premise of the card kernel: on finite operands the row-streamed
    order (passes of `chunk` ranks, dead columns skipped) applies the same
    IEEE f32 operations to the same values as the plain version's
    rank-major order, so R' and info agree bit for bit.  A downdate makes
    problem 1 infeasible (finite bad steps: info from rank-major order) and
    for k > 1 gives problem 2 two bad steps that the two orders meet in
    opposite order: rank 0 late (row n − 3), rank 1 early (row 2)."""
    sign = 1.0 if op == "update" else -1.0
    R, V = (torch.from_numpy(x) for x in _operands(3, n, k, "f32", sign < 0, seed=n + k))
    if sign < 0:
        V[1] *= 40.0
        if k > 1:
            V[2, n - 3, 0] = V[2, 2, 1] = 40.0
    Rs, infos = _row_streamed(R, V, sign, k if chunk == "k" else chunk)
    Rp, infop = up.sweep_plain(R, V, sign)
    assert bool(torch.isfinite(Rp).all())  # the premise holds for finite values only
    assert torch.equal(infos, infop) and torch.equal(Rs, Rp)
    if sign < 0:
        assert int(infop[1]) != 0 and (k == 1 or int(infop[2]) == n - 2)


def test_sweep_launch_plan():
    """The card kernel's plan: its route (the wave route for k >= 2 up to
    528 problems), its passes over R (row route: 8 ranks, then the
    remainder's 4, 2 and 1) and problems a block (row route: one a block
    until every SM has one, then up to 8); its shared memory does not grow
    with k or the batch."""
    assert up.passes(0) == [0] and up.passes(1) == [1] and up.passes(8) == [8]
    assert up.passes(5) == [4, 1] and up.passes(7) == [4, 2, 1]
    assert up.passes(64) == [8] * 8 and up.passes(100) == [8] * 12 + [4]
    assert all(sum(up.passes(k)) == k for k in range(200))
    assert [up.problems_per_block(b) for b in (1, 8, 132, 133, 264, 1024, 1056, 8192)] == [1, 1, 1, 2, 2, 8, 8, 8]
    # the wave route: a warp a rank, passes of 8 and the remainder whole
    assert up.passes(5, "wave") == [5] and up.passes(20, "wave") == [8, 8, 4] and up.passes(64, "wave") == [8] * 8
    assert [up.sweep_route(b, k) for b, k in ((8, 1), (8, 2), (8, 8), (8, 64), (528, 8), (529, 8), (8192, 8))] == [
        "row", "wave", "wave", "wave", "wave", "row", "row"]
    # the fault path's tile, or the wave route's rings where they are larger
    # (groups of 4 rows in flight, 4 groups a link)
    assert up.smem_bytes(238) == 4 * (238 * 239 + 3 * 238) and up.smem_bytes(118) == 4 * (118 * 119 + 3 * 118)
    assert up.smem_bytes(1) == up.smem_bytes(32) == 4 * (7 * 4 * 4 * 32 + 56)
    assert up.smem_bytes(117) == 4 * (7 * 4 * 4 * 128 + 56) and up.smem_bytes(132) == 4 * (7 * 4 * 4 * 160 + 56)
    assert up.smem_bytes(133) == 4 * (133 * 134 + 3 * 133)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("op", ["update", "downdate"])
@pytest.mark.parametrize("n,k", [(16, 1), (16, 4), (24, 1), (24, 4)])
def test_panel_scan_matches_reference(op, dt, n, k):
    R, V = _operands(2, n, k, dt, op == "downdate", seed=3 * n + k)
    Rr, ir, Rp, ip = _run(op, R, V, "xla")
    assert not ir.any()
    _same((Rr, ir), (Rp, ip), TOL["xla"][dt])


def _poison(case):
    """One fault in problem 1 of a batch of 3 (n = 8, k = 2)."""
    def f(R, V):
        if case == "infeasible":
            V[1] *= 40.0
            return
        where, idx, val = {
            "nan_diag": ("R", (3, 3), np.nan), "inf_diag": ("R", (4, 4), np.inf),
            "-inf_diag": ("R", (2, 2), -np.inf), "inf_first_pivot": ("R", (0, 0), np.inf),
            "nan_lower": ("R", (5, 2), np.nan), "inf_lower": ("R", (7, 0), np.inf),
            "nan_upper": ("R", (2, 6), np.nan), "nan_V": ("V", (4, 1), np.nan),
            "inf_V": ("V", (6, 0), np.inf), "-inf_V_first_row": ("V", (0, 1), -np.inf),
        }[case]
        (R if where == "R" else V)[(1, *idx)] = val
    return f


FAULTS = ["nan_diag", "inf_diag", "-inf_diag", "inf_first_pivot", "nan_lower", "inf_lower",
          "nan_upper", "nan_V", "inf_V", "-inf_V_first_row", "infeasible"]


@pytest.mark.parametrize("case", FAULTS)
def test_sweep_faults_match_reference(case):
    """info and the NaN / inf pattern of R' after a non-finite input or an
    infeasible downdate, exactly; only the poisoned problem is flagged and
    the others stay within tolerance."""
    op = "downdate" if case == "infeasible" else "update"
    R, V = _operands(3, 8, 2, "f32", op == "downdate", seed=7)
    _poison(case)(R, V)
    Rr, ir, Rp, ip = _run(op, R, V, "pallas")
    assert ir[1] != 0 and ir[0] == ir[2] == 0
    _same((Rr, ir), (Rp, ip), TOL["sweep"]["f32"], healthy=np.array([True, False, True]))


@pytest.mark.parametrize("case", ["nan_diag", "nan_upper", "inf_lower", "nan_V", "infeasible"])
def test_panel_scan_faults_match_reference(case):
    """The panel scan's info (panel resolution) on the same faults; its
    products read the dead lower triangle only into R''s dead triangle,
    which `triu` drops, so a fault there is no fault on this route."""
    op = "downdate" if case == "infeasible" else "update"
    R, V = _operands(3, 8, 2, "f64", op == "downdate", seed=8)
    _poison(case)(R, V)
    Rr, ir, Rp, ip = _run(op, R, V, "xla")
    assert (ir[1] == 0) == (case == "inf_lower") and ir[0] == ir[2] == 0
    assert np.array_equal(ip, ir.astype(np.int32))
    assert np.array_equal(np.isfinite(Rp[[0, 2]]), np.isfinite(Rr[[0, 2]]))
    assert np.abs(Rp[[0, 2]] - Rr[[0, 2]]).max() <= 1e-12 * np.abs(Rr[[0, 2]]).max()


def test_dispatch_matches_reference():
    for n in (8, 16, 64, 96, 128, 129, 256):
        for k in (1, 8, 64):
            assert up.resolve_panel(n, k) == jup.resolve_panel(n, k)
            assert up.resolve_panel(n, k, 5) == jup.resolve_panel(n, k, 5)
            for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                             (torch.float64, jnp.float64)):
                for interpret in (True, False):
                    want = jup.default_impl(n, k, jdt, interpret=interpret)
                    assert up.default_impl(n, k, tdt, interpret=interpret) == want
                assert up.dtype_capable(tdt) == jup.dtype_capable(jdt)
    # the card's envelope: the (n, n + 1) f32 tile, V streamed
    assert up.smem_bytes(128) == 67584
    assert up.eligible(128, 4096, torch.float32, interpret=False)
    assert up.eligible(238, 1, torch.float32, interpret=False)
    assert not up.eligible(239, 1, torch.float32, interpret=False)
    assert up.eligible(4096, 1, torch.float32, interpret=True)
    with pytest.raises(ValueError, match="update impl"):
        up.chol_update(torch.eye(4)[None], torch.zeros(1, 4, 1), impl="vmap")
    with pytest.raises(ValueError, match="rank-k batch"):
        up.chol_update(torch.eye(4)[None], torch.zeros(1, 3, 1))


def test_forced_pallas_on_f64_takes_the_panel_scan():
    R, V = _operands(2, 16, 2, "f64", False, seed=4)
    Rt, Vt = torch.from_numpy(R), torch.from_numpy(V)
    hopper.reset_counts()
    Rk, ik = up.chol_update(Rt, Vt, impl="pallas")
    Rx, ix = up.chol_update(Rt, Vt, impl="xla")
    assert Rk.dtype == torch.float64 and torch.equal(Rk, Rx) and torch.equal(ik, ix)
    assert not any(hopper.counts().values())
    with pytest.raises(TypeError, match="bf16 or f32"):
        up.sweep(Rt, Vt, 1.0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("op", ["chol_update", "chol_downdate"])
def test_pad_is_a_fixed_point(op, impl):
    """diag(R, I) with zero V rows and columns: every padded rotation is a
    t = 0 no-op, so the sweep's crop is bitwise the unpadded answer (the
    panel scan's panel width follows the bucket, so there it agrees to
    roundoff)."""
    R, V = _operands(1, 12, 3, "f32", op == "chol_downdate", seed=5)
    cfg = ServeConfig(buckets=(16,), nrhs_buckets=(8,), max_batch=2)
    bucket = batching.bucket_for(op, (12, 12), (12, 3), "float32", cfg)
    assert bucket.a_shape == (16, 16) and bucket.b_shape == (16, 8)
    pr, pv = batching.pad_operands(op, torch.from_numpy(R[0]), torch.from_numpy(V[0]), bucket)
    Ab, Vb, occ = batching.assemble([pr], [pv], bucket, device="cpu")
    assert occ == 0.5
    fn = up.chol_update if op == "chol_update" else up.chol_downdate
    Rb, ib = fn(Ab, Vb, impl=impl)
    R1, i1 = fn(torch.from_numpy(R), torch.from_numpy(V), impl=impl)
    got = batching.crop(op, Rb[0], (12, 12), (12, 3))
    if impl == "pallas":
        assert torch.equal(got, R1[0])
    else:
        assert float((got - R1[0]).abs().max()) <= 1e-5 * float(R1[0].abs().max())
    assert not ib.any() and not i1.any()
    assert torch.equal(Rb[0, 12:, 12:], torch.eye(4)) and torch.equal(Rb[1], torch.eye(16))


@pytest.mark.parametrize("impl", ["auto", "vmap", "pallas_split"])
@pytest.mark.parametrize("op", ["chol_update", "chol_downdate"])
def test_batched_update_program_matches_reference(op, impl):
    """serve's bucket program: 'vmap' is the panel scan, the others the
    sweep (plain version here)."""
    from capital_tpu.serve import api as rapi
    from capital_tpu_torch.serve import api

    R, V = _operands(3, 8, 2, "f32", op == "chol_downdate", seed=6)
    Rr, ir = rapi.batched(op, "highest", impl)(jnp.asarray(R), jnp.asarray(V))
    Rp, ip = api.batched(op, "highest", impl)(torch.from_numpy(R), torch.from_numpy(V))
    _same((np.asarray(Rr, np.float64), np.asarray(ir)), (Rp.double().numpy(), ip.numpy()),
          TOL["sweep"]["f32"])
