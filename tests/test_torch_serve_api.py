"""The port's small-N serve path (capital_tpu_torch/serve/) against the JAX
package's (capital_tpu/serve/): the batched bucket programs of
`api.batched` for posv / lstsq / inv under every impl, the dense bucketing
that feeds them, `api.single`, and `ServeConfig`.

Operands are made with numpy from a seed and handed to both packages; the
reference programs are jitted once per (op, impl, dtype) at module level and
shared.  Tolerances, relative to the largest |reference| entry: f32 1e-5
(posv, inv) and 1e-4 (lstsq: the gram squares the condition number); f64
1e-10, where both packages take the library (vmap) route.  `info` is
compared exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import Grid as JGrid
from capital_tpu.serve import api as rapi
from capital_tpu.serve import batching as rbat
from capital_tpu.serve import engine as reng
from capital_tpu_torch import Grid
from capital_tpu_torch.ops import batched_small, hopper
from capital_tpu_torch.serve import api, batching
from capital_tpu_torch.serve.engine import ServeConfig
from capital_tpu_torch.utils import interop

IMPLS = ("vmap", "pallas", "pallas_split", "auto")
BATCH, N, M, K = 3, 12, 40, 2
TOL = {"posv": 1e-5, "inv": 1e-5, "lstsq": 1e-4}
CFG = dict(buckets=(8, 16, 32), rows_buckets=(32, 64, 128), nrhs_buckets=(1, 4),
           max_batch=4)


@functools.lru_cache(maxsize=None)
def _ref_program(op, impl):
    return jax.jit(rapi.batched(op, "highest", impl))


def _operands(op, dtype, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    if op == "lstsq":
        A = rng.standard_normal((batch, M, N))
        B = rng.standard_normal((batch, M, K))
    else:
        X = rng.standard_normal((batch, N, N))
        A = X @ X.transpose(0, 2, 1) / N + 3.0 * np.eye(N)
        B = rng.standard_normal((batch, N, K))
    return A.astype(dtype), (None if op == "inv" else B.astype(dtype))


def _run_both(op, impl, A, B):
    rf = _ref_program(op, impl)
    pf = api.batched(op, "highest", impl)
    if B is None:
        (X, info), (Xp, infop) = rf(jnp.asarray(A)), pf(torch.from_numpy(A))
    else:
        (X, info) = rf(jnp.asarray(A), jnp.asarray(B))
        Xp, infop = pf(torch.from_numpy(A), torch.from_numpy(B))
    return np.asarray(X), np.asarray(info), Xp, infop


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["posv", "lstsq", "inv"])
def test_batched_f32_matches_reference(op, impl):
    A, B = _operands(op, np.float32)
    X, info, Xp, infop = _run_both(op, impl, A, B)
    assert Xp.dtype == torch.float32 and Xp.shape == X.shape
    assert _rel(Xp.numpy(), X) <= TOL[op]
    assert np.array_equal(infop.numpy(), info.astype(np.int32)) and not info.any()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["posv", "lstsq", "inv"])
def test_batched_f64_takes_vmap_and_matches_reference(op, impl):
    A, B = _operands(op, np.float64, seed=1)
    hopper.reset_counts()
    X, info, Xp, infop = _run_both(op, impl, A, B)
    assert Xp.dtype == torch.float64
    assert _rel(Xp.numpy(), X) <= 1e-10
    assert np.array_equal(infop.numpy(), info.astype(np.int32))
    assert not any(hopper.counts().values())


def test_auto_resolves_as_reference():
    """The routes `auto` takes here: the fused kernels' plain versions for
    f32 posv/lstsq and inv at n <= 128, vmap beyond and for f64."""
    A, B = _operands("posv", np.float32)
    X, _ = api.batched("posv", "highest", "auto")(torch.from_numpy(A), torch.from_numpy(B))
    Xk, _ = api.batched("posv", "highest", "pallas")(torch.from_numpy(A), torch.from_numpy(B))
    assert torch.equal(X, Xk)
    for op, a, b in (("posv", (8, 200, 200), (8, 200, 4)), ("lstsq", (8, 64, 16), (8, 64, 1))):
        assert batched_small.default_impl(op, a, b, torch.float32, interpret=True) == \
            rapi.batched_small.default_impl(op, a, b, jnp.float32, interpret=True)


def test_unknown_impl_message_matches_reference():
    with pytest.raises(ValueError) as r:
        rapi.batched("posv", impl="cuda")
    with pytest.raises(ValueError) as p:
        api.batched("posv", impl="cuda")
    assert str(p.value) == str(r.value)


def _later_operands(op, rng):
    """One request's engine-composed operands (A, B) for a residency or
    session bucket op, in f32."""
    def spd(n):
        X = rng.standard_normal((n, n))
        return X @ X.T / n + 3.0 * np.eye(n)

    if op in ("posv_cached", "posv_cached_miss", "chol_update"):
        A = spd(7)
        if op != "posv_cached_miss":
            A = np.linalg.cholesky(A).T
        B = rng.standard_normal((7, 3))
    elif op in ("session_extend", "blocktri_extend"):
        A = np.stack([np.stack([spd(6) for _ in range(3)]), 0.1 * rng.standard_normal((3, 6, 6))])
        B = np.linalg.cholesky(spd(6))
    else:  # session_solve: the window beside its factor
        D = np.stack([spd(6) for _ in range(3)])
        C = 0.1 * rng.standard_normal((3, 6, 6))
        L = np.stack([np.linalg.cholesky(d) for d in D])
        A = np.stack([D, C, L, 0.1 * rng.standard_normal((3, 6, 6))])
        B = rng.standard_normal((3, 6, 2))
    return A.astype(np.float32), B.astype(np.float32)


@pytest.mark.parametrize("op", ["session_extend", "blocktri_extend", "chol_update",
                                "posv_cached", "posv_cached_miss", "session_solve"])
def test_later_ops_name_their_roadmap_item(op):
    """The residency and session bucket ops, once refused naming ROADMAP
    Queue A item 8, are served: `check_op` lets them through, `api.batched`
    builds their program, and their bucket, padding, fill problem and crop
    are the reference's bit for bit."""
    batching.check_op(op)
    assert callable(api.batched(op))
    cfg, rcfg = ServeConfig(**CFG, nblocks_buckets=(4,), block_buckets=(8,)), \
        reng.ServeConfig(**CFG, nblocks_buckets=(4,), block_buckets=(8,))
    A, B = _later_operands(op, np.random.default_rng(3))
    bk = batching.bucket_for(op, A.shape, B.shape, "float32", cfg)
    rbk = rbat.bucket_for(op, A.shape, B.shape, "float32", rcfg)
    assert bk.key == rbk.key
    pa, pb = batching.pad_operands(op, torch.from_numpy(A), torch.from_numpy(B), bk)
    rpa, rpb = rbat.pad_operands(op, jnp.asarray(A), jnp.asarray(B), rbk)
    assert np.array_equal(pa.numpy(), np.asarray(rpa)) and np.array_equal(pb.numpy(), np.asarray(rpb))
    fa, fb = batching.fill_problem(bk, device="cpu")
    rfa, rfb = rbat.fill_problem(rbk)
    assert np.array_equal(fa.numpy(), np.asarray(rfa)) and np.array_equal(fb.numpy(), np.asarray(rfb))
    X = torch.arange(pa.numel() if op in batching.EXTEND_OPS else pb.numel(), dtype=torch.float32)
    X = X.reshape(pa.shape if op in batching.EXTEND_OPS else pb.shape)
    assert np.array_equal(batching.crop(op, X, A.shape, B.shape).numpy(),
                          np.asarray(rbat.crop(op, jnp.asarray(X.numpy()), A.shape, B.shape)))
    with pytest.raises(ValueError) as r:
        rbat.bucket_for("session_open", A.shape, B.shape, "float32", rcfg)
    with pytest.raises(ValueError) as p:
        batching.bucket_for("session_open", A.shape, B.shape, "float32", cfg)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("tier", ["fast", "guaranteed"])
def test_tiers_beyond_balanced_name_their_roadmap_item(tier):
    """The tiers are served for posv, lstsq and posv_blocktri (tests/
    test_torch_refine.py) and, since the session slice, for session_solve
    (its guaranteed tier refines against the resident factor): its tiered
    bucket is the reference's.  inv refuses a tier as the reference does."""
    assert callable(api.batched("session_solve", tier=tier))
    bk = batching.bucket_for("session_solve", (4, 4, 8, 8), (4, 8, 1), "float32",
                             ServeConfig(**CFG), tier=tier)
    rbk = rbat.bucket_for("session_solve", (4, 4, 8, 8), (4, 8, 1), "float32",
                          reng.ServeConfig(**CFG), tier=tier)
    assert bk.key == rbk.key and bk.tier == tier
    with pytest.raises(ValueError) as r:
        rapi.batched("inv", tier=tier)
    with pytest.raises(ValueError) as p:
        api.batched("inv", tier=tier)
    assert str(p.value) == str(r.value)
    for op, a, b in (("posv", (8, 8), (8, 1)), ("lstsq", (20, 6), (20, 2)),
                     ("chol_update", (7, 7), (7, 3))):
        want = rbat.bucket_for(op, a, b, "float32", reng.ServeConfig(**CFG), tier=tier)
        got = batching.bucket_for(op, a, b, "float32", ServeConfig(**CFG), tier=tier)
        assert got.key == want.key and got.tier == tier


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["posv", "inv"])
def test_vmap_nan_pivot_info_matches_reference(op, dt):
    """A NaN pivot on the library route: the reference's potrf runs on
    through it, so info names the pivot (6), not row 1."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((3, 8, 8))
    A = (X @ X.transpose(0, 2, 1) / 8 + 3.0 * np.eye(8)).astype(dt)
    A[1, 5, 5] = np.nan
    B = None if op == "inv" else rng.standard_normal((3, 8, 2)).astype(dt)
    _, info, _, infop = _run_both(op, "vmap", A, B)
    assert info.tolist() == [0, 6, 0]
    assert np.array_equal(infop.numpy(), info.astype(np.int32))


def test_nan_is_contained_to_its_problem():
    A, B = _operands("posv", np.float32, seed=2, batch=4)
    f = api.batched("posv", "highest", "pallas")
    Xc, ic = f(torch.from_numpy(A), torch.from_numpy(B))
    A[2, 4, 4] = np.nan
    Xn, inn = f(torch.from_numpy(A), torch.from_numpy(B))
    assert inn[2] != 0 and not inn[[0, 1, 3]].any() and not ic.any()
    for i in (0, 1, 3):
        assert torch.equal(Xn[i], Xc[i])
    X, info = _ref_program("posv", "pallas")(jnp.asarray(A), jnp.asarray(B))
    assert np.array_equal(inn.numpy(), np.asarray(info).astype(np.int32))


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


REQUESTS = [("posv", (5, 5), (5, 1)), ("posv", (12, 12), (12, 3)), ("posv", (16, 16), (16, 2)),
            ("posv", (32, 32), (32, 4)), ("lstsq", (50, 14), (50, 4)),
            ("posv", (33, 33), (33, 1)), ("posv", (8, 8), (8, 5)),
            ("lstsq", (20, 5), (20, 1)), ("lstsq", (40, 12), (40, 3)), ("lstsq", (120, 30), (120, 2)),
            ("lstsq", (64, 16), (64, 1)), ("inv", (7, 7), None), ("inv", (16, 16), None)]


def test_bucket_for_matches_reference():
    cfg, pcfg = reng.ServeConfig(**CFG), ServeConfig(**CFG)
    for op, a, b in REQUESTS:
        rb = rbat.bucket_for(op, a, b, "float32", cfg)
        pb = batching.bucket_for(op, a, b, "float32", pcfg)
        assert (rb is None) == (pb is None), (op, a, b)
        if rb is not None:
            assert pb.key == rb.key
            assert batching.bucket_label(pb) == rbat.bucket_label(rb)
            assert batching.bucket_label(pb.key) == rbat.bucket_label(rb.key)
    with pytest.raises(ValueError) as r:
        rbat.bucket_for("svd", (4, 4), None, "float32", cfg)
    with pytest.raises(ValueError) as p:
        batching.bucket_for("svd", (4, 4), None, "float32", pcfg)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("op", ["posv", "lstsq", "inv"])
def test_pad_assemble_crop_match_reference(op):
    cfg, pcfg = reng.ServeConfig(**CFG), ServeConfig(**CFG)
    rng = np.random.default_rng(3)
    reqs = [r for r in REQUESTS if r[0] == op]
    rb = rbat.bucket_for(op, reqs[1][1], reqs[1][2], "float32", cfg)
    pb = batching.bucket_for(op, reqs[1][1], reqs[1][2], "float32", pcfg)
    same = [r for r in reqs if rbat.bucket_for(op, r[1], r[2], "float32", cfg) == rb]
    pa_r, pb_r, pa_p, pb_p, shapes = [], [], [], [], []
    for _, a_shape, b_shape in same:
        A = rng.standard_normal(a_shape)
        if op != "lstsq":  # SPD
            A = A @ A.T / a_shape[0] + 3.0 * np.eye(a_shape[0])
        A = A.astype(np.float32)
        B = None if b_shape is None else rng.standard_normal(b_shape).astype(np.float32)
        ra, rbb = rbat.pad_operands(op, jnp.asarray(A), None if B is None else jnp.asarray(B), rb)
        qa, qbb = batching.pad_operands(op, torch.from_numpy(A),
                                        None if B is None else torch.from_numpy(B), pb)
        assert np.array_equal(qa.numpy(), np.asarray(ra))
        assert (qbb is None) == (rbb is None)
        if qbb is not None:
            assert np.array_equal(qbb.numpy(), np.asarray(rbb))
        pa_r.append(ra), pb_r.append(rbb), pa_p.append(qa), pb_p.append(qbb)
        shapes.append((a_shape, b_shape))
    Ar, Br, occ_r = rbat.assemble(pa_r, pb_r, rb)
    Ap, Bp, occ_p = batching.assemble(pa_p, pb_p, pb, device="cpu")
    assert occ_p == occ_r and np.array_equal(Ap.numpy(), np.asarray(Ar))
    if Bp is not None:
        assert np.array_equal(Bp.numpy(), np.asarray(Br))
    Xr, _ = _ref_program(op, "pallas")(*([Ar] if Br is None else [Ar, Br]))
    Xp, ip = api.batched(op, "highest", "pallas")(*([Ap] if Bp is None else [Ap, Bp]))
    assert not ip.any()
    for i, (a_shape, b_shape) in enumerate(shapes):
        cp = batching.crop(op, Xp[i], a_shape, b_shape)
        cr = rbat.crop(op, np.asarray(Xr)[i], a_shape, b_shape)
        assert cp.shape == cr.shape
        assert _rel(cp.numpy(), cr) <= TOL[op]
    # fill slots solve exactly: zeros against a zero RHS, I for inv
    fill = Xp[len(shapes):]
    want = torch.eye(fill.shape[-1]).expand(fill.shape) if op == "inv" else torch.zeros_like(fill)
    assert len(fill) and torch.equal(fill, want)


def test_fill_problem_needs_a_device():
    pb = batching.Bucket("posv", "float32", (8, 8), (8, 1), 4)
    fa, fb = batching.fill_problem(pb, device="cpu")
    fr, fbr = rbat.fill_problem(rbat.Bucket("posv", "float32", (8, 8), (8, 1), 4))
    assert np.array_equal(fa.numpy(), np.asarray(fr)) and np.array_equal(fb.numpy(), np.asarray(fbr))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batching.fill_problem(pb)
    with pytest.raises(ValueError, match="capacity"):
        batching.assemble([fa] * 5, [fb] * 5, pb, device="cpu")


# ---------------------------------------------------------------------------
# the single (oversize) route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["posv", "lstsq", "inv"])
def test_single_matches_reference(op):
    rng = np.random.default_rng(4)
    n = 24
    if op == "lstsq":
        A = rng.standard_normal((96, n)).astype(np.float32)
        B = rng.standard_normal((96, 2)).astype(np.float32)
    else:
        X = rng.standard_normal((n, n))
        A = (X @ X.T / n + 3.0 * np.eye(n)).astype(np.float32)
        B = None if op == "inv" else rng.standard_normal((n, 2)).astype(np.float32)
    jgrid = JGrid.square(c=1, devices=jax.devices()[:1])
    rf = rapi.single(op, jgrid, "highest")
    pf = api.single(op, Grid.square(device="cpu"), "highest")
    args_r = [jnp.asarray(A)] + ([] if B is None else [jnp.asarray(B)])
    args_p = [torch.from_numpy(A)] + ([] if B is None else [torch.from_numpy(B)])
    (X, info), (Xp, infop) = rf(*args_r), pf(*args_p)
    assert _rel(Xp.numpy(), np.asarray(X)) <= TOL[op]
    assert int(infop) == int(info) == 0
    # the residency and session ops have no single route: the reference's error
    with pytest.raises(ValueError) as r:
        rapi.single("session_solve", jgrid)
    with pytest.raises(ValueError) as p:
        api.single("session_solve", Grid.square(device="cpu"))
    assert str(p.value) == str(r.value)


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------


def test_serve_config_crosses_from_the_reference():
    cfg = reng.ServeConfig(**CFG, small_n_impl="pallas_split")
    pc = interop.serve_config_from_fields(dataclasses.asdict(cfg))
    assert dataclasses.asdict(pc) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(reng.ServeConfig())


@pytest.mark.parametrize("bad", [dict(buckets=()), dict(rows_buckets=(0,)), dict(nrhs_buckets=[1]),
                                 dict(max_batch=0), dict(precision="fp8"),
                                 dict(small_n_impl="cuda"), dict(nblocks_buckets=()),
                                 dict(block_buckets=(0, 8)), dict(border_buckets=[4]),
                                 dict(blocktri_impl="spike"), dict(blocktri_partitions=-1)])
def test_serve_config_validates_what_the_slice_reads(bad):
    with pytest.raises(ValueError):
        ServeConfig(**bad)


# ---------------------------------------------------------------------------
# the structured ops: posv_blocktri and posv_arrowhead
# ---------------------------------------------------------------------------


SCFG = dict(buckets=(8, 16), rows_buckets=(32,), nrhs_buckets=(1, 4), max_batch=3,
            nblocks_buckets=(2, 4), block_buckets=(4, 8), border_buckets=(2, 4))
#: (op, a_shape, b_shape) requests; arrowhead B is the packed tail operand
SREQ = [("posv_blocktri", (2, 3, 4, 4), (3, 4, 1)), ("posv_blocktri", (2, 4, 3, 3), (4, 3, 2)),
        ("posv_blocktri", (2, 2, 4, 4), (2, 4, 3)), ("posv_blocktri", (2, 5, 4, 4), (5, 4, 1)),
        ("posv_blocktri", (2, 3, 9, 9), (3, 9, 1)), ("posv_blocktri", (2, 3, 4, 4), (3, 4, 5)),
        ("posv_arrowhead", (2, 3, 4, 4), (14, 3)), ("posv_arrowhead", (2, 4, 3, 3), (13, 2)),
        ("posv_arrowhead", (2, 2, 4, 4), (11, 4)), ("posv_arrowhead", (2, 3, 4, 4), (17, 1))]


def _structured_request(op, a_shape, b_shape, rng):
    """A chain pack A = [D; C] (gram/b + 3I diagonals, 0.3/√b couplings) and
    the RHS — for posv_arrowhead the packed tail [Bᵀ | b_T; S | b_S]."""
    _, nblocks, b, _ = a_shape
    G = rng.standard_normal((nblocks, b, b))
    D = G @ G.transpose(0, 2, 1) / b + 3.0 * np.eye(b)
    C = 0.3 / np.sqrt(b) * rng.standard_normal((nblocks, b, b))
    C[0] = 0.0
    A = np.stack([D, C])
    if op == "posv_blocktri":
        return A, rng.standard_normal(b_shape)
    s = b_shape[0] - nblocks * b
    k = b_shape[1] - s
    F = 0.3 / np.sqrt(nblocks * b) * rng.standard_normal((nblocks, s, b))
    S0 = rng.standard_normal((s, s))
    S = S0 @ S0.T / s + 5.0 * np.eye(s)
    top = np.concatenate([F.transpose(0, 2, 1).reshape(nblocks * b, s),
                          rng.standard_normal((nblocks * b, k))], axis=1)
    return A, np.concatenate([top, np.concatenate([S, rng.standard_normal((s, k))], axis=1)])


def test_structured_bucket_for_matches_reference():
    cfg, pcfg = reng.ServeConfig(**SCFG), ServeConfig(**SCFG)
    for op, a, b in SREQ:
        rb = rbat.bucket_for(op, a, b, "float32", cfg)
        pb = batching.bucket_for(op, a, b, "float32", pcfg)
        assert (rb is None) == (pb is None), (op, a, b)
        if rb is not None:
            assert pb.key == rb.key and batching.bucket_label(pb) == rbat.bucket_label(rb)


@functools.lru_cache(maxsize=None)
def _ref_structured(op, impl, blocktri_impl="auto"):
    return jax.jit(rapi.batched(op, "highest", impl, blocktri_impl=blocktri_impl))


def _structured_batch(op, dtype, seed):
    """The requests of SREQ that share the bucket of the op's first one,
    padded by both packages (bitwise equal) and assembled."""
    cfg, pcfg = reng.ServeConfig(**SCFG), ServeConfig(**SCFG)
    rng = np.random.default_rng(seed)
    first = next(r for r in SREQ if r[0] == op)
    rb = rbat.bucket_for(op, first[1], first[2], dtype, cfg)
    pb = batching.bucket_for(op, first[1], first[2], dtype, pcfg)
    reqs = [r for r in SREQ if r[0] == op and rbat.bucket_for(op, r[1], r[2], dtype, cfg) == rb]
    ra, rbb, pa, pbb, shapes = [], [], [], [], []
    for _, a_shape, b_shape in reqs:
        A, B = (x.astype(dtype) for x in _structured_request(op, a_shape, b_shape, rng))
        x, y = rbat.pad_operands(op, jnp.asarray(A), jnp.asarray(B), rb)
        u, v = batching.pad_operands(op, torch.from_numpy(A), torch.from_numpy(B), pb)
        assert np.array_equal(u.numpy(), np.asarray(x)) and np.array_equal(v.numpy(), np.asarray(y))
        ra.append(x), rbb.append(y), pa.append(u), pbb.append(v), shapes.append((a_shape, b_shape))
    Ar, Br, occ_r = rbat.assemble(ra, rbb, rb)
    Ap, Bp, occ_p = batching.assemble(pa, pbb, pb, device="cpu")
    assert occ_p == occ_r and np.array_equal(Ap.numpy(), np.asarray(Ar))
    assert np.array_equal(Bp.numpy(), np.asarray(Br))
    return Ar, Br, Ap, Bp, shapes


@pytest.mark.parametrize("impl,blocktri_impl", [("auto", "auto"), ("pallas", "auto"),
                                                ("pallas_split", "auto"), ("vmap", "auto"),
                                                ("auto", "scan"), ("auto", "partitioned"),
                                                ("pallas", "partitioned")])
@pytest.mark.parametrize("op", ["posv_blocktri", "posv_arrowhead"])
def test_structured_batched_matches_reference(op, impl, blocktri_impl):
    Ar, Br, Ap, Bp, shapes = _structured_batch(op, "float32", seed=5)
    want = _ref_structured(op, impl, blocktri_impl)(Ar, Br)
    got = api.batched(op, "highest", impl, blocktri_impl=blocktri_impl)(Ap, Bp)
    assert len(got) == len(want) == (3 if op == "posv_arrowhead" else 2)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape == w.shape and _rel(g.numpy(), np.asarray(w)) <= 1e-5
    assert np.array_equal(got[-1].numpy(), np.asarray(want[-1]).astype(np.int32))
    assert not got[-1].any()
    X = got[0]
    for i, (a_shape, b_shape) in enumerate(shapes):
        cp = batching.crop(op, X[i], a_shape, b_shape)
        cr = rbat.crop(op, np.asarray(want[0])[i], a_shape, b_shape)
        assert cp.shape == cr.shape and _rel(cp.numpy(), cr) <= 1e-5
        # the identity tail: padded rows and columns of the chain half are exact zeros
        tail = X[i].clone()
        tail[: cp.shape[0], : cp.shape[1], : cp.shape[2]] = 0
        assert not tail.any()
    # fill slots solve to exact zeros
    assert len(shapes) < X.shape[0] and not X[len(shapes):].any()
    if op == "posv_arrowhead":
        assert not got[1][len(shapes):].any()


@pytest.mark.parametrize("op", ["posv_blocktri", "posv_arrowhead"])
def test_structured_f64_bucket_takes_the_library_route(op):
    Ar, Br, Ap, Bp, _ = _structured_batch(op, "float64", seed=6)
    for impl in ("pallas", "auto"):
        want = _ref_structured(op, impl)(Ar, Br)
        got = api.batched(op, "highest", impl)(Ap, Bp)
        assert got[0].dtype == torch.float64
        for g, w in zip(got[:-1], want[:-1]):
            assert _rel(g.numpy(), np.asarray(w)) <= 1e-10
        assert np.array_equal(got[-1].numpy(), np.asarray(want[-1]).astype(np.int32))


@pytest.mark.parametrize("op", ["posv_blocktri", "posv_arrowhead"])
def test_structured_fill_and_poison(op):
    pb = batching.bucket_for(op, SREQ[0][1] if op == "posv_blocktri" else SREQ[6][1],
                             SREQ[0][2] if op == "posv_blocktri" else SREQ[6][2], "float32",
                             ServeConfig(**SCFG))
    fa, fb = batching.fill_problem(pb, device="cpu")
    fr, fbr = rbat.fill_problem(rbat.Bucket(*pb.key))
    assert np.array_equal(fa.numpy(), np.asarray(fr)) and np.array_equal(fb.numpy(), np.asarray(fbr))
    Ar, Br, Ap, Bp, shapes = _structured_batch(op, "float32", seed=7)
    f = api.batched(op, "highest", "pallas")
    clean = f(Ap, Bp)
    Ap[0, 0, 1, 0, 0] = float("nan")
    Ar = Ar.at[0, 0, 1, 0, 0].set(jnp.nan)
    got = f(Ap, Bp)
    want = _ref_structured(op, "pallas")(Ar, Br)
    assert np.array_equal(got[-1].numpy(), np.asarray(want[-1]).astype(np.int32))
    assert got[-1][0] != 0 and not got[-1][1:].any()
    for g, c in zip(got[:-1], clean[:-1]):
        assert torch.equal(g[1:], c[1:])


@pytest.mark.parametrize("op", ["posv_blocktri", "posv_arrowhead"])
def test_structured_single_matches_reference(op):
    rng = np.random.default_rng(8)
    a_shape, b_shape = ((2, 3, 4, 4), (3, 4, 2)) if op == "posv_blocktri" else ((2, 3, 4, 4), (15, 5))
    A, B = (x.astype(np.float32) for x in _structured_request(op, a_shape, b_shape, rng))
    jgrid = JGrid.square(c=1, devices=jax.devices()[:1])
    X, info = rapi.single(op, jgrid, "highest")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = api.single(op, Grid.square(device="cpu"), "highest")(torch.from_numpy(A),
                                                                      torch.from_numpy(B))
    assert Xp.shape == X.shape and _rel(Xp.numpy(), np.asarray(X)) <= 1e-5
    assert int(infop) == int(info) == 0
