"""Factor residency in the port's serve engine (capital_tpu_torch/serve:
FactorCache, factor_token=, posv_cached and its miss program,
chol_update / chol_downdate on resident factors, blocktri_extend, the
downdate degrade) against the JAX package's (capital_tpu/serve), on the CPU.

One seeded request stream (numpy, `_residency_stream`) goes through the JAX
engine and through the port's engine on a CPU grid, under both schedulers
(module-scoped fixture: the JAX side's AOT compiles are the slow part), and
a second stream drives a small factor-cache budget into evictions.  The
streams cover misses that seed, hits, updates and downdates (f32 and f64),
a never-seeded token, a downdate that loses definiteness (the degrade fails
too), install / release, chain extension of a fresh and a resident chain,
kind and shape mismatches, an ingest fault that poisons one update, and
evicted tokens.

Equal, per request: `ok`, `info`, `bucket`, `error is None`; and at the end
`factor_stats()` (entry_bytes, bytes and eviction_age_hist included),
`cache_stats()` and the stats snapshot's counts.  Close: X within 1e-4 of
max|X_ref| for f32 and 1e-10 for f64 (test_torch_serve_engine.TOL), and the
resident factors likewise.  The port's `serve:request_stats` record must
pass the reference's validator.  The unit tests port tests/test_update.py's
TestFactorCache, TestDowndateDegrade, TestCfgHashSeparation and
TestStatsFactorBlock.
"""

import numpy as np
import pytest
import torch

from capital_tpu.obs import ledger as rledger
from capital_tpu.robust import faultinject as rfaultinject
from capital_tpu.robust.config import RobustConfig as RRobustConfig
from capital_tpu.serve import engine as rengine
from capital_tpu.serve import stats as rstats
from capital_tpu.serve.factorcache import FactorCache as RFactorCache
from capital_tpu.utils import tracing as rtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import blocktri
from capital_tpu_torch.robust import faultinject
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.serve import FactorCache, ServeConfig, SolveEngine, stats
from capital_tpu_torch.utils import tracing

SCHEDULERS = ("continuous", "sync")
LADDERS = dict(buckets=(16, 32), rows_buckets=(64,), nrhs_buckets=(2, 4), nblocks_buckets=(2, 4),
               block_buckets=(8,), max_batch=2, max_delay_s=10.0)
#: the eviction stream's budget: two dense 16 x 16 f32 factors (1024 bytes
#: each) fit, a third evicts the least recently used
EVICT_BYTES = 2048 + 512
TOL = {"float32": 1e-4, "float64": 1e-10}


def _spd(rng, n, dtype=np.float32):
    M = rng.standard_normal((n, n))
    return (M @ M.T / n + 3.0 * np.eye(n)).astype(dtype)


def _chain(rng, nblocks, b, live_head=False):
    D = np.stack([_spd(rng, b) for _ in range(nblocks)])
    C = (0.1 * rng.standard_normal((nblocks, b, b))).astype(np.float32)
    if not live_head:
        C[0] = 0
    return np.stack([D, C])


def _residency_stream(eng, fi):
    """Drive the main stream through `eng` (either package; `fi` is its
    faultinject module).  Returns the tickets in submit order, the tokens
    whose resident factors the caller compares, and the stream's data."""
    rng = np.random.default_rng(0)
    A, A12 = _spd(rng, 16), _spd(rng, 12)
    B, B12 = rng.standard_normal((16, 2)).astype(np.float32), rng.standard_normal((12, 2)).astype(np.float32)
    V = ((0.1 / 4) * rng.standard_normal((16, 2))).astype(np.float32)
    A64 = _spd(rng, 20, np.float64)
    B64, V64 = rng.standard_normal((20, 3)), (0.05 * rng.standard_normal((20, 3)))
    W = (10.0 * np.linalg.cholesky(A.astype(np.float64))[:, :2]).astype(np.float32)
    RI = np.linalg.cholesky(A.astype(np.float64)).T.astype(np.float32)
    ch1, ch2, ch3 = _chain(rng, 2, 8), _chain(rng, 2, 8, live_head=True), _chain(rng, 3, 8)
    ts = []

    def sub(op, X, Y=None, tok=None):
        ts.append(eng.submit(op, X, Y, factor_token=tok))

    sub("posv_cached", A, B, "tokA")        # miss: seeds tokA
    sub("posv_cached", A12, B12, "tokB")    # miss: seeds tokB (one batch with tokA's)
    eng.drain()
    sub("posv_cached", A, B, "tokA")        # hit: potrs alone
    sub("chol_update", V, None, "tokA")
    eng.drain()
    sub("chol_downdate", V, None, "tokA")
    sub("chol_update", V[:12], None, "tokB")
    eng.drain()
    sub("posv_cached", A, B, "tokA")
    eng.drain()
    sub("posv_cached", A64, B64, "tokC")    # f64: the library route
    eng.drain()
    sub("chol_update", V64, None, "tokC")
    eng.drain()
    sub("posv_cached", A64, B64, "tokC")
    sub("chol_update", V, None, "nope")     # never seeded: fails loud
    eng.drain()
    sub("posv_cached", A, B, "tokD")
    eng.drain()
    sub("chol_downdate", W, None, "tokD")   # loses definiteness; the degrade fails too
    eng.drain()
    eng.install_factor("tokI", RI)
    sub("posv_cached", A, B, "tokI")
    eng.drain()
    eng.release_factor("tokI")
    sub("chol_update", V, None, "tokI")     # released: never seeded again
    sub("blocktri_extend", ch1, None, "chain1")  # fresh chain
    eng.drain()
    sub("blocktri_extend", ch2, None, "chain1")  # continues from the carry
    sub("blocktri_extend", ch3, None, "chain2")
    eng.drain()
    sub("chol_update", V, None, "chain1")   # kind mismatch
    sub("posv_cached", A, B, "chain1")      # kind mismatch
    sub("chol_update", V[:12], None, "tokA")  # shape mismatch
    with fi.active_plan(fi.Fault(tag="serve::ingest", kind="nan")) as plan:
        sub("chol_update", V[:12], None, "tokB")  # poisoned: flagged, refused
    eng.drain()
    assert plan.fired == [("serve::ingest", 0)]
    data = dict(A=A, B=B, V=V, A64=A64, B64=B64, V64=V64, chains=(ch1, ch2, ch3))
    return ts, ("tokA", "tokB", "tokC", "tokD", "chain1", "chain2"), data


def _eviction_stream(eng):
    """Seed three dense tokens into a two-entry budget, then traffic to the
    evicted one (update fails, posv_cached reseeds), a chain evicted under
    pressure (its extend fails loud), and a re-release."""
    rng = np.random.default_rng(7)
    As = [_spd(rng, 16) for _ in range(3)]
    B = rng.standard_normal((16, 2)).astype(np.float32)
    V = ((0.1 / 4) * rng.standard_normal((16, 2))).astype(np.float32)
    ch = _chain(rng, 2, 8)
    ts = []

    def solve(op, X, Y=None, tok=None):
        ts.append(eng.submit(op, X, Y, factor_token=tok))
        eng.drain()

    for i, Ai in enumerate(As):
        solve("posv_cached", Ai, B, f"e{i}")   # the third evicts e0
    solve("chol_update", V, None, "e0")        # evicted: fails loud
    solve("posv_cached", As[0], B, "e0")       # reseeds e0, evicts e1
    solve("chol_update", V, None, "e0")
    solve("blocktri_extend", ch, None, "c0")   # evicts more
    solve("posv_cached", As[1], B, "e1")
    solve("posv_cached", As[2], B, "e2")
    solve("blocktri_extend", ch, None, "c0")   # c0 evicted: fails loud
    eng.release_factor("c0")                   # clears the tombstone
    solve("blocktri_extend", ch, None, "c0")   # a fresh chain again
    return ts


def _np(x):
    return np.asarray(x.double().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _run(eng, fi):
    ts, toks, data = _residency_stream(eng, fi)
    return dict(responses=[t.result() for t in ts], factor_stats=eng.factor_stats(),
                cache=eng.cache_stats(), snap=eng.stats.snapshot(),
                resident={t: [_np(a) for a in eng.factors.peek(t).arrays] for t in toks},
                rec=eng.emit_stats(), data=data)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for sched in SCHEDULERS:
        rcfg = rengine.ServeConfig(robust=RRobustConfig(), scheduler=sched, **LADDERS)
        cfg = ServeConfig(robust=RobustConfig(), scheduler=sched, **LADDERS)
        out["jax", sched] = _run(rengine.SolveEngine(cfg=rcfg), rfaultinject)
        out["torch", sched] = _run(SolveEngine(Grid.square(device="cpu"), cfg), faultinject)
        for pkg in ("jax", "torch"):
            kw = dict(scheduler=sched, factor_cache_bytes=EVICT_BYTES, **LADDERS)
            eng = (rengine.SolveEngine(cfg=rengine.ServeConfig(**kw)) if pkg == "jax"
                   else SolveEngine(Grid.square(device="cpu"), ServeConfig(**kw)))
            ts = _eviction_stream(eng)
            out[pkg, sched, "evict"] = dict(responses=[t.result() for t in ts],
                                            factor_stats=eng.factor_stats(), cache=eng.cache_stats())
    return out


def _info(i):
    return None if i is None else tuple(float(v) for v in i)


def _same_responses(ref, got):
    assert len(got) == len(ref)
    for i, (r, p) in enumerate(zip(ref, got)):
        assert (p.op, p.ok, p.bucket, p.batched, p.error is None) == (
            r.op, r.ok, r.bucket, r.batched, r.error is None), (i, p.op, p.error, r.error)
        assert _info(p.info) == _info(r.info), (i, p.op)
        if not r.ok:
            continue
        want, have = np.asarray(r.x, dtype=np.float64), _np(p.x)
        assert have.shape == want.shape, (i, p.op)
        tol = TOL[str(np.asarray(r.x).dtype)]
        assert np.abs(have - want).max() <= tol * np.abs(want).max(), (i, p.op)


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_responses_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    _same_responses(ref["responses"], got["responses"])
    oks = [r.ok for r in got["responses"]]
    assert oks.count(False) == 7  # nope, infeasible downdate, released, 2 kinds, shape, poisoned
    errors = [r.error for r in got["responses"] if not r.ok]
    assert any("not resident (never seeded)" in e for e in errors)
    assert any("degrade refactor ALSO failed" in e for e in errors)
    assert any("left unchanged" in e for e in errors)


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_factor_stats_and_counts_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    assert got["factor_stats"] == ref["factor_stats"]
    assert got["factor_stats"]["downdate_degrades"] == 1
    assert got["cache"] == ref["cache"]
    keys = ("requests", "ok", "flagged", "failed", "ops", "batches", "queue_depth_max")
    assert {k: got["snap"].get(k) for k in keys} == {k: ref["snap"].get(k) for k in keys}


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_resident_factors_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    for tok, arrays in ref["resident"].items():
        for want, have in zip(arrays, got["resident"][tok]):
            tol = TOL["float64" if tok == "tokC" else "float32"]
            assert have.shape == want.shape, tok
            assert np.abs(have - want).max() <= tol * np.abs(want).max(), tok


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_resident_algebra(runs, sched):
    """What the stream left resident answers for the matrices it names: tokA
    is A after update + downdate, tokD survived both failures untouched,
    chain1 is the whole four-block chain's factor bit for bit."""
    got = runs["torch", sched]
    d = got["data"]
    A64 = d["A"].astype(np.float64)
    for tok in ("tokA", "tokD"):
        R = got["resident"][tok][0]
        assert np.linalg.norm(R.T @ R - A64) / np.linalg.norm(A64) < 5e-5, tok
    Vc = d["V64"]
    RC = got["resident"]["tokC"][0]
    want = d["A64"] + Vc @ Vc.T
    assert np.linalg.norm(RC.T @ RC - want) / np.linalg.norm(want) < 1e-12
    ch1, ch2, _ = d["chains"]
    D = torch.from_numpy(np.concatenate([ch1[0], ch2[0]]))[None]
    C = torch.from_numpy(np.concatenate([ch1[1], ch2[1]]))[None]
    L, Wt, info = blocktri.factor(D, C)
    assert not info.any()
    Lr, Wtr, _ = got["resident"]["chain1"]
    assert np.array_equal(Lr, L[0].double().numpy()) and np.array_equal(Wtr, Wt[0].double().numpy())
    assert np.array_equal(got["resident"]["chain1"][2], Lr[-1])


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_eviction_matches_reference(runs, sched):
    ref, got = runs["jax", sched, "evict"], runs["torch", sched, "evict"]
    _same_responses(ref["responses"], got["responses"])
    assert got["factor_stats"] == ref["factor_stats"]
    assert got["cache"] == ref["cache"]
    fs = got["factor_stats"]
    assert fs["evictions"] >= 3 and sum(fs["eviction_age_hist"].values()) == fs["evictions"]
    errors = [r.error for r in got["responses"] if not r.ok]
    assert len(errors) == 2
    assert "not resident (evicted)" in errors[0] and "EVICTED" in errors[1]


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_records_pass_reference_validators(runs, sched):
    rs = runs["torch", sched]["rec"]["request_stats"]
    assert rledger.validate_request_stats(rs) == []
    assert rs["factor_cache"] == runs["torch", sched]["factor_stats"]


# ---------------------------------------------------------------------------
# FactorCache, held to the reference's on the same operations
# ---------------------------------------------------------------------------


def _fc_ops(name):
    """(budget, [(method, args...)]) of one scenario of tests/test_update.py
    and tests/test_sessions.py's FactorCache tests (n = the factor size)."""
    return {
        "put_lookup": (1 << 20, [("lookup", "a"), ("put", "a", 8), ("lookup", "a")]),
        "byte_budget": (2 * 256, [("put", "a", 8), ("put", "b", 8), ("lookup", "a"), ("put", "c", 8),
                                  ("lookup", "b"), ("lookup", "a"), ("lookup", "c")]),
        "oversized": (256, [("put", "a", 8), ("put", "big", 16), ("lookup", "a"), ("lookup", "big")]),
        "release": (1 << 20, [("put", "a", 8), ("release", "a"), ("release", "a")]),
        "reseed": (256, [("put", "a", 8), ("put", "b", 8), ("put", "a", 8)]),
        "age_hist": (200, [("put", "a", 4), ("lookup", "a"), ("lookup", "a"), ("lookup", "a"),
                           ("lookup", "a"), ("put", "b", 4)]),
        "overwrite": (1 << 20, [("put", "a", 4), ("lookup", "a"), ("put", "a", 4), ("put", "b", 8)]),
    }[name]


@pytest.mark.parametrize("name", ["put_lookup", "byte_budget", "oversized", "release", "reseed",
                                  "age_hist", "overwrite"])
def test_factor_cache_matches_reference(name):
    import jax.numpy as jnp

    budget, ops = _fc_ops(name)
    ours, theirs = FactorCache(budget, device="cpu"), RFactorCache(budget)
    for op, tok, *rest in ops:
        if op == "put":
            n = rest[0]
            got = ours.put(tok, "dense", (torch.eye(n),), {"n": n})
            want = theirs.put(tok, "dense", (jnp.eye(n, dtype=jnp.float32),), {"n": n})
        elif op == "lookup":
            got, want = ours.lookup(tok), theirs.lookup(tok)
            got, want = got is None, want is None
        else:
            got, want = ours.release(tok), theirs.release(tok)
        assert got == want, (name, op, tok)
        assert ours.stats() == theirs.stats(), (name, op, tok)
        for t in ("a", "b", "c", "big"):
            assert ours.evicted(t) == theirs.evicted(t)
            assert (ours.peek(t) is None) == (theirs.peek(t) is None)
            if ours.peek(t) is not None:
                assert ours.peek(t).born == theirs.peek(t).born


def test_factor_cache_holds_contiguous_copies():
    """A resident factor is the pool's own contiguous copy on its device:
    a view's hidden storage is not counted, and later writes to what was
    installed (a client tensor, a landed batch) never reach it."""
    fc = FactorCache(1 << 20, device="cpu")
    big = torch.arange(64.0).reshape(8, 8)
    view = big[:4, :4]
    fc.put("v", "dense", (view,), {})
    R = fc.peek("v").arrays[0]
    assert R.is_contiguous() and R.data_ptr() != view.data_ptr() and R.device.type == "cpu"
    assert fc.stats()["entry_bytes"] == {"v": 4 * 4 * 4}
    big.zero_()
    assert torch.equal(R, torch.arange(64.0).reshape(8, 8)[:4, :4])
    x = np.eye(3, dtype=np.float32)
    fc.put("np", "dense", (x,), {})
    x[0, 0] = 7
    assert fc.peek("np").arrays[0][0, 0] == 1
    with pytest.raises(ValueError, match="budget must be positive"):
        FactorCache(0, device="cpu")


def test_factor_cache_append_blocks_continues_the_chain():
    """append_blocks installs a chain, then continues the resident chain of
    its kind in one fresh contiguous buffer per array, with the carry its
    own copy of the last diagonal block; a chain of another kind is
    replaced, not continued."""
    fc = FactorCache(1 << 20, device="cpu")
    L, Wt = torch.randn(3, 4, 4), torch.randn(3, 4, 4)
    fc.append_blocks("c", "blocktri", L, Wt, {"nblocks": 3})
    L2, Wt2 = torch.randn(5, 4, 4)[::2], torch.randn(3, 4, 4)
    fc.append_blocks("c", "blocktri", L2, Wt2, {"nblocks": 6})
    e = fc.peek("c")
    assert torch.equal(e.arrays[0], torch.cat([L, L2])) and torch.equal(e.arrays[1], torch.cat([Wt, Wt2]))
    assert all(a.is_contiguous() for a in e.arrays) and torch.equal(e.arrays[2], L2[-1])
    ptrs = {a.untyped_storage().data_ptr() for a in (*e.arrays, L, Wt, L2, Wt2)}
    assert len(ptrs) == 7 and e.nbytes == (6 + 6 + 1) * 16 * 4 and fc.installs == 2
    L.zero_(), L2.zero_()
    assert e.arrays[0].abs().sum() > 0 and e.arrays[2].abs().sum() > 0
    fc.append_blocks("c", "session", L2, Wt2, {"nblocks": 3})
    assert fc.peek("c").arrays[0].shape[0] == 3 and fc.peek("c").kind == "session"


def test_install_factor_copies_and_validates():
    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))
    R = torch.eye(16) * 2
    assert eng.install_factor("t", R) == []
    R.zero_()
    assert torch.equal(eng.factors.peek("t").arrays[0], torch.eye(16) * 2)
    with pytest.raises(ValueError, match="square"):
        eng.install_factor("u", np.ones((4, 3)))
    with pytest.raises(ValueError, match="factor_token"):
        eng.submit("posv", np.eye(4), np.ones((4, 1)), factor_token="t")
    with pytest.raises(ValueError, match="requires factor_token"):
        eng.submit("chol_update", np.ones((16, 2)))
    with pytest.raises(ValueError, match="needs A = V"):
        eng.submit("chol_update", np.ones((16, 2)), np.ones((16, 2)), factor_token="t")
    with pytest.raises(ValueError, match="square SPD"):
        eng.submit("posv_cached", np.ones((4, 3)), np.ones((4, 1)), factor_token="t")
    with pytest.raises(ValueError, match="blocktri_extend needs"):
        eng.submit("blocktri_extend", np.ones((2, 2, 8, 4)), factor_token="t")


# ---------------------------------------------------------------------------
# the landing sinks: the downdate degrade and the flagged update
# ---------------------------------------------------------------------------


def _seeded(pkg):
    rng = np.random.default_rng(0)
    n = 16
    A = _spd(rng, n)
    B = rng.standard_normal((n, 2)).astype(np.float32)
    V = ((0.1 / np.sqrt(n)) * rng.standard_normal((n, 2))).astype(np.float32)
    if pkg == "jax":
        eng = rengine.SolveEngine(cfg=rengine.ServeConfig(**LADDERS))
    else:
        eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))
    assert eng.solve("posv_cached", A, B, factor_token="tok").ok
    return eng, A, V


@pytest.fixture(scope="module")
def degrade_runs():
    """The degrade-success path, driven through each engine's landing sink
    with a simulated sweep flag (the sweep itself does not flag feasible
    problems), as tests/test_update.py does."""
    import jax.numpy as jnp

    out = {}
    for pkg in ("jax", "torch"):
        eng, A, V = _seeded(pkg)
        if pkg == "jax":
            sink = eng._update_sink("chol_downdate", "tok", 16, jnp.asarray(V))
            x, info, err = sink(jnp.full((16, 16), jnp.nan, jnp.float32), (), jnp.int32(3))
        else:
            sink = eng._update_sink("chol_downdate", "tok", 16, torch.from_numpy(V))
            x, info, err = sink(torch.full((16, 16), float("nan")), (), torch.tensor(3, dtype=torch.int32))
        out[pkg] = dict(x=_np(x), info=info, err=err, resident=_np(eng.factors.peek("tok").arrays[0]),
                        stats=eng.factor_stats(), cache=eng.cache_stats(), A=A, V=V)
    return out


def test_degrade_success_installs_refactor(degrade_runs):
    ref, got = degrade_runs["jax"], degrade_runs["torch"]
    assert got["err"] is None and ref["err"] is None
    assert tuple(int(v) for v in got["info"][:3]) == tuple(int(v) for v in ref["info"][:3]) == (0, 1, 0)
    assert int(got["info"].escalated) == int(ref["info"].escalated) == 1
    A, V = got["A"].astype(np.float64), got["V"].astype(np.float64)
    Am = A - V @ V.T
    for R in (got["x"], got["resident"]):
        assert np.linalg.norm(R.T @ R - Am) / np.linalg.norm(Am) < 5e-5
    assert np.abs(got["resident"] - ref["resident"]).max() <= 1e-4 * np.abs(ref["resident"]).max()
    assert got["stats"] == ref["stats"] and got["stats"]["downdate_degrades"] == 1
    # the degrade program is built once, counted as a warm-up build
    assert got["cache"] == ref["cache"] and got["cache"]["warmup_compiles"] == 1


def test_update_flag_refuses_result():
    eng, _, V = _seeded("torch")
    R0 = eng.factors.peek("tok").arrays[0].clone()
    sink = eng._update_sink("chol_update", "tok", 16, torch.from_numpy(V))
    _, _, err = sink(torch.zeros(16, 16), (), torch.tensor(2, dtype=torch.int32))
    assert err is not None and "left unchanged" in err
    assert torch.equal(eng.factors.peek("tok").arrays[0], R0)


@pytest.mark.parametrize("donate", [False, True])
def test_flagged_update_leaves_resident_factor_bit_for_bit(donate):
    """The update programs write R' into the assembled factor batch (the
    donated argument when donation is on); the resident R is never that
    buffer, so after an update whose V is poisoned (flagged, refused) the
    resident factor is bit for bit what it was — and so is the tensor a
    clean update replaced."""
    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(donate=donate, **LADDERS))
    eng.validate = donate
    rng = np.random.default_rng(3)
    A, B = _spd(rng, 16), rng.standard_normal((16, 2)).astype(np.float32)
    V = ((0.1 / 4) * rng.standard_normal((16, 2))).astype(np.float32)
    assert eng.solve("posv_cached", A, B, factor_token="t").ok
    R0 = eng.factors.peek("t").arrays[0]
    R0_bits = R0.clone()
    with faultinject.active_plan(faultinject.Fault(tag="serve::ingest", kind="nan")):
        r = eng.solve("chol_update", V, factor_token="t")
    assert not r.ok and "left unchanged" in r.error
    assert eng.factors.peek("t").arrays[0] is R0 and torch.equal(R0, R0_bits)
    r = eng.solve("chol_update", V, factor_token="t")
    assert r.ok
    assert torch.equal(R0, R0_bits) and eng.factors.peek("t").arrays[0].data_ptr() != R0.data_ptr()
    prog = [p for k, p in eng.cache.programs().items() if k[1][0] == "chol_update"][0]
    assert prog.donate_argnums == ((0,) if donate else ())


# ---------------------------------------------------------------------------
# config hash, stats block, sweep estimate
# ---------------------------------------------------------------------------


def test_factor_cache_bytes_not_in_executable_identity():
    a = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))
    b = SolveEngine(Grid.square(device="cpu"), ServeConfig(**{**LADDERS, "factor_cache_bytes": 1 << 30}))
    assert a.cfg.factor_cache_bytes != b.cfg.factor_cache_bytes
    assert a._cfg_hash == b._cfg_hash
    assert b.factors.budget_bytes == 1 << 30


def test_bucket_change_does_alter_identity():
    a = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))
    c = SolveEngine(Grid.square(device="cpu"), ServeConfig(**{**LADDERS, "buckets": (16, 64)}))
    assert a._cfg_hash != c._cfg_hash


def _fc_block(hits=8, misses=2, **over):
    blk = {"hits": hits, "misses": misses, "evictions": 1, "installs": 3, "released": 0,
           "downdate_degrades": 0, "entries": 2, "bytes": 1024, "budget_bytes": 4096,
           "hit_rate": hits / (hits + misses) if hits + misses else 1.0}
    blk.update(over)
    return blk


def test_stats_block_absent_without_factor_traffic():
    for c in (stats.Collector(), rstats.Collector()):
        assert "factor_cache" not in c.snapshot(factor_cache=_fc_block(hits=0, misses=0, installs=0))


def test_stats_block_attached_and_merged():
    c, rc = stats.Collector(), rstats.Collector()
    for col in (c, rc):
        col.record_request("posv_cached", 0.01, ok=True)
    s1, s2 = c.snapshot(factor_cache=_fc_block(8, 2)), c.snapshot(factor_cache=_fc_block(2, 8))
    merged = stats.merge_snapshots([s1, s2])
    assert merged == rstats.merge_snapshots([s1, s2])
    fc = merged["factor_cache"]
    assert fc["hits"] == 10 and fc["misses"] == 10 and fc["hit_rate"] == pytest.approx(0.5)
    s3 = c.snapshot()
    assert "factor_cache" in stats.merge_snapshots([s1, s3])
    assert "factor_cache" not in stats.merge_snapshots([s3, s3])
    assert s1 == rc.snapshot(factor_cache=_fc_block(8, 2))


@pytest.mark.parametrize("over, needle", [({}, None), ({"hits": -1}, "factor_cache.hits"),
                                          ({"hit_rate": 1.5}, "hit_rate"),
                                          ({"hit_rate": 0.3}, "inconsistent")])
def test_validate_request_stats_factor_block(over, needle):
    c = stats.Collector()
    c.record_request("chol_update", 0.01, ok=True)
    probs = rledger.validate_request_stats(c.snapshot(factor_cache=_fc_block(**over)))
    assert probs == [] if needle is None else any(needle in p for p in probs)


@pytest.mark.parametrize("block", [None, {}, {"iters": {"p50": 3.0}}, {"iters": {"p50": 0.2}},
                                   {"iters": {"p50": "x"}}, {"iters": None}, {"requests": 4}])
def test_refine_sweeps_from_stats_matches_reference(block):
    assert tracing.refine_sweeps_from_stats(block) == rtracing.refine_sweeps_from_stats(block)
