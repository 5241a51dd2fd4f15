"""Streaming state-space sessions in the port's serve engine
(capital_tpu_torch/serve/sessions.py: SessionManager over SolveEngine's
session ops) against the JAX package's (capital_tpu/serve/sessions.py), on
the CPU.

One seeded session stream (numpy, `_session_stream`) goes through the JAX
SessionManager and through the port's on a CPU grid, under both schedulers
(module-scoped fixture): open, solves at all three accuracy tiers, contract
and append (the sliding window), close, steady-state cycles over two
sessions, a breakdown in an appended segment, and an f32 session.  A second
stream evicts a session under a small factor-cache budget, raises
SessionEvicted and reseeds through open.

Equal, per step: `ok`, `error is None` (or the raised exception's type),
the whole-chain offsets, the segment-relative breakdown pivot; and at the
end the session stats, `factor_stats()` and `cache_stats()`.  Close: X and
the contract's head factor block within 1e-10 of max|ref| in f64 and 1e-4
in f32 (the 'fast' tier factors in f32).  Solves answer for the window
mirror (the marginalized head after contract) in f64 numpy; the port's
session_stats record passes `validate_session_stats`.  The unit tests port
tests/test_sessions.py's TestFactorCacheStats.
"""

import re

import numpy as np
import pytest
import torch

from capital_tpu.obs import ledger as rledger
from capital_tpu.serve import engine as rengine
from capital_tpu.serve import sessions as rsessions
from capital_tpu_torch import Grid
from capital_tpu_torch.serve import FactorCache, ServeConfig, SessionEvicted, SessionManager, SolveEngine

SCHEDULERS = ("continuous", "sync")
LADDERS = dict(buckets=(8,), rows_buckets=(32,), nrhs_buckets=(2,), max_batch=2, max_delay_s=10.0,
               nblocks_buckets=(2, 4), block_buckets=(4,))
#: fits one 4-block f64 session entry (L + Wt + carry = 1152 bytes), not two
EVICT_BYTES = 2000
TOL = {"float32": 1e-4, "float64": 1e-10}


def _chain(rng, nblocks, b, dtype=np.float64, live_head=False):
    """One SPD window (the session wire shape): gram/b + 3I diagonals,
    0.3/sqrt(b) couplings; `live_head` keeps C[0] (an append segment)."""
    G = rng.standard_normal((nblocks, b, b))
    D = G @ G.transpose(0, 2, 1) / b + 3.0 * np.eye(b)
    C = 0.3 / np.sqrt(b) * rng.standard_normal((nblocks, b, b))
    if not live_head:
        C[0] = 0.0
    return D.astype(dtype), C.astype(dtype)


def _np_dense(D, C):
    """Dense assembly of one window in f64 numpy."""
    nblocks, b = D.shape[0], D.shape[1]
    A = np.zeros((nblocks * b, nblocks * b))
    for i in range(nblocks):
        sl = slice(i * b, (i + 1) * b)
        A[sl, sl] = D[i]
        if i:
            up = slice((i - 1) * b, i * b)
            A[sl, up] = C[i]
            A[up, sl] = C[i].T
    return A


def _np(x):
    return np.asarray(x.double().cpu().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


class _Recorder:
    """Runs each manager call, recording what it answered: the response's
    (ok, error is None, x, error) or the exception raised."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.steps = []

    def __call__(self, name, *args, **kw):
        if kw.get("accuracy_tier", "balanced") != "balanced":
            name = f"{name}/{kw['accuracy_tier']}"
        try:
            r = getattr(self.mgr, name.split("/")[0])(*args, **kw)
        except (SessionEvicted, rsessions.SessionEvicted, KeyError, ValueError) as e:
            self.steps.append((name, "raise", type(e).__name__, str(e)))
            return None
        x = None if r.x is None else _np(r.x)
        f32 = r.x is not None and "float32" in str(r.x.dtype)
        self.steps.append((name, r.ok, r.error is None, x, r.error, f32))
        return r

    def residual_solve(self, sid, rng, tier="balanced"):
        """Solve against a fresh RHS and check it against the window mirror
        in f64 numpy; returns the max error relative to max|ref|."""
        Dw, Cw = (_np(x) for x in self.mgr.window(sid))
        nb, b = Dw.shape[0], Dw.shape[1]
        B = rng.standard_normal((nb, b, 2))
        r = self("solve", sid, B, accuracy_tier=tier)
        ref = np.linalg.solve(_np_dense(Dw, Cw), B.reshape(nb * b, 2))
        return float(np.abs(_np(r.x).reshape(nb * b, 2) - ref).max() / np.abs(ref).max())


def _session_stream(eng, mgr):
    """The main stream (module docstring); returns (steps, residuals,
    offsets)."""
    rng = np.random.default_rng(50)
    rec = _Recorder(mgr)
    res, offs = [], []
    D, C = _chain(rng, 4, 4)
    rec("open", "s", D, C)
    for tier in ("balanced", "guaranteed", "fast"):
        res.append((tier, rec.residual_solve("s", rng, tier)))
    rec("contract", "s", 2)
    res.append(("balanced", rec.residual_solve("s", rng)))
    rec("append", "s", *_chain(rng, 2, 4, live_head=True))
    res.append(("balanced", rec.residual_solve("s", rng)))
    res.append(("guaranteed", rec.residual_solve("s", rng, "guaranteed")))
    rec("close", "s")
    rec("close", "s")  # already gone: succeeds, released flag 0
    # steady-state cycles over two sessions
    for sid in ("s1", "s2"):
        rec("open", sid, *_chain(rng, 4, 4))
        for _ in range(2):
            rec("append", sid, *_chain(rng, 2, 4, live_head=True))
            rec("contract", sid, 2)
            res.append(("balanced", rec.residual_solve(sid, rng)))
    # a breakdown in the second appended block: the segment fails loudly
    # and the resident chain and the mirror stay as they were
    rec("open", "p", *_chain(rng, 2, 4))
    offs.append(mgr.segment_offset("p"))
    Da, Ca = _chain(rng, 2, 4, live_head=True)
    Da[1] = np.diag([1.0, 1.0, -5.0, 1.0])
    Ca[1] = 0.0
    r = rec("append", "p", Da, Ca)
    local = int(re.search(r"info=(\d+)", r.error).group(1))
    offs += [local, mgr.absolute_pivot("p", local), mgr.segment_offset("p")]
    res.append(("balanced", rec.residual_solve("p", rng)))
    rec("contract", "p", 1)
    offs += [mgr.pivot_offset("p"), mgr.segment_offset("p")]
    # an f32 session
    rec("open", "f", *_chain(rng, 4, 4, dtype=np.float32))
    res.append(("f32", rec.residual_solve("f", rng)))
    rec("contract", "f", 1)
    rec("append", "f", *_chain(rng, 1, 4, dtype=np.float32, live_head=True))
    res.append(("bf16", rec.residual_solve("f", rng, "fast")))  # f32's fast tier factors in bf16
    # protocol misuse: raises before the engine, or a loud failed Response
    rec("append", "ghost", *_chain(rng, 2, 4))
    rec("solve", "ghost", np.zeros((2, 4, 2)))
    rec("open", "w", D, C[:1])
    rec("open", "w", *_chain(rng, 2, 4))
    rec("append", "w", *_chain(rng, 2, 8))
    rec("solve", "w", np.zeros((3, 4, 2)))
    rec("contract", "w", 2)
    r = eng.solve("session_append", np.stack(_chain(rng, 2, 4)), factor_token="ghost")
    rec.steps.append(("engine append", r.ok, r.error is None, None, r.error, False))
    r = eng.solve("session_contract", 1, factor_token="ghost")
    rec.steps.append(("engine contract", r.ok, r.error is None, None, r.error, False))
    return rec.steps, res, offs


def _eviction_stream(mgr):
    rng = np.random.default_rng(60)
    rec = _Recorder(mgr)
    D1, C1 = _chain(rng, 4, 4)
    rec("open", "s1", D1, C1)
    rec("open", "s2", *_chain(rng, 4, 4))  # evicts s1 under the budget
    B = rng.standard_normal((4, 4, 2))
    rec("solve", "s1", B)                  # SessionEvicted, mirror dropped
    rec("solve", "s1", B)                  # KeyError: not open here
    rec("open", "s1", D1, C1)              # the reseed
    rec("solve", "s1", B)
    return rec.steps, (D1, C1, B)


def _engine(pkg, sched, **kw):
    if pkg == "jax":
        return rengine.SolveEngine(cfg=rengine.ServeConfig(scheduler=sched, **LADDERS, **kw))
    return SolveEngine(Grid.square(device="cpu"), ServeConfig(scheduler=sched, **LADDERS, **kw))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for sched in SCHEDULERS:
        for pkg in ("jax", "torch"):
            eng = _engine(pkg, sched)
            mgr = (rsessions.SessionManager if pkg == "jax" else SessionManager)(eng)
            steps, res, offs = _session_stream(eng, mgr)
            out[pkg, sched] = dict(steps=steps, res=res, offs=offs, stats=mgr.stats(),
                                   factor_stats=eng.factor_stats(), cache=eng.cache_stats(),
                                   rec=mgr.emit_session_stats(), req=eng.emit_stats())
            eng = _engine(pkg, sched, factor_cache_bytes=EVICT_BYTES)
            mgr = (rsessions.SessionManager if pkg == "jax" else SessionManager)(eng)
            steps, data = _eviction_stream(mgr)
            out[pkg, sched, "evict"] = dict(steps=steps, data=data, stats=mgr.stats(),
                                            factor_stats=eng.factor_stats())
    return out


def _same_steps(ref, got):
    assert len(got) == len(ref)
    for i, (r, p) in enumerate(zip(ref, got)):
        assert p[:3] == r[:3], (i, p, r)
        if r[1] == "raise" or r[3] is None:
            continue
        want, have = r[3], p[3]
        assert have.shape == want.shape, (i, p[0])
        # the fast tier factors one dtype down: f32 for an f64 session
        tol = TOL["float32" if r[5] or p[0].endswith("/fast") else "float64"]
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(have - want).max() <= tol * scale, (i, p[0])


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_session_steps_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    _same_steps(ref["steps"], got["steps"])
    assert got["offs"] == ref["offs"]
    b = 4
    seg0, local, absolute, seg1, piv, seg2 = got["offs"]
    assert seg0 == seg1 == seg2 == 2 * b and piv == b
    assert b + 1 <= local <= 2 * b and 3 * b + 1 <= absolute <= 4 * b


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_solves_answer_for_the_window(runs, sched):
    """Every solve answers for the window mirror (the marginalized head
    after contract), at each tier's tolerance (the f32 session's fast tier
    factors in bf16: the repo's bf16 gate, 5e-2)."""
    for tier, err in runs["torch", sched]["res"]:
        assert err < {"balanced": 1e-9, "guaranteed": 1e-9, "fast": 5e-4, "f32": 5e-4, "bf16": 5e-2}[tier], (tier, err)


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_session_and_factor_stats_match_reference(runs, sched):
    ref, got = runs["jax", sched], runs["torch", sched]
    assert got["stats"] == ref["stats"]
    assert got["factor_stats"] == ref["factor_stats"]
    assert got["cache"] == ref["cache"]
    st = got["stats"]
    assert st["failures"] == 1 and st["misses"] == 0 and st["hit_rate"] == 1.0  # the breakdown append
    assert rledger.validate_session_stats(st) == []


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_steady_state_cycles_build_nothing(runs, sched):
    """Session churn is host-side state keyed by session id: the whole
    stream builds one program per bucket, as the reference compiles one."""
    got = runs["torch", sched]
    assert got["cache"]["compiles"] == got["cache"]["entries"] == runs["jax", sched]["cache"]["compiles"]


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_records_pass_reference_validators(runs, sched):
    got = runs["torch", sched]
    rec = got["rec"]
    assert rec["kind"] == "serve:session_stats" and rec["manifest"]["platform"] == "cpu"
    assert rledger.validate_session_stats(rec["session_stats"]) == []
    assert rec["session_stats"] == got["stats"]
    rs = got["req"]["request_stats"]
    assert rledger.validate_request_stats(rs) == []
    assert set(rs["ops"]) >= {"session_open", "session_append", "session_solve", "session_contract",
                              "session_close"}


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_evicted_session_raises_and_reseeds(runs, sched):
    ref, got = runs["jax", sched, "evict"], runs["torch", sched, "evict"]
    _same_steps(ref["steps"], got["steps"])
    steps = got["steps"]
    assert steps[2][1:3] == ("raise", "SessionEvicted") and "re-seed" in steps[2][3]
    assert steps[3][1:3] == ("raise", "KeyError")
    assert got["stats"] == ref["stats"] and got["factor_stats"] == ref["factor_stats"]
    st = got["stats"]
    assert st["evicted_failures"] == st["misses"] == 1 and st["reseeds"] == 1 and st["hit_rate"] < 1.0
    assert rledger.validate_session_stats(st) == []
    D1, C1, B = got["data"]
    ref_x = np.linalg.solve(_np_dense(D1, C1), B.reshape(16, 2))
    assert np.abs(steps[-1][3].reshape(16, 2) - ref_x).max() <= 1e-9


def test_session_manager_keeps_the_window_on_the_engine_device():
    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))
    mgr = SessionManager(eng)
    rng = np.random.default_rng(1)
    D, C = _chain(rng, 4, 4)
    assert mgr.open("s", D, C).ok
    Dw, Cw = mgr.window("s")
    assert isinstance(Dw, torch.Tensor) and Dw.device == eng.grid.device and Dw.dtype == torch.float64
    assert not Cw[0].any() and np.array_equal(Dw.numpy(), D)
    Dw.zero_()  # a copy: the mirror is untouched
    assert np.array_equal(mgr.window("s")[0].numpy(), D)
    assert mgr.contract("s", 1).ok
    L = eng.factors.peek("s").arrays[0]
    Dh = mgr.window("s")[0][0]
    assert torch.equal(Dh, L[0] @ L[0].mT)
    with pytest.raises(ValueError, match="requires factor_token"):
        eng.submit("session_solve", np.stack([D, C]), np.zeros((4, 4, 2)))
    with pytest.raises(ValueError, match="scalar"):
        eng.submit("session_contract", np.ones(2), factor_token="s")
    with pytest.raises(ValueError, match="no operands"):
        eng.submit("session_close", np.ones(2), factor_token="s")


# ---------------------------------------------------------------------------
# FactorCache stats: per-entry bytes and the eviction-age histogram
# ---------------------------------------------------------------------------


def _arrays(n=4):
    return (torch.zeros((n, n), dtype=torch.float64),)


def test_entry_bytes_ledger():
    fc = FactorCache(budget_bytes=1 << 20, device="cpu")
    fc.put("a", "chol", _arrays(4), {})
    fc.put("b", "chol", _arrays(8), {})
    s = fc.stats()
    assert s["entry_bytes"] == {"a": 4 * 4 * 8, "b": 8 * 8 * 8}
    assert s["bytes"] == sum(s["entry_bytes"].values()) and s["entries"] == 2


def test_eviction_age_histogram_on_op_clock():
    fc = FactorCache(budget_bytes=200, device="cpu")
    fc.put("a", "chol", _arrays(4), {})
    for _ in range(4):
        assert fc.lookup("a") is not None
    assert fc.put("b", "chol", _arrays(4), {}) == ["a"]
    s = fc.stats()
    assert s["eviction_age_hist"] == {"8": 1}
    assert sum(s["eviction_age_hist"].values()) == s["evictions"] and fc.evicted("a")


def test_born_preserved_across_overwrite():
    fc = FactorCache(budget_bytes=1 << 20, device="cpu")
    fc.put("a", "chol", _arrays(4), {})
    born0 = fc.peek("a").born
    fc.lookup("a")
    fc.put("a", "chol", _arrays(4), {})
    assert fc.peek("a").born == born0


def test_stats_block_validates_in_request_stats():
    eng = SolveEngine(Grid.square(device="cpu"), ServeConfig(**LADDERS))

    def probs(fc_stats):
        snap = eng.emit_stats()["request_stats"]
        snap["factor_cache"] = fc_stats
        return [p for p in rledger.validate_request_stats(snap) if "factor_cache" in p]

    fc = FactorCache(budget_bytes=200, device="cpu")
    fc.put("a", "session", _arrays(4), {})
    fc.lookup("a")
    fc.put("b", "session", _arrays(4), {})
    assert probs(fc.stats()) == []
    s = fc.stats()
    s["entry_bytes"]["b"] += 8
    assert any("entry_bytes" in p for p in probs(s))
    s = fc.stats()
    s["eviction_age_hist"]["8"] = s["eviction_age_hist"].get("8", 0) + 1
    assert any("eviction_age_hist" in p for p in probs(s))
