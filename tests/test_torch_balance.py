"""The balanced layouts on the mesh: the port's (capital_tpu_torch, an
in-process mesh of CPU ranks) against the JAX package's (the conftest's
virtual CPU devices, Pallas interpreted, under jit), operand for operand.

* the layout helpers: tile_cyclic_perm, cyclic_index, the persistent
  windows (cyclic_window / cyclic_window_update — in place, band-sized),
  take_triangle_cyclic, the cyclic tile rule, the balanced cost model and
  the persistent schedules (_sched_pairs_cyclic);
* summa.trmm / syrk with balance='tile_cyclic' and
  'tile_cyclic_persistent', with their fallback notes and contract errors;
* cholesky.factor with both layouts, and inverse.rectri(balance=
  'tile_cyclic').

Every parity test also holds the Recorder's note set and per-scope flops,
comm_bytes and copy_bytes to the JAX package's.  Tolerances, relative
Frobenius difference against JAX: f64 1e-10, f32 1e-5, bf16 2e-2 (the
classes of test_torch_cholesky_mesh).  The sizes follow the JAX package's
own tests (tests/test_summa.py TestTileCyclicBalance / TestPersistentLayout,
tests/test_cholinv.py, tests/test_inverse_trsm.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.models import inverse as jinv
from capital_tpu.ops import masking as jmask
from capital_tpu.parallel import summa as jsumma
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.models import inverse as tinv
from capital_tpu_torch.ops import masking as tmask
from capital_tpu_torch.parallel import summa as tsumma
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils import tracing as ttracing
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
VS_JAX = {"f64": 1e-10, "f32": 1e-5, "bf16": 2e-2}
GATE = {"f64": 1e-13, "f32": 2e-6, "bf16": 1e-2}
FIELDS = ("flops", "comm_bytes", "copy_bytes", "collectives", "flops_vol", "flops_max")


def _grids(c=1):
    return (JGrid.square(c=c, devices=jax.devices("cpu")[: 4 * c]),
            Grid.square(c=c, devices=["cpu"] * (4 * c)))


def _rand(shape, seed, dt="f64"):
    return np.random.default_rng(seed).standard_normal(shape).astype(NP_DT[dt])


def _spd(n, dt="f64", seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + 3.0 * np.eye(n)).astype(NP_DT[dt])


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_model(jrec, trec):
    """The note set and every scope's priced model agree."""
    assert set(trec.stats) == set(jrec.stats)
    for tag, want in jrec.stats.items():
        got = trec.stats[tag]
        assert got.calls == want.calls, tag
        for f in FIELDS:
            assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9), (tag, f)


def _both(jfn, tfn, *arrays):
    """(port result, JAX result) of the same numpy operands, each under its
    package's Recorder; the models are held equal."""
    with jtracing.Recorder() as jrec:
        want = jax.jit(jfn)(*(jnp.asarray(a) for a in arrays))
    with ttracing.Recorder() as trec:
        got = tfn(*(tensor_from_numpy(a) for a in arrays))
    _same_model(jrec, trec)
    return got, want, trec


# ---- the layout helpers ---------------------------------------------------


@pytest.mark.parametrize("n,d,t", [(64, 2, 8), (96, 2, 8), (384, 2, 192), (256, 4, 16)])
def test_cyclic_maps_match_jax(n, d, t):
    for got, want in zip(tsumma.tile_cyclic_perm(n, d, t), jsumma.tile_cyclic_perm(n, d, t)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmask.cyclic_index(n, d, t).numpy(),
                                  np.asarray(jmask.cyclic_index(n, d, t)))
    with pytest.raises(ValueError, match="must tile"):
        tsumma.tile_cyclic_perm(n + t, d, t)


def test_cyclic_window_roundtrip_in_place():
    """Windows come out in window-local cyclic layout (JAX's values
    exactly); the write-back lands in the buffer itself, touching only the
    window."""
    d, t, n = 2, 8, 96
    X = _rand((n, n), 71)
    perm, _ = tsumma.tile_cyclic_perm(n, d, t)
    V = X[perm][:, perm]
    Vt = torch.from_numpy(V.copy())
    for view in [(0, 0, 32, 32), (32, 16, 64, 48), (64, 0, 32, 96), (0, 0, 96, 96)]:
        W = tsumma.cyclic_window(Vt, view, d, t)
        np.testing.assert_array_equal(W.numpy(), np.asarray(jsumma.cyclic_window(jnp.asarray(V), view, d, t)))
        r0, c0, rows, cols = view
        rp, _ = tsumma.tile_cyclic_perm(rows, d, t)
        cp, _ = tsumma.tile_cyclic_perm(cols, d, t)
        np.testing.assert_array_equal(W.numpy(), X[r0:r0 + rows, c0:c0 + cols][rp][:, cp])
        new = torch.from_numpy(_rand((rows, cols), 72))
        ptr = Vt.data_ptr()
        back = tsumma.cyclic_window_update(Vt, new, view, d, t)
        assert back is Vt and Vt.data_ptr() == ptr
        want = jsumma.cyclic_window_update(jnp.asarray(V), jnp.asarray(new.numpy()), view, d, t)
        np.testing.assert_array_equal(Vt.numpy(), np.asarray(want))
        Vt.copy_(torch.from_numpy(V))
    with pytest.raises(ValueError, match="must align"):
        tsumma.cyclic_window(Vt, (8, 0, 32, 32), d, t)
    with pytest.raises(ValueError, match="must align"):
        tsumma.cyclic_window_update(Vt, torch.zeros(32, 32, dtype=Vt.dtype), (8, 0, 32, 32), d, t)


@pytest.mark.parametrize("uplo,strict", [("U", False), ("L", False), ("U", True), ("L", True)])
def test_take_triangle_cyclic_matches_jax(uplo, strict):
    d, t, n = 2, 8, 64
    V = _rand((n, n), 73)
    got = tmask.take_triangle_cyclic(torch.from_numpy(V), uplo, d, t, strict=strict)
    want = jmask.take_triangle_cyclic(jnp.asarray(V), uplo, d, t, strict=strict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim,override", [(49152, 0), (768, 0), (2560, 0), (4608, 0), (2304, 0),
                                          (256, 0), (64, 0), (64, 16), (100, 0)])
def test_pick_cyclic_tile_matches_jax(dim, override):
    for c in (1, 2):
        g = types.SimpleNamespace(dx=2, dy=2, c=c, num_chunks=0, num_devices=4 * c)
        assert tsumma._pick_cyclic_tile(g, dim, override) == jsumma._pick_cyclic_tile(g, dim, override)


@pytest.mark.parametrize("d", [2, 4])
def test_balanced_cost_model_matches_jax(d):
    g = types.SimpleNamespace(dx=d, dy=d, c=1, num_chunks=0, num_devices=d * d)
    n, T = 64, 64 // d // 4
    for kw in (dict(a_uplo="U"), dict(a_uplo="L", cyclic_rows=T), dict(a_uplo="U", cyclic_rows=T),
               dict(out_uplo="U", cyclic_out=T), dict(out_uplo="L", cyclic_out=T)):
        got = tsumma.tri_fractions(g, n, n, n, **kw)
        assert got == pytest.approx(jsumma.tri_fractions(g, n, n, n, **kw))
    block = tsumma.tri_fractions(g, n, n, n, a_uplo="U")
    cyc = tsumma.tri_fractions(g, n, n, n, a_uplo="U", cyclic_rows=T)
    assert block[1] == 1.0 and cyc[1] < block[1]  # the critical path drops


@pytest.mark.parametrize("side,uplo,shape,t", [("a", "L", (384, 384, 768), 192),
                                               ("a", "U", (1024, 1024, 512), 256),
                                               ("b", "U", (768, 384, 384), 192),
                                               ("b", "L", (512, 512, 512), 64)])
def test_persistent_schedules_match_jax(side, uplo, shape, t):
    M, K, N = shape
    au, bu = (uplo, None) if side == "a" else (None, uplo)
    g = types.SimpleNamespace(dx=2, dy=2, c=1, num_chunks=0, num_devices=4)
    want = jsumma._sched_pairs_cyclic(g, M, K, N, au, bu, t)
    got = tsumma._sched_host_cyclic(2, M, K, N, au, bu, t)
    for x, y in zip(got[0], want[0]):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got[1:] == want[1:]  # the executed fraction and the blocks
    _, tg = _grids()
    dev = tsumma._sched_pairs_cyclic(tg, M, K, N, au, bu, t)
    assert dev is tsumma._sched_pairs_cyclic(tg, M, K, N, au, bu, t)  # built once


# ---- summa with balance='tile_cyclic' --------------------------------------


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_trmm_tile_cyclic_matches_jax(uplo):
    jg, tg = _grids()
    args = dict(side="L", uplo=uplo, alpha=-2.0)
    got, want, trec = _both(
        lambda a, b, o: jsumma.trmm(jg, a, b, jsumma.TrmmArgs(**args), mode="explicit",
                                    balance="tile_cyclic", out=o, out_off=(64, 8)),
        lambda a, b, o: tsumma.trmm(tg, a, b, tsumma.TrmmArgs(**args), mode="explicit",
                                    balance="tile_cyclic", out=o, out_off=(64, 8)),
        _rand((64, 64), 31), _rand((64, 8), 32), np.zeros((128, 16)))
    assert _rel(got, want) < VS_JAX["f64"]
    assert "trmm::tile_cyclic_fallback" not in trec.stats


@pytest.mark.parametrize("trans,uplo", [(True, "U"), (False, "L")])
def test_syrk_tile_cyclic_matches_jax(trans, uplo):
    jg, tg = _grids()
    args = dict(trans=trans, uplo=uplo, alpha=0.5)
    got, want, trec = _both(
        lambda a: jsumma.syrk(jg, a, args=jsumma.SyrkArgs(**args), mode="explicit",
                              balance="tile_cyclic"),
        lambda a: tsumma.syrk(tg, a, args=tsumma.SyrkArgs(**args), mode="explicit",
                              balance="tile_cyclic"),
        _rand((64, 64), 41))
    assert _rel(got, want) < VS_JAX["f64"]
    assert "syrk::tile_cyclic_fallback" not in trec.stats


def test_tile_cyclic_falls_back_with_a_note_like_jax():
    """c = 2 (no balanced schedule): the block schedule and its note."""
    jg, tg = _grids(c=2)
    got, want, trec = _both(
        lambda a, b: (jsumma.trmm(jg, a, b, jsumma.TrmmArgs(side="L", uplo="U"), mode="explicit",
                                  balance="tile_cyclic"),
                      jsumma.syrk(jg, a, args=jsumma.SyrkArgs(trans=True), mode="explicit",
                                  balance="tile_cyclic")),
        lambda a, b: (tsumma.trmm(tg, a, b, tsumma.TrmmArgs(side="L", uplo="U"), mode="explicit",
                                  balance="tile_cyclic"),
                      tsumma.syrk(tg, a, args=tsumma.SyrkArgs(trans=True), mode="explicit",
                                  balance="tile_cyclic")),
        _rand((64, 64), 35), _rand((64, 16), 36))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < VS_JAX["f64"]
    assert trec.stats["trmm::tile_cyclic_fallback"].calls == 1
    assert trec.stats["syrk::tile_cyclic_fallback"].calls == 1


# ---- summa with balance='tile_cyclic_persistent' ----------------------------


def _layout(X, d, t):
    perm, inv = tsumma.tile_cyclic_perm(X.shape[0], d, t)
    return X[perm][:, perm], inv


@pytest.mark.parametrize("side,uplo,dt", [("L", "L", "f64"), ("R", "U", "f64"), ("L", "L", "bf16")])
def test_trmm_persistent_matches_jax(side, uplo, dt):
    jg, tg = _grids()
    d, t, n = 2, 8, 64
    T0 = (np.tril(_rand((n, n), 73)) + 4 * np.eye(n)).astype(NP_DT[dt])
    B0 = _rand((n, n), 74, dt)
    Tp, inv = _layout(T0, d, t)
    Tin = Tp if uplo == "L" else np.ascontiguousarray(Tp.T)
    kw = dict(mode="explicit", balance="tile_cyclic_persistent", cyclic_tile=t)
    got, want, trec = _both(
        lambda a, b: jsumma.trmm(jg, a, b, jsumma.TrmmArgs(side=side, uplo=uplo), **kw),
        lambda a, b: tsumma.trmm(tg, a, b, tsumma.TrmmArgs(side=side, uplo=uplo), **kw),
        Tin, _layout(B0, d, t)[0])
    assert _rel(got, want) < VS_JAX[dt]
    assert trec.stats["trmm::persistent_cyclic"].calls == 1
    assert trec.stats["explicit::shard_sched"].calls == 1


def test_trmm_persistent_windowed_out_matches_jax():
    """Window reads and the band-sized write into a larger buffer, which
    the port mutates in place."""
    jg, tg = _grids()
    d, t, p, n = 2, 8, 128, 64
    Xp, _ = _layout(_rand((p, p), 75), d, t)
    Op, _ = _layout(_rand((p, p), 76), d, t)
    kw = dict(mode="explicit", balance="tile_cyclic_persistent", cyclic_tile=t,
              a_view=(0, 0, n, n), b_view=(0, 64, n, n), out_off=(64, 0))
    args = dict(side="L", uplo="L", alpha=-1.0)
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda a, o: jsumma.trmm(jg, a, a, jsumma.TrmmArgs(**args), out=o, **kw))(
            jnp.asarray(Xp), jnp.asarray(Op))
    X, O = torch.from_numpy(Xp), torch.from_numpy(Op.copy())
    with ttracing.Recorder() as trec:
        got = tsumma.trmm(tg, X, X, tsumma.TrmmArgs(**args), out=O, **kw)
    _same_model(jrec, trec)
    assert got is O
    np.testing.assert_allclose(O.numpy(), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_syrk_persistent_in_place_matches_jax(uplo):
    jg, tg = _grids()
    d, t, p, n = 2, 8, 128, 64
    Xp, _ = _layout(_rand((p, p), 77), d, t)
    C0 = _rand((p, p), 78)
    Cp, _ = _layout(C0 + C0.T, d, t)
    kw = dict(mode="explicit", balance="tile_cyclic_persistent", cyclic_tile=t,
              a_view=(0, 0, n, n), c_view=(64, 64, n, n), in_place=True)
    args = dict(trans=True, uplo=uplo, alpha=-1.0, beta=1.0)
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda a, c: jsumma.syrk(jg, a, c, jsumma.SyrkArgs(**args), **kw))(
            jnp.asarray(Xp), jnp.asarray(Cp))
    X, C = torch.from_numpy(Xp), torch.from_numpy(Cp.copy())
    with ttracing.Recorder() as trec:
        got = tsumma.syrk(tg, X, C, tsumma.SyrkArgs(**args), **kw)
    _same_model(jrec, trec)
    assert got is C and trec.stats["syrk::persistent_cyclic"].calls == 1
    np.testing.assert_allclose(C.numpy(), np.asarray(want), atol=1e-12)


def test_persistent_contract_raises_like_jax():
    jg, tg = _grids()
    jg2, tg2 = _grids(c=2)
    A = _rand((64, 64), 79)
    cases = [
        (jg, tg, "trmm", dict(args=dict(side="L", uplo="L")), {}),  # no cyclic_tile
        (jg, tg, "trmm", dict(args=dict(side="L", uplo="L", diag="U")), dict(cyclic_tile=8)),
        (jg2, tg2, "syrk", dict(args=dict(trans=True)), dict(cyclic_tile=8)),  # c = 2
        (jg, tg, "syrk", dict(args=dict(trans=True)), dict(cyclic_tile=8, mode="xla")),
    ]
    for jgrid, tgrid, op, a, kw in cases:
        kw = dict(dict(mode="explicit", balance="tile_cyclic_persistent"), **kw)
        msgs = []
        for pkg, grid, X in ((jsumma, jgrid, jnp.asarray(A)), (tsumma, tgrid, torch.from_numpy(A))):
            with pytest.raises(ValueError) as e:
                if op == "trmm":
                    pkg.trmm(grid, X, X, pkg.TrmmArgs(**a["args"]), **kw)
                else:
                    pkg.syrk(grid, X, args=pkg.SyrkArgs(**a["args"]), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---- cholinv and rectri ---------------------------------------------------


def _factor_both(A, c=1, **kw):
    jg, tg = _grids(c)
    jcfg = jchol.CholinvConfig(mode="explicit", **kw)
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda a: jchol.factor(jg, a, jcfg))(jnp.asarray(A))
    with ttracing.Recorder() as trec:
        got = tchol.factor(tg, tensor_from_numpy(A), tchol.CholinvConfig(mode="explicit", **kw))
    _same_model(jrec, trec)
    return got, want, trec


def _gates(A, R, Rinv, dt):
    A64, R64, RI64 = (torch.tensor(_f64(x)) for x in (A, R, Rinv))
    assert float(tres.cholesky_residual(A64, R64)) < GATE[dt]
    assert float(tres.cholesky_inverse_residual(R64, RI64)) < GATE[dt]


@pytest.mark.parametrize("dt,n,bc,sip", [("f64", 512, 128, False), ("f32", 512, 128, True),
                                         ("bf16", 512, 128, False), ("f64", 100, 16, False)])
def test_cholinv_persistent_matches_jax(dt, n, bc, sip):
    """One permute at entry (t = bc / d), every window in layout, one
    un-permute at exit; the padded n = 100 crops."""
    A = _spd(n, dt, seed=n)
    (R, Ri), (jR, jRi), trec = _factor_both(A, base_case_dim=bc, schur_in_place=sip,
                                            balance="tile_cyclic_persistent")
    assert R.shape == (n, n)
    assert _rel(R, jR) < VS_JAX[dt] and _rel(Ri, jRi) < VS_JAX[dt]
    assert "cholinv::persistent_fallback" not in trec.stats
    assert trec.stats["syrk::persistent_cyclic"].calls >= 1
    assert trec.stats["trmm::persistent_cyclic"].calls >= 1
    _gates(A, R, Ri, dt)


def test_cholinv_persistent_partial_inverse_matches_jax():
    A = _spd(512, seed=8)
    (R, Ri), (jR, jRi), _ = _factor_both(A, base_case_dim=128, complete_inv=False,
                                         balance="tile_cyclic_persistent")
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]
    assert float(Ri[:256, 256:].abs().max()) == 0.0


def test_cholinv_tile_cyclic_matches_jax():
    """balance='tile_cyclic' from balance_min_window up: the balanced trsm
    and Schur schedules, whose critical path drops below the block one."""
    A = _spd(256, seed=9)
    (R, Ri), (jR, jRi), trec = _factor_both(A, base_case_dim=32, balance="tile_cyclic",
                                            balance_min_window=64)
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]
    (_, _), (_, _), brec = _factor_both(A, base_case_dim=32)
    assert trec.stats["CI::trsm"].flops_max < brec.stats["CI::trsm"].flops_max
    assert trec.stats["CI::tmu"].flops_max < brec.stats["CI::tmu"].flops_max
    _gates(A, R, Ri, "f64")


def test_cholinv_persistent_falls_back_on_2x2x2_like_jax():
    A = _spd(64, seed=10)
    (R, Ri), (jR, jRi), trec = _factor_both(A, c=2, base_case_dim=16,
                                            balance="tile_cyclic_persistent")
    assert trec.stats["cholinv::persistent_fallback"].calls == 1
    assert "syrk::persistent_cyclic" not in trec.stats
    assert _rel(R, jR) < VS_JAX["f64"] and _rel(Ri, jRi) < VS_JAX["f64"]


@pytest.mark.parametrize("balance", ["tile_cyclic", "tile_cyclic_persistent", "cyclic"])
def test_cholinv_balance_errors_match_jax(balance):
    jg, tg = _grids()
    A = _spd(64)
    msgs = []
    for pkg, grid, X in ((jchol, jg, jnp.asarray(A)), (tchol, tg, torch.from_numpy(A))):
        with pytest.raises(ValueError) as e:
            pkg.factor(grid, X, pkg.CholinvConfig(mode="xla", balance=balance))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("dt", ["f64", "bf16"])
def test_rectri_tile_cyclic_matches_jax(dt):
    n = 512
    rng = np.random.default_rng(11)
    L = (np.tril(rng.standard_normal((n, n)), -1) / np.sqrt(n) + 3.0 * np.eye(n)).astype(NP_DT[dt])
    jg, tg = _grids()
    kw = dict(base_case_dim=64, mode="explicit", balance="tile_cyclic", balance_min_window=64)
    got, want, trec = _both(lambda t: jinv.rectri(jg, t, "L", jinv.RectriConfig(**kw)),
                            lambda t: tinv.rectri(tg, t, "L", tinv.RectriConfig(**kw)), L)
    assert _rel(got, want) < VS_JAX[dt]
    # every side-L merge balances but the one of 256 (two 128-row tiles on
    # a d = 2 face: an identity permutation, refused as JAX refuses it)
    assert trec.stats["trmm::tile_cyclic_fallback"].calls == 1
    err = np.linalg.norm(np.eye(n) - _f64(L) @ _f64(got)) / np.sqrt(n)
    assert err < {"f64": 1e-13, "bf16": 5e-2}[dt]
