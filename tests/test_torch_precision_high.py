"""precision='high' on f32: the port's bf16x3 split contraction against the
JAX package's, on the CPU.

At 'high' every in-kernel product of the JAX package on f32 operands
splits each operand into bf16 hi = RN(x) and lo = RN(x − hi) and sums
hi·hi + (hi·lo + lo·hi) in f32 (capital_tpu/ops/pallas_tpu.py
_split_bf16 / precision_dot).  The port computes the same in its kernels'
plain versions (`hopper.split_matmul`), which the CUDA routes 'x3' and
'simt3' are held to on the card (tests/test_torch_gpu.py, chip_smoke.py
phase 19).  The JAX side runs as its own tests run it: Pallas in interpret
mode, the factors under jit on the conftest's CPU devices.  Operands are
made with numpy from a seed.

Tolerances and the check that the split is computed:
* kernels: the port's 'high' within 1e-6 × max|JAX 'high'| (the same
  exact bf16 products, f32 sums in another order); the port's 'highest'
  (IEEE f32) differs from JAX's 'high' by more than 5× the measured
  'high'-against-'high' difference.  The split's own error is ~4e-6 of
  max|ref| for a product of normal operands, so the distinction is taken
  against the measured agreement (2e-7 to 5e-7 here), not against the
  1e-6 tolerance;
* the reference's error profile (tests/test_pallas_tpu.py:44-77): against
  an f64 product, 'high' is within 50× the IEEE result's error and below
  1/20 of a one-pass bf16 product's;
* the slice (cholinv, the 2x2x1 mesh, CholeskyQR2): relative Frobenius of
  the port's 'high' against JAX's 'high' below the f32 class of the other
  parity tests (1e-5), and closer than the port's 'highest' is.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.models import cholesky as jchol
from capital_tpu.models import qr as jqr
from capital_tpu.ops import pallas_tpu
from capital_tpu.ops import qr_fused as jqf
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky as tchol
from capital_tpu_torch.models import inverse as tinv
from capital_tpu_torch.models import qr as tqr
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.ops import qr_fused as tqf
from capital_tpu_torch.parallel import summa as tsumma
from capital_tpu_torch.utils import tracing as ttracing

AGREE = 1e-6  # × max|JAX 'high'|
APART = 5.0   # the port's 'highest' vs JAX's 'high', over the measured agreement
VS_JAX = 1e-5  # slice, relative Frobenius


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _normal(seed, *shape, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _split_is_computed(high, highest, want):
    """The port's 'high' agrees with JAX's 'high'; its 'highest' does not."""
    high, highest, want = _f64(high), _f64(highest), _f64(want)
    scale = np.abs(want).max()
    agree = np.abs(high - want).max()
    apart = np.abs(highest - want).max()
    assert agree <= AGREE * scale, (agree / scale)
    assert apart > APART * agree and apart > 0, (apart / scale, agree / scale)


def _rel(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------------
# the split itself
# --------------------------------------------------------------------------


def test_split_is_the_reference_split_bit_for_bit():
    x = np.concatenate([
        _normal(0, 4096), _normal(1, 1024, scale=1e-30), _normal(2, 1024, scale=1e30),
        np.array([0.0, -0.0, 1.0, 1 + 2.0**-8, 1 + 2.0**-9, 3.4e38, 1e-45, np.inf, -np.inf, np.nan],
                 dtype=np.float32),
    ])
    jh, jl = pallas_tpu._split_bf16(jnp.asarray(x))
    th, tl = hopper.split_bf16(torch.from_numpy(x))
    for got, want in ((th, jh), (tl, jl)):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,b,precision,want", [
    (torch.float32, torch.float32, "high", True),
    (torch.float32, torch.float32, "highest", False),
    (torch.float32, torch.float32, None, False),
    (torch.float32, torch.float32, "default", False),
    (torch.float64, torch.float64, "high", False),
    (torch.bfloat16, torch.bfloat16, "high", False),
    (torch.float32, torch.bfloat16, "high", False),
])
def test_split_rule_is_precision_dots(a, b, precision, want):
    assert hopper.split_high(a, b, precision) is want


# --------------------------------------------------------------------------
# the kernels against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

P = 512
TRI_CASES = {
    "trmm_U": dict(a_uplo="U"),
    "trmm_L_trans_views": dict(a_uplo="L", a_trans=True, a_view=(128, 128, 256, 256),
                               b_view=(0, 128, 256, 384)),
    "trmm_side_R": dict(b_uplo="U", alpha=-1.0),
    "syrk_U": dict(out_uplo="U", a_trans=True),
    "syrk_L": dict(out_uplo="L", b_trans=True),
    "dense": dict(b_trans=True, a_view=(0, 0, 256, 384), b_view=(256, 0, 256, 384)),
}


@pytest.mark.parametrize("case", list(TRI_CASES))
def test_tri_matmul_high_matches_jax(case):
    kw = TRI_CASES[case]
    A, B = _normal(10, P, P), _normal(11, P, P)
    want = pallas_tpu.tri_matmul(jnp.asarray(A), jnp.asarray(B), precision="high",
                                 interpret=True, **kw)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    high = hopper.tri_matmul(At, Bt, precision="high", **kw)
    highest = hopper.tri_matmul(At, Bt, precision="highest", **kw)
    if "out_uplo" in kw:  # the dead half: zero on both sides
        assert not np.any(_f64(high)[_f64(want) == 0] != 0)
    _split_is_computed(high, highest, want)


def test_tri_matmul_high_keeps_nan_in_the_dead_triangle_out():
    A, B = _normal(12, 256, 256), _normal(13, 256, 256)
    Anan = A.copy()
    Anan[np.tril_indices(256, -1)] = np.nan
    got = hopper.tri_matmul(torch.from_numpy(Anan), torch.from_numpy(B), a_uplo="U", precision="high")
    want = hopper.tri_matmul(torch.from_numpy(np.triu(A)), torch.from_numpy(B), precision="high")
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("side", ["a", "b"])
def test_sched_matmul_high_matches_jax(side):
    mb, K, nb = 256, 512, 256
    au, bu = ("L", None) if side == "a" else (None, "U")
    (TO, KO, FI, LA), _, blocks = tsumma._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
    sched = [x[0] for x in (TO, KO, FI, LA)]
    A, B = _normal(20, mb, K), _normal(21, K, nb)
    want = pallas_tpu.sched_matmul(jnp.asarray(A), jnp.asarray(B), *(jnp.asarray(x) for x in sched),
                                   tri_side=side, blocks=blocks, precision="high", interpret=True)
    args = (torch.from_numpy(A), torch.from_numpy(B), *(torch.from_numpy(x) for x in sched))
    high = hopper.sched_matmul(*args, tri_side=side, blocks=blocks, precision="high")
    highest = hopper.sched_matmul(*args, tri_side=side, blocks=blocks, precision="highest")
    live = ~np.isnan(_f64(high))  # tiles no pair lists are undefined
    assert np.array_equal(live, ~np.isnan(_f64(highest)))
    _split_is_computed(_f64(high)[live], _f64(highest)[live], _f64(want)[live])


def _qr_operands():
    A = _normal(30, 1024, 512, scale=1 / 32)
    R = np.triu(_normal(31, 512, 512, scale=1 / np.sqrt(512))) + np.eye(512, dtype=np.float32)
    return A, R


@pytest.mark.parametrize("name", ["gram_blocked", "scale_blocked", "scale_gram"])
def test_qr_kernels_high_match_jax(name):
    A, R = _qr_operands()
    args = (A,) if name == "gram_blocked" else (A, R)
    want = getattr(jqf, name)(*(jnp.asarray(x) for x in args), bm=512, g=4, precision="high",
                              interpret=True)
    targs = tuple(torch.from_numpy(x) for x in args)
    high = getattr(tqf, name)(*targs, bm=512, g=4, precision="high")
    highest = getattr(tqf, name)(*targs, bm=512, g=4, precision="highest")
    if name == "scale_gram":
        for h, hh, w in zip(high, highest, want):
            _split_is_computed(h, hh, w)
    else:
        _split_is_computed(high, highest, want)


# --------------------------------------------------------------------------
# the reference's error profile
# --------------------------------------------------------------------------


def test_tri_matmul_high_error_profile():
    """tests/test_pallas_tpu.py:44-77 on the port: 'high' within 50× of the
    IEEE product's error against f64 and below 1/20 of one-pass bf16's."""
    n = 256
    A, B = _normal(7, n, n), _normal(8, n, n)
    ref = np.triu(A.astype(np.float64)) @ B.astype(np.float64)
    scale = np.abs(ref).max()

    def err(precision):
        got = hopper.tri_matmul(torch.from_numpy(A), torch.from_numpy(B), a_uplo="U", precision=precision)
        return np.abs(_f64(got) - ref).max() / scale

    bf = torch.from_numpy(np.triu(A)).bfloat16().float() @ torch.from_numpy(B).bfloat16().float()
    e_bf16 = np.abs(_f64(bf) - ref).max() / scale
    e_high, e_highest = err("high"), err("highest")
    assert e_high < 50 * max(e_highest, 1e-9)
    assert e_high < e_bf16 / 20
    assert e_high > e_highest  # the split is not the IEEE product


def test_gram_high_beats_one_pass_bf16():
    """tests/test_qr_fused.py:87-104 on the port: the 'high' gram is
    f32-grade and far below a one-pass bf16 gram's error."""
    A = _normal(13, 1024, 512, scale=1 / 32)
    want = A.astype(np.float64).T @ A.astype(np.float64)
    G = _f64(tqf.assemble_sym(tqf.gram_blocked(torch.from_numpy(A), bm=512, precision="high"), 256))
    np.testing.assert_allclose(G, want, rtol=2e-4, atol=2e-3)
    Ab = torch.from_numpy(A).bfloat16().float()
    G1 = _f64(tqf.assemble_sym(tqf.gram_blocked(Ab, bm=512), 256))
    assert np.abs(G - want).max() < np.abs(G1 - want).max() / 50


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,precision,aligned,want", [
    (torch.float32, "high", True, "x3"), (torch.float32, "high", False, "simt3"),
    (torch.float32, "highest", True, "fma"), (torch.float32, None, True, "fma"),
    (torch.float32, "default", False, "simt"), (torch.float64, "high", True, "dmma"),
    (torch.float64, "high", False, "simt"), (torch.bfloat16, "high", True, "wgmma"),
    (torch.bfloat16, "high", False, "wmma"),
])
def test_route_rule_reads_the_precision(dtype, precision, aligned, want):
    assert hopper._pick_route(dtype, aligned, None, "tri_matmul", precision) == want


@pytest.mark.parametrize("dtype,precision,asked", [
    (torch.float32, "high", "fma"), (torch.float32, "highest", "x3"), (torch.float32, None, "simt3"),
    (torch.bfloat16, "high", "x3"), (torch.float64, "high", "simt3"),
])
def test_route_rule_refuses_a_route_of_another_precision(dtype, precision, asked):
    with pytest.raises(ValueError):
        hopper._pick_route(dtype, True, asked, "tri_matmul", precision)


def test_split_route_needs_alignment():
    with pytest.raises(ValueError, match="cannot take"):
        hopper._pick_route(torch.float32, False, "x3", "tri_matmul", "high")


@pytest.mark.parametrize("dtype,precision,blocks,want", [
    (torch.float32, "high", (512, 512, 512), "x3"), (torch.float32, "high", (256, 512, 256), "x3"),
    (torch.float32, "high", (192, 512, 192), "simt3"), (torch.float32, "high", (128, 128, 32), "simt3"),
    (torch.float32, None, (512, 512, 512), "fma"), (torch.float32, None, (192, 512, 192), "simt"),
    (torch.float64, "high", (512, 512, 512), "dmma"), (torch.bfloat16, "high", (192, 512, 192), "simt"),
])
def test_sched_route_reads_the_precision(dtype, precision, blocks, want):
    assert hopper.sched_route(dtype, True, blocks, precision) == want


def test_unaligned_sched_operands_take_simt3():
    assert hopper.sched_route(torch.float32, False, (512, 512, 512), "high") == "simt3"


@pytest.mark.parametrize("dtype,precision,want", [
    (torch.float32, "high", "x3"), (torch.float32, "highest", "fma"), (torch.float32, None, "fma"),
    (torch.bfloat16, "high", "wgmma"), (torch.float64, "high", "dmma"),
])
def test_qr_route_reads_the_precision(dtype, precision, want):
    assert tqf._route(torch.empty((128, 128), dtype=dtype), precision) == want


def test_x3_gram_splits_count_one_block_an_sm():
    """The x3 gram is the ring (one block an SM, as bf16's), not the f32 FMA
    loop (two)."""
    assert tqf.gram_splits(65536, 512, 4, torch.float32, "high") == \
        tqf.gram_splits(65536, 512, 4, torch.bfloat16)
    assert tqf.gram_splits(65536, 512, 4, torch.float32) == 26


@pytest.mark.parametrize("fn", [hopper.tri_matmul, hopper.sched_matmul, tqf.gram_blocked,
                                tqf.scale_blocked, tqf.scale_gram])
def test_no_wrapper_takes_a_route(fn):
    params = inspect.signature(fn).parameters
    assert not any("route" in p for p in params), list(params)


class _Spy:
    """Records (dtype, aligned, precision, blocks) of every tri_matmul /
    sched_matmul call, then runs the real wrapper."""

    def __init__(self, monkeypatch):
        self.calls = []
        real_mm, real_sched = hopper.tri_matmul, hopper.sched_matmul

        def mm(A, B, **kw):
            ok = (hopper._tma_ok(A, hopper._full_view(A, kw.get("a_view")))
                  and hopper._tma_ok(B, hopper._full_view(B, kw.get("b_view"))))
            self.calls.append(hopper._pick_route(A.dtype, ok, None, "tri_matmul", kw.get("precision")))
            return real_mm(A, B, **kw)

        def sched(A, B, *s, **kw):
            ok = hopper._tma_ok(A, (0, 0)) and hopper._tma_ok(B, (0, 0))
            self.calls.append(hopper.sched_route(A.dtype, ok, kw["blocks"], kw.get("precision")))
            return real_sched(A, B, *s, **kw)

        monkeypatch.setattr(hopper, "tri_matmul", mm)
        monkeypatch.setattr(hopper, "sched_matmul", sched)


def _spd(n, seed=0) -> np.ndarray:
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + 3.0 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("precision,want", [("high", "x3"), ("highest", "fma"), (None, "fma")])
def test_cholinv_and_rectri_calls_take_the_precisions_route(monkeypatch, precision, want):
    spy = _Spy(monkeypatch)
    R, _ = tchol.factor(Grid.square(device="cpu"), torch.from_numpy(_spd(512)),
                        tchol.CholinvConfig(mode="pallas", base_case_dim=128, precision=precision))
    tinv.rectri(Grid.square(device="cpu"), R.T.contiguous(), "L",
                tinv.RectriConfig(base_case_dim=128, mode="pallas", precision=precision))
    assert len(spy.calls) == 4 * 3 + 2 * 3
    assert spy.calls == [want] * len(spy.calls)


def test_mesh_calls_take_x3(monkeypatch):
    spy = _Spy(monkeypatch)
    tchol.factor(Grid.rect(2, 2, 1, devices=["cpu"] * 4), torch.from_numpy(_spd(1024)),
                 tchol.CholinvConfig(mode="explicit", base_case_dim=256, precision="high"))
    assert spy.calls == ["x3"] * 12


# --------------------------------------------------------------------------
# the slice against the JAX package at 'high'
# --------------------------------------------------------------------------


def _held_to_jax(got_high, got_highest, want):
    for h, hh, w in zip(got_high, got_highest, want):
        assert _rel(h, w) < VS_JAX
        assert _rel(h, w) < _rel(hh, w)


def test_cholinv_high_matches_jax():
    A = _spd(512)
    jg = JGrid.square(c=1, devices=jax.devices("cpu")[:1])
    jcfg = jchol.CholinvConfig(mode="pallas", base_case_dim=128, precision="high")
    want = jax.jit(lambda a: jchol.factor(jg, a, jcfg))(jnp.asarray(A))
    tg = Grid.square(device="cpu")
    got = {p: tchol.factor(tg, torch.from_numpy(A), tchol.CholinvConfig(
        mode="pallas", base_case_dim=128, precision=p)) for p in ("high", "highest")}
    _held_to_jax(got["high"], got["highest"], want)


def test_mesh_cholinv_high_matches_jax():
    """2x2x1, mode 'explicit', n = 1024 at bc 256: the top node's three
    trmms run sched_matmul (at n = 512 no product of this mesh reaches a
    kernel: all are torch.matmul segment products, IEEE f32 on both sides)."""
    A = _spd(1024)
    jg = JGrid.square(c=1, devices=jax.devices("cpu")[:4])
    jcfg = jchol.CholinvConfig(mode="explicit", base_case_dim=256, precision="high")
    want = jax.jit(lambda a: jchol.factor(jg, a, jcfg))(jnp.asarray(A))
    tg = Grid.rect(2, 2, 1, devices=["cpu"] * 4)
    got = {}
    for p in ("high", "highest"):
        with ttracing.Recorder() as rec:
            got[p] = tchol.factor(tg, torch.from_numpy(A), tchol.CholinvConfig(
                mode="explicit", base_case_dim=256, precision=p))
        assert rec.stats["explicit::shard_sched"].calls == 3
    _held_to_jax(got["high"], got["highest"], want)


def test_cqr2_high_matches_jax():
    A = _normal(40, 1024, 512, scale=1 / 32)
    jg = JGrid.square(c=1, devices=jax.devices("cpu")[:1])
    jQ, jR = jqr.factor(jg, jnp.asarray(A), jqr.CacqrConfig(regime="1d", mode="pallas", precision="high"))
    tg = Grid.square(device="cpu")
    got = {p: tqr.factor(tg, torch.from_numpy(A), tqr.CacqrConfig(regime="1d", mode="pallas", precision=p))
           for p in ("high", "highest")}
    (Q, R), (Qh, Rh) = got["high"], got["highest"]
    _held_to_jax((Q, np.triu(_f64(R))), (Qh, np.triu(_f64(Rh))), (jQ, np.triu(_f64(jR))))
    Q64 = _f64(Q)
    assert np.abs(Q64.T @ Q64 - np.eye(512)).max() < 5e-5
