"""The sched route's schedules and kernel: capital_tpu_torch.parallel.summa's
tile schedules and capital_tpu_torch.ops.hopper.sched_matmul_plain against
the JAX package's (`summa._sched_pairs`, `pallas_tpu.sched_matmul` in
interpret mode), on the CPU.

Schedules must be equal exactly.  Tolerances of the product, relative to
the largest |reference| entry: f64 1e-12, f32 1e-5 (sums in another order),
bf16 2e-2 (both accumulate in f32 and round the result to bf16 once;
compared in f32).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import pallas_tpu
from capital_tpu.parallel import summa as jsumma
from capital_tpu_torch import Grid
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.parallel import summa as tsumma
from capital_tpu_torch.utils.interop import tensor_from_numpy

NP_DT = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}
TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}


def test_sched_blocks_match_the_reference():
    for x in (96, 128, 256, 384, 512, 640, 1024, 2048, 4096, 8192, 1536, 3000):
        for y in (128, 512, 768, 4096):
            assert tsumma._sched_blocks(x, y, x) == jsumma._sched_blocks(x, y, x)


# (M, K, N): 128-tileable at d = 2 and 4, a shape whose shards do not tile
# (192: 96 per shard at d = 2), and one whose only tiling is a single tile
# per shard in K and the tri side (frac >= 1: no skipping, None)
SHAPES = [(512, 512, 512), (1024, 2048, 512), (2048, 1024, 4096), (8192, 8192, 8192),
          (192, 192, 192), (256, 128, 256)]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_sched_pairs_match_the_reference(d, side, uplo):
    jgrid = types.SimpleNamespace(dx=d)
    tgrid = Grid.rect(d, d, 1, devices=["cpu"] * d * d)
    seen_none = False
    for M, K, N in SHAPES:
        if M % d or K % d or N % d:
            continue
        au, bu = (uplo, None) if side == "a" else (None, uplo)
        want = jsumma._sched_pairs(jgrid, M, K, N, au, bu)
        got = tsumma._sched_pairs(tgrid, M, K, N, au, bu)
        gate = tsumma._shard_sched_gate(tgrid, M, K, N, au, bu, None)
        assert (got is None) == (want is None) == (gate is None), (M, K, N)
        if want is None:
            seen_none = True
            continue
        assert got[1] == want[1] and got[2] == want[2]
        for g, w in zip(got[0], want[0]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert seen_none


def test_sched_gate_refuses_what_the_reference_refuses(grid2x2x1, grid2x2x2):
    t221 = Grid.rect(2, 2, 1, devices=["cpu"] * 4)
    t222 = Grid.square(c=2, devices=["cpu"] * 8)
    t_q2 = Grid.rect(2, 2, 1, devices=["cpu"] * 4, num_chunks=2)
    for tg, jg in ((t221, grid2x2x1), (t222, grid2x2x2)):
        for args in (("L", None, None), (None, "U", None), ("L", "U", None), (None, None, "U"),
                     ("L", None, "U"), (None, None, None)):
            want = jsumma._shard_sched_gate(jg, 512, 512, 512, *args)
            got = tsumma._shard_sched_gate(tg, 512, 512, 512, *args)
            assert (got is None) == (want is None), args
    assert tsumma._shard_sched_gate(t_q2, 512, 512, 512, "L", None, None) is None


@pytest.mark.parametrize("args", [("L", None, None), (None, "U", None), (None, None, "U"),
                                  ("U", None, None), (None, None, None)])
def test_tri_fractions_match_the_reference(grid2x2x1, grid2x2x2, args):
    t221 = Grid.rect(2, 2, 1, devices=["cpu"] * 4)
    t222 = Grid.square(c=2, devices=["cpu"] * 8)
    for tg, jg in ((t221, grid2x2x1), (t222, grid2x2x2)):
        for M, K, N in ((512, 512, 512), (256, 1024, 512), (96, 64, 32)):
            assert tsumma.tri_fractions(tg, M, K, N, *args) == jsumma.tri_fractions(jg, M, K, N, *args)


def _operands(M, K, N, dt, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, K)).astype(NP_DT[dt])
    B = rng.standard_normal((K, N)).astype(NP_DT[dt])
    return A, B


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


# (M, K, N, blocks (bm, bn, bk), side, uplo, rank): the stacked schedule of
# a d = 2 trmm, one rank's row — rank 0 of a lower operand carries pads
KERNEL_CASES = [
    (256, 512, 256, "a", "L", 0),
    (256, 512, 256, "a", "U", 1),
    (256, 512, 256, "b", "L", 1),
    (256, 512, 256, "b", "U", 0),
    (512, 1024, 256, "a", "L", 0),
]


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_plain_matches_the_pallas_kernel(dt, case):
    mb, K, nb, side, uplo, rank = KERNEL_CASES[case]
    au, bu = (uplo, None) if side == "a" else (None, uplo)
    # the global shapes of a d = 2 trmm whose per-rank slabs are (mb, K) @ (K, nb)
    (TO, KO, FI, LA), _, blocks = tsumma._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
    to, ko, fi, la = (x[rank] for x in (TO, KO, FI, LA))
    if case == 0:
        assert fi[-1] == 0 and la[-1] == 0  # a schedule with pad entries
    A, B = _operands(mb, K, nb, dt, seed=case)
    want = pallas_tpu.sched_matmul(
        jnp.asarray(A), jnp.asarray(B), *(jnp.asarray(x) for x in (to, ko, fi, la)),
        tri_side=side, blocks=blocks, interpret=True,
    )
    got = hopper.sched_matmul(
        tensor_from_numpy(A), tensor_from_numpy(B), *(torch.from_numpy(x) for x in (to, ko, fi, la)),
        tri_side=side, blocks=blocks,
    )
    assert got.dtype == tensor_from_numpy(A).dtype and got.shape == (mb, nb)
    g, w = _f32(got), _f32(want)
    assert np.abs(g - w).max() <= TOL[dt] * np.abs(w).max()


@pytest.mark.parametrize("blocks", [(128, 128, 128), (256, 128, 256), (128, 256, 128)])
def test_plain_matches_the_pallas_kernel_at_other_blocks(blocks):
    """A hand-made schedule over 256-blocks: every tile listed, skipped
    k-tiles, and pads repeating the last pair."""
    bm, bn, bk = blocks
    M, K, N = 512, 512, 512
    nt, nk = M // bm, K // bk
    pairs = [(t, k) for t in range(nt) for k in range(nk) if k >= t * nk // nt]
    to = np.array([t for t, _ in pairs] + [pairs[-1][0]] * 2, np.int32)
    ko = np.array([k for _, k in pairs] + [pairs[-1][1]] * 2, np.int32)
    fi = np.array([int(i == 0 or pairs[i - 1][0] != t) for i, (t, _) in enumerate(pairs)] + [0, 0],
                  np.int32)
    la = np.array([int(i == len(pairs) - 1 or pairs[i + 1][0] != t)
                   for i, (t, _) in enumerate(pairs)] + [0, 0], np.int32)
    A, B = _operands(M, K, N, "f64", seed=5)
    want = pallas_tpu.sched_matmul(jnp.asarray(A), jnp.asarray(B), *map(jnp.asarray, (to, ko, fi, la)),
                                   tri_side="a", blocks=blocks, interpret=True)
    got = hopper.sched_matmul(torch.from_numpy(A), torch.from_numpy(B),
                              *map(torch.from_numpy, (to, ko, fi, la)), tri_side="a", blocks=blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12 * np.abs(want).max())


def test_wrapper_refuses_and_counts_only_launches():
    A, B = torch.ones(256, 256), torch.ones(256, 256)
    s = torch.zeros(2, dtype=torch.int32)
    one = torch.ones(2, dtype=torch.int32)
    kw = dict(tri_side="a", blocks=(128, 128, 128))
    hopper.reset_counts()
    out = hopper.sched_matmul(A, B, s, s, one, one, **kw)
    assert float(out[0, 0]) == 128.0 and bool(out[128:].isnan().all())  # unlisted tiles: NaN
    assert hopper.counts()["sched_matmul"] == 0  # the CPU runs the plain version
    with pytest.raises(ValueError, match="tri_side"):
        hopper.sched_matmul(A, B, s, s, one, one, tri_side="c", blocks=(128, 128, 128))
    with pytest.raises(ValueError, match="must tile"):
        hopper.sched_matmul(A, B, s, s, one, one, tri_side="a", blocks=(96, 128, 128))
    with pytest.raises(ValueError, match="int32"):
        hopper.sched_matmul(A, B, s.long(), s, one, one, **kw)
    with pytest.raises(ValueError, match="one length"):
        hopper.sched_matmul(A, B, s[:1], s, one, one, **kw)
    with pytest.raises(ValueError, match="cannot multiply"):
        hopper.sched_matmul(A, B[:128], s, s, one, one, **kw)


# ---- explicit SUMMA on the mesh: trmm / syrk / gemm against the reference ---
# The JAX side runs under jit on the conftest's virtual CPU devices (Pallas
# in interpret mode); the port on the in-process mesh of CPU ranks.  Route
# notes (explicit::*) must be equal; values within 1e-10 relative (f64).

from capital_tpu.parallel.topology import Grid as JGrid  # noqa: E402
from capital_tpu.utils import tracing as jtracing  # noqa: E402
from capital_tpu_torch.utils import tracing as ttracing  # noqa: E402


def _notes(rec):
    return {k: v.calls for k, v in rec.stats.items() if k.startswith("explicit::")}


def _tgrid(c, q=0):
    return Grid.square(c=c, devices=["cpu"] * (4 * c), num_chunks=q)


def _jgrid(c, q=0):
    return JGrid.square(c=c, devices=jax.devices("cpu")[: 4 * c], num_chunks=q)


def _both(op, jgrid, tgrid, arrays, **kw):
    """Run summa.`op` in mode 'explicit' in both packages; returns the two
    results (f64 numpy) and the two note dicts."""
    with jtracing.Recorder() as jrec:
        want = jax.jit(lambda *a: getattr(jsumma, op)(jgrid, *a, mode="explicit", **kw))(
            *map(jnp.asarray, arrays))
    with ttracing.Recorder() as trec:
        got = getattr(tsumma, op)(tgrid, *map(torch.from_numpy, arrays), mode="explicit",
                                  **{k: _torch_args(v) for k, v in kw.items()})
    return got.numpy(), np.asarray(want), _notes(trec), _notes(jrec)


def _torch_args(v):
    """The port's *Args dataclass of the same name and fields."""
    return getattr(tsumma, type(v).__name__)(**{f: getattr(v, f) for f in v.__dataclass_fields__})


def _close(got, want):
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _mats(n, seed, tri=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n))
    if tri is not None:
        X = X / np.sqrt(n) + 4 * np.eye(n)
    return X


@pytest.mark.parametrize("side,uplo,n", [("L", "L", 512), ("L", "U", 512), ("R", "L", 512),
                                         ("R", "U", 512), ("L", "L", 192)])
def test_explicit_trmm_2x2x1(side, uplo, n):
    T, B = _mats(n, 21, tri=True), _mats(n, 22)
    got, want, tn, jn = _both("trmm", _jgrid(1), _tgrid(1), (T, B),
                              args=jsumma.TrmmArgs(side=side, uplo=uplo))
    _close(got, want)
    assert tn == jn and tn.get("explicit::shard_sched", 0) == (1 if n == 512 else 0)


@pytest.mark.parametrize("uplo,trans", [("U", True), ("L", False)])
def test_explicit_syrk_and_gemm_2x2x1(uplo, trans):
    A, C = _mats(512, 23), _mats(512, 24)
    got, want, tn, jn = _both("syrk", _jgrid(1), _tgrid(1), (A, C),
                              args=jsumma.SyrkArgs(uplo=uplo, trans=trans, alpha=-1.0, beta=1.0))
    _close(got, want)
    assert tn == jn
    got, want, tn, jn = _both("gemm", _jgrid(1), _tgrid(1), (A, C),
                              args=jsumma.GemmArgs(trans_a=trans, alpha=0.5))
    _close(got, want)
    assert tn == jn


@pytest.mark.parametrize("op", ["trmm_L", "trmm_R", "syrk", "gemm"])
def test_explicit_2x2x2_chunked(op):
    """The c > 1 route (masked-psum panels, chunked depth collect) with
    num_chunks 2."""
    n = 256
    X, Y = _mats(n, 25, tri=True), _mats(n, 26)
    jg, tg = _jgrid(2, 2), _tgrid(2, 2)
    if op.startswith("trmm"):
        args = jsumma.TrmmArgs(side=op[-1], uplo="U", trans_a=True, alpha=-1.0)
        got, want, tn, jn = _both("trmm", jg, tg, (X, Y), args=args)
    elif op == "syrk":
        got, want, tn, jn = _both("syrk", jg, tg, (Y,), args=jsumma.SyrkArgs(uplo="U", trans=True))
    else:
        got, want, tn, jn = _both("gemm", jg, tg, (X, Y), args=jsumma.GemmArgs(trans_b=True))
    _close(got, want)
    assert tn == jn == {}


def test_explicit_matmul_records_the_reference_costs():
    """One trmm per route on 2x2x1 prices flops, the executed views,
    collectives and copy bytes as the reference does."""
    for n in (512, 192):
        T, B = _mats(n, 27, tri=True), _mats(n, 28)
        args = jsumma.TrmmArgs(side="L", uplo="L")
        with jtracing.Recorder() as jrec:
            jax.jit(lambda t, b: jsumma.trmm(_jgrid(1), t, b, args, mode="explicit"))(
                jnp.asarray(T), jnp.asarray(B))
        with ttracing.Recorder() as trec:
            tsumma.trmm(_tgrid(1), torch.from_numpy(T), torch.from_numpy(B), _torch_args(args),
                        mode="explicit")
        jt, tt = jrec.total(), trec.total()
        for f in ("calls", "flops", "comm_bytes", "collectives", "flops_vol", "flops_max",
                  "copy_bytes"):
            assert getattr(tt, f) == pytest.approx(getattr(jt, f), rel=1e-12), f
