"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test takes the `cuda` fixture, which skips when no CUDA
device is present (decided at run time, never at import or collection).
Run on a machine with an H100: `python -m pytest -m gpu tests/test_torch_gpu.py`.

Tolerances, relative to the largest |plain| entry: f64 1e-12, f32 1e-5
(IEEE FMA against the CPU-style sum order of the plain matmul), bf16 one
bf16 ulp per entry plus 1e-5 (both sides accumulate in f32 and round once).
"""

import numpy as np
import pytest
import torch

from capital_tpu_torch import Grid
from capital_tpu_torch.models import arrowhead, blocktri, cholesky, inverse, qr
from capital_tpu_torch.ops import _build, batched_small, blocktri_small, hopper, qr_fused, sweeps, tsqr, update_small
from capital_tpu_torch.parallel import summa
from capital_tpu_torch.robust import refine
from capital_tpu_torch.serve import api
from capital_tpu_torch.utils import residual

pytestmark = pytest.mark.gpu

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
P = 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dt, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(DTYPES[dt]).to(dev)


def _close(got, want, dt, mask=None):
    got, want = got.double().cpu(), want.double().cpu()
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = float(want.abs().max())
    err = (got - want).abs()
    if dt == "bf16":
        assert bool((err <= 2.0**-7 * want.abs() + 1e-5 * scale).all()), float(err.max())
    else:
        assert float(err.max()) <= {"f64": 1e-12, "f32": 1e-5}[dt] * scale


MM_CASES = {
    "trsm": dict(a_uplo="U", a_trans=True, a_view=(0, 0, 512, 512),
                 b_view=(0, 512, 512, 512), out="third", out_off=(0, 512)),
    "inv_side_R": dict(b_uplo="U", alpha=-1.0, a_view=(0, 0, 384, 512),
                       b_view=(512, 512, 512, 512), out="B", out_off=(0, 512)),
    "lower_ragged": dict(a_uplo="L", alpha=0.5, a_view=(128, 64, 300, 300),
                         b_view=(7, 3, 300, 200)),
    "dense_bt": dict(b_trans=True, a_view=(0, 0, 320, 448), b_view=(64, 0, 256, 448)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(MM_CASES))
def test_tri_matmul_kernel_vs_plain(cuda, case, dt):
    kw = dict(MM_CASES[case])
    where = kw.pop("out", None)
    A, B = _rand(1, (P, P), dt, cuda), _rand(2, (P, P), dt, cuda)
    outs = []
    for fn in (hopper.tri_matmul, hopper.tri_matmul_plain):
        a, b = A.clone(), B.clone()
        out = {"B": b, "third": _rand(3, (P, P), dt, cuda)}.get(where)
        outs.append(fn(a, b, out=out, **kw))
    torch.cuda.synchronize()
    _close(outs[0], outs[1], dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("in_place", [False, True])
def test_syrk_kernel_vs_plain(cuda, in_place, dt):
    A, C = _rand(4, (P, P), dt, cuda), _rand(5, (P, P), dt, cuda)
    kw = dict(a_trans=True, b_trans=False, out_uplo="U", alpha=-1.0, beta=1.0,
              a_view=(0, 512, 512, 512), b_view=(0, 512, 512, 512),
              c_view=(512, 512, 512, 512))
    res = []
    for fn in (hopper.tri_matmul, hopper.tri_matmul_plain):
        c = C.clone()
        extra = dict(out=c, out_off=(512, 512)) if in_place else {}
        res.append(fn(A, A, c=c, **kw, **extra))
    torch.cuda.synchronize()
    live = torch.triu(torch.ones(512, 512, dtype=torch.bool))
    if in_place:
        mask = torch.zeros(P, P, dtype=torch.bool)
        mask[512:, 512:] = live
        _close(res[0], res[1], dt, mask)
        outside = torch.ones(P, P, dtype=torch.bool)
        outside[512:, 512:] = False
        assert torch.equal(res[0].cpu()[outside], C.cpu()[outside])
    else:
        _close(res[0], res[1], dt, live)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_syrk_beta0_zeroes_dead_half(cuda, dt):
    A = _rand(6, (P, P), dt, cuda)
    kw = dict(a_trans=True, b_trans=False, out_uplo="L", a_view=(0, 0, 256, 640),
              b_view=(0, 0, 256, 640))
    got = hopper.tri_matmul(A, A, **kw)
    want = hopper.tri_matmul_plain(A, A, **kw)
    _close(got, want, dt)
    assert bool((torch.triu(got, 1) == 0).all())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("pair", [False, True])
def test_transpose_kernels_bitwise(cuda, pair, dt):
    X = _rand(7, (P, P), "f32", cuda)
    Y = _rand(8, (P, P), "f32", cuda)
    Rp, RIp = _rand(9, (P, P), dt, cuda), _rand(10, (P, P), dt, cuda)
    if pair:
        L, Li = X[:384, :384].contiguous(), Y[:384, :384].contiguous()
        got = hopper.transpose_pair(L, Li, Rp.clone(), RIp.clone(), dest=256)
        want = hopper.transpose_pair_plain(L, Li, Rp.clone(), RIp.clone(), dest=256)
        two = (hopper.transpose(L, out_uplo="U", out=Rp.clone(), out_off=(256, 256)),
               hopper.transpose(Li, out_uplo="U", out=RIp.clone(), out_off=(256, 256)))
        for g, w, t in zip(got, want, two):
            assert torch.equal(g, w) and torch.equal(g, t)
    else:
        kw = dict(in_view=(100, 36, 300, 500), out_uplo="L", out_dtype=DTYPES[dt])
        assert torch.equal(hopper.transpose(X, **kw), hopper.transpose_plain(X, **kw))


@pytest.mark.parametrize("dead", ["lower", "upper"])
def test_zeros_dead_lower_kernel(cuda, dead):
    p, tile = 1536, 512
    extra = ((0, 512, 512, 1024),)
    got = hopper.zeros_dead_lower(p, torch.float32, tile, extra=extra, dead=dead, device=cuda)
    want = hopper.zeros_dead_lower_plain(p, torch.float32, tile, extra=extra, dead=dead,
                                         device=cuda)
    zero = want == 0
    assert bool((got[zero] == 0).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_factor_kernels_vs_plain(cuda, monkeypatch, dt):
    n, bc = 1024, 128
    g = np.random.default_rng(11).standard_normal((n, n))
    A = torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(DTYPES[dt]).to(cuda)
    grid = Grid.square()
    cfg = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc)
    hopper.reset_counts()
    R, Ri = cholesky.factor(grid, A, cfg)
    L = n // bc
    assert hopper.counts() == {
        "tri_matmul.trmm": 3 * (L - 1), "tri_matmul.syrk": L - 1, "tri_matmul.dense": 0,
        "transpose": L, "transpose_pair": L, "zeros_dead_lower": 2,
        "qr.gram_blocked": 0, "qr.scale_gram": 0, "qr.scale_blocked": 0,
        "small.potrf": 0, "small.potrs": 0, "small.posv": 0, "small.lstsq": 0,
        "write_diag_blocks": 0, "fused_tail": 0, "small.trsm": 0, "tsqr.panel_qr": 0,
        "bt.fused_forward": 0, "bt.factor": 0, "bt.forward_solve": 0, "bt.solve_backward": 0,
        "up.sweep": 0, "sched_matmul": 0,
    }
    for name in ("tri_matmul", "transpose", "transpose_pair", "zeros_dead_lower"):
        monkeypatch.setattr(hopper, name, getattr(hopper, name + "_plain"))
    Rq, Riq = cholesky.factor(grid, A, cfg)
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    assert float(residual.rel_fro(R.double() - Rq.double(), Rq.double())) < tol
    assert float(residual.rel_fro(Ri.double() - Riq.double(), Riq.double())) < tol
    gate = {"f32": 2e-6, "bf16": 1e-2}[dt]
    assert float(residual.cholesky_residual(A.double(), R.double())) < gate
    assert float(residual.cholesky_inverse_residual(R.double(), Ri.double())) < gate


# ---- CholeskyQR2's fused tall passes (ops/qr_fused.py) ---------------------
# Tolerances: Q within one bf16 ulp per entry plus 1e-5 of the largest (both
# sides sum in f32 and round once), f32 1e-5 and f64 1e-12 of the largest
# entry; G relative Frobenius 1e-3 from bf16 input (the two grams are of two
# Qs that may differ by an ulp), 1e-5 for f32, 1e-12 for f64.

QR_SHAPES = [(2048, 512, 2), (4096, 512, 4), (8192, 1024, 8)]
G_REL = {"f64": 1e-12, "f32": 1e-5, "bf16": 1e-3}
#: the route every qr_fused launch of a dtype takes
QR_ROUTE = {"f64": "dmma", "f32": "fma", "bf16": "wgmma"}


def _tall(seed, m, n, dt, dev):
    return _rand(seed, (m, n), dt, dev) / float(np.sqrt(m))


def _rinv(seed, n, dt, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    R = torch.triu(0.1 * torch.randn((n, n), generator=g, dtype=torch.float64) + torch.eye(n))
    return R.to(DTYPES[dt]).to(dev)


def _g_rel(got, want):
    return float(residual.rel_fro(got.double() - want.double(), want.double()))


def _dead_block_triangle(n, g):
    c = n // g
    t = torch.arange(n) // c
    return t[:, None] > t[None, :]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", QR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_blocked_kernel_vs_plain(cuda, shape, dt):
    m, n, g = shape
    A = _tall(20, m, n, dt, cuda)
    hopper.reset_counts()
    got = qr_fused.gram_blocked(A, g=g)
    want = qr_fused.gram_blocked_plain(A, g=g)
    torch.cuda.synchronize()
    assert hopper.counts()["qr.gram_blocked"] == 1
    assert hopper.route_counts() == {"qr.gram_blocked": {QR_ROUTE[dt]: 1}}
    assert got.dtype == want.dtype
    assert _g_rel(got, want) <= (1e-12 if dt == "f64" else 1e-5)  # exact products, f32 sums
    assert bool((got.cpu()[_dead_block_triangle(n, g)] == 0).all())
    assert torch.equal(got, qr_fused.gram_blocked(A, g=g))  # no atomics: same bits


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", QR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scale_kernels_vs_plain(cuda, shape, dt):
    m, n, g = shape
    A, Rinv = _tall(21, m, n, dt, cuda), _rinv(22, n, dt, cuda)
    hopper.reset_counts()
    Q = qr_fused.scale_blocked(A, Rinv, g=g)
    Qg, G = qr_fused.scale_gram(A, Rinv, g=g)
    Qp, Gp = qr_fused.scale_gram_plain(A, Rinv, g=g)
    torch.cuda.synchronize()
    assert hopper.counts()["qr.scale_blocked"] == 1 and hopper.counts()["qr.scale_gram"] == 1
    assert hopper.route_counts() == {k: {QR_ROUTE[dt]: 1} for k in ("qr.scale_blocked", "qr.scale_gram")}
    assert torch.equal(Q, Qg)  # one scale kernel behind both entries
    _close(Q, Qp, dt)
    assert _g_rel(G, Gp) <= G_REL[dt]
    assert bool((G.cpu()[_dead_block_triangle(n, g)] == 0).all())


def test_qr_kernels_refuse_bad_operands(cuda):
    A = _tall(23, 1024, 512, "f32", cuda)
    with pytest.raises(TypeError):
        qr_fused.scale_blocked(A, _rinv(24, 512, "f64", cuda), g=2)
    with pytest.raises(ValueError, match="needs bm"):
        qr_fused.gram_blocked(A[:1000], g=2)
    with pytest.raises(ValueError, match="row-major"):
        qr_fused.gram_blocked(A.t().contiguous().t(), g=2)


@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_cqr2_kernels_vs_plain(cuda, monkeypatch, dt):
    m, n = 8192, 1024
    A = _tall(25, m, n, dt, cuda)
    grid = Grid.square()
    cfg = qr.CacqrConfig(regime="1d", mode="pallas", precision="highest" if dt == "f32" else None)
    hopper.reset_counts()
    Q, R = qr.factor(grid, A, cfg)
    c = hopper.counts()
    assert (c["qr.gram_blocked"], c["qr.scale_gram"], c["qr.scale_blocked"]) == (1, 1, 1)
    routes = hopper.route_counts()
    assert all(routes[k] == {QR_ROUTE[dt]: 1} for k in ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked"))
    gate = {"f64": 1e-13, "f32": 5e-5, "bf16": 5e-2}[dt]  # bench/drivers.py _tolerance
    assert float(residual.qr_orthogonality(Q)) < gate
    assert float(residual.qr_residual(A, Q, R)) < gate
    for name in ("gram_blocked", "scale_gram", "scale_blocked"):
        monkeypatch.setattr(qr_fused, name, getattr(qr_fused, name + "_plain"))
    monkeypatch.setattr(hopper, "transpose", hopper.transpose_plain)
    Qp, Rp = qr.factor(grid, A, cfg)
    tol = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}[dt]
    assert float(residual.rel_fro(Q.double() - Qp.double(), Qp.double())) < tol
    assert float(residual.rel_fro(R.double() - Rp.double(), Rp.double())) < tol


# the bf16 wgmma route: the flagship's g = 8 split at 65536 rows (11 splits
# of unequal whole k-tiles), the wide n = 4096 at g = 32 (528 tiles, one
# split) and 8320 rows (130 k-tiles over 11 splits, no multiple of 1024)
WG_QR_SHAPES = [(65536, 1024, 8), (8192, 4096, 32), (8192 + 128, 1024, 8)]


@pytest.mark.parametrize("shape", WG_QR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_qr_wgmma_vs_plain(cuda, shape):
    m, n, g = shape
    A, Rinv = _tall(27, m, n, "bf16", cuda), _rinv(28, n, "bf16", cuda)
    hopper.reset_counts()
    G = qr_fused.gram_blocked(A, g=g)
    Q = qr_fused.scale_blocked(A, Rinv, g=g)
    Qg, Gg = qr_fused.scale_gram(A, Rinv, g=g)
    torch.cuda.synchronize()
    assert hopper.route_counts() == {k: {"wgmma": 1} for k in
                                     ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked")}
    assert _g_rel(G, qr_fused.gram_blocked_plain(A, g=g)) <= 1e-5  # exact products, f32 sums
    _close(Q, qr_fused.scale_blocked_plain(A, Rinv, g=g), "bf16")
    assert torch.equal(Q, Qg)  # one scale kernel behind both entries
    assert _g_rel(Gg, qr_fused.gram_blocked_plain(Qg, g=g)) <= 1e-5  # the gram of the rounded Q
    dead = _dead_block_triangle(n, g)
    assert bool((G.cpu()[dead] == 0).all()) and bool((Gg.cpu()[dead] == 0).all())
    # no atomics, no order that varies: the same bits on every call
    assert torch.equal(G, qr_fused.gram_blocked(A, g=g))
    assert torch.equal(Q, qr_fused.scale_blocked(A, Rinv, g=g))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fp_gram_scale_ragged_splits_vs_plain(cuda, dt):
    """8320 rows are 130 k-tiles of 64: the f32 gram's 22 splits and the
    f64 gram's 11 take 5 or 6 and 11 or 12 of them (unequal splits of whole
    k-tiles), and the scale's 65 row panels do not divide among the blocks."""
    m, n, g = 8192 + 128, 1024, 8
    A, Rinv = _tall(29, m, n, dt, cuda), _rinv(30, n, dt, cuda)
    assert len({r1 - r0 for r0, r1 in qr_fused.gram_split_rows(m, qr_fused.gram_splits(m, n, g, DTYPES[dt]))}) == 2
    hopper.reset_counts()
    G = qr_fused.gram_blocked(A, g=g)
    Q = qr_fused.scale_blocked(A, Rinv, g=g)
    Qg, Gg = qr_fused.scale_gram(A, Rinv, g=g)
    torch.cuda.synchronize()
    assert hopper.route_counts() == {k: {QR_ROUTE[dt]: 1} for k in
                                     ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked")}
    assert _g_rel(G, qr_fused.gram_blocked_plain(A, g=g)) <= G_REL[dt]
    _close(Q, qr_fused.scale_blocked_plain(A, Rinv, g=g), dt)
    assert torch.equal(Q, Qg)
    assert _g_rel(Gg, qr_fused.gram_blocked_plain(Qg, g=g)) <= G_REL[dt]
    dead = _dead_block_triangle(n, g)
    assert bool((G.cpu()[dead] == 0).all()) and bool((Gg.cpu()[dead] == 0).all())
    assert torch.equal(G, qr_fused.gram_blocked(A, g=g))
    assert torch.equal(Q, qr_fused.scale_blocked(A, Rinv, g=g))


def test_cqr1_runs_the_trmm_kernel(cuda):
    A = _tall(26, 8192, 1024, "bf16", cuda)
    hopper.reset_counts()
    Q, R = qr.factor(Grid.square(), A, qr.CacqrConfig(num_iter=1, regime="1d", mode="pallas"))
    assert hopper.counts()["tri_matmul.trmm"] == 1
    assert float(residual.qr_residual(A, Q, R)) < 5e-2


# ---------------------------------------------------------------------------
# small-N batched solves (ops/batched_small.py)
# ---------------------------------------------------------------------------


def _spd_batch(seed, batch, n, dt, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn((batch, n, n), generator=g, dtype=torch.float64)
    return (X @ X.mT / n + 3 * torch.eye(n, dtype=torch.float64)).to(DTYPES[dt]).to(dev)


SMALL_SHAPES = [(3, 16, 4), (5, 37, 3), (8, 128, 8), (4, 128, 128)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_small_kernels_vs_plain(cuda, shape, dt):
    b, n, k = shape
    A = _spd_batch(30, b, n, dt, cuda)
    B = _rand(31, (b, n, k), dt, cuda)
    hopper.reset_counts()
    for uplo in ("U", "L"):
        R, info = batched_small.potrf(A, uplo=uplo)
        Rp, infop = batched_small.potrf_plain(A, uplo=uplo)
        _close(R, Rp, dt)
        assert torch.equal(info, infop) and torch.equal(R == 0, Rp == 0)
        _close(batched_small.potrs(Rp, B, uplo=uplo), batched_small.potrs_plain(Rp, B, uplo=uplo), dt)
    X, info = batched_small.posv(A, B)
    Xp, infop = batched_small.posv_plain(A, B)
    _close(X, Xp, dt)
    assert torch.equal(info, infop)
    Al, Bl = _rand(32, (b, 4 * n, n), dt, cuda), _rand(33, (b, 4 * n, k), dt, cuda)
    X, info = batched_small.lstsq(Al, Bl)
    Xp, infop = batched_small.lstsq_plain(Al, Bl)
    # lstsq: two Cholesky sweeps of the gram square the condition number
    got, want = X.double().cpu(), Xp.double().cpu()
    scale = float(want.abs().max())
    tol = 2.0**-7 * want.abs() + 1e-4 * scale if dt == "bf16" else 1e-4 * scale
    assert bool(((got - want).abs() <= tol).all())
    assert torch.equal(info, infop)
    assert hopper.counts()["small.potrf"] == 2 and hopper.counts()["small.potrs"] == 2
    assert hopper.counts()["small.posv"] == 1 and hopper.counts()["small.lstsq"] == 1


def test_small_info_matches_plain(cuda):
    n = 16
    A = _spd_batch(34, 64, n, "f32", cuda)
    for e in range(63):
        A[e, e // 4, 4 * (e % 4) + e % 3] = (float("nan"), float("inf"), -float("inf"))[e % 3]
    A[63, 5, 5] = -100.0
    for uplo in ("U", "L"):
        assert torch.equal(batched_small.potrf(A, uplo=uplo)[1],
                           batched_small.potrf_plain(A, uplo=uplo)[1])
    B = _rand(35, (64, n, 2), "f32", cuda)
    assert torch.equal(batched_small.posv(A, B)[1], batched_small.posv_plain(A, B)[1])
    Al, Bl = _rand(36, (8, 64, n), "f32", cuda), _rand(37, (8, 64, 2), "f32", cuda)
    Al[1, 0, 0], Al[3, 10, 7] = float("nan"), float("inf")
    assert torch.equal(batched_small.lstsq(Al, Bl)[1], batched_small.lstsq_plain(Al, Bl)[1])


def test_small_identity_problems_solve_exactly(cuda):
    A = torch.eye(32, device=cuda).expand(4, 32, 32)
    X, info = batched_small.posv(A, torch.zeros(4, 32, 3, device=cuda))
    assert not info.any() and not X.any()
    Al = torch.eye(96, 32, device=cuda).expand(4, 96, 32)
    X, info = batched_small.lstsq(Al, torch.zeros(4, 96, 3, device=cuda))
    assert not info.any() and not X.any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 33, 128])
@pytest.mark.parametrize("k", [1, 8, 128])
def test_lstsq_kernel_shapes(cuda, n, k, dt):
    """n off and on the 16-column panel, k from 1 to past n, m = 4n + 5 (not
    a multiple of the 32-row stage); 1e-4 of scale (the gram squares the
    condition number)."""
    m = 4 * n + 5
    A, B = _rand(70 + n, (3, m, n), dt, cuda), _rand(71 + k, (3, m, k), dt, cuda)
    hopper.reset_counts()
    X, info = batched_small.lstsq(A, B)
    Xp, infop = batched_small.lstsq_plain(A, B)
    got, want = X.double().cpu(), Xp.double().cpu()
    scale = float(want.abs().max())
    tol = 2.0**-7 * want.abs() + 1e-4 * scale if dt == "bf16" else 1e-4 * scale
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())
    assert torch.equal(info, infop) and not info.any()
    assert hopper.counts()["small.lstsq"] == 1


def test_lstsq_rank_deficient_info_matches_plain(cuda):
    """Exactly rank-deficient problems (a zero column of A, either side of a
    panel boundary and at the ends): G is singular and G2 breaks down too
    (info2 > 0 in the plain pipeline); info equals the plain version's."""
    n = 40
    A, B = _rand(72, (6, 4 * n, n), "f32", cuda), _rand(73, (6, 4 * n, 2), "f32", cuda)
    for p, col in enumerate((0, 15, 16, 39, 7)):
        A[p, :, col] = 0
    G = A.mT @ A
    R1, _ = sweeps.chol_plain(G, "U")
    G2 = sweeps.rsolve_upper_plain(R1, sweeps.fwd_solve_plain(R1, G, from_upper=True))
    assert bool((sweeps.chol_plain(G2, "U")[1][:5] > 0).all())
    X, info = batched_small.lstsq(A, B)
    Xp, infop = batched_small.lstsq_plain(A, B)
    assert torch.equal(info, infop) and not info[5] and bool((info[:5] > 0).all())
    got, want = X[5].double().cpu(), Xp[5].double().cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _same_bits(got, want):
    """Bitwise equality, NaN included: the same NaN pattern, the same bits
    everywhere else (a NaN's payload may differ between a kernel's bf16
    rounding and torch's)."""
    nan = torch.isnan(got)
    if got.dtype != want.dtype or not torch.equal(nan, torch.isnan(want)):
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    return torch.equal(got.masked_fill(nan, 0).view(view), want.masked_fill(nan, 0).view(view))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [7, 33, 128])
@pytest.mark.parametrize("k", [1, 8, 128])
def test_posv_bitwise_potrf_then_potrs(cuda, n, k, dt):
    """The fused posv (the blocked factor and solves in one block) against
    potrs(potrf(A), B) bit for bit — on bf16 storage through the f32 factor
    (posv keeps its factor in f32, X rounded once), so through potrf and
    potrs of A and B widened — and info against potrf's and the plain
    version's, with a fault in four of six problems: NaN below the
    diagonal, NaN in the upper triangle only, +inf on the last pivot, a
    negative pivot (past the first panel where n allows)."""
    A = _spd_batch(80 + n, 6, n, dt, cuda)
    B = _rand(81 + k, (6, n, k), dt, cuda)
    A[1, n // 2, n // 3] = float("nan")
    A[2, 0, n - 1] = float("nan")
    A[3, n - 1, n - 1] = float("inf")
    A[4, min(20, n - 1), min(20, n - 1)] = -1.0
    hopper.reset_counts()
    X, info = batched_small.posv(A, B)
    assert hopper.counts()["small.posv"] == 1
    Af, Bf = A.float(), B.float()
    R, info_r = batched_small.potrf(Af)
    assert _same_bits(X, batched_small.potrs(R, Bf).to(X.dtype))
    assert torch.equal(info, info_r) and torch.equal(info, batched_small.posv_plain(A, B)[1])
    assert not info[[0, 5]].any() and bool(info[1:5].all())


@pytest.mark.parametrize("b", [16, 37, 128, 138])
def test_blocktri_factor_step_is_potrf_and_trsm(cuda, b):
    """factor_step on its route (`chain_route`: 'blocked' up to b = 136,
    'sweep' at 138): with C = 0 and the identity carried, L is
    `small.potrf`'s lower factor of D bit for bit; with a carried factor
    Lc, Wt is `small.trsm`'s forward solve Lc⁻¹·Cᵀ bit for bit."""
    D, C, _, Lc, _ = _bt_operands(90 + b, 3, 2, b, 1, "f32", cuda)
    eye = torch.eye(b, device=cuda).expand(3, b, b).contiguous()
    hopper.reset_counts()
    L, Wt, info = blocktri_small.factor_step(D, torch.zeros_like(C), eye)
    for s in range(2):
        R, info_r = batched_small.potrf(D[:, s].contiguous(), uplo="L")
        assert _same_bits(L[:, s], R) and torch.equal(info[:, s], info_r)
    assert not Wt.any() and not info.any()
    _, Wt1, _ = blocktri_small.factor_step(D[:, :1], C[:, :1], Lc)
    assert _same_bits(Wt1[:, 0], batched_small.trsm(Lc, C[:, 0].mT.contiguous(), uplo="L"))
    assert hopper.route_counts()["bt.factor"] == {blocktri_small.chain_route(b): 2}


def _bt_step_c(name, code, D, C, Lc, B=None, yc=None):
    """One factor step through its C entry on route `code` (0 'sweep', 1
    'blocked'; the wrapper always takes `chain_route(b)`), uncounted:
    (L, Wt, [y,] info) as the wrapper returns them."""
    batch, seg, b, _ = D.shape
    L, Wt = torch.empty_like(D), torch.empty_like(D)
    info = torch.empty((batch, seg), dtype=torch.int32, device=D.device)
    dt = hopper._DTYPE_CODE[D.dtype]
    if name == "factor":
        rc = _build.entry("capital_bt_factor")(dt, D.data_ptr(), C.data_ptr(), Lc.data_ptr(), L.data_ptr(),
                                               Wt.data_ptr(), info.data_ptr(), batch, seg, b, code,
                                               hopper._stream())
        assert rc == 0, rc
        return L, Wt, info
    k = B.shape[-1]
    y = torch.empty_like(B)
    scratch = torch.empty((batch, b, k), dtype=torch.float32, device=D.device)
    route = "blocked" if code else "sweep"
    rc = _build.entry("capital_bt_fused_forward")(
        dt, D.data_ptr(), C.data_ptr(), B.data_ptr(), Lc.data_ptr(), yc.data_ptr(), L.data_ptr(), Wt.data_ptr(),
        y.data_ptr(), info.data_ptr(), scratch.data_ptr(), batch, seg, b, k,
        blocktri_small._stage_cols("fused_forward", b, k, 1, route), 1, code, hopper._stream())
    assert rc == 0, rc
    return L, Wt, y, info


def _bt_solve_c(name, L, Wt, B, carry, route="sweep", splits=1, kc=None):
    """A solve step ('forward_solve' or 'solve_backward') through its C
    entry on `route`, its columns split `splits` ways and staged kc at a time
    (default: `stage_cols` there), with a scratch, uncounted."""
    batch, seg, b, k = B.shape
    kc = blocktri_small._stage_cols(name, b, k, splits, route) if kc is None else kc
    out = torch.empty_like(B)
    scratch = torch.empty((batch, b, k), dtype=torch.float32, device=B.device)
    rc = _build.entry("capital_bt_" + name)(
        hopper._DTYPE_CODE[B.dtype], L.data_ptr(), Wt.data_ptr(), B.data_ptr(), carry.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), batch, seg, b, k, kc, splits, {"sweep": 0, "blocked": 1}[route], hopper._stream())
    assert rc == 0, rc
    return out


def _solve_fault(L, Wt, Y, fault):
    L, Wt, Y = L.clone(), Wt.clone(), Y.clone()
    b, k = Y.shape[-2:]
    if fault == "nan_rhs":
        Y[1, 1, 5, 0] = float("nan")
    elif fault == "-inf_rhs":
        Y[1, 1, 0, k - 1] = -float("inf")
    elif fault == "zero_diag":
        L[1, 1, b // 3, b // 3] = 0
    elif fault == "nan_diag":
        L[1, 1, 7, 7] = float("nan")
    elif fault == "nan_coupling":
        Wt[1, 1, 9, 4] = float("nan")
    return L, Wt, Y


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [37, 128])
@pytest.mark.parametrize("fault", ["none", "nan_rhs", "-inf_rhs", "zero_diag", "nan_diag", "nan_coupling"])
@pytest.mark.parametrize("name", ["forward_solve", "solve_backward"])
def test_blocktri_solve_routes_bitwise(cuda, name, fault, b, dt):
    """Each solve step on its 'blocked' route (the wrapper: 16-byte-row
    stages, register-tiled coupling products, blocked triangular solves,
    the columns split over 4 CUDA blocks a problem here) gives the bits of
    its 'sweep' route (the column sweeps, through the C entry with route
    code 0), of its unsplit launch and of a launch whose carry goes through
    the scratch, on healthy chains and with a fault in problem 1's second
    chain block; a zero diagonal takes safe_div's guarded divisor.  b = 37
    runs the padded tiles and the scalar transposed load."""
    D, C, B, Lc, yc = _bt_operands(96, 3, 4, b, 19, dt, cuda)
    L, Wt, _, _ = blocktri_small.fused_forward_step(D, C, B, Lc, yc)
    L, Wt, Y = _solve_fault(L, Wt, B, fault)
    hopper.reset_counts()
    got = getattr(blocktri_small, name + "_step")(L, Wt, Y, yc)
    assert hopper.route_counts() == {"bt." + name: {"blocked": 1}}
    splits = blocktri_small.rhs_splits(name, 3, b, 19)
    assert splits == 4
    for want in (_bt_solve_c(name, L, Wt, Y, yc), _bt_solve_c(name, L, Wt, Y, yc, "blocked"),
                 _bt_solve_c(name, L, Wt, Y, yc, "blocked", splits, 3)):
        assert _same_bits(got, want)
    bad = torch.isnan(got).flatten(1).any(1)
    assert not bad[[0, 2]].any()


@pytest.mark.parametrize("b", [16, 50, 128, 136, 166])
def test_blocktri_solve_split_and_unsplit_bitwise(cuda, b):
    """At k = 1, 3, 33, 64 and 257, f32 and bf16: each solve step's
    wrapper and the fused step's (their rules' route and column split) are
    bit for bit their unsplit launch and their 'sweep' route; b = 166 takes
    the solve steps' 'sweep' route itself (the fused step stops at 138)."""
    for dt in ("f32", "bf16"):
        for k in (1, 3, 33, 64, 257):
            D, C, B, Lc, yc = _bt_operands(97 + k, 3, 2, b, k, dt, cuda)
            if b <= 138:
                out = blocktri_small.fused_forward_step(D, C, B, Lc, yc)
                for want in (_bt_step_c("fused_forward", 0, D, C, Lc, B, yc),
                             _bt_step_c("fused_forward", 1, D, C, Lc, B, yc)):
                    assert all(torch.equal(g, w) if g.dtype == torch.int32 else _same_bits(g, w)
                               for g, w in zip(out, want))
                L, Wt = out[:2]
            else:
                L, Wt, _, _ = blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)
            for name in ("forward_solve", "solve_backward"):
                route = blocktri_small.chain_route(b, name)
                assert route == ("sweep" if b == 166 else "blocked")
                got = getattr(blocktri_small, name + "_step")(L, Wt, B, yc)
                assert _same_bits(got, _bt_solve_c(name, L, Wt, B, yc))
                assert _same_bits(got, _bt_solve_c(name, L, Wt, B, yc, route))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [37, 128])
@pytest.mark.parametrize("fault", ["none", "nan", "-inf", "indefinite", "nan_coupling"])
def test_blocktri_routes_bitwise(cuda, fault, b, dt):
    """Both factor steps on their 'blocked' route (the wrappers) and on the
    'sweep' route (the C entries with route code 0) give the same L, Wt, y
    and info bit for bit, on healthy chains and with a fault in problem 1's
    second chain block: a non-finite S takes the column sweep at once, an
    indefinite one after chol_blocked gives up (S formed again); the blocks
    after it carry the reference's NaN pattern.  b = 37 runs the padded
    tile and the scalar transposed load."""
    D, C, B, Lc, yc = _bt_operands(95, 3, 4, b, 3, dt, cuda)
    if fault == "nan":
        D[1, 1, 5, 7] = float("nan")
    elif fault == "-inf":
        D[1, 1, 0, 0] = -float("inf")
    elif fault == "indefinite":
        D[1, 1] = torch.diag(torch.tensor([1.0] * 20 + [-5.0] + [1.0] * (b - 21), device=cuda))
        C[1, 1] = 0
    elif fault == "nan_coupling":
        C[1, 1, 9, 4] = float("nan")
    D, C, B, Lc, yc = (x.contiguous() for x in (D, C, B, Lc, yc))
    hopper.reset_counts()
    fused = {"blocked": blocktri_small.fused_forward_step(D, C, B, Lc, yc),
             "sweep": _bt_step_c("fused_forward", 0, D, C, Lc, B, yc)}
    fac = {"blocked": blocktri_small.factor_step(D, C, Lc), "sweep": _bt_step_c("factor", 0, D, C, Lc)}
    for out in (fused, fac):
        for got, want in zip(out["blocked"], out["sweep"]):
            assert torch.equal(got, want) if got.dtype == torch.int32 else _same_bits(got, want)
    assert torch.equal(fused["blocked"][3], fac["blocked"][2])
    assert torch.equal(fused["blocked"][3], blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)[3])
    info = fused["blocked"][3]
    assert bool(info[1, 1]) == (fault != "none") and not info[1, 0] and not info[[0, 2]].any()
    routes = hopper.route_counts()
    assert routes["bt.fused_forward"] == routes["bt.factor"] == {"blocked": 1}


def test_small_counters_move_only_on_launch(cuda):
    A = _spd_batch(38, 4, 16, "f32", cuda)
    B = _rand(39, (4, 16, 2), "f32", cuda)
    hopper.reset_counts()
    batched_small.posv_plain(A, B)
    batched_small.potrf_plain(A)
    assert not any(hopper.counts().values())
    batched_small.posv(A.cpu(), B.cpu())
    assert not any(hopper.counts().values())
    batched_small.posv(A, B)
    assert hopper.counts()["small.posv"] == 1 and sum(hopper.counts().values()) == 1


# the blocked potrf (csrc chol_blocked): panel edges at 16 and 32, the padded tile
# (n % 4), a single panel, the largest n the tile takes
POTRF_N = [1, 7, 16, 31, 33, 64, 100, 128, 129, 240]


def potrf_faults(n, dev):
    """(problems, n, n) f32 SPD problems with one fault each: NaN / +inf /
    -inf on the diagonal, in row 0, below the diagonal in the first panel,
    across the panel edges at 16 and 32, in a later panel and in the upper triangle
    only; a negative pivot in the first panel and in a later one; and
    finite entries near 1e20 whose product overflows in the trailing update
    (deferred past its panel by the blocked factor)."""
    pos = [(5, 5), (n - 4, n - 4), (0, 9), (20, 7), (17, 14), (33, 30), (n - 2, n - 5), (7, 20), (3, n - 2)]
    A = _spd_batch(60 + n, 3 * len(pos) + 3, n, "f32", dev)
    for v, val in enumerate((float("nan"), float("inf"), -float("inf"))):
        for q, (i, j) in enumerate(pos):
            A[v * len(pos) + q, i, j] = val
    e = 3 * len(pos)
    A[e, 4, 4] = -1.0
    A[e + 1, n - 3, n - 3] = -50.0
    for i in (n - 5, n - 3):
        A[e + 2, i, 2] = A[e + 2, 2, i] = 1e20
    return A


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", POTRF_N)
def test_potrf_blocked_vs_plain(cuda, n, dt):
    A = _spd_batch(50 + n, 3, n, dt, cuda)
    for uplo in ("U", "L"):
        R, info = batched_small.potrf(A, uplo=uplo)
        Rp, infop = batched_small.potrf_plain(A, uplo=uplo)
        _close(R, Rp, dt)
        assert torch.equal(info, infop) and not info.any()
        assert torch.equal(R == 0, Rp == 0)  # the dead triangle, and only it


@pytest.mark.parametrize("n", [40, 128])
def test_potrf_blocked_info_matches_plain(cuda, n):
    A = potrf_faults(n, cuda)
    for uplo in ("U", "L"):
        info, want = batched_small.potrf(A, uplo=uplo)[1], batched_small.potrf_plain(A, uplo=uplo)[1]
        assert torch.equal(info, want), (info.tolist(), want.tolist())
    assert bool((info > 0).all())
    # the overflow is born in the trailing update of panel 0 at column 2:
    # the column sweep's info (the reference's rule) is 2 + 3
    assert int(info[-1]) == 5


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_potrf_identity_problems_exact(cuda, dt):
    for n in (16, 40, 128):
        A = torch.eye(n, dtype=DTYPES[dt], device=cuda).expand(3, n, n)
        for uplo in ("U", "L"):
            R, info = batched_small.potrf(A, uplo=uplo)
            assert torch.equal(R, A) and not info.any()


@pytest.mark.parametrize("n", [40, 128])
def test_potrf_blocked_is_the_column_sweep_bitwise(cuda, n):
    """The blocked factor applies chol_sweep's operations in chol_sweep's
    order to every entry: equal bits to fused_tail's factor, which is the
    column sweep on the symmetrised window."""
    S = torch.triu(_spd_batch(70 + n, 1, n, "f32", cuda)[0])
    S = S + torch.triu(S, 1).T  # exactly symmetric: both read the same values
    R, info = batched_small.potrf(S[None], uplo="U")
    Rt, _, tinfo = hopper.fused_tail(S.clone(), torch.zeros_like(S), torch.zeros_like(S), off=0, n=n, dest=0)
    assert torch.equal(R[0], Rt) and int(info[0]) == int(tinfo) == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 5, 40, 127, 128])
@pytest.mark.parametrize("k", [1, 8, 128])
def test_potrs_blocked_vs_plain(cuda, n, k, dt):
    """The blocked solves on the factor's live triangle: against the plain
    version for both uplo, with NaN in the dead triangle (never read), and a
    NaN in one problem's right-hand side kept to that problem."""
    A = _spd_batch(80 + n, 3, n, dt, cuda)
    B = _rand(81 + k, (3, n, k), dt, cuda)
    for uplo in ("U", "L"):
        R, _ = batched_small.potrf_plain(A, uplo=uplo)
        dead = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cuda), -1)
        dead = dead if uplo == "U" else dead.T
        Rg = torch.where(dead, torch.full_like(R, float("nan")), R)
        hopper.reset_counts()
        X = batched_small.potrs(Rg, B, uplo=uplo)
        assert hopper.counts()["small.potrs"] == 1
        _close(X, batched_small.potrs_plain(R, B, uplo=uplo), dt)
        Bn = B.clone()
        Bn[0, n // 2, 0] = float("nan")
        Xn = batched_small.potrs(Rg, Bn, uplo=uplo)
        assert bool(torch.isnan(Xn[0]).any()) and torch.equal(Xn[1:], X[1:])


def test_potrf_counter_moves_only_on_launch(cuda):
    A = _spd_batch(58, 4, 40, "f32", cuda)
    hopper.reset_counts()
    batched_small.potrf_plain(A)
    batched_small.potrf(A.cpu())
    assert not any(hopper.counts().values()) and not hopper.route_counts()
    batched_small.potrf(A, uplo="L")
    batched_small.potrf(potrf_faults(40, cuda))  # the fault path is the same launch
    assert hopper.counts()["small.potrf"] == 2 and sum(hopper.counts().values()) == 2


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_transpose_launch_path_bitwise(cuda, dt):
    """The leaf read and write-back, as cholinv calls them, through the
    trimmed launch path: bitwise the plain versions, counted once each."""
    buf = _rand(61, (1024, 1024), dt, cuda)
    hopper.reset_counts()
    for kw in (dict(in_view=(512, 512, 512, 512), out_uplo="L", out_dtype=torch.float32),
               dict(in_view=(3, 5, 200, 130), out_uplo="U"), dict()):
        assert torch.equal(hopper.transpose(buf, **kw), hopper.transpose_plain(buf, **kw))
    L = torch.tril(_rand(62, (384, 384), "f32", cuda))
    Li = torch.tril(_rand(63, (384, 384), "f32", cuda))
    outs = [f(L, Li, buf.clone(), buf.clone(), dest=384)
            for f in (hopper.transpose_pair, hopper.transpose_pair_plain)]
    assert all(torch.equal(g, w) for g, w in zip(*outs))
    out = buf.clone()
    got = hopper.transpose(L, out_uplo="U", out=out, out_off=(128, 0))
    assert got is out
    assert torch.equal(out, hopper.transpose_plain(L, out_uplo="U", out=buf.clone(), out_off=(128, 0)))
    assert hopper.counts()["transpose"] == 4 and hopper.counts()["transpose_pair"] == 1


def test_transpose_kernel_guards_raise(cuda):
    X = _rand(64, (256, 256), "f32", cuda)
    with pytest.raises(ValueError, match="row-major"):
        hopper.transpose(X.t())
    with pytest.raises(TypeError, match="bf16, f32 or f64"):
        hopper.transpose(X.half())
    with pytest.raises(TypeError, match="bf16, f32 or f64"):
        hopper.transpose(X, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="overlaps"):
        hopper.transpose(X, in_view=(0, 0, 128, 128), out=X, out_off=(64, 64))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        hopper.transpose(X, out=torch.zeros(256, 256))
    L = torch.tril(_rand(65, (64, 64), "f32", cuda))
    Rp = torch.zeros((256, 256), device=cuda)
    with pytest.raises(TypeError, match="one dtype and layout"):
        hopper.transpose_pair(L, L.double(), Rp, Rp.clone(), dest=64)
    with pytest.raises(TypeError, match="one dtype and layout"):
        hopper.transpose_pair(L, L, Rp, Rp.clone().bfloat16(), dest=64)
    with pytest.raises(ValueError, match="overlap"):
        hopper.transpose_pair(L, L, Rp, Rp, dest=64)


def test_small_wrappers_refuse(cuda):
    A64 = _spd_batch(40, 2, 16, "f64", cuda)
    with pytest.raises(TypeError):
        batched_small.posv(A64, torch.zeros(2, 16, 1, dtype=torch.float64, device=cuda))
    A = _spd_batch(41, 2, 256, "f32", cuda)
    with pytest.raises(ValueError, match="shared memory"):
        batched_small.posv(A, torch.zeros(2, 256, 256, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        batched_small.potrf(_spd_batch(42, 1, 242, "f32", cuda))


@pytest.mark.parametrize("impl", ["pallas", "pallas_split", "auto", "vmap"])
def test_small_serve_programs_launch_their_kernels(cuda, impl):
    A = _spd_batch(43, 8, 64, "f32", cuda)
    B = _rand(44, (8, 64, 4), "f32", cuda)
    hopper.reset_counts()
    X, info = api.batched("posv", "highest", impl)(A, B)
    c = hopper.counts()
    want = {"pallas": (1, 0, 0), "auto": (1, 0, 0), "pallas_split": (0, 1, 1), "vmap": (0, 0, 0)}[impl]
    assert (c["small.posv"], c["small.potrf"], c["small.potrs"]) == want
    ref = torch.linalg.solve(A.double(), B.double())
    assert float((X.double() - ref).abs().max() / ref.abs().max()) < 1e-5 and not info.any()


# ---------------------------------------------------------------------------
# the inversion slice: write_diag_blocks, fused_tail, batched trsm, the TSQR
# panel QR, and the paths that launch them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dts", [("bf16", "bf16"), ("f32", "bf16"), ("f64", "f32"), ("f32", "f64")])
@pytest.mark.parametrize("s", [37, 128])
def test_write_diag_blocks_kernel(cuda, s, dts):
    count = 5
    W = _rand(50, (count, s, s), dts[0], cuda)
    outs = []
    for fn in (hopper.write_diag_blocks, hopper.write_diag_blocks_plain):
        out = torch.full((count * s + 9, count * s + 9), float("nan"), dtype=DTYPES[dts[1]], device=cuda)
        outs.append(fn(out, W))
    torch.cuda.synchronize()
    got, want = outs[0].cpu(), outs[1].cpu()
    # bitwise: both round W to out's dtype once, NaN exactly where untouched
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])
    assert int(torch.isnan(got).sum()) == got.numel() - count * s * s


#: integer views for bitwise comparison
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def _diag_specials(dt):
    """NaN, ±inf, ±0, subnormals of W's dtype and values that turn
    subnormal, infinite or zero in a narrower out."""
    tiny = {"bf16": [2.0**-130, -(2.0**-133)], "f32": [1e-40, -3e-45, 2.0**-130],
            "f64": [1e-310, -5e-324, 1e-40, 1e-45, 1e39, -3.3961e38]}[dt]
    return [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 3.3961e38, *tiny]


def _diag_stack(seed, count, s, dt, dev):
    W = _rand(seed, (count, s, s), dt, "cpu")
    flat = W.view(-1)
    sp = torch.tensor(_diag_specials(dt), dtype=torch.float64).to(DTYPES[dt])
    idx = torch.arange(len(sp)) * (flat.numel() // len(sp)) + 1
    flat[idx] = sp
    flat[-len(sp):] = sp
    return W.to(dev)


def _write_diag_c(out, W, route):
    """One launch through the C entry on `route` (uncounted)."""
    rc = _build.entry("capital_write_diag")(
        hopper._DTYPE_CODE[W.dtype], hopper._DTYPE_CODE[out.dtype], W.data_ptr(), out.data_ptr(),
        out.stride(0), W.shape[0], W.shape[1], hopper.WRITE_DIAG_ROUTES[route], hopper._stream())
    assert rc == 0, rc
    return out


def _same_bits(got, want):
    return torch.equal(got.view(_BITS[got.dtype]), want.view(_BITS[want.dtype]))


@pytest.mark.parametrize("s", [24, 64, 100])
@pytest.mark.parametrize("dt_out", list(DTYPES))
@pytest.mark.parametrize("dt_w", list(DTYPES))
def test_write_diag_routes_bitwise(cuda, dt_w, dt_out, s):
    # both routes against each other and the plain version, bit for bit,
    # on NaN-filled outs: specials in W, nothing outside the blocks written
    count = 3
    W = _diag_stack(70 + s, count, s, dt_w, cuda)
    fill = lambda: torch.full((count * s + 16, count * s + 16), float("nan"), dtype=DTYPES[dt_out], device=cuda)
    route = hopper.write_diag_route(fill(), W)
    assert route == ("elem" if s % (16 // W.element_size()) else "vec")
    hopper.reset_counts()
    got = hopper.write_diag_blocks(fill(), W)
    assert hopper.route_counts() == {"write_diag_blocks": {route: 1}}
    elem = _write_diag_c(fill(), W, "elem")
    plain = hopper.write_diag_blocks_plain(fill(), W)
    assert hopper.counts()["write_diag_blocks"] == 1
    torch.cuda.synchronize()
    assert _same_bits(got, elem)  # the replaced kernel's bits, NaN payloads too
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(got), nan)
    assert _same_bits(got.masked_fill(nan, 0), plain.masked_fill(nan, 0))
    blocks = got.as_strided((count, s, s), (s * got.stride(0) + s, got.stride(0), 1))
    assert int(torch.isnan(got).sum()) - int(torch.isnan(blocks).sum()) == got.numel() - count * s * s


@pytest.mark.parametrize("col", [1, 4, 8])
def test_write_diag_offset_out(cuda, col):
    # an out view whose origin is 2 or 8 bytes past a 16-byte boundary
    # takes 'elem', 16 bytes past it 'vec'; both write the plain version's bits
    count, s = 4, 64
    p = count * s
    W = _diag_stack(80, count, s, "bf16", cuda)
    got, want = (torch.full((p, p + 16), float("nan"), dtype=torch.bfloat16, device=cuda) for _ in range(2))
    hopper.reset_counts()
    hopper.write_diag_blocks(got[:, col:col + p], W)
    assert hopper.route_counts() == {"write_diag_blocks": {"vec" if col == 8 else "elem": 1}}
    hopper.write_diag_blocks_plain(want[:, col:col + p], W)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert _same_bits(got.masked_fill(nan, 0), want.masked_fill(nan, 0))


def test_write_diag_flagship_route_tally(cuda):
    # the rectri flagship's write-back: 96 x 512² bf16 into a NaN-filled
    # 49152² buffer, one 'vec' launch; the 'elem' route through the C
    # entry on the same operands counts nothing and writes the same bits
    count, s = 96, 512
    p = count * s
    W = _rand(81, (count, s, s), "bf16", cuda)
    out = torch.full((p, p), float("nan"), dtype=torch.bfloat16, device=cuda)
    hopper.reset_counts()
    hopper.write_diag_blocks(out, W)
    assert hopper.counts()["write_diag_blocks"] == 1
    assert hopper.route_counts() == {"write_diag_blocks": {"vec": 1}}
    blocks = out.as_strided((count, s, s), (s * p + s, p, 1))
    torch.cuda.synchronize()
    assert _same_bits(blocks, W)
    assert int(torch.isnan(out).sum()) == p * p - count * s * s
    blocks.fill_(float("nan"))
    _write_diag_c(out, W, "elem")
    assert hopper.counts()["write_diag_blocks"] == 1
    assert hopper.route_counts() == {"write_diag_blocks": {"vec": 1}}
    torch.cuda.synchronize()
    assert _same_bits(blocks, W)
    assert int(torch.isnan(out).sum()) == p * p - count * s * s


def test_write_diag_vec_entry_refuses_misaligned(cuda):
    # the C entry answers -1 for a 'vec' launch it cannot make aligned
    W = _rand(82, (2, 100, 100), "bf16", cuda)
    out = torch.zeros((200, 200), dtype=torch.bfloat16, device=cuda)
    rc = _build.entry("capital_write_diag")(0, 0, W.data_ptr(), out.data_ptr(), 200, 2, 100,
                                            hopper.WRITE_DIAG_ROUTES["vec"], hopper._stream())
    assert rc == -1


def test_write_diag_blocks_refuses(cuda):
    W = _rand(51, (4, 16, 16), "f32", cuda)
    with pytest.raises(ValueError, match="do not fit"):
        hopper.write_diag_blocks(torch.zeros((60, 60), device=cuda), W)
    with pytest.raises(ValueError, match="square"):
        hopper.write_diag_blocks(torch.zeros((64, 80), device=cuda), W)


def _tail_operand(seed, n, P, off, dt, dev):
    g = np.random.default_rng(seed).standard_normal((P, P))
    A = g @ g.T / P + 3 * np.eye(P)
    A[off:off + n, off:off + n][np.tril_indices(n, -1)] = np.nan  # never read
    return torch.from_numpy(A).to(DTYPES[dt]).to(dev)


def _tail_pair(buf, n, off, dest, P, dt, dev, **kw):
    """fused_tail and its plain version into NaN-filled buffers."""
    outs = []
    for fn in (hopper.fused_tail, hopper.fused_tail_plain):
        Rp = torch.full((P, P), float("nan"), dtype=DTYPES[dt], device=dev)
        RIp = torch.full((P, P), float("nan"), dtype=DTYPES[dt], device=dev)
        outs.append(fn(buf, Rp, RIp, off=off, n=n, dest=dest, **(kw if fn is hopper.fused_tail else {})))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 128, 160])
def test_fused_tail_kernel_vs_plain(cuda, n, dt):
    P, off, dest = 4 * n, n, 2 * n
    buf = _tail_operand(52, n, P, off, dt, cuda)
    hopper.reset_counts()
    outs = []
    for fn in (hopper.fused_tail, hopper.fused_tail_plain):
        Rp = torch.full((P, P), float("nan"), dtype=DTYPES[dt], device=cuda)
        RIp = torch.full((P, P), float("nan"), dtype=DTYPES[dt], device=cuda)
        outs.append(fn(buf, Rp, RIp, off=off, n=n, dest=dest))
    torch.cuda.synchronize()
    (R, RI, info), (Rq, RIq, infoq) = outs
    assert int(info) == int(infoq) == 0
    w = (slice(dest, dest + n), slice(dest, dest + n))
    _close(R[w], Rq[w], dt)
    _close(RI[w], RIq[w], dt)
    assert bool((torch.tril(R[w], -1) == 0).all()) and bool((torch.tril(RI[w], -1) == 0).all())
    for X in (R, RI):  # nothing outside the window is written
        outside = torch.isnan(X).clone()
        outside[w] = True
        assert bool(outside.all())
    assert hopper.route_counts()["fused_tail"] == {"block": 1}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [40, 128, 168])
def test_fused_tail_block_route_is_the_column_sweep_bitwise(cuda, n, dt):
    """The block route's chol_blocked and blocked inverse apply the column
    sweeps' operations in their order: equal bits to the kernel's own
    column-sweep path (`_sweep`)."""
    buf = _tail_operand(58 + n, n, 2 * n, 0, dt, cuda)
    R, RI, i = hopper.fused_tail(buf, torch.zeros_like(buf), torch.zeros_like(buf), off=0, n=n, dest=0)
    Rs, RIs, i_s = hopper.fused_tail(buf, torch.zeros_like(buf), torch.zeros_like(buf), off=0, n=n, dest=0,
                                     _sweep=True)
    assert int(i) == int(i_s) == 0
    assert torch.equal(R, Rs) and torch.equal(RI, RIs)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [256, 384, 512])
def test_fused_tail_cluster_vs_plain(cuda, n, dt):
    """The cluster route against the plain version (a window inside a
    larger NaN-filled buffer: nothing outside it written) and bit for bit
    against its own column-sweep path."""
    P, off, dest = 2 * n, n, 0
    buf = _tail_operand(63 + n, n, P, off, dt, cuda)
    hopper.reset_counts()
    (R, RI, info), (Rq, RIq, infoq) = _tail_pair(buf, n, off, dest, P, dt, cuda)
    assert hopper.route_counts()["fused_tail"] == {"cluster": 1}
    assert int(info) == int(infoq) == 0
    w = (slice(dest, dest + n), slice(dest, dest + n))
    _close(R[w], Rq[w], dt)
    _close(RI[w], RIq[w], dt)
    assert bool((torch.tril(R[w], -1) == 0).all()) and bool((torch.tril(RI[w], -1) == 0).all())
    for X in (R, RI):
        outside = torch.isnan(X).clone()
        outside[w] = True
        assert bool(outside.all())
    (Rs, RIs, i_s), _ = _tail_pair(buf, n, off, dest, P, dt, cuda, _sweep=True)
    assert int(i_s) == 0 and torch.equal(R[w], Rs[w]) and torch.equal(RI[w], RIs[w])


def _tail_cluster_c(buf, n, blocks):
    """One cluster-route launch on `blocks` blocks through the kernel's C
    entry (the wrapper always takes hopper.TAIL_CLUSTER_BLOCKS[n]): its
    return code and (R, R⁻¹, info)."""
    Rp, RIp = torch.zeros_like(buf), torch.zeros_like(buf)
    info = torch.empty((), dtype=torch.int32, device=buf.device)
    scratch = torch.empty(2 * n * n, dtype=torch.float32, device=buf.device)
    rc = _build.entry("capital_fused_tail")(
        hopper._DTYPE_CODE[buf.dtype], buf.data_ptr(), buf.stride(0), Rp.data_ptr(), RIp.data_ptr(),
        Rp.stride(0), info.data_ptr(), scratch.data_ptr(), n, blocks, 0, hopper._stream())
    return rc, (Rp, RIp, info)


def test_fused_tail_cluster_sizes_agree(cuda):
    """Every cluster size the kernel takes for a window computes the same
    bits; the sizes whose rows do not fit a block are refused."""
    for n in hopper.TAIL_CLUSTER_WINDOWS:
        buf = _tail_operand(70 + n, n, n, 0, "f32", cuda)
        outs = {}
        for b in (2, 4, 8):
            rc, out = _tail_cluster_c(buf, n, b)
            assert rc in (0, -1), (n, b, rc)
            if rc == 0:
                outs[b] = out
        assert sorted(outs) == {256: [2, 4, 8], 384: [4, 8], 512: [8]}[n]
        ref = outs[hopper.TAIL_CLUSTER_BLOCKS[n]]
        for b, (R, RI, i) in outs.items():
            assert int(i) == 0 and torch.equal(R, ref[0]) and torch.equal(RI, ref[1]), (n, b)
    buf = _tail_operand(70, 256, 256, 0, "f32", cuda)
    assert _tail_cluster_c(buf, 256, 3)[0] == -1 and _tail_cluster_c(buf, 256, 16)[0] == -1


@pytest.mark.parametrize("n", [256, 384, 512])
def test_fused_tail_cluster_info_matches_plain(cuda, n):
    """Faults send the window through the column sweep in block 0 (device
    memory scratch): a bad pivot in the first and in the last block's
    panels, NaN in row 0, +inf and -inf in the upper half past the first
    panel; info equal to the plain version's, nothing outside the window
    written."""
    base = _tail_operand(75 + n, n, n, 0, "f32", cuda)
    for (r, c, v) in ((5, 5, -1.0), (n - 3, n - 3, -1.0), (0, 7, float("nan")), (3, 9, float("inf")),
                      (40, n - 20, -float("inf"))):
        buf = base.clone()
        buf[r, c] = v
        (_, _, got), (_, _, want) = _tail_pair(buf, n, 0, 0, n, "f32", cuda)
        assert int(got) == int(want) and int(got) > 0, (r, c, int(got), int(want))


def test_fused_tail_info_matches_plain(cuda):
    # a NaN / +inf / -inf at every position of the upper half of a 16 x 16
    # window (the lower half is never read), and a bad pivot
    n, P, off = 16, 64, 16
    base = _tail_operand(53, n, P, off, "f32", cuda)
    cases = [(r, c) for r in range(n) for c in range(r, n)]
    for e, (r, c) in enumerate(cases):
        buf = base.clone()
        buf[off + r, off + c] = (float("nan"), float("inf"), -float("inf"))[e % 3]
        got = hopper.fused_tail(buf, torch.zeros_like(buf), torch.zeros_like(buf), off=off, n=n, dest=0)[2]
        want = hopper.fused_tail_plain(buf, torch.zeros_like(buf), torch.zeros_like(buf), off=off, n=n,
                                       dest=0)[2]
        assert int(got) == int(want) and int(got) > 0, (r, c, int(got), int(want))
    buf = base.clone()
    buf[off + 6, off + 6] = -100.0
    assert int(hopper.fused_tail(buf, torch.zeros_like(buf), torch.zeros_like(buf), off=off, n=n,
                                 dest=0)[2]) == 7


def test_fused_tail_refuses(cuda):
    buf = _tail_operand(54, 128, 512, 0, "f32", cuda)
    z = torch.zeros_like(buf)
    with pytest.raises(ValueError, match="alignment"):
        hopper.fused_tail(buf, z, z.clone(), off=64, n=128, dest=0)
    big = _tail_operand(54, 640, 640, 0, "f32", cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hopper.fused_tail(big, torch.zeros_like(big), torch.zeros_like(big), off=0, n=640, dest=0)
    with pytest.raises(TypeError):
        hopper.fused_tail(buf.double(), z.double(), z.double(), off=0, n=128, dest=0)


@pytest.mark.parametrize("shape", [(3, 16, 4), (5, 37, 3), (8, 128, 8), (4, 128, 128), (2, 128, 324),
                                   (2, 160, 200)])
def test_small_trsm_kernel_vs_plain(cuda, shape):
    b, n, k = shape
    T = _rand(55, (b, n, n), "f32", cuda) / float(np.sqrt(n)) + 3 * torch.eye(n, device=cuda)
    B = _rand(56, (b, n, k), "f32", cuda)
    hopper.reset_counts()
    for uplo in ("U", "L"):
        for trans in (False, True):
            X = batched_small.trsm(T, B, uplo=uplo, trans=trans)
            _close(X, batched_small.trsm_plain(T, B, uplo=uplo, trans=trans), "f32")
            op = torch.triu(T) if uplo == "U" else torch.tril(T)
            op = op.mT if trans else op
            assert float((op.double() @ X.double() - B.double()).abs().max()) < 1e-4
    assert hopper.counts()["small.trsm"] == 4


@pytest.mark.parametrize("uplo", ["U", "L"])
@pytest.mark.parametrize("trans", [False, True])
def test_small_trsm_bf16_and_dead_triangle(cuda, uplo, trans):
    """bf16 storage (widened on load, rounded once) against the plain
    version, and a NaN-filled dead triangle that no solve uses."""
    T = _rand(57, (4, 128, 128), "f32", cuda) / float(np.sqrt(128)) + 3 * torch.eye(128, device=cuda)
    dead = torch.ones(128, 128, dtype=torch.bool, device=cuda)
    T[:, dead.tril(-1) if uplo == "U" else dead.triu(1)] = float("nan")
    B = _rand(58, (4, 128, 8), "f32", cuda)
    for dt in ("f32", "bf16"):
        Td, Bd = T.to(DTYPES[dt]), B.to(DTYPES[dt])
        X = batched_small.trsm(Td, Bd, uplo=uplo, trans=trans)
        assert X.dtype == DTYPES[dt] and bool(torch.isfinite(X).all())
        _close(X, batched_small.trsm_plain(Td, Bd, uplo=uplo, trans=trans), dt)


def _panels(seed, shape, dev, dt="f32"):
    P = _rand(seed, shape, "f32", dev)
    P[0, :, 3] = 0  # a zero column: the identity reflector
    P[1] = 0        # a zero panel (tsqr's padding)
    if shape[0] > 2 and shape[2] > tsqr.PANEL_NB:  # zero columns either side of a block boundary
        P[2, :, tsqr.PANEL_NB - 1] = 0
        P[2, :, tsqr.PANEL_NB] = 0
    return P.to(DTYPES[dt])


def _panel_check(P, dt):
    Q, R = tsqr.panel_qr(P)
    Qq, Rq = tsqr.panel_qr_plain(P)
    _close(Q, Qq, dt)
    _close(R, Rq, dt)
    assert bool((torch.tril(R, -1) == 0).all()) and not bool(R[1].any())
    if dt == "f32":
        assert float((Q.double() @ R.double() - P.double()).abs().max()) < 1e-4


# leaf panels at the widths tsqr cuts, widths off the 16-column block (17,
# 40, 100), square panels (p = n) and p past 256 rows
@pytest.mark.parametrize("shape", [(4, 256, 128), (3, 40, 17), (5, 128, 64), (3, 80, 40), (3, 200, 100),
                                   (3, 17, 17), (3, 100, 100), (3, 128, 128), (3, 300, 33)])
def test_panel_qr_kernel_vs_plain(cuda, shape):
    _panel_check(_panels(57, shape, cuda), "f32")


@pytest.mark.parametrize("shape", [(4, 256, 128), (3, 80, 40), (3, 17, 17)])
def test_panel_qr_bf16_vs_plain(cuda, shape):
    _panel_check(_panels(59, shape, cuda, "bf16"), "bf16")


@pytest.mark.parametrize("n", [128, 40])
def test_panel_qr_reduction_panels(cuda, n):
    """tsqr's reduction shape: two stacked upper triangles, (2n, n)."""
    _, R = tsqr.panel_qr_plain(_panels(60, (8, 3 * n, n), cuda))
    S = torch.cat([R[0::2], R[1::2]], dim=1)  # the zero panel stacks on a live one
    S[1] = 0
    _panel_check(S, "f32")


def test_tsqr_launches_the_panel_kernel(cuda):
    m, n = 8192, 64
    A = _rand(58, (m, n), "f32", cuda)
    leaves = tsqr.resolve_leaves(m, n)
    hopper.reset_counts()
    Q, R = tsqr.tsqr(A)
    assert hopper.counts()["tsqr.panel_qr"] == leaves.bit_length()
    assert sum(hopper.counts().values()) == leaves.bit_length()
    assert float(tsqr.ortho_gate(Q)) < 5e-5 and float(residual.qr_residual(A, Q, R)) < 5e-5
    hopper.reset_counts()
    tsqr.tsqr(A.double())  # f64 takes the library route
    assert not any(hopper.counts().values())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rectri_kernels_vs_plain(cuda, monkeypatch, dt):
    n, bc = 1536, 256  # 6 blocks: a base-only prefix and uneven merges
    g = np.random.default_rng(59).standard_normal((n, n))
    L = torch.from_numpy(np.tril(g, -1) / np.sqrt(n) + 3 * np.eye(n)).to(DTYPES[dt]).to(cuda)
    grid = Grid.square()
    cfg = inverse.RectriConfig(base_case_dim=bc, mode="pallas")
    hopper.reset_counts()
    Li = inverse.rectri(grid, L, "L", cfg)
    c = hopper.counts()
    assert (c["zeros_dead_lower"], c["write_diag_blocks"], c["tri_matmul.trmm"]) == (1, 1, 10)
    assert sum(c.values()) == 12
    gate = {"f32": 5e-5, "bf16": 5e-2}[dt]
    assert float(residual.inverse_residual(L, Li)) < gate
    for name in ("tri_matmul", "zeros_dead_lower", "write_diag_blocks"):
        monkeypatch.setattr(hopper, name, getattr(hopper, name + "_plain"))
    Lq = inverse.rectri(grid, L, "L", cfg)
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    assert float(residual.rel_fro(Li.double() - Lq.double(), Lq.double())) < tol


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bc,depth,route", [(128, 2, "cluster"), (64, 1, "block")])
def test_fused_tail_factor_on_the_card(cuda, dt, bc, depth, route):
    # bc << depth: windows of 512 on the cluster route, of 128 on the block route
    n = 1024
    g = np.random.default_rng(60).standard_normal((n, n))
    A = torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(DTYPES[dt]).to(cuda)
    grid = Grid.square()
    cfg = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, tail_fuse_depth=depth)
    hopper.reset_counts()
    R, Ri = cholesky.factor(grid, A, cfg)
    L = n // (bc << depth)
    c = hopper.counts()
    assert (c["fused_tail"], c["transpose"], c["transpose_pair"]) == (L, 0, 0)
    assert hopper.route_counts()["fused_tail"] == {route: L}
    assert (c["tri_matmul.trmm"], c["tri_matmul.syrk"]) == (3 * (L - 1), L - 1)
    R0, Ri0 = cholesky.factor(grid, A, cholesky.CholinvConfig(mode="pallas", base_case_dim=bc))
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    assert float(residual.rel_fro(R.double() - R0.double(), R0.double())) < tol
    assert float(residual.rel_fro(Ri.double() - Ri0.double(), Ri0.double())) < tol


def test_inversion_counters_move_only_on_launch(cuda):
    W = _rand(61, (2, 16, 16), "f32", cuda)
    out = torch.zeros((32, 32), device=cuda)
    hopper.reset_counts()
    hopper.write_diag_blocks_plain(out, W)
    hopper.write_diag_blocks(out.cpu(), W.cpu())
    tsqr.panel_qr_plain(_panels(62, (2, 32, 8), cuda))
    batched_small.trsm_plain(W, W)
    assert not any(hopper.counts().values())
    hopper.write_diag_blocks(out, W)
    batched_small.trsm(W, W)
    tsqr.panel_qr(_panels(62, (2, 32, 8), cuda))
    c = hopper.counts()
    assert (c["write_diag_blocks"], c["small.trsm"], c["tsqr.panel_qr"]) == (1, 1, 1)
    assert sum(c.values()) == 3


# ---------------------------------------------------------------------------
# the block-tridiagonal slice: the four scan-step kernels and the chain paths
# that launch them
# ---------------------------------------------------------------------------

BT_STEPS = ("fused_forward_step", "factor_step", "forward_solve_step", "solve_backward_step")
#: (batch, seg, b, k): the flagship block with one and 64 right-hand sides,
#: the Spike widths k + 2b (257 streams through the 32-column stage), and b 16
BT_SHAPES = [(8, 8, 128, 1), (8, 8, 128, 64), (2, 8, 128, 257), (4, 7, 16, 34), (3, 5, 37, 3)]


def _bt_operands(seed, batch, seg, b, k, dt, dev):
    D = _spd_batch(seed, batch * seg, b, dt, dev).reshape(batch, seg, b, b)
    C = (0.3 / np.sqrt(b) * _rand(seed + 1, (batch, seg, b, b), "f32", dev)).to(DTYPES[dt])
    B = _rand(seed + 2, (batch, seg, b, k), dt, dev)
    Lc = (torch.tril(0.2 * _rand(seed + 3, (batch, b, b), "f32", dev), -1)
          + 2 * torch.eye(b, device=dev)).to(DTYPES[dt])
    yc = _rand(seed + 4, (batch, b, k), dt, dev)
    return D, C, B, Lc, yc


def _bt_args(name, D, C, B, Lc, yc, L, Wt):
    return {"fused_forward_step": (D, C, B, Lc, yc), "factor_step": (D, C, Lc),
            "forward_solve_step": (L, Wt, B, yc), "solve_backward_step": (L, Wt, B, yc)}[name]


def _bt_close(got, want, dt):
    got, want = got.double().cpu(), want.double().cpu()
    assert bool(torch.isfinite(got).all())
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", BT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_blocktri_kernels_vs_plain(cuda, shape, dt):
    D, C, B, Lc, yc = _bt_operands(50, *shape, dt, cuda)
    L, Wt, _, _ = blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)
    hopper.reset_counts()
    for name in BT_STEPS:
        args = _bt_args(name, D, C, B, Lc, yc, L, Wt)
        got = getattr(blocktri_small, name)(*args)
        want = getattr(blocktri_small, name + "_plain")(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            if w.dtype == torch.int32:
                assert torch.equal(g, w) and not g.any()
            else:
                _bt_close(g, w, dt)
    c = hopper.counts()
    assert {k: c[k] for k in c if k.startswith("bt.")} == {
        "bt.fused_forward": 1, "bt.factor": 1, "bt.forward_solve": 1, "bt.solve_backward": 1}


@pytest.mark.parametrize("fault", ["nan", "-inf", "indefinite", "nan_coupling"])
def test_blocktri_info_matches_plain(cuda, fault):
    D, C, B, Lc, yc = _bt_operands(51, 8, 8, 128, 2, "f32", cuda)
    Lc = torch.eye(128, device=cuda).expand(8, 128, 128).contiguous()
    if fault == "nan":
        D[3, 2, 5, 7] = float("nan")
    elif fault == "-inf":
        D[3, 2, 0, 0] = -float("inf")
    elif fault == "indefinite":
        D[3, 2] = torch.diag(torch.tensor([1.0] * 40 + [-5.0] + [1.0] * 87, device=cuda))
        C[3, 2] = 0
    else:
        C[3, 2, 9, 4] = float("nan")
    _, _, _, info = blocktri_small.fused_forward_step(D, C, B, Lc, yc)
    _, _, _, infop = blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)
    assert torch.equal(info, infop)
    assert info[3].any() and not info[3, :2].any() and not info[[0, 1, 2, 4, 5, 6, 7]].any()
    if fault == "indefinite":
        assert int(info[3, 2]) == 41
    assert torch.equal(blocktri_small.factor_step(D, C, Lc)[2], info)


def test_blocktri_identity_chain_is_exact(cuda):
    b, seg = 128, 8
    eye = torch.eye(b, device=cuda).expand(2, seg, b, b).contiguous()
    zero = torch.zeros_like(eye)
    B = torch.zeros(2, seg, b, 3, device=cuda)
    L, Wt, y, info = blocktri_small.fused_forward_step(eye, zero, B, eye[:, 0], B[:, 0])
    assert torch.equal(L, eye) and not Wt.any() and not y.any() and not info.any()
    assert not blocktri_small.solve_backward_step(L, Wt, B, B[:, 0]).any()
    # identity blocks solve exactly on the solve steps' blocked route too
    R = torch.randn(2, seg, b, 3, generator=torch.Generator(device="cpu").manual_seed(0)).to(cuda)
    assert torch.equal(blocktri_small.forward_solve_step(L, Wt, R, B[:, 0]), R)
    assert torch.equal(blocktri_small.solve_backward_step(L, Wt, R, B[:, 0]), R)


def test_blocktri_counters_move_only_on_launch(cuda):
    D, C, B, Lc, yc = _bt_operands(52, 2, 4, 16, 2, "f32", cuda)
    hopper.reset_counts()
    blocktri_small.fused_forward_step_plain(D, C, B, Lc, yc)
    blocktri_small.factor_step(D.cpu(), C.cpu(), Lc.cpu())
    assert not any(hopper.counts().values())
    blocktri_small.factor_step(D, C, Lc)
    assert hopper.counts()["bt.factor"] == 1 and sum(hopper.counts().values()) == 1


def test_blocktri_wrappers_refuse(cuda):
    D, C, B, Lc, yc = _bt_operands(53, 1, 2, 16, 1, "f32", cuda)
    with pytest.raises(TypeError):
        blocktri_small.factor_step(D.double(), C.double(), Lc.double())
    Db = _spd_batch(54, 1, 140, "f32", cuda).reshape(1, 1, 140, 140)
    with pytest.raises(ValueError, match="shared memory"):
        blocktri_small.factor_step(Db, Db, Db[:, 0])


def _bt_chain(seed, batch, nblocks, b, k, dev):
    D, C, B, _, _ = _bt_operands(seed, batch, nblocks, b, k, "f32", dev)
    C[:, 0] = 0
    return D, C, B


def _chain_residual(D, C, B, X):
    """‖A·X − B‖/‖B‖ blockwise in f64, worst over the batch."""
    D, C, B, X = (t.double() for t in (D, C, B, X))
    R = D @ X - B
    R[:, 1:] += C[:, 1:] @ X[:, :-1]
    R[:, :-1] += C[:, 1:].mT @ X[:, 1:]
    return float((R.flatten(1).norm(dim=1) / B.flatten(1).norm(dim=1)).max())


@pytest.mark.parametrize("impl,want", [
    ("pallas", {"bt.fused_forward": 8, "bt.solve_backward": 8}),
    ("auto", {"bt.fused_forward": 2, "bt.solve_backward": 2}),
    ("xla", {}),
])
def test_blocktri_posv_launches_per_plan(cuda, impl, want):
    D, C, B = _bt_chain(55, 2, 64, 16, 2, cuda)
    hopper.reset_counts()
    X, info = blocktri.posv(D, C, B, impl=impl)
    c = hopper.counts()
    assert c == {**dict.fromkeys(c, 0), **want}
    assert not info.any() and _chain_residual(D, C, B, X) < 5e-5


def test_blocktri_factor_solve_extend_launch_per_plan(cuda):
    D, C, B = _bt_chain(56, 2, 64, 16, 2, cuda)
    hopper.reset_counts()
    L, Wt, info = blocktri.factor(D, C)
    X = blocktri.solve(L, Wt, B)
    assert hopper.counts()["bt.factor"] == 8 and hopper.counts()["bt.forward_solve"] == 8
    assert hopper.counts()["bt.solve_backward"] == 8
    assert not info.any() and _chain_residual(D, C, B, X) < 5e-5
    L1, Wt1, _ = blocktri.factor(D[:, :32], C[:, :32])
    hopper.reset_counts()
    L2, Wt2, _ = blocktri.extend(D[:, 32:], C[:, 32:], L1[:, -1])
    assert hopper.counts()["bt.factor"] == 4 and sum(hopper.counts().values()) == 4
    assert torch.equal(torch.cat([L1, L2], 1), L) and torch.equal(torch.cat([Wt1, Wt2], 1), Wt)


def test_arrowhead_posv_on_the_card(cuda):
    D, C, B = _bt_chain(57, 2, 16, 16, 1, cuda)
    g = torch.Generator(device="cpu").manual_seed(58)
    F = (0.3 / 16 * torch.randn((2, 16, 4, 16), generator=g)).to(cuda)
    S0 = torch.randn((2, 4, 4), generator=g)
    S = (S0 @ S0.mT / 4 + 5 * torch.eye(4)).to(cuda)
    Bs = torch.randn((2, 4, 1), generator=g).to(cuda)
    X, Xs, info = arrowhead.posv(D, C, F, S, B, Bs, impl="pallas")
    Xq, Xsq, infoq = arrowhead.posv(D, C, F, S, B, Bs, impl="xla")
    assert not info.any() and not infoq.any()
    assert float((X - Xq).abs().max() / Xq.abs().max()) < 1e-4
    assert float((Xs - Xsq).abs().max() / Xsq.abs().max()) < 1e-4


# ---- the rank-k update sweep and refinement --------------------------------


def _up_operands(seed, batch, n, k, dt, down, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = torch.randn((batch, n, n), generator=g, dtype=torch.float64)
    R = torch.linalg.cholesky(G @ G.mT / n + 3 * torch.eye(n, dtype=torch.float64)).mT
    V = torch.randn((batch, n, k), generator=g, dtype=torch.float64) * ((0.1 / n**0.5) if down else 0.3)
    return R.to(DTYPES[dt]).contiguous().to(dev), V.to(DTYPES[dt]).to(dev)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("shape", [(8, 128, 1), (8, 128, 8), (8, 128, 64), (1024, 128, 8), (3, 37, 5)])
def test_update_sweep_kernel_vs_plain(cuda, shape, sign, dt):
    """The kernel repeats the plain version's IEEE-rounded arithmetic, so
    the two agree bitwise."""
    R, V = _up_operands(60, *shape, dt, sign < 0, cuda)
    Rk, ik = update_small.sweep(R, V, sign)
    Rp, ip = update_small.sweep_plain(R, V, sign)
    assert torch.equal(ik, ip) and not ik.any()
    assert torch.equal(Rk, Rp)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))


@pytest.mark.parametrize("case", ["nan_diag", "inf_diag", "-inf_diag", "nan_lower", "inf_lower",
                                  "nan_upper", "nan_V", "-inf_V", "infeasible"])
def test_update_sweep_faults_match_plain(cuda, case):
    sign = -1.0 if case in ("infeasible", "-inf_V") else 1.0
    R, V = _up_operands(61, 8, 128, 8, "f32", sign < 0, cuda)
    where, idx, val = {"nan_diag": ("R", (40, 40), float("nan")), "inf_diag": ("R", (7, 7), float("inf")),
                       "-inf_diag": ("R", (90, 90), float("-inf")), "nan_lower": ("R", (100, 3), float("nan")),
                       "inf_lower": ("R", (127, 64), float("inf")), "nan_upper": ("R", (3, 100), float("nan")),
                       "nan_V": ("V", (55, 2), float("nan")), "-inf_V": ("V", (0, 7), float("-inf")),
                       "infeasible": ("V", None, None)}[case]
    if idx is None:
        V[3] *= 40.0
    else:
        (R if where == "R" else V)[(3, *idx)] = val
    Rk, ik = update_small.sweep(R, V, sign)
    Rp, ip = update_small.sweep_plain(R, V, sign)
    assert torch.equal(ik, ip) and int(ik[3]) != 0 and not ik[[0, 1, 2, 4, 5, 6, 7]].any()
    assert torch.equal(Rk.isnan(), Rp.isnan()) and torch.equal(Rk.isinf(), Rp.isinf())
    fin = torch.isfinite(Rp)
    assert torch.equal(Rk[fin], Rp[fin])


UP_GRID_N = (1, 31, 32, 33, 127, 128, 238)
UP_GRID_K = (0, 1, 8, 64, 100)


def _sweep_c(R, V, sign, route):
    """One sweep through the C entry on `route` (uncounted; the wrapper
    takes `sweep_route`)."""
    out, info = torch.empty_like(R), torch.empty(R.shape[0], dtype=torch.int32, device=R.device)
    rc = update_small._sweep_launch(R, V, out, info, sign, route, update_small.problems_per_block(R.shape[0]))
    assert rc == 0
    return out, info


@pytest.mark.parametrize("k", UP_GRID_K)
@pytest.mark.parametrize("n", UP_GRID_N)
def test_update_sweep_row_streamed_bitwise(cuda, n, k):
    """The row-streamed kernel against the plain version, bit for bit, on
    both sides of every 32-column lane boundary and rank-pass boundary
    (passes of 8, 4, 2, 1 ranks), through the wrapper and on each route:
    f32 update and downdate, bf16 update (R between passes in the f32
    scratch)."""
    for dt, sign in (("f32", 1.0), ("f32", -1.0), ("bf16", 1.0)):
        R, V = _up_operands(70 + n + k, 8, n, k, dt, sign < 0, cuda)
        Rp, ip = update_small.sweep_plain(R, V, sign)
        hopper.reset_counts()
        Rk, ik = update_small.sweep(R, V, sign)
        assert hopper.route_counts()["up.sweep"] == {update_small.sweep_route(8, k): 1}
        assert torch.equal(ik, ip) and not ik.any()
        assert torch.equal(Rk, Rp), (dt, sign)
        for route in ("row", "wave") if k >= 2 else ("row",):
            Rc, ic = _sweep_c(R, V, sign, route)
            assert torch.equal(ic, ip) and torch.equal(Rc, Rp), (dt, sign, route)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_update_sweep_throughput_batch_bitwise(cuda, dt):
    """8192 problems (the row route, eight a block; the wave route through
    the C entry): n = 128 at k = 8 (one pass) and n = 37 at k = 5 (passes
    of 4 and 1)."""
    for n, k, sign in ((128, 8, 1.0), (37, 5, -1.0)):
        R, V = _up_operands(80 + k, 8192, n, k, dt, sign < 0, cuda)
        Rk, ik = update_small.sweep(R, V, sign)
        Rp, ip = update_small.sweep_plain(R, V, sign)
        assert torch.equal(ik, ip) and not ik.any() and torch.equal(Rk, Rp)
        Rw, iw = _sweep_c(R, V, sign, "wave")
        assert torch.equal(iw, ip) and torch.equal(Rw, Rp)


#: faults in a 128 x 20 problem (passes of 8, 8 and 4 ranks), each in the
#: first, middle and last lane (columns 0 / 32, 47, 127 and their rows)
#: and, for V, rank pass (ranks 0, 11, 19): (sign, [(operand, index,
#: value)]); 'scale' multiplies the problem's V
UP_FAULT_POSITIONS = {
    **{f"nan_diag_{j}": (1.0, [("R", (j, j), float("nan"))]) for j in (0, 47, 127)},
    **{f"-inf_diag_{j}": (-1.0, [("R", (j, j), float("-inf"))]) for j in (0, 47, 127)},
    **{f"inf_lower_{r}_{c}": (1.0, [("R", (r, c), float("inf"))]) for r, c in ((1, 0), (90, 47), (127, 95))},
    **{f"nan_upper_{r}_{c}": (1.0, [("R", (r, c), float("nan"))]) for r, c in ((3, 96), (10, 79), (0, 127))},
    **{f"nan_V_{c}_{q}": (1.0, [("V", (c, q), float("nan"))]) for c, q in ((0, 0), (47, 11), (127, 19))},
    **{f"-inf_V_{c}_{q}": (-1.0, [("V", (c, q), float("-inf"))]) for c, q in ((32, 19), (79, 0), (127, 8))},
    **{f"overflow_V_{c}_{q}": (1.0, [("V", (c, q), 3e38)]) for c, q in ((0, 0), (60, 12), (127, 19))},
    "infeasible": (-1.0, [("scale", None, 40.0)]),
    # bad steps (0, 100) and (1, 5): rank-major order meets (0, 100) first,
    # the rows (1, 5)
    "bad_order": (-1.0, [("V", (100, 0), 40.0), ("V", (5, 1), 40.0)]),
    "bad_late_rank": (-1.0, [("V", (33, 19), 40.0)]),
}


@pytest.mark.parametrize("case", sorted(UP_FAULT_POSITIONS))
def test_update_sweep_fault_positions_match_plain(cuda, case):
    """Each fault in one problem of 8 and in three problems of 1056 (on the
    row route eight a block: a faulted problem beside healthy ones in its
    block), on both routes: info, the NaN / inf pattern and every finite
    bit equal the plain version's, and only the poisoned problems are
    flagged."""
    sign, edits = UP_FAULT_POSITIONS[case]
    for batch, where in ((8, (3,)), (1056, (3, 10, 1049))):
        R, V = _up_operands(63, batch, 128, 20, "f32", sign < 0, cuda)
        for p in where:
            for op, idx, val in edits:
                if op == "scale":
                    V[p] *= val
                else:
                    (R if op == "R" else V)[(p, *idx)] = val
        Rp, ip = update_small.sweep_plain(R, V, sign)
        for route in ("row", "wave"):
            Rk, ik = _sweep_c(R, V, sign, route)
            assert torch.equal(ik, ip) and set(torch.nonzero(ik).flatten().tolist()) == set(where), (case, route)
            assert _same_bits(Rk, Rp), (case, route)


def test_update_sweep_refuses(cuda):
    R, V = _up_operands(62, 2, 16, 2, "f32", False, cuda)
    with pytest.raises(TypeError, match="bf16 or f32"):
        update_small.sweep(R.double(), V.double(), 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        update_small.sweep(R, V.bfloat16(), 1.0)
    big = torch.eye(240, device=cuda)[None]
    with pytest.raises(ValueError, match="shared"):
        update_small.sweep(big, torch.zeros((1, 240, 1), device=cuda), 1.0)
    # the C entry refuses the wave route at k = 1 and a row route of 9 warps
    out, info = torch.empty_like(R), torch.empty(2, dtype=torch.int32, device=cuda)
    assert update_small._sweep_launch(R, V[..., :1].contiguous(), out, info, 1.0, "wave", 1) == -1
    assert update_small._sweep_launch(R, V, out, info, 1.0, "row", 9) == -1


@pytest.mark.parametrize("impl,want", [("auto", 1), ("pallas", 1), ("pallas_split", 1), ("vmap", 0)])
def test_batched_update_launches_per_plan(cuda, impl, want):
    R, V = _up_operands(63, 8, 128, 8, "f32", False, cuda)
    hopper.reset_counts()
    R1, info = api.batched("chol_update", "highest", impl)(R, V)
    c = hopper.counts()
    assert c == {**dict.fromkeys(c, 0), "up.sweep": want} and not info.any()
    # the serve bucket (8 problems, k = 8) takes the wave route
    assert hopper.route_counts().get("up.sweep", {}) == ({"wave": 1} if want else {})
    hopper.reset_counts()
    api.batched("chol_update", "highest", impl)(R.double(), V.double())
    assert not any(hopper.counts().values())


def test_guaranteed_posv_launches_per_plan(cuda):
    g = torch.Generator(device="cpu").manual_seed(64)
    X = torch.randn((8, 128, 128), generator=g)
    A = (X @ X.mT / 128 + 3 * torch.eye(128)).to(cuda)
    B = torch.randn((8, 128, 8), generator=g).to(cuda)
    hopper.reset_counts()
    Xg, iters, conv, resid, info = api.batched("posv", "highest", "auto", tier="guaranteed")(A, B)
    c = hopper.counts()
    want = {"small.potrf": 1, "small.potrs": 1 + refine.DEFAULT_MAX_ITERS}
    assert c == {**dict.fromkeys(c, 0), **want}
    assert Xg.dtype == torch.float32 and conv.all() and not info.any()
    r = (A.double() @ Xg.double() - B.double()).flatten(1).norm(dim=1) / B.double().flatten(1).norm(dim=1)
    assert float(r.max()) < 1e-6


# ---- the mesh schedule's per-rank product (sched_matmul) ------------------
# Tolerances as at the top of the file: the kernel against its plain version
# at one rank's slabs of a d = 2 trmm, with the rank's stacked-schedule row
# (rank 0 of a lower operand carries pad entries).

SCHED_CASES = [(512, 1024, 512, "a", "L", 0), (512, 1024, 512, "a", "U", 1),
               (512, 1024, 512, "b", "L", 1), (512, 1024, 512, "b", "U", 0),
               (1024, 2048, 512, "a", "L", 0)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", range(len(SCHED_CASES)))
def test_sched_matmul_kernel_vs_plain(cuda, case, dt):
    mb, K, nb, side, uplo, rank = SCHED_CASES[case]
    au, bu = (uplo, None) if side == "a" else (None, uplo)
    (TO, KO, FI, LA), _, blocks = summa._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
    sched = [torch.from_numpy(x[rank].copy()).to(cuda) for x in (TO, KO, FI, LA)]
    A, B = _rand(30 + case, (mb, K), dt, cuda), _rand(40 + case, (K, nb), dt, cuda)
    hopper.reset_counts()
    got = hopper.sched_matmul(A, B, *sched, tri_side=side, blocks=blocks)
    assert hopper.counts()["sched_matmul"] == 1
    want = hopper.sched_matmul_plain(A, B, *sched, tri_side=side, blocks=blocks)
    torch.cuda.synchronize()
    _close(got, want, dt)


def test_sched_matmul_wrapper_refuses(cuda):
    A = torch.ones(256, 256, device=cuda)
    s = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        hopper.sched_matmul(A.bfloat16(), A.bfloat16(), s, s, s + 1, s + 1, blocks=(64, 64, 64))
    with pytest.raises(TypeError, match="B is"):
        hopper.sched_matmul(A, A.double(), s, s, s + 1, s + 1, blocks=(128, 128, 128))
    with pytest.raises(ValueError, match="schedule is on"):
        hopper.sched_matmul(A, A, s.cpu(), s, s + 1, s + 1, blocks=(128, 128, 128))
    with pytest.raises(ValueError, match="row-major"):
        hopper.sched_matmul(A.T, A, s, s, s + 1, s + 1, blocks=(128, 128, 128))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mesh_factor_launches_the_plan(cuda, monkeypatch, dt):
    """cholinv on a 2x2x1 mesh of the card, mode 'explicit': 4 sched_matmul
    launches per routed trmm (3 at n = 1024, bc = 256: the top node) and no
    other kernel; the same factor through the plain version agrees."""
    n, bc = 1024, 256
    g = np.random.default_rng(12).standard_normal((n, n))
    A = torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(DTYPES[dt]).to(cuda)
    grid = Grid.rect(2, 2, 1, devices=[cuda] * 4)
    cfg = cholesky.CholinvConfig(mode="explicit", base_case_dim=bc)
    hopper.reset_counts()
    R, Ri = cholesky.factor(grid, A, cfg)
    c = hopper.counts()
    assert c == {**dict.fromkeys(c, 0), "sched_matmul": 4 * 3}
    monkeypatch.setattr(hopper, "sched_matmul", hopper.sched_matmul_plain)
    Rq, Riq = cholesky.factor(grid, A, cfg)
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    assert float(residual.rel_fro(R.double() - Rq.double(), Rq.double())) < tol
    assert float(residual.rel_fro(Ri.double() - Riq.double(), Riq.double())) < tol
    gate = {"f32": 2e-6, "bf16": 1e-2}[dt]
    assert float(residual.cholesky_residual(A.double(), R.double())) < gate
    assert float(residual.cholesky_inverse_residual(R.double(), Ri.double())) < gate


# ---- the bf16 wgmma route (TMA ring + wgmma) of tri_matmul and sched_matmul
# Each case forces the route and is held to the plain version with the bf16
# tolerance at the top of the file.  Operands are non-symmetric, so a
# transposed layout cannot pass by symmetry; triangular windows carry NaN in
# their dead half, which must never reach the sum.

WG_P = 2048
#: (M, N, K) and the window origin (row, column) inside 2048 x 2048 buffers:
#: ragged in every dimension, origins aligned for TMA
WG_SHAPES = [((256, 384, 192), (128, 64)), ((1000, 520, 777), (8, 16))]


def _wg_run(fn, A, B, **kw):
    if fn is hopper.tri_matmul:
        return hopper.tri_matmul(A, B, _route="wgmma", **kw)
    return hopper.tri_matmul_plain(A, B, **kw)


def _nan_dead(X, view, uplo):
    """X with NaN in the dead triangle of window `view` (uplo kept)."""
    X = X.clone()
    r0, c0, rows, cols = view
    r = torch.arange(rows, device=X.device)[:, None]
    c = torch.arange(cols, device=X.device)[None, :]
    dead = (r > c) if uplo == "U" else (r < c)
    X[r0:r0 + rows, c0:c0 + cols].masked_fill_(dead, float("nan"))
    return X


@pytest.mark.parametrize("shape", range(len(WG_SHAPES)))
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
def test_wgmma_dense_vs_plain(cuda, a_trans, b_trans, shape):
    (M, N, K), (r0, c0) = WG_SHAPES[shape]
    A, B = _rand(70, (WG_P, WG_P), "bf16", cuda), _rand(71, (WG_P, WG_P), "bf16", cuda)
    kw = dict(a_trans=a_trans, b_trans=b_trans,
              a_view=(r0, c0, K, M) if a_trans else (r0, c0, M, K),
              b_view=(c0, r0, N, K) if b_trans else (c0, r0, K, N))
    hopper.reset_counts()
    got = _wg_run(hopper.tri_matmul, A, B, **kw)
    assert hopper.route_counts() == {"tri_matmul.dense": {"wgmma": 1}}
    torch.cuda.synchronize()
    _close(got, _wg_run(None, A, B, **kw), "bf16")


@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("uplo", ["U", "L"])
@pytest.mark.parametrize("side", ["a", "b"])
def test_wgmma_trmm_vs_plain(cuda, side, uplo, a_trans, b_trans):
    """A triangular operand with NaN in its dead half, every orientation;
    the dense operand ragged (777 wide), the result written in place at an
    offset of a third buffer."""
    n, m = 520, 777
    A, B = _rand(72, (WG_P, WG_P), "bf16", cuda), _rand(73, (WG_P, WG_P), "bf16", cuda)
    if side == "a":
        av, bv = (64, 128, n, n), ((8, 256, m, n) if b_trans else (8, 256, n, m))
        A = _nan_dead(A, av, uplo)
        tri = dict(a_uplo=uplo)
    else:
        av, bv = ((16, 8, n, m) if a_trans else (16, 8, m, n)), (256, 64, n, n)
        B = _nan_dead(B, bv, uplo)
        tri = dict(b_uplo=uplo)
    kw = dict(a_trans=a_trans, b_trans=b_trans, a_view=av, b_view=bv, alpha=-0.5, out_off=(1024, 512), **tri)
    C = _rand(74, (WG_P, WG_P), "bf16", cuda)
    outs = [_wg_run(fn, A, B, out=C.clone(), **kw) for fn in (hopper.tri_matmul, None)]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    _close(outs[0], outs[1], "bf16")


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("out_uplo", ["U", "L"])
def test_wgmma_syrk_vs_plain(cuda, out_uplo, a_trans, b_trans, in_place):
    """The triangular-output form: fused beta*C read-modify-write in place,
    or beta = 0 with the dead half zeroed (every tile launched)."""
    n, k = 648, 520
    A, B = _rand(75, (WG_P, WG_P), "bf16", cuda), _rand(76, (WG_P, WG_P), "bf16", cuda)
    C = _rand(77, (WG_P, WG_P), "bf16", cuda)
    kw = dict(a_trans=a_trans, b_trans=b_trans, out_uplo=out_uplo,
              a_view=(0, 64, k, n) if a_trans else (0, 64, n, k),
              b_view=(128, 0, n, k) if b_trans else (128, 0, k, n))
    r = torch.arange(n)[:, None]
    q = torch.arange(n)[None, :]
    live = (r <= q) if out_uplo == "U" else (r >= q)
    if in_place:
        kw.update(alpha=-1.0, beta=1.0, c_view=(1024, 1024, n, n), out_off=(1024, 1024))
        outs = []
        for fn in (hopper.tri_matmul, None):
            c = C.clone()
            outs.append(_wg_run(fn, A, B, c=c, out=c, **kw))
        torch.cuda.synchronize()
        mask = torch.zeros(WG_P, WG_P, dtype=torch.bool)
        mask[1024:1024 + n, 1024:1024 + n] = live
        _close(outs[0], outs[1], "bf16", mask)
        outside = torch.ones(WG_P, WG_P, dtype=torch.bool)
        outside[1024:1024 + n, 1024:1024 + n] = False
        assert torch.equal(outs[0].cpu()[outside], C.cpu()[outside])
    else:
        got = _wg_run(hopper.tri_matmul, A, B, **kw)
        torch.cuda.synchronize()
        _close(got, _wg_run(None, A, B, **kw), "bf16")
        assert bool((got.cpu()[~live] == 0).all())


def test_wgmma_route_tally(cuda):
    """Aligned bf16 windows take wgmma, an odd column offset wmma, aligned
    f32 fma; counts() keeps its keys and its sums; reset clears the tally."""
    A = _rand(78, (512, 512), "bf16", cuda)
    hopper.reset_counts()
    hopper.tri_matmul(A, A, a_uplo="U", a_view=(0, 0, 256, 256), b_view=(0, 256, 256, 256))
    hopper.tri_matmul(A, A, a_uplo="U", a_view=(0, 3, 256, 256), b_view=(0, 256, 256, 256))
    hopper.tri_matmul(A.float(), A.float(), out_uplo="U", a_trans=True)
    hopper.tri_matmul(A, A, a_view=(0, 0, 256, 256), b_view=(0, 256, 256, 256), _route="wmma")
    assert hopper.route_counts() == {"tri_matmul.trmm": {"wgmma": 1, "wmma": 1},
                                     "tri_matmul.syrk": {"fma": 1}, "tri_matmul.dense": {"wmma": 1}}
    c = hopper.counts()
    assert set(c) == set(hopper.KERNELS)
    assert (c["tri_matmul.trmm"], c["tri_matmul.syrk"], c["tri_matmul.dense"]) == (2, 1, 1)
    with pytest.raises(ValueError, match="wgmma route cannot"):
        hopper.tri_matmul(A, A, a_view=(0, 3, 256, 256), b_view=(0, 256, 256, 256), _route="wgmma")
    with pytest.raises(ValueError, match="only bf16"):
        hopper.tri_matmul(A.float(), A.float(), _route="wgmma")
    hopper.reset_counts()
    assert hopper.route_counts() == {}


@pytest.mark.parametrize("case", range(len(SCHED_CASES)))
def test_sched_matmul_wgmma_vs_plain(cuda, case):
    """Every schedule case on the wgmma route, rank 0 (pads when the operand
    is lower) and rank 1; the schedules hold runs of one pair and of many."""
    mb, K, nb, side, uplo, _ = SCHED_CASES[case]
    au, bu = (uplo, None) if side == "a" else (None, uplo)
    (TO, KO, FI, LA), _, blocks = summa._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
    A, B = _rand(80 + case, (mb, K), "bf16", cuda), _rand(90 + case, (K, nb), "bf16", cuda)
    lengths = []
    for rank in range(2):
        sched = [torch.from_numpy(x[rank].copy()).to(cuda) for x in (TO, KO, FI, LA)]
        starts = np.flatnonzero(FI[rank] == 1)
        ends = np.flatnonzero(LA[rank] == 1)
        lengths += list(ends - starts + 1)
        hopper.reset_counts()
        got = hopper.sched_matmul(A, B, *sched, tri_side=side, blocks=blocks)
        assert hopper.route_counts() == {"sched_matmul": {"wgmma": 1}}
        want = hopper.sched_matmul_plain(A, B, *sched, tri_side=side, blocks=blocks)
        torch.cuda.synchronize()
        written = ~torch.isnan(want)
        _close(got, want, "bf16", written.cpu())
    assert min(lengths) == 1 and max(lengths) > 1


def test_sched_matmul_wmma_route_stays(cuda):
    """k-blocks that are not a multiple of 64 keep the wmma route; asking
    for wgmma there raises."""
    mb, K, nb = 256, 384, 256
    A, B = _rand(95, (mb, K), "bf16", cuda), _rand(96, (K, nb), "bf16", cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    sched = [one * 0, one * 0, one, one]
    blocks = (128, 128, 96)
    hopper.reset_counts()
    got = hopper.sched_matmul(A, B, *sched, tri_side="a", blocks=blocks)
    assert hopper.route_counts() == {"sched_matmul": {"wmma": 1}}
    want = hopper.sched_matmul_plain(A, B, *sched, tri_side="a", blocks=blocks)
    torch.cuda.synchronize()
    _close(got, want, "bf16", (~torch.isnan(want)).cpu())
    with pytest.raises(ValueError, match="wgmma route cannot"):
        hopper.sched_matmul(A, B, *sched, tri_side="a", blocks=blocks, _route="wgmma")


@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_mesh_and_rectri_routes(cuda, dt):
    """Every tri_matmul launch of a cholinv and a rectri, and every
    sched_matmul launch of a mesh factor, takes its dtype's route."""
    route = {"f32": "fma", "bf16": "wgmma", "f64": "dmma"}[dt]
    n = 1024
    g = np.random.default_rng(13).standard_normal((n, n))
    A = torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(DTYPES[dt]).to(cuda)
    hopper.reset_counts()
    R, _ = cholesky.factor(Grid.square(device=cuda), A, cholesky.CholinvConfig(mode="pallas", base_case_dim=128))
    inverse.rectri(Grid.square(device=cuda), R.T.contiguous(), "L",
                   inverse.RectriConfig(base_case_dim=128, mode="pallas"))
    c = hopper.counts()
    # rectri's one write-back: a contiguous stack of 128-blocks into an
    # aligned buffer, the 'vec' route in every dtype
    assert hopper.route_counts() == {
        "tri_matmul.trmm": {route: c["tri_matmul.trmm"]}, "tri_matmul.syrk": {route: c["tri_matmul.syrk"]},
        "write_diag_blocks": {"vec": 1}}
    hopper.reset_counts()
    cholesky.factor(Grid.rect(2, 2, 1, devices=[cuda] * 4), A,
                    cholesky.CholinvConfig(mode="explicit", base_case_dim=256))
    assert hopper.route_counts() == {"sched_matmul": {route: 12}}


# ---- the f64 dmma and f32 fma routes of tri_matmul and sched_matmul --------
# Each case forces the dtype's fast route (f64 'dmma', f32 'fma') and is held
# to the plain version with the tolerances at the top of the file; windows
# are ragged in every dimension (not multiples of the 128 x 64 / 128 x 128
# tiles) at 16-byte-aligned origins, triangular windows carry NaN in their
# dead half, and the routes are held to the simt loop on the same operands.

FP_FAST = {"f64": "dmma", "f32": "fma"}


def _fp_run(fn, A, B, dt, **kw):
    if fn is hopper.tri_matmul:
        return hopper.tri_matmul(A, B, _route=FP_FAST[dt], **kw)
    return hopper.tri_matmul_plain(A, B, **kw)


@pytest.mark.parametrize("shape", range(len(WG_SHAPES)))
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("dt", list(FP_FAST))
def test_dmma_fma_dense_vs_plain(cuda, dt, a_trans, b_trans, shape):
    (M, N, K), (r0, c0) = WG_SHAPES[shape]
    A, B = _rand(100, (WG_P, WG_P), dt, cuda), _rand(101, (WG_P, WG_P), dt, cuda)
    kw = dict(a_trans=a_trans, b_trans=b_trans,
              a_view=(r0, c0, K, M) if a_trans else (r0, c0, M, K),
              b_view=(c0, r0, N, K) if b_trans else (c0, r0, K, N))
    hopper.reset_counts()
    got = _fp_run(hopper.tri_matmul, A, B, dt, **kw)
    assert hopper.route_counts() == {"tri_matmul.dense": {FP_FAST[dt]: 1}}
    torch.cuda.synchronize()
    _close(got, _fp_run(None, A, B, dt, **kw), dt)


@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("uplo", ["U", "L"])
@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("dt", list(FP_FAST))
def test_dmma_fma_trmm_vs_plain(cuda, dt, side, uplo, a_trans, b_trans):
    """A triangular operand with NaN in its dead half, every orientation;
    the dense operand ragged (777 wide), the result written in place at an
    offset of a third buffer."""
    n, m = 520, 777
    A, B = _rand(102, (WG_P, WG_P), dt, cuda), _rand(103, (WG_P, WG_P), dt, cuda)
    if side == "a":
        av, bv = (64, 128, n, n), ((8, 256, m, n) if b_trans else (8, 256, n, m))
        A = _nan_dead(A, av, uplo)
        tri = dict(a_uplo=uplo)
    else:
        av, bv = ((16, 8, n, m) if a_trans else (16, 8, m, n)), (256, 64, n, n)
        B = _nan_dead(B, bv, uplo)
        tri = dict(b_uplo=uplo)
    kw = dict(a_trans=a_trans, b_trans=b_trans, a_view=av, b_view=bv, alpha=-0.5, out_off=(1024, 512), **tri)
    C = _rand(104, (WG_P, WG_P), dt, cuda)
    hopper.reset_counts()
    outs = [_fp_run(fn, A, B, dt, out=C.clone(), **kw) for fn in (hopper.tri_matmul, None)]
    assert hopper.route_counts() == {"tri_matmul.trmm": {FP_FAST[dt]: 1}}
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    _close(outs[0], outs[1], dt)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("out_uplo", ["U", "L"])
@pytest.mark.parametrize("dt", list(FP_FAST))
def test_dmma_fma_syrk_vs_plain(cuda, dt, out_uplo, a_trans, b_trans, in_place):
    """The triangular-output form: fused beta*C read-modify-write in place,
    or beta = 0 with the dead half zeroed (every tile launched)."""
    n, k = 648, 520
    A, B = _rand(105, (WG_P, WG_P), dt, cuda), _rand(106, (WG_P, WG_P), dt, cuda)
    C = _rand(107, (WG_P, WG_P), dt, cuda)
    kw = dict(a_trans=a_trans, b_trans=b_trans, out_uplo=out_uplo,
              a_view=(0, 64, k, n) if a_trans else (0, 64, n, k),
              b_view=(128, 0, n, k) if b_trans else (128, 0, k, n))
    r = torch.arange(n)[:, None]
    q = torch.arange(n)[None, :]
    live = (r <= q) if out_uplo == "U" else (r >= q)
    if in_place:
        kw.update(alpha=-1.0, beta=1.0, c_view=(1024, 1024, n, n), out_off=(1024, 1024))
        outs = []
        for fn in (hopper.tri_matmul, None):
            c = C.clone()
            outs.append(_fp_run(fn, A, B, dt, c=c, out=c, **kw))
        torch.cuda.synchronize()
        mask = torch.zeros(WG_P, WG_P, dtype=torch.bool)
        mask[1024:1024 + n, 1024:1024 + n] = live
        _close(outs[0], outs[1], dt, mask)
        outside = torch.ones(WG_P, WG_P, dtype=torch.bool)
        outside[1024:1024 + n, 1024:1024 + n] = False
        assert torch.equal(outs[0].cpu()[outside], C.cpu()[outside])
    else:
        got = _fp_run(hopper.tri_matmul, A, B, dt, **kw)
        torch.cuda.synchronize()
        _close(got, _fp_run(None, A, B, dt, **kw), dt)
        assert bool((got.cpu()[~live] == 0).all())


@pytest.mark.parametrize("dt", list(FP_FAST))
def test_dmma_fma_against_simt(cuda, dt):
    """The fast route and the simt loop on the same operands: a trmm with
    NaN in the dead half and a ragged dense product agree within the
    dtype's tolerance (both are IEEE sums of the same products in another
    order)."""
    A, B = _rand(108, (WG_P, WG_P), dt, cuda), _rand(109, (WG_P, WG_P), dt, cuda)
    A = _nan_dead(A, (64, 128, 520, 520), "L")
    for kw in (dict(a_uplo="L", a_trans=True, a_view=(64, 128, 520, 520), b_view=(8, 256, 520, 777)),
               dict(b_trans=True, a_view=(1024, 0, 1000, 777), b_view=(8, 16, 520, 777))):
        hopper.reset_counts()
        fast = hopper.tri_matmul(A, B, _route=FP_FAST[dt], **kw)
        simt = hopper.tri_matmul(A, B, _route="simt", **kw)
        form = "tri_matmul.trmm" if "a_uplo" in kw else "tri_matmul.dense"
        assert hopper.route_counts() == {form: {FP_FAST[dt]: 1, "simt": 1}}
        torch.cuda.synchronize()
        _close(fast, simt, dt)


@pytest.mark.parametrize("case", range(len(SCHED_CASES)))
@pytest.mark.parametrize("dt", list(FP_FAST))
def test_sched_matmul_dmma_fma_vs_plain(cuda, dt, case):
    """Every schedule case on the dtype's fast route, rank 0 (pads when the
    operand is lower) and rank 1, and against the simt loop."""
    mb, K, nb, side, uplo, _ = SCHED_CASES[case]
    au, bu = (uplo, None) if side == "a" else (None, uplo)
    (TO, KO, FI, LA), _, blocks = summa._sched_host(2, 2 * mb, K, 2 * nb, au, bu)
    A, B = _rand(110 + case, (mb, K), dt, cuda), _rand(120 + case, (K, nb), dt, cuda)
    for rank in range(2):
        sched = [torch.from_numpy(x[rank].copy()).to(cuda) for x in (TO, KO, FI, LA)]
        hopper.reset_counts()
        got = hopper.sched_matmul(A, B, *sched, tri_side=side, blocks=blocks)
        assert hopper.route_counts() == {"sched_matmul": {FP_FAST[dt]: 1}}
        simt = hopper.sched_matmul(A, B, *sched, tri_side=side, blocks=blocks, _route="simt")
        want = hopper.sched_matmul_plain(A, B, *sched, tri_side=side, blocks=blocks)
        torch.cuda.synchronize()
        written = (~torch.isnan(want)).cpu()
        _close(got, want, dt, written)
        _close(got, simt, dt, written)


def test_dmma_fma_routes_refuse(cuda):
    """A fast route where its 16-byte copies cannot read the window, or a
    route of another dtype, raises before any launch."""
    A = _rand(111, (512, 512), "f64", cuda)
    hopper.reset_counts()
    with pytest.raises(ValueError, match="dmma route cannot"):
        hopper.tri_matmul(A, A, a_view=(0, 1, 256, 256), b_view=(0, 256, 256, 256), _route="dmma")
    with pytest.raises(ValueError, match="only f32"):
        hopper.tri_matmul(A, A, _route="fma")
    with pytest.raises(ValueError, match="only bf16"):
        hopper.tri_matmul(A.float(), A.float(), _route="wmma")
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    odd = torch.zeros(1 + 256 * 384, device=cuda)[1:].view(256, 384)  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="fma route cannot"):
        hopper.sched_matmul(odd, A.float()[:384, :256].contiguous(), one * 0, one * 0, one, one,
                            tri_side="a", blocks=(128, 128, 128), _route="fma")
    assert hopper.route_counts() == {}
    # an unaligned f64 window takes the simt loop by itself
    got = hopper.tri_matmul(A, A, a_view=(0, 1, 256, 256), b_view=(0, 256, 256, 256))
    assert hopper.route_counts() == {"tri_matmul.dense": {"simt": 1}}
    torch.cuda.synchronize()
    _close(got, hopper.tri_matmul_plain(A, A, a_view=(0, 1, 256, 256), b_view=(0, 256, 256, 256)), "f64")


# ---- the serve engine's captured bucket programs ----------------------------

ENGINE_LADDERS = dict(buckets=(32, 64), rows_buckets=(128, 256), nrhs_buckets=(1, 8),
                      nblocks_buckets=(8, 32), block_buckets=(16, 32), border_buckets=(8,), max_batch=4)
#: (op, a_shape, b_shape, dtype, tier, small_n_impl): the program, its launches at capture
CAPTURE_CASES = {
    "posv f32 auto": (("posv", (64, 64), (64, 8), "float32", "balanced", "auto"), {"small.posv": 1}),
    "posv f32 split": (("posv", (64, 64), (64, 8), "float32", "balanced", "pallas_split"),
                       {"small.potrf": 1, "small.potrs": 1}),
    "lstsq f32 auto": (("lstsq", (256, 64), (256, 8), "float32", "balanced", "auto"), {"small.lstsq": 1}),
    "inv bf16 auto": (("inv", (32, 32), None, "bfloat16", "balanced", "auto"), {"small.posv": 1}),
    "posv f64 auto": (("posv", (64, 64), (64, 8), "float64", "balanced", "auto"), {}),
    "posv f64 guaranteed": (("posv", (32, 32), (32, 1), "float64", "guaranteed", "auto"),
                            {"small.potrf": 1, "small.potrs": refine.DEFAULT_MAX_ITERS + 1}),
    "blocktri f32 scan": (("posv_blocktri", (2, 8, 32, 32), (8, 32, 8), "float32", "balanced", "auto"),
                          {"bt.fused_forward": 1, "bt.solve_backward": 1}),
    "blocktri f32 partitioned": (("posv_blocktri", (2, 32, 16, 16), (32, 16, 1), "float32", "balanced",
                                  "auto"), {"bt.fused_forward": 2, "bt.solve_backward": 2}),
    # the residency and session programs
    "posv_cached f32 auto": (("posv_cached", (64, 64), (64, 8), "float32", "balanced", "auto"),
                             {"small.potrs": 1}),
    "posv_cached_miss f32 auto": (("posv_cached_miss", (64, 64), (64, 8), "float32", "balanced", "auto"),
                                  {"small.potrf": 1, "small.potrs": 1}),
    "posv_cached_miss f64 auto": (("posv_cached_miss", (32, 32), (32, 1), "float64", "balanced", "auto"), {}),
    "chol_downdate f32 auto": (("chol_downdate", (64, 64), (64, 8), "float32", "balanced", "auto"),
                               {"up.sweep": 1}),
    "blocktri_extend f32 auto": (("blocktri_extend", (2, 8, 32, 32), (32, 32), "float32", "balanced", "auto"),
                                 {"bt.factor": 1}),
    "session_extend f32 auto": (("session_extend", (2, 8, 32, 32), (32, 32), "float32", "balanced", "auto"),
                                {"bt.factor": 1}),
    "session_solve f32 auto": (("session_solve", (4, 8, 32, 32), (8, 32, 8), "float32", "balanced", "auto"),
                               {"bt.forward_solve": 1, "bt.solve_backward": 1}),
    "session_solve f32 guaranteed": (("session_solve", (4, 8, 32, 32), (8, 32, 2), "float32", "guaranteed",
                                      "auto"), {"bt.forward_solve": refine.DEFAULT_MAX_ITERS + 1,
                                                "bt.solve_backward": refine.DEFAULT_MAX_ITERS + 1}),
}


def _capture_operands(op, a_shape, b_shape, dtype, cap, dev):
    g = torch.Generator().manual_seed(len(op) + cap)
    f64 = torch.float64
    if op in ("posv_blocktri", "blocktri_extend", "session_extend", "session_solve"):
        _, nb, b, _ = a_shape
        G = torch.randn(cap, nb, b, b, generator=g, dtype=f64)
        D = G @ G.mT / b + 3.0 * torch.eye(b, dtype=f64)
        C = 0.3 / b ** 0.5 * torch.randn(cap, nb, b, b, generator=g, dtype=f64)
        if op in ("blocktri_extend", "session_extend"):
            # appended blocks (C[:, 0] live) and a prefix's carry
            G = torch.randn(cap, b, b, generator=g, dtype=f64)
            A, B = torch.stack([D, C], dim=1), torch.linalg.cholesky(G @ G.mT / b + 3.0 * torch.eye(b, dtype=f64))
        else:
            C[:, 0] = 0
            A, B = torch.stack([D, C], dim=1), torch.randn(cap, *b_shape, generator=g, dtype=f64)
            if op == "session_solve":
                from capital_tpu_torch.models import blocktri

                L, Wt, _ = blocktri.factor(D, C, impl="xla")
                A = torch.cat([A, torch.stack([L, Wt], dim=1)], dim=1)
    elif op == "lstsq":
        A, B = torch.randn(cap, *a_shape, generator=g, dtype=f64), torch.randn(cap, *b_shape, generator=g, dtype=f64)
    else:
        n = a_shape[0]
        G = torch.randn(cap, n, n, generator=g, dtype=f64)
        A = G @ G.mT / n + 3.0 * torch.eye(n, dtype=f64)
        B = None if b_shape is None else torch.randn(cap, *b_shape, generator=g, dtype=f64)
        if op in ("posv_cached", "chol_downdate"):
            A = torch.linalg.cholesky(A).mT.contiguous()  # the resident upper factor
        if op == "chol_downdate":
            B = 0.05 * B
    dt = DTYPES[{"float64": "f64", "float32": "f32", "bfloat16": "bf16"}[dtype]]
    return tuple(x.to(dt).to(dev) for x in (A, B) if x is not None)


def _same_bits(got, want):
    nan = torch.isnan(got.float()) if got.is_floating_point() else torch.zeros_like(got, dtype=torch.bool)
    if got.dtype != want.dtype or not torch.equal(nan, torch.isnan(want.float()) if want.is_floating_point()
                                                  else nan):
        return False
    return torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0))


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_engine_replay_equals_eager_and_capture_counts(cuda, case):
    from capital_tpu_torch.serve import batching, program
    from capital_tpu_torch.serve.engine import ServeConfig

    (op, a_shape, b_shape, dtype, tier, impl), plan = CAPTURE_CASES[case]
    cfg = ServeConfig(small_n_impl=impl, **ENGINE_LADDERS)
    bucket = batching.Bucket(op, dtype, a_shape, b_shape, cfg.max_batch, tier)
    assert program.capturable(bucket, cfg)
    fn = api.batched(op, cfg.precision, impl, blocktri_impl=cfg.blocktri_impl, tier=tier)
    prog = program.Program(fn, bucket, cuda, capture=True)
    assert prog.captured and prog.capture_counts == plan
    routes = {k: {"blocked": v} for k, v in plan.items() if k.startswith("bt.")}
    if "up.sweep" in plan:  # the update's sweep tallies the route its batch and rank take
        routes["up.sweep"] = {update_small.sweep_route(cfg.max_batch, b_shape[1]): plan["up.sweep"]}
    assert prog.capture_routes == routes
    ins = _capture_operands(op, a_shape, b_shape, dtype, cfg.max_batch, cuda)
    hopper.reset_counts()
    got = prog(*ins)
    want = tuple(fn(*(x.clone() for x in ins)))
    torch.cuda.synchronize()
    assert len(got) == len(want) and all(_same_bits(g, w) for g, w in zip(got, want))
    # the replay launched nothing through the wrappers: only the eager call counted
    assert hopper.counts() == {**dict.fromkeys(hopper.KERNELS, 0), **plan}
    assert prog.replays == 1 and not int(got[-1].abs().max())


def test_engine_two_inflight_batches_land_their_own(cuda):
    from capital_tpu_torch.serve import ServeConfig, SolveEngine

    eng = SolveEngine(cfg=ServeConfig(scheduler="continuous", max_inflight=2, **dict(ENGINE_LADDERS,
                                                                                      max_batch=2)))
    assert eng.grid.device.type == "cuda"
    g = torch.Generator().manual_seed(3)
    probs = []
    for _ in range(4):
        G = torch.randn(20, 20, generator=g, dtype=torch.float64)
        probs.append((G @ G.T / 20 + 3.0 * torch.eye(20, dtype=torch.float64),
                      torch.randn(20, 3, generator=g, dtype=torch.float64)))
    tickets = [eng.submit("posv", A.float(), B.float()) for A, B in probs]
    assert eng.scheduler.inflight_depth == 2 and all(t.done for t in tickets)
    eng.drain()
    for (A, B), t in zip(probs, tickets):
        r = t.result()
        assert r.ok and r.x.device.type == "cuda"
        want = torch.linalg.solve(A, B)
        assert float((r.x.double().cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ((key, prog),) = eng.cache.programs().items()
    assert prog.captured and eng.cache.replays() == {key: 2}


def test_engine_residency_and_sessions_on_the_card(cuda):
    """The residency and session protocol through the engine on the card:
    every bucket program captured; a poisoned update is refused and the
    resident factor stays bit for bit; extending a chain from its resident
    carry is bit for bit the refactor of the whole chain; a session's
    sliding cycle answers for its marginalized window."""
    from capital_tpu_torch.models import blocktri
    from capital_tpu_torch.robust import faultinject
    from capital_tpu_torch.serve import ServeConfig, SessionManager, SolveEngine

    eng = SolveEngine(cfg=ServeConfig(**ENGINE_LADDERS))
    g = torch.Generator(device=cuda).manual_seed(5)

    def spd(*shape):
        G = torch.randn(*shape, generator=g, device=cuda, dtype=torch.float64)
        return G @ G.mT / shape[-1] + 3.0 * torch.eye(shape[-1], device=cuda, dtype=torch.float64)

    A, B = spd(48, 48).float(), torch.randn(48, 4, generator=g, device=cuda)
    V = 0.05 * torch.randn(48, 8, generator=g, device=cuda)
    assert eng.solve("posv_cached", A, B, factor_token="t").ok
    R0 = eng.factors.peek("t").arrays[0].clone()
    with faultinject.active_plan(faultinject.Fault(tag="serve::ingest", kind="nan")):
        r = eng.solve("chol_update", V, factor_token="t")
    assert not r.ok and "left unchanged" in r.error
    assert torch.equal(eng.factors.peek("t").arrays[0], R0)
    assert eng.solve("chol_update", V, factor_token="t").ok
    r = eng.solve("posv_cached", A, B, factor_token="t")
    want = torch.linalg.solve(A.double() + V.double() @ V.double().T, B.double())
    assert float((r.x.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # a chain extended from its resident carry is the whole chain's factor
    D = spd(16, 32, 32).float()
    C = (0.3 / 32 ** 0.5 * torch.randn(16, 32, 32, generator=g, device=cuda))
    C[0] = 0
    assert eng.solve("blocktri_extend", torch.stack([D[:8], C[:8]]), factor_token="c").ok
    assert eng.solve("blocktri_extend", torch.stack([D[8:], C[8:]]), factor_token="c").ok
    L, Wt, info = blocktri.factor(D[None], C[None])
    ent = eng.factors.peek("c")
    assert not info.any() and torch.equal(ent.arrays[0], L[0]) and torch.equal(ent.arrays[1], Wt[0])
    # a session: open, append + contract, solve at the three tiers
    mgr = SessionManager(eng)
    assert mgr.open("s", D[:8], C[:8]).ok
    assert mgr.append("s", D[8:12], C[8:12]).ok and mgr.contract("s", 4).ok
    Dw, Cw = mgr.window("s")
    Bw = torch.randn(8, 32, 2, generator=g, device=cuda)
    dense = torch.zeros(256, 256, dtype=torch.float64, device=cuda)
    for i in range(8):
        dense[32 * i:32 * i + 32, 32 * i:32 * i + 32] = Dw[i].double()
        if i:
            dense[32 * i:32 * i + 32, 32 * i - 32:32 * i] = Cw[i].double()
            dense[32 * i - 32:32 * i, 32 * i:32 * i + 32] = Cw[i].double().T
    ref = torch.linalg.solve(dense, Bw.double().reshape(256, 2))
    for tier, tol in (("balanced", 1e-4), ("guaranteed", 1e-4), ("fast", 5e-2)):
        r = mgr.solve("s", Bw, accuracy_tier=tier)
        assert r.ok, (tier, r.error)
        assert float((r.x.double().reshape(256, 2) - ref).abs().max()) <= tol * float(ref.abs().max()), tier
    progs = eng.cache.programs()
    assert progs and all(p.captured for p in progs.values())
    assert {k[1][0] for k in progs} >= {"posv_cached", "posv_cached_miss", "chol_update", "blocktri_extend",
                                        "session_extend", "session_solve"}


def test_router_thread_and_process_replicas_on_the_card(cuda, tmp_path):
    """Two ThreadReplicas and one ProcessReplica (its own CUDA context on
    the card) behind a Router, sharing one warm-up manifest: the first
    replica builds, the others build what it foresaw; every response under
    the drivers' residual gates (5e-5 f32, 10x for lstsq), no build after
    warm-up on any replica, and every replica served."""
    from capital_tpu_torch.serve import loadgen
    from capital_tpu_torch.serve.engine import ServeConfig
    from capital_tpu_torch.serve.replica import ProcessReplica, ThreadReplica
    from capital_tpu_torch.serve.router import Router, RouterConfig

    cfg = ServeConfig(buckets=(32, 64), rows_buckets=(128, 256), nrhs_buckets=(1, 8), max_batch=4,
                      max_delay_s=0.002, persist_dir=str(tmp_path))
    wl = loadgen.Workload(requests=64, concurrency=8, ops=("posv", "lstsq"), ns=(32, 64), nrhs=(1, 8))
    r = Router(RouterConfig(policy="least_loaded"))
    for rep in (ThreadReplica("t0", cfg, device="cuda"), ThreadReplica("t1", cfg, device="cuda"),
                ProcessReplica("p0", cfg, device="cuda")):
        r.add_replica(rep)
    try:
        fresh = r.warmup(loadgen.warmup_specs(wl), timeout=600.0)
        assert fresh["t0"] == len(loadgen.warmup_specs(wl)) and fresh["t1"] == fresh["p0"] == 0, fresh
        r.start()
        sent = [(op, A, B, r.submit(op, A, B)) for op, A, B in loadgen.build_requests(wl)]
        served = set()
        for op, A, B, t in sent:
            res = t.result(timeout=300.0)
            assert res.ok, res.error
            A64, B64, x = (np.asarray(v, dtype=np.float64) for v in (A, B, res.x))
            if op == "lstsq":
                resid = np.linalg.norm(A64.T @ (A64 @ x - B64)) / np.linalg.norm(A64.T @ B64)
            else:
                resid = np.linalg.norm(A64 @ x - B64) / np.linalg.norm(B64)
            assert resid < (5e-4 if op == "lstsq" else 5e-5), (op, A.shape, resid)
            served.add(res.replica_id)
        snaps = r.replica_stats()
        assert set(snaps) == {"t0", "t1", "p0"} and served == set(snaps)
        for rid, snap in snaps.items():
            # builds only at warm-up: t0 the specs', t1 and p0 the manifest's
            assert snap["cache"]["misses"] == 0, rid
            assert snap["cache"]["compiles"] == snap["cache"]["warmup_compiles"] == fresh[rid], rid
        c = r.counters()
        assert c["completed"] == c["dispatched"] == wl.requests and not c["parked"]
    finally:
        r.stop()
