"""The small-N batched solves of the port (capital_tpu_torch/ops/
batched_small.py) against the JAX package's Pallas kernels
(capital_tpu/ops/batched_small.py) in interpret mode.

On the CPU the port's wrappers run their plain versions, so this holds the
plain versions to the reference; tests/test_torch_gpu.py holds the CUDA
kernels to the plain versions on the card.  Operands are made with numpy
from a seed and handed to both packages; the reference callables are jitted
once at module level and shared, so each shape compiles once.

Tolerances, relative to the largest |reference| entry: f32 1e-5 (the port
divides by sqrt(d) where the reference multiplies by rsqrt(d), and sums in
another order; n <= 32 keeps the growth small), lstsq 1e-4 (two Cholesky
sweeps of the gram square the condition number); bf16 one bf16 ulp of each
entry plus 1e-5 (both compute in f32 and round once).  `info` is compared
exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import batched_small as ref
from capital_tpu.utils import tracing as ref_tracing
from capital_tpu_torch.ops import batched_small as bs
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

N, BATCH = 16, 4


@functools.lru_cache(maxsize=None)
def _ref(name, **kw):
    return jax.jit(functools.partial(getattr(ref, name), **kw))


def _spd(seed, batch=BATCH, n=N, dtype=np.float32):
    X = np.random.default_rng(seed).standard_normal((batch, n, n))
    return (X @ X.transpose(0, 2, 1) / n + 3.0 * np.eye(n)).astype(dtype)


def _rhs(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, rel=1e-5, mask=None):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def _info(x):
    return np.asarray(x).astype(np.int32) if not isinstance(x, torch.Tensor) else x.numpy()


# ---------------------------------------------------------------------------
# parity with the reference, clean operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_potrf_matches_reference(uplo):
    A = _spd(1)
    R, info = _ref("potrf", uplo=uplo)(jnp.asarray(A))
    Rp, infop = bs.potrf(_t(A), uplo=uplo)
    _close(Rp, R)
    assert np.array_equal(_info(infop), _info(info)) and not _info(infop).any()
    dead = np.tril(np.ones((N, N), bool), -1) if uplo == "U" else np.triu(np.ones((N, N), bool), 1)
    assert np.all(Rp.numpy()[:, dead] == 0)


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_potrs_matches_reference(uplo):
    A = _spd(2)
    R, _ = _ref("potrf", uplo=uplo)(jnp.asarray(A))
    B = _rhs(3, (BATCH, N, 4))
    X = _ref("potrs", uplo=uplo)(R, jnp.asarray(B))
    Xp = bs.potrs(_t(R), _t(B), uplo=uplo)
    _close(Xp, X)


@pytest.mark.parametrize("k", [1, 4])
def test_posv_matches_reference(k):
    A, B = _spd(4), _rhs(5, (BATCH, N, k))
    X, info = _ref("posv")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = bs.posv(_t(A), _t(B))
    _close(Xp, X)
    assert np.array_equal(_info(infop), _info(info))
    ref64 = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    _close(Xp, ref64, rel=1e-5)


def test_lstsq_matches_reference():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((BATCH, 64, N)).astype(np.float32)
    B = rng.standard_normal((BATCH, 64, 2)).astype(np.float32)
    X, info = _ref("lstsq")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = bs.lstsq(_t(A), _t(B))
    _close(Xp, X, rel=1e-4)
    assert np.array_equal(_info(infop), _info(info)) and not _info(infop).any()


def test_posv_bf16_matches_reference():
    A = _spd(7).astype(jnp.bfloat16)
    B = _rhs(8, (BATCH, N, 1)).astype(jnp.bfloat16)
    X, info = _ref("posv")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = bs.posv(tensor_from_numpy(A), tensor_from_numpy(B))
    assert Xp.dtype == torch.bfloat16
    got, want = _f64(Xp), _f64(X)
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-5 * scale)
    assert np.array_equal(_info(infop), _info(info))


@pytest.mark.parametrize("block", [1, 2, 4, 8])
def test_block_knob_changes_nothing(block):
    A, B = _spd(9), _rhs(10, (BATCH, N, 2))
    X, infop = bs.posv(_t(A), _t(B), block=block)
    X0, _ = bs.posv(_t(A), _t(B))
    assert torch.equal(X, X0) and not infop.any()
    Xr, _ = _ref("posv", block=block)(jnp.asarray(A), jnp.asarray(B))
    _close(X, Xr)


# ---------------------------------------------------------------------------
# info: exactly the reference's, fault by fault
# ---------------------------------------------------------------------------


def _faulted():
    """[clean, NaN on the diagonal at [1, 3, 3], indefinite pivot at
    [2, 5, 5], off-diagonal-only contamination at [3, 0, 7] (upper half
    only: the lower half the factor reads stays clean)]."""
    A = _spd(11)
    A[1, 3, 3] = np.nan
    A[2, 5, 5] = -100.0
    A[3, 0, 7] = np.nan
    return A


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_potrf_info_matches_reference(uplo):
    A = _faulted()
    R, info = _ref("potrf", uplo=uplo)(jnp.asarray(A))
    Rp, infop = bs.potrf(_t(A), uplo=uplo)
    assert np.array_equal(_info(infop), _info(info))
    assert list(_info(infop)) == [0, 2, 6, 1]
    _close(Rp[0], np.asarray(R)[0])


def test_posv_info_matches_reference_and_is_contained():
    A, B = _faulted(), _rhs(12, (BATCH, N, 2))
    X, info = _ref("posv")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = bs.posv(_t(A), _t(B))
    assert np.array_equal(_info(infop), _info(info))
    _close(Xp[0], np.asarray(X)[0])
    Xc, _ = bs.posv(_t(_spd(11)), _t(B))
    assert torch.equal(Xp[0], Xc[0])


@pytest.mark.parametrize("where", [(0, 0, 0), (1, 17, 5), (2, 40, 15)])
def test_lstsq_info_matches_reference(where):
    rng = np.random.default_rng(13)
    A = rng.standard_normal((3, 64, N)).astype(np.float32)
    B = rng.standard_normal((3, 64, 2)).astype(np.float32)
    A[where] = np.nan
    X, info = _ref("lstsq")(jnp.asarray(A), jnp.asarray(B))
    Xp, infop = bs.lstsq(_t(A), _t(B))
    assert np.array_equal(_info(infop), _info(info))
    assert _info(infop)[where[0]] != 0


@pytest.mark.parametrize("val", [np.nan, np.inf, -np.inf])
def test_info_over_every_fault_position(val):
    """One non-finite entry at every (p, q) of an 8 x 8 problem."""
    n = 8
    base = _spd(14, batch=1, n=n)[0]
    A = np.repeat(base[None], n * n, 0)
    for e in range(n * n):
        A[e, e // n, e % n] = val
    _, info = _ref("potrf")(jnp.asarray(A))
    _, infop = bs.potrf(_t(A))
    assert np.array_equal(_info(infop), _info(info))


#: n = 40 spans three panels of the card's blocked factor (16 columns each);
#: the faults sit where blocked and column order could disagree
MP_N = 40
MP_FAULTS = {
    # (row, col) positions: the diagonal in each panel, row 0, below the
    # diagonal in the first panel, across the panel edges at 16 and 32, in
    # the last panel, the upper triangle only (the lower half the factor
    # reads clean)
    "positions": [(5, 5), (36, 36), (0, 9), (20, 7), (17, 14), (33, 30), (38, 35), (7, 20), (3, 38)],
    # a negative pivot in the first panel and in the later one
    "pivots": [(4, 4, -1.0), (35, 35, -50.0)],
}


def _mp_faults(group):
    """10 n = 40 problems of one fault group (clean problems fill the rest)."""
    A = _spd(40, batch=10, n=MP_N)
    if group in ("nan", "inf", "-inf"):
        for p, (i, j) in enumerate(MP_FAULTS["positions"]):
            A[p, i, j] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[group]
    else:
        for p, (i, j, v) in enumerate(MP_FAULTS["pivots"]):
            A[p, i, j] = v
        # finite entries near 1e20 in column 2: L[35][2]·L[35][2] overflows
        # in the trailing update, past the panel of the column that made it
        for i in (35, 37):
            A[2, i, 2] = A[2, 2, i] = 1e20
    return A


@pytest.mark.parametrize("group", ["nan", "inf", "-inf", "pivots_and_overflow"])
def test_potrf_info_multi_panel_faults(group):
    A = _mp_faults(group)
    _, info = _ref("potrf")(jnp.asarray(A))
    _, infop = bs.potrf(_t(A))
    assert np.array_equal(_info(infop), _info(info))
    k = len(MP_FAULTS["positions"]) if group != "pivots_and_overflow" else 3
    assert np.all(_info(infop)[:k] > 0) and not np.any(_info(infop)[k:])
    if group == "pivots_and_overflow":  # born at column 2, seen at 3: 2 + 3
        assert list(_info(infop)[:3]) == [5, 36, 5]


def test_potrf_envelope_unchanged():
    """The blocked kernel's tile (round4(n) rows of 16-byte-aligned
    leading dimension) takes every n the column sweep's did: 1..240."""
    e = functools.partial(bs.eligible, dtype=torch.float32, interpret=False)
    limit = 232448 - 1024
    for n in range(1, 300):
        n4 = (n + 3) // 4 * 4
        ld = bs._potrf_ld(n)
        assert ld % 4 == 0 and ld >= n4
        assert bs.smem_bytes("potrf", n, n) == 4 * n4 * ld
        assert e("potrf", (8, n, n), None) == (n <= 240) == (bs.smem_bytes("potrf", n, n) <= limit)
    assert bs.smem_bytes("potrf", 128, 128) == 4 * 128 * 132  # ld = 4 mod 8 where it fits
    assert bs._potrf_ld(240) == 240


def test_potrs_working_set_and_envelope():
    """potrs' blocked solves want 16-byte rows: round4(n) rows of the factor
    (ld) and of the right-hand sides (ldy), each padded to 4 mod 8 where the
    pair still fits; a posv or inv bucket, which may run as potrf + potrs,
    needs both kernels' working sets to fit."""
    e = functools.partial(bs.eligible, dtype=torch.float32, interpret=False)
    assert bs._potrs_lds(128, 8) == (132, 12)
    assert bs._potrs_lds(128, 128) == (132, 132)
    assert bs._potrs_lds(37, 5) == (44, 12)
    assert bs.smem_bytes("potrs", 128, 8) == 4 * 128 * (132 + 12)
    assert bs.smem_bytes("potrs", 128, 324) == 4 * 128 * (128 + 324) == 232448 - 1024
    assert e("potrs", (8, 128, 128), (8, 128, 324)) and not e("potrs", (8, 128, 128), (8, 128, 325))
    for n in range(1, 300):
        for k in (1, 8, n):
            ld, ldy = bs._potrs_lds(n, k)
            assert ld % 4 == 0 and ldy % 4 == 0 and ld >= n and ldy >= k
    # posv runs on potrs' tile; the column-sweep posv kernel would have taken
    # n = 127, k = 325 (n·odd_ld(n) + n·k floats), potrs' rows round n up to 128
    assert bs.smem_bytes("posv", 127, 325) == bs.smem_bytes("potrs", 127, 325) > 232448 - 1024
    assert 4 * (127 * 127 + 127 * 325) <= 232448 - 1024
    assert not e("posv", (8, 127, 127), (8, 127, 325)) and not e("inv", (8, 325, 325), None)
    assert e("posv", (8, 128, 128), (8, 128, 323)) and e("inv", (8, 128, 128), None)


@pytest.mark.parametrize("n", [1, 7, 33, 128, 160])
def test_posv_runs_on_the_potrs_layout(n):
    """posv's kernel holds A, then L and Lᵀ, in potrs' 16-byte-row tile
    beside the right-hand sides: its working set is potrs', and that
    working set is its envelope (the deleted column-sweep kernel's odd-ld
    layout no longer enters)."""
    e = functools.partial(bs.eligible, dtype=torch.float32, interpret=False)
    limit = 232448 - 1024
    for k in (0, 1, 3, 8, 33, n, 200, 323, 324):
        n4 = (n + 3) // 4 * 4
        assert bs.smem_bytes("posv", n, k) == bs.smem_bytes("potrs", n, k) == 4 * n4 * sum(bs._potrs_lds(n, k))
        assert e("posv", (8, n, n), (8, n, k)) == (bs.smem_bytes("potrs", n, k) <= limit)
    assert e("inv", (8, n, n), None)
    if n == 128:  # the one k where the old column-sweep edge refused what the tile takes
        assert bs.smem_bytes("posv", 128, 324) <= limit and e("posv", (8, 128, 128), (8, 128, 324))


# ---------------------------------------------------------------------------
# identity-tail exactness (bucket padding)
# ---------------------------------------------------------------------------


def test_posv_identity_tail_exact():
    A, B = _spd(15), _rhs(16, (BATCH, N, 2))
    A[2:] = np.eye(N, dtype=np.float32)
    B[2:] = 0.0
    Xp, infop = bs.posv(_t(A), _t(B))
    assert not infop.any()
    assert np.all(Xp.numpy()[2:] == 0.0)
    X, _ = _ref("posv")(jnp.asarray(A), jnp.asarray(B))
    _close(Xp, X)


def test_lstsq_identity_tail_exact():
    rng = np.random.default_rng(17)
    A = rng.standard_normal((BATCH, 64, N)).astype(np.float32)
    B = rng.standard_normal((BATCH, 64, 2)).astype(np.float32)
    A[3:] = np.eye(64, N, dtype=np.float32)
    B[3:] = 0.0
    Xp, infop = bs.lstsq(_t(A), _t(B))
    assert not infop.any()
    assert np.all(Xp.numpy()[3:] == 0.0)


def test_padded_problem_solves_exactly_to_zero_tail():
    """diag(A, I) against [B; 0]: the tail rows of X are exact zeros."""
    A = _spd(18, n=12)
    Ap = np.zeros((BATCH, N, N), np.float32)
    Ap[:, :12, :12] = A
    Ap[:, 12:, 12:] = np.eye(4)
    B = np.zeros((BATCH, N, 3), np.float32)
    B[:, :12] = _rhs(19, (BATCH, 12, 3))
    Xp, infop = bs.posv(_t(Ap), _t(B))
    assert not infop.any() and np.all(Xp.numpy()[:, 12:] == 0.0)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


def test_dispatch_constants_match_reference():
    assert bs.SMALL_N_MAX == ref.SMALL_N_MAX
    assert bs.IMPLS == ref.IMPLS
    for n in (1, 2, 3, 6, 12, 16, 24, 100, 128, 129):
        assert bs.pick_block(n) == ref.pick_block(n)
        for block in (0, 1, 3, 8):
            assert bs._resolve_block(n, block) == ref._resolve_block(n, block)


def test_dtype_capable_matches_reference():
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                 (torch.float64, jnp.float64)):
        assert bs.dtype_capable(t) == ref.dtype_capable(j)


@pytest.mark.parametrize("interpret", [True, False])
def test_default_impl_matches_reference(interpret):
    """Every bucket the kernels take on either machine resolves as the
    reference does (the card's envelope admits every n <= 128 bucket with
    k <= n)."""
    cases = []
    for n in (8, 16, 64, 100, 128, 129, 256):
        for k in (1, 8, n):
            cases += [("posv", (8, n, n), (8, n, k)), ("lstsq", (8, 4 * n, n), (8, 4 * n, k)),
                      ("inv", (8, n, n), None)]
    for op, a, b in cases:
        for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float64, jnp.float64)):
            assert (bs.default_impl(op, a, b, t, interpret=interpret)
                    == ref.default_impl(op, a, b, j, interpret=True)), (op, a, b, t)


def test_eligible_card_edges_as_documented():
    e = functools.partial(bs.eligible, dtype=torch.float32, interpret=False)
    assert e("posv", (8, 128, 128), (8, 128, 324))
    assert not e("posv", (8, 128, 128), (8, 128, 325))
    # lstsq's blocked layout: two 16-byte-row tiles (one doubles as the [A | B]
    # stage), AᵀB with round4(k) columns, a 16-column panel of G2
    assert bs.smem_bytes("lstsq", 128, 8) == 4 * (2 * 128 * 132 + 128 * 8 + 16 * 128)
    assert e("lstsq", (8, 512, 128), (8, 512, 172))
    assert not e("lstsq", (8, 512, 128), (8, 512, 173))
    assert e("lstsq", (8, 1 << 20, 128), (8, 1 << 20, 8))  # m does not enter
    assert e("posv", (8, 160, 160), (8, 160, 200))
    assert not e("posv", (8, 160, 160), (8, 160, 201))
    assert e("inv", (8, 128, 128), None) and e("potrf", (8, 240, 240), None)
    assert not e("potrf", (8, 241, 241), None)
    for n in range(1, 129):
        for op in ("posv", "lstsq"):
            assert e(op, (8, 4 * n, n), (8, 4 * n, n))
    assert bs.eligible("posv", (8, 4096, 4096), (8, 4096, 1), torch.float32, interpret=True)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def test_wrappers_raise_on_f64():
    A = _t(_spd(20).astype(np.float64))
    B = _t(_rhs(21, (BATCH, N, 1), np.float64))
    with pytest.raises(TypeError, match="bf16 or f32"):
        bs.posv(A, B)
    with pytest.raises(TypeError):
        bs.potrf(A)
    with pytest.raises(TypeError):
        bs.potrs(A, B)
    with pytest.raises(TypeError):
        bs.lstsq(A, B)
    with pytest.raises(TypeError, match="one dtype"):
        bs.posv(_t(_spd(20)), B.to(torch.bfloat16))


def test_wrappers_raise_on_bad_shapes_with_reference_messages():
    A = np.zeros((2, 4, 5), np.float32)
    with pytest.raises(ValueError) as r:
        ref.potrf(jnp.asarray(A))
    with pytest.raises(ValueError) as p:
        bs.potrf(_t(A))
    assert str(p.value) == str(r.value)
    A, B = _spd(22), np.zeros((BATCH, N + 1, 2), np.float32)
    with pytest.raises(ValueError) as r:
        ref.posv(jnp.asarray(A), jnp.asarray(B))
    with pytest.raises(ValueError) as p:
        bs.posv(_t(A), _t(B))
    assert str(p.value) == str(r.value)
    with pytest.raises(ValueError, match="tall"):
        bs.lstsq(_t(np.zeros((2, 4, 8), np.float32)), _t(np.zeros((2, 4, 1), np.float32)))
    with pytest.raises(ValueError, match="uplo"):
        bs.potrf(_t(_spd(22)), uplo="X")


def test_wrappers_raise_on_mixed_devices():
    A = _t(_spd(23))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        bs.posv(A, torch.zeros((BATCH, N, 1), device="meta"))


@pytest.mark.parametrize("uplo", ["U", "L"])
@pytest.mark.parametrize("trans", [False, True])
def test_trsm_matches_reference(uplo, trans):
    # a triangular factor from the reference potrf, garbage in its dead
    # triangle (only the live one may be read)
    R, _ = _ref("potrf", uplo=uplo)(jnp.asarray(_spd(24)))
    G = _rhs(26, (BATCH, N, N))
    T = np.asarray(R) + (np.triu(G, 1) if uplo == "L" else np.tril(G, -1))
    B = _rhs(25, (BATCH, N, 3))
    X = _ref("trsm", uplo=uplo, trans=trans)(jnp.asarray(T), jnp.asarray(B))
    Xp = bs.trsm(_t(T), _t(B), uplo=uplo, trans=trans)
    _close(Xp, X)
    op = np.triu(T) if uplo == "U" else np.tril(T)
    op = np.swapaxes(op, 1, 2) if trans else op
    _close(Xp, np.linalg.solve(op.astype(np.float64), B.astype(np.float64)), rel=1e-5)


def test_trsm_bf16_matches_reference():
    R, _ = _ref("potrf", uplo="L")(jnp.asarray(_spd(27)))
    T = np.asarray(R).astype(jnp.bfloat16)
    B = _rhs(28, (BATCH, N, 2)).astype(jnp.bfloat16)
    X = _ref("trsm", uplo="L", trans=True)(jnp.asarray(T), jnp.asarray(B))
    Xp = bs.trsm(tensor_from_numpy(T), tensor_from_numpy(B), uplo="L", trans=True)
    assert Xp.dtype == torch.bfloat16
    got, want = _f64(Xp), _f64(X)
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-5 * np.abs(want).max())


def test_trsm_envelope_and_refusals():
    # trsm runs potrs' blocked solves on potrs' tile: its working set and
    # envelope are potrs' (and posv's)
    e = functools.partial(bs.eligible, dtype=torch.float32, interpret=False)
    assert e("trsm", (8, 128, 128), (8, 128, 324)) and not e("trsm", (8, 128, 128), (8, 128, 325))
    assert bs.smem_bytes("trsm", 128, 8) == 4 * 128 * (132 + 12)
    for n in (1, 7, 33, 128, 160, 240):
        for k in (1, 8, 64, n):
            assert bs.smem_bytes("trsm", n, k) == bs.smem_bytes("potrs", n, k)
            assert e("trsm", (8, n, n), (8, n, k)) == e("potrs", (8, n, n), (8, n, k))
    with pytest.raises(TypeError):
        bs.trsm(torch.zeros((2, 4, 4), dtype=torch.float64), torch.zeros((2, 4, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="uplo"):
        bs.trsm(torch.zeros((2, 4, 4)), torch.zeros((2, 4, 1)), uplo="X")


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def test_flop_model_matches_reference():
    for n, k, m in ((16, 1, 64), (128, 8, 512), (100, 3, 400)):
        assert tracing.batched_chol_flops(n) == ref_tracing.batched_chol_flops(n)
        assert tracing.batched_trsm_flops(n, k) == ref_tracing.batched_trsm_flops(n, k)
        assert tracing.fused_posv_flops(n, k) == ref_tracing.fused_posv_flops(n, k)
        assert tracing.fused_lstsq_flops(m, n, k) == ref_tracing.fused_lstsq_flops(m, n, k)
    for tag in ("OP::batched_small", "SV::fused_posv", "SV::fused_lstsq",
                "serve::pad", "serve::solve"):
        assert tag in tracing.PHASE_REGISTRY and tag in ref_tracing.PHASE_REGISTRY


def test_recorder_prices_each_call():
    A, B = _t(_spd(26)), _t(_rhs(27, (BATCH, N, 2)))
    with tracing.Recorder() as rec:
        R, _ = bs.potrf(A)
        bs.potrs(R, B)
        bs.posv(A, B)
    assert rec.stats["OP::batched_small"].flops == BATCH * (
        tracing.batched_chol_flops(N) + 2 * tracing.batched_trsm_flops(N, 2))
    assert rec.stats["SV::fused_posv"].flops == BATCH * tracing.fused_posv_flops(N, 2)


def test_bf16_outputs_round_once():
    """bf16 storage: the plain version computes from the f32 upcast and
    rounds once on store."""
    A = _spd(28).astype(jnp.bfloat16)
    R, _ = bs.potrf(tensor_from_numpy(A))
    R32, _ = bs.potrf(tensor_from_numpy(A).float())
    assert np.array_equal(tensor_to_numpy(R), tensor_to_numpy(R32.to(torch.bfloat16)))
