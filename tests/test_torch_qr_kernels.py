"""The port's CholeskyQR2 kernels (capital_tpu_torch/ops/qr_fused.py) against
the JAX package's Pallas kernels (capital_tpu/ops/qr_fused.py).

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernels run in interpret mode, so this holds the plain versions to
the reference (tests/test_torch_gpu.py holds the CUDA kernels to the plain
versions on the card).  Operands are made with numpy from a seed and handed
to both packages; bf16 crosses bitwise.

Tolerances, relative to the largest |reference| entry unless stated:
* f64 1e-12 and f32 1e-5: the two sides sum in different orders;
* bf16 Q within one bf16 ulp of each entry plus 1e-5: both sides sum the
  exact bf16 products in f32 and round once, and a sum that differs in its
  last f32 bits may round to the neighbouring bf16;
* G from bf16 input, relative Frobenius: 1e-5 for gram_blocked (exact
  products, f32 sums), 1e-3 for scale_gram (the grams of two Qs that may
  differ by an ulp).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import qr_fused as jq
from capital_tpu.parallel.topology import Grid as JGrid
from capital_tpu_torch import Grid
from capital_tpu_torch.ops import _build, hopper
from capital_tpu_torch.ops import qr_fused as tq
from capital_tpu_torch.utils.interop import tensor_from_numpy

DTYPES = {
    "f64": (np.float64, torch.float64),
    "f32": (np.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
}
# (m, n, g): the g=4 and g=2 splits of n=512 and the flagship's g=8 split
SHAPES = [(2048, 512, 4), (1024, 512, 2), (1024, 1024, 8)]
REL = {"f64": 1e-12, "f32": 1e-5}


def _ids(s):
    return "x".join(map(str, s))


def _operands(m, n, dt, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(DTYPES[dt][0])
    Rinv = np.triu(0.1 * rng.standard_normal((n, n)) / np.sqrt(n) + np.eye(n)).astype(DTYPES[dt][0])
    return A, Rinv


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _assert_q(got, want, dt):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dt == "bf16":
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-5 * scale)
    else:
        assert np.abs(got - want).max() <= REL[dt] * scale


def _assert_g(got, want, dt, bf16_rel):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    if dt == "bf16":
        assert np.linalg.norm(got - want) <= bf16_rel * np.linalg.norm(want)
    else:
        assert np.abs(got - want).max() <= REL[dt] * np.abs(want).max()


def _dead(n, g):
    t = np.arange(n) // (n // g)
    return t[:, None] > t[None, :]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_gram_blocked_plain_vs_pallas(shape, dt):
    m, n, g = shape
    A, _ = _operands(m, n, dt)
    want = jq.gram_blocked(jnp.asarray(A), g=g)
    got = tq.gram_blocked(tensor_from_numpy(A), g=g)
    assert got.dtype == (torch.float64 if dt == "f64" else torch.float32)
    _assert_g(got, want, dt, bf16_rel=1e-5)
    assert np.all(_f64(got)[_dead(n, g)] == 0) and np.all(_f64(want)[_dead(n, g)] == 0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scale_blocked_plain_vs_pallas(shape, dt):
    m, n, g = shape
    A, Rinv = _operands(m, n, dt, seed=1)
    want = jq.scale_blocked(jnp.asarray(A), jnp.asarray(Rinv), g=g)
    got = tq.scale_blocked(tensor_from_numpy(A), tensor_from_numpy(Rinv), g=g)
    assert got.dtype == DTYPES[dt][1]
    _assert_q(got, want, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_scale_gram_plain_vs_pallas(shape, dt):
    m, n, g = shape
    A, Rinv = _operands(m, n, dt, seed=2)
    Qj, Gj = jq.scale_gram(jnp.asarray(A), jnp.asarray(Rinv), g=g)
    Qt, Gt = tq.scale_gram(tensor_from_numpy(A), tensor_from_numpy(Rinv), g=g)
    _assert_q(Qt, Qj, dt)
    _assert_g(Gt, Gj, dt, bf16_rel=1e-3)
    assert np.all(_f64(Gt)[_dead(n, g)] == 0)
    # the gram is of the ROUNDED Q: exactly the plain gram of the returned Q
    assert torch.equal(Gt, tq.gram_blocked_plain(Qt, g=g))


# shapes every fused kernel refuses, each for its own reason
GATE_CASES = {
    "g2_needs_half_256": (1024, 256, 2),
    "bm_does_not_tile_m": (1000, 512, 2),
    "n_not_g128_aligned": (1024, 384, 4),
}


@pytest.mark.parametrize("fn", ["gram_blocked", "scale_blocked", "scale_gram"])
@pytest.mark.parametrize("case", list(GATE_CASES))
def test_shape_gate_errors_match(case, fn):
    m, n, g = GATE_CASES[case]
    A = np.zeros((m, n), np.float32)
    args = (A,) if fn == "gram_blocked" else (A, np.zeros((n, n), np.float32))
    with pytest.raises(ValueError) as want:
        getattr(jq, fn)(*(jnp.asarray(a) for a in args), g=g)
    with pytest.raises(ValueError) as got:
        getattr(tq, fn)(*(torch.from_numpy(a) for a in args), g=g)
    assert str(got.value) == str(want.value)


def test_rinv_shape_error_matches():
    A, R = np.zeros((1024, 512), np.float32), np.zeros((256, 256), np.float32)
    with pytest.raises(ValueError) as want:
        jq.scale_gram(jnp.asarray(A), jnp.asarray(R), g=2)
    with pytest.raises(ValueError) as got:
        tq.scale_gram(torch.from_numpy(A), torch.from_numpy(R), g=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [128, 192, 256, 384, 512, 768, 1024, 2048, 4096])
@pytest.mark.parametrize("override", [0, 2, 4, 8])
def test_pick_g_agrees(n, override):
    assert tq.pick_g(n, override) == jq.pick_g(n, override)


@pytest.mark.parametrize("m", [1000, 1024, 1536, 65536])
@pytest.mark.parametrize("n,g", [(256, 2), (512, 2), (512, 4), (768, 2), (1024, 8), (4096, 32)])
@pytest.mark.parametrize("bm", [1024, 512])
def test_eligible_agrees(m, n, g, bm):
    assert tq._eligible(m, n, bm, g) == jq._eligible(m, n, bm, g)
    assert tq.live_fraction(g) == jq.live_fraction(g)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("m,n,g", [(1 << 21, 1024, 8), (65536, 4096, 32), (1000, 512, 2),
                                   (1024, 192, 2), (65536, 512, 4)])
def test_fused_plan_agrees_in_interpret_mode(m, n, g, mode):
    jgrid = JGrid.square(c=1, devices=jax.devices("cpu")[:1])
    want = jq.fused_plan(jgrid, m, n, mode, g=g, dtype=jnp.bfloat16)
    got = tq.fused_plan(Grid.square(device="cpu"), m, n, mode, g=g, dtype=torch.bfloat16)
    assert got == want
    assert tq.fused_ok(Grid.square(device="cpu"), m, n, mode, g=g, dtype=torch.bfloat16) == (
        want is not None
    )


def test_assemble_sym_agrees():
    A, _ = _operands(1024, 512, "f64", seed=3)
    Gu = jq.gram_blocked(jnp.asarray(A), g=4)
    want = np.asarray(jq.assemble_sym(Gu, 128))
    got = tq.assemble_sym(tq.gram_blocked(tensor_from_numpy(A), g=4), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, A.T @ A, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("m,n,g,dt,want", [
    (1 << 21, 1024, 8, torch.bfloat16, 11),  # 36 live 128-tiles x 11 = 3 whole waves of 132
    (65536, 4096, 32, torch.bfloat16, 1),  # 528 live tiles are 4 whole waves alone
    (2048, 512, 2, torch.bfloat16, 11),  # 12 tiles x 11 = one wave; splits of 2 and 3 k-tiles
    (256, 512, 4, torch.bfloat16, 4),  # capped at one split per 64-row k-tile
    (65536, 512, 4, torch.float32, 26),  # 10 tiles x 26 = 260 of the FMA loop's 264 slots
    (65536, 1024, 8, torch.float32, 22),  # 36 x 22 = 792 = 3 whole waves of 264
    (128, 512, 4, torch.float32, 2),  # capped at one split per 64-row k-tile
    (2048, 512, 2, torch.float32, 22),  # 12 x 22 = one wave of 264
    (65536, 512, 4, torch.float64, 13),  # 10 x 13 = 130: one wave of the DMMA loop's 132
    (1 << 21, 1024, 8, torch.float64, 11),  # 3 whole waves of 132, as bf16
    (128, 512, 4, torch.float64, 2),
])
def test_gram_splits(m, n, g, dt, want):
    """One split rule for every dtype: whole non-empty 64-row k-tiles, the
    fewest waves of the dtype's block slots per split."""
    s = tq.gram_splits(m, n, g, dt)
    assert s == want
    assert all(r1 > r0 and r0 % 64 == 0 for r0, r1 in tq.gram_split_rows(m, s))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("n,g", [(512, 2), (512, 4), (1024, 8), (2048, 4), (4096, 32)])
def test_gram_tiles_visit_every_live_tile_once(n, g, dt):
    """The gram grid's tiles are exactly the tiles of the upper block-row
    form, each once: a tile is live iff its columns start at or after its
    block row's first column.  With the dtype's row splits at m = 65536, the
    (tile, split) grid sums every live tile over every row of A once."""
    T = tq._GRAM_TILE
    tiles = tq.gram_tiles(n, g)
    assert len(tiles) == len(set(tiles))
    live = np.zeros((n, n), bool)
    for i, j in tiles:
        live[i * T:(i + 1) * T, j * T:(j + 1) * T] = True
    assert np.array_equal(live, ~_dead(n, g))
    assert tiles == sorted(tiles)  # row by row: the kernel's block order
    m = 65536
    rows = np.zeros((n // T, n // T), np.int64)
    for r0, r1 in tq.gram_split_rows(m, tq.gram_splits(m, n, g, dt)):
        for i, j in tiles:
            rows[i, j] += r1 - r0
    assert np.array_equal(rows, np.where(live[::T, ::T], m, 0))


@pytest.mark.parametrize("m,splits", [(128, 1), (128, 2), (2048, 11), (8192 + 128, 11), (8192 + 128, 13),
                                      (65536, 11), (65536, 16), (1 << 21, 11), (1 << 21, 16),
                                      (65536, 13), (65536, 26), (8192 + 128, 22), (1 << 21, 22)])
def test_gram_split_rows_cover_every_row_once(m, splits):
    """Every row of A in exactly one split, splits in row order, each a run
    of whole 64-row k-tiles whose counts differ by at most one (the rule of
    every dtype's gram kernel)."""
    rows = tq.gram_split_rows(m, splits)
    assert rows[0][0] == 0 and rows[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    sizes = [r1 - r0 for r0, r1 in rows]
    assert all(r0 % 64 == 0 for r0, _ in rows) and max(sizes) - min(sizes) <= 64 and min(sizes) > 0


@pytest.mark.parametrize("dt,want", [(torch.bfloat16, "wgmma"), (torch.float32, "fma"),
                                     (torch.float64, "dmma")])
def test_route_is_the_dtype_fast_route(dt, want):
    """Every launch of a dtype is tallied on its fast route: the wgmma ring
    (bf16), the FMA loop (f32), the DMMA loop (f64)."""
    assert tq._route(torch.empty((128, 128), dtype=dt)) == want == hopper._ROUTES[dt][0]


def _csrc_int(name: str, src: str) -> int:
    """The integer a `constexpr int` names in ops/csrc/<src>."""
    m = re.search(r"constexpr int (?:\w+ = \w+, )*" + name + r" = (\d+)", (_build.CSRC / src).read_text())
    assert m, (name, src)
    return int(m.group(1))


@pytest.mark.parametrize("dt,kernel", [(torch.bfloat16, "gram_wgmma"), (torch.float32, "gram_fma"),
                                       (torch.float64, "gram_dmma")])
def test_blocks_per_sm_mirror_the_gram_kernels_launch_bounds(dt, kernel):
    """The split rule's block slots an SM are the gram kernel's own
    `__launch_bounds__` minimum (a literal, or mm_tiles.cuh's D_MINB /
    F_MINB): the split count is chosen for the occupancy the kernel has."""
    text = (_build.CSRC / "qr_fused.cu").read_text()
    m = re.search(r"__launch_bounds__\([\w:]+, ([\w:]+)\)\s+" + kernel + r"\(", text)
    assert m, kernel
    minb = m.group(1)
    want = int(minb) if minb.isdigit() else _csrc_int(minb.removeprefix("mmt::"), "mm_tiles.cuh")
    assert tq._BLOCKS_PER_SM[dt] == want


@pytest.mark.parametrize("mirror,name", [("_GRAM_TILE", "TILE"), ("_SPLIT_ROWS", "SPLIT_ROWS")])
def test_host_mirrors_match_the_kernel_constants(mirror, name):
    """The host's tile edge and split k-tile rows are the kernel file's."""
    assert getattr(tq, mirror) == _csrc_int(name, "qr_fused.cu")


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    A, R = (tensor_from_numpy(x) for x in _operands(1024, 512, "f32", seed=4))
    hopper.reset_counts()
    assert torch.equal(tq.gram_blocked(A, g=2), tq.gram_blocked_plain(A, g=2))
    assert torch.equal(tq.scale_blocked(A, R, g=2), tq.scale_blocked_plain(A, R, g=2))
    for got, want in zip(tq.scale_gram(A, R, g=2), tq.scale_gram_plain(A, R, g=2)):
        assert torch.equal(got, want)
    assert all(v == 0 for v in hopper.counts().values())
    names = ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked")
    lines = ("181", "260", "328")
    for name, line in zip(names, lines):
        k = hopper.KERNELS[name]
        assert k.replaces == "capital_tpu/ops/qr_fused.py:" + line
        assert k.source == "capital_tpu_torch/ops/csrc/qr_fused.cu" and k.route == "cuda"
