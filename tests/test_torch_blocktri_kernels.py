"""The block-tridiagonal scan-step kernels of the port
(capital_tpu_torch/ops/blocktri_small.py) against the JAX package's Pallas
kernels (capital_tpu/ops/blocktri_small.py) in interpret mode.

On the CPU the port's wrappers run their plain versions, so this holds the
plain versions to the reference; tests/test_torch_gpu.py holds the CUDA
kernels to the plain versions on the card.  Operands are made with numpy
from a seed and handed to both packages; the reference steps are jitted
once per shape at module level (interpret-mode Pallas compiles in seconds,
so every test here shares one geometry: batch 2, seg 3, b 4, k 2).

Tolerances, relative to the largest |reference| entry: f32 1e-5 (IEEE f32
in both, sums in another order), bf16 2e-2 (both compute in f32 and round
each block's outputs once; the carried factor is rounded between blocks on
neither side).  `info` is compared exactly, per chain block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import blocktri_small as ref
from capital_tpu_torch.ops import blocktri_small as bt
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.utils.interop import tensor_from_numpy

BATCH, SEG, B, K = 2, 3, 4, 2
TOL = {np.float32: 1e-5, jnp.bfloat16: 2e-2}
STEPS = ("fused_forward_step", "factor_step", "forward_solve_step", "solve_backward_step")


@functools.lru_cache(maxsize=None)
def _ref(name):
    return jax.jit(functools.partial(getattr(ref, name), interpret=True))


def _operands(seed, dtype=np.float32):
    """One step's operands: an SPD chain segment (gram/b + 3I diagonals,
    0.3/√b couplings), a random right-hand side and random carries — the
    carried factor a lower-triangular L with a dominant diagonal."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((BATCH, SEG, B, B))
    D = G @ G.transpose(0, 1, 3, 2) / B + 3.0 * np.eye(B)
    C = 0.3 / np.sqrt(B) * rng.standard_normal((BATCH, SEG, B, B))
    Rhs = rng.standard_normal((BATCH, SEG, B, K))
    Lc = np.tril(0.2 * rng.standard_normal((BATCH, B, B)), -1) + np.eye(B) * (1.5 + rng.random((BATCH, 1, B)))
    yc = rng.standard_normal((BATCH, B, K))
    Lf = np.tril(0.2 * rng.standard_normal((BATCH, SEG, B, B)), -1) + 2.0 * np.eye(B)
    return {n: x.astype(dtype) for n, x in dict(D=D, C=C, B=Rhs, Lc=Lc, yc=yc, L=Lf).items()}


def _args(name, o):
    return {"fused_forward_step": ("D", "C", "B", "Lc", "yc"), "factor_step": ("D", "C", "Lc"),
            "forward_solve_step": ("L", "C", "B", "yc"),
            "solve_backward_step": ("L", "C", "B", "yc")}[name]


def _run_both(name, o):
    keys = _args(name, o)
    want = _ref(name)(*(jnp.asarray(o[k]) for k in keys))
    got = getattr(bt, name)(*(tensor_from_numpy(np.asarray(o[k])) for k in keys))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], list(got)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, tol):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", STEPS)
def test_step_matches_reference(name, dtype):
    o = _operands(1, dtype)
    want, got = _run_both(name, o)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == np.int32:
            assert np.array_equal(g.numpy(), w) and not w.any()
        else:
            assert g.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
            _close(g, w, TOL[dtype])


def test_factor_representation():
    # L masked lower (zeros above the diagonal), Wt_1 = 0 from an identity
    # carry and a zero first coupling, and the fused step's factor equals
    # the factor-only step's bitwise
    o = _operands(2)
    o["C"][:, 0] = 0
    o["Lc"] = np.broadcast_to(np.eye(B, dtype=np.float32), (BATCH, B, B)).copy()
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    L, Wt, info = bt.factor_step(t["D"], t["C"], t["Lc"])
    Lf, Wtf, _, infof = bt.fused_forward_step(t["D"], t["C"], t["B"], t["Lc"], t["yc"])
    assert torch.equal(L, Lf) and torch.equal(Wt, Wtf) and torch.equal(info, infof)
    assert torch.equal(L, torch.tril(L)) and not Wt[:, 0].any()
    # S_1 = D_1 exactly: L_1·L_1ᵀ rebuilds it
    assert torch.allclose(L[:, 0] @ L[:, 0].mT, t["D"][:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fault", ["nan", "-inf", "indefinite", "nan_coupling"])
def test_faults_flag_only_their_problem(fault):
    # a fault in problem 1's chain block 1: the per-block info equals the
    # reference's exactly, problem 0 is untouched
    o = _operands(3)
    clean = _run_both("fused_forward_step", o)[1]
    if fault == "nan":
        o["D"][1, 1, 2, 1] = np.nan
    elif fault == "-inf":
        o["D"][1, 1, 0, 0] = -np.inf
    elif fault == "indefinite":
        o["D"][1, 1] = np.diag([1.0, -5.0, 1.0, 1.0]).astype(np.float32)
        o["C"][1, 1] = 0
    else:
        o["C"][1, 1, 3, 2] = np.nan
    want, got = _run_both("fused_forward_step", o)
    assert np.array_equal(got[3].numpy(), want[3])
    assert got[3][1].any() and not got[3][0].any() and not got[3][1, 0].any()
    for g, c in zip(got[:3], clean[:3]):
        assert torch.equal(g[0], c[0])
    if fault == "indefinite":
        assert got[3][1, 1] == 2  # the exact local pivot
    # factor_step flags the same blocks
    L, Wt, info = bt.factor_step(*(torch.from_numpy(o[k]) for k in ("D", "C", "Lc")))
    assert torch.equal(info, got[3])


def test_plain_versions_are_the_wrappers_on_the_cpu():
    o = _operands(4)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    hopper.reset_counts()
    for name in STEPS:
        args = [t[k] for k in _args(name, o)]
        w = getattr(bt, name)(*args)
        p = getattr(bt, name + "_plain")(*args)
        for a, c in zip(w if isinstance(w, tuple) else (w,), p if isinstance(p, tuple) else (p,)):
            assert torch.equal(a, c)
    assert not any(hopper.counts().values())


def test_wrappers_refuse():
    o = _operands(5)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    with pytest.raises(TypeError, match="bf16 or f32"):
        bt.factor_step(t["D"].double(), t["C"].double(), t["Lc"].double())
    with pytest.raises(TypeError, match="one dtype"):
        bt.factor_step(t["D"], t["C"].bfloat16(), t["Lc"])
    with pytest.raises(ValueError, match="carry Lc"):
        bt.factor_step(t["D"], t["C"], t["Lc"][:1])
    with pytest.raises(ValueError, match="must be \\(batch, seg, b, b\\)"):
        bt.forward_solve_step(t["L"][..., :3], t["C"], t["B"], t["yc"])
    with pytest.raises(ValueError, match="B must be"):
        bt.fused_forward_step(t["D"], t["C"], t["B"][:, :2], t["Lc"], t["yc"])


def test_envelope_admits_every_ladder_width():
    # b <= 128: the serve ladders (k <= 64, k + s <= 96) and the Spike
    # widths k + 2b, k + s + 2b all take the kernels on the card
    for b in (16, 32, 64, 128):
        for k in (1, 2, 33, 64, 96, 64 + 2 * b, 96 + 2 * b):
            assert bt.step_eligible(b, k, 8, torch.float32, interpret=False)
            assert bt.default_impl(b, k, 8, torch.bfloat16, interpret=False) == "pallas"
        assert bt.partition_inner_impl(b, 64, 8, torch.float32, interpret=False) == "pallas"
    # the factor steps' blocked route: three tiles of 128 rows of 132 floats;
    # the fused step's stage lies over L_{i−1}'s tile and past it, two
    # buffers of 128 rows of 92 floats at k = 257, as the solve steps' stage
    assert bt.smem_bytes("factor", 128, 0) == 202_752
    assert bt.stage_cols("fused_forward", 128, 257) == 92
    assert bt.smem_bytes("fused_forward", 128, 257) == 4 * (2 * 128 * 132 + 2 * 128 * 92) == 229_376
    assert bt.smem_bytes("fused_forward", 128, 1) == 202_752
    assert bt.stage_cols("fused_forward", 64, 64) == 64
    assert bt.stage_cols("solve_backward", 128, 257) == 92
    for kernel in ("factor", "fused_forward", "forward_solve", "solve_backward"):
        assert bt.smem_bytes(kernel, 128, 257) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    # the largest chain block the fused step takes, and f64 never
    assert bt.step_eligible(138, 1, 8, torch.float32, interpret=False)
    assert not bt.step_eligible(140, 1, 8, torch.float32, interpret=False)
    assert bt.default_impl(140, 1, 8, torch.float32, interpret=False) == "xla"
    # each route asks for the kernel it launches: the two-tile sweeps of
    # solve go further than the fused step of posv
    assert bt.step_eligible(138, 0, 8, torch.float32, interpret=False, kernel="factor")
    assert bt.step_eligible(168, 1, 8, torch.float32, interpret=False, kernel="forward_solve")
    assert not bt.step_eligible(168, 1, 8, torch.float32, interpret=False)
    assert bt.default_impl(16, 1, 8, torch.float64, interpret=False) == "xla"


#: b -> (route, ld, factor step bytes, fused step stage columns at k = 257)
CHAIN_LAYOUTS = {2: ("blocked", 4, 4 * 3 * 4 * 4, 257), 7: ("blocked", 12, 4 * 3 * 8 * 12, 257),
                 16: ("blocked", 20, 4 * 3 * 16 * 20, 257), 128: ("blocked", 132, 202_752, 92),
                 136: ("blocked", 140, 228_480, 68), 137: ("sweep", 137, 225_228, 5),
                 138: ("sweep", 139, 230_184, 1)}


@pytest.mark.parametrize("b", sorted(CHAIN_LAYOUTS))
def test_chain_route_and_layout(b):
    """The factor steps' two routes: 'blocked' (16-byte-row tiles, ld 4 mod
    8, plus one staged column) up to b = 136, 'sweep' (odd-ld tiles) at 137
    and 138; smem_bytes and stage_cols mirror the kernel's layout, and the
    envelope (step_eligible, default_impl) is the same on both sides of
    the switch."""
    route, ld, factor_bytes, kc = CHAIN_LAYOUTS[b]
    assert bt.chain_route(b) == bt.chain_route(b, "fused_forward") == route
    b4 = (b + 3) // 4 * 4
    assert (bt._blocked_ld(b) if route == "blocked" else bt._odd_ld(b)) == ld
    if route == "blocked":
        assert ld % 4 == 0 and (ld // 4) % 2 == 1 and ld >= b4
        assert factor_bytes == 4 * 3 * b4 * ld
    else:
        assert 4 * (3 * b4 * bt._blocked_ld(b) + 2 * b) > hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
        assert factor_bytes == 4 * 3 * b * ld
    assert bt.smem_bytes("factor", b, 0) == factor_bytes
    assert bt.stage_cols("fused_forward", b, 257) == kc
    if route == "blocked":
        # the fused step's stage (two buffers of round4(b) rows of
        # _blocked_ld(kc) floats) lies over L_{i−1}'s tile and past it
        tile, stage = b4 * ld, 2 * b4 * bt._blocked_ld(kc)
        assert bt.smem_bytes("fused_forward", b, 257) == 4 * (2 * tile + max(tile, stage))
    else:
        assert bt.smem_bytes("fused_forward", b, 257) == factor_bytes + 4 * 2 * b * kc
    for kernel in ("fused_forward", "factor"):
        assert bt.step_eligible(b, 1, 8, torch.float32, interpret=False, kernel=kernel)
        assert bt.default_impl(b, 1, 8, torch.float32, interpret=False, kernel=kernel) == "pallas"
    # the solve steps take the blocked route up to b = 164, on 16-byte-row
    # tiles: two tiles and a stage of two round4(b)-row buffers
    assert bt.chain_route(b, "forward_solve") == bt.chain_route(b, "solve_backward") == "blocked"
    assert bt.smem_bytes("forward_solve", b, 1) == 4 * (2 * b4 * bt._blocked_ld(b) + 2 * b4 * 4)


#: b -> (solve steps' route, ld, bytes at k = 1, stage columns at k = 257,
#: bytes at k = 257), both steps alike
SOLVE_LAYOUTS = {2: ("blocked", 4, 256, 257, 8_448), 16: ("blocked", 20, 3_072, 257, 35_840),
                 37: ("blocked", 44, 15_360, 257, 97_280), 50: ("blocked", 52, 23_296, 257, 129_792),
                 128: ("blocked", 132, 139_264, 92, 229_376), 136: ("blocked", 140, 156_672, 68, 226_304),
                 164: ("blocked", 164, 220_416, 12, 230_912), 165: ("sweep", 165, 219_120, 10, 231_000),
                 169: ("sweep", 169, 229_840, 2, 231_192)}


@pytest.mark.parametrize("kernel", ["forward_solve", "solve_backward"])
@pytest.mark.parametrize("b", sorted(SOLVE_LAYOUTS))
def test_solve_route_and_layout(b, kernel):
    """The solve steps' two routes: 'blocked' (two 16-byte-row tiles of
    round4(b) rows, ld 4 mod 8, and a stage of two round4(b)-row buffers of
    _blocked_ld(kc) floats) up to b = 164, 'sweep' (two odd-ld tiles and a
    stage of 2·b·kc floats, the kernels the blocked route replaced) from
    165 to 169; smem_bytes and stage_cols mirror the kernel's layout, and
    the 'sweep' numbers are the ones the sweeps always had."""
    route, ld, bytes1, kc, bytes257 = SOLVE_LAYOUTS[b]
    b4 = (b + 3) // 4 * 4
    assert bt.chain_route(b, kernel) == route
    assert bt.stage_cols(kernel, b, 1) == 1 and bt.stage_cols(kernel, b, 257) == kc
    assert bt.smem_bytes(kernel, b, 1) == bytes1 and bt.smem_bytes(kernel, b, 257) == bytes257
    if route == "blocked":
        assert bt._blocked_ld(b) == ld and ld % 4 == 0 and (ld // 4) % 2 == 1
        assert bytes257 == 4 * (2 * b4 * ld + 2 * b4 * bt._blocked_ld(kc))
        assert bt._blocked_ld(kc) % 4 == 0 and (bt._blocked_ld(kc) // 4) % 2 == 1
        # the widest stage that fits: one more 4-column group would not
        wider = bt._blocked_ld(bt._round4(kc) + 1)
        assert kc == 257 or 4 * (2 * b4 * ld + 2 * b4 * wider) > hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    else:
        assert bt._odd_ld(b) == ld and bytes257 == 4 * (2 * b * ld + 2 * b * kc)
        # the blocked layout does not fit a single 4-column group here
        assert 4 * (2 * b4 * bt._blocked_ld(b) + 8 * b4) > hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    # the sweep layout through the route keyword of the helpers, as a
    # check of the other route through the C entry computes it
    assert bt._smem_bytes(kernel, b, 1, 1, "sweep") == 4 * (2 * b * bt._odd_ld(b) + 2 * b)
    assert bt.smem_bytes(kernel, b, 257) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE


def _parent_solve_fits(b: int) -> bool:
    """The solve steps' envelope before their blocked route: two odd-ld
    tiles and one staged column of the two-buffer stage."""
    budget = hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE
    return budget - 4 * 2 * b * bt._odd_ld(b) >= 8 * b


@pytest.mark.parametrize("kernel", ["forward_solve", "solve_backward"])
def test_solve_envelope_is_the_parents(kernel):
    """step_eligible and default_impl admit every (b, k) of the solve steps
    that they admitted before the blocked route, and no other: b <= 169
    whatever k, on one route or the other."""
    for b in range(1, 201):
        want = _parent_solve_fits(b)
        assert want == (b <= 169)
        for k in (1, 2, 3, 33, 64, 257, 4096):
            assert bt.step_eligible(b, k, 8, torch.float32, interpret=False, kernel=kernel) == want
            assert bt.default_impl(b, k, 8, torch.float32, interpret=False,
                                   kernel=kernel) == ("pallas" if want else "xla")
        if want:
            assert bt.chain_route(b, kernel) == ("blocked" if b <= 164 else "sweep")


#: (kernel, batch, b, k) -> column splits: phase 13's scan-step geometries
#: (chip_smoke.BT_GEOMS), the blocktri flagship's steps (1 problem, k = 1)
#: and the partitioned flagship's interior steps (8 problems, k + 2b = 257)
SPLITS = {("forward_solve", 8, 128, 1): 1, ("forward_solve", 8, 128, 64): 16,
          ("forward_solve", 8, 128, 33): 8, ("forward_solve", 8, 128, 257): 16,
          ("forward_solve", 16, 16, 34): 8, ("forward_solve", 264, 128, 1): 1,
          ("forward_solve", 264, 128, 33): 1, ("solve_backward", 1, 128, 1): 1,
          ("solve_backward", 8, 128, 257): 16, ("solve_backward", 16, 16, 34): 8,
          ("solve_backward", 2, 128, 3): 1, ("solve_backward", 128, 128, 257): 1,
          ("solve_backward", 1, 165, 257): 1, ("fused_forward", 8, 128, 257): 16,
          ("fused_forward", 1, 128, 1): 1, ("fused_forward", 264, 128, 33): 1,
          ("fused_forward", 16, 16, 34): 8, ("fused_forward", 8, 137, 257): 1,
          ("factor", 8, 128, 0): 1}


@pytest.mark.parametrize("geom", sorted(SPLITS), ids=lambda g: "-".join(map(str, g)))
def test_rhs_splits_rule(geom):
    """The column split fills the card's SMS SMs with no CUDA block
    narrower than one 4-column group (splits <= k // 4), 1 once the batch
    fills them, for the factor step and on the 'sweep' route (b = 165 for
    the solve steps, 137 for the fused step); every block's range is
    non-empty and the ranges tile [0, k)."""
    kernel, batch, b, k = geom
    s = bt.rhs_splits(kernel, batch, b, k)
    assert s == SPLITS[geom]
    assert batch * s <= max(bt.SMS, batch) and (s == 1 or k // s >= 4)
    if kernel != "factor":
        cols = [(i * k // s, (i + 1) * k // s) for i in range(s)]
        assert cols[0][0] == 0 and cols[-1][1] == k and all(lo < hi for lo, hi in cols)
        assert all(a[1] == c[0] for a, c in zip(cols, cols[1:]))
        kc = bt.stage_cols(kernel, b, k, s)
        assert 1 <= kc <= -(-k // s)
        assert bt.smem_bytes(kernel, b, k, s) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE


@pytest.mark.parametrize("dt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                                    (torch.float64, jnp.float64)], ids=["f32", "bf16", "f64"])
def test_dispatch_matches_reference_in_interpret_mode(dt, jdt):
    for b, k in ((4, 1), (16, 8), (128, 64)):
        assert bt.default_impl(b, k, 8, dt, interpret=True) == ref.default_impl(b, k, 8, jdt,
                                                                                  interpret=True)
        assert bt.partition_inner_impl(b, k, 8, dt, interpret=True) == \
            ref.partition_inner_impl(b, k, 8, jdt, interpret=True)
    assert bt.dtype_capable(dt) == ref.dtype_capable(jdt)
