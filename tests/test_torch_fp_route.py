"""The route predicate of the f32 and f64 tri_matmul and sched_matmul
kernels, on the CPU.

On the card an f64 window takes the dmma route (mma.sync on the FP64 tensor
cores) and an f32 window the fma route (pipelined IEEE FMA) when their
16-byte copies can read it: A's and B's origins 16-byte aligned and their
leading dimensions multiples of 16 bytes (`hopper._tma_ok`), and, for
sched_matmul, blocks that the route's tile divides (`hopper._sched_fits`).
Other f32 / f64 windows take the simt loop.  The route is decided in Python
before the launch from views, strides and blocks alone, so these tests pin
it without a card: every f32 / f64 call that small cholinv, rectri and mesh
factors make must be eligible, misaligned windows must not be, and a route
of another dtype is refused.
"""

import numpy as np
import pytest
import torch

from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky, inverse
from capital_tpu_torch.ops import hopper

DTYPES = {"f32": torch.float32, "f64": torch.float64}
FAST = {"f32": "fma", "f64": "dmma"}


def _spd(n, seed, dt):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(DTYPES[dt])


class _Spy:
    """Records the operands, windows and blocks of every tri_matmul /
    sched_matmul call, then runs the real wrapper."""

    def __init__(self, monkeypatch):
        self.mm, self.sched = [], []
        real_mm, real_sched = hopper.tri_matmul, hopper.sched_matmul

        def mm(A, B, **kw):
            self.mm.append((A, B, kw.get("a_view"), kw.get("b_view")))
            return real_mm(A, B, **kw)

        def sched(A, B, *s, **kw):
            self.sched.append((A, B, kw["blocks"]))
            return real_sched(A, B, *s, **kw)

        monkeypatch.setattr(hopper, "tri_matmul", mm)
        monkeypatch.setattr(hopper, "sched_matmul", sched)

    def routes(self):
        """The route each recorded call would take on the card."""
        got = []
        for A, B, av, bv in self.mm:
            ok = hopper._tma_ok(A, hopper._full_view(A, av)) and hopper._tma_ok(B, hopper._full_view(B, bv))
            got.append(hopper._pick_route(A.dtype, ok, None, "tri_matmul"))
        for A, B, blocks in self.sched:
            fast = hopper._ROUTES[A.dtype][0]
            ok = hopper._tma_ok(A, (0, 0)) and hopper._tma_ok(B, (0, 0)) and hopper._sched_fits(fast, blocks)
            got.append(hopper._pick_route(A.dtype, ok, None, "sched_matmul"))
        return got


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n,bc", [(512, 128), (768, 256)])
def test_cholinv_calls_take_the_fast_route(monkeypatch, n, bc, dt):
    spy = _Spy(monkeypatch)
    R, _ = cholesky.factor(Grid.square(device="cpu"), _spd(n, 1, dt),
                           cholesky.CholinvConfig(mode="pallas", base_case_dim=bc))
    assert R.dtype == DTYPES[dt]
    assert len(spy.mm) == 4 * (cholesky.padded_dim(n, bc) // bc - 1)  # 768 pads to 1024
    assert spy.routes() == [FAST[dt]] * len(spy.mm)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rectri_calls_take_the_fast_route(monkeypatch, dt):
    n, bc = 512, 128
    L = torch.tril(_spd(n, 2, dt) / 8 + 2 * torch.eye(n, dtype=DTYPES[dt]))
    spy = _Spy(monkeypatch)
    inverse.rectri(Grid.square(device="cpu"), L, "L", inverse.RectriConfig(base_case_dim=bc, mode="pallas"))
    assert len(spy.mm) == 2 * (n // bc - 1)
    assert spy.routes() == [FAST[dt]] * len(spy.mm)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mesh_calls_take_the_fast_route(monkeypatch, dt):
    spy = _Spy(monkeypatch)
    grid = Grid.rect(2, 2, 1, devices=["cpu"] * 4)
    cholesky.factor(grid, _spd(1024, 3, dt), cholesky.CholinvConfig(mode="explicit", base_case_dim=256))
    assert len(spy.sched) == 4 * 3 and not spy.mm
    assert spy.routes() == [FAST[dt]] * 12


@pytest.mark.parametrize("dt,aligned,asked,want", [
    ("f32", True, None, "fma"), ("f32", False, None, "simt"), ("f32", True, "simt", "simt"),
    ("f32", False, "simt", "simt"), ("f32", True, "fma", "fma"),
    ("f64", True, None, "dmma"), ("f64", False, None, "simt"), ("f64", True, "simt", "simt"),
    ("f64", False, "simt", "simt"), ("f64", True, "dmma", "dmma"),
])
def test_fp_route_choice(dt, aligned, asked, want):
    assert hopper._pick_route(DTYPES[dt], aligned, asked, "tri_matmul") == want


@pytest.mark.parametrize("dt,aligned,asked,match", [
    (torch.float32, False, "fma", "cannot take"), (torch.float64, False, "dmma", "cannot take"),
    (torch.float32, True, "dmma", "only f64"), (torch.float64, True, "fma", "only f32"),
    (torch.bfloat16, True, "dmma", "only f64"), (torch.bfloat16, True, "fma", "only f32"),
    (torch.bfloat16, True, "simt", "only f32 and f64"), (torch.float64, True, "wgmma", "only bf16"),
    (torch.float64, True, "wmma", "only bf16"), (torch.float32, True, "tf32", "unknown"),
])
def test_fp_route_choice_refuses(dt, aligned, asked, match):
    with pytest.raises(ValueError, match=match):
        hopper._pick_route(dt, aligned, asked, "tri_matmul")


@pytest.mark.parametrize("dt,off,ok", [
    (torch.float64, (0, 0), True), (torch.float64, (3, 2), True), (torch.float64, (0, 1), False),
    (torch.float64, (5, 7), False), (torch.float32, (1, 4), True), (torch.float32, (0, 6), False),
])
def test_fp_eligibility_reads_the_window_origin(dt, off, ok):
    X = torch.zeros(64, 64, dtype=dt)
    assert hopper._tma_ok(X, (*off, 8, 8)) is ok


@pytest.mark.parametrize("dt,cols,ok", [
    (torch.float64, 64, True), (torch.float64, 66, True), (torch.float64, 65, False),
    (torch.float32, 68, True), (torch.float32, 66, False),
])
def test_fp_eligibility_reads_the_row_stride(dt, cols, ok):
    X = torch.zeros(16, cols, dtype=dt)
    assert hopper._tma_ok(X, (0, 0, 4, 4)) is ok


@pytest.mark.parametrize("route,blocks,ok", [
    ("dmma", (128, 128, 32), True), ("dmma", (512, 512, 512), True), ("dmma", (128, 64, 64), False),
    ("dmma", (128, 128, 16), False), ("fma", (128, 128, 8), True), ("fma", (256, 128, 24), True),
    ("fma", (128, 64, 128), False), ("simt", (64, 64, 16), True), ("simt", (64, 64, 8), False),
])
def test_sched_tile_fits(route, blocks, ok):
    assert hopper._sched_fits(route, blocks) is ok


def test_route_codes_name_every_route():
    """Every dtype's two routes, and f32's two at precision 'high', have a C
    route code; the full-precision element-load loops share code 0, the
    fast routes and the split routes have codes of their own."""
    named = {r for rs in hopper._ROUTES.values() for r in rs} | set(hopper._SPLIT_ROUTES)
    assert named == set(hopper._ROUTE_CODE) == set(hopper._SCHED_TILE)
    fast = [hopper._ROUTE_CODE[rs[0]] for rs in hopper._ROUTES.values()]
    assert sorted(fast) == [1, 2, 3]
    assert {hopper._ROUTE_CODE[rs[1]] for rs in hopper._ROUTES.values()} == {0}
    assert [hopper._ROUTE_CODE[r] for r in hopper._SPLIT_ROUTES] == [4, 5]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_cpu_calls_move_no_counter(dt):
    """On the CPU the wrappers run the plain versions, whatever route the
    shape would pick on the card: counts() keeps its keys at 0 and the
    route tally stays empty."""
    hopper.reset_counts()
    A = torch.randn(256, 256).to(DTYPES[dt])
    hopper.tri_matmul(A, A, a_uplo="U")
    hopper.tri_matmul(A, A, a_view=(0, 1, 255, 255), b_view=(0, 1, 255, 255), out_uplo="L",
                      a_trans=True)
    c = hopper.counts()
    assert set(c) == set(hopper.KERNELS)
    assert all(type(v) is int and v == 0 for v in c.values())
    assert hopper.route_counts() == {}
