"""The route predicate of the bf16 tri_matmul and sched_matmul kernels, on
the CPU.

On the card a bf16 window takes the wgmma route (TMA + wgmma) when TMA can
read it: a 16-byte-aligned origin and a leading dimension that is a
multiple of 16 bytes (`hopper._tma_ok`); other bf16 windows take the wmma
route.  The route is decided in Python before the launch, from the views
and strides alone, so these tests pin it without a card: every call that a
small cholinv, rectri and mesh factor make must be eligible, an odd offset
must not be, and the launch counters keep their keys.
"""

import numpy as np
import pytest
import torch

from capital_tpu_torch import Grid
from capital_tpu_torch.models import cholesky, inverse
from capital_tpu_torch.ops import hopper

#: every kernel's launch counter, as `hopper.counts()` has named them since
#: the last TPU kernel was ported
COUNTER_KEYS = {
    "tri_matmul.trmm", "tri_matmul.syrk", "tri_matmul.dense", "transpose", "transpose_pair",
    "zeros_dead_lower", "write_diag_blocks", "fused_tail", "qr.gram_blocked", "qr.scale_gram",
    "qr.scale_blocked", "small.potrf", "small.potrs", "small.posv", "small.lstsq", "small.trsm",
    "tsqr.panel_qr", "bt.fused_forward", "bt.factor", "bt.forward_solve", "bt.solve_backward",
    "up.sweep", "sched_matmul",
}


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return torch.from_numpy(g @ g.T / n + 3 * np.eye(n)).to(torch.bfloat16)


class _Spy:
    """Records the operands and windows of every tri_matmul / sched_matmul
    call, then runs the real wrapper."""

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

    def ineligible(self):
        bad = [(A.shape, A.stride(), av, B.shape, B.stride(), bv) for A, B, av, bv in self.mm
               if not (hopper._tma_ok(A, hopper._full_view(A, av))
                       and hopper._tma_ok(B, hopper._full_view(B, bv)))]
        bad += [(A.shape, B.shape, blocks) for A, B, blocks in self.sched
                if not (hopper._tma_ok(A, (0, 0)) and hopper._tma_ok(B, (0, 0))
                        and blocks[2] % hopper._WGMMA_BK == 0)]
        return bad


@pytest.mark.parametrize("n,bc", [(1024, 128), (768, 256)])
def test_cholinv_calls_are_tma_eligible(monkeypatch, n, bc):
    spy = _Spy(monkeypatch)
    cholesky.factor(Grid.square(device="cpu"), _spd(n, 1),
                    cholesky.CholinvConfig(mode="pallas", base_case_dim=bc))
    assert len(spy.mm) == 4 * (cholesky.padded_dim(n, bc) // bc - 1)  # 768 pads to 1024
    assert spy.ineligible() == []


def test_rectri_calls_are_tma_eligible(monkeypatch):
    n, bc = 1024, 128
    L = torch.tril(_spd(n, 2).float() / 8 + 2 * torch.eye(n)).to(torch.bfloat16)
    spy = _Spy(monkeypatch)
    inverse.rectri(Grid.square(device="cpu"), L, "L", inverse.RectriConfig(base_case_dim=bc, mode="pallas"))
    assert len(spy.mm) == 2 * (n // bc - 1)
    assert spy.ineligible() == []


def test_mesh_calls_are_tma_eligible(monkeypatch):
    spy = _Spy(monkeypatch)
    grid = Grid.rect(2, 2, 1, devices=["cpu"] * 4)
    cholesky.factor(grid, _spd(1024, 3), cholesky.CholinvConfig(mode="explicit", base_case_dim=256))
    assert len(spy.sched) == 4 * 3
    assert spy.ineligible() == []


@pytest.mark.parametrize("dtype,off,ok", [
    (torch.bfloat16, (0, 0), True), (torch.bfloat16, (3, 8), True), (torch.bfloat16, (0, 4), False),
    (torch.bfloat16, (1, 1), False), (torch.float32, (2, 4), True), (torch.float32, (0, 2), False),
])
def test_tma_ok_reads_the_window_origin(dtype, off, ok):
    X = torch.zeros(64, 64, dtype=dtype)
    assert hopper._tma_ok(X, (*off, 8, 8)) is ok


@pytest.mark.parametrize("cols,ok", [(64, True), (72, True), (60, False), (9, False)])
def test_tma_ok_reads_the_row_stride(cols, ok):
    X = torch.zeros(16, cols, dtype=torch.bfloat16)
    assert hopper._tma_ok(X, (0, 0, 4, 4)) is ok
    # a column slice keeps the buffer's stride: only the origin moves
    assert hopper._tma_ok(X[:, 8:], (0, 0, 4, 4)) is ok


@pytest.mark.parametrize("dtype,aligned,asked,want", [
    (torch.bfloat16, True, None, "wgmma"), (torch.bfloat16, False, None, "wmma"),
    (torch.bfloat16, True, "wmma", "wmma"), (torch.bfloat16, False, "wmma", "wmma"),
    (torch.float32, True, None, "fma"), (torch.float64, False, None, "simt"),
])
def test_route_choice(dtype, aligned, asked, want):
    assert hopper._pick_route(dtype, aligned, asked, "tri_matmul") == want


@pytest.mark.parametrize("dtype,aligned,asked", [
    (torch.bfloat16, False, "wgmma"), (torch.float32, True, "wgmma"), (torch.float32, True, "wmma"),
    (torch.bfloat16, True, "mma"),
])
def test_route_choice_refuses(dtype, aligned, asked):
    with pytest.raises(ValueError):
        hopper._pick_route(dtype, aligned, asked, "tri_matmul")


def test_counts_keep_their_keys():
    """counts() is still one flat dict of ints over every kernel; the route
    tally sits beside it and CPU calls move neither."""
    hopper.reset_counts()
    A = torch.randn(256, 256).to(torch.bfloat16)
    hopper.tri_matmul(A, A, a_uplo="U")
    c = hopper.counts()
    assert set(c) == COUNTER_KEYS == set(hopper.KERNELS)
    assert all(type(v) is int and v == 0 for v in c.values())
    assert hopper.route_counts() == {}
