"""The route rule of the write_diag_blocks kernel, on the CPU.

On the card `hopper.write_diag_blocks` takes the 'vec' route (16-byte
vectors of W, cast in registers, stored at out's width) where every access
it makes is aligned, and the 'elem' route (one element a thread) otherwise.
The rule (`hopper.write_diag_route`) reads dtypes, shapes, strides and
`data_ptr()` only, so these tests pin it on CPU tensors: the rectri paths'
own write-backs go 'vec', every misalignment goes 'elem'.  The kernel
itself is held bit for bit to its plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import inspect
import re

import numpy as np
import pytest
import torch

from capital_tpu_torch import Grid
from capital_tpu_torch.models import inverse
from capital_tpu_torch.ops import _build, hopper

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def _stack(count, s, dt, offset=0):
    """A contiguous (count, s, s) stack whose data starts `offset` elements
    into a fresh buffer (torch's CPU allocations are 64-byte aligned)."""
    flat = torch.zeros(offset + count * s * s, dtype=DTYPES[dt])
    return flat[offset:].view(count, s, s)


def _out(p, dt, pad=0, col=0):
    """A p x p view of a p x (p + pad) buffer, starting `col` elements in."""
    return torch.zeros((p, p + pad), dtype=DTYPES[dt])[:, col:col + p]


def _rectri_routes(monkeypatch, n, bc, dt):
    """The route the card's rule gives every write_diag_blocks call of one
    CPU rectri (mode 'pallas', the batched prefix on), the plain version
    doing the work."""
    seen = []

    def spy(out, W):
        seen.append((hopper.write_diag_route(out, W.contiguous()), tuple(W.shape)))
        return hopper.write_diag_blocks_plain(out, W)

    monkeypatch.setattr(hopper, "write_diag_blocks", spy)
    g = np.random.default_rng(7).standard_normal((n, n))
    L = torch.from_numpy(np.tril(g, -1) / np.sqrt(n) + 3 * np.eye(n)).to(DTYPES[dt])
    cfg = inverse.RectriConfig(base_case_dim=bc, mode="pallas", precision=None)
    Li = inverse.rectri(Grid.square(device="cpu"), L, "L", cfg)
    assert bool(torch.isfinite(Li).all())
    return seen


@pytest.mark.parametrize("n,bc,dt", [(768, 128, "bf16"), (512, 32, "f32")])
def test_rectri_write_back_takes_vec(monkeypatch, n, bc, dt):
    # the bf16 flagship's pattern (a block count that is no power of two:
    # 96 there, 6 here) and the f32 cell's (16 blocks), at a small n
    assert _rectri_routes(monkeypatch, n, bc, dt) == [("vec", (n // bc, bc, bc))]


@pytest.mark.parametrize("s,dts", [(512, ("bf16", "bf16")), (512, ("f32", "f32")), (512, ("f32", "bf16")),
                                   (24, ("f64", "bf16")), (40, ("bf16", "f32")), (64, ("f32", "f64"))])
def test_aligned_stacks_take_vec(s, dts):
    # the flagship's 512-blocks (bf16, f32, and f32 into bf16) two to a
    # buffer, and the sizes the JAX parity test adds
    assert hopper.write_diag_route(_out(2 * s, dts[1]), _stack(2, s, dts[0])) == "vec"


@pytest.mark.parametrize("case", ["s100", "odd_ldo", "f64_odd_s", "W_off", "W_strided"])
def test_misaligned_operands_take_elem(case):
    # (an out origin off 16 bytes: test_store_width_decides_out_alignment)
    W, out = {
        "s100": lambda: (_stack(3, 100, "bf16"), _out(300, "bf16")),
        "odd_ldo": lambda: (_stack(3, 64, "bf16"), _out(192, "bf16", pad=1)),
        "f64_odd_s": lambda: (_stack(3, 25, "f64"), _out(75, "bf16")),
        "W_off": lambda: (_stack(3, 64, "f32", offset=1), _out(192, "f32")),
        "W_strided": lambda: (_stack(3, 64, "f32").transpose(1, 2), _out(192, "f32")),
    }[case]()
    assert hopper.write_diag_route(out, W) == "elem"


@pytest.mark.parametrize("col,dts,want", [(1, ("bf16", "bf16"), "elem"), (4, ("bf16", "bf16"), "elem"),
                                          (8, ("bf16", "bf16"), "vec"), (2, ("f64", "bf16"), "vec"),
                                          (1, ("f64", "bf16"), "elem"), (2, ("f32", "bf16"), "elem"),
                                          (4, ("f32", "bf16"), "vec")])
def test_store_width_decides_out_alignment(col, dts, want):
    # the store width is the vector's bytes at out's dtype, 16 at most:
    # f64 -> bf16 stores 4 bytes, f32 -> bf16 8, bf16 -> bf16 16
    s = 64
    W, out = _stack(3, s, dts[0]), _out(3 * s, dts[1], pad=16, col=col)
    assert hopper.write_diag_route(out, W) == want


def test_route_codes_match_the_kernel():
    text = (_build.CSRC / "write_diag.cu").read_text()
    enum = dict(re.findall(r"ROUTE_(\w+) = (\d+)", text))
    assert {k.lower(): int(v) for k, v in enum.items()} == hopper.WRITE_DIAG_ROUTES
    # no wrapper keyword forces a route: the rule alone picks it
    assert list(inspect.signature(hopper.write_diag_blocks).parameters) == ["out", "W"]


def test_cpu_call_counts_and_tallies_nothing():
    hopper.reset_counts()
    W = torch.arange(2 * 16 * 16, dtype=torch.float32).reshape(2, 16, 16)
    out = hopper.write_diag_blocks(torch.full((40, 40), float("nan")), W)
    assert torch.equal(out[16:32, 16:32], W[1]) and int(torch.isnan(out).sum()) == 40 * 40 - 2 * 256
    assert not any(hopper.counts().values()) and hopper.route_counts() == {}
