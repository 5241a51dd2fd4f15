"""The port's mesh layer (capital_tpu_torch.parallel.topology, .mesh and the
mesh cost model of utils/tracing) against the JAX package's, on the CPU.

The JAX grids are the conftest's virtual CPU devices; the port's are the
in-process virtual mesh (every rank on the CPU).  Rank maps, shapes and
error messages must be equal; the collectives are checked against numpy
exactly (copies and sums of a few exactly representable values); the cost
model must give the same numbers to the last bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.parallel import topology as jtopo
from capital_tpu.utils import tracing as jtracing
from capital_tpu_torch import Grid
from capital_tpu_torch.parallel import mesh
from capital_tpu_torch.parallel import topology as ttopo
from capital_tpu_torch.utils import tracing as ttracing

CPU = torch.device("cpu")


def _cpus(p):
    return [CPU] * p


@pytest.mark.parametrize("shape,layout", [((2, 2, 1), 0), ((2, 2, 2), 0), ((2, 2, 2), 1),
                                          ((2, 2, 2), 2), ((1, 2, 4), 1), ((4, 2, 1), 2)])
def test_rank_map_matches_the_reference(shape, layout):
    dx, dy, c = shape
    P = dx * dy * c
    want = jtopo._order_devices(list(range(P)), dx, dy, c, layout)
    if layout == 2 and not jtopo.layout2_eligible(dx, dy, c):
        with pytest.warns(UserWarning, match="falling back to layout 0"):
            grid = Grid.rect(dx, dy, c, devices=_cpus(P), layout=layout)
    else:
        grid = Grid.rect(dx, dy, c, devices=_cpus(P), layout=layout)
    assert (grid.dx, grid.dy, grid.c, grid.num_devices) == (dx, dy, c, P)
    for r, xyz in enumerate(grid.coords):
        assert want[xyz] == r
    assert ttopo.layout2_eligible(dx, dy, c) == jtopo.layout2_eligible(dx, dy, c)


def test_square_and_flat_match_the_reference():
    for c, P in ((1, 4), (2, 8), (1, 1)):
        jg = jtopo.Grid.square(c=c, devices=jax.devices("cpu")[:P])
        tg = Grid.square(c=c, devices=_cpus(P))
        assert (tg.dx, tg.dy, tg.c, tg.num_devices) == (jg.dx, jg.dy, jg.c, jg.num_devices)
    jf, tf = jtopo.Grid.flat(jax.devices("cpu")[:4]), Grid.flat(_cpus(4))
    assert (tf.dx, tf.dy, tf.c) == (jf.dx, jf.dy, jf.c)
    g = Grid.square(c=2, devices=_cpus(8), num_chunks=2, collective_concurrency="solo")
    assert (g.num_chunks, g.collective_concurrency, g.platform) == (2, "solo", "cpu")


@pytest.mark.parametrize("make", [
    lambda devs: ("square", dict(c=2, devices=devs[:6])),
    lambda devs: ("square", dict(c=1, devices=devs[:3])),
    lambda devs: ("rect", dict(dx=2, dy=2, c=2, devices=devs[:4])),
    lambda devs: ("square", dict(c=1, devices=devs[:4], layout=3)),
])
def test_errors_match_the_reference(make):
    jname, jkw = make(jax.devices("cpu"))
    tname, tkw = make(_cpus(8))
    with pytest.raises(ValueError) as want:
        getattr(jtopo.Grid, jname)(**jkw)
    with pytest.raises(ValueError) as got:
        getattr(Grid, tname)(**tkw)
    assert str(got.value) == str(want.value)


def test_distinct_devices_wait_for_the_nccl_backend():
    with pytest.raises(NotImplementedError, match="Queue A item 10.*NCCL"):
        Grid.rect(2, 1, 1, devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="not both"):
        Grid.square(devices=[CPU], device="cpu")


def _grid222():
    return Grid.square(c=2, devices=_cpus(8), layout=1)


def _ref_coords(grid):
    return [tuple(xyz) for xyz in grid.coords]


def test_blocks_and_assemble_cut_the_face():
    grid = _grid222()
    X = torch.arange(8 * 6, dtype=torch.float64).reshape(8, 6)
    blk = mesh.blocks(grid, X)
    for r, (x, y, _) in enumerate(_ref_coords(grid)):
        np.testing.assert_array_equal(blk[r].numpy(), X.numpy()[4 * x:4 * x + 4, 3 * y:3 * y + 3])
        assert mesh.axis_index(grid, r, "x") == x and mesh.axis_index(grid, r, "y") == y
    assert torch.equal(mesh.assemble(grid, blk), X)


@pytest.mark.parametrize("axis,dim", [("x", 0), ("y", 1), ("z", 1)])
def test_all_gather_concatenates_along_the_axis(axis, dim):
    grid = _grid222()
    vals = [torch.full((2, 3), float(r)) for r in range(grid.num_devices)]
    got = mesh.all_gather(grid, vals, axis, dim)
    ai = "xyz".index(axis)
    for r, xyz in enumerate(_ref_coords(grid)):
        peers = []
        for i in range(2):
            key = list(xyz)
            key[ai] = i
            peers.append(_ref_coords(grid).index(tuple(key)))
        want = np.concatenate([np.full((2, 3), float(p)) for p in peers], axis=dim)
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("axes", [("x",), ("z",), ("x", "y"), ("x", "y", "z")])
def test_psum_sums_over_the_axes(axes):
    grid = _grid222()
    vals = [torch.tensor([[2.0 ** r]]) for r in range(grid.num_devices)]
    got = mesh.psum(grid, vals, axes)
    on = ["xyz".index(a) for a in axes]
    for r, xyz in enumerate(_ref_coords(grid)):
        want = sum(2.0 ** q for q, other in enumerate(_ref_coords(grid))
                   if all(other[i] == xyz[i] for i in range(3) if i not in on))
        assert float(got[r]) == want
    assert float(mesh.replicated(grid, mesh.psum(grid, vals, ("x", "y", "z")))) == 255.0


@pytest.fixture(scope="module")
def grid_pairs(grid2x2x1, grid2x2x2):
    chunked = jtopo.Grid.square(c=1, devices=jax.devices("cpu")[:4], num_chunks=2)
    return [
        (grid2x2x1, Grid.rect(2, 2, 1, devices=_cpus(4))),
        (grid2x2x2, Grid.square(c=2, devices=_cpus(8))),
        (chunked, Grid.rect(2, 2, 1, devices=_cpus(4), num_chunks=2)),
        (jtopo.Grid.square(c=2, devices=jax.devices("cpu")[:8], num_chunks=3),
         Grid.square(c=2, devices=_cpus(8), num_chunks=3)),
    ]


@pytest.mark.parametrize("dt", ["float64", "float32", "bfloat16"])
def test_mesh_costs_match_the_reference(grid_pairs, dt):
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    for jg, tg in grid_pairs:
        for M, N, K in ((512, 256, 1024), (96, 2, 64), (4096, 8192, 4096)):
            assert ttracing.gemm_cost(tg, M, N, K, tdt) == jtracing.gemm_cost(jg, M, N, K, jdt)
        assert ttracing.transpose_cost(tg, 512, 256, tdt) == jtracing.transpose_cost(jg, 512, 256, jdt)
        assert ttracing.replicate_cost(tg, 256, 256, tdt) == jtracing.replicate_cost(jg, 256, 256, jdt)
        for axes in ("all", "z"):
            assert (ttracing.allreduce_cost(tg, 128, 64, tdt, axes)
                    == jtracing.allreduce_cost(jg, 128, 64, jdt, axes))
