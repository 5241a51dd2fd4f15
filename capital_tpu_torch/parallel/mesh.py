"""The in-process mesh: the port's counterpart of shard_map and the lax
collectives, in bulk-synchronous form.

A distributed step holds one value per rank — a list indexed by rank, rank
r at `grid.coords[r]` — and the collectives run between the steps:

* `blocks(grid, X)` — the P('x', 'y') cut of a global X (shard_map's
  in_specs): rank (x, y, z) holds block (x, y), replicated over z;
* `rows(grid, X)` — the P(('x', 'y', 'z'), None) cut (the JAX grid's
  rows_sharding): rank (x, y, z) holds row block (x·dy + y)·c + z, a
  contiguous view the kernels read in place;
* `all_gather(grid, vals, axis, dim)` — lax.all_gather(tiled=True): every
  rank gets the concatenation, along `dim`, of the values of the ranks that
  differ from it only along `axis`, in that axis' order;
* `psum(grid, vals, axes)` — lax.psum over the named axes;
* `axis_index(grid, r, axis)` — lax.axis_index;
* `assemble(grid, vals)` / `assemble_rows(grid, vals)` /
  `replicated(grid, vals)` — shard_map's out_specs P('x', 'y'),
  P(('x', 'y', 'z'), None) and P().

Each collective the reference issues is one call here, so a
`torch.distributed` backend for ranks on distinct devices replaces this
module and nothing else (ROADMAP Queue A item 10).  On the virtual mesh
every rank shares one device: a gather is one `torch.cat` and a sum one
chain of adds per group of ranks, computed once and held by every rank of
the group (the values are never written in place).  The collectives run
one at a time, so collective_concurrency='solo' is always satisfied; no
communication is measured.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.parallel.topology import AXES, Grid


def axis_index(grid: Grid, r: int, axis: str) -> int:
    """Rank r's coordinate along 'x', 'y' or 'z'."""
    return grid.coords[r][AXES.index(axis)]


def _groups(grid: Grid, axes: tuple[str, ...]) -> list[list[int]]:
    """The ranks grouped by their coordinates off `axes`, each group in
    row-major order of its coordinates on `axes`."""
    on = [AXES.index(a) for a in axes]
    groups: dict[tuple, list[int]] = {}
    for r, xyz in enumerate(grid.coords):
        key = tuple(v for i, v in enumerate(xyz) if i not in on)
        groups.setdefault(key, []).append(r)
    for g in groups.values():
        g.sort(key=lambda r: tuple(grid.coords[r][i] for i in on))
    return list(groups.values())


def blocks(grid: Grid, X: torch.Tensor) -> list[torch.Tensor]:
    """Rank r's block of the global X under P('x', 'y') (a view)."""
    mb, nb = X.shape[0] // grid.dx, X.shape[1] // grid.dy
    out = []
    for x, y, _ in grid.coords:
        out.append(X[x * mb:(x + 1) * mb, y * nb:(y + 1) * nb])
    return out


def _row_block(grid: Grid, r: int) -> int:
    x, y, z = grid.coords[r]
    return (x * grid.dy + y) * grid.c + z


def rows(grid: Grid, X: torch.Tensor) -> list[torch.Tensor]:
    """Rank r's rows of the global X under P(('x', 'y', 'z'), None) (a
    view); the row count must divide by the number of ranks."""
    p = grid.num_devices
    if X.shape[0] % p:
        raise ValueError(f"{X.shape[0]} rows do not divide over {p} ranks")
    mb = X.shape[0] // p
    return [X[_row_block(grid, r) * mb:(_row_block(grid, r) + 1) * mb] for r in range(p)]


def all_gather(grid: Grid, vals: list[torch.Tensor], axis: str, dim: int) -> list[torch.Tensor]:
    """Tiled all_gather over one axis (see the module docstring)."""
    out: list = [None] * grid.num_devices
    for g in _groups(grid, (axis,)):
        cat = torch.cat([vals[r] for r in g], dim) if len(g) > 1 else vals[g[0]]
        for r in g:
            out[r] = cat
    return out


def psum(grid: Grid, vals: list[torch.Tensor], axes: tuple[str, ...]) -> list[torch.Tensor]:
    """Sum over the ranks that differ only along `axes`, in rank order."""
    out: list = [None] * grid.num_devices
    for g in _groups(grid, axes):
        s = vals[g[0]]
        for r in g[1:]:
            s = s + vals[r]
        for r in g:
            out[r] = s
    return out


def assemble(grid: Grid, vals: list[torch.Tensor]) -> torch.Tensor:
    """The global tensor whose P('x', 'y') blocks are the z = 0 ranks'
    values (out_specs P('x', 'y'); the depth replicas agree)."""
    at = {xyz: v for xyz, v in zip(grid.coords, vals)}
    rows = [torch.cat([at[(x, y, 0)] for y in range(grid.dy)], 1) for x in range(grid.dx)]
    return torch.cat(rows, 0)


def assemble_rows(grid: Grid, vals: list[torch.Tensor]) -> torch.Tensor:
    """The global tensor whose P(('x', 'y', 'z'), None) row blocks are the
    ranks' values."""
    order = sorted(range(grid.num_devices), key=lambda r: _row_block(grid, r))
    return torch.cat([vals[r] for r in order], 0)


def replicated(grid: Grid, vals: list[torch.Tensor]) -> torch.Tensor:
    """A replicated value (out_specs P()): rank 0's."""
    del grid
    return vals[0]
