"""SUMMA on the device grid (counterpart of capital_tpu/parallel/summa.py:
GemmArgs/TrmmArgs/SyrkArgs, gemm, trmm, syrk, transpose and the explicit
d x d x c schedule).

* One device, modes 'pallas' and 'explicit' (whose one-device schedule is
  the same copy-free kernel route in the JAX package): trmm/syrk run
  through the hand-written kernels of ops/hopper.py — dead triangular tiles
  are never visited, windows are read and written in place.
* Every other call materialises its windows and the triangle mask and goes
  through `_matmul`: mode 'xla' (and 'pallas' on a mesh) leaves the product
  to `torch.matmul`, as the JAX package leaves it to XLA; mode 'explicit'
  runs the SUMMA schedule rank by rank on the in-process mesh
  (`_explicit_matmul`, parallel/mesh.py).  On a d x d x 1 mesh a trmm whose
  shards tile by 128 takes the sched route: each rank runs the
  `hopper.sched_matmul` kernel over its own live (tile, k-tile) pairs.
* transpose is a plain `A.T`, made contiguous (the kernels take row-major
  buffers only).

Windowed writes (`out`, syrk `in_place`) mutate the passed buffer and
return it.

The balanced layouts, mode 'explicit' on a c == 1 square face with d > 1:

* balance='tile_cyclic' — a schedule preference: the call permutes the
  triangular operand's rows (trmm side L) or the output's axes (syrk) into
  `tile_cyclic_perm` order, runs the balanced schedule (`cyclic_rows` /
  `cyclic_out`: liveness tested per original tile, products on
  `torch.matmul` as the JAX package leaves them to XLA) and un-permutes the
  result; other calls fall back to the block schedule with a
  `*::tile_cyclic_fallback` note.
* balance='tile_cyclic_persistent' — a storage contract: every passed
  buffer is already in the symmetric tile-cyclic layout
  V = X[perm][:, perm] (models/cholesky.py permutes once).  Windows are
  chunk-local reshapes (`cyclic_window`), write-backs band-sized in-place
  copies (`cyclic_window_update`), and trmm's per-rank products run
  `hopper.sched_matmul` over `_sched_pairs_cyclic`'s schedules.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from capital_tpu_torch.ops import hopper, masking
from capital_tpu_torch.parallel import mesh
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.utils import tracing

MODES = ("xla", "pallas", "explicit")


@dataclasses.dataclass(frozen=True)
class GemmArgs:
    """Mirror of blas::ArgPack_gemm (reference src/blas/engine.h:72-94)."""

    alpha: float = 1.0
    beta: float = 0.0
    trans_a: bool = False
    trans_b: bool = False
    precision: str | None = None


@dataclasses.dataclass(frozen=True)
class TrmmArgs:
    """Mirror of blas::ArgPack_trmm (reference src/blas/engine.h:96-112)."""

    side: str = "L"  # 'L': B <- alpha*op(A)B ; 'R': B <- alpha*B*op(A)
    uplo: str = "U"
    trans_a: bool = False
    diag: str = "N"  # 'N' non-unit, 'U' unit diagonal
    alpha: float = 1.0
    precision: str | None = None


@dataclasses.dataclass(frozen=True)
class SyrkArgs:
    """Mirror of blas::ArgPack_syrk (reference src/blas/engine.h:114-130)."""

    uplo: str = "U"
    trans: bool = False  # False: C = a*A*Aᵀ + b*C ; True: C = a*AᵀA + b*C
    alpha: float = 1.0
    beta: float = 0.0
    precision: str | None = None


def _check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown summa mode {mode!r}")


def _window(X: torch.Tensor, view) -> torch.Tensor:
    if view is None:
        return X
    r0, c0, rows, cols = view
    return X[r0:r0 + rows, c0:c0 + cols]


def _copy_bytes_of(*terms) -> float:
    """Sum of (factor, tensor) copy prices: factor counts reads + writes of
    the moved tensor (2.0 = one read + one write)."""
    return float(sum(f * t.numel() * t.element_size() for f, t in terms))


# --------------------------------------------------------------------------
# the explicit schedule's liveness, gates and tile schedules
# --------------------------------------------------------------------------


def _seg_live_a_global(xi, s, ch, mb, lk, w, a_uplo):
    # A columns of (segment s, chunk ch): [s*lk + ch*w, +w); rows of this
    # rank's block: [xi*mb, +mb).  Live = intersects the stored triangle.
    lo = s * lk + ch * w
    if a_uplo == "U":
        return xi * mb < lo + w  # ∃ row <= col
    return (xi + 1) * mb - 1 >= lo  # 'L': ∃ row >= col


def _seg_live_b_global(yi, s, ch, nb, lk, w, b_uplo):
    # B rows of (segment s, chunk ch); cols of this block: [yi*nb, +nb)
    lo = s * lk + ch * w
    if b_uplo == "U":
        return lo < (yi + 1) * nb
    return lo + w - 1 >= yi * nb


def _out_live(xi, yi, mb, nb, out_uplo):
    """Does rank (xi, yi)'s C block touch the stored triangle?"""
    if out_uplo == "U":
        return xi * mb < (yi + 1) * nb
    return (xi + 1) * mb - 1 >= yi * nb


def tile_cyclic_perm(m: int, d: int, tile: int):
    """Row permutation of the block-cyclic-over-tiles distribution on a
    d-row face: original row tile g lands on rank row g % d, local slot
    g // d.  Returns (perm, inv) as numpy index arrays: X[perm] is the
    cyclic layout, Y[inv] undoes it."""
    if m % (d * tile):
        raise ValueError(f"tile_cyclic_perm: {d} devices x tile {tile} must tile {m}")
    nt = m // tile
    order = [g for xi in range(d) for g in range(xi, nt, d)]
    perm = np.concatenate([np.arange(g * tile, (g + 1) * tile) for g in order])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m)
    return perm, inv


def _cyclic_dims(what: str, V: torch.Tensor, view, d: int, tile: int):
    r0, c0, rows, cols = view
    p, pc = V.shape
    g = d * tile
    if r0 % g or c0 % g or rows % g or cols % g or p % g or pc % g:
        raise ValueError(f"{what}: view {view} of {(p, pc)} must align to d*tile = {g}")
    return p, pc, g, r0 // g, (r0 + rows) // g, c0 // g, (c0 + cols) // g


def cyclic_window(V: torch.Tensor, view, d: int, tile: int) -> torch.Tensor:
    """The LOGICAL window `view = (r0, c0, rows, cols)` of a buffer stored
    in the persistent symmetric tile-cyclic layout V = X[perm][:, perm]
    (perm = tile_cyclic_perm(p, d, tile)), without un-permuting.  A window
    aligned to d·tile is a contiguous slice of every rank chunk on each
    axis; the result is itself in window-local tile-cyclic layout (whose
    permutation depends only on (extent, d, tile), never on the offset).
    It is a view of V when the window spans whole chunks, else one
    window-sized copy (the kernels read row-major 2-D operands)."""
    p, pc, g, a, b, e, f = _cyclic_dims("cyclic_window", V, view, d, tile)
    rows, cols = view[2], view[3]
    W = V.reshape(d, p // g, tile, d, pc // g, tile)[:, a:b, :, :, e:f, :]
    return W.reshape(rows, cols)


def cyclic_window_update(V: torch.Tensor, W: torch.Tensor, view, d: int, tile: int) -> torch.Tensor:
    """Write a window-local tile-cyclic result W into the window `view` of
    the persistent-layout buffer V, in place (the inverse of
    cyclic_window): one copy into V's strided chunk slices, band-sized —
    V is never rebuilt.  Returns V."""
    p, pc, g, a, b, e, f = _cyclic_dims("cyclic_window_update", V, view, d, tile)
    V6 = V.view(d, p // g, tile, d, pc // g, tile)
    V6[:, a:b, :, :, e:f, :].copy_(W.reshape(d, b - a, tile, d, f - e, tile))
    return V


def _pick_cyclic_tile(grid: Grid, dim: int, override: int) -> int:
    """The one tile rule of balance='tile_cyclic' (trmm rows / syrk
    output): ~4 local tiles a rank, a 128 multiple once the local extent
    reaches 128, with more tiles than ranks; `override` wins.  0 when the
    grid or shape cannot take the cyclic schedule (c == 1 square faces with
    d > 1, the tile tiling the global dim)."""
    d = grid.dx
    tile = override
    if tile == 0 and d > 1:
        base = dim // d // 4
        if dim // d >= 128:
            t = max(base // 128 * 128, 128)
            while t >= 128 and (dim % (d * t) or dim // t <= d):
                t -= 128
            if t >= 128:
                tile = t
        elif base > 0 and (dim // d) % 4 == 0:
            tile = base
    ok = grid.c == 1 and grid.dx == grid.dy and d > 1 and tile > 0 and dim % (d * tile) == 0
    return tile if ok else 0


def tri_fractions(grid: Grid, M: int, K: int, N: int, a_uplo: str | None = None,
                  b_uplo: str | None = None, out_uplo: str | None = None,
                  cyclic_rows: int = 0, cyclic_out: int = 0) -> tuple[float, float]:
    """(mean_frac, max_frac) of the dense per-rank contraction that the
    explicit schedule's K-segment route executes under dead-segment and
    dead-output skipping, from the same liveness predicates: mean is the
    volumetric view, max the critical-path rank (the fullest block row runs
    every segment under block distribution).  cyclic_rows / cyclic_out
    price the balanced schedules instead (liveness per original tile)."""
    d, c = grid.dx, grid.c
    if grid.num_devices == 1 or (a_uplo is None and b_uplo is None and out_uplo is None):
        return 1.0, 1.0
    if grid.dy != d or d % max(1, c) or M % d or K % d or N % d:
        return 1.0, 1.0  # shapes the explicit schedule would reject: dense model
    q = max(1, grid.num_chunks)
    lk = K // d
    if lk % q:
        return 1.0, 1.0
    w = lk // q
    mb, nb = M // d, N // d
    spl = d // c
    if cyclic_rows:
        tile = cyclic_rows
        if c != 1 or a_uplo is None or tile > mb or mb % tile:
            return 1.0, 1.0
        ntl = mb // tile
        fracs = []
        for xi in range(d):
            live = sum(bool(_seg_live_a_global(t * d + xi, s, ch, tile, lk, w, a_uplo))
                       for t in range(ntl) for s in range(d) for ch in range(q))
            fracs.append(live / (ntl * d * q))
        return sum(fracs) / len(fracs), max(fracs)
    if cyclic_out:
        tile = cyclic_out
        if c != 1 or out_uplo is None or a_uplo is not None or b_uplo is not None or M != N \
                or mb % tile:
            return 1.0, 1.0
        ntl = mb // tile
        fracs = []
        for xi in range(d):
            for yi in range(d):
                live = sum((ti * d + xi <= tj * d + yi) if out_uplo == "U"
                           else (ti * d + xi >= tj * d + yi)
                           for ti in range(ntl) for tj in range(ntl))
                fracs.append(live / (ntl * ntl))
        return sum(fracs) / len(fracs), max(fracs)
    fracs = []
    for zi in range(c):
        segs = range(d) if c == 1 else [zi * spl + i for i in range(spl)]
        denom = len(segs) * q
        for xi in range(d):
            for yi in range(d):
                if out_uplo is not None and not _out_live(xi, yi, mb, nb, out_uplo):
                    fracs.append(0.0)
                    continue
                live = 0
                for s in segs:
                    for ch in range(q):
                        la = a_uplo is None or _seg_live_a_global(xi, s, ch, mb, lk, w, a_uplo)
                        lb = b_uplo is None or _seg_live_b_global(yi, s, ch, nb, lk, w, b_uplo)
                        live += bool(la and lb)
                fracs.append(live / denom)
    return sum(fracs) / len(fracs), max(fracs)


def _shard_kernels_gate(grid: Grid, M: int, K: int, N: int, a_uplo, b_uplo, out_uplo,
                        cyclic_rows: int = 0, cyclic_out: int = 0) -> bool:
    """Does the explicit schedule run its local compute through the
    live-tile `tri_matmul` kernel per shard?  A 1 x 1 x 1 grid, unchunked,
    with 128-aligned blocks and a triangular operand or output.  Shared by
    the router and the cost model."""
    d, c = grid.dx, grid.c
    q = max(1, grid.num_chunks)
    structured = a_uplo is not None or b_uplo is not None or out_uplo is not None
    if not (structured and d == 1 and grid.dy == 1 and c == 1 and q == 1):
        return False
    if cyclic_rows or cyclic_out:
        return False
    return M % 128 == 0 and N % 128 == 0 and K % 128 == 0


def _sched_blocks(mb: int, K: int, nb: int) -> tuple[int, int, int]:
    """(bm, bk, bn) for the sched route: the largest of 512/256/128 dividing
    the extent AND leaving >= 4 tiles, else the smallest divisor, else 0
    (cannot tile)."""

    def pick(x: int) -> int:
        for b in (512, 256, 128):
            if x % b == 0 and x // b >= 4:
                return b
        for b in (128, 256, 512):
            if x % b == 0:
                return b
        return 0

    return pick(mb), pick(K), pick(nb)


def _sched_host(d: int, M: int, K: int, N: int, a_uplo, b_uplo):
    """The per-rank tile schedules as (d, L) int32 numpy arrays (TO, KO,
    FI, LA) — rank i's live (tile, k-tile) pairs, padded to the longest by
    repeating its last pair with first = last = 0 — with the executed
    fraction L/(nt·nk) and the blocks (bm, bn, bk); None when the shapes do
    not tile or nothing is skippable."""
    mb, nb = M // d, N // d
    bm, bk, bn = _sched_blocks(mb, K, nb)
    if not (bm and bk and bn):
        return None
    uplo = a_uplo if a_uplo is not None else b_uplo
    a_side = a_uplo is not None
    bt = bm if a_side else bn
    nt, nk = (mb if a_side else nb) // bt, K // bk
    per_dev = []
    for xi in range(d):
        pairs = []
        for t in range(nt):
            r0 = xi * (mb if a_side else nb) + t * bt
            for k in range(nk):
                c0 = k * bk
                if a_side:  # A (M, K) triangular: row-tile origin r0, K origin c0
                    live = (c0 < r0 + bt) if uplo == "L" else (c0 + bk > r0)
                else:  # B (K, N) triangular: K origin c0 (rows), col origin r0
                    live = (c0 + bk > r0) if uplo == "L" else (c0 < r0 + bt)
                if live:
                    pairs.append((t, k))
        if not pairs:
            return None
        per_dev.append(pairs)
    arrays = _stack_pairs(per_dev)
    frac = arrays[0].shape[1] / float(nt * nk)
    if frac >= 1.0:
        # nothing skippable at this tiling: stay on the segment route
        return None
    return arrays, frac, (bm, bn, bk)


def _stack_pairs(per_dev):
    """Each rank's (tile, k-tile) pairs as the (d, L) int32 arrays (TO, KO,
    FI, LA): first / last mark a tile's run, and a shorter list is padded
    to the longest by repeating its last pair with first = last = 0."""
    L = max(len(p) for p in per_dev)
    TO, KO, FI, LA = (np.zeros((len(per_dev), L), np.int32) for _ in range(4))
    for xi, pairs in enumerate(per_dev):
        for idx, (t, k) in enumerate(pairs):
            TO[xi, idx], KO[xi, idx] = t, k
            FI[xi, idx] = 1 if idx == 0 or pairs[idx - 1][0] != t else 0
            LA[xi, idx] = 1 if idx == len(pairs) - 1 or pairs[idx + 1][0] != t else 0
        TO[xi, len(pairs):], KO[xi, len(pairs):] = pairs[-1]
    return TO, KO, FI, LA


@functools.lru_cache(maxsize=256)
def _sched_pairs(grid: Grid, M: int, K: int, N: int, a_uplo, b_uplo):
    """_sched_host's schedule with the arrays on the grid's device (built
    once per shape: a recursion reuses each level's shapes)."""
    sched = _sched_host(grid.dx, M, K, N, a_uplo, b_uplo)
    if sched is None:
        return None
    arrays, frac, blocks = sched
    return tuple(torch.from_numpy(a).to(grid.device) for a in arrays), frac, blocks


def _sched_host_cyclic(d: int, M: int, K: int, N: int, a_uplo, b_uplo, t: int):
    """_sched_host for the PERSISTENT tile-cyclic layout: the triangular
    operand's cyclic axis (rows for side L, columns for side R) AND the
    contraction axis are both stored in tile_cyclic_perm order, so
    liveness is tested at ORIGINAL tile indices — local tile j on rank i is
    original tile j·d + i, gathered K-tile kt is original K-tile
    (kt % nkc)·d + kt // nkc.  Blocks: the layout's t on the cyclic axes,
    512/256/128 on the dense free axis.  None when t does not tile (a
    cyclic K has no contiguous dead segments: callers go dense)."""
    a_side = a_uplo is not None
    uplo = a_uplo if a_side else b_uplo
    loc = M // d if a_side else N // d  # the triangular / cyclic axis, local
    dense = N // d if a_side else M // d  # the dense free axis, local
    if loc % t or K % (d * t):
        return None
    bfree = next((b for b in (512, 256, 128) if dense % b == 0), dense)
    ntl, nkc = loc // t, K // (d * t)
    nkt = d * nkc
    per_dev = []
    for xi in range(d):
        pairs = []
        for j in range(ntl):
            g = j * d + xi  # original tile of the cyclic output axis
            for kt in range(nkt):
                gk = (kt % nkc) * d + kt // nkc  # original K tile
                if a_side:  # A (M, K) triangular: U keeps cols >= rows
                    live = gk >= g if uplo == "U" else gk <= g
                else:  # B (K, N) triangular: U keeps rows <= cols
                    live = gk <= g if uplo == "U" else gk >= g
                if live:
                    pairs.append((j, kt))
        if not pairs:
            return None
        per_dev.append(pairs)
    arrays = _stack_pairs(per_dev)
    blocks = (t, bfree, t) if a_side else (bfree, t, t)
    return arrays, arrays[0].shape[1] / float(ntl * nkt), blocks


@functools.lru_cache(maxsize=256)
def _sched_pairs_cyclic(grid: Grid, M: int, K: int, N: int, a_uplo, b_uplo, t: int):
    """_sched_host_cyclic's schedule with the arrays on the grid's device,
    built once per shape (never written)."""
    sched = _sched_host_cyclic(grid.dx, M, K, N, a_uplo, b_uplo, t)
    if sched is None:
        return None
    arrays, frac, blocks = sched
    return tuple(torch.from_numpy(a).to(grid.device) for a in arrays), frac, blocks


def _shard_sched_gate(grid: Grid, M: int, K: int, N: int, a_uplo, b_uplo, out_uplo,
                      cyclic_rows: int = 0, cyclic_out: int = 0):
    """The sched route's schedule, or None: d > 1 square face, c == 1,
    unchunked, exactly one triangular operand, no balanced schedule, and
    tileable shards.  Shared by the router and the cost model."""
    d, c = grid.dx, grid.c
    q = max(1, grid.num_chunks)
    if not (d > 1 and grid.dy == d and c == 1 and q == 1):
        return None
    if (a_uplo is None) == (b_uplo is None) or out_uplo is not None:
        return None
    if cyclic_rows or cyclic_out:
        return None
    if M % d or K % d or N % d:
        return None
    return _sched_pairs(grid, M, K, N, a_uplo, b_uplo)


# --------------------------------------------------------------------------
# the explicit schedule
# --------------------------------------------------------------------------


def _explicit_matmul(grid: Grid, A: torch.Tensor, B: torch.Tensor, precision: str | None = None,
                     a_uplo: str | None = None, b_uplo: str | None = None,
                     out_uplo: str | None = None, cyclic_rows: int = 0, cyclic_out: int = 0,
                     sched=None) -> torch.Tensor:
    """C = A @ B with the explicit SUMMA schedule on the d x d x c grid,
    rank by rank on the in-process mesh; `sched` forwards `_matmul`'s
    schedule.  Per rank (x, y, z), on its P('x', 'y') blocks a, b:

      c == 1:  a_row = all_gather(a, 'y'); b_col = all_gather(b, 'x')
               acc += a_row @ b_col, per K-segment, skipping the segments
               dead for this block (a_uplo / b_uplo) and every segment of a
               dead output block (out_uplo)
      c  > 1:  for each of this layer's d/c K-steps k:
                 a_panel = psum(a if y == k else 0, 'y')
                 b_panel = psum(b if x == k else 0, 'x')
                 acc += a_panel @ b_panel   (dead panels skipped)
               C = psum(acc, 'z'), in num_chunks column slices

    The sched route (trmm shapes on d x d x 1, see _shard_sched_gate, or
    the persistent layout's schedule handed in as `sched`) instead runs
    `hopper.sched_matmul` on the gathered slabs with the rank's own tile
    schedule.  cyclic_rows (side-L trmm) and cyclic_out (syrk) run the
    balanced schedules on c == 1: A's rows, or both output axes, are in
    tile_cyclic_perm order, and each local row tile x segment (output tile
    pair) is skipped by its ORIGINAL tile's liveness.  num_chunks = q > 1 splits each gather into
    q K-slices.  Local products accumulate in f32 (f64 for f64) through
    `torch.matmul`; each rank's partial is cast back to the operands'
    dtype before the depth collect."""
    d, c = grid.dx, grid.c
    if grid.dy != d:
        raise ValueError("explicit SUMMA requires a square grid face")
    if d % c != 0:
        raise ValueError(f"depth c={c} must divide face d={d}")
    (M, K), (K2, N) = A.shape, B.shape
    if K != K2:
        raise ValueError(f"inner dims mismatch: {tuple(A.shape)} @ {tuple(B.shape)}")
    if M % d or K % d or N % d:
        raise ValueError(f"global dims {(M, K, N)} must be divisible by d={d}")
    if cyclic_rows:
        if c != 1 or a_uplo is None or b_uplo is not None or out_uplo is not None:
            raise ValueError("cyclic_rows supports the c==1 triangular-A (side-L trmm) schedule only")
        if (M // d) % cyclic_rows:
            raise ValueError(f"cyclic tile {cyclic_rows} must divide the local rows {M // d}")
    if cyclic_out:
        if c != 1 or out_uplo is None or a_uplo is not None or b_uplo is not None:
            raise ValueError("cyclic_out supports the c==1 tri-output (syrk) schedule only")
        if (M // d) % cyclic_out or (N // d) % cyclic_out or M != N:
            raise ValueError(f"cyclic_out tile {cyclic_out} must tile the square local block "
                             f"{(M // d, N // d)}")
    spl = d // c  # K-segments owned by each depth layer
    q = max(1, grid.num_chunks)
    lk = K // d  # local K extent
    if lk % q:
        raise ValueError(f"num_chunks={q} must divide the local K extent {lk}")
    w = lk // q
    mb, nb = M // d, N // d
    wire = torch.promote_types(A.dtype, B.dtype)
    acc_dt = torch.promote_types(wire, torch.float32)
    ranks = range(grid.num_devices)
    xs = [mesh.axis_index(grid, r, "x") for r in ranks]
    ys = [mesh.axis_index(grid, r, "y") for r in ranks]
    zs = [mesh.axis_index(grid, r, "z") for r in ranks]
    a_blk, b_blk = mesh.blocks(grid, A), mesh.blocks(grid, B)

    shard_kernels = _shard_kernels_gate(grid, M, K, N, a_uplo, b_uplo, out_uplo, cyclic_rows,
                                        cyclic_out)
    if shard_kernels:
        tracing.note("explicit::shard_kernels")
        sched = None
    elif sched is None:  # direct callers: build what _matmul forwards
        sched = _shard_sched_gate(grid, M, K, N, a_uplo, b_uplo, out_uplo, cyclic_rows,
                                  cyclic_out)
    if sched is not None:
        tracing.note("explicit::shard_sched")

    if shard_kernels or sched is not None:
        a_ch = mesh.all_gather(grid, a_blk, "y", 1)
        b_ch = mesh.all_gather(grid, b_blk, "x", 0)
        parts = []
        for r in ranks:
            if shard_kernels:
                tri = dict(out_uplo=out_uplo) if out_uplo else dict(a_uplo=a_uplo, b_uplo=b_uplo)
                part = hopper.tri_matmul(a_ch[r], b_ch[r], precision=precision, **tri)
            else:
                # each rank runs ITS OWN row of the stacked schedule
                (TO, KO, FI, LA), _, blocks = sched
                sel = xs[r] if a_uplo is not None else ys[r]
                part = hopper.sched_matmul(
                    a_ch[r], b_ch[r], TO[sel], KO[sel], FI[sel], LA[sel],
                    tri_side="a" if a_uplo is not None else "b", blocks=blocks,
                    precision=precision,
                )
            parts.append(part.to(wire))
        return mesh.assemble(grid, parts)

    out_live = [None] * len(ranks)
    if out_uplo is not None:
        out_live = [_out_live(xs[r], ys[r], mb, nb, out_uplo) for r in ranks]
    accs: list = [None] * len(ranks)

    def accumulate(r, live, a_op, b_op):
        # a dead term's matmul is skipped (the reference's zero branch)
        if live is None or live:
            prod = torch.matmul(a_op.to(acc_dt), b_op.to(acc_dt))
            accs[r] = prod if accs[r] is None else accs[r] + prod

    def accumulate_tile(r, live, rs, cs, a_op, b_op):
        # the balanced schedules: one tile of rank r's accumulator
        if live:
            if accs[r] is None:
                accs[r] = torch.zeros((mb, nb), dtype=acc_dt, device=A.device)
            accs[r][rs, cs] += torch.matmul(a_op.to(acc_dt), b_op.to(acc_dt))

    def seg_live(r, s, ch):
        live = None
        if a_uplo is not None:
            live = _seg_live_a_global(xs[r], s, ch, mb, lk, w, a_uplo)
        if b_uplo is not None:
            lb = _seg_live_b_global(ys[r], s, ch, nb, lk, w, b_uplo)
            live = lb if live is None else (live and lb)
        if out_live[r] is not None:
            live = out_live[r] if live is None else (live and out_live[r])
        return live

    if c == 1:
        for ch in range(q):
            # gathered chunk: segment s holds global K-range [s*lk + ch*w, +w)
            a_ch = mesh.all_gather(grid, [a[:, ch * w:(ch + 1) * w] for a in a_blk], "y", 1)
            b_ch = mesh.all_gather(grid, [b[ch * w:(ch + 1) * w] for b in b_blk], "x", 0)
            for r in ranks:
                if cyclic_out:
                    T = cyclic_out
                    for ti in range(mb // T):
                        gi, rs = ti * d + xs[r], slice(ti * T, (ti + 1) * T)
                        for tj in range(nb // T):
                            gj, cs = tj * d + ys[r], slice(tj * T, (tj + 1) * T)
                            live = gi <= gj if out_uplo == "U" else gi >= gj
                            accumulate_tile(r, live, rs, cs, a_ch[r][rs], b_ch[r][:, cs])
                    continue
                if a_uplo is None and b_uplo is None:
                    accumulate(r, out_live[r], a_ch[r], b_ch[r])
                    continue
                if cyclic_rows:
                    T = cyclic_rows
                    for t in range(mb // T):
                        rs = slice(t * T, (t + 1) * T)
                        for s in range(d):
                            live = _seg_live_a_global(t * d + xs[r], s, ch, T, lk, w, a_uplo)
                            ks = slice(s * w, (s + 1) * w)
                            accumulate_tile(r, live, rs, slice(None), a_ch[r][rs, ks], b_ch[r][ks])
                    continue
                for s in range(d):
                    accumulate(r, seg_live(r, s, ch), a_ch[r][:, s * w:(s + 1) * w],
                               b_ch[r][s * w:(s + 1) * w])
    else:
        # per-step masked-psum broadcast of this layer's own d/c panels;
        # the broadcast is unconditional, only dead matmuls are skipped
        for i in range(spl):
            ks = [zs[r] * spl + i for r in ranks]  # each rank's global K-step
            for ch in range(q):
                a_sl = [a[:, ch * w:(ch + 1) * w] for a in a_blk]
                b_sl = [b[ch * w:(ch + 1) * w] for b in b_blk]
                a_pan = mesh.psum(grid, [a_sl[r] if ys[r] == ks[r] else torch.zeros_like(a_sl[r])
                                         for r in ranks], ("y",))
                b_pan = mesh.psum(grid, [b_sl[r] if xs[r] == ks[r] else torch.zeros_like(b_sl[r])
                                         for r in ranks], ("x",))
                for r in ranks:
                    accumulate(r, seg_live(r, ks[r], ch), a_pan[r], b_pan[r])

    parts = [
        (acc if acc is not None else torch.zeros((mb, nb), dtype=acc_dt, device=A.device)).to(wire)
        for acc in accs
    ]
    if c > 1:
        # chunked depth collect: q psums over column slices (uneven widths
        # when q does not divide the block; zero-width tails skipped)
        widths = [nb // q + (1 if j < nb % q else 0) for j in range(q)]
        pieces, off = [], 0
        for wd in widths:
            if wd:
                pieces.append(mesh.psum(grid, [p[:, off:off + wd] for p in parts], ("z",)))
                off += wd
        parts = [torch.cat([pc[r] for pc in pieces], 1) if len(pieces) > 1 else pieces[0][r]
                 for r in ranks]
    return mesh.assemble(grid, parts)


def _matmul(grid: Grid, A: torch.Tensor, B: torch.Tensor, mode: str,
            precision: str | None = None, a_uplo: str | None = None,
            b_uplo: str | None = None, out_uplo: str | None = None,
            cyclic_rows: int = 0, cyclic_out: int = 0, sched_override=None) -> torch.Tensor:
    """A @ B in `mode`.  The uplo flags describe triangular structure of the
    (already masked) operands or the result; only mode 'explicit' exploits
    them.  The model count `flops` stays dense; flops_vol / flops_max carry
    the skipping (tri_fractions, or the sched route's executed fraction).
    sched_override hands in a schedule built outside (_sched_pairs_cyclic:
    the persistent layout, whose liveness the gates cannot see)."""
    M, K, N = A.shape[0], A.shape[1], B.shape[1]
    flops, comm, ncoll = tracing.gemm_cost(grid, M, N, K, torch.promote_types(A.dtype, B.dtype))
    sched = None
    if mode == "explicit":
        if sched_override is not None:
            sched = sched_override
            mean_f = max_f = sched[1]
        elif _shard_kernels_gate(grid, M, K, N, a_uplo, b_uplo, out_uplo, cyclic_rows, cyclic_out):
            mean_f = max_f = 0.5  # per-shard live-tile kernels
        elif (sched := _shard_sched_gate(grid, M, K, N, a_uplo, b_uplo, out_uplo, cyclic_rows,
                                         cyclic_out)) is not None:
            # every rank runs the padded maximum schedule: mean == max
            mean_f = max_f = sched[1]
        else:
            mean_f, max_f = tri_fractions(grid, M, K, N, a_uplo, b_uplo, out_uplo,
                                          cyclic_rows=cyclic_rows, cyclic_out=cyclic_out)
    else:
        mean_f = max_f = 1.0  # dense + mask executes the full contraction
    tracing.emit(flops=flops, comm_bytes=comm, collectives=ncoll,
                 flops_vol=flops * mean_f, flops_max=flops * max_f)
    if mode in ("xla", "pallas"):
        return torch.matmul(A, B)
    if mode == "explicit":
        return _explicit_matmul(grid, A, B, precision, a_uplo, b_uplo, out_uplo, cyclic_rows,
                                cyclic_out, sched=sched)
    raise ValueError(f"unknown summa mode {mode!r}")


# --------------------------------------------------------------------------
# public ops
# --------------------------------------------------------------------------


def gemm(
    grid: Grid,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor | None = None,
    args: GemmArgs = GemmArgs(),
    mode: str = "xla",
) -> torch.Tensor:
    """C = alpha · op(A) @ op(B) + beta · C (reference summa.hpp:7-44) — a
    dense product with no dead blocks."""
    _check(mode)
    if args.beta != 0.0 and C is None:
        raise ValueError("beta != 0 requires the accumulate operand C")
    Aop = A.T if args.trans_a else A
    Bop = B.T if args.trans_b else B
    out = _matmul(grid, Aop, Bop, mode, args.precision)
    if args.alpha != 1.0:
        out = args.alpha * out
    if args.beta != 0.0:
        out = out + args.beta * C
    return out


def _kernel_route(grid: Grid, mode: str, M: int, N: int, K: int, dtype) -> None:
    """Cost attribution of the one-device kernel route: the executed flops
    are half the dense count (dead tiles skipped)."""
    flops, comm, ncoll = tracing.gemm_cost(grid, M, N, K, dtype)
    if mode == "explicit":
        tracing.note("explicit::copy_free")
        tracing.emit(flops=flops, comm_bytes=comm, collectives=ncoll,
                     flops_vol=flops / 2, flops_max=flops / 2)
    else:
        tracing.emit(flops=flops / 2, comm_bytes=comm, collectives=ncoll)


def _persistent_params(grid: Grid, mode: str, cyclic_tile: int, who: str):
    """Validate a balance='tile_cyclic_persistent' call.  It is a storage
    contract (the passed buffers ARE in the symmetric tile-cyclic layout),
    so a silent block fallback would read them as block-ordered: every
    violation raises."""
    d = grid.dx
    q = max(1, grid.num_chunks)
    if mode != "explicit" or grid.c != 1 or grid.dy != d or d < 2 or q != 1 or cyclic_tile < 1:
        raise ValueError(
            f"{who}: balance='tile_cyclic_persistent' requires "
            "mode='explicit' on an unchunked c==1 square face with d>1 and "
            f"an explicit cyclic_tile >= 1 (the layout's tile); got "
            f"mode={mode!r}, grid {grid.dx}x{grid.dy}x{grid.c}, chunks={q}, "
            f"cyclic_tile={cyclic_tile}"
        )
    return d, cyclic_tile


def _trmm_persistent(grid, A, B, args, mode, a_view, b_view, out, out_off, cyclic_tile):
    """trmm where every passed buffer is in the persistent symmetric
    tile-cyclic layout: windows by cyclic_window, the triangle masked at
    original indices (masking.take_triangle_cyclic), the per-rank products
    on `hopper.sched_matmul` over _sched_pairs_cyclic's schedule, and the
    product already in layout — written back band-sized into `out`."""
    d, t = _persistent_params(grid, mode, cyclic_tile, "trmm")
    if args.diag == "U":
        raise ValueError("tile_cyclic_persistent trmm does not support diag='U'")
    Aw = cyclic_window(A, a_view, d, t) if a_view is not None else A
    Bw = cyclic_window(B, b_view, d, t) if b_view is not None else B
    T = masking.take_triangle_cyclic(Aw, args.uplo, d, t)
    Top = T.T if args.trans_a else T
    eff_uplo = args.uplo if not args.trans_a else ("L" if args.uplo == "U" else "U")
    # the window-sized residue of data motion: mask, windows, transpose
    cb = _copy_bytes_of((2.0, Aw))
    if a_view is not None:
        cb += _copy_bytes_of((2.0, Aw))
    if args.trans_a:
        cb += _copy_bytes_of((2.0, Aw))
    if b_view is not None:
        cb += _copy_bytes_of((2.0, Bw))
    if args.side == "L":
        P, Q, au, bu = Top, Bw, eff_uplo, None
    elif args.side == "R":
        P, Q, au, bu = Bw, Top, None, eff_uplo
    else:
        raise ValueError(f"side must be 'L' or 'R', got {args.side!r}")
    sched = _sched_pairs_cyclic(grid, P.shape[0], P.shape[1], Q.shape[1], au, bu, t)
    if sched is None:
        tracing.note("trmm::persistent_dense")
        res = _matmul(grid, P, Q, mode, args.precision)
    else:
        tracing.note("trmm::persistent_cyclic")
        res = _matmul(grid, P, Q, mode, args.precision, a_uplo=au, b_uplo=bu,
                      sched_override=sched)
    if args.alpha != 1.0:
        res = args.alpha * res
    if out is not None:
        cb += _copy_bytes_of((4.0, res))  # band-sized read-modify-write
        tracing.emit(copy_bytes=cb / grid.num_devices)
        return cyclic_window_update(out, res, (out_off[0], out_off[1], *res.shape), d, t)
    tracing.emit(copy_bytes=cb / grid.num_devices)
    return res


def _syrk_persistent(grid, A, C, args, mode, a_view, c_view, in_place, cyclic_tile):
    """syrk under the persistent layout: the cyclic_out schedule runs on
    the operands as they lie (no per-call shuffles), the symmetrize masks at
    original indices, and in_place writes back through
    cyclic_window_update."""
    d, t = _persistent_params(grid, mode, cyclic_tile, "syrk")
    Aw = cyclic_window(A, a_view, d, t) if a_view is not None else A
    cb = _copy_bytes_of((2.0, Aw))  # the .T below
    if a_view is not None:
        cb += _copy_bytes_of((2.0, Aw))
    Aop = (Aw.T, Aw) if args.trans else (Aw, Aw.T)
    D = _matmul(grid, Aop[0], Aop[1], mode, args.precision, out_uplo=args.uplo, cyclic_out=t)
    tracing.note("syrk::persistent_cyclic")
    live = masking.take_triangle_cyclic(D, args.uplo, d, t)
    strict = masking.take_triangle_cyclic(D, args.uplo, d, t, strict=True)
    out = live + transpose(grid, strict)
    cb += _copy_bytes_of((4.0, D))  # the two masks
    if args.alpha != 1.0:
        out = args.alpha * out
    if args.beta != 0.0:
        Cw = cyclic_window(C, c_view, d, t) if c_view is not None else C
        out = out + args.beta * Cw
        if c_view is not None:
            cb += _copy_bytes_of((2.0, Cw))
    if in_place:
        r0, c0 = (c_view[0], c_view[1]) if c_view is not None else (0, 0)
        cb += _copy_bytes_of((4.0, out))
        tracing.emit(copy_bytes=cb / grid.num_devices)
        return cyclic_window_update(C, out, (r0, c0, *out.shape), d, t)
    tracing.emit(copy_bytes=cb / grid.num_devices)
    return out


def trmm(
    grid: Grid,
    A: torch.Tensor,
    B: torch.Tensor,
    args: TrmmArgs = TrmmArgs(),
    mode: str = "xla",
    *,
    a_view: tuple[int, int, int, int] | None = None,
    b_view: tuple[int, int, int, int] | None = None,
    out: torch.Tensor | None = None,
    out_off: tuple[int, int] = (0, 0),
    balance: str = "block",
    cyclic_tile: int = 0,
) -> torch.Tensor:
    """alpha · op(tri(A)) @ B (side 'L') or alpha · B @ op(tri(A)) (side
    'R') — reference summa.hpp:47-83.  With `out` the result is written into
    `out` at out_off in place and `out` is returned.

    balance='tile_cyclic' (explicit, side L, c == 1 square faces with d > 1):
    the triangular operand's rows go into tile_cyclic_perm order, the
    balanced cyclic_rows schedule runs, the product comes back un-permuted —
    two row-shuffles priced as grid transposes; elsewhere the block
    schedule runs with a 'trmm::tile_cyclic_fallback' note.  cyclic_tile
    overrides the picked tile.  balance='tile_cyclic_persistent': every
    buffer is in the layout of tile cyclic_tile (see _trmm_persistent);
    unsupported grids raise."""
    _check(mode)
    if args.side not in ("L", "R"):
        raise ValueError(f"side must be 'L' or 'R', got {args.side!r}")
    a_dims = (a_view[2], a_view[3]) if a_view is not None else tuple(A.shape)
    b_dims = (b_view[2], b_view[3]) if b_view is not None else tuple(B.shape)
    if (mode in ("pallas", "explicit") and grid.num_devices == 1 and args.diag != "U"
            and balance != "tile_cyclic_persistent"):
        if balance == "tile_cyclic":
            # one device skips dead tiles in the kernel: no balanced schedule
            tracing.note("trmm::tile_cyclic_fallback")
        _kernel_route(grid, mode, b_dims[0], b_dims[1], a_dims[0],
                      torch.promote_types(A.dtype, B.dtype))
        if args.side == "L":
            return hopper.tri_matmul(
                A, B, a_uplo=args.uplo, a_trans=args.trans_a, alpha=args.alpha,
                precision=args.precision, a_view=a_view, b_view=b_view,
                out=out, out_off=out_off,
            )
        return hopper.tri_matmul(
            B, A, b_uplo=args.uplo, b_trans=args.trans_a, alpha=args.alpha,
            precision=args.precision, a_view=b_view, b_view=a_view,
            out=out, out_off=out_off,
        )
    if balance == "tile_cyclic_persistent":
        return _trmm_persistent(grid, A, B, args, mode, a_view, b_view, out, out_off, cyclic_tile)
    # the materialising route: windows, triangle mask, _matmul, write-back
    Aw, Bw = _window(A, a_view), _window(B, b_view)
    T = masking.take_triangle(Aw, args.uplo)
    if args.diag == "U":
        T = masking.with_unit_diagonal(T)
    Top = T.T if args.trans_a else T
    # transposing a triangular operand flips its triangle; explicit mode
    # skips dead K-segments / tiles by it
    eff_uplo = args.uplo if not args.trans_a else ("L" if args.uplo == "U" else "U")
    res = None
    if balance == "tile_cyclic":
        M = Top.shape[0] if args.side == "L" else 0
        tile = _pick_cyclic_tile(grid, M, cyclic_tile) if (mode == "explicit" and args.side == "L") else 0
        if tile:
            perm, inv = tile_cyclic_perm(M, grid.dx, tile)
            # two row-shuffles priced as grid transposes: the M x M
            # triangular operand in, the M x N product out
            comm_a, nc_a = tracing.transpose_cost(grid, M, M, Top.dtype)
            comm_o, nc_o = tracing.transpose_cost(grid, M, Bw.shape[1], Top.dtype)
            tracing.emit(comm_bytes=comm_a + comm_o, collectives=nc_a + nc_o)
            dev = Top.device
            res = _matmul(grid, Top[torch.from_numpy(perm).to(dev)], Bw, mode, args.precision,
                          a_uplo=eff_uplo, cyclic_rows=tile)
            res = res[torch.from_numpy(inv).to(dev)]
        else:
            tracing.note("trmm::tile_cyclic_fallback")
    if res is None:
        if args.side == "L":
            res = _matmul(grid, Top, Bw, mode, args.precision, a_uplo=eff_uplo)
        else:
            res = _matmul(grid, Bw, Top, mode, args.precision, b_uplo=eff_uplo)
    if args.alpha != 1.0:
        res = args.alpha * res
    # copy-bytes attribution of this route, per device: triangle mask,
    # window slices, unit diagonal, transpose, write-back round-trip
    cb = _copy_bytes_of((2.0, T))
    if a_view is not None:
        cb += _copy_bytes_of((2.0, T))
    if args.diag == "U":
        cb += _copy_bytes_of((2.0, T))
    if args.trans_a:
        cb += _copy_bytes_of((2.0, T))
    if b_view is not None:
        cb += _copy_bytes_of((2.0, Bw))
    if out is None:
        tracing.emit(copy_bytes=cb / grid.num_devices)
        return res
    cb += _copy_bytes_of((2.0, out))
    tracing.emit(copy_bytes=cb / grid.num_devices)
    _window(out, (out_off[0], out_off[1], *res.shape)).copy_(res)
    return out


def syrk(
    grid: Grid,
    A: torch.Tensor,
    C: torch.Tensor | None = None,
    args: SyrkArgs = SyrkArgs(),
    mode: str = "xla",
    *,
    a_view: tuple[int, int, int, int] | None = None,
    c_view: tuple[int, int, int, int] | None = None,
    in_place: bool = False,
    balance: str = "block",
    cyclic_tile: int = 0,
) -> torch.Tensor:
    """C = alpha·AᵀA + beta·C (trans) or alpha·AAᵀ + beta·C.

    mode 'pallas'/'explicit' on one device computes only the args.uplo
    triangle: with beta == 0 the other half is zero, with beta != 0 it is
    UNDEFINED, so callers read only args.uplo.  Elsewhere the full
    symmetric result is computed ('explicit' on a mesh computes the
    args.uplo blocks and symmetrizes with one grid transpose).  in_place
    (beta != 0 and C given) writes the update into C's c_view window and
    returns C itself — the caller's C is modified.

    balance='tile_cyclic' (explicit on a c == 1 square face with d > 1):
    A's free axis is permuted in and both output axes out (three shuffles,
    priced), the balanced cyclic_out schedule runs between; elsewhere a
    'syrk::tile_cyclic_fallback' note.  balance='tile_cyclic_persistent':
    see _syrk_persistent."""
    _check(mode)
    if args.beta != 0.0 and C is None:
        raise ValueError("beta != 0 requires the accumulate operand C")
    if in_place and (args.beta == 0.0 or C is None):
        raise ValueError("in_place syrk requires the accumulate operand C")
    if mode in ("pallas", "explicit") and grid.num_devices == 1 and balance != "tile_cyclic_persistent":
        if balance == "tile_cyclic":
            tracing.note("syrk::tile_cyclic_fallback")
        a_dims = (a_view[2], a_view[3]) if a_view is not None else tuple(A.shape)
        n_out = a_dims[1] if args.trans else a_dims[0]
        k_in = a_dims[0] if args.trans else a_dims[1]
        _kernel_route(grid, mode, n_out, n_out, k_in, A.dtype)
        out_kw = {}
        if in_place:
            out_kw = dict(out=C, out_off=(c_view[0], c_view[1]) if c_view is not None else (0, 0))
        return hopper.tri_matmul(
            A, A, a_trans=args.trans, b_trans=not args.trans, out_uplo=args.uplo,
            alpha=args.alpha, precision=args.precision, a_view=a_view, b_view=a_view,
            c=C, c_view=c_view, beta=args.beta, **out_kw,
        )
    if balance == "tile_cyclic_persistent":
        return _syrk_persistent(grid, A, C, args, mode, a_view, c_view, in_place, cyclic_tile)
    Aw = _window(A, a_view)
    if balance == "tile_cyclic" and mode != "explicit":
        tracing.note("syrk::tile_cyclic_fallback")
    if mode == "explicit":
        cyc, inv = 0, None
        if balance == "tile_cyclic":
            n_out = Aw.shape[1] if args.trans else Aw.shape[0]
            T = _pick_cyclic_tile(grid, n_out, cyclic_tile)
            if T:
                perm, inv = tile_cyclic_perm(n_out, grid.dx, T)
                pj = torch.from_numpy(perm).to(Aw.device)
                Aw = Aw[:, pj] if args.trans else Aw[pj, :]
                cyc = T
                # three shuffles at their true shapes: A in, C's rows and
                # columns out
                ca, na = tracing.transpose_cost(grid, *Aw.shape, Aw.dtype)
                cc, nc = tracing.transpose_cost(grid, n_out, n_out, Aw.dtype)
                tracing.emit(comm_bytes=ca + 2 * cc, collectives=na + 2 * nc)
            else:
                tracing.note("syrk::tile_cyclic_fallback")
        Aop = (Aw.T, Aw) if args.trans else (Aw, Aw.T)
        D = _matmul(grid, Aop[0], Aop[1], mode, args.precision, out_uplo=args.uplo,
                    cyclic_out=cyc)
        if cyc:
            ij = torch.from_numpy(inv).to(D.device)
            D = D[ij][:, ij]
        if args.uplo == "U":
            out = torch.triu(D) + transpose(grid, torch.triu(D, 1))
        else:
            out = torch.tril(D) + transpose(grid, torch.tril(D, -1))
    else:
        Aop = (Aw.T, Aw) if args.trans else (Aw, Aw.T)
        out = _matmul(grid, Aop[0], Aop[1], mode, args.precision)
    if args.alpha != 1.0:
        out = args.alpha * out
    # copy-bytes attribution (see trmm): the .T operand, window slices, the
    # symmetrize's two triangle masks, the write-back round-trip
    cb = _copy_bytes_of((2.0, Aw))
    if a_view is not None:
        cb += _copy_bytes_of((2.0, Aw))
    if mode == "explicit":
        cb += _copy_bytes_of((4.0, out))
    if args.beta != 0.0:
        Cw = _window(C, c_view)
        out = out + args.beta * Cw
        if c_view is not None:
            cb += _copy_bytes_of((2.0, Cw))
    if not in_place:
        tracing.emit(copy_bytes=cb / grid.num_devices)
        return out
    cb += _copy_bytes_of((2.0, C))
    tracing.emit(copy_bytes=cb / grid.num_devices)
    off = (c_view[0], c_view[1]) if c_view is not None else (0, 0)
    _window(C, (off[0], off[1], *out.shape)).copy_(out)
    return C


def transpose(grid: Grid, A: torch.Tensor) -> torch.Tensor:
    """Aᵀ as a new row-major tensor: the grid transpose (each rank swaps its
    block with the mirrored rank), priced by tracing.transpose_cost."""
    comm, ncoll = tracing.transpose_cost(grid, A.shape[0], A.shape[1], A.dtype)
    tracing.emit(comm_bytes=comm, collectives=ncoll)
    return A.T.contiguous()
