"""CholeskyQR2's fused tall passes on Hopper (counterpart of
capital_tpu/ops/qr_fused.py).

The 1d CQR2 pipeline (models/qr.py) is three passes over the tall m x n
operand:

* ``gram_blocked`` — the upper block-row gram at column split g: block row j
  (rows jc..(j+1)c, c = n/g) holds (AᵀA)[jc:(j+1)c, jc:]; the strictly lower
  block triangle is zero.  (g+1)/2g of the dense flops.
* ``scale_gram`` — Q = A·R⁻¹ (R⁻¹ upper triangular with true zeros below the
  diagonal), Q rounded to A's dtype, then the gram of the ROUNDED Q in the
  same layout: sweep 1's scale and sweep 2's gram in one call.
* ``scale_blocked`` — Q = A·R⁻¹ alone (CQR2's final scale).

Each is a wrapper, a plain version and a launch counter, as in ops/hopper.py:
the wrapper validates its arguments with the JAX package's rule
(`_shape_gate`, same message), launches the hand-written kernel
(ops/csrc/qr_fused.cu) for CUDA tensors and runs the plain version for CPU
tensors — no other route.  The counters are `hopper.KERNELS["qr.*"]`, with
each launch tallied by route, as `hopper._ROUTES` names each dtype's fast
route: 'wgmma' for bf16 (the TMA + wgmma ring of ops/csrc/wgmma_tiles.cuh),
'dmma' for f64 and 'fma' for f32 (the DMMA and FMA loops of
ops/csrc/mm_tiles.cuh); f32 at precision 'high' takes 'x3', the JAX
package's bf16x3 split (`hopper.split_high`): the wrapper allocates a
workspace for the operands' bf16 hi / lo images, the kernel splits them
into it and runs the wgmma ring on them (ops/csrc/x3_tiles.cuh).  The plain
versions follow the JAX kernels' block structure: row blocks of `bm`
accumulated in turn into the gram, g column blocks, the zero block
triangle, each product at the call's precision (`hopper.split_matmul`).
The gram accumulates in f32 (f64 for f64).
"""

from __future__ import annotations

from fractions import Fraction

import torch

from capital_tpu_torch.ops import _build, hopper

#: output tile edge of every gram and scale kernel (ops/csrc/qr_fused.cu TILE)
_GRAM_TILE = 128
#: SMs of the H100
_SMS = 132
#: gram blocks an SM holds: the bf16 wgmma ring (128 KB) and the f64 DMMA
#: ring (198 KB) one, the f32 FMA loop two — each gram kernel's
#: `__launch_bounds__` minimum (ops/csrc/mm_tiles.cuh D_MINB / F_MINB), which
#: tests/test_torch_qr_kernels.py reads from the sources
_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 2, torch.float64: 1}
#: rows of the k-tiles a row split is made of (ops/csrc/qr_fused.cu SPLIT_ROWS)
_SPLIT_ROWS = 64
#: most row splits: each is an n x n partial for the finalize to sum
_MAX_SPLITS = 32
#: rows per step of the plain scale (values do not depend on it)
_PLAIN_SCALE_ROWS = 1 << 16


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation for sub-f32 operands, f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _pick_bm(m: int, preferred: int) -> int:
    bm = preferred
    while bm >= 256 and m % bm:
        bm //= 2
    return bm if m % bm == 0 else 0


def live_fraction(g: int) -> float:
    """Executed fraction of the dense contraction at column split g."""
    return (g + 1) / (2.0 * g) if g > 1 else 1.0


def _eligible(m: int, n: int, bm: int = 1024, g: int = 2) -> int:
    """The one eligibility rule of every fused tall pass: g-way column
    blocks that are 128-multiples of at least 128 (g=2 also needs
    n/2 >= 256) and a row block that tiles m.  Returns the picked bm, or 0
    if ineligible."""
    if g < 2 or n % (g * 128):
        return 0
    if g == 2 and n // 2 < 256:
        return 0
    return _pick_bm(m, bm)


def _shape_gate(name: str, m: int, n: int, bm: int, g: int) -> int:
    bm = _eligible(m, n, bm, g)
    if bm == 0:
        raise ValueError(
            f"{name} needs bm | m and a {g}-way 128-aligned column split "
            f"(n % {g * 128} == 0), got {(m, n)}"
        )
    return bm


def pick_g(n: int, override: int = 0) -> int:
    """Column split of the fused passes: the largest g whose blocks stay
    128 wide (the JAX package's rule)."""
    if override:
        return override if _eligible(1 << 20, n, 1024, override) else 0
    g = 2
    while n % (2 * g * 128) == 0:
        g *= 2
    return g if _eligible(1 << 20, n, 1024, g) else 0


def assemble_sym(Gu: torch.Tensor, c: int) -> torch.Tensor:
    """Symmetric gram from the upper block-row form with block width c
    (every strictly lower block is the transpose of its mirror)."""
    G = Gu.clone()
    n = G.shape[0]
    for i in range(1, n // c):
        G[i * c:(i + 1) * c, : i * c] = G[: i * c, i * c:(i + 1) * c].T
    return G


def fused_plan(grid, m: int, n: int, mode: str, bm: int = 1024, g: int = 2,
               *, dtype) -> str | None:
    """Which fused CQR2 pipeline runs: 'full' (gram_blocked, scale_gram,
    scale_blocked) for every eligible shape in mode 'pallas', else None.
    On a mesh the kernels run once per rank on its m/p rows
    (models/qr._cqr2_fused_sharded): the rows must divide over the ranks
    and eligibility is the per-rank extent's.

    The JAX rule also answers 'split' and 'panels' where a kernel's VMEM
    envelope would be exceeded; the card has no such envelope, so its
    answer is the one the JAX rule gives where no VMEM applies.  The
    'split' and 'panels' tiers stay callable directly
    (models/qr._cqr2_fused, _cqr2_panels)."""
    del dtype  # no envelope depends on it here
    p = grid.num_devices
    if p > 1 and m % p:
        return None
    if mode == "pallas" and _eligible(m // p, n, bm, g):
        return "full"
    return None


def fused_ok(grid, m: int, n: int, mode: str, bm: int = 1024, g: int = 2,
             *, dtype) -> bool:
    """True when a fused pipeline tier can run (see fused_plan)."""
    return fused_plan(grid, m, n, mode, bm, g, dtype=dtype) is not None


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _gram_into(G: torch.Tensor, X: torch.Tensor, bm: int, g: int, precision) -> torch.Tensor:
    n = X.shape[1]
    c = n // g
    split = hopper.split_high(X.dtype, X.dtype, precision)
    for r0 in range(0, X.shape[0], bm):
        Xb = X[r0:r0 + bm].to(G.dtype)
        for j in range(g):
            G[j * c:(j + 1) * c, j * c:] += hopper.split_matmul(
                Xb[:, j * c:(j + 1) * c].T, Xb[:, j * c:], split)
    return G


def _scale(A: torch.Tensor, Rinv: torch.Tensor, g: int, precision) -> torch.Tensor:
    m, n = A.shape
    c = n // g
    acc = _acc_dtype(A.dtype)
    split = hopper.split_high(A.dtype, Rinv.dtype, precision)
    R = Rinv.to(acc)
    Q = torch.empty_like(A)
    for r0 in range(0, m, _PLAIN_SCALE_ROWS):
        Ab = A[r0:r0 + _PLAIN_SCALE_ROWS].to(acc)
        for j in range(g):
            Q[r0:r0 + Ab.shape[0], j * c:(j + 1) * c] = hopper.split_matmul(
                Ab[:, :(j + 1) * c], R[:(j + 1) * c, j * c:(j + 1) * c], split,
            ).to(A.dtype)
    return Q


def _check_rinv(A: torch.Tensor, Rinv: torch.Tensor) -> None:
    n = A.shape[1]
    if tuple(Rinv.shape) != (n, n):
        raise ValueError(f"Rinv {tuple(Rinv.shape)} does not match A {tuple(A.shape)}")


def gram_blocked_plain(A, *, bm: int = 1024, g: int = 2, precision=None):
    """Plain PyTorch version of `gram_blocked`."""
    m, n = A.shape
    bm = _shape_gate("gram_blocked", m, n, bm, g)
    G = torch.zeros((n, n), dtype=_acc_dtype(A.dtype), device=A.device)
    return _gram_into(G, A, bm, g, precision)


def scale_blocked_plain(A, Rinv, *, bm: int = 1024, g: int = 2, precision=None):
    """Plain PyTorch version of `scale_blocked`."""
    m, n = A.shape
    _check_rinv(A, Rinv)
    _shape_gate("scale_blocked", m, n, bm, g)
    return _scale(A, Rinv, g, precision)


def scale_gram_plain(A, Rinv, *, bm: int = 1024, g: int = 2, precision=None):
    """Plain PyTorch version of `scale_gram`: the scale, then the gram of
    the rounded Q."""
    m, n = A.shape
    _check_rinv(A, Rinv)
    bm = _shape_gate("scale_gram", m, n, bm, g)
    Q = _scale(A, Rinv, g, precision)
    G = torch.zeros((n, n), dtype=_acc_dtype(A.dtype), device=A.device)
    return Q, _gram_into(G, Q, bm, g, precision)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def gram_tiles(n: int, g: int) -> list[tuple[int, int]]:
    """The gram kernel's live output tiles (tile row, tile column) in the
    order of its blocks (`live_tile` in ops/csrc/qr_fused.cu): tile row i
    from the first column of its block row to the last."""
    T = _GRAM_TILE
    c, nt = n // g, n // T
    return [(i, j) for i in range(nt) for j in range((i * T // c) * (c // T), nt)]


def gram_split_rows(m: int, splits: int) -> list[tuple[int, int]]:
    """Rows [r0, r1) of each row split of the gram: split q takes the
    64-row k-tiles [q·K/S, (q+1)·K/S) of the K = ceil(m/64), whole k-tiles
    whose counts differ by at most one (`split_rows` in
    ops/csrc/qr_fused.cu, every dtype)."""
    kt = -(-m // _SPLIT_ROWS)
    return [(min(m, q * kt // splits * _SPLIT_ROWS), min(m, (q + 1) * kt // splits * _SPLIT_ROWS))
            for q in range(splits)]


def gram_splits(m: int, n: int, g: int, dtype: torch.dtype, precision=None) -> int:
    """Row splits of the gram kernel: the fewest splits, at most 32 and at
    most one per 64-row k-tile, whose blocks need the fewest waves of the
    card's block slots (132 SMs x `_BLOCKS_PER_SM`; the x3 route, f32 at
    precision 'high', holds one block an SM as the bf16 ring does) per
    split.  At 65536 x 512, g=4 (10 live tiles): f64 13 splits (130
    blocks, one wave of 132), f32 26 (260 of 264 slots); the bf16 QR
    flagship 11 (36 x 11 = 396 = 3 whole waves)."""
    live = len(gram_tiles(n, g))
    per_sm = 1 if hopper.split_high(dtype, dtype, precision) else _BLOCKS_PER_SM[dtype]
    slots = _SMS * per_sm
    most = min(_MAX_SPLITS, -(-m // _SPLIT_ROWS))
    return min(range(1, most + 1), key=lambda s: (Fraction(-(-live * s // slots), s), s))


def _route(A: torch.Tensor, precision=None) -> str:
    """The route every launch of A's dtype at `precision` takes (its fast
    route: 'x3' for f32 at 'high')."""
    return hopper._routes(A.dtype, precision)[0]


def _images(A: torch.Tensor, route: str, *windows):
    """The x3 route's workspace for the images of the (rows, cols)
    operands (None on the other routes)."""
    return hopper._x3_work(A.device, *windows) if route == "x3" else None


def _data_ptr(X):
    return X.data_ptr() if X is not None else None


def _kernel_args(A: torch.Tensor, what: str) -> None:
    hopper._kernel_operand(A, what)
    if A.data_ptr() % 16 or (A.stride(0) * A.element_size()) % 16:
        raise ValueError(f"{what}: the kernels read 16-byte aligned rows")


def _gram_out(A: torch.Tensor, m: int, n: int, g: int, precision):
    acc = _acc_dtype(A.dtype)
    G = torch.empty((n, n), dtype=acc, device=A.device)
    splits = gram_splits(m, n, g, A.dtype, precision)
    work = torch.empty((splits, n, n), dtype=acc, device=A.device) if splits > 1 else None
    return G, work, splits


def _scale_operands(A, Rinv):
    _kernel_args(A, "A")
    _kernel_args(Rinv, "Rinv")
    if Rinv.dtype != A.dtype:
        raise TypeError(f"qr_fused kernel: Rinv is {Rinv.dtype}, A is {A.dtype}")


def gram_blocked(A, *, bm: int = 1024, g: int = 2, precision=None):
    """Upper block-row gram of tall-skinny A at the g-way split: (n, n) in
    f32 (f64 for f64), block row j valid from column j·(n/g), the strictly
    lower block triangle zero (ops/csrc/qr_fused.cu; the JAX package's
    qr_fused.gram_blocked).  `bm` enters only the shape rule."""
    m, n = A.shape
    _shape_gate("gram_blocked", m, n, bm, g)
    if not hopper._on_card(A):
        return gram_blocked_plain(A, bm=bm, g=g, precision=precision)
    _kernel_args(A, "A")
    G, work, splits = _gram_out(A, m, n, g, precision)
    route = _route(A, precision)
    images = _images(A, route, (m, n))
    rc = _build.entry("capital_gram_blocked")(
        hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0), m, n, g,
        G.data_ptr(), _data_ptr(work), splits, _data_ptr(images), hopper._stream(),
    )
    hopper._launched(rc, hopper.KERNELS["qr.gram_blocked"], route)
    return G


def scale_gram(A, Rinv, *, bm: int = 1024, g: int = 2, precision=None):
    """(Q, G) = (A @ Rinv rounded to A's dtype, the upper block-row gram of
    that rounded Q) in one call (ops/csrc/qr_fused.cu; qr_fused.scale_gram).
    Rinv must be upper triangular with true zeros below the diagonal (the
    kernel skips them); on the card it has A's dtype."""
    m, n = A.shape
    _check_rinv(A, Rinv)
    _shape_gate("scale_gram", m, n, bm, g)
    if not hopper._on_card(A, Rinv):
        return scale_gram_plain(A, Rinv, bm=bm, g=g, precision=precision)
    _scale_operands(A, Rinv)
    Q = torch.empty_like(A, memory_format=torch.contiguous_format)
    G, work, splits = _gram_out(A, m, n, g, precision)
    route = _route(A, precision)
    images = _images(A, route, (m, n), (n, n))  # Q's images reuse A's once the scale is done
    rc = _build.entry("capital_scale_gram")(
        hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0), Rinv.data_ptr(),
        Rinv.stride(0), Q.data_ptr(), Q.stride(0), m, n, g, G.data_ptr(),
        _data_ptr(work), splits, _data_ptr(images), hopper._stream(),
    )
    hopper._launched(rc, hopper.KERNELS["qr.scale_gram"], route)
    return Q, G


def scale_blocked(A, Rinv, *, bm: int = 1024, g: int = 2, precision=None):
    """Q = A @ Rinv in A's dtype, Rinv upper triangular with true zeros
    below the diagonal (ops/csrc/qr_fused.cu; qr_fused.scale_blocked)."""
    m, n = A.shape
    _check_rinv(A, Rinv)
    _shape_gate("scale_blocked", m, n, bm, g)
    if not hopper._on_card(A, Rinv):
        return scale_blocked_plain(A, Rinv, bm=bm, g=g, precision=precision)
    _scale_operands(A, Rinv)
    Q = torch.empty_like(A, memory_format=torch.contiguous_format)
    route = _route(A, precision)
    images = _images(A, route, (m, n), (n, n))
    rc = _build.entry("capital_scale_blocked")(
        hopper._DTYPE_CODE[A.dtype], A.data_ptr(), A.stride(0), Rinv.data_ptr(),
        Rinv.stride(0), Q.data_ptr(), Q.stride(0), m, n, _data_ptr(images), hopper._stream(),
    )
    hopper._launched(rc, hopper.KERNELS["qr.scale_blocked"], route)
    return Q
