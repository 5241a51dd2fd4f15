"""Block-tridiagonal scan-step kernels on Hopper (counterpart of
capital_tpu/ops/blocktri_small.py): `seg` chain blocks per launch, one CUDA
block per problem.

`models/blocktri.py` factors a block-tridiagonal SPD chain

    A = [[D_1, C_2ᵀ            ],
         [C_2, D_2, C_3ᵀ       ],
         [     C_3, D_3, ...   ]]

as A = L̃·L̃ᵀ with L̃_ii = L_i = chol(D_i − W_i·W_iᵀ) and
L̃_{i,i−1} = W_i = C_i·L_{i−1}⁻ᵀ.  The chain is sequential, so the models
layer drives it as a host loop of launches; these kernels are the loop
body: one launch runs `seg` consecutive chain blocks of every problem, with
the running diagonal factor carried in shared memory from one block to the
next (block i's factor is born on chip and consumed by block i+1's
triangular solve without a trip through device memory).

* ``fused_forward_step``: the factor recurrence and the forward sweep
  y_i = L_i⁻¹(b_i − Wt_iᵀ·y_{i−1}) in one pass (posv).
* ``factor_step``: the factor recurrence alone (factor, extend).
* ``forward_solve_step``: the forward sweep from a ready factor (solve).
* ``solve_backward_step``: x_i = L_i⁻ᵀ(y_i − Wt_{i+1}·x_{i+1}), blocks in
  descending order (posv, solve).

Carried representation, as in the JAX package: Wt = Wᵀ (Wt_i solves
L_{i−1}·Wt_i = C_iᵀ), L masked lower (zeros above the diagonal), Wt_1 = 0.
The carry into the first block is (L_0 = I, y_0 = 0) and C_1 must be zero
(the models layer zeroes it), so step one computes Wt_1 = 0 and S_1 = D_1
exactly.

Each kernel is a wrapper, a plain version and a launch counter
(`hopper.KERNELS["bt.*"]`), as in ops/batched_small.py.  The wrapper
validates shapes and dtype (bf16 or f32; f64 raises TypeError — the
kernels compute in f32 and would downgrade it), launches the hand-written
kernel (ops/csrc/blocktri_small.cu) for CUDA tensors and runs the plain
version for CPU tensors.  The plain versions loop over the `seg` blocks
with the column sweeps of ops/sweeps.py, so `info` follows the JAX
kernel's convention exactly (per block 0 / j / b+1, with its spreading of
non-finite values); the models layer min-combines it to a global pivot.

Shared memory (`smem_bytes`): the (b, b) tiles are resident in f32 and the
right-hand sides stream through a stage of `stage_cols` columns (columns
are independent), with the carried y_{i−1} / x_{i+1} kept in f32 in a
device-memory scratch between blocks, or in the stage itself where a
block's columns fit one chunk (the solve steps' 'blocked' route).  So every
RHS width fits beside the tiles, and the envelope is one of b alone.

Every step runs on one of two routes (`chain_route`, tallied in
`hopper.route_counts()`).  'blocked': 16-byte-row tiles, Wt by the blocked
forward solve, S −= Wtᵀ·Wt in 4 x 4 register tiles, potrf's blocked factor
(`chol_blocked`, the column sweep only for a faulted block); the coupling
products of the right-hand sides in 4 x 4 register tiles and their
triangular solves blocked (`fwd_blocked`, `bwd_upper_blocked`); the RHS
columns of the solve steps and the fused step split over `rhs_splits`
CUDA blocks a problem, so that a small batch fills the SMs.  'sweep':
odd-ld tiles and the column sweeps, one CUDA block a problem — b = 137
and 138 for the factor steps, 165 to 169 for the solve steps.  Both apply
the sweeps' operations in the sweeps' order, so they compute the same
bits, and a split changes none.

`block` (the JAX kernels' static column unroll) is validated and changes
nothing here; `precision` is IEEE f32 either way.
"""

from __future__ import annotations

import functools

import torch

from capital_tpu_torch.ops import _build, hopper, sweeps
from capital_tpu_torch.ops.batched_small import _resolve_block

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

#: resident (b, b) f32 tiles per kernel: the carried factor, Wt and the
#: Schur complement for the factor steps; L and Wt for the solve steps
_TILES = {"fused_forward": 3, "factor": 3, "forward_solve": 2, "solve_backward": 2}
#: the factor steps, whose blocked route keeps three tiles
_FACTOR_KERNELS = ("fused_forward", "factor")
#: the kernels whose right-hand-side columns split over CUDA blocks on the
#: blocked route (`rhs_splits`); the fused step's split blocks each run the
#: factor recurrence again, on SMs the batch leaves idle
_SPLIT_KERNELS = ("fused_forward", "forward_solve", "solve_backward")
#: the C entries' route codes (csrc/blocktri_small.cu)
_ROUTE_CODE = {"sweep": 0, "blocked": 1}
#: streaming multiprocessors of the card the column split fills (H100 SXM)
SMS = 132


def _odd_ld(b: int) -> int:
    return b + 1 if b % 2 == 0 else b


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _blocked_ld(b: int) -> int:
    """The blocked route's leading dimension (csrc chain_ld): round4(b)
    floats (16-byte rows), plus 4 when that makes it 4 mod 8.  A stage of
    kc columns takes `_blocked_ld(kc)` too."""
    b4 = _round4(b)
    return b4 if (b4 // 4) % 2 else b4 + 4


def _budget() -> int:
    return hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE


def _kernel(kernel: str) -> str:
    if kernel not in _TILES:
        raise ValueError(f"unknown blocktri_small kernel {kernel!r}")
    return kernel


def _blocked_tile(b: int) -> int:
    """Floats of one blocked-route tile: round4(b) rows of `_blocked_ld(b)`."""
    return _round4(b) * _blocked_ld(b)


def _blocked_stage(b: int, kc: int) -> int:
    """Floats of the blocked route's RHS stage: two buffers (the columns
    being solved, the carried neighbour) of round4(b) rows of
    `_blocked_ld(kc)` floats."""
    return 2 * _round4(b) * _blocked_ld(kc)


def chain_route(b: int, kernel: str = "factor") -> str:
    """The route `kernel` takes for chain blocks of order b on the card,
    tallied in `hopper.route_counts()`: 'blocked' where its 16-byte-row
    tiles and a stage of one 4-column group fit a block, else 'sweep' (odd-ld
    tiles, the column sweeps).  Both compute the same bits.

    * the factor steps (fused_forward, factor): three tiles and one staged
      column — b <= 136; 'sweep' takes b up to 138;
    * the solve steps (forward_solve, solve_backward): two tiles and a
      stage of round4(b) x 4 floats twice — b <= 164; 'sweep' takes b up to
      169."""
    if _kernel(kernel) in _FACTOR_KERNELS:
        return "blocked" if 4 * (3 * _blocked_tile(b) + 2 * b) <= _budget() else "sweep"
    return "blocked" if 4 * (2 * _blocked_tile(b) + _blocked_stage(b, 4)) <= _budget() else "sweep"


def rhs_splits(kernel: str, batch: int, b: int, k: int) -> int:
    """CUDA blocks a problem's k right-hand-side columns split over on the
    card: enough that batch·splits fills the card's `SMS` SMs, with no
    block narrower than one 4-column register-tile group (splits <= k // 4);
    1 for a batch that fills them alone, for the factor step, and on the
    'sweep' route (one block a problem).  Block s of problem p takes
    columns [s·k // splits, (s+1)·k // splits); the fused step's blocks each
    run the factor recurrence too, and only block 0 stores L, Wt and info.
    At the partitioned flagship's interiors (8 problems, k = 257, b = 128)
    16, at the Spike flagship's (16 problems, k = 34, b = 16) 8."""
    if _kernel(kernel) not in _SPLIT_KERNELS or chain_route(b, kernel) != "blocked" or batch < 1:
        return 1
    return max(1, min(k // 4, SMS // batch))


def _stage_cols(kernel: str, b: int, k: int, splits: int, route: str) -> int:
    """`stage_cols` on `route`'s layout (a check that runs the other route
    through the C entry sizes its stage with this)."""
    if _kernel(kernel) == "factor" or k == 0:
        return 0
    want = -(-k // splits)
    if route == "blocked":
        # two tiles, then the stage (which the fused step lays over L_{i−1}'s
        # tile and past it): round4(b) rows of at most `lds` floats, twice
        lds = (_budget() // 4 - 2 * _blocked_tile(b)) // (2 * _round4(b))
        g = lds // 4  # the widest stage ld is 4·g if g is odd, else 4·(g − 1)
        return max(0, min(want, 4 * g if g % 2 else 4 * (g - 1)))
    room = _budget() - 4 * _TILES[kernel] * b * _odd_ld(b)
    return max(0, min(want, room // (8 * b)))


def stage_cols(kernel: str, b: int, k: int, splits: int = 1) -> int:
    """RHS columns one chunk of the stage holds: all of a CUDA block's
    ceil(k / splits) columns when they fit beside the tiles, else as many as
    fit (0 for the factor step, which has no right-hand side), on the
    layout of `chain_route(b, kernel)`."""
    return _stage_cols(kernel, b, k, splits, chain_route(b, kernel))


def _smem_bytes(kernel: str, b: int, k: int, splits: int, route: str) -> int:
    """`smem_bytes` on `route`'s layout."""
    kc = _stage_cols(kernel, b, k, splits, route)
    if route == "blocked":
        tile = _blocked_tile(b)
        if kernel == "factor":
            return 4 * 3 * tile
        stage = _blocked_stage(b, kc)
        return 4 * (2 * tile + (max(tile, stage) if kernel == "fused_forward" else stage))
    return 4 * (_TILES[kernel] * b * _odd_ld(b) + 2 * b * kc)


def smem_bytes(kernel: str, b: int, k: int, splits: int = 1) -> int:
    """Dynamic shared memory of one CUDA block of `kernel` for chain blocks
    of order b with k right-hand sides split `splits` ways, on the route
    `chain_route(b, kernel)` picks, with kc = `stage_cols` and tile =
    round4(b)·ld floats, ld = `_blocked_ld(b)` (16-byte rows for
    register-tiled products):

    'blocked'
      factor          4·3·tile                   (L_{i−1}, Wt, S → L_i)
      fused_forward   4·(2·tile + max(tile, 2·round4(b)·_blocked_ld(kc)))
                      (Wt, S → L_i, then L_{i−1} or the stage over it)
      forward_solve   4·(2·tile + 2·round4(b)·_blocked_ld(kc))  (L_iᵀ, Wt_i)
      solve_backward  the same                                (L_i, Wt_{i+1}ᵀ)
    'sweep' (b rows of odd_ld(b) floats, so column walks are free of bank
    conflicts)
      factor          4·3·b·odd_ld
      fused_forward   the same + 4·2·b·kc
      forward_solve   4·(2·b·odd_ld + 2·b·kc)
      solve_backward  the same

    At b = 128 the tiles take 67,584 bytes each (ld 132): the factor step
    202,752, the fused step the same at k = 1 and 229,376 at k = 257
    (kc = 92), the solve steps 139,264 at k = 1 and 229,376 at k = 257."""
    return _smem_bytes(kernel, b, k, splits, chain_route(b, _kernel(kernel)))


def _fits(kernel: str, b: int, k: int) -> bool:
    """The envelope, from `smem_bytes` alone: the tiles fit, and a kernel
    with right-hand sides stages at least one column."""
    k = max(k, 1)
    return smem_bytes(kernel, b, k) <= _budget() and (kernel == "factor" or stage_cols(kernel, b, k) > 0)


def dtype_capable(dtype) -> bool:
    """Whether the kernels serve this dtype without precision loss: they
    compute in f32, so f64 is out, even under a forced impl."""
    return dtype in _KERNEL_DTYPES


def step_eligible(b: int, k: int, seg: int, dtype, *, interpret: bool,
                  kernel: str = "fused_forward") -> bool:
    """Shared-memory gate for ONE problem of the route's largest kernel
    (the fused step for posv, the factor step for factor and extend, the
    forward sweep for solve): its resident tiles plus at least one staged
    RHS column must fit one block's shared memory, 232,448 bytes less a
    1,024-byte reserve (`smem_bytes`).  Neither k nor seg enters beyond
    that: the RHS streams through the stage and the chain blocks stream
    from device memory, so every width the serve ladders and the drivers
    reach (k <= 64, k + s <= 96, the Spike widths k + 2b and k + s + 2b) is
    eligible up to b = 138 (the fused step).  interpret=True (the operands
    lie on the CPU) answers True: the plain versions have no envelope, as
    the JAX kernels in interpret mode have none."""
    del seg, dtype  # the working set is f32 whatever the storage dtype
    return interpret or _fits(kernel, b, k)


def default_impl(b: int, k: int, seg: int, dtype, *, interpret: bool,
                 kernel: str = "fused_forward") -> str:
    """Resolve impl='auto' for a blocktri chain: 'pallas' (the kernels)
    for bf16/f32 within `kernel`'s envelope, else 'xla' (the library
    route)."""
    if not dtype_capable(dtype):
        return "xla"
    return "pallas" if step_eligible(b, k, seg, dtype, interpret=interpret, kernel=kernel) else "xla"


def partition_inner_impl(b: int, k: int, seg: int, dtype, *, interpret: bool) -> str:
    """Resolve the inner impl of the partitioned (Spike) driver, whose
    interior chains solve the widened RHS [B | F | G] of k + 2b columns:
    `default_impl` at that width."""
    return default_impl(b, k + 2 * b, seg, dtype, interpret=interpret)


# --------------------------------------------------------------------------
# argument handling
# --------------------------------------------------------------------------


def _check_steps(name, seg_operands, carries, b):
    for nm, x in seg_operands:
        if x.dim() != 4 or tuple(x.shape[2:]) != (b, b):
            raise ValueError(f"{name}: {nm} must be (batch, seg, b, b), got {tuple(x.shape)}")
    for nm, x, shape in carries:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: carry {nm} must be {shape}, got {tuple(x.shape)}")


def _check_rhs(name, B, batch, seg, b):
    if B.dim() != 4 or tuple(B.shape[:3]) != (batch, seg, b):
        raise ValueError(f"{name}: B must be (batch, seg, b, k), got {tuple(B.shape)}")


def _check_dtype(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"{name}: takes bf16 or f32, got {t.dtype} (the kernels compute "
                "in f32; f64 takes the xla route)"
            )
    if len({t.dtype for t in tensors}) > 1:
        raise TypeError(f"{name}: operands of one dtype, got {[t.dtype for t in tensors]}")


def _kernel_gate(name: str, kernel: str, b: int, k: int) -> None:
    if not _fits(kernel, b, k):
        raise ValueError(
            f"{name}: chain blocks of order {b} do not fit one block's {_budget()} bytes "
            "of shared memory (smem_bytes)"
        )


def _launch(name: str, *args, route: str) -> None:
    """Launch capital_bt_<name> with its route's code as the last argument
    before the stream, and tally the launch by route."""
    rc = _build.entry("capital_bt_" + name)(*args, _ROUTE_CODE[route], hopper._stream())
    hopper._launched(rc, hopper.KERNELS["bt." + name], route)


@functools.lru_cache(maxsize=256)
def _rhs_launch(kernel: str, batch: int, b: int, k: int):
    """(route, splits, kc, needs_scratch) of a launch of a kernel with right-hand
    sides, by the rules: the scratch is needed unless every CUDA block's
    columns fit one chunk on the solve steps' blocked route (the carry then
    stays in the stage).  Cached: a launch's host time is part of every
    small chain's wall."""
    route = chain_route(b, kernel)
    splits = rhs_splits(kernel, batch, b, k)
    kc = stage_cols(kernel, b, k, splits)
    resident = kernel in _SPLIT_KERNELS and route == "blocked" and -(-k // splits) <= kc
    return route, splits, kc, not resident


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _factor_block(d, c, Lp):
    """One chain block of the factor recurrence on f32 stacks:
    Wt = Lp⁻¹·cᵀ, S = d − Wtᵀ·Wt, (L, info) = chol(S) masked lower."""
    wt = sweeps.fwd_solve_plain(Lp, c.mT, from_upper=False)
    s = d - wt.mT @ wt
    L, info = sweeps.chol_plain(s, "L")
    return torch.tril(L), wt, info


def _forward_block(L, wt, rhs, yp):
    return sweeps.fwd_solve_plain(L, rhs - wt.mT @ yp, from_upper=False)


def fused_forward_step_plain(D, C, B, Lc, yc, *, block: int = 0, precision=None):
    """Plain PyTorch version of `fused_forward_step`."""
    del precision  # f32 is always IEEE f32 here
    batch, seg, b, _ = D.shape
    _check_steps("fused_forward_step", [("D", D), ("C", C)],
                 [("Lc", Lc, (batch, b, b)), ("yc", yc, (batch, b, B.shape[-1]))], b)
    _check_rhs("fused_forward_step", B, batch, seg, b)
    _check_dtype("fused_forward_step", D, C, B, Lc, yc)
    _resolve_block(b, block)
    Lp, yp = Lc.float(), yc.float()
    Ls, Wts, ys, infos = [], [], [], []
    for s in range(seg):
        L, wt, info = _factor_block(D[:, s].float(), C[:, s].float(), Lp)
        y = _forward_block(L, wt, B[:, s].float(), yp)
        Ls.append(L), Wts.append(wt), ys.append(y), infos.append(info)
        Lp, yp = L, y
    st = lambda xs, dt: torch.stack(xs, 1).to(dt)  # noqa: E731
    return st(Ls, D.dtype), st(Wts, D.dtype), st(ys, B.dtype), torch.stack(infos, 1)


def factor_step_plain(D, C, Lc, *, block: int = 0, precision=None):
    """Plain PyTorch version of `factor_step`."""
    del precision
    batch, seg, b, _ = D.shape
    _check_steps("factor_step", [("D", D), ("C", C)], [("Lc", Lc, (batch, b, b))], b)
    _check_dtype("factor_step", D, C, Lc)
    _resolve_block(b, block)
    Lp = Lc.float()
    Ls, Wts, infos = [], [], []
    for s in range(seg):
        L, wt, info = _factor_block(D[:, s].float(), C[:, s].float(), Lp)
        Ls.append(L), Wts.append(wt), infos.append(info)
        Lp = L
    return (torch.stack(Ls, 1).to(D.dtype), torch.stack(Wts, 1).to(D.dtype),
            torch.stack(infos, 1))


def forward_solve_step_plain(L, Wt, B, yc, *, block: int = 0, precision=None):
    """Plain PyTorch version of `forward_solve_step`."""
    del precision
    batch, seg, b, _ = L.shape
    _check_steps("forward_solve_step", [("L", L), ("Wt", Wt)],
                 [("yc", yc, (batch, b, B.shape[-1]))], b)
    _check_rhs("forward_solve_step", B, batch, seg, b)
    _check_dtype("forward_solve_step", L, Wt, B, yc)
    _resolve_block(b, block)
    yp = yc.float()
    ys = []
    for s in range(seg):
        yp = _forward_block(L[:, s].float(), Wt[:, s].float(), B[:, s].float(), yp)
        ys.append(yp)
    return torch.stack(ys, 1).to(B.dtype)


def solve_backward_step_plain(L, Wtn, Y, xc, *, block: int = 0, precision=None):
    """Plain PyTorch version of `solve_backward_step`."""
    del precision
    batch, seg, b, _ = L.shape
    _check_steps("solve_backward_step", [("L", L), ("Wtn", Wtn)],
                 [("xc", xc, (batch, b, Y.shape[-1]))], b)
    _check_rhs("solve_backward_step", Y, batch, seg, b)
    _check_dtype("solve_backward_step", L, Wtn, Y, xc)
    _resolve_block(b, block)
    xn = xc.float()
    xs = [None] * seg
    for s in reversed(range(seg)):
        r = Y[:, s].float() - Wtn[:, s].float() @ xn
        xn = sweeps.bwd_solve_plain(L[:, s].float(), r, from_upper=False)
        xs[s] = xn
    return torch.stack(xs, 1).to(Y.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _c(*tensors):
    return [t.contiguous() for t in tensors]


def _solve_launch(kernel, L, Wt, B, carry, out):
    """One launch of a solve step on contiguous operands, on its route and
    column split by the rules."""
    batch, seg, b, k = B.shape
    route, splits, kc, needs_scratch = _rhs_launch(kernel, batch, b, k)
    scratch = torch.empty((batch, b, k), dtype=torch.float32, device=B.device) if needs_scratch else None
    _launch(kernel, hopper._DTYPE_CODE[B.dtype], L.data_ptr(), Wt.data_ptr(), B.data_ptr(),
            carry.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), batch, seg,
            b, k, kc, splits, route=route)


def fused_forward_step(D, C, B, Lc, yc, *, block: int = 0, precision: str | None = "highest"):
    """FUSED factor + forward-solve scan step: for each of `seg` chain
    blocks, factor S_i and consume L_i at once for y_i =
    L_i⁻¹(b_i − Wt_iᵀ·y_{i−1}) while it is in shared memory.

    D, C: (batch, seg, b, b) chain blocks; B: (batch, seg, b, k); Lc:
    (batch, b, b) carried factor (I before block 1); yc: (batch, b, k)
    carried forward solution (0 before block 1).  Returns (L, Wt, y,
    info): per-block factors, transposed sub-diagonal factors, forward
    solutions and per-block potrf info (batch, seg) int32.  On the card the
    launch takes `chain_route(b, "fused_forward")` ('blocked' or 'sweep',
    the same bits), tallied in `hopper.route_counts()`."""
    batch, seg, b, _ = D.shape
    k = B.shape[-1]
    _check_steps("fused_forward_step", [("D", D), ("C", C)],
                 [("Lc", Lc, (batch, b, b)), ("yc", yc, (batch, b, k))], b)
    _check_rhs("fused_forward_step", B, batch, seg, b)
    _check_dtype("fused_forward_step", D, C, B, Lc, yc)
    _resolve_block(b, block)
    if not hopper._on_card(D, C, B, Lc, yc):
        return fused_forward_step_plain(D, C, B, Lc, yc)
    _kernel_gate("fused_forward_step", "fused_forward", b, k)
    D, C, B, Lc, yc = _c(D, C, B, Lc, yc)
    L, Wt, y = torch.empty_like(D), torch.empty_like(D), torch.empty_like(B)
    info = torch.empty((batch, seg), dtype=torch.int32, device=D.device)
    scratch = torch.empty((batch, b, k), dtype=torch.float32, device=D.device)
    if batch and seg:
        route, splits, kc, _ = _rhs_launch("fused_forward", batch, b, k)
        _launch("fused_forward", hopper._DTYPE_CODE[D.dtype], D.data_ptr(), C.data_ptr(),
                B.data_ptr(), Lc.data_ptr(), yc.data_ptr(), L.data_ptr(), Wt.data_ptr(),
                y.data_ptr(), info.data_ptr(), scratch.data_ptr(), batch, seg, b, k, kc, splits,
                route=route)
    return L, Wt, y, info


def factor_step(D, C, Lc, *, block: int = 0, precision: str | None = "highest"):
    """Factor-only scan step: `seg` blocks of the Schur-complement Cholesky
    recurrence from the carried factor Lc.  Returns (L, Wt, info) shaped
    as in `fused_forward_step`, on its routes as there."""
    batch, seg, b, _ = D.shape
    _check_steps("factor_step", [("D", D), ("C", C)], [("Lc", Lc, (batch, b, b))], b)
    _check_dtype("factor_step", D, C, Lc)
    _resolve_block(b, block)
    if not hopper._on_card(D, C, Lc):
        return factor_step_plain(D, C, Lc)
    _kernel_gate("factor_step", "factor", b, 0)
    D, C, Lc = _c(D, C, Lc)
    L, Wt = torch.empty_like(D), torch.empty_like(D)
    info = torch.empty((batch, seg), dtype=torch.int32, device=D.device)
    if batch and seg:
        _launch("factor", hopper._DTYPE_CODE[D.dtype], D.data_ptr(), C.data_ptr(), Lc.data_ptr(),
                L.data_ptr(), Wt.data_ptr(), info.data_ptr(), batch, seg, b, route=chain_route(b, "factor"))
    return L, Wt, info


def forward_solve_step(L, Wt, B, yc, *, block: int = 0, precision: str | None = "highest"):
    """Forward block-bidiagonal sweep from a ready factor: for each of
    `seg` blocks, y_i = L_i⁻¹(b_i − Wt_iᵀ·y_{i−1}).  Returns y
    (batch, seg, b, k).  On the card the launch takes
    `chain_route(b, "forward_solve")` and `rhs_splits` CUDA blocks a
    problem (the same bits either way), tallied in `hopper.route_counts()`."""
    batch, seg, b, _ = L.shape
    k = B.shape[-1]
    _check_steps("forward_solve_step", [("L", L), ("Wt", Wt)], [("yc", yc, (batch, b, k))], b)
    _check_rhs("forward_solve_step", B, batch, seg, b)
    _check_dtype("forward_solve_step", L, Wt, B, yc)
    _resolve_block(b, block)
    if not hopper._on_card(L, Wt, B, yc):
        return forward_solve_step_plain(L, Wt, B, yc)
    _kernel_gate("forward_solve_step", "forward_solve", b, k)
    L, Wt, B, yc = _c(L, Wt, B, yc)
    y = torch.empty_like(B)
    if batch and seg and k:
        _solve_launch("forward_solve", L, Wt, B, yc, y)
    return y


def solve_backward_step(L, Wtn, Y, xc, *, block: int = 0, precision: str | None = "highest"):
    """Backward block-bidiagonal sweep, blocks in DESCENDING chain order
    inside the step: x_i = L_i⁻ᵀ(y_i − Wt_{i+1}·x_{i+1}).  `Wtn` is Wt
    shifted down one block (Wtn[:, s] = Wt of chain block s+1; zeros past
    the chain end) and `xc` carries x_{i+1} of the block after this step's
    last (0 past the chain end).  Returns x (batch, seg, b, k), on its
    route and column split as in `forward_solve_step`."""
    batch, seg, b, _ = L.shape
    k = Y.shape[-1]
    _check_steps("solve_backward_step", [("L", L), ("Wtn", Wtn)], [("xc", xc, (batch, b, k))], b)
    _check_rhs("solve_backward_step", Y, batch, seg, b)
    _check_dtype("solve_backward_step", L, Wtn, Y, xc)
    _resolve_block(b, block)
    if not hopper._on_card(L, Wtn, Y, xc):
        return solve_backward_step_plain(L, Wtn, Y, xc)
    _kernel_gate("solve_backward_step", "solve_backward", b, k)
    L, Wtn, Y, xc = _c(L, Wtn, Y, xc)
    x = torch.empty_like(Y)
    if batch and seg and k:
        _solve_launch("solve_backward", L, Wtn, Y, xc, x)
    return x
