"""Single-device routes of SUMMA (counterpart of
capital_tpu/parallel/summa.py: GemmArgs/TrmmArgs/SyrkArgs, trmm, syrk,
gemm).

* mode 'pallas' (and 'explicit', whose single-device schedule is the same
  copy-free kernel route in the JAX package) runs trmm/syrk through the
  hand-written kernels of ops/hopper.py: dead triangular tiles are never
  visited, windows are read in place, results are written in place.
* mode 'xla' masks the triangle and leaves the product to `torch.matmul`,
  as the JAX package leaves it to XLA.
* gemm is a plain product outside any kernel: `torch.matmul` in every mode.
* transpose is a plain `A.T`, made contiguous (the windowed kernels take
  row-major buffers only).

Windowed writes (`out`, syrk `in_place`) mutate the passed buffer and
return it.  The distributed schedules and the balanced layouts wait for the
port's multi-device item (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.ops import hopper, masking
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


def _check(grid: Grid, mode: str, balance: str, who: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown summa mode {mode!r}")
    if balance != "block":
        raise NotImplementedError(
            f"{who}: balance={balance!r} is not ported yet (ROADMAP Queue A "
            "item 10, multi-device schedules)"
        )
    if grid.num_devices != 1:
        raise NotImplementedError(f"{who}: multi-device grids are not ported yet")


def _window(X: torch.Tensor, view) -> torch.Tensor:
    if view is None:
        return X
    r0, c0, rows, cols = view
    return X[r0:r0 + rows, c0:c0 + cols]


def _kernel_route(mode: str, flops: float) -> None:
    """Cost attribution of the kernel route: the executed flops are half
    the dense count (dead tiles skipped)."""
    if mode == "explicit":
        tracing.note("explicit::copy_free")
        tracing.emit(flops=flops, flops_vol=flops / 2, flops_max=flops / 2)
    else:
        tracing.emit(flops=flops / 2)


def gemm(
    grid: Grid,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor | None = None,
    args: GemmArgs = GemmArgs(),
    mode: str = "xla",
) -> torch.Tensor:
    """C = alpha · op(A) @ op(B) + beta · C — a dense product with no dead
    blocks, so `torch.matmul` in every mode."""
    _check(grid, mode, "block", "gemm")
    if args.beta != 0.0 and C is None:
        raise ValueError("beta != 0 requires the accumulate operand C")
    Aop = A.T if args.trans_a else A
    Bop = B.T if args.trans_b else B
    flops, _, _ = tracing.gemm_cost(grid, Aop.shape[0], Bop.shape[1], Aop.shape[1], A.dtype)
    tracing.emit(flops=flops)
    out = Aop @ Bop
    if args.alpha != 1.0:
        out = args.alpha * out
    if args.beta != 0.0:
        out = out + args.beta * C
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
) -> torch.Tensor:
    """alpha · op(tri(A)) @ B (side 'L') or alpha · B @ op(tri(A)) (side
    'R').  With `out` the result is written into `out` at out_off in place
    and `out` is returned."""
    _check(grid, mode, balance, "trmm")
    if args.side not in ("L", "R"):
        raise ValueError(f"side must be 'L' or 'R', got {args.side!r}")
    a_dims = (a_view[2], a_view[3]) if a_view is not None else tuple(A.shape)
    b_dims = (b_view[2], b_view[3]) if b_view is not None else tuple(B.shape)
    flops, _, _ = tracing.gemm_cost(grid, b_dims[0], b_dims[1], a_dims[0], A.dtype)
    if mode in ("pallas", "explicit") and args.diag != "U":
        _kernel_route(mode, flops)
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
    tracing.emit(flops=flops)
    T = masking.take_triangle(_window(A, a_view), args.uplo)
    if args.diag == "U":
        T = masking.with_unit_diagonal(T)
    Top = T.T if args.trans_a else T
    Bw = _window(B, b_view)
    res = Top @ Bw if args.side == "L" else Bw @ Top
    if args.alpha != 1.0:
        res = args.alpha * res
    if out is None:
        return res
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
) -> torch.Tensor:
    """C = alpha·AᵀA + beta·C (trans) or alpha·AAᵀ + beta·C.

    mode 'pallas'/'explicit' computes only the args.uplo triangle: with
    beta == 0 the other half is zero, with beta != 0 it is UNDEFINED, so
    callers read only args.uplo.  mode 'xla' computes the full symmetric
    result.  in_place (beta != 0 and C given) writes the update into C's
    c_view window and returns C itself — the caller's C is modified."""
    _check(grid, mode, balance, "syrk")
    if args.beta != 0.0 and C is None:
        raise ValueError("beta != 0 requires the accumulate operand C")
    if in_place and (args.beta == 0.0 or C is None):
        raise ValueError("in_place syrk requires the accumulate operand C")
    a_dims = (a_view[2], a_view[3]) if a_view is not None else tuple(A.shape)
    n_out = a_dims[1] if args.trans else a_dims[0]
    k_in = a_dims[0] if args.trans else a_dims[1]
    flops, _, _ = tracing.gemm_cost(grid, n_out, n_out, k_in, A.dtype)
    if mode in ("pallas", "explicit"):
        _kernel_route(mode, flops)
        out_kw = {}
        if in_place:
            out_kw = dict(out=C, out_off=(c_view[0], c_view[1]) if c_view is not None else (0, 0))
        return hopper.tri_matmul(
            A, A, a_trans=args.trans, b_trans=not args.trans, out_uplo=args.uplo,
            alpha=args.alpha, precision=args.precision, a_view=a_view, b_view=a_view,
            c=C, c_view=c_view, beta=args.beta, **out_kw,
        )
    tracing.emit(flops=flops)
    Aw = _window(A, a_view)
    out = Aw.T @ Aw if args.trans else Aw @ Aw.T
    if args.alpha != 1.0:
        out = args.alpha * out
    if args.beta != 0.0:
        out = out + args.beta * _window(C, c_view)
    if in_place:
        _window(C, c_view).copy_(out)
        return C
    return out


def transpose(grid: Grid, A: torch.Tensor) -> torch.Tensor:
    """Aᵀ as a new row-major tensor (the JAX package's summa.transpose: a
    plain transpose, no kernel).  One device has no grid transpose to
    price, so nothing is emitted."""
    _check(grid, "xla", "block", "transpose")
    return A.T.contiguous()
