"""Triangular solve (TRSM) on one device or a mesh (counterpart of
capital_tpu/models/trsm.py).

Blocked recursion, lower-triangular side 'L' shown (the other side/uplo
combinations by symmetry):

    [L11  0 ] [X1]   [B1]      X1 = trsm(L11, B1)
    [L21 L22] [X2] = [B2]  ->  X2 = trsm(L22, B2 − L21·X1)

Leaves: 'invert' (default) inverts every diagonal bc-block up front in one
batched `lapack.trtri_stack` (TS::dinv) and turns each leaf into a product
with its inverse; 'solve' runs `torch.linalg.solve_triangular` on the leaf.
The off-diagonal updates and the invert leaves are dense products
(`summa.gemm`, `torch.matmul`): this module reaches no kernel of the JAX
package, and none of the port's.  Solved blocks are written into one X
buffer at their final offsets.  On a mesh (parallel/topology.py) A pads to
the bc·2^k chain (`cholesky.padded_dim`), so every recursion window divides
the face, and the updates run summa.gemm in cfg.mode (mode 'explicit': the
dense SUMMA schedule).
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.models.cholesky import pad_embed_identity, padded_dim
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.parallel import summa
from capital_tpu_torch.parallel.summa import GemmArgs
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class TrsmConfig:
    """Blocked-TRSM knobs, field for field the JAX package's TrsmConfig:
    leaf 'invert' (diagonal-block inverses, every leaf a product) or
    'solve' (substitution at each leaf)."""

    base_case_dim: int = 256
    mode: str = "xla"
    precision: str | None = "highest"
    leaf: str = "invert"


def _diag_block_inverses(A: torch.Tensor, bc: int, lower: bool, unit_diag: bool,
                         cfg: TrsmConfig) -> torch.Tensor:
    """(p/bc, bc, bc) stack of the inverses of tri(A)'s diagonal blocks."""
    D = lapack.diag_block_stack(A, 0, bc, bc)
    D = torch.tril(D) if lower else torch.triu(D)
    return lapack.trtri_stack(D, uplo="L" if lower else "U", unit_diag=unit_diag,
                              precision=cfg.precision)


def _base_solve(T: torch.Tensor, B: torch.Tensor, lower: bool, left: bool,
                unit_diag: bool) -> torch.Tensor:
    """The 'solve' leaf; only tri(T) is read.  bf16 solves at f32 (the
    library's triangular solve takes no bf16) and rounds once."""
    ct = lapack._compute_dtype(T.dtype)
    X = torch.linalg.solve_triangular(
        T.to(ct), B.to(ct), upper=not lower, left=left, unitriangular=unit_diag
    )
    return X.to(B.dtype)


def solve(grid: Grid, A: torch.Tensor, B: torch.Tensor, side: str = "L", uplo: str = "L",
          trans_a: bool = False, cfg: TrsmConfig = TrsmConfig(), *,
          unit_diag: bool = False) -> torch.Tensor:
    """X with op(tri(A)) @ X = B (side 'L') or X @ op(tri(A)) = B (side
    'R'), op = transpose when trans_a.  unit_diag takes tri(A)'s diagonal
    as ones without reading it.  Returns a new tensor."""
    if side not in ("L", "R"):
        raise ValueError(f"side must be 'L' or 'R', got {side!r}")
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    if cfg.leaf not in ("invert", "solve"):
        raise ValueError(f"leaf must be 'invert' or 'solve', got {cfg.leaf!r}")
    n = A.shape[0]
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"triangular operand must be square, got {tuple(A.shape)}")
    need = B.shape[0] if side == "L" else B.shape[1]
    if need != n:
        raise ValueError(f"shape mismatch: A {tuple(A.shape)} vs B {tuple(B.shape)} side={side}")
    lower = uplo == "L"
    if trans_a:
        # op(T)·X = B is a solve with the transposed triangle
        return solve(grid, summa.transpose(grid, A), B, side, "U" if lower else "L",
                     False, cfg, unit_diag=unit_diag)

    # diag(A, I) padding (the zero-padded right-hand sides solve to zeros):
    # a mesh pads to bc·2^k so every window divides the face; one device
    # to a multiple of bc for the invert leaf, 'solve' unpadded
    bc = cfg.base_case_dim
    if grid.num_devices > 1:
        p = padded_dim(n, bc)
    else:
        p = -(-n // bc) * bc if cfg.leaf == "invert" and n > bc else n
    if p != n:
        A = pad_embed_identity(A, n, p)
        B = (torch.cat([B, B.new_zeros((p - n, B.shape[1]))]) if side == "L"
             else torch.cat([B, B.new_zeros((B.shape[0], p - n))], dim=1))

    Dinv = None
    if cfg.leaf == "invert" and p >= bc and p % bc == 0:
        with tracing.scope("TS::dinv"):
            Dinv = _diag_block_inverses(A, bc, lower, unit_diag, cfg)

    X = torch.zeros_like(B)
    X = _solve_into(grid, A, B, X, 0, p, side, lower, unit_diag, cfg, Dinv)
    if p != n:
        X = X[:n, :] if side == "L" else X[:, :n]
    return X


def _solve_into(grid: Grid, A: torch.Tensor, B: torch.Tensor, X: torch.Tensor, off: int,
                size: int, side: str, lower: bool, unit_diag: bool, cfg: TrsmConfig,
                Dinv: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the (off, off, size, size) window of tri(A) against the
    right-hand sides B (already cut to this window), writing the solution
    into X at `off` along the solve axis, in place.  Returns X."""

    def xwin(o: int, s: int) -> torch.Tensor:
        return X[o:o + s, :] if side == "L" else X[:, o:o + s]

    bc = cfg.base_case_dim
    if size <= bc:
        if Dinv is not None and size == bc:
            # invert leaf: one product with the precomputed block inverse
            D = Dinv[off // bc]
            gargs = GemmArgs(precision=cfg.precision)
            with tracing.scope("TS::leaf"):
                if side == "L":
                    V = summa.gemm(grid, D, B, None, gargs, mode=cfg.mode)
                else:
                    V = summa.gemm(grid, B, D, None, gargs, mode=cfg.mode)
        else:
            V = _base_solve(A[off:off + size, off:off + size], B, lower, side == "L", unit_diag)
        xwin(off, size).copy_(V)
        return X

    # split on a bc boundary, so every leaf is bc-sized at a bc-aligned offset
    n1 = (size // bc // 2) * bc if size % bc == 0 else size // 2
    n2 = size - n1
    o1, o2 = off, off + n1
    gargs = GemmArgs(alpha=-1.0, beta=1.0, precision=cfg.precision)

    def update(P, Q, C):
        with tracing.scope("TS::update"):
            return summa.gemm(grid, P, Q, C, gargs, mode=cfg.mode)

    if side == "L" and lower:
        X = _solve_into(grid, A, B[:n1, :], X, o1, n1, side, lower, unit_diag, cfg, Dinv)
        B2 = update(A[o2:o2 + n2, o1:o1 + n1], xwin(o1, n1), B[n1:, :])
        X = _solve_into(grid, A, B2, X, o2, n2, side, lower, unit_diag, cfg, Dinv)
    elif side == "L":
        X = _solve_into(grid, A, B[n1:, :], X, o2, n2, side, lower, unit_diag, cfg, Dinv)
        B1 = update(A[o1:o1 + n1, o2:o2 + n2], xwin(o2, n2), B[:n1, :])
        X = _solve_into(grid, A, B1, X, o1, n1, side, lower, unit_diag, cfg, Dinv)
    elif lower:
        X = _solve_into(grid, A, B[:, n1:], X, o2, n2, side, lower, unit_diag, cfg, Dinv)
        B1 = update(xwin(o2, n2), A[o2:o2 + n2, o1:o1 + n1], B[:, :n1])
        X = _solve_into(grid, A, B1, X, o1, n1, side, lower, unit_diag, cfg, Dinv)
    else:
        X = _solve_into(grid, A, B[:, :n1], X, o1, n1, side, lower, unit_diag, cfg, Dinv)
        B2 = update(xwin(o1, n1), A[o1:o1 + n1, o2:o2 + n2], B[:, n1:])
        X = _solve_into(grid, A, B2, X, o2, n2, side, lower, unit_diag, cfg, Dinv)
    return X
