"""Triangular masks (counterpart of capital_tpu/ops/masking.py).

Dense storage plus masks in place of the reference's packed triangular
storage.  Masks select (`torch.where` semantics through triu/tril), so a
NaN in the dead half never leaks into the kept half.
"""

from __future__ import annotations

import torch


def triu_mask(n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    r = torch.arange(n, device=device)
    return (r[:, None] <= r[None, :]).to(dtype)


def tril_mask(n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    r = torch.arange(n, device=device)
    return (r[:, None] >= r[None, :]).to(dtype)


def take_triangle(A: torch.Tensor, uplo: str) -> torch.Tensor:
    """Zero the dead half; `uplo` names the half to keep."""
    if uplo == "U":
        return torch.triu(A)
    if uplo == "L":
        return torch.tril(A)
    raise ValueError(f"uplo must be 'U' or 'L', got {uplo!r}")


def cyclic_index(n: int, d: int, tile: int, device=None) -> torch.Tensor:
    """orig[i] = the ORIGINAL row/col index stored at position i of a
    tile-cyclic layout over d ranks (parallel/summa.tile_cyclic_perm):
    storage is d contiguous rank chunks, chunk s holding the original tiles
    ≡ s (mod d) in ascending order."""
    if n % (d * tile):
        raise ValueError(f"cyclic_index: {d} devices x tile {tile} must tile {n}")
    i = torch.arange(n, device=device)
    chunk, j = i // (n // d), i % (n // d)
    return ((j // tile) * d + chunk) * tile + (j % tile)


def take_triangle_cyclic(A: torch.Tensor, uplo: str, d: int, tile: int,
                         strict: bool = False) -> torch.Tensor:
    """take_triangle for a matrix whose BOTH axes are stored tile-cyclically
    (the persistent layout V = X[perm][:, perm]): the triangle lives at
    ORIGINAL indices, so the mask compares the cyclic index maps.
    strict=True drops the diagonal."""
    r = cyclic_index(A.shape[0], d, tile, A.device)
    c = cyclic_index(A.shape[1], d, tile, A.device)
    if uplo == "U":
        m = r[:, None] < c[None, :] if strict else r[:, None] <= c[None, :]
    elif uplo == "L":
        m = r[:, None] > c[None, :] if strict else r[:, None] >= c[None, :]
    else:
        raise ValueError(f"uplo must be 'U' or 'L', got {uplo!r}")
    return torch.where(m, A, torch.zeros((), dtype=A.dtype, device=A.device))


def embed_identity_tail(X: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the (m, n) matrix X to (rows, cols) with ones where padded
    row m+j meets padded column n+j (diag(X, I) for square X)."""
    m, n = X.shape
    if rows < m or cols < n or rows - m < cols - n:
        raise ValueError(
            f"cannot embed {tuple(X.shape)} into ({rows}, {cols}): need "
            f"rows >= {m} and rows - {m} >= cols - {n}"
        )
    if (rows, cols) == (m, n):
        return X
    out = torch.zeros((rows, cols), dtype=X.dtype, device=X.device)
    out[:m, :n] = X
    j = torch.arange(cols - n, device=X.device)
    out[m + j, n + j] = 1
    return out


def with_unit_diagonal(A: torch.Tensor) -> torch.Tensor:
    """Force ones on the diagonal (Diag::AblasUnit)."""
    out = A.clone()
    out.diagonal().fill_(1)
    return out


def symmetrize_from(A: torch.Tensor, uplo: str) -> torch.Tensor:
    """Fill the dead half from the stored half: tri + triᵀ − diag."""
    T = take_triangle(A, uplo)
    return T + T.T - torch.diag(torch.diagonal(T))
