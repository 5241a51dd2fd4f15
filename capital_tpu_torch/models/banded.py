"""Symmetric banded systems on the blocktri path (counterpart of
capital_tpu/models/banded.py).

An SPD banded matrix with bandwidth ``u`` is a block-tridiagonal chain once
re-blocked at any block size ``b >= u``: every entry with |p − q| <= u lands
in a diagonal block D_i or in the coupling C_i between adjacent blocks.
This module gathers LAPACK-style band storage into (D, C) chain blocks (an
index map, no loop over n), pads the tail block's diagonal with identity
rows so the chain length divides, and rides `blocktri.posv` unchanged —
whichever algorithm its dispatch picks.

Band storage follows ``scipy.linalg.solveh_banded``: ``ab`` is (u + 1, n);
in LOWER form ``ab[d, i] = A[i + d, i]`` (main diagonal in row 0), in UPPER
form ``ab[u + i − j, j] = A[i, j]`` for i <= j (main diagonal in the last
row).  The identity padding keeps the padded matrix SPD and the padded
solution rows exactly zero for zero RHS rows, so un-padding is a slice.

`solveh_bordered` adds s dense rows/columns coupling every unknown to a
small dense corner and rides `models/arrowhead.posv` the same way.

Entry points take numpy arrays or tensors; numpy inputs are placed on the
CUDA card unless `device` says otherwise, tensors stay where they are.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.models import arrowhead, blocktri

__all__ = ["resolve_block", "to_blocktri", "solveh_banded", "solveh_bordered"]

#: default re-blocking size floor (the JAX package's value)
_MIN_BLOCK = 8


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("banded: no CUDA device; pass device='cpu' to solve on the host")
        device = "cuda"
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def resolve_block(u: int, n: int, block: int = 0) -> int:
    """The chain block size of a bandwidth-u re-blocking: any b >= max(u, 1)
    is correct; the default is max(u, 8) capped at n.  An explicit `block`
    below the bandwidth raises."""
    if block:
        if block < max(u, 1):
            raise ValueError(
                f"banded: block {block} is below the bandwidth {u} — "
                "couplings would span non-adjacent blocks"
            )
        return block
    return max(u, _MIN_BLOCK, 1) if n >= _MIN_BLOCK else max(u, 1, n)


def _lower_form(ab, lower: bool):
    """Band storage in LOWER form (ab[d, i] = A[i + d, i]); the upper form's
    A[i + d, i] = A[i, i + d] sits at ab[u − d, i + d]."""
    if ab.dim() != 2:
        raise ValueError(f"banded: ab must be 2-D (u+1, n), got {tuple(ab.shape)}")
    if lower:
        return ab
    u, n = ab.shape[0] - 1, ab.shape[1]
    d = torch.arange(u + 1, device=ab.device)[:, None]
    i = torch.arange(n, device=ab.device)[None, :]
    src = torch.clamp(i + d, 0, n - 1)
    return torch.where(i + d < n, ab[u - d, src], torch.zeros((), dtype=ab.dtype, device=ab.device))


def to_blocktri(ab, *, lower: bool = False, block: int = 0, device=None):
    """Re-block band storage into the chain (D, C, n): D (nblocks, b, b),
    C (nblocks, b, b) with C[0] = 0 and C[i] coupling block i to i−1, and
    the original order n; nblocks·b >= n with identity rows padding the tail
    block's diagonal.  D_i[r, c] = ab[|r−c|, i·b + min(r, c)] and
    C_i[r, c] = ab[b + r − c, (i−1)·b + c], each masked to the band."""
    ab = _lower_form(_as_tensor(ab, device), lower)
    u, n = ab.shape[0] - 1, ab.shape[1]
    if n == 0:
        raise ValueError("banded: empty operand (n = 0)")
    b = resolve_block(u, n, block)
    nblocks = -(-n // b)
    pad = nblocks * b - n
    abp = torch.nn.functional.pad(ab, (0, pad))
    dev = abp.device
    zero = torch.zeros((), dtype=abp.dtype, device=dev)
    r = torch.arange(b, device=dev)[:, None]
    c = torch.arange(b, device=dev)[None, :]
    i = torch.arange(nblocks, device=dev)[:, None, None]
    dband = (r - c).abs()
    dcol = i * b + torch.minimum(r, c)
    D = torch.where(dband <= u, abp[torch.clamp(dband, max=u), dcol], zero)
    # identity on padded diagonal rows keeps the chain SPD
    D = D + torch.where((i * b + r >= n) & (r == c), torch.ones((), dtype=abp.dtype, device=dev), zero)
    cband = b + r - c
    ccol = torch.clamp((i - 1) * b + c, 0, nblocks * b - 1)
    C = torch.where((cband <= u) & (i >= 1), abp[torch.clamp(cband, max=u), ccol], zero)
    return D, C, n


def solveh_banded(ab, rhs, *, lower: bool = False, block: int = 0, device=None, **posv_kwargs):
    """Solve the SPD banded system — ``scipy.linalg.solveh_banded``'s calling
    convention on the blocktri path.  ``rhs`` is (n,) or (n, k); returns x
    of the same shape.  Extra keyword arguments flow to `blocktri.posv`
    (impl, partitions, partition_inner, precision).  Raises on a reported
    breakdown, naming the order of the first failing leading minor."""
    D, C, n = to_blocktri(ab, lower=lower, block=block, device=device)
    rhs = _as_tensor(rhs, D.device, D.dtype)
    squeeze = rhs.dim() == 1
    if squeeze:
        rhs = rhs[:, None]
    if rhs.shape[0] != n:
        raise ValueError(f"banded: rhs has {rhs.shape[0]} rows, operand order is {n}")
    nblocks, b = D.shape[0], D.shape[1]
    Bp = torch.nn.functional.pad(rhs, (0, 0, 0, nblocks * b - n)).reshape(nblocks, b, rhs.shape[1])
    X, info = blocktri.posv(D[None], C[None], Bp[None], **posv_kwargs)
    bad = int(info[0])
    if bad:
        raise ValueError(
            f"banded: leading minor of order {bad} is not positive definite (blocktri posv info)"
        )
    x = X[0].reshape(nblocks * b, rhs.shape[1])[:n]
    return x[:, 0] if squeeze else x


def solveh_bordered(ab, border, corner, rhs, rhs_corner, *, lower: bool = False, block: int = 0,
                    device=None, **posv_kwargs):
    """Solve the SPD bordered-banded system [[T, Bᵀ], [B, S]] on the
    arrowhead path: T banded in `solveh_banded` storage, `border` the dense
    (s, n) rows B, `corner` the (s, s) block S.  ``rhs`` is (n,) or (n, k)
    with ``rhs_corner`` matching over s; returns (x, x_corner).  Breakdown
    raises like `solveh_banded`, corner pivots in the bordered order
    n + s."""
    D, C, n = to_blocktri(ab, lower=lower, block=block, device=device)
    border = _as_tensor(border, D.device, D.dtype)
    corner = _as_tensor(corner, D.device, D.dtype)
    if border.dim() != 2 or border.shape[1] != n:
        raise ValueError(
            f"banded: border must be (s, n) = (s, {n}) dense rows, got {tuple(border.shape)}"
        )
    s = border.shape[0]
    if tuple(corner.shape) != (s, s):
        raise ValueError(f"banded: corner must be (s, s) = ({s}, {s}), got {tuple(corner.shape)}")
    rhs = _as_tensor(rhs, D.device, D.dtype)
    rhs_corner = _as_tensor(rhs_corner, D.device, D.dtype)
    squeeze = rhs.dim() == 1
    if squeeze:
        rhs, rhs_corner = rhs[:, None], rhs_corner[:, None]
    if rhs.shape[0] != n or rhs_corner.shape[0] != s:
        raise ValueError(
            f"banded: rhs/rhs_corner have {rhs.shape[0]}/{rhs_corner.shape[0]} rows, operand "
            f"orders are {n}/{s}"
        )
    nblocks, b = D.shape[0], D.shape[1]
    pad = nblocks * b - n
    # border columns chunk into per-block (s, b) couplings; the padded tail
    # columns are zero, so the identity diagonal rows stay decoupled
    F = torch.nn.functional.pad(border, (0, pad)).reshape(s, nblocks, b).transpose(0, 1)
    Bp = torch.nn.functional.pad(rhs, (0, 0, 0, pad)).reshape(nblocks, b, rhs.shape[1])
    X, Xs, info = arrowhead.posv(D[None], C[None], F[None], corner[None], Bp[None],
                                 rhs_corner[None], **posv_kwargs)
    bad = int(info[0])
    if bad:
        if bad > nblocks * b:
            bad -= pad  # corner pivots back to the unpadded order
        raise ValueError(
            f"banded: leading minor of order {bad} is not positive definite (arrowhead posv info)"
        )
    x = X[0].reshape(nblocks * b, rhs.shape[1])[:n]
    xs = Xs[0]
    return (x[:, 0], xs[:, 0]) if squeeze else (x, xs)
