"""Plain versions of the column sweeps that the small-N kernels share
(the device functions of ops/csrc/batched_small.cuh): one Python loop over
columns, batched f32 tensor ops inside.  ops/batched_small.py composes them
into the plain potrf/potrs/posv/lstsq/trsm, and `hopper.fused_tail_plain`
into the fused cholinv tail.
"""

from __future__ import annotations

import torch


def _safe_div(d: torch.Tensor) -> torch.Tensor:
    return torch.where((d != 0) & torch.isfinite(d), d, torch.ones_like(d))


def chol_plain(S: torch.Tensor, uplo: str):
    """Column-sweep Cholesky of a batch of f32 (n, n) matrices: at column j,
    u = S[:, j] / sqrt(S[j, j]) becomes row j of R ('U'; column j of L for
    'L') and the rank-1 update S -= u·uᵀ clears row and column j.  A bad
    pivot (non-finite or <= 0) sets info to j + 1 once and divides by 1.0;
    a clean diagonal with a non-finite factor entry gives n + 1.  Entry i
    of the extracted column is NaN when row i of S holds a non-finite
    value (the JAX kernel's one-hot contraction)."""
    S = S.clone()
    batch, n, _ = S.shape
    R = torch.zeros_like(S)
    info = torch.zeros(batch, dtype=torch.int32, device=S.device)
    nan = torch.full((), float("nan"), device=S.device)
    one = torch.ones((), device=S.device)
    for j in range(n):
        col = torch.where(torch.isfinite(S).all(-1), S[:, :, j], nan)
        d = col[:, j]
        good = torch.isfinite(d) & (d > 0)
        info = torch.where((info == 0) & ~good, j + 1, info).to(torch.int32)
        u = col / torch.sqrt(torch.where(good, d, one))[:, None]
        if uplo == "U":
            R[:, j, :] = u
        else:
            R[:, :, j] = u
        S -= u[:, :, None] * u[:, None, :]
    off_bad = ~torch.isfinite(R).all(-1).all(-1)
    info = torch.where((info == 0) & off_bad, n + 1, info).to(torch.int32)
    return R, info


def fwd_solve_plain(T: torch.Tensor, B: torch.Tensor, *, from_upper: bool) -> torch.Tensor:
    """Forward substitution L·Y = B, L = Tᵀ (T stored upper) or T (stored
    lower); only the live triangle of T is read."""
    Y = B.clone()
    n = T.shape[-1]
    for j in range(n):
        lcol = T[:, j, :] if from_upper else T[:, :, j]  # L[:, j]
        y = Y[:, j, :] / _safe_div(lcol[:, j])[:, None]
        Y[:, j + 1:, :] -= lcol[:, j + 1:, None] * y[:, None, :]
        Y[:, j, :] = y
    return Y


def bwd_solve_plain(T: torch.Tensor, Y: torch.Tensor, *, from_upper: bool) -> torch.Tensor:
    """Back substitution U·X = Y, U = T (stored upper) or Tᵀ (stored
    lower)."""
    X = Y.clone()
    n = T.shape[-1]
    for j in range(n - 1, -1, -1):
        ucol = T[:, :, j] if from_upper else T[:, j, :]  # U[:, j]
        x = X[:, j, :] / _safe_div(ucol[:, j])[:, None]
        X[:, :j, :] -= ucol[:, :j, None] * x[:, None, :]
        X[:, j, :] = x
    return X


def rsolve_upper_plain(R: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Right-side solve W·R = V for upper-triangular R (column sweep
    ascending)."""
    W = V.clone()
    n = R.shape[-1]
    for j in range(n):
        w = W[:, :, j] / _safe_div(R[:, j, j])[:, None]
        W[:, :, j + 1:] -= w[:, :, None] * R[:, None, j, j + 1:]
        W[:, :, j] = w
    return W
