"""Breakdown detection for Cholesky factors (counterpart of
capital_tpu/robust/detect.py).

A clean factor has a finite, strictly positive diagonal; `factor_info`
reduces that predicate to a LAPACK potrf-style int32 status on the device,
with no host synchronisation.
"""

from __future__ import annotations

import torch


def factor_info(R: torch.Tensor) -> torch.Tensor:
    """int32 status of a triangular factor R (n x n):

      0           healthy: finite everywhere, diagonal strictly positive;
      k in [1, n] 1-based index of the first non-finite or non-positive
                  diagonal entry;
      n + 1       clean diagonal but a non-finite off-diagonal entry.
    """
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    bad = ~(torch.isfinite(d) & (d > 0))
    first_bad = torch.where(
        bad.any(-1), torch.argmax(bad.to(torch.int32), dim=-1) + 1, 0
    )
    off_bad = ~torch.isfinite(R).all(-1).all(-1)
    n = R.shape[-1]
    return torch.where(
        first_bad > 0, first_bad, torch.where(off_bad, n + 1, 0)
    ).to(torch.int32)


def combine_block_infos(info: torch.Tensor, tail_infos: list, n: int) -> torch.Tensor:
    """Fold per-window info scalars ``(dest, nw, w)`` into a global potrf
    status: post-hoc pivots inside a broken window are dropped, then each
    window's candidate (dest + w for a pivot, n + 1 for w == nw + 1) merges
    in by minimum."""
    for dest, nw, w in tail_infos:
        broken = w.to(info.dtype) > 0
        inside = (info > dest) & (info <= dest + nw) & (info <= n)
        info = torch.where(broken & inside, torch.zeros_like(info), info)
    for dest, nw, w in tail_infos:
        w = w.to(info.dtype)
        piv = torch.where((w > 0) & (w <= nw) & (dest + w <= n), dest + w, 0)
        offd = torch.where(w == nw + 1, n + 1, 0)
        cand = torch.where(piv > 0, piv, offd).to(info.dtype)
        info = torch.where(
            info == 0, cand,
            torch.where(cand == 0, info, torch.minimum(info, cand)),
        )
    return info


def combine_window_infos(infos: torch.Tensor, nw: int, n: int, offset: int = 0) -> torch.Tensor:
    """`combine_block_infos` from a zero start over consecutive windows of
    width nw: window i of ``infos`` (batch, W) sits at offset + i·nw.  From
    a zero start nothing is dropped and the fold is the minimum of the
    windows' non-zero candidates, so it is taken in one vectorized pass —
    the loop of per-window folds costs a chain of W small launches a call."""
    w = infos.to(torch.int64)
    dest = offset + nw * torch.arange(w.shape[-1], device=w.device)
    piv = torch.where((w > 0) & (w <= nw) & (dest + w <= n), dest + w, 0)
    cand = torch.where(piv > 0, piv, torch.where(w == nw + 1, n + 1, 0))
    first = torch.where(cand > 0, cand, n + 2).amin(dim=-1)
    return torch.where(first == n + 2, 0, first).to(torch.int32)
