"""Shifted-CholeskyQR recovery for broken gram factorizations (counterpart
of capital_tpu/robust/recovery.py).

On breakdown (robust/detect.factor_info != 0) the gram G = AᵀA is
numerically indefinite.  The sCQR fix (Fukaya, Kannan, Nakatsukasa,
Yamamoto, Yanagisawa, "Shifted Cholesky QR for computing the QR
factorization of ill-conditioned matrices") re-factors

    G + sigma·I,   sigma = c·u·(m·n + n(n+1))·tr(G),   c = 11,

which bounds cond(A·R⁻¹) so that the next CholeskyQR sweep is safe.

The JAX package branches with lax.cond and never leaves the device; here
the branch is taken on the host, which reads the status scalar — one
synchronisation per guarded site, and only under a RobustConfig.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.ops import tsqr as tsqr_mod
from capital_tpu_torch.robust import detect
from capital_tpu_torch.robust.config import CholEvent, RobustConfig
from capital_tpu_torch.utils import tracing


def unit_roundoff(dtype: torch.dtype) -> float:
    """u of the compute dtype: sub-f32 inputs are factored in f32 by
    ops/lapack, so their roundoff is f32's."""
    if dtype.itemsize < 4:
        dtype = torch.float32
    return float(torch.finfo(dtype).eps)


def sigma_shift(G: torch.Tensor, m_rows: int, c: float = 11.0) -> torch.Tensor:
    """sigma = c·u·(m·n + n(n+1))·tr(G), in G's dtype; the trace reads only
    the diagonal, so an upper-valid gram works."""
    n = G.shape[-1]
    u = unit_roundoff(G.dtype)
    return (c * u * (m_rows * n + n * (n + 1))) * torch.sum(torch.diagonal(G))


def guarded_chol(G: torch.Tensor, m_rows: int, rcfg: RobustConfig | None, chol_fn):
    """Factor G via chol_fn (G -> (R, Rinv)) with breakdown detection and a
    shifted retry.  Returns (R, Rinv, CholEvent).  With rcfg None or
    rcfg.recover False it only detects: sigma = 0 and info_after = info.
    The retry runs muted, so the cost model keeps pricing the healthy
    path."""
    R, Rinv = chol_fn(G)
    info = detect.factor_info(R)
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    if rcfg is None or not rcfg.recover:
        return R, Rinv, CholEvent(info=info, sigma=zero, info_after=info)
    sigma = sigma_shift(G, m_rows, c=rcfg.shift_c)
    if int(info) == 0:
        return R, Rinv, CholEvent(info=info, sigma=zero, info_after=info)
    with tracing.muted():
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        R, Rinv = chol_fn(G + sigma * eye)
    return R, Rinv, CholEvent(info=info, sigma=sigma, info_after=detect.factor_info(R))


def escalation_dtype(dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of the TSQR rung: always f64 (torch has no x64
    switch to degrade it)."""
    del dtype  # the rule is unconditional; the argument documents the call sites
    return torch.float64


def tsqr_escalate(A: torch.Tensor, *, precision: str | None = "highest"):
    """Re-factor A with the blocked Householder TSQR (ops/tsqr) at the
    escalation dtype.  Returns (Q, R, ortho) at that dtype, ortho the
    measured ‖I − QᵀQ‖_F/√n."""
    ct = escalation_dtype(A.dtype)
    Q, R = tsqr_mod.tsqr(A.to(ct), precision=precision)
    return Q, R, tsqr_mod.ortho_gate(Q, precision)
