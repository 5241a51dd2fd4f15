"""Blocked Householder TSQR, the unconditionally stable tall-skinny QR
(counterpart of capital_tpu/ops/tsqr.py; Demmel, Grigori, Hoemmen, Langou,
arXiv:0809.2407).

A's rows are zero-padded to `leaves * panel` (leaves a power of two) and
cut into (panel, n) row panels; each panel gets a Householder QR, then
pairs of (n, n) R factors stack into (2n, n) panels and re-factor, halving
the count per level, while each level's thin-Q blocks multiply into the
per-leaf Q accumulators.

Panel QRs take the library route, batched `torch.linalg.qr`, as the JAX
package's `_qr_xla` takes `lax.linalg.qr`.  The JAX package's other route,
a batched Householder Pallas kernel for f32/bf16 panels of n <= 128
(`_qr_pallas`), is not ported yet (ROADMAP Queue B item 11): a call that
resolves to it raises NotImplementedError instead of quietly taking the
library route.  f64 always takes the library route, in both packages.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.utils import tracing

IMPLS = ("auto", "pallas", "xla")

#: largest panel column count 'auto' routes to the Householder kernel
SMALL_N_MAX = 128


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.itemsize < 4 else dtype


def resolve_panel(m: int, n: int, panel: int = 0) -> int:
    """Leaf panel rows: `panel` clamped to >= n, default max(2n, 128)."""
    if panel:
        return max(panel, n)
    return max(2 * n, 128)


def resolve_leaves(m: int, n: int, panel: int = 0) -> int:
    """Leaf count: ceil(m / panel) rounded up to a power of two (the extra
    leaves are zero pads, whose R factors are exact zeros)."""
    p = resolve_panel(m, n, panel)
    raw = max(-(-m // p), 1)
    return 1 << (raw - 1).bit_length()


def default_impl(n: int, dtype: torch.dtype) -> str:
    """Resolve impl='auto' for a batch of n-column panels: 'pallas' (the
    Householder kernel) for f32/bf16 panels with n <= SMALL_N_MAX, else
    'xla'.  f64 always takes 'xla'; the card has no VMEM envelope to
    consult, unlike the JAX rule."""
    if dtype.itemsize > 4 or n > SMALL_N_MAX:
        return "xla"
    return "pallas"


def _qr_xla(P: torch.Tensor, precision):
    """Batched thin Householder QR via torch.linalg.qr (the library route)."""
    del precision  # torch.linalg.qr has no precision knob
    Q, R = torch.linalg.qr(P, mode="reduced")
    return Q, torch.triu(R)


def _qr_batch(P: torch.Tensor, impl: str, *, precision):
    pick = impl
    if impl == "auto":
        pick = default_impl(P.shape[-1], P.dtype)
    elif impl == "pallas" and P.dtype.itemsize > 4:
        pick = "xla"  # the kernel computes in f32: never downgrade f64
    if pick == "pallas":
        raise NotImplementedError(
            f"tsqr: the batched Householder panel kernel (the JAX package's "
            f"tsqr._qr_pallas) is not ported yet (ROADMAP Queue B item 11); "
            f"{tuple(P.shape)} {P.dtype} panels resolve to it — pass impl='xla'"
        )
    return _qr_xla(P, precision)


def tsqr(A: torch.Tensor, *, panel: int = 0, precision: str | None = "highest",
         impl: str = "auto"):
    """Blocked Householder TSQR of tall-skinny A: (Q, R) with A = Q·R, Q
    (m, n) orthonormal to working precision at any cond(A), R (n, n) upper
    triangular.  Computes at >= f32 and casts back once."""
    if A.dim() != 2 or A.shape[0] < A.shape[1]:
        raise ValueError(f"tsqr expects one tall-skinny matrix, got {tuple(A.shape)}")
    if impl not in IMPLS:
        raise ValueError(f"tsqr impl must be one of {IMPLS}, got {impl!r}")
    m, n = A.shape
    p = resolve_panel(m, n, panel)
    leaves = resolve_leaves(m, n, panel)

    with tracing.scope("QR::tsqr"):
        tracing.emit(flops=tracing.tsqr_flops(m, n, leaves))
        Ap = A.to(_compute_dtype(A.dtype))
        mp = leaves * p
        if mp > m:
            Ap = torch.cat([Ap, Ap.new_zeros((mp - m, n))])
        Qacc, Rs = _qr_batch(Ap.reshape(leaves, p, n), impl, precision=precision)
        level_count = leaves
        while level_count > 1:
            S = torch.cat([Rs[0::2], Rs[1::2]], dim=1)  # (L/2, 2n, n)
            Qp, Rs = _qr_batch(S, impl, precision=precision)
            # node i's top block belongs to child 2i, its bottom to 2i+1:
            # every original leaf under a child takes that child's factor
            F = torch.stack([Qp[:, :n], Qp[:, n:]], dim=1).reshape(level_count, n, n)
            group = leaves // level_count
            Qacc = (Qacc.reshape(level_count, group, p, n) @ F[:, None]).reshape(leaves, p, n)
            level_count //= 2
        Q = Qacc.reshape(mp, n)[:m]
        R = Rs[0]
    return Q.to(A.dtype), R.to(A.dtype)


def ortho_gate(Q: torch.Tensor, precision: str | None = "highest") -> torch.Tensor:
    """‖I − QᵀQ‖_F / √n at Q's own dtype, as float32 — the ladder's
    orthogonality measurement."""
    del precision
    return gram_gate(Q.T @ Q)


def gram_gate(G: torch.Tensor) -> torch.Tensor:
    """‖G − I‖_F / √n of a gram G = QᵀQ, at G's dtype, as float32."""
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return (torch.linalg.norm(G - eye) / G.shape[-1] ** 0.5).to(torch.float32)
