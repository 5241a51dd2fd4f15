"""Residual norms — the correctness gates (counterpart of
capital_tpu/utils/residual.py).

Dense gates keep the JAX package's arithmetic: `cholesky_residual` and
`cholesky_inverse_residual` compute at the operands' dtype,
`inverse_residual` at the f32 floor.  The probe-vector gates are O(n²): they
check a factor at sizes where an n³ product would cost more than the
factorization (the n=49152 flagship).  The QR gates follow the JAX
package's: orthogonality at Q's dtype, residuals at the f32 floor, the
row-blocked residual for shapes whose m x n f32 temporaries would not fit.
"""

from __future__ import annotations

import torch


def _floor(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def rel_fro(err: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(err²)) / sqrt(sum(ref²))."""
    return torch.sqrt(torch.sum(torch.square(err))) / torch.sqrt(
        torch.sum(torch.square(ref))
    )


def cholesky_residual(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """‖A − RᵀR‖_F / ‖A‖_F for upper-triangular R."""
    return rel_fro(A - R.T @ R, A)


def cholesky_inverse_residual(R: torch.Tensor, Rinv: torch.Tensor) -> torch.Tensor:
    """‖I − R·R⁻¹‖_F / ‖I‖_F."""
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    return rel_fro(eye - R @ Rinv, eye)


def inverse_residual(A: torch.Tensor, Ainv: torch.Tensor) -> torch.Tensor:
    """‖I − A·A⁻¹‖_F / ‖I‖_F, accumulated at the f32 floor."""
    ct = _floor(A.dtype)
    eye = torch.eye(A.shape[0], dtype=ct, device=A.device)
    return rel_fro(eye - A.to(ct) @ Ainv.to(ct), eye)


def inverse_residual_blocked(
    A: torch.Tensor, Ainv: torch.Tensor, block_rows: int = 4096
) -> torch.Tensor:
    """inverse_residual accumulated over row blocks: O(block_rows·n) extra
    memory for the error instead of an n x n f32 one.  The operands are
    brought to the f32 floor once (bf16 is exact in f32, so the values match
    the dense form).  When block_rows does not tile n the largest divisor of
    n <= block_rows is used; only n <= block_rows takes the dense form."""
    n = A.shape[0]
    if n <= block_rows:
        return inverse_residual(A, Ainv)
    br = next(b for b in range(min(block_rows, n), 0, -1) if n % b == 0)
    ct = _floor(A.dtype)
    Ac, Ai = A.to(ct), Ainv.to(ct)
    num = torch.zeros((), dtype=ct, device=A.device)
    for r0 in range(0, n, br):
        err = Ac[r0:r0 + br] @ Ai
        err[:, r0:r0 + br].diagonal().sub_(1.0)
        num = num + torch.sum(torch.square(err))
    return torch.sqrt(num) / torch.sqrt(torch.tensor(float(n), dtype=ct, device=A.device))


def cholesky_probe_residual(
    A: torch.Tensor, R: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """‖A·v − Rᵀ(R·v)‖ / ‖A·v‖ for probe vectors v (n x k), at the f32
    floor: O(n²k) instead of the n³ dense gate."""
    ct = _floor(A.dtype)
    Rc, vc = R.to(ct), v.to(ct)
    Av = A.to(ct) @ vc
    return rel_fro(Av - Rc.T @ (Rc @ vc), Av)


def inverse_probe_residual(
    R: torch.Tensor, Rinv: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """‖v − R·(R⁻¹·v)‖ / ‖v‖ at the f32 floor (O(n²k))."""
    ct = _floor(R.dtype)
    vc = v.to(ct)
    return rel_fro(vc - R.to(ct) @ (Rinv.to(ct) @ vc), vc)


def qr_orthogonality(Q: torch.Tensor) -> torch.Tensor:
    """‖I − QᵀQ‖_F / ‖I‖_F, at Q's dtype."""
    eye = torch.eye(Q.shape[1], dtype=Q.dtype, device=Q.device)
    return rel_fro(eye - Q.T @ Q, eye)


def qr_residual(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """‖A − QR‖_F / ‖A‖_F at the f32 floor."""
    ct = _floor(A.dtype)
    Ac = A.to(ct)
    return rel_fro(Ac - Q.to(ct) @ R.to(ct), Ac)


def qr_residual_blocked(
    A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor, block_rows: int = 65536
) -> torch.Tensor:
    """qr_residual accumulated over row blocks: O(block_rows·n) extra memory
    instead of several m x n f32 temporaries (8.6 GB each at the 2M x 1024
    shape).  The dense form when block_rows does not tile m."""
    m = A.shape[0]
    if m % block_rows or m == block_rows:
        return qr_residual(A, Q, R)
    ct = _floor(A.dtype)
    Rc = R.to(ct)  # R as given, like the dense form
    num = torch.zeros((), dtype=ct, device=A.device)
    den = torch.zeros((), dtype=ct, device=A.device)
    for r0 in range(0, m, block_rows):
        ab = A[r0:r0 + block_rows].to(ct)
        err = ab - Q[r0:r0 + block_rows].to(ct) @ Rc
        num = num + torch.sum(torch.square(err))
        den = den + torch.sum(torch.square(ab))
    return torch.sqrt(num) / torch.sqrt(den)
