"""Local factorizations — the LAPACK seam (counterpart of
capital_tpu/ops/lapack.py).

The JAX package maps this seam onto `lax.linalg`, a library call; the port
maps it onto `torch.linalg`.  Sub-f32 inputs (bf16/f16) are upcast to f32
for the factorization and cast back once, as in the reference.

A breakdown leaves the reference's NaN pattern in the factor
(`cholesky_lower`), so that `robust/detect.factor_info` reports it the
same way in both packages (`torch.linalg.cholesky` would raise instead).  Every routine also takes a
stack of matrices (leading batch dimensions), as `torch.linalg` does: the
serve tier's vmap route writes its batch axis out this way.

`potrf`, `potrf_trtri` and `potrf_trtri_upper` carry the fault-injection
taps where the reference has them (robust/faultinject.py); a tap is the
identity when no plan is active.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.robust import detect, faultinject


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Panel factorizations run at >= f32."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def cholesky_lower(P: torch.Tensor, *, symmetrize: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of P, per matrix of a stack, with the
    reference's breakdown rule (the JAX package's CPU potrf): a
    non-positive pivot NaN-fills the whole factor, as `lax.linalg.cholesky`
    does; a NaN pivot does not stop that potrf (NaN fails its `<= 0`
    test), so its factor keeps the leading columns and is NaN in the
    trailing triangle from that pivot on.  torch reports both as breakdown
    and leaves the NaN on the failed pivot; rebuilding the pattern gives
    `robust/detect.factor_info` the reference's pivot index.  The fill
    covers the lower entries of columns >= t: t = n on a clean factor, the
    pivot on a NaN pivot, 0 otherwise.  The strict upper triangle stays
    zero.

    Reads the lower triangle of P, or of (P + Pᵀ)/2 under `symmetrize`
    (`lax.linalg.cholesky`'s and `jnp.linalg.cholesky`'s default; the
    reference's `symmetrize_input=False` callers read the lower one)."""
    if symmetrize:
        P = (P + P.mT) / 2
    L, info = torch.linalg.cholesky_ex(P)
    n = L.shape[-1]
    j = (info.long()[..., None] - 1).clamp(min=0)
    nan_pivot = torch.diagonal(L, dim1=-2, dim2=-1).gather(-1, j).isnan()
    t = torch.where(info[..., None] == 0, n, torch.where(nan_pivot, j, 0))
    idx = torch.arange(n, device=L.device)
    fill = (idx[:, None] >= idx) & (idx >= t[..., None])
    return L.masked_fill(fill, float("nan"))


def _eye(n: int, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=like.device)


def potrf(A: torch.Tensor, uplo: str = "U", with_info: bool = False):
    """Cholesky factor of SPD A: upper R with A = RᵀR (uplo='U') or lower L
    with A = LLᵀ (uplo='L')."""
    A = faultinject.tap(A)
    L = cholesky_lower(A.to(_compute_dtype(A.dtype)), symmetrize=True).to(A.dtype)
    T = L.mT if uplo == "U" else L
    return (T, detect.factor_info(T)) if with_info else T


def potrs(T: torch.Tensor, B: torch.Tensor, uplo: str = "U") -> torch.Tensor:
    """SPD solve A·X = B from an existing Cholesky factor by two triangular
    sweeps (Rᵀ then R for 'U', L then Lᵀ for 'L')."""
    if uplo not in ("U", "L"):
        raise ValueError(f"uplo must be 'U' or 'L', got {uplo!r}")
    ct = _compute_dtype(T.dtype)
    Tc, Bc = T.to(ct), B.to(ct)
    # the transposed sweep comes first for 'U' (Rᵀ then R), second for 'L'
    first, second = (Tc.mT, Tc) if uplo == "U" else (Tc, Tc.mT)
    Y = torch.linalg.solve_triangular(first, Bc, upper=False)
    X = torch.linalg.solve_triangular(second, Y, upper=True)
    return X.to(B.dtype)


def trtri(T: torch.Tensor, uplo: str = "U", unit_diag: bool = False) -> torch.Tensor:
    """Inverse of a triangular matrix (leading batch dims invert as a
    stack)."""
    ct = _compute_dtype(T.dtype)
    eye = torch.eye(T.shape[-1], dtype=ct, device=T.device).expand(T.shape)
    out = torch.linalg.solve_triangular(
        T.to(ct), eye, upper=(uplo == "U"), unitriangular=unit_diag
    )
    return out.to(T.dtype)


def potrf_trtri(A: torch.Tensor, uplo: str = "U", with_info: bool = False):
    """Factor + triangular inverse back to back; the factor stays at the
    compute dtype between the two steps."""
    A = faultinject.tap(A)
    ct = _compute_dtype(A.dtype)
    L = cholesky_lower(A.to(ct), symmetrize=True)
    T = L.mT if uplo == "U" else L
    Tinv = torch.linalg.solve_triangular(
        T, _eye(A.shape[-1], A, ct), upper=(uplo == "U")
    )
    T, Tinv = T.to(A.dtype), Tinv.to(A.dtype)
    return (T, Tinv, detect.factor_info(T)) if with_info else (T, Tinv)


def potrf_trtri_upper(P: torch.Tensor, with_info: bool = False):
    """(R, R⁻¹) upper-triangular from a symmetric panel whose upper
    triangle holds the valid content (the lower half may be garbage).  The
    three transposes go through the port's transpose kernel
    (ops/hopper.transpose), as the JAX package routes them through its
    Pallas transpose."""
    from capital_tpu_torch.ops import hopper

    P = faultinject.tap(P)
    ct = _compute_dtype(P.dtype)
    P_low = hopper.transpose(P, out_uplo="L", out_dtype=ct)
    L = cholesky_lower(P_low).contiguous()  # row-major for the kernel
    Linv = torch.linalg.solve_triangular(L, _eye(P.shape[-1], P, ct), upper=False).contiguous()
    R = hopper.transpose(L, out_uplo="U", out_dtype=P.dtype)
    Rinv = hopper.transpose(Linv, out_uplo="U", out_dtype=P.dtype)
    return (R, Rinv, detect.factor_info(R)) if with_info else (R, Rinv)


def trtri_newton(D: torch.Tensor, unit_diag: bool = False, precision: str | None = "highest") -> torch.Tensor:
    """Exact inverse of a (..., s, s) LOWER-triangular stack by the
    finite-termination Newton iteration, all batched matmuls: with
    X₀ = diag(D)⁻¹ the residual I − D·X₀ is strictly lower triangular,
    hence nilpotent, and each step X ← X·(2I − D·X) squares it, so
    ⌈log₂ s⌉ steps give the inverse.  Runs at the >= f32 compute dtype
    and casts back once.  unit_diag never reads the stored diagonal."""
    del precision  # f32 products are IEEE f32 here
    ct = _compute_dtype(D.dtype)
    s = D.shape[-1]
    eye = torch.eye(s, dtype=ct, device=D.device)
    if unit_diag:
        Dm = torch.tril(D, -1).to(ct) + eye
        d = torch.ones(D.shape[:-1], dtype=ct, device=D.device)
    else:
        Dm = torch.tril(D).to(ct)
        d = torch.diagonal(Dm, dim1=-2, dim2=-1)
    X = (1.0 / d)[..., :, None] * eye
    two_eye = 2.0 * eye
    for _ in range(max(1, (s - 1).bit_length())):
        X = X @ (two_eye - Dm @ X)
    return X.to(D.dtype)


def diag_block_stack(X: torch.Tensor, o: int, s: int, stride: int) -> torch.Tensor:
    """(count, s, s) stack of the diagonal-band blocks
    ``X[..., i*stride + o : i*stride + o + s, i*stride : i*stride + s]``,
    flattened over any leading batch dims (o=0, stride=s: the diagonal
    blocks; o=s, stride=2s: the sub-diagonal block of each merge pair).
    One strided view of X, copied once."""
    count = X.shape[-2] // stride
    r, c = X.stride(-2), X.stride(-1)
    view = X.as_strided(
        tuple(X.shape[:-2]) + (count, s, s),
        tuple(X.stride()[:-2]) + (stride * (r + c), r, c),
        X.storage_offset() + o * r,
    )
    return view.reshape(-1, s, s)


def trtri_stack(D: torch.Tensor, uplo: str = "L", unit_diag: bool = False, inner: int = 128,
                precision: str | None = None) -> torch.Tensor:
    """Inverse of a (nb, bc, bc) stack of triangular blocks: inner blocks
    of the largest bc/2^j <= `inner` through `trtri_newton`, then batched
    merge levels

        [A11  0 ]^-1   [      A11⁻¹          0   ]
        [A21 A22]    = [−A22⁻¹·A21·A11⁻¹   A22⁻¹ ]

    (the plain batched `trtri` when halving cannot reach `inner`).  The
    whole chain runs at the >= f32 compute dtype and casts back once;
    precision None means 'highest' (IEEE f32 here either way)."""
    nb, bc = D.shape[0], D.shape[-1]
    d = bc
    while inner > 0 and d > inner and d % 2 == 0:
        d //= 2
    k = bc // d if 0 < d <= inner else 0
    inner = d
    if k <= 1:
        return trtri(D, uplo=uplo, unit_diag=unit_diag)
    if uplo != "L":
        # one transpose each way keeps a single (lower) merge body
        return trtri_stack(D.mT, "L", unit_diag, inner, precision).mT
    ct = _compute_dtype(D.dtype)
    Dm = torch.tril(D).to(ct)
    W = trtri_newton(diag_block_stack(Dm, 0, inner, inner), unit_diag=unit_diag)
    s = inner
    while s < bc:
        W = merge_level(W, Dm, s)
        s *= 2
    return W.to(D.dtype)


def merge_level(W: torch.Tensor, T: torch.Tensor, s: int) -> torch.Tensor:
    """One batched merge level: W holds the inverses of T's consecutive
    (s, s) lower-triangular diagonal blocks; pair them into the inverses
    of the (2s, 2s) blocks, B21 = −A22⁻¹·A21·A11⁻¹ with A21 read from T."""
    A21 = diag_block_stack(T, s, s, 2 * s)
    A11i, A22i = W[0::2], W[1::2]
    B21 = -(A22i @ (A21 @ A11i))
    return torch.cat(
        [torch.cat([A11i, torch.zeros_like(A11i)], dim=2), torch.cat([B21, A22i], dim=2)],
        dim=1,
    )
