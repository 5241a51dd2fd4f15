"""Blocked Householder TSQR, the unconditionally stable tall-skinny QR
(counterpart of capital_tpu/ops/tsqr.py; Demmel, Grigori, Hoemmen, Langou,
arXiv:0809.2407).

A's rows are zero-padded to `leaves * panel` (leaves a power of two) and
cut into (panel, n) row panels; each panel gets a Householder QR, then
pairs of (n, n) R factors stack into (2n, n) panels and re-factor, halving
the count per level, while each level's thin-Q blocks multiply into the
per-leaf Q accumulators.

Panel QRs have two routes, resolved per batch of panels by `default_impl`
as in the JAX package: the batched Householder panel kernel
(ops/csrc/tsqr.cu, `panel_qr`; the JAX package's `_qr_pallas`) for f32/bf16
panels of n <= 128 whose working tile fits one block's shared memory, and
batched `torch.linalg.qr` (`_qr_xla`, the JAX package's `lax.linalg.qr`)
otherwise.  f64 always takes the library route, in both packages: the
kernel computes in f32.  `panel_qr` is a wrapper, a plain version
(`panel_qr_plain`, the JAX kernel's `_house_panel` step by step) and the
launch counter `hopper.KERNELS["tsqr.panel_qr"]`; it launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.ops import _build, batched_small, hopper
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


#: the panel kernel's column block (csrc PNB), threads a block (PNT) and
#: the rows its panel factor keeps in registers at most (32 a row group)
PANEL_NB = 16
PANEL_THREADS = 256
PANEL_MAX_ROWS = 32 * PANEL_THREADS // PANEL_NB


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def smem_bytes(rows: int, n: int) -> int:
    """Dynamic shared memory of one block of the panel kernel (csrc
    smem_floats): the (round8(rows), ld) f32 tile, ld = round4(n) plus 4
    when that is 0 mod 8; the block's reflectors V and V·T (or V·Tᵀ),
    transposed (PANEL_NB x round8(rows) each); every block's T (PANEL_NB²
    each); the VᵀW workspace (PANEL_NB x 512); the reduction buffers and
    R's diagonal."""
    n4 = _round4(n)
    ld = n4 if (n4 // 4) % 2 else n4 + 4
    nb, warps = PANEL_NB, PANEL_THREADS // 32
    blocks, rows8 = -(-n // nb), (rows + 7) // 8 * 8
    floats = (rows8 * ld + 2 * nb * rows8 + blocks * nb * nb + nb * 512
              + 2 * warps * nb + 2 * nb + nb * nb + n4)
    return 4 * floats


def eligible(rows: int, n: int, dtype, *, interpret: bool) -> bool:
    """Whether the panel kernel takes (rows, n) panels: its tile
    (`smem_bytes`) must fit one block's shared memory, 232,448 bytes less a
    1,024-byte reserve, at f32 and bf16 alike, and its panel factor holds
    at most PANEL_MAX_ROWS (512) rows in registers.  n = 128 takes panels up
    to 280 rows, so every panel `tsqr` cuts for n <= 128 (rows max(2n, 128),
    reduction panels 2n) fits.  interpret=True (the panels lie on the CPU)
    answers True: the plain version has no envelope."""
    del dtype  # the tile is f32 whatever the storage dtype
    return interpret or (rows <= PANEL_MAX_ROWS
                         and smem_bytes(rows, n) <= hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE)


def default_impl(rows: int, n: int, dtype: torch.dtype, *, interpret: bool) -> str:
    """Resolve impl='auto' for a batch of (rows, n) panels: 'pallas' (the
    panel kernel) for f32/bf16 panels with n <= SMALL_N_MAX that fit it
    (`eligible`), else 'xla'.  f64 always takes 'xla'."""
    if dtype.itemsize > 4 or n > SMALL_N_MAX:
        return "xla"
    return "pallas" if eligible(rows, n, dtype, interpret=interpret) else "xla"


def _qr_xla(P: torch.Tensor, precision):
    """Batched thin Householder QR via torch.linalg.qr (the library route)."""
    del precision  # torch.linalg.qr has no precision knob
    Q, R = torch.linalg.qr(P, mode="reduced")
    return Q, torch.triu(R)


def _house_panel_plain(a: torch.Tensor):
    """Householder QR of a batch of f32 (p, n) panels, the JAX kernel's
    `_house_panel` arithmetic step by step: for column j, x = W[j:, j],
    α = −sign(x_j)·‖x‖, v = (x − α·e_j)/‖x − α·e_j‖ (0 for a zero column),
    W ← W − 2·v·(vᵀW); R = triu of the top n rows; thin Q by applying the
    stored reflectors to I[:, :n] in descending order."""
    _, p, n = a.shape
    rows = torch.arange(p, device=a.device)
    W, V = a.clone(), torch.zeros_like(a)
    one, zero = torch.ones((), device=a.device), torch.zeros((), device=a.device)
    for j in range(n):
        x = torch.where(rows >= j, W[:, :, j], zero)
        xj = x[:, j]
        sig = torch.sqrt(torch.sum(x * x, dim=1))
        alpha = -torch.where(xj >= 0, one, -one) * sig
        v = x - alpha[:, None] * (rows == j)
        vn2 = torch.sum(v * v, dim=1)
        v = v * torch.where(vn2 > 0, torch.rsqrt(torch.where(vn2 > 0, vn2, one)), zero)[:, None]
        vtW = torch.einsum("bp,bpn->bn", v, W)
        W = W - 2.0 * (v[:, :, None] * vtW[:, None, :])
        V[:, :, j] = v
    R = torch.triu(W[:, :n, :])
    E = torch.eye(p, n, device=a.device).expand(a.shape).clone()
    for j in range(n - 1, -1, -1):
        v = V[:, :, j]
        vtE = torch.einsum("bp,bpn->bn", v, E)
        E = E - 2.0 * (v[:, :, None] * vtE[:, None, :])
    return E, R


def _check_panels(P: torch.Tensor) -> None:
    if P.dim() != 3 or P.shape[1] < P.shape[2]:
        raise ValueError(f"panel_qr: wants a (batch, p, n) stack with p >= n, got {tuple(P.shape)}")
    if P.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"panel_qr: takes bf16 or f32, got {P.dtype} (the kernel computes in f32; "
            "f64 takes the library route)"
        )


def panel_qr_plain(P: torch.Tensor, *, block: int = 0, precision=None):
    """Plain PyTorch version of `panel_qr`."""
    _check_panels(P)
    batched_small._resolve_block(P.shape[-1], block)
    Q, R = _house_panel_plain(P.float())
    return Q.to(P.dtype), R.to(P.dtype)


def panel_qr(P: torch.Tensor, *, block: int = 0, precision: str | None = "highest"):
    """Batched Householder QR of (batch, p, n) panels, p >= n: (Q, R) with
    Q (batch, p, n) thin and R (batch, n, n) upper triangular, one launch
    with one block per panel (ops/csrc/tsqr.cu; the JAX package's
    `tsqr._qr_pallas`): a blocked compact-WY Householder QR, the same
    reflectors as the plain version.  bf16 or f32; computes in f32; the
    panel must fit the kernel (`eligible`, ValueError otherwise)."""
    _check_panels(P)
    batched_small._resolve_block(P.shape[-1], block)
    if not hopper._on_card(P):
        return panel_qr_plain(P)
    batch, p, n = P.shape
    if not eligible(p, n, P.dtype, interpret=False):
        raise ValueError(
            f"panel_qr: a ({p}, {n}) panel needs {smem_bytes(p, n)} bytes of shared memory "
            f"and at most {PANEL_MAX_ROWS} rows; a block has "
            f"{hopper.SMEM_PER_BLOCK - hopper.SMEM_RESERVE} bytes"
        )
    P = P.contiguous()
    Q = torch.empty_like(P)
    R = torch.empty((batch, n, n), dtype=P.dtype, device=P.device)
    if batch:
        rc = _build.entry("capital_tsqr_panel")(
            hopper._DTYPE_CODE[P.dtype], P.data_ptr(), Q.data_ptr(), R.data_ptr(),
            batch, p, n, hopper._stream(),
        )
        hopper._launched(rc, hopper.KERNELS["tsqr.panel_qr"])
    return Q, R


def _qr_batch(P: torch.Tensor, impl: str, *, precision):
    """One batch of panels through the resolved route.  Whether the
    kernel's envelope applies follows the panels' device: CPU panels take
    the plain version, which has none."""
    pick = impl
    if impl == "auto":
        pick = default_impl(P.shape[-2], P.shape[-1], P.dtype, interpret=not P.is_cuda)
    elif impl == "pallas" and P.dtype.itemsize > 4:
        pick = "xla"  # the kernel computes in f32: never downgrade f64
    if pick == "pallas":
        return panel_qr(P, precision=precision)
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
