"""Triangular inversion (rectri) and Newton–Schulz inversion (counterpart
of capital_tpu/models/inverse.py).

* ``rectri`` — recursive inverse of a lower-triangular L over one flat
  output buffer:

      L⁻¹ = [[     L11⁻¹     ,   0  ]
             [−L22⁻¹·L21·L11⁻¹, L22⁻¹]]

  Every base-case block is inverted up front by one batched prefix
  (`lapack.trtri_stack` over all diagonal bc-blocks, written into the
  buffer by the `hopper.write_diag_blocks` kernel; the buffer's dead upper
  tiles are zeroed by `hopper.zeros_dead_lower(dead="upper")`), and each
  recursion node then merges its two children with two triangular
  products through `summa.trmm` (side R, then side L in place into the
  buffer) — the `tri_matmul` kernel in mode 'pallas', masked
  `torch.matmul` in mode 'xla'.  uplo 'U' transposes in and out.  On a
  mesh (parallel/topology.py) there is no batched prefix: each leaf is
  inverted on its replicated window, the buffer is padded to the full
  bc·2^k chain, and with mode 'explicit' both merge trmms run the explicit
  SUMMA schedule, whose per-rank products are `hopper.sched_matmul`
  launches where the shards tile; `balance='tile_cyclic'` sends the side-L
  merge of windows of at least balance_min_window through summa's balanced
  cyclic_rows schedule (per-tile products on `torch.matmul`).
* ``newton`` — X ← X(2I − AX) from X₀ = Aᵀ/(‖A‖₁‖A‖∞), two products per
  step through `summa.gemm` in cfg.mode (on a mesh, mode 'explicit' runs
  the dense SUMMA schedule), exiting when ‖I − AX‖_F/√n <= tol.  The JAX
  package's lax.while_loop becomes a host loop: each step reads the
  residual on the host once to decide whether to go on.
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.models.cholesky import pad_embed_identity, padded_dim
from capital_tpu_torch.ops import hopper, lapack
from capital_tpu_torch.parallel import summa
from capital_tpu_torch.parallel.summa import GemmArgs, TrmmArgs
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class RectriConfig:
    """User configuration, field for field the JAX package's RectriConfig.

    batch_below: the single-device batched prefix — -1 (default) inverts
        only the base cases up front (t = bc), 0 turns the prefix off, > 0
        also runs batched dense merge levels for windows up to it (clamped
        up to bc; levels above bc need a power-of-two block count).
    balance: 'block' or 'tile_cyclic' (the explicit side-L merges of
        windows >= balance_min_window take the balanced schedule).
    precision: f32 at 'high' runs tri_matmul's and sched_matmul's
        products as the JAX package's bf16x3 split (hopper.split_high);
        torch.matmul products and every other dtype and precision are full
        precision.
    """

    base_case_dim: int = 256
    mode: str = "xla"
    precision: str | None = "highest"
    balance: str = "block"
    balance_min_window: int = 8192
    batch_below: int = -1


def _batched_prefix_size(grid: Grid, p: int, cfg: RectriConfig) -> int:
    """Largest level size t = bc·2^j the batched prefix produces (t = bc:
    base cases only, the default), or 0 when it is off or bc does not
    divide p.  Levels above bc pair equal siblings, so they need a
    power-of-two block count."""
    bc = cfg.base_case_dim
    nb = p // bc
    limit = bc if cfg.batch_below < 0 else max(cfg.batch_below, bc)
    if not (grid.num_devices == 1 and cfg.batch_below != 0 and p % bc == 0 and p >= bc):
        return 0
    if nb & (nb - 1):
        return bc
    t = bc
    while t * 2 <= min(limit, p):
        t *= 2
    return t


def _rectri_batched_prefix(Tp: torch.Tensor, out: torch.Tensor, t: int,
                           cfg: RectriConfig) -> torch.Tensor:
    """Invert every diagonal t-window of Tp into `out`: one trtri_stack over
    all base-case blocks, then (t > bc only) one batched merge per level,
    and one write_diag_blocks launch."""
    bc = cfg.base_case_dim
    with tracing.scope("RT::batch_base"):
        W = lapack.trtri_stack(
            torch.tril(lapack.diag_block_stack(Tp, 0, bc, bc)), uplo="L",
            precision=cfg.precision,
        )
    s = bc
    while s < t:
        with tracing.scope("RT::batch_merge"):
            W = lapack.merge_level(W, Tp, s)
        s *= 2
    with tracing.scope("RT::batch_write"):
        return hopper.write_diag_blocks(out, W)


def _rectri_into(grid: Grid, Tp: torch.Tensor, out: torch.Tensor, off: int, size: int,
                 cfg: RectriConfig, stop_at: int = 0) -> torch.Tensor:
    """Invert the lower-triangular window (off, off, size, size) of Tp into
    the same window of `out`, in place.  Windows <= stop_at are already
    inverted (the batched prefix) and pass through."""
    if size <= stop_at:
        return out
    if size <= cfg.base_case_dim:
        with tracing.scope("RT::base"):
            inv = lapack.trtri(Tp[off:off + size, off:off + size], uplo="L")
            out[off:off + size, off:off + size] = inv.to(out.dtype)
            return out
    bc = cfg.base_case_dim
    # split on a base-case boundary, so every leaf is a bc-aligned block
    n1 = (size // bc // 2) * bc if size % bc == 0 else size // 2
    n2 = size - n1
    out = _rectri_into(grid, Tp, out, off, n1, cfg, stop_at)
    out = _rectri_into(grid, Tp, out, off + n1, n2, cfg, stop_at)
    # B21 = −L22⁻¹ · L21 · L11⁻¹, two triangular products through windows
    bal = ("tile_cyclic" if cfg.balance == "tile_cyclic" and cfg.mode == "explicit"
           and n2 >= cfg.balance_min_window else "block")
    with tracing.scope("RT::merge"):
        M = summa.trmm(
            grid, out, Tp, TrmmArgs(side="R", uplo="L", precision=cfg.precision),
            mode=cfg.mode,
            a_view=(off, off, n1, n1),        # L11inv
            b_view=(off + n1, off, n2, n1),   # L21
        )
        out = summa.trmm(
            grid, out, M, TrmmArgs(side="L", uplo="L", alpha=-1.0, precision=cfg.precision),
            mode=cfg.mode,
            a_view=(off + n1, off + n1, n2, n2),  # L22inv
            out=out, out_off=(off + n1, off),
            balance=bal,
        )
    return out


def rectri(grid: Grid, T: torch.Tensor, uplo: str = "L",
           cfg: RectriConfig = RectriConfig()) -> torch.Tensor:
    """Inverse of triangular T (uplo names its stored triangle; the other
    one is never read).  The result is a new tensor whose dead triangle is
    exactly zero."""
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    if T.dim() != 2 or T.shape[0] != T.shape[1]:
        raise ValueError(f"triangular operand must be square, got {tuple(T.shape)}")
    if T.device.type != grid.device.type:
        raise ValueError(f"T is on {T.device}, the grid on {grid.device}")
    if uplo == "U":
        # U⁻¹ = (L⁻¹)ᵀ with L = Uᵀ
        return summa.transpose(grid, rectri(grid, summa.transpose(grid, T), "L", cfg))
    n = T.shape[0]
    # one device pads to the smaller of the bc·2^k chain and 256-alignment
    # (the recursion handles odd halving); a mesh pads the full chain, so
    # every window divides the face.  diag(T, I) inverts to diag(T⁻¹, I)
    p = padded_dim(n, cfg.base_case_dim)
    if grid.num_devices == 1:
        p = min(p, -(-n // 256) * 256)
    Tp = pad_embed_identity(T, n, p)
    t = _batched_prefix_size(grid, p, cfg)
    if t:
        # the prefix writes every diagonal t-block and the merges the whole
        # strict-lower triangle: only the dead upper tiles need zeros
        with tracing.scope("RT::buffers"):
            out = hopper.zeros_dead_lower(p, T.dtype, t, dead="upper", device=T.device)
        out = _rectri_batched_prefix(Tp, out, t, cfg)
    else:
        out = torch.zeros((p, p), dtype=T.dtype, device=T.device)
    out = _rectri_into(grid, Tp, out, 0, p, cfg, stop_at=t)
    return out[:n, :n] if p != n else out


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton–Schulz knobs, field for field the JAX package's NewtonConfig.

    tol: exit when ‖I − AX‖_F/√n <= tol; None means 50·eps of A's dtype
        (with the JAX package's floor of 2⁻²¹ for f32 at precision 'high').
    """

    tol: float | None = None
    max_iter: int = 100
    mode: str = "xla"
    precision: str | None = "highest"


def newton(grid: Grid, A: torch.Tensor, cfg: NewtonConfig = NewtonConfig()):
    """Iterative inverse of well-conditioned A by Newton–Schulz.  Returns
    (Ainv, iters) with iters the number of steps executed (a Python int).

    The loop runs on the host: after each step the residual is read back
    once (one device synchronisation per iteration) to decide whether to
    stop, as the JAX package's lax.while_loop decides on the device."""
    n = A.shape[0]
    tol = cfg.tol
    if tol is None:
        eps = float(torch.finfo(A.dtype).eps)
        if A.dtype.itemsize == 4 and cfg.precision == "high":
            eps = max(eps, 2.0**-21)
        tol = 50.0 * eps
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    norm1 = torch.max(torch.sum(torch.abs(A), dim=0))
    norminf = torch.max(torch.sum(torch.abs(A), dim=1))
    X = A.T / (norm1 * norminf)
    gargs = GemmArgs(precision=cfg.precision)
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=A.dtype, device=A.device))

    def resid(AX):
        return float(torch.linalg.norm(eye - AX) / sqrt_n)

    AX = summa.gemm(grid, A, X, args=gargs, mode=cfg.mode)
    r, it = resid(AX), 0
    while r > tol and it < cfg.max_iter:
        X = summa.gemm(grid, X, 2.0 * eye - AX, args=gargs, mode=cfg.mode)
        AX = summa.gemm(grid, A, X, args=gargs, mode=cfg.mode)
        r, it = resid(AX), it + 1
    return X, it
