"""Block-arrowhead Cholesky on one device (counterpart of
capital_tpu/models/arrowhead.py): a blocktri chain plus a thin border.

The SPD matrix

        A = [[T, Bᵀ],
             [B, S ]]

has T block-tridiagonal (nblocks blocks of size b, n_T = nblocks·b), B a
border of s rows coupling every chain block to the small dense corner S.
It factors as the chain plus a Schur-complement completion:

        Z_B = T⁻¹·Bᵀ,  S̃ = S − B·Z_B = L_S·L_Sᵀ

and the solve completes as Z_r = T⁻¹·b_T, y = b_S − B·Z_r,
x_S = L_S⁻ᵀ·L_S⁻¹·y, x_T = Z_r − Z_B·x_S.

Z_r and Z_B come from ONE `blocktri.posv` call on the widened RHS
[b_T | Bᵀ] (k + s columns), so the whole arrowhead rides whichever chain
algorithm posv picks (the sequential kernel loop, the partitioned Spike
driver or the library route); the chain prices itself under BT::*, the
completion under AH::schur and AH::border.  The corner Cholesky and the
corner triangular solves are library calls (`torch.linalg`), as the JAX
package leaves them to `lax.linalg`.

Breakdown coordinates: the chain's status over n_T and the corner's over
s fold through `detect.combine_block_infos` with the corner window at
offset n_T, so info = k is 1-based in whole-matrix coordinates (k <= n_T
a chain pivot, n_T < k <= n_T + s a corner pivot, n_T + s + 1 the
off-diagonal sentinel).

Serve packing: `posv_arrowhead` carries the chain as posv_blocktri's
A = (2, nblocks, b, b) and border, corner and RHS as one
(n_T + s, s + k) tail operand (`pack` / `unpack`).
"""

from __future__ import annotations

import torch

from capital_tpu_torch.models import blocktri
from capital_tpu_torch.robust import detect
from capital_tpu_torch.utils import tracing


def _check_arrowhead(D, C, F, S, B=None, Bs=None, op="arrowhead"):
    """Shape-validate the border/corner operands (the chain pair is
    re-checked by blocktri)."""
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"{op}: D must be (batch, nblocks, b, b), got {tuple(D.shape)}")
    batch, nblocks, b, _ = D.shape
    if F.dim() != 4 or tuple(F.shape[:2]) != (batch, nblocks) or F.shape[-1] != b:
        raise ValueError(
            f"{op}: F must be (batch, nblocks, s, b) riding D {tuple(D.shape)}, "
            f"got {tuple(F.shape)}")
    s = F.shape[2]
    if s < 1:
        raise ValueError(f"{op}: border must have s >= 1 rows, got s={s}")
    if tuple(S.shape) != (batch, s, s):
        raise ValueError(
            f"{op}: S must be (batch, s, s) = ({batch}, {s}, {s}) riding F {tuple(F.shape)}, "
            f"got {tuple(S.shape)}")
    if B is not None:
        if B.dim() != 4 or tuple(B.shape[:3]) != (batch, nblocks, b):
            raise ValueError(
                f"{op}: B must be (batch, nblocks, b, k) riding D {tuple(D.shape)}, "
                f"got {tuple(B.shape)}")
        if tuple(Bs.shape) != (batch, s, B.shape[-1]):
            raise ValueError(
                f"{op}: Bs must be (batch, s, k) = ({batch}, {s}, {B.shape[-1]}) riding B "
                f"{tuple(B.shape)}, got {tuple(Bs.shape)}")


def _combine_info(chain_info, corner_info, nblocks: int, b: int, s: int):
    """Fold the chain's global status (over n_T) and the corner's local
    status (over s) into one whole-matrix potrf status."""
    n_t = nblocks * b
    start = torch.zeros(chain_info.shape, dtype=torch.int32, device=chain_info.device)
    return detect.combine_block_infos(start, [(0, n_t, chain_info), (n_t, s, corner_info)],
                                      n_t + s)


def _corner_factor(F, Zb, S):
    """AH::schur: S̃ = S − B·Z_B by one batched reduction over the chain
    blocks, and its Cholesky (the reference's symmetrised input)."""
    batch, nblocks, s, b = F.shape
    with tracing.scope("AH::schur"):
        tracing.emit(flops=batch * tracing.arrowhead_schur_flops(nblocks, b, s))
        stilde = S - torch.einsum("znsb,znbt->zst", F, Zb)
        ls = blocktri._chol_block(stilde)
        corner_info = detect.factor_info(ls)
    return stilde, ls, corner_info


def posv(D, C, F, S, B, Bs, *, block: int = 0, seg: int = 0,
         precision: str | None = "highest", impl: str = "auto", partitions: int = 0,
         partition_inner: str = "auto"):
    """Factor and solve the block-arrowhead system A·[x_T; x_S] = [B; Bs].

    D, C: the chain (blocktri.posv's contract; C[:, 0] ignored); F: the
    border (batch, nblocks, s, b); S: the (batch, s, s) SPD corner; B:
    (batch, nblocks, b, k); Bs: (batch, s, k).  `impl`, `partitions` and
    `partition_inner` pass to the one widened blocktri.posv call.

    Returns (X, Xs, info): X (batch, nblocks, b, k), Xs (batch, s, k),
    info (batch,) int32 whole-matrix potrf status over nblocks·b + s."""
    _check_arrowhead(D, C, F, S, B, Bs, op="arrowhead posv")
    batch, nblocks, b, _ = D.shape
    s, k = F.shape[2], B.shape[-1]
    z, chain_info = blocktri.posv(
        D, C, torch.cat([B, F.mT], dim=-1), block=block, seg=seg, precision=precision,
        impl=impl, partitions=partitions, partition_inner=partition_inner)
    zr, zb = z[..., :k], z[..., k:]
    _, ls, corner_info = _corner_factor(F, zb, S)
    with tracing.scope("AH::border"):
        tracing.emit(flops=batch * tracing.arrowhead_border_flops(nblocks, b, s, k))
        t1 = Bs - torch.einsum("znsb,znbk->zsk", F, zr)
        xs = blocktri._tri_solve(ls, blocktri._tri_solve(ls, t1), transpose=True)
        x = zr - torch.einsum("znbs,zsk->znbk", zb, xs)
    return x, xs, _combine_info(chain_info, corner_info, nblocks, b, s)


def schur(D, C, F, S, *, block: int = 0, seg: int = 0, precision: str | None = "highest",
          impl: str = "auto", partitions: int = 0, partition_inner: str = "auto"):
    """The completion half of the factorization: Z_B = T⁻¹·Bᵀ, the Schur
    complement S̃ = S − B·Z_B and its Cholesky L_S.  Returns (Zb, Stilde,
    Ls, info), info in whole-matrix coordinates like `posv`."""
    _check_arrowhead(D, C, F, S, op="arrowhead schur")
    batch, nblocks, b, _ = D.shape
    s = F.shape[2]
    zb, chain_info = blocktri.posv(
        D, C, F.mT, block=block, seg=seg, precision=precision, impl=impl,
        partitions=partitions, partition_inner=partition_inner)
    stilde, ls, corner_info = _corner_factor(F, zb, S)
    return zb, stilde, ls, _combine_info(chain_info, corner_info, nblocks, b, s)


def assemble(D, C, F, S):
    """The dense (batch, n, n) arrowhead, n = nblocks·b + s (test and
    reference seam)."""
    _check_arrowhead(D, C, F, S, op="arrowhead assemble")
    batch, nblocks, _, b = D.shape
    s = F.shape[2]
    td = blocktri.assemble(D, C)
    bd = F.transpose(1, 2).reshape(batch, s, nblocks * b)
    top = torch.cat([td, bd.mT], dim=-1)
    bot = torch.cat([bd, S], dim=-1)
    return torch.cat([top, bot], dim=-2)


def pack(F, S, B, Bs):
    """Encode (border, corner, RHS) as serve's (batch, n_T + s, s + k) tail
    operand: rows [:n_T] are Bᵀ beside the blocked-flat chain RHS, rows
    [n_T:] are S beside the corner RHS."""
    batch, nblocks, s, b = F.shape
    k = B.shape[-1]
    n_t = nblocks * b
    top = torch.cat([F.mT.reshape(batch, n_t, s), B.reshape(batch, n_t, k)], dim=-1)
    bot = torch.cat([S, Bs], dim=-1)
    return torch.cat([top, bot], dim=-2)


def unpack(P, nblocks: int, b: int):
    """Invert `pack` from shapes alone: s = rows − nblocks·b, k = cols − s.
    Returns (F, S, B, Bs)."""
    batch, rows, cols = P.shape
    n_t = nblocks * b
    s = rows - n_t
    k = cols - s
    if s < 1 or k < 0:
        raise ValueError(
            f"arrowhead unpack: packed {tuple(P.shape)} cannot carry an nblocks={nblocks}, "
            f"b={b} chain (need rows > {n_t})")
    ft = P[:, :n_t, :s].reshape(batch, nblocks, b, s)
    return (ft.mT, P[:, n_t:, :s], P[:, :n_t, s:].reshape(batch, nblocks, b, k),
            P[:, n_t:, s:])
