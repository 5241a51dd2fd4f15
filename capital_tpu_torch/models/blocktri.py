"""Block-tridiagonal Cholesky on one device (counterpart of
capital_tpu/models/blocktri.py): a host loop of scan-step kernels.

A block-tridiagonal SPD system (Kalman smoothers, PDE chains, GP /
state-space models) factors in O(nblocks·b³) work instead of the dense
O((nblocks·b)³).  The chain recurrence

    W_i = C_i·L_{i−1}⁻ᵀ          (zero for i = 1)
    L_i = chol(D_i − W_i·W_iᵀ)   (lower)

runs as a host loop of nblocks/seg launches of the ops/blocktri_small
kernels (impl='pallas', bf16/f32: each launch carries the running factor
on chip across `seg` chain blocks), or as a host loop of batched
`torch.linalg` calls, one chain block per step (impl='xla', the library
route and the f64 path).  The solves are the matching forward / backward
block-bidiagonal sweeps; `posv` fuses the factor and the forward sweep
in one kernel per step.

Operand layout (the serve bucket layout, batch first):

    D: (batch, nblocks, b, b)   diagonal blocks, symmetric SPD chain
    C: (batch, nblocks, b, b)   sub-diagonal blocks; C[:, 0] is dead and
                                zeroed (the chain has nblocks−1 couplings)
    B: (batch, nblocks, b, k)   right-hand sides

Phases: `BT::factor` wraps the factor loop (the fused forward sweep
included for posv), `BT::solve` the substitution sweeps, `UP::extend` the
appended-block factor; each prices the whole chain once
(`tracing.blocktri_chol_flops` / `blocktri_solve_flops`).  Per-block
breakdown info min-combines to one global LAPACK-convention pivot index
(`robust.detect.combine_window_infos`, the vectorized
`combine_block_infos`: block i's local 0/k/b+1 maps to global
0/(i·b+k)/(n+1)).

`posv(impl='partitioned')` (and 'auto' from PARTITION_MIN_NBLOCKS chain
blocks, bf16/f32) runs the Spike / one-level cyclic-reduction
decomposition instead: the chain splits into P partitions whose last
block is a separator; the P interior chains factor together with the
partition axis folded into the batch (batch·P problems per launch), one
widened substitution pass at RHS [B | F | G] (k + 2b columns) gives the
local solutions and the two spikes, the P-block reduced interface system
runs the ordinary sequential loop, and back-substitution is one batched
product pair — sequential depth O(nblocks/P + P) against O(nblocks).
Phases `BT::partition` (interiors and back-substitution) and `BT::reduce`
(interface assembly and the reduced chain).

Where the JAX package's library route solved its triangular systems
through an LU solve on the CPU (an XLA:CPU speed workaround, `_tri_solve`),
the port calls `torch.linalg.solve_triangular` on every device.  Inputs
are never written: C is zeroed in a copy.
"""

from __future__ import annotations

import math

import torch

from capital_tpu_torch.ops import blocktri_small, lapack
from capital_tpu_torch.robust import detect
from capital_tpu_torch.utils import tracing

IMPLS = ("auto", "pallas", "xla", "partitioned")

#: auto resolves to 'partitioned' only from this chain length on (the JAX
#: package's value)
PARTITION_MIN_NBLOCKS = 16

#: inner-impl vocabulary of the partitioned driver
PARTITION_INNER = ("auto", "pallas", "xla")

#: the serve-side algorithm vocabulary (ServeConfig.blocktri_impl)
ALGORITHMS = ("auto", "scan", "partitioned")


def resolve_seg(nblocks: int, seg: int = 0) -> int:
    """Chain blocks per launch: default 8, decremented to the nearest
    divisor of nblocks so every launch takes the same count."""
    s = min(seg or 8, nblocks)
    while nblocks % s:
        s -= 1
    return max(s, 1)


def resolve_partitions(nblocks: int, partitions: int = 0) -> int:
    """Partition count for impl='partitioned': a divisor of nblocks with at
    least one interior block per partition (m = nblocks/P >= 2); a request
    decrements to the nearest valid divisor, the default is the largest
    valid divisor <= √nblocks (8 at nblocks = 64).  1 when the chain cannot
    split (nblocks < 4, or prime)."""
    cap = nblocks // 2
    p = min(partitions or math.isqrt(nblocks), cap)
    while p > 1 and nblocks % p:
        p -= 1
    return max(p, 1)


def _steps(X, nsteps: int, seg: int):
    """(batch, nblocks, ...) -> (nsteps, batch, seg, ...) view."""
    b = X.shape[0]
    return X.reshape((b, nsteps, seg) + tuple(X.shape[2:])).movedim(1, 0)


def _unsteps(Y):
    """Inverse of `_steps`: (nsteps, batch, seg, ...) -> (batch, nblocks, ...)."""
    Z = Y.movedim(0, 1)
    return Z.reshape((Z.shape[0], Z.shape[1] * Z.shape[2]) + tuple(Z.shape[3:]))


def _check_chain(D, C, B=None, op="blocktri"):
    if D.dim() != 4 or D.shape[2] != D.shape[3]:
        raise ValueError(f"{op}: D must be (batch, nblocks, b, b), got {tuple(D.shape)}")
    if C.shape != D.shape:
        raise ValueError(f"{op}: C {tuple(C.shape)} must match D {tuple(D.shape)}")
    if B is not None:
        if B.dim() != 4 or B.shape[:3] != D.shape[:3]:
            raise ValueError(
                f"{op}: B must be (batch, nblocks, b, k) riding D {tuple(D.shape)}, "
                f"got {tuple(B.shape)}")


def _interpret(X) -> bool:
    """The envelope question is the card's only for CUDA operands."""
    return X.device.type != "cuda"


def _partitioned_auto(nblocks: int, partitions: int, dtype) -> bool:
    """Does 'auto' resolve to the partitioned driver?  bf16/f32 chains that
    split, from PARTITION_MIN_NBLOCKS blocks on or at any length when
    `partitions` is requested; f64 keeps the sequential library route."""
    if not blocktri_small.dtype_capable(dtype):
        return False
    if resolve_partitions(nblocks, partitions) < 2:
        return False
    return bool(partitions) or nblocks >= PARTITION_MIN_NBLOCKS


def _resolve_impl(impl: str, dtype, b: int, k: int, seg: int, interpret: bool, kernel: str, *,
                  nblocks: int = 0, partitions: int = 0, allow_partitioned: bool = False,
                  op: str = "blocktri") -> str:
    """`kernel` names the route's largest scan-step kernel, whose envelope
    decides 'auto' (blocktri_small.step_eligible)."""
    if impl not in IMPLS:
        raise ValueError(f"blocktri impl must be one of {IMPLS}, got {impl!r}")
    if impl == "partitioned":
        if not allow_partitioned:
            raise ValueError(
                f"{op}: impl='partitioned' is a posv-only algorithm (the "
                "factored representation is sequential); use posv() or "
                "impl in ('auto', 'pallas', 'xla')")
        if resolve_partitions(nblocks, partitions) < 2:
            return blocktri_small.default_impl(b, k, seg, dtype, interpret=interpret, kernel=kernel)
        return impl
    if impl == "auto":
        if allow_partitioned and _partitioned_auto(nblocks, partitions, dtype):
            return "partitioned"
        return blocktri_small.default_impl(b, k, seg, dtype, interpret=interpret, kernel=kernel)
    if impl == "pallas" and not blocktri_small.dtype_capable(dtype):
        # the kernels compute in f32: a forced 'pallas' never downgrades f64
        return "xla"
    return impl


def posv_algorithm(nblocks: int, dtype, *, impl: str = "auto", partitions: int = 0) -> str:
    """Which algorithm `posv()` runs for this geometry: 'partitioned' or
    'scan' (shapes and dtype only)."""
    if impl not in IMPLS:
        raise ValueError(f"blocktri impl must be one of {IMPLS}, got {impl!r}")
    if impl == "partitioned":
        return "partitioned" if resolve_partitions(nblocks, partitions) >= 2 else "scan"
    if impl == "auto" and _partitioned_auto(nblocks, partitions, dtype):
        return "partitioned"
    return "scan"


def _combine(infos, nblocks: int, b: int, offset: int = 0):
    """Per-block infos (batch, nblocks) local 0/k/b+1 -> global (batch,)
    potrf status over n = offset + nblocks·b; `offset` shifts the blocks'
    diagonal positions (extend's prefix length)."""
    return detect.combine_window_infos(infos, b, offset + nblocks * b, offset)


def _zero_first_coupling(C):
    """The chain has nblocks−1 couplings: C[:, 0] is dead weight, zeroed
    (in a copy), which also makes the first step uniform with the rest."""
    C = C.clone()
    C[:, 0] = 0
    return C


def _eye_carry(batch: int, b: int, like):
    return torch.eye(b, dtype=like.dtype, device=like.device).expand(batch, b, b)


# --------------------------------------------------------------------------
# the library route: a host loop of batched torch.linalg calls (exact
# dtype; bf16 steps compute at f32 and round once, as the reference's
# primitives do)
# --------------------------------------------------------------------------


def _tri_solve(L, R, transpose: bool = False):
    """Lower-triangular left solve L·X = R (Lᵀ·X = R with `transpose`)."""
    ct = lapack._compute_dtype(R.dtype)
    Lc = L.to(ct)
    X = torch.linalg.solve_triangular(Lc.mT if transpose else Lc, R.to(ct), upper=transpose)
    return X.to(R.dtype)


def _chol_block(s):
    """Library Cholesky of a (batch, b, b) Schur complement with the
    reference's symmetrised input ((S + Sᵀ)/2, at S's dtype) and its
    breakdown rule (`lapack.cholesky_lower`), so `detect.factor_info`
    reports the reference's pivot index."""
    ct = lapack._compute_dtype(s.dtype)
    return lapack.cholesky_lower(((s + s.mT) / 2).to(ct)).to(s.dtype)


def _xla_factor_scan(D, C, carry0=None):
    batch, nblocks, b, _ = D.shape
    Lp = _eye_carry(batch, b, D) if carry0 is None else carry0
    Ls, Wts = [], []
    for i in range(nblocks):
        wt = _tri_solve(Lp, C[:, i].mT)
        Lp = _chol_block(D[:, i] - wt.mT @ wt)
        Ls.append(Lp), Wts.append(wt)
    L = torch.stack(Ls, 1)
    # the per-block info in one pass over the stack: a host loop pays per launch
    return L, torch.stack(Wts, 1), detect.factor_info(L)


def _xla_forward_scan(L, Wt, B):
    batch, nblocks, b, _ = L.shape
    yp = torch.zeros((batch, b, B.shape[-1]), dtype=B.dtype, device=B.device)
    ys = []
    for i in range(nblocks):
        yp = _tri_solve(L[:, i], B[:, i] - Wt[:, i].mT @ yp)
        ys.append(yp)
    return torch.stack(ys, 1)


def _xla_backward_scan(L, Wt, Y):
    batch, nblocks, b, _ = L.shape
    xn = torch.zeros((batch, b, Y.shape[-1]), dtype=Y.dtype, device=Y.device)
    xs = [None] * nblocks
    for i in reversed(range(nblocks)):
        r = Y[:, i] if i == nblocks - 1 else Y[:, i] - Wt[:, i + 1] @ xn
        xn = _tri_solve(L[:, i], r, transpose=True)
        xs[i] = xn
    return torch.stack(xs, 1)


# --------------------------------------------------------------------------
# the kernel route: nblocks/seg launches, the carry handed from one launch
# to the next
# --------------------------------------------------------------------------


def _pallas_factor_scan(D, C, *, seg, block, precision, carry0=None):
    batch, nblocks, b, _ = D.shape
    nsteps = nblocks // seg
    Ds, Cs = _steps(D, nsteps, seg), _steps(C, nsteps, seg)
    Lc = _eye_carry(batch, b, D) if carry0 is None else carry0
    outs = []
    for i in range(nsteps):
        L, Wt, info = blocktri_small.factor_step(Ds[i], Cs[i], Lc, block=block,
                                                 precision=precision)
        outs.append((L, Wt, info))
        Lc = L[:, -1]
    return tuple(_unsteps(torch.stack(o)) for o in zip(*outs))


def _pallas_forward_scan(L, Wt, B, *, seg, block, precision):
    batch, nblocks, b, _ = L.shape
    nsteps = nblocks // seg
    Ls, Wts, Bs = (_steps(X, nsteps, seg) for X in (L, Wt, B))
    yc = torch.zeros((batch, b, B.shape[-1]), dtype=B.dtype, device=B.device)
    ys = []
    for i in range(nsteps):
        y = blocktri_small.forward_solve_step(Ls[i], Wts[i], Bs[i], yc, block=block,
                                              precision=precision)
        ys.append(y)
        yc = y[:, -1]
    return _unsteps(torch.stack(ys))


def _pallas_backward_scan(L, Wt, Y, *, seg, block, precision):
    batch, nblocks, b, _ = L.shape
    nsteps = nblocks // seg
    Wtn = torch.cat([Wt[:, 1:], torch.zeros_like(Wt[:, :1])], dim=1)
    Ls, Wtns, Ys = (_steps(X, nsteps, seg) for X in (L, Wtn, Y))
    xc = torch.zeros((batch, b, Y.shape[-1]), dtype=Y.dtype, device=Y.device)
    xs = [None] * nsteps
    for i in reversed(range(nsteps)):
        x = blocktri_small.solve_backward_step(Ls[i], Wtns[i], Ys[i], xc, block=block,
                                               precision=precision)
        xs[i] = x
        xc = x[:, 0]
    return _unsteps(torch.stack(xs))


def _pallas_fused_forward(D, C, B, *, seg, block, precision):
    batch, nblocks, b, _ = D.shape
    nsteps = nblocks // seg
    Ds, Cs, Bs = (_steps(X, nsteps, seg) for X in (D, C, B))
    Lc = _eye_carry(batch, b, D)
    yc = torch.zeros((batch, b, B.shape[-1]), dtype=B.dtype, device=B.device)
    outs = []
    for i in range(nsteps):
        L, Wt, y, info = blocktri_small.fused_forward_step(Ds[i], Cs[i], Bs[i], Lc, yc,
                                                           block=block, precision=precision)
        outs.append((L, Wt, y, info))
        Lc, yc = L[:, -1], y[:, -1]
    return tuple(_unsteps(torch.stack(o)) for o in zip(*outs))


# --------------------------------------------------------------------------
# the partitioned (Spike / one-level cyclic-reduction) driver
# --------------------------------------------------------------------------


def _scan_posv(D, C, B, impl, *, seg, block, precision):
    """Raw sequential fused posv: (X, per-block infos (batch, nblocks)), no
    scopes, emits or info combining."""
    if impl == "pallas":
        L, Wt, Y, infos = _pallas_fused_forward(D, C, B, seg=seg, block=block,
                                                precision=precision)
        X = _pallas_backward_scan(L, Wt, Y, seg=seg, block=block, precision=precision)
    else:
        L, Wt, infos = _xla_factor_scan(D, C)
        Y = _xla_forward_scan(L, Wt, B)
        X = _xla_backward_scan(L, Wt, Y)
    return X, infos


def _combine_partitioned(infos_in, infos_red, nblocks, b, P, m):
    """Map partition-relative per-block infos to one whole-chain potrf
    status: interior block j of partition p sits at global block p·m + j,
    separator p at p·m + m − 1.  The one BACKWARD pollution edge is masked
    first: a broken interior p + 1 turns separator p's reduced diagonal
    into NaN through E_{p+1}ᵀ·Φ_{p+1}, so separator p's candidate is
    dropped whenever interior p + 1 is broken (its own, later, position
    wins)."""
    next_broken = infos_in[:, 1:].amax(dim=-1) > 0
    red = infos_red.clone()
    red[:, :P - 1] = torch.where(next_broken, torch.zeros_like(red[:, :P - 1]), red[:, :P - 1])
    infos = torch.cat([infos_in, red[:, :, None]], dim=2).reshape(-1, nblocks)
    return _combine(infos, nblocks, b)


def _partitioned_posv(D, C, B, *, partitions, inner, block, seg, precision):
    """The Spike decomposition (module docstring).  Separators are the last
    block of every partition, s_p = p·m + m − 1; interiors are blocks
    p·m .. p·m + m − 2."""
    batch, nblocks, b, _ = D.shape
    k = B.shape[-1]
    P = partitions
    m = nblocks // P
    Dr = D.reshape(batch, P, m, b, b)
    Cr = C.reshape(batch, P, m, b, b)
    Br = B.reshape(batch, P, m, b, k)
    E = Cr[:, :, 0]            # cross-partition coupling into block p·m
    Csep = Cr[:, :, m - 1]     # separator s_p <- its own interior tail
    Dsep, Bsep = Dr[:, :, m - 1], Br[:, :, m - 1]

    with tracing.scope("BT::partition"):
        tracing.emit(flops=batch * tracing.blocktri_partition_flops(nblocks, b, k, P))
        # the P interior chains of every problem, folded into the batch
        Din = Dr[:, :, :m - 1].reshape(batch * P, m - 1, b, b)
        Cin = Cr[:, :, :m - 1].clone()
        Cin[:, :, 0] = 0
        Cin = Cin.reshape(batch * P, m - 1, b, b)
        # widened RHS [B | F | G]: F_p = E_p in the first interior block,
        # G_p = C_{s_p}ᵀ in the last; E_0 is zero, so Φ_0 = 0
        R = torch.zeros((batch, P, m - 1, b, k + 2 * b), dtype=B.dtype, device=B.device)
        R[..., :k] = Br[:, :, :m - 1]
        R[:, :, 0, :, k:k + b] = E
        R[:, :, m - 2, :, k + b:] = Csep.mT
        Sol, infos_in = _scan_posv(Din, Cin, R.reshape(batch * P, m - 1, b, k + 2 * b), inner,
                                   seg=resolve_seg(m - 1, seg), block=block, precision=precision)
        Sol = Sol.reshape(batch, P, m - 1, b, k + 2 * b)
        g, Phi, Psi = Sol[..., :k], Sol[..., k:k + b], Sol[..., k + b:]

    with tracing.scope("BT::reduce"):
        tracing.emit(flops=batch * tracing.blocktri_reduce_flops(P, b, k))
        # the Schur complement over the separators:
        # S[p,p]   = D_{s_p} − C_{s_p}·Ψ_p[last] − E_{p+1}ᵀ·Φ_{p+1}[first]
        # S[p,p−1] = −C_{s_p}·Φ_p[last]            (dead at p = 0)
        # b̃_p      = B_{s_p} − C_{s_p}·g_p[last] − E_{p+1}ᵀ·g_{p+1}[first]
        ET = E.mT
        Sd = Dsep - Csep @ Psi[:, :, m - 2]
        Sd[:, :P - 1] += -(ET[:, 1:] @ Phi[:, 1:, 0])
        Ct = -(Csep @ Phi[:, :, m - 2])
        Ct[:, 0] = 0
        bt = Bsep - Csep @ g[:, :, m - 2]
        bt[:, :P - 1] += -(ET[:, 1:] @ g[:, 1:, 0])
        xsep, infos_red = _scan_posv(Sd, Ct, bt, inner, seg=resolve_seg(P, seg), block=block,
                                     precision=precision)

    with tracing.scope("BT::partition"):
        # back-substitution, no loop: x_{J_p} = g_p − Φ_p·x_{s_{p−1}} − Ψ_p·x_{s_p}
        xprev = torch.cat([torch.zeros_like(xsep[:, :1]), xsep[:, :-1]], dim=1)
        Xin = g - Phi @ xprev[:, :, None] - Psi @ xsep[:, :, None]
        X = torch.cat([Xin, xsep[:, :, None]], dim=2).reshape(batch, nblocks, b, k)

    infos_in = infos_in.reshape(batch, P, m - 1)
    return X, _combine_partitioned(infos_in, infos_red, nblocks, b, P, m)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def factor(D, C, *, block: int = 0, seg: int = 0, precision: str | None = "highest",
           impl: str = "auto"):
    """Factor the block-tridiagonal SPD chain: A = L̃·L̃ᵀ.

    Returns (L, Wt, info): L (batch, nblocks, b, b) per-block lower
    Cholesky factors, Wt (batch, nblocks, b, b) TRANSPOSED sub-diagonal
    factors (Wt_i = W_iᵀ = L_{i−1}⁻¹·C_iᵀ; Wt_1 = 0), and info (batch,)
    int32 global potrf status over n = nblocks·b."""
    _check_chain(D, C, op="blocktri factor")
    batch, nblocks, b, _ = D.shape
    seg = resolve_seg(nblocks, seg)
    impl = _resolve_impl(impl, D.dtype, b, b, seg, _interpret(D), "factor", op="blocktri factor")
    C = _zero_first_coupling(C)
    with tracing.scope("BT::factor"):
        tracing.emit(flops=batch * tracing.blocktri_chol_flops(nblocks, b))
        if impl == "pallas":
            L, Wt, infos = _pallas_factor_scan(D, C, seg=seg, block=block, precision=precision)
        else:
            L, Wt, infos = _xla_factor_scan(D, C)
    return L, Wt, _combine(infos, nblocks, b)


def extend(D, C, L_last, *, block: int = 0, seg: int = 0, precision: str | None = "highest",
           impl: str = "auto", offset: int = 0):
    """Append blocks to an already-factored chain without refactoring the
    prefix: the recurrence needs only `L_last`, the final (batch, b, b)
    diagonal factor of the existing chain.

    D/C are the appended blocks only; C[:, 0] is LIVE here (it couples the
    first appended block to the prefix tail).  `offset` shifts the
    returned info's pivot indices by the prefix length.  Returns (L, Wt,
    info) for the appended blocks; concatenated onto the prefix's (L, Wt)
    they are bitwise the factor of the whole chain."""
    _check_chain(D, C, op="blocktri extend")
    batch, nblocks, b, _ = D.shape
    if tuple(L_last.shape) != (batch, b, b):
        raise ValueError(
            f"blocktri extend: L_last must be (batch, b, b) = ({batch}, {b}, {b}) riding D "
            f"{tuple(D.shape)}, got {tuple(L_last.shape)}")
    seg = resolve_seg(nblocks, seg)
    impl = _resolve_impl(impl, D.dtype, b, b, seg, _interpret(D), "factor", op="blocktri extend")
    with tracing.scope("UP::extend"):
        tracing.emit(flops=batch * tracing.blocktri_chol_flops(nblocks, b))
        if impl == "pallas":
            L, Wt, infos = _pallas_factor_scan(D, C, seg=seg, block=block, precision=precision,
                                               carry0=L_last)
        else:
            L, Wt, infos = _xla_factor_scan(D, C, carry0=L_last)
    return L, Wt, _combine(infos, nblocks, b, offset)


def contract(L, Wt, k: int):
    """Drop the `k` oldest blocks from an already-factored chain: block i's
    factors depend only on blocks <= i, so the retained factor is a pure
    slice, bitwise what `extend(D[:, k:], C[:, k:], L[:, k − 1])` would
    replay.  `Wt[:, k]` (the coupling into the dropped prefix) stays: both
    sweeps are blind to it.  The contracted factor represents the marginal
    (Schur-complemented) precision of the retained window.  Returns
    (L[:, k:], Wt[:, k:]) — views, no copy."""
    _check_chain(L, Wt, op="blocktri contract")
    nblocks = L.shape[1]
    if not 0 <= k < nblocks:
        raise ValueError(f"blocktri contract: k must be in [0, nblocks={nblocks}), got {k}")
    return L[:, k:], Wt[:, k:]


def solve(L, Wt, B, *, block: int = 0, seg: int = 0, precision: str | None = "highest",
          impl: str = "auto"):
    """Solve A·X = B from a ready factor: the forward then backward
    block-bidiagonal sweeps.  Returns X (batch, nblocks, b, k)."""
    _check_chain(L, Wt, B, op="blocktri solve")
    batch, nblocks, b, _ = L.shape
    k = B.shape[-1]
    seg = resolve_seg(nblocks, seg)
    impl = _resolve_impl(impl, B.dtype, b, k, seg, _interpret(B), "forward_solve", op="blocktri solve")
    with tracing.scope("BT::solve"):
        tracing.emit(flops=batch * 2 * tracing.blocktri_solve_flops(nblocks, b, k))
        if impl == "pallas":
            Y = _pallas_forward_scan(L, Wt, B, seg=seg, block=block, precision=precision)
            X = _pallas_backward_scan(L, Wt, Y, seg=seg, block=block, precision=precision)
        else:
            Y = _xla_forward_scan(L, Wt, B)
            X = _xla_backward_scan(L, Wt, Y)
    return X


def posv(D, C, B, *, block: int = 0, seg: int = 0, precision: str | None = "highest",
         impl: str = "auto", partitions: int = 0, partition_inner: str = "auto"):
    """Fused factor + solve of the block-tridiagonal chain (the serve
    `posv_blocktri` op): one fused kernel per step factors and runs the
    forward sweep, then the backward sweep finishes.  Returns (X, info):
    X (batch, nblocks, b, k), info (batch,) int32 global potrf status.

    impl='partitioned' (or 'auto' from PARTITION_MIN_NBLOCKS) runs the Spike
    decomposition instead, same (X, info) contract.  `partitions` requests
    the split count (0: `resolve_partitions`'s default); `partition_inner`
    picks the interior/reduced chains' route ('auto' asks
    `blocktri_small.partition_inner_impl` at the widened RHS; f64 always
    takes the library route)."""
    _check_chain(D, C, B, op="blocktri posv")
    batch, nblocks, b, _ = D.shape
    k = B.shape[-1]
    seg = resolve_seg(nblocks, seg)
    interpret = _interpret(D)
    impl = _resolve_impl(impl, D.dtype, b, k, seg, interpret, "fused_forward", nblocks=nblocks,
                         partitions=partitions, allow_partitioned=True, op="blocktri posv")
    C = _zero_first_coupling(C)
    if impl == "partitioned":
        if partition_inner not in PARTITION_INNER:
            raise ValueError(
                f"blocktri posv: partition_inner must be one of {PARTITION_INNER}, "
                f"got {partition_inner!r}")
        P = resolve_partitions(nblocks, partitions)
        if partition_inner == "auto":
            inner = blocktri_small.partition_inner_impl(
                b, k, resolve_seg(nblocks // P - 1, seg), D.dtype, interpret=interpret)
        elif partition_inner == "pallas" and not blocktri_small.dtype_capable(D.dtype):
            inner = "xla"
        else:
            inner = partition_inner
        return _partitioned_posv(D, C, B, partitions=P, inner=inner, block=block, seg=seg,
                                 precision=precision)
    with tracing.scope("BT::factor"):
        tracing.emit(flops=batch * (tracing.blocktri_chol_flops(nblocks, b)
                                    + tracing.blocktri_solve_flops(nblocks, b, k)))
        if impl == "pallas":
            L, Wt, Y, infos = _pallas_fused_forward(D, C, B, seg=seg, block=block,
                                                    precision=precision)
        else:
            L, Wt, infos = _xla_factor_scan(D, C)
            Y = _xla_forward_scan(L, Wt, B)
    with tracing.scope("BT::solve"):
        tracing.emit(flops=batch * tracing.blocktri_solve_flops(nblocks, b, k))
        if impl == "pallas":
            X = _pallas_backward_scan(L, Wt, Y, seg=seg, block=block, precision=precision)
        else:
            X = _xla_backward_scan(L, Wt, Y)
    return X, _combine(infos, nblocks, b)


def assemble(D, C):
    """The dense (batch, n, n) matrix the chain represents (test and
    reference seam; O(n²) memory)."""
    _check_chain(D, C, op="blocktri assemble")
    batch, nblocks, b, _ = D.shape
    n = nblocks * b
    A = torch.zeros((batch, n, n), dtype=D.dtype, device=D.device)
    for i in range(nblocks):
        sl = slice(i * b, (i + 1) * b)
        A[:, sl, sl] = D[:, i]
        if i:
            up = slice((i - 1) * b, i * b)
            A[:, sl, up] = C[:, i]
            A[:, up, sl] = C[:, i].mT
    return A
