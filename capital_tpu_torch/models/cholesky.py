"""cholinv: recursive Cholesky + triangular inverse (counterpart of
capital_tpu/models/cholesky.py), on one device or on a d x d x c mesh.

For SPD A it computes the upper factor R (A = RᵀR) and R⁻¹ together, by the
reference's recursion (cholinv.hpp:87-165):

    recurse(A):
      1. R11, R11inv = recurse(A11)
      2. R12 = R11⁻ᵀ · A12                                # CI::trsm (trmm)
      3. A22' = A22 − R12ᵀ·R12                            # CI::tmu  (syrk)
      4. R22, R22inv = recurse(A22')
      5. R12inv = −R11inv · R12 · R22inv                  # CI::inv  (2 trmms)

`plan` fixes the schedule on the host; `factor` runs it eagerly against two
p x p buffers (R and R⁻¹) that every phase reads and writes through windows,
in place.  On one CUDA device each phase launches the hand-written kernels
of ops/hopper.py; on the CPU the same calls run their plain versions.  On a
mesh (parallel/topology.py) the phases run through parallel/summa.py's
materialising route — with mode 'explicit' every trmm whose shards tile
takes the per-rank `hopper.sched_matmul` kernel — and each leaf panel is
factored by the ranks its base-case policy names (`_scoped_base_factor`).

With `tail_fuse_depth > 0` a subtree whose window passes `_tail_fusible`
runs as one `hopper.fused_tail` launch (CI::tail_fused) in place of its
leaf, trsm, syrk and trmm launches; on the card that admits windows of
128 (one block) and of 256, 384 and 512 (a thread-block cluster), and
larger windows recurse unfused (`hopper.tail_eligible`).

On a mesh with mode 'explicit', `balance` picks the layout: 'block' (the
default), 'tile_cyclic' (windows of at least balance_min_window take
summa's balanced schedules, permuting per call) or
'tile_cyclic_persistent' (the whole padded matrix is permuted ONCE into the
symmetric tile-cyclic layout of tile t = base_case_dim // d, every phase
runs in layout — trmm's per-rank products on `sched_matmul` over the
persistent schedules — and R, R⁻¹ are un-permuted once at exit; grids the
layout cannot cover fall back to 'block' with a
'cholinv::persistent_fallback' note).

In-place semantics are real here (the JAX package returns new arrays):
`out_buffers` are written into, and `schur_in_place=True` overwrites the
trailing windows of the operand — the caller's A itself when no padding is
needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from capital_tpu_torch.ops import batched_small, hopper, lapack, masking
from capital_tpu_torch.parallel import mesh, summa
from capital_tpu_torch.parallel.summa import SyrkArgs, TrmmArgs
from capital_tpu_torch.parallel.topology import Grid
from capital_tpu_torch.robust import detect
from capital_tpu_torch.robust.config import RobustConfig
from capital_tpu_torch.utils import tracing
from capital_tpu_torch.utils.config import BaseCasePolicy


@dataclasses.dataclass(frozen=True)
class CholinvConfig:
    """User configuration, field for field the JAX package's CholinvConfig.

    complete_inv: compute the full R⁻¹, or leave the top-level off-diagonal
        block of R⁻¹ zero (False).
    split: the top window is n >> split.
    base_case_dim: recursion bottoms out at windows <= this size.
    policy: base-case replication policy: which ranks factor each leaf
        panel on a mesh (one device: all coincide).
    mode: 'pallas' (the hand-written kernels), 'explicit' (the same route
        on one device; the explicit SUMMA schedule on a mesh) or 'xla'
        (masked torch.matmul).
    base_case_dtype: dtype of the leaf potrf/trtri; None means f32 for
        inputs narrower than f32, else the input dtype.
    precision: f32 at 'high' runs the kernels' products (mode 'pallas' /
        'explicit') as the JAX package's bf16x3 split (hopper.split_high);
        every other dtype and precision, and the torch.matmul products of
        mode 'xla' and of the mesh's segments, are full precision (f32
        IEEE).
    balance: 'block', 'tile_cyclic' or 'tile_cyclic_persistent' (the last
        two in mode 'explicit' only; see the module docstring).
    balance_min_window: the smallest window 'tile_cyclic' balances.
    schur_in_place: write each Schur complement into the operand's own
        trailing window instead of a fresh buffer (peak memory ~3n² instead
        of ~3.35n²).  MODIFIES the operand — the caller's A when p == n.
    tail_fuse_depth: windows up to base_case_dim << depth may run as one
        fused_tail launch, where `_tail_fusible` admits them (0: never).
    base_prefetch: 2 writes both leaf results with one transpose_pair
        launch, 1 with two transpose launches; bitwise-identical results.
    robust: with a RobustConfig, factor() also returns a LAPACK-style int32
        info of R (robust/detect.factor_info).
    """

    complete_inv: bool = True
    split: int = 1
    base_case_dim: int = 256
    policy: BaseCasePolicy = BaseCasePolicy.REPLICATE_COMM_COMP
    mode: str = "xla"
    base_case_dtype: Optional[torch.dtype] = None
    precision: Optional[str] = "highest"
    balance: str = "block"
    balance_min_window: int = 8192
    schur_in_place: bool = False
    tail_fuse_depth: int = 0
    base_prefetch: int = 2
    robust: Optional[RobustConfig] = None


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One recursion window: [off, off+n) on the diagonal."""

    off: int
    n: int
    is_base: bool
    top: tuple["PlanNode", "PlanNode"] | None = None


def padded_dim(n: int, base_case_dim: int) -> int:
    """Smallest base_case_dim · 2^k >= n."""
    p = min(base_case_dim, n)
    while p < n:
        p *= 2
    return p


def pad_embed_identity(X: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """diag(X, I) of size p (X itself when p == n): SPD stays SPD and
    factors to diag(R, I) with no cross-talk."""
    if p == n:
        return X
    Xp = torch.zeros((p, p), dtype=X.dtype, device=X.device)
    Xp[:n, :n] = X
    Xp.diagonal()[n:] = 1
    return Xp


def plan(n: int, cfg: CholinvConfig, off: int = 0) -> PlanNode:
    """The recursion schedule for a (padded) window of size n."""
    if cfg.split < 1:
        raise ValueError(f"split must be >= 1 (split={cfg.split} would not shrink the window)")
    if n <= cfg.base_case_dim:
        return PlanNode(off=off, n=n, is_base=True)
    n1 = max(cfg.base_case_dim, n >> cfg.split)
    left = plan(n1, cfg, off)
    right = plan(n - n1, cfg, off + n1)
    return PlanNode(off=off, n=n, is_base=False, top=(left, right))


def top_split(n: int, cfg: CholinvConfig) -> int:
    """Column where the top-level recursion splits the cropped n x n output
    (the boundary of the zero block of R⁻¹ when complete_inv=False)."""
    node = plan(padded_dim(n, cfg.base_case_dim), cfg)
    return n if node.is_base else min(node.top[0].n, n)


def _zeros_plan(grid: Grid, node: PlanNode, cfg: CholinvConfig) -> int:
    """The zeros_dead_lower tile when every leaf window is a tile multiple
    (the recursion then writes every live tile), else 0 (plain zeros)."""

    def aligned(nd: PlanNode, tile: int) -> bool:
        if nd.is_base:
            return nd.off % tile == 0 and nd.n % tile == 0
        return all(aligned(c, tile) for c in nd.top)

    tile = min(512, cfg.base_case_dim)
    return tile if grid.num_devices == 1 and aligned(node, tile) else 0


def _check_config(cfg: CholinvConfig) -> None:
    if cfg.balance not in ("block", "tile_cyclic", "tile_cyclic_persistent"):
        raise ValueError(f"unknown balance {cfg.balance!r}")
    if cfg.balance.startswith("tile_cyclic") and cfg.mode != "explicit":
        # the balanced schedules exist only in the explicit schedule
        raise ValueError(f"balance={cfg.balance!r} requires mode='explicit'")


def persistent_tile(grid: Grid, node: PlanNode, cfg: CholinvConfig) -> int:
    """The layout tile of balance='tile_cyclic_persistent', or 0 when the
    grid or plan cannot hold the layout.  t = base_case_dim // d makes the
    alignment quantum d·t == base_case_dim, so every window of a
    bc-aligned plan extracts and updates cleanly (summa.cyclic_window)."""
    d = grid.dx
    if not (cfg.mode == "explicit" and grid.c == 1 and grid.dy == d and d > 1
            and max(1, grid.num_chunks) == 1 and cfg.base_case_dim % d == 0):
        return 0
    bc = cfg.base_case_dim

    def aligned(nd: PlanNode) -> bool:
        if nd.off % bc or nd.n % bc:
            return False
        return nd.is_base or all(aligned(c) for c in nd.top)

    return bc // d if aligned(node) else 0


def _base_case_into(grid, buf, off, n, dest, cfg, Rp, RIp, ptile=0):
    """Leaf: read the window (off, off, n, n) of `buf` (upper triangle
    valid), factor and invert it, and write triu(R) / triu(R⁻¹) into Rp /
    RIp at (dest, dest).  One device: through the transpose kernels as a
    lower panel.  A mesh: the window is materialised (it is replicated to
    every rank) and factored by the ranks of the policy's scope; with the
    persistent layout (ptile) it is extracted in layout, un-permuted on the
    replicated panel, factored, re-permuted and written back band-sized."""
    bc_dtype = cfg.base_case_dtype
    if bc_dtype is None:
        bc_dtype = buf.dtype if buf.dtype.itemsize >= 4 else torch.float32
    with tracing.scope("CI::factor_diag"):
        scope_ = cfg.policy.compute_scope
        comm, ncoll = tracing.replicate_cost(grid, n, n, bc_dtype)
        if grid.num_devices > 1 and scope_ != "all":
            # result broadcast: psum of the masked pair over 'z' (layer) or
            # the whole mesh (root)
            p = grid.c if scope_ == "layer" else grid.num_devices
            bcomm, bcoll = tracing.allreduce_cost(
                grid, n, n, bc_dtype, axes="z" if scope_ == "layer" else "all"
            )
            if p > 1:
                comm, ncoll = comm + 2 * bcomm, ncoll + 2 * bcoll
        tracing.emit(flops=tracing.potrf_trtri_flops(n), comm_bytes=comm, collectives=ncoll)
        if ptile:
            wperm, winv = (torch.from_numpy(x).to(buf.device)
                           for x in summa.tile_cyclic_perm(n, grid.dx, ptile))
            window = summa.cyclic_window(buf, (off, off, n, n), grid.dx, ptile).to(bc_dtype)
            R, Rinv = _scoped_base_factor(grid, window[winv][:, winv], scope_)
            summa.cyclic_window_update(Rp, R[wperm][:, wperm], (dest, dest, n, n), grid.dx, ptile)
            summa.cyclic_window_update(RIp, Rinv[wperm][:, wperm], (dest, dest, n, n), grid.dx,
                                       ptile)
            return Rp, RIp
        if grid.num_devices > 1:
            window = buf[off:off + n, off:off + n].to(bc_dtype)
            R, Rinv = _scoped_base_factor(grid, window, scope_)
            Rp[dest:dest + n, dest:dest + n] = R
            RIp[dest:dest + n, dest:dest + n] = Rinv
            return Rp, RIp
        P_low = hopper.transpose(buf, in_view=(off, off, n, n), out_uplo="L", out_dtype=bc_dtype)
        # torch.linalg hands back column-major factors; the write-back
        # kernels read row-major panels (a bc x bc copy each)
        L = lapack.cholesky_lower(P_low).contiguous()
        eye = torch.eye(n, dtype=bc_dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False).contiguous()
        if cfg.base_prefetch >= 2:
            return hopper.transpose_pair(L, Linv, Rp, RIp, dest=dest)
        Rp = hopper.transpose(L, out_uplo="U", out=Rp, out_off=(dest, dest))
        RIp = hopper.transpose(Linv, out_uplo="U", out=RIp, out_off=(dest, dest))
        return Rp, RIp


def _scoped_base_factor(grid, window, scope_):
    """potrf + trtri of a replicated panel on a mesh, run by the ranks the
    policy names (reference cholinv policy.h:160-514):

      'all'   — every rank factors the replicated panel (global code, no
                collective; 'layer' on a c == 1 grid is the same)
      'layer' — only the z = 0 ranks factor; the pair reaches the other
                layers as a psum over 'z' of the layer-masked value
      'root'  — only rank (0, 0, 0) factors; the pair is summed over the
                whole mesh
    """
    def factor(w):
        return lapack.potrf_trtri(masking.symmetrize_from(w, "U"), uplo="U")

    if scope_ == "all" or (scope_ == "layer" and grid.c == 1):
        return factor(window)
    axes = ("z",) if scope_ == "layer" else ("x", "y", "z")
    Rs, Rinvs = [], []
    for r in range(grid.num_devices):
        if all(mesh.axis_index(grid, r, a) == 0 for a in axes):
            R, Rinv = factor(window)
        else:
            R = Rinv = torch.zeros_like(window)
        Rs.append(R)
        Rinvs.append(Rinv)
    return (mesh.replicated(grid, mesh.psum(grid, Rs, axes)),
            mesh.replicated(grid, mesh.psum(grid, Rinvs, axes)))


def _tail_fusible(grid, buf, off, node, cfg, top, Rp) -> bool:
    """Whether this plan() subtree runs as one fused_tail launch (the JAX
    package's gate): the knob is on and the window within
    base_case_dim << tail_fuse_depth; one device; not a top-level window
    under complete_inv=False (the kernel always writes the whole window
    inverse); the window a multiple of 128 and off, node.off and the
    buffers' dimensions multiples of it; bf16 or f32 (f64 takes the
    unfused recursion); and the window fits the kernel
    (`hopper.tail_eligible`, whose envelope applies to CUDA
    buffers only)."""
    if cfg.tail_fuse_depth <= 0:
        return False
    if node.n > cfg.base_case_dim << cfg.tail_fuse_depth:
        return False
    if grid.num_devices != 1:
        return False
    if top and not cfg.complete_inv:
        return False
    if node.n % 128:
        return False
    if (off % node.n or node.off % node.n or buf.shape[0] % node.n
            or buf.shape[1] % node.n or Rp.shape[0] % node.n):
        return False
    if not batched_small.dtype_capable(buf.dtype):
        return False
    return hopper.tail_eligible(node.n, buf.dtype, interpret=not buf.is_cuda)


def _recurse(grid, buf, off, node, cfg, top, Rp, RIp, ptile=0, tail_infos=None):
    """One recursion window: the input is the (off, off, node.n, node.n)
    window of `buf` (upper triangle valid), the output blocks land in Rp /
    RIp at the window's absolute offset node.off.  ptile != 0: all three
    buffers are in the persistent tile-cyclic layout of that tile.  A fused
    subtree appends (node.off, node.n, info) to `tail_infos` when it is a
    list."""
    if not ptile and _tail_fusible(grid, buf, off, node, cfg, top, Rp):
        with tracing.scope("CI::tail_fused"):
            tracing.emit(flops=tracing.fused_tail_flops(node.n))
            Rp, RIp, kinfo = hopper.fused_tail(
                buf, Rp, RIp, off=off, n=node.n, dest=node.off, precision=cfg.precision,
            )
        if tail_infos is not None:
            tail_infos.append((node.off, node.n, kinfo))
        return Rp, RIp

    if node.is_base:
        return _base_case_into(grid, buf, off, node.n, node.off, cfg, Rp, RIp, ptile)

    left, right = node.top
    n1, n2 = left.n, right.n
    d0 = node.off

    # 1. top-left window
    Rp, RIp = _recurse(grid, buf, off, left, cfg, False, Rp, RIp, ptile, tail_infos)

    def bal(win: int) -> str:
        # the persistent layout states its storage contract on every call;
        # 'tile_cyclic' balances the explicit windows of balance_min_window
        # and up (summa falls back with a note where it cannot)
        if ptile:
            return "tile_cyclic_persistent"
        return ("tile_cyclic" if cfg.balance == "tile_cyclic" and cfg.mode == "explicit"
                and win >= cfg.balance_min_window else "block")

    # 2. TRSM phase: R12 = R11⁻ᵀ · A12
    with tracing.scope("CI::trsm"):
        summa.trmm(
            grid, RIp, buf,
            TrmmArgs(side="L", uplo="U", trans_a=True, precision=cfg.precision),
            mode=cfg.mode,
            a_view=(d0, d0, n1, n1),
            b_view=(off, off + n1, n1, n2),
            out=Rp, out_off=(d0, d0 + n1),
            balance=bal(n1), cyclic_tile=ptile,
        )

    # 3. Schur complement: A22' = A22 − R12ᵀR12, into buf's own trailing
    # window (schur_in_place) or a fresh (n2, n2) buffer
    with tracing.scope("CI::tmu"):
        S = summa.syrk(
            grid, Rp, buf,
            SyrkArgs(trans=True, alpha=-1.0, beta=1.0, precision=cfg.precision),
            mode=cfg.mode,
            a_view=(d0, d0 + n1, n1, n2),
            c_view=(off + n1, off + n1, n2, n2),
            in_place=cfg.schur_in_place,
            balance=bal(n2), cyclic_tile=ptile,
        )

    # 4. trailing window
    s_off = off + n1 if cfg.schur_in_place else 0
    Rp, RIp = _recurse(grid, S, s_off, right, cfg, False, Rp, RIp, ptile, tail_infos)

    # 5. inverse completion: R⁻¹12 = −R11inv·R12·R22inv, skipped at the top
    # level when complete_inv=False (the block keeps its initial zeros)
    if cfg.complete_inv or not top:
        with tracing.scope("CI::inv"):
            T = summa.trmm(
                grid, RIp, Rp,
                TrmmArgs(side="L", uplo="U", precision=cfg.precision),
                mode=cfg.mode,
                a_view=(d0, d0, n1, n1),
                b_view=(d0, d0 + n1, n1, n2),
                balance=bal(n1), cyclic_tile=ptile,
            )
            # the side-R completion never takes the per-call balanced
            # schedule, but states the persistent layout's contract
            summa.trmm(
                grid, RIp, T,
                TrmmArgs(side="R", uplo="U", alpha=-1.0, precision=cfg.precision),
                mode=cfg.mode,
                a_view=(right.off, right.off, n2, n2),
                out=RIp, out_off=(d0, d0 + n1),
                balance="tile_cyclic_persistent" if ptile else "block", cyclic_tile=ptile,
            )
    return Rp, RIp


def factor(
    grid: Grid,
    A: torch.Tensor,
    cfg: CholinvConfig = CholinvConfig(),
    out_buffers: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Factor SPD A into (R, Rinv): A = RᵀR, Rinv = R⁻¹ (upper triangular).

    With complete_inv=False the top-level off-diagonal block of Rinv is
    zero.  out_buffers: (Rp, RIp) p x p buffers to factor INTO (they are
    written in place and returned, cropped when p > n); their strictly-
    lower halves must be zero, p == padded_dim(n, bc), complete_inv=True —
    a previous factor's outputs satisfy this.  With cfg.schur_in_place the
    Schur complements are written into the operand: A itself is modified
    when n needs no padding (hand factor a copy if A is needed afterwards).
    With cfg.robust set the return is (R, Rinv, info), info the int32
    potrf status of R (0 clean)."""
    n = A.shape[0]
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"cholinv needs a square matrix, got {tuple(A.shape)}")
    if A.device.type != grid.device.type:
        raise ValueError(f"A is on {A.device}, the grid on {grid.device}")
    _check_config(cfg)
    p = padded_dim(n, cfg.base_case_dim)
    Ap = pad_embed_identity(A, n, p)
    node = plan(p, cfg)

    # the persistent layout: permute once here (a symmetric permutation, so
    # SPD and the triangular contract of the elimination order survive),
    # un-permute R and R⁻¹ once at exit — three lifetime shuffles priced as
    # grid transposes
    ptile = 0
    if cfg.balance == "tile_cyclic_persistent":
        ptile = persistent_tile(grid, node, cfg)
        if ptile:
            perm, pinv = (torch.from_numpy(x).to(A.device)
                          for x in summa.tile_cyclic_perm(p, grid.dx, ptile))
            Ap = Ap[perm][:, perm]
            cbytes, ncoll = tracing.transpose_cost(grid, p, p, Ap.dtype)
            tracing.emit(comm_bytes=3 * cbytes, collectives=3 * ncoll)
        else:
            tracing.note("cholinv::persistent_fallback")

    if out_buffers is not None:
        Rp, RIp = out_buffers
        if Rp.shape != (p, p) or RIp.shape != (p, p):
            raise ValueError(
                f"out_buffers must be ({p}, {p}) for n={n}, "
                f"bc={cfg.base_case_dim}; got {tuple(Rp.shape)}, {tuple(RIp.shape)}"
            )
        if not cfg.complete_inv:
            raise ValueError(
                "out_buffers requires complete_inv=True (the skipped "
                "off-diagonal window would keep the previous contents)"
            )
        if ptile:
            # the buffers arrive in original order: into the layout, in
            # place (zeros are permutation-invariant), two more shuffles
            Rp.copy_(Rp[perm][:, perm])
            RIp.copy_(RIp[perm][:, perm])
            cbytes, ncoll = tracing.transpose_cost(grid, p, p, Rp.dtype)
            tracing.emit(comm_bytes=2 * cbytes, collectives=2 * ncoll)
    else:
        tile = _zeros_plan(grid, node, cfg)
        if tile:
            # every live upper tile is written exactly once by the
            # recursion; only the dead lower half (and the skipped top-right
            # R⁻¹ window when complete_inv=False) needs zeros
            with tracing.scope("CI::buffers"):
                Rp = hopper.zeros_dead_lower(p, A.dtype, tile, device=A.device)
                extra = (
                    ()
                    if cfg.complete_inv or node.is_base
                    else ((0, node.top[0].n, node.top[0].n, p - node.top[0].n),)
                )
                RIp = hopper.zeros_dead_lower(p, A.dtype, tile, extra=extra, device=A.device)
        else:
            Rp = torch.zeros((p, p), dtype=A.dtype, device=A.device)
            RIp = torch.zeros((p, p), dtype=A.dtype, device=A.device)

    # fused windows report breakdown through their in-kernel info, which
    # combines with the post-hoc scan of R
    tail_infos = [] if cfg.robust is not None else None
    R, Rinv = _recurse(grid, Ap, 0, node, cfg, True, Rp, RIp, ptile, tail_infos)
    if ptile:
        R.copy_(R[pinv][:, pinv])
        Rinv.copy_(Rinv[pinv][:, pinv])
    if p != n:
        R, Rinv = R[:n, :n], Rinv[:n, :n]
    if cfg.robust is not None:
        info = detect.factor_info(R)
        if tail_infos:
            info = detect.combine_block_infos(info, tail_infos, n)
        return R, Rinv, info
    return R, Rinv


def factor_buffers(
    grid: Grid, n: int, dtype: torch.dtype, cfg: CholinvConfig = CholinvConfig()
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh (Rp, RIp) buffers satisfying factor's out_buffers contract."""
    p = padded_dim(n, cfg.base_case_dim)
    node = plan(p, cfg)
    tile = _zeros_plan(grid, node, cfg)
    if tile:
        with tracing.scope("CI::buffers"):
            return (
                hopper.zeros_dead_lower(p, dtype, tile, device=grid.device),
                hopper.zeros_dead_lower(p, dtype, tile, device=grid.device),
            )
    return (
        torch.zeros((p, p), dtype=dtype, device=grid.device),
        torch.zeros((p, p), dtype=dtype, device=grid.device),
    )


def solve(grid: Grid, A: torch.Tensor, B: torch.Tensor, cfg: CholinvConfig = CholinvConfig()):
    """SPD solve A·X = B: factor with complete_inv=False, then the two
    triangular sweeps (ops/lapack.potrs).  With cfg.robust the return is
    (X, info); X is garbage when info != 0."""
    if B.shape[0] != A.shape[0]:
        raise ValueError(f"shape mismatch: A {tuple(A.shape)} vs B {tuple(B.shape)}")
    ccfg = dataclasses.replace(cfg, complete_inv=False)
    if cfg.robust is not None:
        R, _, info = factor(grid, A, ccfg)
        return lapack.potrs(R, B, uplo="U"), info
    R, _ = factor(grid, A, ccfg)
    return lapack.potrs(R, B, uplo="U")


def spd_inverse(grid: Grid, A: torch.Tensor, cfg: CholinvConfig = CholinvConfig()) -> torch.Tensor:
    """A⁻¹ = R⁻¹·R⁻ᵀ for SPD A."""
    cfg = dataclasses.replace(cfg, complete_inv=True, robust=None)
    _, Rinv = factor(grid, A, cfg)
    return summa.gemm(
        grid, Rinv, Rinv, args=summa.GemmArgs(trans_b=True, precision=cfg.precision),
        mode=cfg.mode,
    )
