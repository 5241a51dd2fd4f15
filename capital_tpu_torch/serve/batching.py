"""Shape bucketing and micro-batch assembly (counterpart of
capital_tpu/serve/batching.py): the dense ops posv, lstsq and inv, the
structured ops posv_blocktri and posv_arrowhead, and the factor-residency
and streaming-session bucket programs.

Every distinct operand shape would be a fresh program; bucketing pads each
request to the smallest rung of the config's ladders with a structure-safe
pad (`masking.embed_identity_tail`: a padded SPD matrix stays SPD and
factors to diag(R, I), a padded tall operand keeps full column rank), and
zero-fills the right-hand side, so the identity tail solves to exact zeros
and `crop` recovers the request's solution.  A short batch is topped up
with identity fill problems against zero right-hand sides.

posv_blocktri packs the chain as A = (2, nblocks, b, b) (A[0] the diagonal
blocks, A[1] the sub-diagonal ones, A[1, 0] dead) and B = (nblocks, b,
nrhs); nblocks and b bucket on their own ladders.  Each diagonal block pads
to diag(D_i, I), couplings and right-hand sides zero-pad, and appended
chain blocks are identity blocks: the real blocks' solution is bitwise the
unpadded one.  posv_arrowhead adds one packed tail operand
(models/arrowhead.pack) whose border columns zero-pad and whose corner
embeds as diag(S, I); the border width s has its own ladder.

The factor-residency ops bucket on the engine-composed operands, not the
wire payload: chol_update / chol_downdate as (resident factor R (n, n),
rank-k panel V (n, k)) on `buckets` x `nrhs_buckets`, the pad diag(R, I)
with zero V rows and columns (a fixed point of the sweep); posv_cached as
(resident R, RHS) and its miss program posv_cached_miss as (A, RHS), both
at posv's geometry; blocktri_extend and the session open / append program
session_extend as (appended chain pack (2, nblocks, b, b), resident carry
(b, b)), the carry padded to diag(L_last, I); session_solve as the 4-stack
[D; C; L; Wt] (4, nblocks, b, b) with the factor half padded consistently
with the window half (diag(L_i, I) beside diag(D_i, I)).  A bucket carries
the accuracy tier ('balanced', 'fast', 'guaranteed'): tiers change the
program, not the padded shapes.

Padding runs on the operands' device (the card on the engine's path).
Functions that create tensors take `device=`, which defaults to the CUDA
card and raises without one.
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.ops import masking
from capital_tpu_torch.robust import refine
from capital_tpu_torch.utils import tracing

OPS = ("posv", "lstsq", "inv", "posv_blocktri", "posv_arrowhead",
       "chol_update", "chol_downdate", "posv_cached", "blocktri_extend")

#: ops that require a resident factor (engine.submit factor_token=...).
FACTOR_OPS = ("chol_update", "chol_downdate", "posv_cached",
              "blocktri_extend")

#: engine-internal bucket op: a posv_cached whose token is not resident
#: rides the full (A, B) operands through a 3-output refactor program
#: (X, R, info) so landing can install R — the seeding route.
MISS_OPS = ("posv_cached_miss",)

#: the client-facing streaming-session ops (SolveEngine.submit, every one
#: with factor_token = the session id).  session_open and session_append
#: run the one engine-internal `session_extend` bucket program;
#: session_solve buckets under its own name on the 4-stack [D; C; L; Wt];
#: session_contract and session_close are host-side and have no program.
SESSION_OPS = ("session_open", "session_append", "session_solve",
               "session_contract", "session_close")

#: engine-internal session bucket ops.
SESSION_BUCKET_OPS = ("session_extend", "session_solve")

#: the dense ops
DENSE_OPS = ("posv", "lstsq", "inv")

#: the block-tridiagonal chain ops (models/blocktri, models/arrowhead)
STRUCTURED_OPS = ("posv_blocktri", "posv_arrowhead")

#: the rank-k update ops
UPDATE_OPS = ("chol_update", "chol_downdate")

#: the chain-extension bucket ops: (appended chain pack, resident carry)
EXTEND_OPS = ("blocktri_extend", "session_extend")


def check_op(op: str) -> None:
    """Raise ValueError (the reference's message) for an op without a
    bucket program: OPS, MISS_OPS and SESSION_BUCKET_OPS have one."""
    if op in OPS or op in MISS_OPS or op in SESSION_BUCKET_OPS:
        return
    raise ValueError(f"unknown serve op {op!r}; expected one of {OPS}")


def _check_tier(tier: str) -> None:
    if tier not in refine.TIERS:
        raise ValueError(f"accuracy_tier must be one of {refine.TIERS}, got {tier!r}")


def _device(device) -> torch.device:
    """The device tensors are created on: the CUDA card unless given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "serve.batching: no CUDA device; pass device='cpu' to build "
                "batches on the host"
            )
        device = "cuda"
    return torch.device(device)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One program shape class: the padded per-problem operand shapes plus
    the micro-batch capacity.  Hashable."""

    op: str
    dtype: str
    a_shape: tuple[int, ...]
    b_shape: tuple[int, ...] | None
    capacity: int
    tier: str = "balanced"

    @property
    def key(self) -> tuple:
        return (self.op, self.dtype, self.a_shape, self.b_shape,
                self.capacity, self.tier)


def bucket_label(bucket) -> str:
    """Compact bucket name, e.g. ``posv/f32/a256x256/b256x8/c8``.  Accepts
    a Bucket or its `.key` tuple."""
    if isinstance(bucket, tuple):
        bucket = Bucket(*bucket)
    a = "x".join(str(d) for d in bucket.a_shape)
    b = ("" if bucket.b_shape is None
         else "/b" + "x".join(str(d) for d in bucket.b_shape))
    tier = "" if bucket.tier == "balanced" else f"/{bucket.tier}"
    dt = str(bucket.dtype).replace("float", "f").replace("bfloat", "bf")
    return f"{bucket.op}/{dt}/a{a}{b}/c{bucket.capacity}{tier}"


def _pick(ladder: tuple[int, ...], v: int) -> int | None:
    """Smallest ladder rung >= v, or None (oversize)."""
    best = None
    for r in ladder:
        if r >= v and (best is None or r < best):
            best = r
    return best


def bucket_for(op: str, a_shape, b_shape, dtype: str, cfg,
               *, tier: str = "balanced") -> Bucket | None:
    """Resolve a request's operand shapes to a bucket, or None when any
    dimension exceeds its ladder (the request then takes the single route).
    lstsq rows bucket at `m + (nb - n)`: each padded column needs its own
    appended row (masking.embed_identity_tail).  posv_blocktri buckets
    nblocks and b on cfg.nblocks_buckets / cfg.block_buckets and nrhs on
    the dense ladder; posv_arrowhead's tail operand (nblocks·b + s, s + k)
    buckets to (nbb·bb + sb, sb + kb), s on cfg.border_buckets;
    chol_update / chol_downdate bucket (R (n, n), V (n, k)) to
    ((nb, nb), (nb, kb)); posv_cached / posv_cached_miss take posv's
    geometry; blocktri_extend / session_extend bucket the appended chain
    like posv_blocktri with the carry at (bb, bb); session_solve buckets
    the 4-stack [D; C; L; Wt] to (4, nbb, bb, bb).  `tier` is stamped into
    the bucket."""
    check_op(op)
    _check_tier(tier)
    if tier != "balanced":
        b = bucket_for(op, a_shape, b_shape, dtype, cfg)
        return None if b is None else dataclasses.replace(b, tier=tier)
    if op in UPDATE_OPS or op in ("posv_cached", "posv_cached_miss"):
        nb = _pick(cfg.buckets, a_shape[0])
        kb = _pick(cfg.nrhs_buckets, b_shape[1])
        if nb is None or kb is None:
            return None
        return Bucket(op, dtype, (nb, nb), (nb, kb), cfg.max_batch)
    if op in EXTEND_OPS:
        _, nblocks, b, _ = a_shape
        nbb = _pick(cfg.nblocks_buckets, nblocks)
        bb = _pick(cfg.block_buckets, b)
        if nbb is None or bb is None:
            return None
        return Bucket(op, dtype, (2, nbb, bb, bb), (bb, bb), cfg.max_batch)
    if op == "session_solve":
        _, nblocks, b, _ = a_shape
        nbb = _pick(cfg.nblocks_buckets, nblocks)
        bb = _pick(cfg.block_buckets, b)
        kb = _pick(cfg.nrhs_buckets, b_shape[2])
        if nbb is None or bb is None or kb is None:
            return None
        return Bucket(op, dtype, (4, nbb, bb, bb), (nbb, bb, kb), cfg.max_batch)
    if op == "posv_blocktri":
        _, nblocks, b, _ = a_shape
        nbb = _pick(cfg.nblocks_buckets, nblocks)
        bb = _pick(cfg.block_buckets, b)
        kb = _pick(cfg.nrhs_buckets, b_shape[2])
        if nbb is None or bb is None or kb is None:
            return None
        return Bucket(op, dtype, (2, nbb, bb, bb), (nbb, bb, kb), cfg.max_batch)
    if op == "posv_arrowhead":
        _, nblocks, b, _ = a_shape
        s = b_shape[0] - nblocks * b
        k = b_shape[1] - s
        nbb = _pick(cfg.nblocks_buckets, nblocks)
        bb = _pick(cfg.block_buckets, b)
        sb = _pick(cfg.border_buckets, s)
        kb = _pick(cfg.nrhs_buckets, k)
        if nbb is None or bb is None or sb is None or kb is None:
            return None
        return Bucket(op, dtype, (2, nbb, bb, bb), (nbb * bb + sb, sb + kb), cfg.max_batch)
    if op in ("posv", "inv"):
        n = a_shape[0]
        nb = _pick(cfg.buckets, n)
        if nb is None:
            return None
        if op == "inv":
            return Bucket(op, dtype, (nb, nb), None, cfg.max_batch)
        kb = _pick(cfg.nrhs_buckets, b_shape[1])
        if kb is None:
            return None
        return Bucket(op, dtype, (nb, nb), (nb, kb), cfg.max_batch)
    m, n = a_shape
    nb = _pick(cfg.buckets, n)
    if nb is None:
        return None
    mb = _pick(cfg.rows_buckets, m + (nb - n))
    kb = _pick(cfg.nrhs_buckets, b_shape[1])
    if mb is None or kb is None:
        return None
    return Bucket(op, dtype, (mb, nb), (mb, kb), cfg.max_batch)


def pad_operands(op: str, A, B, bucket: Bucket):
    """Pad one request's operands to the bucket's per-problem shapes:
    identity-tail embed for the factored operand, zero-fill for the RHS
    (on A's device).  For the update ops diag(R, I) stays a valid upper
    factor and the zero V rows and columns make every padded rotation a
    t = 0 no-op: the pad is a fixed point of the sweep."""
    check_op(op)
    with tracing.scope("serve::pad"):
        if op == "posv_blocktri":
            return _pad_blocktri(A, B, bucket)
        if op == "posv_arrowhead":
            return _pad_arrowhead(A, B, bucket)
        if op in EXTEND_OPS:
            return _pad_blocktri_extend(A, B, bucket)
        if op == "session_solve":
            return _pad_session_solve(A, B, bucket)
        pa = masking.embed_identity_tail(A, *bucket.a_shape)
        pb = None
        if bucket.b_shape is not None:
            m, k = B.shape
            pb = torch.nn.functional.pad(
                B, (0, bucket.b_shape[1] - k, 0, bucket.b_shape[0] - m)
            )
        return pa, pb


def _chain_pad(A, bucket: Bucket, diagonals=(0,)):
    """The chain pack A = (stack, nblocks, b, b) padded to the bucket's
    (stack, nbb, bb, bb): the real blocks of each stack entry in
    `diagonals` complete to diag(X_i, I) and its appended blocks become I;
    every other entry (the couplings) zero-pads."""
    _, nblocks, b, _ = A.shape
    nbb, bb = bucket.a_shape[1], bucket.a_shape[2]
    pa = torch.nn.functional.pad(A, (0, bb - b, 0, bb - b, 0, nbb - nblocks))
    eye = torch.eye(bb, dtype=A.dtype, device=A.device)
    tail = torch.where(torch.arange(bb, device=A.device) >= b, eye, torch.zeros_like(eye))
    blk = (torch.arange(nbb, device=A.device) < nblocks)[:, None, None]
    emb = torch.where(blk, tail, eye)
    for i in diagonals:
        pa[i] += emb
    return pa


def _pad_blocktri(A, B, bucket: Bucket):
    """Structure-safe pad for the block-tridiagonal chain (module
    docstring): the padded operand stays block-tridiagonal SPD and the real
    blocks' solution is bitwise the unpadded one (trailing identity blocks
    never feed back; their carries are exact zeros)."""
    nbb, bb, kb = bucket.b_shape
    nblocks, b, k = B.shape
    return _chain_pad(A, bucket), torch.nn.functional.pad(
        B, (0, kb - k, 0, bb - b, 0, nbb - nblocks))


def _pad_arrowhead(A, P, bucket: Bucket):
    """Structure-safe pad for the block-arrowhead operands: the chain pack
    pads as `_pad_blocktri`'s; in the tail operand the border columns
    zero-pad, the corner embeds as diag(S, I) and the RHS zero-pads, so the
    padded system is diag(A_real, I).  The chain rows are re-blocked before
    padding (a flat row pad would interleave the appended block-tail rows
    wrongly when bb > b)."""
    _, nblocks, b, _ = A.shape
    nbb, bb = bucket.a_shape[1], bucket.a_shape[2]
    n_t = nblocks * b
    s = P.shape[0] - n_t
    k = P.shape[1] - s
    sb = bucket.b_shape[0] - nbb * bb
    kb = bucket.b_shape[1] - sb
    pad = torch.nn.functional.pad
    top = P[:n_t].reshape(nblocks, b, s + k)
    ptop = torch.cat([pad(top[..., :s], (0, sb - s, 0, bb - b, 0, nbb - nblocks)),
                      pad(top[..., s:], (0, kb - k, 0, bb - b, 0, nbb - nblocks))],
                     dim=-1).reshape(nbb * bb, sb + kb)
    pbot = torch.cat([masking.embed_identity_tail(P[n_t:, :s], sb, sb),
                      pad(P[n_t:, s:], (0, kb - k, 0, sb - s))], dim=-1)
    return _chain_pad(A, bucket), torch.cat([ptop, pbot], dim=0)


def _pad_blocktri_extend(A, carry, bucket: Bucket):
    """Structure-safe pad for the chain-extension operands: the appended
    blocks pad as `_pad_blocktri`'s, and the resident carry L_last embeds
    as diag(L_last, I), a lower factor of diag(S_last, I), so the first
    appended block's coupling solve stays block-diagonal arithmetic and
    the real blocks' factor is bitwise the unpadded one."""
    return _chain_pad(A, bucket), masking.embed_identity_tail(carry, *bucket.b_shape)


def _pad_session_solve(A, B, bucket: Bucket):
    """Structure-safe pad for the session 4-stack [D; C; L; Wt]: the window
    half pads as `_pad_blocktri`'s (diag(D_i, I), zero couplings, appended
    identity blocks) and the factor half consistently with it —
    diag(L_i, I) is the factor of diag(S_i, I) and the zero-padded Wt keeps
    both sweeps' padded carries exact zeros — so the real blocks' solution
    is bitwise the unpadded one and the guaranteed tier's residual is
    exactly zero on every padded row."""
    nbb, bb, kb = bucket.b_shape
    nblocks, b, k = B.shape
    return _chain_pad(A, bucket, diagonals=(0, 2)), torch.nn.functional.pad(
        B, (0, kb - k, 0, bb - b, 0, nbb - nblocks))


def fill_problem(bucket: Bucket, *, device=None):
    """The benign problem that tops a short batch up to capacity: an
    identity operand (SPD for posv/inv, orthonormal columns for lstsq)
    against a zero RHS.  For posv_blocktri the identity chain (identity
    diagonal blocks, zero couplings); for posv_arrowhead that chain coupled
    to an identity corner through a zero border (the whole matrix is I).
    The extend programs extend the identity chain from an identity carry;
    session_solve's fill is the identity window beside its own factor
    (L = I, Wt = 0)."""
    check_op(bucket.op)
    dev, dt = _device(device), _dtype(bucket.dtype)
    if bucket.op in EXTEND_OPS or bucket.op == "session_solve":
        _, nbb, bb, _ = bucket.a_shape
        eyes = torch.eye(bb, dtype=dt, device=dev).expand(nbb, bb, bb)
        zeros = torch.zeros((nbb, bb, bb), dtype=dt, device=dev)
        if bucket.op == "session_solve":
            return (torch.stack([eyes, zeros, eyes, zeros]),
                    torch.zeros(bucket.b_shape, dtype=dt, device=dev))
        return torch.stack([eyes, zeros]), torch.eye(bb, dtype=dt, device=dev)
    if bucket.op in STRUCTURED_OPS:
        _, nbb, bb, _ = bucket.a_shape
        eyes = torch.eye(bb, dtype=dt, device=dev).expand(nbb, bb, bb)
        fa = torch.stack([eyes, torch.zeros((nbb, bb, bb), dtype=dt, device=dev)])
        fb = torch.zeros(bucket.b_shape, dtype=dt, device=dev)
        if bucket.op == "posv_arrowhead":
            sb = bucket.b_shape[0] - nbb * bb
            fb[nbb * bb:, :sb] = torch.eye(sb, dtype=dt, device=dev)
        return fa, fb
    fa = torch.eye(*bucket.a_shape, dtype=dt, device=dev)
    fb = None
    if bucket.b_shape is not None:
        fb = torch.zeros(bucket.b_shape, dtype=dt, device=dev)
    return fa, fb


def assemble(padded_a, padded_b, bucket: Bucket, *, device=None):
    """Stack per-request padded operands into the bucket's fixed batch
    shape, topping up with fill problems.  Returns (Ab, Bb | None,
    occupancy), occupancy the real-request fraction of capacity."""
    nreq = len(padded_a)
    if not 0 < nreq <= bucket.capacity:
        raise ValueError(f"{nreq} requests for capacity {bucket.capacity}")
    fa, fb = fill_problem(bucket, device=device)
    Ab = torch.stack(list(padded_a) + [fa] * (bucket.capacity - nreq))
    Bb = None
    if bucket.b_shape is not None:
        Bb = torch.stack(list(padded_b) + [fb] * (bucket.capacity - nreq))
    return Ab, Bb, nreq / bucket.capacity


def crop(op: str, X, a_shape, b_shape):
    """Slice one padded per-problem solution back to the request's true
    shape (the identity tail's rows of X are exact zeros)."""
    if op in ("posv", "posv_cached", "posv_cached_miss"):
        return X[: a_shape[0], : b_shape[1]]
    if op == "lstsq":
        return X[: a_shape[1], : b_shape[1]]
    if op in ("posv_blocktri", "session_solve"):
        return X[: a_shape[1], : a_shape[2], : b_shape[2]]
    if op in EXTEND_OPS:
        # the stacked (2, nbb, bb, bb) [L; Wt] back to the appended blocks
        return X[:, : a_shape[1], : a_shape[2], : a_shape[2]]
    if op == "posv_arrowhead":
        # X is the chain half (nbb, bb, kb), blocked, so slicing unpads; the
        # corner half is the program's second output
        nblocks, b = a_shape[1], a_shape[2]
        s = b_shape[0] - nblocks * b
        return X[:nblocks, :b, : b_shape[1] - s]
    check_op(op)
    return X[: a_shape[0], : a_shape[0]]  # inv, chol_update, chol_downdate
