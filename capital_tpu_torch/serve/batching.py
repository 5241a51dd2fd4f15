"""Shape bucketing and micro-batch assembly (counterpart of
capital_tpu/serve/batching.py), the dense part: posv, lstsq and inv.

Every distinct operand shape would be a fresh program; bucketing pads each
request to the smallest rung of the config's ladders with a structure-safe
pad (`masking.embed_identity_tail`: a padded SPD matrix stays SPD and
factors to diag(R, I), a padded tall operand keeps full column rank), and
zero-fills the right-hand side, so the identity tail solves to exact zeros
and `crop` recovers the request's solution.  A short batch is topped up
with identity fill problems against zero right-hand sides.

The structured ops (posv_blocktri, posv_arrowhead, the session ops) wait
for ROADMAP Queue A item 6, the factor-residency ops for item 8, and
accuracy tiers other than 'balanced' for item 7: each raises
NotImplementedError naming its item.  Functions that create tensors take
`device=`, which defaults to the CUDA card and raises without one.
"""

from __future__ import annotations

import dataclasses

import torch

from capital_tpu_torch.ops import masking
from capital_tpu_torch.utils import tracing

OPS = ("posv", "lstsq", "inv", "posv_blocktri", "posv_arrowhead",
       "chol_update", "chol_downdate", "posv_cached", "blocktri_extend")

#: ops that require a resident factor (engine.submit factor_token=...).
FACTOR_OPS = ("chol_update", "chol_downdate", "posv_cached",
              "blocktri_extend")

#: engine-internal bucket op of the residency-miss (seeding) route.
MISS_OPS = ("posv_cached_miss",)

#: engine-internal session bucket ops.
SESSION_BUCKET_OPS = ("session_extend", "session_solve")

#: the ops this slice serves
DENSE_OPS = ("posv", "lstsq", "inv")


def check_op(op: str) -> None:
    """Raise for an op this slice does not serve: NotImplementedError
    naming its ROADMAP item for a later slice's op, ValueError for an
    unknown one."""
    if op in DENSE_OPS:
        return
    if op in FACTOR_OPS or op in MISS_OPS:
        item = "Queue A item 8, serve tier (factor residency)"
    elif op in OPS or op in SESSION_BUCKET_OPS:
        item = "Queue A item 6, structured solvers"
    else:
        raise ValueError(f"unknown serve op {op!r}; expected one of {OPS}")
    raise NotImplementedError(f"serve op {op!r} is not ported yet (ROADMAP {item})")


def _check_tier(tier: str) -> None:
    if tier != "balanced":
        raise NotImplementedError(
            f"accuracy_tier={tier!r} is not ported yet (ROADMAP Queue A item 7, "
            "refinement); only 'balanced' is served"
        )


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
    appended row (masking.embed_identity_tail)."""
    check_op(op)
    _check_tier(tier)
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
    (on A's device)."""
    check_op(op)
    with tracing.scope("serve::pad"):
        pa = masking.embed_identity_tail(A, *bucket.a_shape)
        pb = None
        if bucket.b_shape is not None:
            m, k = B.shape
            pb = torch.nn.functional.pad(
                B, (0, bucket.b_shape[1] - k, 0, bucket.b_shape[0] - m)
            )
        return pa, pb


def fill_problem(bucket: Bucket, *, device=None):
    """The benign problem that tops a short batch up to capacity: an
    identity operand (SPD for posv/inv, orthonormal columns for lstsq)
    against a zero RHS."""
    check_op(bucket.op)
    dev, dt = _device(device), _dtype(bucket.dtype)
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
    if op == "posv":
        return X[: a_shape[0], : b_shape[1]]
    if op == "lstsq":
        return X[: a_shape[1], : b_shape[1]]
    check_op(op)
    return X[: a_shape[0], : a_shape[0]]  # inv
