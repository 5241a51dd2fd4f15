"""Deterministic fault injection keyed on tracing.PHASE_REGISTRY tags
(counterpart of capital_tpu/robust/faultinject.py).

A `Fault` names a registered phase tag, which occurrence of that tag to
hit, and the corruption to apply; `tap(x)` calls in ops/lapack and
models/qr apply it.  Injection is positional and host-side, so the same
plan always corrupts the same site::

    with faultinject.active_plan(
        faultinject.Fault(tag="CQR::gram", kind="rank_deficient")
    ) as plan:
        Q, R, info = qr.factor(grid, A, cfg_with_robust)
    assert plan.fired == [("CQR::gram", 0)]

PyTorch runs eagerly, so a tap fires only where the code actually runs.
The JAX package's taps fire at trace time, where both branches of a
lax.cond are traced; taps inside recovery branches therefore fire there
and not here.  Compare `plan.fired` across the two packages only at sites
outside the recovery branches (e.g. CQR::gram).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from capital_tpu_torch.utils import tracing

_KINDS = ("nan", "inf", "rank_deficient", "raise")


class FaultInjected(RuntimeError):
    """Raised by kind='raise' faults, as a device-side abort would be."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planted fault.

    tag: a phase tag registered in tracing.PHASE_REGISTRY (ValueError
        otherwise — typos must not silently never fire).
    kind: 'nan' / 'inf' poison one element; 'rank_deficient' zeroes the
        last row and column (a singular but finite gram); 'raise' throws
        FaultInjected.
    index: which occurrence of `tag` to hit (0-based, counted per plan).
    count: how many consecutive occurrences from `index` to corrupt.
    """

    tag: str
    kind: str = "nan"
    index: int = 0
    count: int = 1

    def __post_init__(self):
        if self.tag not in tracing.PHASE_REGISTRY:
            raise ValueError(
                f"fault tag {self.tag!r} not in tracing.PHASE_REGISTRY; "
                f"known tags: {sorted(tracing.PHASE_REGISTRY)}"
            )
        if self.kind not in _KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {_KINDS}")


class FaultPlan:
    """Active set of faults plus the deterministic firing record."""

    def __init__(self, faults):
        self.faults = tuple(faults)
        self.hits = collections.Counter()  # tag -> occurrences seen
        self.fired: list[tuple[str, int]] = []  # (tag, occurrence) applied

    def corrupt(self, x, tag: str):
        occ = self.hits[tag]
        self.hits[tag] += 1
        for f in self.faults:
            if f.tag == tag and f.index <= occ < f.index + f.count:
                self.fired.append((tag, occ))
                if f.kind == "raise":
                    raise FaultInjected(f"injected fault at {tag!r} occurrence {occ}")
                x = _corrupt_array(x, f.kind)
        return x


def _corrupt_array(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A corrupted copy of x (the input is never modified)."""
    if kind == "rank_deficient":
        if x.dim() < 2:
            return torch.zeros_like(x)
        y = x.clone()
        y[..., -1, :] = 0
        y[..., :, -1] = 0
        return y
    y = x.clone()
    y[(0,) * x.dim()] = float("nan") if kind == "nan" else float("inf")
    return y


_PLANS: list[FaultPlan] = []


@contextlib.contextmanager
def active_plan(*faults: Fault):
    """Activate a fault plan for the enclosed region; yields the plan so
    tests can assert on `plan.fired` afterwards."""
    plan = FaultPlan(faults)
    _PLANS.append(plan)
    try:
        yield plan
    finally:
        _PLANS.remove(plan)


def tap(x, point: str | None = None):
    """Fault-injection tap: identity when no plan is active.  The site key
    is `point` if given, else the innermost active tracing scope."""
    if not _PLANS:
        return x
    tag = point or tracing.current_scope() or "<top>"
    for plan in _PLANS:
        x = plan.corrupt(x, tag)
    return x
