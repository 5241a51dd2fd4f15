"""Robustness configuration and status records (counterpart of
capital_tpu/robust/config.py).

cholinv uses only the presence of a RobustConfig: with one attached,
`models/cholesky.factor` returns a LAPACK-style `info` beside (R, Rinv).
CholeskyQR2 (`models/qr.factor`) uses every knob and returns a RobustInfo.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Breakdown detection + shifted-CholeskyQR recovery knobs.

    shift_c: c in the sCQR shift sigma = c·u·(m·n + n(n+1))·tr(G).
    ortho_tol: escalation gate on ‖I − QᵀQ‖_F/√n; None derives 100·n·u at
        the factor's compute dtype.
    recover: False = detect only (status reported, no shifted re-factor).
    escalate: False = never run the third (sCQR3) sweep.
    tsqr: run the Householder TSQR (ops/tsqr.py, at f64) as the last rung
        when the sCQR3 gate still fails.
    """

    shift_c: float = 11.0
    ortho_tol: float | None = None
    recover: bool = True
    escalate: bool = True
    tsqr: bool = False


class RobustInfo(NamedTuple):
    """Aggregated robust status of one qr.factor call: 0-d tensors on the
    grid's device, int32 except sigma and ortho (float32)."""

    info: object  # max residual factor_info after recovery (0 = ok)
    breakdown: object  # chol sites whose unshifted factor broke
    shifted: object  # sites re-factored with the gram shift
    sigma: object  # largest shift applied (0.0 on the healthy path)
    escalated: object  # 1 = sCQR3 third sweep ran; 2 = TSQR rung ran
    ortho: object  # escalation gate value; -1.0 when not computed
    gate: object = 0  # which gate a nonzero info came from (GATE_* below)


#: RobustInfo.gate vocabulary.
GATE_NONE = 0
GATE_ORTHO = 1  # orthogonality gate failed (escalate via TSQR)
GATE_RESIDUAL = 2  # residual factor status nonzero (operand is bad)


class CholEvent(NamedTuple):
    """Per-site record from robust/recovery.guarded_chol."""

    info: object  # int32 status of the unshifted factor
    sigma: object  # shift actually applied (0 when the factor was healthy)
    info_after: object  # int32 status of the returned (possibly shifted) factor
