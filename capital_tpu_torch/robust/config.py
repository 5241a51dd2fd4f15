"""Robustness configuration (counterpart of capital_tpu/robust/config.py).

cholinv uses only the presence of a RobustConfig: with one attached,
`models/cholesky.factor` returns a LAPACK-style `info` beside (R, Rinv).
The recovery knobs are carried for the CholeskyQR2 slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Breakdown detection + shifted-CholeskyQR recovery knobs (see the JAX
    package's RobustConfig for the shift formula)."""

    shift_c: float = 11.0
    ortho_tol: float | None = None
    recover: bool = True
    escalate: bool = True
    tsqr: bool = False
