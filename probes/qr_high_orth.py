"""CholeskyQR2 in f32 at 'high' and 'highest': where the drivers'
orthogonality gate (‖I − QᵀQ‖_F / ‖I‖_F at Q's dtype, 5e-5 for f32) reads
the gate's own f32 sum over m rows rather than Q.

    python3 probes/qr_high_orth.py

On a machine with one H100, from the root of a checkout: CQR2 (regime '1d',
mode 'pallas') of one seeded A at 2,097,152 x 1024 (the QR flagship's
shape), 65536 x 512 and 524,288 x 1024, at 'high' through the kernels (the
x3 route), at 'high' through the plain versions, and at 'highest'; for
each, the orthogonality in the gate's f32 form and the same measure with Q
widened to f64, and the row-blocked residual.  One JSON line a run.
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from capital_tpu_torch import Grid  # noqa: E402
from capital_tpu_torch.models import cholesky, qr  # noqa: E402
from capital_tpu_torch.ops import _build, hopper, qr_fused  # noqa: E402
from capital_tpu_torch.utils import residual  # noqa: E402

SHAPES = ((2_097_152, 1024), (65536, 512), (524288, 1024))
RUNS = (("high", "high", False), ("highest", "highest", False), ("high plain", "high", True))


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    grid = Grid.square()
    for m, n in SHAPES:
        A = cs.tall_randn(m, n, torch.float32, 1, dev)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        for label, prec, plain in RUNS:
            cfg = qr.CacqrConfig(regime="1d", mode="pallas", precision=prec,
                                 cholinv=cholesky.CholinvConfig(base_case_dim=128, mode="pallas"))
            if plain:
                with cs.plain_qr_versions(hopper, qr_fused):
                    Q, R = qr.factor(grid, A, cfg)
            else:
                Q, R = qr.factor(grid, A, cfg)
            Qd = Q.double()
            rec = {"m": m, "n": n, "run": label,
                   "orthogonality_f32": float(residual.qr_orthogonality(Q)),
                   "orthogonality_f64": float(residual.rel_fro(eye - Qd.T @ Qd, eye)),
                   "residual": float(residual.qr_residual_blocked(A, Q, R))}
            print(json.dumps(rec), flush=True)
            del Q, R, Qd
            torch.cuda.empty_cache()
        del A
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
