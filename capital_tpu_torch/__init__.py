"""capital_tpu_torch: the PyTorch / CUDA port of capital_tpu for NVIDIA
Hopper (H100).

The JAX package `capital_tpu` stays beside it as the reference; this
package imports torch, numpy and the standard library only — never jax and
nothing of `capital_tpu`.  Sub-packages mirror the reference's names.
Entry points run on the CUDA card by default (`Grid.square()`); pass
`device="cpu"` for the plain PyTorch path on the host.

Ported so far: single-device cholinv (`models/cholesky.factor`, with the
fused tail), single-device CholeskyQR2 (`models/qr.factor`), triangular
inversion and TRSM (`models/inverse.rectri` / `newton`,
`models/trsm.solve`), TSQR (`ops/tsqr.tsqr`), the small-N batched
solves of serve's bucket programs (`serve/api.batched`), the
block-tridiagonal chain solvers (`models/blocktri`, `models/arrowhead`,
`models/banded`), the rank-k Cholesky update / downdate
(`ops/update_small`) and mixed-precision iterative refinement
(`robust/refine`, serve's 'fast' and 'guaranteed' tiers), and cholinv and
rectri on a d x d x c mesh of ranks that share one device (the explicit
SUMMA schedule, parallel/summa.py over parallel/mesh.py), with their
hand-written kernels (ops/hopper.py, ops/qr_fused.py, ops/batched_small.py,
ops/tsqr.py, ops/blocktri_small.py, ops/update_small.py, ops/csrc/).
`KERNELS` holds every kernel's launch counter.
"""

from capital_tpu_torch.models import arrowhead, banded, blocktri, cholesky, inverse, qr, trsm
from capital_tpu_torch.ops.hopper import KERNELS
from capital_tpu_torch.parallel.topology import Grid

__all__ = ["Grid", "KERNELS", "arrowhead", "banded", "blocktri", "cholesky", "inverse", "qr",
           "trsm"]
