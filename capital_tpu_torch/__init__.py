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
(`robust/refine`, serve's 'fast' and 'guaranteed' tiers), the serve tier
(`serve/`: the engine, residency and sessions, telemetry, loadgen, replicas,
the router, the CLI), and cholinv and
rectri on a d x d x c mesh of ranks that share one device (the explicit
SUMMA schedule, parallel/summa.py over parallel/mesh.py), with their
hand-written kernels (ops/hopper.py, ops/qr_fused.py, ops/batched_small.py,
ops/tsqr.py, ops/blocktri_small.py, ops/update_small.py, ops/csrc/).
`KERNELS` holds every kernel's launch counter.

Exports resolve lazily (PEP 562): `Grid`, `KERNELS` and the models import
torch on first touch, while the serve front end's host-only modules
(`serve.router`, `serve.replica`, `serve.loadgen`, `serve.telemetry`)
import this package without loading torch — a router pump or a loadgen
client process never pays a device runtime's import.
"""

#: attribute -> defining module (the models export themselves)
_EXPORTS = {
    "Grid": "capital_tpu_torch.parallel.topology",
    "KERNELS": "capital_tpu_torch.ops.hopper",
    **{m: f"capital_tpu_torch.models.{m}"
       for m in ("arrowhead", "banded", "blocktri", "cholesky", "inverse", "qr", "trsm")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    mod = importlib.import_module(module)
    value = mod if module.endswith("." + name) else getattr(mod, name)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
