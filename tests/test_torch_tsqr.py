"""The TSQR panel kernel of the port (capital_tpu_torch.ops.tsqr.panel_qr
and the routes of tsqr that reach it) against the JAX package's batched
Householder Pallas kernel (capital_tpu.ops.tsqr._qr_pallas, in interpret
mode) and its tsqr, on the CPU.

On the CPU `panel_qr` runs its plain version, the JAX kernel's
`_house_panel` arithmetic step by step, so Q and R carry the same signs as
the reference (torch.linalg.qr's would not).  Panels are made with numpy
from a seed, with a zero column (the identity reflector) and a zero panel
(tsqr's padding) among them.

Tolerances, relative to the largest |reference| entry: f32 1e-5 (the port
divides by sqrt where the reference multiplies by rsqrt, and sums in
another order); bf16 tsqr 2e-2 relative Frobenius (the operand is rounded
to bf16, and so are Q and R).  Gates on the port's own tsqr: ‖I − QᵀQ‖/√n
and ‖A − QR‖/‖A‖ below 5e-5 (`_tolerance` of bench/drivers.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import tsqr as jtsqr
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.ops import tsqr as ttsqr
from capital_tpu_torch.utils import residual as tres
from capital_tpu_torch.utils.interop import tensor_from_numpy


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, rel=1e-5):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _panels(seed, shape):
    P = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    P[0, :, 3] = 0.0
    P[1] = 0.0
    return P


@pytest.mark.parametrize("shape", [(3, 128, 64), (4, 40, 17)])
def test_panel_qr_matches_jax_kernel(shape):
    P = _panels(shape[1], shape)
    Qj, Rj = jtsqr._qr_pallas(jnp.asarray(P), block=0, precision="highest", interpret=True)
    Q, R = ttsqr.panel_qr(torch.from_numpy(P))
    _close(Q, Qj)
    _close(R, Rj)
    assert not torch.tril(R, -1).any() and not R[1].any()


@pytest.mark.parametrize("impl,dt", [("pallas", "f32"), ("auto", "f32"), ("auto", "bf16")])
def test_tsqr_kernel_route_matches_jax(impl, dt):
    A = np.random.default_rng(3).standard_normal((1000, 48)).astype(np.float32)
    if dt == "bf16":
        A = A.astype(jnp.bfloat16)
    Qj, Rj = jtsqr.tsqr(jnp.asarray(A), impl=impl, interpret=True)
    hopper.reset_counts()
    Q, R = ttsqr.tsqr(tensor_from_numpy(A), impl=impl)
    assert not any(hopper.counts().values())  # CPU tensors take the plain version
    if dt == "f32":
        _close(Q, Qj)
        _close(R, Rj)
        assert float(ttsqr.ortho_gate(Q)) < 5e-5
        assert float(tres.qr_residual(torch.from_numpy(A), Q, R)) < 5e-5
    else:
        for got, want in ((Q, Qj), (R, Rj)):
            assert np.linalg.norm(_f64(got) - _f64(want)) < 2e-2 * np.linalg.norm(_f64(want))


def test_default_impl_matches_jax():
    for rows, n in ((128, 64), (256, 128), (512, 256), (96, 48)):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                         (torch.float64, jnp.float64)):
            assert ttsqr.default_impl(rows, n, tdt, interpret=True) == jtsqr.default_impl(
                rows, n, jdt, interpret=True), (rows, n, tdt)


def test_card_envelope_edges():
    # one f32 tile of rows x odd_ld(n) and R's diagonal in 227 KB
    assert ttsqr.smem_bytes(256, 128) == 4 * (256 * 129 + 128)
    assert ttsqr.eligible(447, 128, torch.float32, interpret=False)
    assert not ttsqr.eligible(448, 128, torch.float32, interpret=False)
    assert ttsqr.default_impl(512, 128, torch.float32, interpret=False) == "xla"
    assert ttsqr.default_impl(256, 128, torch.float32, interpret=False) == "pallas"
    assert ttsqr.eligible(4096, 128, torch.float32, interpret=True)


def test_panel_qr_refuses():
    with pytest.raises(TypeError):
        ttsqr.panel_qr(torch.zeros((2, 8, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="p >= n"):
        ttsqr.panel_qr(torch.zeros((2, 4, 8)))
