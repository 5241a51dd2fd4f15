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


def _compact_wy_qr(a, nb):
    """The panel kernel's algebra (ops/csrc/tsqr.cu) in f32 NumPy: columns in
    blocks of nb; inside a block ONE reduction a column gives x·x, x·w_c for
    the later columns and x·v_c for the earlier ones, from which
    ‖x − α·e_j‖² = 2σ(σ + |x_j|), vᵀw_c and v_cᵀv_j follow; T by larft
    (forward, τ = 2); the trailing columns by Y = VᵀW, W −= V·(Tᵀ·Y); thin Q
    by Q[j0:, j0:] −= V·(T·(Vᵀ·Q[j0:, j0:])), blocks descending."""
    f = np.float32
    p, n = a.shape
    W = a.astype(f).copy()
    rd = np.zeros(n, f)
    Vs, Ts = [], []
    for j0 in range(0, n, nb):
        w = min(nb, n - j0)
        Z = np.zeros((nb, nb), f)
        for jj in range(w):
            j = j0 + jj
            x = W[j:, j].copy()
            blk = W[j:, j0:j0 + w]
            d = x @ blk  # the column's one reduction
            s, xj = d[jj], x[0]
            sig = np.sqrt(s)
            alpha = -sig if xj >= 0 else sig
            un2 = f(2) * sig * (sig + abs(xj))
            inv = f(1) / np.sqrt(un2) if un2 > 0 else f(0)
            t = (d - alpha * blk[0]) * inv
            v = x * inv
            v[0] = (xj - alpha) * inv
            rd[j] = xj - f(2) * v[0] * t[jj]
            Z[:jj, jj] = t[:jj]
            W[j:, j + 1:j0 + w] -= f(2) * np.outer(v, t[jj + 1:w])
            W[j:, j] = v
        T = np.zeros((nb, nb), f)
        for i in range(w):
            T[i, i] = 2
            T[:i, i] = -f(2) * (T[:i, :i] @ Z[:i, i])
        V = np.zeros((p, nb), f)
        for c in range(w):
            V[j0 + c:, c] = W[j0 + c:, j0 + c]
        Vs.append(V)
        Ts.append(T)
        if j0 + w < n:
            Y = V[j0:].T @ W[j0:, j0 + w:]
            W[j0:, j0 + w:] -= V[j0:] @ (T.T @ Y)
    R = np.triu(W[:n])
    R[np.arange(n), np.arange(n)] = rd
    Q = np.eye(p, n, dtype=f)
    for b in range(len(Vs) - 1, -1, -1):
        j0, V, T = b * nb, Vs[b], Ts[b]
        Q[j0:, j0:] -= V[j0:] @ (T @ (V[j0:].T @ Q[j0:, j0:]))
    return Q, R


@pytest.mark.parametrize("shape", [(3, 40, 17), (2, 64, 64)])
def test_compact_wy_algebra_matches_jax_kernel(shape):
    """The blocked compact-WY algebra of the card's panel kernel (nb = 16,
    as built) against the JAX kernel in interpret mode, with a zero column
    on a block boundary (columns 15 and 16), a zero column inside a block
    and a zero panel: f32 1e-5 of the largest |reference| entry (sums in
    another order)."""
    P = _panels(shape[1] + 1, shape)
    P[2 % shape[0], :, 15] = 0.0
    P[2 % shape[0], :, 16] = 0.0
    Qj, Rj = jtsqr._qr_pallas(jnp.asarray(P), block=0, precision="highest", interpret=True)
    got = [_compact_wy_qr(P[i], ttsqr.PANEL_NB) for i in range(shape[0])]
    _close(np.stack([q for q, _ in got]), Qj)
    _close(np.stack([r for _, r in got]), Rj)
    assert not np.any(got[1][1])


def test_card_envelope_edges():
    # the f32 tile (16-byte rows, ld 132), the block's V and V·T transposed,
    # eight blocks' T, the VᵀW workspace, the reduction buffers and R's
    # diagonal in 227 KB; the panel factor keeps at most 512 rows in registers
    assert ttsqr.smem_bytes(256, 128) == 4 * (256 * 132 + 2 * 16 * 256 + 8 * 256 + 16 * 512 + 256 + 32 + 256 + 128)
    assert ttsqr.eligible(280, 128, torch.float32, interpret=False)
    assert not ttsqr.eligible(281, 128, torch.float32, interpret=False)
    assert ttsqr.eligible(512, 8, torch.float32, interpret=False)
    assert not ttsqr.eligible(513, 8, torch.float32, interpret=False)
    assert ttsqr.default_impl(512, 128, torch.float32, interpret=False) == "xla"
    assert ttsqr.default_impl(256, 128, torch.float32, interpret=False) == "pallas"
    assert ttsqr.eligible(4096, 128, torch.float32, interpret=True)
    for n in range(1, ttsqr.SMALL_N_MAX + 1):  # every panel tsqr cuts
        for rows in (ttsqr.resolve_panel(1 << 20, n), 2 * n):
            assert ttsqr.default_impl(rows, n, torch.float32, interpret=False) == "pallas", (rows, n)


def test_panel_qr_refuses():
    with pytest.raises(TypeError):
        ttsqr.panel_qr(torch.zeros((2, 8, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="p >= n"):
        ttsqr.panel_qr(torch.zeros((2, 4, 8)))
