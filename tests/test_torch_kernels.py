"""The port's kernels (capital_tpu_torch/ops/hopper.py) against the JAX
package's Pallas kernels (capital_tpu/ops/pallas_tpu.py).

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernels run in interpret mode, so this holds the plain versions to
the reference; tests/test_torch_gpu.py holds the CUDA kernels to the plain
versions on the card.  Inputs are made with numpy from a seed and handed to
both packages.  Window sizes and offsets are 128-aligned: that is the
Pallas kernels' view path (off it they materialize, with different bf16
rounding of the fused beta term).

Tolerances, relative to the largest |reference| entry: f64 1e-12 and f32
1e-5 (the two sides sum in different orders); bf16 one bf16 ulp of each
entry (both accumulate in f32, then round once — a sum that differs in its
last f32 bits may round to the neighbouring bf16) plus 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import pallas_tpu
from capital_tpu_torch.ops import hopper
from capital_tpu_torch.utils.interop import tensor_from_numpy

DTYPES = {
    "f64": (np.float64, torch.float64),
    "f32": (np.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
}
P = 512  # buffer edge


def _mk(seed, shape, dt):
    return np.random.default_rng(seed).standard_normal(shape).astype(DTYPES[dt][0])


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _assert_close(got, want, dt, mask=None):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(np.abs(want).max(), 1e-30)
    if dt == "bf16":
        tol = 2.0**-7 * np.abs(want) + 1e-5 * scale
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    else:
        rel = {"f64": 1e-12, "f32": 1e-5}[dt]
        assert np.abs(got - want).max() <= rel * scale


def _prec(dt):
    return "highest" if dt == "f32" else None


# kwargs; "out" names the buffer written in place: "B" (B's own buffer) or
# "fresh" (a third buffer); absent, the result is a new tensor
TRMM_CASES = {
    "L_U": dict(a_uplo="U"),
    "L_U_trans_views": dict(a_uplo="U", a_trans=True, a_view=(128, 128, 256, 256),
                            b_view=(0, 128, 256, 384)),
    "L_L_alpha": dict(a_uplo="L", alpha=-1.5, a_view=(256, 0, 256, 256),
                      b_view=(128, 0, 256, 128)),
    "L_L_trans": dict(a_uplo="L", a_trans=True, a_view=(0, 0, 384, 384),
                      b_view=(128, 128, 384, 256)),
    "R_U": dict(b_uplo="U", alpha=-1.0, a_view=(0, 0, 128, 256),
                b_view=(256, 256, 256, 256)),
    "R_L_trans": dict(b_uplo="L", b_trans=True, a_view=(128, 0, 256, 384),
                      b_view=(0, 128, 384, 384)),
    # in-place into the triangular operand's own buffer, disjoint window:
    # the cholinv inverse-completion shape (side R, out = the B buffer)
    "R_U_inplace": dict(b_uplo="U", alpha=-1.0, a_view=(0, 0, 256, 256),
                        b_view=(256, 256, 256, 256), out="B", out_off=(0, 256)),
    # TRSM shape: transposed upper triangle, out = a third buffer
    "L_U_trans_out": dict(a_uplo="U", a_trans=True, a_view=(0, 0, 256, 256),
                          b_view=(0, 256, 256, 256), out="fresh", out_off=(0, 256)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(TRMM_CASES))
def test_trmm_form(case, dt):
    kw = dict(TRMM_CASES[case])
    where = kw.pop("out", None)
    a, b = _mk(1, (P, P), dt), _mk(2, (P, P), dt)
    if "a_view" not in kw and "b_view" not in kw and where is None:
        a, b = a[:256, :256], b[:256, :384]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = tensor_from_numpy(a), tensor_from_numpy(b)
    jout = tout = None
    if where == "B":
        jout, tout = jb, tb
    elif where == "fresh":
        o = _mk(3, (P, P), dt)
        jout, tout = jnp.asarray(o), tensor_from_numpy(o)
    want = pallas_tpu.tri_matmul(ja, jb, out=jout, precision=_prec(dt), **kw)
    got = hopper.tri_matmul(ta, tb, out=tout, precision=_prec(dt), **kw)
    if tout is not None:
        assert got is tout  # written in place
    _assert_close(got, want, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("uplo", ["U", "L"])
def test_syrk_beta0_dead_half_zero(uplo, dt):
    a = _mk(4, (P, P), dt)
    kw = dict(a_trans=True, b_trans=False, out_uplo=uplo, alpha=-1.0,
              a_view=(0, 128, 256, 384), b_view=(0, 128, 256, 384))
    want = pallas_tpu.tri_matmul(jnp.asarray(a), jnp.asarray(a), precision=_prec(dt), **kw)
    ta = tensor_from_numpy(a)
    got = hopper.tri_matmul(ta, ta, precision=_prec(dt), **kw)
    _assert_close(got, want, dt)
    dead = np.tril(np.ones((384, 384), bool), -1) if uplo == "U" else np.triu(
        np.ones((384, 384), bool), 1)
    assert np.all(_f64(got)[dead] == 0.0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_syrk_fused_beta(dt):
    """Fused beta·C: only the valid triangle is defined."""
    a, c = _mk(5, (P, P), dt), _mk(6, (P, P), dt)
    kw = dict(a_trans=True, b_trans=False, out_uplo="U", alpha=-1.0, beta=1.0,
              a_view=(0, 128, 128, 384), b_view=(0, 128, 128, 384),
              c_view=(128, 128, 384, 384))
    want = pallas_tpu.tri_matmul(jnp.asarray(a), jnp.asarray(a), c=jnp.asarray(c),
                                 precision=_prec(dt), **kw)
    ta = tensor_from_numpy(a)
    got = hopper.tri_matmul(ta, ta, c=tensor_from_numpy(c), precision=_prec(dt), **kw)
    _assert_close(got, want, dt, mask=np.triu(np.ones((384, 384), bool)))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_syrk_in_place_rmw(dt):
    """schur_in_place shape: out IS c, rewritten in its own window; the rest
    of the buffer is untouched."""
    a, c = _mk(7, (P, P), dt), _mk(8, (P, P), dt)
    cv = (128, 128, 384, 384)
    kw = dict(a_trans=True, b_trans=False, out_uplo="U", alpha=-1.0, beta=1.0,
              a_view=(0, 128, 128, 384), b_view=(0, 128, 128, 384), c_view=cv,
              out_off=(128, 128))
    jc = jnp.asarray(c)
    want = pallas_tpu.tri_matmul(jnp.asarray(a), jnp.asarray(a), c=jc, out=jc,
                                 precision=_prec(dt), **kw)
    ta, tc = tensor_from_numpy(a), tensor_from_numpy(c)
    got = hopper.tri_matmul(ta, ta, c=tc, out=tc, precision=_prec(dt), **kw)
    assert got is tc
    mask = np.zeros((P, P), bool)
    mask[128:, 128:] = np.triu(np.ones((384, 384), bool))
    _assert_close(got, want, dt, mask=mask)
    outside = np.ones((P, P), bool)
    outside[128:, 128:] = False
    assert np.array_equal(_f64(got)[outside], _f64(c)[outside])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dense_form(dt):
    a, b = _mk(9, (P, P), dt), _mk(10, (P, P), dt)
    kw = dict(b_trans=True, alpha=2.0, a_view=(128, 0, 256, 384), b_view=(0, 128, 128, 384))
    want = pallas_tpu.tri_matmul(jnp.asarray(a), jnp.asarray(b), precision=_prec(dt), **kw)
    got = hopper.tri_matmul(tensor_from_numpy(a), tensor_from_numpy(b),
                            precision=_prec(dt), **kw)
    _assert_close(got, want, dt)


def test_tri_matmul_rejects_overlapping_in_place():
    t = torch.zeros((P, P))
    with pytest.raises(ValueError, match="overlaps"):
        hopper.tri_matmul(t, t, b_uplo="U", a_view=(0, 0, 256, 256),
                          b_view=(256, 256, 256, 256), out=t, out_off=(128, 256))


TRANSPOSE_CASES = {
    "plain": dict(),
    "view_mask_L_cast": dict(in_view=(128, 128, 256, 256), out_uplo="L", cast=True),
    "view_mask_U": dict(in_view=(0, 128, 384, 256), out_uplo="U"),
    "in_place_same_buffer": dict(in_view=(256, 0, 256, 256), out_uplo="U",
                                 out="X", out_off=(0, 256)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(TRANSPOSE_CASES))
def test_transpose(case, dt):
    kw = dict(TRANSPOSE_CASES[case])
    where = kw.pop("out", None)
    cast = kw.pop("cast", False)
    x = _mk(11, (P, P), dt)
    if not kw:
        x = x[:384, :256]
    jx, tx = jnp.asarray(x), tensor_from_numpy(x)
    jkw, tkw = (dict(out_dtype=jnp.float32), dict(out_dtype=torch.float32)) if cast else ({}, {})
    if where == "X":
        want = pallas_tpu.transpose(jx, out=jx, **kw)
        got = hopper.transpose(tx, out=tx, **kw)
        assert got is tx
    else:
        want = pallas_tpu.transpose(jx, **kw, **jkw)
        got = hopper.transpose(tx, **kw, **tkw)
    assert np.array_equal(_f64(got), _f64(want))  # a transpose is exact


@pytest.mark.parametrize("dt", list(DTYPES))
def test_transpose_pair_bitwise_two_transposes(dt):
    n, dest = 128, 256
    L = _mk(12, (n, n), "f32")
    Li = _mk(13, (n, n), "f32")
    rp, rip = _mk(14, (P, P), dt), _mk(15, (P, P), dt)
    tL, tLi = tensor_from_numpy(L), tensor_from_numpy(Li)
    Rp, RIp = tensor_from_numpy(rp), tensor_from_numpy(rip)
    got = hopper.transpose_pair(tL, tLi, Rp, RIp, dest=dest)
    assert got[0] is Rp and got[1] is RIp
    R1 = hopper.transpose(tL, out_uplo="U", out=tensor_from_numpy(rp), out_off=(dest, dest))
    R2 = hopper.transpose(tLi, out_uplo="U", out=tensor_from_numpy(rip), out_off=(dest, dest))
    assert torch.equal(got[0], R1) and torch.equal(got[1], R2)
    jR, jRI = pallas_tpu.transpose_pair(jnp.asarray(L), jnp.asarray(Li), jnp.asarray(rp),
                                        jnp.asarray(rip), dest=dest)
    assert np.array_equal(_f64(got[0]), _f64(jR))
    assert np.array_equal(_f64(got[1]), _f64(jRI))


def _x(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


#: every guard of the transpose wrappers, by the exception and message it
#: raises; `card` ones sit on the kernel side (dtype, layout) and are reached
#: by pretending the operands lie on the card
TRANSPOSE_GUARDS = {
    "out_uplo": (False, ValueError, "out_uplo", lambda: hopper.transpose(_x(8, 8), out_uplo="X")),
    "3-D input": (False, ValueError, "2-D", lambda: hopper.transpose(_x(2, 8, 8))),
    "in_view outside": (False, ValueError, "outside", lambda: hopper.transpose(_x(8, 8), in_view=(4, 0, 5, 8))),
    "out window outside": (False, ValueError, "outside",
                           lambda: hopper.transpose(_x(8, 4), out=_x(8, 8), out_off=(6, 0))),
    "in-place overlap": (False, ValueError, "overlaps",
                         lambda: (lambda X: hopper.transpose(X, in_view=(0, 0, 4, 4), out=X, out_off=(2, 2)))(
                             _x(8, 8))),
    "mixed devices": (False, ValueError, "one CUDA device or all on the CPU",
                      lambda: hopper.transpose(_x(8, 8), out=torch.zeros((8, 8), device="meta"))),
    "column-major input": (True, ValueError, "row-major", lambda: hopper.transpose(_x(8, 6).T)),
    "f16 input": (True, TypeError, "bf16, f32 or f64", lambda: hopper.transpose(_x(8, 8, dtype=torch.float16))),
    "f16 result": (True, TypeError, "bf16, f32 or f64",
                   lambda: hopper.transpose(_x(8, 8), out_dtype=torch.float16)),
    "column-major out": (True, ValueError, "row-major", lambda: hopper.transpose(_x(8, 8), out=_x(8, 8).T)),
    "pair not square": (False, ValueError, "square panels",
                        lambda: hopper.transpose_pair(_x(8, 4), _x(8, 4), _x(16, 16), _x(16, 16), dest=0)),
    "pair buffers differ": (False, ValueError, "square panels",
                            lambda: hopper.transpose_pair(_x(8, 8), _x(8, 8), _x(16, 16), _x(16, 8), dest=0)),
    "pair window outside": (False, ValueError, "outside",
                            lambda: hopper.transpose_pair(_x(8, 8), _x(8, 8), _x(16, 16), _x(16, 16), dest=12)),
    "pair outputs overlap": (False, ValueError, "Rp and RIp windows overlap",
                             lambda: (lambda R: hopper.transpose_pair(_x(8, 8), _x(8, 8), R, R, dest=8))(
                                 _x(16, 16))),
    "pair output overlaps input": (False, ValueError, "overlaps an input",
                                   lambda: (lambda R: hopper.transpose_pair(R[4:12, 4:12], _x(8, 8), R,
                                                                            _x(16, 16), dest=8))(_x(16, 16))),
    "pair inputs' dtypes": (True, TypeError, "one dtype and layout",
                            lambda: hopper.transpose_pair(_x(8, 8), _x(8, 8, dtype=torch.float64), _x(16, 16),
                                                          _x(16, 16), dest=8)),
    "pair outputs' layouts": (True, TypeError, "one dtype and layout",
                              lambda: hopper.transpose_pair(_x(8, 8), _x(8, 8), _x(16, 16), _x(16, 32)[:, :16],
                                                            dest=8)),
    "pair column-major input": (True, ValueError, "row-major",
                                lambda: hopper.transpose_pair(_x(8, 8).T, _x(8, 8), _x(16, 16), _x(16, 16),
                                                              dest=8)),
}


@pytest.mark.parametrize("case", list(TRANSPOSE_GUARDS))
def test_transpose_guards_raise(monkeypatch, case):
    """Every guard raises on CPU operands after the launch-path trim; the
    kernel-side ones before any launch (a missing one would reach the build
    and fail there instead)."""
    card, exc, match, call = TRANSPOSE_GUARDS[case]
    if card:
        monkeypatch.setattr(hopper, "_on_card", lambda *t: True)
    with pytest.raises(exc, match=match):
        call()


def test_on_card_decides_by_every_operand():
    cpu = torch.zeros(2, 2)
    assert not hopper._on_card(cpu, None, cpu)
    with pytest.raises(ValueError, match="one CUDA device"):
        hopper._on_card(cpu, torch.zeros((2, 2), device="meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        hopper._on_card(None, None)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dead", ["lower", "upper"])
def test_zeros_dead_lower(dead, dt):
    """Dead tiles and extra windows are exactly zero; every other tile of
    the plain version is NaN (the kernel leaves them unwritten)."""
    p, tile = 512, 128
    extra = ((0, 256, 256, 256),)
    got = hopper.zeros_dead_lower(p, DTYPES[dt][1], tile, extra=extra, dead=dead, device="cpu")
    want = pallas_tpu.zeros_dead_lower(p, DTYPES[dt][0], tile, extra=extra, dead=dead)
    t = np.arange(p) // tile
    zero = (t[:, None] > t[None, :]) if dead == "lower" else (t[:, None] < t[None, :])
    zero[0:256, 256:512] = True
    g = _f64(got)
    assert np.all(g[zero] == 0.0)
    assert np.all(np.isnan(g[~zero]))
    assert np.all(_f64(want)[zero] == 0.0)
