"""The cholinv and rectri paths' kernels on Hopper, single-device and on
the mesh (counterpart of
capital_tpu/ops/pallas_tpu.py), and the one launch-counter registry of every
kernel of the port (`KERNELS`; the CholeskyQR2 kernels' wrappers live in
ops/qr_fused.py, the small-N batched solves' in ops/batched_small.py, the
TSQR panel kernel's in ops/tsqr.py, the block-tridiagonal scan steps' in
ops/blocktri_small.py, the rank-k update sweep's in ops/update_small.py).

Each kernel sits here as three things side by side:

* the **wrapper** (`tri_matmul`, `transpose`, `transpose_pair`,
  `zeros_dead_lower`, `write_diag_blocks`, `fused_tail`, `sched_matmul`):
  it validates its
  arguments, then launches the
  hand-written CUDA kernel (ops/csrc/*.cu) when its tensors lie on a CUDA
  device, or runs the plain version when they lie on the CPU.  There is no
  other route: a CUDA tensor launches the kernel or raises.
* the **plain version** (`*_plain`): the same function in plain PyTorch, used
  for CPU tensors and, on the card, as the reference a kernel is held to.
* the **launch counter** (`KERNELS`): each wrapper adds one where it
  launches its kernel, and nowhere else.  `tri_matmul` and `sched_matmul`
  also tally each launch by route (`route_counts`).  Windows whose A and B
  origins and leading dimensions are 16-byte aligned (`_tma_ok`; sched
  also needs blocks that the route's tile divides) take the dtype's fast
  route: 'wgmma' for bf16 (TMA + wgmma), 'dmma' for f64 (mma.sync on the
  FP64 tensor cores), 'fma' for f32 (pipelined IEEE FMA); the others take
  the element-load loop, 'wmma' for bf16 and 'simt' for f32 / f64, and
  sched blocks that only a 64-row tile divides (the persistent layout's
  t = 192) take 'simt' in every dtype (`sched_route`).  f32 products at
  precision 'high' compute the JAX package's bf16x3 split (`split_high`)
  on two routes of their own: 'x3' (aligned windows: a split pass writes
  the operands' bf16 hi / lo images, the wgmma ring multiplies them) and
  'simt3' (the element-load loop splitting as it stages, any window).  No
  wrapper takes a route from its caller.  The
  CholeskyQR2 kernels tally their dtype's fast route ('wgmma' bf16, 'fma'
  f32, 'dmma' f64, 'x3' f32 at 'high'; their operands are always
  TMA-aligned); `fused_tail` tallies 'block' (one
  block holds the window) or 'cluster' (a thread-block cluster does);
  `write_diag_blocks` 'vec' (16-byte vectors, `write_diag_route`) or
  'elem'.  The route is chosen before the launch and never changes after a
  failure.

Unlike the JAX package, where "consumed" buffers are a promise to XLA,
writes here are real mutation: `out` windows are written in place and the
wrapper returns the same tensor.  An in-place window that overlaps a window
the same call reads raises.

Windows are `(r0, c0, rows, cols)` tuples on 2-D row-major buffers; kernels
address them through a base pointer, a leading dimension and the window
origin, so any offset works without materializing a slice.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from capital_tpu_torch.ops import _build, sweeps
from capital_tpu_torch.ops.masking import take_triangle

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_UPLO = {None: 0, "U": 1, "L": 2}
_CSRC = "capital_tpu_torch/ops/csrc/"
_PALLAS = "capital_tpu/ops/pallas_tpu.py:"
_QR_FUSED = "capital_tpu/ops/qr_fused.py:"
#: the batched-grid kernels share one pallas_call (_batched_call); each
#: entry names it and the kernel's own def line
_SMALL = "capital_tpu/ops/batched_small.py:358 (def :"
#: the blocktri scan steps reach that pallas_call from their own module
_BT = "capital_tpu/ops/batched_small.py:358 (def capital_tpu/ops/blocktri_small.py:"
#: most `extra` windows one zeros_dead_lower launch takes (csrc MAX_EXTRA)
MAX_EXTRA = 8
#: shared memory one block may use on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
#: kept back from it for the kernels' static shared memory
SMEM_RESERVE = 1024


@dataclasses.dataclass
class Kernel:
    """One kernel's identity and its launch count."""

    name: str
    source: str  # CUDA source, relative to the repo root
    replaces: str  # the Pallas kernel's pallas_call, file:line
    route: str = "cuda"
    launches: int = 0
    #: launches by kernel route inside the CUDA source (tri_matmul, sched_matmul, qr.*)
    by_route: dict[str, int] = dataclasses.field(default_factory=dict)


#: every kernel of this module, by name
KERNELS: dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("tri_matmul.trmm", _CSRC + "tri_matmul.cu", _PALLAS + "1306"),
        Kernel("tri_matmul.syrk", _CSRC + "tri_matmul.cu", _PALLAS + "1199"),
        Kernel("tri_matmul.dense", _CSRC + "tri_matmul.cu", _PALLAS + "1104"),
        Kernel("transpose", _CSRC + "transpose.cu", _PALLAS + "661"),
        Kernel("transpose_pair", _CSRC + "transpose.cu", _PALLAS + "723"),
        Kernel("zeros_dead_lower", _CSRC + "zeros_dead.cu", _PALLAS + "409"),
        # the rectri batched prefix's write-back and the opt-in cholinv tail
        Kernel("write_diag_blocks", _CSRC + "write_diag.cu", _PALLAS + "560"),
        Kernel("fused_tail", _CSRC + "fused_tail.cu", _PALLAS + "827"),
        # CholeskyQR2's tall passes; wrappers in ops/qr_fused.py
        Kernel("qr.gram_blocked", _CSRC + "qr_fused.cu", _QR_FUSED + "181"),
        Kernel("qr.scale_gram", _CSRC + "qr_fused.cu", _QR_FUSED + "260"),
        Kernel("qr.scale_blocked", _CSRC + "qr_fused.cu", _QR_FUSED + "328"),
        # small-N batched solves; wrappers in ops/batched_small.py
        Kernel("small.potrf", _CSRC + "batched_small.cu", _SMALL + "398)"),
        Kernel("small.potrs", _CSRC + "batched_small.cu", _SMALL + "470)"),
        Kernel("small.posv", _CSRC + "batched_small.cu", _SMALL + "506)"),
        Kernel("small.lstsq", _CSRC + "batched_small.cu", _SMALL + "546)"),
        Kernel("small.trsm", _CSRC + "batched_small.cu", _SMALL + "431)"),
        # TSQR's Householder panel QR; wrapper in ops/tsqr.py
        Kernel("tsqr.panel_qr", _CSRC + "tsqr.cu",
               "capital_tpu/ops/batched_small.py:358 (def capital_tpu/ops/tsqr.py:200)"),
        # block-tridiagonal scan steps; wrappers in ops/blocktri_small.py
        Kernel("bt.fused_forward", _CSRC + "blocktri_small.cu", _BT + "171)"),
        Kernel("bt.factor", _CSRC + "blocktri_small.cu", _BT + "229)"),
        Kernel("bt.forward_solve", _CSRC + "blocktri_small.cu", _BT + "266)"),
        Kernel("bt.solve_backward", _CSRC + "blocktri_small.cu", _BT + "304)"),
        # the rank-k update / downdate rotation sweep; wrapper in ops/update_small.py
        Kernel("up.sweep", _CSRC + "update_small.cu",
               "capital_tpu/ops/batched_small.py:358 (def capital_tpu/ops/update_small.py:158)"),
        # the per-rank tile-skipping product of the explicit mesh schedule
        Kernel("sched_matmul", _CSRC + "sched_matmul.cu", _PALLAS + "505"),
    )
}


def reset_counts() -> None:
    """Set every launch counter (and route tally) to 0."""
    for k in KERNELS.values():
        k.launches = 0
        k.by_route.clear()


def counts() -> dict[str, int]:
    """Launch count of every kernel, by name."""
    return {name: k.launches for name, k in KERNELS.items()}


def route_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel that has routes, by route ('wgmma', 'wmma',
    'simt', ...; fused_tail 'block' / 'cluster'; the chain's factor steps
    'blocked' / 'sweep'; write_diag_blocks 'vec' / 'elem'); kernels not
    launched since the last reset are left out."""
    return {name: dict(k.by_route) for name, k in KERNELS.items() if k.by_route}


# --------------------------------------------------------------------------
# shared argument handling
# --------------------------------------------------------------------------


def _on_card(*tensors) -> bool:
    """True when every given tensor is on a CUDA device, False when every
    one is on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on one CUDA device or all on the CPU, got {kinds}")


def _full_view(X: torch.Tensor, view):
    return tuple(view) if view is not None else (0, 0, *X.shape)


def _check_window(X: torch.Tensor, view, what: str) -> None:
    if X.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got shape {tuple(X.shape)}")
    r0, c0, rows, cols = view
    if min(r0, c0, rows, cols) < 0 or r0 + rows > X.shape[0] or c0 + cols > X.shape[1]:
        raise ValueError(f"{what} window {view} outside its buffer {tuple(X.shape)}")


def _window(X: torch.Tensor, view) -> torch.Tensor:
    r0, c0, rows, cols = view
    return X[r0:r0 + rows, c0:c0 + cols]


def _overlaps(X: torch.Tensor, xv, Y: torch.Tensor, yv) -> bool:
    """Do window xv of X and window yv of Y share any element?"""
    if X.untyped_storage().data_ptr() != Y.untyped_storage().data_ptr():
        return False
    if X.stride() != Y.stride() or X.stride(1) != 1:
        raise ValueError("operands share storage with different layouts")
    ld = X.stride(0)
    xr, xc = divmod(X.storage_offset(), ld)
    yr, yc = divmod(Y.storage_offset(), ld)
    ar, ac, ah, aw = xr + xv[0], xc + xv[1], xv[2], xv[3]
    br, bc, bh, bw = yr + yv[0], yc + yv[1], yv[2], yv[3]
    if min(ah, aw, bh, bw) == 0:
        return False
    return ar < br + bh and br < ar + ah and ac < bc + bw and bc < ac + aw


def _kernel_operand(X: torch.Tensor, what: str) -> None:
    if X.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernels take bf16, f32 or f64, got {X.dtype}")
    if X.dim() != 2 or X.stride(1) != 1:
        raise ValueError(
            f"{what}: the kernels take row-major 2-D buffers (stride(1) == 1), "
            f"got strides {X.stride()}"
        )


def _ptr(X: torch.Tensor, r0: int, c0: int) -> int:
    return X.data_ptr() + (r0 * X.stride(0) + c0) * X.element_size()


def _stream() -> int:
    """The raw handle of PyTorch's current stream on the current device
    (every kernel launches on it).  `torch.accelerator` hands back the C++
    stream object directly, where `torch.cuda.current_stream()` builds a
    Python Stream first: a several-fold cheaper read of the same handle,
    which every launch pays (probes/launch_path.py times both)."""
    return torch.accelerator.current_stream().native_handle


def _launched(rc: int, kernel: Kernel, route: str | None = None) -> None:
    if rc == -2:
        raise RuntimeError(f"{kernel.name}: TMA tensor-map encode failed")
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed (error {rc})")
    kernel.launches += 1
    if route is not None:
        kernel.by_route[route] = kernel.by_route.get(route, 0) + 1


def _tma_ok(X: torch.Tensor, view) -> bool:
    """Can TMA read window `view` of X: its origin 16-byte aligned and its
    leading dimension a multiple of 16 bytes (for bf16, a column offset and
    a row stride that are multiples of 8 on an aligned buffer).  The dmma
    and fma loops' 16-byte copies need the same of their f64 / f32 windows."""
    return _ptr(X, view[0], view[1]) % 16 == 0 and X.stride(0) * X.element_size() % 16 == 0


#: each dtype's routes: the fast route for 16-byte-aligned windows first,
#: then the element-load loop that takes any window.  chip_smoke.py and the
#: GPU tests pit them against each other through the C entry points, with
#: `_pick_route` checking the route they name
_ROUTES = {torch.bfloat16: ("wgmma", "wmma"), torch.float32: ("fma", "simt"),
           torch.float64: ("dmma", "simt")}
#: f32's routes at precision 'high' (`split_high`): the bf16x3 split on the
#: wgmma ring over the operands' bf16 images for 16-byte-aligned windows,
#: and the element-load loop that splits as it stages for any other
_SPLIT_ROUTES = ("x3", "simt3")
#: the C entry points' route codes (csrc/tri_matmul.cu, sched_matmul.cu)
_ROUTE_CODE = {"wmma": 0, "simt": 0, "wgmma": 1, "dmma": 2, "fma": 3, "x3": 4, "simt3": 5}
_DT_NAME = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}


def split_high(a_dtype, b_dtype, precision) -> bool:
    """Does a product of these operand dtypes at `precision` take the bf16x3
    split?  The JAX package's rule (pallas_tpu.precision_dot): f32 x f32
    into an f32 accumulator at 'high'.  Every other 'high' runs as 'highest'
    (f64 stays f64, bf16 one pass), and 'highest', 'default' and None leave
    f32 on its IEEE routes."""
    return precision == "high" and a_dtype == torch.float32 and b_dtype == torch.float32


def _routes(dtype, precision) -> tuple[str, str]:
    """(fast route, element-load route) of a product of two `dtype`
    operands at `precision`."""
    return _SPLIT_ROUTES if split_high(dtype, dtype, precision) else _ROUTES[dtype]


def _pick_route(dtype, aligned: bool, route: str | None, what: str, precision=None) -> str:
    """The route a tri_matmul launch takes: the dtype's fast route ('wgmma'
    bf16, 'dmma' f64, 'fma' f32, 'x3' f32 at precision 'high') when
    `aligned` says its loop takes the operands, else its element-load loop
    ('wmma' bf16, 'simt' f32 / f64, 'simt3' f32 at 'high').  A named `route`
    (a direct C-entry launch) must be the dtype's at that precision and
    possible."""
    if route is not None and route not in _ROUTE_CODE:
        raise ValueError(f"{what}: unknown route {route!r}")
    fast, elem = _routes(dtype, precision)
    if route is None:
        return fast if aligned else elem
    if route not in (fast, elem):
        if route in _SPLIT_ROUTES or route in _ROUTES.get(dtype, ()):
            raise ValueError(f"{what}: {dtype} at precision {precision!r} takes {fast} / {elem}, "
                             f"not the {route} route (x3 and simt3 are f32's at 'high')")
        owners = " and ".join(_DT_NAME[d] for d, rs in _ROUTES.items() if route in rs)
        raise ValueError(f"{what}: only {owners} has the {route} route, got {dtype}")
    if route == fast and not aligned:
        raise ValueError(f"{what}: the {route} route cannot take these operands (it reads "
                         "16-byte-aligned windows; sched_matmul's blocks must be multiples of "
                         "its tile)")
    return route


# --------------------------------------------------------------------------
# tri_matmul
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _MMSpec:
    av: tuple
    bv: tuple
    M: int
    N: int
    K: int
    fused_c: bool
    rmw: bool
    form: str


def _mm_spec(A, B, a_uplo, a_trans, b_uplo, b_trans, out_uplo, a_view, b_view,
             out, out_off, c, c_view, beta) -> _MMSpec:
    """Validate a tri_matmul call (the JAX package's rules, plus the bounds
    and overlap checks that in-place mutation needs)."""
    if a_uplo is not None and b_uplo is not None:
        raise ValueError("at most one triangular operand")
    if out_uplo is not None and (a_uplo is not None or b_uplo is not None):
        raise ValueError("out_uplo cannot combine with a triangular operand")
    for u in (a_uplo, b_uplo, out_uplo):
        if u not in _UPLO:
            raise ValueError(f"uplo must be 'U', 'L' or None, got {u!r}")
    rmw = (
        out_uplo is not None and out is not None and beta != 0.0 and out is c
        and tuple(out_off) == ((c_view[0], c_view[1]) if c_view is not None else (0, 0))
    )
    if out_uplo is not None and out is not None and not rmw:
        raise ValueError(
            "in-place `out` with out_uplo requires out to BE the C operand "
            "with out_off == the c_view origin (syrk RMW)"
        )
    if beta != 0.0 and (out_uplo is None or c is None):
        raise ValueError("beta accumulation needs out_uplo and the C operand")
    av, bv = _full_view(A, a_view), _full_view(B, b_view)
    _check_window(A, av, "A")
    _check_window(B, bv, "B")
    am, ak = (av[3], av[2]) if a_trans else (av[2], av[3])
    bk, bn = (bv[3], bv[2]) if b_trans else (bv[2], bv[3])
    if ak != bk:
        raise ValueError(
            f"contraction mismatch: {(am, ak)} x {(bk, bn)} "
            f"(A{tuple(A.shape)} view {a_view}, B{tuple(B.shape)} view {b_view})"
        )
    fused_c = beta != 0.0 and c is not None
    if fused_c:
        cv = _full_view(c, c_view)
        _check_window(c, cv, "C")
        if (cv[2], cv[3]) != (am, bn):
            raise ValueError(f"C operand {(cv[2], cv[3])} does not match the {(am, bn)} result")
    if out is not None:
        ov = (out_off[0], out_off[1], am, bn)
        _check_window(out, ov, "out")
        for X, xv, what in ((A, av, "A"), (B, bv, "B")):
            if _overlaps(out, ov, X, xv):
                raise ValueError(f"in-place out window {ov} overlaps the {what} window {xv}")
    form = "syrk" if out_uplo else ("trmm" if (a_uplo or b_uplo) else "dense")
    return _MMSpec(av, bv, am, bn, ak, fused_c, rmw, form)


def _acc_dtype(*dtypes) -> torch.dtype:
    dt = dtypes[0]
    for d in dtypes[1:]:
        dt = torch.promote_types(dt, d)
    return torch.float64 if dt == torch.float64 else torch.float32


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 split of f32 x (the JAX package's pallas_tpu._split_bf16):
    hi = RN_bf16(x) and lo = RN_bf16(x − hi), both widened back to f32,
    where they are exact."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def split_matmul(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """The plain versions' product: a @ b, or where `split` (`split_high` of
    the operands as the caller received them) the bf16x3 split, hi·hi +
    (hi·lo + lo·hi) in f32 products of the images, summed as the reference
    sums them.  Each product of two bf16 values is exact in f32, so only
    the sums round (and TF32 would leave the images' products as they
    are)."""
    if not split:
        return a @ b
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return ah @ bh + (ah @ bl + al @ bh)


def _image_elems(rows: int, cols: int) -> int:
    """bf16 elements of one f32 operand's x3 images: the hi and lo planes of
    rows x cols, each row rounded up to 16 bytes (csrc/x3_tiles.cuh
    image_elems)."""
    return 2 * rows * (-(-cols // 8) * 8)


def _x3_work(device, *windows) -> torch.Tensor:
    """The x3 route's workspace for the images of the given (rows, cols)
    operand windows, one after the other (never empty: a tensor map needs
    an address)."""
    n = sum(_image_elems(r, c) for r, c in windows)
    return torch.empty(max(n, 8), dtype=torch.bfloat16, device=device)


def tri_matmul_plain(
    A, B, *, a_uplo=None, a_trans=False, b_uplo=None, b_trans=False,
    out_uplo=None, alpha=1.0, precision=None, a_view=None, b_view=None,
    out=None, out_off=(0, 0), c=None, c_view=None, beta=0.0,
):
    """Plain PyTorch version of `tri_matmul` (same arguments, same result).
    With fused beta·C the dead half of a fresh result is NaN — undefined by
    contract, and NaN makes a reader of it visible."""
    s = _mm_spec(A, B, a_uplo, a_trans, b_uplo, b_trans, out_uplo, a_view,
                 b_view, out, out_off, c, c_view, beta)
    Aw, Bw = _window(A, s.av), _window(B, s.bv)
    if a_uplo is not None:
        Aw = take_triangle(Aw, a_uplo)
    if b_uplo is not None:
        Bw = take_triangle(Bw, b_uplo)
    acc = _acc_dtype(A.dtype, B.dtype)
    opA = (Aw.T if a_trans else Aw).to(acc)
    opB = (Bw.T if b_trans else Bw).to(acc)
    res = split_matmul(opA, opB, split_high(A.dtype, B.dtype, precision))
    if alpha != 1.0:
        res = alpha * res
    if out_uplo is not None:
        res = take_triangle(res, out_uplo)
    live = None
    if s.fused_c:
        Cw = _window(c, _full_view(c, c_view))
        add = torch.promote_types(res.dtype, c.dtype)
        res = res.to(add) + beta * Cw.to(add)
        r = torch.arange(s.M, device=res.device)[:, None]
        q = torch.arange(s.N, device=res.device)[None, :]
        live = (r <= q) if out_uplo == "U" else (r >= q)
    if out is not None:
        ow = _window(out, (out_off[0], out_off[1], s.M, s.N))
        res = res.to(out.dtype)
        ow.copy_(torch.where(live, res, ow) if s.rmw else res)
        return out
    if s.fused_c:
        out_dtype = torch.promote_types(torch.promote_types(A.dtype, B.dtype), c.dtype)
        res = torch.where(live, res, torch.full_like(res, float("nan")))
    else:
        out_dtype = torch.promote_types(A.dtype, B.dtype)
    return res.to(out_dtype).contiguous()


def tri_matmul(
    A, B, *, a_uplo=None, a_trans=False, b_uplo=None, b_trans=False,
    out_uplo=None, alpha=1.0, precision=None, a_view=None, b_view=None,
    out=None, out_off=(0, 0), c=None, c_view=None, beta=0.0,
):
    """C = alpha · op(A) · op(B) with dead triangular tiles never visited
    (ops/csrc/tri_matmul.cu; the JAX package's pallas_tpu.tri_matmul).

    a_uplo/a_trans, b_uplo/b_trans — at most one triangular operand, its
        uplo naming the stored triangle of the untransposed window (BLAS
        trmm); the dead triangle is zero whatever the buffer holds.
    out_uplo — only that triangle of the result is computed (syrk); with
        beta == 0 the dead half is zero, with fused beta·C it is UNDEFINED.
    a_view/b_view/c_view — (r0, c0, rows, cols) windows of the buffers.
    out/out_off — write the result into `out` at out_off in place and return
        `out`.  `out` may be A's or B's buffer when the windows are disjoint;
        with out_uplo the one in-place form is the syrk read-modify-write
        (out IS c, out_off == the c_view origin).
    precision — f32 at 'high' computes the JAX package's bf16x3 split,
        hi·hi + (hi·lo + lo·hi) of the operands' bf16 hi / lo parts
        (`split_high`); every other dtype or precision is full precision (f32
        IEEE, the reference's 'highest'; bf16 one pass; f64 f64).

    The kernel takes A, B, C and out of one dtype (bf16, f32 or f64) and
    accumulates in f32 (f64 for f64).  Windows whose A and B origins and
    row strides are 16-byte aligned take the dtype's fast route (bf16
    'wgmma', f64 'dmma', f32 'fma', f32 at 'high' 'x3': the split pass
    writes both windows' bf16 images into a workspace from the caching
    allocator, then the wgmma ring multiplies them), the others its
    element-load loop (bf16 'wmma', f32 / f64 'simt', f32 at 'high'
    'simt3').  The fast routes launch their tiles longest k-range first."""
    s = _mm_spec(A, B, a_uplo, a_trans, b_uplo, b_trans, out_uplo, a_view,
                 b_view, out, out_off, c, c_view, beta)
    cc = c if s.fused_c else None
    if not _on_card(A, B, out, cc):
        return tri_matmul_plain(
            A, B, a_uplo=a_uplo, a_trans=a_trans, b_uplo=b_uplo, b_trans=b_trans,
            out_uplo=out_uplo, alpha=alpha, precision=precision, a_view=a_view, b_view=b_view,
            out=out, out_off=out_off, c=c, c_view=c_view, beta=beta,
        )
    for X, what in ((A, "A"), (B, "B"), (out, "out"), (cc, "C")):
        if X is not None:
            _kernel_operand(X, what)
            if X.dtype != A.dtype:
                raise TypeError(f"tri_matmul kernel: {what} is {X.dtype}, A is {A.dtype}")
    if out is None:
        res = torch.empty((s.M, s.N), dtype=A.dtype, device=A.device)
        o_ptr, ldo = res.data_ptr(), s.N
    else:
        res = out
        o_ptr, ldo = _ptr(out, out_off[0], out_off[1]), out.stride(0)
    if s.M == 0 or s.N == 0:
        return res
    if s.fused_c:
        cv = _full_view(c, c_view)
        c_ptr, ldc = _ptr(c, cv[0], cv[1]), c.stride(0)
    else:
        c_ptr, ldc = None, 0
    all_tiles = out_uplo is not None and not s.fused_c
    route = _pick_route(A.dtype, _tma_ok(A, s.av) and _tma_ok(B, s.bv), None, "tri_matmul",
                        precision)
    work = _x3_work(A.device, s.av[2:], s.bv[2:]) if route == "x3" else None
    rc = _build.entry("capital_tri_matmul")(
        _DTYPE_CODE[A.dtype],
        _ptr(A, s.av[0], s.av[1]), A.stride(0),
        _ptr(B, s.bv[0], s.bv[1]), B.stride(0),
        o_ptr, ldo, c_ptr, ldc,
        float(alpha), float(beta), s.M, s.N, s.K,
        int(bool(a_trans)), int(bool(b_trans)),
        _UPLO[a_uplo], _UPLO[b_uplo], _UPLO[out_uplo],
        int(s.fused_c), int(all_tiles), _ROUTE_CODE[route],
        work.data_ptr() if work is not None else None, _stream(),
    )
    _launched(rc, KERNELS["tri_matmul." + s.form], route)
    return res


# --------------------------------------------------------------------------
# transpose / transpose_pair
# --------------------------------------------------------------------------


def _transpose_spec(X, in_view, out_uplo, out, out_off):
    if out_uplo not in _UPLO:
        raise ValueError(f"out_uplo must be 'U', 'L' or None, got {out_uplo!r}")
    iv = _full_view(X, in_view)
    _check_window(X, iv, "X")
    if out is not None:
        ov = (out_off[0], out_off[1], iv[3], iv[2])
        _check_window(out, ov, "out")
        if _overlaps(out, ov, X, iv):
            raise ValueError(f"in-place out window {ov} overlaps the input window {iv}")
    return iv


def transpose_plain(X, *, in_view=None, out_uplo=None, out=None, out_off=(0, 0), out_dtype=None):
    """Plain PyTorch version of `transpose`."""
    iv = _transpose_spec(X, in_view, out_uplo, out, out_off)
    res_dtype = out.dtype if out is not None else (out_dtype or X.dtype)
    t = _window(X, iv).T
    if out_uplo is not None:
        t = take_triangle(t, out_uplo)
    t = t.to(res_dtype)
    if out is not None:
        _window(out, (out_off[0], out_off[1], iv[3], iv[2])).copy_(t)
        return out
    return t.contiguous()


def transpose(X, *, in_view=None, out_uplo=None, out=None, out_off=(0, 0), out_dtype=None):
    """Windowᵀ, masked to `out_uplo` of the result (dead half zero whatever
    the input holds), cast to `out_dtype` (or out's dtype) in the kernel,
    and written into `out` at out_off in place (returning `out`) or into a
    fresh tensor (ops/csrc/transpose.cu; pallas_tpu.transpose)."""
    iv = _transpose_spec(X, in_view, out_uplo, out, out_off)
    if not _on_card(X, out):
        return transpose_plain(X, in_view=in_view, out_uplo=out_uplo, out=out,
                               out_off=out_off, out_dtype=out_dtype)
    res_dtype = out.dtype if out is not None else (out_dtype or X.dtype)
    _kernel_operand(X, "X")
    if out is None:
        res = torch.empty((iv[3], iv[2]), dtype=res_dtype, device=X.device)
        o_ptr, ldo = res.data_ptr(), iv[2]
    else:
        res = out
        o_ptr, ldo = _ptr(out, out_off[0], out_off[1]), out.stride(0)
    _kernel_operand(res, "out")
    if iv[2] == 0 or iv[3] == 0:
        return res
    rc = _build.entry("capital_transpose")(
        _DTYPE_CODE[X.dtype], _DTYPE_CODE[res_dtype],
        _ptr(X, iv[0], iv[1]), X.stride(0), o_ptr, ldo,
        iv[2], iv[3], _UPLO[out_uplo], _stream(),
    )
    _launched(rc, KERNELS["transpose"])
    return res


def _pair_spec(L, Linv, Rp, RIp, dest):
    n = L.shape[0]
    if L.shape != (n, n) or Linv.shape != (n, n) or Rp.shape != RIp.shape:
        raise ValueError(
            f"transpose_pair wants square panels and matching buffers, got "
            f"L{tuple(L.shape)} Linv{tuple(Linv.shape)} Rp{tuple(Rp.shape)} RIp{tuple(RIp.shape)}"
        )
    ov = (dest, dest, n, n)
    _check_window(Rp, ov, "Rp")
    if _overlaps(Rp, ov, RIp, ov):
        raise ValueError("transpose_pair: Rp and RIp windows overlap")
    for Y in (Rp, RIp):
        for X in (L, Linv):
            if _overlaps(Y, ov, X, (0, 0, n, n)):
                raise ValueError("transpose_pair: an output window overlaps an input")
    return n


def transpose_pair_plain(L, Linv, Rp, RIp, *, dest):
    """Plain PyTorch version of `transpose_pair`: two `transpose_plain`
    calls."""
    _pair_spec(L, Linv, Rp, RIp, dest)
    Rp = transpose_plain(L, out_uplo="U", out=Rp, out_off=(dest, dest))
    RIp = transpose_plain(Linv, out_uplo="U", out=RIp, out_off=(dest, dest))
    return Rp, RIp


def transpose_pair(L, Linv, Rp, RIp, *, dest: int):
    """Both leaf write-backs in one launch: triu(Lᵀ) into Rp and
    triu(Linvᵀ) into RIp at (dest, dest), in place; bitwise equal to two
    `transpose` calls (ops/csrc/transpose.cu; pallas_tpu.transpose_pair)."""
    n = _pair_spec(L, Linv, Rp, RIp, dest)
    if not _on_card(L, Linv, Rp, RIp):
        return transpose_pair_plain(L, Linv, Rp, RIp, dest=dest)
    for X, what in ((L, "L"), (Linv, "Linv"), (Rp, "Rp"), (RIp, "RIp")):
        _kernel_operand(X, what)
    if L.dtype != Linv.dtype or L.stride(0) != Linv.stride(0):
        raise TypeError("transpose_pair kernel: L and Linv need one dtype and layout")
    if Rp.dtype != RIp.dtype or Rp.stride(0) != RIp.stride(0):
        raise TypeError("transpose_pair kernel: Rp and RIp need one dtype and layout")
    if n == 0:
        return Rp, RIp
    rc = _build.entry("capital_transpose_pair")(
        _DTYPE_CODE[L.dtype], _DTYPE_CODE[Rp.dtype],
        L.data_ptr(), Linv.data_ptr(), L.stride(0),
        _ptr(Rp, dest, dest), _ptr(RIp, dest, dest), Rp.stride(0), n, _stream(),
    )
    _launched(rc, KERNELS["transpose_pair"])
    return Rp, RIp


# --------------------------------------------------------------------------
# zeros_dead_lower
# --------------------------------------------------------------------------


def _zeros_spec(p, dtype, tile, extra, dead):
    if tile < 1 or p < 1:
        raise ValueError(f"zeros_dead_lower needs p >= 1 and tile >= 1, got p={p}, tile={tile}")
    if dead not in ("lower", "upper"):
        raise ValueError(f"dead must be 'lower' or 'upper', got {dead!r}")
    if not dtype.is_floating_point:
        raise TypeError(f"zeros_dead_lower takes a floating dtype, got {dtype}")
    extra = [tuple(int(v) for v in w) for w in extra]
    if len(extra) > MAX_EXTRA:
        raise ValueError(f"at most {MAX_EXTRA} extra windows, got {len(extra)}")
    for w in extra:
        r0, c0, rows, cols = w
        if min(w) < 0 or r0 + rows > p or c0 + cols > p:
            raise ValueError(f"extra window {w} outside the {p} x {p} buffer")
    return extra


def zeros_dead_lower_plain(p, dtype, tile, extra=(), dead="lower", *, device="cpu"):
    """Plain PyTorch version of `zeros_dead_lower`.  Every tile the kernel
    leaves unwritten is NaN here, so a recursion that leaves a live tile
    unwritten shows up as NaN in its result."""
    extra = _zeros_spec(p, dtype, tile, extra, dead)
    buf = torch.full((p, p), float("nan"), dtype=dtype, device=device)
    t = torch.arange(p, device=device) // tile
    dead_mask = (t[:, None] < t[None, :]) if dead == "upper" else (t[:, None] > t[None, :])
    buf[dead_mask] = 0
    for r0, c0, rows, cols in extra:
        buf[r0:r0 + rows, c0:c0 + cols] = 0
    return buf


def zeros_dead_lower(p, dtype, tile, extra=(), dead="lower", *, device):
    """A p x p buffer whose strictly-sub-diagonal `tile` blocks (strictly-
    super-diagonal with dead='upper') and `extra` (r0, c0, rows, cols)
    windows are zero; every other tile is left unwritten (ops/csrc/
    zeros_dead.cu; pallas_tpu.zeros_dead_lower).  On the card the buffer
    comes from torch.empty; the plain version fills the rest with NaN."""
    device = torch.device(device)
    extra = _zeros_spec(p, dtype, tile, extra, dead)
    if device.type == "cpu":
        return zeros_dead_lower_plain(p, dtype, tile, extra, dead, device=device)
    if device.type != "cuda":
        raise ValueError(f"zeros_dead_lower: unsupported device {device}")
    buf = torch.empty((p, p), dtype=dtype, device=device)
    flat = (ctypes.c_longlong * max(1, 4 * len(extra)))(*[v for w in extra for v in w])
    rc = _build.entry("capital_zeros_dead")(
        buf.data_ptr(), p, buf.stride(0), buf.element_size(), tile,
        int(dead == "upper"), flat, len(extra), _stream(),
    )
    _launched(rc, KERNELS["zeros_dead_lower"])
    return buf


# --------------------------------------------------------------------------
# write_diag_blocks
# --------------------------------------------------------------------------


def _diag_spec(out, W):
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"write_diag_blocks: W must be a (count, s, s) stack, got {tuple(W.shape)}")
    if out.dim() != 2 or out.shape[0] != out.shape[1]:
        raise ValueError(f"write_diag_blocks: out must be square, got {tuple(out.shape)}")
    count, s = W.shape[0], W.shape[1]
    if count * s > out.shape[0]:
        raise ValueError(
            f"write_diag_blocks: {count} blocks of {s} do not fit the diagonal of "
            f"{tuple(out.shape)}"
        )
    if W.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
        raise ValueError("write_diag_blocks: W shares storage with out")
    return count, s


def write_diag_blocks_plain(out, W):
    """Plain PyTorch version of `write_diag_blocks`: one copy per block."""
    count, s = _diag_spec(out, W)
    for i in range(count):
        out[i * s:(i + 1) * s, i * s:(i + 1) * s].copy_(W[i])
    return out


#: write_diag_blocks' routes and their C route codes (csrc/write_diag.cu)
WRITE_DIAG_ROUTES = {"elem": 0, "vec": 1}


def write_diag_route(out, W) -> str:
    """The route a CUDA `write_diag_blocks(out, W)` launch takes: 'vec'
    (16-byte vectors of W, cast in registers, stored at out's width) where
    every access it makes is aligned — W a contiguous stack at a 16-byte
    aligned address, s a multiple of the vector width (16 bytes of W's
    dtype), and out's origin and row stride multiples of the store width
    (the vector's bytes at out's dtype, 16 at most); 'elem' (one element a
    thread) otherwise.  Reads dtypes, shapes, strides and `data_ptr()`
    only, so it answers for CPU tensors too."""
    vec = 16 // W.itemsize
    store = min(16, vec * out.itemsize)
    ok = (W.data_ptr() % 16 == 0 and W.shape[-1] % vec == 0 and out.data_ptr() % store == 0
          and out.stride(0) * out.itemsize % store == 0 and W.is_contiguous())
    return "vec" if ok else "elem"


def write_diag_blocks(out, W):
    """Write the (count, s, s) stack W onto the diagonal blocks
    ``out[i*s:(i+1)*s, i*s:(i+1)*s]`` in place, cast to out's dtype, and
    return `out`; every other element of `out` is left untouched
    (ops/csrc/write_diag.cu; pallas_tpu.write_diag_blocks).  Any block size
    s works; on the card the launch takes `write_diag_route(out, W)`'s
    route, tallied in `route_counts()`.  Where the JAX package's fallback
    would clip a block (a non-square `out`, or count·s beyond its edge)
    this raises ValueError."""
    count, s = _diag_spec(out, W)
    if not _on_card(out, W):
        return write_diag_blocks_plain(out, W)
    _kernel_operand(out, "out")
    if W.dtype not in _DTYPE_CODE:
        raise TypeError(f"write_diag_blocks: W must be bf16, f32 or f64, got {W.dtype}")
    if count == 0 or s == 0:
        return out
    W = W.contiguous()
    route = write_diag_route(out, W)
    rc = _build.entry("capital_write_diag")(
        _DTYPE_CODE[W.dtype], _DTYPE_CODE[out.dtype], W.data_ptr(), out.data_ptr(),
        out.stride(0), count, s, WRITE_DIAG_ROUTES[route], _stream(),
    )
    _launched(rc, KERNELS["write_diag_blocks"], route)
    return out


# --------------------------------------------------------------------------
# fused_tail
# --------------------------------------------------------------------------


def _tail_spec(buf, Rp, RIp, off, n, dest):
    if n < 1:
        raise ValueError(f"fused_tail: window n must be >= 1, got {n}")
    if (off % n or dest % n or buf.shape[0] % n or buf.shape[1] % n
            or Rp.shape[0] % n or Rp.shape[1] % n or Rp.shape != RIp.shape):
        raise ValueError(
            f"fused_tail alignment: off={off} dest={dest} n={n} "
            f"buf{tuple(buf.shape)} Rp{tuple(Rp.shape)} RIp{tuple(RIp.shape)} must all be "
            "multiples of the window"
        )
    iv, ov = (off, off, n, n), (dest, dest, n, n)
    _check_window(buf, iv, "buf")
    _check_window(Rp, ov, "Rp")
    if _overlaps(Rp, ov, RIp, ov):
        raise ValueError("fused_tail: the Rp and RIp windows overlap")
    for Y, what in ((Rp, "Rp"), (RIp, "RIp")):
        if _overlaps(Y, ov, buf, iv):
            raise ValueError(f"fused_tail: the {what} window overlaps the input window")


#: blocks of the cluster route's cluster, by window: the multiples of 128
#: up to 512 (2, 4 or 8 blocks, each a divisor of n / 16 whose rows fit a
#: block; probes/tail_cluster.py times every size against the others)
TAIL_CLUSTER_BLOCKS = {256: 4, 384: 4, 512: 8}
TAIL_CLUSTER_WINDOWS = tuple(TAIL_CLUSTER_BLOCKS)
#: rows of a panel of the cluster route (csrc PANEL)
_TAIL_PANEL = 16


def _tail_ld(n: int) -> int:
    """The block route's tile stride (csrc tail_ld): round4(n) floats
    (16-byte rows), plus 4 when that makes it 4 mod 8 and both tiles still
    fit a block."""
    n4 = (n + 3) // 4 * 4
    ld = n4 if (n4 // 4) % 2 else n4 + 4
    return ld if 8 * n4 * ld <= SMEM_PER_BLOCK - SMEM_RESERVE else n4


def _square_ld(n: int) -> int:
    """The cluster route's square stride (csrc square_ld; n a multiple of
    16): n floats, plus 4 when n is 0 mod 8."""
    return n if (n // 4) % 2 else n + 4


def tail_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the block route for an (n, n) window: two
    f32 tiles of round4(n) x _tail_ld(n) (the window, then L and R = Lᵀ;
    I, then R⁻¹)."""
    n4 = (n + 3) // 4 * 4
    return 8 * n4 * _tail_ld(n)


def tail_cluster_smem_bytes(n: int, blocks: int) -> int:
    """Dynamic shared memory of one block of the cluster route (csrc
    cluster_floats): its n / blocks rows of the n x n f32 square, the
    16 x n panel, R⁻¹'s diagonal on its rows, L11ᵀ and the pivots' roots
    copied from the panel's owner, its own roots and a flag."""
    rows = n // blocks
    return 4 * (rows * _square_ld(n) + _TAIL_PANEL * n + rows + _TAIL_PANEL * _TAIL_PANEL
                + 2 * _TAIL_PANEL + 4)


def tail_route(n: int) -> str | None:
    """The route `fused_tail` takes for an (n, n) window on the card:
    'block' when one block's shared memory holds the window's two f32 tiles
    (round4(n) <= 168), 'cluster' for the windows of TAIL_CLUSTER_BLOCKS on
    their cluster, None for any other window (the kernel refuses it)."""
    room = SMEM_PER_BLOCK - SMEM_RESERVE
    if n >= 1 and tail_smem_bytes(n) <= room:
        return "block"
    if n in TAIL_CLUSTER_BLOCKS and tail_cluster_smem_bytes(n, TAIL_CLUSTER_BLOCKS[n]) <= room:
        return "cluster"
    return None


#: the cluster route's fault-path scratch (2·n² f32 for the largest window),
#: one per (device, stream): the kernel writes it only on a fault, and two
#: streams' faults must not share it
_TAIL_SCRATCH: dict = {}


def _tail_scratch(device, stream: int) -> torch.Tensor:
    key = (device, stream)
    scratch = _TAIL_SCRATCH.get(key)
    if scratch is None:
        scratch = _TAIL_SCRATCH[key] = torch.empty(2 * max(TAIL_CLUSTER_WINDOWS) ** 2, dtype=torch.float32,
                                                   device=device)
    return scratch


def tail_eligible(n: int, dtype, *, interpret: bool) -> bool:
    """Whether `fused_tail` takes an (n, n) window of `dtype`: bf16 or f32
    (f64 takes the unfused recursion) on one of its routes (`tail_route`):
    the block route up to n = 168, the cluster route at 256, 384 and 512.
    With cholinv's `n % 128 == 0` gate, windows of 128 fuse on the block
    route and of 256–512 on the cluster route; larger windows stay unfused
    on the card, where the JAX package fuses any window its VMEM budget
    admits — the unfused recursion computes the same factor.

    interpret=True (the caller's buffers lie on the CPU) answers True: the
    plain version has no envelope, as the JAX kernel in interpret mode has
    none."""
    if interpret:
        return True
    return dtype in (torch.bfloat16, torch.float32) and tail_route(n) is not None


def fused_tail_plain(buf, Rp, RIp, *, off, n, dest, block=0, precision="highest"):
    """Plain PyTorch version of `fused_tail`: the window symmetrised from
    its upper half, `sweeps.chol_plain` (uplo U) and `sweeps.bwd_solve_plain`
    of the identity, in f32."""
    _tail_spec(buf, Rp, RIp, off, n, dest)
    del block, precision
    w = buf[off:off + n, off:off + n].float()
    idx = torch.arange(n, device=buf.device)
    upper = idx[:, None] <= idx[None, :]
    S = torch.where(upper, w, w.T)
    R, info = sweeps.chol_plain(S[None], "U")
    eye = torch.eye(n, dtype=torch.float32, device=buf.device)[None]
    Rinv = sweeps.bwd_solve_plain(R, eye, from_upper=True)
    zero = torch.zeros((), device=buf.device)
    _window(Rp, (dest, dest, n, n)).copy_(torch.where(upper, R[0], zero))
    _window(RIp, (dest, dest, n, n)).copy_(torch.where(upper, Rinv[0], zero))
    return Rp, RIp, info[0]


def fused_tail(buf, Rp, RIp, *, off: int, n: int, dest: int, block: int = 0,
               precision: str | None = "highest", _sweep: bool = False):
    """A whole cholinv recursion subtree in one launch (ops/csrc/
    fused_tail.cu; pallas_tpu.fused_tail): read the (off, off, n, n) window
    of `buf` (upper triangle valid; the lower half may hold anything),
    factor it A = RᵀR, invert R by back-substituting the identity, and
    write triu(R) and triu(R⁻¹) into the (dest, dest, n, n) windows of `Rp`
    and `RIp` in place.  Returns (Rp, RIp, info), info a 0-d int32 tensor
    in the potrf 0/k/n+1 convention of `batched_small.potrf`, computed in
    the kernel.  R and R⁻¹ are the column sweeps' (`sweeps.chol_plain`,
    `sweeps.bwd_solve_plain` of I) bit for bit on a healthy window.

    off, dest and both dimensions of every buffer must be multiples of n
    (ValueError otherwise, as in the JAX package).  The kernel takes bf16
    or f32 buffers of one dtype and computes in f32 in shared memory, on
    the route `tail_route` picks before the launch and
    `route_counts()['fused_tail']` tallies: 'block' (n <= 168, one block)
    or 'cluster' (n = 256, 384, 512; a thread-block cluster of
    `TAIL_CLUSTER_BLOCKS[n]` blocks, with an f32 scratch of 2·n², kept per
    device and stream, for the fault path).  Other windows raise.  `block`
    (the JAX kernel's static column unroll) changes nothing here.  `_sweep`
    runs the kernel's column-sweep path (its fault path) on a healthy
    window, which chip_smoke.py and the GPU tests hold to the blocked path
    bit for bit."""
    _tail_spec(buf, Rp, RIp, off, n, dest)
    del block
    if not _on_card(buf, Rp, RIp):
        return fused_tail_plain(buf, Rp, RIp, off=off, n=n, dest=dest)
    for X, what in ((buf, "buf"), (Rp, "Rp"), (RIp, "RIp")):
        _kernel_operand(X, what)
        if X.dtype not in (torch.bfloat16, torch.float32) or X.dtype != buf.dtype:
            raise TypeError(
                f"fused_tail kernel: buf, Rp and RIp must share one dtype, bf16 or f32; "
                f"{what} is {X.dtype}, buf {buf.dtype}"
            )
    if Rp.stride(0) != RIp.stride(0):
        raise ValueError("fused_tail kernel: Rp and RIp need one layout")
    route = tail_route(n)
    if route is None:
        raise ValueError(
            f"fused_tail: a window of {n} fits neither route: the block route holds n <= 168 in "
            f"{SMEM_PER_BLOCK - SMEM_RESERVE} bytes of shared memory, the cluster route takes "
            f"{TAIL_CLUSTER_WINDOWS}"
        )
    stream = _stream()
    blocks, scratch = 1, None
    if route == "cluster":
        blocks, scratch = TAIL_CLUSTER_BLOCKS[n], _tail_scratch(buf.device, stream).data_ptr()
    info = torch.empty((), dtype=torch.int32, device=buf.device)
    rc = _build.entry("capital_fused_tail")(
        _DTYPE_CODE[buf.dtype], _ptr(buf, off, off), buf.stride(0),
        _ptr(Rp, dest, dest), _ptr(RIp, dest, dest), Rp.stride(0),
        info.data_ptr(), scratch, n, blocks, int(_sweep), stream,
    )
    _launched(rc, KERNELS["fused_tail"], route)
    return Rp, RIp, info


# --------------------------------------------------------------------------
# sched_matmul
# --------------------------------------------------------------------------

#: (rows, cols, depth) of one CUDA block's tile on each route: the blocks
#: must be multiples of it
_WGMMA_BK = 64
_SCHED_TILE = {"wgmma": (128, 128, _WGMMA_BK), "wmma": (128, 128, 32), "dmma": (128, 128, 32),
               "fma": (128, 128, 8), "simt": (64, 64, 16), "x3": (128, 128, _WGMMA_BK),
               "simt3": (64, 64, 16)}
#: most schedule entries one launch takes (the grid's second dimension)
SCHED_MAX_PAIRS = 65535


def _sched_fits(route: str, blocks) -> bool:
    """Does the route's CUDA tile divide the schedule's blocks?"""
    return all(b % t == 0 for b, t in zip(blocks, _SCHED_TILE[route]))


def sched_route(dtype, aligned: bool, blocks, precision=None) -> str | None:
    """The route a sched_matmul launch takes, by shape and precision alone:
    the dtype's fast route when the operands are 16-byte aligned and its
    tile divides the blocks; else the element-load loop whose tile divides
    them — bf16's 128-row 'wmma', then the 64-row 'simt' loop of every
    dtype (blocks of t = 192, the persistent layout's at base_case_dim 384
    on a d = 2 face).  f32 at precision 'high' takes 'x3', else its 64-row
    'simt3'.  None when no tile divides the blocks."""
    fast, elem = _routes(dtype, precision)
    if aligned and _sched_fits(fast, blocks):
        return fast
    for route in (elem, "simt3" if elem == "simt3" else "simt"):
        if _sched_fits(route, blocks):
            return route
    return None


def _sched_spec(A, B, to, ko, first, last, tri_side, blocks):
    if tri_side not in ("a", "b"):
        raise ValueError(f"tri_side must be 'a' or 'b', got {tri_side!r}")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"sched_matmul: cannot multiply {tuple(A.shape)} by {tuple(B.shape)}")
    (M, K), N = A.shape, B.shape[1]
    bm, bn, bk = blocks
    if min(blocks) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"sched_matmul: blocks {tuple(blocks)} must tile (M, K, N) = {(M, K, N)}")
    for x in (to, ko, first, last):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape != to.shape or not x.is_contiguous():
            raise ValueError(
                "sched_matmul: to, ko, first and last must be contiguous 1-D int32 "
                "arrays of one length"
            )
        if x.device != A.device:
            raise ValueError(f"sched_matmul: the schedule is on {x.device}, A on {A.device}")
    if to.numel() == 0:
        raise ValueError("sched_matmul: empty schedule")
    return M, N, K


def sched_matmul_plain(A, B, to, ko, first, last, *, tri_side="a", blocks, precision=None):
    """Plain PyTorch version of `sched_matmul`: the Pallas body's pair loop
    written out, with the outer (dense-side) axis done in one product per
    pair.  Tiles that no pair lists are NaN (undefined by contract)."""
    M, N, _ = _sched_spec(A, B, to, ko, first, last, tri_side, blocks)
    split = split_high(A.dtype, B.dtype, precision)
    bm, bn, bk = blocks
    acc_dt = _acc_dtype(A.dtype, B.dtype)
    out = torch.full((M, N), float("nan"), dtype=torch.promote_types(A.dtype, B.dtype),
                     device=A.device)
    acc = None
    for t, k, fi, la in zip(to.tolist(), ko.tolist(), first.tolist(), last.tolist()):
        ks = slice(k * bk, (k + 1) * bk)
        if tri_side == "a":
            a_op, b_op = A[t * bm:(t + 1) * bm, ks], B[ks]
        else:
            a_op, b_op = A[:, ks], B[ks, t * bn:(t + 1) * bn]
        prod = split_matmul(a_op.to(acc_dt), b_op.to(acc_dt), split)
        acc = prod if fi == 1 or acc is None else acc + prod
        if la == 1:
            if tri_side == "a":
                out[t * bm:(t + 1) * bm] = acc.to(out.dtype)
            else:
                out[:, t * bn:(t + 1) * bn] = acc.to(out.dtype)
    return out


def sched_matmul(A, B, to, ko, first, last, *, tri_side="a", blocks, precision=None):
    """C = A @ B visiting only the (tile, k-tile) pairs listed in the int32
    schedule arrays (ops/csrc/sched_matmul.cu; pallas_tpu.sched_matmul).

    tri_side='a': pair p is (row tile to[p] of A and C, k-tile ko[p]), the
    side-L trmm shape; 'b': (column tile of B and C, k-tile), side R.
    first[p] / last[p] mark each tile's first and last live k-step; pad
    entries repeat the final pair with first = last = 0 and write nothing.
    blocks = (bm, bn, bk) tile M, N and K.  The operands are pre-masked: no
    mask is applied inside a tile.  Output tiles that no pair lists are
    undefined.  The kernel takes row-major contiguous A and B of one dtype
    (bf16, f32 or f64), blocks that a route's CUDA tile divides
    (`_SCHED_TILE`), accumulates in f32 (f64 for f64) and writes the
    operands' dtype.  The route is `sched_route`'s: 16-byte-aligned
    operands whose blocks the fast route's tile divides take that route
    (bf16 'wgmma', f64 'dmma', f32 'fma'), the others the element-load loop
    ('wmma' bf16, 'simt' f32 / f64), and blocks only a 64-row tile divides
    'simt' in bf16 too.  f32 at precision 'high' computes the bf16x3 split
    (`split_high`) on 'x3' (the operands' bf16 images, split into a
    workspace from the caching allocator, on the wgmma ring) or 'simt3'."""
    M, N, K = _sched_spec(A, B, to, ko, first, last, tri_side, blocks)
    if not _on_card(A, B, to, ko, first, last):
        return sched_matmul_plain(A, B, to, ko, first, last, tri_side=tri_side, blocks=blocks,
                                  precision=precision)
    for X, what in ((A, "A"), (B, "B")):
        _kernel_operand(X, what)
        if not X.is_contiguous():
            raise ValueError(f"sched_matmul kernel: {what} must be contiguous")
    if B.dtype != A.dtype:
        raise TypeError(f"sched_matmul kernel: B is {B.dtype}, A is {A.dtype}")
    if to.numel() > SCHED_MAX_PAIRS:
        raise ValueError(f"sched_matmul kernel: {to.numel()} pairs, at most {SCHED_MAX_PAIRS}")
    route = sched_route(A.dtype, _tma_ok(A, (0, 0)) and _tma_ok(B, (0, 0)), blocks, precision)
    if route is None:
        raise ValueError(
            f"sched_matmul kernel: blocks {tuple(blocks)} must be multiples of a route's "
            f"tile, at least {_SCHED_TILE['simt']}"
        )
    res = torch.empty((M, N), dtype=A.dtype, device=A.device)
    work = _x3_work(A.device, (M, K), (K, N)) if route == "x3" else None
    rc = _build.entry("capital_sched_matmul")(
        _DTYPE_CODE[A.dtype], A.data_ptr(), B.data_ptr(), res.data_ptr(),
        to.data_ptr(), ko.data_ptr(), first.data_ptr(), last.data_ptr(),
        to.numel(), M, N, K, *blocks, int(tri_side == "a"), _ROUTE_CODE[route],
        work.data_ptr() if work is not None else None, _stream(),
    )
    _launched(rc, KERNELS["sched_matmul"], route)
    return res
