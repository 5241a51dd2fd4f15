#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (capital_tpu_torch) on one card.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with one NVIDIA H100.  It

1. builds the port's CUDA kernels from the checkout (nvcc, sm_90a) and
   prints the card (name and power limit, from nvidia-smi), the torch and
   CUDA versions and the build time;
2. holds every kernel of the cholinv path against its plain PyTorch version
   on the card, at the path's shapes (n=16384, bc=512: 8192-wide trmm/syrk
   windows, 512-wide leaves), in bf16 and f32, and times kernel, plain
   version and the nearest single PyTorch call with CUDA events beside the
   kernel's bound;
3. drives the cholinv path, `models/cholesky.factor` in mode 'pallas':
   n=16384 bf16 (against the same factor through the plain versions, plus
   residual gates), n=8192 f32 (residual gates), and the n=49152 bf16
   flagship with bc=384 (timed, probe-vector residual gates, and one factor
   traced with torch.profiler: device time by CI:: phase and kernel, idle
   share) — each with the launch counters set to 0 just before and checked
   just after against what the plan predicts;
4. holds the CholeskyQR2 kernels (gram_blocked, scale_gram, scale_blocked)
   against their plain versions at the 2,097,152 x 1024 bf16 QR flagship and
   at 65536 x 512 f32, timed beside their bounds and library calls;
5. drives the CholeskyQR2 path, `models/qr.factor` in mode 'pallas': the
   2,097,152 x 1024 bf16 flagship (timed, profiled, gated), 65536 x 512 f32
   (also against the same factor through the plain versions), 65536 x 4096
   bf16 (both grams through cholinv at bc=128), CQR1 at 65536 x 1024 bf16,
   and a robust f32 run with a rank-deficient gram injected — each with
   the counters set to 0 just before and checked just after against the
   plan, and the orthogonality and residual gates of bench/drivers.py;
6. prints the `kernels` JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line; so does a machine without CUDA or a directory without the package.
f32 matmuls run in full IEEE f32: TF32 is switched off below.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 FMA
PATH_KERNELS = ("tri_matmul.trmm", "tri_matmul.syrk", "transpose", "transpose_pair",
                "zeros_dead_lower")
QR_KERNELS = ("qr.gram_blocked", "qr.scale_gram", "qr.scale_blocked")
#: (m, n) of each CholeskyQR2 run: the BASELINE.md "CAQR2 ... 2M x 1024"
#: flagship (bf16), the f32 row (65536 x 512), a wide gram whose factor goes
#: through cholinv (n=4096, bc=128), CQR1 and the robust run (n=1024)
QR_SHAPES = {"flagship": (2_097_152, 1024), "f32": (65536, 512), "wide": (65536, 4096),
             "cqr1": (65536, 1024)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("FAIL: " + msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over memory
    rate and operations over peak rate."""
    tb, tf = nbytes / MEM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def spd_hash(n: int, dtype, salt: int, device) -> torch.Tensor:
    """Deterministic well-conditioned SPD matrix made on the card: a
    symmetric hash of (min(i, j), max(i, j), salt) mapped to U[-1, 1]/√n,
    plus 3I (spectrum ≈ [1.8, 4.2]).  Built in row blocks (uint32 arithmetic
    emulated in int64)."""
    m32 = 0xFFFFFFFF
    out = torch.empty((n, n), dtype=dtype, device=device)
    c = torch.arange(n, device=device, dtype=torch.int64)[None, :]
    for r0 in range(0, n, 2048):
        r = torch.arange(r0, min(n, r0 + 2048), device=device, dtype=torch.int64)[:, None]
        lo, hi = torch.minimum(r, c), torch.maximum(r, c)
        h = ((lo * 0x9E3779B1) & m32) ^ ((hi * 0x85EBCA77) & m32)
        h = (h + salt * 0xC2B2AE3D) & m32
        h = ((h ^ (h >> 16)) * 0x7FEB352D) & m32
        h = ((h ^ (h >> 15)) * 0x846CA68B) & m32
        h = h ^ (h >> 16)
        v = (h.to(torch.float32) * 2.0**-32 * 2.0 - 1.0) / math.sqrt(n)
        v = v + 3.0 * (r == c)
        out[r0:r0 + r.shape[0]] = v.to(dtype)
        del lo, hi, h, v
    return out


def check_close(name, got, want, dtype, mask=None) -> float:
    """Kernel against plain version.  Tolerance: bf16, one bf16 ulp of each
    entry plus 1e-5 of the largest (both accumulate in f32 and round once);
    f32, 3e-5 of the largest entry (8192-long IEEE sums in another order).
    The QR kernels' Q is held the same way; their gram G by relative
    Frobenius (`check_gram`)."""
    g, w = got.float(), want.float()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = (g - w).abs()
    scale = float(w.abs().max())
    if dtype == torch.bfloat16:
        ok = bool((err <= 2.0**-7 * w.abs() + 1e-5 * scale).all())
    else:
        ok = float(err.max()) <= 3e-5 * scale
    worst = float(err.max())
    check(ok and math.isfinite(worst), f"{name} {dtype}: kernel vs plain max err {worst} (scale {scale})")
    return worst


def check_gram(name, got, want, dtype, g) -> float:
    """Gram kernel against plain version: relative Frobenius <= 1e-3 from
    bf16 input (scale_gram's two grams are of two Qs that may differ by an
    ulp), 1e-5 from f32 input (long IEEE sums in another order); the strictly
    lower block triangle must be exactly zero."""
    n = got.shape[0]
    rel = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    check(rel <= tol, f"{name} {dtype}: gram kernel vs plain relative Frobenius {rel} > {tol}")
    t = torch.arange(n, device=got.device) // (n // g)
    check(bool((got[t[:, None] > t[None, :]] == 0).all()), f"{name} {dtype}: dead block triangle not zero")
    print(json.dumps({"gram": name, "dtype": str(dtype), "rel_fro_vs_plain": rel}), flush=True)
    return float((got - want).abs().max())


def kernel_phase(hopper, dtype, dev, W: int = 8192, bc: int = 512) -> dict:
    """Every kernel against its plain version at the main path's shapes
    (the top-level window W and the leaf bc of n=16384, bc=512)."""
    p = 2 * W
    item = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.float32).to(dtype)
    RIp, Rp, buf = rnd(p, p), rnd(p, p), rnd(p, p)
    res = {}

    # trmm form, the TRSM shape: R12 = triu(RIp11)ᵀ · A12 into Rp
    kw = dict(a_uplo="U", a_trans=True, a_view=(0, 0, W, W), b_view=(0, W, W, W),
              out_off=(0, W))
    out_k, out_p = Rp.clone(), Rp.clone()
    hopper.tri_matmul(RIp, buf, out=out_k, **kw)
    hopper.tri_matmul_plain(RIp, buf, out=out_p, **kw)
    err = check_close("trmm", out_k, out_p, dtype)
    # the side-R inverse-completion shape, in the triangular operand's buffer
    T = rnd(W, W)
    kwr = dict(b_uplo="U", alpha=-1.0, b_view=(W, W, W, W), out_off=(0, W))
    rk, rp = RIp.clone(), RIp.clone()
    hopper.tri_matmul(T, rk, out=rk, **kwr)
    hopper.tri_matmul_plain(T, rp, out=rp, **kwr)
    err = max(err, check_close("trmm side R", rk, rp, dtype))
    del rk, rp
    A11t = torch.triu(RIp[:W, :W]).t().contiguous()
    B12 = buf[:W, W:].contiguous()
    flops = W * W * (W + 1)
    nbytes = (W * (W + 1) / 2 + 2 * W * W) * item
    res["tri_matmul.trmm"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: hopper.tri_matmul(RIp, buf, out=out_k, **kw), 5),
        plain_ms=time_ms(lambda: hopper.tri_matmul_plain(RIp, buf, out=out_p, **kw), 5),
        library_ms=time_ms(lambda: torch.matmul(A11t, B12), 5),
        shape=f"trsm window {W}x{W} tri x {W}x{W}",
        bound=bound_ms(nbytes, flops, dtype),
    )
    del out_k, out_p, A11t, B12, T

    # syrk form, the Schur shape: S = −R12ᵀR12 + A22, upper tiles only
    kw = dict(a_trans=True, b_trans=False, out_uplo="U", alpha=-1.0, beta=1.0,
              a_view=(0, W, W, W), b_view=(0, W, W, W), c=buf, c_view=(W, W, W, W))
    sk = hopper.tri_matmul(Rp, Rp, **kw)
    sp = hopper.tri_matmul_plain(Rp, Rp, **kw)
    live = torch.triu(torch.ones(W, W, dtype=torch.bool, device=dev))
    err = check_close("syrk", sk, sp, dtype, live)
    del sk, sp, live
    R12 = Rp[:W, W:].contiguous()
    C22 = buf[W:, W:].contiguous()
    res["tri_matmul.syrk"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: hopper.tri_matmul(Rp, Rp, **kw), 5),
        plain_ms=time_ms(lambda: hopper.tri_matmul_plain(Rp, Rp, **kw), 5),
        library_ms=time_ms(lambda: torch.addmm(C22, R12.t(), R12, beta=1.0, alpha=-1.0), 5),
        shape=f"schur {W}x{W} upper, K={W}, fused beta*C",
        bound=bound_ms((W * W + W * (W + 1)) * item, W * W * (W + 1), dtype),
    )
    del R12, C22

    # dense form (off the cholinv path; the same CUDA kernel)
    D = W // 2
    kw = dict(b_trans=True, a_view=(0, 0, D, D), b_view=(D, 0, D, D))
    err = check_close("dense", hopper.tri_matmul(buf, Rp, **kw),
                      hopper.tri_matmul_plain(buf, Rp, **kw), dtype)
    Ad, Bd = buf[:D, :D].contiguous(), Rp[D:2 * D, :D].contiguous()
    res["tri_matmul.dense"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: hopper.tri_matmul(buf, Rp, **kw), 5),
        plain_ms=time_ms(lambda: hopper.tri_matmul_plain(buf, Rp, **kw), 5),
        library_ms=time_ms(lambda: torch.matmul(Ad, Bd.t()), 5),
        shape=f"{D}x{D}x{D}",
        bound=bound_ms(3 * D * D * item, 2.0 * D**3, dtype),
    )
    del Ad, Bd

    # transpose, the leaf read: window -> lower f32 panel
    kw = dict(in_view=(bc, bc, bc, bc), out_uplo="L", out_dtype=torch.float32)
    check(torch.equal(hopper.transpose(buf, **kw), hopper.transpose_plain(buf, **kw)),
          f"transpose {dtype}: kernel differs from plain")
    panel = torch.empty((bc, bc), dtype=torch.float32, device=dev)
    win = buf[bc:2 * bc, bc:2 * bc]
    res["transpose"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.transpose(buf, **kw), 200),
        plain_ms=time_ms(lambda: hopper.transpose_plain(buf, **kw), 200),
        library_ms=time_ms(lambda: panel.copy_(win.t()), 200),
        shape=f"{bc}x{bc} {dtype} -> f32 lower",
        bound=bound_ms((bc * (bc + 1) / 2) * item + bc * bc * 4, 0.0, dtype),
    )

    # transpose_pair, the leaf write-back: two f32 panels -> Rp, RIp
    L = torch.tril(rnd(bc, bc).float())
    Li = torch.tril(rnd(bc, bc).float())
    pk = hopper.transpose_pair(L, Li, Rp.clone(), RIp.clone(), dest=bc)
    pp = hopper.transpose_pair_plain(L, Li, Rp.clone(), RIp.clone(), dest=bc)
    check(torch.equal(pk[0], pp[0]) and torch.equal(pk[1], pp[1]),
          f"transpose_pair {dtype}: kernel differs from plain")
    del pk, pp
    res["transpose_pair"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.transpose_pair(L, Li, Rp, RIp, dest=bc), 200),
        plain_ms=time_ms(lambda: hopper.transpose_pair_plain(L, Li, Rp, RIp, dest=bc), 200),
        library_ms=None,
        shape=f"2 x {bc}x{bc} f32 -> {dtype} upper",
        bound=bound_ms(2 * (bc * (bc + 1) / 2 * 4 + bc * bc * item), 0.0, dtype),
    )
    del RIp, Rp, buf

    # zeros_dead_lower into a NaN-prefilled buffer (the caching allocator
    # hands the freed block back): dead tiles zero, every other tile intact
    tile = bc
    nanbuf = torch.full((p, p), float("nan"), dtype=dtype, device=dev)
    ptr = nanbuf.data_ptr()
    del nanbuf
    z = hopper.zeros_dead_lower(p, dtype, tile, device=dev)
    check(z.data_ptr() == ptr, "zeros_dead_lower: NaN-prefilled block was not reused")
    zp = hopper.zeros_dead_lower_plain(p, dtype, tile, device=dev)
    check(torch.equal(torch.isnan(z), torch.isnan(zp)) and bool((z[~torch.isnan(zp)] == 0).all()),
          f"zeros_dead_lower {dtype}: kernel's zero set differs from plain")
    del z, zp
    nt = p // tile
    dead_bytes = nt * (nt - 1) / 2 * tile * tile * item
    full = torch.empty((p, p), dtype=dtype, device=dev)
    res["zeros_dead_lower"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: hopper.zeros_dead_lower(p, dtype, tile, device=dev), 20),
        plain_ms=time_ms(lambda: hopper.zeros_dead_lower_plain(p, dtype, tile, device=dev), 20),
        library_ms=time_ms(lambda: full.zero_(), 20),
        shape=f"{p}x{p} tile {tile}",
        bound=bound_ms(dead_bytes, 0.0, dtype),
    )
    del full
    torch.cuda.empty_cache()
    return res


def predicted_counts(leaves: int) -> dict:
    """Launches of one cholinv factor with split=1 and `leaves` leaves."""
    return {
        "tri_matmul.trmm": 3 * (leaves - 1), "tri_matmul.syrk": leaves - 1,
        "tri_matmul.dense": 0, "transpose": leaves, "transpose_pair": leaves,
        "zeros_dead_lower": 2, **dict.fromkeys(QR_KERNELS, 0),
    }


@contextmanager
def plain_versions(hopper):
    """Route the factor through the plain versions (for the comparison run
    only): swap the wrappers in the module namespace and restore them."""
    names = ("tri_matmul", "transpose", "transpose_pair", "zeros_dead_lower")
    saved = {n: getattr(hopper, n) for n in names}
    try:
        for n in names:
            setattr(hopper, n, getattr(hopper, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(hopper, n, f)


def drive(cholesky, hopper, grid, n, dtype, bc, precision):
    """One factor through the kernels with the counters set to 0 just
    before and read just after; returns (R, Rinv, A, cfg, counts, seconds)."""
    cfg = cholesky.CholinvConfig(mode="pallas", base_case_dim=bc, precision=precision)
    A = spd_hash(n, dtype, salt=1, device=grid.device)
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    R, Ri = cholesky.factor(grid, A, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = hopper.counts()
    want = predicted_counts(cholesky.padded_dim(n, bc) // bc)
    check(counts == want, f"n={n} launch counts {counts} != predicted {want}")
    return R, Ri, A, cfg, counts, secs


def profile(run, prefix: str) -> dict:
    """One call of `run` under torch.profiler: wall time, device time by
    kernel name and by phase (scopes whose tag starts with `prefix`), and
    the share of the wall the device was idle (no kernel running)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from capital_tpu_torch.utils import tracing

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        # a trace loses its first kernel: spend it on a tiny one (its few
        # microseconds count as busy, outside the timed window)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del res

    phases = {  # device time of the kernels launched inside each scope
        evt.key: float(evt.device_time_total) / 1e3
        for evt in prof.key_averages() if evt.key.startswith(prefix)
    }
    kernels: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.time_range.end <= e.time_range.start:
            continue
        if getattr(e, "is_user_annotation", False) or e.name in tracing.PHASE_REGISTRY:
            continue  # a scope's range on the device timeline, not a kernel
        kernels[e.name[:80]] = kernels.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    # busy time: the union of kernel intervals on the device timeline
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / 1e3 / (wall * 1e3)),
                phases_device_ms=phases, top_kernels_device_ms=top)


def tall_randn(m: int, n: int, dtype, seed: int, device) -> torch.Tensor:
    """Gaussian m x n operand made on the card from a seed (well
    conditioned: cond ~ (1 + sqrt(n/m)) / (1 - sqrt(n/m)))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((m, n), generator=gen, device=device, dtype=dtype)


def qr_kernel_phase(qr_fused, m: int, n: int, dtype, dev) -> dict:
    """The three CholeskyQR2 kernels against their plain versions at (m, n)
    and its column split, timed beside bound and library call."""
    g = qr_fused.pick_g(n)
    live = qr_fused.live_fraction(g)
    item = torch.tensor([], dtype=dtype).element_size()
    A = tall_randn(m, n, dtype, 11, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    Rinv = torch.triu(torch.randn((n, n), generator=gen, device=dev) * (0.1 / math.sqrt(n))
                      + torch.eye(n, device=dev)).to(dtype)
    flops = 2.0 * m * n * n * live
    res, iters = {}, 3
    pi = 1 if m * n > 1 << 28 else 3  # the plain versions loop over row blocks

    Gk, Gp = qr_fused.gram_blocked(A, g=g), qr_fused.gram_blocked_plain(A, g=g)
    err = check_gram("gram_blocked", Gk, Gp, dtype, g)
    del Gk, Gp
    res["qr.gram_blocked"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qr_fused.gram_blocked(A, g=g), iters),
        plain_ms=time_ms(lambda: qr_fused.gram_blocked_plain(A, g=g), pi, warmup=1),
        library_ms=time_ms(lambda: torch.mm(A.t(), A), iters),
        shape=f"{m}x{n} {dtype} g={g}",
        bound=bound_ms(m * n * item + 4.0 * n * n, flops, dtype),
    )

    Qk, Qp = qr_fused.scale_blocked(A, Rinv, g=g), qr_fused.scale_blocked_plain(A, Rinv, g=g)
    err = check_close("scale_blocked", Qk, Qp, dtype)
    del Qk, Qp
    Rt = torch.triu(Rinv)
    res["qr.scale_blocked"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qr_fused.scale_blocked(A, Rinv, g=g), iters),
        plain_ms=time_ms(lambda: qr_fused.scale_blocked_plain(A, Rinv, g=g), pi, warmup=1),
        library_ms=time_ms(lambda: A @ Rt, iters),
        shape=f"{m}x{n} {dtype} g={g}",
        bound=bound_ms(2.0 * m * n * item + n * n * item, flops, dtype),
    )
    del Rt

    (Qk, Gk), (Qp, Gp) = qr_fused.scale_gram(A, Rinv, g=g), qr_fused.scale_gram_plain(A, Rinv, g=g)
    err = max(check_close("scale_gram Q", Qk, Qp, dtype), check_gram("scale_gram", Gk, Gp, dtype, g))
    del Qk, Gk, Qp, Gp
    res["qr.scale_gram"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qr_fused.scale_gram(A, Rinv, g=g), iters),
        plain_ms=time_ms(lambda: qr_fused.scale_gram_plain(A, Rinv, g=g), pi, warmup=1),
        library_ms=None,  # no single PyTorch call computes it
        shape=f"{m}x{n} {dtype} g={g}",
        bound=bound_ms(2.0 * m * n * item + n * n * item + 4.0 * n * n, 2 * flops, dtype),
    )
    del A, Rinv
    torch.cuda.empty_cache()
    return res


def predicted_qr_counts(n: int, bc: int, num_iter: int, shifted: int = 0) -> dict:
    """Launches of one qr.factor in mode 'pallas' on one device: CQR2 runs
    the three fused kernels and factors both grams through cholinv
    (n >= 2048) or potrf_trtri_upper (three transposes each, once more per
    shifted retry); CQR1 runs one tri_matmul trmm."""
    counts = dict.fromkeys(predicted_counts(1), 0)
    if num_iter == 1:
        counts["tri_matmul.trmm"] = 1
        return counts
    if n >= 2048:
        counts = {k: 2 * v for k, v in predicted_counts(n // bc).items()}
    else:
        counts["transpose"] = 3 * (2 + shifted)
    counts.update(dict.fromkeys(QR_KERNELS, 1))
    return counts


@contextmanager
def plain_qr_versions(hopper, qr_fused):
    """Route a QR factor through the plain versions (comparison run only)."""
    names = ("gram_blocked", "scale_gram", "scale_blocked")
    saved = {n: getattr(qr_fused, n) for n in names}
    try:
        for n in names:
            setattr(qr_fused, n, getattr(qr_fused, n + "_plain"))
        with plain_versions(hopper):
            yield
    finally:
        for n, f in saved.items():
            setattr(qr_fused, n, f)


def qr_gates(residual, A, Q, R, label) -> dict:
    """The gates of capital_tpu/bench/drivers.py (`_tolerance`):
    ‖I − QᵀQ‖ and the row-blocked ‖A − QR‖/‖A‖ < 5e-2 (bf16), 5e-5 (f32)."""
    tol = 5e-2 if A.dtype == torch.bfloat16 else 5e-5
    orth = float(residual.qr_orthogonality(Q))
    res = float(residual.qr_residual_blocked(A, Q, R))
    check(orth < tol and res < tol, f"{label}: orthogonality {orth}, residual {res} (tol {tol})")
    return dict(orthogonality=orth, residual=res)


def drive_qr(qr, hopper, grid, A, cfg, want, label):
    """One qr.factor with the counters set to 0 just before and read just
    after, held to the plan's launch counts."""
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = qr.factor(grid, A, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = hopper.counts()
    if callable(want):
        want = want(out)
    check(counts == want, f"{label}: launch counts {counts} != predicted {want}")
    return out, counts, secs


def qr_path(hopper, dev, grid) -> dict:
    """The CholeskyQR2 runs of the path table."""
    from capital_tpu_torch.models import cholesky, qr
    from capital_tpu_torch.ops import qr_fused
    from capital_tpu_torch.robust import faultinject
    from capital_tpu_torch.robust.config import RobustConfig
    from capital_tpu_torch.utils import residual

    out = {}

    def cfg_for(dtype, bc=128, **kw):
        prec = "highest" if dtype == torch.float32 else None
        return qr.CacqrConfig(regime="1d", mode="pallas", precision=prec,
                              cholinv=cholesky.CholinvConfig(base_case_dim=bc, mode="pallas"), **kw)

    # ---- the QR flagship: 2,097,152 x 1024 bf16, g=8, plan 'full' ---------
    m, n = QR_SHAPES["flagship"]
    A = tall_randn(m, n, torch.bfloat16, 1, dev)
    cfg = cfg_for(torch.bfloat16)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg, predicted_qr_counts(n, 128, 2),
                                    "QR flagship")
    gates = qr_gates(residual, A, Q, R, "QR flagship")
    del Q, R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        Q = R = None  # free the previous result: peak memory of one factor
        Q, R = qr.factor(grid, A, cfg)
    end.record()
    end.synchronize()
    t = start.elapsed_time(end) / 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    del Q, R
    out["flagship"] = dict(m=m, n=n, dtype="bfloat16", g=qr_fused.pick_g(n), plan="full",
                           seconds=t, tflops=2.0 * m * n * n * 2 / t / 1e12, peak_bytes=peak,
                           seconds_first=secs, counts=counts, **gates)
    print(json.dumps({"qr": "flagship", **out["flagship"]}), flush=True)
    out["profile"] = profile(lambda: qr.factor(grid, A, cfg), "CQR::")
    print(json.dumps({"profile": "QR flagship", **out["profile"]}), flush=True)
    del A
    torch.cuda.empty_cache()

    # ---- 65536 x 512 f32, precision 'highest', g=4: also vs plain ---------
    m, n = QR_SHAPES["f32"]
    A = tall_randn(m, n, torch.float32, 2, dev)
    cfg = cfg_for(torch.float32)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg, predicted_qr_counts(n, 128, 2),
                                    "QR f32")
    gates = qr_gates(residual, A, Q, R, "QR f32")
    with plain_qr_versions(hopper, qr_fused):
        Qp, Rp = qr.factor(grid, A, cfg)
    dQ = float(residual.rel_fro(Q - Qp, Qp))
    dR = float(residual.rel_fro(R - Rp, Rp))
    # f32: the kernels and the plain versions sum in other orders; 1e-5
    check(dQ < 1e-5 and dR < 1e-5, f"QR f32 kernels vs plain: Q {dQ}, R {dR}")
    out["f32"] = dict(m=m, n=n, counts=counts, seconds_first=secs, vs_plain=[dQ, dR], **gates)
    print(json.dumps({"qr": "65536x512 f32", **out["f32"]}), flush=True)
    del A, Q, R, Qp, Rp

    # ---- 65536 x 4096 bf16: both grams through cholinv at bc=128 ----------
    (m, n), bc = QR_SHAPES["wide"], 128
    A = tall_randn(m, n, torch.bfloat16, 3, dev)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg_for(torch.bfloat16, bc),
                                    predicted_qr_counts(n, bc, 2), "QR wide gram")
    out["wide_gram"] = dict(m=m, n=n, bc=bc, counts=counts, seconds_first=secs,
                            **qr_gates(residual, A, Q, R, "QR wide gram"))
    print(json.dumps({"qr": "65536x4096 bf16", **out["wide_gram"]}), flush=True)
    del A, Q, R

    # ---- CQR1, 65536 x 1024 bf16: the sweep's tri_matmul trmm -------------
    m, n = QR_SHAPES["cqr1"]
    A = tall_randn(m, n, torch.bfloat16, 4, dev)
    (Q, R), counts, secs = drive_qr(qr, hopper, grid, A, cfg_for(torch.bfloat16, num_iter=1),
                                    predicted_qr_counts(n, 128, 1), "CQR1")
    out["cqr1"] = dict(m=m, n=n, counts=counts, seconds_first=secs,
                       **qr_gates(residual, A, Q, R, "CQR1"))
    print(json.dumps({"qr": "CQR1 65536x1024 bf16", **out["cqr1"]}), flush=True)
    del A, Q, R

    # ---- robust: 65536 x 1024 f32, rank-deficient gram injected -----------
    # exempt from the orthogonality gate: the corrupted gram no longer
    # describes A; the ladder's flags and a finite Q are the contract
    A = tall_randn(m, n, torch.float32, 5, dev)
    with faultinject.active_plan(faultinject.Fault(tag="CQR::gram", kind="rank_deficient")) as plan:
        (Q, R, ri), counts, secs = drive_qr(
            qr, hopper, grid, A, cfg_for(torch.float32, robust=RobustConfig()),
            lambda res: predicted_qr_counts(n, 128, 2, shifted=int(res[2].shifted)), "QR robust")
    info = {k: float(v) for k, v in ri._asdict().items()}
    check(info["breakdown"] >= 1 and info["shifted"] >= 1, f"QR robust: no breakdown seen {info}")
    check(bool(torch.isfinite(Q).all()), "QR robust: Q not finite")
    check(info["info"] in (0, n + 2), f"QR robust: info {info['info']}")
    check(plan.fired == [("CQR::gram", 0)], f"QR robust: fired {plan.fired}")
    out["robust"] = dict(m=m, n=n, counts=counts, seconds_first=secs, robust_info=info)
    print(json.dumps({"qr": "robust 65536x1024 f32", **out["robust"]}), flush=True)
    del A, Q, R
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from capital_tpu_torch import Grid
    from capital_tpu_torch.models import cholesky
    from capital_tpu_torch.ops import _build, hopper
    from capital_tpu_torch.utils import residual

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 is IEEE f32 throughout
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    build_s = _build.build()
    print(json.dumps({"env": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "build_s": round(build_s, 2)}), flush=True)
    for src, log in sorted(_build.build_logs().items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {src}: {line.strip()}")
    dev = torch.device("cuda")
    out = {"env": smi, "build_s": build_s, "kernels": {}, "factor": {}}

    # ---- phase 2: kernels against their plain versions -------------------
    for dtype in (torch.bfloat16, torch.float32):
        res = kernel_phase(hopper, dtype, dev)
        for name, r in res.items():
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
            print(json.dumps({"kernel": name, "dtype": str(dtype), **r}), flush=True)
        out["kernels"][str(dtype)] = res

    grid = Grid.square()

    # ---- phase 3a: n=16384 bf16, kernels against plain versions ----------
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, 16384, torch.bfloat16, 512, None)
    with plain_versions(hopper):
        Rq, Riq = cholesky.factor(grid, A, cfg)
    torch.cuda.synchronize()
    dR = float(residual.rel_fro(R.float() - Rq.float(), Rq.float()))
    dRi = float(residual.rel_fro(Ri.float() - Riq.float(), Riq.float()))
    del Rq, Riq
    # bf16 tolerance: R is rounded to bf16 at every level; 2e-2 relative
    check(dR < 2e-2 and dRi < 2e-2, f"n=16384 bf16 kernels vs plain: {dR}, {dRi}")
    Af = A.float()
    res_r = float(residual.cholesky_residual(Af, R.float()))
    res_i = float(residual.cholesky_inverse_residual(R.float(), Ri.float()))
    del Af
    # gates: bf16 keeps 8 significant bits (2^-8 ≈ 4e-3 per entry)
    check(res_r < 1e-2 and res_i < 1e-2, f"n=16384 bf16 residuals {res_r}, {res_i}")
    out["factor"]["n16384_bf16"] = dict(counts=counts, seconds_first=secs, vs_plain=[dR, dRi],
                                        residual=res_r, inverse_residual=res_i)
    print(json.dumps({"factor": "n=16384 bf16 bc=512", **out["factor"]["n16384_bf16"]}), flush=True)
    del R, Ri, A
    torch.cuda.empty_cache()

    # ---- phase 3b: n=8192 f32 -------------------------------------------
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, 8192, torch.float32, 256, "highest")
    res_r = float(residual.cholesky_residual(A, R))
    res_i = float(residual.cholesky_inverse_residual(R, Ri))
    # f32 gates (the reference's f32 class, ~1e-6), with room for n=8192
    check(res_r < 5e-6 and res_i < 5e-6, f"n=8192 f32 residuals {res_r}, {res_i}")
    out["factor"]["n8192_f32"] = dict(counts=counts, seconds_first=secs,
                                      residual=res_r, inverse_residual=res_i)
    print(json.dumps({"factor": "n=8192 f32 bc=256", **out["factor"]["n8192_f32"]}), flush=True)
    del R, Ri, A
    torch.cuda.empty_cache()

    # ---- phase 3c: the n=49152 bf16 flagship, bc=384 ---------------------
    n, bc = 49152, 384
    R, Ri, A, cfg, counts, secs = drive(cholesky, hopper, grid, n, torch.bfloat16, bc, None)
    path_counts = counts
    del R, Ri
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 2
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        R = Ri = None  # free the previous result: peak memory of one factor
        R, Ri = cholesky.factor(grid, A, cfg)
    end.record()
    end.synchronize()
    t = start.elapsed_time(end) / 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    v = torch.randn(n, 4, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    pr = float(residual.cholesky_probe_residual(A, R, v))
    pi = float(residual.inverse_probe_residual(R, Ri, v))
    check(pr < 1e-2 and pi < 1e-2, f"flagship probe residuals {pr}, {pi}")
    flag = dict(n=n, bc=bc, dtype="bfloat16", seconds=t, tflops=(2 * n**3 / 3) / t / 1e12,
                peak_bytes=peak, probe_residual=pr, probe_inverse_residual=pi,
                seconds_first=secs, counts=path_counts, card=smi)
    out["factor"]["flagship"] = flag
    print(json.dumps({"factor": "flagship", **flag}), flush=True)
    del R, Ri
    out["profile"] = profile(lambda: cholesky.factor(grid, A, cfg), "CI::")
    print(json.dumps({"profile": "flagship", **out["profile"]}), flush=True)
    del A

    missing = [k for k in PATH_KERNELS if path_counts.get(k, 0) < 1]
    check(not missing, f"kernels of the path never launched: {missing}")

    # ---- phase 4: the CholeskyQR2 kernels against their plain versions ----
    from capital_tpu_torch.ops import qr_fused

    for run, dtype in (("flagship", torch.bfloat16), ("f32", torch.float32)):
        m, n = QR_SHAPES[run]
        res = qr_kernel_phase(qr_fused, m, n, dtype, dev)
        for name, r in res.items():
            b, by = r.pop("bound")
            r.update(bound_ms=b, bound_by=by)
            print(json.dumps({"kernel": name, "dtype": str(dtype), **r}), flush=True)
        out["kernels"][str(dtype)].update(res)

    # ---- phase 5: the CholeskyQR2 path ------------------------------------
    out["qr"] = qr_path(hopper, dev, grid)
    qr_counts = out["qr"]["flagship"]["counts"]
    missing = [k for k in QR_KERNELS if qr_counts.get(k, 0) < 1]
    check(not missing, f"kernels of the QR path never launched: {missing}")

    bf = out["kernels"][str(torch.bfloat16)]
    launches = {**{k: path_counts[k] for k in PATH_KERNELS}, **{k: qr_counts[k] for k in QR_KERNELS}}
    line = {"kernels": [
        {"name": k, "route": hopper.KERNELS[k].route, "source": hopper.KERNELS[k].source,
         "replaces": hopper.KERNELS[k].replaces, "launches": launches[k],
         "max_abs_err": bf[k]["max_abs_err"], "ms": bf[k]["ms"], "plain_ms": bf[k]["plain_ms"],
         "bound_ms": bf[k]["bound_ms"], "bound_by": bf[k]["bound_by"],
         "library_ms": bf[k]["library_ms"]}
        for k in PATH_KERNELS + QR_KERNELS
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
