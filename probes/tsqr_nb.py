"""The blocked TSQR panel kernel against its column-block width, its thread
count and the column-sweep kernel it replaced, on the card.

    python3 probes/tsqr_nb.py

Builds copies of capital_tpu_torch/ops/csrc under build/probes/tsqr_nb/
beside the tree's own build: 'nb16' is the tree's tsqr.cu (column blocks of
16, 256 threads), 'nb8' sets the block width `PNB` to 8 (32 does not
fit: its tile and workspaces outgrow one block at 256 x 128, and its rows
would not lie in one register slot a row group), 'nb16 512t' sets the
threads `PNT` to 512, 'sweep' puts back the column-sweep kernel
(probes/tsqr_sweep.cu), and 'phases' is the tree's kernel with clock64()
stamps of block 0's thread 0 after each barrier (`STAMPS`), summed by
phase over the kernel.  Every variant is held to
`tsqr.panel_qr_plain` (f32 1e-5 of scale, bf16 one ulp more; R exactly
upper triangular, a zero panel's R zero) at the shapes in `CHECK`, then
timed, interleaved (v0 .. vN, vN .. v0) — a variant whose tile does not fit
one block says so and drops out: the QR flagship's 8192 leaf
panels of 256 x 128 f32, one panel alone (the latency of the tree's top
levels, which run fewer panels than the card has SMs) and 64 panels.  One
JSON line per variant, its ptxas register and spill lines first, then
block 0's cycles by phase at 8192 panels and at one.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, tsqr  # noqa: E402

SRC = "tsqr.cu"
NB = ("constexpr int PNB = 16;", "constexpr int PNB = {};")
NT = ("constexpr int PNT = 256;", "constexpr int PNT = {};")
#: each variant: its text replacements in tsqr.cu
VARIANTS = {
    "nb16": (),
    "nb8": ((NB[0], NB[1].format(8)),),
    "nb16 512t": ((NT[0], NT[1].format(512)),),
    "sweep": (),
    "phases": (),
}
STAMP = """
__device__ long long g_cyc[16];
__device__ long long g_last;
#define PT_START do { if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64(); } while (0)
#define PT(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const long long t_ = clock64(); \\
  g_cyc[i] += t_ - g_last; g_last = t_; } } while (0)
"""
#: (anchor in the tree's tsqr.cu, the stamp inserted after it); the slots
#: are PHASES, summed over the column blocks
STAMPS = (
    ('#include "common.cuh"\n', STAMP),
    ("  const long long b = blockIdx.x;\n", "  PT_START;\n"),
    ("load_in(P, dt, (b * p + r) * n + c) : 0.f;\n  }\n  __syncthreads();\n", "  PT(0);\n"),
    ("    const int j = j0 + jj;\n", "    PT(12);\n"),
    ("    if (gd == jj) xb[c] = dreg;\n", "    PT(10);\n"),
    ("    __syncthreads();\n    float s = 0.f, d = 0.f;\n", "    PT(11);\n"),
    ("    panel_factor<RPT>(W, ld, p, j0, w, red, redx, Zs, rd);\n    __syncthreads();\n", "    PT(1);\n"),
    ("    if (trailing) S = product_vtw(W, ld, p, j0, j0 + w, j0 + w, n4, Y);\n    __syncthreads();\n", "    PT(2);\n"),
    ("    sum_slices(VT, prow, j0 + w, j0 + w, j0 + w, n4, S, Y);\n    __syncthreads();\n", "    PT(3);\n"),
    ("    product_uy(W, ld, UT, prow, j0, j0 + w, j0 + w, n4, Y);\n    __syncthreads();\n", "    PT(4);\n"),
    ("  __syncthreads();  // R is read out before Q overwrites it\n", "  PT(5);\n"),
    ("    const int S = c1 < n4 ? product_vtw(W, ld, p, j0, c1, j0, n4, Y) : 1;\n    __syncthreads();\n", "    PT(6);\n"),
    ("      if (c < w) W[r * ld + j0 + c] = 0.f;\n    }\n    __syncthreads();\n", "    PT(7);\n"),
    ("    product_uy(W, ld, UT, prow, j0, j0, j0 + w, n4, Y);\n    __syncthreads();\n", "    PT(8);\n"),
    ("      else store_out(Q, dt, (b * p + r) * n + c, W[r * ld + c]);\n    }\n", "  __syncthreads();\n  PT(9);\n"),
)
PHASES = ("load", "panel: store-back", "T, V copy, VᵀW", "V·Tᵀ, Y sum", "W −= U·Y", "R store",
          "Q: V copy, VᵀQ", "Q: V·T, Y sum", "Q −= U·Y", "Q store", "column: sums, shuffles",
          "column: barrier", "column: reflector, update")
CHECK = ((4, 256, 128), (3, 40, 17), (3, 80, 40), (3, 100, 100), (3, 256, 128), (3, 17, 17))
TIMED = {"8192 x 256x128": (8192, 256, 128), "1 x 256x128": (1, 256, 128), "64 x 256x128": (64, 256, 128)}


def build_variants(root: Path) -> dict:
    """The tree's build, then each variant's tsqr.cu compiled in parallel;
    returns each variant's `_build._Kernels` (the other sources shared with
    the tree's)."""
    _build.build()
    tree = _build._STATE
    states, procs = {}, {}
    for name, subs in VARIANTS.items():
        d = root / name.replace(" ", "_")
        csrc = d / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        if name == "sweep":
            shutil.copy(Path(__file__).with_name("tsqr_sweep.cu"), csrc / SRC)
        if name == "phases":
            text = (csrc / SRC).read_text()
            for anchor, stamp in STAMPS:
                assert text.count(anchor) == 1, anchor
                text = text.replace(anchor, anchor + stamp)
            (csrc / SRC).write_text(text + (
                '\nextern "C" int probe_cycles(long long* out) {\n'
                '  static const long long zero[16] = {0};\n'
                '  const cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));\n'
                '  return e ? (int)e : (int)cudaMemcpyToSymbol(g_cyc, zero, sizeof(zero));\n}\n'))
        for old, new in subs:
            text = (csrc / SRC).read_text()
            assert text.count(old) == 1, old
            (csrc / SRC).write_text(text.replace(old, new))
        lib = d / "tsqr.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        st = _build._Kernels()
        st.libs = dict(tree.libs)
        st.libs[SRC] = ctypes.CDLL(str(lib))
        for fn, (src, argtypes) in _build.SIGNATURES.items():
            if src == SRC:
                f = getattr(st.libs[SRC], fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
        st.logs = {SRC: log}
        states[name] = st
        lines = [ln.strip() for ln in log.splitlines()
                 if "Function properties" in ln or "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": lines}), flush=True)
    return states


def panels(shape, seed, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    P = torch.randn(shape, generator=g, device=dev)
    if shape[0] > 2:
        P[0, :, 3] = 0
        P[1] = 0
        if shape[2] > 16:
            P[2, :, 15] = 0
            P[2, :, 16] = 0
    return P


def check(P) -> tuple[bool, float]:
    Q, R = tsqr.panel_qr(P)
    Qq, Rq = tsqr.panel_qr_plain(P)
    worst, ok = 0.0, True
    for got, want in ((Q, Qq), (R, Rq)):
        err = (got.double() - want.double()).abs()
        tol = 1e-5 * float(want.double().abs().max())
        if P.dtype == torch.bfloat16:
            tol = tol + 2.0**-7 * want.double().abs()
        ok &= bool((err <= tol).all())
        worst = max(worst, float(err.max()))
    ok &= bool((torch.tril(R, -1) == 0).all())
    if P.shape[0] > 2:
        ok &= not bool(R[1].any())
    return ok, worst


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("tsqr_nb: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "tsqr_nb"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    ok = True
    for name, st in list(states.items()):
        _build._STATE = st
        try:
            tsqr.panel_qr(panels(TIMED["1 x 256x128"], 1, dev))
        except RuntimeError as e:  # the variant's tile does not fit one block
            print(json.dumps({"variant": name, "launch": str(e)[:200]}), flush=True)
            del states[name]
            continue
        worst, good = 0.0, True
        for i, shape in enumerate(CHECK):
            for dt in (torch.float32, torch.bfloat16):
                g, w = check(panels(shape, 10 + i, dev).to(dt))
                good &= g
                worst = max(worst, w) if dt == torch.float32 else worst
                if not g:
                    print(json.dumps({"variant": name, "FAIL": shape, "dtype": str(dt)}), flush=True)
        ok &= good
        print(json.dumps({"variant": name, "max_abs_err_vs_plain_f32": worst, "ok": good}), flush=True)
    if not ok:
        return 1
    cases = {c: panels(shape, 3, dev) for c, shape in TIMED.items()}
    order = [name for name in states if name != "phases"]
    res = {name: {c: [] for c in cases} for name in order}
    for name in order + order[::-1]:
        _build._STATE = states[name]
        for c, P in cases.items():
            res[name][c].append(time_ms(lambda: tsqr.panel_qr(P), 3 if P.shape[0] > 1000 else 20))
    for name, r in res.items():
        print(json.dumps({"variant": name, **{c: sum(v) / len(v) for c, v in r.items()}, "runs": r}), flush=True)
    _build._STATE = states["phases"]
    read = states["phases"].libs[SRC].probe_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    for c in ("8192 x 256x128", "1 x 256x128"):
        buf = (ctypes.c_longlong * 16)()
        tsqr.panel_qr(cases[c])
        torch.cuda.synchronize()
        assert read(buf) == 0  # reads and clears
        tsqr.panel_qr(cases[c])
        torch.cuda.synchronize()
        assert read(buf) == 0
        cyc = {PHASES[i]: buf[i] for i in range(len(PHASES))}
        print(json.dumps({"phases": c, "block0_cycles": cyc, "total": sum(cyc.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
