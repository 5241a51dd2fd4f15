"""The batched SPD solve from a ready factor (`batched_small.potrs`) against
the column-sweep kernel it replaced, on the card.

    python3 probes/potrs_variants.py

Builds copies of capital_tpu_torch/ops/csrc under
build/probes/potrs_variants/ beside the tree's own build: 'blocked' is the
tree's batched_small.cu; 'sweep' puts back the kernel and C entry the
blocked one replaced (`SWEEP_KERNEL`, `SWEEP_ENTRY`: the whole factor in an
odd-ld tile, fwd_sweep then bwd_sweep, one or two block barriers a
column); 'bounds2' and 'bounds1' are the tree's kernel under
__launch_bounds__(NT, 2) and (NT) — two blocks an SM, or one — where the
tree asks for three; 'phases' is the tree's kernel with a clock64() stamp
of block 0's thread 0 after each phase (`STAMPS`).  Every variant is held
to `potrs_plain` (f32 1e-5 of scale, bf16 one ulp more) and to 'sweep' bit
for bit, at 8 x 128 x 8, 8192 x 128 x 8 and 8 x 128 x 128, 'U' and 'L',
f32 and bf16; then the throughput batch 8192 x 128 x 8 f32, the serve
latency batch 8 x 128 x 8 and serve's inv shape 8 x 128 x 128 are timed
on each, interleaved (v0 .. vN, vN .. v0), wall by CUDA events and device
time from a torch.profiler trace, beside `torch.cholesky_solve` (wall and
device); the guaranteed posv at (8, 128, 8) f32 (one potrf and nine
potrs) on 'sweep' and 'blocked'; block 0's cycles by phase.  Prints every
ptxas register / spill line of batched_small.cu per variant (potrf, trsm,
posv and lstsq share the file), then one JSON line per variant and case.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from capital_tpu_torch.ops import _build, batched_small  # noqa: E402

SRC = "batched_small.cu"
#: the potrs kernel the blocked one replaced
SWEEP_KERNEL = """template <typename T>
__global__ void __launch_bounds__(NT) potrs_kernel(const T* Tm, const T* B, T* X, int n, int k, int upper) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* S = smem;
  float* Y = smem + n * ld;
  const long long b = blockIdx.x;
  load_tile(S, ld, Tm + b * n * n, n, n);
  load_tile(Y, k, B + b * n * k, n, k);
  __syncthreads();
  // 'U': S holds R = Lᵀ (upper-stored); 'L': S holds L
  fwd_sweep(S, ld, upper != 0, Y, k, n, k);
  bwd_sweep(S, ld, upper != 0, Y, k, n, k);
  store_tile(X + b * n * k, Y, k, n, k);
}

"""
SWEEP_ENTRY = """extern "C" int capital_small_potrs(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                   int k, int upper, void* stream) {
  if (n < 1 || k < 0) return -1;
  const size_t smem = tile_bytes(n) + sizeof(float) * (size_t)n * k;
  if (dtype == DT_F32)
    return run<potrs_kernel<float>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X, n, k, upper);
  if (dtype == DT_BF16)
    return run<potrs_kernel<bf16>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X, n, k, upper);
  return -1;
}

"""
#: the tree's kernel and its register bound
KERNEL_HEAD = "__launch_bounds__(NT, 3) potrs_kernel"
#: block 0's thread 0 reads clock64() at the kernel's start and after each
#: of these lines of its body (the loads and their barrier, the two solves,
#: the store)
STAMPS = ("  __syncthreads();\n", "  fwd_blocked<true>(S, ld, n, Y, ldy, k);\n",
          "  bwd_upper_blocked<true, true>(S, ld, n, Y, ldy, k);\n", "  store_rhs(X + b * n * k, Y, ldy, n, k);\n")
PHASES = ("load", "fwd", "bwd", "store")
#: inside the two solves (block 0's thread 0, summed over the panels):
#: (anchor that opens a panel, anchor after its diagonal step's barrier,
#: anchor after its tiles' barrier, first slot of g_cyc)
SOLVE_STAMPS = (
    ("    const int w = min(NB, n - k0);\n    for (int c = threadIdx.x; c < nc1 + nc2; c += NT) {",
     "    __syncthreads();\n    const int t0 = k0 + NB;\n    if (t0 >= n4) break;\n    for (int e = threadIdx.x; e < (n4 - t0)",
     "    __syncthreads();\n  }\n}\n\n// W·R = V in place on W", 5),
    ("    const int w = min(NB, n - k0);\n    for (int c = threadIdx.x; c < nc; c += NT) {",
     "    __syncthreads();\n    if (k0 == 0) break;\n    for (int e = threadIdx.x; e < k0 / 4 * cg; e += NT) {",
     "    __syncthreads();\n  }\n}\n\n// -----", 7),
)
SOLVE_PHASES = ("fwd diagonal", "fwd tiles", "bwd diagonal", "bwd tiles")
CHECK = [(8, 128, 8), (8192, 128, 8), (8, 128, 128)]
TIMED = {"throughput 8192x128x8": (8192, 128, 8), "latency 8x128x8": (8, 128, 8),
         "inv 8x128x128": (8, 128, 128)}


def sweep_source(text: str) -> str:
    i = text.index("// potrs: the blocked solves on the factor's live triangle")
    i = text.rindex("// ----", 0, i)
    j = text.index("// R = R2·R1 (both upper)")
    text = text[:i] + text[j:]
    i = text.index("// op(T)·X = B with one sweep")
    text = text[:i] + SWEEP_KERNEL + text[i:]
    i = text.index("// potrs' tile strides")
    j = text.index('extern "C" int capital_small_trsm(')
    return text[:i] + SWEEP_ENTRY + text[j:]


def bounds_source(blocks: int):
    def edit(text: str) -> str:
        assert text.count(KERNEL_HEAD) == 1
        head = f"__launch_bounds__(NT, {blocks}) potrs_kernel" if blocks > 1 else "__launch_bounds__(NT) potrs_kernel"
        return text.replace(KERNEL_HEAD, head)
    return edit


def phases_source(text: str) -> str:
    def stamp(i):
        return f"  if (blockIdx.x == 0 && threadIdx.x == 0) g_cyc[{i}] = clock64();\n"
    j = text.index("\n", text.index("extern __shared__", text.index(KERNEL_HEAD))) + 1
    text = text[:j] + stamp(0) + text[j:]
    for k, anchor in enumerate(STAMPS, 1):
        j = text.index(anchor, j) + len(anchor)
        text = text[:j] + stamp(k) + text[j:]
    for opens, diag, tiles, k in SOLVE_STAMPS:  # the stamps sit after a line, the timer at the panel's start
        for anchor, stamp_at in ((tiles, "    __syncthreads();\n"), (diag, "    __syncthreads();\n")):
            a = text.index(anchor) + len(stamp_at)
            slot = k + (anchor is tiles)
            start = "tp" if anchor is diag else "tq"
            text = (text[:a] + f"    if (blockIdx.x == 0 && threadIdx.x == 0) g_cyc[{slot}] += clock64() - {start};\n"
                    + ("    const long long tq = clock64();\n" if anchor is diag else "") + text[a:])
        a = text.index(opens)
        text = text[:a] + "    const long long tp = clock64();\n" + text[a:]
    text = text.replace("using namespace small;\n", "using namespace small;\n__device__ long long g_cyc[16];\n", 1)
    return text + ('\nextern "C" int probe_cycles(long long* out) '
                   '{ return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); }\n'
                   'extern "C" int probe_reset(const long long* in) '
                   '{ return (int)cudaMemcpyToSymbol(g_cyc, in, sizeof(g_cyc)); }\n')


def build_variants(root: Path) -> dict:
    _build.build()
    tree = _build._STATE
    states, procs = {}, {}
    for name, edit in (("blocked", None), ("sweep", sweep_source), ("bounds2", bounds_source(2)),
                       ("bounds1", bounds_source(1)), ("phases", phases_source)):
        csrc = root / name / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        if edit is not None:
            (csrc / SRC).write_text(edit((csrc / SRC).read_text()))
        lib = root / name / "batched_small.so"
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
        states[name] = st
        lines = [ln.strip() for ln in log.splitlines()
                 if "Function properties" in ln or "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": lines}), flush=True)
    return states


def operands(shape, seed, dev):
    b, n, k = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((b, n, n), generator=g, device=dev)
    A = X @ X.mT / n + 3.0 * torch.eye(n, device=dev)
    return A, torch.randn((b, n, k), generator=g, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("potrs_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "potrs_variants"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    ok = True
    for i, shape in enumerate(CHECK):
        A, B = operands(shape, 20 + i, dev)
        for dt in (torch.float32, torch.bfloat16):
            for uplo in ("U", "L"):
                R, _ = batched_small.potrf_plain(A.to(dt), uplo=uplo)
                Bd = B.to(dt)
                want = batched_small.potrs_plain(R, Bd, uplo=uplo)
                got = {}
                for name, st in states.items():
                    _build._STATE = st
                    got[name] = batched_small.potrs(R, Bd, uplo=uplo)
                    err = (got[name].double() - want.double()).abs()
                    tol = 1e-5 * float(want.double().abs().max())
                    if dt == torch.bfloat16:
                        tol = tol + 2.0**-7 * want.double().abs()
                    good = bool((err <= tol).all())
                    ok &= good
                    if not good:
                        print(json.dumps({"variant": name, "FAIL vs plain": shape, "dtype": str(dt),
                                          "uplo": uplo, "max_err": float(err.max())}), flush=True)
                same = all(torch.equal(x, got["sweep"]) for x in got.values())
                ok &= same
                print(json.dumps({"check": list(shape), "dtype": str(dt), "uplo": uplo,
                                  "bitwise_every_variant_vs_sweep": same}), flush=True)
    if not ok:
        return 1
    cases = {}
    for c, shape in TIMED.items():
        A, B = operands(shape, 5, dev)
        R, _ = batched_small.potrf_plain(A, uplo="U")
        cases[c] = (R, B)
    timed = ["sweep", "blocked", "bounds2", "bounds1"]
    res = {name: {c: [] for c in cases} for name in timed}
    dev_ms = {name: {} for name in timed}
    for turn, name in enumerate(timed + timed[::-1]):
        _build._STATE = states[name]
        for c, (R, B) in cases.items():
            it = 5 if R.shape[0] > 100 else 50
            res[name][c].append(chip_smoke.time_ms(lambda: batched_small.potrs(R, B), it))
            if turn < len(timed):
                dev_ms[name][c] = chip_smoke.device_ms(lambda: batched_small.potrs(R, B), it)
    for name in timed:
        print(json.dumps({"variant": name, **{c: sum(v) / len(v) for c, v in res[name].items()},
                          "runs": res[name], "device_ms": dev_ms[name]}), flush=True)
    lib = {}
    for c, (R, B) in cases.items():
        it = 5 if R.shape[0] > 100 else 50
        lib[c] = dict(ms=chip_smoke.time_ms(lambda: torch.cholesky_solve(B, R, upper=True), it),
                      device_ms=chip_smoke.device_ms(lambda: torch.cholesky_solve(B, R, upper=True), it))
    print(json.dumps({"library": "cholesky_solve", **lib}), flush=True)
    from capital_tpu_torch.serve import api
    A, B = operands((8, 128, 8), 6, dev)
    run = api.batched("posv", "highest", "auto", tier="guaranteed")
    g = {name: [] for name in timed[:2]}
    for name in timed[:2] + timed[1::-1]:
        _build._STATE = states[name]
        g[name].append(chip_smoke.time_ms(lambda: run(A, B), 10))
    print(json.dumps({"guaranteed posv 8x128x8": {k: sum(v) / len(v) for k, v in g.items()}, "runs": g}),
          flush=True)
    _build._STATE = states["phases"]
    read = states["phases"].libs[SRC].probe_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    reset = states["phases"].libs[SRC].probe_reset
    reset.argtypes, reset.restype = [ctypes.c_void_p], ctypes.c_int
    zero = (ctypes.c_longlong * 16)()
    for c, (R, B) in cases.items():
        buf = (ctypes.c_longlong * 16)()
        batched_small.potrs(R, B)
        torch.cuda.synchronize()
        assert reset(zero) == 0
        batched_small.potrs(R, B)
        torch.cuda.synchronize()
        assert read(buf) == 0
        cyc = list(buf)
        print(json.dumps({"phases": c, "block0_cycles": {PHASES[i]: cyc[i + 1] - cyc[i] for i in range(4)},
                          "total": cyc[4] - cyc[0],
                          "inside_the_solves": {SOLVE_PHASES[i]: cyc[5 + i] for i in range(4)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
