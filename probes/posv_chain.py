"""The fused small-N posv (`batched_small.posv`) and the chain's factor steps
(`blocktri_small.fused_forward_step`, `factor_step`) against the kernels they
replaced, on the card.

    python3 probes/posv_chain.py

Builds copies of capital_tpu_torch/ops/csrc under build/probes/posv_chain/
beside the tree's own build, all in one process:
  * 'replaced': the column-sweep posv kernel and its C entry put back into
    batched_small.cu (`OLD_POSV`, `OLD_POSV_ENTRY`: the factor in an odd-ld
    tile, chol_sweep, fwd_sweep, bwd_sweep);
  * 'posv_inline': the tree's posv with its two halves (posv_factor,
    posv_solve) inlined into one kernel body (`POSV_INLINE`), which spills
    under the three-blocks-an-SM register cap;
  * 'phases': the tree's blocktri_small.cu with clock64() stamps of block
    0's thread 0 around each chain block's three parts — Wt = L⁻¹·Cᵀ, the
    Schur update S = D − Wtᵀ·Wt, the factor (scan, Cholesky, any fault
    path) — summed over the chain blocks, on both routes.
The chain kernels the blocked route replaced are the tree's 'sweep' route
(route code 0 of the C entries, `chip_smoke.bt_sweep_route`): the column-sweep
factor block, with its row scan and NaN pattern as functions of their own
(scan_rows, nan_pattern), in odd-ld tiles.  Every case is held to the
replaced kernel bit for bit (X and info of posv; L, Wt, y and info of both
chain steps; NaN patterns included): posv at 8 x n x k for n in {7, 33, 128},
k in {1, 8, 128}, and at 8192 x 128 x 8, f32 and bf16, with faults in one
problem of four; the chain steps at 8 x 8 x 128 x 1, 8 x 8 x 128 x 64,
16 x 7 x 16 x 34 and 3 x 5 x 37 x 3, f32 and bf16, with a fault in one chain
block.  Then the variants are timed in turns (v0 .. vN, vN .. v0), wall by
CUDA events and device time from a torch.profiler trace: posv on each of its
three, beside potrf + potrs of the same problem, at 8192 x 128 x 8,
8 x 128 x 8 and 8 x 128 x 128 f32; the chain steps on both routes at
8 x 8 x 128 x 1 and 16 x 7 x 16 x 34 f32.  Prints the ptxas register and
spill lines of both sources per variant, one JSON line per check and case,
and block 0's cycles by part of a chain block on each route.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from capital_tpu_torch.ops import _build, batched_small, blocktri_small  # noqa: E402

SMALL, CHAIN = "batched_small.cu", "blocktri_small.cu"
#: the posv kernel the blocked one replaced
OLD_POSV = """template <typename T>
__device__ void load_tile(float* dst, int ldd, const T* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ldd + c] = widen(src[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) posv_kernel(const T* A, const T* B, T* X, int* info, int n, int k) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* S = smem;
  float* Y = smem + n * ld;
  const long long b = blockIdx.x;
  load_tile(S, ld, A + b * n * n, n, n);
  load_tile(Y, k, B + b * n * k, n, k);
  __syncthreads();
  // both uplo conventions run the same arithmetic: L (lower) = Rᵀ
  const int inf = chol_sweep(S, ld, n);
  fwd_sweep(S, ld, false, Y, k, n, k);
  bwd_sweep(S, ld, false, Y, k, n, k);
  store_tile(X + b * n * k, Y, k, n, k);
  if (threadIdx.x == 0) info[b] = inf;
}

"""
OLD_POSV_ENTRY = """static size_t tile_bytes(int n) { return sizeof(float) * (size_t)n * odd_ld(n); }

extern "C" int capital_small_posv(int dtype, const void* A, const void* B, void* X, void* info, int batch,
                                  int n, int k, void* stream) {
  if (n < 1 || k < 0) return -1;
  const size_t smem = tile_bytes(n) + sizeof(float) * (size_t)n * k;
  if (dtype == DT_F32)
    return run<posv_kernel<float>>(batch, smem, stream, (const float*)A, (const float*)B, (float*)X,
               (int*)info, n, k);
  if (dtype == DT_BF16)
    return run<posv_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (const bf16*)B, (bf16*)X,
               (int*)info, n, k);
  return -1;
}

"""
#: the tree's posv halves and kernel, from their comment to the next function
POSV_SPAN = ("// posv's two halves, each kept out of line", "// R = R2·R1 (both upper)")
#: the same kernel in one body
POSV_INLINE = """template <typename T>
__global__ void __launch_bounds__(NT, 3) posv_kernel(const T* A, const T* B, T* X, int* info, int n, int k, int ld,
                                                  int ldy) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* Y = S + round4(n) * ld;
  const long long b = blockIdx.x;
  const T* a = A + b * n * n;
  zero_pad(S, ld, n);
  load_rhs(Y, ldy, B + b * n * k, n, k);
  const bool finite = !__syncthreads_or(load_rows(S, ld, a, n));
  int inf = finite ? chol_blocked(S, ld, n) : -1;
  if (inf < 0) {
    if (finite) {
      zero_pad(S, ld, n);
      load_rows(S, ld, a, n);
      __syncthreads();
    }
    inf = chol_sweep(S, ld, n);
    mirror_lower(S, ld, n);
  }
  if (threadIdx.x == 0) info[b] = inf;
  fwd_blocked<true>(S, ld, n, Y, ldy, k);
  bwd_upper_blocked<true, true>(S, ld, n, Y, ldy, k);
  store_rhs(X + b * n * k, Y, ldy, n, k);
}

"""
#: (before, after) text of the stamps in each chain source: t0 after the
#: loads' barrier, t1 after Wt, t2 after the Schur update's barrier, the
#: sums just before the block's return
STAMP_SUM = ("  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
             "    g_cyc[0] += t1 - t0; g_cyc[1] += t2 - t1; g_cyc[2] += clock64() - t2; g_cyc[3] += 1;\n  }\n")
NEW_STAMPS = (
    ("  load_rows(S, ld, d, b);\n  __syncthreads();\n  fwd_blocked<true>(P, ld, b, W, ld, b);\n"
     "  schur_update(W, S, ld, b);\n  __syncthreads();\n",
     "  load_rows(S, ld, d, b);\n  __syncthreads();\n  const long long t0 = clock64();\n"
     "  fwd_blocked<true>(P, ld, b, W, ld, b);\n  const long long t1 = clock64();\n"
     "  schur_update(W, S, ld, b);\n  __syncthreads();\n  const long long t2 = clock64();\n"),
    ("    mirror_lower(S, ld, b);\n  }\n  return info;\n",
     "    mirror_lower(S, ld, b);\n  }\n" + STAMP_SUM + "  return info;\n"),
)
OLD_STAMPS = (
    ("  load_tile(S, ld, d, b);\n  __syncthreads();\n  fwd_sweep(P, ld, false, W, ld, b, b);  // Wt = L_{i−1}⁻¹·Cᵀ\n",
     "  load_tile(S, ld, d, b);\n  __syncthreads();\n  const long long t0 = clock64();\n"
     "  fwd_sweep(P, ld, false, W, ld, b, b);  // Wt = L_{i−1}⁻¹·Cᵀ\n  const long long t1 = clock64();\n"),
    ("  __syncthreads();\n  const int anybad = scan_rows(S, ld, b, rowbad);\n  const int info = chol_sweep",
     "  __syncthreads();\n  const long long t2 = clock64();\n"
     "  const int anybad = scan_rows(S, ld, b, rowbad);\n  const int info = chol_sweep"),
    ("  if (anybad) nan_pattern(S, ld, b, rowbad);\n  return info;\n",
     "  if (anybad) nan_pattern(S, ld, b, rowbad);\n" + STAMP_SUM + "  return info;\n"),
)
PARTS = ("Wt", "schur", "factor")
PROBE_FNS = ('\nextern "C" int probe_cycles(long long* out) '
             '{ return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); }\n'
             'extern "C" int probe_reset(const long long* in) '
             '{ return (int)cudaMemcpyToSymbol(g_cyc, in, sizeof(g_cyc)); }\n')
POSV_VARIANTS = ("replaced", "tree", "posv_inline")
POSV_CHECK = [(8, 7, 1), (8, 7, 128), (8, 33, 8), (8, 33, 128), (8, 128, 1), (8, 128, 8), (8, 128, 128),
              (8192, 128, 8)]
CHAIN_CHECK = [(8, 8, 128, 1), (8, 8, 128, 64), (16, 7, 16, 34), (3, 5, 37, 3)]
POSV_TIMED = {"throughput 8192x128x8": (8192, 128, 8), "latency 8x128x8": (8, 128, 8),
              "inv 8x128x128": (8, 128, 128)}
CHAIN_TIMED = {"8x8x128x1": (8, 8, 128, 1), "16x7x16x34": (16, 7, 16, 34)}
#: the chain steps' variants: the replaced kernels (route 0) and the tree's
#: blocked route (the wrappers)
CHAIN_VARIANTS = ("replaced", "tree")
CHAIN_STEPS = {"fused_forward_step": "bt.fused_forward", "factor_step": "bt.factor"}


def replaced_small(text: str) -> str:
    i = text.index("// One problem a block, the factor never in device memory")
    j = text.index("// R = R2·R1 (both upper)")
    text = text[:i] + text[j:]
    i = text.index("// ---------------------------------------------------------------------------\n// lstsq:")
    text = text[:i] + OLD_POSV + text[i:]
    i = text.index('extern "C" int capital_small_posv(')
    j = text.index("// lstsq's shared memory (floats)")
    return text[:i] + OLD_POSV_ENTRY + text[j:]


def posv_inline(text: str) -> str:
    i, j = text.index(POSV_SPAN[0]), text.index(POSV_SPAN[1])
    return text[:i] + POSV_INLINE + text[j:]


def chain_step(step: str, variant: str, args):
    """A chain step on the replaced kernel (the sweep route) or the tree's."""
    if variant == "replaced":
        return chip_smoke.bt_sweep_route(CHAIN_STEPS[step], args)
    return getattr(blocktri_small, step)(*args)


def stamped(stamps):
    def edit(text: str) -> str:
        for old, new in stamps:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        text = text.replace("using namespace small;\n", "using namespace small;\n__device__ long long g_cyc[4];\n", 1)
        return text + PROBE_FNS
    return edit


def build_variants(root: Path) -> dict:
    _build.build()
    tree = _build._STATE
    for src in (SMALL, CHAIN):  # this process's build log, else the one the build left on disk
        log = tree.logs.get(src) or (_build.build_dir() / (Path(src).stem + ".log")).read_text()
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": "tree", "source": src, "ptxas": lines}), flush=True)
    edits = {"replaced": {SMALL: replaced_small},
             "posv_inline": {SMALL: posv_inline},
             "phases": {CHAIN: stamped(NEW_STAMPS + OLD_STAMPS)}}
    procs = {}
    for name, files in edits.items():
        csrc = root / name / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        for src, edit in files.items():
            (csrc / src).write_text(edit((csrc / src).read_text()))
            lib = root / name / (Path(src).stem + ".so")
            cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / src)]
            procs[(name, src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                   text=True), lib)
    states = {"tree": tree}
    for (name, src), (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name} {src}: nvcc failed\n{log[-3000:]}")
        st = states.get(name)
        if st is None:
            st = states[name] = _build._Kernels()
            st.libs = dict(tree.libs)
        st.libs[src] = ctypes.CDLL(str(lib))
        for fn, (s, argtypes) in _build.SIGNATURES.items():
            if s == src:
                f = getattr(st.libs[src], fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "source": src, "ptxas": lines}), flush=True)
    return states


def posv_operands(shape, dt, seed, dev, faults: bool):
    b, n, k = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((b, n, n), generator=g, device=dev)
    A = X @ X.mT / n + 3.0 * torch.eye(n, device=dev)
    B = torch.randn((b, n, k), generator=g, device=dev)
    if faults:
        A[1, n // 2, n // 3] = float("nan")
        A[2, 0, n - 1] = float("inf")
        A[3, min(20, n - 1), min(20, n - 1)] = -1.0
        A[4, n - 1, n - 1] = float("nan")
    return A.to(dt), B.to(dt)


def chain_operands(shape, dt, seed, dev, fault: str):
    batch, seg, b, k = shape
    D, C, B, Lc, yc = chip_smoke.bt_operands(batch, seg, b, k, torch.float32, seed, dev)
    if fault == "nan":
        D[1, 2, 5 % b, 3 % b] = float("nan")
    elif fault == "indefinite":
        D[1, 2] = torch.eye(b, device=dev)
        D[1, 2, b // 2, b // 2] = -5.0
        C[1, 2] = 0
    return [t.to(dt) for t in (D, C, B, Lc, yc)]


def run_with(states, name, fn):
    _build._STATE = states[name]
    out = fn()
    torch.cuda.synchronize()
    return out


def checks(states, dev) -> bool:
    ok = True
    for i, shape in enumerate(POSV_CHECK):
        for dt in (torch.float32, torch.bfloat16):
            A, B = posv_operands(shape, dt, 40 + i, dev, faults=True)
            got = {v: run_with(states, v, lambda: batched_small.posv(A, B)) for v in POSV_VARIANTS}
            same = all(chip_smoke.same_bits(x, y) for v in POSV_VARIANTS for x, y in zip(got[v], got["replaced"]))
            ok &= same
            print(json.dumps({"check": "posv", "shape": list(shape), "dtype": str(dt),
                              "info": got["tree"][1][:6].tolist(), "bitwise_vs_replaced": same}), flush=True)
    for i, shape in enumerate(CHAIN_CHECK):
        for dt in (torch.float32, torch.bfloat16):
            for fault in ("none", "nan", "indefinite"):
                D, C, B, Lc, yc = chain_operands(shape, dt, 50 + i, dev, fault)
                for step, args in (("fused_forward_step", (D, C, B, Lc, yc)), ("factor_step", (D, C, Lc))):
                    got = {v: run_with(states, "tree", lambda: chain_step(step, v, args))
                           for v in CHAIN_VARIANTS}
                    same = all(chip_smoke.same_bits(x, y) for x, y in zip(got["tree"], got["replaced"]))
                    ok &= same
                    print(json.dumps({"check": step, "shape": list(shape), "dtype": str(dt), "fault": fault,
                                      "route": blocktri_small.chain_route(shape[2]),
                                      "info_problem_1": got["tree"][-1][1].tolist(),
                                      "bitwise_vs_replaced": same}), flush=True)
    _build._STATE = states["tree"]
    return ok


def timings(states, dev) -> None:
    posv = {}
    for c, shape in POSV_TIMED.items():
        A, B = posv_operands(shape, torch.float32, 5, dev, faults=False)
        it = 3 if shape[0] > 100 else 50
        posv["posv " + c] = (lambda v, A=A, B=B: batched_small.posv(A, B), it)
        posv["potrf + potrs " + c] = (lambda v, A=A, B=B: batched_small.potrs(batched_small.potrf(A)[0], B), it)
    turns(posv, POSV_VARIANTS, lambda v: states[v])
    cases = {}
    for c, shape in CHAIN_TIMED.items():
        D, C, B, Lc, yc = chain_operands(shape, torch.float32, 6, dev, "none")
        for step, args in (("fused_forward_step", (D, C, B, Lc, yc)), ("factor_step", (D, C, Lc))):
            cases[f"{step} {c}"] = (lambda v, step=step, args=args: chain_step(step, v, args), 5)
    turns(cases, CHAIN_VARIANTS, lambda v: states["tree"])


def turns(cases, order, state) -> None:
    """Each case on each variant in turns (v0 .. vN, vN .. v0), variant v
    run as cases[c][0](v) under the build `state(v)`: mean wall of the two
    readings, device time from the first turn's trace."""
    order = list(order)
    res = {c: {v: [] for v in order} for c in cases}
    dev_ms = {c: {} for c in cases}
    for turn, v in enumerate(order + order[::-1]):
        _build._STATE = state(v)
        for c, (fn, it) in cases.items():
            res[c][v].append(chip_smoke.time_ms(lambda: fn(v), it))
            if turn < len(order):
                dev_ms[c][v] = chip_smoke.device_ms(lambda: fn(v), it)
    for c in cases:
        print(json.dumps({"case": c, **{v: sum(r) / len(r) for v, r in res[c].items()}, "runs": res[c],
                          "device_ms": dev_ms[c]}), flush=True)
    _build._STATE = state("tree")


def phases(states, dev) -> None:
    D, C, _, Lc, _ = chain_operands((8, 8, 128, 1), torch.float32, 7, dev, "none")
    _build._STATE = states["phases"]
    lib = states["phases"].libs[CHAIN]
    read, reset = lib.probe_cycles, lib.probe_reset
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    reset.argtypes, reset.restype = [ctypes.c_void_p], ctypes.c_int
    zero = (ctypes.c_longlong * 4)()
    for v in CHAIN_VARIANTS:
        chain_step("factor_step", v, (D, C, Lc))
        torch.cuda.synchronize()
        assert reset(zero) == 0
        chain_step("factor_step", v, (D, C, Lc))
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 4)()
        assert read(buf) == 0
        blocks = max(buf[3], 1)
        print(json.dumps({"phases": v, "chain_blocks": buf[3],
                          "block0_cycles_per_chain_block": {PARTS[i]: buf[i] / blocks for i in range(3)}}),
              flush=True)
    _build._STATE = states["tree"]


def main() -> int:
    if not torch.cuda.is_available():
        print("posv_chain: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _build.build_dir().parent / "probes" / "posv_chain"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    if not checks(states, dev):
        print(json.dumps({"result": "FAIL: not bit for bit the replaced kernels"}), flush=True)
        return 1
    timings(states, dev)
    phases(states, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
