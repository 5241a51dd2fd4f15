"""The fused small-N least squares (`batched_small.lstsq`) against the
column-sweep kernel it replaced, with the new kernel's cycles by phase, on
the card.

    python3 probes/lstsq_variants.py

Builds copies of capital_tpu_torch/ops/csrc under
build/probes/lstsq_variants/ beside the tree's own build: 'blocked' is the
tree's batched_small.cu; 'sweep' puts back the kernel and C entry the
blocked one replaced (`SWEEP_KERNEL`, `SWEEP_ENTRY`: a 16-row stage added
into shared memory, column sweeps with a barrier a column); 'phases' is the
tree's kernel with a clock64() stamp of block 0's thread 0 after each
phase (`STAMPS`).  Every variant is held to `lstsq_plain` (1e-4 of scale;
info equal, over NaN / inf and exactly rank-deficient problems), then the
throughput batch 2048 x 512 x 128 x 8 f32 and the serve latency batch
8 x 512 x 128 x 8 are timed on each, interleaved (v0 .. vN, vN .. v0).
Prints every ptxas register / spill line of batched_small.cu per variant
(potrf, potrs, posv and trsm share the file), then one JSON line per
variant, then block 0's cycles by phase at both batches.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from capital_tpu_torch.ops import _build, batched_small  # noqa: E402

SRC = "batched_small.cu"
#: the lstsq kernel the blocked one replaced (SWEEP_ROWS was LSTSQ_ROWS, 16)
SWEEP_KERNEL = """constexpr int SWEEP_ROWS = 16;

template <typename T>
__global__ void __launch_bounds__(NT) lstsq_kernel(const T* A, const T* B, T* X, int* info, int m, int n, int k) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n), lds = n + k;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  float* P = smem;           // G's copy, then L1 (R1 = L1ᵀ) in its lower triangle
  float* Q = P + n * ld;     // G -> V -> G2 -> L2 (lower) and R = R2·R1 (upper)
  float* C = Q + n * ld;     // AᵀB -> t1 -> t2 -> X
  float* st = C + n * k;     // SWEEP_ROWS x (n + k) stage of [A | B] rows
  const long long b = blockIdx.x;
  const T* a = A + b * m * n;
  const T* bb = B + b * m * k;

  for (int e = tid; e < n * ld; e += NT) Q[e] = 0.f;
  for (int e = tid; e < n * k; e += NT) C[e] = 0.f;
  for (int r0 = 0; r0 < m; r0 += SWEEP_ROWS) {
    const int rows = min(SWEEP_ROWS, m - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < SWEEP_ROWS * lds; e += NT) {
      const int r = e / lds, c = e - r * lds;
      float v = 0.f;
      if (r < rows) v = c < n ? widen(a[(long long)(r0 + r) * n + c]) : widen(bb[(long long)(r0 + r) * k + c - n]);
      st[e] = v;
    }
    __syncthreads();
    for (int i = ty; i < n; i += WARPS) {  // G = AᵀA, lower triangle
      for (int l = tx; l <= i; l += 32) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < SWEEP_ROWS; ++r) acc += st[r * lds + i] * st[r * lds + l];
        Q[i * ld + l] += acc;
      }
    }
    for (int e = tid; e < n * k; e += NT) {  // C = AᵀB
      const int i = e / k, c = e - i * k;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < SWEEP_ROWS; ++r) acc += st[r * lds + i] * st[r * lds + n + c];
      C[e] += acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += NT) {  // P = G, both triangles
    const int i = e / n, l = e - i * n;
    P[i * ld + l] = l <= i ? Q[i * ld + l] : Q[l * ld + i];
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += NT) {  // Q's upper triangle from its lower
    const int i = e / n, l = e - i * n;
    if (l > i) Q[i * ld + l] = Q[l * ld + i];
  }
  __syncthreads();

  const int info1 = chol_sweep(P, ld, n);         // R1
  fwd_sweep(P, ld, false, Q, ld, n, n);           // V = R1⁻ᵀ·G
  rsolve_upper_sweep(P, ld, false, Q, ld, n);     // G2 = V·R1⁻¹
  const int info2 = chol_sweep(Q, ld, n);         // R2
  fwd_sweep(P, ld, false, C, k, n, k);            // t1 = R1⁻ᵀ·C
  fwd_sweep(Q, ld, false, C, k, n, k);            // t2 = R2⁻ᵀ·t1
  // R = R2·R1 (both upper): R[i][c] = Σ_{l=i..c} L2[l][i]·L1[c][l], written
  // into Q's strict upper triangle (L2 is read from its lower one), then
  // the diagonal
  for (int i = ty; i < n; i += WARPS) {
    for (int c = i + 1 + tx; c < n; c += 32) {
      float acc = 0.f;
      for (int l = i; l <= c; ++l) acc += Q[l * ld + i] * P[c * ld + l];
      Q[i * ld + c] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += NT) Q[i * ld + i] *= P[i * ld + i];
  __syncthreads();
  bwd_sweep(Q, ld, true, C, k, n, k);             // X = R⁻¹·t2
  store_tile(X + b * n * k, C, k, n, k);
  if (tid == 0) info[b] = max(info1, info2);
}

"""
SWEEP_ENTRY = """extern "C" int capital_small_lstsq(int dtype, const void* A, const void* B, void* X, void* info, int batch,
                                   int m, int n, int k, void* stream) {
  if (n < 1 || k < 0 || m < n) return -1;
  const size_t smem = 2 * tile_bytes(n) + sizeof(float) * ((size_t)n * k + (size_t)SWEEP_ROWS * (n + k));
  if (dtype == DT_F32)
    return run<lstsq_kernel<float>>(batch, smem, stream, (const float*)A, (const float*)B, (float*)X,
               (int*)info, m, n, k);
  if (dtype == DT_BF16)
    return run<lstsq_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (const bf16*)B, (bf16*)X,
               (int*)info, m, n, k);
  return -1;
}
"""
STAMP = """
__device__ long long g_cyc[16];
#define PT(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) g_cyc[i] = clock64(); } while (0)
"""
#: (anchor in the tree's batched_small.cu, the stamp inserted after it);
#: slot: 0 start, 1 gram, 2 R1, 3 V and t1, 4 G2, 5 R2, 6 t2, 7 R2·R1, 8 X, 9 stored
STAMPS = (
    ('#include "batched_small.cuh"\n', STAMP),
    ("  const int tile = n4 * ld;\n", "  PT(0);\n"),
    ("  const bool finite = stream();\n", "  PT(1);\n"),
    ("  int route = finite ? chol_blocked(P, ld, n) : -1;  // 0: R1 ready\n", "  PT(2);\n"),
    ("    fwd_blocked(P, ld, n, Q, ld, n, C, ldc, k);  // V = R1⁻ᵀ·G and t1 = R1⁻ᵀ·C\n", "    PT(3);\n"),
    ("    rsolve_blocked(P, ld, n, Q, ld, XT);  // G2 = V·R1⁻¹\n", "    PT(4);\n"),
    ("    route = __syncthreads_or(nf) ? -1 : chol_blocked(Q, ld, n);  // R2\n", "    PT(5);\n"),
    ("    fwd_blocked(Q, ld, n, C, ldc, k);  // t2 = R2⁻ᵀ·t1\n", "    PT(6);\n"),
    ("    r2r1_product(Q, P, ld, n);\n", "    PT(7);\n"),
    ("    bwd_upper_blocked(Q, ld, n, C, ldc, k);  // X = R⁻¹·t2\n", "    PT(8);\n"),
    ("  store_tile(X + b * n * k, C, ldc, n, k);\n", "  __syncthreads();\n  PT(9);\n"),
)
PHASES = ("gram", "R1", "V and t1", "G2", "R2", "t2", "R2·R1", "X", "store")
CHECK = ((3, 73, 17, 1), (3, 137, 33, 8), (3, 517, 128, 8), (3, 160, 40, 3), (2, 517, 128, 128))
SHAPES = {"throughput 2048x512x128x8": (2048, 512, 128, 8), "latency 8x512x128x8": (8, 512, 128, 8)}


def between(s: str, start: str, stop: str) -> tuple[int, int]:
    i = s.index(start)
    return i, s.index(stop, i)


def sweep_source(text: str) -> str:
    i, j = between(text, "// ---------------------------------------------------------------------------\n// lstsq:",
                   "// ---------------------------------------------------------------------------\n// C entries")
    text = text[:i] + SWEEP_KERNEL + text[j:]
    i = text.index("// lstsq's shared memory (floats)")
    return text[:i] + SWEEP_ENTRY


def phases_source(text: str) -> str:
    for anchor, stamp in STAMPS:
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, anchor + stamp)
    return text + ('\nextern "C" int probe_cycles(long long* out) '
                   '{ return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); }\n')


def build_variants(root: Path) -> dict:
    _build.build()
    tree = _build._STATE
    states, procs = {}, {}
    for name, edit in (("blocked", None), ("sweep", sweep_source), ("phases", phases_source)):
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
    b, m, n, k = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, m, n), generator=g, device=dev), torch.randn((b, m, k), generator=g, device=dev)


def faulted(dev):
    """n = 40: NaN and inf in A, exactly zero columns (rank-deficient: G
    and G2 break down), and two clean problems."""
    A, B = operands((8, 160, 40, 2), 9, dev)
    A[0, 0, 0], A[1, 10, 7] = float("nan"), float("inf")
    for p, col in zip(range(2, 6), (0, 15, 16, 39)):
        A[p, :, col] = 0
    return A, B


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
        print("lstsq_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    root = _build.build_dir().parent / "probes" / "lstsq_variants"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    ok = True
    for name, st in states.items():
        _build._STATE = st
        worst, good = 0.0, True
        for i, shape in enumerate(CHECK):
            A, B = operands(shape, 20 + i, dev)
            for dt in (torch.float32, torch.bfloat16):
                X, info = batched_small.lstsq(A.to(dt), B.to(dt))
                Xp, ip = batched_small.lstsq_plain(A.to(dt), B.to(dt))
                err = (X.double() - Xp.double()).abs()
                tol = 1e-4 * float(Xp.double().abs().max())
                if dt == torch.bfloat16:
                    tol = tol + 2.0**-7 * Xp.double().abs()
                g = bool((err <= tol).all()) and torch.equal(info, ip)
                worst = max(worst, float(err.max())) if dt == torch.float32 else worst
                good &= g
                if not g:
                    print(json.dumps({"variant": name, "FAIL": shape, "dtype": str(dt)}), flush=True)
        A, B = faulted(dev)
        got, want = batched_small.lstsq(A, B)[1], batched_small.lstsq_plain(A, B)[1]
        good &= torch.equal(got, want)
        ok &= good
        print(json.dumps({"variant": name, "max_abs_err_vs_plain_f32": worst, "info": got.tolist(),
                          "info_plain": want.tolist(), "ok": good}), flush=True)
    if not ok:
        return 1
    cases = {c: operands(shape, 5, dev) for c, shape in SHAPES.items()}
    timed = ["blocked", "sweep"]
    res = {name: {c: [] for c in cases} for name in timed}
    for name in timed + timed[::-1]:
        _build._STATE = states[name]
        for c, (A, B) in cases.items():
            res[name][c].append(time_ms(lambda: batched_small.lstsq(A, B), 3 if A.shape[0] > 100 else 20))
    for name, r in res.items():
        print(json.dumps({"variant": name, **{c: sum(v) / len(v) for c, v in r.items()}, "runs": r}), flush=True)
    _build._STATE = states["phases"]
    read = states["phases"].libs[SRC].probe_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    for c, (A, B) in cases.items():
        buf = (ctypes.c_longlong * 16)()
        for _ in range(3):
            batched_small.lstsq(A, B)
        torch.cuda.synchronize()
        assert read(buf) == 0
        cyc = list(buf)
        steps = {PHASES[i]: cyc[i + 1] - cyc[i] for i in range(len(PHASES))}
        print(json.dumps({"phases": c, "block0_cycles": steps, "total": cyc[9] - cyc[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
