"""The rank-k update sweep (`update_small.sweep`) and batched trsm
(`batched_small.trsm`) against the kernels they replaced, on the card.

    python3 probes/update_trsm.py [--skip-timing]

Builds a copy of capital_tpu_torch/ops/csrc under build/probes/update_trsm/
beside the tree's own build, in one process: update_small.cu is the
replaced resident sweep (`OLD_SWEEP`: one block of 128 threads a problem,
R in an (n, n + 1) f32 tile, thread 0 computing each step between two
barriers; its entry renamed `capital_up_sweep_replaced` and called
directly), and batched_small.cu gets the column-sweep trsm kernel and its
entry back (`OLD_TRSM`, `OLD_TRSM_ENTRY`: T and B in odd-ld tiles,
fwd_sweep or bwd_sweep).

Checks, every one bit for bit against the replaced kernel (R' and info of
the sweep, X of trsm; NaN patterns included):
  * the sweep at 8 problems for n in {1, 31, 32, 33, 127, 128, 238} and k
    in {0, 1, 8, 64, 100}, and at 8192 x 128 x 8 and 8192 x 37 x 5, f32
    and bf16, update and downdate;
  * the sweep's faults (`FAULTS`): a NaN / inf / -inf pivot, a NaN / inf
    below the diagonal, a NaN above it, a NaN / -inf in V, an overflow in
    V, an infeasible downdate, and two bad steps whose rank-major order is
    not the row order, each placed in the first, middle and last lane and
    (for V) rank pass of a 128 x 20 problem (passes of 8, 8 and 4 ranks),
    in one problem of 8 and in three problems of 1056 (on the row route
    eight a block, so a faulted problem shares its block with healthy
    ones), on both routes; only the faulted problems may have nonzero
    info;
  * trsm at 8 x n x k for (n, k) in {(1, 1), (37, 5), (33, 64), (128, 8),
    (128, 323), (160, 200)} and 8192 x 128 x 8, f32 and bf16, every uplo x
    trans, with NaN in T's dead triangle and one problem with a zero pivot.
Prints one JSON line per failed check and a count.

The sweep checks run the wrapper (the rule's route) and both routes
through the C entry (`sweep_c`; the wave route takes k >= 2).

Variants (`VARIANTS`: text edits of a copy of the tree's sources, built
beside it and timed with it): the row route without the next row's loads
in flight (`row_no_prefetch`), at seven problems a block with registers
for three blocks an SM (`row_7_warps`; both also held bit for bit), the
wave route handing rows on one or two at a time (`wave_hop1`,
`wave_hop2`; held bit for bit) and, one row at a time, taking the next
row in before it steps a row (`wave_lookahead`), and trsm's forward solve
reading ahead (`trsm_fwd_ahead`, held bit for bit).

Then timings in turns (v0 .. vN, vN .. v0; wall by CUDA events, device
time from a trace): the sweep (`SWEEP_TIMED`: 8192 x 128 x 8 f32 and bf16,
8 x 128 x {1, 8, 64}, and 132 to 2112 problems at k = 8, where the route
rule changes sides), the replaced kernel against each route of the tree's
(and the row route at 4 problems a block instead of 8 at 8192), beside the
refactor (RᵀR + VVᵀ, cholesky_ex, f32 at 8 and 8192); trsm at 8192 x 128 x 8 f32 (every
uplo x trans) and 8 x 128 x 8 f32 (uplo 'U' and 'L'), beside
torch.linalg.solve_triangular.  Prints the ptxas register and
spill lines of both sources per variant and the card's name and power
limit.
"""

import argparse
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
from capital_tpu_torch.ops import _build, batched_small, hopper, update_small  # noqa: E402

UPDATE, SMALL = "update_small.cu", "batched_small.cu"
#: the resident sweep kernel the row-streamed one replaced, whole (its
#: entry renamed)
OLD_SWEEP = r"""// Rank-k Cholesky update / downdate: the rotation sweep over a batch of
// independent problems, one block per problem (blockIdx.x = problem).
//
// Replaces capital_tpu/ops/update_small.py:158 (_pallas_sweep, launched
// through the one pallas_call of capital_tpu/ops/batched_small.py:358).  As
// there, the batch is the grid and problems share nothing: a NaN in one
// problem reaches only its own factor and info.
//
// Per problem the upper factor R (n x n) is loaded once into an f32 tile
// in shared memory (leading dimension n + 1); V (n x k) streams one column
// per rank.  For rank q and column j (σ = +1 update, −1 downdate):
//
//   thread 0:  t = v_j / safe(R_jj),  c² = 1 + σ·t·t,
//              good = R_jj finite and > 0 and c² finite and > 0,
//              info = j + 1 at the first bad step, c⁻¹ = 1/sqrt(good ? c² : 1)
//   barrier
//   thread c:  R_jc ← R_jc + ((R_jc + σt·v_c)·c⁻¹·[c >= j] − R_jc),
//              v_c ← (v_c − t·R_jc)·c⁻¹
//   barrier
//
// The arithmetic is the reference kernel's, operation for operation, with
// IEEE-rounded intrinsics (no FMA contraction, IEEE sqrt and division), so
// the kernel and its plain version (capital_tpu_torch/ops/update_small.
// sweep_plain) agree bitwise.  So do the non-finite cases: the reference
// reads row j and column q of V through one-hot contractions, so an entry
// of the extracted row is NaN when its tile column holds a non-finite value
// in another row, and v_i is NaN when row i of V holds one in another
// column; a non-finite row delta turns its whole tile column NaN in the
// write-back.  The kernel keeps a non-finite count per tile column and per
// row of V to give the same values without the contractions.
//
// What bounds it: n·k dependent steps with two block barriers each; at the
// serve batch (8 problems) 8 of the 132 SMs work.  A warp per problem,
// several problems per block or a blocked form on tensor cores are the
// levers, not taken here.
//
// Shared memory per block, as capital_tpu_torch/ops/update_small.smem_bytes
// computes it: 4·(n·(n + 1) + 3n) bytes (the tile, v, two count vectors).

#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr size_t SMEM_MAX = 232448 - 1024;

__device__ __forceinline__ int nonfinite(float x) { return isfinite(x) ? 0 : 1; }

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

template <typename T>
__global__ void __launch_bounds__(NT) sweep_kernel(const T* R, const T* V, T* out, int* info_out, int n,
                                                   int k, float sign) {
  extern __shared__ float smem[];
  const int ld = n + 1, tid = threadIdx.x;
  float* tile = smem;                // n x ld, the working factor
  float* v = tile + (size_t)n * ld;  // the rotated column of V
  int* colcnt = (int*)(v + n);       // non-finite entries per tile column
  int* vrow = colcnt + n;            // non-finite entries per row of V
  __shared__ float s_t, s_st, s_cinv;
  const long long b = blockIdx.x;
  const T* Rb = R + b * n * n;
  const T* Vb = V + b * n * k;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    tile[r * ld + c] = widen(Rb[e]);
  }
  __syncthreads();
  for (int c = tid; c < n; c += NT) {
    int cnt = 0;
    for (int r = 0; r < n; ++r) cnt += nonfinite(tile[r * ld + c]);
    colcnt[c] = cnt;
    int vc = 0;
    for (int q = 0; q < k; ++q) vc += nonfinite(widen(Vb[(long long)c * k + q]));
    vrow[c] = vc;
  }
  int info = 0;  // thread 0's is the block's
  for (int q = 0; q < k; ++q) {
    __syncthreads();  // the counts (q = 0) or the last step of rank q − 1 have landed
    for (int i = tid; i < n; i += NT) {
      const float x = widen(Vb[(long long)i * k + q]);
      v[i] = (vrow[i] - nonfinite(x) > 0) ? qnan() : x;
    }
    for (int j = 0; j < n; ++j) {
      __syncthreads();  // v and row j are current
      if (tid == 0) {
        const float x = tile[j * ld + j];
        const float d = (colcnt[j] - nonfinite(x) > 0) ? qnan() : x;
        const float vj = v[j];
        const float t = __fdiv_rn(vj, (d != 0.f && isfinite(d)) ? d : 1.f);
        const float st = __fmul_rn(sign, t);
        const float c2 = __fadd_rn(1.f, __fmul_rn(st, t));
        const bool good = isfinite(d) && d > 0.f && isfinite(c2) && c2 > 0.f;
        if (info == 0 && !good) info = j + 1;
        s_t = t;
        s_st = st;
        s_cinv = __fdiv_rn(1.f, __fsqrt_rn(good ? c2 : 1.f));
      }
      __syncthreads();
      const float t = s_t, st = s_st, cinv = s_cinv;
      for (int c = tid; c < n; c += NT) {
        const float x = tile[j * ld + c];
        const int nfx = nonfinite(x);
        const float rr = (colcnt[c] - nfx > 0) ? qnan() : x;
        const float vc = v[c];
        const float nr = (c >= j) ? __fmul_rn(__fadd_rn(rr, __fmul_rn(st, vc)), cinv) : 0.f;
        v[c] = __fmul_rn(__fsub_rn(vc, __fmul_rn(t, rr)), cinv);
        const float delta = __fsub_rn(nr, rr);
        const float y = __fadd_rn(x, delta);
        tile[j * ld + c] = y;
        if (isfinite(delta)) {
          colcnt[c] += nonfinite(y) - nfx;
        } else {  // the write-back's 0·delta is NaN down the column
          for (int r = 0; r < n; ++r)
            if (r != j) tile[r * ld + c] = qnan();
          colcnt[c] = (n - 1) + nonfinite(y);
        }
      }
    }
  }
  __syncthreads();
  bool bad = false;
  for (int c = tid; c < n; c += NT) bad |= colcnt[c] > 0;
  const int any_bad = __syncthreads_or(bad);
  T* ob = out + b * n * n;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    ob[e] = Cast<T>::from(r <= c ? tile[r * ld + c] : 0.f);
  }
  if (tid == 0) info_out[b] = (info == 0 && any_bad) ? n + 1 : info;
}

template <typename T>
int launch(const void* R, const void* V, void* out, void* info, int batch, int n, int k, float sign,
           void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n * (n + 1) + 3 * (size_t)n);
  if (smem > SMEM_MAX) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  sweep_kernel<T><<<batch, NT, smem, (cudaStream_t)stream>>>((const T*)R, (const T*)V, (T*)out, (int*)info,
                                                             n, k, sign);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 = launched), -1 for
// arguments the kernel does not take.  R and out are contiguous (batch, n,
// n) stacks, V (batch, n, k), info (batch,) int32; R, V and out share one
// dtype (bf16 or f32).
extern "C" int capital_up_sweep_replaced(int dtype, const void* R, const void* V, void* out, void* info, int batch,
                                int n, int k, double sign, void* stream) {
  if (n < 1 || k < 0 || batch < 1) return -1;
  if (dtype == DT_F32) return launch<float>(R, V, out, info, batch, n, k, (float)sign, stream);
  if (dtype == DT_BF16) return launch<bf16>(R, V, out, info, batch, n, k, (float)sign, stream);
  return -1;
}
"""
#: the column-sweep trsm kernel the blocked one replaced (with the tile
#: load it alone used)
OLD_TRSM = """template <typename T>
__device__ void load_tile(float* dst, int ldd, const T* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ldd + c] = widen(src[e]);
  }
}

// op(T)·X = B with one sweep: forward (L = T stored lower, or Tᵀ of a T
// stored upper) or backward (U = T stored upper, or Tᵀ of a T stored lower)
template <typename T>
__global__ void __launch_bounds__(NT) trsm_kernel(const T* Tm, const T* B, T* X, int n, int k, int upper,
                                                  int forward) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* S = smem;
  float* Y = smem + n * ld;
  const long long b = blockIdx.x;
  load_tile(S, ld, Tm + b * n * n, n, n);
  load_tile(Y, k, B + b * n * k, n, k);
  __syncthreads();
  if (forward) fwd_sweep(S, ld, upper != 0, Y, k, n, k);
  else bwd_sweep(S, ld, upper != 0, Y, k, n, k);
  store_tile(X + b * n * k, Y, k, n, k);
}

"""
OLD_TRSM_ENTRY = """extern "C" int capital_small_trsm(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                  int k, int upper, int forward, void* stream) {
  if (n < 1 || k < 0) return -1;
  const size_t smem = sizeof(float) * ((size_t)n * odd_ld(n) + (size_t)n * k);
  if (dtype == DT_F32)
    return run<trsm_kernel<float>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X, n, k, upper,
               forward);
  if (dtype == DT_BF16)
    return run<trsm_kernel<bf16>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X, n, k, upper,
               forward);
  return -1;
}

"""
#: the tree's trsm kernel and entry, from their first line to the next
#: function's
TRSM_SPAN = ("// op(T)·X = B, one problem a block, on potrs' tile", "// posv's two halves")
ENTRY_SPAN = ('extern "C" int capital_small_trsm(', 'extern "C" int capital_small_posv(')

#: the row route without the next row's loads in flight (a row loaded at
#: its turn): NS registers fewer, the loads' latency on the chain
NO_PREFETCH = (
    ("  float nxt[NS];\n  load_row<NS>(nxt, Rb, wb, n, 0, first, lane);\n#pragma unroll\n  for (int jb = 0; jb < NS; ++jb) {\n"
     "    const int rows = min(32, n - 32 * jb);\n    for (int jl = 0; jl < rows; ++jl) {\n"
     "      const int j = 32 * jb + jl;\n      float row[NS];\n#pragma unroll\n      for (int i = 0; i < NS; ++i) {\n"
     "        row[i] = nxt[i];\n        chk = check(row[i], chk);\n      }\n"
     "      if (j + 1 < n) load_row<NS>(nxt, Rb, wb, n, j + 1, first, lane);\n",
     "#pragma unroll\n  for (int jb = 0; jb < NS; ++jb) {\n    const int rows = min(32, n - 32 * jb);\n"
     "    for (int jl = 0; jl < rows; ++jl) {\n      const int j = 32 * jb + jl;\n      float row[NS];\n"
     "      load_row<NS>(row, Rb, wb, n, j, first, lane);\n#pragma unroll\n"
     "      for (int i = 0; i < NS; ++i) chk = check(row[i], chk);\n"),
)
#: the row route at seven problems a block, registers capped for three
#: blocks an SM (97 a thread instead of 85)
SEVEN_WARPS = (("constexpr int MAX_WARPS = 8;", "constexpr int MAX_WARPS = 7;"),
               ("__launch_bounds__(32 * MAX_WARPS) sweep_kernel", "__launch_bounds__(32 * MAX_WARPS, 3) sweep_kernel"))
#: the wave route handing rows on one or two at a time instead of in groups
#: of four
def hop(rows):
    return (("constexpr int HOP = 4;", f"constexpr int HOP = {rows};"),)


#: the wave route taking group g + 1 in before it steps group g (each warp
#: two groups behind the one before it, the ring wait off its chain), one
#: row a group
WAVE_LOOKAHEAD = hop(1) + (
    ("    for (int h = 0; h < HOP; ++h) load_row<NS>(nxt[h], Rb, wb, n, h, first, lane);\n  }\n",
     "    for (int h = 0; h < HOP; ++h) load_row<NS>(nxt[h], Rb, wb, n, h, first, lane);\n  } else {\n"
     "    receive<NS>(nxt, in, in_full, in_freed, 0, lane);\n  }\n"),
    ("      } else {\n        receive<NS>(row, in, in_full, in_freed, g, lane);\n      }\n",
     "      } else {\n#pragma unroll\n        for (int h = 0; h < HOP; ++h)\n#pragma unroll\n"
     "          for (int i = 0; i < NS; ++i) row[h][i] = nxt[h][i];\n"
     "        if (j + HOP < n) receive<NS>(nxt, in, in_full, in_freed, g + 1, lane);\n      }\n"))
#: variants of the tree's sources: name -> (source, its (old, new) edits)
VARIANTS = {"row_no_prefetch": (UPDATE, NO_PREFETCH), "row_7_warps": (UPDATE, SEVEN_WARPS),
            "wave_hop1": (UPDATE, hop(1)), "wave_hop2": (UPDATE, hop(2)), "wave_lookahead": (UPDATE, WAVE_LOOKAHEAD),
            "trsm_fwd_ahead": (SMALL, (("  if constexpr (FORWARD) fwd_blocked<true>(S, ld, n, Y, ldy, k);",
                                        "  if constexpr (FORWARD) fwd_blocked<true, true>(S, ld, n, Y, ldy, k);"),))}
UPDATE_VARIANTS = [v for v, (src, _) in VARIANTS.items() if src == UPDATE and v.startswith("row")]

SWEEP_N = (1, 31, 32, 33, 127, 128, 238)
SWEEP_K = (0, 1, 8, 64, 100)
#: faults in a 128 x 20 problem (passes of 8, 8 and 4 ranks): name ->
#: (sign, edits), an edit (operand, index, value) or ("Vscale", None, s);
#: positions in the first, middle and last lane (columns 0 / 32, 47,
#: 127) and, for V, rank pass (ranks 0, 11, 19)
FAULTS = {
    **{f"nan_diag_{j}": (1.0, [("R", (j, j), "nan")]) for j in (0, 47, 127)},
    **{f"inf_diag_{j}": (1.0, [("R", (j, j), "inf")]) for j in (0, 47, 127)},
    **{f"-inf_diag_{j}": (-1.0, [("R", (j, j), "-inf")]) for j in (0, 47, 127)},
    **{f"nan_lower_{r}_{c}": (1.0, [("R", (r, c), "nan")]) for r, c in ((100, 32), (64, 47), (127, 31))},
    **{f"inf_lower_{r}_{c}": (1.0, [("R", (r, c), "inf")]) for r, c in ((1, 0), (90, 47), (127, 95))},
    **{f"nan_upper_{r}_{c}": (1.0, [("R", (r, c), "nan")]) for r, c in ((3, 96), (10, 79), (0, 127))},
    **{f"nan_V_{c}_{q}": (1.0, [("V", (c, q), "nan")]) for c, q in ((0, 0), (47, 11), (127, 19))},
    **{f"-inf_V_{c}_{q}": (-1.0, [("V", (c, q), "-inf")]) for c, q in ((32, 19), (79, 0), (127, 8))},
    **{f"overflow_V_{c}_{q}": (1.0, [("V", (c, q), 3e38)]) for c, q in ((0, 0), (60, 12), (127, 19))},
    "infeasible": (-1.0, [("Vscale", None, 40.0)]),
    # bad steps (0, 100) and (1, 5): rank-major meets (0, 100) first, the
    # row-streamed order (1, 5)
    "bad_order": (-1.0, [("V", (100, 0), 40.0), ("V", (5, 1), 40.0)]),
    "bad_late_rank": (-1.0, [("V", (33, 19), 40.0)]),
}
TRSM_SHAPES = ((8, 1, 1), (8, 37, 5), (8, 33, 64), (8, 128, 8), (8, 128, 323), (8, 160, 200), (8192, 128, 8))
CASES = tuple((u, t) for u in ("U", "L") for t in (False, True))


def build_variants(root: Path) -> dict:
    _build.build()
    tree = _build._STATE
    for src in (UPDATE, SMALL):  # this process's build log, else the one the build left on disk
        log = tree.logs.get(src) or (_build.build_dir() / (Path(src).stem + ".log")).read_text()
        print(json.dumps({"variant": "tree", "source": src, "ptxas": ptxas_lines(log)}), flush=True)
    csrc = root / "replaced" / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / UPDATE).write_text(OLD_SWEEP)
    text = (csrc / SMALL).read_text()
    i, j = text.index(TRSM_SPAN[0]), text.index(TRSM_SPAN[1])
    text = text[:i] + OLD_TRSM + text[j:]
    i, j = text.index(ENTRY_SPAN[0]), text.index(ENTRY_SPAN[1])
    (csrc / SMALL).write_text(text[:i] + OLD_TRSM_ENTRY + text[j:])
    procs = {}
    for src in (UPDATE, SMALL):
        lib = root / "replaced" / (Path(src).stem + ".so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(csrc / src)]
        procs[("replaced", src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                     text=True), lib)
    for name, (src, edits) in VARIANTS.items():
        vsrc = root / name / "csrc"
        shutil.copytree(_build.CSRC, vsrc)
        text = (vsrc / src).read_text()
        for a, b in edits:
            assert text.count(a) == 1, (name, a[:60])
            text = text.replace(a, b)
        (vsrc / src).write_text(text)
        lib = root / name / (Path(src).stem + ".so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(vsrc / src)]
        procs[(name, src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                              lib)
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
        print(json.dumps({"variant": name, "source": src, "ptxas": ptxas_lines(log)}), flush=True)
    st = states["replaced"]
    for name, (src, _) in [("replaced", (SMALL, None))] + list(VARIANTS.items()):
        for fn, (s, argtypes) in _build.SIGNATURES.items():
            if s == src:
                f = getattr(states[name].libs[s], fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
    old = st.libs[UPDATE].capital_up_sweep_replaced
    P, I = ctypes.c_void_p, ctypes.c_int
    old.argtypes, old.restype = [I, P, P, P, P, I, I, I, ctypes.c_double, P], I
    return states


def ptxas_lines(log: str) -> list:
    """ptxas' lines per kernel and out-of-line function: its (mangled) name,
    registers, stack frame and spills."""
    keep = ("Compiling entry function", "Function properties for", "registers", "spill")
    return [ln.replace("ptxas info    : ", "").strip() for ln in log.splitlines() if any(x in ln for x in keep)]


def sweep_old(states, R, V, sign):
    """The replaced resident kernel (uncounted)."""
    batch, n, _ = R.shape
    out, info = torch.empty_like(R), torch.empty(batch, dtype=torch.int32, device=R.device)
    rc = states["replaced"].libs[UPDATE].capital_up_sweep_replaced(
        hopper._DTYPE_CODE[R.dtype], R.data_ptr(), V.data_ptr(), out.data_ptr(), info.data_ptr(), batch, n,
        V.shape[-1], float(sign), hopper._stream())
    assert rc == 0, rc
    return out, info


def sweep_c(R, V, sign, route, warps=None):
    """The tree's kernel through its C entry on `route`, at `warps`
    problems a block on the row route (uncounted; the wrapper takes
    `sweep_route` and `problems_per_block`)."""
    batch = R.shape[0]
    out, info = torch.empty_like(R), torch.empty(batch, dtype=torch.int32, device=R.device)
    rc = update_small._sweep_launch(R, V, out, info, sign, route, warps or update_small.problems_per_block(batch))
    assert rc == 0, rc
    return out, info


def sweep_variant(states, name, R, V, sign, route):
    """A variant build's kernel through its C entry (uncounted), at the
    variant's most problems a block on the row route."""
    _build._STATE = states[name]
    try:
        return sweep_c(R, V, sign, route, 7 if name == "row_7_warps" and R.shape[0] > 1000 else None)
    finally:
        _build._STATE = states["tree"]


def routes_for(k):
    return ("row", "wave") if k >= 2 else ("row",)


def trsm_with(states, name, T, B, uplo, trans):
    _build._STATE = states[name]
    try:
        return batched_small.trsm(T, B, uplo=uplo, trans=trans)
    finally:
        _build._STATE = states["tree"]


def fault_operands(case, batch, where, dev):
    sign, edits = FAULTS[case]
    _, R, V = chip_smoke.up_operands(batch, 128, 20, torch.float32, sign < 0, 41, dev)
    for p in where:
        for op, idx, val in edits:
            if op == "Vscale":
                V[p] *= val
            else:
                (R if op == "R" else V)[(p, *idx)] = float(val)
    return sign, R, V


def checks(states, dev) -> tuple[int, int]:
    done = failed = 0

    def report(ok, **what):
        nonlocal done, failed
        done += 1
        if not ok:
            failed += 1
            print(json.dumps({"FAIL": what}), flush=True)

    shapes = [(8, n, k) for n in SWEEP_N for k in SWEEP_K] + [(8192, 128, 8), (8192, 37, 5)]
    for batch, n, k in shapes:
        for dt in (torch.float32, torch.bfloat16):
            for sign in (1.0, -1.0):
                _, R, V = chip_smoke.up_operands(batch, n, k, dt, sign < 0, n + k, dev)
                Ro, io = sweep_old(states, R, V, sign)
                for route in ("rule",) + routes_for(k):
                    Rk, ik = update_small.sweep(R, V, sign) if route == "rule" else sweep_c(R, V, sign, route)
                    torch.cuda.synchronize()
                    report(chip_smoke.same_bits(Rk, Ro) and torch.equal(ik, io), check="sweep", route=route,
                           shape=[batch, n, k], dtype=str(dt), sign=sign, info=ik[:4].tolist())
    for name in UPDATE_VARIANTS + ["wave_hop1", "wave_hop2"]:  # the same bits, or not worth timing
        route = "wave" if name.startswith("wave") else "row"
        for batch, n, k in ((8, 33, 5), (8, 37, 20), (8, 128, 20), (8192, 128, 8)):
            _, R, V = chip_smoke.up_operands(batch, n, k, torch.float32, False, n + k, dev)
            Ro, io = sweep_old(states, R, V, 1.0)
            Rv, iv = sweep_variant(states, name, R, V, 1.0, route)
            torch.cuda.synchronize()
            report(chip_smoke.same_bits(Rv, Ro) and torch.equal(iv, io), check="sweep variant", variant=name,
                   shape=[batch, n, k])
    for case in FAULTS:
        for batch, where in ((8, (3,)), (1056, (3, 10, 1049))):
            sign, R, V = fault_operands(case, batch, where, dev)
            Ro, io = sweep_old(states, R, V, sign)
            for route in ("row", "wave"):
                Rk, ik = sweep_c(R, V, sign, route)
                torch.cuda.synchronize()
                flagged = set(torch.nonzero(ik).flatten().tolist())
                report(chip_smoke.same_bits(Rk, Ro) and torch.equal(ik, io) and flagged == set(where),
                       check="sweep fault", case=case, route=route, batch=batch, info=[int(ik[p]) for p in where],
                       replaced=[int(io[p]) for p in where], flagged=sorted(flagged)[:8])
    g = torch.Generator(device=dev).manual_seed(5)
    for batch, n, k in TRSM_SHAPES:
        T = torch.randn((batch, n, n), generator=g, device=dev) / max(n, 1) ** 0.5 + 3.0 * torch.eye(n, device=dev)
        B = torch.randn((batch, n, k), generator=g, device=dev)
        T[1, n // 2, n // 2] = 0.0  # a zero pivot: the guarded divisor
        for uplo, trans in CASES:
            Tc = T.clone()
            dead = torch.ones(n, n, dtype=torch.bool, device=dev)
            dead = dead.tril(-1) if uplo == "U" else dead.triu(1)
            Tc[:, dead] = float("nan")  # never used
            for dt in (torch.float32, torch.bfloat16):
                Td, Bd = Tc.to(dt), B.to(dt)
                Xo = trsm_with(states, "replaced", Td, Bd, uplo, trans)
                for v in ("tree", "trsm_fwd_ahead"):  # the variant too, should it be adopted
                    Xk = trsm_with(states, v, Td, Bd, uplo, trans)
                    torch.cuda.synchronize()
                    report(chip_smoke.same_bits(Xk, Xo) and bool(torch.isfinite(Xk[0]).all()), check="trsm",
                           variant=v, shape=[batch, n, k], dtype=str(dt), uplo=uplo, trans=trans)
    return done, failed


def turns(cases, order) -> None:
    """Each case on each variant in turns (v0 .. vN, vN .. v0): mean wall
    of the two readings (CUDA events), device time from the first turn's
    trace."""
    res = {c: {v: [] for v in order if v in fns} for c, (fns, _) in cases.items()}
    dev_ms = {c: {} for c in cases}
    for turn, v in enumerate(list(order) + list(order)[::-1]):
        for c, (fns, it) in cases.items():
            if v not in fns:
                continue
            res[c][v].append(chip_smoke.time_ms(fns[v], it))
            if turn < len(order):
                dev_ms[c][v] = chip_smoke.device_ms(fns[v], it)
    for c in cases:
        print(json.dumps({"case": c, **{v: sum(r) / len(r) for v, r in res[c].items()}, "runs": res[c],
                          "device_ms": dev_ms[c]}), flush=True)


#: the sweep's timed cases (batch, n, k, dtype): the throughput batch, the
#: serve bucket over the nrhs rungs, and the batches between, where the
#: route rule changes sides
SWEEP_TIMED = ((8192, 128, 8, torch.float32), (8192, 128, 8, torch.bfloat16), (8, 128, 1, torch.float32),
               (8, 128, 8, torch.float32), (8, 128, 8, torch.bfloat16), (8, 128, 64, torch.float32),
               (132, 128, 8, torch.float32), (264, 128, 8, torch.float32), (396, 128, 8, torch.float32),
               (528, 128, 8, torch.float32), (1056, 128, 8, torch.float32), (2112, 128, 8, torch.float32),
               (132, 128, 64, torch.float32))


def timings(states, dev) -> None:
    cases = {}
    for batch, n, k, dt in SWEEP_TIMED:
        _, R, V = chip_smoke.up_operands(batch, n, k, dt, False, 31 + k, dev)
        it = 5 if batch * k > 8 * 64 else 20
        fns = {"replaced": lambda R=R, V=V: sweep_old(states, R, V, 1.0)}
        for route in routes_for(k):
            fns[route] = lambda R=R, V=V, r=route: sweep_c(R, V, 1.0, r)
        if batch == 8192:
            fns["row 4 a block"] = lambda R=R, V=V: sweep_c(R, V, 1.0, "row", 4)
            for name in UPDATE_VARIANTS:
                fns[name] = lambda R=R, V=V, name=name: sweep_variant(states, name, R, V, 1.0, "row")
        if k >= 2 and batch <= 528:
            for name in ("wave_hop1", "wave_hop2", "wave_lookahead"):
                fns[name] = lambda R=R, V=V, name=name: sweep_variant(states, name, R, V, 1.0, "wave")
        if dt == torch.float32 and batch in (8, 8192):  # cusolver's Cholesky takes no bf16
            fns["refactor"] = lambda R=R, V=V: chip_smoke.up_refactor(R, V)
        label = f"sweep {batch}x{n}x{k} {'f32' if dt == torch.float32 else 'bf16'}"
        cases[label + f" (rule: {update_small.sweep_route(batch, k)})"] = (fns, it)
    g = torch.Generator(device=dev).manual_seed(6)
    for batch in (8192, 8):
        n, k = 128, 8
        T = torch.randn((batch, n, n), generator=g, device=dev) / n**0.5 + 3.0 * torch.eye(n, device=dev)
        B = torch.randn((batch, n, k), generator=g, device=dev)
        it = 5 if batch > 8 else 50
        for uplo, trans in CASES if batch > 8 else (("U", False), ("L", False)):
            Tt = torch.triu(T) if uplo == "U" else torch.tril(T)
            Tt = Tt.mT if trans else Tt
            cases[f"trsm {batch}x{n}x{k} f32 {uplo}{' trans' if trans else ''}"] = (
                {v: lambda T=T, B=B, u=uplo, t=trans, v=v: trsm_with(states, v, T, B, u, t)
                 for v in ("replaced", "tree", "trsm_fwd_ahead")}
                | {"solve_triangular": lambda Tt=Tt, B=B, up=(uplo == "U") != trans:
                   torch.linalg.solve_triangular(Tt, B, upper=up)},
                it)
    turns(cases, ("replaced", "tree", "row", "wave", "row 4 a block", *VARIANTS, "refactor", "solve_triangular"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-timing", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_trsm: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _build.build_dir().parent / "probes" / "update_trsm"
    shutil.rmtree(root, ignore_errors=True)
    states = build_variants(root)
    dev = torch.device("cuda")
    done, failed = checks(states, dev)
    print(json.dumps({"checks": done, "bit_for_bit": done - failed}), flush=True)
    if failed:
        print(json.dumps({"result": "FAIL: not bit for bit the replaced kernels"}), flush=True)
        return 1
    if not args.skip_timing:
        timings(states, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
