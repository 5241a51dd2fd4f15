// Rank-k Cholesky update / downdate: the rotation sweep over a batch of
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
extern "C" int capital_up_sweep(int dtype, const void* R, const void* V, void* out, void* info, int batch,
                                int n, int k, double sign, void* stream) {
  if (n < 1 || k < 0 || batch < 1) return -1;
  if (dtype == DT_F32) return launch<float>(R, V, out, info, batch, n, k, (float)sign, stream);
  if (dtype == DT_BF16) return launch<bf16>(R, V, out, info, batch, n, k, (float)sign, stream);
  return -1;
}
