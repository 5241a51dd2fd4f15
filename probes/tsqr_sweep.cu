// The column-sweep TSQR panel kernel that the blocked compact-WY kernel
// (capital_tpu_torch/ops/csrc/tsqr.cu) replaced, kept outside the package
// for the same-process A/B of probes/tsqr_nb.py, which copies it over tsqr.cu
// in a copy of csrc/.  Same C entry, same arguments.
//
// TSQR panel QR: a batch of (p, n) panels, one block per panel
// (blockIdx.x = panel), each factored P = Q·R by Householder reflectors —
// thin Q (p, n) and upper-triangular R (n, n).
//
// Replaces capital_tpu/ops/tsqr.py:_qr_pallas (:200; body _house_panel
// :137; its pallas_call is batched_small._batched_call :358), the leaf and
// reduction panel QRs of ops/tsqr.tsqr under impl 'pallas' / 'auto'.  The
// reflectors are the JAX kernel's: for column j, x = W[j:, j],
// α = −sign(x_j)·‖x‖ (sign(0) = +1), v = (x − α·e_j)/‖x − α·e_j‖ (v = 0
// for a zero column: the identity reflector, so zero-padded panels factor
// exactly), H_j = I − 2·v·vᵀ applied to the columns right of j; R = triu of
// the swept top n rows, its diagonal x_j − 2·v_j·(vᵀx) as the JAX sweep
// computes it; Q = H_0·…·H_{n−1}·I[:, :n] by a descending sweep.
//
// Shared memory (f32): the JAX kernel keeps three (p, n) arrays — the
// panel, the reflectors and the thin-Q accumulator (384 KB at p = 256,
// n = 128), more than the 227 KB of a block.  Here one (p, n) tile with an
// odd leading dimension holds all three in turn: v_j is stored in column j
// on and below the diagonal, R's strict upper triangle stays above it and
// its diagonal in an n-vector; R is written out, then Q is formed in place
// in the order of LAPACK's org2r — at step j first the columns right of j
// (which still hold e_c-based Q columns with zeros in rows <= j), then
// column j from v_j.  4·(p·ld + n) bytes: 132,608 at p = 256, n = 128
// (capital_tpu_torch/ops/tsqr.smem_bytes).
//
// What bounds it on the card: f32 operations — 4·p·n² − 4n³/3 useful flops
// per panel (R and Q) on CUDA cores, 8192 panels of 256 x 128 at the QR
// flagship's leaves (1.7 ms at 67 TF/s).  The design does one warp per
// column for the reflector products (no block barrier inside a column's
// dot-and-update) and two block reductions plus two barriers per column;
// not done yet: several columns per barrier (blocked WY), tensor cores.

#include "batched_small.cuh"

using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of a and b over the block, in a fixed order, returned to every
// thread.  `red` holds 2·WARPS floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // red is free: the previous sum has been read
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[WARPS + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  for (int w = 0; w < WARPS; ++w) {
    t.x += red[w];
    t.y += red[WARPS + w];
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(NT) panel_qr_kernel(const T* P, T* Q, T* R, int p, int n) {
  extern __shared__ float smem[];
  __shared__ float red[2 * WARPS];
  const int ld = odd_ld(n);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* W = smem;         // the panel -> v_j below the diagonal, R above -> Q
  float* rd = W + p * ld;  // R's diagonal
  const long long b = blockIdx.x;
  const T* a = P + b * p * n;
  for (int e = tid; e < p * n; e += NT) {
    const int r = e / n, c = e - r * n;
    W[r * ld + c] = widen(a[e]);
  }
  __syncthreads();

  // ascending reflector sweep
  for (int j = 0; j < n; ++j) {
    float s2 = 0.f;
    for (int r = j + tid; r < p; r += NT) {
      const float x = W[r * ld + j];
      s2 += x * x;
    }
    const float sig = sqrtf(block_sum2(s2, 0.f, red).x);
    const float xj = W[j * ld + j];
    const float alpha = xj >= 0.f ? -sig : sig;
    float vv = 0.f, vx = 0.f;
    for (int r = j + tid; r < p; r += NT) {
      const float x = W[r * ld + j];
      const float v = r == j ? xj - alpha : x;
      vv += v * v;
      vx += v * x;
    }
    const float2 t = block_sum2(vv, vx, red);  // every x has been read
    const float inv = t.x > 0.f ? 1.f / sqrtf(t.x) : 0.f;
    if (tid == 0) rd[j] = xj - 2.f * ((xj - alpha) * inv) * (t.y * inv);
    for (int r = j + tid; r < p; r += NT) W[r * ld + j] = (r == j ? xj - alpha : W[r * ld + j]) * inv;
    __syncthreads();
    for (int c = j + 1 + warp; c < n; c += WARPS) {  // H_j on the columns right of j
      float s = 0.f;
      for (int r = j + lane; r < p; r += 32) s += W[r * ld + j] * W[r * ld + c];
      s = warp_sum(s);
      for (int r = j + lane; r < p; r += 32) W[r * ld + c] -= 2.f * W[r * ld + j] * s;
    }
    __syncthreads();
  }

  T* rout = R + b * n * n;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    rout[e] = Cast<T>::from(c > r ? W[r * ld + c] : (c == r ? rd[r] : 0.f));
  }
  __syncthreads();  // R is read out before Q overwrites it

  // descending thin-Q sweep, in place (LAPACK org2r order)
  for (int j = n - 1; j >= 0; --j) {
    const float vjj = W[j * ld + j];
    for (int c = j + 1 + warp; c < n; c += WARPS) {
      float s = 0.f;
      for (int r = j + lane; r < p; r += 32) s += W[r * ld + j] * W[r * ld + c];
      s = warp_sum(s);
      for (int r = j + lane; r < p; r += 32) W[r * ld + c] -= 2.f * W[r * ld + j] * s;
    }
    __syncthreads();  // v_j is read; column j may now be overwritten
    for (int r = tid; r < p; r += NT)
      W[r * ld + j] = r < j ? 0.f : (r == j ? 1.f : 0.f) - 2.f * W[r * ld + j] * vjj;
    __syncthreads();
  }
  T* q = Q + b * p * n;
  for (int e = tid; e < p * n; e += NT) {
    const int r = e / n, c = e - r * n;
    q[e] = Cast<T>::from(W[r * ld + c]);
  }
}

template <typename T>
static int launch(const void* P, void* Q, void* R, int batch, int p, int n, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)p * odd_ld(n) + (size_t)n);
  if (smem > SMEM_MAX) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(panel_qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  panel_qr_kernel<T><<<batch, NT, smem, (cudaStream_t)stream>>>((const T*)P, (T*)Q, (T*)R, p, n);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  P and Q are contiguous (batch, p, n) stacks,
// R a contiguous (batch, n, n) stack.
extern "C" int capital_tsqr_panel(int dtype, const void* P, void* Q, void* R, int batch, int p, int n,
                                  void* stream) {
  if (batch < 1 || n < 1 || p < n) return -1;
  if (dtype == DT_F32) return launch<float>(P, Q, R, batch, p, n, stream);
  if (dtype == DT_BF16) return launch<bf16>(P, Q, R, batch, p, n, stream);
  return -1;
}
