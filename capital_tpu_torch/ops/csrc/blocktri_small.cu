// Block-tridiagonal scan steps: `seg` chain blocks per launch of every
// problem of a batch, one block per problem (blockIdx.x = problem).
//
// Replaces capital_tpu/ops/blocktri_small.py: the pallas_call (through
// batched_small._batched_call :358) of fused_forward_step :171 (:216),
// factor_step :229 (:255), forward_solve_step :266 (:293) and
// solve_backward_step :304 (:335).  As there, problems share nothing, and
// the carried diagonal factor L_{i−1} stays on chip from one chain block to
// the next inside the launch.
//
// Per chain block i (f32, all in shared memory):
//   Wt = L_{i−1}⁻¹·Cᵀ       Cᵀ is an index read while loading, then fwd_sweep
//   S  = D − Wtᵀ·Wt         a plain shared-tile product (lower half computed,
//                           mirrored: the full S feeds chol_sweep's info)
//   L_i, info = chol(S)     chol_sweep, in place; L masked lower on store
//   y_i = L_i⁻¹(b_i − Wtᵀ·y_{i−1})               (fused, forward_solve)
//   x_i = L_i⁻ᵀ(y_i − Wt_{i+1}·x_{i+1}), descending      (solve_backward)
// The sweeps are batched_small.cuh's, so info follows the JAX kernel's
// convention exactly and identity blocks factor and solve exactly.
//
// Shared memory, as capital_tpu_torch/ops/blocktri_small.smem_bytes
// computes it (ld = odd_ld(b)): three b x b tiles for the factor steps
// (L_{i−1}, Wt, S → L_i; the L tile and the S tile swap roles after every
// block), two for the sweeps (L_i, Wt), and a stage of 2·b·kc floats for
// the right-hand sides: the chunk being solved and the carried chunk of the
// neighbouring block.  Right-hand-side columns are independent, so they
// stream through the stage kc at a time, and the f32 carry between chain
// blocks lives in a device-memory scratch (batch, b, k) that the wrapper
// allocates (read back by the same block after a barrier).  At b = 128
// three tiles take 198,144 bytes and leave room for kc = 32; every width k
// fits that way.
//
// What bounds them on the card: at the flagship (batch 1, 64 blocks of 128)
// one SM walks the chain alone, so the time is the dependent sweeps — per
// block 128 columns of Wt's forward sweep, 128 of the Cholesky and 128 of
// the RHS sweep, each with one or two block barriers — far from both the
// bytes bound (the operands are read once) and the f32 operations bound.
// A batch of problems (or the partitioned driver's folded interiors)
// fills more SMs.  Not done yet: tensor cores for Wtᵀ·Wt and the
// Wt sweep, a cluster per problem.

#include "batched_small.cuh"

using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;
// largest chain block of the factor steps: three f32 tiles must fit SMEM_MAX
// (b <= 138); the per-row flags below are static shared memory
constexpr int MAX_B = 256;

template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int b) {
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int r = e / b, c = e - r * b;
    dst[r * ld + c] = widen(src[e]);
  }
}

// dst = srcᵀ: coalesced reads of src, the transposed write hits distinct
// banks because ld is odd
template <typename T>
__device__ void load_tile_t(float* dst, int ld, const T* src, int b) {
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int r = e / b, c = e - r * b;
    dst[c * ld + r] = widen(src[e]);
  }
}

template <typename T>
__device__ void store_tile(T* dst, const float* src, int ld, int b, bool lower_only) {
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int r = e / b, c = e - r * b;
    dst[e] = Cast<T>::from(lower_only && c > r ? 0.f : src[r * ld + c]);
  }
}

// One chain block of the factor recurrence: P holds L_{i−1} (lower), W
// receives Wt_i, S receives L_i in its lower triangle.  Returns the block's
// info (all threads).  Ends with a barrier.
//
// A non-finite Schur complement spreads through the factor as the JAX
// kernel's one-hot sweep spreads it (ops/sweeps.chol_plain): column 0 is
// NaN at the rows of S holding a non-finite value, every later column is
// NaN.  chol_sweep reads the lower triangle only, so that pattern is set
// here from the rows of the full S; the next chain block's sweeps then see
// the factor the reference carries, and its info agrees too.
template <typename T>
__device__ int factor_block(const float* P, float* W, float* S, int ld, const T* d, const T* c, int b) {
  __shared__ unsigned char rowbad[MAX_B];
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  load_tile_t(W, ld, c, b);
  load_tile(S, ld, d, b);
  __syncthreads();
  fwd_sweep(P, ld, false, W, ld, b, b);  // Wt = L_{i−1}⁻¹·Cᵀ
  for (int i = ty; i < b; i += WARPS) {   // S −= Wtᵀ·Wt
    for (int j = tx; j <= i; j += 32) {
      float acc = 0.f;
      for (int l = 0; l < b; ++l) acc += W[l * ld + i] * W[l * ld + j];
      S[i * ld + j] -= acc;
      if (j != i) S[j * ld + i] -= acc;
    }
  }
  __syncthreads();
  bool bad = false;
  for (int i = ty; i < b; i += WARPS) {
    bool row = false;
    for (int l = tx; l < b; l += 32) row |= !isfinite(S[i * ld + l]);
    row = __any_sync(0xffffffffu, row);
    if (tx == 0) rowbad[i] = row;
    bad |= row;
  }
  const int anybad = __syncthreads_or(bad);
  const int info = chol_sweep(S, ld, b);
  if (anybad) {
    const float nan = __int_as_float(0x7fc00000);
    for (int e = threadIdx.x; e < b * b; e += NT) {
      const int r = e / b, cc = e - r * b;
      if (cc <= r && (cc > 0 || rowbad[r])) S[r * ld + cc] = nan;
    }
    __syncthreads();
  }
  return info;
}

// The forward sweep of one chain block over every RHS column, kc at a time:
// y = Lt⁻¹(rhs − Wᵀ·yprev), yprev from `first_carry` (the launch's carry, at
// dtype) or from the f32 scratch `carry`; y goes to `carry` and `out`.
template <typename T>
__device__ void forward_rhs(const float* Lt, const float* W, int ld, const T* rhs, const T* first_carry,
                            float* carry, T* out, float* R, float* Yp, int b, int k, int kc) {
  for (int c0 = 0; c0 < k; c0 += kc) {
    const int w = min(kc, k - c0);
    for (int e = threadIdx.x; e < b * w; e += NT) {
      const int r = e / w, c = e - r * w;
      const long long g = (long long)r * k + c0 + c;
      R[e] = widen(rhs[g]);
      Yp[e] = first_carry ? widen(first_carry[g]) : carry[g];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < b * w; e += NT) {
      const int r = e / w, c = e - r * w;
      float acc = 0.f;
      for (int l = 0; l < b; ++l) acc += W[l * ld + r] * Yp[l * w + c];
      R[e] -= acc;
    }
    __syncthreads();
    fwd_sweep(Lt, ld, false, R, w, b, w);
    for (int e = threadIdx.x; e < b * w; e += NT) {
      const int r = e / w, c = e - r * w;
      const long long g = (long long)r * k + c0 + c;
      carry[g] = R[e];
      out[g] = Cast<T>::from(R[e]);
    }
    __syncthreads();  // the next chunk overwrites the stage
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_forward_kernel(const T* D, const T* C, const T* B, const T* Lc,
                                                           const T* yc, T* L, T* Wt, T* y, int* info,
                                                           float* scratch, int seg, int b, int k, int kc) {
  extern __shared__ float smem[];
  const int ld = odd_ld(b);
  float* P = smem;
  float* W = P + b * ld;
  float* S = W + b * ld;
  float* R = S + b * ld;
  float* Yp = R + b * kc;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  load_tile(P, ld, Lc + p * bb, b);
  __syncthreads();
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    const int inf = factor_block(P, W, S, ld, D + blk * bb, C + blk * bb, b);
    store_tile(L + blk * bb, S, ld, b, true);
    store_tile(Wt + blk * bb, W, ld, b, false);
    if (threadIdx.x == 0) info[blk] = inf;
    forward_rhs(S, W, ld, B + blk * bk, s == 0 ? yc + p * bk : nullptr, scratch + p * bk, y + blk * bk,
                R, Yp, b, k, kc);
    __syncthreads();  // the stores have read W and S
    float* t = P;
    P = S;
    S = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) factor_kernel(const T* D, const T* C, const T* Lc, T* L, T* Wt, int* info,
                                                    int seg, int b) {
  extern __shared__ float smem[];
  const int ld = odd_ld(b);
  float* P = smem;
  float* W = P + b * ld;
  float* S = W + b * ld;
  const long long p = blockIdx.x, bb = (long long)b * b;
  load_tile(P, ld, Lc + p * bb, b);
  __syncthreads();
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    const int inf = factor_block(P, W, S, ld, D + blk * bb, C + blk * bb, b);
    store_tile(L + blk * bb, S, ld, b, true);
    store_tile(Wt + blk * bb, W, ld, b, false);
    if (threadIdx.x == 0) info[blk] = inf;
    __syncthreads();
    float* t = P;
    P = S;
    S = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) forward_solve_kernel(const T* L, const T* Wt, const T* B, const T* yc, T* y,
                                                           float* scratch, int seg, int b, int k, int kc) {
  extern __shared__ float smem[];
  const int ld = odd_ld(b);
  float* Lt = smem;
  float* W = Lt + b * ld;
  float* R = W + b * ld;
  float* Yp = R + b * kc;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    load_tile(Lt, ld, L + blk * bb, b);
    load_tile(W, ld, Wt + blk * bb, b);
    __syncthreads();
    forward_rhs(Lt, W, ld, B + blk * bk, s == 0 ? yc + p * bk : nullptr, scratch + p * bk, y + blk * bk,
                R, Yp, b, k, kc);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) solve_backward_kernel(const T* L, const T* Wtn, const T* Y, const T* xc,
                                                            T* x, float* scratch, int seg, int b, int k, int kc) {
  extern __shared__ float smem[];
  const int ld = odd_ld(b);
  float* Lt = smem;
  float* W = Lt + b * ld;
  float* R = W + b * ld;
  float* Xn = R + b * kc;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  float* carry = scratch + p * bk;
  for (int s = seg - 1; s >= 0; --s) {
    const long long blk = p * seg + s;
    load_tile(Lt, ld, L + blk * bb, b);
    load_tile(W, ld, Wtn + blk * bb, b);
    __syncthreads();
    for (int c0 = 0; c0 < k; c0 += kc) {
      const int w = min(kc, k - c0);
      for (int e = threadIdx.x; e < b * w; e += NT) {
        const int r = e / w, c = e - r * w;
        const long long g = (long long)r * k + c0 + c;
        R[e] = widen(Y[blk * bk + g]);
        Xn[e] = s == seg - 1 ? widen(xc[p * bk + g]) : carry[g];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < b * w; e += NT) {  // R −= Wt_{i+1}·x_{i+1}
        const int r = e / w, c = e - r * w;
        float acc = 0.f;
        for (int l = 0; l < b; ++l) acc += W[r * ld + l] * Xn[l * w + c];
        R[e] -= acc;
      }
      __syncthreads();
      bwd_sweep(Lt, ld, false, R, w, b, w);  // x = L⁻ᵀ·R
      for (int e = threadIdx.x; e < b * w; e += NT) {
        const int r = e / w, c = e - r * w;
        const long long g = (long long)r * k + c0 + c;
        carry[g] = R[e];
        x[blk * bk + g] = Cast<T>::from(R[e]);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// C entries: return the cudaError_t of the launch (0 = launched), -1 for
// arguments the kernels do not take.  Chain operands are contiguous
// (batch, seg, b, b) / (batch, seg, b, k) stacks, carries (batch, b, b) /
// (batch, b, k), info (batch, seg) int32, scratch (batch, b, k) f32.
// ---------------------------------------------------------------------------

template <auto Kernel, typename... Args>
static int run(int batch, size_t smem, void* stream, Args... args) {
  if (smem > SMEM_MAX || batch < 1) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

static size_t tiles_bytes(int ntiles, int b) { return sizeof(float) * (size_t)ntiles * b * odd_ld(b); }

static size_t stage_bytes(int b, int kc) { return sizeof(float) * 2 * (size_t)b * kc; }

extern "C" int capital_bt_fused_forward(int dtype, const void* D, const void* C, const void* B, const void* Lc,
                                        const void* yc, void* L, void* Wt, void* y, void* info, void* scratch,
                                        int batch, int seg, int b, int k, int kc, void* stream) {
  if (b < 1 || b > MAX_B || seg < 1 || k < 0 || (k > 0 && (kc < 1 || kc > k))) return -1;
  const size_t smem = tiles_bytes(3, b) + stage_bytes(b, kc);
  if (dtype == DT_F32)
    return run<fused_forward_kernel<float>>(batch, smem, stream, (const float*)D, (const float*)C,
               (const float*)B, (const float*)Lc, (const float*)yc, (float*)L, (float*)Wt, (float*)y,
               (int*)info, (float*)scratch, seg, b, k, kc);
  if (dtype == DT_BF16)
    return run<fused_forward_kernel<bf16>>(batch, smem, stream, (const bf16*)D, (const bf16*)C,
               (const bf16*)B, (const bf16*)Lc, (const bf16*)yc, (bf16*)L, (bf16*)Wt, (bf16*)y,
               (int*)info, (float*)scratch, seg, b, k, kc);
  return -1;
}

extern "C" int capital_bt_factor(int dtype, const void* D, const void* C, const void* Lc, void* L, void* Wt,
                                 void* info, int batch, int seg, int b, void* stream) {
  if (b < 1 || b > MAX_B || seg < 1) return -1;
  const size_t smem = tiles_bytes(3, b);
  if (dtype == DT_F32)
    return run<factor_kernel<float>>(batch, smem, stream, (const float*)D, (const float*)C, (const float*)Lc,
               (float*)L, (float*)Wt, (int*)info, seg, b);
  if (dtype == DT_BF16)
    return run<factor_kernel<bf16>>(batch, smem, stream, (const bf16*)D, (const bf16*)C, (const bf16*)Lc,
               (bf16*)L, (bf16*)Wt, (int*)info, seg, b);
  return -1;
}

extern "C" int capital_bt_forward_solve(int dtype, const void* L, const void* Wt, const void* B, const void* yc,
                                        void* y, void* scratch, int batch, int seg, int b, int k, int kc,
                                        void* stream) {
  if (b < 1 || seg < 1 || k < 1 || kc < 1 || kc > k) return -1;
  const size_t smem = tiles_bytes(2, b) + stage_bytes(b, kc);
  if (dtype == DT_F32)
    return run<forward_solve_kernel<float>>(batch, smem, stream, (const float*)L, (const float*)Wt,
               (const float*)B, (const float*)yc, (float*)y, (float*)scratch, seg, b, k, kc);
  if (dtype == DT_BF16)
    return run<forward_solve_kernel<bf16>>(batch, smem, stream, (const bf16*)L, (const bf16*)Wt,
               (const bf16*)B, (const bf16*)yc, (bf16*)y, (float*)scratch, seg, b, k, kc);
  return -1;
}

extern "C" int capital_bt_solve_backward(int dtype, const void* L, const void* Wtn, const void* Y,
                                         const void* xc, void* x, void* scratch, int batch, int seg, int b, int k,
                                         int kc, void* stream) {
  if (b < 1 || seg < 1 || k < 1 || kc < 1 || kc > k) return -1;
  const size_t smem = tiles_bytes(2, b) + stage_bytes(b, kc);
  if (dtype == DT_F32)
    return run<solve_backward_kernel<float>>(batch, smem, stream, (const float*)L, (const float*)Wtn,
               (const float*)Y, (const float*)xc, (float*)x, (float*)scratch, seg, b, k, kc);
  if (dtype == DT_BF16)
    return run<solve_backward_kernel<bf16>>(batch, smem, stream, (const bf16*)L, (const bf16*)Wtn,
               (const bf16*)Y, (const bf16*)xc, (bf16*)x, (float*)scratch, seg, b, k, kc);
  return -1;
}
