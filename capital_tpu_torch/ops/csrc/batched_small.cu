// Small-N batched solves: potrf, trsm, potrs, posv and lstsq over a batch
// of independent problems, one block per problem (blockIdx.x = problem).
//
// Replaces capital_tpu/ops/batched_small.py: the one pallas_call (:358,
// through _batched_call :347) of potrf :398, trsm :431, potrs :470, posv
// :506 and lstsq :546.  As there, the batch is the grid and problems share nothing:
// a NaN in one problem reaches only its own outputs and info.
//
// What bounds them on the card: at the throughput batch (8192 problems of
// order 128, 8 right-hand sides) potrf, potrs and posv are bound by bytes
// (the operand is read once, ~1 useful flop per byte); lstsq at m = 512 by
// f32 operations (the gram, 2·m·n² flops per problem).  At the serve
// latency batch (8 problems) only 8 of the 132 SMs work and the time is the
// dependent column sweep: n steps with one or two block barriers each.
// What the design does about it: each problem is loaded into shared memory
// once (upcast to f32) and every phase runs there; the factor of posv and
// the whole CholeskyQR2 state of lstsq never reach device memory; outputs
// are rounded once on store.  Sweeps are CUDA-core f32 with IEEE sqrt and
// division (see batched_small.cuh).  Not done yet: a warp per problem at
// small n, several blocks or a cluster per problem, tensor-core updates.
//
// potrf runs the blocked factor (chol_blocked, batched_small.cuh): three
// barriers a 16-column panel instead of two or three a column, the
// diagonal block in one warp's registers, the trailing update as 4 x 4
// register tiles fed by 16-byte shared loads; rows move as 4-entry vectors
// (16 bytes of f32, 8 of bf16) when n % 4 == 0.  256 threads a block, one
// problem a block: ptxas gives potrf_kernel 80 registers a thread (f32 and
// bf16, no spills; _build.build_logs()) and 192 B of static shared memory,
// and at n = 128 the tile is 128 x 132 f32 (67,584 B dynamic), so three
// blocks share an SM and the 8192-problem batch runs in 21 waves.
//
// Shared memory per block (f32; ld = odd_ld(n), potrf ld = potrf_ld(n)),
// as capital_tpu_torch/ops/batched_small.smem_bytes computes it:
//   potrf        round4(n)·ld
//   trsm, potrs, posv  n·ld + n·k
//   lstsq        2·n·ld + n·k + LSTSQ_ROWS·(n+k)
// Above 48 KB it is dynamic shared memory, enabled per kernel with
// cudaFuncSetAttribute.  lstsq streams A and B through a LSTSQ_ROWS-row
// stage (A at 512 x 128 f32 is 256 KB and cannot be resident); its n x n
// state is two tiles reused in place: R1 in one, G -> V -> G2 -> R2 -> R
// in the other (R = R2·R1 goes into the free upper triangle beside R2's
// lower one, so the back-substitution runs through R = R2·R1 as the JAX
// kernel does).

#include "batched_small.cuh"

using namespace small;

constexpr int LSTSQ_ROWS = 16;
constexpr size_t SMEM_MAX = 232448 - 1024;

template <typename T>
__device__ void load_tile(float* dst, int ldd, const T* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ldd + c] = widen(src[e]);
  }
}

template <typename T>
__device__ void store_tile(T* dst, const float* src, int lds, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[e] = Cast<T>::from(src[r * lds + c]);
  }
}

// four consecutive entries, widened to f32 / rounded once from f32
__device__ __forceinline__ void load4(const float* p, float* v) { unpack4(v, *reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  uint2 t;
  bf16* h = reinterpret_cast<bf16*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint2*>(p) = t;
}

// whether an n x n problem at p can move in 4-entry vectors
template <typename T>
__device__ __forceinline__ bool rows_vec4(const T* p, int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// one problem into the tile, a warp a row (coalesced), four rows' loads in
// flight a thread before their stores; returns whether this thread loaded
// a non-finite entry
template <typename T>
__device__ bool load_rows(float* __restrict__ S, int ld, const T* __restrict__ src, int n) {
  constexpr int ROWS = 4;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool bad = false;
  if (rows_vec4(src, n)) {
    for (int c = 4 * lane; c < n; c += 128)
      for (int r0 = wid; r0 < n; r0 += ROWS * WARPS) {
        float v[ROWS][4];
#pragma unroll
        for (int b = 0; b < ROWS; ++b)
          if (r0 + b * WARPS < n) load4(src + (r0 + b * WARPS) * n + c, v[b]);
#pragma unroll
        for (int b = 0; b < ROWS; ++b)
          if (r0 + b * WARPS < n) {
#pragma unroll
            for (int t = 0; t < 4; ++t) bad |= !isfinite(v[b][t]);
            store4(S + (r0 + b * WARPS) * ld + c, v[b]);
          }
      }
  } else {
    for (int r = wid; r < n; r += WARPS)
      for (int c = lane; c < n; c += 32) {
        const float v = widen(src[r * n + c]);
        bad |= !isfinite(v);
        S[r * ld + c] = v;
      }
  }
  return bad;
}

// the factor from the tile's rows: R = Lᵀ (the strict upper triangle holds
// Lᵀ) or L, the dead triangle exactly zero
template <typename T>
__device__ void store_factor(T* dst, const float* S, int ld, int n, int upper) {
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rows_vec4(dst, n)) {
    for (int r = wid; r < n; r += WARPS)
      for (int c = 4 * lane; c < n; c += 128) {
        float v[4];
        unpack4(v, *reinterpret_cast<const float4*>(S + r * ld + c));
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (upper ? c + t < r : c + t > r) v[t] = 0.f;
        store4(dst + r * n + c, v);
      }
  } else {
    for (int r = wid; r < n; r += WARPS)
      for (int c = lane; c < n; c += 32) {
        const bool live = upper ? c >= r : c <= r;
        dst[r * n + c] = Cast<T>::from(live ? S[r * ld + c] : 0.f);
      }
  }
}

// One problem a block: the input scanned as it loads, chol_blocked on the
// tile (ld from potrf_ld), and on a fault the column sweep on the input,
// whose info is the reference's; its lower triangle is then mirrored so
// both store rows.
template <typename T>
__global__ void __launch_bounds__(NT) potrf_kernel(const T* A, T* R, int* info, int n, int ld, int upper) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const long long off = (long long)blockIdx.x * n * n;
  const bool finite = !__syncthreads_or(load_rows(S, ld, A + off, n));
  int inf = finite ? chol_blocked(S, ld, n) : -1;
  if (inf < 0) {
    if (finite) {  // chol_blocked wrote the tile
      load_rows(S, ld, A + off, n);
      __syncthreads();
    }
    inf = chol_sweep(S, ld, n);
    for (int e = threadIdx.x; e < n * n; e += NT) {
      const int i = e / n, c = e - i * n;
      if (c > i) S[i * ld + c] = S[c * ld + i];
    }
    __syncthreads();
  }
  store_factor(R + off, S, ld, n, upper);
  if (threadIdx.x == 0) info[blockIdx.x] = inf;
}

template <typename T>
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

template <typename T>
__global__ void __launch_bounds__(NT) lstsq_kernel(const T* A, const T* B, T* X, int* info, int m, int n, int k) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n), lds = n + k;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  float* P = smem;           // G's copy, then L1 (R1 = L1ᵀ) in its lower triangle
  float* Q = P + n * ld;     // G -> V -> G2 -> L2 (lower) and R = R2·R1 (upper)
  float* C = Q + n * ld;     // AᵀB -> t1 -> t2 -> X
  float* st = C + n * k;     // LSTSQ_ROWS x (n + k) stage of [A | B] rows
  const long long b = blockIdx.x;
  const T* a = A + b * m * n;
  const T* bb = B + b * m * k;

  for (int e = tid; e < n * ld; e += NT) Q[e] = 0.f;
  for (int e = tid; e < n * k; e += NT) C[e] = 0.f;
  for (int r0 = 0; r0 < m; r0 += LSTSQ_ROWS) {
    const int rows = min(LSTSQ_ROWS, m - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < LSTSQ_ROWS * lds; e += NT) {
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
        for (int r = 0; r < LSTSQ_ROWS; ++r) acc += st[r * lds + i] * st[r * lds + l];
        Q[i * ld + l] += acc;
      }
    }
    for (int e = tid; e < n * k; e += NT) {  // C = AᵀB
      const int i = e / k, c = e - i * k;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < LSTSQ_ROWS; ++r) acc += st[r * lds + i] * st[r * lds + n + c];
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

// ---------------------------------------------------------------------------
// C entries: return the cudaError_t of the launch (0 = launched), -1 for
// arguments the kernels do not take.  Every pointer is a contiguous
// (batch, rows, cols) stack; info is (batch,) int32.
// ---------------------------------------------------------------------------

// The shared-memory limit is raised to SMEM_MAX once per kernel, at its
// first launch; that covers every size the wrappers admit.
template <auto Kernel, typename... Args>
static int run(int batch, size_t smem, void* stream, Args... args) {
  if (smem > SMEM_MAX || batch < 1) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

static size_t tile_bytes(int n) { return sizeof(float) * (size_t)n * odd_ld(n); }

// The potrf tile's leading dimension: round4(n) (16-byte rows), plus 4 when
// that makes ld ≡ 4 (mod 8) and still fits, so the 16-byte row loads of
// eight lanes on eight consecutive rows hit distinct banks.  Shared memory
// is round4(n)·ld floats (ops/batched_small.smem_bytes): n <= 240 fits.
static int potrf_ld(int n) {
  const int n4 = round4(n), ld = (n4 / 4) % 2 ? n4 : n4 + 4;
  return sizeof(float) * (size_t)n4 * ld <= SMEM_MAX ? ld : n4;
}

extern "C" int capital_small_potrf(int dtype, const void* A, void* R, void* info, int batch, int n,
                                   int upper, void* stream) {
  if (n < 1) return -1;
  const int ld = potrf_ld(n);
  const size_t smem = sizeof(float) * (size_t)round4(n) * ld;
  if (dtype == DT_F32)
    return run<potrf_kernel<float>>(batch, smem, stream, (const float*)A, (float*)R, (int*)info, n, ld, upper);
  if (dtype == DT_BF16)
    return run<potrf_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (bf16*)R, (int*)info, n, ld, upper);
  return -1;
}

extern "C" int capital_small_potrs(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                   int k, int upper, void* stream) {
  if (n < 1 || k < 0) return -1;
  const size_t smem = tile_bytes(n) + sizeof(float) * (size_t)n * k;
  if (dtype == DT_F32)
    return run<potrs_kernel<float>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X, n, k, upper);
  if (dtype == DT_BF16)
    return run<potrs_kernel<bf16>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X, n, k, upper);
  return -1;
}

extern "C" int capital_small_trsm(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                  int k, int upper, int forward, void* stream) {
  if (n < 1 || k < 0) return -1;
  const size_t smem = tile_bytes(n) + sizeof(float) * (size_t)n * k;
  if (dtype == DT_F32)
    return run<trsm_kernel<float>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X, n, k, upper,
               forward);
  if (dtype == DT_BF16)
    return run<trsm_kernel<bf16>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X, n, k, upper,
               forward);
  return -1;
}

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

extern "C" int capital_small_lstsq(int dtype, const void* A, const void* B, void* X, void* info, int batch,
                                   int m, int n, int k, void* stream) {
  if (n < 1 || k < 0 || m < n) return -1;
  const size_t smem = 2 * tile_bytes(n) + sizeof(float) * ((size_t)n * k + (size_t)LSTSQ_ROWS * (n + k));
  if (dtype == DT_F32)
    return run<lstsq_kernel<float>>(batch, smem, stream, (const float*)A, (const float*)B, (float*)X,
               (int*)info, m, n, k);
  if (dtype == DT_BF16)
    return run<lstsq_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (const bf16*)B, (bf16*)X,
               (int*)info, m, n, k);
  return -1;
}
