// The fused tall passes of CholeskyQR2: gram_blocked, scale_blocked and
// scale_gram.
//
// Replaces capital_tpu/ops/qr_fused.py: gram_blocked (:147, pallas_call
// :181), scale_gram (:203, :260) and scale_blocked (:290, :328).  What the
// TPU kernels compute, kept here:
//   * gram: the upper block-row gram of tall A at column split g (c = n/g):
//     block row j holds (AᵀA)[jc:(j+1)c, jc:], the strictly lower block
//     triangle is zero.  Accumulation is f32 for bf16/f32, f64 for f64.
//   * scale: Q = A·R⁻¹ with R⁻¹ upper triangular and true zeros below the
//     diagonal, rounded once to A's dtype.  A column tile of Q reads only the
//     rows of R⁻¹ above its last column: finer than the TPU's per-column-
//     block bound, and the same values, because the skipped terms are zero
//     by contract.
//   * scale_gram: the scale, then the gram of the ROUNDED Q.
// What bounds them on the card: at the 2,097,152 x 1024 bf16 QR flagship the
// gram and the scale_gram are bound by operations (the tensor cores), the
// scale by bytes (A read, Q written).  The design answers with tensor cores
// for bf16 (WMMA m16n16k16, f32 accumulate, 128 x 128 tiles) and register-
// tiled FMA for f32/f64 (64 x 64 tiles, 4 x 4 per thread, IEEE FMA, no
// TF32); operand tiles move as 16-byte loads, the next k-step's loads in
// flight while the current one multiplies.  wgmma/TMA are later work.
//
// The TPU kernel carries the f32 (n, n) gram in VMEM across its sequential
// row-block grid.  Here blocks run in no order and an SM holds 227 KB, so the
// gram is a grid over (live output tile, row split): each block sums its
// tile over its rows in registers and writes a partial; a second pass sums
// the partials in a fixed order and zeroes the dead block triangle.  No
// atomics: the result is the same bits on every run.  scale_gram is two
// phases in one entry: the scale writes Q, the gram reads it back (one extra
// read of Q against the TPU kernel, which keeps Q_blk in VMEM).
//
// Every linear index into A or Q is 64-bit: at the flagship m·n = 2^31.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int NTHREADS = 256;

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// ---- tiles of the gram grid ----------------------------------------------

// first live tile column of tile row ti: block row j = ti·T / c starts at
// column j·c (T divides c, so a tile is wholly live or wholly dead)
__host__ __device__ inline int live_lo(int ti, int T, int c) { return (ti * T / c) * (c / T); }

__host__ inline long long live_tiles(int n, int T, int c) {
  long long cnt = 0;
  for (int i = 0; i < n / T; ++i) cnt += n / T - live_lo(i, T, c);
  return cnt;
}

__device__ inline void live_tile(int bid, int nt, int T, int c, int& ti, int& tj) {
  for (int i = 0; i < nt; ++i) {
    int cnt = nt - live_lo(i, T, c);
    if (bid < cnt) {
      ti = i;
      tj = live_lo(i, T, c) + bid;
      return;
    }
    bid -= cnt;
  }
  ti = tj = 0;  // not reached: the grid holds exactly the live tiles
}

struct GramArgs {
  const void* A;
  long long lda;
  long long m;
  int n, c;
  void* out;  // splits x n x n partial sums (G itself when splits == 1)
  int splits;
};

// ---- gram, bf16: WMMA on the tensor cores, f32 accumulate -----------------
// Output tile (ti, tj) = Σ_r A[r, ti·T + a] · A[r, tj·T + b] over this
// block's row split.  Both operands are 32-row slabs of A, T wide, stored
// k-major in shared memory: the left one is read as a col_major fragment
// (Aᵀ), the right one as row_major.  8 warps as 4 (rows) x 2 (cols), each
// 32 x 64 = 2 x 4 fragments.
__global__ void __launch_bounds__(NTHREADS) gram_wmma(GramArgs p) {
  constexpr int T = 128, BK = 32, LD = T + 8, CH = 8;  // CH bf16 per 16 bytes
  __shared__ __align__(128) bf16 Xs[BK * LD];
  __shared__ __align__(128) bf16 Ys[BK * LD];
  int ti, tj;
  live_tile(blockIdx.x, p.n / T, T, p.c, ti, tj);
  const long long rows = p.m / p.splits, r0 = (long long)blockIdx.y * rows;
  const bf16* A = (const bf16*)p.A;
  const int tid = threadIdx.x, warp = tid / 32, wr = warp / 2, wc = warp % 2;
  uint4 rx[2], ry[2];  // this thread's chunks of the next k-step
  auto load = [&](long long k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int q = tid + NTHREADS * u, row = q / (T / CH), col = (q % (T / CH)) * CH;
      const bf16* src = A + (r0 + k0 + row) * p.lda;
      rx[u] = *(const uint4*)(src + ti * T + col);
      ry[u] = *(const uint4*)(src + tj * T + col);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
  load(0);
  for (long long k0 = 0; k0 < rows; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int q = tid + NTHREADS * u, row = q / (T / CH), col = (q % (T / CH)) * CH;
      *(uint4*)(Xs + row * LD + col) = rx[u];
      *(uint4*)(Ys + row * LD + col) = ry[u];
    }
    __syncthreads();
    if (k0 + BK < rows) load(k0 + BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) wmma::load_matrix_sync(a[r], Xs + ks * LD + wr * 32 + r * 16, LD);
#pragma unroll
      for (int c = 0; c < 4; ++c) wmma::load_matrix_sync(b[c], Ys + ks * LD + wc * 64 + c * 16, LD);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) wmma::mma_sync(acc[r][c], a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = (float*)p.out + (long long)blockIdx.y * p.n * p.n;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long i = ti * T + wr * 32 + r * 16, j = tj * T + wc * 64 + c * 16;
      wmma::store_matrix_sync(out + i * p.n + j, acc[r][c], p.n, wmma::mem_row_major);
    }
}

// ---- gram, f32 / f64: register-tiled FMA ----------------------------------
template <typename T>
__global__ void __launch_bounds__(NTHREADS) gram_simt(GramArgs p) {
  constexpr int TT = 64, BK = 16, CH = 16 / sizeof(T), NCH = BK * TT / CH / NTHREADS;
  __shared__ __align__(16) T Xs[BK][TT];
  __shared__ __align__(16) T Ys[BK][TT];
  int ti, tj;
  live_tile(blockIdx.x, p.n / TT, TT, p.c, ti, tj);
  const long long rows = p.m / p.splits, r0 = (long long)blockIdx.y * rows;
  const T* A = (const T*)p.A;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  uint4 rx[NCH], ry[NCH];
  auto load = [&](long long k0) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      int q = tid + NTHREADS * u, row = q / (TT / CH), col = (q % (TT / CH)) * CH;
      const T* src = A + (r0 + k0 + row) * p.lda;
      rx[u] = *(const uint4*)(src + ti * TT + col);
      ry[u] = *(const uint4*)(src + tj * TT + col);
    }
  };
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
  load(0);
  for (long long k0 = 0; k0 < rows; k0 += BK) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      int q = tid + NTHREADS * u, row = q / (TT / CH), col = (q % (TT / CH)) * CH;
      *(uint4*)(&Xs[row][col]) = rx[u];
      *(uint4*)(&Ys[row][col]) = ry[u];
    }
    __syncthreads();
    if (k0 + BK < rows) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Xs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Ys[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fma_(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  T* out = (T*)p.out + (long long)blockIdx.y * p.n * p.n;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(long long)(ti * TT + ty + 16 * r) * p.n + tj * TT + tx + 16 * c] = acc[r][c];
}

// Sum the row-split partials in split order and zero the dead block
// triangle (element (r, col) is live iff col >= (r / c)·c).  With one split
// the partial kernel wrote G itself, and only the dead triangle is written.
template <typename A_t>
__global__ void gram_finalize(A_t* G, const A_t* W, int n, int c, int splits) {
  const long long total = (long long)n * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    int r = (int)(e / n), col = (int)(e % n);
    if (col < (r / c) * c) {
      G[e] = A_t(0);
    } else if (splits > 1) {
      A_t s = W[e];
      for (int q = 1; q < splits; ++q) s += W[q * total + e];
      G[e] = s;
    }
  }
}

template <typename T>
static int gram_launch(const GramArgs& p, void* G, cudaStream_t s) {
  typedef typename AccOf<T>::type A_t;
  constexpr int tile = sizeof(T) == 2 ? 128 : 64;
  constexpr int bk = sizeof(T) == 2 ? 32 : 16;
  if (p.n % tile || p.c % tile || p.splits < 1 || p.m % ((long long)p.splits * bk))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)live_tiles(p.n, tile, p.c), (unsigned)p.splits);
  if constexpr (sizeof(T) == 2) gram_wmma<<<grid, NTHREADS, 0, s>>>(p);
  else gram_simt<T><<<grid, NTHREADS, 0, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  long long total = (long long)p.n * p.n;
  unsigned blocks = (unsigned)((total + NTHREADS - 1) / NTHREADS);
  gram_finalize<A_t><<<blocks, NTHREADS, 0, s>>>((A_t*)G, (const A_t*)p.out, p.n, p.c, p.splits);
  return (int)cudaGetLastError();
}

static int gram_pass(int dtype, const void* A, long long lda, long long m, int n, int c,
                     void* G, void* work, int splits, cudaStream_t s) {
  GramArgs p;
  p.A = A; p.lda = lda; p.m = m; p.n = n; p.c = c;
  p.out = splits > 1 ? work : G;
  p.splits = splits;
  switch (dtype) {
    case DT_BF16: return gram_launch<bf16>(p, G, s);
    case DT_F32: return gram_launch<float>(p, G, s);
    case DT_F64: return gram_launch<double>(p, G, s);
    default: return -1;
  }
}

// ---- scale: Q = A·R⁻¹ ------------------------------------------------------

struct ScaleArgs {
  const void* A;
  long long lda;
  const void* R;
  long long ldr;
  void* Q;
  long long ldq;
  long long m;
  int n;
};

// bf16: 128 x 128 output tiles, WMMA, the f32 sum rounded once to bf16.
// Blocks walk a row panel's column tiles consecutively, so the panel of A
// is read from device memory about once and from L2 by its neighbours.
__global__ void __launch_bounds__(NTHREADS) scale_wmma(ScaleArgs p) {
  constexpr int TM = 128, TN = 128, BK = 32, LDA = BK + 8, LDB = TN + 8, CH = 8;
  __shared__ __align__(128) bf16 As[TM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float scratch[8][16 * 16];
  const int ntn = p.n / TN;
  const long long i0 = (long long)(blockIdx.x / ntn) * TM;
  const int j0 = (blockIdx.x % ntn) * TN, kend = j0 + TN;  // rows of R⁻¹ past kend are zero
  const bf16* A = (const bf16*)p.A;
  const bf16* R = (const bf16*)p.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wr = warp / 2, wc = warp % 2;
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int q = tid + NTHREADS * u;
      int arow = q / (BK / CH), acol = (q % (BK / CH)) * CH;
      ra[u] = *(const uint4*)(A + (i0 + arow) * p.lda + k0 + acol);
      int brow = q / (TN / CH), bcol = (q % (TN / CH)) * CH;
      rb[u] = *(const uint4*)(R + (long long)(k0 + brow) * p.ldr + j0 + bcol);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
  load(0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int q = tid + NTHREADS * u;
      *(uint4*)(As + (q / (BK / CH)) * LDA + (q % (BK / CH)) * CH) = ra[u];
      *(uint4*)(Bs + (q / (TN / CH)) * LDB + (q % (TN / CH)) * CH) = rb[u];
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) wmma::load_matrix_sync(a[r], As + (wr * 32 + r * 16) * LDA + ks, LDA);
#pragma unroll
      for (int c = 0; c < 4; ++c) wmma::load_matrix_sync(b[c], Bs + ks * LDB + wc * 64 + c * 16, LDB);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) wmma::mma_sync(acc[r][c], a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  // epilogue: each fragment through the warp's f32 scratch, then 8 bf16
  // (16 bytes) per lane: row lane/2, columns (lane%2)·8 ...+8
  float* sc = scratch[warp];
  bf16* Q = (bf16*)p.Q;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wmma::store_matrix_sync(sc, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = lane / 2, col = (lane % 2) * 8;
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 h = __floats2bfloat162_rn(sc[row * 16 + col + 2 * e],
                                                 sc[row * 16 + col + 2 * e + 1]);
        w[e] = *reinterpret_cast<unsigned*>(&h);
      }
      long long qi = i0 + wr * 32 + r * 16 + row;
      *(uint4*)(Q + qi * p.ldq + j0 + wc * 64 + c * 16 + col) = make_uint4(w[0], w[1], w[2], w[3]);
      __syncwarp();
    }
}

// f32 / f64: 64 x 64 output tiles, 4 x 4 FMA per thread.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) scale_simt(ScaleArgs p) {
  constexpr int TM = 64, TN = 64, BK = 16, CH = 16 / sizeof(T);
  constexpr int NCH = TM * BK / CH / NTHREADS;  // A and R⁻¹ chunks per thread
  __shared__ __align__(16) T As[TM][BK];
  __shared__ __align__(16) T Bs[BK][TN];
  const int ntn = p.n / TN;
  const long long i0 = (long long)(blockIdx.x / ntn) * TM;
  const int j0 = (blockIdx.x % ntn) * TN, kend = j0 + TN;
  const T* A = (const T*)p.A;
  const T* R = (const T*)p.R;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  uint4 ra[NCH], rb[NCH];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      int q = tid + NTHREADS * u;
      int arow = q / (BK / CH), acol = (q % (BK / CH)) * CH;
      ra[u] = *(const uint4*)(A + (i0 + arow) * p.lda + k0 + acol);
      int brow = q / (TN / CH), bcol = (q % (TN / CH)) * CH;
      rb[u] = *(const uint4*)(R + (long long)(k0 + brow) * p.ldr + j0 + bcol);
    }
  };
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
  load(0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      int q = tid + NTHREADS * u;
      *(uint4*)(&As[q / (BK / CH)][(q % (BK / CH)) * CH]) = ra[u];
      *(uint4*)(&Bs[q / (TN / CH)][(q % (TN / CH)) * CH]) = rb[u];
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty + 16 * r][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fma_(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  T* Q = (T*)p.Q;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Q[(i0 + ty + 16 * r) * p.ldq + j0 + tx + 16 * c] = acc[r][c];
}

static int scale_pass(int dtype, const ScaleArgs& p, cudaStream_t s) {
  const int tile = dtype == DT_BF16 ? 128 : 64;
  if (p.n % tile || p.m % tile) return (int)cudaErrorInvalidValue;
  long long blocks = (p.m / tile) * (p.n / tile);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  switch (dtype) {
    case DT_BF16: scale_wmma<<<(unsigned)blocks, NTHREADS, 0, s>>>(p); break;
    case DT_F32: scale_simt<float><<<(unsigned)blocks, NTHREADS, 0, s>>>(p); break;
    case DT_F64: scale_simt<double><<<(unsigned)blocks, NTHREADS, 0, s>>>(p); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// ---- C entry points: each returns the cudaError_t of its launches ---------

extern "C" int capital_gram_blocked(int dtype, const void* A, long long lda, long long m, int n,
                                    int g, void* G, void* work, int splits, void* stream) {
  return gram_pass(dtype, A, lda, m, n, n / g, G, work, splits, (cudaStream_t)stream);
}

extern "C" int capital_scale_blocked(int dtype, const void* A, long long lda, const void* R,
                                     long long ldr, void* Q, long long ldq, long long m, int n,
                                     void* stream) {
  ScaleArgs p;
  p.A = A; p.lda = lda; p.R = R; p.ldr = ldr; p.Q = Q; p.ldq = ldq; p.m = m; p.n = n;
  return scale_pass(dtype, p, (cudaStream_t)stream);
}

extern "C" int capital_scale_gram(int dtype, const void* A, long long lda, const void* R,
                                  long long ldr, void* Q, long long ldq, long long m, int n, int g,
                                  void* G, void* work, int splits, void* stream) {
  ScaleArgs p;
  p.A = A; p.lda = lda; p.R = R; p.ldr = ldr; p.Q = Q; p.ldq = ldq; p.m = m; p.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = scale_pass(dtype, p, s);
  if (rc) return rc;
  return gram_pass(dtype, Q, ldq, m, n, n / g, G, work, splits, s);
}
