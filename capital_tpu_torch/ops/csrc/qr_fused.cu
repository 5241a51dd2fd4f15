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
// gram is bound by operations (the tensor cores), the scale sits at the
// balance point (A read and Q written take as long as its products).  bf16
// runs on the TMA + wgmma ring of wgmma_tiles.cuh (128 x 128 tiles, f32
// accumulate); f32 / f64 on register-tiled FMA (64 x 64 tiles, 4 x 4 per
// thread, IEEE FMA, no TF32), operand tiles moving as 16-byte loads with the
// next k-step's loads in flight while the current one multiplies.
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

#include "wgmma_tiles.cuh"

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

// ---- gram, bf16: TMA + wgmma, f32 accumulate ------------------------------
// Output tile (ti, tj) = Σ_r A[r, ti·T + a] · A[r, tj·T + b] over this
// block's row split: the ring's <AT = true, BT = false> orientation, both
// operands MN-major 64-row slabs of A read through one tensor map (boxes of
// 64 rows x 64 columns).  Split q of S takes the 64-row k-tiles
// [q·K/S, (q+1)·K/S) of the K = ceil(m/64): whole k-tiles whose counts
// differ by at most one (gram_split_rows in ops/qr_fused.py is the same
// rule on the host).  T = 128 divides c, so no tile needs masking.  The
// blocks of one split run side by side (blockIdx.x is the tile), so the
// slabs they share come from L2.
//
// Two-level sums: wgmma's f32 accumulation does not round to nearest, and
// its error grows with the chain (a split's chain is ~3,000 k-tiles at the
// flagship: ~1e-3 relative on the diagonal).  So wgmma sums chains of
// GRAM_CHAIN k-tiles (restarting with scale-d 0, the accumulator registers
// never written by other instructions), and each chain is added in IEEE f32
// to a second register sum once its products are done, as the TPU kernel
// adds each row block's product to its f32 scratch.
constexpr int GRAM_CHAIN = 32;

__global__ void __launch_bounds__(wg::THREADS, 1)
    gram_wgmma(const __grid_constant__ CUtensorMap ta, GramArgs p) {
  extern __shared__ uint8_t smem[];
  int ti, tj;
  live_tile(blockIdx.x, p.n / wg::BM, wg::BM, p.c, ti, tj);
  const long long kt = (p.m + wg::BK - 1) / wg::BK;
  const int t0 = (int)(blockIdx.y * kt / p.splits);
  const int nk = (int)((blockIdx.y + 1) * kt / p.splits) - t0;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      wg::produce<true, false>(r, &ta, &ta, ti * wg::BM, tj * wg::BN, nk,
                               [&](int t) { return (t0 + t) * wg::BK; }, [](int) { return false; });
    }
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128, wgi = ctid >> 7;
    float d[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = sum[i] = 0.0f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % wg::STAGES;
      wg::bar_wait(r.full(s), (t / wg::STAGES) & 1);
      wg::fence_acc(d);
      wg::wgmma_fence();
      wg::mma_stage<true, false>(r, s, wgi, d, t % GRAM_CHAIN != 0);
      wg::wgmma_commit();
      wg::fence_acc(d);
      if (t % GRAM_CHAIN == GRAM_CHAIN - 1 || t == nk - 1) {
        wg::wgmma_wait<0>();
        wg::fence_acc(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += d[i];
      } else {
        wg::wgmma_wait<1>();
        wg::fence_acc(d);
      }
      if (t > 0 && (ctid & 127) == 0) wg::bar_arrive(r.empty((t - 1) % wg::STAGES));
    }
    const float* acc = wg::stage_acc(r, ctid, sum);
    float* out = (float*)p.out + (long long)blockIdx.y * p.n * p.n;
    for (int e = ctid; e < wg::BM * wg::BN / 4; e += 256) {
      const int row = e / (wg::BN / 4), col = (e % (wg::BN / 4)) * 4;
      *reinterpret_cast<float4*>(out + (long long)(ti * wg::BM + row) * p.n + tj * wg::BN + col) =
          *reinterpret_cast<const float4*>(acc + row * wg::EPI_LD + col);
    }
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

static int gram_wgmma_launch(const GramArgs& p, dim3 grid, cudaStream_t s) {
  CUtensorMap ta;
  if (!wg::make_map(&ta, p.A, p.m, p.n, p.lda, wg::BM / 2)) return -2;
  static bool sized[wg::MAX_DEVICES] = {};
  const cudaError_t e = wg::size_smem(gram_wgmma, sized);
  if (e != cudaSuccess) return (int)e;
  gram_wgmma<<<grid, wg::THREADS, wg::SMEM_BYTES, s>>>(ta, p);
  return (int)cudaGetLastError();
}

// bf16 splits are whole 64-row k-tiles of any count up to K; the f32 / f64
// kernel's splits are equal and whole 16-row steps
template <typename T>
static int gram_launch(const GramArgs& p, void* G, cudaStream_t s) {
  typedef typename AccOf<T>::type A_t;
  constexpr bool wide = sizeof(T) == 2;
  constexpr int tile = wide ? wg::BM : 64;
  if (p.n % tile || p.c % tile || p.splits < 1 || p.m < 1 ||
      (wide ? p.splits > (p.m + wg::BK - 1) / wg::BK : p.m % ((long long)p.splits * 16) != 0))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)live_tiles(p.n, tile, p.c), (unsigned)p.splits);
  int rc;
  if constexpr (wide) {
    rc = gram_wgmma_launch(p, grid, s);
  } else {
    gram_simt<T><<<grid, NTHREADS, 0, s>>>(p);
    rc = (int)cudaGetLastError();
  }
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

// ---- scale, bf16: TMA + wgmma, persistent ----------------------------------
// Q tile (i0, j0) = A[i0:i0+128, :j0+128] · R⁻¹[:j0+128, j0:j0+128]: the
// ring's <false, false> orientation, A K-major (boxes of 128 rows x 64),
// R⁻¹ MN-major (two boxes of 64 k-rows x 64).  The tile's k-range stops at
// its last column (the rows of R⁻¹ below are zero by contract), so no
// k-tile is masked.
//
// One block per SM walks tiles b = blockIdx.x, + gridDim.x, ...: the ring
// runs on across tiles (one k-tile counter for stage and phase), so the
// producer loads the next tile while the consumers round and store this
// one.  Tile b is row panel b / ntn and column tile (b + b / ntn) % ntn:
// the column tiles of a panel are neighbours in b (the panel is read from
// device memory about once and then from L2), and the rotation hands every
// block every column tile in turn (their k-ranges differ up to ntn-fold).
// Each consumer warpgroup rounds its 64 rows to bf16 once into its own
// staging rows beside the ring and stores them as 16-byte row segments.
constexpr int SCALE_LD = wg::BN + 8;  // bf16 pitch of a staging row: 4 banks apart
constexpr int SCALE_STAGE_OFF = wg::STAGES * wg::STAGE_BYTES + 3 * wg::STAGES * 8;
constexpr int SCALE_SMEM = wg::SMEM_BYTES + wg::BM * SCALE_LD * 2;

__device__ __forceinline__ void scale_tile(long long b, int ntn, long long& i0, int& j0) {
  const long long panel = b / ntn;
  i0 = panel * wg::BM;
  j0 = (int)((b + panel) % ntn) * wg::BN;
}

// the 128 threads of consumer warpgroup wgi (named barriers 3 and 4)
__device__ __forceinline__ void warpgroup_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wgi) : "memory");
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    scale_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tr,
                ScaleArgs p) {
  extern __shared__ uint8_t smem[];
  const wg::Ring r = wg::make_ring(smem);
  const int ntn = p.n / wg::BN;
  const long long tiles = (p.m / wg::BM) * ntn;
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x != 0) return;
    uint32_t g = 0;  // k-tiles loaded so far
    for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
      long long i0;
      int j0;
      scale_tile(b, ntn, i0, j0);
      const int nk = (j0 + wg::BN) / wg::BK;
      for (int t = 0; t < nk; ++t, ++g) {
        const int s = g % wg::STAGES;
        wg::bar_wait(r.empty(s), ((g / wg::STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t fb = r.full(s), sb = wg::saddr(r.b(s));
        wg::bar_expect_tx(fb, wg::STAGE_BYTES);
        wg::tma_load(wg::saddr(r.a(s)), &ta, fb, t * wg::BK, (int)i0);
        wg::tma_load(sb, &tr, fb, j0, t * wg::BK);
        wg::tma_load(sb + wg::B_BYTES / 2, &tr, fb, j0 + wg::BN / 2, t * wg::BK);
      }
    }
    return;
  }
  wg::consumer_regs();
  const int ctid = threadIdx.x - 128, wgi = ctid >> 7, wtid = ctid & 127;
  bf16* stage = reinterpret_cast<bf16*>(r.base + SCALE_STAGE_OFF) + wgi * (wg::BM / 2) * SCALE_LD;
  int r0, c0;
  wg::acc_origin(ctid, r0, c0);
  r0 -= wgi * (wg::BM / 2);  // row within this warpgroup's 64
  bf16* Q = (bf16*)p.Q;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  uint32_t g = 0;  // k-tiles consumed so far
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    long long i0;
    int j0;
    scale_tile(b, ntn, i0, j0);
    const int nk = (j0 + wg::BN) / wg::BK;
    for (int t = 0; t < nk; ++t, ++g) {
      const int s = g % wg::STAGES;
      wg::bar_wait(r.full(s), (g / wg::STAGES) & 1);
      wg::fence_acc(d);
      wg::wgmma_fence();
      wg::mma_stage<false, false>(r, s, wgi, d, t > 0);
      wg::wgmma_commit();
      wg::fence_acc(d);
      wg::wgmma_wait<1>();
      wg::fence_acc(d);
      if (t > 0 && wtid == 0) wg::bar_arrive(r.empty((g - 1) % wg::STAGES));
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(d);
    if (wtid == 0) wg::bar_arrive(r.empty((g - 1) % wg::STAGES));
    warpgroup_sync(wgi);  // the previous tile's staging rows are stored
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * h) * SCALE_LD + c0 + 8 * j) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    warpgroup_sync(wgi);
    const long long row0 = i0 + wgi * (wg::BM / 2);
    for (int e = wtid; e < (wg::BM / 2) * (wg::BN / 8); e += 128) {
      const int row = e / (wg::BN / 8), col = (e % (wg::BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Q + (row0 + row) * p.ldq + j0 + col) =
          *reinterpret_cast<const uint4*>(stage + row * SCALE_LD + col);
    }
  }
}

static int scale_wgmma_launch(const ScaleArgs& p, long long tiles, cudaStream_t s) {
  CUtensorMap ta, tr;
  if (!wg::make_map(&ta, p.A, p.m, p.n, p.lda, wg::BM) ||
      !wg::make_map(&tr, p.R, p.n, p.n, p.ldr, wg::BN / 2))
    return -2;
  static bool sized[wg::MAX_DEVICES] = {};
  cudaError_t e = wg::size_smem(scale_wgmma, sized, SCALE_SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  scale_wgmma<<<blocks, wg::THREADS, SCALE_SMEM, s>>>(ta, tr, p);
  return (int)cudaGetLastError();
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
    case DT_BF16: return scale_wgmma_launch(p, blocks, s);
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
