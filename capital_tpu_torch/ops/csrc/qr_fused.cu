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
// What bounds them on the card: operations, in every dtype (the bf16
// flagship's scale sits at the balance point: A read and Q written take as
// long as its products).  Every dtype runs 128 x 128 output tiles: bf16 on
// the TMA + wgmma ring of wgmma_tiles.cuh (f32 accumulate), f64 on the DMMA
// loop of mm_tiles.cuh (mma.sync m16n8k8 on the FP64 tensor cores, every
// multiply-add f64), f32 on its FMA loop (IEEE fmaf, no TF32).  The
// wrapper's shape rule makes 128 divide n, c and m, so no tile is masked.
// f32 at precision 'high' takes the x3 route instead (x3_tiles.cuh): the
// split pass writes the f32 operands' bf16 hi / lo images into the caller's
// workspace and gram_x3 / scale_x3 run the ring on them, three bf16
// products a k-tile in 512-deep chains added in IEEE f32 — the reference's
// bf16x3 split (qr_fused._dot through pallas_tpu.precision_dot).
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

#include <climits>

#include "mm_tiles.cuh"
#include "wgmma_tiles.cuh"
#include "x3_tiles.cuh"

// output tile edge of every gram and scale kernel
constexpr int TILE = 128;
static_assert(wg::BM == TILE && wg::BN == TILE && mmt::D_BM == TILE && mmt::D_BN == TILE &&
                  mmt::F_BM == TILE && mmt::F_BN == TILE,
              "the three loops share one output tile");
constexpr int FIN_THREADS = 256;  // gram_finalize's blocks

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

// Row split q of S: the SPLIT_ROWS-row k-tiles [q·K/S, (q+1)·K/S) of the
// K = ceil(m/SPLIT_ROWS), whole k-tiles whose counts differ by at most one
// (gram_split_rows in ops/qr_fused.py is the same rule on the host).  Every
// loop's k-tile divides SPLIT_ROWS, so a split is whole k-tiles of each.
constexpr int SPLIT_ROWS = 64;
static_assert(wg::BK == SPLIT_ROWS && SPLIT_ROWS % mmt::D_BK == 0 && SPLIT_ROWS % mmt::F_BK == 0,
              "a split is whole k-tiles of every loop");

__device__ __forceinline__ void split_rows(long long m, int q, int S, long long& r0, long long& r1) {
  const long long K = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  r0 = q * K / S * SPLIT_ROWS;
  r1 = min(m, (q + 1) * K / S * SPLIT_ROWS);
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
// 64 rows x 64 columns), over the rows of split blockIdx.y (`split_rows`).
// The blocks of one split run side by side (blockIdx.x is the tile), so the
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
  long long r0, r1;
  split_rows(p.m, blockIdx.y, p.splits, r0, r1);
  const int nk = (int)((r1 - r0 + wg::BK - 1) / wg::BK), k0 = (int)r0;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      wg::produce<true, false>(r, &ta, &ta, ti * wg::BM, tj * wg::BN, nk,
                               [&](int t) { return k0 + t * wg::BK; }, [](int) { return false; });
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

// ---- gram, f32 at 'high': the ring on A's split images ----------------------
// gram_wgmma's tiles and splits over A's hi / lo images (both maps MN-major
// 64-row slabs, one pair for each side of the product); the partial is
// written from the IEEE f32 totals of x3::consume.
__global__ void __launch_bounds__(wg::THREADS, 1)
    gram_x3(const __grid_constant__ x3::Maps maps, GramArgs p) {
  extern __shared__ uint8_t smem[];
  int ti, tj;
  live_tile(blockIdx.x, p.n / wg::BM, wg::BM, p.c, ti, tj);
  long long r0, r1;
  split_rows(p.m, blockIdx.y, p.splits, r0, r1);
  const int nk = (int)((r1 - r0 + wg::BK - 1) / wg::BK), k0 = (int)r0;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      x3::produce<true, false>(r, maps, ti * wg::BM, tj * wg::BN, nk,
                               [&](int t) { return k0 + t * wg::BK; });
    }
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128;
    float* sum = x3::sum_of(r, ctid);
    float dh[64], dx[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dh[i] = dx[i] = 0.0f;
    x3::consume<true, false>(r, nk, ctid, sum, dh, dx);
    float* out = (float*)p.out + (long long)blockIdx.y * p.n * p.n;
    x3::store_totals(out + (long long)ti * wg::BM * p.n + tj * wg::BN, p.n, sum, ctid);
  }
}

// ---- gram, f64 / f32: the DMMA and FMA loops of mm_tiles.cuh ---------------
// The same tile and split as gram_wgmma: operand a is A[split rows, ti·128 :
// +128], operand b is A[split rows, tj·128 : +128], both stored k-major (the
// loops' <AT = true, BT = false> orientation, one window over all of A).
// Every 128-tile is wholly live, so no k-tile is masked; rows past m (a
// ragged last split) are zero-filled by the loops' loads.  A diagonal tile
// (ti == tj) reads its slab twice, the second time from L2.

// the window, tile origin and k-tiles of this block's (tile, split)
template <typename T>
__device__ __forceinline__ void gram_block(const GramArgs& p, int bk, mmt::Win<T>& w, int& i0,
                                           int& j0, int& k0, int& nk) {
  int ti, tj;
  live_tile(blockIdx.x, p.n / TILE, TILE, p.c, ti, tj);
  long long r0, r1;
  split_rows(p.m, blockIdx.y, p.splits, r0, r1);
  w = {(const T*)p.A, p.lda, (int)p.m, p.n};
  i0 = ti * TILE;
  j0 = tj * TILE;
  k0 = (int)r0;
  nk = (int)((r1 - r0 + bk - 1) / bk);
}

// this block's partial: tile (i0, j0) of plane blockIdx.y
template <typename A_t>
__device__ __forceinline__ A_t* gram_partial(const GramArgs& p, int i0, int j0) {
  return (A_t*)p.out + (long long)blockIdx.y * p.n * p.n + (long long)i0 * p.n + j0;
}

__global__ void __launch_bounds__(mmt::D_THREADS, mmt::D_MINB) gram_dmma(GramArgs p) {
  extern __shared__ __align__(16) uint8_t dmma_smem[];
  mmt::Win<double> w;
  int i0, j0, k0, nk;
  gram_block(p, mmt::D_BK, w, i0, j0, k0, nk);
  double acc[mmt::D_MI][mmt::D_NI][4];
  const auto all = [](int, int) { return true; };
  mmt::dmma_loop<true, false>(
      reinterpret_cast<double*>(dmma_smem), w, w, i0, j0, nk,
      [&](int t) { return k0 + t * mmt::D_BK; }, [](int) { return 0; }, all, all, acc);
  double* out = gram_partial<double>(p, i0, j0);
#pragma unroll
  for (int mi = 0; mi < mmt::D_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < mmt::D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        out[(long long)mmt::dmma_row(mi, x) * p.n + mmt::dmma_col(ni, x)] = acc[mi][ni][x];
}

__global__ void __launch_bounds__(mmt::F_THREADS, mmt::F_MINB) gram_fma(GramArgs p) {
  __shared__ __align__(16) mmt::FmaSmem sm;
  mmt::Win<float> w;
  int i0, j0, k0, nk;
  gram_block(p, mmt::F_BK, w, i0, j0, k0, nk);
  float acc[8][8];
  const auto all = [](int, int) { return true; };
  mmt::fma_loop<true, false>(sm, w, w, i0, j0, nk, [&](int t) { return k0 + t * mmt::F_BK; },
                             [](int) { return 0; }, all, all, acc);
  float* out = gram_partial<float>(p, i0, j0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (long long)mmt::fma_row(i) * p.n;
    *reinterpret_cast<float4*>(row + mmt::fma_col(0)) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + mmt::fma_col(4)) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
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

// Raises a DMMA kernel's dynamic shared memory to what its orientation's
// ring takes (once per device) and launches it.
template <bool AT, typename Args>
static int dmma_launch(void (*kernel)(Args), bool (&sized)[wg::MAX_DEVICES], dim3 grid,
                       const Args& p, cudaStream_t s) {
  constexpr int bytes = mmt::dmma_smem_bytes<AT, false>();
  const cudaError_t e = wg::size_smem(kernel, sized, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, mmt::D_THREADS, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// split A into its images at `images`, then gram_x3 on them
static int gram_x3_launch(const GramArgs& p, bf16* images, dim3 grid, cudaStream_t s) {
  int rc = x3::split(p.A, p.lda, p.m, p.n, UPLO_NONE, images, s);
  if (rc) return rc;
  x3::Maps maps;
  if (!x3::image_maps(maps.a, images, p.m, p.n, wg::BM / 2)) return -2;
  maps.b[0] = maps.a[0];
  maps.b[1] = maps.a[1];
  static bool sized[wg::MAX_DEVICES] = {};
  const cudaError_t e = wg::size_smem(gram_x3, sized, x3::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  gram_x3<<<grid, wg::THREADS, x3::SMEM_BYTES, s>>>(maps, p);
  return (int)cudaGetLastError();
}

// one split rule for every dtype: any count up to ceil(m / SPLIT_ROWS);
// `images` (f32 only) selects the x3 route
template <typename T>
static int gram_launch(const GramArgs& p, void* G, bf16* images, cudaStream_t s) {
  typedef typename AccOf<T>::type A_t;
  if (p.n % TILE || p.c % TILE || p.splits < 1 || p.m < 1 || p.m > INT_MAX ||
      p.splits > (p.m + SPLIT_ROWS - 1) / SPLIT_ROWS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)live_tiles(p.n, TILE, p.c), (unsigned)p.splits);
  int rc;
  if (images) {
    rc = gram_x3_launch(p, images, grid, s);
  } else if constexpr (sizeof(T) == 2) {
    rc = gram_wgmma_launch(p, grid, s);
  } else if constexpr (sizeof(T) == 8) {
    static bool sized[wg::MAX_DEVICES] = {};
    rc = dmma_launch<true>(gram_dmma, sized, grid, p, s);
  } else {
    gram_fma<<<grid, mmt::F_THREADS, 0, s>>>(p);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  long long total = (long long)p.n * p.n;
  unsigned blocks = (unsigned)((total + FIN_THREADS - 1) / FIN_THREADS);
  gram_finalize<A_t><<<blocks, FIN_THREADS, 0, s>>>((A_t*)G, (const A_t*)p.out, p.n, p.c, p.splits);
  return (int)cudaGetLastError();
}

static int gram_pass(int dtype, const void* A, long long lda, long long m, int n, int c,
                     void* G, void* work, int splits, bf16* images, cudaStream_t s) {
  GramArgs p;
  p.A = A; p.lda = lda; p.m = m; p.n = n; p.c = c;
  p.out = splits > 1 ? work : G;
  p.splits = splits;
  if (images && dtype != DT_F32) return -1;
  switch (dtype) {
    case DT_BF16: return gram_launch<bf16>(p, G, nullptr, s);
    case DT_F32: return gram_launch<float>(p, G, images, s);
    case DT_F64: return gram_launch<double>(p, G, nullptr, s);
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
  i0 = panel * TILE;
  j0 = (int)((b + panel) % ntn) * TILE;
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

// ---- scale, f32 at 'high': the ring on A's and R⁻¹'s split images ----------
// scale_wgmma's persistent walk and tile order over the images (A K-major,
// R⁻¹ MN-major); one k-tile counter runs on across tiles for stages and
// phases, so the producer loads the next tile while the consumers store
// this one.  Q is written in f32 from the IEEE f32 totals of x3::consume.
__global__ void __launch_bounds__(wg::THREADS, 1)
    scale_x3(const __grid_constant__ x3::Maps maps, ScaleArgs p) {
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
      x3::produce<false, false>(r, maps, (int)i0, j0, nk, [](int t) { return t * wg::BK; }, g);
      g += nk;
    }
    return;
  }
  wg::consumer_regs();
  const int ctid = threadIdx.x - 128;
  float* sum = x3::sum_of(r, ctid);
  float* Q = (float*)p.Q;
  float dh[64], dx[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dh[i] = dx[i] = 0.0f;
  uint32_t g = 0;  // k-tiles consumed so far
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    long long i0;
    int j0;
    scale_tile(b, ntn, i0, j0);
    const int nk = (j0 + wg::BN) / wg::BK;
    x3::consume<false, false>(r, nk, ctid, sum, dh, dx, g);
    g += nk;
    x3::store_totals(Q + i0 * p.ldq + j0, p.ldq, sum, ctid);
  }
}

// split A and R⁻¹ into their images at `images` (A's, then R⁻¹'s), then
// scale_x3 on them, one block an SM
static int scale_x3_launch(const ScaleArgs& p, long long tiles, bf16* images, cudaStream_t s) {
  bf16* rimg = images + x3::image_elems(p.m, p.n);
  int rc = x3::split(p.A, p.lda, p.m, p.n, UPLO_NONE, images, s);
  if (rc == 0) rc = x3::split(p.R, p.ldr, p.n, p.n, UPLO_NONE, rimg, s);
  if (rc) return rc;
  x3::Maps maps;
  if (!x3::image_maps(maps.a, images, p.m, p.n, wg::BM) ||
      !x3::image_maps(maps.b, rimg, p.n, p.n, wg::BN / 2))
    return -2;
  static bool sized[wg::MAX_DEVICES] = {};
  cudaError_t e = wg::size_smem(scale_x3, sized, x3::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  scale_x3<<<blocks, wg::THREADS, x3::SMEM_BYTES, s>>>(maps, p);
  return (int)cudaGetLastError();
}

// ---- scale, f64 / f32: the DMMA and FMA loops of mm_tiles.cuh --------------
// Q tile (i0, j0) = A[i0:i0+128, :j0+128] · R⁻¹[:j0+128, j0:j0+128], the
// loops' <false, false> orientation; as in scale_wgmma the k-range stops at
// the tile's last column, so no k-tile is masked.  One block a tile, tile
// `scale_tile32(blockIdx.x)`: a panel's column tiles are neighbours in the
// grid, so the panel comes from device memory about once and then from L2,
// and the hardware hands each SM its next tile as one ends, which evens out
// the k-ranges (up to ntn-fold apart).  scale_tile32 is scale_tile's map in
// 32-bit arithmetic (scale_pass keeps the grid and m below 2^31): with the
// 64-bit map scale_fma spilled 16 bytes at its 128-register cap.
__device__ __forceinline__ void scale_tile32(unsigned b, unsigned ntn, int& i0, int& j0) {
  const unsigned panel = b / ntn;
  i0 = (int)(panel * TILE);
  j0 = (int)((b + panel) % ntn) * TILE;
}

template <typename T>
__device__ __forceinline__ void scale_windows(const ScaleArgs& p, mmt::Win<T>& wa, mmt::Win<T>& wr) {
  wa = {(const T*)p.A, p.lda, (int)p.m, p.n};
  wr = {(const T*)p.R, p.ldr, p.n, p.n};
}

__global__ void __launch_bounds__(mmt::D_THREADS, mmt::D_MINB) scale_dmma(ScaleArgs p) {
  extern __shared__ __align__(16) uint8_t dmma_smem[];
  mmt::Win<double> wa, wr;
  scale_windows(p, wa, wr);
  int i0, j0;
  scale_tile32(blockIdx.x, p.n / TILE, i0, j0);
  const auto all = [](int, int) { return true; };
  double acc[mmt::D_MI][mmt::D_NI][4];
  mmt::dmma_loop<false, false>(
      reinterpret_cast<double*>(dmma_smem), wa, wr, i0, j0, (j0 + TILE) / mmt::D_BK,
      [](int t) { return t * mmt::D_BK; }, [](int) { return 0; }, all, all, acc);
  double* Q = (double*)p.Q + (long long)i0 * p.ldq + j0;
#pragma unroll
  for (int mi = 0; mi < mmt::D_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < mmt::D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        Q[(long long)mmt::dmma_row(mi, x) * p.ldq + mmt::dmma_col(ni, x)] = acc[mi][ni][x];
}

__global__ void __launch_bounds__(mmt::F_THREADS, mmt::F_MINB) scale_fma(ScaleArgs p) {
  __shared__ __align__(16) mmt::FmaSmem sm;
  mmt::Win<float> wa, wr;
  scale_windows(p, wa, wr);
  int i0, j0;
  scale_tile32(blockIdx.x, p.n / TILE, i0, j0);
  const auto all = [](int, int) { return true; };
  float acc[8][8];
  mmt::fma_loop<false, false>(sm, wa, wr, i0, j0, (j0 + TILE) / mmt::F_BK,
                              [](int t) { return t * mmt::F_BK; }, [](int) { return 0; }, all,
                              all, acc);
  float* Q = (float*)p.Q + (long long)i0 * p.ldq + j0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = Q + (long long)mmt::fma_row(i) * p.ldq;
    *reinterpret_cast<float4*>(row + mmt::fma_col(0)) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + mmt::fma_col(4)) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// `images` (f32 only) selects the x3 route
static int scale_pass(int dtype, const ScaleArgs& p, bf16* images, cudaStream_t s) {
  if (p.n % TILE || p.m % TILE || p.m > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long tiles = (p.m / TILE) * (p.n / TILE);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (images) return dtype == DT_F32 ? scale_x3_launch(p, tiles, images, s) : -1;
  switch (dtype) {
    case DT_BF16: return scale_wgmma_launch(p, tiles, s);
    case DT_F32: scale_fma<<<(unsigned)tiles, mmt::F_THREADS, 0, s>>>(p); break;
    case DT_F64: {
      static bool sized[wg::MAX_DEVICES] = {};
      return dmma_launch<false>(scale_dmma, sized, dim3((unsigned)tiles), p, s);
    }
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// ---- C entry points: each returns the cudaError_t of its launches ---------
// `images` is null on the dtype's own route; for f32 at precision 'high' it
// is the x3 route's workspace: A's bf16 images (x3::image_elems(m, n)), then,
// for the scales, R⁻¹'s (x3::image_elems(n, n)).  scale_gram splits its Q
// into the space A's images held once the scale is done (stream order).

extern "C" int capital_gram_blocked(int dtype, const void* A, long long lda, long long m, int n,
                                    int g, void* G, void* work, int splits, void* images,
                                    void* stream) {
  return gram_pass(dtype, A, lda, m, n, n / g, G, work, splits, (bf16*)images,
                   (cudaStream_t)stream);
}

extern "C" int capital_scale_blocked(int dtype, const void* A, long long lda, const void* R,
                                     long long ldr, void* Q, long long ldq, long long m, int n,
                                     void* images, void* stream) {
  ScaleArgs p;
  p.A = A; p.lda = lda; p.R = R; p.ldr = ldr; p.Q = Q; p.ldq = ldq; p.m = m; p.n = n;
  return scale_pass(dtype, p, (bf16*)images, (cudaStream_t)stream);
}

extern "C" int capital_scale_gram(int dtype, const void* A, long long lda, const void* R,
                                  long long ldr, void* Q, long long ldq, long long m, int n, int g,
                                  void* G, void* work, int splits, void* images, void* stream) {
  ScaleArgs p;
  p.A = A; p.lda = lda; p.R = R; p.ldr = ldr; p.Q = Q; p.ldq = ldq; p.m = m; p.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = scale_pass(dtype, p, (bf16*)images, s);
  if (rc) return rc;
  return gram_pass(dtype, Q, ldq, m, n, n / g, G, work, splits, (bf16*)images, s);
}
