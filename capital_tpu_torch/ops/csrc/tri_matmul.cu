// tri_matmul: C = alpha * op(A) @ op(B), with at most one triangular operand
// or a triangular output, fused beta * C at flush, operands read through
// windows of flat row-major buffers and the result written into a window.
//
// Replaces capital_tpu/ops/pallas_tpu.py:tri_matmul (trmm_kernel,
// syrk_kernel, dense_kernel).  What the TPU kernel computes, kept here:
//   * dead triangular tiles are never visited: a triangular operand limits
//     each output tile's k loop to its live range (trmm form); a triangular
//     output launches only its live tiles, through a 1-D grid mapped onto the
//     tile triangle (syrk form);
//   * tiles that straddle the diagonal are masked against window-relative
//     indices of the untransposed operand, by select, so garbage (NaN) in a
//     dead half never reaches the sum;
//   * flush: alpha, then the out_uplo mask, then + beta * C at the promoted
//     type, then one cast.  Accumulation is f32 for bf16/f32 and f64 for f64;
//     f32 is IEEE FMA (no TF32).
// What bounds it on the card: operations.  cholinv's trmm/syrk windows are
// thousands wide, far above the H100's ~295 flop/byte balance point.
//
// Seven routes, chosen by the wrapper (ops/hopper.py) before the launch:
//   * wgmma (bf16 windows whose A and B origins and leading dimensions are
//     16-byte aligned, as TMA needs): mm_wgmma, the TMA + wgmma ring of
//     wgmma_tiles.cuh.  128 x 128 tiles, k-tile 64; k_range still bounds
//     each tile's k loop, and the at most two k-tiles that straddle the
//     diagonal are zeroed by select in shared memory (by the producer
//     warpgroup's spare warps) before any wgmma reads them.  The epilogue
//     flushes the accumulators, staged as f32 in shared memory, in 16-byte
//     row segments.  Tiles launch longest k-range first, so the short tiles
//     fill the last wave;
//   * wmma (bf16 windows that TMA cannot take): mm_wmma, WMMA m16n16k16
//     128 x 128 tiles with element loads into one shared buffer;
//   * dmma (f64 windows with the same 16-byte alignment): mm_dmma, the
//     DMMA loop of mm_tiles.cuh on the FP64 tensor cores — 128 x 128 tiles,
//     a 3-stage cp.async ring, the straddling k-tiles masked in shared
//     memory; every multiply-add in f64, only the order of the sums differs
//     from the plain version;
//   * fma (f32 windows with that alignment): mm_fma, the pipelined IEEE-FMA
//     loop of mm_tiles.cuh — 128 x 128 tiles, 8 x 8 outputs a thread, the
//     next k-slice in flight during the FMAs;
//   * simt (unaligned f32 and f64 windows): mm_simt, register-tiled FMA
//     64 x 64 tiles with element loads;
//   * x3 (f32 windows with that alignment at precision 'high'): the split
//     pass of x3_tiles.cuh writes both windows' bf16 hi / lo images into the
//     caller's workspace, then mm_x3 runs the TMA + wgmma ring on them,
//     three bf16 products a k-tile (hi·hi, hi·lo + lo·hi) in 512-deep chains
//     added in IEEE f32 — the reference's bf16x3 split;
//   * simt3 (other f32 windows at 'high'): mm_simt3, mm_simt's tiles with
//     each element split as it is staged.
// dmma, fma and x3 launch their tiles longest k-range first, as wgmma does.
//
// The sequential (tile, k) pair axis of the TPU grid becomes the k loop
// inside one thread block: blocks own disjoint output tiles, so nothing is
// carried between blocks.

#include "mm_tiles.cuh"
#include "wgmma_tiles.cuh"
#include "x3_tiles.cuh"

using namespace nvcuda;

struct MM {
  const void* A;
  long long lda;
  const void* B;
  long long ldb;
  void* O;
  long long ldo;
  const void* C;
  long long ldc;
  double alpha, beta;
  int M, N, K;
  int a_tri, b_tri;  // uplo of the untransposed triangular window, or 0
  int out_uplo;
  int fused_c;
  int all_tiles;  // grid covers every output tile; dead ones are zeroed
  int ntm, ntn;
  int bm, bn;
};

// live output columns [lo, hi) of tile-row i under out_uplo — the JAX
// kernel's tile predicate i*bm < (j+1)*bn ('U') / j*bn < (i+1)*bm ('L')
__host__ __device__ inline void live_cols(const MM& p, int i, int& lo, int& hi) {
  lo = 0;
  hi = p.ntn;
  if (p.out_uplo == UPLO_U) {
    long long l = ((long long)i * p.bm) / p.bn;
    lo = l < p.ntn ? (int)l : p.ntn;
  } else if (p.out_uplo == UPLO_L) {
    long long h = ((long long)(i + 1) * p.bm + p.bn - 1) / p.bn;
    hi = h < p.ntn ? (int)h : p.ntn;
  }
}

__device__ inline void tile_of(const MM& p, int bid, int& ti, int& tj, bool& live) {
  if (p.out_uplo == UPLO_NONE || p.all_tiles) {
    ti = bid / p.ntn;
    tj = bid % p.ntn;
    int lo, hi;
    live_cols(p, ti, lo, hi);
    live = tj >= lo && tj < hi;
    return;
  }
  for (int i = 0; i < p.ntm; ++i) {
    int lo, hi;
    live_cols(p, i, lo, hi);
    int cnt = hi > lo ? hi - lo : 0;
    if (bid < cnt) {
      ti = i;
      tj = lo + bid;
      live = true;
      return;
    }
    bid -= cnt;
  }
  ti = p.ntm;
  tj = 0;
  live = false;
}

// live k range of the output tile at (i0, j0): a triangular operand bounds it
__device__ inline void k_range(const MM& p, bool at, bool bt, int i0, int j0,
                               int bm, int bn, int bk, int& kb, int& ke) {
  kb = 0;
  ke = p.K;
  if (p.a_tri) {
    bool upper = (p.a_tri == UPLO_U) != at;  // op(A)(i, k) != 0 needs k >= i
    if (upper) kb = i0;
    else ke = min(p.K, i0 + bm);
  }
  if (p.b_tri) {
    bool upper = (p.b_tri == UPLO_U) != bt;  // op(B)(k, j) != 0 needs k <= j
    if (upper) ke = min(p.K, j0 + bn);
    else kb = j0;
  }
  kb = (kb / bk) * bk;
}

template <typename T, bool AT>
__device__ __forceinline__ T load_a(const MM& p, const T* A, int i, int k) {
  if (i >= p.M || k >= p.K) return zero_of<T>();
  long long r = AT ? k : i, c = AT ? i : k;
  if (p.a_tri && !in_tri(p.a_tri, r, c)) return zero_of<T>();
  return A[r * p.lda + c];
}

template <typename T, bool BT>
__device__ __forceinline__ T load_b(const MM& p, const T* B, int k, int j) {
  if (k >= p.K || j >= p.N) return zero_of<T>();
  long long r = BT ? j : k, c = BT ? k : j;
  if (p.b_tri && !in_tri(p.b_tri, r, c)) return zero_of<T>();
  return B[r * p.ldb + c];
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// flush one element: alpha, out_uplo mask (select), + beta * C, one cast.
// Explicit _rn operations keep the compiler from contracting the epilogue
// into an FMA, so it rounds like the plain version.
template <typename T>
__device__ __forceinline__ void flush(const MM& p, T* O, const T* C, int i, int j,
                                      typename AccOf<T>::type acc) {
  typedef typename AccOf<T>::type A_t;
  if (i >= p.M || j >= p.N) return;
  A_t v = mul_rn((A_t)p.alpha, acc);
  if (!in_tri(p.out_uplo, i, j)) v = A_t(0);
  if (p.fused_c) v = add_rn(v, mul_rn((A_t)p.beta, widen(C[(long long)i * p.ldc + j])));
  O[(long long)i * p.ldo + j] = Cast<T>::from(v);
}

template <typename T>
__device__ inline void zero_tile(const MM& p, T* O, int i0, int j0, int bm, int bn) {
  for (int e = threadIdx.x; e < bm * bn; e += blockDim.x) {
    int i = i0 + e / bn, j = j0 + e % bn;
    if (i < p.M && j < p.N) O[(long long)i * p.ldo + j] = zero_of<T>();
  }
}

// ---- f32 / f64: register-tiled FMA -----------------------------------------
template <typename T, bool AT, bool BT>
__global__ void __launch_bounds__(256) mm_simt(MM p) {
  constexpr int BM = mmt::S_BM, BN = mmt::S_BN, BK = mmt::S_BK;
  typedef typename AccOf<T>::type A_t;
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN + 1];
  int ti, tj;
  bool live;
  tile_of(p, blockIdx.x, ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  T* O = (T*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  const T* A = (const T*)p.A;
  const T* B = (const T*)p.B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  A_t acc[4][4];
  mmt::simt_zero<T>(acc);
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      int ii = AT ? e % BM : e / BK, kk = AT ? e / BM : e % BK;
      As[kk][ii] = load_a<T, AT>(p, A, i0 + ii, k0 + kk);
    }
    for (int e = tid; e < BK * BN; e += 256) {
      int jj = BT ? e / BK : e % BN, kk = BT ? e % BK : e / BN;
      Bs[kk][jj] = load_b<T, BT>(p, B, k0 + kk, j0 + jj);
    }
    __syncthreads();
    mmt::simt_step<T>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  const T* C = (const T*)p.C;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) flush(p, O, C, i0 + ty + 16 * r, j0 + tx + 16 * c, acc[r][c]);
}

// ---- f32 at 'high', any window: mm_simt's tiles with the split (simt3) -----
template <bool AT, bool BT>
__global__ void __launch_bounds__(256) mm_simt3(MM p) {
  constexpr int BM = mmt::S_BM, BN = mmt::S_BN, BK = mmt::S_BK;
  __shared__ x3::Simt3Smem sm;
  int ti, tj;
  bool live;
  tile_of(p, blockIdx.x, ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  float* O = (float*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  const float* A = (const float*)p.A;
  const float* B = (const float*)p.B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float sh[4][4], sx[4][4], total[4][4];
  mmt::simt_zero<float>(sh);
  mmt::simt_zero<float>(sx);
  mmt::simt_zero<float>(total);
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  for (int k0 = kb, slice = 1; k0 < ke; k0 += BK, ++slice) {
    for (int e = tid; e < BM * BK; e += 256) {
      int ii = AT ? e % BM : e / BK, kk = AT ? e / BM : e % BK;
      x3::stage(sm.ah, sm.al, kk, ii, load_a<float, AT>(p, A, i0 + ii, k0 + kk));
    }
    for (int e = tid; e < BK * BN; e += 256) {
      int jj = BT ? e / BK : e % BN, kk = BT ? e % BK : e / BN;
      x3::stage(sm.bh, sm.bl, kk, jj, load_b<float, BT>(p, B, k0 + kk, j0 + jj));
    }
    __syncthreads();
    x3::simt3_step(sm, tx, ty, sh, sx);
    __syncthreads();
    if (slice % x3::S3_CHAIN == 0 || k0 + BK >= ke) x3::simt3_fold(sh, sx, total);
  }
  const float* C = (const float*)p.C;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) flush(p, O, C, i0 + ty + 16 * r, j0 + tx + 16 * c, total[r][c]);
}

// ---- bf16: WMMA on the tensor cores, f32 accumulate ------------------------
// 8 warps as 4 (rows) x 2 (cols); each warp owns 32 x 64 of the 128 x 128
// tile = 2 x 4 fragments.  Shared tiles are stored in the operand's memory
// orientation (row_major or col_major fragments), so every global load is
// contiguous across a warp.
template <bool AT, bool BT>
__global__ void __launch_bounds__(256) mm_wmma(MM p) {
  constexpr int BM = mmt::W_BM, BN = mmt::W_BN, BK = mmt::W_BK;
  constexpr int LDA = mmt::WmmaA<AT>::LD;  // As[k][i] if AT else As[i][k]
  constexpr int LDB = mmt::WmmaB<BT>::LD;  // Bs[j][k] if BT else Bs[k][j]
  __shared__ __align__(32) bf16 As[mmt::WmmaA<AT>::SIZE];
  __shared__ __align__(32) bf16 Bs[mmt::WmmaB<BT>::SIZE];
  __shared__ __align__(32) float scratch[8][16 * 16];
  int ti, tj;
  bool live;
  tile_of(p, blockIdx.x, ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  bf16* O = (bf16*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  const bf16* A = (const bf16*)p.A;
  const bf16* B = (const bf16*)p.B;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  mmt::AccFrag acc[2][4];
  mmt::wmma_zero(acc);
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      if (AT) {
        int ii = e % BM, kk = e / BM;
        As[kk * LDA + ii] = load_a<bf16, AT>(p, A, i0 + ii, k0 + kk);
      } else {
        int ii = e / BK, kk = e % BK;
        As[ii * LDA + kk] = load_a<bf16, AT>(p, A, i0 + ii, k0 + kk);
      }
    }
    for (int e = tid; e < BK * BN; e += 256) {
      if (BT) {
        int jj = e / BK, kk = e % BK;
        Bs[jj * LDB + kk] = load_b<bf16, BT>(p, B, k0 + kk, j0 + jj);
      } else {
        int jj = e % BN, kk = e / BN;
        Bs[kk * LDB + jj] = load_b<bf16, BT>(p, B, k0 + kk, j0 + jj);
      }
    }
    __syncthreads();
    mmt::wmma_step<AT, BT>(As, Bs, wr, wc, acc);
    __syncthreads();
  }
  const bf16* C = (const bf16*)p.C;
  float* sc = scratch[warp];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wmma::store_matrix_sync(sc, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        flush(p, O, C, i0 + wr * 32 + r * 16 + e / 16, j0 + wc * 64 + c * 16 + e % 16, sc[e]);
      }
      __syncwarp();
    }
}

// ---- bf16, the wgmma route: TMA ring + wgmma (wgmma_tiles.cuh) --------------

// which operand's k-tile at k0 crosses its triangle's diagonal inside the
// output tile at (i0, j0): bit 0 A, bit 1 B (a tile wholly inside the
// triangle needs no mask; k_range has dropped the wholly dead ones)
__device__ __forceinline__ int straddles(const MM& p, bool at, bool bt, int i0, int j0, int bm,
                                         int bn, int bk, int k0) {
  if (p.a_tri) {
    const bool up = (p.a_tri == UPLO_U) != at;  // op(A)(i, k) != 0 needs k >= i
    return (up ? k0 >= i0 + bm - 1 : k0 + bk - 1 <= i0) ? 0 : 1;
  }
  if (p.b_tri) {
    const bool up = (p.b_tri == UPLO_U) != bt;  // op(B)(k, j) != 0 needs k <= j
    return (up ? k0 + bk - 1 <= j0 : k0 >= j0 + bn - 1) ? 0 : 2;
  }
  return 0;
}

// The launch options of the wgmma, dmma and fma routes, passed beside MM
// (whose layout the wmma and simt kernels keep: a larger MM changes their
// register allocation, and the wmma kernel ran 2.6x slower with it)
struct TileOpts {
  int order;  // block -> tile order: bit 0 reversed, bit 1 column-major
  int vec;    // O and C rows take 16-byte loads and stores
};

// block -> tile for the wgmma, dmma and fma routes: the longest k-ranges first
__device__ inline int ordered_bid(const MM& p, int order, int bid) {
  if (order == 0 || !(p.out_uplo == UPLO_NONE || p.all_tiles)) return bid;
  const int b = (order & 1) ? p.ntm * p.ntn - 1 - bid : bid;
  return (order & 2) ? (b % p.ntm) * p.ntn + b / p.ntm : b;
}

// flush() for the 8 columns j .. j + 7 of row i, read from the staged f32
// tile: the same operations, in 16-byte loads of C and stores of the
// result where the row holds all 8 and both are aligned (vec)
__device__ __forceinline__ void flush_seg(const MM& p, bool vec, bf16* O, const bf16* C, int i,
                                          int j, const float* acc) {
  if (i >= p.M || j >= p.N) return;
  if (!(vec && j + 8 <= p.N)) {
    for (int x = 0; x < 8; ++x) flush(p, O, C, i, j + x, acc[x]);
    return;
  }
  const float4 a0 = *reinterpret_cast<const float4*>(acc);
  const float4 a1 = *reinterpret_cast<const float4*>(acc + 4);
  float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  uint4 c = make_uint4(0, 0, 0, 0);
  if (p.fused_c) c = *reinterpret_cast<const uint4*>(C + (long long)i * p.ldc + j);
  const __nv_bfloat162* cp = reinterpret_cast<const __nv_bfloat162*>(&c);
  uint4 out;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    v[x] = __fmul_rn((float)p.alpha, v[x]);
    if (!in_tri(p.out_uplo, i, j + x)) v[x] = 0.0f;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (p.fused_c) {
      const float2 cx = __bfloat1622float2(cp[x]);
      v[2 * x] = __fadd_rn(v[2 * x], __fmul_rn((float)p.beta, cx.x));
      v[2 * x + 1] = __fadd_rn(v[2 * x + 1], __fmul_rn((float)p.beta, cx.y));
    }
    op[x] = __floats2bfloat162_rn(v[2 * x], v[2 * x + 1]);
  }
  *reinterpret_cast<uint4*>(O + (long long)i * p.ldo + j) = out;
}

// ta / tb map the A and B windows as stored (AT: A is K x M; BT: B is N x K)
template <bool AT, bool BT>
__global__ void __launch_bounds__(wg::THREADS, 1)
    mm_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, MM p,
             TileOpts o) {
  constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK;
  extern __shared__ uint8_t smem[];
  int ti, tj;
  bool live;
  tile_of(p, ordered_bid(p, o.order, blockIdx.x), ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  bf16* O = (bf16*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const wg::Ring r = wg::make_ring(smem);
  // only the k-tiles that cross a triangle's diagonal are masked
  auto need = [&](int t) -> bool {
    return straddles(p, AT, BT, i0, j0, BM, BN, BK, kb + t * BK) != 0;
  };
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      wg::produce<AT, BT>(r, &ta, &tb, i0, j0, nk, [&](int t) { return kb + t * BK; }, need);
    } else if (threadIdx.x >= 32) {
      const int mtid = threadIdx.x - 32;
      wg::mask_loop(r, nk, mtid, need, [&](int t, int s) {
        const int k0 = kb + t * BK;
        if (p.a_tri) {
          wg::mask_tile<!AT>(r.a(s), mtid, [&](int mn, int k) {
            const int i = i0 + mn, kk = k0 + k;
            return in_tri(p.a_tri, AT ? kk : i, AT ? i : kk);
          });
        } else {
          wg::mask_tile<BT>(r.b(s), mtid, [&](int mn, int k) {
            const int j = j0 + mn, kk = k0 + k;
            return in_tri(p.b_tri, BT ? j : kk, BT ? kk : j);
          });
        }
      });
    }
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128;
    float d[64];
    wg::consume<AT, BT>(r, nk, ctid, d);
    const float* acc = wg::stage_acc(r, ctid, d);
    const bf16* C = (const bf16*)p.C;
    for (int e = ctid; e < BM * BN / 8; e += 256) {
      const int row = e / (BN / 8), col = (e % (BN / 8)) * 8;
      flush_seg(p, o.vec, O, C, i0 + row, j0 + col, acc + row * wg::EPI_LD + col);
    }
  }
}

template <bool AT, bool BT>
static int launch_wgmma(const MM& p, TileOpts o, dim3 grid, cudaStream_t s) {
  CUtensorMap ta, tb;
  const bool ok =
      wg::make_map(&ta, p.A, AT ? p.K : p.M, AT ? p.M : p.K, p.lda, AT ? wg::BM / 2 : wg::BM) &&
      wg::make_map(&tb, p.B, BT ? p.N : p.K, BT ? p.K : p.N, p.ldb, BT ? wg::BN : wg::BN / 2);
  if (!ok) return -2;
  static bool sized[wg::MAX_DEVICES] = {};  // per instantiation
  const cudaError_t e = wg::size_smem(mm_wgmma<AT, BT>, sized);
  if (e != cudaSuccess) return (int)e;
  mm_wgmma<AT, BT><<<grid, wg::THREADS, wg::SMEM_BYTES, s>>>(ta, tb, p, o);
  return (int)cudaGetLastError();
}

// ---- f32 at 'high', the x3 route: the ring on the split images --------------

template <bool AT, bool BT>
__global__ void __launch_bounds__(wg::THREADS, 1)
    mm_x3(const __grid_constant__ x3::Maps maps, MM p, TileOpts o) {
  constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK;
  extern __shared__ uint8_t smem[];
  int ti, tj;
  bool live;
  tile_of(p, ordered_bid(p, o.order, blockIdx.x), ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  float* O = (float*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) x3::produce<AT, BT>(r, maps, i0, j0, nk, [&](int t) { return kb + t * BK; });
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128;
    float* sum = x3::sum_of(r, ctid);
    float dh[64], dx[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dh[i] = dx[i] = 0.0f;
    x3::consume<AT, BT>(r, nk, ctid, sum, dh, dx);
    const float* C = (const float*)p.C;
#pragma unroll 4
    for (int i = 0; i < 64; ++i) {
      int row, col;
      x3::total_rc(ctid, i, row, col);
      flush(p, O, C, i0 + row, j0 + col, sum[i * 256]);
    }
  }
}

// split both windows as stored (AT: A is K x M; BT: B is N x K) into
// `work`, A's images then B's (x3::split's layout), then the product on them
template <bool AT, bool BT>
static int launch_x3(const MM& p, TileOpts o, dim3 grid, bf16* work, cudaStream_t s) {
  const long long ar = AT ? p.K : p.M, ac = AT ? p.M : p.K;
  const long long br = BT ? p.N : p.K, bc = BT ? p.K : p.N;
  bf16* bimg = work + x3::image_elems(ar, ac);
  int rc = x3::split(p.A, p.lda, ar, ac, p.a_tri, work, s);
  if (rc == 0) rc = x3::split(p.B, p.ldb, br, bc, p.b_tri, bimg, s);
  if (rc) return rc;
  x3::Maps maps;
  if (!x3::image_maps(maps.a, work, ar, ac, AT ? wg::BM / 2 : wg::BM) ||
      !x3::image_maps(maps.b, bimg, br, bc, BT ? wg::BN : wg::BN / 2))
    return -2;
  static bool sized[wg::MAX_DEVICES] = {};  // per instantiation
  const cudaError_t e = wg::size_smem(mm_x3<AT, BT>, sized, x3::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  mm_x3<AT, BT><<<grid, wg::THREADS, x3::SMEM_BYTES, s>>>(maps, p, o);
  return (int)cudaGetLastError();
}

// ---- f64, the dmma route; f32, the fma route (mm_tiles.cuh) -----------------

// the A and B windows as stored (AT: A is K x M; BT: B is N x K)
template <typename T, bool AT, bool BT>
__device__ __forceinline__ void windows(const MM& p, mmt::Win<T>& wa, mmt::Win<T>& wb) {
  wa.p = (const T*)p.A;
  wa.ld = p.lda;
  wa.rows = AT ? p.K : p.M;
  wa.cols = AT ? p.M : p.K;
  wb.p = (const T*)p.B;
  wb.ld = p.ldb;
  wb.rows = BT ? p.N : p.K;
  wb.cols = BT ? p.K : p.N;
}

template <bool AT, bool BT>
__global__ void __launch_bounds__(mmt::D_THREADS, mmt::D_MINB) mm_dmma(MM p, TileOpts o) {
  constexpr int BM = mmt::D_BM, BN = mmt::D_BN, BK = mmt::D_BK;
  extern __shared__ __align__(16) uint8_t dmma_smem[];
  int ti, tj;
  bool live;
  tile_of(p, ordered_bid(p, o.order, blockIdx.x), ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  double* O = (double*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  mmt::Win<double> wa, wb;
  windows<double, AT, BT>(p, wa, wb);
  double acc[mmt::D_MI][mmt::D_NI][4];
  mmt::dmma_loop<AT, BT>(
      reinterpret_cast<double*>(dmma_smem), wa, wb, i0, j0, nk, [&](int t) { return kb + t * BK; },
      [&](int t) { return straddles(p, AT, BT, i0, j0, BM, BN, BK, kb + t * BK); },
      [&](int r, int c) { return in_tri(p.a_tri, r, c); },
      [&](int r, int c) { return in_tri(p.b_tri, r, c); }, acc);
  const double* C = (const double*)p.C;
#pragma unroll
  for (int mi = 0; mi < mmt::D_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < mmt::D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        flush(p, O, C, i0 + mmt::dmma_row(mi, x), j0 + mmt::dmma_col(ni, x), acc[mi][ni][x]);
}

template <bool AT, bool BT>
__global__ void __launch_bounds__(mmt::F_THREADS, mmt::F_MINB) mm_fma(MM p, TileOpts o) {
  constexpr int BM = mmt::F_BM, BN = mmt::F_BN, BK = mmt::F_BK;
  __shared__ __align__(16) mmt::FmaSmem sm;
  int ti, tj;
  bool live;
  tile_of(p, ordered_bid(p, o.order, blockIdx.x), ti, tj, live);
  const int i0 = ti * BM, j0 = tj * BN;
  float* O = (float*)p.O;
  if (!live) {
    zero_tile(p, O, i0, j0, BM, BN);
    return;
  }
  int kb, ke;
  k_range(p, AT, BT, i0, j0, BM, BN, BK, kb, ke);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  mmt::Win<float> wa, wb;
  windows<float, AT, BT>(p, wa, wb);
  float acc[8][8];
  mmt::fma_loop<AT, BT>(
      sm, wa, wb, i0, j0, nk, [&](int t) { return kb + t * BK; },
      [&](int t) { return straddles(p, AT, BT, i0, j0, BM, BN, BK, kb + t * BK); },
      [&](int r, int c) { return in_tri(p.a_tri, r, c); },
      [&](int r, int c) { return in_tri(p.b_tri, r, c); }, acc);
  const float* C = (const float*)p.C;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) flush(p, O, C, i0 + mmt::fma_row(i), j0 + mmt::fma_col(j), acc[i][j]);
}

template <bool AT, bool BT>
static int launch_dmma(const MM& p, TileOpts o, dim3 grid, cudaStream_t s) {
  constexpr int bytes = mmt::dmma_smem_bytes<AT, BT>();
  static bool sized[wg::MAX_DEVICES] = {};  // per instantiation
  const cudaError_t e = wg::size_smem(mm_dmma<AT, BT>, sized, bytes);
  if (e != cudaSuccess) return (int)e;
  mm_dmma<AT, BT><<<grid, mmt::D_THREADS, bytes, s>>>(p, o);
  return (int)cudaGetLastError();
}

static long long count_blocks(const MM& p) {
  if (p.out_uplo == UPLO_NONE || p.all_tiles) return (long long)p.ntm * p.ntn;
  long long total = 0;
  for (int i = 0; i < p.ntm; ++i) {
    int lo, hi;
    live_cols(p, i, lo, hi);
    if (hi > lo) total += hi - lo;
  }
  return total;
}

#define CAPITAL_MM_DISPATCH(KERNEL, ...)                                  \
  do {                                                                    \
    if (at && bt) KERNEL<__VA_ARGS__ true, true><<<grid, 256, 0, s>>>(p); \
    else if (at) KERNEL<__VA_ARGS__ true, false><<<grid, 256, 0, s>>>(p); \
    else if (bt) KERNEL<__VA_ARGS__ false, true><<<grid, 256, 0, s>>>(p); \
    else KERNEL<__VA_ARGS__ false, false><<<grid, 256, 0, s>>>(p);        \
  } while (0)

// route codes (ops/hopper.py:_ROUTE_CODE): 0 the element-load loop (wmma for
// bf16, simt for f32 / f64), 1 wgmma (bf16), 2 dmma (f64), 3 fma (f32),
// 4 x3 and 5 simt3 (f32 at precision 'high')
enum Route : int { R_ELEM = 0, R_WGMMA = 1, R_DMMA = 2, R_FMA = 3, R_X3 = 4, R_SIMT3 = 5 };

// Returns the cudaError_t of the launch (0 = launched); -1 for a bad dtype
// or route, -2 when a tensor map cannot be encoded.  The caller has checked
// the route's alignment (16-byte origins and leading dimensions of A and B
// for wgmma, dmma, fma and x3); those four launch their tiles longest
// k-range first.  `work` is x3's workspace: the images of the A window, then
// of the B window, as stored (x3::image_elems of each; null on the other
// routes).
extern "C" int capital_tri_matmul(int dtype, const void* A, long long lda, const void* B,
                                  long long ldb, void* O, long long ldo, const void* C,
                                  long long ldc, double alpha, double beta, int M, int N,
                                  int K, int a_trans, int b_trans, int a_tri, int b_tri,
                                  int out_uplo, int fused_c, int all_tiles, int route,
                                  void* work, void* stream) {
  const bool ok = route == R_ELEM || (route == R_WGMMA && dtype == DT_BF16) ||
                  (route == R_DMMA && dtype == DT_F64) || (route == R_FMA && dtype == DT_F32) ||
                  ((route == R_X3 || route == R_SIMT3) && dtype == DT_F32);
  if (!ok || dtype < DT_BF16 || dtype > DT_F64 || (route == R_X3 && !work)) return -1;
  MM p;
  p.A = A; p.lda = lda; p.B = B; p.ldb = ldb; p.O = O; p.ldo = ldo; p.C = C; p.ldc = ldc;
  p.alpha = alpha; p.beta = beta; p.M = M; p.N = N; p.K = K;
  p.a_tri = a_tri; p.b_tri = b_tri; p.out_uplo = out_uplo; p.fused_c = fused_c;
  p.all_tiles = all_tiles;
  p.bm = p.bn = dtype == DT_BF16 || route == R_FMA || route == R_X3 ? 128 : 64;
  if (route == R_DMMA) {
    p.bm = mmt::D_BM;
    p.bn = mmt::D_BN;
  }
  p.ntm = (M + p.bm - 1) / p.bm;
  p.ntn = (N + p.bn - 1) / p.bn;
  long long blocks = count_blocks(p);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  bool at = a_trans != 0, bt = b_trans != 0;
  if (route == R_SIMT3) {
    CAPITAL_MM_DISPATCH(mm_simt3, );
    return (int)cudaGetLastError();
  }
  if (route != R_ELEM) {
    // op(A) upper: short tiles at the bottom; lower: at the top.  op(B)
    // upper: short tiles at the left; lower: at the right.
    TileOpts o;
    o.order = 0;
    if (a_tri) o.order = ((a_tri == UPLO_U) != at) ? 0 : 1;
    if (b_tri) o.order = ((b_tri == UPLO_U) != bt) ? 3 : 2;
    o.vec = (uintptr_t)O % 16 == 0 && ldo % 8 == 0 &&
            (!fused_c || ((uintptr_t)C % 16 == 0 && ldc % 8 == 0));
    if (route == R_WGMMA) {
      if (at && bt) return launch_wgmma<true, true>(p, o, grid, s);
      if (at) return launch_wgmma<true, false>(p, o, grid, s);
      if (bt) return launch_wgmma<false, true>(p, o, grid, s);
      return launch_wgmma<false, false>(p, o, grid, s);
    }
    if (route == R_X3) {
      bf16* w = (bf16*)work;
      if (at && bt) return launch_x3<true, true>(p, o, grid, w, s);
      if (at) return launch_x3<true, false>(p, o, grid, w, s);
      if (bt) return launch_x3<false, true>(p, o, grid, w, s);
      return launch_x3<false, false>(p, o, grid, w, s);
    }
    if (route == R_DMMA) {
      if (at && bt) return launch_dmma<true, true>(p, o, grid, s);
      if (at) return launch_dmma<true, false>(p, o, grid, s);
      if (bt) return launch_dmma<false, true>(p, o, grid, s);
      return launch_dmma<false, false>(p, o, grid, s);
    }
    if (at && bt) mm_fma<true, true><<<grid, mmt::F_THREADS, 0, s>>>(p, o);
    else if (at) mm_fma<true, false><<<grid, mmt::F_THREADS, 0, s>>>(p, o);
    else if (bt) mm_fma<false, true><<<grid, mmt::F_THREADS, 0, s>>>(p, o);
    else mm_fma<false, false><<<grid, mmt::F_THREADS, 0, s>>>(p, o);
    return (int)cudaGetLastError();
  }
  switch (dtype) {
    case DT_BF16: CAPITAL_MM_DISPATCH(mm_wmma, ); break;
    case DT_F32: CAPITAL_MM_DISPATCH(mm_simt, float,); break;
    case DT_F64: CAPITAL_MM_DISPATCH(mm_simt, double,); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
