// sched_matmul: C = A @ B over the (tile, k-tile) pairs of a schedule held
// in device memory — the per-rank tile-skipping product of the explicit
// SUMMA schedule on a d x d mesh (parallel/summa.py, the sched route).
//
// Replaces capital_tpu/ops/pallas_tpu.py:sched_matmul (pallas_call :505).
// What the TPU kernel computes, kept here: pair p names a tile to[p] of the
// triangular side (rows of A and C for tri_side 'a', columns of B and C for
// 'b') and a k-tile ko[p]; first[p] starts a tile's sum and last[p] writes
// it; pad entries (first = last = 0) write nothing.  The operands arrive
// pre-masked, so no mask is applied inside a tile.  Accumulation is f32 for
// bf16 and f32, f64 for f64; f32 is IEEE FMA (no TF32).  Output tiles that
// no pair lists are left unwritten.
//
// The TPU runs the pair axis in order with a scratch accumulator carried
// from step to step.  Blocks on the card run in no order, so each run of
// pairs (first .. last) becomes one block: the grid is (dense-side
// sub-tiles x sub-tiles of a schedule tile, schedule position p); a block
// whose first[p] != 1 exits at once, the others walk p, p+1, ... to the
// run's last pair (fma: the k-th of them takes the k-th longest run,
// pick_run), accumulating in registers, and write their sub-tile once.
// Every block reads its indices from device memory: no host sync.
//
// What bounds it on the card: operations.  The flagship's top node per
// rank is 4096 x 8192 @ 8192 x 4096 in 512-blocks, far above the H100's
// ~295 flop/byte balance point.  Seven routes, chosen by the wrapper
// (ops/hopper.py) before the launch:
//   * wgmma (bf16 with 16-byte-aligned operands and 64-multiple k-blocks):
//     sched_wgmma, the TMA + wgmma ring of wgmma_tiles.cuh on 128 x 128
//     sub-tiles; its producer thread walks the run's k-tiles ko[q]·bk ...
//     + bk, reading ko and last from device memory;
//   * wmma (other bf16 whose blocks the 128 x 128 x 32 tile divides):
//     sched_wmma, WMMA m16n16k16 128 x 128 tiles with element loads into
//     one shared buffer;
//   * dmma (f64 with 16-byte-aligned operands): sched_dmma, the DMMA loop
//     of mm_tiles.cuh (FP64 tensor cores, 3-stage cp.async ring) on 128 x 128
//     sub-tiles, its k-tiles walked the same way;
//   * fma (f32 with 16-byte-aligned operands): sched_fma, the pipelined
//     IEEE-FMA loop of mm_tiles.cuh on 128 x 128 sub-tiles;
//   * simt (the other f32 and f64, and bf16 blocks that only a 64-row tile
//     divides: the persistent tile-cyclic layout's t = 192): sched_simt,
//     register-tiled FMA 64 x 64 tiles, bf16 widened to f32 on the way in;
//   * x3 (f32 at precision 'high' with 16-byte-aligned operands and
//     64-multiple k-blocks): the split pass of x3_tiles.cuh writes A's and
//     B's bf16 hi / lo images into the caller's workspace, then sched_x3
//     runs the ring on them as sched_wgmma does, three bf16 products a
//     k-tile in 512-deep chains added in IEEE f32 (the reference's bf16x3
//     split);
//   * simt3 (the other f32 at 'high', the t = 192 blocks among them):
//     sched_simt3, sched_simt's tiles with each element split as it is
//     staged.
// Runs of unequal length (9–16 k-blocks on the flagship) leave SMs idle at
// the tail: the fma blocks take the runs longest first
// (pick_run; two blocks an SM put several runs in a wave), the other routes
// in schedule order; a persistent walk that balances them is later work.

#include "mm_tiles.cuh"
#include "wgmma_tiles.cuh"
#include "x3_tiles.cuh"

using namespace nvcuda;

struct SP {
  const void* A;  // (M, K) row-major
  const void* B;  // (K, N) row-major
  void* O;        // (M, N) row-major
  const int* to;
  const int* ko;
  const int* fi;
  const int* la;
  int L;           // schedule length
  int M, N, K;
  int bm, bn, bk;  // schedule blocks
  int tri_a;       // 1: pairs index row tiles (tri_side 'a'); 0: column tiles
  int sub;         // CUDA sub-tiles along the triangular side of one schedule tile
};

// origin of this block's output sub-tile for the run starting at pos
__device__ __forceinline__ void sub_origin(const SP& p, int pos, int BMc, int BNc, int& i0,
                                           int& j0) {
  const int t = p.to[pos];
  const int s = blockIdx.x % p.sub, q = blockIdx.x / p.sub;
  if (p.tri_a) {
    i0 = t * p.bm + s * BMc;
    j0 = q * BNc;
  } else {
    i0 = q * BMc;
    j0 = t * p.bn + s * BNc;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) sched_simt(SP p) {
  constexpr int BM = mmt::S_BM, BN = mmt::S_BN, BK = mmt::S_BK;
  typedef typename AccOf<T>::type A_t;
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN + 1];
  int i0, j0;
  sub_origin(p, pos, BM, BN, i0, j0);
  const T* A = (const T*)p.A;
  const T* B = (const T*)p.B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  A_t acc[4][4];
  mmt::simt_zero<T>(acc);
  for (int q = pos; q < p.L; ++q) {
    const int kb = p.ko[q] * p.bk;
    for (int k0 = kb; k0 < kb + p.bk; k0 += BK) {
      for (int e = tid; e < BM * BK; e += 256) {
        int ii = e / BK, kk = e % BK;
        As[kk][ii] = A[(long long)(i0 + ii) * p.K + k0 + kk];
      }
      for (int e = tid; e < BK * BN; e += 256) {
        int kk = e / BN, jj = e % BN;
        Bs[kk][jj] = B[(long long)(k0 + kk) * p.N + j0 + jj];
      }
      __syncthreads();
      mmt::simt_step<T>(As, Bs, tx, ty, acc);
      __syncthreads();
    }
    if (p.la[q] == 1) break;
  }
  T* O = (T*)p.O;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      O[(long long)(i0 + ty + 16 * r) * p.N + j0 + tx + 16 * c] = Cast<T>::from(acc[r][c]);
}

// f32 at 'high': sched_simt's tiles with the split, 512-deep chains
__global__ void __launch_bounds__(256) sched_simt3(SP p) {
  constexpr int BM = mmt::S_BM, BN = mmt::S_BN, BK = mmt::S_BK;
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  __shared__ x3::Simt3Smem sm;
  int i0, j0;
  sub_origin(p, pos, BM, BN, i0, j0);
  const float* A = (const float*)p.A;
  const float* B = (const float*)p.B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float sh[4][4], sx[4][4], total[4][4];
  mmt::simt_zero<float>(sh);
  mmt::simt_zero<float>(sx);
  mmt::simt_zero<float>(total);
  int slice = 0;
  for (int q = pos; q < p.L; ++q) {
    const int kb = p.ko[q] * p.bk;
    for (int k0 = kb; k0 < kb + p.bk; k0 += BK) {
      for (int e = tid; e < BM * BK; e += 256) {
        int ii = e / BK, kk = e % BK;
        x3::stage(sm.ah, sm.al, kk, ii, A[(long long)(i0 + ii) * p.K + k0 + kk]);
      }
      for (int e = tid; e < BK * BN; e += 256) {
        int kk = e / BN, jj = e % BN;
        x3::stage(sm.bh, sm.bl, kk, jj, B[(long long)(k0 + kk) * p.N + j0 + jj]);
      }
      __syncthreads();
      x3::simt3_step(sm, tx, ty, sh, sx);
      __syncthreads();
      if (++slice % x3::S3_CHAIN == 0) x3::simt3_fold(sh, sx, total);
    }
    if (p.la[q] == 1) break;
  }
  x3::simt3_fold(sh, sx, total);
  float* O = (float*)p.O;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) O[(long long)(i0 + ty + 16 * r) * p.N + j0 + tx + 16 * c] = total[r][c];
}

__global__ void __launch_bounds__(256) sched_wmma(SP p) {
  constexpr int BM = mmt::W_BM, BN = mmt::W_BN, BK = mmt::W_BK;
  constexpr int LDA = mmt::WmmaA<false>::LD, LDB = mmt::WmmaB<false>::LD;
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  __shared__ __align__(32) bf16 As[mmt::WmmaA<false>::SIZE];
  __shared__ __align__(32) bf16 Bs[mmt::WmmaB<false>::SIZE];
  __shared__ __align__(32) float scratch[8][16 * 16];
  int i0, j0;
  sub_origin(p, pos, BM, BN, i0, j0);
  const bf16* A = (const bf16*)p.A;
  const bf16* B = (const bf16*)p.B;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  mmt::AccFrag acc[2][4];
  mmt::wmma_zero(acc);
  for (int q = pos; q < p.L; ++q) {
    const int kb = p.ko[q] * p.bk;
    for (int k0 = kb; k0 < kb + p.bk; k0 += BK) {
      for (int e = tid; e < BM * BK; e += 256) {
        int ii = e / BK, kk = e % BK;
        As[ii * LDA + kk] = A[(long long)(i0 + ii) * p.K + k0 + kk];
      }
      for (int e = tid; e < BK * BN; e += 256) {
        int kk = e / BN, jj = e % BN;
        Bs[kk * LDB + jj] = B[(long long)(k0 + kk) * p.N + j0 + jj];
      }
      __syncthreads();
      mmt::wmma_step<false, false>(As, Bs, wr, wc, acc);
      __syncthreads();
    }
    if (p.la[q] == 1) break;
  }
  bf16* O = (bf16*)p.O;
  float* sc = scratch[warp];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wmma::store_matrix_sync(sc, acc[r][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        long long i = i0 + wr * 32 + r * 16 + e / 16;
        long long j = j0 + wc * 64 + c * 16 + e % 16;
        O[i * p.N + j] = __float2bfloat16_rn(sc[e]);
      }
      __syncwarp();
    }
}

// pairs in the run that starts at pos (first[pos] == 1 .. the next last == 1)
__device__ __forceinline__ int run_pairs(const SP& p, int pos) {
  int pairs = 0;
  for (int q = pos; q < p.L; ++q) {
    ++pairs;
    if (p.la[q] == 1) break;
  }
  return pairs;
}

// The run an fma block computes.  Blocks at a run's first pair
// (first[y] == 1) work, the others exit at once, as on the other routes;
// the k-th working block in dispatch order (the k-th run start) takes the
// k-th longest run (ties in schedule order), so a launch dispatches its
// longest runs first and the short ones fill its last wave (the schedule
// lists a lower operand's runs shortest first).  Every working block ranks
// the runs itself from first / last in shared memory: no host sync.
// Schedules of more than RANK_MAX_L entries or RANK_MAX_RUNS runs keep
// schedule order.  Returns false when the block has no run.
constexpr int RANK_MAX_L = 4096, RANK_MAX_RUNS = 512;

__device__ bool pick_run(const SP& p, int& pos, int& pairs) {
  __shared__ unsigned char flags[RANK_MAX_L];  // bit 0 first, bit 1 last
  __shared__ int start[RANK_MAX_RUNS], len[RANK_MAX_RUNS];
  __shared__ int nruns, pick_pos, pick_len;
  const int y = blockIdx.y;
  if (p.fi[y] != 1) return false;
  if (p.L <= RANK_MAX_L) {
    if (threadIdx.x == 0) {
      nruns = 0;
      pick_pos = -1;
      pick_len = 0;
    }
    for (int q = threadIdx.x; q < p.L; q += blockDim.x)
      flags[q] = (unsigned char)((p.fi[q] == 1) | ((p.la[q] == 1) << 1));
    __syncthreads();
    for (int q = threadIdx.x; q < p.L; q += blockDim.x) {
      if (!(flags[q] & 1)) continue;
      int r = q;
      while (r + 1 < p.L && !(flags[r] & 2)) ++r;
      const int k = atomicAdd(&nruns, 1);
      if (k < RANK_MAX_RUNS) {
        start[k] = q;
        len[k] = r - q + 1;
      }
    }
    __syncthreads();
    const int R = nruns;
    if (R <= RANK_MAX_RUNS) {
      int k = 0;  // run starts before this block's
      for (int j = 0; j < R; ++j) k += start[j] < y;
      for (int i = threadIdx.x; i < R; i += blockDim.x) {
        int rank = 0;
        for (int j = 0; j < R; ++j) rank += len[j] > len[i] || (len[j] == len[i] && start[j] < start[i]);
        if (rank == k) {
          pick_pos = start[i];
          pick_len = len[i];
        }
      }
      __syncthreads();
      pos = pick_pos;
      pairs = pick_len;
      return pos >= 0;
    }
  }
  pos = y;
  pairs = run_pairs(p, y);
  return true;
}

template <typename T>
__device__ __forceinline__ void sched_windows(const SP& p, mmt::Win<T>& wa, mmt::Win<T>& wb) {
  wa.p = (const T*)p.A;
  wa.ld = p.K;
  wa.rows = p.M;
  wa.cols = p.K;
  wb.p = (const T*)p.B;
  wb.ld = p.N;
  wb.rows = p.K;
  wb.cols = p.N;
}

// one block an SM: each run of the flagship's schedule is about one wave,
// so the runs keep schedule order (ranking them, as sched_fma does,
// measured 7 % slower here: probes/dmma_tiles.py)
__global__ void __launch_bounds__(mmt::D_THREADS, mmt::D_MINB) sched_dmma(SP p) {
  constexpr int BK = mmt::D_BK;
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  extern __shared__ __align__(16) uint8_t dmma_smem[];
  int i0, j0;
  sub_origin(p, pos, mmt::D_BM, mmt::D_BN, i0, j0);
  const int per = p.bk / BK, nk = run_pairs(p, pos) * per;
  mmt::Win<double> wa, wb;
  sched_windows<double>(p, wa, wb);
  double acc[mmt::D_MI][mmt::D_NI][4];
  const auto none = [](int, int) { return true; };
  mmt::dmma_loop<false, false>(
      reinterpret_cast<double*>(dmma_smem), wa, wb, i0, j0, nk,
      [&](int t) { return p.ko[pos + t / per] * p.bk + (t % per) * BK; }, [](int) { return 0; },
      none, none, acc);
  double* O = (double*)p.O;
#pragma unroll
  for (int mi = 0; mi < mmt::D_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < mmt::D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        O[(long long)(i0 + mmt::dmma_row(mi, x)) * p.N + j0 + mmt::dmma_col(ni, x)] = acc[mi][ni][x];
}

__global__ void __launch_bounds__(mmt::F_THREADS, mmt::F_MINB) sched_fma(SP p) {
  constexpr int BK = mmt::F_BK;
  int pos, pairs;
  if (!pick_run(p, pos, pairs)) return;
  __shared__ __align__(16) mmt::FmaSmem sm;
  int i0, j0;
  sub_origin(p, pos, mmt::F_BM, mmt::F_BN, i0, j0);
  const int per = p.bk / BK, nk = pairs * per;
  mmt::Win<float> wa, wb;
  sched_windows<float>(p, wa, wb);
  float acc[8][8];
  const auto none = [](int, int) { return true; };
  mmt::fma_loop<false, false>(
      sm, wa, wb, i0, j0, nk, [&](int t) { return p.ko[pos + t / per] * p.bk + (t % per) * BK; },
      [](int) { return 0; }, none, none, acc);
  float* O = (float*)p.O;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = O + (long long)(i0 + mmt::fma_row(i)) * p.N + j0;
    *reinterpret_cast<float4*>(row + mmt::fma_col(0)) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + mmt::fma_col(4)) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ta maps A (M x K, K-major), tb maps B (K x N, MN-major)
__global__ void __launch_bounds__(wg::THREADS, 1)
    sched_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, SP p) {
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  extern __shared__ uint8_t smem[];
  int i0, j0;
  sub_origin(p, pos, wg::BM, wg::BN, i0, j0);
  const int per = p.bk / wg::BK, nk = run_pairs(p, pos) * per;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      wg::produce<false, false>(r, &ta, &tb, i0, j0, nk, [&](int t) {
        return p.ko[pos + t / per] * p.bk + (t % per) * wg::BK;
      }, [](int) { return false; });
    }
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128;
    float d[64];
    wg::consume<false, false>(r, nk, ctid, d);
    int r0, c0;
    wg::acc_origin(ctid, r0, c0);
    bf16* O = (bf16*)p.O;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long i = i0 + r0 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(O + i * p.N + j0 + c0 + 8 * j) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
  }
}

static int launch_sched_wgmma(const SP& p, dim3 grid, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, p.A, p.M, p.K, p.K, wg::BM) ||
      !wg::make_map(&tb, p.B, p.K, p.N, p.N, wg::BN / 2))
    return -2;
  static bool sized[wg::MAX_DEVICES] = {};
  const cudaError_t e = wg::size_smem(sched_wgmma, sized);
  if (e != cudaSuccess) return (int)e;
  sched_wgmma<<<grid, wg::THREADS, wg::SMEM_BYTES, s>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

// f32 at 'high': the ring on A's and B's split images (maps.a K-major,
// maps.b MN-major), the run's k-tiles walked as sched_wgmma walks them
__global__ void __launch_bounds__(wg::THREADS, 1)
    sched_x3(const __grid_constant__ x3::Maps maps, SP p) {
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  extern __shared__ uint8_t smem[];
  int i0, j0;
  sub_origin(p, pos, wg::BM, wg::BN, i0, j0);
  const int per = p.bk / wg::BK, nk = run_pairs(p, pos) * per;
  const wg::Ring r = wg::make_ring(smem);
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) {
      x3::produce<false, false>(r, maps, i0, j0, nk, [&](int t) {
        return p.ko[pos + t / per] * p.bk + (t % per) * wg::BK;
      });
    }
  } else {
    wg::consumer_regs();
    const int ctid = threadIdx.x - 128;
    float* sum = x3::sum_of(r, ctid);
    float dh[64], dx[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dh[i] = dx[i] = 0.0f;
    x3::consume<false, false>(r, nk, ctid, sum, dh, dx);
    x3::store_totals((float*)p.O + (long long)i0 * p.N + j0, p.N, sum, ctid);
  }
}

// split A (M x K) and B (K x N) into `work`, then the product on the images
static int launch_sched_x3(const SP& p, dim3 grid, bf16* work, cudaStream_t s) {
  bf16* bimg = work + x3::image_elems(p.M, p.K);
  int rc = x3::split(p.A, p.K, p.M, p.K, UPLO_NONE, work, s);
  if (rc == 0) rc = x3::split(p.B, p.N, p.K, p.N, UPLO_NONE, bimg, s);
  if (rc) return rc;
  x3::Maps maps;
  if (!x3::image_maps(maps.a, work, p.M, p.K, wg::BM) ||
      !x3::image_maps(maps.b, bimg, p.K, p.N, wg::BN / 2))
    return -2;
  static bool sized[wg::MAX_DEVICES] = {};
  const cudaError_t e = wg::size_smem(sched_x3, sized, x3::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  sched_x3<<<grid, wg::THREADS, x3::SMEM_BYTES, s>>>(maps, p);
  return (int)cudaGetLastError();
}

// route codes as capital_tri_matmul's: 0 the element-load loop (wmma for
// bf16 blocks its 128 x 128 x 32 tile divides, else simt — the rule of
// ops/hopper.py:sched_route), 1 wgmma (bf16), 2 dmma (f64), 3 fma (f32),
// 4 x3 and 5 simt3 (f32 at precision 'high')
enum Route : int { R_ELEM = 0, R_WGMMA = 1, R_DMMA = 2, R_FMA = 3, R_X3 = 4, R_SIMT3 = 5 };

// Returns the cudaError_t of the launch (0 = launched); -1 for a bad dtype
// or route, or blocks that the CUDA tiles do not divide; -2 when a tensor
// map cannot be encoded.  The caller has checked the route's alignment
// (16-byte operands for wgmma, dmma, fma and x3; k-blocks of 64 for wgmma
// and x3).  `work` is x3's workspace: A's images, then B's
// (x3::image_elems(M, K) + x3::image_elems(K, N); null on the other routes).
extern "C" int capital_sched_matmul(int dtype, const void* A, const void* B, void* O,
                                    const int* to, const int* ko, const int* fi, const int* la,
                                    int L, int M, int N, int K, int bm, int bn, int bk,
                                    int tri_a, int route, void* work, void* stream) {
  SP p;
  p.A = A; p.B = B; p.O = O; p.to = to; p.ko = ko; p.fi = fi; p.la = la;
  p.L = L; p.M = M; p.N = N; p.K = K; p.bm = bm; p.bn = bn; p.bk = bk; p.tri_a = tri_a;
  const bool ok = route == R_ELEM || (route == R_WGMMA && dtype == DT_BF16) ||
                  (route == R_DMMA && dtype == DT_F64) || (route == R_FMA && dtype == DT_F32) ||
                  ((route == R_X3 || route == R_SIMT3) && dtype == DT_F32);
  if (!ok || (route == R_X3 && !work)) return -1;
  // the CUDA sub-tile (rows, cols, depth) of each route
  int BMc = mmt::S_BM, BNc = mmt::S_BN, BKc = mmt::S_BK;
  const bool wmma_fits = bm % mmt::W_BM == 0 && bn % mmt::W_BN == 0 && bk % mmt::W_BK == 0;
  if (dtype == DT_BF16 && (route == R_WGMMA || wmma_fits)) {
    BMc = mmt::W_BM;
    BNc = mmt::W_BN;
    BKc = route == R_WGMMA ? wg::BK : mmt::W_BK;
  } else if (route == R_X3) {
    BMc = wg::BM;
    BNc = wg::BN;
    BKc = wg::BK;
  } else if (route == R_DMMA) {
    BMc = mmt::D_BM;
    BNc = mmt::D_BN;
    BKc = mmt::D_BK;
  } else if (route == R_FMA) {
    BMc = mmt::F_BM;
    BNc = mmt::F_BN;
    BKc = mmt::F_BK;
  }
  if (bm % BMc || bn % BNc || bk % BKc || M % bm || N % bn || K % bk) return -1;
  p.sub = tri_a ? bm / BMc : bn / BNc;
  const long long dense = tri_a ? N / BNc : M / BMc;
  const long long gx = dense * p.sub;
  if (L <= 0 || L > 65535 || gx <= 0 || gx > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  dim3 grid((unsigned)gx, (unsigned)L);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == R_WGMMA) return launch_sched_wgmma(p, grid, s);
  if (route == R_X3) return launch_sched_x3(p, grid, (bf16*)work, s);
  if (route == R_SIMT3) {
    sched_simt3<<<grid, 256, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (route == R_DMMA) {
    constexpr int bytes = mmt::dmma_smem_bytes<false, false>();
    static bool sized[wg::MAX_DEVICES] = {};
    const cudaError_t e = wg::size_smem(sched_dmma, sized, bytes);
    if (e != cudaSuccess) return (int)e;
    sched_dmma<<<grid, mmt::D_THREADS, bytes, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (route == R_FMA) {
    sched_fma<<<grid, mmt::F_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  switch (dtype) {
    case DT_BF16:
      if (wmma_fits) {
        sched_wmma<<<grid, 256, 0, s>>>(p);
      } else {
        sched_simt<bf16><<<grid, 256, 0, s>>>(p);
      }
      break;
    case DT_F32: sched_simt<float><<<grid, 256, 0, s>>>(p); break;
    case DT_F64: sched_simt<double><<<grid, 256, 0, s>>>(p); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
