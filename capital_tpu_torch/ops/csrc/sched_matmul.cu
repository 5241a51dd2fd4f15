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
// run's last pair, accumulating in registers, and write their sub-tile
// once.  Every block reads its indices from device memory: no host sync.
//
// What bounds it on the card: operations.  The flagship's top node per
// rank is 4096 x 8192 @ 8192 x 4096 in 512-blocks, far above the H100's
// ~295 flop/byte balance point.  Three routes, chosen by the wrapper
// (ops/hopper.py) before the launch:
//   * wgmma (bf16 with 16-byte-aligned operands and 64-multiple k-blocks):
//     sched_wgmma, the TMA + wgmma ring of wgmma_tiles.cuh on 128 x 128
//     sub-tiles; its producer thread walks the run's k-tiles ko[q]·bk ...
//     + bk, reading ko and last from device memory;
//   * wmma (other bf16): sched_wmma, WMMA m16n16k16 128 x 128 tiles with
//     element loads into one shared buffer;
//   * simt (f32 and f64): sched_simt, register-tiled FMA 64 x 64 tiles.
// Runs of unequal length (9–16 k-blocks on the flagship) still leave SMs
// idle at the tail; a persistent walk that balances them is later work.

#include "mm_tiles.cuh"
#include "wgmma_tiles.cuh"

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

// ta maps A (M x K, K-major), tb maps B (K x N, MN-major)
__global__ void __launch_bounds__(wg::THREADS, 1)
    sched_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, SP p) {
  const int pos = blockIdx.y;
  if (p.fi[pos] != 1) return;
  extern __shared__ uint8_t smem[];
  int i0, j0;
  sub_origin(p, pos, wg::BM, wg::BN, i0, j0);
  int pairs = 0;
  for (int q = pos; q < p.L; ++q) {
    ++pairs;
    if (p.la[q] == 1) break;
  }
  const int per = p.bk / wg::BK, nk = pairs * per;
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

// Returns the cudaError_t of the launch (0 = launched); -1 for a bad dtype
// or route, or blocks that the CUDA tiles do not divide; -2 when a tensor
// map cannot be encoded.  use_wgmma picks the bf16 wgmma route (the caller
// has checked TMA's alignment).
extern "C" int capital_sched_matmul(int dtype, const void* A, const void* B, void* O,
                                    const int* to, const int* ko, const int* fi, const int* la,
                                    int L, int M, int N, int K, int bm, int bn, int bk,
                                    int tri_a, int use_wgmma, void* stream) {
  SP p;
  p.A = A; p.B = B; p.O = O; p.to = to; p.ko = ko; p.fi = fi; p.la = la;
  p.L = L; p.M = M; p.N = N; p.K = K; p.bm = bm; p.bn = bn; p.bk = bk; p.tri_a = tri_a;
  if (use_wgmma && dtype != DT_BF16) return -1;
  const int BMc = dtype == DT_BF16 ? mmt::W_BM : mmt::S_BM;
  const int BNc = dtype == DT_BF16 ? mmt::W_BN : mmt::S_BN;
  const int BKc = use_wgmma ? wg::BK : dtype == DT_BF16 ? mmt::W_BK : mmt::S_BK;
  if (bm % BMc || bn % BNc || bk % BKc || M % bm || N % bn || K % bk) return -1;
  p.sub = tri_a ? bm / BMc : bn / BNc;
  const long long dense = tri_a ? N / BNc : M / BMc;
  const long long gx = dense * p.sub;
  if (L <= 0 || L > 65535 || gx <= 0 || gx > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  dim3 grid((unsigned)gx, (unsigned)L);
  cudaStream_t s = (cudaStream_t)stream;
  if (use_wgmma) return launch_sched_wgmma(p, grid, s);
  switch (dtype) {
    case DT_BF16: sched_wmma<<<grid, 256, 0, s>>>(p); break;
    case DT_F32: sched_simt<float><<<grid, 256, 0, s>>>(p); break;
    case DT_F64: sched_simt<double><<<grid, 256, 0, s>>>(p); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
