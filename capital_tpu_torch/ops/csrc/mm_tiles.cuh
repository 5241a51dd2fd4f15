// The tile loops of the unaligned bf16 route and the f32 / f64 routes shared
// by tri_matmul.cu and sched_matmul.cu: one k-slice of a block's output
// tile, staged in shared memory by element loads, multiplied into the
// block's accumulator.  Each kernel stages its own operands (masked windows
// in tri_matmul, plain row-major slabs in sched_matmul) and flushes its own
// way.
//
// Which window takes which loop: bf16 windows that TMA can read (16-byte
// aligned origins and leading dimensions) go to the TMA + wgmma ring of
// wgmma_tiles.cuh; the other bf16 windows to the WMMA loop below, and f32
// and f64 to the register-tiled FMA loop.  What bounds these loops on the
// card: the loads and the single buffer, not the multiply — every element
// is loaded and predicated on its own, and two __syncthreads per k-slice
// keep a load and a multiply from overlapping; WMMA compiles to mma.sync,
// which cannot reach the tensor cores' full rate.  They stay as the routes
// for windows the wgmma ring does not take.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace mmt {

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// ---- f32 / f64: register-tiled FMA -----------------------------------------
// 64 x 64 output tile, 16-deep k slices, 256 threads as 16 x 16; thread
// (tx, ty) owns rows ty + 16r and columns tx + 16c, r, c < 4.  IEEE FMA,
// accumulated in f32 (f64 for f64).
constexpr int S_BM = 64, S_BN = 64, S_BK = 16;

template <typename T>
__device__ __forceinline__ void simt_zero(typename AccOf<T>::type (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
}

// acc += As[k][rows] x Bs[k][cols] over one staged slice
template <typename T>
__device__ __forceinline__ void simt_step(const T (&As)[S_BK][S_BM + 1],
                                          const T (&Bs)[S_BK][S_BN + 1], int tx, int ty,
                                          typename AccOf<T>::type (&acc)[4][4]) {
  typedef typename AccOf<T>::type A_t;
#pragma unroll
  for (int kk = 0; kk < S_BK; ++kk) {
    A_t a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = widen(As[kk][ty + 16 * r]);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = widen(Bs[kk][tx + 16 * c]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fma_(a[r], b[c], acc[r][c]);
  }
}

// ---- bf16: WMMA m16n16k16 on the tensor cores, f32 accumulate ---------------
// 128 x 128 output tile, 32-deep k slices; 8 warps as 4 (rows) x 2 (cols),
// each owning 32 x 64 = 2 x 4 fragments.  Shared tiles keep the operand's
// memory orientation: As[i][k] (row_major) or As[k][i] (col_major, AT), and
// Bs[k][j] or Bs[j][k] (BT), each row padded by 8 elements.
constexpr int W_BM = 128, W_BN = 128, W_BK = 32;

template <bool AT>
struct WmmaA {
  static constexpr int LD = AT ? W_BM + 8 : W_BK + 8;
  static constexpr int SIZE = AT ? W_BK * LD : W_BM * LD;
  typedef typename std::conditional<AT, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type Lay;
};

template <bool BT>
struct WmmaB {
  static constexpr int LD = BT ? W_BK + 8 : W_BN + 8;
  static constexpr int SIZE = BT ? W_BN * LD : W_BK * LD;
  typedef typename std::conditional<BT, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type Lay;
};

typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> AccFrag;

__device__ __forceinline__ void wmma_zero(AccFrag (&acc)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) nvcuda::wmma::fill_fragment(acc[r][c], 0.0f);
}

// acc += As x Bs over one staged slice; warp (wr, wc) of the 4 x 2 layout
template <bool AT, bool BT>
__device__ __forceinline__ void wmma_step(const bf16* As, const bf16* Bs, int wr, int wc,
                                          AccFrag (&acc)[2][4]) {
  using namespace nvcuda;
  constexpr int LDA = WmmaA<AT>::LD, LDB = WmmaB<BT>::LD;
#pragma unroll
  for (int ks = 0; ks < W_BK; ks += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, typename WmmaA<AT>::Lay> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, typename WmmaB<BT>::Lay> b[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int row = wr * 32 + r * 16;
      const bf16* src = AT ? As + ks * LDA + row : As + row * LDA + ks;
      wmma::load_matrix_sync(a[r], src, LDA);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int col = wc * 64 + c * 16;
      const bf16* src = BT ? Bs + col * LDB + ks : Bs + ks * LDB + col;
      wmma::load_matrix_sync(b[c], src, LDB);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) wmma::mma_sync(acc[r][c], a[r], b[c], acc[r][c]);
  }
}

}  // namespace mmt
