// The tile loops of tri_matmul.cu and sched_matmul.cu for every window the
// TMA + wgmma ring (wgmma_tiles.cuh) does not take, and of the f32 / f64
// CholeskyQR2 passes in qr_fused.cu (the DMMA and FMA loops): a block's
// output tile accumulated over its k loop.  Each kernel stages its own
// operands (masked windows in tri_matmul, plain row-major slabs in
// sched_matmul, unmasked slabs of A and R⁻¹ in qr_fused) and flushes its
// own way.
//
// Which window takes which loop (the wrapper in ops/hopper.py decides):
//   * bf16 windows that TMA can read: the wgmma ring; the other bf16
//     windows: the WMMA loop below (mma.sync m16n16k16, one shared buffer);
//   * f64 windows whose origins and leading dimensions are 16-byte aligned:
//     the DMMA loop (route 'dmma') — mma.sync m16n8k8 with f64 operands and
//     accumulators on the FP64 tensor cores, fed by a 3-stage cp.async ring;
//   * f32 windows with the same alignment: the pipelined FMA loop (route
//     'fma') — IEEE fmaf on 128 x 128 tiles, 8 x 8 outputs a thread, the
//     next k-slice loaded into registers while the current one multiplies;
//   * f32 and f64 windows that are not 16-byte aligned: the register-tiled
//     FMA loop of PR 1 (route 'simt'): every element loaded and predicated on
//     its own, two __syncthreads per k-slice, one buffer.
//
// What bounds the card's f32 and f64 products: operations (67 TF/s for f32
// FMA and for the f64 tensor cores; the windows are thousands wide).  The
// DMMA loop reaches the tensor cores only through mma.sync (there is no f64
// wgmma); ptxas takes m8n8k4 and the sm_90 shapes m16n8k4 / k8 / k16, and
// the m16n8 shapes issue at twice m8n8k4's rate on the card.  Hopper has no
// IEEE f32 tensor-core mode (TF32 keeps 10 mantissa bits), so the f32 loop
// stays on the FMA pipes and is designed for latency and bandwidth: 16-byte
// loads, k-major shared tiles read as float4, one __syncthreads a k-slice.
//
// Triangles: both new loops take a `need(t)` predicate and a stored-index
// `live(r, c)` predicate from the kernel, and zero the dead elements of only
// the k-tiles that straddle the diagonal, by select after the data arrives
// (in shared memory for DMMA, in the staging registers for FMA), so NaN in a
// dead half never reaches a sum and interior tiles carry no mask.  Ragged
// edges are zero-filled at the load (cp.async's source size, or an edge
// branch of the FMA loader taken only by chunks that cross the edge).
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


// ---- shared by the DMMA and FMA loops ---------------------------------------

// An operand window as stored: origin, leading dimension, rows x cols.
// Indices passed to a `live(r, c)` predicate are window-relative, stored.
template <typename T>
struct Win {
  const T* p;
  long long ld;
  int rows, cols;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- f64: DMMA m16n8k8 on the tensor cores ----------------------------------
// 128 x 128 output tile, 32-deep k-tiles in a ring of 3 stages (up to 216 KB
// of dynamic shared memory: one block an SM), 8 warps as 4 (rows) x 2 (cols)
// each owning 32 x 64 = 2 x 8 m16n8 fragments (64 f64 accumulators).  On
// the card (probes/dmma_tiles.py) 32-deep k-tiles beat 16-deep ones by 3-5 %
// on trmm and sched in two calls; 128 x 64 or 64 x 128 tiles at two blocks
// an SM, 16 warps of 32 x 32 and 2, 4 or 6 stages did no better, and
// 16-byte fragment loads through a relabelling of the fragment slots were
// slower.
// Fragments (PTX ISA, checked on the card): A a_x at (g + 8(x%2), t + 4(x/2)),
// B b_x at (t + 4x, g), C c_x at (g + 8(x/2), 2t + x%2); g = lane/4, t = lane%4.
constexpr int D_BM = 128, D_BN = 128, D_BK = 32, D_KS = 8, D_STAGES = 3, D_PAD = 4;
constexpr int D_WM = 32, D_WN = 64;          // a warp's tile
constexpr int D_MINB = 1;                    // blocks an SM (__launch_bounds__)
constexpr int D_WARPS_M = D_BM / D_WM, D_WARPS_N = D_BN / D_WN;
constexpr int D_THREADS = 32 * D_WARPS_M * D_WARPS_N;
constexpr int D_MI = D_WM / 16, D_NI = D_WN / 8;  // m16n8 fragments a warp

// one stage's tile of an operand in its stored orientation, R x C, each row
// padded by 4 f64 (LD = 4 mod 16, so the 16 lanes of a half-warp read 16
// distinct bank pairs in every fragment load, A or B, either orientation)
template <int R_, int C_>
struct DTile {
  static constexpr int R = R_, C = C_, LD = C_ + D_PAD, SIZE = R_ * LD;
};
template <bool AT>
using DTileA = DTile<AT ? D_BK : D_BM, AT ? D_BM : D_BK>;
template <bool BT>
using DTileB = DTile<BT ? D_BN : D_BK, BT ? D_BK : D_BN>;
template <bool AT, bool BT>
constexpr int dmma_smem_bytes() {
  return D_STAGES * (DTileA<AT>::SIZE + DTileB<BT>::SIZE) * (int)sizeof(double);
}

// cp.async of the stored Tile::R x Tile::C tile at (r0, c0) of w into s,
// 16 bytes a copy; what lies past the window's edge is zero-filled (the
// copy's source size), so no element of the tile carries a predicate
template <typename T, class Tile, int NT>
__device__ __forceinline__ void copy_tile(T* s, const Win<T>& w, int r0, int c0, int tid) {
  constexpr int V = 16 / (int)sizeof(T), CPR = Tile::C / V, N = Tile::R * CPR;
  static_assert(N % NT == 0, "copy_tile: the chunks must divide among the threads");
#pragma unroll
  for (int x = 0; x < N / NT; ++x) {
    const int e = tid + x * NT, rl = e / CPR, cl = (e % CPR) * V;
    const int r = r0 + rl, c = c0 + cl;
    const int n = (r < w.rows && c < w.cols) ? min(V, w.cols - c) : 0;
    const T* src = n ? w.p + (long long)r * w.ld + c : w.p;
    cp_async16(s + rl * Tile::LD + cl, src, n * (int)sizeof(T));
  }
}

// zero the dead elements of a staged tile whose stored origin is (r0, c0)
template <typename T, class Tile, int NT, class Live>
__device__ __forceinline__ void mask_tile(T* s, int r0, int c0, int tid, Live live) {
  for (int e = tid; e < Tile::R * Tile::C; e += NT) {
    const int rl = e / Tile::C, cl = e % Tile::C;
    if (!live(r0 + rl, c0 + cl)) s[rl * Tile::LD + cl] = T(0);
  }
}

__device__ __forceinline__ void dmma_m16n8k8(double (&c)[4], const double (&a)[4],
                                             const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc += As x Bs over one staged k-tile; warp tile origin (wm, wn)
template <bool AT, bool BT>
__device__ __forceinline__ void dmma_stage(const double* As, const double* Bs, int wm, int wn,
                                           int g, int t, double (&acc)[D_MI][D_NI][4]) {
  constexpr int LDA = DTileA<AT>::LD, LDB = DTileB<BT>::LD;
#pragma unroll
  for (int kk = 0; kk < D_BK; kk += D_KS) {
    double a[D_MI][4], b[D_NI][2];
#pragma unroll
    for (int mi = 0; mi < D_MI; ++mi)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = wm + mi * 16 + g + 8 * (x % 2), k = kk + t + 4 * (x / 2);
        a[mi][x] = AT ? As[k * LDA + i] : As[i * LDA + k];
      }
#pragma unroll
    for (int ni = 0; ni < D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = wn + ni * 8 + g, k = kk + t + 4 * x;
        b[ni][x] = BT ? Bs[j * LDB + k] : Bs[k * LDB + j];
      }
#pragma unroll
    for (int mi = 0; mi < D_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < D_NI; ++ni) dmma_m16n8k8(acc[mi][ni], a[mi], b[ni]);
  }
}

// the warp tile's origin in the block tile, and the tile-relative (row,
// col) of accumulator element x of fragment (mi, ni)
__device__ __forceinline__ int dmma_row(int mi, int x) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  return (warp / D_WARPS_N) * D_WM + mi * 16 + g + 8 * (x / 2);
}
__device__ __forceinline__ int dmma_col(int ni, int x) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  return (warp % D_WARPS_N) * D_WN + ni * 8 + 2 * t + x % 2;
}

// acc = op(A) op(B) over a block's nk k-tiles of the output tile at (i0,
// j0): k-tile kt starts at k0_of(kt); need(kt) has bit 0 (A) or bit 1 (B)
// set when that operand's tile crosses its triangle's diagonal, and then
// the tile's elements outside live_a / live_b are zeroed in shared memory
// once it has landed.  One __syncthreads a k-tile (two on a masked one);
// the copies of the next two k-tiles are in flight during the products.
template <bool AT, bool BT, class K0, class Need, class LiveA, class LiveB>
__device__ __forceinline__ void dmma_loop(double* smem, const Win<double>& wa,
                                          const Win<double>& wb, int i0, int j0, int nk,
                                          K0 k0_of, Need need, LiveA live_a, LiveB live_b,
                                          double (&acc)[D_MI][D_NI][4]) {
  typedef DTileA<AT> TA;
  typedef DTileB<BT> TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp / D_WARPS_N) * D_WM, wn = (warp % D_WARPS_N) * D_WN;
#pragma unroll
  for (int mi = 0; mi < D_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < D_NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.0;
  auto stage_a = [&](int s) { return smem + s * (TA::SIZE + TB::SIZE); };
  auto stage_b = [&](int s) { return smem + s * (TA::SIZE + TB::SIZE) + TA::SIZE; };
  auto load = [&](int kt) {
    const int s = kt % D_STAGES, k0 = k0_of(kt);
    copy_tile<double, TA, D_THREADS>(stage_a(s), wa, AT ? k0 : i0, AT ? i0 : k0, tid);
    copy_tile<double, TB, D_THREADS>(stage_b(s), wb, BT ? j0 : k0, BT ? k0 : j0, tid);
  };
#pragma unroll
  for (int kt = 0; kt < D_STAGES - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<D_STAGES - 2>();
    __syncthreads();
    const int s = kt % D_STAGES, m = need(kt);
    if (m) {
      const int k0 = k0_of(kt);
      if (m & 1) mask_tile<double, TA, D_THREADS>(stage_a(s), AT ? k0 : i0, AT ? i0 : k0, tid, live_a);
      if (m & 2) mask_tile<double, TB, D_THREADS>(stage_b(s), BT ? j0 : k0, BT ? k0 : j0, tid, live_b);
      __syncthreads();
    }
    if (kt + D_STAGES - 1 < nk) load(kt + D_STAGES - 1);
    cp_commit();
    dmma_stage<AT, BT>(stage_a(s), stage_b(s), wm, wn, g, t, acc);
  }
  cp_wait<0>();
}

// ---- f32: pipelined IEEE FMA ------------------------------------------------
// 128 x 128 output tile, 8-deep k-tiles, 256 threads as 16 x 16: thread
// (tx, ty) owns rows 4ty + {0..3} and 64 + 4ty + {0..3}, and the same
// columns by tx, so each k step reads its 8 + 8 operands as four float4
// from k-major shared tiles.  Each thread stages one 16-byte chunk of A and
// one of B per k-tile in registers: the next k-tile's loads are issued
// before the current one's FMAs and stored (transposed where the operand is
// stored k-contiguous) after them, into the other of two buffers.
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_LD = 128 + 4;
constexpr int F_THREADS = 256;
constexpr int F_MINB = 2;  // blocks an SM (__launch_bounds__)

struct FmaSmem {
  float a[2][F_BK][F_LD];  // op(A)ᵀ: [k][i]
  float b[2][F_BK][F_LD];  // op(B): [k][j]
};

// this thread's chunk of a stored k-tile: KROWS when the stored rows are k
// (8 x 128: 32 chunks a row), else 128 x 8 (2 chunks a row)
template <bool KROWS>
__device__ __forceinline__ void chunk_of(int tid, int& rl, int& cl) {
  constexpr int CPR = (KROWS ? F_BM : F_BK) / 4;
  rl = tid / CPR;
  cl = (tid % CPR) * 4;
}

// 4 stored-contiguous elements at (r, c .. c + 3); only a chunk that
// crosses the window's edge takes the element-wise branch
__device__ __forceinline__ float4 load4(const Win<float>& w, int r, int c) {
  if (r < w.rows && c + 4 <= w.cols)
    return *reinterpret_cast<const float4*>(w.p + (long long)r * w.ld + c);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < w.rows)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (c + x < w.cols) v[x] = w.p[(long long)r * w.ld + c + x];
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <class Live>
__device__ __forceinline__ float4 mask4(float4 v, int r, int c, Live live) {
  v.x = live(r, c) ? v.x : 0.f;
  v.y = live(r, c + 1) ? v.y : 0.f;
  v.z = live(r, c + 2) ? v.z : 0.f;
  v.w = live(r, c + 3) ? v.w : 0.f;
  return v;
}

// write a chunk at stored (rl, cl) of the k-tile into the k-major tile s
template <bool KROWS>
__device__ __forceinline__ void put4(float (&s)[F_BK][F_LD], int rl, int cl, float4 v) {
  if (KROWS) {
    *reinterpret_cast<float4*>(&s[rl][cl]) = v;
  } else {
    s[cl][rl] = v.x;
    s[cl + 1][rl] = v.y;
    s[cl + 2][rl] = v.z;
    s[cl + 3][rl] = v.w;
  }
}

__device__ __forceinline__ void fma_stage(const float (&As)[F_BK][F_LD],
                                          const float (&Bs)[F_BK][F_LD], int tx, int ty,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < F_BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// tile-relative row (col) of this thread's accumulator row i (column j)
__device__ __forceinline__ int fma_row(int i) { return (i / 4) * 64 + 4 * (threadIdx.x / 16) + i % 4; }
__device__ __forceinline__ int fma_col(int j) { return (j / 4) * 64 + 4 * (threadIdx.x % 16) + j % 4; }

// acc = op(A) op(B) over a block's nk k-tiles: the DMMA loop's contract
// (k0_of, need, live_a, live_b), masking in the staging registers
template <bool AT, bool BT, class K0, class Need, class LiveA, class LiveB>
__device__ __forceinline__ void fma_loop(FmaSmem& sm, const Win<float>& wa, const Win<float>& wb,
                                         int i0, int j0, int nk, K0 k0_of, Need need,
                                         LiveA live_a, LiveB live_b, float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int ar, ac, br, bc;
  chunk_of<AT>(tid, ar, ac);
  chunk_of<!BT>(tid, br, bc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // stored origins of this thread's chunks in k-tile kt
  auto a_at = [&](int kt, int& r, int& c) {
    const int k0 = k0_of(kt);
    r = (AT ? k0 : i0) + ar;
    c = (AT ? i0 : k0) + ac;
  };
  auto b_at = [&](int kt, int& r, int& c) {
    const int k0 = k0_of(kt);
    r = (BT ? j0 : k0) + br;
    c = (BT ? k0 : j0) + bc;
  };
  float4 va, vb;
  auto fetch = [&](int kt) {
    int r, c;
    a_at(kt, r, c);
    va = load4(wa, r, c);
    b_at(kt, r, c);
    vb = load4(wb, r, c);
  };
  auto store = [&](int kt, int buf) {
    const int m = need(kt);
    int r, c;
    if (m & 1) {
      a_at(kt, r, c);
      va = mask4(va, r, c, live_a);
    }
    if (m & 2) {
      b_at(kt, r, c);
      vb = mask4(vb, r, c, live_b);
    }
    put4<AT>(sm.a[buf], ar, ac, va);
    put4<!BT>(sm.b[buf], br, bc, vb);
  };
  if (nk > 0) {
    fetch(0);
    store(0, 0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch(kt + 1);
    fma_stage(sm.a[cur], sm.b[cur], tx, ty, acc);
    if (more) store(kt + 1, cur ^ 1);
    __syncthreads();
  }
}

}  // namespace mmt
