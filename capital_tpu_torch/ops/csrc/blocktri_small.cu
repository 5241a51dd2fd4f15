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
// Per chain block i (f32, all in shared memory), every step on one of two
// routes (ops/blocktri_small.chain_route picks one per kernel before the
// launch):
//                      blocked                       sweep
//   Wt = L_{i−1}⁻¹·Cᵀ  Cᵀ by 4 x 4 register tiles,   Cᵀ an index read,
//                      fwd_blocked                   fwd_sweep
//   S  = D − Wtᵀ·Wt    4 x 4 register tiles of the   a dot product a thread
//                      lower half, mirrored (the full S feeds info)
//   L_i, info = chol(S) chol_blocked; on a fault      chol_sweep
//                      chol_sweep, S formed again
//   y_i = L_i⁻¹(b_i − Wtᵀ·y_{i−1})    (fused, forward_solve)
//   x_i = L_i⁻ᵀ(y_i − Wt_{i+1}·x_{i+1}), descending      (solve_backward)
//                      the coupling product in 4 x 4  a dot product a
//                      register tiles (`couple`),     thread and entry,
//                      fwd_blocked / bwd_upper_blocked fwd_sweep / bwd_sweep
//                      on 16-byte-row stages
// Both routes apply the column sweeps' operations in the sweeps' order
// (batched_small.cuh), so their L, Wt, y, x and info are bitwise the same,
// info follows the JAX kernel's convention exactly and identity blocks factor
// and solve exactly.  The blocked factor route keeps L_i in both triangles
// (Lᵀ above the diagonal), so the next block's fwd_blocked reads rows.
//
// Shared memory, as capital_tpu_torch/ops/blocktri_small.smem_bytes
// computes it.  Blocked route: tiles of round4(b) rows of chain_ld(b) floats
// (16-byte rows, ld ≡ 4 mod 8, zero padding) — three for the factor steps
// (L_{i−1}, Wt, S → L_i), two for the solve steps (L_i, Wt) — and a stage of
// two round4(b)-row buffers of chain_ld(kc) floats for the right-hand sides
// (the columns being solved and the carried neighbour y_{i−1} / x_{i+1}).
// The fused step lays its stage over the dead L_{i−1} tile and what lies
// past it (the factor is done with L_{i−1} when the stage fills), so at
// k = 1 it takes no more than the factor step.  Sweep route: b rows of
// odd_ld(b) (three tiles for the factor steps, two for the solve steps) and
// a stage of 2·b·kc floats.  Right-hand-side columns are independent, so
// they stream through the stage kc at a time, and the f32 carry between
// chain blocks lives in a device-memory scratch (batch, b, k) that the
// wrapper allocates (read back by the same block after a barrier) — except
// on the solve steps' blocked route where a block's columns fit one chunk:
// the carry then stays in the stage from one chain block to the next.
//
// Column split (blocked route): the grid is (batch, splits), and block
// (p, s) takes columns [s·k/splits, (s+1)·k/splits) of problem p through
// every chain block (ops/blocktri_small.rhs_splits picks splits so that
// the batch fills the SMs).  The fused step's split blocks each run the
// factor recurrence again and only split 0 stores L, Wt and info.  The
// columns are independent, so a split changes no bit.
//
// What bounds them on the card: at the flagship (batch 1, 64 blocks of 128)
// one SM walks the chain alone, so the time is each block's dependent
// chain — on the blocked route three barriers a 16-column panel of the
// factor and two of each triangular solve, on the sweep route one or two a
// column — far from both the bytes bound (the operands are read once) and
// the f32 operations bound.  A batch of problems, the partitioned driver's
// folded interiors, or the column split fills more SMs.  Not done yet:
// tensor cores for Wtᵀ·Wt and the Wt solve, a cluster per problem.

#include <algorithm>

#include "batched_small.cuh"

using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;
// largest chain block the kernels take (the per-row flags below are static
// shared memory); the factor steps' sweep route stops at b = 138, where
// three odd-ld tiles fill SMEM_MAX
constexpr int MAX_B = 256;

// The factor steps' tile layouts (ops/blocktri_small.chain_route picks
// one before the launch): the blocked route's tiles are round4(b) rows of
// 16-byte-aligned floats, ld ≡ 4 (mod 8) — potrf_ld's rule — with their
// padding rows and columns zero; the sweep route's are b rows of odd_ld(b).
__host__ __device__ __forceinline__ int chain_ld(int b, bool blocked) {
  if (!blocked) return odd_ld(b);
  const int b4 = round4(b);
  return (b4 / 4) % 2 ? b4 : b4 + 4;
}
__host__ __device__ __forceinline__ int chain_rows(int b, bool blocked) { return blocked ? round4(b) : b; }

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

// dst = srcᵀ on a 16-byte-row tile (live entries only).  Where rows move as
// 4-entry vectors, a thread takes a 4 x 4 tile of src through registers:
// four rows' 16-byte loads, then four 16-byte stores into four rows of dst,
// consecutive threads on consecutive tiles of one column band, so a
// quarter-warp stores 128 contiguous bytes.  Else entry by entry down src's
// columns (a strided read, a contiguous write: a column walk of dst would
// meet 8-way bank conflicts at ld ≡ 4 mod 8).
template <typename T>
__device__ void load_tile_t4(float* dst, int ld, const T* src, int b) {
  if (rows_vec4(src, b)) {
    const int tb = b / 4;
    for (int e = threadIdx.x; e < tb * tb; e += NT) {
      const int r0 = 4 * (e % tb), c0 = 4 * (e / tb);
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(src + (r0 + i) * b + c0, v[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
        st4(dst + (c0 + j) * ld + r0, t);
      }
    }
  } else {
    for (int e = threadIdx.x; e < b * b; e += NT) {
      const int r = e / b, c = e - r * b;
      dst[r * ld + c] = widen(src[c * b + r]);
    }
  }
}

template <typename T>
__device__ void store_tile(T* dst, const float* src, int ld, int b, bool lower_only) {
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int r = e / b, c = e - r * b;
    dst[e] = Cast<T>::from(lower_only && c > r ? 0.f : src[r * ld + c]);
  }
}

// rowbad[i]: row i of the full b x b S holds a non-finite entry.  Returns,
// to every thread, whether any row does.
__device__ int scan_rows(const float* S, int ld, int b, unsigned char* rowbad) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  bool bad = false;
  for (int i = ty; i < b; i += WARPS) {
    bool row = false;
    for (int l = tx; l < b; l += 32) row |= !isfinite(S[i * ld + l]);
    row = __any_sync(0xffffffffu, row);
    if (tx == 0) rowbad[i] = row;
    bad |= row;
  }
  return __syncthreads_or(bad);
}

// The JAX kernel's spreading of a non-finite Schur complement through its
// factor (ops/sweeps.chol_plain): column 0 NaN at the rows of S that held a
// non-finite value, every later column NaN (lower triangle).  Ends with a
// barrier.
__device__ void nan_pattern(float* S, int ld, int b, const unsigned char* rowbad) {
  const float nan = __int_as_float(0x7fc00000);
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int r = e / b, c = e - r * b;
    if (c <= r && (c > 0 || rowbad[r])) S[r * ld + c] = nan;
  }
  __syncthreads();
}

// One chain block of the factor recurrence on the sweep route (odd-ld
// tiles): P holds L_{i−1} (lower), W receives Wt_i, S receives L_i in its
// lower triangle.  Returns the block's info (all threads).  Ends with a
// barrier.
//
// A non-finite Schur complement spreads through the factor as the JAX
// kernel's one-hot sweep spreads it.  chol_sweep reads the lower triangle
// only, so that pattern is set here from the rows of the full S
// (nan_pattern); the next chain block's sweeps then see the factor the
// reference carries, and its info agrees too.
template <typename T>
__device__ int factor_block_sweep(const float* P, float* W, float* S, int ld, const T* d, const T* c, int b) {
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
  const int anybad = scan_rows(S, ld, b, rowbad);
  const int info = chol_sweep(S, ld, b);
  if (anybad) nan_pattern(S, ld, b, rowbad);
  return info;
}

// S −= Wtᵀ·Wt on 16-byte-row tiles: 4 x 4 register tiles of S's lower
// triangle (tile e of the packed lower triangle of tiles to thread e mod
// NT), two 16-byte loads of W's rows per 16 FMAs.  Each accumulator starts
// at 0 and takes fmaf(W[l][i], W[l][j], acc) for l ascending — the sweep
// route's dot product, contracted — and is subtracted once from the entry
// and once from its mirror, each from D's own value, as the sweep route
// does, so S is bitwise the same.  Padding tiles compute zeros (W's
// padding columns are zero).
__device__ void schur_update(const float* W, float* S, int ld, int b) {
  const int T = round4(b) / 4, tiles = T * (T + 1) / 2;
  for (int e = threadIdx.x; e < tiles; e += NT) {
    int ti = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > e) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= e) ++ti;
    const int i0 = 4 * ti, j0 = 4 * (e - ti * (ti + 1) / 2);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int l = 0; l < b; ++l) {
      float x[4], y[4];
      unpack4(x, ld4(W + l * ld + i0));
      unpack4(y, ld4(W + l * ld + j0));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(x[r], y[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v[4];
      unpack4(v, ld4(S + (i0 + r) * ld + j0));
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] -= acc[r][q];
      st4(S + (i0 + r) * ld + j0, v);
    }
    if (i0 == j0) continue;  // the diagonal tile holds its own mirror
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[4];
      unpack4(v, ld4(S + (j0 + q) * ld + i0));
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] -= acc[r][q];
      st4(S + (j0 + q) * ld + i0, v);
    }
  }
}

// One chain block on the blocked route: the tiles hold 16-byte rows with
// zero padding, P holds L_{i−1} in both triangles (L below the diagonal, Lᵀ
// above), and so does S on return.
//   Wt = L_{i−1}⁻¹·Cᵀ     Cᵀ by register tiles (load_tile_t4), fwd_blocked
//   S  = D − Wtᵀ·Wt       schur_update, the full S (both triangles)
//   L_i, info = chol(S)   the full S scanned (scan_rows); a finite S goes to
//                         chol_blocked
// A non-finite S, or one chol_blocked does not certify (it then wrote the
// tile: S is formed again from D and W), takes chol_sweep, whose info is
// the reference's, and nan_pattern; its L is mirrored into the upper
// triangle for the next block's fwd_blocked.  Every part applies its sweep's
// operations in the sweep's order, so L_i, Wt_i and info are the sweep
// route's bit for bit.  Ends with a barrier.
template <typename T>
__device__ int factor_block_blocked(const float* P, float* W, float* S, int ld, const T* d, const T* c, int b) {
  __shared__ unsigned char rowbad[MAX_B];
  load_tile_t4(W, ld, c, b);
  load_rows(S, ld, d, b);
  __syncthreads();
  fwd_blocked<true>(P, ld, b, W, ld, b);
  schur_update(W, S, ld, b);
  __syncthreads();
  const int anybad = scan_rows(S, ld, b, rowbad);
  int info = anybad ? -1 : chol_blocked(S, ld, b);
  if (info < 0) {
    if (!anybad) {
      zero_pad(S, ld, b);
      load_rows(S, ld, d, b);
      __syncthreads();
      schur_update(W, S, ld, b);
      __syncthreads();
    }
    info = chol_sweep(S, ld, b);
    if (anybad) nan_pattern(S, ld, b, rowbad);
    mirror_lower(S, ld, b);
  }
  return info;
}

template <typename T, bool BLOCKED>
__device__ __forceinline__ int factor_block(const float* P, float* W, float* S, int ld, const T* d, const T* c,
                                            int b) {
  if constexpr (BLOCKED) return factor_block_blocked(P, W, S, ld, d, c, b);
  else return factor_block_sweep(P, W, S, ld, d, c, b);
}

// The carried factor into P, and on the blocked route W and S zeroed (their
// padding stays zero from here on) and L_c in both triangles of P.
template <typename T, bool BLOCKED>
__device__ void load_carry(float* P, int ld, const T* Lc, int b) {
  if constexpr (BLOCKED) {
    const int rows = chain_rows(b, true);
    for (int e = threadIdx.x; e < 2 * rows * ld; e += NT) P[rows * ld + e] = 0.f;
    load_factor_both(P, ld, Lc, b, 0);
  } else {
    load_tile(P, ld, Lc, b);
  }
  __syncthreads();
}

// The fused step's right-hand sides on the sweep route: the forward column
// sweep of one chain block over every RHS column, kc at a time:
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
__global__ void __launch_bounds__(NT) fused_forward_sweep_kernel(const T* D, const T* C, const T* B, const T* Lc,
                                                                 const T* yc, T* L, T* Wt, T* y, int* info,
                                                                 float* scratch, int seg, int b, int k, int kc) {
  extern __shared__ float4 smem4[];
  const int ld = chain_ld(b, false), rows = chain_rows(b, false);
  float* P = reinterpret_cast<float*>(smem4);
  float* W = P + rows * ld;
  float* S = W + rows * ld;
  float* R = S + rows * ld;
  float* Yp = R + b * kc;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  load_carry<T, false>(P, ld, Lc + p * bb, b);
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    const int inf = factor_block_sweep(P, W, S, ld, D + blk * bb, C + blk * bb, b);
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

// ---------------------------------------------------------------------------
// The right-hand sides on the blocked route: stages of round4(b) rows of
// lds = chain_ld(kc) floats (16-byte rows), the coupling product in 4 x 4
// register tiles and the blocked triangular solves of batched_small.cuh.
// ---------------------------------------------------------------------------

// w columns from column c0 of one problem's two (b, k) row-major blocks —
// the right-hand side and the carried neighbour — into two stages (b rows
// of lds floats), widened to f32: four entries of each in flight a thread
// before their stores; `src2` null skips the second
template <typename T1, typename T2>
__device__ void stage_in2(float* dst1, const T1* src1, float* dst2, const T2* src2, int lds, int k, int c0, int w,
                          int b) {
  const int n = b * w;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * NT) {
    float v[4], u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * NT, r = e / w;
      const long long g = (long long)r * k + c0 + e - r * w;
      if (e < n) {
        v[q] = widen(src1[g]);
        if (src2) u[q] = widen(src2[g]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * NT, r = e / w;
      if (e < n) {
        dst1[r * lds + e - r * w] = v[q];
        if (src2) dst2[r * lds + e - r * w] = u[q];
      }
    }
  }
}

// the stage's w columns out to columns c0.. of `out` (rounded once to T)
// and, where `carry` is given, to the f32 scratch
template <typename T>
__device__ void stage_out(T* out, float* carry, const float* R, int lds, int k, int c0, int w, int b) {
  for (int e = threadIdx.x; e < b * w; e += NT) {
    const int r = e / w, c = e - r * w;
    const long long g = (long long)r * k + c0 + c;
    const float v = R[r * lds + c];
    out[g] = Cast<T>::from(v);
    if (carry) carry[g] = v;
  }
}

// R −= Aᵀ·Y on the stage (b live rows, w columns): register tiles of R of
// RT rows by 4 columns, A read by rows (A[l][r0..r0+RT)) and Y by rows.
// Each accumulator starts at 0, takes fmaf(A[l][r], Y[l][c], acc) for l
// ascending and is subtracted once — the sweep route's dot product,
// contracted — so R is bitwise the same.  The forward step passes A = Wt_i
// as stored (Rᵢ −= Wt_iᵀ·y_{i−1}), the backward one A = Wt_{i+1}ᵀ
// (Rᵢ −= Wt_{i+1}·x_{i+1}).  Padding rows and columns compute values nobody
// reads.
template <int RT>
__device__ __forceinline__ void couple_tiles(const float* A, int ld, const float* Y, float* R, int lds, int b,
                                             int w) {
  const int cg = round4(w) / 4, tiles = round4(b) / RT * cg;
  for (int e = threadIdx.x; e < tiles; e += NT) {
    const int r0 = RT * (e / cg), c0 = 4 * (e % cg);
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int l = 0; l < b; ++l) {
      float a[4], y[4];
      if constexpr (RT == 4) unpack4(a, ld4(A + l * ld + r0));
      else a[0] = A[l * ld + r0];
      unpack4(y, ld4(Y + l * lds + c0));
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], y[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float v[4];
      unpack4(v, ld4(R + (r0 + r) * lds + c0));
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] -= acc[r][q];
      st4(R + (r0 + r) * lds + c0, v);
    }
  }
}

// 4 x 4 tiles (two 16-byte loads per 16 FMAs), or 1 x 4 where 4 x 4 tiles
// would leave three quarters of the threads idle (w <= 4 at b = 128: one
// warp, 128 dependent steps, against four warps)
__device__ void couple(const float* A, int ld, const float* Y, float* R, int lds, int b, int w) {
  if (round4(b) * (round4(w) / 4) <= NT) couple_tiles<1>(A, ld, Y, R, lds, b, w);
  else couple_tiles<4>(A, ld, Y, R, lds, b, w);
}

// floats [0, n) of shared memory zeroed, 16 bytes a store (n % 4 == 0)
__device__ __forceinline__ void zero_smem(float* S, int n) {
  for (int e = threadIdx.x; e < n / 4; e += NT) reinterpret_cast<float4*>(S)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// this block's columns of its problem: [lo, hi) of k, split `splits` ways
__device__ __forceinline__ void split_cols(int k, int splits, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.y * k / splits);
  hi = (int)((long long)(blockIdx.y + 1) * k / splits);
}

// The fused step's right-hand sides of one chain block on the blocked
// route: columns [lo, hi) kc at a time, y = L_i⁻¹(rhs − Wtᵀ·yprev) with
// yprev from `first` (the launch's carry, at T) or the f32 scratch `carry`;
// y goes to `carry` and `out`.  Out of line, so the factor's registers and
// the stage's are allocated apart (inlined into the kernel they spilled).
template <typename T>
__device__ __noinline__ void fused_rhs(const float* S, const float* W, int ld, float* R, float* Yp, int lds,
                                       const T* rhs, const T* first, float* carry, T* out, int k, int lo, int hi,
                                       int kc, int b) {
  for (int c0 = lo; c0 < hi; c0 += kc) {
    const int w = min(kc, hi - c0);
    if (first) stage_in2(R, rhs, Yp, first, lds, k, c0, w, b);
    else stage_in2(R, rhs, Yp, (const float*)carry, lds, k, c0, w, b);
    __syncthreads();
    couple(W, ld, Yp, R, lds, b, w);
    __syncthreads();
    fwd_blocked<true, true>(S, ld, b, R, lds, w);
    stage_out(out, carry, R, lds, k, c0, w, b);
    __syncthreads();  // the next chunk overwrites the stage; the carry is in
  }
}

// The fused step on the blocked route.  Layout: W, S, then L_{i−1} (P);
// once factor_block_blocked has consumed L_{i−1}, the RHS stage (R, then
// Yp) takes P's place and what lies past it, and at the chain block's end
// L_i is copied from S into P.  The carry goes through the scratch.
template <typename T>
__global__ void __launch_bounds__(NT) fused_forward_blocked_kernel(const T* D, const T* C, const T* B, const T* Lc,
                                                                   const T* yc, T* L, T* Wt, T* y, int* info,
                                                                   float* scratch, int seg, int b, int k, int kc,
                                                                   int splits) {
  extern __shared__ float4 smem4[];
  const int ld = chain_ld(b, true), rows = chain_rows(b, true), lds = chain_ld(kc, true);
  float* W = reinterpret_cast<float*>(smem4);
  float* S = W + rows * ld;
  float* P = S + rows * ld;
  float* R = P;
  float* Yp = P + rows * lds;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  int lo, hi;
  split_cols(k, splits, lo, hi);
  const bool owner = blockIdx.y == 0;
  float* carry = scratch + p * bk;
  zero_smem(W, 2 * rows * ld);  // W's and S's padding stays zero from here on
  load_factor_both(P, ld, Lc + p * bb, b, 0);
  __syncthreads();
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    const int inf = factor_block_blocked(P, W, S, ld, D + blk * bb, C + blk * bb, b);
    if (owner) {
      store_tile(L + blk * bb, S, ld, b, true);
      store_tile(Wt + blk * bb, W, ld, b, false);
      if (threadIdx.x == 0) info[blk] = inf;
    }
    fused_rhs(S, W, ld, R, Yp, lds, B + blk * bk, s == 0 ? yc + p * bk : nullptr, carry, y + blk * bk, k, lo, hi,
              kc, b);
    for (int e = threadIdx.x; e < rows * ld / 4; e += NT)  // L_i carried on
      reinterpret_cast<float4*>(P)[e] = reinterpret_cast<const float4*>(S)[e];
    __syncthreads();
  }
}

template <typename T, bool BLOCKED>
__global__ void __launch_bounds__(NT) factor_kernel(const T* D, const T* C, const T* Lc, T* L, T* Wt, int* info,
                                                    int seg, int b) {
  extern __shared__ float4 smem4[];
  const int ld = chain_ld(b, BLOCKED), rows = chain_rows(b, BLOCKED);
  float* P = reinterpret_cast<float*>(smem4);
  float* W = P + rows * ld;
  float* S = W + rows * ld;
  const long long p = blockIdx.x, bb = (long long)b * b;
  load_carry<T, BLOCKED>(P, ld, Lc + p * bb, b);
  for (int s = 0; s < seg; ++s) {
    const long long blk = p * seg + s;
    const int inf = factor_block<T, BLOCKED>(P, W, S, ld, D + blk * bb, C + blk * bb, b);
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

// The solve steps on the blocked route (FORWARD: forward_solve, else
// solve_backward, chain blocks descending).  Layout: the factor tile Lf,
// the coupling tile A, the stage R and the carried neighbour Yn.
//   forward    Lf = L_iᵀ (fwd_blocked reads L from the rows of Lᵀ and
//              nothing else), A = Wt_i as stored
//   backward   Lf = L_i as stored (bwd_upper_blocked reads U = Lᵀ from its
//              lower triangle only), A = Wt_{i+1}ᵀ
// (the transposed loads keep their shared-memory stores contiguous, where
// the factor steps' both-triangle load would conflict 16 ways)
// A block whose columns fit one chunk keeps the carry in the stage (R and
// Yn swap roles after every chain block); else each chunk reads and writes
// it through the scratch.
template <typename T, bool FORWARD>
__global__ void __launch_bounds__(NT) solve_blocked_kernel(const T* L, const T* Wt, const T* B, const T* carry0,
                                                           T* out, float* scratch, int seg, int b, int k, int kc,
                                                           int splits) {
  extern __shared__ float4 smem4[];
  const int ld = chain_ld(b, true), rows = chain_rows(b, true), lds = chain_ld(kc, true);
  float* Lf = reinterpret_cast<float*>(smem4);
  float* A = Lf + rows * ld;
  float* R = A + rows * ld;
  float* Yn = R + rows * lds;
  const long long p = blockIdx.x, bb = (long long)b * b, bk = (long long)b * k;
  int lo, hi;
  split_cols(k, splits, lo, hi);
  const bool resident = hi - lo <= kc;
  float* carry = resident ? nullptr : scratch + p * bk;
  zero_smem(Lf, 2 * rows * (ld + lds));  // the padding stays zero from here on
  __syncthreads();
  for (int t = 0; t < seg; ++t) {
    const long long blk = p * seg + (FORWARD ? t : seg - 1 - t);
    if constexpr (FORWARD) {
      load_tile_t4(Lf, ld, L + blk * bb, b);
      load_rows(A, ld, Wt + blk * bb, b);
    } else {
      load_rows(Lf, ld, L + blk * bb, b);
      load_tile_t4(A, ld, Wt + blk * bb, b);
    }
    for (int c0 = lo; c0 < hi; c0 += kc) {
      const int w = min(kc, hi - c0);
      if (t == 0) stage_in2(R, B + blk * bk, Yn, carry0 + p * bk, lds, k, c0, w, b);
      else stage_in2(R, B + blk * bk, Yn, resident ? nullptr : (const float*)carry, lds, k, c0, w, b);
      __syncthreads();
      couple(A, ld, Yn, R, lds, b, w);
      __syncthreads();
      if constexpr (FORWARD) fwd_blocked<true, true>(Lf, ld, b, R, lds, w);
      else bwd_upper_blocked<true, true, true>(Lf, ld, b, R, lds, w);
      stage_out(out + blk * bk, carry, R, lds, k, c0, w, b);
      if (resident) {  // the result is the next block's carry; nobody reads
        float* r = R;  // Yn (the new R) again before the next barrier
        R = Yn;
        Yn = r;
      } else {
        __syncthreads();  // the next chunk overwrites the stage; the carry is in
      }
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
static int run(dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > SMEM_MAX || grid.x < 1 || grid.y < 1 || grid.y > 65535) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

static size_t tiles_bytes(int ntiles, int b, bool blocked = false) {
  return sizeof(float) * (size_t)ntiles * chain_rows(b, blocked) * chain_ld(b, blocked);
}

// the sweep route's stage: the chunk and the carried chunk, b x kc each
static size_t stage_bytes(int b, int kc) { return sizeof(float) * 2 * (size_t)b * kc; }

// the blocked route's stage: two buffers of round4(b) rows of chain_ld(kc)
static size_t blocked_stage_bytes(int b, int kc) {
  return sizeof(float) * 2 * (size_t)chain_rows(b, true) * chain_ld(kc, true);
}

// the column split takes 1 <= splits <= k (no block without a column)
static bool split_ok(int k, int splits) { return splits >= 1 && splits <= (k > 0 ? k : 1); }

template <typename T>
static int fused_forward(const void* D, const void* C, const void* B, const void* Lc, const void* yc, void* L,
                         void* Wt, void* y, void* info, void* scratch, int batch, int seg, int b, int k, int kc,
                         int splits, bool blocked, void* stream) {
  if (!blocked) {
    if (splits != 1) return -1;
    return run<fused_forward_sweep_kernel<T>>(
        dim3(batch), tiles_bytes(3, b) + stage_bytes(b, kc), stream, (const T*)D, (const T*)C, (const T*)B,
        (const T*)Lc, (const T*)yc, (T*)L, (T*)Wt, (T*)y, (int*)info, (float*)scratch, seg, b, k, kc);
  }
  // two tiles, then L_{i−1}'s tile or the stage laid over it, whichever is larger
  const size_t smem = tiles_bytes(2, b, true) + std::max(tiles_bytes(1, b, true), blocked_stage_bytes(b, kc));
  return run<fused_forward_blocked_kernel<T>>(
      dim3(batch, splits), smem, stream, (const T*)D, (const T*)C, (const T*)B, (const T*)Lc, (const T*)yc,
      (T*)L, (T*)Wt, (T*)y, (int*)info, (float*)scratch, seg, b, k, kc, splits);
}

template <typename T, bool BLOCKED>
static int factor(const void* D, const void* C, const void* Lc, void* L, void* Wt, void* info, int batch, int seg,
                  int b, void* stream) {
  return run<factor_kernel<T, BLOCKED>>(dim3(batch), tiles_bytes(3, b, BLOCKED), stream, (const T*)D,
                                        (const T*)C, (const T*)Lc, (T*)L, (T*)Wt, (int*)info, seg, b);
}

// A solve step (FORWARD: forward_solve, else solve_backward) on its route.
// The blocked route's scratch may be null when every block's columns fit
// one chunk (the carry then stays in the stage).
template <typename T, bool FORWARD>
static int solve_step(const void* L, const void* Wt, const void* B, const void* carry0, void* out, void* scratch,
                      int batch, int seg, int b, int k, int kc, int splits, bool blocked, void* stream) {
  if (!blocked) {
    if (splits != 1 || !scratch) return -1;
    const size_t smem = tiles_bytes(2, b) + stage_bytes(b, kc);
    if constexpr (FORWARD)
      return run<forward_solve_kernel<T>>(dim3(batch), smem, stream, (const T*)L, (const T*)Wt, (const T*)B,
                                          (const T*)carry0, (T*)out, (float*)scratch, seg, b, k, kc);
    else
      return run<solve_backward_kernel<T>>(dim3(batch), smem, stream, (const T*)L, (const T*)Wt, (const T*)B,
                                           (const T*)carry0, (T*)out, (float*)scratch, seg, b, k, kc);
  }
  if (!scratch && (k + splits - 1) / splits > kc) return -1;
  const size_t smem = tiles_bytes(2, b, true) + blocked_stage_bytes(b, kc);
  return run<solve_blocked_kernel<T, FORWARD>>(dim3(batch, splits), smem, stream, (const T*)L, (const T*)Wt,
                                               (const T*)B, (const T*)carry0, (T*)out, (float*)scratch, seg, b, k,
                                               kc, splits);
}

// route: 0 sweep, 1 blocked (ops/blocktri_small.chain_route); splits: the
// column split of the blocked route (ops/blocktri_small.rhs_splits), 1 on
// the sweep route
extern "C" int capital_bt_fused_forward(int dtype, const void* D, const void* C, const void* B, const void* Lc,
                                        const void* yc, void* L, void* Wt, void* y, void* info, void* scratch,
                                        int batch, int seg, int b, int k, int kc, int splits, int route,
                                        void* stream) {
  if (b < 1 || b > MAX_B || seg < 1 || k < 0 || (k > 0 && (kc < 1 || kc > k)) || route < 0 || route > 1 ||
      !split_ok(k, splits))
    return -1;
  auto go = dtype == DT_F32 ? fused_forward<float> : dtype == DT_BF16 ? fused_forward<bf16> : nullptr;
  return go ? go(D, C, B, Lc, yc, L, Wt, y, info, scratch, batch, seg, b, k, kc, splits, route == 1, stream) : -1;
}

extern "C" int capital_bt_factor(int dtype, const void* D, const void* C, const void* Lc, void* L, void* Wt,
                                 void* info, int batch, int seg, int b, int route, void* stream) {
  if (b < 1 || b > MAX_B || seg < 1 || route < 0 || route > 1) return -1;
  auto go = dtype == DT_F32    ? (route ? factor<float, true> : factor<float, false>)
            : dtype == DT_BF16 ? (route ? factor<bf16, true> : factor<bf16, false>)
                               : nullptr;
  return go ? go(D, C, Lc, L, Wt, info, batch, seg, b, stream) : -1;
}

extern "C" int capital_bt_forward_solve(int dtype, const void* L, const void* Wt, const void* B, const void* yc,
                                        void* y, void* scratch, int batch, int seg, int b, int k, int kc,
                                        int splits, int route, void* stream) {
  if (b < 1 || seg < 1 || k < 1 || kc < 1 || kc > k || route < 0 || route > 1 || !split_ok(k, splits)) return -1;
  auto go = dtype == DT_F32 ? solve_step<float, true> : dtype == DT_BF16 ? solve_step<bf16, true> : nullptr;
  return go ? go(L, Wt, B, yc, y, scratch, batch, seg, b, k, kc, splits, route == 1, stream) : -1;
}

extern "C" int capital_bt_solve_backward(int dtype, const void* L, const void* Wtn, const void* Y,
                                         const void* xc, void* x, void* scratch, int batch, int seg, int b, int k,
                                         int kc, int splits, int route, void* stream) {
  if (b < 1 || seg < 1 || k < 1 || kc < 1 || kc > k || route < 0 || route > 1 || !split_ok(k, splits)) return -1;
  auto go = dtype == DT_F32 ? solve_step<float, false> : dtype == DT_BF16 ? solve_step<bf16, false> : nullptr;
  return go ? go(L, Wtn, Y, xc, x, scratch, batch, seg, b, k, kc, splits, route == 1, stream) : -1;
}
