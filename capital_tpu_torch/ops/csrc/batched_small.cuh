// Shared device functions of the small-N batched kernels and the chain's
// factor steps: the Cholesky column sweep and the three triangular sweeps,
// the blocked factor (chol_blocked), the blocked triangular solves
// (fwd_blocked, bwd_upper_blocked) and the tile loads, on f32 tiles in
// shared memory, run by one block of NT threads.
//
// These are the in-kernel helpers of capital_tpu/ops/batched_small.py
// (_chol :198, _fwd_solve :249, _bwd_solve :275, _rsolve_upper :298).  The
// TPU sweeps were one-hot contractions over the whole matrix (~6n³ executed
// flops for a Cholesky); these do the useful work only (n³/3), with one or
// two block barriers per column (chol_blocked: three per panel).  Every
// function but chol_blocked's three panel steps is called by all threads of
// the block, expects its operands ready in shared memory (after a barrier)
// and ends with a barrier, so calls chain.
//
// A triangular factor is kept in one of two layouts, named by
// `upper_stored`: L in the lower triangle (L(r, c) = S[r·ld + c]) or Lᵀ in
// the upper triangle (L(r, c) = S[c·ld + r]).  The sweeps' n x n tiles have
// an odd leading dimension (odd_ld), so a walk down a column hits 32
// distinct banks; the blocked functions' tiles have 16-byte rows (ld ≡ 4
// mod 8) and hold a factor in both triangles, so their walks are row walks.
//
// Exactness: sqrtf and division are IEEE (no fast-math, no rsqrtf), so a
// pivot of 1 divides by exactly 1 and identity problems solve exactly.
#pragma once

#include "common.cuh"

namespace small {

// threads per block of every batched_small kernel: 8 warps
constexpr int NT = 256;
constexpr int WARPS = NT / 32;

__host__ __device__ __forceinline__ int odd_ld(int n) { return (n % 2 == 0) ? n + 1 : n; }

// the substitution sweeps' guarded divisor (batched_small._safe_div)
__device__ __forceinline__ float safe_div(float d) { return (d != 0.f && isfinite(d)) ? d : 1.f; }

__device__ __forceinline__ float tri_at(const float* S, int ld, bool upper_stored, int r, int c) {
  return upper_stored ? S[c * ld + r] : S[r * ld + c];
}

// Cholesky of the symmetric n x n tile S (ld), in place: on return the lower
// triangle holds L (A = L·Lᵀ; R = Lᵀ).  Reads the lower triangle; the upper
// one only enters `info`.  Right-looking: at column j the pivot d = S[j][j],
// the column below it is divided by sqrt(d), and the trailing lower triangle
// takes the rank-1 update.
//
// info, the LAPACK potrf convention of the JAX kernel, exactly:
//   j + 1  at the first column j whose pivot is non-finite or <= 0, or whose
//          row of the working matrix holds a non-finite entry (row 0 of the
//          input for j = 0, column j of the live lower triangle after);
//   j + 2  when the working matrix holds a non-finite entry elsewhere at
//          step j (the JAX kernel's extracted column then spreads it to the
//          next pivot; at the last column this is n + 1);
//   n + 1  a clean diagonal with a non-finite factor entry.
// A bad pivot divides by 1.0 and the sweep goes on.  All threads return the
// same info.
__device__ int chol_sweep(float* S, int ld, int n) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  bool any = false, row0 = false;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (!isfinite(S[r * ld + c])) {
      any = true;
      row0 |= (r == 0);
    }
  }
  int sticky = __syncthreads_or(any);
  const int row0bad = __syncthreads_or(row0);
  int info = 0;
  bool upd_bad = false;
  for (int j = 0; j < n; ++j) {
    if (j > 0) sticky |= __syncthreads_or(upd_bad);  // step j-1's update has landed
    upd_bad = false;
    const float d = S[j * ld + j];
    const bool good = isfinite(d) && d > 0.f;
    const float s = sqrtf(good ? d : 1.f);
    bool cb = false;
    for (int l = j + 1 + tid; l < n; l += NT) {
      const float v = S[l * ld + j];
      cb |= !isfinite(v);
      S[l * ld + j] = v / s;
    }
    const int colbad = __syncthreads_or(cb);  // the scaled column is in
    if (tid == 0) S[j * ld + j] = d / s;       // nobody reads S[j][j] again this step
    if (info == 0) {
      if (!good || (j == 0 ? row0bad : colbad)) info = j + 1;
      else if (sticky) info = j + 2;
    }
    for (int l = j + 1 + ty; l < n; l += WARPS) {
      const float ul = S[l * ld + j];
      float* row = S + l * ld;
      for (int m = j + 1 + tx; m <= l; m += 32) {
        const float v = row[m] - ul * S[m * ld + j];
        row[m] = v;
        upd_bad |= !isfinite(v);
      }
    }
  }
  __syncthreads();
  bool ob = false;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (c <= r && !isfinite(S[r * ld + c])) ob = true;
  }
  if (__syncthreads_or(ob) && info == 0) info = n + 1;
  return info;
}

// ---------------------------------------------------------------------------
// chol_blocked: the same factor as chol_sweep, blocked right-looking with a
// panel of NB columns, on a tile laid out for 16-byte shared loads.  Each
// panel takes three block barriers (chol_sweep takes two or three a column):
//   1. warp 0 factors the NB x NB diagonal block in registers (lane i holds
//      row i; the pivot reaches the lanes by a shuffle, each column's scaled
//      entries through a small shared buffer) with no block barrier, and
//      checks the pivots there; it publishes the pivots' square roots and
//      writes L11 into the lower triangle and L11ᵀ into the upper one;
//   2. one thread per row below the block solves its row against L11 in
//      registers (L21 = A21·L11⁻ᵀ) and writes it back, and its transpose
//      into the strict upper triangle: the panel, k-major;
//   3. every thread takes 4 x 4 tiles of the trailing lower triangle (live
//      tiles only) and applies S -= L21·L21ᵀ in registers, reading the
//      k-major panel with two 16-byte loads per 16 FMAs.
//
// Arithmetic: every entry of the working matrix receives the operations
// chol_sweep applies to it, in the same order — v ← fma(−L[l][c], L[m][c], v)
// for c ascending (chol_sweep's `row[m] − ul·S[m][j]`, contracted), then
// v / sqrtf(d), or d / sqrtf(d) on the diagonal (IEEE sqrt and division) —
// so the factor is the column sweep's bit for bit; only the time at which
// an entry receives each update changes.
//
// info: the function certifies info 0 or gives up; it never computes a
// nonzero info.  The column sweep's info depends on the step at which a
// non-finite value reaches the working matrix, and the deferred trailing
// update moves that step (an overflow born in a trailing entry by column c
// shows at the panel's end, not at column c + 1).  But with a finite input
// every non-finite entry of L lies in some row l and, through
// S[l][l] −= L[l][c]², makes pivot l non-finite (fma, division and sqrt keep
// a non-finite value non-finite), while a column sweep with info 0 meets
// finite positive pivots only.  So the caller scans the whole input (both
// triangles) as it loads it and calls this on a finite one only; the
// function checks every pivot (and, as a second line, every entry of L it
// writes), and on any fault returns −1: the caller then factors the input
// again with chol_sweep, whose info is the reference's (`sweeps.chol_plain`).
// A return of 0 is the column sweep's info too, on the same factor.
//
// Size: n <= NB + NT (272), one thread a row below the diagonal block (a
// loop over the rows instead took potrf_kernel from 80 registers to 105,
// three blocks an SM to two); a larger n returns −1 before touching S, and
// the caller's column sweep factors it.  potrf's tile stops at n = 240.
//
// Layout: S 16-byte aligned, ld % 4 == 0, round4(n) rows of ld >= round4(n)
// floats (the trailing tiles run over the padding, which is never read back
// into a live entry).  On return 0 the lower triangle holds L and the
// strict upper triangle Lᵀ, so either factor is a row walk.  All NT threads
// call it after a barrier; it ends with one.
// ---------------------------------------------------------------------------

// panel width (at most 32: the diagonal block is one warp's rows): 16 beat
// 32 at the throughput batch (32 needs 102 registers a thread, two blocks an
// SM; 16 needs 80, three) and lost a little at the latency batch
// (probes/potrf_nb.py builds and times both)
constexpr int NB = 16;
constexpr unsigned FULL_MASK = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void unpack4(float* v, const float4 t) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Panel step 1, warp 0: the w x w diagonal block whose first entry is at
// `blk` (row stride ld).  Lane i keeps
// row i's live entries (c <= i) in registers, zeros above the diagonal.
// Per column: the pivot by one shuffle, the scaled column through shared
// memory (one store a lane, broadcast 16-byte loads), the update in
// registers.  The columns are fully unrolled with no runtime condition
// around a warp-wide operation (a branch there, even a uniform one, made
// each of them wait on the warp's reconvergence, at several times the
// column's arithmetic); columns past w (the last, narrow panel) run on the
// zero padding and are ignored.  Returns, to every lane, whether a pivot was bad or an entry of
// L11 non-finite.
__device__ __forceinline__ bool chol_diag_block(float* blk, int ld, int w, float* sq) {
  __shared__ __align__(16) float xs[2][NB];  // column j's scaled entries
  const int lane = threadIdx.x & 31, w4 = round4(w);
  float r[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) r[c] = 0.f;
  float* row = blk + lane * ld;
  if (lane < w) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      if (4 * q < w4) unpack4(r + 4 * q, *reinterpret_cast<const float4*>(row + 4 * q));
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) r[c] = (c <= lane && c < w) ? r[c] : 0.f;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = __shfl_sync(FULL_MASK, r[j], j);
    const bool good = isfinite(d) && d > 0.f;
    bad |= !good && j < w;
    const float s = sqrtf(good ? d : 1.f);
    if (lane == 0) sq[j] = s;
    // L[i][j] on lanes i > j, d / s on lane j; the other lanes divide s by
    // itself (a quotient nobody reads) so no lane takes the division's
    // slow path on a zero
    const bool live = j <= lane && lane < w;
    const float x = (live ? r[j] : s) / s;
    r[j] = live ? x : 0.f;
    if (lane < NB) xs[j & 1][lane] = x;  // two buffers: the next column's
    __syncwarp();                        // stores wait for no reader
#pragma unroll
    for (int q = (j + 1) / 4; q < NB / 4; ++q) {
      float v[4];
      unpack4(v, *reinterpret_cast<const float4*>(&xs[j & 1][4 * q]));
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t > j) r[4 * q + t] = (4 * q + t <= lane) ? fmaf(-x, v[t], r[4 * q + t]) : r[4 * q + t];
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c <= lane && lane < w) bad |= !isfinite(r[c]);
  bad = __any_sync(FULL_MASK, bad);
  // row i of the block (zeros above its diagonal, which the mirror
  // overwrites), then L11ᵀ into the block's upper triangle
  if (lane < w) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      if (4 * q < w4)
        *reinterpret_cast<float4*>(row + 4 * q) = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
  __syncwarp();
  if (lane < w) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c < lane) blk[c * ld + lane] = r[c];
  }
  return bad;
}

// Panel step 2: row l = k0 + NB + threadIdx.x of the rows below the block
// (one a thread: chol_blocked takes n <= NB + NT only), scaled and updated
// column by column as chol_sweep does it; L11 is read from its transpose
// (row c of the block's upper triangle: L11[m][c], m > c) with broadcast
// 16-byte loads.  Returns whether an entry is non-finite.
__device__ __forceinline__ bool chol_panel_row(float* S, int ld, int n, int k0, const float* sq) {
  const int l = k0 + NB + threadIdx.x;
  if (l >= n) return false;
  float x[NB];
  float* row = S + l * ld + k0;
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) unpack4(x + 4 * q, *reinterpret_cast<const float4*>(row + 4 * q));
  const float* Lt = S + k0 * ld + k0;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    x[c] = x[c] / sq[c];
#pragma unroll
    for (int q = (c + 1) / 4; q < NB / 4; ++q) {
      float v[4];
      unpack4(v, *reinterpret_cast<const float4*>(Lt + c * ld + 4 * q));
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t > c) x[4 * q + t] = fmaf(-x[c], v[t], x[4 * q + t]);
    }
  }
  bool bad = false;
#pragma unroll
  for (int c = 0; c < NB; ++c) bad |= !isfinite(x[c]);
#pragma unroll
  for (int q = 0; q < NB / 4; ++q)
    *reinterpret_cast<float4*>(row + 4 * q) = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
#pragma unroll
  for (int c = 0; c < NB; ++c) S[(k0 + c) * ld + l] = x[c];
  return bad;
}

// Panel step 3: S[l][m] −= Σ_c L[l][k0+c]·L[m][k0+c], c ascending, over the
// trailing lower triangle l >= m >= k0 + NB in 4 x 4 tiles (tile e of the
// packed lower triangle of tiles to thread e mod NT), the panel read from
// its transpose P[c·ld + l] = L[l][k0 + c].
__device__ __forceinline__ void chol_trailing(float* S, int ld, int n, int k0) {
  const int t0 = k0 + NB, T = (round4(n) - t0) / 4, tiles = T * (T + 1) / 2;
  const float* P = S + k0 * ld;
  for (int e = threadIdx.x; e < tiles; e += NT) {
    int ti = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > e) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= e) ++ti;
    const int l0 = t0 + 4 * ti, m0 = t0 + 4 * (e - ti * (ti + 1) / 2);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) unpack4(acc[r], *reinterpret_cast<const float4*>(S + (l0 + r) * ld + m0));
#pragma unroll 4
    for (int c = 0; c < NB; ++c) {
      float a[4], b[4];
      unpack4(a, *reinterpret_cast<const float4*>(P + c * ld + l0));
      unpack4(b, *reinterpret_cast<const float4*>(P + c * ld + m0));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(-a[r], b[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(S + (l0 + r) * ld + m0) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__device__ int chol_blocked(float* S, int ld, int n) {
  __shared__ float sq[NB];  // the current panel's sqrtf(pivot)
  const int wid = threadIdx.x / 32;
  if (n > NB + NT) return -1;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const bool bad = wid == 0 && chol_diag_block(S + k0 * ld + k0, ld, min(NB, n - k0), sq);
    if (__syncthreads_or(bad)) return -1;
    if (k0 + NB >= n) break;
    if (__syncthreads_or(chol_panel_row(S, ld, n, k0, sq))) return -1;
    chol_trailing(S, ld, n, k0);
    __syncthreads();
  }
  return 0;
}

// The blocked back-substitutions' diagonal step on one column `col` (rows
// k0 .. k0 + w, stride ldy) against U = S's upper rows: j descending,
// y_j = Y[j]/d_j, then Y[i] −= U[i][j]·y_j for i < j — bwd_sweep's
// operations in its order.  FULL (w == NB, every panel but a narrow last
// one) unrolls every bound on w away (see fwd_blocked's `full_panels`).
// LOWER reads U[i][j] from Uᵀ in S's lower triangle (S[j·ld + i]) instead,
// and reads ahead: the block's divisors all at once, and row j − 1 of Uᵀ
// (16-byte loads) while y_j divides, so the column's dependent chain waits
// on no shared-memory load (read in the chain's order, the loads of a row
// sat between two divisions).
template <bool FULL, bool LOWER = false>
__device__ __forceinline__ void bwd_diag_column(const float* S, int ld, int k0, int w, float* col, int ldy) {
  float y[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) y[i] = FULL || i < w ? col[(k0 + i) * ldy] : 0.f;
  if constexpr (LOWER) {
    float d[NB], v[NB / 4][4], vn[NB / 4][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) d[j] = FULL || j < w ? safe_div(S[(k0 + j) * ld + k0 + j]) : 1.f;
    const int top = FULL ? NB - 1 : w - 1;
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      if (4 * q < top) unpack4(v[q], ld4(S + (k0 + top) * ld + k0 + 4 * q));
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      if (!FULL && j >= w) continue;
      if (j > 0) {  // row j − 1 of Uᵀ: U[i][j − 1] for i < j − 1
#pragma unroll
        for (int q = 0; q < NB / 4; ++q)
          if (4 * q < j - 1) unpack4(vn[q], ld4(S + (k0 + j - 1) * ld + k0 + 4 * q));
      }
      y[j] = y[j] / d[j];
#pragma unroll
      for (int i = 0; i < j; ++i) y[i] = fmaf(-v[i / 4][i % 4], y[j], y[i]);
#pragma unroll
      for (int q = 0; q < NB / 4; ++q)
#pragma unroll
        for (int t = 0; t < 4; ++t) v[q][t] = vn[q][t];
    }
  } else {
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      if (!FULL && j >= w) continue;
      y[j] = y[j] / safe_div(S[(k0 + j) * ld + k0 + j]);
#pragma unroll
      for (int i = 0; i < j; ++i) y[i] = fmaf(-S[(k0 + i) * ld + k0 + j], y[j], y[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (FULL || i < w) col[(k0 + i) * ldy] = y[i];
}

// Forward substitution L·Y = B in place on Y (n x k, leading dimension ldy).
// Step j subtracts L[l][j]·(Y[j]/L[j][j]) from every row l > j; row j is
// not touched again, so the division of row j is done once at the end (the
// same quotient the update used).  Only the live triangle of L is read.
__device__ void fwd_sweep(const float* S, int ld, bool upper_stored, float* Y, int ldy, int n, int k) {
  for (int j = 0; j < n; ++j) {
    const float sd = safe_div(S[j * ld + j]);
    const int cnt = (n - j - 1) * k;
    for (int e = threadIdx.x; e < cnt; e += NT) {
      const int r = e / k, c = e - r * k, l = j + 1 + r;
      Y[l * ldy + c] -= tri_at(S, ld, upper_stored, l, j) * (Y[j * ldy + c] / sd);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n * k; e += NT) {
    const int r = e / k, c = e - r * k;
    Y[r * ldy + c] /= safe_div(S[r * ld + r]);
  }
  __syncthreads();
}

// Back substitution Lᵀ·X = Y in place on Y: columns descending, rows above.
__device__ void bwd_sweep(const float* S, int ld, bool upper_stored, float* Y, int ldy, int n, int k) {
  for (int j = n - 1; j >= 0; --j) {
    const float sd = safe_div(S[j * ld + j]);
    const int cnt = j * k;
    for (int e = threadIdx.x; e < cnt; e += NT) {
      const int r = e / k, c = e - r * k;
      Y[r * ldy + c] -= tri_at(S, ld, upper_stored, j, r) * (Y[j * ldy + c] / sd);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n * k; e += NT) {
    const int r = e / k, c = e - r * k;
    Y[r * ldy + c] /= safe_div(S[r * ld + r]);
  }
  __syncthreads();
}

// Right-side solve W·R = V in place on W (n x n, leading dimension ldw),
// R = Lᵀ upper triangular: columns ascending, W[:, l>j] -= (W[:, j]/R[j][j])
// · R[j][l]; the division of column j is done once at the end.
__device__ void rsolve_upper_sweep(const float* S, int ld, bool upper_stored, float* W, int ldw, int n) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  for (int j = 0; j < n; ++j) {
    const float sd = safe_div(S[j * ld + j]);
    for (int i = ty; i < n; i += WARPS) {
      const float w = W[i * ldw + j] / sd;
      for (int l = j + 1 + tx; l < n; l += 32) W[i * ldw + l] -= w * tri_at(S, ld, upper_stored, l, j);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, j = e - i * n;
    W[i * ldw + j] /= safe_div(S[j * ld + j]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// tile loads and the blocked triangular solves (batched_small.cu's potrf,
// potrs, posv and lstsq; blocktri_small.cu's chain factor)
// ---------------------------------------------------------------------------

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

// The factor's live triangle into both triangles of S — U = R = Lᵀ in the
// upper one, L in the lower one: T[r][c] to S[r][c] and S[c][r], whatever
// uplo names — a warp a row, 16 bytes a load where rows allow (four rows'
// loads in flight a thread before their stores); S's padding (columns
// n..round4(n), rows n..round4(n)) zeroed.  T's dead triangle is read only
// where a 16-byte load straddles the diagonal, and never stored.
template <typename T>
__device__ void load_factor_both(float* __restrict__ S, int ld, const T* __restrict__ src, int n, int upper) {
  constexpr int ROWS = 4;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = round4(n), pad = n4 - n;
  if (rows_vec4(src, n)) {
    for (int c = 4 * lane; c < n; c += 128)
      for (int r0 = wid; r0 < n; r0 += ROWS * WARPS) {
        float v[ROWS][4];
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          const int r = r0 + b * WARPS;
          if (r < n && (upper ? c + 3 >= r : c <= r)) load4(src + r * n + c, v[b]);
        }
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          const int r = r0 + b * WARPS;
          if (r >= n) continue;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (upper ? c + t >= r : c + t <= r) {
              S[r * ld + c + t] = v[b][t];
              S[(c + t) * ld + r] = v[b][t];
            }
        }
      }
  } else {
    for (int r = wid; r < n; r += WARPS)
      for (int c = (upper ? r : 0) + lane; c < (upper ? n : r + 1); c += 32) {
        const float v = widen(src[r * n + c]);
        S[r * ld + c] = v;
        S[c * ld + r] = v;
      }
  }
  for (int e = threadIdx.x; e < n * pad; e += NT) S[(e / pad) * ld + n + e % pad] = 0.f;
  for (int e = threadIdx.x; e < pad * ld; e += NT) S[n * ld + e] = 0.f;
}

// S's padding zeroed: columns n..round4(n) of rows < n, and rows
// n..round4(n) whole (ld floats)
__device__ __forceinline__ void zero_pad(float* S, int ld, int n) {
  const int pad = round4(n) - n;
  for (int e = threadIdx.x; e < n * pad; e += NT) S[(e / pad) * ld + n + e % pad] = 0.f;
  for (int e = threadIdx.x; e < pad * ld; e += NT) S[n * ld + e] = 0.f;
}

// chol_sweep's L (lower triangle) copied into the strict upper triangle,
// so the tile holds both triangles as chol_blocked leaves them; ends with a
// barrier
__device__ __forceinline__ void mirror_lower(float* S, int ld, int n) {
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, c = e - i * n;
    if (c > i) S[i * ld + c] = S[c * ld + i];
  }
  __syncthreads();
}

// fwd_blocked's diagonal step on one column `col` of Y (rows k0 .. k0 + w,
// stride ldy): y_j = Y[j]/d_j, then Y[i] −= L[i][j]·y_j for i > j, L read
// from the rows of Lᵀ.  FULL (w == NB) unrolls every bound on w away.
// AHEAD reads the block's divisors all at once and row j + 1 of Lᵀ while
// y_j divides (see bwd_diag_column's LOWER); the arithmetic is the same.
template <bool FULL, bool AHEAD = false>
__device__ __forceinline__ void fwd_diag_column(const float* S, int ld, int k0, int w, float* col, int ldy) {
  const int w4 = round4(w);
  float y[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) y[i] = FULL || i < w ? col[(k0 + i) * ldy] : 0.f;
  if constexpr (AHEAD) {
    float d[NB], v[NB / 4][4], vn[NB / 4][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) d[j] = FULL || j < w ? safe_div(S[(k0 + j) * ld + k0 + j]) : 1.f;
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      if (FULL || 4 * q < w4) unpack4(v[q], ld4(S + k0 * ld + k0 + 4 * q));
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!FULL && j >= w) break;
      if (j + 1 < (FULL ? NB : w)) {  // row j + 1 of Lᵀ: L[k0 + i][k0 + j + 1] at column k0 + i
#pragma unroll
        for (int q = (j + 2) / 4; q < NB / 4; ++q)
          if (FULL || 4 * q < w4) unpack4(vn[q], ld4(S + (k0 + j + 1) * ld + k0 + 4 * q));
      }
      y[j] = y[j] / d[j];
#pragma unroll
      for (int q = (j + 1) / 4; q < NB / 4; ++q) {
        if (!FULL && 4 * q >= w4) break;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * q + t > j) y[4 * q + t] = fmaf(-v[q][t], y[j], y[4 * q + t]);
      }
#pragma unroll
      for (int q = 0; q < NB / 4; ++q)
#pragma unroll
        for (int t = 0; t < 4; ++t) v[q][t] = vn[q][t];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!FULL && j >= w) break;
      y[j] = y[j] / safe_div(S[(k0 + j) * ld + k0 + j]);
      const float* lt = S + (k0 + j) * ld + k0;  // L[k0 + i][k0 + j] at column k0 + i
#pragma unroll
      for (int q = (j + 1) / 4; q < NB / 4; ++q) {
        if (!FULL && 4 * q >= w4) break;
        float v[4];
        unpack4(v, ld4(lt + 4 * q));
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * q + t > j) y[4 * q + t] = fmaf(-v[t], y[j], y[4 * q + t]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (FULL || i < w) col[(k0 + i) * ldy] = y[i];
}

// L·Y = B in place on Y = [Y1 | Y2] (n rows; nc1 columns of leading
// dimension ld1, then nc2 of ld2; zero past them up to round4), L from a
// chol_blocked tile S: L in its lower triangle, Lᵀ in its strict upper one,
// zero outside n.  Panels of NB rows: a thread a column solves the diagonal
// block in registers (y_j = Y[j]/d_j, then Y[i] −= L[i][j]·y_j, as
// fwd_sweep), then 4 x 4 register tiles take the rows below:
// Y[l] −= Σ_j L[l][j]·y_j, j ascending — every entry gets fwd_sweep's
// operations in fwd_sweep's order.  Two barriers a panel.
//
// `full_panels` gives the full panels (w == NB, all but a narrow last one)
// their own copy of the diagonal step, with no run-time bound on w inside
// its unrolled loops: in potrs those bounds cost spills under its
// three-blocks-an-SM register cap and a third of its time
// (probes/potrs_variants.py); lstsq, at one block an SM, keeps the single
// copy, whose second one would take it to 255 registers and spills.
// `ahead`: the diagonal step reads its loads ahead of the dependent chain
// (fwd_diag_column's AHEAD; the chain's solve steps, at one block an SM).
template <bool full_panels = false, bool ahead = false>
__device__ void fwd_blocked(const float* S, int ld, int n, float* Y1, int ld1, int nc1, float* Y2 = nullptr,
                            int ld2 = 0, int nc2 = 0) {
  const int n4 = round4(n), cg1 = round4(nc1) / 4, cg = cg1 + round4(nc2) / 4;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int w = min(NB, n - k0);
    for (int c = threadIdx.x; c < nc1 + nc2; c += NT) {
      float* col = c < nc1 ? Y1 + c : Y2 + c - nc1;
      const int ldy = c < nc1 ? ld1 : ld2;
      if (full_panels && w == NB) fwd_diag_column<true, ahead>(S, ld, k0, w, col, ldy);
      else fwd_diag_column<false, ahead>(S, ld, k0, w, col, ldy);
    }
    __syncthreads();
    const int t0 = k0 + NB;
    if (t0 >= n4) break;
    for (int e = threadIdx.x; e < (n4 - t0) / 4 * cg; e += NT) {
      const int l0 = t0 + 4 * (e / cg), g = e % cg;
      float* Y = g < cg1 ? Y1 + 4 * g : Y2 + 4 * (g - cg1);
      const int ldy = g < cg1 ? ld1 : ld2;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack4(acc[i], ld4(Y + (l0 + i) * ldy));
#pragma unroll 4
      for (int j = 0; j < NB; ++j) {
        float l[4], y[4];
        unpack4(l, ld4(S + (k0 + j) * ld + l0));
        unpack4(y, ld4(Y + (k0 + j) * ldy));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(-l[i], y[t], acc[i][t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(Y + (l0 + i) * ldy, acc[i]);
    }
    __syncthreads();
  }
}

// U·X = Y in place on Y (n rows, nc columns, ldy), U upper triangular in
// the rows of S (U[i][c] = S[i·ld + c], c >= i).  Panels of NB rows from
// the bottom: a thread a column solves the diagonal block (j descending, as
// bwd_sweep), then 4 x 4 register tiles take the rows above it, j
// descending — bwd_sweep's operations in bwd_sweep's order.  With
// `lower_rows` S also holds Uᵀ in its lower triangle, and the tiles read a
// column of U as a 16-byte load of a row of Uᵀ (four scalar loads that
// share two banks otherwise); `full_panels` as in fwd_blocked.  With
// `diag_lower` too the diagonal blocks read U from Uᵀ as well, so only S's
// lower triangle is read: L as the chain stores it, U = Lᵀ; their loads
// then run ahead of the dependent chain (bwd_diag_column's LOWER).
template <bool lower_rows = false, bool full_panels = false, bool diag_lower = false>
__device__ void bwd_upper_blocked(const float* S, int ld, int n, float* Y, int ldy, int nc) {
  const int cg = round4(nc) / 4;
  for (int k0 = (n - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int w = min(NB, n - k0);
    for (int c = threadIdx.x; c < nc; c += NT) {
      if (full_panels && w == NB) bwd_diag_column<true, diag_lower>(S, ld, k0, w, Y + c, ldy);
      else bwd_diag_column<false, diag_lower>(S, ld, k0, w, Y + c, ldy);
    }
    __syncthreads();
    if (k0 == 0) break;
    for (int e = threadIdx.x; e < k0 / 4 * cg; e += NT) {
      const int i0 = 4 * (e / cg), c0 = 4 * (e % cg);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack4(acc[i], ld4(Y + (i0 + i) * ldy + c0));
      for (int j = w - 1; j >= 0; --j) {
        float y[4], u[4];
        unpack4(y, ld4(Y + (k0 + j) * ldy + c0));
        if (lower_rows) {
          unpack4(u, ld4(S + (k0 + j) * ld + i0));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i] = S[(i0 + i) * ld + k0 + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(-u[i], y[t], acc[i][t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(Y + (i0 + i) * ldy + c0, acc[i]);
    }
    __syncthreads();
  }
}

}  // namespace small
