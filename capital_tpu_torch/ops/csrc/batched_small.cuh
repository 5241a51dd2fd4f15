// Shared device functions of the small-N batched kernels: the Cholesky
// column sweep and the three triangular sweeps, on f32 tiles in shared
// memory, run by one block of NT threads.
//
// These are the in-kernel helpers of capital_tpu/ops/batched_small.py
// (_chol :198, _fwd_solve :249, _bwd_solve :275, _rsolve_upper :298).  The
// TPU sweeps were one-hot contractions over the whole matrix (~6n³ executed
// flops for a Cholesky); these do the useful work only (n³/3), with one or
// two block barriers per column.  Every function is called by all threads
// of the block, expects its operands ready in shared memory (after a
// barrier) and ends with a barrier, so calls chain.
//
// A triangular factor is kept in one of two layouts, named by
// `upper_stored`: L in the lower triangle (L(r, c) = S[r·ld + c]) or Lᵀ in
// the upper triangle (L(r, c) = S[c·ld + r]).  Leading dimensions of n x n
// tiles are odd (odd_ld), so a walk down a column hits 32 distinct banks.
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

}  // namespace small
