// Small-N batched solves: potrf, trsm, potrs, posv and lstsq over a batch
// of independent problems, one block per problem (blockIdx.x = problem).
//
// Replaces capital_tpu/ops/batched_small.py: the one pallas_call (:358,
// through _batched_call :347) of potrf :398, trsm :431, potrs :470, posv
// :506 and lstsq :546.  As there, the batch is the grid and problems share nothing:
// a NaN in one problem reaches only its own outputs and info.
//
// What bounds them on the card: at the throughput batch (8192 problems of
// order 128, 8 right-hand sides) potrf, potrs and posv are bound by bytes
// (the operand is read once, ~1 useful flop per byte); lstsq at m = 512 by
// f32 operations (the gram, 2·m·n² flops per problem; IEEE f32, the
// reference's "highest" — TF32 is never used).  At the serve latency batch
// (8 problems) only 8 of the 132 SMs work and the time is the dependent
// chain of each factor and solve.  What the design does about it: each
// problem is loaded into shared memory once (upcast to f32) and every phase
// runs there; the factor of posv and the whole CholeskyQR2 state of lstsq
// never reach device memory; outputs are rounded once on store.  Sweeps are
// CUDA-core f32 with IEEE sqrt and division (see batched_small.cuh).  Not
// done yet: several blocks or a cluster per problem, tensor-core updates.
//
// potrf runs the blocked factor (chol_blocked, batched_small.cuh): three
// barriers a 16-column panel instead of two or three a column, the
// diagonal block in one warp's registers, the trailing update as 4 x 4
// register tiles fed by 16-byte shared loads; rows move as 4-entry vectors
// (16 bytes of f32, 8 of bf16) when n % 4 == 0.  256 threads a block, one
// problem a block: ptxas gives potrf_kernel 80 registers a thread (f32 and
// bf16, no spills; _build.build_logs()) and 192 B of static shared memory,
// and at n = 128 the tile is 128 x 132 f32 (67,584 B dynamic), so three
// blocks share an SM and the 8192-problem batch runs in 21 waves.
//
// potrs runs lstsq's blocked solves (fwd_blocked, then bwd_upper_blocked)
// on the factor's live triangle, loaded into both triangles of a
// 16-byte-row tile (U = R = Lᵀ above, L below, so both solves' tiles read
// rows): two barriers a 16-row panel of each solve where the sweeps took
// one or two a column, the panel's rows below (above) it as 4 x 4 register
// tiles.  At n = 128, k = 8 the block needs 73,728 B (three blocks an SM).
// trsm runs one of those two solves on the same tile (op(T) lower: the
// forward one; upper: the backward one), each reading one triangle, which
// is all it loads, in place of a column sweep (probes/update_trsm.py keeps
// that kernel: 2.126 ms at 8192 x 128 x 8 f32 on the H100, this one 0.431).
//
// posv is potrf's blocked factor and potrs' blocked solves in one block, on
// potrs' tile: A loaded by rows and scanned, chol_blocked (which leaves L
// below the diagonal and Lᵀ above it, the layout the solves read), then
// fwd_blocked and bwd_upper_blocked; a fault runs chol_sweep on A read again
// and mirrors its L.  The factor and the solves are two out-of-line
// functions, so each keeps its own kernel's register allocation (80, three
// blocks an SM).  X and info are the column sweeps' bit for bit, and
// potrs(potrf(A), B)'s, without the factor's trip through device memory.
// 73,728 B at n = 128, k = 8 (three blocks an SM); 135,168 B for serve's inv
// bucket (k = n = 128, one block an SM).
//
// lstsq, one problem a block, every phase on register tiles:
//   * the gram: [A | B] streams once through a double-buffered stage of
//     LSTSQ_ROWS rows (the next stage's 16-byte cp.async copies land while
//     the block works on this one, one barrier a stage); each warp keeps
//     three blocks of 32 4 x 4 tiles of G's lower triangle or of C = AᵀB in
//     registers for the whole m loop (two 16-byte shared loads per 16 FMAs)
//     and writes G and C to shared memory once;
//   * R1 and R2 by chol_blocked, V = R1⁻ᵀ·G (with t1 = R1⁻ᵀ·C in the same
//     solve) and G2 = V·R1⁻¹ by blocked solves (the 16 x 16 diagonal block
//     in registers, then a register-tiled trailing update: two barriers a
//     panel, not one a column), t2 and the back-substitution the same way,
//     and R = R2·R1 as 4 x 4 tiles of the upper triangle dealt out longest
//     first;
//   * each factor and solve applies its column sweep's operations in the
//     sweep's order, so the fast path computes what the sweeps compute; a
//     non-finite G or G2 or a factor chol_blocked does not certify runs the
//     column sweeps instead (G streamed again when G2 has replaced it),
//     whose info is the reference's.
// At n = 128, k = 8 the block needs 147,456 B: one block an SM, 16 waves of
// the 2048-problem batch.  ptxas: 167 registers (f32; bf16 153), no spill,
// under __launch_bounds__(NT, 1); left to itself it chose 128 and spilled.
//
// Shared memory per block (f32; potrf ld = potrf_ld(n), potrs, posv and
// trsm ld, ldy = potrs_lds(n, k), lstsq ld = lstsq_ld(n)), as
// capital_tpu_torch/ops/batched_small.smem_bytes computes it:
//   potrf              round4(n)·ld
//   potrs, posv, trsm  round4(n)·(ld + ldy)
//   lstsq              max(tile, stage) + tile + round4(n)·round4(k) + NB·round4(n),
//                      tile = round4(n)·ld, stage = 2·rows·(round32(n) + round16(k))
// Above 48 KB it is dynamic shared memory, enabled per kernel with
// cudaFuncSetAttribute.  lstsq's state: the stage, then G's copy and R1 (L1
// and L1ᵀ) in one tile; G -> V -> G2 -> R2 (L2 and L2ᵀ) -> R in the other
// (R = R2·R1 replaces L2ᵀ above the diagonal, L2 stays below); C -> t1 ->
// t2 -> X; a 16-column panel of G2 transposed.

#include "batched_small.cuh"

using namespace small;

constexpr int LSTSQ_ROWS = 32;
constexpr size_t SMEM_MAX = 232448 - 1024;

template <typename T>
__device__ void store_tile(T* dst, const float* src, int lds, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e - r * cols;
    dst[e] = Cast<T>::from(src[r * lds + c]);
  }
}

// the factor from the tile's rows: R = Lᵀ (the strict upper triangle holds
// Lᵀ) or L, the dead triangle exactly zero
template <typename T>
__device__ void store_factor(T* dst, const float* S, int ld, int n, int upper) {
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rows_vec4(dst, n)) {
    for (int r = wid; r < n; r += WARPS)
      for (int c = 4 * lane; c < n; c += 128) {
        float v[4];
        unpack4(v, *reinterpret_cast<const float4*>(S + r * ld + c));
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (upper ? c + t < r : c + t > r) v[t] = 0.f;
        store4(dst + r * n + c, v);
      }
  } else {
    for (int r = wid; r < n; r += WARPS)
      for (int c = lane; c < n; c += 32) {
        const bool live = upper ? c >= r : c <= r;
        dst[r * n + c] = Cast<T>::from(live ? S[r * ld + c] : 0.f);
      }
  }
}

// One problem a block: the input scanned as it loads, chol_blocked on the
// tile (ld from potrf_ld), and on a fault the column sweep on the input,
// whose info is the reference's; its lower triangle is then mirrored so
// both store rows.
template <typename T>
__global__ void __launch_bounds__(NT) potrf_kernel(const T* A, T* R, int* info, int n, int ld, int upper) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const long long off = (long long)blockIdx.x * n * n;
  const bool finite = !__syncthreads_or(load_rows(S, ld, A + off, n));
  int inf = finite ? chol_blocked(S, ld, n) : -1;
  if (inf < 0) {
    if (finite) {  // chol_blocked wrote the tile
      load_rows(S, ld, A + off, n);
      __syncthreads();
    }
    inf = chol_sweep(S, ld, n);
    mirror_lower(S, ld, n);
  }
  store_factor(R + off, S, ld, n, upper);
  if (threadIdx.x == 0) info[blockIdx.x] = inf;
}

// ---------------------------------------------------------------------------
// lstsq: the gram streamed into registers, the blocked factor, blocked solves
// ---------------------------------------------------------------------------

constexpr int GRAM_SLOTS = 3;    // gram blocks of 32 4 x 4 tiles a warp accumulates in one pass over A
constexpr int STAGE_UNITS = 8;   // 4-entry groups of a stage a thread copies, at most

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
// the n x n tiles' leading dimension: 16-byte rows, 4 mod 8 (potrf_ld's rule)
__host__ __device__ __forceinline__ int lstsq_ld(int n) {
  const int n4 = round4(n);
  return (n4 / 4) % 2 ? n4 : n4 + 4;
}
// rows of [A | B] a stage holds: LSTSQ_ROWS, fewer when a stage would
// hold more than STAGE_UNITS groups of 4 entries a thread
__host__ __device__ __forceinline__ int lstsq_stage_rows(int n, int k) {
  const int rows = STAGE_UNITS * NT / ((n + 3) / 4 + (k + 3) / 4);
  return rows < 1 ? 1 : (rows < LSTSQ_ROWS ? rows : LSTSQ_ROWS);
}
// a stage row: A's columns padded to 32, then B's padded to 16
__host__ __device__ __forceinline__ int lstsq_stage_ld(int n, int k) { return round_up(n, 32) + round_up(k, 16); }

// gram blocks covering G's lower triangle: 16 rows x 32 columns of G, a
// lane 4 x 4 (lanes 8 a row of tiles)
__device__ __forceinline__ int gram_blocks_g(int n) {
  int cnt = 0;
  for (int R = 0; 16 * R < n; ++R) cnt += min((16 * R + 15) / 32, (n - 1) / 32) + 1;
  return cnt;
}

// Gram block e as this lane's tile: i0 the row of G (or C), j0 the stage
// column of its second factor (A's for a G block, B's for a C block of 32
// rows x 16 columns).  False past the last block.
__device__ __forceinline__ bool gram_block(int e, int n, int k, int nA, int lane, int& i0, int& j0) {
  for (int R = 0; 16 * R < n; ++R) {
    const int c = min((16 * R + 15) / 32, (n - 1) / 32) + 1;
    if (e < c) {
      i0 = 16 * R + 4 * (lane / 8);
      j0 = 32 * e + 4 * (lane % 8);
      return true;
    }
    e -= c;
  }
  const int kc = (k + 15) / 16;
  if (kc == 0 || e >= (n + 31) / 32 * kc) return false;
  i0 = 32 * (e / kc) + 4 * (lane / 4);
  j0 = nA + 16 * (e % kc) + 4 * (lane % 4);
  return true;
}

// Stage rows r0 .. r0 + sr − 1 of [A | B] into `st` (rows of lds entries
// of T: A's columns from 0, B's from nA), zero past m.  Rows that start on
// 16-byte boundaries (`async`) move as 16-byte cp.async copies that land
// while the block works on the other buffer; others entry by entry.
template <typename T>
__device__ __forceinline__ void stage_fill(T* st, int lds, int nA, const T* a, const T* bm, int m, int n, int k,
                                           int r0, int sr, bool async) {
  constexpr int V = 16 / sizeof(T);
  if (async) {
    const int ga = n / V, gu = ga + k / V;
    for (int u = threadIdx.x; u < sr * gu; u += NT) {
      const int r = u / gu, q = u - r * gu, row = r0 + r;
      T* dst = st + r * lds + (q < ga ? V * q : nA + V * (q - ga));
      if (row >= m) *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else if (q < ga) cp_async16(dst, a + (long long)row * n + V * q);
      else cp_async16(dst, bm + (long long)row * k + V * (q - ga));
    }
    cp_async_commit();
  } else {
    const int w = n + k;
    for (int u = threadIdx.x; u < sr * w; u += NT) {
      const int r = u / w, c = u - r * w, row = r0 + r;
      T v = Cast<T>::from(0.f);
      if (row < m) v = c < n ? a[(long long)row * n + c] : bm[(long long)row * k + c - n];
      st[r * lds + (c < n ? c : nA + c - n)] = v;
    }
  }
}

// G = AᵀA into Q (both triangles, rows and columns < n) and C = AᵀB into C,
// from [A | B] streamed once per pass through a double-buffered stage `st`
// (2 x sr rows of lds entries of T, zero-initialised: its padding is never
// written).  Each warp keeps GRAM_SLOTS blocks of 32 register tiles for
// the whole pass (every FMA of the m loop in registers, two 16-byte shared
// loads per 16 FMAs, bf16 widened as it is read); the next stage's
// cp.async copies land while the block works on this one, one barrier a
// stage.  More blocks than 8 x GRAM_SLOTS (k > 16 at n = 128) take more
// passes.  Returns whether this thread wrote a non-finite entry of G.
template <typename T>
__device__ bool gram_stream(const T* a, const T* bm, int m, int n, int k, T* st, int sr, int lds, float* Q, int ld,
                            float* C, int ldc) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nA = round_up(n, 32);
  const bool async = n % V == 0 && k % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(bm) % 16 == 0;
  const int nblk = gram_blocks_g(n) + (n + 31) / 32 * ((k + 15) / 16), nst = (m + sr - 1) / sr;
  bool bad = false;
  for (int pass = 0; pass * GRAM_SLOTS * WARPS < nblk; ++pass) {
    int i0[GRAM_SLOTS], j0[GRAM_SLOTS];
    bool act[GRAM_SLOTS];
    float acc[GRAM_SLOTS][4][4];
#pragma unroll
    for (int s = 0; s < GRAM_SLOTS; ++s) {
      i0[s] = j0[s] = 0;  // a slot past the last block reads column 0 and is never written
      act[s] = gram_block((pass * GRAM_SLOTS + s) * WARPS + warp, n, k, nA, lane, i0[s], j0[s]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;
    }
    stage_fill(st, lds, nA, a, bm, m, n, k, 0, sr, async);
    cp_async_wait_all();
    __syncthreads();
    for (int s = 0; s < nst; ++s) {
      if (s + 1 < nst) stage_fill(st + ((s + 1) & 1) * sr * lds, lds, nA, a, bm, m, n, k, (s + 1) * sr, sr, async);
      const T* buf = st + (s & 1) * sr * lds;
      const int rows = min(sr, m - s * sr);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const T* row = buf + r * lds;
#pragma unroll
        for (int q = 0; q < GRAM_SLOTS; ++q) {
          float x[4], y[4];
          load4(row + i0[q], x);
          load4(row + j0[q], y);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[q][i][j] = fmaf(x[i], y[j], acc[q][i][j]);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < GRAM_SLOTS; ++q) {
      if (!act[q]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = i0[q] + i, c = j0[q] + j;
          const float v = acc[q][i][j];
          if (c >= nA) {
            if (r < n && c - nA < k) C[r * ldc + c - nA] = v;
          } else if (r < n && c <= r) {
            Q[r * ld + c] = v;
            Q[c * ld + r] = v;
            bad |= !isfinite(v);
          }
        }
    }
  }
  return bad;
}

// W·R = V in place on W (round4(n) rows, n columns, ldw), R = Lᵀ of a
// chol_blocked tile (R's rows are the tile's upper rows).  Panels of NB
// columns: a thread a row solves the diagonal block in registers
// (x_j = W[i][j]/d_j, then W[i][l] −= x_j·R[j][l], as rsolve_upper_sweep)
// and writes x transposed into XT (NB x round4(n)); 4 x 4 register tiles
// then take the columns right of the panel, j ascending.
__device__ void rsolve_blocked(const float* S, int ld, int n, float* W, int ldw, float* XT) {
  const int n4 = round4(n);
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int w = min(NB, n - k0), w4 = round4(w);
    for (int i = threadIdx.x; i < n4; i += NT) {
      float x[NB];
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        if (4 * q < w4) unpack4(x + 4 * q, ld4(W + i * ldw + k0 + 4 * q));
        else x[4 * q] = x[4 * q + 1] = x[4 * q + 2] = x[4 * q + 3] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= w) break;
        x[j] = x[j] / safe_div(S[(k0 + j) * ld + k0 + j]);
        const float* rt = S + (k0 + j) * ld + k0;  // R[k0 + j][k0 + l] at column k0 + l
#pragma unroll
        for (int q = (j + 1) / 4; q < NB / 4; ++q) {
          if (4 * q >= w4) break;
          float v[4];
          unpack4(v, ld4(rt + 4 * q));
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (4 * q + t > j) x[4 * q + t] = fmaf(-x[j], v[t], x[4 * q + t]);
        }
      }
#pragma unroll
      for (int q = 0; q < NB / 4; ++q)
        if (4 * q < w4) st4(W + i * ldw + k0 + 4 * q, x + 4 * q);
#pragma unroll
      for (int j = 0; j < NB; ++j) XT[j * n4 + i] = x[j];
    }
    __syncthreads();
    const int t0 = k0 + NB;
    if (t0 >= n4) break;
    const int cg = (n4 - t0) / 4;
    for (int e = threadIdx.x; e < n4 / 4 * cg; e += NT) {
      const int i0 = 4 * (e / cg), l0 = t0 + 4 * (e % cg);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack4(acc[i], ld4(W + (i0 + i) * ldw + l0));
#pragma unroll 4
      for (int j = 0; j < NB; ++j) {
        float x[4], r[4];
        unpack4(x, ld4(XT + j * n4 + i0));
        unpack4(r, ld4(S + (k0 + j) * ld + l0));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(-x[i], r[t], acc[i][t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(W + (i0 + i) * ldw + l0, acc[i]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// potrs and posv: the blocked solves on a tile holding both triangles
// ---------------------------------------------------------------------------

// whether rows of k entries at p can move in 4-entry vectors
template <typename T>
__device__ __forceinline__ bool cols_vec4(const T* p, int k) {
  return k % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// B (n x k) into Y (round4(n) rows of ldy), zero padding up to round4(k)
// columns and round4(n) rows
template <typename T>
__device__ void load_rhs(float* Y, int ldy, const T* src, int n, int k) {
  const int n4 = round4(n), k4 = round4(k), pad = k4 - k;
  if (cols_vec4(src, k)) {
    const int q = k / 4;
    for (int e = threadIdx.x; e < n * q; e += NT) {
      const int r = e / q, c = 4 * (e - r * q);
      float v[4];
      load4(src + r * k + c, v);
      store4(Y + r * ldy + c, v);
    }
  } else {
    for (int e = threadIdx.x; e < n * k; e += NT) {
      const int r = e / k, c = e - r * k;
      Y[r * ldy + c] = widen(src[e]);
    }
  }
  for (int e = threadIdx.x; e < n * pad; e += NT) Y[(e / pad) * ldy + k + e % pad] = 0.f;
  for (int e = threadIdx.x; e < (n4 - n) * k4; e += NT) Y[(n + e / k4) * ldy + e % k4] = 0.f;
}

// X (n x k) from Y's rows, rounded once
template <typename T>
__device__ void store_rhs(T* dst, const float* Y, int ldy, int n, int k) {
  if (cols_vec4(dst, k)) {
    const int q = k / 4;
    for (int e = threadIdx.x; e < n * q; e += NT) {
      const int r = e / q, c = 4 * (e - r * q);
      float v[4];
      unpack4(v, ld4(Y + r * ldy + c));
      store4(dst + r * k + c, v);
    }
  } else {
    for (int e = threadIdx.x; e < n * k; e += NT) {
      const int r = e / k, c = e - r * k;
      dst[e] = Cast<T>::from(Y[r * ldy + c]);
    }
  }
}

// One problem a block: the factor into both triangles of S, B into Y,
// then fwd_blocked (L·Z = B, L read from U's rows) and bwd_upper_blocked
// (U·X = Z, U's columns read from L's rows) in place on Y — fwd_sweep's and bwd_sweep's operations in
// their order, so X is the column-sweep kernel's bit for bit; bf16 widened
// on load, rounded once on store.
template <typename T>
__global__ void __launch_bounds__(NT, 3) potrs_kernel(const T* Tm, const T* B, T* X, int n, int k, int upper, int ld,
                                                   int ldy) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* Y = S + round4(n) * ld;
  const long long b = blockIdx.x;
  load_factor_both(S, ld, Tm + b * n * n, n, upper);
  load_rhs(Y, ldy, B + b * n * k, n, k);
  __syncthreads();
  fwd_blocked<true>(S, ld, n, Y, ldy, k);
  bwd_upper_blocked<true, true>(S, ld, n, Y, ldy, k);
  store_rhs(X + b * n * k, Y, ldy, n, k);
}

// T's live triangle into ONE triangle of the 16-byte-row tile S — the
// upper one (`to_upper`) or the lower one — T[r][c] at S[r][c] where T's
// live triangle is that one, else at S[c][r] (`flip`); S's padding
// (columns n..round4(n), rows n..round4(n)) zeroed.  Where rows move as
// 4-entry vectors (no padding then), a thread takes a 4 x 4 block of T
// that holds live entries through registers: four rows' 16-byte loads,
// then four 16-byte stores, transposed when flipped — consecutive threads
// along a row band of T, or down a column band when flipped, so a
// quarter-warp stores 128 contiguous bytes (a flipped entry-by-entry store
// conflicted 16 ways at ld ≡ 4 mod 8).  A diagonal block also carries T's
// dead entries into S's other triangle, which no solve reads; S's other
// triangle is otherwise left as it was.
template <typename T>
__device__ void load_factor_one(float* __restrict__ S, int ld, const T* __restrict__ src, int n, int upper,
                                bool to_upper) {
  const int n4 = round4(n), pad = n4 - n;
  const bool flip = (upper != 0) != to_upper;
  if (rows_vec4(src, n)) {
    const int tb = n / 4;
    for (int e = threadIdx.x; e < tb * tb; e += NT) {
      const int a = e / tb, z = e - a * tb;
      const int bi = flip ? z : a, bj = flip ? a : z;  // T's row and column block
      if (upper ? bj < bi : bj > bi) continue;         // all dead
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(src + (4 * bi + i) * n + 4 * bj, v[i]);
      if (flip) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
          st4(S + (4 * bj + j) * ld + 4 * bi, t);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) st4(S + (4 * bi + i) * ld + 4 * bj, v[i]);
      }
    }
  } else {
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = wid; r < n; r += WARPS)
      for (int c = (upper ? r : 0) + lane; c < (upper ? n : r + 1); c += 32)
        S[flip ? c * ld + r : r * ld + c] = widen(src[r * n + c]);
  }
  for (int e = threadIdx.x; e < n * pad; e += NT) S[(e / pad) * ld + n + e % pad] = 0.f;
  for (int e = threadIdx.x; e < pad * ld; e += NT) S[n * ld + e] = 0.f;
}

// op(T)·X = B, one problem a block, on potrs' tile and blocked solves, B
// beside the factor.  op(T) lower ('L' without trans: L = T; 'U' with
// trans: L = Tᵀ): Lᵀ into S's upper triangle, then fwd_blocked, which
// reads only that triangle.  op(T) upper ('U': U = T; 'L' with trans: U =
// Tᵀ): Uᵀ into S's lower triangle, then bwd_upper_blocked with
// `diag_lower`, which reads only that one (and reads its diagonal block's
// rows and divisors ahead of the dependent chain).  So half the cases load
// T transposed and half as it lies, and none stores a triangle it does
// not read.  Both solves apply their column sweep's operations in the
// sweep's order (fwd_sweep, bwd_sweep), so X is the column-sweep kernel's
// bit for bit; bf16 widened on load, rounded once on store.  One instance
// a direction: both solves in one body behind a run-time branch spilled
// 84 B under the three-blocks-an-SM cap; the forward solve reading ahead
// (`fwd_blocked<true, true>`) spilled 104 B there and was 4–13 % slower
// (probes/update_trsm.py).
template <typename T, bool FORWARD>
__global__ void __launch_bounds__(NT, 3) trsm_kernel(const T* Tm, const T* B, T* X, int n, int k, int upper, int ld,
                                                  int ldy) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* Y = S + round4(n) * ld;
  const long long b = blockIdx.x;
  load_factor_one(S, ld, Tm + b * n * n, n, upper, FORWARD);
  load_rhs(Y, ldy, B + b * n * k, n, k);
  __syncthreads();
  if constexpr (FORWARD) fwd_blocked<true>(S, ld, n, Y, ldy, k);
  else bwd_upper_blocked<true, true, true>(S, ld, n, Y, ldy, k);
  store_rhs(X + b * n * k, Y, ldy, n, k);
}

// posv's two halves, each kept out of line (__noinline__) so that the kernel
// gets potrf's register allocation around the factor and potrs' around the
// solves under its three-blocks-an-SM cap (80 registers): inlined into one
// body they spilled 292 bytes and took 2.33 ms at 8192 x 128 x 8 f32 on the
// H100, out of line each call saves a few registers once and the kernel took
// 1.78 (probes/posv_chain.py keeps the one-body kernel as a variant).
//
// The factor: A (the block's problem) into the 16-byte-row tile, scanned for
// non-finite entries as it loads, and chol_blocked, which leaves L below the
// diagonal and Lᵀ above it; a non-finite input, or a factor chol_blocked does
// not certify, runs chol_sweep on A read again (its info is the reference's)
// and mirrors its L.  Returns info.
template <typename T>
__device__ __noinline__ int posv_factor(float* S, int ld, const T* a, int n) {
  const bool finite = !__syncthreads_or(load_rows(S, ld, a, n));
  int inf = finite ? chol_blocked(S, ld, n) : -1;
  if (inf < 0) {
    if (finite) {  // chol_blocked wrote the tile, its padding too
      zero_pad(S, ld, n);
      load_rows(S, ld, a, n);
      __syncthreads();
    }
    inf = chol_sweep(S, ld, n);
    mirror_lower(S, ld, n);
  }
  return inf;
}

// The solves in place on Y, potrs' arithmetic: L·Z = B (L read from the rows
// of Lᵀ), then Lᵀ·X = Z (U's columns read from L's rows)
__device__ __noinline__ void posv_solve(const float* S, int ld, int n, float* Y, int ldy, int k) {
  fwd_blocked<true>(S, ld, n, Y, ldy, k);
  bwd_upper_blocked<true, true>(S, ld, n, Y, ldy, k);
}

// One problem a block, the factor never in device memory: potrs' tile
// (padding zeroed) and the right-hand sides beside it, posv_factor, then
// posv_solve.  Every part applies its column sweep's operations in the
// sweep's order, so X and info are the column-sweep kernel's, and
// potrs(potrf(A), B)'s, bit for bit.
template <typename T>
__global__ void __launch_bounds__(NT, 3) posv_kernel(const T* A, const T* B, T* X, int* info, int n, int k, int ld,
                                                  int ldy) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* Y = S + round4(n) * ld;
  const long long b = blockIdx.x;
  zero_pad(S, ld, n);
  load_rhs(Y, ldy, B + b * n * k, n, k);
  const int inf = posv_factor(S, ld, A + b * n * n, n);
  if (threadIdx.x == 0) info[b] = inf;
  posv_solve(S, ld, n, Y, ldy, k);
  store_rhs(X + b * n * k, Y, ldy, n, k);
}

// R = R2·R1 (both upper) into Q's strict upper triangle, then its diagonal:
// R2[i][l] = L2[l][i] from Q's lower triangle, R1[l][c] from P's upper one
// (chol_blocked leaves both factors in both triangles), R[i][c] =
// Σ_{l=i..c} R2[i][l]·R1[l][c], l ascending.  4 x 4 tiles of the upper
// triangle, longest first (diagonal-major from the far corner), dealt out in
// a zigzag so every thread gets about the same number of steps.
__device__ void r2r1_product(float* Q, const float* P, int ld, int n) {
  const int T = round4(n) / 4, tiles = T * (T + 1) / 2;
  for (int base = 0; base < tiles; base += NT) {
    const int e = base + ((base / NT) % 2 ? NT - 1 - (int)threadIdx.x : (int)threadIdx.x);
    if (e >= tiles) continue;
    int m = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (m * (m + 1) / 2 > e) --m;
    while ((m + 1) * (m + 2) / 2 <= e) ++m;
    const int ti = e - m * (m + 1) / 2, i0 = 4 * ti, c0 = 4 * (ti + T - 1 - m);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][t] = 0.f;
    const int hi = min(c0 + 4, n);
    for (int l = i0; l < hi; ++l) {
      float a[4], b[4];
      unpack4(a, ld4(Q + l * ld + i0));  // L2[l][i0 + i]: live for i0 + i <= l
      unpack4(b, ld4(P + l * ld + c0));  // R1[l][c0 + t]: live for c0 + t >= l
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = i0 + i <= l ? a[i] : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) b[t] = c0 + t >= l ? b[t] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (c0 + t > i0 + i && c0 + t < n) Q[(i0 + i) * ld + c0 + t] = acc[i][t];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NT) Q[i * ld + i] *= P[i * ld + i];
  __syncthreads();
}

// One problem a block.  The fast path: the gram (gram_stream), R1 =
// chol_blocked(G) on a copy, V = R1⁻ᵀ·G with t1 = R1⁻ᵀ·C in the same
// blocked solve (fwd_blocked) and G2 = V·R1⁻¹ (rsolve_blocked) in place of
// G, R2 = chol_blocked(G2), t2 = R2⁻ᵀ·t1, R = R2·R1 and the
// back-substitution (bwd_upper_blocked):
// every factor and solve is its column sweep's arithmetic in its order, so
// the path computes what the sweeps compute.  A non-finite G or G2, or a
// factor that chol_blocked does not certify, sends the problem through the
// column sweeps instead (G streamed again when G2 has replaced it), whose
// info is the reference's.
template <typename T>
__global__ void __launch_bounds__(NT, 1) lstsq_kernel(const T* A, const T* B, T* X, int* info, int m, int n, int k) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, n4 = round4(n), ld = lstsq_ld(n), ldc = round4(k);
  const int sr = lstsq_stage_rows(n, k), lds = lstsq_stage_ld(n, k);
  float* P = reinterpret_cast<float*>(smem4);   // the stage -> G's copy -> L1 (and L1ᵀ)
  float* Q = P + max(n4 * ld, 2 * sr * lds);    // G -> V -> G2 -> L2, then R = R2·R1 above the diagonal
  float* C = Q + n4 * ld;                       // AᵀB -> t1 -> t2 -> X
  float* XT = C + n4 * ldc;                     // a panel of G2, transposed
  const long long b = blockIdx.x;
  const T* a = A + b * m * n;
  const T* bm = B + b * m * k;
  const int tile = n4 * ld;

  auto stream = [&]() {
    for (int e = tid; e < tile; e += NT) Q[e] = 0.f;
    for (int e = tid; e < 2 * sr * lds; e += NT) P[e] = 0.f;
    __syncthreads();
    return !__syncthreads_or(gram_stream(a, bm, m, n, k, reinterpret_cast<T*>(P), sr, lds, Q, ld, C, ldc));
  };
  auto copy_g = [&]() {  // P = G, padding included
    for (int e = tid; e < tile; e += NT) P[e] = Q[e];
    __syncthreads();
  };

  for (int e = tid; e < n4 * ldc; e += NT) C[e] = 0.f;
  const bool finite = stream();
  copy_g();
  int route = finite ? chol_blocked(P, ld, n) : -1;  // 0: R1 ready
  if (route == 0) {
    fwd_blocked(P, ld, n, Q, ld, n, C, ldc, k);  // V = R1⁻ᵀ·G and t1 = R1⁻ᵀ·C
    rsolve_blocked(P, ld, n, Q, ld, XT);  // G2 = V·R1⁻¹
    bool nf = false;
    for (int e = tid; e < n * n; e += NT) {
      const int r = e / n, c = e - r * n;
      nf |= !isfinite(Q[r * ld + c]);
    }
    route = __syncthreads_or(nf) ? -1 : chol_blocked(Q, ld, n);  // R2
    if (route != 0) stream();  // G and C again, for the sweeps
  }
  int inf = 0;
  if (route == 0) {
    fwd_blocked(Q, ld, n, C, ldc, k);  // t2 = R2⁻ᵀ·t1
    r2r1_product(Q, P, ld, n);
    bwd_upper_blocked(Q, ld, n, C, ldc, k);  // X = R⁻¹·t2
  } else {
    copy_g();
    const int info1 = chol_sweep(P, ld, n);        // R1
    fwd_sweep(P, ld, false, Q, ld, n, n);          // V = R1⁻ᵀ·G
    rsolve_upper_sweep(P, ld, false, Q, ld, n);    // G2 = V·R1⁻¹
    const int info2 = chol_sweep(Q, ld, n);        // R2
    fwd_sweep(P, ld, false, C, ldc, n, k);         // t1 = R1⁻ᵀ·C
    fwd_sweep(Q, ld, false, C, ldc, n, k);         // t2 = R2⁻ᵀ·t1
    // R = R2·R1 (both upper): R[i][c] = Σ_{l=i..c} L2[l][i]·L1[c][l], into
    // Q's strict upper triangle (L2 read from its lower one), then the
    // diagonal
    const int ty = tid / 32, tx = tid % 32;
    for (int i = ty; i < n; i += WARPS) {
      for (int c = i + 1 + tx; c < n; c += 32) {
        float acc = 0.f;
        for (int l = i; l <= c; ++l) acc += Q[l * ld + i] * P[c * ld + l];
        Q[i * ld + c] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += NT) Q[i * ld + i] *= P[i * ld + i];
    __syncthreads();
    bwd_sweep(Q, ld, true, C, ldc, n, k);          // X = R⁻¹·t2
    inf = max(info1, info2);
  }
  store_tile(X + b * n * k, C, ldc, n, k);
  if (tid == 0) info[b] = inf;
}

// ---------------------------------------------------------------------------
// C entries: return the cudaError_t of the launch (0 = launched), -1 for
// arguments the kernels do not take.  Every pointer is a contiguous
// (batch, rows, cols) stack; info is (batch,) int32.
// ---------------------------------------------------------------------------

// The shared-memory limit is raised to SMEM_MAX once per kernel, at its
// first launch; that covers every size the wrappers admit.
template <auto Kernel, typename... Args>
static int run(int batch, size_t smem, void* stream, Args... args) {
  if (smem > SMEM_MAX || batch < 1) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The potrf tile's leading dimension: round4(n) (16-byte rows), plus 4 when
// that makes ld ≡ 4 (mod 8) and still fits, so the 16-byte row loads of
// eight lanes on eight consecutive rows hit distinct banks.  Shared memory
// is round4(n)·ld floats (ops/batched_small.smem_bytes): n <= 240 fits.
static int potrf_ld(int n) {
  const int n4 = round4(n), ld = (n4 / 4) % 2 ? n4 : n4 + 4;
  return sizeof(float) * (size_t)n4 * ld <= SMEM_MAX ? ld : n4;
}

extern "C" int capital_small_potrf(int dtype, const void* A, void* R, void* info, int batch, int n,
                                   int upper, void* stream) {
  if (n < 1) return -1;
  const int ld = potrf_ld(n);
  const size_t smem = sizeof(float) * (size_t)round4(n) * ld;
  if (dtype == DT_F32)
    return run<potrf_kernel<float>>(batch, smem, stream, (const float*)A, (float*)R, (int*)info, n, ld, upper);
  if (dtype == DT_BF16)
    return run<potrf_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (bf16*)R, (int*)info, n, ld, upper);
  return -1;
}

// potrs' tile strides: round4(n) and round4(k) floats, each plus 4 when
// that makes it 4 mod 8 and the working set, round4(n) rows of both, still
// fits (ops/batched_small._potrs_lds mirrors it)
static void potrs_lds(int n, int k, int* ld, int* ldy) {
  const int n4 = round4(n), k4 = round4(k);
  const int lp = (n4 / 4) % 2 ? n4 : n4 + 4, yp = (k4 / 4) % 2 ? k4 : k4 + 4;
  const size_t fit = SMEM_MAX / sizeof(float) / n4;
  *ld = lp + yp <= (int)fit ? lp : n4;
  *ldy = *ld + yp <= (int)fit ? yp : k4;
}

extern "C" int capital_small_potrs(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                   int k, int upper, void* stream) {
  if (n < 1 || k < 0) return -1;
  int ld, ldy;
  potrs_lds(n, k, &ld, &ldy);
  const size_t smem = sizeof(float) * (size_t)round4(n) * (ld + ldy);
  if (dtype == DT_F32)
    return run<potrs_kernel<float>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X, n, k, upper,
                                    ld, ldy);
  if (dtype == DT_BF16)
    return run<potrs_kernel<bf16>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X, n, k, upper,
                                   ld, ldy);
  return -1;
}

extern "C" int capital_small_trsm(int dtype, const void* Tm, const void* B, void* X, int batch, int n,
                                  int k, int upper, int forward, void* stream) {
  if (n < 1 || k < 0) return -1;
  int ld, ldy;
  potrs_lds(n, k, &ld, &ldy);
  const size_t smem = sizeof(float) * (size_t)round4(n) * (ld + ldy);
  if (dtype == DT_F32)
    return forward ? run<trsm_kernel<float, true>>(batch, smem, stream, (const float*)Tm, (const float*)B, (float*)X,
                                                   n, k, upper, ld, ldy)
                   : run<trsm_kernel<float, false>>(batch, smem, stream, (const float*)Tm, (const float*)B,
                                                    (float*)X, n, k, upper, ld, ldy);
  if (dtype == DT_BF16)
    return forward ? run<trsm_kernel<bf16, true>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X,
                                                  n, k, upper, ld, ldy)
                   : run<trsm_kernel<bf16, false>>(batch, smem, stream, (const bf16*)Tm, (const bf16*)B, (bf16*)X,
                                                   n, k, upper, ld, ldy);
  return -1;
}

extern "C" int capital_small_posv(int dtype, const void* A, const void* B, void* X, void* info, int batch,
                                  int n, int k, void* stream) {
  if (n < 1 || k < 0) return -1;
  int ld, ldy;
  potrs_lds(n, k, &ld, &ldy);
  const size_t smem = sizeof(float) * (size_t)round4(n) * (ld + ldy);
  if (dtype == DT_F32)
    return run<posv_kernel<float>>(batch, smem, stream, (const float*)A, (const float*)B, (float*)X,
               (int*)info, n, k, ld, ldy);
  if (dtype == DT_BF16)
    return run<posv_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (const bf16*)B, (bf16*)X,
               (int*)info, n, k, ld, ldy);
  return -1;
}

// lstsq's shared memory (floats): the stage or G's copy, G -> ... -> R, C,
// and a panel of G2 (ops/batched_small.smem_bytes mirrors it)
static size_t lstsq_floats(int n, int k) {
  const size_t tile = (size_t)round4(n) * lstsq_ld(n);
  const size_t stage = 2 * (size_t)lstsq_stage_rows(n, k) * lstsq_stage_ld(n, k);
  return (tile > stage ? tile : stage) + tile + (size_t)round4(n) * round4(k) + (size_t)NB * round4(n);
}

extern "C" int capital_small_lstsq(int dtype, const void* A, const void* B, void* X, void* info, int batch,
                                   int m, int n, int k, void* stream) {
  if (n < 1 || k < 0 || m < n || n > NB + NT) return -1;
  const size_t smem = sizeof(float) * lstsq_floats(n, k);
  if (dtype == DT_F32)
    return run<lstsq_kernel<float>>(batch, smem, stream, (const float*)A, (const float*)B, (float*)X,
               (int*)info, m, n, k);
  if (dtype == DT_BF16)
    return run<lstsq_kernel<bf16>>(batch, smem, stream, (const bf16*)A, (const bf16*)B, (bf16*)X,
               (int*)info, m, n, k);
  return -1;
}
