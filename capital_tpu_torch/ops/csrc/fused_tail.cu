// fused_tail: a whole cholinv recursion subtree in one launch — read the
// (n, n) window of buf (upper triangle valid), symmetrise it, factor it
// A = RᵀR, invert R by back-substituting the identity, and write triu(R)
// and triu(R⁻¹) into windows of Rp and RIp in place, with the
// potrf-convention info in a device int32.
//
// Replaces capital_tpu/ops/pallas_tpu.py:fused_tail (:751, the pallas_call
// at :827), cholinv's opt-in tail (models/cholesky.py, CI::tail_fused).
// Its arithmetic is that of the batched small-N kernels: chol_sweep and
// bwd_sweep of batched_small.cuh, the device functions of the JAX
// kernel's _chol and _bwd_solve.
//
// What bounds it on the card: the dependent chain of the factor and of the
// back-substitution, not bytes (the window read once, two windows written
// once) or flops (n³/3 + n³/3).  Both routes walk 16-column panels instead
// of columns (three block barriers a panel where the column sweep took two
// or three a column), keep the working set in shared memory between the
// phases, and take their trailing updates as 4 x 4 register tiles.  Two
// routes, picked in Python before the launch (hopper.tail_route):
//
//   block    one block holds the window (round4(n) <= 168): chol_blocked on
//            a 16-byte-row tile, then a blocked back-substitution of the
//            identity that never visits the blocks of R⁻¹ known to be zero
//            (bwd_inverse_blocked).  Shared memory: two tiles of
//            round4(n) x tail_ld(n) f32 (135,168 B at n = 128).
//   cluster  n = 256, 384, 512: a thread-block cluster of C blocks (2, 4 or
//            8; hopper.TAIL_CLUSTER_BLOCKS) holds one n x n f32 square in
//            distributed shared memory, 16-row panels dealt round-robin to
//            the blocks (panel p to block p mod C).  The square keeps L in
//            its lower triangle and, once L is done, R⁻¹ in its strict upper
//            one; R⁻¹'s diagonal sits in a vector beside it.  The factor
//            takes two cluster barriers a panel (the owner's diagonal block,
//            then the panel every block pushed into every block), the
//            back-substitution one (the owner's finished rows, which every
//            block copies before it updates its own rows above them).
//
// Exactness: every entry receives the column sweep's operations in the
// sweep's order (chol_blocked's contract; the back-substitution as
// bwd_upper_blocked), so a healthy window's R and R⁻¹ are the column
// sweeps' bit for bit — up to the sign of an exact zero, since the blocks
// of R⁻¹ known to be zero only ever add ±0 in the sweep.  The blocked
// factor certifies info 0 or gives up (chol_blocked): the input is scanned
// as it loads, every pivot and panel entry is checked, and any fault runs
// the column sweeps instead, whose info is the reference's — the block
// route on its tile, the cluster route in block 0 over an f32 copy of the
// window in device memory (the caller's scratch: the sweep needs the whole
// square in one block), slow but only on a fault.  `sweep` forces that path
// (the card's tests hold the blocked path to it bit for bit).

#include <cooperative_groups.h>

#include "batched_small.cuh"

namespace cg = cooperative_groups;
using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;
constexpr int PANEL = NB;  // 16: the rows of a panel, the columns of a diagonal block
static_assert(NT == PANEL * PANEL, "the cluster route copies L11ᵀ one entry a thread");

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// triu of an n x n f32 tile (rows of ld) into the window at dst, zeros below
template <typename T>
__device__ void store_upper(T* dst, long long ldr, const float* S, int ld, int n) {
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = wid; r < n; r += WARPS)
    for (int c = lane; c < n; c += 32) dst[r * ldr + c] = Cast<T>::from(c >= r ? S[r * ld + c] : 0.f);
}

// The column sweeps on the symmetrised window in f32 tiles S (ld) and Y
// (ldy): chol_sweep, then R·X = I by bwd_sweep, then R = Lᵀ mirrored into
// S's rows so both factors store as rows.  Y must hold I.
template <typename T>
__device__ int sweeps_on(const T* buf, long long ldb, float* S, int ld, float* Y, int ldy, int n) {
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    S[r * ld + c] = widen(buf[min(r, c) * ldb + max(r, c)]);
  }
  __syncthreads();
  const int inf = chol_sweep(S, ld, n);
  bwd_sweep(S, ld, false, Y, ldy, n, n);  // R·X = I, R = Lᵀ
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (c > r) S[r * ld + c] = S[c * ld + r];
  }
  __syncthreads();
  return inf;
}

// ---------------------------------------------------------------------------
// block route
// ---------------------------------------------------------------------------

// the block route's tile: round4(n) rows of tail_ld(n) floats (16-byte rows,
// plus 4 when that makes ld 4 mod 8 and both tiles still fit)
__host__ __device__ __forceinline__ int tail_ld(int n) {
  const int n4 = round4(n), ld = (n4 / 4) % 2 ? n4 : n4 + 4;
  return 2 * sizeof(float) * (size_t)n4 * ld <= SMEM_MAX ? ld : n4;
}

// The window's upper half into S, mirrored (a warp a row of the upper half,
// coalesced, four rows' loads in flight a thread before their stores), zero
// padding up to round4(n) rows and ld columns; returns whether this thread
// read a non-finite entry.
template <typename T>
__device__ bool load_window(float* __restrict__ S, int ld, const T* __restrict__ buf, long long ldb, int n) {
  constexpr int ROWS = 4;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = round4(n), pad = ld - n;
  bool bad = false;
  for (int r0 = wid; r0 < n; r0 += ROWS * WARPS)
    for (int c = r0 / 32 * 32 + lane; c < n; c += 32) {
      float v[ROWS];
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
        const int r = r0 + b * WARPS;
        if (r < n && c >= r) v[b] = widen(buf[r * ldb + c]);
      }
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
        const int r = r0 + b * WARPS;
        if (r >= n || c < r) continue;
        bad |= !isfinite(v[b]);
        S[r * ld + c] = v[b];
        S[c * ld + r] = v[b];
      }
    }
  for (int e = threadIdx.x; e < n * pad; e += NT) S[(e / pad) * ld + n + e % pad] = 0.f;
  for (int e = threadIdx.x; e < (n4 - n) * ld; e += NT) S[n * ld + e] = 0.f;
  return bad;
}

// Y = I on round4(n) rows of ld floats (zero padding), 16 bytes a store
__device__ void identity_tile(float* Y, int ld, int n) {
  const int q = ld / 4;
  for (int e = threadIdx.x; e < round4(n) * q; e += NT) {
    const int r = e / q, c = 4 * (e - r * q);
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = (c + t == r && r < n) ? 1.f : 0.f;
    st4(Y + r * ld + c, v);
  }
}

// R·X = I in place on Y = I (n x round4(n), ldy), R = Lᵀ of a chol_blocked
// tile S (R's rows are the tile's upper rows, its columns L's rows, read
// 16 bytes at a time by the tiles).  Panels of NB rows from the
// bottom: a thread a column solves the diagonal block (j descending, as
// bwd_sweep), then 4 x 4 register tiles take the rows above it, j
// descending — bwd_upper_blocked's operations in its order, restricted to
// the columns c >= k0 that can be nonzero: X is upper triangular, and the
// sweep adds only ±0 into a column c < k0 of the panel's rows and from them.
__device__ void bwd_inverse_blocked(const float* S, int ld, int n, float* Y, int ldy) {
  const int n4 = round4(n);
  for (int k0 = (n - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int w = min(NB, n - k0);
    for (int c = k0 + threadIdx.x; c < n; c += NT) {
      if (w == NB) bwd_diag_column<true>(S, ld, k0, w, Y + c, ldy);
      else bwd_diag_column<false>(S, ld, k0, w, Y + c, ldy);
    }
    __syncthreads();
    if (k0 == 0) break;
    const int cg4 = (n4 - k0) / 4;
    for (int e = threadIdx.x; e < k0 / 4 * cg4; e += NT) {
      const int i0 = 4 * (e / cg4), c0 = k0 + 4 * (e % cg4);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack4(acc[i], ld4(Y + (i0 + i) * ldy + c0));
      for (int j = w - 1; j >= 0; --j) {
        float y[4], u[4];
        unpack4(y, ld4(Y + (k0 + j) * ldy + c0));
        unpack4(u, ld4(S + (k0 + j) * ld + i0));  // R[i0 + i][k0 + j] = L[k0 + j][i0 + i]
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

// One window a block: the window's upper half loaded mirrored and scanned,
// chol_blocked, the blocked inverse; on a fault (or `sweep`) the column
// sweeps on the window read again.  S holds L and R = Lᵀ, Y holds R⁻¹.
template <typename T>
__global__ void __launch_bounds__(NT) tail_block_kernel(const T* buf, long long ldb, T* rp, T* rip, long long ldr,
                                                        int* info, int n, int sweep) {
  extern __shared__ float4 smem4[];
  const int ld = tail_ld(n);
  float* S = reinterpret_cast<float*>(smem4);
  float* Y = S + round4(n) * ld;
  identity_tile(Y, ld, n);
  const bool finite = !__syncthreads_or(load_window(S, ld, buf, ldb, n));
  int inf = finite && !sweep ? chol_blocked(S, ld, n) : -1;
  if (inf == 0) bwd_inverse_blocked(S, ld, n, Y, ld);
  else inf = sweeps_on(buf, ldb, S, ld, Y, ld, n);
  store_upper(rp, ldr, S, ld, n);
  store_upper(rip, ldr, Y, ld, n);
  if (threadIdx.x == 0) *info = inf;
}

// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

// the square's leading dimension (n a multiple of 16): 16-byte rows, 4 mod 8
__host__ __device__ __forceinline__ int square_ld(int n) { return (n / 4) % 2 ? n : n + 4; }

// One block's shared memory (floats): its n / C rows of the square, the
// panel (16 x n: the factor's panel column k-major, then the owner's 16
// finished rows of the back-substitution), R⁻¹'s diagonal on its rows,
// L11ᵀ and the pivots' roots copied from the owner, its own roots, a flag.
__host__ __device__ __forceinline__ int cluster_floats(int n, int C) {
  return n / C * square_ld(n) + PANEL * n + n / C + PANEL * PANEL + PANEL + PANEL + 4;
}

// global row of local row lr of block `rank` (16-row panels round-robin)
__device__ __forceinline__ int grow(int lr, int rank, int C) { return ((lr >> 4) * C + rank) * PANEL + (lr & 15); }

// This block's rows g of the symmetrised window, S[g][m] = A[m][g] for
// m <= g (the upper half down a column, 16 consecutive g a half-warp, four
// loads in flight a thread before their stores); returns whether this
// thread read a non-finite entry.  The strict upper triangle is left as it
// is: the factor never reads it.
template <typename T>
__device__ bool load_square_rows(float* __restrict__ Sq, int ld, const T* __restrict__ buf, long long ldb, int n,
                                 int rank, int C) {
  constexpr int LOADS = 4;
  const int slots = n / C * n;  // (local panel, m, i), i fastest
  bool bad = false;
  for (int e0 = threadIdx.x; e0 < slots; e0 += LOADS * NT) {
    float v[LOADS];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int e = e0 + b * NT, i = e & 15, m = (e >> 4) % n, g = ((e >> 4) / n * C + rank) * PANEL + i;
      if (e < slots && m <= g) v[b] = widen(buf[m * ldb + g]);
    }
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int e = e0 + b * NT, i = e & 15, m = (e >> 4) % n, lp = (e >> 4) / n, g = (lp * C + rank) * PANEL + i;
      if (e >= slots || m > g) continue;
      bad |= !isfinite(v[b]);
      Sq[(lp * PANEL + i) * ld + m] = v[b];
    }
  }
  return bad;
}

// Panel step 2 of chol_blocked for local row `row` (global row g): scaled
// and updated column by column against L11 (D: L11ᵀ row-major, then the
// roots), written back and pushed into every block's panel PT[c·n + g].
__device__ __forceinline__ bool cluster_panel_row(cg::cluster_group& cluster, float* row, const float* D, float* PT,
                                                  int n, int g, int C) {
  float x[PANEL];
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) unpack4(x + 4 * q, ld4(row + 4 * q));
#pragma unroll
  for (int c = 0; c < PANEL; ++c) {
    x[c] = x[c] / D[PANEL * PANEL + c];
#pragma unroll
    for (int q = (c + 1) / 4; q < PANEL / 4; ++q) {
      float v[4];
      unpack4(v, ld4(D + c * PANEL + 4 * q));
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t > c) x[4 * q + t] = fmaf(-x[c], v[t], x[4 * q + t]);
    }
  }
  bool bad = false;
#pragma unroll
  for (int c = 0; c < PANEL; ++c) bad |= !isfinite(x[c]);
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) st4(row + 4 * q, x + 4 * q);
  for (int r = 0; r < C; ++r) {
    float* pt = cluster.map_shared_rank(PT, r);
#pragma unroll
    for (int c = 0; c < PANEL; ++c) pt[c * n + g] = x[c];
  }
  return bad;
}

// Panel step 3 on this block's rows: S[l][m] −= Σ_c L[l][k0+c]·L[m][k0+c],
// c ascending, over l >= m >= k0 + 16 in 4 x 4 tiles, the panel read from
// PT (k-major, global rows).
__device__ void cluster_trailing(float* Sq, int ld, const float* PT, int n, int k0, int rank, int C) {
  const int t0 = k0 + PANEL, nct = (n - t0) / 4, quads = n / C / 4;
  for (int e = threadIdx.x; e < quads * nct; e += NT) {
    const int q = e / nct, lr = 4 * q, l0 = grow(lr, rank, C), m0 = t0 + 4 * (e - q * nct);
    if (l0 < t0 || m0 > l0) continue;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) unpack4(acc[r], ld4(Sq + (lr + r) * ld + m0));
#pragma unroll 4
    for (int c = 0; c < PANEL; ++c) {
      float a[4], b[4];
      unpack4(a, ld4(PT + c * n + l0));
      unpack4(b, ld4(PT + c * n + m0));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][t] = fmaf(-a[r], b[t], acc[r][t]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) st4(Sq + (lr + r) * ld + m0, acc[r]);
  }
}

// The owner's diagonal solve of panel k0 (rows: its 16 rows of the square,
// yd: their entries of R⁻¹'s diagonal), a thread a column c >= k0: y = the
// column's R⁻¹ entries (strict upper from the square, the diagonal from yd,
// zero below), j descending as bwd_sweep, R[k0+i][k0+j] = L[k0+j][k0+i].
__device__ void cluster_diag_solve(float* rows, int ld, float* yd, int n, int k0) {
  for (int c = k0 + threadIdx.x; c < n; c += NT) {
    float y[PANEL];
#pragma unroll
    for (int i = 0; i < PANEL; ++i) y[i] = k0 + i < c ? rows[i * ld + c] : (k0 + i == c ? yd[i] : 0.f);
#pragma unroll
    for (int j = PANEL - 1; j >= 0; --j) {
      y[j] = y[j] / safe_div(rows[j * ld + k0 + j]);
#pragma unroll
      for (int i = 0; i < j; ++i) y[i] = fmaf(-rows[j * ld + k0 + i], y[j], y[i]);
    }
#pragma unroll
    for (int i = 0; i < PANEL; ++i) {
      if (k0 + i < c) rows[i * ld + c] = y[i];
      else if (k0 + i == c) yd[i] = y[i];
    }
  }
}

// Rows r < k0 of this block take the finished panel k0 (Pb: the owner's 16
// rows, L left of k0, R⁻¹ from k0 with zeros below its diagonal):
// X[r][c] −= Σ_j R[r][k0+j]·X[k0+j][c], j descending, for c >= k0.
__device__ void cluster_bwd_update(float* Sq, int ld, const float* Pb, int n, int k0, int rank, int C) {
  const int ncg = (n - k0) / 4, quads = n / C / 4;
  for (int e = threadIdx.x; e < quads * ncg; e += NT) {
    const int q = e / ncg, lr = 4 * q, r0 = grow(lr, rank, C), c0 = k0 + 4 * (e - q * ncg);
    if (r0 >= k0) continue;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) unpack4(acc[i], ld4(Sq + (lr + i) * ld + c0));
#pragma unroll 4
    for (int j = PANEL - 1; j >= 0; --j) {
      float u[4], y[4];
      unpack4(u, ld4(Pb + j * n + r0));
      unpack4(y, ld4(Pb + j * n + c0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(-u[i], y[t], acc[i][t]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) st4(Sq + (lr + i) * ld + c0, acc[i]);
  }
}

// The owner's 16 finished rows of panel k0 (o: its square's rows, oy:
// their entries of R⁻¹'s diagonal) into Pb (16 x n): L left of k0, R⁻¹
// from k0 with zeros below its diagonal.  16-byte loads across the
// cluster, four in flight a thread before their stores.
__device__ void copy_finished_panel(const float* o, const float* oy, int ld, float* __restrict__ Pb, int n, int k0) {
  constexpr int LOADS = 4;
  const int q4 = n / 4, total = PANEL * q4;
  for (int e0 = threadIdx.x; e0 < total; e0 += LOADS * NT) {
    float v[LOADS][4];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int e = e0 + b * NT, j = e / q4, c = 4 * (e - j * q4);
      if (e < total) unpack4(v[b], ld4(o + j * ld + c));
    }
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int e = e0 + b * NT, j = e / q4, c = 4 * (e - j * q4);
      if (e >= total) continue;
      if (c >= k0 && c < k0 + PANEL) {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[b][t] = c + t < k0 + j ? 0.f : (c + t == k0 + j ? oy[j] : v[b][t]);
      }
      st4(Pb + j * n + c, v[b]);
    }
  }
}

// One window a cluster of C blocks (gridDim.x = C, one cluster).
template <typename T>
__global__ void __launch_bounds__(NT) tail_cluster_kernel(const T* buf, long long ldb, T* rp, T* rip, long long ldr,
                                                          int* info, float* scratch, int n, int sweep) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)gridDim.x, rank = (int)cluster.block_rank();  // one cluster
  const int RL = n / C, ld = square_ld(n), tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  float* Sq = reinterpret_cast<float*>(smem4);  // this block's rows of the square
  float* PT = Sq + RL * ld;                     // the panel
  float* yd = PT + PANEL * n;                   // R⁻¹'s diagonal on this block's rows
  float* D = yd + RL;                           // L11ᵀ, then the roots, from the owner
  float* sq = D + PANEL * PANEL + PANEL;        // this block's roots when it owns the panel
  int* flag = reinterpret_cast<int*>(sq + PANEL);

  bool bad = false;
  if (!sweep) {
    bad = load_square_rows(Sq, ld, buf, ldb, n, rank, C);
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += PANEL) {
      const int p = k0 / PANEL, owner = p % C, lr0 = p / C * PANEL;
      if (rank == owner && tid < 32) bad |= chol_diag_block(Sq + lr0 * ld + k0, ld, PANEL, sq);
      if (k0 + PANEL >= n) break;
      cluster.sync();  // the owner's L11 and roots are out
      {
        const float* o = cluster.map_shared_rank(Sq, owner) + lr0 * ld + k0;
        D[tid] = o[(tid / PANEL) * ld + tid % PANEL];  // NT = 256 = 16 x 16
        if (tid < PANEL) D[PANEL * PANEL + tid] = cluster.map_shared_rank(sq, owner)[tid];
      }
      __syncthreads();
      if (tid < RL) {
        const int g = grow(tid, rank, C);
        if (g >= k0 + PANEL) bad |= cluster_panel_row(cluster, Sq + tid * ld + k0, D, PT, n, g, C);
      }
      cluster.sync();  // every block's panel rows are in every PT
      cluster_trailing(Sq, ld, PT, n, k0, rank, C);
      __syncthreads();
    }
  }
  const int mine = __syncthreads_or(bad);
  if (tid == 0) *flag = mine;
  cluster.sync();
  const bool blocked = !sweep && !__syncthreads_or(tid < C && *cluster.map_shared_rank(flag, tid));

  if (blocked) {
    // R⁻¹ starts as I: zero the strict upper triangle of this block's rows
    for (int e = tid; e < RL * n; e += NT) {
      const int lr = e / n, c = e - lr * n;
      if (c > grow(lr, rank, C)) Sq[lr * ld + c] = 0.f;
    }
    for (int lr = tid; lr < RL; lr += NT) yd[lr] = 1.f;
    __syncthreads();
    for (int k0 = n - PANEL; k0 >= 0; k0 -= PANEL) {
      const int p = k0 / PANEL, owner = p % C, lr0 = p / C * PANEL;
      if (rank == owner) cluster_diag_solve(Sq + lr0 * ld, ld, yd + lr0, n, k0);
      cluster.sync();  // the owner's rows of panel p are final
      if (k0 == 0) break;
      copy_finished_panel(cluster.map_shared_rank(Sq, owner) + lr0 * ld, cluster.map_shared_rank(yd, owner) + lr0,
                          ld, PT, n, k0);
      __syncthreads();
      cluster_bwd_update(Sq, ld, PT, n, k0, rank, C);
      __syncthreads();
    }
    // R⁻¹'s rows of this block, and R's columns (L's rows) of this block
    const int wid = tid / 32, lane = tid % 32;
    for (int lr = wid; lr < RL; lr += WARPS) {
      const int g = grow(lr, rank, C);
      T* dst = rip + g * ldr;
      for (int c = lane; c < n; c += 32) dst[c] = Cast<T>::from(c > g ? Sq[lr * ld + c] : (c == g ? yd[lr] : 0.f));
    }
    for (int e = tid; e < RL * n; e += NT) {
      const int i = e & 15, r = (e >> 4) % n, lp = (e >> 4) / n, g = (lp * C + rank) * PANEL + i;
      rp[r * ldr + g] = Cast<T>::from(r <= g ? Sq[(lp * PANEL + i) * ld + r] : 0.f);
    }
    if (rank == 0 && tid == 0) *info = 0;
  }
  cluster.sync();  // no block reads another's shared memory past here
  if (!blocked && rank == 0) {
    float* S = scratch;
    float* Y = scratch + (size_t)n * n;
    for (int e = tid; e < n * n; e += NT) {
      const int r = e / n, c = e - r * n;
      Y[e] = r == c ? 1.f : 0.f;
    }
    const int inf = sweeps_on(buf, ldb, S, n, Y, n, n);
    store_upper(rp, ldr, S, n, n);
    store_upper(rip, ldr, Y, n, n);
    if (tid == 0) *info = inf;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
static int launch_block(const void* buf, long long ldb, void* rp, void* rip, long long ldr, void* info, int n,
                        int sweep, void* stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)round4(n) * tail_ld(n);
  if (smem > SMEM_MAX || n > NB + NT) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(tail_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  tail_block_kernel<T><<<1, NT, smem, (cudaStream_t)stream>>>((const T*)buf, ldb, (T*)rp, (T*)rip, ldr, (int*)info,
                                                               n, sweep);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cluster(const void* buf, long long ldb, void* rp, void* rip, long long ldr, void* info,
                          void* scratch, int n, int C, int sweep, void* stream) {
  if ((C != 2 && C != 4 && C != 8) || n % (PANEL * C) || n / C > NT || scratch == nullptr) return -1;
  const size_t smem = sizeof(float) * (size_t)cluster_floats(n, C);
  if (smem > SMEM_MAX) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(tail_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, tail_cluster_kernel<T>, (const T*)buf, ldb, (T*)rp, (T*)rip, ldr,
                                            (int*)info, (float*)scratch, n, sweep);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  buf, rp and rip point at the windows' first
// element; rp and rip share the leading dimension ldr.  blocks = 1 takes
// the block route, 2 / 4 / 8 the cluster route on that many blocks, which
// needs `scratch`: 2·n·n f32 of device memory for the fault path.
extern "C" int capital_fused_tail(int dtype, const void* buf, long long ldb, void* rp, void* rip, long long ldr,
                                  void* info, void* scratch, int n, int blocks, int sweep, void* stream) {
  if (n < 1) return -1;
  if (blocks == 1) {
    if (dtype == DT_F32) return launch_block<float>(buf, ldb, rp, rip, ldr, info, n, sweep, stream);
    if (dtype == DT_BF16) return launch_block<bf16>(buf, ldb, rp, rip, ldr, info, n, sweep, stream);
    return -1;
  }
  if (dtype == DT_F32) return launch_cluster<float>(buf, ldb, rp, rip, ldr, info, scratch, n, blocks, sweep, stream);
  if (dtype == DT_BF16) return launch_cluster<bf16>(buf, ldb, rp, rip, ldr, info, scratch, n, blocks, sweep, stream);
  return -1;
}
