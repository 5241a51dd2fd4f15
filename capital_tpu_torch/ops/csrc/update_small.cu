// Rank-k Cholesky update / downdate: the rotation sweep over a batch of
// independent problems, a warp per problem, several problems a block.
//
// Replaces capital_tpu/ops/update_small.py:158 (_pallas_sweep, launched
// through the one pallas_call of capital_tpu/ops/batched_small.py:358).  As
// there, the batch is the grid and problems share nothing: a NaN in one
// problem reaches only its own factor and info.
//
// The reference's step (q, j) — rank q, column j, σ = +1 update, −1
// downdate — is
//
//   t = v_j / safe(R_jj),  c² = 1 + σ·t·t,
//   good = R_jj finite and > 0 and c² finite and > 0,  c⁻¹ = 1/sqrt(good ? c² : 1)
//   R_jc ← R_jc + ((R_jc + σt·v_c)·c⁻¹·[c >= j] − R_jc),  v_c ← (v_c − t·R_jc)·c⁻¹
//
// in rank-major order (for q, for j), info = j + 1 at the first bad step
// in that order.  Step (q, j) writes row j and v_q only; it reads row j
// after ranks 0..q−1 and v_q after steps 0..j−1 of rank q.  Any order that
// keeps those two dependencies applies the same IEEE operations to the
// same values, and so does the row-streamed order this kernel runs: ranks
// in passes of at most KC, each pass a walk over the rows in order that
// applies the pass's ranks to a row before it moves on.  R is read once
// and written once a pass; a problem's only state is its V.  Columns c < j
// of row j are zero on output and v_c is dead after step c, so a row's
// dead columns are skipped (half the column work).
//
// The fast path, a warp per problem: lane l keeps columns l, l + 32, ...
// (NS = ceil(n/32) slots) of the current row in registers and the same
// entries of each v_q of the pass.  Row j's pivot R_jj and v_q[j] reach
// every lane by one shuffle each at the row's start; each lane then runs
// the scalar chain itself (the same __fdiv_rn / __fsqrt_rn / __fmul_rn /
// __fadd_rn sequence, so every lane holds the same bits) and carries the
// pivot through the pass's ranks with the owner's update of it, so no
// barrier and no shuffle stands between two steps.  The next row's loads
// are in flight while a row is swept.  Between passes R stays f32: in
// `out` for f32 storage, in an f32 scratch (`work`) for bf16.  bf16 is
// widened on load and rounded once, on the last pass's store.
//
// Faults.  The reference reads row j and V through one-hot contractions,
// so a non-finite value spreads (a NaN in column c elsewhere poisons the
// extracted entry, a non-finite delta turns its whole column NaN, the
// final n + 1 test reads the whole tile), and the row-streamed order is
// wrong once anything non-finite is read or made.  So the fast path
// checks every entry of R it loads (all n² on the first pass, the lower
// triangle too), every entry of V, every t and c², and every live entry a
// row stores (a non-finite v entry shows in t at its own pivot step; a
// non-finite intermediate of a row stays non-finite to the row's store):
// x·0 + acc is NaN exactly when x is not finite.  A problem that fails a
// check is swept again, in the same launch, from its untouched inputs by
// the resident algorithm below, whose results and info are the
// reference's; a problem that passes has info = the first bad step in
// rank-major order, min(q·n + j) % n + 1 over the steps whose pivot or c²
// was not positive (a finite bad step: t's divisor guarded, c⁻¹ = 1).
//
// The resident algorithm (the kernel this one replaced): the whole block
// on one problem, R in an f32 tile in shared memory (leading dimension
// n + 1), V streamed one column per rank, thread 0 computing t, c² and
// c⁻¹ between two barriers a step, and a non-finite count per tile column
// and per row of V that gives the one-hot contractions' NaN spread
// without the contractions.  A block's flagged problems take the tile in
// turn after every warp of the block has finished its fast path.
//
// What bounds it.  Bytes: R read and R' written (4n² a problem at f32, a
// pass), V read once — 0.331 ms at 8192 × 128 × 8 f32 on the H100.  The
// fast path is issue-bound instead: a step is ~45 warp instructions of
// scalar chain (two IEEE divisions and a square root) plus ~8 per live
// column slot (0.880 ms there, 2.7× the bound), and a problem's n·k steps
// are one dependent chain of ≈ 250 cycles each, so a small batch waits on
// that chain (8 problems at k = 8: 0.155 ms on this route).
//
// Two routes, picked by the wrapper's rule (update_small.sweep_route):
//   row   a warp a problem, up to MAX_WARPS problems a block, as above:
//         the throughput route (the SMs' issue rate bounds it);
//   wave  a block a problem and a warp a rank: row j goes from the warp of
//         rank q to the warp of rank q + 1 through a ring in shared
//         memory, so a pass of Q ranks is a chain of about n + Q rows
//         instead of n·Q steps — the latency route for small batches
//         (8 problems at k = 8: 0.045 ms).
// Both apply the same operations to the same values (each warp of the
// wave route runs the row route's step on one rank), both check the same
// values, and both send a problem that fails a check to the resident
// algorithm in the same launch.
//
// Shared memory per block, as capital_tpu_torch/ops/update_small.smem_bytes
// computes it: the fault path's tile, v and two count vectors, 4·(n·(n +
// 1) + 3n) bytes; on the wave route, where larger (n <= 117 and 129..132),
// its rings (7 links x RING groups of HOP rows of 32·NS floats) and their
// flags, which lie over the tile; dynamic.  Static: a flag a warp, the block's least bad
// step.  The fast paths use no other shared memory.  Registers hold
// n <= 32·NS_MAX = 256; the wrapper's envelope (n <= 238) is the tile's.

#include <climits>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;  // problems a block, at most
constexpr int KC = 8;         // ranks a pass applies to a row, at most
constexpr int NS_MAX = 8;     // column slots a lane: n <= 256
constexpr int RING = 4;       // row groups in flight between two rank warps (wave route)
constexpr int HOP = 4;        // rows a group: rows handed from warp to warp at once (divides 32)
enum Route : int { ROUTE_ROW = 0, ROUTE_WAVE = 1 };
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448 - 1024;

__device__ __forceinline__ int nonfinite(float x) { return isfinite(x) ? 0 : 1; }

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// NaN exactly when x is not finite (x·0 is 0 for finite x); never
// contracted or folded away (no fast-math)
__device__ __forceinline__ float check(float x, float acc) { return __fmaf_rn(x, 0.f, acc); }

// Spin until a ring flag reaches `want` (the flags only grow within a
// pass); a protocol fault traps after 2^28 polls instead of hanging the
// card.
__device__ __forceinline__ void wait_at_least(volatile int* flag, int want) {
  for (unsigned polls = 0; *flag < want; ++polls)
    if (polls > (1u << 28)) __trap();
}

// Row r of the working factor into this lane's slots: columns >= lo
// (0 on the first pass, whose loads also scan the lower triangle; r on the
// later ones), zero elsewhere and for r >= n; from R (storage type) on the
// first pass, from the f32 working copy after.
template <int NS, typename T>
__device__ __forceinline__ void load_row(float (&dst)[NS], const T* Rb, const float* wb, int n, int r, bool first,
                                         int lane) {
  if (first) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 32 * i + lane;
      dst[i] = (c < n && r < n) ? widen(Rb[r * n + c]) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 32 * i + lane;
      dst[i] = (c < n && c >= r && r < n) ? wb[r * n + c] : 0.f;
    }
  }
}

// One pass of the fast path: ranks q0 .. q0 + Q − 1 applied row by row.
// Rows come from R (first) or the f32 working copy wb, and go to `ob`
// whole, rounded to T, with zeros below the diagonal (last), or to wb,
// live columns only.  Returns false when a check failed (the problem then
// takes the resident path); `best` keeps the least q·n + j of a bad step.
template <int NS, int Q, typename T>
__device__ __forceinline__ bool pass(const T* Rb, float* wb, T* ob, const T* Vb, int n, int k, int q0, bool first,
                                     bool last, float sign, int& best, int lane) {
  float chk = 0.f;
  float v[Q > 0 ? Q : 1][NS];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 32 * i + lane;
      v[q][i] = c < n ? widen(Vb[(long long)c * k + q0 + q]) : 0.f;
      chk = check(v[q][i], chk);
    }
  float nxt[NS];
  load_row<NS>(nxt, Rb, wb, n, 0, first, lane);
#pragma unroll
  for (int jb = 0; jb < NS; ++jb) {
    const int rows = min(32, n - 32 * jb);
    for (int jl = 0; jl < rows; ++jl) {
      const int j = 32 * jb + jl;
      float row[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        row[i] = nxt[i];
        chk = check(row[i], chk);
      }
      if (j + 1 < n) load_row<NS>(nxt, Rb, wb, n, j + 1, first, lane);
      float d = __shfl_sync(FULL, row[jb], jl);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        // v_q[j] is the row's start value until step q changes it
        const float vj = __shfl_sync(FULL, v[q][jb], jl);
        // d and c² finite here, or a check below fails: the reference's
        // isfinite terms change nothing the fast path keeps
        const float t = __fdiv_rn(vj, d != 0.f ? d : 1.f);
        const float st = __fmul_rn(sign, t);
        const float c2 = __fadd_rn(1.f, __fmul_rn(st, t));
        const bool good = d > 0.f && c2 > 0.f;
        if (!good) best = min(best, (q0 + q) * n + j);
        const float cinv = __fdiv_rn(1.f, __fsqrt_rn(good ? c2 : 1.f));
        chk = check(c2, check(t, chk));
#pragma unroll
        for (int i = jb; i < NS; ++i) {
          const float rr = row[i], vc = v[q][i];
          const bool live = i > jb || lane >= jl;
          const float nr = live ? __fmul_rn(__fadd_rn(rr, __fmul_rn(st, vc)), cinv) : 0.f;
          v[q][i] = __fmul_rn(__fsub_rn(vc, __fmul_rn(t, rr)), cinv);
          row[i] = __fadd_rn(rr, __fsub_rn(nr, rr));
        }
        // the pivot after this rank, as its owner lane computes it
        d = __fadd_rn(d, __fsub_rn(__fmul_rn(__fadd_rn(d, __fmul_rn(st, vj)), cinv), d));
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 32 * i + lane;
        if (c >= n) continue;
        const bool live = i > jb || (i == jb && lane >= jl);
        if (live) chk = check(row[i], chk);
        if (last) ob[j * n + c] = Cast<T>::from(live ? row[i] : 0.f);
        else if (live) wb[j * n + c] = row[i];
      }
      if (__any_sync(FULL, chk != chk)) return false;
    }
  }
  return true;
}

// The fast path for one problem: passes of KC ranks, then the remainder's
// 4, 2 and 1 (k = 0: one pass that only copies and checks).  False when a
// check failed.
template <int NS, typename T>
__device__ __forceinline__ bool stream_problem(const T* Rb, float* wb, T* ob, const T* Vb, int n, int k, float sign,
                                               int& best, int lane) {
  if (k == 0) return pass<NS, 0>(Rb, wb, ob, Vb, n, k, 0, true, true, sign, best, lane);
  bool ok = true;
  int q0 = 0;
  for (; ok && k - q0 >= KC; q0 += KC) ok = pass<NS, KC>(Rb, wb, ob, Vb, n, k, q0, q0 == 0, q0 + KC == k, sign, best, lane);
  if (ok && (k - q0) & 4) {
    ok = pass<NS, 4>(Rb, wb, ob, Vb, n, k, q0, q0 == 0, q0 + 4 == k, sign, best, lane);
    q0 += 4;
  }
  if (ok && (k - q0) & 2) {
    ok = pass<NS, 2>(Rb, wb, ob, Vb, n, k, q0, q0 == 0, q0 + 2 == k, sign, best, lane);
    q0 += 2;
  }
  if (ok && (k - q0) & 1) ok = pass<NS, 1>(Rb, wb, ob, Vb, n, k, q0, q0 == 0, true, sign, best, lane);
  return ok;
}

// The resident algorithm on one problem, by the whole block (every thread
// calls it): the kernel this one replaced, column for column.  Writes the
// problem's R' (upper, zeros below) and info.
template <typename T>
__device__ __noinline__ void resident(float* smem, const T* Rb, const T* Vb, T* ob, int* info_b, int n, int k,
                                      float sign) {
  const int ld = n + 1, tid = threadIdx.x, nt = blockDim.x;
  float* tile = smem;                // n x ld, the working factor
  float* v = tile + (size_t)n * ld;  // the rotated column of V
  int* colcnt = (int*)(v + n);       // non-finite entries per tile column
  int* vrow = colcnt + n;            // non-finite entries per row of V
  __shared__ float s_t, s_st, s_cinv;
  __syncthreads();  // the tile's last user is done
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    tile[r * ld + c] = widen(Rb[e]);
  }
  __syncthreads();
  for (int c = tid; c < n; c += nt) {
    int cnt = 0;
    for (int r = 0; r < n; ++r) cnt += nonfinite(tile[r * ld + c]);
    colcnt[c] = cnt;
    int vc = 0;
    for (int q = 0; q < k; ++q) vc += nonfinite(widen(Vb[(long long)c * k + q]));
    vrow[c] = vc;
  }
  int info = 0;  // thread 0's is the problem's
  for (int q = 0; q < k; ++q) {
    __syncthreads();  // the counts (q = 0) or the last step of rank q − 1 have landed
    for (int i = tid; i < n; i += nt) {
      const float x = widen(Vb[(long long)i * k + q]);
      v[i] = (vrow[i] - nonfinite(x) > 0) ? qnan() : x;
    }
    for (int j = 0; j < n; ++j) {
      __syncthreads();  // v and row j are current
      if (tid == 0) {
        const float x = tile[j * ld + j];
        const float d = (colcnt[j] - nonfinite(x) > 0) ? qnan() : x;
        const float vj = v[j];
        const float t = __fdiv_rn(vj, (d != 0.f && isfinite(d)) ? d : 1.f);
        const float st = __fmul_rn(sign, t);
        const float c2 = __fadd_rn(1.f, __fmul_rn(st, t));
        const bool good = isfinite(d) && d > 0.f && isfinite(c2) && c2 > 0.f;
        if (info == 0 && !good) info = j + 1;
        s_t = t;
        s_st = st;
        s_cinv = __fdiv_rn(1.f, __fsqrt_rn(good ? c2 : 1.f));
      }
      __syncthreads();
      const float t = s_t, st = s_st, cinv = s_cinv;
      for (int c = tid; c < n; c += nt) {
        const float x = tile[j * ld + c];
        const int nfx = nonfinite(x);
        const float rr = (colcnt[c] - nfx > 0) ? qnan() : x;
        const float vc = v[c];
        const float nr = (c >= j) ? __fmul_rn(__fadd_rn(rr, __fmul_rn(st, vc)), cinv) : 0.f;
        v[c] = __fmul_rn(__fsub_rn(vc, __fmul_rn(t, rr)), cinv);
        const float delta = __fsub_rn(nr, rr);
        const float y = __fadd_rn(x, delta);
        tile[j * ld + c] = y;
        if (isfinite(delta)) {
          colcnt[c] += nonfinite(y) - nfx;
        } else {  // the write-back's 0·delta is NaN down the column
          for (int r = 0; r < n; ++r)
            if (r != j) tile[r * ld + c] = qnan();
          colcnt[c] = (n - 1) + nonfinite(y);
        }
      }
    }
  }
  __syncthreads();
  bool bad = false;
  for (int c = tid; c < n; c += nt) bad |= colcnt[c] > 0;
  const int any_bad = __syncthreads_or(bad);
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    ob[e] = Cast<T>::from(r <= c ? tile[r * ld + c] : 0.f);
  }
  if (tid == 0) *info_b = (info == 0 && any_bad) ? n + 1 : info;
}

// blockDim.x / 32 problems a block, warp w on problem blockIdx.x·warps + w;
// then the block sweeps its flagged problems, one at a time, on the tile.
template <int NS, typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS) sweep_kernel(const T* R, const T* V, T* out, float* work,
                                                               int* info, int batch, int n, int k, float sign) {
  extern __shared__ float smem[];
  __shared__ int s_flag[MAX_WARPS];
  const int warps = blockDim.x / 32, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * warps;
  const long long b = first + w;
  bool flagged = false;
  if (b < batch) {
    const long long off = b * n * n;
    float* wb;
    if constexpr (sizeof(T) == sizeof(float)) wb = reinterpret_cast<float*>(out) + off;
    else wb = work ? work + off : nullptr;  // null: one pass, no working copy
    int best = INT_MAX;
    flagged = !stream_problem<NS>(R + off, wb, out + off, V + b * n * k, n, k, sign, best, lane);
    if (!flagged && lane == 0) info[b] = best == INT_MAX ? 0 : best % n + 1;
  }
  if (lane == 0) s_flag[w] = flagged;
  __syncthreads();
  for (int p = 0; p < warps; ++p)
    if (s_flag[p]) {
      const long long pb = first + p;
      resident(smem, R + pb * n * n, V + pb * n * k, out + pb * n * n, info + pb, n, k, sign);
    }
}

// Row group g (HOP rows) from its slot (g % RING) of a ring link into
// this lane's slots, once the producing warp has published it; then the
// slot is free for group g + RING.
template <int NS>
__device__ __forceinline__ void receive(float (&dst)[HOP][NS], const float* ring, volatile int* full,
                                        volatile int* freed, int g, int lane) {
  const int s = g % RING;
  wait_at_least(full + s, g + 1);
  __threadfence_block();
#pragma unroll
  for (int h = 0; h < HOP; ++h)
#pragma unroll
    for (int i = 0; i < NS; ++i) dst[h][i] = ring[(s * HOP + h) * 32 * NS + 32 * i + lane];
  __threadfence_block();
  __syncwarp();
  if (lane == 0) freed[s] = g + 1;
}

// Wave route: one problem a block, warp w on rank q0 + w of a pass of
// Q = min(KC, k − q0) ranks.  Rows go from warp w to warp w + 1 in groups
// of HOP through a ring of RING groups in shared memory (a flag a slot for
// "group g is here", one for "group g was read"); warp 0 reads R, warp
// Q − 1 writes it.  Each warp runs the row route's step on its rank, so a
// row leaves warp w as the row route leaves it after rank q0 + w, and a
// pass takes about n + HOP·Q rows of one warp where the row route takes
// n·Q steps.  A warp's row costs more than a row-route step: its next step
// waits on this step's update of v, and the hand-off (≈ 200 cycles: flag
// polls, fences, shared loads) sits on the chain, once a group.  A tail
// group shorter than HOP is padded with zero rows (t = 0, c⁻¹ = 1: v and
// every real row untouched), so the group's steps have no run-time bound.
// A warp runs its pass to the end whatever its checks say (a warp that
// stopped would leave the next one waiting); the block votes after the
// last pass.
template <int NS, typename T>
__device__ __forceinline__ void wave_pass(const T* Rb, float* wb, T* ob, const T* Vb, int n, int k, int q0, int Q,
                                          bool first, bool last, float sign, int& best, float& chk, float* buf,
                                          volatile int* full, volatile int* freed, int w, int lane) {
  constexpr int SLOT = HOP * 32 * NS;
  const int q = q0 + w;
  const bool head = w == 0, tail = w == Q - 1;
  float v[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = 32 * i + lane;
    v[i] = c < n ? widen(Vb[(long long)c * k + q]) : 0.f;
    chk = check(v[i], chk);
  }
  float* in = buf + (size_t)(w - 1) * RING * SLOT;  // link w − 1 (unused by the head)
  float* out = buf + (size_t)w * RING * SLOT;       // link w (unused by the tail)
  volatile int* in_full = full + (w - 1) * RING;
  volatile int* in_freed = freed + (w - 1) * RING;
  volatile int* out_full = full + w * RING;
  volatile int* out_freed = freed + w * RING;
  float nxt[HOP][NS];
  if (head) {
#pragma unroll
    for (int h = 0; h < HOP; ++h) load_row<NS>(nxt[h], Rb, wb, n, h, first, lane);
  }
#pragma unroll
  for (int jb = 0; jb < NS; ++jb) {
    const int rows = min(32, n - 32 * jb);
    for (int jl = 0; jl < rows; jl += HOP) {
      const int j = 32 * jb + jl, g = j / HOP, s = g % RING;
      float row[HOP][NS];
      if (head) {
#pragma unroll
        for (int h = 0; h < HOP; ++h)
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            row[h][i] = nxt[h][i];
            chk = check(row[h][i], chk);
          }
#pragma unroll
        for (int h = 0; h < HOP; ++h) load_row<NS>(nxt[h], Rb, wb, n, j + HOP + h, first, lane);
      } else {
        receive<NS>(row, in, in_full, in_freed, g, lane);
      }
#pragma unroll
      for (int h = 0; h < HOP; ++h) {
        const int jh = jl + h;  // a zero pad row past the block's rows
        const float d = __shfl_sync(FULL, row[h][jb], jh);
        const float vj = __shfl_sync(FULL, v[jb], jh);
        const float t = __fdiv_rn(vj, d != 0.f ? d : 1.f);
        const float st = __fmul_rn(sign, t);
        const float c2 = __fadd_rn(1.f, __fmul_rn(st, t));
        const bool good = d > 0.f && c2 > 0.f;
        if (!good && jh < rows) best = min(best, q * n + j + h);
        const float cinv = __fdiv_rn(1.f, __fsqrt_rn(good ? c2 : 1.f));
        chk = check(c2, check(t, chk));
#pragma unroll
        for (int i = jb; i < NS; ++i) {
          const float rr = row[h][i], vc = v[i];
          const bool live = i > jb || lane >= jh;
          const float nr = live ? __fmul_rn(__fadd_rn(rr, __fmul_rn(st, vc)), cinv) : 0.f;
          v[i] = __fmul_rn(__fsub_rn(vc, __fmul_rn(t, rr)), cinv);
          row[h][i] = __fadd_rn(rr, __fsub_rn(nr, rr));
        }
      }
      if (!tail) {
        wait_at_least(out_freed + s, g + 1 - RING);
#pragma unroll
        for (int h = 0; h < HOP; ++h)
#pragma unroll
          for (int i = 0; i < NS; ++i) out[(s * HOP + h) * 32 * NS + 32 * i + lane] = row[h][i];
        __threadfence_block();
        __syncwarp();
        if (lane == 0) out_full[s] = g + 1;
      } else {
#pragma unroll
        for (int h = 0; h < HOP; ++h) {
          if (jl + h >= rows) continue;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int c = 32 * i + lane;
            if (c >= n) continue;
            const bool live = i > jb || (i == jb && lane >= jl + h);
            if (live) chk = check(row[h][i], chk);
            if (last) ob[(j + h) * n + c] = Cast<T>::from(live ? row[h][i] : 0.f);
            else if (live) wb[(j + h) * n + c] = row[h][i];
          }
        }
      }
    }
  }
}

// The wave route's kernel: passes of up to KC ranks, a warp a rank, R
// between passes in the f32 working copy; then one vote, and a problem that
// failed a check is swept by the resident algorithm on the tile, which
// overlays the rings.
template <int NS, typename T>
__global__ void __launch_bounds__(32 * KC) sweep_wave_kernel(const T* R, const T* V, T* out, float* work,
                                                             int* info, int n, int k, float sign) {
  extern __shared__ float smem[];
  __shared__ int s_best;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.x, off = b * n * n;
  float* buf = smem;
  volatile int* full = reinterpret_cast<int*>(buf + (size_t)(KC - 1) * RING * HOP * 32 * NS);
  volatile int* freed = full + (KC - 1) * RING;
  float* wb;
  if constexpr (sizeof(T) == sizeof(float)) wb = reinterpret_cast<float*>(out) + off;
  else wb = work ? work + off : nullptr;
  if (threadIdx.x == 0) s_best = INT_MAX;
  int best = INT_MAX;
  float chk = 0.f;
  for (int q0 = 0; q0 < k; q0 += KC) {
    const int Q = min(KC, k - q0);
    for (int e = threadIdx.x; e < 2 * (KC - 1) * RING; e += blockDim.x) full[e] = 0;  // and freed
    __syncthreads();  // the flags are reset, the last pass's rows are in wb
    if (w < Q)
      wave_pass<NS>(R + off, wb, out + off, V + b * n * k, n, k, q0, Q, q0 == 0, q0 + Q == k, sign, best, chk, buf,
                    full, freed, w, lane);
    __syncthreads();
  }
  if (lane == 0 && best != INT_MAX) atomicMin(&s_best, best);
  if (__syncthreads_or(chk != chk)) resident(smem, R + off, V + b * n * k, out + off, info + b, n, k, sign);
  else if (threadIdx.x == 0) info[b] = s_best == INT_MAX ? 0 : s_best % n + 1;
}

template <int NS, typename T>
int launch_ns(int route, const void* R, const void* V, void* out, void* work, void* info, int batch, int n, int k,
              int warps, float sign, size_t smem, cudaStream_t stream) {
  if (route == ROUTE_WAVE) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        sweep_wave_kernel<NS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (attr != cudaSuccess) return (int)attr;
    sweep_wave_kernel<NS, T><<<batch, 32 * min(k, KC), smem, stream>>>(
        (const T*)R, (const T*)V, (T*)out, (float*)work, (int*)info, n, k, sign);
    return (int)cudaGetLastError();
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(sweep_kernel<NS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (batch + warps - 1) / warps;
  sweep_kernel<NS, T><<<blocks, 32 * warps, smem, stream>>>((const T*)R, (const T*)V, (T*)out, (float*)work,
                                                            (int*)info, batch, n, k, sign);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of a block: the fault path's tile, v and
// counts, 4·(n·(n + 1) + 3n), or on the wave route its rings and flags,
// which lie over it, where they take more (n <= 117, 129 <= n <= 132).
size_t smem_bytes(int n, int route) {
  const size_t tile = (size_t)n * (n + 1) + 3 * (size_t)n;
  const size_t rings = (size_t)(KC - 1) * RING * HOP * 32 * ((n + 31) / 32) + 2 * (KC - 1) * RING;
  return sizeof(float) * (route == ROUTE_WAVE && rings > tile ? rings : tile);
}

template <typename T>
int launch(int route, const void* R, const void* V, void* out, void* work, void* info, int batch, int n, int k,
           int warps, float sign, void* stream) {
  const size_t smem = smem_bytes(n, route);
  if (smem > SMEM_MAX || n > 32 * NS_MAX) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + 31) / 32) {
    case 1: return launch_ns<1, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 2: return launch_ns<2, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 3: return launch_ns<3, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 4: return launch_ns<4, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 5: return launch_ns<5, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 6: return launch_ns<6, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    case 7: return launch_ns<7, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
    default: return launch_ns<8, T>(route, R, V, out, work, info, batch, n, k, warps, sign, smem, s);
  }
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 = launched), -1 for
// arguments the kernel does not take.  R and out are contiguous (batch, n,
// n) stacks, V (batch, n, k), info (batch,) int32; R, V and out share one
// dtype (bf16 or f32).  route: 0 row (a warp a problem, `warps` problems a
// block, 1..8), 1 wave (a block a problem, a warp a rank; k >= 2).  work:
// an f32 (batch, n, n) scratch for R between passes, needed for bf16 when
// the route takes more than one pass over R (row: k > 8 or k not a power
// of two; wave: k > 8), else ignored (f32 keeps R in out) and may be null.
extern "C" int capital_up_sweep(int dtype, const void* R, const void* V, void* out, void* work, void* info,
                                int batch, int n, int k, int route, int warps, double sign, void* stream) {
  if (n < 1 || k < 0 || batch < 1) return -1;
  if (route == ROUTE_ROW && (warps < 1 || warps > MAX_WARPS)) return -1;
  if (route == ROUTE_WAVE && k < 2) return -1;
  if (route != ROUTE_ROW && route != ROUTE_WAVE) return -1;
  const int passes = route == ROUTE_WAVE ? (k + KC - 1) / KC : k == 0 ? 1 : k / KC + __builtin_popcount(k % KC);
  if (dtype == DT_BF16 && passes > 1 && work == nullptr) return -1;
  if (dtype == DT_F32) return launch<float>(route, R, V, out, work, info, batch, n, k, warps, (float)sign, stream);
  if (dtype == DT_BF16) return launch<bf16>(route, R, V, out, work, info, batch, n, k, warps, (float)sign, stream);
  return -1;
}
