// TSQR panel QR: a batch of (p, n) panels, one block per panel
// (blockIdx.x = panel), each factored P = Q·R by Householder reflectors —
// thin Q (p, n) and upper-triangular R (n, n).
//
// Replaces capital_tpu/ops/tsqr.py:_qr_pallas (:200; body _house_panel
// :137; its pallas_call is batched_small._batched_call :358), the leaf and
// reduction panel QRs of ops/tsqr.tsqr under impl 'pallas' / 'auto'.  The
// reflectors are the JAX kernel's: for column j, x = W[j:, j],
// α = −sign(x_j)·‖x‖ (sign(0) = +1), v = (x − α·e_j)/‖x − α·e_j‖ (v = 0
// for a zero column: the identity reflector, so zero-padded panels factor
// exactly), H_j = I − 2·v·vᵀ applied to the columns right of j; R = triu of
// the swept top n rows, its diagonal x_j − 2·v_j·(vᵀx) as the JAX sweep
// computes it; Q = H_0·…·H_{n−1}·I[:, :n].
//
// What bounds it on the card: f32 operations — 4·p·n² − 4n³/3 useful flops
// per panel (R and Q) on CUDA cores (IEEE f32: the reference's "highest";
// TF32 is never used), 8192 panels of 256 × 128 at the QR flagship's
// leaves (1.7 ms at 67 TF/s).  One panel's tile is one block's shared
// memory, so one block an SM: 8 warps, 2 a scheduler, latency hidden by
// independent FMA chains.
//
// The design, a blocked compact-WY Householder QR (LAPACK geqrf / larft /
// larfb, orgqr), columns in blocks of PNB:
//   * panel factor: thread (g, c) keeps column j0 + c of rows g + PG·i in
//     registers for the whole block.  Column j takes ONE block reduction:
//     each thread sums x·w_c over its rows (x, column j, arrives by warp
//     shuffle), so x·x, every x·w_c (c > j) and every x·v_c (c < j) come out
//     of one barrier; ‖x − α·e_j‖² = 2σ(σ + |x_j|), vᵀw_c = (x·w_c −
//     α·w_c[j])/‖x − α·e_j‖ (LAPACK's cancellation-free forms), and the
//     v_cᵀv_j feed the block's T.
//   * T (nb × nb, upper): larft forward with τ = 2 (unit-norm v), so that
//     H_{j0}·…·H_{j0+nb−1} = I − V·T·Vᵀ.
//   * trailing update as two register-tiled products on the shared tile:
//     Y = Vᵀ·W_right (8 × 4 tiles a thread, the depth split into row slices
//     that a fixed-order pass sums), then W_right −= (V·Tᵀ)·Y (8 × 4 tiles
//     of the output, depth nb; V·Tᵀ a row a thread), three 16-byte shared
//     loads per 32 FMAs.
//   * thin Q by the same products, one block at a time in descending
//     order: Q[j0:, j0:] −= (V·T)·(Vᵀ·Q[j0:, j0:]), the block's own columns
//     starting as identity columns (LAPACK orgqr).
// About nb + 4 barriers a block of columns (the column sweep took two
// reductions and two more barriers a column).  The tile arrives by 16-byte
// cp.async copies and leaves by 16-byte stores when the panel is f32 with
// n % 4 == 0, else an entry at a time.
//
// Shared memory (f32, ld = tile_ld(n): round4(n) plus 4 when that is 0 mod
// 8, so 16-byte row loads of neighbouring rows spread over the banks;
// prow = round8(p)):
//   W     prow x ld    the panel -> v below the diagonal, R above -> Q
//   VT    PNB x prow   the block's reflectors, transposed, zero above
//   UT    PNB x prow   V·Tᵀ (trailing update) or V·T (thin Q), transposed
//   Tall  nblk x PNB²  every block's T
//   Y     YCAP         Vᵀ·W partial sums by row slice, then their sum
//   red   2 x PWARPS x PNB, redx 2 x PNB, Zs PNB², rd round4(n)
// 211,584 bytes at p = 256, n = 128 (capital_tpu_torch/ops/tsqr.smem_bytes).

#include "common.cuh"

constexpr int PNT = 256;               // threads a block
constexpr int PWARPS = PNT / 32;
constexpr int PNB = 16;                // columns a block of reflectors: 8 or 16 (PNB divides PG)
constexpr int PG = PNT / PNB;          // row groups of the panel factor
constexpr int YCAP = PNB * 512;        // floats of the Y workspace: two row slices for n <= 256
constexpr int MAX_SLICES = 8;          // row slices of Y = Vᵀ·W at most
constexpr size_t SMEM_MAX = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

__host__ __device__ __forceinline__ int tile_ld(int n) {
  const int n4 = round4(n);
  return (n4 / 4) % 2 ? n4 : n4 + 4;
}

__host__ __device__ __forceinline__ int nblocks(int n) { return (n + PNB - 1) / PNB; }

// floats of shared memory for one (p, n) panel
__host__ __device__ __forceinline__ size_t smem_floats(int p, int n) {
  return (size_t)round8(p) * tile_ld(n) + 2 * (size_t)PNB * round8(p) + (size_t)nblocks(n) * PNB * PNB + YCAP +
         2 * PWARPS * PNB + 2 * PNB + PNB * PNB + round4(n);
}

__device__ __forceinline__ float load_in(const void* P, int dt, long long i) {
  return dt == DT_F32 ? static_cast<const float*>(P)[i] : __bfloat162float(static_cast<const bf16*>(P)[i]);
}

__device__ __forceinline__ void store_out(void* Q, int dt, long long i, float v) {
  if (dt == DT_F32) static_cast<float*>(Q)[i] = v;
  else static_cast<bf16*>(Q)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack(float* v, const float4 t) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Factor the w columns j0 .. j0 + w − 1 (rows >= j0) of the tile: v_j into
// column j on and below the diagonal, R's entries of these columns above
// it, R's diagonal into rd, v_cᵀv_j (c < j) into Zs[j][c].  Ends with the
// block's columns stored back (no barrier).
//
// Thread (g, c) keeps column j0 + c of its rows g + PG·i below the block's
// own PNB rows in wr (its other rows are zero there and stay zero) and its
// row of the block's own rows, j0 + gd, in dreg: every live row in wr lies
// below every column's diagonal, so the column loop needs no row masks;
// only dreg's row is compared with the column.
template <int RPT>
__device__ __forceinline__ void panel_factor(float* W, int ld, int p, int j0, int w, float* red, float* redx,
                                             float* Zs, float* rd) {
  static_assert(PG % PNB == 0, "a block's rows lie in one register slot of each row group");
  const int tid = threadIdx.x, c = tid % PNB, g = tid / PNB, lane = tid & 31, warp = tid >> 5;
  const int seg = lane & ~(PNB - 1);  // the first lane of this row group in the warp
  const int gd = g - j0 % PG;         // this row group's row of the block: j0 + gd
  const bool hasd = gd >= 0 && gd < PNB && j0 + gd < p && c < w;
  float wr[RPT], xr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g + PG * i;
    wr[i] = (c < w && r < p && r >= j0 + PNB) ? W[r * ld + j0 + c] : 0.f;
  }
  float dreg = hasd ? W[(j0 + gd) * ld + j0 + c] : 0.f;
  for (int jj = 0; jj < w; ++jj) {
    const int j = j0 + jj;
    float part2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xr[i] = __shfl_sync(FULL, wr[i], seg + jj);
      part2[i & 1] = fmaf(xr[i], wr[i], part2[i & 1]);
    }
    const float xd = __shfl_sync(FULL, dreg, seg + jj);
    const bool below = gd >= jj;  // dreg's row is at or below row j
    float part = part2[0] + part2[1] + (below ? xd * dreg : 0.f);
#pragma unroll
    for (int o = PNB; o < 32; o <<= 1) part += __shfl_xor_sync(FULL, part, o);
    float* rb = red + (jj & 1) * PWARPS * PNB;  // [column][warp]
    float* xb = redx + (jj & 1) * PNB;
    if (lane < PNB) rb[c * PWARPS + warp] = part;
    if (gd == jj) xb[c] = dreg;
    __syncthreads();
    float s = 0.f, d = 0.f;
#pragma unroll
    for (int q = 0; q < PWARPS; q += 4) {
      float a[4], e[4];
      unpack(a, ld4(rb + jj * PWARPS + q));
      unpack(e, ld4(rb + c * PWARPS + q));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s += a[i];
        d += e[i];
      }
    }
    const float xj = xb[jj], cj = xb[c];
    const float sig = sqrtf(s);
    const float alpha = xj >= 0.f ? -sig : sig;
    const float un2 = 2.f * sig * (sig + fabsf(xj));  // ‖x − α·e_j‖²
    const float inv = un2 > 0.f ? 1.f / sqrtf(un2) : 0.f;
    const float uj = xj - alpha;
    // c > jj: vᵀw_c;  c == jj: vᵀx;  c < jj: v_cᵀv_j
    const float t = (d - alpha * cj) * inv;
    if (g == 0 && c == jj) rd[j] = xj - 2.f * (uj * inv) * t;
    if (g == 0 && c < jj) Zs[jj * PNB + c] = t;
    // rows >= j: column jj becomes v = u·inv, a later column w −= 2·(vᵀw)·v
    // = w + u·(−2·t·inv), an earlier one (a reflector already) stays
    const float coef = c == jj ? inv : (c > jj ? -2.f * t * inv : 0.f);
    const float keep = c == jj ? 0.f : 1.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) wr[i] = fmaf(xr[i], coef, keep * wr[i]);
    dreg = below ? fmaf(gd == jj ? uj : xd, coef, keep * dreg) : dreg;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g + PG * i;
    if (c < w && r < p && r >= j0 + PNB) W[r * ld + j0 + c] = wr[i];
  }
  if (hasd) W[(j0 + gd) * ld + j0 + c] = dreg;
}

// T of the block (upper, w x w, zero outside): T[a][a] = 2,
// T[a][i] = −2·Σ_{b=a}^{i−1} T[a][b]·(v_bᵀv_i) — LAPACK larft, forward,
// columnwise, τ = 2.  Warp 0, lane a owns row a; Zs[i][b] = v_bᵀv_i.
__device__ __forceinline__ void block_t(const float* Zs, int w, float* T) {
  const int a = threadIdx.x;
  if (a >= 32) return;
  float trow[PNB];
#pragma unroll
  for (int i = 0; i < PNB; ++i) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < PNB / 4; ++q) {
      if (4 * q >= i) break;
      float z[4];
      unpack(z, ld4(Zs + i * PNB + 4 * q));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < i) acc[k] = fmaf(trow[4 * q + k], i < w ? z[k] : 0.f, acc[k]);
    }
    const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    trow[i] = (a >= w || i >= w || i < a) ? 0.f : (i == a ? 2.f : -2.f * sum);
  }
  if (a < PNB) {
#pragma unroll
    for (int i = 0; i < PNB; i += 4) st4(T + a * PNB + i, trow + i);
  }
}

// VT[a][r] = v_{j0+a}[r]: the block's reflectors from the tile, transposed,
// zero above the diagonal and past the panel; a thread a row
__device__ __forceinline__ void copy_v(const float* W, int ld, int p, int prow, int j0, int w, float* VT) {
  for (int r = threadIdx.x; r < prow; r += PNT) {
#pragma unroll
    for (int q = 0; q < PNB / 4; ++q) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < p && r >= j0) unpack(v, ld4(W + r * ld + j0 + 4 * q));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 4 * q + i;
        VT[a * prow + r] = (a < w && r >= j0 + a) ? v[i] : 0.f;
      }
    }
  }
}

// Y[s][a][c − cz] = Σ_{r in slice s} v_{j0+a}[r]·W[r][c] for the columns
// c in [c1, n4) (c1 − cz a multiple of 4), the reflectors read from the
// tile's block columns (masked above the diagonal).  Returns the slice
// count.  Thread: 8 reflectors × 4 columns over one row slice (three
// 16-byte loads per 32 FMAs).
__device__ __forceinline__ int product_vtw(const float* W, int ld, int p, int j0, int c1, int cz, int n4, float* Y) {
  constexpr int QA = PNB / 8;
  const int ng = (n4 - c1) / 4, nz4 = n4 - cz;
  const int ts = (QA * ng + 31) & ~31;  // threads of a slice: whole warps, so a warp walks one slice
  int S = PNT / ts;
  S = min(S, YCAP / (PNB * nz4));
  S = max(1, min(S, MAX_SLICES));
  const int e = threadIdx.x % ts, s = threadIdx.x / ts, q = e % QA, cg = e / QA;
  if (s < S && cg < ng) {
    const int D = p - j0, L = (D + S - 1) / S;
    const int lo = j0 + s * L, hi = min(p, lo + L), mid = min(hi, j0 + PNB);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    const float* vcol = W + j0 + 8 * q;
    const float* wcol = W + c1 + 4 * cg;
    for (int r = lo; r < mid; ++r) {  // the block's diagonal rows: v is zero above its diagonal
      float v[8], x[4];
      unpack(v, ld4(vcol + r * ld));
      unpack(v + 4, ld4(vcol + r * ld + 4));
      unpack(x, ld4(wcol + r * ld));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float vi = r - j0 >= 8 * q + i ? v[i] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(vi, x[k], acc[i][k]);
      }
    }
#pragma unroll 4
    for (int r = max(lo, mid); r < hi; ++r) {
      float v[8], x[4];
      unpack(v, ld4(vcol + r * ld));
      unpack(v + 4, ld4(vcol + r * ld + 4));
      unpack(x, ld4(wcol + r * ld));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(v[i], x[k], acc[i][k]);
    }
    float* y = Y + (s * PNB + 8 * q) * nz4 + (c1 - cz) + 4 * cg;
#pragma unroll
    for (int i = 0; i < 8; ++i) st4(y + i * nz4, acc[i]);
  }
  return S;
}

// UT[a][r] = (V·Tᵀ)[r][a] (trans) or (V·T)[r][a]: a thread a row of V
// (from VT), T's rows as 16-byte broadcast loads
__device__ __forceinline__ void scale_v(const float* T, const float* VT, int prow, int j0, bool trans, float* UT) {
  for (int r = j0 + threadIdx.x; r < prow; r += PNT) {
    float v[PNB], u[PNB];
#pragma unroll
    for (int a = 0; a < PNB; ++a) {
      v[a] = VT[a * prow + r];
      u[a] = 0.f;
    }
    // trans: u[a] = Σ_{b >= a} v[b]·T[a][b];  else u[a] = Σ_{b <= a} v[b]·T[b][a]
#pragma unroll
    for (int a = 0; a < PNB; ++a) {
#pragma unroll
      for (int q = 0; q < PNB / 4; ++q) {
        float t[4];
        unpack(t, ld4(T + a * PNB + 4 * q));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = 4 * q + i;
          if (trans && b >= a) u[a] = fmaf(v[b], t[i], u[a]);
          if (!trans && b >= a) u[b] = fmaf(v[a], t[i], u[b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < PNB; ++a) UT[a * prow + r] = u[a];
  }
}

// Y[0][a][c − cz] = Yᵀ's column c: the S row slices summed in order for
// c >= c1; for the block's own identity columns of the thin-Q pass
// (c < ceye) row c of V (Vᵀ·e_c, from VT); zero for the padding between.
__device__ __forceinline__ void sum_slices(const float* VT, int prow, int cz, int ceye, int c1, int n4, int S,
                                           float* Y) {
  const int nz4 = n4 - cz;
  for (int e = threadIdx.x; e < PNB * nz4; e += PNT) {
    const int a = e / nz4, c = cz + e - a * nz4;
    float v = 0.f;
    if (c < ceye) {
      v = VT[a * prow + c];
    } else if (c >= c1) {
      for (int s = 0; s < S; ++s) v += Y[(s * PNB + a) * nz4 + c - cz];
    }
    Y[e] = v;
  }
}

// W[r][c] −= Σ_a UT[a][r]·Y[a][c] for r in [j0, prow), c in [cz, n4); the
// columns in [cz, ceye) start from the identity instead of the tile (the
// block's own columns in the thin-Q pass).  Thread: 8 × 4 output tiles
// (three 16-byte loads per 32 FMAs).
__device__ __forceinline__ void product_uy(float* W, int ld, const float* UT, int prow, int j0, int cz, int ceye,
                                           int n4, const float* Z) {
  const int nz4 = n4 - cz, ng = nz4 / 4, rg = (prow - j0) / 8;
  for (int e = threadIdx.x; e < ng * rg; e += PNT) {
    const int cg = e % ng, r0 = j0 + 8 * (e / ng), c0 = cz + 4 * cg;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unpack(acc[i], ld4(W + (r0 + i) * ld + c0));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < ceye) acc[i][k] = r0 + i == c0 + k ? 1.f : 0.f;
    }
#pragma unroll 4
    for (int a = 0; a < PNB; ++a) {  // UT's rows past w are zero
      float u[8], z[4];
      unpack(u, ld4(UT + a * prow + r0));
      unpack(u + 4, ld4(UT + a * prow + r0 + 4));
      unpack(z, ld4(Z + a * nz4 + 4 * cg));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(-u[i], z[k], acc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) st4(W + (r0 + i) * ld + c0, acc[i]);
  }
}

template <int RPT>
__global__ void __launch_bounds__(PNT) panel_qr_kernel(const void* P, void* Q, void* R, int dt, int p, int n) {
  extern __shared__ float4 smem4[];
  const int ld = tile_ld(n), prow = round8(p), n4 = round4(n), nblk = nblocks(n);
  float* W = reinterpret_cast<float*>(smem4);
  float* VT = W + prow * ld;
  float* UT = VT + PNB * prow;
  float* Tall = UT + PNB * prow;
  float* Y = Tall + nblk * PNB * PNB;
  float* red = Y + YCAP;
  float* redx = red + 2 * PWARPS * PNB;
  float* Zs = redx + 2 * PNB;
  float* rd = Zs + PNB * PNB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;

  // the panel, zero-padded to round4(p) x round4(n): 16-byte cp.async rows
  // when they allow it, else a warp a row
  const bool vec = dt == DT_F32 && n % 4 == 0 && reinterpret_cast<uintptr_t>(P) % 16 == 0;
  if (vec) {
    const float* src = static_cast<const float*>(P) + b * p * n;
    for (int e = tid; e < prow * (n / 4); e += PNT) {
      const int r = e / (n / 4), c = 4 * (e - r * (n / 4));
      if (r < p) cp_async16(W + r * ld + c, src + (long long)r * n + c);
      else *reinterpret_cast<float4*>(W + r * ld + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    for (int r = warp; r < prow; r += PWARPS)
      for (int c = lane; c < n4; c += 32)
        W[r * ld + c] = (r < p && c < n) ? load_in(P, dt, (b * p + r) * n + c) : 0.f;
  }
  __syncthreads();

  // ascending blocks of reflectors: factor, T, trailing update
  for (int k = 0; k < nblk; ++k) {
    const int j0 = k * PNB, w = min(PNB, n - j0);
    float* T = Tall + k * PNB * PNB;
    panel_factor<RPT>(W, ld, p, j0, w, red, redx, Zs, rd);
    __syncthreads();
    const bool trailing = j0 + w < n;
    int S = 0;
    block_t(Zs, w, T);
    copy_v(W, ld, p, prow, j0, w, VT);
    if (trailing) S = product_vtw(W, ld, p, j0, j0 + w, j0 + w, n4, Y);
    __syncthreads();
    if (!trailing) continue;
    scale_v(T, VT, prow, j0, true, UT);
    sum_slices(VT, prow, j0 + w, j0 + w, j0 + w, n4, S, Y);
    __syncthreads();
    product_uy(W, ld, UT, prow, j0, j0 + w, j0 + w, n4, Y);
    __syncthreads();
  }

  // R: the top n rows, strict upper triangle from the tile, diagonal from rd
  float* Rb = static_cast<float*>(R) + b * n * n;
  for (int r = warp; r < n; r += PWARPS)
    for (int c = vec ? 4 * lane : lane; c < n; c += vec ? 128 : 32) {
      if (vec) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = c + i > r ? W[r * ld + c + i] : (c + i == r ? rd[r] : 0.f);
        *reinterpret_cast<float4*>(Rb + r * n + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        store_out(R, dt, (b * n + r) * n + c, c > r ? W[r * ld + c] : (c == r ? rd[r] : 0.f));
      }
    }
  __syncthreads();  // R is read out before Q overwrites it

  // thin Q, descending blocks, in place
  for (int k = nblk - 1; k >= 0; --k) {
    const int j0 = k * PNB, w = min(PNB, n - j0);
    const int c1 = j0 + w < n ? j0 + w : n4;  // product 1's columns: those of the later blocks
    const float* T = Tall + k * PNB * PNB;
    copy_v(W, ld, p, prow, j0, w, VT);
    const int S = c1 < n4 ? product_vtw(W, ld, p, j0, c1, j0, n4, Y) : 1;
    __syncthreads();
    scale_v(T, VT, prow, j0, false, UT);
    sum_slices(VT, prow, j0, j0 + w, c1, n4, S, Y);
    for (int e = tid; e < j0 * PNB; e += PNT) {  // the block's columns above its rows: zero
      const int r = e / PNB, c = e - r * PNB;
      if (c < w) W[r * ld + j0 + c] = 0.f;
    }
    __syncthreads();
    product_uy(W, ld, UT, prow, j0, j0, j0 + w, n4, Y);
    __syncthreads();
  }
  float* Qb = static_cast<float*>(Q) + b * p * n;
  for (int r = warp; r < p; r += PWARPS)
    for (int c = vec ? 4 * lane : lane; c < n; c += vec ? 128 : 32) {
      if (vec) *reinterpret_cast<float4*>(Qb + r * n + c) = ld4(W + r * ld + c);
      else store_out(Q, dt, (b * p + r) * n + c, W[r * ld + c]);
    }
}

template <int RPT>
static int launch(const void* P, void* Q, void* R, int dt, int batch, int p, int n, size_t smem, void* stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(panel_qr_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  panel_qr_kernel<RPT><<<batch, PNT, smem, (cudaStream_t)stream>>>(P, Q, R, dt, p, n);
  return (int)cudaGetLastError();
}


// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take: p < n, p > 32·PG (the panel factor's
// registers) or a tile over one block's shared memory.  P and Q are
// contiguous (batch, p, n) stacks, R a contiguous (batch, n, n) stack.
extern "C" int capital_tsqr_panel(int dtype, const void* P, void* Q, void* R, int batch, int p, int n,
                                  void* stream) {
  if (batch < 1 || n < 1 || p < n || (dtype != DT_F32 && dtype != DT_BF16)) return -1;
  const size_t smem = sizeof(float) * smem_floats(p, n);
  if (smem > SMEM_MAX) return -1;
  if (p <= 8 * PG) return launch<8>(P, Q, R, dtype, batch, p, n, smem, stream);
  if (p <= 16 * PG) return launch<16>(P, Q, R, dtype, batch, p, n, smem, stream);
  if (p <= 32 * PG) return launch<32>(P, Q, R, dtype, batch, p, n, smem, stream);
  return -1;
}
