// The f32 products at precision 'high' of tri_matmul.cu, sched_matmul.cu and
// qr_fused.cu: the bf16x3 split contraction.
//
// Replaces the split that every in-kernel product of the JAX package makes
// for f32 operands at 'high' (capital_tpu/ops/pallas_tpu.py _split_bf16 and
// precision_dot, shared through _make_accumulate by tri_matmul and
// sched_matmul and through qr_fused._dot by the three CholeskyQR2 passes):
// each f32 operand x becomes hi = RN_bf16(x) and lo = RN_bf16(x - hi), and
// the product is hi·hi + (hi·lo + lo·hi), three bf16 products summed in f32;
// lo·lo is dropped.  Every bf16 x bf16 product is exact in f32, so only the
// order of the f32 sums differs from the reference.
//
// What bounds it on the card: operations, three bf16 passes at the tensor
// cores' rate (the windows are thousands wide).  Two routes, picked by the
// wrappers (ops/hopper.py, ops/qr_fused.py) before the launch:
//   * x3 (16-byte-aligned f32 windows): a split pass writes the hi and lo
//     images of each operand window as bf16 planes into a workspace the
//     wrapper allocates (a triangular operand's dead triangle as zeros, so
//     no k-tile is masked and NaN there never reaches a sum), then the TMA +
//     wgmma ring of wgmma_tiles.cuh runs on the images: each k-tile takes
//     two ring stages, the hi images in one and the lo images in the next,
//     and the consumers issue hi·hi into one accumulator chain and hi·lo +
//     lo·hi into a second.  wgmma's f32 sums do not round to nearest (see
//     qr_fused.cu gram_wgmma), so the chains restart every CHAIN k-tiles
//     (512 deep), and each chain pair is added as hi·hi + cross in IEEE f32
//     to a per-thread total in shared memory — the reference's acc += hh +
//     (hl + lh) per block;
//   * simt3 (any other f32 window): the element-load loop of mm_tiles.cuh
//     with the split made as each element is staged (split_f32), the three
//     products in IEEE fmaf into two register chains folded the same way
//     every 512 of depth.
// The images make an in-place `out` window over A or B safe: the x3 product
// reads only the images.
#pragma once

#include "mm_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace x3 {

// ---- the split ---------------------------------------------------------------

// hi and lo of one f32 value (widened back to f32: both are exact there)
__device__ __forceinline__ void split_f32(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// bf16 columns of an image row: the window's, rounded up to 16 bytes (TMA's
// stride rule)
__host__ __device__ inline long long image_ld(long long cols) { return (cols + 7) / 8 * 8; }

// bf16 elements of one operand's two images: the hi plane, then the lo plane
__host__ __device__ inline long long image_elems(long long rows, long long cols) {
  return 2 * rows * image_ld(cols);
}

// The split pass: hi and lo of each element of the (rows x cols) f32 window
// at X (leading dimension ld) into the hi plane at img and the lo plane
// rows·image_ld(cols) elements after it; elements outside the kept triangle
// `uplo` of the window are written as zeros.  One thread a column, the rows
// walked by blockIdx.y in strides of gridDim.y: loads and stores coalesce
// along a row.
__global__ void split_kernel(const float* X, long long ld, long long rows, int cols, int uplo,
                             bf16* img) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long ldi = image_ld(cols), plane = rows * ldi;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float x = in_tri(uplo, r, c) ? X[r * ld + c] : 0.0f;
    const bf16 hi = __float2bfloat16_rn(x);
    img[r * ldi + c] = hi;
    img[plane + r * ldi + c] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

constexpr int SPLIT_THREADS = 256, SPLIT_ROW_BLOCKS = 2048;

static int split(const void* X, long long ld, long long rows, long long cols, int uplo, bf16* img,
                 cudaStream_t s) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid((unsigned)((cols + SPLIT_THREADS - 1) / SPLIT_THREADS),
                  (unsigned)(rows < SPLIT_ROW_BLOCKS ? rows : SPLIT_ROW_BLOCKS));
  split_kernel<<<grid, SPLIT_THREADS, 0, s>>>((const float*)X, ld, rows, (int)cols, uplo, img);
  return (int)cudaGetLastError();
}

// ---- x3: the ring on the images ------------------------------------------------

// The tensor maps of the two operands' images, hi and lo (kernel parameter,
// __grid_constant__: TMA reads the maps where they lie)
struct Maps {
  CUtensorMap a[2];  // A's hi, lo
  CUtensorMap b[2];  // B's hi, lo
};

// Maps of a (rows x cols) operand's images at img (split's layout);
// box_rows as wg::make_map's
static bool image_maps(CUtensorMap (&m)[2], const bf16* img, long long rows, long long cols,
                       int box_rows) {
  const long long ldi = image_ld(cols);
  return wg::make_map(&m[0], img, rows, cols, ldi, box_rows) &&
         wg::make_map(&m[1], img + rows * ldi, rows, cols, ldi, box_rows);
}

// k-tiles a chain: hi·hi and the cross terms restart every CHAIN k-tiles
// (512 deep) and are added to the IEEE f32 total
constexpr int CHAIN = 8;
static_assert(wg::STAGES % 2 == 0, "a k-tile takes a pair of stages");
// the per-thread totals beside the ring's barriers: 64 floats for each of
// the 256 consumer threads, thread-minor (conflict-free)
constexpr int SUM_OFF = wg::STAGES * wg::STAGE_BYTES + 3 * wg::STAGES * 8;
static_assert(SUM_OFF % 16 == 0, "the totals are 16-byte aligned");
constexpr int SMEM_BYTES = wg::SMEM_BYTES + 64 * 256 * 4;

// the totals of consumer thread ctid: value i at sum[i * 256]
__device__ __forceinline__ float* sum_of(const wg::Ring& r, int ctid) {
  return reinterpret_cast<float*>(r.base + SUM_OFF) + ctid;
}

// the first of the two stages of k-tile g (hi images; lo in the next) and
// the parity of its round
__device__ __forceinline__ int pair_stage(uint32_t g) { return (int)(2 * g % wg::STAGES); }
__device__ __forceinline__ uint32_t pair_parity(uint32_t g) {
  return (2 * g / wg::STAGES) & 1;
}

// The producer: k-tile t (the g0 + t-th of the block) of the hi images into
// stage pair_stage, of the lo images into the next stage.
template <bool AT, bool BT, class KOf>
__device__ __forceinline__ void produce(const wg::Ring& r, const Maps& m, int i0, int j0, int nk,
                                        KOf k_of, uint32_t g0 = 0) {
  for (int t = 0; t < nk; ++t) {
    const uint32_t g = g0 + t;
    const int k0 = k_of(t);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int s = pair_stage(g) + part;
      wg::bar_wait(r.empty(s), pair_parity(g) ^ 1);  // round 0 passes at once
      wg::load_stage<AT, BT>(r, s, r.full(s), &m.a[part], &m.b[part], i0, j0, k0);
    }
  }
}

// The consumers: nk k-tiles (the g0-th onwards of the block) into the totals
// at sum (sum_of), which this zeroes first.  Each k-tile's hi·hi (stage s)
// into dh and hi·lo + lo·hi (stages s, s + 1) into dx are issued as one
// group; the previous group is waited for and its two stages released, so
// one group stays in flight, except at the end of a chain, where the chains
// are added to the totals.  Every stage is released when this returns.  dh
// and dx are the caller's accumulator registers, zeroed once before its
// loops (a chain's first product overwrites them: no other instruction
// writes them between wgmma groups).
template <bool AT, bool BT>
__device__ __forceinline__ void consume(const wg::Ring& r, int nk, int ctid, float* sum,
                                        float (&dh)[64], float (&dx)[64], uint32_t g0 = 0) {
  const int wgi = ctid >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i * 256] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const uint32_t g = g0 + t;
    const int s = pair_stage(g);
    wg::bar_wait(r.full(s), pair_parity(g));
    wg::bar_wait(r.full(s + 1), pair_parity(g));
    wg::fence_acc(dh);
    wg::fence_acc(dx);
    wg::wgmma_fence();
    const bool chained = t % CHAIN != 0;
    wg::mma_stages<AT, BT>(r, s, s, wgi, dh, chained);      // hi·hi
    wg::mma_stages<AT, BT>(r, s, s + 1, wgi, dx, chained);  // hi·lo
    wg::mma_stages<AT, BT>(r, s + 1, s, wgi, dx);           // + lo·hi
    wg::wgmma_commit();
    wg::fence_acc(dh);
    wg::fence_acc(dx);
    if (t % CHAIN == CHAIN - 1 || t == nk - 1) {
      wg::wgmma_wait<0>();
      wg::fence_acc(dh);
      wg::fence_acc(dx);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i * 256] = __fadd_rn(sum[i * 256], __fadd_rn(dh[i], dx[i]));
    } else {
      wg::wgmma_wait<1>();
      wg::fence_acc(dh);
      wg::fence_acc(dx);
    }
    if (t > 0 && (ctid & 127) == 0) {
      const int sp = pair_stage(g - 1);
      wg::bar_arrive(r.empty(sp));
      wg::bar_arrive(r.empty(sp + 1));
    }
  }
  if (nk > 0 && (ctid & 127) == 0) {
    const int sp = pair_stage(g0 + nk - 1);
    wg::bar_arrive(r.empty(sp));
    wg::bar_arrive(r.empty(sp + 1));
  }
}

// Tile row and column of total i of consumer thread ctid (wgmma's
// accumulator layout, wg::acc_origin)
__device__ __forceinline__ void total_rc(int ctid, int i, int& row, int& col) {
  int r0, c0;
  wg::acc_origin(ctid, r0, c0);
  row = r0 + 8 * ((i >> 1) & 1);
  col = c0 + 8 * (i >> 2) + (i & 1);
}

// This thread's totals into the f32 tile at `tile` (row pitch ld), as pairs
// of neighbouring columns of a row
__device__ __forceinline__ void store_totals(float* tile, long long ld, const float* sum, int ctid) {
#pragma unroll 4
  for (int i = 0; i < 64; i += 2) {
    int row, col;
    total_rc(ctid, i, row, col);
    *reinterpret_cast<float2*>(tile + row * ld + col) = make_float2(sum[i * 256], sum[(i + 1) * 256]);
  }
}

// ---- simt3: the element-load loop with the split ---------------------------------

// 512 of depth a chain, as x3's
constexpr int S3_CHAIN = CHAIN * wg::BK / mmt::S_BK;

static_assert(mmt::S_BM == mmt::S_BN, "stage() takes A's and B's slices alike");

struct Simt3Smem {
  float ah[mmt::S_BK][mmt::S_BM + 1], al[mmt::S_BK][mmt::S_BM + 1];
  float bh[mmt::S_BK][mmt::S_BN + 1], bl[mmt::S_BK][mmt::S_BN + 1];
};

// stage one element of op(A) (kk, ii) or op(B) (kk, jj), split
__device__ __forceinline__ void stage(float (&h)[mmt::S_BK][mmt::S_BM + 1],
                                      float (&l)[mmt::S_BK][mmt::S_BM + 1], int kk, int x, float v) {
  split_f32(v, h[kk][x], l[kk][x]);
}

// sh += Ah x Bh, sx += Ah x Bl + Al x Bh over one staged slice (256 threads
// as 16 x 16, thread (tx, ty) owning rows ty + 16r and columns tx + 16c)
__device__ __forceinline__ void simt3_step(const Simt3Smem& sm, int tx, int ty, float (&sh)[4][4],
                                           float (&sx)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < mmt::S_BK; ++kk) {
    float ah[4], al[4], bh[4], bl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ah[r] = sm.ah[kk][ty + 16 * r];
      al[r] = sm.al[kk][ty + 16 * r];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bh[c] = sm.bh[kk][tx + 16 * c];
      bl[c] = sm.bl[kk][tx + 16 * c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sh[r][c] = fmaf(ah[r], bh[c], sh[r][c]);
        sx[r][c] = fmaf(al[r], bh[c], fmaf(ah[r], bl[c], sx[r][c]));
      }
  }
}

// total += sh + sx, and the chains restart
__device__ __forceinline__ void simt3_fold(float (&sh)[4][4], float (&sx)[4][4], float (&total)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      total[r][c] = __fadd_rn(total[r][c], __fadd_rn(sh[r][c], sx[r][c]));
      sh[r][c] = sx[r][c] = 0.0f;
    }
}

}  // namespace x3
