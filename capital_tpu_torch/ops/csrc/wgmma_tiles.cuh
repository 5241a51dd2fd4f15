// The Hopper main loop shared by the bf16 routes of tri_matmul.cu,
// sched_matmul.cu and qr_fused.cu: TMA loads into a ring of shared-memory
// stages, one producer thread, two consumer warpgroups on wgmma, f32
// accumulators in registers.  Written as inline PTX (no CUTLASS device code).
//
// What bounds the clients on the card: operations (their windows are
// thousands wide, far above the H100's ~295 flop/byte balance point; the QR
// scale sits at the balance point), so the design is the shape that reaches
// the tensor cores' rate:
//   * CTA tile 128 x 128, k-tile 64 bf16 = 128 bytes, so every operand tile
//     is rows of 128 bytes under the 128-byte swizzle that both TMA and
//     wgmma understand;
//   * a ring of STAGES = 4 stages (A 16 KB + B 16 KB each: 128 KB of dynamic
//     shared memory).  Thread 0 of warpgroup 0 keeps TMA loads in flight and
//     each stage's `full` mbarrier counts their bytes (expect_tx); the two
//     consumer warpgroups (1 and 2) each run wgmma.m64n128k16 on 64 rows of
//     the tile and release the stage's `empty` mbarrier once the products
//     that read it are done.  setmaxnreg gives the producer 40 registers and
//     the consumers 232;
//   * a k-tile whose operand straddles a diagonal lands on the stage's
//     `landed` mbarrier instead; warps 1-3 of warpgroup 0 zero its dead half
//     in shared memory, fence it for the async proxy and arrive on `full`.
//     The consumers' loop is wgmma and barriers only: any other instruction
//     there (masking, or an epilogue that reuses accumulator registers)
//     makes ptxas serialize every wgmma (its warning C7515);
//   * the consumers stage their f32 accumulators through shared memory, and
//     the epilogue reads them back in 16-byte row segments, so its loads of
//     C and stores of the result are coalesced;
//   * 2-D tensor maps built on the host for each call from the window itself
//     (origin, rows x cols, leading dimension), so TMA zero-fills past the
//     ragged edge and past K: no load carries a bounds predicate.
//
// Operand orientation.  Row-major A (M x K) is K-major; a transposed A
// (stored K x M) is MN-major.  Row-major B (K x N) is MN-major; a transposed
// B (stored N x K) is K-major.  wgmma takes both majors for 16-bit types
// through its transpose bits.  Shared-memory images, all 1024-byte aligned:
//   K-major tile:  one TMA box of 128 rows (M or N) x 64 k, 128 B a row;
//   MN-major tile: two TMA boxes of 64 k-rows x 64 (M or N), 8 KB apart.
// Either way consumer warpgroup w reads its 64 rows of A at +8192·w.
// Descriptors (128-byte swizzle): K-major SBO = 1024 (the next 8 rows),
// LBO unused, and a 16-deep k step moves the start 32 bytes; MN-major LBO =
// 8192 (the next 64-wide MN box), SBO = 1024 (the next 8 k-rows), and a
// 16-deep k step moves the start 2048 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links -lcuda

#include "common.cuh"

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, its 3·STAGES mbarriers, and slack to align the ring to 1024
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 3 * STAGES * 8 + 1024;
// row pitch (f32) of the staged accumulator tile: 8 banks between rows
constexpr int EPI_LD = BN + 8;
// MN-major descriptor strides (bytes): the next 64-wide MN box, the next 8 k-rows
constexpr uint32_t MN_LBO = 8192, MN_SBO = 1024;

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)f;
  }
  return fn;
}

// Map of a (rows x cols) bf16 window at `ptr` with leading dimension `ld`
// elements, read in boxes of 64 columns x `box_rows` rows (128 for a K-major
// tile, 64 for one half of an MN-major one).  An empty window (K = 0) maps
// one element that no load ever reads.  Returns false if the encode fails.
static bool make_map(CUtensorMap* m, const void* ptr, long long rows, long long cols,
                     long long ld, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[2] = {(cuuint64_t)(cols > 0 ? cols : 1), (cuuint64_t)(rows > 0 ? rows : 1)};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device (the one the launch goes to), once per device: a function attribute
// belongs to each device's context.  `sized` is the kernel's own flag array.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
static cudaError_t size_smem(Kernel kernel, bool (&sized)[MAX_DEVICES], int bytes = SMEM_BYTES) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && sized[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) sized[dev] = true;
  return e;
}

// ---- device: PTX wrappers ---------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box at (c0 = column, c1 = row) of the map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// consumer-only barrier (both consumer warpgroups, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the masking warps' barrier (warps 1-3 of warpgroup 0, 96 threads)
__device__ __forceinline__ void maskers_sync() {
  asm volatile("bar.sync 2, 96;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to wgmma / TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d = A (64 x 16) · B (16 x 128) + (scale_d ? d : 0); TA / TB = 1 for an
// MN-major operand
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// ---- the ring ---------------------------------------------------------------

struct Ring {
  uint8_t* base;  // 1024-aligned start of stage 0
  __device__ uint8_t* a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint8_t* b(int s) const { return base + s * STAGE_BYTES + A_BYTES; }
  __device__ uint32_t full(int s) const { return saddr(base + STAGES * STAGE_BYTES + 8 * s); }
  __device__ uint32_t empty(int s) const {
    return saddr(base + STAGES * STAGE_BYTES + 8 * (STAGES + s));
  }
  __device__ uint32_t landed(int s) const {
    return saddr(base + STAGES * STAGE_BYTES + 8 * (2 * STAGES + s));
  }
};

// Align the ring inside the dynamic shared memory and initialise its
// barriers: `full` waits for the producer's one arrival and the stage's
// bytes (or, for a masked k-tile, the maskers' one arrival), `landed` for
// the producer's arrival and the bytes of a k-tile to be masked, `empty`
// for one arrival from each consumer warpgroup.  Every thread of the block
// calls it (it ends in __syncthreads).
__device__ __forceinline__ Ring make_ring(uint8_t* raw) {
  Ring r;
  r.base = raw + ((1024 - (saddr(raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(r.full(s), 1);
      bar_init(r.empty(s), 2);
      bar_init(r.landed(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ---- producer warpgroup: thread 0 loads, warps 1-3 mask ---------------------

// One k-tile at k0 of the output tile at (i0, j0) into stage s, on the
// barrier fb: A's 128 rows and B's 128 columns.  A K-major operand is one
// box of 128 rows, an MN-major one two boxes of 64 (AT: A is stored K x M;
// BT: B is stored N x K).
template <bool AT, bool BT>
__device__ __forceinline__ void load_stage(const Ring& r, int s, uint32_t fb, const CUtensorMap* ta,
                                           const CUtensorMap* tb, int i0, int j0, int k0) {
  const uint32_t sa = saddr(r.a(s)), sb = saddr(r.b(s));
  bar_expect_tx(fb, STAGE_BYTES);
  if (AT) {
    tma_load(sa, ta, fb, i0, k0);
    tma_load(sa + A_BYTES / 2, ta, fb, i0 + BM / 2, k0);
  } else {
    tma_load(sa, ta, fb, k0, i0);
  }
  if (BT) {
    tma_load(sb, tb, fb, k0, j0);
  } else {
    tma_load(sb, tb, fb, j0, k0);
    tma_load(sb + B_BYTES / 2, tb, fb, j0 + BN / 2, k0);
  }
}

// Load the nk k-tiles of the output tile at (i0, j0); k_of(t) is the first k
// of k-tile t, and a k-tile that need(t) lands on `landed` for the maskers.
template <bool AT, bool BT, class KOf, class Need>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* ta,
                                        const CUtensorMap* tb, int i0, int j0, int nk, KOf k_of,
                                        Need need) {
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    bar_wait(r.empty(s), ((t / STAGES) & 1) ^ 1);  // round 0 passes at once
    load_stage<AT, BT>(r, s, need(t) ? r.landed(s) : r.full(s), ta, tb, i0, j0, k_of(t));
  }
}

// Zero, by select, the dead elements of one 16 KB operand tile in shared
// memory: live(mn, k) says whether element (mn, k) of the tile (mn the M or
// N index, 0..127; k 0..63) is inside the operand's kept triangle.  The
// tile is 128 rows of 128 bytes under the 128-byte swizzle (16-byte chunk g
// of row R holds logical chunk g ^ (R % 8)); a K-major row is one mn, an
// MN-major row one k of one of the two 64-wide halves.  Thread mtid of the
// 96 masking threads takes every 96th chunk.
template <bool KMAJOR, class Live>
__device__ __forceinline__ void mask_tile(uint8_t* tile, int mtid, Live live) {
  for (int ch = mtid; ch < 1024; ch += 96) {
    const int R = ch >> 3, col0 = ((ch & 7) ^ (R & 7)) << 3;
    uint4* p = reinterpret_cast<uint4*>(tile + ch * 16);
    uint4 v = *p;
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t keep[4] = {0, 0, 0, 0};
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int mn = KMAJOR ? R : (R >> 6) * 64 + col0 + x;
      const int k = KMAJOR ? col0 + x : R & 63;
      if (live(mn, k)) keep[x >> 1] |= (x & 1) ? 0xFFFF0000u : 0x0000FFFFu;
    }
    if ((keep[0] & keep[1] & keep[2] & keep[3]) != 0xFFFFFFFFu) {
      *p = make_uint4(w[0] & keep[0], w[1] & keep[1], w[2] & keep[2], w[3] & keep[3]);
    }
  }
}

// The masking warps (mtid 0..95): for each k-tile that need(t), wait for it
// to land, zero its dead half with mask(t, s), make the writes visible to
// wgmma and release it to the consumers on `full`.
template <class Need, class Mask>
__device__ __forceinline__ void mask_loop(const Ring& r, int nk, int mtid, Need need, Mask mask) {
  uint32_t parity = 0;  // bit s: the phase of landed(s) to wait for
  for (int t = 0; t < nk; ++t) {
    if (!need(t)) continue;
    const int s = t % STAGES;
    bar_wait(r.landed(s), (parity >> s) & 1);
    parity ^= 1u << s;
    mask(t, s);
    fence_async_smem();
    maskers_sync();
    if (mtid == 0) bar_arrive(r.full(s));
  }
}

// ---- consumers (two warpgroups, ctid 0..255) --------------------------------

// d += this warpgroup's 64 rows of A (stage sa) · B (stage sb), k = 64;
// with accumulate false the first product overwrites d instead (a new
// chain's first k-tile, without zeroing the accumulator registers in the
// loop)
template <bool AT, bool BT>
__device__ __forceinline__ void mma_stages(const Ring& r, int sa_stage, int sb_stage, int wgi,
                                           float (&d)[64], bool accumulate = true) {
  const uint32_t sa = saddr(r.a(sa_stage)) + wgi * (A_BYTES / 2), sb = saddr(r.b(sb_stage));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = AT ? desc(sa + kk * 2048, MN_LBO, MN_SBO) : desc(sa + kk * 32, 16, 1024);
    const uint64_t db = BT ? desc(sb + kk * 32, 16, 1024) : desc(sb + kk * 2048, MN_LBO, MN_SBO);
    mma_m64n128k16<AT ? 1 : 0, BT ? 0 : 1>(d, da, db, (kk > 0 || accumulate) ? 1 : 0);
  }
}

// the product of one stage's A and B
template <bool AT, bool BT>
__device__ __forceinline__ void mma_stage(const Ring& r, int s, int wgi, float (&d)[64],
                                          bool accumulate = true) {
  mma_stages<AT, BT>(r, s, s, wgi, d, accumulate);
}

// The consumers' main loop over nk k-tiles: each k-tile's products are
// issued, then the previous k-tile's are waited for and its stage
// released, so one group of wgmma stays in flight.
template <bool AT, bool BT>
__device__ __forceinline__ void consume(const Ring& r, int nk, int ctid, float (&d)[64]) {
  const int wgi = ctid >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    bar_wait(r.full(s), (t / STAGES) & 1);
    fence_acc(d);
    wgmma_fence();
    mma_stage<AT, BT>(r, s, wgi, d);
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<1>();
    fence_acc(d);
    if (t > 0 && (ctid & 127) == 0) bar_arrive(r.empty((t - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(d);
}

// Tile row and column of accumulator element pair (4j + 2h, 4j + 2h + 1)
// of consumer thread ctid: rows r0 + 8h, columns c0 + 8j and c0 + 8j + 1.
__device__ __forceinline__ void acc_origin(int ctid, int& r0, int& c0) {
  const int t = ctid & 127;
  r0 = (ctid >> 7) * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  c0 = (t & 3) * 2;
}

// Write both consumer warpgroups' accumulators into the f32 tile (row pitch
// EPI_LD) in the ring's first stages, once every wgmma of the block has read
// its last stage; the tile is complete when this returns.
__device__ __forceinline__ float* stage_acc(const Ring& r, int ctid, const float (&d)[64]) {
  float* tile = reinterpret_cast<float*>(r.a(0));
  int r0, c0;
  acc_origin(ctid, r0, c0);
  consumers_sync();
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * EPI_LD + c0 + 8 * j) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  consumers_sync();
  return tile;
}

}  // namespace wg
