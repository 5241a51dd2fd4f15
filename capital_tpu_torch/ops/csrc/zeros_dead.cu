// zeros_dead_lower: zero only the strictly-lower tile blocks (or the
// strictly-upper ones) of a p x p row-major buffer, plus `extra` element
// windows; every other tile is left unwritten.
//
// Replaces capital_tpu/ops/pallas_tpu.py:zeros_dead_lower.  cholinv's R and
// R⁻¹ buffers come from torch.empty: the recursion writes every live upper
// tile exactly once, so only the dead half (and, with complete_inv=False,
// the skipped top-right window of R⁻¹) needs zeros — half the traffic of
// filling the whole buffer.
// What bounds it on the card: bytes (a pure store stream).  The design:
// one block per tile, 16-byte stores along each row where the row segment
// is 16-byte aligned, element stores otherwise.  Zero has the same bit
// pattern in bf16, f32 and f64, so the kernel works on bytes.

#include "common.cuh"

constexpr int MAX_EXTRA = 8;

struct ZD {
  char* buf;
  long long p;      // buffer edge, elements
  long long ld;     // leading dimension, elements
  int elem;         // element size, bytes
  int tile;         // tile edge, elements
  int dead_upper;   // 0: strictly-lower tiles, 1: strictly-upper tiles
  int n_extra;
  long long extra[MAX_EXTRA][4];  // (r0, c0, rows, cols) element windows
};

// zero rows [r0, r1) x cols [c0, c1) (elements), clipped to the buffer
__device__ void zero_rect(const ZD& z, long long r0, long long r1, long long c0, long long c1) {
  r1 = min(r1, z.p);
  c1 = min(c1, z.p);
  if (r0 >= r1 || c0 >= c1) return;
  const long long rows = r1 - r0, bytes = (c1 - c0) * z.elem;
  const long long ld_bytes = z.ld * z.elem;
  const long long start = r0 * ld_bytes + c0 * z.elem;
  const bool vec = ((uintptr_t)(z.buf + start) % 16 == 0) && (ld_bytes % 16 == 0) && (bytes % 16 == 0);
  if (vec) {
    const long long per_row = bytes / 16;
    for (long long e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      long long r = e / per_row, v = e % per_row;
      reinterpret_cast<uint4*>(z.buf + start + r * ld_bytes)[v] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (long long e = threadIdx.x; e < rows * bytes; e += blockDim.x) {
      long long r = e / bytes, b = e % bytes;
      z.buf[start + r * ld_bytes + b] = 0;
    }
  }
}

// grid (nt, nt, 1 + n_extra): z-slice 0 zeroes the dead tiles, slice e + 1
// zeroes the part of extra window e that falls in tile (blockIdx.y, blockIdx.x)
__global__ void __launch_bounds__(256) zeros_dead_kernel(ZD z) {
  const long long ti = blockIdx.y, tj = blockIdx.x, t = z.tile;
  const long long r0 = ti * t, c0 = tj * t;
  if (blockIdx.z == 0) {
    bool dead = z.dead_upper ? ti < tj : ti > tj;
    if (dead) zero_rect(z, r0, r0 + t, c0, c0 + t);
    return;
  }
  const long long* w = z.extra[blockIdx.z - 1];
  zero_rect(z, max(r0, w[0]), min(r0 + t, w[0] + w[2]), max(c0, w[1]), min(c0 + t, w[1] + w[3]));
}

// Returns the cudaError_t of the launch (0 = launched); -1 for bad arguments.
// extra: n_extra rows of (r0, c0, rows, cols).
extern "C" int capital_zeros_dead(void* buf, long long p, long long ld, int elem, int tile,
                                  int dead_upper, const long long* extra, int n_extra,
                                  void* stream) {
  if (tile < 1 || n_extra < 0 || n_extra > MAX_EXTRA || p < 1) return -1;
  ZD z;
  z.buf = (char*)buf;
  z.p = p;
  z.ld = ld;
  z.elem = elem;
  z.tile = tile;
  z.dead_upper = dead_upper;
  z.n_extra = n_extra;
  for (int e = 0; e < n_extra; ++e)
    for (int q = 0; q < 4; ++q) z.extra[e][q] = extra[4 * e + q];
  const long long nt = (p + tile - 1) / tile;
  if (nt > 65535) return -1;
  dim3 grid((unsigned)nt, (unsigned)nt, 1 + n_extra);
  zeros_dead_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(z);
  return (int)cudaGetLastError();
}
