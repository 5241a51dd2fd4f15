// write_diag_blocks: a (count, s, s) stack W onto the diagonal blocks
// out[i·s:(i+1)·s, i·s:(i+1)·s] of a square row-major buffer, in place,
// cast to out's dtype.  Every other element of out is left untouched.
//
// Replaces capital_tpu/ops/pallas_tpu.py:write_diag_blocks (:530, the
// pallas_call at :560), the rectri batched prefix's write-back
// (models/inverse.py, RT::batch_write).
//
// What bounds it on the card: bytes — W read once, count·s² elements of
// out written once, no arithmetic.  At the rectri flagship (96 blocks of
// 512² bf16 into a 49152² buffer) that is 100 MB, 0.030 ms at 3.35 TB/s.
// The TPU kernel's 128-lane block shape and its copy-chain fallback for
// other s do not carry over: any s works.  Two routes, picked in Python
// (ops/hopper.py:write_diag_route) and passed as a route code:
//
// * 'vec' (1): every thread moves 16-byte vectors of W (8 bf16, 4 f32 or
//   2 f64 values), converts them in registers and stores the matching
//   width of out (4 to 64 bytes, in 16-byte pieces at most).  A thread
//   loads VEC_UNROLL vectors before its first store, and blockIdx.x takes a
//   band of rows holding about THREADS·VEC_UNROLL vectors, so an SM keeps
//   tens of KB in flight against HBM's latency with one load / store
//   instruction per 16 bytes.  Taken only where every access is aligned:
//   W's base 16-byte aligned, s a multiple of the vector width, and out's
//   base and row stride aligned to the store width (16 bytes at most).
// * 'elem' (0): the first port's kernel, any s and any alignment —
//   blockIdx.x a band of ROWS rows, the threads of a block walking along a
//   row one element at a time.
//
// Both convert with the same Cast<To>::from, so they write the same bits.

#include "common.cuh"

constexpr int ROWS = 8;
constexpr int THREADS = 256;
constexpr int VEC_UNROLL = 4;

enum Route : int { ROUTE_ELEM = 0, ROUTE_VEC = 1 };

template <typename Tw, typename To>
__global__ void __launch_bounds__(THREADS) write_diag_kernel(const Tw* W, To* out, long long ldo, int s) {
  const long long b = blockIdx.y;
  const Tw* w = W + b * s * s;
  To* o = out + b * s * ldo + b * s;
  const int r1 = min(s, (int)(blockIdx.x + 1) * ROWS);
  for (int r = blockIdx.x * ROWS; r < r1; ++r) {
    for (int c = threadIdx.x; c < s; c += THREADS) o[r * ldo + c] = Cast<To>::from(w[(long long)r * s + c]);
  }
}

// 16 bytes of W (the 'vec' route's loads)
__device__ __forceinline__ uint4 ld_vec(const void* p) { return *reinterpret_cast<const uint4*>(p); }

// one vector of W (V = 16 / sizeof(Tw) values), cast, onto out at p: one
// 4- or 8-byte store, or 16-byte stores
template <typename Tw, typename To>
__device__ __forceinline__ void store_cast(To* p, uint4 raw) {
  constexpr int V = 16 / sizeof(Tw), OB = V * sizeof(To);
  const Tw* x = reinterpret_cast<const Tw*>(&raw);
  alignas(16) To y[V];
#pragma unroll
  for (int j = 0; j < V; ++j) y[j] = Cast<To>::from(x[j]);
  if constexpr (OB >= 16) {
#pragma unroll
    for (int j = 0; j < OB / 16; ++j) reinterpret_cast<uint4*>(p)[j] = reinterpret_cast<const uint4*>(y)[j];
  } else if constexpr (OB == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(y);
  } else {
    *reinterpret_cast<unsigned*>(p) = *reinterpret_cast<const unsigned*>(y);
  }
}

// blockIdx.y = block of W, blockIdx.x = a band of `band` rows of it; vr =
// s / V vectors a row.  Vector e of the band is row e / vr, column vector
// e % vr: consecutive threads touch consecutive 16-byte pieces of a row.
template <typename Tw, typename To>
__global__ void __launch_bounds__(THREADS) write_diag_vec_kernel(const Tw* W, To* out, long long ldo, int s,
                                                                 int vr, int band) {
  constexpr int V = 16 / sizeof(Tw);
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * band;
  const int nv = min(band, s - r0) * vr;  // vectors in this band
  const Tw* w = W + b * s * s + (long long)r0 * s;
  To* o = out + (b * s + r0) * ldo + b * s;
  for (int e0 = threadIdx.x; e0 < nv; e0 += THREADS * VEC_UNROLL) {
    uint4 raw[VEC_UNROLL];
#pragma unroll
    for (int u = 0; u < VEC_UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < nv) raw[u] = ld_vec(w + (long long)e * V);  // W's band is contiguous
    }
#pragma unroll
    for (int u = 0; u < VEC_UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < nv) {
        const int r = e / vr, c = (e - r * vr) * V;
        store_cast<Tw, To>(o + r * ldo + c, raw[u]);
      }
    }
  }
}

template <typename Tw, typename To>
static int launch(const void* W, void* out, long long ldo, int count, int s, int route, void* stream) {
  if (route == ROUTE_ELEM) {
    const dim3 grid((s + ROWS - 1) / ROWS, count);
    write_diag_kernel<Tw, To><<<grid, THREADS, 0, (cudaStream_t)stream>>>((const Tw*)W, (To*)out, ldo, s);
    return (int)cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(Tw), A = V * sizeof(To) < 16 ? V * sizeof(To) : 16;
  if (route != ROUTE_VEC || s % V || (uintptr_t)W % 16 || (uintptr_t)out % A || ldo * sizeof(To) % A) return -1;
  const int vr = s / V, band = max(1, THREADS * VEC_UNROLL / vr);
  const dim3 grid((s + band - 1) / band, count);
  write_diag_vec_kernel<Tw, To><<<grid, THREADS, 0, (cudaStream_t)stream>>>((const Tw*)W, (To*)out, ldo, s, vr,
                                                                             band);
  return (int)cudaGetLastError();
}

template <typename Tw>
static int by_out(int dt_out, const void* W, void* out, long long ldo, int count, int s, int route,
                  void* stream) {
  if (dt_out == DT_BF16) return launch<Tw, bf16>(W, out, ldo, count, s, route, stream);
  if (dt_out == DT_F32) return launch<Tw, float>(W, out, ldo, count, s, route, stream);
  if (dt_out == DT_F64) return launch<Tw, double>(W, out, ldo, count, s, route, stream);
  return -1;
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take (a 'vec' launch whose accesses would not all be
// aligned among them).  W is a contiguous (count, s, s) stack; out a
// row-major buffer with leading dimension ldo; route 0 'elem', 1 'vec'.
extern "C" int capital_write_diag(int dt_w, int dt_out, const void* W, void* out, long long ldo, int count,
                                  int s, int route, void* stream) {
  if (count < 1 || count > 65535 || s < 1) return -1;
  if (dt_w == DT_BF16) return by_out<bf16>(dt_out, W, out, ldo, count, s, route, stream);
  if (dt_w == DT_F32) return by_out<float>(dt_out, W, out, ldo, count, s, route, stream);
  if (dt_w == DT_F64) return by_out<double>(dt_out, W, out, ldo, count, s, route, stream);
  return -1;
}
