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
// What the design does about it: blockIdx.y picks the block, blockIdx.x a
// band of ROWS rows; the threads of a block walk along a row, so reads of W
// and writes of out are both contiguous runs of s elements.  The TPU
// kernel's 128-lane block shape and its copy-chain fallback for other s do
// not carry over: any s works.

#include "common.cuh"

constexpr int ROWS = 8;
constexpr int THREADS = 256;

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

template <typename Tw, typename To>
static int launch(const void* W, void* out, long long ldo, int count, int s, void* stream) {
  const dim3 grid((s + ROWS - 1) / ROWS, count);
  write_diag_kernel<Tw, To><<<grid, THREADS, 0, (cudaStream_t)stream>>>((const Tw*)W, (To*)out, ldo, s);
  return (int)cudaGetLastError();
}

template <typename Tw>
static int by_out(int dt_out, const void* W, void* out, long long ldo, int count, int s, void* stream) {
  if (dt_out == DT_BF16) return launch<Tw, bf16>(W, out, ldo, count, s, stream);
  if (dt_out == DT_F32) return launch<Tw, float>(W, out, ldo, count, s, stream);
  if (dt_out == DT_F64) return launch<Tw, double>(W, out, ldo, count, s, stream);
  return -1;
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  W is a contiguous (count, s, s) stack; out a
// row-major buffer with leading dimension ldo.
extern "C" int capital_write_diag(int dt_w, int dt_out, const void* W, void* out, long long ldo, int count,
                                  int s, void* stream) {
  if (count < 1 || count > 65535 || s < 1) return -1;
  if (dt_w == DT_BF16) return by_out<bf16>(dt_out, W, out, ldo, count, s, stream);
  if (dt_w == DT_F32) return by_out<float>(dt_out, W, out, ldo, count, s, stream);
  if (dt_w == DT_F64) return by_out<double>(dt_out, W, out, ldo, count, s, stream);
  return -1;
}
