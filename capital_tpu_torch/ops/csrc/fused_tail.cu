// fused_tail: a whole cholinv recursion subtree in one launch — read the
// (n, n) window of buf (upper triangle valid), symmetrise it, factor it
// A = RᵀR by the column sweep, invert R by back-substituting the identity,
// and write triu(R) and triu(R⁻¹) into windows of Rp and RIp in place,
// with the potrf-convention info in a device int32.
//
// Replaces capital_tpu/ops/pallas_tpu.py:fused_tail (:751, the pallas_call
// at :827), cholinv's opt-in tail (models/cholesky.py, CI::tail_fused).
// Its arithmetic is that of the batched small-N kernels: chol_sweep and
// bwd_sweep of batched_small.cuh, the device functions of the JAX
// kernel's _chol and _bwd_solve.
//
// What bounds it on the card: the dependent column sweep.  One block owns
// the window; the factor and the inverse stay in shared memory between
// the phases (no device-memory round trip between potrf, trsm, syrk and
// trmm, which is what fusing buys), and the n columns of the factor and
// then of the back-substitution each cost one or two block barriers.  The
// bytes (the window read once, two windows written once) and the useful
// flops (n³/3 + n³/3) are small next to that.
//
// Shared memory (f32): the symmetrised window with an odd leading
// dimension ld = odd_ld(n), then the n x n identity that becomes R⁻¹:
// 4·(n·ld + n²) bytes, which reaches n = 169 in the 227 KB of one block
// (capital_tpu_torch/ops/hopper.tail_eligible).  The cholinv gate
// (_tail_fusible) wants n % 128 == 0, so n = 128 windows fuse on the card.

#include "batched_small.cuh"

using namespace small;

constexpr size_t SMEM_MAX = 232448 - 1024;

template <typename T>
__global__ void __launch_bounds__(NT) fused_tail_kernel(const T* buf, long long ldb, T* rp, T* rip, long long ldr,
                                                        int* info, int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* S = smem;          // the symmetrised window, then L (R = Lᵀ) in its lower triangle
  float* Y = smem + n * ld;  // I, then R⁻¹
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (c >= r) {  // the upper half, read along rows, mirrored
      const float v = widen(buf[r * ldb + c]);
      S[r * ld + c] = v;
      S[c * ld + r] = v;
    }
    Y[e] = (r == c) ? 1.f : 0.f;
  }
  __syncthreads();
  const int inf = chol_sweep(S, ld, n);
  bwd_sweep(S, ld, false, Y, n, n, n);  // R·X = I, R = Lᵀ
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    const bool up = c >= r;
    rp[r * ldr + c] = Cast<T>::from(up ? S[c * ld + r] : 0.f);
    rip[r * ldr + c] = Cast<T>::from(up ? Y[e] : 0.f);
  }
  if (threadIdx.x == 0) *info = inf;
}

template <typename T>
static int launch(const void* buf, long long ldb, void* rp, void* rip, long long ldr, void* info, int n,
                  void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n * odd_ld(n) + (size_t)n * n);
  if (smem > SMEM_MAX) return -1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(fused_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  fused_tail_kernel<T><<<1, NT, smem, (cudaStream_t)stream>>>((const T*)buf, ldb, (T*)rp, (T*)rip, ldr, (int*)info,
                                                               n);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched), -1 for arguments
// the kernel does not take.  buf, rp and rip point at the windows' first
// element; rp and rip share the leading dimension ldr.
extern "C" int capital_fused_tail(int dtype, const void* buf, long long ldb, void* rp, void* rip, long long ldr,
                                  void* info, int n, void* stream) {
  if (n < 1) return -1;
  if (dtype == DT_F32) return launch<float>(buf, ldb, rp, rip, ldr, info, n, stream);
  if (dtype == DT_BF16) return launch<bf16>(buf, ldb, rp, rip, ldr, info, n, stream);
  return -1;
}
