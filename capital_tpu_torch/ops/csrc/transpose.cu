// transpose / transpose_pair: the transpose of a window of a row-major
// buffer, optionally masked to one triangle of the result (dead half
// written as zero whatever the input holds), cast in the kernel, and
// written in place into a window of the output buffer.
//
// Replaces capital_tpu/ops/pallas_tpu.py:transpose and :transpose_pair.
// cholinv uses them at every leaf: to read the bc x bc window as the f32
// lower panel the factorization wants, and to write triu(Lᵀ) / triu(Linvᵀ)
// back into the R / R⁻¹ buffers (the pair does both streams in one launch,
// blockIdx.z choosing the stream, with per-element arithmetic identical to
// two `transpose` calls, so the results are bitwise equal).
// What bounds it on the card: bytes (one read, one write per element, no
// arithmetic).  The design: 32 x 32 tiles staged through padded shared
// memory so that both the read and the write are coalesced rows, and an
// output tile that lies wholly in the masked-off half is written as zeros
// without reading its input.

#include "common.cuh"

constexpr int TT = 32;  // tile edge
constexpr int TR = 8;   // rows of threads; each thread moves TT / TR elements

template <typename Tin, typename Tout>
__device__ __forceinline__ void transpose_tile(const Tin* X, long long ldx, Tout* O,
                                               long long ldo, int m, int n, int uplo) {
  // output is n x m: O(i, j) = X(j, i); output tile rows [oi0, +TT), cols [oj0, +TT)
  __shared__ Tin tile[TT][TT + 1];
  const int oi0 = blockIdx.x * TT, oj0 = blockIdx.y * TT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // wholly dead under the mask: 'U' keeps i <= j, 'L' keeps i >= j
  bool dead = (uplo == UPLO_U && oi0 > oj0 + TT - 1) || (uplo == UPLO_L && oi0 + TT - 1 < oj0);
  if (!dead) {
    for (int y = ty; y < TT; y += TR) {
      int r = oj0 + y, c = oi0 + tx;  // X row = output col, X col = output row
      if (r < m && c < n) tile[y][tx] = X[(long long)r * ldx + c];
    }
  }
  __syncthreads();
  for (int y = ty; y < TT; y += TR) {
    int i = oi0 + y, j = oj0 + tx;
    if (i < n && j < m) {
      Tout v = zero_of<Tout>();
      if (!dead && in_tri(uplo, i, j)) v = Cast<Tout>::from(tile[tx][y]);
      O[(long long)i * ldo + j] = v;
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(TT * TR) transpose_kernel(const Tin* X, long long ldx, Tout* O,
                                                            long long ldo, int m, int n, int uplo) {
  transpose_tile<Tin, Tout>(X, ldx, O, ldo, m, n, uplo);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(TT * TR) transpose_pair_kernel(const Tin* L, const Tin* Linv,
                                                                 long long ldi, Tout* R, Tout* RI,
                                                                 long long ldo, int n) {
  if (blockIdx.z == 0) transpose_tile<Tin, Tout>(L, ldi, R, ldo, n, n, UPLO_U);
  else transpose_tile<Tin, Tout>(Linv, ldi, RI, ldo, n, n, UPLO_U);
}

template <typename Tin, typename Tout>
static void launch_one(const void* X, long long ldx, void* O, long long ldo, int m, int n,
                       int uplo, cudaStream_t s) {
  dim3 grid((n + TT - 1) / TT, (m + TT - 1) / TT), block(TT, TR);
  transpose_kernel<Tin, Tout><<<grid, block, 0, s>>>((const Tin*)X, ldx, (Tout*)O, ldo, m, n, uplo);
}

template <typename Tin, typename Tout>
static void launch_pair(const void* L, const void* Linv, long long ldi, void* R, void* RI,
                        long long ldo, int n, cudaStream_t s) {
  dim3 grid((n + TT - 1) / TT, (n + TT - 1) / TT, 2), block(TT, TR);
  transpose_pair_kernel<Tin, Tout>
      <<<grid, block, 0, s>>>((const Tin*)L, (const Tin*)Linv, ldi, (Tout*)R, (Tout*)RI, ldo, n);
}

#define CAPITAL_DT_CASES(TIN, CALL)                 \
  switch (out_dtype) {                              \
    case DT_BF16: CALL(TIN, bf16); break;           \
    case DT_F32: CALL(TIN, float); break;           \
    case DT_F64: CALL(TIN, double); break;          \
    default: return -1;                             \
  }

#define CAPITAL_DISPATCH(CALL)                                   \
  switch (in_dtype) {                                            \
    case DT_BF16: CAPITAL_DT_CASES(bf16, CALL); break;           \
    case DT_F32: CAPITAL_DT_CASES(float, CALL); break;           \
    case DT_F64: CAPITAL_DT_CASES(double, CALL); break;          \
    default: return -1;                                          \
  }

// X: the m x n input window; O: the n x m output window.
// Returns the cudaError_t of the launch (0 = launched); -1 for a bad dtype.
extern "C" int capital_transpose(int in_dtype, int out_dtype, const void* X, long long ldx,
                                 void* O, long long ldo, int m, int n, int uplo, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL_ONE(A, B) launch_one<A, B>(X, ldx, O, ldo, m, n, uplo, s)
  CAPITAL_DISPATCH(CALL_ONE)
#undef CALL_ONE
  return (int)cudaGetLastError();
}

// L, Linv: n x n inputs (leading dimension ldi); R, RI: the n x n output
// windows (leading dimension ldo), each receiving triu of its input's
// transpose.
extern "C" int capital_transpose_pair(int in_dtype, int out_dtype, const void* L,
                                      const void* Linv, long long ldi, void* R, void* RI,
                                      long long ldo, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL_PAIR(A, B) launch_pair<A, B>(L, Linv, ldi, R, RI, ldo, n, s)
  CAPITAL_DISPATCH(CALL_PAIR)
#undef CALL_PAIR
  return (int)cudaGetLastError();
}
