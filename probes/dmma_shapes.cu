// Which f64 mma.sync shapes ptxas takes for sm_90a, whether the fragment
// layouts that csrc/mm_tiles.cuh's DMMA loop assumes are right, and each
// shape's rate on the card (8 independent accumulators a warp, no loads).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/dmma_shapes probes/dmma_shapes.cu && build/dmma_shapes
//
// Prints one JSON line per shape: "bad" counts wrong elements of one
// 16 x 8 (8 x 8) product of small integers (exact in f64), "tflops" the
// rate of 1056 blocks of 4 warps.
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

// layouts assumed:
//  m8n8k4 : a (g, t); b (t, g); c (g, 2t+i)
//  m16n8kK: a_i (g + 8*(i%2), t + 4*(i/2)); b_i (t + 4*i, g); c_i (g + 8*(i/2), 2t + i%2)
__device__ __forceinline__ void mma_m8n8k4(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma_k4(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma_k8(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma_k16(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int KS>
__device__ __forceinline__ void mma16(double* c, const double* a, const double* b) {
  if (KS == 4) mma_k4(c, a, b);
  else if (KS == 8) mma_k8(c, a, b);
  else mma_k16(c, a, b);
}

// one warp: D (16 x 8) = A (16 x KS, row-major) B (KS x 8, row-major)
template <int KS>
__global__ void layout16(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[KS / 2], b[KS / 4], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < KS / 2; ++i) a[i] = A[(g + 8 * (i % 2)) * KS + t + 4 * (i / 2)];
  for (int i = 0; i < KS / 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  mma16<KS>(c, a, b);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = c[i];
}

__global__ void layout8(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[1] = {A[g * 4 + t]}, b[1] = {B[t * 8 + g]}, c[2] = {0, 0};
  mma_m8n8k4(c, a, b);
  for (int i = 0; i < 2; ++i) D[g * 8 + 2 * t + i] = c[i];
}

// rate: each warp runs iters x 8 independent MMAs on registers
template <int KS>
__global__ void rate16(double* out, int iters) {
  double a[KS / 2], b[KS / 4], c[8][4];
  for (int i = 0; i < KS / 2; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < KS / 4; ++i) b[i] = 1.0 - threadIdx.x * 1e-3 + i;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) c[j][i] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma16<KS>(c[j], a, b);
  double s = 0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += c[j][i];
  if (s == 12345.0) out[0] = s;
}

__global__ void rate8(double* out, int iters) {
  double a[1] = {1.0 + threadIdx.x * 1e-3}, b[1] = {1.0 - threadIdx.x * 1e-3}, c[8][2];
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_m8n8k4(c[j], a, b);
  double s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1];
  if (s == 12345.0) out[0] = s;
}

static int check(const char* name, int M, int N, int K, void (*launch)(const double*, const double*, double*)) {
  double *hA = (double*)malloc(M * K * 8), *hB = (double*)malloc(K * N * 8), *hD = (double*)malloc(M * N * 8);
  for (int i = 0; i < M * K; ++i) hA[i] = (i * 7 + 3) % 11 - 5;
  for (int i = 0; i < K * N; ++i) hB[i] = (i * 5 + 1) % 13 - 6;
  double *dA, *dB, *dD;
  cudaMalloc(&dA, M * K * 8); cudaMalloc(&dB, K * N * 8); cudaMalloc(&dD, M * N * 8);
  cudaMemcpy(dA, hA, M * K * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, K * N * 8, cudaMemcpyHostToDevice);
  cudaMemset(dD, 0, M * N * 8);
  launch(dA, dB, dD);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hD, dD, M * N * 8, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < N; ++j) {
      double s = 0;
      for (int k = 0; k < K; ++k) s += hA[i * K + k] * hB[k * N + j];
      if (s != hD[i * N + j]) ++bad;
    }
  printf("{\"probe\": \"layout\", \"shape\": \"%s\", \"err\": \"%s\", \"bad\": %d}\n", name, cudaGetErrorString(e), bad);
  cudaFree(dA); cudaFree(dB); cudaFree(dD);
  free(hA); free(hB); free(hD);
  return bad;
}

template <class F>
static void rate(const char* name, F kern, double flops_per_mma) {
  double* out;
  cudaMalloc(&out, 8);
  int blocks = 132 * 8, threads = 128, iters = 4096;
  kern<<<blocks, threads>>>(out, 16);
  cudaDeviceSynchronize();
  cudaEvent_t s, t;
  cudaEventCreate(&s); cudaEventCreate(&t);
  cudaEventRecord(s);
  kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(t);
  cudaEventSynchronize(t);
  float ms;
  cudaEventElapsedTime(&ms, s, t);
  double flops = (double)blocks * (threads / 32) * iters * 8 * flops_per_mma;
  printf("{\"probe\": \"rate\", \"shape\": \"%s\", \"ms\": %.4f, \"tflops\": %.2f, \"err\": \"%s\"}\n", name, ms,
         flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  check("m8n8k4", 8, 8, 4, [](const double* A, const double* B, double* D) { layout8<<<1, 32>>>(A, B, D); });
  check("m16n8k4", 16, 8, 4, [](const double* A, const double* B, double* D) { layout16<4><<<1, 32>>>(A, B, D); });
  check("m16n8k8", 16, 8, 8, [](const double* A, const double* B, double* D) { layout16<8><<<1, 32>>>(A, B, D); });
  check("m16n8k16", 16, 8, 16, [](const double* A, const double* B, double* D) { layout16<16><<<1, 32>>>(A, B, D); });
  rate("m8n8k4", rate8, 2.0 * 8 * 8 * 4);
  rate("m16n8k4", rate16<4>, 2.0 * 16 * 8 * 4);
  rate("m16n8k8", rate16<8>, 2.0 * 16 * 8 * 8);
  rate("m16n8k16", rate16<16>, 2.0 * 16 * 8 * 16);
  return 0;
}
