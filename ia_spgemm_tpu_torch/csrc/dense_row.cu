// Dense-row accumulator SpGEMM kernel for Hopper (sm_90a), plain C ABI.
//
//   K11 ia_k11_dense_row  <- ia_spgemm_tpu/ops/dense_row.py:35 _kernel
//
// C = A @ B with A in ELL and B dense: every output row is a dense
// accumulator, acc[r, :] += a_val[r, kk] * B[a_col[r, kk], :] over the
// row's ELL slots in order, empty slots (a_col < 0) skipped. The TPU
// kernel kept a (tile_rows, n) accumulator in VMEM and double-buffered
// aligned 8-row groups of B by DMA; n up to 64K floats is 256 KB, more
// than an SM's shared memory, so here the grid is (row, 1024-column
// chunk) and each thread keeps 4 accumulators in registers, reading its
// columns of B's rows coalesced from global memory.
//
// What bounds it on this card: bytes. Each (row, chunk) block reads its
// row's K slot columns once (a broadcast load) and K rows x 4 KB of B,
// and writes 4 KB of C: about 4*K*n bytes of B per output row, served
// from device memory or L2 (B's rows are shared between output rows),
// against 2*K*n flops. The multiply and the add round separately
// (__fmul_rn, __fadd_rn), as the plain version does, so the two agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

__global__ void k11_dense_row(const int32_t* __restrict__ a_col,
                              const float* __restrict__ a_val,
                              const float* __restrict__ b,
                              float* __restrict__ out, int K, int n) {
  const size_t row = blockIdx.x;
  const int c0 = blockIdx.y * kChunk + threadIdx.x;
  float acc[kPerThread];
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) acc[t] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const int col = a_col[row * K + kk];
    if (col < 0) continue;
    const float v = a_val[row * K + kk];
    const float* brow = b + (size_t)col * n;
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int c = c0 + t * kThreads;
      if (c < n) acc[t] = __fadd_rn(acc[t], __fmul_rn(v, __ldg(brow + c)));
    }
  }
  float* orow = out + row * n;
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int c = c0 + t * kThreads;
    if (c < n) orow[c] = acc[t];
  }
}

}  // namespace

// Launches on `stream` (of the current device), does not synchronise,
// returns cudaGetLastError() (0 on success). a_col/a_val (m, K), b (k, n),
// out (m, n), all row-major; every a_col entry is -1 or a row of b.
extern "C" int ia_k11_dense_row(const void* a_col, const void* a_val,
                                const void* b, void* out, int m, int K,
                                int n, void* stream) {
  dim3 grid(m, (n + kChunk - 1) / kChunk);
  k11_dense_row<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_col, (const float*)a_val, (const float*)b,
      (float*)out, K, n);
  return (int)cudaGetLastError();
}
