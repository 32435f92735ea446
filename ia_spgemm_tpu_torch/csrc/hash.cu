// Hash-accumulator SpGEMM kernel for Hopper (sm_90a), plain C ABI.
//
//   K12 ia_k12_hash  <- ia_spgemm_tpu/ops/hash_spgemm.py:58 _kernel
//
// C = A @ B with both operands ELL: one open-addressing table of H slots
// per output row (Knuth multiply-shift hash, linear probe), whose slots
// and per-row count of distinct columns are the output. The TPU kernel
// probed scalar SMEM tables one product at a time and streamed B's rows
// by double-buffered DMA; here one thread block owns one output row, its
// table in shared memory (8*H bytes: 16 KB at H = 2048), and the block's
// threads insert the row's Ka*Kb products in parallel: a slot is claimed
// by atomicCAS from -1 (the winner counts the column, numeric zeros
// included, as the TPU kernel does), values add with shared-memory
// atomicAdd, and a probe stops at the matching column or an empty slot.
// Parallel inserts place colliding columns in other slots and sum each
// column in another order than the TPU's sequential probe: the slot order
// is not the JAX package's, the set of (column, sum) per row is.
//
// What bounds it: shared-memory atomics and the write of the (m, H)
// tables (8*H bytes per row, most of them empty); B's rows are read with
// Kb-wide strides. The caller guarantees H >= the row's distinct columns
// (ops/hash_kernels.py checks H >= min(ncols, Ka*Kb)); a probe still
// stops after H slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void k12_hash(const int32_t* __restrict__ a_col,
                         const float* __restrict__ a_val,
                         const int32_t* __restrict__ b_col,
                         const float* __restrict__ b_val,
                         int* __restrict__ out_col,
                         float* __restrict__ out_val, int* __restrict__ nnz,
                         int Ka, int Kb, int H) {
  extern __shared__ int smem[];
  int* tcol = smem;
  float* tval = reinterpret_cast<float*>(smem + H);
  int* count = smem + 2 * H;
  const size_t row = blockIdx.x;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    tcol[h] = -1;
    tval[h] = 0.f;
  }
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  const int total = Ka * Kb;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int ka = p / Kb;
    const int acol = a_col[row * Ka + ka];
    if (acol < 0) continue;
    const size_t bi = (size_t)acol * Kb + (p - ka * Kb);
    const int j = b_col[bi];
    if (j < 0) continue;
    const float v = __fmul_rn(a_val[row * Ka + ka], b_val[bi]);
    // the JAX package's hash on int32 (wrapping multiply), on uint32
    uint32_t h = (((uint32_t)j * 2654435761u) & 0x7FFFFFFFu) % (uint32_t)H;
    for (int probe = 0; probe < H; ++probe) {
      int cur = ((volatile int*)tcol)[h];
      if (cur == -1) {
        cur = atomicCAS(&tcol[h], -1, j);
        if (cur == -1) {
          atomicAdd(count, 1);
          atomicAdd(&tval[h], v);
          break;
        }
      }
      if (cur == j) {
        atomicAdd(&tval[h], v);
        break;
      }
      h = h + 1 == (uint32_t)H ? 0 : h + 1;
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    out_col[row * H + h] = tcol[h];
    out_val[row * H + h] = tval[h];
  }
  if (threadIdx.x == 0) nnz[row] = *count;
}

int smem_limit_set[kMaxDevices];   // bytes allowed so far, per device

}  // namespace

// Launches on `stream` (of the current device), does not synchronise,
// returns cudaGetLastError() (0 on success). a_col/a_val (m, Ka), b_col/
// b_val (k, Kb), out_col/out_val (m, H), nnz (m,), all row-major.
extern "C" int ia_k12_hash(const void* a_col, const void* a_val,
                           const void* b_col, const void* b_val,
                           void* out_col, void* out_val, void* nnz, int m,
                           int Ka, int Kb, int H, void* stream) {
  const size_t smem = (size_t)(2 * H + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if ((size_t)smem_limit_set[dev] < smem) {
      err = cudaFuncSetAttribute(
          k12_hash, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      smem_limit_set[dev] = (int)smem;
    }
  }
  k12_hash<<<m, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a_col, (const float*)a_val, (const int32_t*)b_col,
      (const float*)b_val, (int*)out_col, (float*)out_val, (int*)nnz, Ka, Kb,
      H);
  return (int)cudaGetLastError();
}
