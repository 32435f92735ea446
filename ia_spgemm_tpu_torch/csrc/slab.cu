// Slab-engine SpGEMM kernels for Hopper (sm_90a), plain C ABI.
//
// Counterparts of the Pallas kernels in ia_spgemm_tpu/ops/slab.py:
//   K8  ia_k8_expand_sort_lr     <- _expand_sort_kernel_lr    (:99)
//   K9  ia_k9_expand_sort_lr_dd  <- _expand_sort_kernel_lr_dd (:306)
//   K10 ia_k10_compress_dd       <- _compress_kernel_t_dd     (:369)
//
// The slab engine packs whole C rows back to back into one sort of
// `width` (512 or 1024) slots, keyed local_row * n + col, so one bitonic
// network sorts every row of the slab and duplicates of one (row, col)
// land adjacent. One thread block owns one slab and keeps its keys and
// values in shared memory (8 or 12 bytes a slot: at most 12 KB), between
// one read of the slab's fragment gather and one write of the result.
//
// K8 is K2's body (bitonic.cu) with slab-local row keys; its float32 sums
// are compressed by K3. The TPU's compensated pipeline formed each
// product as a Dekker (hi, lo) pair and summed runs by two-sum, because
// the TPU has no float64; this card has it, so K9 forms the exact product
// (double)a * (double)b (two 24-bit mantissas fit 53 bits) and sorts
// (key, double) pairs, and K10 sums each duplicate run in float64 and
// writes hi = f32(s), lo = f32(s - hi). No float32 error-free
// transformation is left for FMA contraction to break.
//
// What bounds them: as for K2, the sort's log2(w)*(log2(w)+1)/2 barrier-
// separated shared-memory passes (w/2 threads per block), not device
// memory; K9 and K10 move 12 bytes a slot instead of 8. Faster forms
// (fusing the gather into K8, fusing K8 with K3, several slabs a block)
// are later work.
//
// A slab's fragment slot e takes the reversed half of its fragment when
// e is odd (the JAX rule), so the slab arrives as alternating sorted runs
// of length `run` and the sort starts merging at start_kk = 2 * run.
// Empty slab columns (padding up to S) gather the table's all -1 fill
// row and come out with nnz 0.

#include "sort_common.cuh"

namespace {

__global__ void k8_expand_sort_lr(const int32_t* __restrict__ g,
                                  const float* __restrict__ avT,
                                  const int32_t* __restrict__ lrT,
                                  int* __restrict__ out_k,
                                  float* __restrict__ out_v, int S, int ka,
                                  int lanes, int run, int width, int n,
                                  int start_kk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* k = reinterpret_cast<int*>(smem_raw);
  float* v = reinterpret_cast<float*>(k + width);
  const int s = blockIdx.x;
  expand_row<float, true>(g, avT, lrT, n, k, v, s, S, ka, lanes, run, 1,
                          width);
  block_sort(k, v, width, start_kk);
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    out_k[(size_t)s * width + p] = k[p];
    out_v[(size_t)s * width + p] = v[p];
  }
}

__global__ void k9_expand_sort_lr_dd(const int32_t* __restrict__ g,
                                     const float* __restrict__ avT,
                                     const int32_t* __restrict__ lrT,
                                     int* __restrict__ out_k,
                                     double* __restrict__ out_v, int S,
                                     int ka, int lanes, int run, int width,
                                     int n, int start_kk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* v = reinterpret_cast<double*>(smem_raw);
  int* k = reinterpret_cast<int*>(v + width);
  const int s = blockIdx.x;
  expand_row<double, true>(g, avT, lrT, n, k, v, s, S, ka, lanes, run, 1,
                           width);
  block_sort(k, v, width, start_kk);
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    out_k[(size_t)s * width + p] = k[p];
    out_v[(size_t)s * width + p] = v[p];
  }
}

__global__ void k10_compress_dd(const int* __restrict__ key,
                                const double* __restrict__ val,
                                int* __restrict__ out_col,
                                float* __restrict__ out_hi,
                                float* __restrict__ out_lo,
                                int* __restrict__ nnz, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* v = reinterpret_cast<double*>(smem_raw);
  int* k = reinterpret_cast<int*>(v + width);
  const int s = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    k[p] = key[(size_t)s * width + p];
    v[p] = val[(size_t)s * width + p];
  }
  __syncthreads();
  const size_t o = (size_t)s * width;
  compress_row(k, v, width, width, true, out_col + o,
               DDOut{out_hi + o, out_lo + o}, nnz + s, k + width);
}

// keys + values of `vbytes` each + 32 warp totals + 1 block total; at
// most 12 * 1024 + 132 bytes, under the 48 KB default
inline size_t slab_smem(int width, size_t vbytes) {
  return (size_t)width * (sizeof(int) + vbytes) + 33 * sizeof(int);
}

}  // namespace

// Each entry point launches one block per slab on `stream`, which belongs
// to the current device (the caller selects it), does not synchronise,
// and returns cudaGetLastError() after the launch (0 on success).

extern "C" int ia_k8_expand_sort_lr(const void* g, const void* avT,
                                    const void* lrT, void* out_k,
                                    void* out_v, int S, int ka, int lanes,
                                    int run, int width, int n, int start_kk,
                                    void* stream) {
  k8_expand_sort_lr<<<S, threads_for(width), slab_smem(width, 4),
                      (cudaStream_t)stream>>>(
      (const int32_t*)g, (const float*)avT, (const int32_t*)lrT,
      (int*)out_k, (float*)out_v, S, ka, lanes, run, width, n, start_kk);
  return (int)cudaGetLastError();
}

extern "C" int ia_k9_expand_sort_lr_dd(const void* g, const void* avT,
                                       const void* lrT, void* out_k,
                                       void* out_v, int S, int ka,
                                       int lanes, int run, int width, int n,
                                       int start_kk, void* stream) {
  k9_expand_sort_lr_dd<<<S, threads_for(width), slab_smem(width, 8),
                         (cudaStream_t)stream>>>(
      (const int32_t*)g, (const float*)avT, (const int32_t*)lrT,
      (int*)out_k, (double*)out_v, S, ka, lanes, run, width, n, start_kk);
  return (int)cudaGetLastError();
}

extern "C" int ia_k10_compress_dd(const void* key, const void* val,
                                  void* out_col, void* out_hi, void* out_lo,
                                  void* nnz, int S, int width,
                                  void* stream) {
  k10_compress_dd<<<S, threads_for(width), slab_smem(width, 8),
                    (cudaStream_t)stream>>>(
      (const int*)key, (const double*)val, (int*)out_col, (float*)out_hi,
      (float*)out_lo, (int*)nnz, width);
  return (int)cudaGetLastError();
}
