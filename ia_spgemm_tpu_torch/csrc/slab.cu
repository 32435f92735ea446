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
// land adjacent.
//
// K8 and K9 run the register network of sort_common.cuh (building block
// 3, row_net_rows with the TableIn source and its slab-local rows): one
// slab per block of width / 8 threads (128 at 1024), E = 8 slots a thread
// in registers. Each thread reads its slots straight from the packed B
// table through the fragment index mt: at run 8 and 32 one table row, one
// A value and one slab-local row per thread, and two 16-byte loads
// (columns, value bits); so no gathered copy of the table's rows is
// written to device memory first. The table (one row of 4 * run lanes per B fragment) is
// small enough to stay in L2 while the slabs read it. A slab's fragment
// slot e takes the reversed half of its fragment when e is odd (the JAX
// rule), so the slab arrives as alternating sorted runs of length `run`
// and the sort merges from start_kk = 2 * run: register and lane strides
// without barriers, the strides of 256 and 512 through one shared-memory
// exchange pair (two barriers) per stage. The sorted slab goes out with
// 16-byte stores. Empty slab columns (padding up to S) read the table's
// all -1 fill row and come out as SENTINEL / 0.
//
// K8's float32 sums are compressed by K3 (bitonic.cu). The TPU's
// compensated pipeline formed each product as a Dekker (hi, lo) pair and
// summed runs by two-sum, because the TPU has no float64; this card has
// it, so K9 forms the exact product (double)a * (double)b (two 24-bit
// mantissas fit 53 bits) and sorts (key, double) pairs, and K10 sums each
// duplicate run in float64 and writes hi = f32(s), lo = f32(s - hi). No
// float32 error-free transformation is left for FMA contraction to break.
//
// What bounds them: bytes would (the table's read lanes, mt, avT and lrT
// once, the sorted (S, width) keys and values written once, at 3.35
// TB/s); the network's compares and shuffles keep K8 and K9 a few times
// above that, as K1, K4 and K6 are. K10 is the last kernel on shared
// memory (building block 2: one block-wide scan, 12 bytes a slot); it
// already runs within 1.5x of its bytes bound on the headline's slabs
// (PERF.md), so it is left as it is.

#include "sort_common.cuh"

namespace {

// K8 / K9: each block sorts its slabs' slots (one slab of 512 or 1024
// slots; several slabs of 128 or 256 share a 128-thread block), the
// sorted slab stored as it is (NetOut::kSorted).
__global__ void __launch_bounds__(128)
k8_expand_sort_lr(TableIn<float> in, int* __restrict__ out_k,
                  float* __restrict__ out_v, int S, int width, int start_kk,
                  int rows_per_block, int vec_out) {
  row_net_rows<float, 8, true, NetOut::kSorted>(
      in, out_k, out_v, nullptr, S, width, start_kk, width, rows_per_block,
      vec_out);
}

__global__ void __launch_bounds__(128)
k9_expand_sort_lr_dd(TableIn<double> in, int* __restrict__ out_k,
                     double* __restrict__ out_v, int S, int width,
                     int start_kk, int rows_per_block, int vec_out) {
  row_net_rows<double, 8, true, NetOut::kSorted>(
      in, out_k, out_v, nullptr, S, width, start_kk, width, rows_per_block,
      vec_out);
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
  compress_row(k, v, width, out_col + o, DDOut{out_hi + o, out_lo + o},
               nnz + s, k + width);
}

// K10's keys + float64 values + 32 warp totals + 1 block total; at most
// 12 * 1024 + 132 bytes, under the 48 KB default
inline size_t k10_smem(int width) {
  return (size_t)width * (sizeof(int) + sizeof(double)) + 33 * sizeof(int);
}

// K8 / K9 on `stream`: at most 12 KB of shared memory a block (1024
// float64 values and keys), under the 48 KB default.
template <typename V, typename Kernel>
int launch_slab(Kernel kernel, const void* table, const void* mt,
                const void* avT, const void* lrT, void* out_k, void* out_v,
                int S, int ka, int lanes, int run, int width, int n,
                int start_kk, void* stream) {
  const TableIn<V> in{(const int32_t*)table, (const int32_t*)mt,
                      (const float*)avT, (const int32_t*)lrT, ka, lanes, run,
                      n, ((uintptr_t)table & 15) == 0 && lanes % 4 == 0};
  const int rows_per_block = net_rows_per_block<8>(width);
  const int vec_out = (((uintptr_t)out_k | (uintptr_t)out_v) & 15) == 0;
  const int grid = (S + rows_per_block - 1) / rows_per_block;
  kernel<<<grid, width / 8 * rows_per_block,
           net_smem_bytes<V, 8>(width, rows_per_block, true,
                                NetOut::kSorted),
           (cudaStream_t)stream>>>(in, (int*)out_k, (V*)out_v, S, width,
                                   start_kk, rows_per_block, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream`, which belongs to the current
// device (the caller selects it), does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success). K8 / K9 take the
// packed table (F_B + 1, lanes) and the (ka, S) fragment index mt, A
// values avT and slab-local rows lrT; they write (S, width) sorted keys
// and values.

extern "C" int ia_k8_expand_sort_lr(const void* table, const void* mt,
                                    const void* avT, const void* lrT,
                                    void* out_k, void* out_v, int S, int ka,
                                    int lanes, int run, int width, int n,
                                    int start_kk, void* stream) {
  return launch_slab<float>(k8_expand_sort_lr, table, mt, avT, lrT, out_k,
                            out_v, S, ka, lanes, run, width, n, start_kk,
                            stream);
}

extern "C" int ia_k9_expand_sort_lr_dd(const void* table, const void* mt,
                                       const void* avT, const void* lrT,
                                       void* out_k, void* out_v, int S,
                                       int ka, int lanes, int run, int width,
                                       int n, int start_kk, void* stream) {
  return launch_slab<double>(k9_expand_sort_lr_dd, table, mt, avT, lrT,
                             out_k, out_v, S, ka, lanes, run, width, n,
                             start_kk, stream);
}

extern "C" int ia_k10_compress_dd(const void* key, const void* val,
                                  void* out_col, void* out_hi, void* out_lo,
                                  void* nnz, int S, int width,
                                  void* stream) {
  k10_compress_dd<<<S, threads_for(width), k10_smem(width),
                    (cudaStream_t)stream>>>(
      (const int*)key, (const double*)val, (int*)out_col, (float*)out_hi,
      (float*)out_lo, (int*)nnz, width);
  return (int)cudaGetLastError();
}
