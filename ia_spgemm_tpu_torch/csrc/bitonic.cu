// Width-class bitonic SpGEMM kernels for Hopper (sm_90a), plain C ABI.
//
// Counterparts of the Pallas kernels in ia_spgemm_tpu/ops/bitonic.py:
//   K1 ia_k1_expand_sort_compress  <- _expand_sort_compress_kernel_t (:1034)
//   K2 ia_k2_expand_sort           <- _expand_sort_kernel_t          (:977)
//   K3 ia_k3_compress              <- _compress_kernel_t             (:523)
//   K4 ia_k4_sort_compress_rows    <- _kernel                        (:241)
//
// They compute what the Pallas kernels compute, not how: one thread block
// owns one output row, keeps the row's `width` (key, value) products in
// shared memory, sorts them with a bitonic network (partner i ^ s, no
// rolls), sums duplicate-column runs, and writes each survivor straight
// to its rank, found by one block-wide exclusive scan. Hopper stores at
// data-dependent offsets, so the TPU's omega-network compaction and its
// (width, 128-row) transposed tiles are gone.
//
// What bounds them on this card: device memory traffic is small (K1 reads
// ka*4*run*4 B of fragments + ka*4 B of A values per row, writes
// out_w*8 B), while the sort makes log2(w)*(log2(w)+1)/2 shared-memory
// passes over 8*w bytes with a block barrier each. For the narrow
// headline classes (w <= 512) the barriers and the few threads per block
// (w/2) bound the kernels, not bytes. The design keeps everything a row
// needs in shared memory between one read and one write of device
// memory; making the sort cheaper (warp-level sorts for narrow classes,
// several rows per block, cp.async/TMA fragment reads, fusing K2 and K3)
// is later work.
//
// Conventions shared with the JAX package: SENTINEL = INT32_MAX marks an
// empty product slot and sorts last (signed int32 compares); empty output
// slots are col -1 / value 0; a fragment's direction (forward or reversed
// run) follows its global fragment index e, not its packed row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;

// Threads per block for a row of `width` slots (width a power of two,
// 128..16384): one compare-exchange pair per thread, at most 1024.
inline int threads_for(int width) {
  int t = width / 2;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// keys + values + 32 warp totals + 1 block total
inline size_t smem_bytes(int width) {
  return (size_t)(2 * width + 33) * sizeof(int);
}

// ---- building block 1: the expand prologue ------------------------------
// Fragment e of this row sits in packed row ep = e / pack of g at lane
// offset (e % pack) * 4 * run as [col_f | val_f | col_rev | val_rev]; odd
// fragments take the reversed half, so the row arrives as alternating
// ascending / descending runs. Invalid columns (< 0) become SENTINEL with
// value 0 by a select: padded class rows carry NaN A values, which a
// multiply-by-mask would leak into the sums.
__device__ void expand_row(const int32_t* __restrict__ g,
                           const float* __restrict__ avT, int* k, float* v,
                           int row, int m, int ka, int lanes, int run,
                           int pack, int width) {
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    int key = kSentinel;
    float val = 0.f;
    int e = p / run;
    if (e < ka) {
      int r = p - e * run;
      int ep = e / pack;
      int off = (e - ep * pack) * 4 * run + ((e & 1) ? 2 * run : 0);
      const int32_t* src = g + ((size_t)ep * m + row) * lanes + off;
      int c = src[r];
      if (c >= 0) {
        key = c;
        val = avT[(size_t)e * m + row] * __int_as_float(src[run + r]);
      }
    }
    k[p] = key;
    v[p] = val;
  }
}

// ---- building block 2: block bitonic sort in shared memory -------------
// Ascending by key. Merging starts at block size start_kk: 2*run when the
// row holds alternating sorted runs of length run, 2 for a full sort.
__device__ void block_sort(int* k, float* v, int width, int start_kk) {
  __syncthreads();
  const int half = width >> 1;
  for (int kk = start_kk; kk <= width; kk <<= 1) {
    for (int s = kk >> 1; s > 0; s >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        int i = ((t & ~(s - 1)) << 1) | (t & (s - 1));
        int j = i + s;
        bool asc = (i & kk) == 0;
        int ki = k[i], kj = k[j];
        if (ki != kj && (ki > kj) == asc) {
          k[i] = kj;
          k[j] = ki;
          float vi = v[i];
          v[i] = v[j];
          v[j] = vi;
        }
      }
      __syncthreads();
    }
  }
}

// ---- building block 3: compress -----------------------------------------
__device__ __forceinline__ bool emits(const int* k, int i, int width) {
  int key = k[i];
  return key != kSentinel && (i == width - 1 || k[i + 1] != key);
}

// Sum of the duplicate run ending at its last slot i.
__device__ __forceinline__ float run_sum(const int* k, const float* v,
                                         int i) {
  int key = k[i];
  float s = v[i];
  for (int j = i - 1; j >= 0 && k[j] == key; --j) s += v[j];
  return s;
}

// Block-wide exclusive scan of one int per thread; *total gets the sum.
// blockDim.x is a multiple of 32.
__device__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    int wt = lane < nw ? warp_tot[lane] : 0;
    int wi = wt;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < nw) warp_tot[lane] = wi - wt;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return warp_tot[wid] + incl - x;
}

// Sorted row (k, v) in shared memory -> duplicate sums, nnz, and either
// the survivors compacted left into out_w slots (compact) or left at
// their sorted slots with -1 / 0 holes (!compact, out_w == width). Each
// thread scans a contiguous chunk so ranks keep column order. nnz counts
// every survivor, also those past out_w.
__device__ void compress_row(const int* k, const float* v, int width,
                             int out_w, bool compact, int* out_col,
                             float* out_val, int* nnz, int* scratch) {
  const int nt = blockDim.x;
  const int chunk = width / nt;
  const int lo = threadIdx.x * chunk;
  int cnt = 0;
  for (int i = lo; i < lo + chunk; ++i) cnt += emits(k, i, width);
  int off = block_exclusive_scan(cnt, scratch, scratch + 32);
  const int total = scratch[32];
  if (compact) {
    for (int i = lo; i < lo + chunk; ++i) {
      if (!emits(k, i, width)) continue;
      if (off < out_w) {
        out_col[off] = k[i];
        out_val[off] = run_sum(k, v, i);
      }
      ++off;
    }
    for (int p = total + threadIdx.x; p < out_w; p += nt) {
      out_col[p] = -1;
      out_val[p] = 0.f;
    }
  } else {
    for (int i = lo; i < lo + chunk; ++i) {
      bool e = emits(k, i, width);
      out_col[i] = e ? k[i] : -1;
      out_val[i] = e ? run_sum(k, v, i) : 0.f;
    }
  }
  if (threadIdx.x == 0) *nnz = total;
}

// ---- the four kernels -----------------------------------------------------

__global__ void k1_expand_sort_compress(
    const int32_t* __restrict__ g, const float* __restrict__ avT,
    int* __restrict__ out_col, float* __restrict__ out_val,
    int* __restrict__ nnz, int m, int ka, int lanes, int run, int pack,
    int width, int start_kk, int out_w) {
  extern __shared__ int smem[];
  int* k = smem;
  float* v = reinterpret_cast<float*>(smem + width);
  const int row = blockIdx.x;
  expand_row(g, avT, k, v, row, m, ka, lanes, run, pack, width);
  block_sort(k, v, width, start_kk);
  compress_row(k, v, width, out_w, true, out_col + (size_t)row * out_w,
               out_val + (size_t)row * out_w, nnz + row, smem + 2 * width);
}

__global__ void k2_expand_sort(const int32_t* __restrict__ g,
                               const float* __restrict__ avT,
                               int* __restrict__ out_k,
                               float* __restrict__ out_v, int m, int ka,
                               int lanes, int run, int pack, int width,
                               int start_kk) {
  extern __shared__ int smem[];
  int* k = smem;
  float* v = reinterpret_cast<float*>(smem + width);
  const int row = blockIdx.x;
  expand_row(g, avT, k, v, row, m, ka, lanes, run, pack, width);
  block_sort(k, v, width, start_kk);
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    out_k[(size_t)row * width + p] = k[p];
    out_v[(size_t)row * width + p] = v[p];
  }
}

__global__ void k3_compress(const int* __restrict__ key,
                            const float* __restrict__ val,
                            int* __restrict__ out_col,
                            float* __restrict__ out_val,
                            int* __restrict__ nnz, int width, int out_w,
                            int compact) {
  extern __shared__ int smem[];
  int* k = smem;
  float* v = reinterpret_cast<float*>(smem + width);
  const int row = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    k[p] = key[(size_t)row * width + p];
    v[p] = val[(size_t)row * width + p];
  }
  __syncthreads();
  compress_row(k, v, width, out_w, compact != 0,
               out_col + (size_t)row * out_w, out_val + (size_t)row * out_w,
               nnz + row, smem + 2 * width);
}

__global__ void k4_sort_compress_rows(const int* __restrict__ key,
                                      const float* __restrict__ val,
                                      int* __restrict__ out_col,
                                      float* __restrict__ out_val,
                                      int* __restrict__ nnz, int width,
                                      int start_kk) {
  extern __shared__ int smem[];
  int* k = smem;
  float* v = reinterpret_cast<float*>(smem + width);
  const int row = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    k[p] = key[(size_t)row * width + p];
    v[p] = val[(size_t)row * width + p];
  }
  block_sort(k, v, width, start_kk);
  compress_row(k, v, width, width, true, out_col + (size_t)row * width,
               out_val + (size_t)row * width, nnz + row, smem + 2 * width);
}

// Allow more than 48 KB of dynamic shared memory (K4 at width 16384 uses
// 128 KB). Set once per kernel and device, to what the widest row needs,
// on the device the caller made current; later launches skip it.
constexpr int kMaxDevices = 64;
constexpr int kMaxWidth = 16384;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxWidth));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

bool k1_smem_set[kMaxDevices], k2_smem_set[kMaxDevices],
    k3_smem_set[kMaxDevices], k4_smem_set[kMaxDevices];

}  // namespace

// Each entry point launches on `stream`, which belongs to the current
// device (the caller selects it), does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).

extern "C" int ia_k1_expand_sort_compress(
    const void* g, const void* avT, void* out_col, void* out_val,
    void* nnz, int m, int ka, int lanes, int run, int pack, int width,
    int start_kk, int out_w, void* stream) {
  size_t smem = smem_bytes(width);
  cudaError_t err = allow_smem(k1_expand_sort_compress, k1_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k1_expand_sort_compress<<<m, threads_for(width), smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)g, (const float*)avT, (int*)out_col, (float*)out_val,
      (int*)nnz, m, ka, lanes, run, pack, width, start_kk, out_w);
  return (int)cudaGetLastError();
}

extern "C" int ia_k2_expand_sort(const void* g, const void* avT,
                                 void* out_k, void* out_v, int m, int ka,
                                 int lanes, int run, int pack, int width,
                                 int start_kk, void* stream) {
  size_t smem = smem_bytes(width);
  cudaError_t err = allow_smem(k2_expand_sort, k2_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k2_expand_sort<<<m, threads_for(width), smem, (cudaStream_t)stream>>>(
      (const int32_t*)g, (const float*)avT, (int*)out_k, (float*)out_v, m,
      ka, lanes, run, pack, width, start_kk);
  return (int)cudaGetLastError();
}

extern "C" int ia_k3_compress(const void* key, const void* val,
                              void* out_col, void* out_val, void* nnz,
                              int m, int width, int out_w, int compact,
                              void* stream) {
  size_t smem = smem_bytes(width);
  cudaError_t err = allow_smem(k3_compress, k3_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k3_compress<<<m, threads_for(width), smem, (cudaStream_t)stream>>>(
      (const int*)key, (const float*)val, (int*)out_col, (float*)out_val,
      (int*)nnz, width, out_w, compact);
  return (int)cudaGetLastError();
}

extern "C" int ia_k4_sort_compress_rows(const void* key, const void* val,
                                        void* out_col, void* out_val,
                                        void* nnz, int m, int width,
                                        int start_kk, void* stream) {
  size_t smem = smem_bytes(width);
  cudaError_t err = allow_smem(k4_sort_compress_rows, k4_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k4_sort_compress_rows<<<m, threads_for(width), smem,
                          (cudaStream_t)stream>>>(
      (const int*)key, (const float*)val, (int*)out_col, (float*)out_val,
      (int*)nnz, width, start_kk);
  return (int)cudaGetLastError();
}
