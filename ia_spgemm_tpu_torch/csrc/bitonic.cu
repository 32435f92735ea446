// Width-class bitonic SpGEMM kernels for Hopper (sm_90a), plain C ABI.
//
// Counterparts of the Pallas kernels in ia_spgemm_tpu/ops/bitonic.py:
//   K1 ia_k1_expand_sort_compress  <- _expand_sort_compress_kernel_t (:1034)
//   K2 ia_k2_expand_sort           <- _expand_sort_kernel_t          (:977)
//   K3 ia_k3_compress              <- _compress_kernel_t             (:523)
//   K4 ia_k4_sort_compress_rows    <- _kernel                        (:241)
//   K7a ia_k7a_expand_sort_packed  <- _expand_sort_kernel_packed     (:1056)
//   K7b ia_k7b_compress_packed     <- _compress_kernel_packed        (:1086)
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
// is later work. K7 (the bf16 serve lane) moves one int32 key per product
// through the network instead of a (key, value) pair: half the shared
// memory and half the exchanges of K2, at bf16 precision per product.
//
// Conventions and building blocks: sort_common.cuh.

#include "sort_common.cuh"

namespace {

// keys + values + 32 warp totals + 1 block total
inline size_t smem_bytes(int width) {
  return (size_t)(2 * width + 33) * sizeof(int);
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
  expand_row<float, false>(g, avT, nullptr, 0, k, v, row, m, ka, lanes,
                           run, pack, width);
  block_sort(k, v, width, start_kk);
  compress_row(k, v, width, out_w, true, out_col + (size_t)row * out_w,
               F32Out{out_val + (size_t)row * out_w}, nnz + row,
               smem + 2 * width);
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
  expand_row<float, false>(g, avT, nullptr, 0, k, v, row, m, ka, lanes,
                           run, pack, width);
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
               out_col + (size_t)row * out_w,
               F32Out{out_val + (size_t)row * out_w}, nnz + row,
               smem + 2 * width);
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
               F32Out{out_val + (size_t)row * width}, nnz + row,
               smem + 2 * width);
}

// ---- K7: the bf16 serve lane ---------------------------------------------
// (col | bf16(product)) in one int32 key, the JAX package's _pack_colval
// (:498) bit for bit, on uint32 so every shift is logical and the
// rounding add wraps as the TPU's int32 add does: round to nearest even
// (0x7FFF + the kept lsb), then the 16 high bits, capped at 0xFFFE so no
// key equals the sentinel. col <= 32767 keeps the sign bit clear, so the
// keys order by (col, value bits) under signed compares.
__device__ __forceinline__ int pack_colval(int c, float prod) {
  const uint32_t pb = __float_as_uint(prod);
  const uint32_t rnd = pb + 0x7FFFu + ((pb >> 16) & 1u);
  const uint32_t enc = min(rnd >> 16, 0xFFFEu);
  return (int)(((uint32_t)c << 16) | enc);
}

// K7a: K2's expand (one fragment per table row, no lane packing), each
// product packed into its key, then the key-only network. The row holds
// alternating ascending / descending runs, as in K1/K2, so the merge
// starts at start_kk = 2*run. Shared memory: width keys, half of K2's.
__global__ void k7a_expand_sort_packed(const int32_t* __restrict__ g,
                                       const float* __restrict__ avT,
                                       int* __restrict__ out_p, int m,
                                       int ka, int lanes, int run,
                                       int width, int start_kk) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    int key = kSentinel;
    const int e = p / run;
    if (e < ka) {
      const int r = p - e * run;
      const int32_t* src = g + ((size_t)e * m + row) * lanes +
                           ((e & 1) ? 2 * run : 0);
      const int c = src[r];
      if (c >= 0)
        key = pack_colval(c, __fmul_rn(avT[(size_t)e * m + row],
                                       __int_as_float(src[run + r])));
    }
    smem[p] = key;
  }
  block_sort_keys(smem, width, start_kk);
  for (int p = threadIdx.x; p < width; p += blockDim.x)
    out_p[(size_t)row * width + p] = smem[p];
}

// K7b: unpack the sorted keys (_unpack_colval, :512: the bf16 bits widen
// to float32 exactly), then K3's float32 duplicate sums and compaction.
__global__ void k7b_compress_packed(const int* __restrict__ packed,
                                    int* __restrict__ out_col,
                                    float* __restrict__ out_val,
                                    int* __restrict__ nnz, int width,
                                    int out_w, int compact) {
  extern __shared__ int smem[];
  int* k = smem;
  float* v = reinterpret_cast<float*>(smem + width);
  const int row = blockIdx.x;
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    const int x = packed[(size_t)row * width + p];
    const bool sent = x == kSentinel;
    k[p] = sent ? kSentinel : (int)((uint32_t)x >> 16);
    v[p] = sent ? 0.f : __uint_as_float(((uint32_t)x & 0xFFFFu) << 16);
  }
  __syncthreads();
  compress_row(k, v, width, out_w, compact != 0,
               out_col + (size_t)row * out_w,
               F32Out{out_val + (size_t)row * out_w}, nnz + row,
               smem + 2 * width);
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
    k3_smem_set[kMaxDevices], k4_smem_set[kMaxDevices],
    k7a_smem_set[kMaxDevices], k7b_smem_set[kMaxDevices];

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

extern "C" int ia_k7a_expand_sort_packed(const void* g, const void* avT,
                                         void* out_p, int m, int ka,
                                         int lanes, int run, int width,
                                         int start_kk, void* stream) {
  size_t smem = (size_t)width * sizeof(int);
  cudaError_t err = allow_smem(k7a_expand_sort_packed, k7a_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k7a_expand_sort_packed<<<m, threads_for(width), smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)g, (const float*)avT, (int*)out_p, m, ka, lanes, run,
      width, start_kk);
  return (int)cudaGetLastError();
}

extern "C" int ia_k7b_compress_packed(const void* packed, void* out_col,
                                      void* out_val, void* nnz, int m,
                                      int width, int out_w, int compact,
                                      void* stream) {
  size_t smem = smem_bytes(width);
  cudaError_t err = allow_smem(k7b_compress_packed, k7b_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k7b_compress_packed<<<m, threads_for(width), smem,
                        (cudaStream_t)stream>>>(
      (const int*)packed, (int*)out_col, (float*)out_val, (int*)nnz, width,
      out_w, compact);
  return (int)cudaGetLastError();
}
