// Width-class bitonic SpGEMM kernels for Hopper (sm_90a), plain C ABI.
//
// Counterparts of the Pallas kernels in ia_spgemm_tpu/ops/bitonic.py:
//   K1 ia_k1_expand_sort_compress  <- _expand_sort_compress_kernel_t (:1034)
//   K2 ia_k2_expand_sort           <- _expand_sort_kernel_t          (:977)
//   K3 ia_k3_compress[_f64]        <- _compress_kernel_t             (:523)
//   K4 ia_k4_sort_compress_rows[_f64] <- _kernel                     (:241)
//   K5 ia_k5_sort_compress[_f64]   <- _fused_kernel_t                (:657)
//   K6 ia_k6_sort[_f64]            <- _sort_only_kernel_t            (:346)
//   K7a ia_k7a_expand_sort_packed  <- _expand_sort_kernel_packed     (:1056)
//   K7b ia_k7b_compress_packed     <- _compress_kernel_packed        (:1086)
// (an _f64 entry is the float64-value instance of the same kernel)
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
// K5 and K6 take rows the torch expand (ops/bitonic.py _expand_ell) has
// already written to device memory: (m, width) int32 keys and float32 or
// float64 values, each row alternating ascending / descending runs of
// `run`. The TPU split them at FUSED_MAX_WIDTH (sort + compress in one
// kernel below it, sort then K3 above) because of its scoped VMEM; here
// one block per row holds up to 12 * width bytes of shared memory either
// way, and the split is kept so both kernels run where the JAX package
// runs them. Bound on this card: bytes would allow 12 * width * 2 per row
// (read the pair, write it or its compacted survivors) at 3.35 TB/s, but
// the same barrier-separated network passes as K1/K2 hold them back; K5
// saves K6 + K3's extra write and read of the sorted row. K4 and K5 share
// one device function (sort_compress_row); K5 adds the out_w cap.
//
// Conventions and building blocks: sort_common.cuh.

#include "sort_common.cuh"

namespace {

// values + keys + 32 warp totals + 1 block total (values first, so a
// float64 lane stays 8-byte aligned)
template <typename V>
inline size_t smem_bytes(int width) {
  return (size_t)width * (sizeof(V) + sizeof(int)) + 33 * sizeof(int);
}

// ---- K1-K4 ----------------------------------------------------------------

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

// One row of (m, width) keys and values from device memory into shared
// memory laid out as smem_bytes<V> says: returns the keys; *v gets the
// values.
template <typename V>
__device__ int* load_row(const int* __restrict__ key,
                         const V* __restrict__ val, unsigned char* raw,
                         V** v, int row, int width) {
  V* vs = reinterpret_cast<V*>(raw);
  int* ks = reinterpret_cast<int*>(vs + width);
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    ks[p] = key[(size_t)row * width + p];
    vs[p] = val[(size_t)row * width + p];
  }
  *v = vs;
  return ks;
}

template <typename V>
__global__ void k3_compress(const int* __restrict__ key,
                            const V* __restrict__ val,
                            int* __restrict__ out_col,
                            V* __restrict__ out_val, int* __restrict__ nnz,
                            int width, int out_w, int compact) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  V* v;
  int* k = load_row(key, val, smem_raw, &v, row, width);
  __syncthreads();
  compress_row(k, v, width, out_w, compact != 0,
               out_col + (size_t)row * out_w,
               ValOut<V>{out_val + (size_t)row * out_w}, nnz + row,
               k + width);
}

// K4 and K5: sort one pre-expanded row, sum duplicates, write the first
// out_w survivors (K4: out_w == width).
template <typename V>
__device__ void sort_compress_row(const int* __restrict__ key,
                                  const V* __restrict__ val,
                                  int* __restrict__ out_col,
                                  V* __restrict__ out_val,
                                  int* __restrict__ nnz, int width,
                                  int start_kk, int out_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  V* v;
  int* k = load_row(key, val, smem_raw, &v, row, width);
  block_sort(k, v, width, start_kk);
  compress_row(k, v, width, out_w, true, out_col + (size_t)row * out_w,
               ValOut<V>{out_val + (size_t)row * out_w}, nnz + row,
               k + width);
}

template <typename V>
__global__ void k4_sort_compress_rows(const int* __restrict__ key,
                                      const V* __restrict__ val,
                                      int* __restrict__ out_col,
                                      V* __restrict__ out_val,
                                      int* __restrict__ nnz, int width,
                                      int start_kk) {
  sort_compress_row(key, val, out_col, out_val, nnz, width, start_kk,
                    width);
}

// ---- K5, K6: the cols layout over the torch expand --------------------------

template <typename V>
__global__ void k5_sort_compress(const int* __restrict__ key,
                                 const V* __restrict__ val,
                                 int* __restrict__ out_col,
                                 V* __restrict__ out_val,
                                 int* __restrict__ nnz, int width,
                                 int start_kk, int out_w) {
  sort_compress_row(key, val, out_col, out_val, nnz, width, start_kk,
                    out_w);
}

template <typename V>
__global__ void k6_sort(const int* __restrict__ key,
                        const V* __restrict__ val, int* __restrict__ out_k,
                        V* __restrict__ out_v, int width, int start_kk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  V* v;
  int* k = load_row(key, val, smem_raw, &v, row, width);
  block_sort(k, v, width, start_kk);
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    out_k[(size_t)row * width + p] = k[p];
    out_v[(size_t)row * width + p] = v[p];
  }
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
// 128 KB with float32 values, 192 KB with float64). Set once per kernel
// instance and device, to what its widest row needs, on the device the
// caller made current; later launches skip it.
constexpr int kMaxDevices = 64;
constexpr int kMaxWidth = 16384;

template <typename V, typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<V>(kMaxWidth));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

bool k1_smem_set[kMaxDevices], k2_smem_set[kMaxDevices],
    k7a_smem_set[kMaxDevices], k7b_smem_set[kMaxDevices];

// The launches of the kernels with a float and a double instance; each
// instance keeps its own shared-memory flags (the static locals).
template <typename V>
int launch_k3(const void* key, const void* val, void* out_col,
              void* out_val, void* nnz, int m, int width, int out_w,
              int compact, void* stream) {
  static bool done[kMaxDevices];
  size_t smem = smem_bytes<V>(width);
  cudaError_t err = allow_smem<V>(k3_compress<V>, done, smem);
  if (err != cudaSuccess) return (int)err;
  k3_compress<V><<<m, threads_for(width), smem, (cudaStream_t)stream>>>(
      (const int*)key, (const V*)val, (int*)out_col, (V*)out_val,
      (int*)nnz, width, out_w, compact);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_k4(const void* key, const void* val, void* out_col,
              void* out_val, void* nnz, int m, int width, int start_kk,
              void* stream) {
  static bool done[kMaxDevices];
  size_t smem = smem_bytes<V>(width);
  cudaError_t err = allow_smem<V>(k4_sort_compress_rows<V>, done, smem);
  if (err != cudaSuccess) return (int)err;
  k4_sort_compress_rows<V><<<m, threads_for(width), smem,
                             (cudaStream_t)stream>>>(
      (const int*)key, (const V*)val, (int*)out_col, (V*)out_val,
      (int*)nnz, width, start_kk);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_k5(const void* key, const void* val, void* out_col,
              void* out_val, void* nnz, int m, int width, int start_kk,
              int out_w, void* stream) {
  static bool done[kMaxDevices];
  size_t smem = smem_bytes<V>(width);
  cudaError_t err = allow_smem<V>(k5_sort_compress<V>, done, smem);
  if (err != cudaSuccess) return (int)err;
  k5_sort_compress<V><<<m, threads_for(width), smem,
                        (cudaStream_t)stream>>>(
      (const int*)key, (const V*)val, (int*)out_col, (V*)out_val,
      (int*)nnz, width, start_kk, out_w);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_k6(const void* key, const void* val, void* out_k, void* out_v,
              int m, int width, int start_kk, void* stream) {
  static bool done[kMaxDevices];
  size_t smem = smem_bytes<V>(width);
  cudaError_t err = allow_smem<V>(k6_sort<V>, done, smem);
  if (err != cudaSuccess) return (int)err;
  k6_sort<V><<<m, threads_for(width), smem, (cudaStream_t)stream>>>(
      (const int*)key, (const V*)val, (int*)out_k, (V*)out_v, width,
      start_kk);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream`, which belongs to the current
// device (the caller selects it), does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).

extern "C" int ia_k1_expand_sort_compress(
    const void* g, const void* avT, void* out_col, void* out_val,
    void* nnz, int m, int ka, int lanes, int run, int pack, int width,
    int start_kk, int out_w, void* stream) {
  size_t smem = smem_bytes<float>(width);
  cudaError_t err =
      allow_smem<float>(k1_expand_sort_compress, k1_smem_set, smem);
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
  size_t smem = smem_bytes<float>(width);
  cudaError_t err = allow_smem<float>(k2_expand_sort, k2_smem_set, smem);
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
  return launch_k3<float>(key, val, out_col, out_val, nnz, m, width, out_w,
                          compact, stream);
}

extern "C" int ia_k3_compress_f64(const void* key, const void* val,
                                  void* out_col, void* out_val, void* nnz,
                                  int m, int width, int out_w, int compact,
                                  void* stream) {
  return launch_k3<double>(key, val, out_col, out_val, nnz, m, width,
                           out_w, compact, stream);
}

extern "C" int ia_k4_sort_compress_rows(const void* key, const void* val,
                                        void* out_col, void* out_val,
                                        void* nnz, int m, int width,
                                        int start_kk, void* stream) {
  return launch_k4<float>(key, val, out_col, out_val, nnz, m, width,
                          start_kk, stream);
}

extern "C" int ia_k4_sort_compress_rows_f64(const void* key,
                                            const void* val, void* out_col,
                                            void* out_val, void* nnz, int m,
                                            int width, int start_kk,
                                            void* stream) {
  return launch_k4<double>(key, val, out_col, out_val, nnz, m, width,
                           start_kk, stream);
}

extern "C" int ia_k5_sort_compress(const void* key, const void* val,
                                   void* out_col, void* out_val, void* nnz,
                                   int m, int width, int start_kk,
                                   int out_w, void* stream) {
  return launch_k5<float>(key, val, out_col, out_val, nnz, m, width,
                          start_kk, out_w, stream);
}

extern "C" int ia_k5_sort_compress_f64(const void* key, const void* val,
                                       void* out_col, void* out_val,
                                       void* nnz, int m, int width,
                                       int start_kk, int out_w,
                                       void* stream) {
  return launch_k5<double>(key, val, out_col, out_val, nnz, m, width,
                           start_kk, out_w, stream);
}

extern "C" int ia_k6_sort(const void* key, const void* val, void* out_k,
                          void* out_v, int m, int width, int start_kk,
                          void* stream) {
  return launch_k6<float>(key, val, out_k, out_v, m, width, start_kk,
                          stream);
}

extern "C" int ia_k6_sort_f64(const void* key, const void* val, void* out_k,
                              void* out_v, int m, int width, int start_kk,
                              void* stream) {
  return launch_k6<double>(key, val, out_k, out_v, m, width, start_kk,
                           stream);
}

extern "C" int ia_k7a_expand_sort_packed(const void* g, const void* avT,
                                         void* out_p, int m, int ka,
                                         int lanes, int run, int width,
                                         int start_kk, void* stream) {
  size_t smem = (size_t)width * sizeof(int);
  cudaError_t err =
      allow_smem<float>(k7a_expand_sort_packed, k7a_smem_set, smem);
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
  size_t smem = smem_bytes<float>(width);
  cudaError_t err =
      allow_smem<float>(k7b_compress_packed, k7b_smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  k7b_compress_packed<<<m, threads_for(width), smem,
                        (cudaStream_t)stream>>>(
      (const int*)packed, (int*)out_col, (float*)out_val, (int*)nnz, width,
      out_w, compact);
  return (int)cudaGetLastError();
}
