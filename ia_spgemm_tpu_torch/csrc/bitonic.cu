// Width-class bitonic SpGEMM kernels for Hopper (sm_90a), plain C ABI.
//
// Counterparts of the Pallas kernels in ia_spgemm_tpu/ops/bitonic.py:
//   K1 ia_k1_expand_sort_compress  <- _expand_sort_compress_kernel_t (:1034)
//   K2 ia_k2_expand_sort[_table]   <- _expand_sort_kernel_t          (:977)
//   K3 ia_k3_compress[_f64]        <- _compress_kernel_t             (:523)
//   K4 ia_k4_sort_compress_rows[_f64] <- _kernel                     (:241)
//   K5 ia_k5_sort_compress[_f64]   <- _fused_kernel_t                (:657)
//   K6 ia_k6_sort[_f64]            <- _sort_only_kernel_t            (:346)
//   K7a ia_k7a_expand_sort_packed  <- _expand_sort_kernel_packed     (:1056)
//   K7b ia_k7b_compress_packed     <- _compress_kernel_packed        (:1086)
// (an _f64 entry is the float64-value instance of the same kernel; K2's
// _table entry reads the B table through rT instead of the gather g)
//
// They compute what the Pallas kernels compute, not how: each owns whole
// output rows, sorts a row's (key, value) products with a bitonic network
// (partner i ^ s, no rolls), sums duplicate-column runs, and writes each
// survivor to its rank, found by a scan over the row. Hopper stores at
// data-dependent offsets, so the TPU's omega-network compaction and its
// (width, 128-row) transposed tiles are gone. Two designs, on the
// building blocks of sort_common.cuh:
//
// - The register network (building block 3): K1-K4, K6 and K7a (and K8,
//   K9 in slab.cu). A row of W slots is held E = 8 (16 at W = 16384,
//   and in K7a) slots a thread in registers; strides below 32E need no
//   barrier, rows of at most 32E slots share a 128-thread block, and the
//   compress is a segmented scan over warp shuffles. K1 gathers its
//   products straight into registers (expand_slots) and sorts and
//   compresses them; K2 does
//   the same without the compress, from K1's gather g where the plan
//   pregathered it and otherwise straight from the wide B table through
//   the fragment index rT (TableIn, K8's source without slab rows), so
//   the flat route and the serve lane write no gathered copy of the
//   table; K3 compresses rows K2, K6 or K8 sorted, with no sort; K4 sorts
//   and compresses pre-expanded rows (the wide classes, the ring's
//   shards); K6 sorts them only, for K3; K7a (the bf16 serve lane) packs
//   each of K2's table-source slots into one int32 key and sorts the keys
//   alone (value type NoVal: no value shuffles, half the shared slots;
//   16 slots a thread, as keys alone leave the registers for them).
//   Bound: bytes (read the row or its fragments once, write out_w slots
//   once, at 3.35 TB/s); the network leaves them instruction-bound, a few
//   times above it.
// - The shared-memory network (building blocks 1-2): K5 and K7b (and K10
//   in slab.cu). One thread block owns one output row, keeps its `width`
//   products in shared memory, sorts them with one block barrier per
//   stride (log2(w)*(log2(w)+1)/2 passes over 8*w bytes) where it sorts
//   (K5), and compresses them with one block-wide scan; the barriers and
//   the few threads per block (w/2), not bytes, bound them. Moving them
//   to the register network is later work.
//
// K5 and K6 take rows the torch expand (ops/bitonic.py _expand_ell) has
// already written to device memory: (m, width) int32 keys and float32 or
// float64 values, each row alternating ascending / descending runs of
// `run`. The TPU split them at FUSED_MAX_WIDTH (sort + compress in one
// kernel below it, sort then K3 above) because of its scoped VMEM; the
// split is kept so both kernels run where the JAX package runs them, as
// is K1's (below FUSED_MAX_WIDTH) against K2 + K3.
//
// Conventions and building blocks: sort_common.cuh.

#include <type_traits>

#include "sort_common.cuh"

namespace {

constexpr int kMaxDevices = 64;

// Shared memory of the shared-memory network (K5, K7b): values + keys
// + 32 warp totals + 1 block total (values first, so a float64 lane stays
// 8-byte aligned)
template <typename V>
inline size_t smem_bytes(int width) {
  return (size_t)width * (sizeof(V) + sizeof(int)) + 33 * sizeof(int);
}

// ---- K5: the shared-memory network ---------------------------------------

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

// K5: sort one pre-expanded row, sum duplicates, write the first out_w
// survivors.
template <typename V>
__global__ void k5_sort_compress(const int* __restrict__ key,
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

// ---- K1-K4, K6, K7a: the register network (building block 3) -------------
// The rows, their sources (RowsIn, GatherIn, TableIn), loads and stores
// are sort_common.cuh's (row_net_rows). Bound on this card: bytes, read
// the row (K1, K2, K7a: its fragments and A values) once and write out_w
// slots, at 3.35 TB/s.

// The kernels, one instance per (E, launch bound): E = 16 at width 16384
// (1024 threads), 8 below, the launch bound the widest row the instance
// takes (so that rows up to 2048 slots keep their registers).

// K1: expand + sort + compress of one width class from the gather.
template <int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
k1_expand_sort_compress(GatherIn in, int* __restrict__ out_col,
                        float* __restrict__ out_val, int* __restrict__ nnz,
                        int m, int width, int start_kk, int out_w,
                        int rows_per_block, int vec_out) {
  row_net_rows<float, E, true, NetOut::kCompact>(
      in, out_col, out_val, nnz, m, width, start_kk, out_w, rows_per_block,
      vec_out);
}

// K2: expand + sort without the compress, from the gather g (GatherIn) or
// the B table (TableIn); the sorted row goes out as it is, for K3. nnz is
// unused.
template <int E, int kMaxThreads, typename In>
__global__ void __launch_bounds__(kMaxThreads)
k2_expand_sort(In in, int* __restrict__ out_k, float* __restrict__ out_v,
               int* __restrict__ nnz, int m, int width, int start_kk,
               int out_w, int rows_per_block, int vec_out) {
  row_net_rows<float, E, true, NetOut::kSorted>(
      in, out_k, out_v, nnz, m, width, start_kk, out_w, rows_per_block,
      vec_out);
}

// K3: the compress alone, of rows K2, K6 or K8 sorted; kOut kCompact or
// kInPlace (compact=False). start_kk is unused.
template <typename V, int E, int kMaxThreads, NetOut kOut>
__global__ void __launch_bounds__(kMaxThreads)
k3_compress(RowsIn<V> in, int* __restrict__ out_col,
            V* __restrict__ out_val, int* __restrict__ nnz, int m,
            int width, int start_kk, int out_w, int rows_per_block,
            int vec_out) {
  row_net_rows<V, E, false, kOut>(in, out_col, out_val, nnz, m, width,
                                  start_kk, out_w, rows_per_block, vec_out);
}

template <typename V, int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
k4_sort_compress_rows(RowsIn<V> in, int* __restrict__ out_col,
                      V* __restrict__ out_val, int* __restrict__ nnz, int m,
                      int width, int start_kk, int out_w,
                      int rows_per_block, int vec_out) {
  row_net_rows<V, E, true, NetOut::kCompact>(in, out_col, out_val, nnz, m,
                                             width, start_kk, out_w,
                                             rows_per_block, vec_out);
}

// K6: the sort alone (the sorted row goes out as it is, in the normal
// layout, for K3). nnz is unused.
template <typename V, int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
k6_sort_rows(RowsIn<V> in, int* __restrict__ out_k, V* __restrict__ out_v,
             int* __restrict__ nnz, int m, int width, int start_kk,
             int out_w, int rows_per_block, int vec_out) {
  row_net_rows<V, E, true, NetOut::kSorted>(in, out_k, out_v, nnz, m, width,
                                            start_kk, out_w, rows_per_block,
                                            vec_out);
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

// K7a's source: the table source's (column, float32 product) slots, each
// packed into one key (SENTINEL stays SENTINEL); no value rides along.
struct PackedIn {
  TableIn<float> table;
};

template <int E>
__device__ __forceinline__ void load_slots(int (&k)[E], NoVal (&)[E],
                                           const PackedIn& in, int m,
                                           int width, int row, int base) {
  float v[E];
  load_slots<E>(k, v, in.table, m, width, row, base);
#pragma unroll
  for (int r = 0; r < E; ++r)
    k[r] = k[r] == kSentinel ? kSentinel : pack_colval(k[r], v[r]);
}

// K7a: K2's table-source expand, each product packed into its key, then
// the key-only network (NoVal). The row holds alternating ascending /
// descending runs, as in K1/K2, so the merge starts at start_kk = 2*run;
// the sorted keys go out as they are, for K7b. out_v and nnz are unused.
template <int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
k7a_expand_sort_packed(PackedIn in, int* __restrict__ out_p,
                       NoVal* __restrict__ out_v, int* __restrict__ nnz,
                       int m, int width, int start_kk, int out_w,
                       int rows_per_block, int vec_out) {
  row_net_rows<NoVal, E, true, NetOut::kSorted>(
      in, out_p, out_v, nnz, m, width, start_kk, out_w, rows_per_block,
      vec_out);
}

// The kernel of a (value type, E, launch bound, sort, output, source):
// K1 and K2 for the gather and the table, K7a for the packed table, K3
// without the sort, K6 for the sorted row, K4.
template <typename V, int E, int kMaxThreads, bool kSort, NetOut kOut,
          typename In>
auto net_kernel() {
  if constexpr (std::is_same_v<In, PackedIn>)
    return &k7a_expand_sort_packed<E, kMaxThreads>;
  else if constexpr (!std::is_same_v<In, RowsIn<V>>) {
    if constexpr (kOut == NetOut::kCompact)
      return &k1_expand_sort_compress<E, kMaxThreads>;
    else
      return &k2_expand_sort<E, kMaxThreads, In>;
  } else if constexpr (!kSort)
    return &k3_compress<V, E, kMaxThreads, kOut>;
  else if constexpr (kOut == NetOut::kSorted)
    return &k6_sort_rows<V, E, kMaxThreads>;
  else
    return &k4_sort_compress_rows<V, E, kMaxThreads>;
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

// Allow more than 48 KB of dynamic shared memory (K5 at width 16384
// uses 128 KB with float32 values, 192 KB with float64). Set once per kernel
// instance and device, to what its widest row needs, on the device the
// caller made current; later launches skip it.

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

bool k7b_smem_set[kMaxDevices];

// The register network's launches (K1-K4, K6, K7a): the instance for the
// row's width (E = 16 at 16384 and in K7a, 8 below otherwise; the
// launch bound the widest row it takes), rows of at most 32E slots
// (T <= 32 threads) sharing a 128-thread block. Each instance raises its
// own shared-memory limit once per device (the static local), to what
// its widest row needs.
template <typename V, int E, int kMaxThreads, bool kSort, NetOut kOut,
          typename In>
int launch_row_net(const In& in, void* out_col, void* out_val, void* nnz,
                   int m, int width, int start_kk, int out_w,
                   void* stream) {
  static bool done[kMaxDevices];
  const auto kernel = net_kernel<V, E, kMaxThreads, kSort, kOut, In>();
  const int T = width / E;
  const int rows_per_block = net_rows_per_block<E>(width);
  const size_t smem =
      net_smem_bytes<V, E>(width, rows_per_block, kSort, kOut);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)net_smem_bytes<V, E>(kMaxThreads * E, 1, kSort, kOut));
      if (err != cudaSuccess) return (int)err;
      done[dev] = true;
    }
  }
  const int vec_out = (((uintptr_t)out_col | (uintptr_t)out_val) & 15) == 0
                      && out_w % 4 == 0;
  const int grid = (m + rows_per_block - 1) / rows_per_block;
  kernel<<<grid, T * rows_per_block, smem, (cudaStream_t)stream>>>(
      in, (int*)out_col, (V*)out_val, (int*)nnz, m, width, start_kk, out_w,
      rows_per_block, vec_out);
  return (int)cudaGetLastError();
}

template <typename V, bool kSort, NetOut kOut, typename In>
int launch_rows(const In& in, void* out_col, void* out_val, void* nnz, int m,
                int width, int start_kk, int out_w, void* stream) {
#define IA_NET(E_, THREADS)                                             \
  launch_row_net<V, E_, THREADS, kSort, kOut>(in, out_col, out_val, nnz, \
                                              m, width, start_kk, out_w, \
                                              stream)
  if (width == kMaxWidth) return IA_NET(16, 1024);
  if (width <= 2048) return IA_NET(8, 256);
  if (width == 4096) return IA_NET(8, 512);
  return IA_NET(8, 1024);
#undef IA_NET
}

// Pre-expanded rows as a network source: vector loads where both
// pointers are on the 16-byte grid (a row of width >= 128 slots keeps
// every row there).
template <typename V>
RowsIn<V> rows_in(const void* key, const void* val) {
  return {(const int*)key, (const V*)val,
          (((uintptr_t)key | (uintptr_t)val) & 15) == 0};
}

template <typename V>
int launch_k3(const void* key, const void* val, void* out_col,
              void* out_val, void* nnz, int m, int width, int out_w,
              int compact, void* stream) {
  const RowsIn<V> in = rows_in<V>(key, val);
  return compact ? launch_rows<V, false, NetOut::kCompact>(
                       in, out_col, out_val, nnz, m, width, 2, out_w, stream)
                 : launch_rows<V, false, NetOut::kInPlace>(
                       in, out_col, out_val, nnz, m, width, 2, width,
                       stream);
}

// K7a at every width: E = 16 slots a thread, half the threads a row of
// E = 8 and one stride fewer across warps, with keys alone in registers
// (74 of them, no spill); on the headline's flat plan 0.268 ms alone
// against E = 8's 0.310 (PERF.md). The launch bound is the widest row
// the instance takes.
int launch_k7a(const PackedIn& in, void* out_p, int m, int width,
               int start_kk, void* stream) {
#define IA_K7A(THREADS)                                                   \
  launch_row_net<NoVal, 16, THREADS, true, NetOut::kSorted>(             \
      in, out_p, nullptr, nullptr, m, width, start_kk, width, stream)
  if (width <= 4096) return IA_K7A(256);
  if (width == 8192) return IA_K7A(512);
  return IA_K7A(1024);
#undef IA_K7A
}

// The B table read through rT (ka, m) as a network source: key the
// column (no slab rows); vector loads where the table is on the 16-byte
// grid and its rows a multiple of 4 lanes long.
TableIn<float> table_in(const void* table, const void* rT, const void* avT,
                        int ka, int lanes, int run) {
  return {(const int32_t*)table, (const int32_t*)rT, (const float*)avT,
          nullptr, ka, lanes, run, 0,
          ((uintptr_t)table & 15) == 0 && lanes % 4 == 0};
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

}  // namespace

// Each entry point launches on `stream`, which belongs to the current
// device (the caller selects it), does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).

extern "C" int ia_k1_expand_sort_compress(
    const void* g, const void* avT, void* out_col, void* out_val,
    void* nnz, int m, int ka, int lanes, int run, int pack, int width,
    int start_kk, int out_w, void* stream) {
  const GatherIn in{(const int32_t*)g, (const float*)avT, ka, lanes, run,
                    pack, ((uintptr_t)g & 15) == 0 && lanes % 4 == 0};
  return launch_rows<float, true, NetOut::kCompact>(
      in, out_col, out_val, nnz, m, width, start_kk, out_w, stream);
}

extern "C" int ia_k2_expand_sort(const void* g, const void* avT,
                                 void* out_k, void* out_v, int m, int ka,
                                 int lanes, int run, int pack, int width,
                                 int start_kk, void* stream) {
  const GatherIn in{(const int32_t*)g, (const float*)avT, ka, lanes, run,
                    pack, ((uintptr_t)g & 15) == 0 && lanes % 4 == 0};
  return launch_rows<float, true, NetOut::kSorted>(
      in, out_k, out_v, nullptr, m, width, start_kk, width, stream);
}

extern "C" int ia_k2_expand_sort_table(const void* table, const void* rT,
                                       const void* avT, void* out_k,
                                       void* out_v, int m, int ka,
                                       int lanes, int run, int width,
                                       int start_kk, void* stream) {
  return launch_rows<float, true, NetOut::kSorted>(
      table_in(table, rT, avT, ka, lanes, run), out_k, out_v, nullptr, m,
      width, start_kk, width, stream);
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
  return launch_rows<float, true, NetOut::kCompact>(
      rows_in<float>(key, val), out_col, out_val, nnz, m, width, start_kk,
      width, stream);
}

extern "C" int ia_k4_sort_compress_rows_f64(const void* key,
                                            const void* val, void* out_col,
                                            void* out_val, void* nnz, int m,
                                            int width, int start_kk,
                                            void* stream) {
  return launch_rows<double, true, NetOut::kCompact>(
      rows_in<double>(key, val), out_col, out_val, nnz, m, width, start_kk,
      width, stream);
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
  return launch_rows<float, true, NetOut::kSorted>(
      rows_in<float>(key, val), out_k, out_v, nullptr, m, width, start_kk,
      width, stream);
}

extern "C" int ia_k6_sort_f64(const void* key, const void* val, void* out_k,
                              void* out_v, int m, int width, int start_kk,
                              void* stream) {
  return launch_rows<double, true, NetOut::kSorted>(
      rows_in<double>(key, val), out_k, out_v, nullptr, m, width, start_kk,
      width, stream);
}

extern "C" int ia_k7a_expand_sort_packed(const void* table, const void* rT,
                                         const void* avT, void* out_p,
                                         int m, int ka, int lanes, int run,
                                         int width, int start_kk,
                                         void* stream) {
  return launch_k7a(PackedIn{table_in(table, rT, avT, ka, lanes, run)},
                    out_p, m, width, start_kk, stream);
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
