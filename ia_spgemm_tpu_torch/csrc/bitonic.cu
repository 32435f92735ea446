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
// (width, 128-row) transposed tiles are gone. All eight run the register
// network of sort_common.cuh (building block 3, row_net_rows): a row of W
// slots is held E = 8 (16 at W = 16384, and in K7a) slots a thread in
// registers; strides below 32E need no barrier, rows of at most 32E
// slots share a 128-thread block, and the compress is a segmented scan
// over warp shuffles. K1 gathers its products straight into registers
// (expand_slots) and sorts and compresses them; K2 does the same without
// the compress, from K1's gather g where the plan pregathered it and
// otherwise straight from the wide B table through the fragment index rT
// (TableIn, K8's source without slab rows), so the flat route and the
// serve lane write no gathered copy of the table; K3 compresses rows K2,
// K6 or K8 sorted, with no sort; K4 sorts and compresses pre-expanded rows
// (the wide classes, the ring's shards) and K5 the same rows of the cols
// layout, its first out_w survivors kept; K6 sorts them only, for K3; K7a
// (the bf16 serve lane) packs each of K2's table-source slots into one
// int32 key and sorts the keys alone (value type NoVal: no value shuffles,
// half the shared slots; 16 slots a thread, as keys alone leave the
// registers for them); K7b unpacks K7a's sorted keys in registers as it
// loads them (PackedRowsIn) and runs K3's compress on them. Bound: bytes
// (read the row or its fragments once, write out_w slots once, at 3.35
// TB/s); the network leaves the sorting kernels instruction-bound, a few
// times above it, and the compress alone (K3, K7b) within 1.3x of it on
// the main paths' rows (PERF.md).
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

// ---- the kernels on the register network (building block 3) -------------
// The rows, their sources (RowsIn, GatherIn, TableIn, PackedRowsIn),
// loads and stores are sort_common.cuh's (row_net_rows). Bound on this
// card: bytes, read the row (K1, K2, K7a: its fragments and A values; K7b:
// its packed keys) once and write out_w slots, at 3.35 TB/s.

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

// K4: sort + compress of pre-expanded rows, every survivor kept (out_w =
// width).
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

// K5: K4's network on the cols layout's pre-expanded rows (the classes up
// to FUSED_MAX_WIDTH), the first out_w survivors kept; its own symbol, so
// that torch.profiler tells its launches from K4's.
template <typename V, int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
k5_sort_compress(RowsIn<V> in, int* __restrict__ out_col,
                 V* __restrict__ out_val, int* __restrict__ nnz, int m,
                 int width, int start_kk, int out_w, int rows_per_block,
                 int vec_out) {
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

// K7b: K3's float32 duplicate sums and compaction (kCompact) or holes
// (kInPlace, compact=False) of K7a's sorted keys, each unpacked in
// registers as it is loaded (PackedRowsIn: _unpack_colval, :512). No
// sort; start_kk is unused.
template <int E, int kMaxThreads, NetOut kOut>
__global__ void __launch_bounds__(kMaxThreads)
k7b_compress_packed(PackedRowsIn in, int* __restrict__ out_col,
                    float* __restrict__ out_val, int* __restrict__ nnz,
                    int m, int width, int start_kk, int out_w,
                    int rows_per_block, int vec_out) {
  row_net_rows<float, E, false, kOut>(in, out_col, out_val, nnz, m, width,
                                      start_kk, out_w, rows_per_block,
                                      vec_out);
}

// The kernel of a (value type, E, launch bound, sort, output, source):
// K1 and K2 for the gather and the table, K7a for the packed table, K7b
// for the packed rows, K3 without the sort, K6 for the sorted row, K4 (K5
// where kK5: the same instance under K5's symbol).
template <typename V, int E, int kMaxThreads, bool kSort, NetOut kOut,
          bool kK5, typename In>
auto net_kernel() {
  if constexpr (std::is_same_v<In, PackedIn>)
    return &k7a_expand_sort_packed<E, kMaxThreads>;
  else if constexpr (std::is_same_v<In, PackedRowsIn>)
    return &k7b_compress_packed<E, kMaxThreads, kOut>;
  else if constexpr (!std::is_same_v<In, RowsIn<V>>) {
    if constexpr (kOut == NetOut::kCompact)
      return &k1_expand_sort_compress<E, kMaxThreads>;
    else
      return &k2_expand_sort<E, kMaxThreads, In>;
  } else if constexpr (!kSort)
    return &k3_compress<V, E, kMaxThreads, kOut>;
  else if constexpr (kOut == NetOut::kSorted)
    return &k6_sort_rows<V, E, kMaxThreads>;
  else if constexpr (kK5)
    return &k5_sort_compress<V, E, kMaxThreads>;
  else
    return &k4_sort_compress_rows<V, E, kMaxThreads>;
}

// The register network's launches: the instance for the row's width
// (E = 16 at 16384 and in K7a, 8 below otherwise; the launch bound the
// widest row it takes), rows of at most 32E slots (T <= 32 threads)
// sharing a 128-thread block. Each instance raises its own shared-memory
// limit once per device (the static local), to what its widest row
// needs.
template <typename V, int E, int kMaxThreads, bool kSort, NetOut kOut,
          bool kK5 = false, typename In>
int launch_row_net(const In& in, void* out_col, void* out_val, void* nnz,
                   int m, int width, int start_kk, int out_w,
                   void* stream) {
  static bool done[kMaxDevices];
  const auto kernel =
      net_kernel<V, E, kMaxThreads, kSort, kOut, kK5, In>();
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

template <typename V, bool kSort, NetOut kOut, bool kK5 = false,
          typename In>
int launch_rows(const In& in, void* out_col, void* out_val, void* nnz, int m,
                int width, int start_kk, int out_w, void* stream) {
#define IA_NET(E_, THREADS)                                                 \
  launch_row_net<V, E_, THREADS, kSort, kOut, kK5>(in, out_col, out_val,    \
                                                   nnz, m, width, start_kk, \
                                                   out_w, stream)
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

// The compress alone (K3 on sorted rows, K7b on sorted packed keys):
// compacted to out_w, or in place (out_w = width).
template <typename V, typename In>
int launch_compress(const In& in, void* out_col, void* out_val, void* nnz,
                    int m, int width, int out_w, int compact,
                    void* stream) {
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
  return launch_compress<float>(rows_in<float>(key, val), out_col, out_val,
                                nnz, m, width, out_w, compact, stream);
}

extern "C" int ia_k3_compress_f64(const void* key, const void* val,
                                  void* out_col, void* out_val, void* nnz,
                                  int m, int width, int out_w, int compact,
                                  void* stream) {
  return launch_compress<double>(rows_in<double>(key, val), out_col,
                                 out_val, nnz, m, width, out_w, compact,
                                 stream);
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
  return launch_rows<float, true, NetOut::kCompact, true>(
      rows_in<float>(key, val), out_col, out_val, nnz, m, width, start_kk,
      out_w, stream);
}

extern "C" int ia_k5_sort_compress_f64(const void* key, const void* val,
                                       void* out_col, void* out_val,
                                       void* nnz, int m, int width,
                                       int start_kk, int out_w,
                                       void* stream) {
  return launch_rows<double, true, NetOut::kCompact, true>(
      rows_in<double>(key, val), out_col, out_val, nnz, m, width, start_kk,
      out_w, stream);
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
  return launch_compress<float>(
      PackedRowsIn{(const int*)packed, ((uintptr_t)packed & 15) == 0},
      out_col, out_val, nnz, m, width, out_w, compact, stream);
}
