// Dense-row accumulator SpGEMM kernel for Hopper (sm_90a), plain C ABI.
//
//   K11 ia_k11_dense_row[_f64]  <- ia_spgemm_tpu/ops/dense_row.py:35 _kernel
//
// C = A @ B with A in ELL and B dense: every output row is a dense
// accumulator, acc[r, :] += a_val[r, kk] * B[a_col[r, kk], :] over the
// row's ELL slots, empty slots (a_col < 0) skipped. The TPU kernel kept a
// (tile_rows, n) accumulator in VMEM and double-buffered aligned 8-row
// groups of B by DMA, one group per A slot.
//
// What bounds it on this card: not the bytes of the bound. The bound
// reads B once and writes C once; a kernel that reads one B row segment
// per A slot moves about 4*K*n bytes of B per output row through L2 (18
// GB on build_matrix(m=16384), 17 live slots a row) for 4*n bytes of C.
// Reading each distinct segment of a tile of rows once cuts that to ~10.7
// GB at 8 rows a tile; what is left is mostly the 8 random columns a row,
// which no two rows share. Then the B traffic and the work per segment
// (its copy, its wait, the walk over its entries) set the pace, so a
// thread takes as many columns of each segment as its registers allow
// (kVecs vectors of 16 bytes) and a tile stays small (kRows = 8). A block
// owns one tile of kRows consecutive output rows and one chunk of W
// columns (1024 float32 / 512 float64: a 64 MB column slice of a
// 16384-row B, mostly held by the 50 MB L2), and the grid is chunk-major
// with the tile as the fast index, so the blocks in flight share one
// slice:
//   1. The tile's slots (kRows x kcp, kcp = min(K, kSlots) rounded up to
//      a power of two; K > kSlots in passes of kSlots) go to shared
//      memory as 64-bit keys (column, tile index), empty slots last, and
//      a bitonic network sorts them.
//   2. A block scan marks each distinct column's run: the tile's
//      segments, each read once however many of its rows reference it;
//      each entry's value and tile row are laid out in entry order.
//   3. Each thread keeps kRows x kVecs x (16 bytes of V) accumulators in
//      registers, indexed by constants (a switch on the entry's row), and
//      walks the segments in column order. Its vectors of each segment
//      come through a cp.async ring in shared memory, kStages - 1
//      segments in flight ahead of the one it applies; the ring slots are
//      the thread's own, so no barrier guards them. Each segment is
//      applied to the rows whose entries follow it, in entry order; a row
//      that does not reference it is never touched (0 * inf is NaN).
//   4. C goes out with streaming stores (st.global.cs), so that it does
//      not push B's slice out of L2.
// The sort is repeated by each column chunk's block; a first kernel that
// wrote each tile's schedule once for the others to read was slower
// (PERF.md, section 6).
// Order of the sums: a row's products are added in ascending (column,
// slot) order within each pass of kSlots slots, passes in slot order. An
// ELL built from canonical CSR holds each row's columns ascending, so
// that is slot order, and with the multiply and the add rounded
// separately (no FMA), as the plain version does, the two agree bit for
// bit. Rows with unsorted columns get their products in another order
// than the plain version's (tests/test_torch_k11_tiles.py models the
// schedule step for step and states that tolerance).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;                    // output rows of a tile
constexpr int kSlots = 32;                  // slots of a row in one pass
constexpr int kMaxEntries = kRows * kSlots;
constexpr int kStages = 8;                  // ring slots per thread (2^i)
constexpr int kVecs = 2;                    // 16-byte vectors per thread
constexpr unsigned long long kEmpty = ~0ull;

// 16 bytes of V: one of a thread's vectors of a segment.
template <typename V>
struct Vec16;
template <>
struct Vec16<float> {
  using T = float4;
  static constexpr int N = 4;
};
template <>
struct Vec16<double> {
  using T = double2;
  static constexpr int N = 2;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int S>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(S)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide exclusive scan of one int per thread; *total gets the sum.
__device__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int wt = lane < kThreads / 32 ? warp_tot[lane] : 0;
    int wi = wt;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = wi - wt;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return warp_tot[wid] + incl - x;
}

__device__ __forceinline__ void unpack(float4 x, float (&v)[4]) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void unpack(double2 x, double (&v)[2]) {
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ float4 pack(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack(const double (&v)[2]) {
  return make_double2(v[0], v[1]);
}

template <typename V, int J, int N>
__device__ __forceinline__ void madd(V (&acc)[J][N], V v,
                                     const V (&bv)[J][N]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e)
      acc[j][e] = add_rn(acc[j][e], mul_rn(v, bv[j][e]));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
k11_dense_row(const int32_t* __restrict__ a_col, const V* __restrict__ a_val,
              const V* __restrict__ b, V* __restrict__ out, int m, int K,
              int n, int n_tiles, int vec) {
  constexpr int N = Vec16<V>::N;
  constexpr int kStride = kThreads * N;        // columns between a thread's
  constexpr int W = kStride * kVecs;           // vectors; the chunk
  using VT = typename Vec16<V>::T;
  __shared__ unsigned long long keys[kMaxEntries];
  __shared__ V tile_v[kMaxEntries];
  __shared__ V ent_v[kMaxEntries];             // entry e: value, tile row
  __shared__ int ent_r[kMaxEntries];
  __shared__ int seg_col[kMaxEntries];
  __shared__ int seg_start[kMaxEntries + 1];
  __shared__ int scan[kThreads / 32 + 1];
  __shared__ __align__(16) V ring[kStages][kVecs][kStride];

  const int row0 = (blockIdx.x % n_tiles) * kRows;
  const int c0 = (blockIdx.x / n_tiles) * W + threadIdx.x * N;
  V acc[kRows][kVecs][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[r][j][e] = V(0);

  int kcp = 1;
  while (kcp < K && kcp < kSlots) kcp <<= 1;
  const int shift = 31 - __clz(kcp);
  const int n_ent = kRows * kcp;                   // a power of two
  const int per = n_ent >= kThreads ? n_ent / kThreads : 1;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_ent);

  for (int k0 = 0; k0 < K; k0 += kcp) {
    __syncthreads();          // the previous pass is done with the lists
    // 1. the tile's slots as keys (column, tile index), empty slots last
    for (int i = threadIdx.x; i < n_ent; i += kThreads) {
      const int row = row0 + (i >> shift);
      const int kk = k0 + (i & (kcp - 1));
      unsigned long long key = kEmpty;
      if (row < m && kk < K) {
        const size_t s = (size_t)row * K + kk;
        const int c = a_col[s];
        if (c >= 0) {
          key = ((unsigned long long)c << 32) | (unsigned)i;
          tile_v[i] = a_val[s];
        }
      }
      keys[i] = key;
    }
    for (int kk = 2; kk <= n_ent; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        __syncthreads();
        for (int t = threadIdx.x; t < n_ent / 2; t += kThreads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const unsigned long long x = keys[i], y = keys[i + j];
          if ((x > y) == ((i & kk) == 0)) {
            keys[i] = y;
            keys[i + j] = x;
          }
        }
      }
    }
    __syncthreads();
    // 2. one segment per distinct column: heads (low 16 bits) and live
    // entries (high 16 bits) counted and scanned together (<= 256 each)
    int cnt = 0;
    for (int i = lo; i < hi; ++i) {
      const unsigned long long x = keys[i];
      if (x == kEmpty) continue;
      const bool head = i == 0 || (x >> 32) != (keys[i - 1] >> 32);
      cnt += (1 << 16) | (int)head;
    }
    int pos = block_exclusive_scan(cnt, scan, scan + kThreads / 32) & 0xffff;
    for (int i = lo; i < hi; ++i) {
      const unsigned long long x = keys[i];
      if (x == kEmpty) continue;
      ent_v[i] = tile_v[(unsigned)x];
      ent_r[i] = (int)(unsigned)x >> shift;
      if (i == 0 || (x >> 32) != (keys[i - 1] >> 32)) {
        seg_col[pos] = (int)(x >> 32);
        seg_start[pos] = i;
        ++pos;
      }
    }
    const int total = scan[kThreads / 32];
    const int n_seg = total & 0xffff;
    if (threadIdx.x == 0) seg_start[n_seg] = total >> 16;
    __syncthreads();
    // 3. the segments in column order through the ring
    auto issue = [&](int d) {
      if (d < n_seg) {
        const V* src = b + (size_t)seg_col[d] * n;
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int c = c0 + j * kStride;
          V* dst = &ring[d & (kStages - 1)][j][threadIdx.x * N];
          if (c >= n) continue;
          if (vec) {
            cp_async16(dst, src + c);
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e)
              if (c + e < n)
                cp_async_elem<(int)sizeof(V)>(dst + e, src + c + e);
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int d = 0; d < kStages - 1; ++d) issue(d);
    for (int d = 0; d < n_seg; ++d) {
      issue(d + kStages - 1);
      cp_async_wait<kStages - 1>();
      V bv[kVecs][N];
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        unpack(*reinterpret_cast<const VT*>(
                   &ring[d & (kStages - 1)][j][threadIdx.x * N]),
               bv[j]);
      const int e1 = seg_start[d + 1];
      for (int e = seg_start[d]; e < e1; ++e) {
        const V v = ent_v[e];
        switch (ent_r[e]) {
#define IA_K11_ROW(R_) \
  case R_:             \
    madd(acc[R_], v, bv); \
    break;
          IA_K11_ROW(0) IA_K11_ROW(1) IA_K11_ROW(2) IA_K11_ROW(3)
          IA_K11_ROW(4) IA_K11_ROW(5) IA_K11_ROW(6) IA_K11_ROW(7)
#undef IA_K11_ROW
        }
      }
    }
    cp_async_wait<0>();
  }
  static_assert(kRows == 8, "the switch above names 8 rows");

  // 4. streaming stores of the tile's rows
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= m) break;
    V* orow = out + (size_t)(row0 + r) * n;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int c = c0 + j * kStride;
      if (c >= n) continue;
      if (vec) {
        __stcs(reinterpret_cast<VT*>(orow + c), pack(acc[r][j]));
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (c + e < n) __stcs(orow + c + e, acc[r][j][e]);
      }
    }
  }
}

template <typename V>
int launch_k11(const void* a_col, const void* a_val, const void* b,
               void* out, int m, int K, int n, void* stream) {
  constexpr int W = kThreads * Vec16<V>::N * kVecs;
  const int n_tiles = (m + kRows - 1) / kRows;
  const long long blocks = (long long)n_tiles * ((n + W - 1) / W);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // 16-byte segments and stores: rows of B and C start on the 16-byte
  // grid when n is a multiple of 16 / sizeof(V) and both bases do
  const int vec = n % Vec16<V>::N == 0
                  && (((uintptr_t)b | (uintptr_t)out) & 15) == 0;
  k11_dense_row<V><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_col, (const V*)a_val, (const V*)b, (V*)out, m, K, n,
      n_tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (of the current device), does not synchronise,
// returns cudaGetLastError() (0 on success). a_col/a_val (m, K), b (k, n),
// out (m, n), all row-major; every a_col entry is -1 or a row of b; the
// values are float32 (ia_k11_dense_row) or float64 (_f64).
extern "C" int ia_k11_dense_row(const void* a_col, const void* a_val,
                                const void* b, void* out, int m, int K,
                                int n, void* stream) {
  return launch_k11<float>(a_col, a_val, b, out, m, K, n, stream);
}

extern "C" int ia_k11_dense_row_f64(const void* a_col, const void* a_val,
                                    const void* b, void* out, int m, int K,
                                    int n, void* stream) {
  return launch_k11<double>(a_col, a_val, b, out, m, K, n, stream);
}
