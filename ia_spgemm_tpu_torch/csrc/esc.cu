// The global ESC engine's expansion for Hopper (sm_90a), plain C ABI.
//
//   K14 ia_k14_esc_expand  <- no TPU kernel: the JAX package left this
//                             stage to XLA (ia_spgemm_tpu/ops/esc.py:214
//                             _expand_products, gathers and scans)
//
// The global engine (ops/esc.py) materialises every intermediate product
// of C = A @ B, sorts them by (row, column) and sums duplicate runs. K14
// writes the products: for each of the e_cap slots, the sort key
// row * n + col (int32 where (m+1)(n+1) < 2^31, else int64) and the value
// a * b, formed in the product type. A's entries own consecutive slots in
// entry order, each its B row's entries in B's order, so the slots are
// exactly those of the plain PyTorch version (ops/esc_kernels.py) and the
// stable sort after it sees the same input: C comes out bit for bit the
// same. Slots from E (the number of products) up to e_cap get the key
// m * n and the value 0.
//
// Where A's entries start in the slots comes from one torch cumsum before
// the launch: offs_end (nnza,) int32, the inclusive running sum of the B
// row lengths of A's entries, 0 for entries past nnz. The plain version
// broadcast each entry's row, value and B offset to its slots with scans
// over all e_cap slots (a single-block torch.cummax for float64 and for
// the entries' rows: 116 of 148 device ms a product on cage12 float64).
//
// What bounds it: bytes. It writes e_cap x (key + value) bytes, 8-16 a
// slot, and reads A's arrays once and B's arrays (which fit the 50 MB L2)
// about once: at 3.35 TB/s about 0.2 ms for cage12 float64's 41.9 M slots.
// So the design is a load-balanced expansion with no scan over products:
// each block of 256 threads owns a tile of 4096 consecutive slots. Warps
// 0 and 1 find the entries that cover the tile's first and last slot by
// a 32-way search of offs_end, and the rows of a chunk's first and last
// entry by the same search of A's row pointer; each entry of the chunk
// then finds its row by a binary search between those two rows, so no
// per-entry row array is made. The chunk's entries (end slot, B offset,
// row, A value) go to shared memory, and each thread finds the entry of
// each of its slots by a binary search there and writes key and value
// coalesced, in slot order. An entry longer than a tile spans tiles; a
// tile that meets more than kChunk entries (B rows of length 0 or 1)
// stages them a chunk at a time. No atomics, no allocation.
//
// Preconditions (the wrapper checks types and shapes; these would need a
// device sync): A's row pointer non-decreasing with row_ptr[m] >= every
// entry that owns a slot; offs_end as described; B's row pointer within
// its arrays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;                  // slots a thread
constexpr int kTile = kThreads * kSlots;    // slots a block
constexpr int kChunk = 1024;                // entries staged at once

// First i in [0, n) with a[i] > v (n if none), a non-decreasing; every
// lane of the calling warp takes part and gets the answer. Each round
// probes 32 evenly spaced points of the range left, so n = 2^21 takes 5.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ a,
                                                int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + 31) >> 5;
    const int i = lo + lane * stride;
    const bool gt = i >= hi || a[i] > v;
    const unsigned ball = __ballot_sync(0xffffffffu, gt);
    if (ball == 0) {
      lo += 31 * stride + 1;
    } else {
      const int f = __ffs(ball) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        const int nlo = lo + (f - 1) * stride + 1;
        hi = min(hi, lo + f * stride);
        lo = nlo;
      }
    }
  }
  return lo;
}

// The row of entry t: the last r in [0, m) with row_ptr[r] <= t.
__device__ __forceinline__ int warp_row_of(const int* __restrict__ row_ptr,
                                           int m, int t) {
  return min(max(warp_upper_bound(row_ptr, m + 1, t) - 1, 0), m - 1);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

template <class TA, class TB, class TP, class K>
__global__ void __launch_bounds__(kThreads)
k14_esc_expand(const int* __restrict__ a_rp, const int* __restrict__ a_col,
               const TA* __restrict__ a_val, const int* __restrict__ b_rp,
               const int* __restrict__ b_col, const TB* __restrict__ b_val,
               const int* __restrict__ offs_end, K* __restrict__ key,
               TP* __restrict__ val, int nnza, int m, int k, int n,
               int nnzb, int e_cap) {
  __shared__ int s_end[kChunk];    // the entry's last slot + 1
  __shared__ int s_base[kChunk];   // its B position less its first slot
  __shared__ int s_row[kChunk];
  __shared__ TA s_aval[kChunk];
  __shared__ int s_t[2], s_r[2], s_lo, s_hi;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int e0 = blockIdx.x * kTile;
  const int e1 = min(e0 + kTile, e_cap);
  const int E = nnza ? offs_end[nnza - 1] : 0;
  const int hiE = min(e1, E);

  if (e0 < hiE) {
    // the entries covering the tile's first and its last product slot
    if (warp < 2) {
      const int t = warp_upper_bound(offs_end, nnza, warp ? hiE - 1 : e0);
      if ((tid & 31) == 0) s_t[warp] = t;
    }
    __syncthreads();
    const int t_first = s_t[0], t_last = s_t[1];
    for (int t0 = t_first; t0 <= t_last; t0 += kChunk) {
      const int n_ent = min(kChunk, t_last - t0 + 1);
      if (warp < 2) {
        const int r = warp_row_of(a_rp, m, warp ? t0 + n_ent - 1 : t0);
        if ((tid & 31) == 0) s_r[warp] = r;
      }
      __syncthreads();
      const int r_lo = s_r[0], r_hi = s_r[1];
      for (int j = tid; j < n_ent; j += kThreads) {
        const int t = t0 + j;
        const int end = offs_end[t];
        const int start = t ? offs_end[t - 1] : 0;
        const int c = min(max(a_col[t], 0), k - 1);
        int lo = r_lo, hi = r_hi;  // the last r with a_rp[r] <= t
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (a_rp[mid] <= t) lo = mid; else hi = mid - 1;
        }
        s_end[j] = end;
        s_base[j] = b_rp[c] - start;
        s_row[j] = lo;
        s_aval[j] = a_val[t];
        if (j == 0) s_lo = max(e0, start);
        if (j == n_ent - 1) s_hi = min(hiE, end);
      }
      __syncthreads();
      const int lo_s = s_lo, hi_s = s_hi;
#pragma unroll 4
      for (int q = 0; q < kSlots; ++q) {
        const int s = e0 + q * kThreads + tid;
        if (s < lo_s || s >= hi_s) continue;
        int lo = 0, hi = n_ent - 1;  // the first entry ending past s
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[mid] > s) hi = mid; else lo = mid + 1;
        }
        const int bpos = min(max(s_base[lo] + s, 0), nnzb - 1);
        key[s] = (K)s_row[lo] * (K)n + (K)b_col[bpos];
        val[s] = mul((TP)s_aval[lo], (TP)b_val[bpos]);
      }
      __syncthreads();  // the next chunk overwrites shared memory
    }
  }
  const K pad = (K)m * (K)n;
  for (int q = 0; q < kSlots; ++q) {
    const int s = e0 + q * kThreads + tid;
    if (s >= max(e0, hiE) && s < e1) {
      key[s] = pad;
      val[s] = (TP)0;
    }
  }
}

template <class TA, class TB, class TP, class K>
int launch(const void* a_rp, const void* a_col, const void* a_val,
           const void* b_rp, const void* b_col, const void* b_val,
           const void* offs_end, void* key, void* val, int nnza, int m,
           int k, int n, int nnzb, int e_cap, cudaStream_t stream) {
  const int blocks = (int)(((long long)e_cap + kTile - 1) / kTile);
  k14_esc_expand<TA, TB, TP, K><<<blocks, kThreads, 0, stream>>>(
      (const int*)a_rp, (const int*)a_col, (const TA*)a_val,
      (const int*)b_rp, (const int*)b_col, (const TB*)b_val,
      (const int*)offs_end, (K*)key, (TP*)val, nnza, m, k, n, nnzb, e_cap);
  return (int)cudaGetLastError();
}

template <class K>
int launch_types(int types, const void* a_rp, const void* a_col,
                 const void* a_val, const void* b_rp, const void* b_col,
                 const void* b_val, const void* offs_end, void* key,
                 void* val, int nnza, int m, int k, int n, int nnzb,
                 int e_cap, cudaStream_t stream) {
#define IA_K14(TA, TB, TP)                                                  \
  launch<TA, TB, TP, K>(a_rp, a_col, a_val, b_rp, b_col, b_val, offs_end,  \
                        key, val, nnza, m, k, n, nnzb, e_cap, stream)
  switch (types) {
    case 0: return IA_K14(float, float, float);
    case 4: return IA_K14(float, float, double);
    case 6: return IA_K14(float, double, double);
    case 5: return IA_K14(double, float, double);
    case 7: return IA_K14(double, double, double);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IA_K14
}

}  // namespace

// Launches on `stream` (of the current device), does not synchronise,
// returns cudaGetLastError() (0 on success). A: a_rp (m+1,), a_col and
// a_val (nnza,); B: b_rp (k+1,), b_col and b_val (nnzb,); offs_end
// (nnza,) int32; key and val (e_cap,). types: bit 0 A's values float64,
// bit 1 B's, bit 2 the products', bit 3 int64 keys (else float32 and
// int32); float32 products only from float32 operands.
extern "C" int ia_k14_esc_expand(const void* a_rp, const void* a_col,
                                 const void* a_val, const void* b_rp,
                                 const void* b_col, const void* b_val,
                                 const void* offs_end, void* key, void* val,
                                 int nnza, int m, int k, int n, int nnzb,
                                 int e_cap, int types, void* stream) {
  if (e_cap <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (types & 8)
    return launch_types<long long>(types & 7, a_rp, a_col, a_val, b_rp,
                                   b_col, b_val, offs_end, key, val, nnza,
                                   m, k, n, nnzb, e_cap, st);
  return launch_types<int>(types, a_rp, a_col, a_val, b_rp, b_col, b_val,
                           offs_end, key, val, nnza, m, k, n, nnzb, e_cap,
                           st);
}
