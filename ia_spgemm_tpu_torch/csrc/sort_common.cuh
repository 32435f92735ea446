// Building blocks shared by the sort kernels of bitonic.cu (K1-K7)
// and slab.cu (K8-K10): the register network with its row sources
// (pre-expanded rows, K1's gather, the B table read through a fragment
// index, K7a's sorted packed keys), its register compress and its stores
// (K1-K9, building block 3); and the duplicate-sum / compaction of a
// sorted row in shared memory with a block-wide scan (K10 alone, building
// block 2).
//
// Conventions shared with the JAX package: SENTINEL = INT32_MAX marks an
// empty product slot and sorts last (signed int32 compares); empty output
// slots are col -1 / value 0; a fragment's direction (forward or reversed
// run) follows its fragment index e, not its packed row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxWidth = 16384;

// Threads per block of the shared-memory compress (K10) for a row of
// `width` slots (a power of two, 128..16384): width / 2, at most 1024.
inline int threads_for(int width) {
  int t = width / 2;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// ---- building block 2: the shared-memory compress (K10) ----------------
// One block per sorted row held in shared memory: each thread counts the
// survivors of its contiguous chunk, one block-wide scan ranks them, and
// each survivor's run sum goes to its rank. Barriers, and few threads a
// block (width / 2), not bytes, bound it; the register network's compress
// (row_net_scan below) is K1's, K3's, K4's, K5's and K7b's.
__device__ __forceinline__ bool emits(const int* k, int i, int width) {
  int key = k[i];
  return key != kSentinel && (i == width - 1 || k[i + 1] != key);
}

// Sum of the duplicate run ending at its last slot i.
template <typename V>
__device__ __forceinline__ V run_sum(const int* k, const V* v, int i) {
  int key = k[i];
  V s = v[i];
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

// Where compress_row writes a value: the float32 pair hi = f32(s),
// lo = f32(s - hi) of a float64 sum. s - hi is exact in float64 and no
// product is involved, so FMA contraction cannot change it.
struct DDOut {
  float* hi;
  float* lo;
  __device__ void put(int i, double s) const {
    float h = __double2float_rn(s);
    hi[i] = h;
    lo[i] = __double2float_rn(s - (double)h);
  }
  __device__ void zero(int i) const {
    hi[i] = 0.f;
    lo[i] = 0.f;
  }
};

// Sorted row (k, v) in shared memory -> duplicate sums, nnz, and the
// survivors compacted left into the row's `width` slots, -1 / 0 past
// them. Each thread scans a contiguous chunk so ranks keep column order.
template <typename V, typename Out>
__device__ void compress_row(const int* k, const V* v, int width,
                             int* out_col, Out out, int* nnz,
                             int* scratch) {
  const int nt = blockDim.x;
  const int chunk = width / nt;
  const int lo = threadIdx.x * chunk;
  int cnt = 0;
  for (int i = lo; i < lo + chunk; ++i) cnt += emits(k, i, width);
  int off = block_exclusive_scan(cnt, scratch, scratch + 32);
  const int total = scratch[32];
  for (int i = lo; i < lo + chunk; ++i) {
    if (!emits(k, i, width)) continue;
    out_col[off] = k[i];
    out.put(off, run_sum(k, v, i));
    ++off;
  }
  for (int p = total + threadIdx.x; p < width; p += nt) {
    out_col[p] = -1;
    out.zero(p);
  }
  if (threadIdx.x == 0) *nnz = total;
}

// ---- building block 3: the register network (K1-K9) --------------------
// A row of W slots (W a power of two, 128..16384) is held E slots per
// thread in registers, T = W / E threads per row: E = 8, or 16 at 16384
// so that a row stays at 1024 threads (and in K7a, whose keys alone
// leave the registers for 16). In the normal layout row thread t (lane =
// t % 32) holds slots t*E .. t*E + E - 1. A bitonic stage kk compares
// strides kk/2 .. 1:
//   - strides below E inside a thread (registers, no synchronisation);
//   - strides E .. 16E between the lanes of a warp (__shfl_xor_sync);
//   - strides of 32E and more (rows of more than one warp) in the
//     transposed layout, whose slot order swaps the index's top wb bits
//     (the warp bits, wb = log2(W) - log2(E) - 5) with its bottom wb bits:
//     one exchange through shared memory behind one barrier into it, the
//     stage's large strides there as register / lane strides, one
//     exchange back. Each thread writes only the shared slots it read in
//     the previous exchange, so one barrier per exchange suffices.
// tests/test_torch_k4_network.py models this schedule step for step,
// tests/test_torch_k1_k3_network.py K1's gather into registers and K3's
// compress alone, tests/test_torch_k8_k9_network.py the table source of
// K8 and K9, tests/test_torch_k2_k7a_network.py that of K2 and K7a and
// K7a's key-only sort, tests/test_torch_k5_k7b_network.py K5's capped
// compress and K7b's unpacking source. K4 is the sort and the compress,
// K5 the same with the first out_w survivors kept, K6 the sort without
// the compress, K3 the compress without the sort, K7b the same of K7a's
// packed keys unpacked as they are loaded, K1 the sort and compress of
// slots gathered straight into registers, K2 the sort of slots gathered
// from K1's g or from the B table, K7a the same with each slot packed
// into its key and the keys sorted alone (value type NoVal), K8 / K9 the
// sort of a slab's slots gathered straight from the packed B table.
// Rows of at most 32E slots are one warp's work or less (T <= 32), sort
// without shared memory, and share a block (rows_per_block).
// Shared slots are XOR-swizzled within each 32-word line (swz), which
// keeps both layouts' accesses free of bank conflicts up to W = 8192; swz
// and the transposed order are linear in the slot's bits, so a thread's
// E addresses are its first one XORed with per-register constants.
// Splitting a row over a thread-block cluster (its slots spread over the
// blocks' shared memory, strides across blocks exchanged through
// distributed shared memory) was measured for the launches of fewer rows
// than SMs and lost to one block per row (PERF.md, PR 6).

// The value type of a key-only network (K7a's packed keys): it carries
// nothing, and every step that would move a value (a shuffle, a shared
// slot, a store) is compiled out for it (kCarries).
struct NoVal {
  NoVal() = default;
  __host__ __device__ constexpr NoVal(int) {}
};

template <typename V>
constexpr bool kCarries = !std::is_same_v<V, NoVal>;

// Bytes of one value in shared memory: none for NoVal.
template <typename V>
constexpr size_t kValBytes = kCarries<V> ? sizeof(V) : 0;

template <int E>
struct RowShape {
  int W, T, L, nw;   // slots, threads, lanes per segment, warps per row
  int n_bits, wb;    // log2(W), warp bits
  __device__ RowShape(int width) : W(width), T(width / E) {
    L = T < 32 ? T : 32;
    nw = T / L;
    n_bits = 31 - __clz(width);
    wb = n_bits - (31 - __clz(E)) - 5;
  }
};

__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 5) ^ (i >> 8)) & 31);
}

// The row slot at position p of the transposed layout (an involution).
__device__ __forceinline__ int transposed_slot(int p, int n_bits, int wb) {
  const int lo_mask = (1 << wb) - 1;
  const int shift = n_bits - wb;
  return ((p & lo_mask) << shift) | (p & ((1 << shift) - 1) & ~lo_mask)
         | (p >> shift);
}

template <typename V>
__device__ __forceinline__ void cmp_swap(int& ka, V& va, int& kb, V& vb,
                                         bool asc) {
  const int lo = min(ka, kb), hi = max(ka, kb);
  const int na = asc ? lo : hi;
  const bool sw = na != ka;
  kb = asc ? hi : lo;
  ka = na;
  const V tv = sw ? vb : va;
  vb = sw ? va : vb;
  va = tv;
}

// Compares of one stage from stride jhi down to 1, positions base + r
// (base = t*E in the thread's layout): position p meets p + j where bit
// j of p is clear, ascending where p & dirbit == 0.
template <int E, typename V>
__device__ __forceinline__ void row_net_steps(int (&k)[E], V (&v)[E],
                                              int base, int dirbit, int jhi,
                                              int L) {
  for (int j = jhi; j >= E; j >>= 1) {
    const bool lower = (base & j) == 0;
    const bool keep_min = lower == ((base & dirbit) == 0);
    const int m = j / E;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int pk = __shfl_xor_sync(0xffffffffu, k[r], m, L);
      const int nk = keep_min ? min(k[r], pk) : max(k[r], pk);
      if constexpr (kCarries<V>) {
        const V pv = __shfl_xor_sync(0xffffffffu, v[r], m, L);
        v[r] = nk != k[r] ? pv : v[r];
      }
      k[r] = nk;
    }
  }
#pragma unroll
  for (int jj = E / 2; jj > 0; jj >>= 1) {
    if (jj > jhi) continue;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & jj) continue;
      cmp_swap(k[r], v[r], k[r + jj], v[r + jj], ((base + r) & dirbit) == 0);
    }
  }
}

// One exchange between the normal and the transposed layout: write the
// thread's slots at the `from` layout's shared addresses, barrier, read
// them back at the `to` layout's.
template <int E, typename V>
__device__ __forceinline__ void row_net_exchange(
    int (&k)[E], V (&v)[E], int* ks, V* vs, int base, bool to_transposed,
    const RowShape<E>& sh) {
  constexpr int kBits = E == 16 ? 4 : 3;
  // swizzled addresses: normal swz(base) ^ r; transposed the same XOR of
  // its first address with each register bit's image
  const int an = swz(base);
  const int at = swz(transposed_slot(base, sh.n_bits, sh.wb));
  int bt[kBits];
#pragma unroll
  for (int b = 0; b < kBits; ++b)
    bt[b] = swz(transposed_slot(1 << b, sh.n_bits, sh.wb));
#pragma unroll
  for (int r = 0; r < E; ++r) {
    int a_t = at;
#pragma unroll
    for (int b = 0; b < kBits; ++b)
      if ((r >> b) & 1) a_t ^= bt[b];
    const int a = to_transposed ? (an ^ r) : a_t;
    ks[a] = k[r];
    if constexpr (kCarries<V>) vs[a] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    int a_t = at;
#pragma unroll
    for (int b = 0; b < kBits; ++b)
      if ((r >> b) & 1) a_t ^= bt[b];
    const int a = to_transposed ? a_t : (an ^ r);
    k[r] = ks[a];
    if constexpr (kCarries<V>) v[r] = vs[a];
  }
}

// The sort: stages start_kk .. W over the thread's slots (normal layout
// in and out). ks / vs: the row's W shared slots (rows of more than one
// warp). tid: the thread's index in its row.
template <int E, typename V>
__device__ __forceinline__ void row_net_sort(int (&k)[E], V (&v)[E],
                                             int* ks, V* vs, int tid,
                                             int start_kk,
                                             const RowShape<E>& sh) {
  const int base = tid * E;
  const int big = 32 * E;
  for (int kk = start_kk; kk <= sh.W; kk <<= 1) {
    int j = kk >> 1;
    if (j >= big) {
      const int kt = kk >> (sh.n_bits - sh.wb);
      row_net_exchange(k, v, ks, vs, base, true, sh);
      row_net_steps(k, v, base, kk < sh.W ? kt : 0, kt >> 1, 32);
      row_net_exchange(k, v, ks, vs, base, false, sh);
      j = big >> 1;
    }
    row_net_steps(k, v, base, kk, j, sh.L);
  }
}

// Shared scratch of the compress (rows of more than one warp): per warp
// its first and last key, and its (head seen, trailing run sum,
// survivors) aggregate.
template <typename V>
struct RowScratch {
  V sum[32];
  int first[32], last[32], flag[32], cnt[32];
};

// What the compress's scan leaves each thread: which of its slots head a
// run and which end one that survives (bit r for slot r), the run sum
// carried into its first slot from the threads before it, the survivors
// before it and in the whole row.
template <typename V>
struct RunScan {
  unsigned head, emit;
  V ax;
  int cx, total;
};

// The scan of a sorted row (normal layout, in registers), as the JAX
// kernel's segmented scan does it (bitonic.py:253-265): per-thread
// segmented sums (in place in v), a lane scan of (head seen, trailing run
// sum, survivors) by shuffles, the warps' aggregates scanned through
// shared memory (two barriers; none where a row is a warp or less). A
// survivor's run sum is then v[r] where a head precedes it in its
// thread, ax + v[r] otherwise.
template <int E, typename V>
__device__ __forceinline__ RunScan<V> row_net_scan(
    const int (&k)[E], V (&v)[E], int tid, const RowShape<E>& sh,
    RowScratch<V>* sc) {
  const unsigned full = 0xffffffffu;
  const int L = sh.L;
  const int lane = tid % L, wr = tid / L;
  int prev = __shfl_up_sync(full, k[E - 1], 1, L);
  int next = __shfl_down_sync(full, k[0], 1, L);
  bool has_prev = lane > 0, has_next = lane < L - 1;
  if (sh.nw > 1) {
    if (lane == 0) sc->first[wr] = k[0];
    if (lane == L - 1) sc->last[wr] = k[E - 1];
    __syncthreads();
    if (lane == 0 && wr > 0) {
      prev = sc->last[wr - 1];
      has_prev = true;
    }
    if (lane == L - 1 && wr < sh.nw - 1) {
      next = sc->first[wr + 1];
      has_next = true;
    }
  }
  unsigned head = 0, emit = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool h = r == 0 ? (!has_prev || k[0] != prev) : k[r] != k[r - 1];
    const bool l = r == E - 1 ? (!has_next || k[E - 1] != next)
                              : k[r] != k[r + 1];
    head |= (unsigned)h << r;
    emit |= (unsigned)(l && k[r] != kSentinel) << r;
  }
#pragma unroll
  for (int r = 1; r < E; ++r)        // per-thread segmented sums, in place
    if (!((head >> r) & 1)) v[r] += v[r - 1];
  int fi = head != 0, ci = __popc(emit);
  V ai = v[E - 1];
  for (int d = 1; d < L; d <<= 1) {
    const int fo = __shfl_up_sync(full, fi, d, L);
    const V ao = __shfl_up_sync(full, ai, d, L);
    const int co = __shfl_up_sync(full, ci, d, L);
    if (lane >= d) {
      ai = fi ? ai : ao + ai;
      fi |= fo;
      ci += co;
    }
  }
  int fx = __shfl_up_sync(full, fi, 1, L);
  V ax = __shfl_up_sync(full, ai, 1, L);
  int cx = __shfl_up_sync(full, ci, 1, L);
  if (lane == 0) {
    fx = 0;
    ax = V(0);
    cx = 0;
  }
  int total = __shfl_sync(full, ci, L - 1, L);
  if (sh.nw > 1) {
    if (lane == L - 1) {
      sc->flag[wr] = fi;
      sc->sum[wr] = ai;
      sc->cnt[wr] = ci;
    }
    __syncthreads();
    // every warp scans the warps' aggregates (nw <= 32) itself
    int wf = lane < sh.nw ? sc->flag[lane] : 0;
    V wa = lane < sh.nw ? sc->sum[lane] : V(0);
    int wc = lane < sh.nw ? sc->cnt[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int fo = __shfl_up_sync(full, wf, d);
      const V ao = __shfl_up_sync(full, wa, d);
      const int co = __shfl_up_sync(full, wc, d);
      if (lane >= d) {
        wa = wf ? wa : ao + wa;
        wf |= fo;
        wc += co;
      }
    }
    total = __shfl_sync(full, wc, sh.nw - 1);
    const int pf = __shfl_sync(full, wf, (wr + 31) & 31);
    const V pa = __shfl_sync(full, wa, (wr + 31) & 31);
    const int pc = __shfl_sync(full, wc, (wr + 31) & 31);
    if (wr > 0) {          // the warps before this one, then the lanes
      ax = fx ? ax : pa + ax;
      fx |= pf;
      cx += pc;
    }
  }
  return {head, emit, ax, cx, total};
}

// The sorted row -> duplicate sums, nnz and the survivors compacted left
// (K1, K3-K5, K7b): each survivor goes to its rank in the row's W shared
// slots (ks / vs, free once the sort is done), and after one more barrier
// every thread takes back its own E slots (-1 / 0 past the survivors)
// into k / v, for coalesced stores by the caller. Returns the row's
// survivors.
template <int E, typename V>
__device__ __forceinline__ int row_net_compress(
    int (&k)[E], V (&v)[E], int tid, const RowShape<E>& sh,
    RowScratch<V>* sc, int* ks, V* vs) {
  const RunScan<V> s = row_net_scan<E, V>(k, v, tid, sh, sc);
  int pos = s.cx;
  bool seen = false;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    seen |= (s.head >> r) & 1;
    if ((s.emit >> r) & 1) {
      ks[swz(pos)] = k[r];
      vs[swz(pos)] = seen ? v[r] : s.ax + v[r];
      ++pos;
    }
  }
  __syncthreads();
  const int an = swz(tid * E);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = tid * E + r;
    k[r] = p < s.total ? ks[an ^ r] : -1;
    v[r] = p < s.total ? vs[an ^ r] : V(0);
  }
  return s.total;
}

// The sorted row -> duplicate sums and nnz, each survivor left at its
// sorted slot with its run's sum and -1 / 0 in every other slot (K3's and
// K7b's compact=False): no shared slots, no staging. Returns the
// row's survivors.
template <int E, typename V>
__device__ __forceinline__ int row_net_mark(int (&k)[E], V (&v)[E], int tid,
                                            const RowShape<E>& sh,
                                            RowScratch<V>* sc) {
  const RunScan<V> s = row_net_scan<E, V>(k, v, tid, sh, sc);
  bool seen = false;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    seen |= (s.head >> r) & 1;
    const bool e = (s.emit >> r) & 1;
    v[r] = e ? (seen ? v[r] : s.ax + v[r]) : V(0);
    k[r] = e ? k[r] : -1;
  }
  return s.total;
}

// ---- the network's rows: sources, loads, stores, the one routine --------
// One row per block for rows of more than 32E slots (T = W / E threads),
// several rows per 128-thread block below that. Each thread brings its E
// slots into registers (RowsIn: 16-byte vector loads of the row, scalar
// where a pointer is off the 16-byte grid; PackedRowsIn the same of the
// packed keys, each unpacked as it is loaded; GatherIn, TableIn: the
// expand, expand_slots; K7a's source packs each expanded slot into its
// key), sorts them there (all but K3 and K7b), compresses them (K1,
// K3-K5, K7b) and stores E slots of the row with 16-byte vector stores
// where the row pointers and out_w allow them. K2, K6, K7a (keys only),
// K8 and K9 store the sorted row; K1, K3-K5 and K7b the compacted row
// (staged through shared memory: survivors written straight to their
// ranks would leave a warp's stores scattered over 32 sectors each), its
// first out_w slots; K3 and K7b with compact=False each survivor at its
// sorted slot, holes -1 / 0, straight from registers. The row stays in
// registers between that one read and one write, with block barriers
// only for the sort's strides of 32E and more (two per such stage) and
// three in the compress (one, or none in the in-place mode, where a row
// is a warp or less).

template <int E>
__device__ __forceinline__ void load_keys(int (&k)[E], const int* p,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p) + q);
      k[4 * q] = x.x;
      k[4 * q + 1] = x.y;
      k[4 * q + 2] = x.z;
      k[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) k[r] = p[r];
  }
}

template <int E>
__device__ __forceinline__ void load_vals(float (&v)[E], const float* p,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = p[r];
  }
}

template <int E>
__device__ __forceinline__ void load_vals(double (&v)[E], const double* p,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      const double2 x = __ldg(reinterpret_cast<const double2*>(p) + q);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = p[r];
  }
}

// Four values at p (16-byte aligned): one float4, or two double2.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The thread's slots base .. base + E - 1, those below out_w, into the
// row's out_col / out_val (no out_val for NoVal). vec: both row pointers
// on the 16-byte grid and out_w a multiple of 4, so that each quad of
// slots is wholly below out_w or wholly past it.
template <int E, typename V>
__device__ __forceinline__ void store_slots(int* out_col, V* out_val,
                                            const int (&k)[E],
                                            const V (&v)[E], int base,
                                            int out_w, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      if (base + 4 * q >= out_w) continue;
      *reinterpret_cast<int4*>(out_col + base + 4 * q) =
          make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
      if constexpr (kCarries<V>) store4(out_val + base + 4 * q, v + 4 * q);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (base + r >= out_w) continue;
      out_col[base + r] = k[r];
      if constexpr (kCarries<V>) out_val[base + r] = v[r];
    }
  }
}

// A product of an A value and a B value's bits: rounded once in float32
// (__fmul_rn, never contracted into a later sum), or exact in float64
// (two 24-bit mantissas fit 53 bits).
template <typename V>
__device__ __forceinline__ V product(float a, int b_bits);

template <>
__device__ __forceinline__ float product<float>(float a, int b_bits) {
  return __fmul_rn(a, __int_as_float(b_bits));
}

template <>
__device__ __forceinline__ double product<double>(float a, int b_bits) {
  return __dmul_rn((double)a, (double)__int_as_float(b_bits));
}

// One fragment as the expand reads it: its half of the packed row
// (columns at src[0 .. run), value bits at src[run .. 2 * run)), its A
// value and the base its columns add to their keys.
struct Frag {
  const int32_t* src;
  float a;
  int key0;
};

// The expand into registers (K1, K2, K7a, K8, K9): slot p of the row is
// position p % run of fragment e = p / run, frag(e) its Frag. The key is
// key0 + the column, the value product<V>(a, the B value); a column < 0
// and every slot past ka * run become SENTINEL / 0 by a select (padded
// class rows and slabs carry NaN or junk A values). Where run is a
// multiple of E, the thread's E slots are E neighbouring lanes of one
// fragment: one frag(e), E columns and E value bits, by 16-byte loads
// where vec allows (the source on the 16-byte grid, its rows a multiple
// of 4 lanes long); else (run < E) each slot finds its own fragment.
template <int E, typename V, typename FragAt>
__device__ __forceinline__ void expand_slots(int (&k)[E], V (&v)[E],
                                             int base, int run, int ka,
                                             bool vec, FragAt frag) {
  if (run % E == 0) {
    const int e = base / run;
    if (e >= ka) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        k[r] = kSentinel;
        v[r] = V(0);
      }
      return;
    }
    const Frag f = frag(e);
    const int32_t* src = f.src + (base - e * run);
    int b[E];
    load_keys<E>(k, src, vec);
    load_keys<E>(b, src + run, vec);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const bool ok = k[r] >= 0;
      v[r] = ok ? product<V>(f.a, b[r]) : V(0);
      k[r] = ok ? f.key0 + k[r] : kSentinel;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = base + r;
    const int e = p / run;
    k[r] = kSentinel;
    v[r] = V(0);
    if (e < ka) {
      const Frag f = frag(e);
      const int32_t* src = f.src + (p - e * run);
      const int c = __ldg(src);
      if (c >= 0) {
        k[r] = f.key0 + c;
        v[r] = product<V>(f.a, __ldg(src + run));
      }
    }
  }
}

// Where a block's rows come from. RowsIn: (m, width) keys and values in
// device memory (K3-K6). PackedRowsIn: (m, width) sorted (col << 16 |
// bf16) keys, K7a's output (K7b). GatherIn: K1's fragment gather g
// (ceil(ka / pack), m, lanes) and A values avT (ka, m) (K1, and K2 on
// pregathered classes). TableIn: a packed B table (F + 1, lanes) read
// through the fragment index rT (ka, m), with A values avT (ka, m) and,
// for K8 and K9, slab-local rows lrT (ka, m) (K2 and K7a: none, lrT
// null). m counts rows (K8, K9: slabs).
template <typename V>
struct RowsIn {
  const int* key;
  const V* val;
  int vec;      // key and val on the 16-byte grid
};

struct PackedRowsIn {
  const int* p;
  int vec;      // p on the 16-byte grid
};

struct GatherIn {
  const int32_t* g;
  const float* avT;
  int ka, lanes, run, pack;
  int vec;      // g on the 16-byte grid and lanes a multiple of 4
};

template <typename V>
struct TableIn {
  const int32_t* table;
  const int32_t* rT;
  const float* avT;
  const int32_t* lrT;   // null: the key is the column
  int ka, lanes, run, n;
  int vec;      // table on the 16-byte grid and lanes a multiple of 4
};

template <int E, typename V>
__device__ __forceinline__ void load_slots(int (&k)[E], V (&v)[E],
                                           const RowsIn<V>& in, int m,
                                           int width, int row, int base) {
  const size_t off = (size_t)row * width + base;
  load_keys<E>(k, in.key + off, in.vec != 0);
  load_vals<E>(v, in.val + off, in.vec != 0);
}

// K7b: the thread's E packed keys (16-byte loads where vec), each
// unpacked in registers, _unpack_colval (ops/bitonic.py:512) bit for bit:
// the column is the logical x >> 16, the value the bf16 bits widened to
// float32, (x & 0xFFFF) << 16, exactly; SENTINEL stays SENTINEL with
// value 0.
template <int E>
__device__ __forceinline__ void load_slots(int (&k)[E], float (&v)[E],
                                           const PackedRowsIn& in, int m,
                                           int width, int row, int base) {
  load_keys<E>(k, in.p + (size_t)row * width + base, in.vec != 0);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const uint32_t x = (uint32_t)k[r];
    const bool sent = k[r] == kSentinel;
    v[r] = sent ? 0.f : __uint_as_float((x & 0xFFFFu) << 16);
    k[r] = sent ? kSentinel : (int)(x >> 16);
  }
}

// K1: fragment e in packed row e / pack of g at lane offset (e % pack) *
// 4 * run, plus 2 * run for odd e (the reversed half); key the column.
template <int E>
__device__ __forceinline__ void load_slots(int (&k)[E], float (&v)[E],
                                           const GatherIn& in, int m,
                                           int width, int row, int base) {
  expand_slots<E, float>(k, v, base, in.run, in.ka, in.vec != 0,
                         [&](int e) {
    const int ep = e / in.pack;
    return Frag{in.g + ((size_t)ep * m + row) * in.lanes
                    + (e - ep * in.pack) * 4 * in.run
                    + ((e & 1) ? 2 * in.run : 0),
                __ldg(in.avT + (size_t)e * m + row), 0};
  });
}

// K2, K7a, K8, K9: fragment e of row `row` is table row rT[e, row] (the
// all -1 fill row for empty and padding slots) at lane offset 2 * run for
// odd e. K2 / K7a: key the column. K8 / K9: key lrT[e, row] * n + the
// column (the planner keeps it below 2^31 - 1, so SENTINEL still sorts
// last), the product unsigned so that a padding slot's junk row cannot
// overflow; its key is selected away.
template <int E, typename V>
__device__ __forceinline__ void load_slots(int (&k)[E], V (&v)[E],
                                           const TableIn<V>& in, int m,
                                           int width, int row, int base) {
  expand_slots<E, V>(k, v, base, in.run, in.ka, in.vec != 0, [&](int e) {
    const size_t i = (size_t)e * m + row;
    return Frag{in.table + (size_t)__ldg(in.rT + i) * in.lanes
                    + ((e & 1) ? 2 * in.run : 0),
                __ldg(in.avT + i),
                in.lrT ? (int)((unsigned)__ldg(in.lrT + i) * (unsigned)in.n)
                       : 0};
  });
}

// What a network kernel leaves in its outputs: the sorted row (K2, K6,
// K7a, K8, K9), the compacted row's first out_w slots (K1, K3-K5, K7b), or
// each survivor at its sorted slot (K3's and K7b's compact=False).
enum class NetOut { kSorted, kCompact, kInPlace };

// Rows per block: rows of at most 32E slots (T <= 32 threads) share a
// 128-thread block, wider rows take one block each.
template <int E>
inline int net_rows_per_block(int width) {
  const int T = width / E;
  return T <= 32 ? 128 / T : 1;
}

// Shared memory of a block of the register network: the compress's
// scratch first (K1, K3-K5, K7b), then W value (none for NoVal) and W key
// slots per row where the sort exchanges through them (rows of more than
// a warp) or the compress stages the compacted row.
template <typename V, int E>
inline size_t net_smem_bytes(int width, int rows_per_block, bool sort,
                             NetOut out) {
  const int T = width / E;
  const bool slots = out == NetOut::kCompact || (sort && T > 32);
  return (out != NetOut::kSorted ? sizeof(RowScratch<V>) : 0)
         + (slots ? (size_t)rows_per_block * width
                        * (kValBytes<V> + sizeof(int))
                  : 0);
}

// One block's rows through the register network: load (or expand), sort
// from start_kk (kSort), compress (kOut), store. The last block's
// padding rows (row >= m) run SENTINEL rows through every step, so that
// every thread reaches every barrier, and store nothing. Output rows are
// out_w slots apart.
template <typename V, int E, bool kSort, NetOut kOut, typename In>
__device__ __forceinline__ void row_net_rows(
    const In& in, int* __restrict__ out_col, V* __restrict__ out_val,
    int* __restrict__ nnz, int m, int width, int start_kk, int out_w,
    int rows_per_block, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowShape<E> sh(width);
  const int seg = threadIdx.x / sh.T;        // the block's row
  const int tid = threadIdx.x - seg * sh.T;  // the thread's index in it
  const int row = blockIdx.x * rows_per_block + seg;
  const bool live = row < m;
  int k[E];
  V v[E];
  if (live) {
    load_slots<E>(k, v, in, m, width, row, tid * E);
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      k[r] = kSentinel;
      v[r] = V(0);
    }
  }
  RowScratch<V>* sc = reinterpret_cast<RowScratch<V>*>(smem_raw);
  unsigned char* slots =
      smem_raw + (kOut != NetOut::kSorted ? sizeof(RowScratch<V>) : 0);
  V* vs = reinterpret_cast<V*>(slots) + (size_t)seg * width;
  int* ks = reinterpret_cast<int*>(
      slots + (size_t)rows_per_block * width * kValBytes<V>)
      + (size_t)seg * width;
  if constexpr (kSort) row_net_sort<E, V>(k, v, ks, vs, tid, start_kk, sh);
  int total = 0;
  if constexpr (kOut == NetOut::kCompact)
    total = row_net_compress<E, V>(k, v, tid, sh, sc, ks, vs);
  else if constexpr (kOut == NetOut::kInPlace)
    total = row_net_mark<E, V>(k, v, tid, sh, sc);
  if (!live) return;
  const size_t o = (size_t)row * out_w;
  store_slots<E, V>(out_col + o, out_val + o, k, v, tid * E, out_w,
                    vec_out != 0);
  if (kOut != NetOut::kSorted && tid == 0) nnz[row] = total;
}

}  // namespace
