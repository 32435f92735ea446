// Building blocks shared by the sort kernels of bitonic.cu (K1-K4) and
// slab.cu (K8-K10): the fragment expand, the block bitonic sort in shared
// memory, and the duplicate-sum / compaction of a sorted row.
//
// Conventions shared with the JAX package: SENTINEL = INT32_MAX marks an
// empty product slot and sorts last (signed int32 compares); empty output
// slots are col -1 / value 0; a fragment's direction (forward or reversed
// run) follows its fragment index e, not its packed row.

#pragma once

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

// ---- building block 1: the expand prologue ------------------------------
// Fragment e of this row sits in packed row ep = e / pack of g at lane
// offset (e % pack) * 4 * run as [col_f | val_f | col_rev | val_rev]; odd
// fragments take the reversed half, so the row arrives as alternating
// ascending / descending runs. Invalid columns (< 0) become SENTINEL with
// value 0 by a select: padded class rows carry NaN A values, which a
// multiply-by-mask would leak into the sums. kLocalRows (the slab engine)
// keys each product lrT[e] * n + col, its slab-local row and column. The
// product is formed in V: float, or double, where it is exact.
template <typename V, bool kLocalRows>
__device__ void expand_row(const int32_t* __restrict__ g,
                           const float* __restrict__ avT,
                           const int32_t* __restrict__ lrT, int n, int* k,
                           V* v, int row, int m, int ka, int lanes, int run,
                           int pack, int width) {
  for (int p = threadIdx.x; p < width; p += blockDim.x) {
    int key = kSentinel;
    V val = V(0);
    int e = p / run;
    if (e < ka) {
      int r = p - e * run;
      int ep = e / pack;
      int off = (e - ep * pack) * 4 * run + ((e & 1) ? 2 * run : 0);
      const int32_t* src = g + ((size_t)ep * m + row) * lanes + off;
      int c = src[r];
      if (c >= 0) {
        key = kLocalRows ? lrT[(size_t)e * m + row] * n + c : c;
        val = V(avT[(size_t)e * m + row]) * V(__int_as_float(src[run + r]));
      }
    }
    k[p] = key;
    v[p] = val;
  }
}

// ---- building block 2: block bitonic sort in shared memory -------------
// Ascending by key. Merging starts at block size start_kk: 2*run when the
// row holds alternating sorted runs of length run, 2 for a full sort.
template <typename V>
__device__ void block_sort(int* k, V* v, int width, int start_kk) {
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
          V vi = v[i];
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

// Where compress_row writes a value: one float32 lane, or (DDOut) the
// float32 pair hi = f32(s), lo = f32(s - hi) of a float64 sum. s - hi is
// exact in float64 and no product is involved, so FMA contraction cannot
// change it.
struct F32Out {
  float* v;
  __device__ void put(int i, float s) const { v[i] = s; }
  __device__ void zero(int i) const { v[i] = 0.f; }
};

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

// Sorted row (k, v) in shared memory -> duplicate sums, nnz, and either
// the survivors compacted left into out_w slots (compact) or left at
// their sorted slots with -1 / 0 holes (!compact, out_w == width). Each
// thread scans a contiguous chunk so ranks keep column order. nnz counts
// every survivor, also those past out_w.
template <typename V, typename Out>
__device__ void compress_row(const int* k, const V* v, int width, int out_w,
                             bool compact, int* out_col, Out out, int* nnz,
                             int* scratch) {
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
        out.put(off, run_sum(k, v, i));
      }
      ++off;
    }
    for (int p = total + threadIdx.x; p < out_w; p += nt) {
      out_col[p] = -1;
      out.zero(p);
    }
  } else {
    for (int i = lo; i < lo + chunk; ++i) {
      bool e = emits(k, i, width);
      out_col[i] = e ? k[i] : -1;
      if (e)
        out.put(i, run_sum(k, v, i));
      else
        out.zero(i);
    }
  }
  if (threadIdx.x == 0) *nnz = total;
}

}  // namespace
