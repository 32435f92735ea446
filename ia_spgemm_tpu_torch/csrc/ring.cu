// Ring hop kernel for Hopper (sm_90a), plain C ABI.
//
//   K13 ia_k13_ring_hop, ia_k13_ring_hop_xproc
//       <- ia_spgemm_tpu/parallel/rdma_ring.py:31 _hop_kernel
//
// One step of the ring SpGEMM (parallel/ring.py): every shard d receives
// the B block of shard (d + 1) % D, i.e. sends its own to the left
// neighbour. The TPU kernel ran on each chip, met both neighbours at a
// barrier semaphore (so the receiver's output buffer was live) and then
// pushed its block by remote DMA. Here the receivers exist before the
// launch, which is what the barrier was for, and one launch moves every
// block whose source lies on one card: on a single card stream order is
// the only synchronisation needed; with several cards in one process each
// source card's launch stores into peer memory over NVLink, ordered by
// events in the wrapper.
//
// The copy table is a kernel parameter: a __grid_constant__ struct of up
// to kMaxCopies (source, destination, bytes) triples plus each copy's
// first chunk (3.6 KB, under the 4 KB parameter limit), filled by the C
// entry from a host array. No device table, no host-to-device copy: the
// host's work per call is the launch. A larger table goes out as several
// launches (the wrapper packs them).
//
// The work is cut into chunks of kChunkBytes; the grid is sized to the
// card (kBlocksPerSm blocks per SM at most, never more than there are
// chunks) and each block walks the chunks with a grid stride. In a chunk
// each thread issues kUnroll 16-byte loads before its kUnroll stores, so
// several loads are in flight per thread; copies whose pointers are not
// both 16-byte aligned go byte by byte, and an aligned copy's last
// nbytes % 16 bytes too.
//
// What bounds it on this card: bytes, each byte read once and written
// once (2 x block bytes per copy at 3.35 TB/s; 4.5 us for the headline's
// B blocks at D = 4, NVIDIA H100 80GB HBM3, 700 W). It is a pure copy, so
// it agrees with the plain version bit for bit.
//
// Across processes (ia_k13_ring_hop_xproc) nothing orders the two sides,
// so that instance does what _hop_kernel does, barrier included. Each
// process holds four 64-bit signal words (kFromLeft, kFromRight,
// kDelivered, kError), mapped into both neighbours by CUDA IPC, and one
// launch per ring step:
//   - barrier: block 0 adds 1 to the left neighbour's kFromRight and to
//     the right neighbour's kFromLeft (red.release.sys); every block then
//     spins until both of its own words reach `arrivals` (the count of
//     this process's hops so far, this one included). A neighbour's
//     arrival means its stream finished everything enqueued before, the
//     reads of the receivers written now included
//     (semaphore_signal x2 + semaphore_wait of rdma_ring.py:35-38). One
//     word per neighbour, not one sum: a sum can be filled by one
//     neighbour a step ahead while the other has not arrived;
//   - copy: the table's local copies (shard i + 1 -> receiver i, same
//     card) and, last, the copies into the left neighbour's receivers
//     through its IPC-mapped pointers; after each such chunk every thread
//     fences at system scope and one adds 1 to the left's kDelivered;
//   - delivery: block 0 spins until its own kDelivered reaches
//     `delivered`, the chunks of every incoming block so far, which the
//     receiver counts from its own receivers' bytes and kChunkBytes
//     (rdma.wait()).
// The counters only grow, across the steps and the calls of a process's
// ring; the wrapper keeps the expected values. Every spin is bounded by
// `timeout_ns` of %globaltimer, with __nanosleep backoff: at the limit
// the kernel stores an error code into its own kError and exits, and a
// launch that finds kError set does nothing, so a lost peer costs one
// limit and never hangs the card. The wrapper reads kError at the ring
// call's end and raises. What bounds it: the same bytes as above, but
// processes sharing one card are CUDA contexts that time-slice, so a hop
// there waits out the other processes' slices (milliseconds against a
// 4.5 us copy on the headline's blocks, PERF.md); the spin backs off
// with __nanosleep and leaves the copies to run at full width once the
// neighbours have arrived.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCopies = 128;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunkBytes = 16LL * kThreads * kUnroll;   // 16 KB
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

struct CopyTable {
  const char* src[kMaxCopies];
  char* dst[kMaxCopies];
  long long nbytes[kMaxCopies];
  int first_chunk[kMaxCopies + 1];   // prefix sums of the chunk counts
  int n;
};
static_assert(sizeof(CopyTable) <= 4096, "kernel parameter limit");

// Copies chunk `chunk` of the table (16-byte vectors where source and
// destination are both aligned, bytes otherwise and for the tail);
// returns the copy it belongs to. kPastL1: load through L2 only (the
// source may be a receiver that another process wrote).
template <bool kPastL1>
__device__ __forceinline__ int copy_chunk(const CopyTable& t, int chunk) {
  int lo = 0, hi = t.n - 1;   // the copy holding this chunk
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const char* src = t.src[lo];
  char* dst = t.dst[lo];
  const long long begin = (long long)(chunk - t.first_chunk[lo])
                          * kChunkBytes;
  const long long end = min(begin + kChunkBytes, t.nbytes[lo]);
  const bool vec = ((reinterpret_cast<uintptr_t>(src)
                     | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  long long tail = begin;
  if (vec) {
    const long long nvec = end >> 4;          // whole vectors below end
    const long long v0 = begin >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    int4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads + threadIdx.x;
      if (v < nvec) buf[u] = kPastL1 ? __ldcg(s4 + v) : __ldg(s4 + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads + threadIdx.x;
      if (v < nvec) d4[v] = buf[u];
    }
    tail = nvec << 4;
  }
  for (long long b = tail + threadIdx.x; b < end; b += kThreads)
    dst[b] = kPastL1 ? __ldcg(src + b) : src[b];
  return lo;
}

__global__ void __launch_bounds__(kThreads)
k13_ring_hop(const __grid_constant__ CopyTable t) {
  const int total = t.first_chunk[t.n];
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x)
    copy_chunk<false>(t, chunk);
}

int sm_count[kMaxDevices];

// each process's signal words (int64 each, zeroed once, never reset)
enum : int { kFromLeft = 0, kFromRight = 1, kDelivered = 2, kError = 3 };
enum : unsigned long long { kBarrierTimeout = 1, kDeliveryTimeout = 2 };

struct XprocParams {
  CopyTable t;                    // copies [first_remote, n) go left
  unsigned long long* own;        // this process's signal words
  unsigned long long* left;       // the left neighbour's (IPC-mapped)
  unsigned long long* right;      // the right neighbour's (IPC-mapped)
  unsigned long long arrivals;    // each of own[kFromLeft/kFromRight]
  unsigned long long delivered;   // own[kDelivered]
  unsigned long long timeout_ns;  // per spin
  int first_remote;
};
static_assert(sizeof(XprocParams) <= 4096, "kernel parameter limit");

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_sys(unsigned long long* p,
                                                unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until own[a] >= target and own[b] >= target (b < 0: a alone).
// Returns false, with kError set, at the time limit or when kError is
// already set (another block timed out).
__device__ bool spin_until(unsigned long long* own, int a, int b,
                           unsigned long long target,
                           unsigned long long timeout_ns,
                           unsigned long long code) {
  const unsigned long long t0 = global_ns();
  unsigned ns = 32;
  while (ld_acquire_sys(own + a) < target
         || (b >= 0 && ld_acquire_sys(own + b) < target)) {
    if (ld_acquire_sys(own + kError) != 0) return false;
    if (global_ns() - t0 > timeout_ns) {
      atomicCAS_system(own + kError, 0ULL, code);
      return false;
    }
    __nanosleep(ns);
    if (ns < 4096) ns <<= 1;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
k13_ring_hop_xproc(const __grid_constant__ XprocParams p) {
  __shared__ int go;
  if (threadIdx.x == 0) {
    bool ok = ld_acquire_sys(p.own + kError) == 0;
    if (ok && blockIdx.x == 0) {           // arrive at both neighbours
      red_release_sys(p.left + kFromRight, 1);
      red_release_sys(p.right + kFromLeft, 1);
    }
    go = ok && spin_until(p.own, kFromLeft, kFromRight, p.arrivals,
                          p.timeout_ns, kBarrierTimeout);
  }
  __syncthreads();
  if (!go) return;
  const int total = p.t.first_chunk[p.t.n];
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x) {
    if (copy_chunk<true>(p.t, chunk) >= p.first_remote) {
      // a chunk of the left's block: every thread's stores, then one
      // release of the count the left waits on
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) red_release_sys(p.left + kDelivered, 1);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    spin_until(p.own, kDelivered, -1, p.delivered, p.timeout_ns,
               kDeliveryTimeout);
}

// Fills t from host triples; returns the chunk count, or -1 when the
// table is refused (over kMaxCopies, a count <= 0, too many chunks).
long long fill_table(CopyTable& t, const long long* triples, int n) {
  if (n < 0 || n > kMaxCopies) return -1;
  t.n = n;
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    t.src[i] = reinterpret_cast<const char*>(triples[3 * i]);
    t.dst[i] = reinterpret_cast<char*>(triples[3 * i + 1]);
    t.nbytes[i] = triples[3 * i + 2];
    if (t.nbytes[i] <= 0) return -1;
    t.first_chunk[i] = (int)chunks;
    chunks += (t.nbytes[i] + kChunkBytes - 1) / kChunkBytes;
  }
  if (chunks >= (1LL << 31)) return -1;
  t.first_chunk[n] = (int)chunks;
  return chunks;
}

// kBlocksPerSm blocks per SM of the current device at most; 0 on error.
long long grid_cap(cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (sm_count[dev] == 0) {
    *err = cudaDeviceGetAttribute(&sm_count[dev],
                                  cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
  }
  return (long long)sm_count[dev] * kBlocksPerSm;
}

}  // namespace

// Launches on `stream` (of the current device, where every source lies),
// does not synchronise, returns cudaGetLastError() (0 on success).
// triples: n_copies (source pointer, destination pointer, byte count)
// int64 triples in host memory, 1 <= n_copies <= 128, every count > 0.
extern "C" int ia_k13_ring_hop(const long long* triples, int n_copies,
                               void* stream) {
  if (n_copies < 1) return (int)cudaErrorInvalidValue;
  CopyTable t;
  const long long chunks = fill_table(t, triples, n_copies);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  long long grid = grid_cap(&err);
  if (grid == 0) return (int)err;
  if (grid > chunks) grid = chunks;
  k13_ring_hop<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// One ring step across processes on `stream`: the barrier, the copies
// and the delivery wait above. triples: n_copies (source, destination,
// bytes) int64 triples, 0 <= n_copies <= 128, every count > 0; the last
// n_remote go into the left neighbour's receivers. words: the addresses
// of this process's, the left's and the right's signal words; targets:
// (arrivals, delivered, timeout_ns). Returns cudaGetLastError().
extern "C" int ia_k13_ring_hop_xproc(const long long* triples, int n_copies,
                                     int n_remote, const long long* words,
                                     const long long* targets,
                                     void* stream) {
  XprocParams p;
  const long long chunks = fill_table(p.t, triples, n_copies);
  if (chunks < 0 || n_remote < 0 || n_remote > n_copies)
    return (int)cudaErrorInvalidValue;
  p.first_remote = n_copies - n_remote;
  p.own = reinterpret_cast<unsigned long long*>(words[0]);
  p.left = reinterpret_cast<unsigned long long*>(words[1]);
  p.right = reinterpret_cast<unsigned long long*>(words[2]);
  p.arrivals = (unsigned long long)targets[0];
  p.delivered = (unsigned long long)targets[1];
  p.timeout_ns = (unsigned long long)targets[2];
  cudaError_t err;
  long long grid = grid_cap(&err);
  if (grid == 0) return (int)err;
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;           // the barrier runs without copies too
  k13_ring_hop_xproc<<<(unsigned)grid, kThreads, 0,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The chunk size both sides of a cross-process hop count deliveries in.
extern "C" int ia_k13_chunk_bytes() { return (int)kChunkBytes; }

// Lets the current device's kernels store into `peer`'s memory; returns
// 0 when it is enabled (now or before), the CUDA error otherwise.
extern "C" int ia_k13_enable_peer_access(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it, or the next launch check reports it
    return 0;
  }
  return (int)e;
}
