// Ring hop kernel for Hopper (sm_90a), plain C ABI.
//
//   K13 ia_k13_ring_hop  <- ia_spgemm_tpu/parallel/rdma_ring.py:31 _hop_kernel
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

__global__ void __launch_bounds__(kThreads)
k13_ring_hop(const __grid_constant__ CopyTable t) {
  const int total = t.first_chunk[t.n];
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x) {
    int lo = 0, hi = t.n - 1;   // the copy holding this chunk
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (t.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    const char* src = t.src[lo];
    char* dst = t.dst[lo];
    const long long nbytes = t.nbytes[lo];
    const long long begin = (long long)(chunk - t.first_chunk[lo])
                            * kChunkBytes;
    const long long end = min(begin + kChunkBytes, nbytes);
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
        if (v < nvec) buf[u] = __ldg(s4 + v);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * kThreads + threadIdx.x;
        if (v < nvec) d4[v] = buf[u];
      }
      tail = nvec << 4;
    }
    for (long long b = tail + threadIdx.x; b < end; b += kThreads)
      dst[b] = src[b];
  }
}

int sm_count[kMaxDevices];

}  // namespace

// Launches on `stream` (of the current device, where every source lies),
// does not synchronise, returns cudaGetLastError() (0 on success).
// triples: n_copies (source pointer, destination pointer, byte count)
// int64 triples in host memory, 1 <= n_copies <= 128, every count > 0.
extern "C" int ia_k13_ring_hop(const long long* triples, int n_copies,
                               void* stream) {
  if (n_copies < 1 || n_copies > kMaxCopies) return (int)cudaErrorInvalidValue;
  CopyTable t;
  t.n = n_copies;
  long long chunks = 0;
  for (int i = 0; i < n_copies; ++i) {
    t.src[i] = reinterpret_cast<const char*>(triples[3 * i]);
    t.dst[i] = reinterpret_cast<char*>(triples[3 * i + 1]);
    t.nbytes[i] = triples[3 * i + 2];
    t.first_chunk[i] = (int)chunks;
    chunks += (t.nbytes[i] + kChunkBytes - 1) / kChunkBytes;
  }
  if (chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  t.first_chunk[n_copies] = (int)chunks;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  long long grid = (long long)sm_count[dev] * kBlocksPerSm;
  if (grid > chunks) grid = chunks;
  k13_ring_hop<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

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
