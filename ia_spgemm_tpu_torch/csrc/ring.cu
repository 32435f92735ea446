// Ring hop kernel for Hopper (sm_90a), plain C ABI.
//
//   K13 ia_k13_ring_hop  <- ia_spgemm_tpu/parallel/rdma_ring.py:31 _hop_kernel
//
// One step of the ring SpGEMM (parallel/ring.py): every shard d receives
// the B block of shard (d + 1) % D, i.e. sends its own to the left
// neighbour. The TPU kernel ran on each chip, met both neighbours at a
// barrier semaphore (so the receiver's output buffer was live) and then
// pushed its block by remote DMA. Here the wrapper allocates every
// receiver's fresh output before the launch, which is what the barrier
// was for, and one launch moves every block whose source lies on one
// card: on a single card stream order is the only synchronisation
// needed; with several cards in one process each source card's launch
// stores into peer memory over NVLink, ordered by events in the wrapper.
//
// The launch reads a device table of (source pointer, destination
// pointer, byte count) int64 triples, one per block copied; one launch
// can carry both of a ring step's arrays (the column and value blocks).
// The grid is (chunks of a block, copy): each block of threads walks its
// copy with a grid stride, 16-byte vector loads and stores where both
// pointers are 16-byte aligned, then a byte tail (or bytes throughout
// when they are not).
//
// What bounds it on this card: bytes, each byte read once and written
// once (2 x block bytes per copy at 3.35 TB/s); at the ring's shapes (a
// few MB per step) the launch latency and the table's host-to-device copy
// dominate. It is a pure copy, so it agrees with the plain version bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1024;

__global__ void k13_ring_hop(const int64_t* __restrict__ table) {
  const int64_t* e = table + 3 * (int64_t)blockIdx.y;
  const char* src = reinterpret_cast<const char*>(e[0]);
  char* dst = reinterpret_cast<char*>(e[1]);
  const int64_t nbytes = e[2];
  const bool vec = ((reinterpret_cast<uintptr_t>(src)
                     | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int64_t nvec = vec ? nbytes >> 4 : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int64_t v = first; v < nvec; v += stride) d4[v] = __ldg(s4 + v);
  for (int64_t b = nvec * 16 + first; b < nbytes; b += stride) dst[b] = src[b];
}

}  // namespace

// Launches on `stream` (of the current device, where every source block
// lies), does not synchronise, returns cudaGetLastError() (0 on success).
// table: n_copies (src, dst, nbytes) int64 triples in device memory;
// max_bytes: the largest nbytes (sizes the grid), 64-bit.
extern "C" int ia_k13_ring_hop(const void* table, int n_copies,
                               long long max_bytes, void* stream) {
  if (n_copies <= 0) return 0;
  long long gx = ((max_bytes + 15) / 16 + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxBlocksX) gx = kMaxBlocksX;
  dim3 grid((unsigned)gx, (unsigned)n_copies);
  k13_ring_hop<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table);
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
