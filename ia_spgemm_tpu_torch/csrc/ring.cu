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
// so that instance does what _hop_kernel does, barrier included, but no
// kernel waits for a neighbour: the barrier and the delivery wait are
// stream memory operations (ia_k13_stream_ops: cuStreamWriteValue64 and
// cuStreamWaitValue64 with CU_STREAM_WAIT_VALUE_GEQ), enqueued by the
// wrapper around one copy launch per card that holds a source block.
// Each process's signal words (from-left, from-right, delivered, its own
// error, a neighbour's alert; int64) lie in a page of pinned host memory
// that its neighbours map too, and each word has one writer, which
// writes the running count of its hops by value:
//   - barrier: the home card's stream writes the count into the left
//     neighbour's from-right and the right neighbour's from-left word,
//     then waits until both of its own reach it. A neighbour's arrival
//     means its gathers of the step before are done, so the receivers
//     written now are free (semaphore_signal x2 + semaphore_wait of
//     rdma_ring.py:35-38);
//   - copy: on each card whose blocks are sources, after the barrier,
//     this kernel (the table's copies: block i + 1 into receiver i, and
//     from shard 0's card block 0 into the left neighbour's last
//     receiver through its IPC-mapped pointer), loads local, stores local
//     or over NVLink;
//   - delivery: after every card's copies the home card's stream writes
//     the count into the left's delivered word (a write without
//     CU_STREAM_WRITE_VALUE_NO_MEMORY_BARRIER is preceded by a memory
//     fence, so the stores land first), and waits until its own reaches
//     the count before anything reads the incoming receiver (rdma.wait()).
// A waiting stream gives up its context's time slice: two processes of
// one card pass a write and a wait back and forth in 11.6 us
// (bench/ring_wait_probe.py, PERF.md), where a spinning kernel held the
// slice and a hop took 4.6 ms. A stream wait has no time limit, so the
// watchdog is a thread of each process on the host (rdma_ring._watch):
// once a pending hop's words have not moved for its limit it sets
// this process's error word, alerts both neighbours and writes a value
// past every target into its own words, which releases the waits; a
// launch that pushes into the left neighbour copies the error word into
// the card's memory first and copies nothing if it is set, so a lost
// peer costs one limit, never hangs the card and is never written after
// the limit. What bounds it: the same bytes as above.

#include <cuda.h>
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

// Copies the table unless *halt (a copy in device memory of this
// process's error word, made in stream order just before the launch;
// nullptr: never halted) is set. Each block reads it once.
__global__ void __launch_bounds__(kThreads)
k13_ring_hop_xproc(const __grid_constant__ CopyTable t,
                   const unsigned long long* halt) {
  if (halt != nullptr && *halt != 0) return;
  const int total = t.first_chunk[t.n];
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x)
    copy_chunk<true>(t, chunk);
}

// the kinds of ia_k13_stream_ops' operations
enum : long long { kWrite = 0, kWait = 1 };

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

// The copies of one ring step across processes whose sources lie on the
// current device, on `stream`: triples as ia_k13_ring_hop's (1 <= n_copies
// <= 128). halt: 0 (no check), or the address of this process's error
// word in pinned host memory, copied into the 8 bytes at halt_copy
// (device memory of the current device) in stream order before the
// launch: every block of the kernel then reads it from the card's memory
// (read from host memory by every block, the reads go one at a time
// over PCIe, ~1 us each). Does not synchronise; returns
// cudaGetLastError().
extern "C" int ia_k13_ring_hop_xproc(const long long* triples, int n_copies,
                                     long long halt, long long halt_copy,
                                     void* stream) {
  if (n_copies < 1) return (int)cudaErrorInvalidValue;
  CopyTable t;
  const long long chunks = fill_table(t, triples, n_copies);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  long long grid = grid_cap(&err);
  if (grid == 0) return (int)err;
  if (grid > chunks) grid = chunks;
  const unsigned long long* flag = nullptr;
  if (halt != 0) {
    flag = reinterpret_cast<const unsigned long long*>(halt_copy);
    err = cudaMemcpyAsync((void*)flag, reinterpret_cast<const void*>(halt),
                          sizeof(*flag), cudaMemcpyDefault,
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  k13_ring_hop_xproc<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      t, flag);
  return (int)cudaGetLastError();
}

// Enqueues n_ops (kind, device address, value) int64 triples on `stream`
// in order: kind kWrite writes value into the 64-bit word (after a
// memory fence), kWait holds the stream until the word is >= value.
// Returns 0 or the first failing CUresult.
extern "C" int ia_k13_stream_ops(const long long* ops, int n_ops,
                                 void* stream) {
  for (int i = 0; i < n_ops; ++i) {
    const CUdeviceptr addr = (CUdeviceptr)ops[3 * i + 1];
    const cuuint64_t value = (cuuint64_t)ops[3 * i + 2];
    CUresult r;
    if (ops[3 * i] == kWrite)
      r = cuStreamWriteValue64((CUstream)stream, addr, value,
                               CU_STREAM_WRITE_VALUE_DEFAULT);
    else if (ops[3 * i] == kWait)
      r = cuStreamWaitValue64((CUstream)stream, addr, value,
                              CU_STREAM_WAIT_VALUE_GEQ);
    else
      r = CUDA_ERROR_INVALID_VALUE;
    if (r != CUDA_SUCCESS) return (int)r;
  }
  return 0;
}

// Loads both kernels into the current device's context now. Lazy
// module loading (CUDA_MODULE_LOADING=LAZY, PyTorch's default) loads a
// kernel at its first launch and waits for the context to go idle, so a
// first launch behind a stream wait would block the host until the
// neighbours arrive, or for ever if one is lost. Returns a cudaError_t.
extern "C" int ia_k13_load_kernels() {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k13_ring_hop);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k13_ring_hop_xproc);
  return (int)e;
}

// 1 if `device` takes 64-bit stream memory operations, 0 if not, a
// negative CUresult on error.
extern "C" int ia_k13_can_wait(int device) {
  CUdevice dev;
  int v = 0;
  CUresult r = cuDeviceGet(&dev, device);
  if (r == CUDA_SUCCESS)
    r = cuDeviceGetAttribute(
        &v, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev);
  return r == CUDA_SUCCESS ? (v != 0) : -(int)r;
}

// Pins nbytes of host memory at `host` for every device (portable,
// mapped) and stores its device address into *device_address; returns
// a cudaError_t. ia_k13_host_unmap undoes it.
extern "C" int ia_k13_host_map(long long host, long long nbytes,
                               long long* device_address) {
  void* p = reinterpret_cast<void*>(host);
  cudaError_t e = cudaHostRegister(
      p, (size_t)nbytes, cudaHostRegisterPortable | cudaHostRegisterMapped);
  if (e != cudaSuccess) return (int)e;
  void* d = nullptr;
  e = cudaHostGetDevicePointer(&d, p, 0);
  if (e != cudaSuccess) {
    cudaHostUnregister(p);
    return (int)e;
  }
  *device_address = reinterpret_cast<long long>(d);
  return 0;
}

extern "C" int ia_k13_host_unmap(long long host) {
  return (int)cudaHostUnregister(reinterpret_cast<void*>(host));
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
