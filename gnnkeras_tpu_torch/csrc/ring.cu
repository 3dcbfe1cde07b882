// Ring all-gather between the ranks of a process group on one node: every
// rank contributes a block of ``nbytes`` and receives every rank's block in
// rank order,
//
//   out[q * nbytes : (q + 1) * nbytes] = x of rank q,   q = 0 .. P - 1,
//
// in P - 1 steps around the ring: at step i a rank sends the block of rank
// (r - i) mod P (its own at step 0, at later steps the one it received at
// step i - 1) into its right neighbour's receive slot (i + 1) mod 2, and
// receives the block of rank (r - i - 1) mod P from its left neighbour.
//
// Replaces: gnnkeras_tpu/ops/ring.py, _ring_kernel launched by
// ring_all_gather (the pallas_ring transport of PartitionedGNN, the
// per-iteration halo exchange of the edge-partitioned engine).  The TPU
// kernel sends with remote DMAs into double-buffered VMEM slots, gates each
// send on a credit semaphore from the right neighbour and opens with a
// barrier with both neighbours.  Here the two receive slots and the flag
// words of each rank live in device memory that the ranks map into each
// other's address space through CUDA IPC (gnn_ring_alloc / gnn_ring_open,
// the handles exchanged once per group by the caller), and the kernel stores
// straight into the right neighbour's slot.
//
// Flags instead of semaphores.  Each rank's flag area holds, per slot s and
// per thread block b (block b of every rank moves chunk b of every block, so
// each chunk runs its own independent ring):
//   ready[s][b]   bumped by the left neighbour after it wrote chunk b of slot s,
//   credit[s][b]  bumped by the right neighbour when it is done with its slot s
//                 (copied out, and forwarded unless it was the last step),
//   sent[s][b], recvd[s][b]  this rank's own running counts.
// All four are monotonic counters over the group's lifetime: a write into the
// neighbour's slot s waits until credit[s][b] has caught up with sent[s][b],
// a read of the own slot waits until ready[s][b] exceeds recvd[s][b].  No
// reset is needed between launches, and a launch never waits for a barrier
// beyond its neighbours' progress (the counters order consecutive calls).
// Flags are read with ld.acquire.sys and bumped with red.release.sys after a
// system-scope fence; slot data is read with ld.global.cg (L2, not a stale
// L1 line from an earlier call).
//
// Bounded waits.  Every wait spins for at most ``timeout_ns`` of the GPU's
// global timer; on expiry thread 0 writes 1 into ``err`` and the block
// returns.  The wrapper reads ``err`` after the launch and raises: the ring
// is then broken (the counters of the ranks disagree) and the group must be
// set up again.
//
// What bounds it on an H100: on one card P ranks are P processes, and
// without MPS their kernels are time-sliced, not concurrent, so a rank
// waiting for its neighbour keeps the card until the scheduler switches
// contexts: each step can cost a time slice, far above the bytes' time
// (P · nbytes written and read at 3.35 TB/s).  Under MPS the ranks' kernels
// run side by side and the copies (16-byte vectors where the block size and
// the pointers allow) bound it.
//
// Entries: gnn_ring_alloc, gnn_ring_open, gnn_ring_close, gnn_ring_free and
// gnn_ring_all_gather, plain C functions bound with ctypes.  Each returns a
// cudaError_t; the launch runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxBlocks = 64;  // chunks per block, and thread blocks per launch
constexpr int kThreads = 256;
constexpr size_t kFlagBytes = 4096;  // flag area at the start of a rank's region
// offsets (in uint32 words) of the flag arrays, each [2][kMaxBlocks]
constexpr int kReady = 0;
constexpr int kCredit = 2 * kMaxBlocks;
constexpr int kSent = 4 * kMaxBlocks;
constexpr int kRecvd = 6 * kMaxBlocks;
static_assert(8 * kMaxBlocks * 4 <= kFlagBytes, "flag area too small");

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void bump_release(uint32_t* p) {
  asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= want; false (and err set) on timeout.
__device__ bool wait_at_least(const uint32_t* flag, uint32_t want, uint64_t timeout_ns, int* err) {
  const uint64_t t0 = now_ns();
  // counters wrap after 2^32 bumps; compare by signed difference
  while (static_cast<int32_t>(load_acquire(flag) - want) < 0) {
    if (now_ns() - t0 > timeout_ns) {
      atomicExch(err, 1);
      return false;
    }
    __nanosleep(256);
  }
  return true;
}

template <typename V>
__device__ __forceinline__ void copy_chunk(V* __restrict__ dst, const V* __restrict__ src, long lo, long hi,
                                           bool src_shared) {
  for (long k = lo + threadIdx.x; k < hi; k += blockDim.x) dst[k] = src_shared ? __ldcg(src + k) : src[k];
}

template <typename V>
__global__ void __launch_bounds__(kThreads) ring_kernel(const V* __restrict__ x, V* __restrict__ out,
                                                        uint32_t* my, uint32_t* left, uint32_t* right, int rank,
                                                        int P, long words, long chunk, size_t cap,
                                                        uint64_t timeout_ns, int* err) {
  __shared__ bool failed;
  const int b = blockIdx.x;
  const long lo = b * chunk;
  const long hi = lo + chunk < words ? lo + chunk : words;
  auto slot = [cap](uint32_t* region, int s) {
    return reinterpret_cast<V*>(reinterpret_cast<char*>(region) + kFlagBytes + s * cap);
  };
  uint32_t sent[2], recvd[2];
  if (threadIdx.x == 0) {
    failed = false;
    for (int s = 0; s < 2; ++s) {
      sent[s] = my[kSent + s * kMaxBlocks + b];
      recvd[s] = my[kRecvd + s * kMaxBlocks + b];
    }
  }
  copy_chunk(out + rank * words, x, lo, hi, false);  // the own block

  const V* src = x;
  for (int i = 0; i < P - 1; ++i) {
    const int s = (i + 1) & 1;
    // the right neighbour must be done with everything written into its slot s
    if (threadIdx.x == 0 && !wait_at_least(my + kCredit + s * kMaxBlocks + b, sent[s], timeout_ns, err))
      failed = true;
    __syncthreads();
    if (failed) break;
    copy_chunk(slot(right, s), src, lo, hi, i > 0);
    __threadfence_system();
    __syncthreads();  // every thread's stores, and reads of src, are done
    if (threadIdx.x == 0) {
      bump_release(right + kReady + s * kMaxBlocks + b);
      ++sent[s];
      // the slot just forwarded from (received at step i - 1) is free again
      if (i > 0) bump_release(left + kCredit + (i & 1) * kMaxBlocks + b);
      if (!wait_at_least(my + kReady + s * kMaxBlocks + b, recvd[s] + 1, timeout_ns, err)) failed = true;
      ++recvd[s];
    }
    __syncthreads();
    if (failed) break;
    const int q = ((rank - i - 1) % P + P) % P;
    copy_chunk(out + q * words, slot(my, s), lo, hi, true);
    src = slot(my, s);
    if (i == P - 2) {  // the last receipt is not forwarded: free it now
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence_system();
        bump_release(left + kCredit + s * kMaxBlocks + b);
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      my[kSent + s * kMaxBlocks + b] = sent[s];
      my[kRecvd + s * kMaxBlocks + b] = recvd[s];
    }
  }
}

template <typename V>
cudaError_t launch(const void* x, void* out, void* my, void* left, void* right, int rank, int P, size_t nbytes,
                   size_t cap, uint64_t timeout_ns, void* err, cudaStream_t stream) {
  const long words = static_cast<long>(nbytes / sizeof(V));
  // chunks of at least 32 KiB, at most kMaxBlocks of them
  long blocks = static_cast<long>((nbytes + 32767) / 32768);
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  const long chunk = (words + blocks - 1) / blocks;
  ring_kernel<V><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), static_cast<uint32_t*>(my), static_cast<uint32_t*>(left),
      static_cast<uint32_t*>(right), rank, P, words, chunk, cap, timeout_ns, static_cast<int*>(err));
  return cudaGetLastError();
}

bool aligned(const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

}  // namespace

// A rank's region: the flag area (zeroed) and two receive slots of ``cap``
// bytes each; ``handle`` receives its cudaIpcMemHandle_t (64 bytes).
extern "C" int gnn_ring_alloc(size_t cap, void** region, void* handle) {
  if (cap % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMalloc(region, kFlagBytes + 2 * cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*region, 0, kFlagBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *region);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map another rank's region (its 64-byte handle) into this process.
extern "C" int gnn_ring_open(const void* handle, void** region) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(region, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int gnn_ring_close(void* region) { return static_cast<int>(cudaIpcCloseMemHandle(region)); }

extern "C" int gnn_ring_free(void* region) { return static_cast<int>(cudaFree(region)); }

// out (P * nbytes) <- every rank's x (nbytes), in rank order.  ``my`` is this
// rank's region, ``left`` / ``right`` its neighbours' regions mapped here;
// ``err`` a device int the kernel sets to 1 on a timed-out wait.
extern "C" int gnn_ring_all_gather(const void* x, void* out, void* my, void* left, void* right, int rank, int P,
                                   size_t nbytes, size_t cap, unsigned long long timeout_ns, void* err,
                                   void* stream) {
  if (P < 2 || rank < 0 || rank >= P || nbytes == 0 || nbytes > cap) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {x, out};
  bool a16 = nbytes % 16 == 0, a4 = nbytes % 4 == 0, a2 = nbytes % 2 == 0;
  for (const void* p : ptrs) {
    a16 = a16 && aligned(p, 16);
    a4 = a4 && aligned(p, 4);
    a2 = a2 && aligned(p, 2);
  }
  cudaError_t e;
  if (a16)
    e = launch<int4>(x, out, my, left, right, rank, P, nbytes, cap, timeout_ns, err, s);
  else if (a4)
    e = launch<unsigned int>(x, out, my, left, right, rank, P, nbytes, cap, timeout_ns, err, s);
  else if (a2)
    e = launch<unsigned short>(x, out, my, left, right, rank, P, nbytes, cap, timeout_ns, err, s);
  else
    e = launch<unsigned char>(x, out, my, left, right, rank, P, nbytes, cap, timeout_ns, err, s);
  return static_cast<int>(e);
}
