// All-gather between the ranks of a process group on one node: every rank
// contributes a block of ``nbytes`` and receives every rank's block in rank
// order,
//
//   out[q * nbytes : (q + 1) * nbytes] = x of rank q,   q = 0 .. P - 1.
//
// Replaces: gnnkeras_tpu/ops/ring.py, _ring_kernel launched by
// ring_all_gather (the pallas_ring transport of PartitionedGNN, the
// per-iteration halo exchange of the edge-partitioned engine).  The TPU
// kernel runs P - 1 ring steps: remote DMAs into the right neighbour's
// double-buffered VMEM slots, each gated on a credit semaphore.  Here a
// call is one push and one wait:
//
//   push      a kernel stores x straight into slot r of every peer's receive
//             region (rank r's block, P - 1 stores of the block, and the own
//             copy into out), then the rank records its push event;
//   wait      for every peer q, the host waits (bounded, on a counter in
//             host memory the ranks share) until q has recorded its push of
//             this call, then the stream waits on q's event: the wait is the
//             GPU's cross-process event wait, not a spinning kernel;
//   copy-out  a kernel copies the P - 1 received blocks of the own region
//             into out, then the rank records its copy event.
//
// Every rank's region holds P slots of ``cap`` bytes (slot q receives rank
// q's block) and lives in device memory that the group's ranks map into each
// other's address space through CUDA IPC; the push and copy events are
// interprocess events, their handles exchanged once per group with the
// regions' (gnn_ring_create / gnn_ring_connect, the exchange done by the
// caller).  Before a push writes into a peer's region, the host waits until
// that peer has recorded its copy-out of the previous call and the stream
// waits on that event, so a slot is never overwritten while it is read.
//
// Counters instead of semaphores.  The shared host counters ``posted[q]``
// and ``freed[q]`` are the number of pushes and copy-outs rank q has
// recorded over the group's lifetime; call n waits for freed[q] >= n - 1
// and posted[q] >= n.  A rank cannot run more than one call ahead of a peer
// (its push of call n + 1 needs the peer's copy-out of call n), so when the
// host sees the count, the event's latest record is the one of that call.
// No reset is needed between calls and there is no entry barrier.  The
// copy-out reads the region with ld.global.cg, and the push ends with a
// system-scope fence: the stores also reach a peer on another card (NVLink)
// before the event completes.
//
// Bounded waits.  Only the host waits for another rank, each wait for at
// most ``timeout_ns``; on expiry the call returns kTimedOut and the wrapper
// raises (the counters of the ranks then disagree and the group must be set
// up again).  The device never waits for a rank whose work is not already
// queued: a stream waits only on an event whose record the host has seen.
// That queued work can still fail to finish (the peer's context died after
// it posted); gnn_ring_settle bounds that case: it polls the own copy event
// of the last call, which completes only after the peers' pushes did, for at
// most ``timeout_ns``.  A caller runs it before it synchronises with the
// card (the engine: before each iteration's convergence test and at the end
// of a forward).
//
// What bounds it on an H100: on one card the P ranks are P processes whose
// contexts the GPU time-slices (no MPS).  A context whose stream waits on
// another process's event has no runnable work, so the scheduler runs the
// contexts that do: a call costs the context switches between the ranks'
// pushes and copy-outs, not a time slice per wait.  Under MPS or across cards
// the copies bound it: each rank writes P blocks and reads and writes P - 1
// (16-byte vectors where the block size and the pointers allow).
//
// Entries: gnn_ring_create, gnn_ring_connect, gnn_ring_all_gather,
// gnn_ring_settle and gnn_ring_destroy, plain C functions bound with ctypes.  Each returns a
// cudaError_t (or kTimedOut); the kernels run on the caller's stream.

#include <cuda_runtime.h>
#include <sched.h>
#include <stdint.h>
#include <string.h>
#include <time.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;         // thread blocks per destination
constexpr int kTimedOut = -1;          // a host wait for a peer ran out
constexpr size_t kHandleBytes = 64;    // cudaIpcMemHandle_t, cudaIpcEventHandle_t
constexpr size_t kLine = 64;           // one counter per cache line
static_assert(sizeof(cudaIpcMemHandle_t) == kHandleBytes, "IPC memory handle size");
static_assert(sizeof(cudaIpcEventHandle_t) == kHandleBytes, "IPC event handle size");

struct Ring {
  int rank, P;
  size_t cap;
  char* region;           // this rank's P receive slots
  char** regions;         // host: every rank's region as mapped here (own at rank)
  char** regions_dev;     // the same array on the device, for the push
  cudaEvent_t* push_ev;   // every rank's push event (own created, peers' opened)
  cudaEvent_t* copy_ev;   // every rank's copy event
  uint64_t* counters;     // shared host memory: posted[q] at line q, freed[q] at line P + q
  uint64_t calls;
};

uint64_t* posted(Ring* g, int q) {
  return reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(g->counters) + q * kLine);
}
uint64_t* freed(Ring* g, int q) {
  return reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(g->counters) + (g->P + q) * kLine);
}

uint64_t now_ns() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return static_cast<uint64_t>(t.tv_sec) * 1000000000ull + t.tv_nsec;
}

// Until *counter >= want: spin with yields, then sleep 20 us between polls;
// false when timeout_ns ran out first.
bool wait_host(const uint64_t* counter, uint64_t want, uint64_t timeout_ns) {
  const uint64_t t0 = now_ns();
  for (long i = 0;; ++i) {
    if (__atomic_load_n(counter, __ATOMIC_ACQUIRE) >= want) return true;
    if (i < 4096) {
      sched_yield();
      continue;
    }
    if (now_ns() - t0 > timeout_ns) return false;
    const timespec nap = {0, 20000};
    nanosleep(&nap, nullptr);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) push_kernel(const V* __restrict__ x, V* __restrict__ out,
                                                        char* const* __restrict__ regions, int rank, long words,
                                                        long chunk, size_t cap) {
  const int q = blockIdx.y;
  const long lo = blockIdx.x * chunk;
  const long hi = lo + chunk < words ? lo + chunk : words;
  V* dst = q == rank ? out + static_cast<long>(rank) * words : reinterpret_cast<V*>(regions[q] + rank * cap);
  for (long k = lo + threadIdx.x; k < hi; k += kThreads) dst[k] = x[k];
  __threadfence_system();
}

template <typename V>
__global__ void __launch_bounds__(kThreads) copy_kernel(const char* __restrict__ region, V* __restrict__ out,
                                                        int rank, long words, long chunk, size_t cap) {
  const int q = blockIdx.y;
  if (q == rank) return;
  const long lo = blockIdx.x * chunk;
  const long hi = lo + chunk < words ? lo + chunk : words;
  const V* src = reinterpret_cast<const V*>(region + q * cap);
  V* dst = out + static_cast<long>(q) * words;
  for (long k = lo + threadIdx.x; k < hi; k += kThreads) dst[k] = __ldcg(src + k);
}

template <typename V>
cudaError_t launch(Ring* g, const void* x, void* out, size_t nbytes, bool push, cudaStream_t stream) {
  const long words = static_cast<long>(nbytes / sizeof(V));
  // chunks of at least 32 KiB, at most kMaxChunks of them
  long chunks = static_cast<long>((nbytes + 32767) / 32768);
  chunks = chunks < 1 ? 1 : (chunks > kMaxChunks ? kMaxChunks : chunks);
  const long chunk = (words + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(g->P));
  if (push)
    push_kernel<V><<<grid, kThreads, 0, stream>>>(static_cast<const V*>(x), static_cast<V*>(out), g->regions_dev,
                                                   g->rank, words, chunk, g->cap);
  else
    copy_kernel<V><<<grid, kThreads, 0, stream>>>(g->region, static_cast<V*>(out), g->rank, words, chunk, g->cap);
  return cudaGetLastError();
}

cudaError_t launch_any(Ring* g, const void* x, void* out, size_t nbytes, bool push, cudaStream_t stream) {
  auto aligned = [](const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
  // the slots start at multiples of cap (a multiple of 256) in 256-aligned regions
  const size_t a = (nbytes % 16 == 0 && aligned(x, 16) && aligned(out, 16))  ? 16
                   : (nbytes % 4 == 0 && aligned(x, 4) && aligned(out, 4))   ? 4
                   : (nbytes % 2 == 0 && aligned(x, 2) && aligned(out, 2))   ? 2
                                                                              : 1;
  switch (a) {
    case 16: return launch<int4>(g, x, out, nbytes, push, stream);
    case 4: return launch<unsigned int>(g, x, out, nbytes, push, stream);
    case 2: return launch<unsigned short>(g, x, out, nbytes, push, stream);
    default: return launch<unsigned char>(g, x, out, nbytes, push, stream);
  }
}

// Wait until every peer's count has reached ``want``, then let the stream
// wait on the peer's event of that count.
int wait_peers(Ring* g, bool pushes, uint64_t want, uint64_t timeout_ns, cudaStream_t stream) {
  for (int q = 0; q < g->P; ++q) {
    if (q == g->rank) continue;
    if (!wait_host(pushes ? posted(g, q) : freed(g, q), want, timeout_ns)) return kTimedOut;
    const cudaError_t e = cudaStreamWaitEvent(stream, pushes ? g->push_ev[q] : g->copy_ev[q], 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Record the own event and publish the count at once: the peers' streams
// wait on the event, not their hosts.
int post(Ring* g, bool pushes, uint64_t n, cudaStream_t stream) {
  const cudaError_t e = cudaEventRecord(pushes ? g->push_ev[g->rank] : g->copy_ev[g->rank], stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  __atomic_store_n(pushes ? posted(g, g->rank) : freed(g, g->rank), n, __ATOMIC_RELEASE);
  return 0;
}

}  // namespace

// This rank's part of a group: its region of P slots of ``cap`` bytes, its
// push and copy events, the host counters at ``counters`` (2 P lines of 64
// bytes, zeroed, shared by the ranks).  Writes the region's and the two
// events' IPC handles (3 x 64 bytes) into ``handles`` for the other ranks.
extern "C" int gnn_ring_create(int rank, int P, size_t cap, void* counters, void** ring, void* handles) {
  if (P < 2 || rank < 0 || rank >= P || cap % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Ring* g = new Ring();
  g->rank = rank;
  g->P = P;
  g->cap = cap;
  g->counters = static_cast<uint64_t*>(counters);
  g->regions = new char*[P]();
  g->push_ev = new cudaEvent_t[P]();
  g->copy_ev = new cudaEvent_t[P]();
  *ring = g;
  char* h = static_cast<char*>(handles);
  cudaError_t e = cudaMalloc(reinterpret_cast<void**>(&g->region), P * cap);
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(reinterpret_cast<cudaIpcMemHandle_t*>(h), g->region);
  const unsigned flags = cudaEventDisableTiming | cudaEventInterprocess;
  if (e == cudaSuccess) e = cudaEventCreateWithFlags(&g->push_ev[rank], flags);
  if (e == cudaSuccess) e = cudaEventCreateWithFlags(&g->copy_ev[rank], flags);
  if (e == cudaSuccess)
    e = cudaIpcGetEventHandle(reinterpret_cast<cudaIpcEventHandle_t*>(h + kHandleBytes), g->push_ev[rank]);
  if (e == cudaSuccess)
    e = cudaIpcGetEventHandle(reinterpret_cast<cudaIpcEventHandle_t*>(h + 2 * kHandleBytes), g->copy_ev[rank]);
  g->regions[rank] = g->region;
  return static_cast<int>(e);
}

// Map every other rank's region and open its events: ``handles`` holds the P
// ranks' 3 x 64 bytes from gnn_ring_create, in rank order.
extern "C" int gnn_ring_connect(void* ring, const void* handles) {
  Ring* g = static_cast<Ring*>(ring);
  const char* h = static_cast<const char*>(handles);
  cudaError_t e = cudaSuccess;
  for (int q = 0; q < g->P && e == cudaSuccess; ++q) {
    if (q == g->rank) continue;
    const char* hq = h + q * 3 * kHandleBytes;
    cudaIpcMemHandle_t mh;
    cudaIpcEventHandle_t ph, ch;
    memcpy(&mh, hq, kHandleBytes);
    memcpy(&ph, hq + kHandleBytes, kHandleBytes);
    memcpy(&ch, hq + 2 * kHandleBytes, kHandleBytes);
    e = cudaIpcOpenMemHandle(reinterpret_cast<void**>(&g->regions[q]), mh, cudaIpcMemLazyEnablePeerAccess);
    if (e == cudaSuccess) e = cudaIpcOpenEventHandle(&g->push_ev[q], ph);
    if (e == cudaSuccess) e = cudaIpcOpenEventHandle(&g->copy_ev[q], ch);
  }
  if (e == cudaSuccess) e = cudaMalloc(reinterpret_cast<void**>(&g->regions_dev), g->P * sizeof(char*));
  if (e == cudaSuccess) e = cudaMemcpy(g->regions_dev, g->regions, g->P * sizeof(char*), cudaMemcpyHostToDevice);
  return static_cast<int>(e);
}

// Unmap the peers' regions and events and free the own; the caller makes
// sure first that no rank's work on them is pending.
extern "C" int gnn_ring_destroy(void* ring) {
  Ring* g = static_cast<Ring*>(ring);
  cudaError_t first = cudaSuccess;
  auto keep = [&first](cudaError_t e) {
    if (first == cudaSuccess) first = e;
  };
  for (int q = 0; q < g->P; ++q) {
    if (q != g->rank && g->regions[q] != nullptr) keep(cudaIpcCloseMemHandle(g->regions[q]));
    if (g->push_ev[q] != nullptr) keep(cudaEventDestroy(g->push_ev[q]));
    if (g->copy_ev[q] != nullptr) keep(cudaEventDestroy(g->copy_ev[q]));
  }
  if (g->regions_dev != nullptr) keep(cudaFree(g->regions_dev));
  if (g->region != nullptr) keep(cudaFree(g->region));
  delete[] g->regions;
  delete[] g->push_ev;
  delete[] g->copy_ev;
  delete g;
  return static_cast<int>(first);
}

// out (P * nbytes) <- every rank's x (nbytes), in rank order: wait for the
// peers' copy-outs of the previous call, push, wait for the peers' pushes,
// copy out.  Returns kTimedOut when a host wait ran out.
extern "C" int gnn_ring_all_gather(void* ring, const void* x, void* out, size_t nbytes,
                                   unsigned long long timeout_ns, void* stream) {
  Ring* g = static_cast<Ring*>(ring);
  if (nbytes == 0 || nbytes > g->cap) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t n = ++g->calls;
  int err = n > 1 ? wait_peers(g, false, n - 1, timeout_ns, s) : 0;
  if (err == 0) err = static_cast<int>(launch_any(g, x, out, nbytes, true, s));
  if (err == 0) err = post(g, true, n, s);
  if (err == 0) err = wait_peers(g, true, n, timeout_ns, s);
  if (err == 0) err = static_cast<int>(launch_any(g, x, out, nbytes, false, s));
  if (err == 0) err = post(g, false, n, s);
  return err;
}

// Until the last call's copy-out has completed on the card (and with it the
// peers' pushes it waited for): polls the own copy event, yielding, then
// sleeping 20 us between polls.  Returns kTimedOut after ``timeout_ns``.
extern "C" int gnn_ring_settle(void* ring, unsigned long long timeout_ns) {
  Ring* g = static_cast<Ring*>(ring);
  const uint64_t t0 = now_ns();
  for (long i = 0;; ++i) {
    const cudaError_t e = cudaEventQuery(g->copy_ev[g->rank]);
    if (e != cudaErrorNotReady) return static_cast<int>(e);
    if (i < 4096) {
      sched_yield();
      continue;
    }
    if (now_ns() - t0 > timeout_ns) return kTimedOut;
    const timespec nap = {0, 20000};
    nanosleep(&nap, nullptr);
  }
}
