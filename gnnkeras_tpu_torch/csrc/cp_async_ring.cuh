// Shared by the kernels that stream tiles through shared memory in
// persistent blocks (strip_matmul.cuh, fused_unfold.cuh): the asynchronous
// 16-byte copies of a cp.async ring, how many ring stages and blocks fit on
// an SM, and the count of blocks a persistent launch keeps resident.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

// Blocks of ``bytes`` of shared memory that fit on one SM (228 KiB, 1 KiB
// of it reserved per block)
constexpr int blocks_fit(int bytes) { return 228 * 1024 / (bytes + 1024); }

// Ring stages of ``stage`` bytes beside ``fixed`` bytes: three where they
// keep more tiles in flight on an SM than two (two leave room for more
// blocks, whose warps hide latency)
constexpr int ring_stages(int stage, int fixed) {
  return 3 * blocks_fit(3 * stage + fixed) > 2 * blocks_fit(2 * stage + fixed) ? 3 : 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Blocks of ``kernel`` resident on the whole card (``threads`` a block,
// ``bytes`` of dynamic shared memory, the limit raised first where it
// exceeds 48 KiB), for the current device.  Found at the device's first
// launch and kept in the caller's ``resident`` (one per kernel), so that
// later launches on that device, including ones captured into a CUDA graph,
// make no non-stream API call.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int bytes, int (&resident)[kMaxDevices], int* count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  *count = resident[dev];
  return cudaSuccess;
}

}  // namespace
