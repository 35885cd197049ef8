// Shared device helpers for the Vilamb kernels (sm_90a).
//
// The mixing constants and fmix32 are those of the reference's
// repro/kernels/common.py; every word is a raw uint32, whatever the leaf's
// dtype.  Folds are XOR: each thread XORs its lanes, a warp XOR-shuffles,
// and the warps meet in shared memory.  The mbarrier helpers serve the
// kernels that stage tiles through shared memory (flash attention, K3).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vilamb {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t SALT2 = 0x85EBCA77u;
constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;

// Threads per CTA for every kernel here: 8 warps.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Murmur3 32-bit finalizer.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}

// XOR of the four mixed, position-salted words of one 16-byte load.
// `bsalt` is the block's salt and `lane` the index of the load's first lane.
__device__ __forceinline__ uint32_t mix4(uint4 w, uint32_t bsalt, uint32_t lane) {
  return fmix32(w.x ^ bsalt ^ (lane * SALT2)) ^
         fmix32(w.y ^ bsalt ^ ((lane + 1u) * SALT2)) ^
         fmix32(w.z ^ bsalt ^ ((lane + 2u) * SALT2)) ^
         fmix32(w.w ^ bsalt ^ ((lane + 3u) * SALT2));
}

__device__ __forceinline__ void xor4(uint4& acc, uint4 w) {
  acc.x ^= w.x;
  acc.y ^= w.y;
  acc.z ^= w.z;
  acc.w ^= w.w;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// XOR of `v` over the CTA (kThreads threads); the result is valid in
// thread 0.  `smem` holds kWarps words; it is free again on return.
__device__ __forceinline__ uint32_t block_xor(uint32_t v, uint32_t* smem) {
  v = warp_xor(v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r ^= smem[w];
  }
  __syncthreads();
  return r;
}

// One CTA per block or stripe; the grid strides when there are more.
inline int grid_for(int64_t items) {
  const int64_t cap = int64_t(1) << 30;
  return int(items < cap ? items : cap);
}

// ------------------------------------------------ mbarriers and bulk copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace vilamb
