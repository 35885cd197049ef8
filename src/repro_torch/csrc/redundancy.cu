// K3: work-queue-driven fused checksum + parity update (Algorithm 1,
// lines 7-18).
//
// Replaces: repro/kernels/redundancy/redundancy.py `fused_update_striped`
// (the Pallas kernel, pallas_call at :93) plus the merge in its wrapper
// (ops.py `fused_update`, :51-53).  On the TPU the scalar-prefetched work
// queue drove the BlockSpec index map, 128-lane checksum partials were
// carried across lane tiles, and the wrapper folded them and merged
// checksums and parity into the old arrays under the dirty masks.
//
// Computes, for each i < *count (the count is read on the device, so the
// host never waits): stripe s = ids[i] gets
//   parity[s]   = XOR of its members (members >= n_blocks are zero), and
//   checksum[b] = XOR_i fmix32(w[b,i] ^ salt(b,i)) for each member b that
//                 is inside the leaf and dirty (block_dirty[b] != 0).
// Everything else — clean stripes, clean members — is left byte-identical.
// The update is in place on `checksums` and `parity`.
//
// Bound: bytes.  For this run's queue it reads the leaf's members of each
// queued stripe once and writes one parity row per stripe and 4 bytes per
// dirty block: (members * L * 4 + count * L * 4 + dirty * 4) / 3.35 TB/s on
// an H100 SXM.  A due tick of the 8 GiB heap with at most 65,536 dirty
// stripes reads at most 1 GiB (<= 0.32 ms).
//
// Design: one CTA (256 threads) per queued stripe, a grid-stride loop over
// the queue.  A thread owns a 16-byte column: it loads that `uint4` of each
// member once, XORs it into the parity column, and mixes it into that
// member's running checksum (up to kMaxStripe members, unrolled so the
// accumulators stay in registers).  Each stripe's slab is therefore read
// exactly once for both outputs.  Per member, a warp XOR-shuffle and a
// shared-memory combine of the 8 warps finish the checksum; thread p then
// writes member p's checksum if it is dirty.  Offsets are 64-bit.
#include "vilamb_common.cuh"

namespace vilamb {

constexpr int kMaxStripe = 16;

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const uint4* __restrict__ lanes, uint32_t* __restrict__ checksums,
                    uint4* __restrict__ parity, const uint8_t* __restrict__ block_dirty,
                    const int32_t* __restrict__ ids, const int32_t* __restrict__ count,
                    int64_t n_blocks, int64_t l4, int stripe, int64_t n_stripes) {
  __shared__ uint32_t smem[kWarps][kMaxStripe];
  const int64_t queued = *count < n_stripes ? int64_t(*count) : n_stripes;
  for (int64_t i = blockIdx.x; i < queued; i += gridDim.x) {
    const int64_t s = ids[i];
    const int64_t first = s * stripe;
    const int64_t rest = n_blocks - first;
    const int members = int(rest < stripe ? rest : stripe);
    const uint4* base = lanes + first * l4;
    uint32_t ck[kMaxStripe];
#pragma unroll
    for (int p = 0; p < kMaxStripe; ++p) ck[p] = 0u;
    for (int64_t j = threadIdx.x; j < l4; j += kThreads) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t lane = uint32_t(j) * 4u;
#pragma unroll
      for (int p = 0; p < kMaxStripe; ++p) {
        if (p < members) {
          const uint4 w = base[p * l4 + j];
          xor4(acc, w);
          ck[p] ^= mix4(w, uint32_t(first + p) * GOLDEN, lane);
        }
      }
      parity[s * l4 + j] = acc;
    }
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int p = 0; p < kMaxStripe; ++p) {
      if (p < members) {  // uniform across the CTA
        const uint32_t v = warp_xor(ck[p]);
        if ((threadIdx.x & 31) == 0) smem[warp][p] = v;
      }
    }
    __syncthreads();
    if (int(threadIdx.x) < members) {
      const int p = threadIdx.x;
      const int64_t b = first + p;
      if (block_dirty[b]) {
        uint32_t v = 0u;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v ^= smem[w][p];
        checksums[b] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace vilamb

// lanes: uint32[n_blocks, L]; checksums: uint32[n_blocks] (in place);
// parity: uint32[n_stripes, L] (in place); block_dirty: bool[n_blocks];
// ids: int32[n_stripes] work queue; count: int32[1] live queue length.
// `grid` CTAs stride over the queue (the queue length stays on the device).
extern "C" int vilamb_fused_update(const void* lanes, void* checksums, void* parity,
                                   const void* block_dirty, const void* ids,
                                   const void* count, int64_t n_blocks,
                                   int64_t lanes_per_block, int64_t stripe,
                                   int64_t grid, void* stream) {
  const int64_t n_stripes = (n_blocks + stripe - 1) / stripe;
  if (stripe < 1 || stripe > vilamb::kMaxStripe) return static_cast<int>(cudaErrorInvalidValue);
  if (n_stripes > 0 && grid > 0) {
    vilamb::fused_update_kernel<<<vilamb::grid_for(grid), vilamb::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(lanes), static_cast<uint32_t*>(checksums),
        static_cast<uint4*>(parity), static_cast<const uint8_t*>(block_dirty),
        static_cast<const int32_t*>(ids), static_cast<const int32_t*>(count), n_blocks,
        lanes_per_block / 4, static_cast<int>(stripe), n_stripes);
  }
  return static_cast<int>(cudaGetLastError());
}
