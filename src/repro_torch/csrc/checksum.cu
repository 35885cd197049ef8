// K1: per-block position-salted fmix32 XOR-fold checksum.
//
// Replaces: repro/kernels/checksum/checksum.py `checksum_partials` (the
// Pallas kernel, pallas_call at :49), whose grid (n_blocks, lane_tiles)
// carried 128 lane partials across the sequential lane-tile axis and left
// the final fold to ops.py.
//
// Computes: out[b] = XOR_i fmix32(w[b,i] ^ ((b + block_offset) * GOLDEN
//                                           ^ i * SALT2)), all uint32.
// A sharded leaf's (k, n_blocks, L) lane view takes one launch: the grid's
// y index is the shard, and each shard salts by its local block index, as
// the reference's per-shard program does; out is the k shards' checksums,
// shard after shard.  Shard s starts `shard_stride` lanes after shard s-1:
// n_blocks * L for a whole leaf, more for a patrol window of row-range
// shards (blocks [start, start + w) of every shard, read in place from the
// leaf: the window's shards lie a whole shard apart).
//
// Bound: bytes.  It reads every lane once and writes 4 bytes per block:
// (n_blocks * L * 4 + n_blocks * 4) / 3.35 TB/s on an H100 SXM — about
// 2.6 ms for the 8 GiB heap.  The ~12 integer operations per lane are far
// below the ALU rate.
//
// Design: one CTA (256 threads) per block of a shard, the grid striding if
// there are more than 2^30 blocks a shard.  The one-shard instance does no
// shard arithmetic at all: at 4 KiB a block the shard offset's few
// instructions a CTA cost the sharded launch ~5% of its time
// (`chip_smoke.py` phase 21 on an H100 80GB HBM3 at 700 W), which the
// machine-local launch does not pay.  Each thread walks the block's lanes in 16-byte
// `uint4` loads (neighbouring threads on neighbouring addresses) and keeps
// one running XOR, so the TPU's 128-lane partials never exist: a warp XOR-
// shuffle and a shared-memory combine of the 8 warps finish the fold in the
// kernel.  `block_offset` is a runtime argument, so a window of blocks
// (the later patrol slice) uses the same kernel.  Offsets are 64-bit:
// block * L exceeds 2^31 lanes on an 8 GiB heap.
#include "vilamb_common.cuh"

namespace vilamb {

template <bool kSharded>
__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint4* __restrict__ lanes, uint32_t* __restrict__ out,
                int64_t n_blocks, int64_t l4, uint32_t block_offset,
                int64_t stride4) {
  __shared__ uint32_t smem[kWarps];
  if (kSharded) {                                   // this CTA's shard
    lanes += int64_t(blockIdx.y) * stride4;
    out += int64_t(blockIdx.y) * n_blocks;
  }
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const uint4* row = lanes + b * l4;
    const uint32_t bsalt = (uint32_t(b) + block_offset) * GOLDEN;
    uint32_t acc = 0;
    for (int64_t j = threadIdx.x; j < l4; j += kThreads) {
      acc ^= mix4(row[j], bsalt, uint32_t(j) * 4u);
    }
    acc = block_xor(acc, smem);
    if (threadIdx.x == 0) out[b] = acc;
  }
}

}  // namespace vilamb

// lanes: uint32[shards, n_blocks, L], each shard's (n_blocks, L) rows
// contiguous and `shard_stride` lanes after the previous shard's (16-byte
// aligned, L % 4 == 0, shard_stride % 4 == 0); out: uint32[shards *
// n_blocks].  At most 65,535 shards (the grid's y).
extern "C" int vilamb_checksum(const void* lanes, void* out, int64_t n_blocks,
                               int64_t lanes_per_block, int64_t block_offset,
                               int64_t shards, int64_t shard_stride, void* stream) {
  if (shards < 1 || shards > 65535 || shard_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    const dim3 grid(vilamb::grid_for(n_blocks), static_cast<unsigned>(shards));
    auto kernel = shards > 1 ? vilamb::checksum_kernel<true> : vilamb::checksum_kernel<false>;
    kernel<<<grid, vilamb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(lanes), static_cast<uint32_t*>(out), n_blocks,
        lanes_per_block / 4, static_cast<uint32_t>(block_offset), shard_stride / 4);
  }
  return static_cast<int>(cudaGetLastError());
}
