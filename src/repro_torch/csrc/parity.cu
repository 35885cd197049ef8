// K2: stripe XOR parity (the paper's cross-page parity).
//
// Replaces: repro/kernels/parity/parity.py `stripe_parity_striped` (the
// Pallas kernel, pallas_call at :29), which took a pre-striped
// (n_stripes, P, L) view that ops.py zero-padded with jnp.pad — a copy of
// the whole lane view whenever n_blocks % P != 0.
//
// Computes: parity[s, i] = XOR_{p < P, s*P+p < n_blocks} w[s*P+p, i].
// A sharded leaf's (k, n_blocks, L) lane view takes one launch: the grid's
// y index is the shard, a stripe's members are that shard's blocks only
// (stripes never span shards), and parity holds the k shards' stripes,
// shard after shard.
//
// Bound: bytes.  It reads every lane once and writes one parity row per
// stripe: (n_blocks * L * 4 + n_stripes * L * 4) / 3.35 TB/s on an H100
// SXM — about 3.2 ms for the 8 GiB heap with 4+1 stripes.
//
// Design: one CTA (256 threads) per stripe of a shard, the grid striding
// if there are more; the one-shard instance does no shard arithmetic.  Each thread owns a 16-byte column of the stripe: it loads the same
// `uint4` of each member (coalesced across the warp) and XORs them in
// registers, then writes the parity `uint4` once.  Members at or past
// n_blocks (a partial last stripe) are skipped, which is the reference's
// zero padding without the padded copy.  Offsets are 64-bit.
#include "vilamb_common.cuh"

namespace vilamb {

template <bool kSharded>
__global__ void __launch_bounds__(kThreads)
parity_kernel(const uint4* __restrict__ lanes, uint4* __restrict__ parity,
              int64_t n_blocks, int64_t l4, int64_t stripe, int64_t n_stripes) {
  if (kSharded) {                                   // this CTA's shard
    lanes += int64_t(blockIdx.y) * n_blocks * l4;
    parity += int64_t(blockIdx.y) * n_stripes * l4;
  }
  for (int64_t s = blockIdx.x; s < n_stripes; s += gridDim.x) {
    const int64_t first = s * stripe;
    const int64_t rest = n_blocks - first;
    const int64_t members = rest < stripe ? rest : stripe;
    const uint4* base = lanes + first * l4;
    for (int64_t j = threadIdx.x; j < l4; j += kThreads) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (int64_t p = 0; p < members; ++p) xor4(acc, base[p * l4 + j]);
      parity[s * l4 + j] = acc;
    }
  }
}

}  // namespace vilamb

// lanes: uint32[shards, n_blocks, L]; parity: uint32[shards * ceil(n_blocks / P), L].
// At most 65,535 shards (the grid's y).
extern "C" int vilamb_parity(const void* lanes, void* parity, int64_t n_blocks,
                             int64_t lanes_per_block, int64_t stripe, int64_t shards,
                             void* stream) {
  if (stripe < 1 || shards < 1 || shards > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_stripes = (n_blocks + stripe - 1) / stripe;
  if (n_stripes > 0) {
    const dim3 grid(vilamb::grid_for(n_stripes), static_cast<unsigned>(shards));
    auto kernel = shards > 1 ? vilamb::parity_kernel<true> : vilamb::parity_kernel<false>;
    kernel<<<grid, vilamb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(lanes), static_cast<uint4*>(parity), n_blocks,
        lanes_per_block / 4, stripe, n_stripes);
  }
  return static_cast<int>(cudaGetLastError());
}
