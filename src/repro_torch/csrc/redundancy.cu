// K3: fused checksum + parity update of a due group's leaves (Algorithm 1,
// lines 7-18), one launch for the whole group.
//
// Replaces: repro/kernels/redundancy/redundancy.py:67 `fused_update_striped`
// (the Pallas kernel, pallas_call at :93) plus the merge in its wrapper
// (ops.py `fused_update`, :51-53).  On the TPU a scalar-prefetched queue of
// dirty stripes drove a (stripes, L // tile) grid, 128-lane checksum
// partials were carried across the sequential lane-tile axis, and the
// wrapper merged checksums and parity into the old arrays under the masks.
//
// Computes, for every leaf ("job") of the launch and every stripe s of it
// holding a dirty block (a bit set in the leaf's packed `dirty | shadow`
// words, read here; bits at or past n_blocks are ignored):
//   parity[s]   = XOR of its members (members >= n_blocks are zero), and
//   checksum[b] = XOR_i fmix32(w[b,i] ^ salt(b,i)) for each dirty member b.
// Everything else (clean stripes, clean members) is left byte-identical.
// The update is in place on `checksums` and `parity`; the host never waits.
//
// Bound: bytes.  It reads the dirty stripes' members once and every packed
// word once, and writes one parity row per dirty stripe and 4 bytes per
// dirty block: (dirty_stripes * (members + 1) * L * 4 + dirty * 4 +
// words * 4) / 3.35 TB/s on an H100 SXM.
//
// Design.
// - Work: a stripe is cut into column tiles of 256 * K 16-byte columns (K
//   = 2 for stripes of up to 4 members over blocks above 4 KiB, else 1).
//   An item is a stripe, or a run of its tiles where the launch has too
//   few stripes to give each CTA several (the wrapper decides from the
//   shapes alone): a stripe of 4 KiB blocks is one tile, one of 64 KiB
//   blocks eight.  The items of all the launch's leaves are numbered one
//   after another (a leaf's descriptor holds its first item's number).
// - Grid: persistent, the SM count times the instance's occupancy, found
//   once a device.  A CTA is 8 consumer warps and one producer warp.
// - The producer warp takes runs of items from a ticket (an atomic counter
//   the wrapper zeroes for each launch; a run is about 1/64 of a CTA's
//   share of the launch's bytes), tests 32 items a ballot from the packed
//   words (a stripe of 1-16 members spans at most 2 words; a clean item
//   costs that test and nothing else), and streams each dirty item's tiles
//   into a ring of shared-memory stages with TMA bulk copies
//   (`cp.async.bulk`, one a member row, or one a stripe of whole blocks)
//   under full/empty mbarriers: 96 KiB a CTA, two CTAs an SM (128 KiB and
//   one at 16 members), so 2-5 tiles a CTA stay in flight while the
//   consumers reduce.  The ticket balances the dirty items over the CTAs
//   whatever their places: a static share left the CTAs' dirty counts as
//   far apart as random writes make them.
// - The consumer warps fold each tile into its parity columns (stored at
//   once) and per-member checksum partials kept in registers across the
//   item's tiles; at its last tile the partials meet across the warps
//   (shuffles, then shared memory behind the consumers' own barrier) and
//   warp 0 writes the dirty members' checksums.
// - An item that is a run of a stripe's tiles folds its partials with the
//   stripe's other runs by option (b): it stores them in a scratch slot of
//   its own, fences, and bumps the stripe's counter; the run that arrives
//   last XORs the stripe's slots (exact in any order, so the bits do not
//   depend on scheduling) and writes the checksums.  The ticket, the
//   counters and the slots are stream-ordered tensors from the caching
//   allocator, zeroed by the wrapper for each call, so launches in flight
//   on two streams never share them and none depends on an earlier one's
//   leftovers.  (a), a cluster per stripe reducing through DSMEM, would tie
//   a stripe's tiles to one co-scheduled group sized per L.
// Offsets are 64-bit.  Descriptors travel in the launch's own parameters
// (`__grid_constant__`, up to 32,764 bytes since CUDA 12.1).
#include "vilamb_common.cuh"

namespace vilamb {
namespace k3 {

constexpr int kMaxStripe = 16;
constexpr int kDescWords = 11;
// Descriptor words: lanes, checksums, parity, words (pointers), n_blocks,
// l4 (16-byte columns a block), tiles (column tiles a stripe), cpt (tiles
// an item), first item, and for a job whose stripes span several items its
// first counter and first partial item (else -1).
enum { kLanes, kChecksums, kParity, kWords, kBlocks, kL4, kTiles, kCpt, kFirst, kCnt, kPart };
#if CUDART_VERSION >= 12010
constexpr int kMaxJobs = 352;
#else
constexpr int kMaxJobs = 44;
#endif
constexpr int kCtaThreads = kThreads + 32;   // 8 consumer warps and the producer warp

struct Params {
  int64_t desc[kMaxJobs * kDescWords];
  int64_t total_items;
  int64_t grab;          // items a ticket hands out
  int32_t* ticket;       // zeroed: the number of the next grab
  int32_t* counters;
  uint32_t* partials;
  int n_jobs;
  int stripe;
};

// A kernel instance: stripes of at most S members, tiles of K column
// steps of the consumers' 256 threads (16-byte columns), a ring of N
// stages of S tile rows in dynamic shared memory.  96 KiB a CTA, two CTAs
// an SM, except S = 16 (128 KiB, one).
template <int S, int K, int N>
struct Ring {
  static constexpr int kCols = kThreads * K;
  static constexpr int kStages = N;
  static constexpr int kRowBytes = kCols * 16;
  static constexpr int kStageBytes = S * kRowBytes;
  static constexpr int kBytes = kStages * kStageBytes;
};

// What a stage holds: the item's stripe, job | chunk << 9, the tile, the
// stripe's dirty members, and flags (kLastTile of its item, kDone: no more).
struct Header {
  int32_t stripe, jobchunk, tile;
  uint32_t mask, flags;
};
enum : uint32_t { kLastTile = 1u, kDone = 2u };

// ---------------------------------------------------------------- PTX
// A bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The consumers' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// ------------------------------------------------------------- kernel
// A dirty item: job d's stripe s, its tiles [t0, t1), m members in the leaf.
struct Item {
  const int64_t* d;
  int64_t s, first;
  int t0, t1, m, chunk;
};

__device__ __forceinline__ Item item_of(const Params& prm, int P, int32_t stripe,
                                        int32_t jobchunk) {
  const int64_t* d = prm.desc + (jobchunk & 511) * kDescWords;
  const int chunk = jobchunk >> 9, cpt = int(d[kCpt]), tiles = int(d[kTiles]);
  const int64_t first = int64_t(stripe) * P, rest = d[kBlocks] - first;
  const int t0 = chunk * cpt;
  return Item{d, stripe, first, t0, t0 + cpt < tiles ? t0 + cpt : tiles,
              int(rest < P ? rest : P), chunk};
}

template <class R>
__device__ __forceinline__ int cols_of(const int64_t* d, int t) {
  const int64_t left = d[kL4] - int64_t(t) * R::kCols;
  return int(left < R::kCols ? left : R::kCols);
}

// The issue of one tile's member rows into a stage (one thread).
template <class R>
__device__ __forceinline__ void issue_tile(const Item& it, int t, uint32_t stage,
                                           uint32_t bar) {
  const uint32_t bytes = uint32_t(cols_of<R>(it.d, t)) * 16u;
  mbar_expect_tx(bar, bytes * uint32_t(it.m));
  const int64_t l4 = it.d[kL4];
  const uint4* row = reinterpret_cast<const uint4*>(it.d[kLanes]) + it.first * l4
                     + int64_t(t) * R::kCols;
  if (l4 == R::kCols) {   // whole blocks fill the stage's rows: one copy
    bulk_load(stage, row, bytes * uint32_t(it.m), bar);
    return;
  }
  for (int p = 0; p < it.m; ++p)
    bulk_load(stage + uint32_t(p) * R::kRowBytes, row + p * l4, bytes, bar);
}

// The dirty test of item u (u < total): its stripe's dirty members from
// the packed words (a stripe of 1-16 members spans at most 2 words; bits
// at or past n_blocks are not its members'), its stripe and job | chunk.
__device__ __forceinline__ uint32_t test_item(const Params& prm, const int64_t* s_first,
                                              int64_t u, int32_t& stripe, int32_t& jobchunk) {
  const int P = prm.stripe;
  int lo = 0, hi = prm.n_jobs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_first[mid] <= u) lo = mid; else hi = mid - 1;
  }
  const int64_t* d = prm.desc + lo * kDescWords;
  const int64_t per = (d[kTiles] + d[kCpt] - 1) / d[kCpt];   // items a stripe
  const int64_t lu = u - s_first[lo];
  const int64_t s = per == 1 ? lu : lu / per;
  const int64_t first = s * P, rest = d[kBlocks] - first;
  const int m = int(rest < P ? rest : P);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(d[kWords]);
  const int64_t wi = first >> 5;
  const int sh = int(first & 31);
  uint64_t bits = __ldg(words + wi);
  if (sh + m > 32) bits |= uint64_t(__ldg(words + wi + 1)) << 32;
  stripe = int32_t(s);
  jobchunk = lo | int32_t(lu - s * per) << 9;
  return uint32_t((bits >> sh) & ((uint64_t(1) << m) - 1));
}

template <int S, int K, int N>
__global__ void __launch_bounds__(kCtaThreads, S <= 8 ? 2 : 1)
fused_update_kernel(const __grid_constant__ Params prm) {
  using R = Ring<S, K, N>;
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ uint64_t s_full[N], s_empty[N];
  __shared__ Header s_hdr[N];
  __shared__ int64_t s_first[kMaxJobs + 1];
  __shared__ uint32_t s_red[2][kWarps][S];

  const int n_jobs = prm.n_jobs, P = prm.stripe;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n_jobs; i += kCtaThreads)
    s_first[i] = prm.desc[i * kDescWords + kFirst];
  if (threadIdx.x == 0) {
    s_first[n_jobs] = prm.total_items;
    for (int q = 0; q < N; ++q) {
      mbar_init(smem_u32(&s_full[q]), 1);
      mbar_init(smem_u32(&s_empty[q]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t ring0 = smem_u32(ring), full0 = smem_u32(&s_full[0]),
                 empty0 = smem_u32(&s_empty[0]);

  if (warp == kWarps) {
    // The producer warp: takes `grab` items at a time from the launch's
    // ticket, tests 32 of them a ballot, and streams each dirty item's
    // tiles into the ring, N ahead of the consumers.
    uint32_t pk = 0;   // tiles issued: stage pk % N, its use pk / N
    int grab = 0;
    if (lane == 0) grab = atomicAdd(prm.ticket, 1);
    grab = __shfl_sync(0xffffffffu, grab, 0);
    while (int64_t(grab) * prm.grab < prm.total_items) {
      int next = 0;
      if (lane == 0) next = atomicAdd(prm.ticket, 1);   // lands while this one runs
      const int64_t u0 = int64_t(grab) * prm.grab;
      const int64_t u1 = u0 + prm.grab < prm.total_items ? u0 + prm.grab : prm.total_items;
      for (int64_t w = u0; w < u1; w += 32) {
        const int64_t u = w + lane;
        int32_t stripe = 0, jobchunk = 0;
        const uint32_t mask = u < u1 ? test_item(prm, s_first, u, stripe, jobchunk) : 0u;
        for (uint32_t dirty = __ballot_sync(0xffffffffu, mask != 0u); dirty;
             dirty &= dirty - 1u) {
          const int src = __ffs(dirty) - 1;
          const int32_t st_s = __shfl_sync(0xffffffffu, stripe, src);
          const int32_t st_jc = __shfl_sync(0xffffffffu, jobchunk, src);
          const uint32_t st_m = __shfl_sync(0xffffffffu, mask, src);
          const Item it = item_of(prm, P, st_s, st_jc);
          for (int t = it.t0; t < it.t1; ++t, ++pk) {
            const uint32_t st = pk % N;
            mbar_wait(empty0 + 8u * st, ((pk / N) & 1u) ^ 1u);
            if (lane == 0) {
              s_hdr[st] = Header{st_s, st_jc, t, st_m, t + 1 == it.t1 ? kLastTile : 0u};
              issue_tile<R>(it, t, ring0 + st * R::kStageBytes, full0 + 8u * st);
            }
            __syncwarp();
          }
        }
      }
      grab = __shfl_sync(0xffffffffu, next, 0);
    }
    const uint32_t st = pk % N;
    mbar_wait(empty0 + 8u * st, ((pk / N) & 1u) ^ 1u);
    if (lane == 0) {
      s_hdr[st].flags = kDone;
      mbar_arrive(full0 + 8u * st);
    }
    return;
  }

  // The consumer warps: each tile's parity columns and checksum partials;
  // at an item's last tile the partials meet across the warps and warp 0
  // writes the dirty members' checksums.
  uint32_t ck[S];
#pragma unroll
  for (int p = 0; p < S; ++p) ck[p] = 0u;
  uint32_t e = 0;    // items finished: s_red half e & 1
  for (uint32_t k = 0;; ++k) {
    const uint32_t st = k % N;
    mbar_wait(full0 + 8u * st, (k / N) & 1u);
    const Header h = s_hdr[st];
    if (h.flags & kDone) break;
    const Item it = item_of(prm, P, h.stripe, h.jobchunk);
    const int cols = cols_of<R>(it.d, h.tile);
    const int64_t col0 = int64_t(h.tile) * R::kCols + threadIdx.x;
    const uint4* stage = ring + st * (R::kStageBytes / 16);
    uint4 acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const uint32_t bsalt = uint32_t(it.first + p) * GOLDEN;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int j = c * kThreads + threadIdx.x;
        if (p < it.m && j < cols) {
          const uint4 v = stage[p * R::kCols + j];
          xor4(acc[c], v);
          ck[p] ^= mix4(v, bsalt, uint32_t(col0 + c * kThreads) * 4u);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8u * st);   // this warp is done with the stage
    uint4* par = reinterpret_cast<uint4*>(it.d[kParity]) + it.s * it.d[kL4];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c * kThreads + int(threadIdx.x) < cols) __stcs(par + col0 + c * kThreads, acc[c]);
    }
    if (!(h.flags & kLastTile)) continue;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      if (p < it.m) {  // uniform across the consumers
        const uint32_t r = warp_xor(ck[p]);
        if (lane == 0) s_red[e & 1u][warp][p] = r;
      }
      ck[p] = 0u;
    }
    consumers_sync();
    if (warp == 0) {
      const bool dirty_b = lane < it.m && ((h.mask >> lane) & 1u);
      uint32_t v = 0u;
      if (lane < it.m) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v ^= s_red[e & 1u][w][lane < S ? lane : 0];
      }
      uint32_t* cks = reinterpret_cast<uint32_t*>(it.d[kChecksums]);
      const int per = (int(it.d[kTiles]) + int(it.d[kCpt]) - 1) / int(it.d[kCpt]);
      if (per == 1) {
        if (dirty_b) cks[it.first + lane] = v;
      } else {
        const int64_t item0 = it.d[kPart] + it.s * per;   // the stripe's first item
        if (dirty_b) prm.partials[(item0 + it.chunk) * P + lane] = v;
        __threadfence();
        __syncwarp();
        int last = 0;
        if (lane == 0) last = atomicAdd(prm.counters + it.d[kCnt] + it.s, 1) == per - 1;
        last = __shfl_sync(0xffffffffu, last, 0);
        if (last) {
          __threadfence();
          if (dirty_b) {
            uint32_t y = 0u;
#pragma unroll 4
            for (int q = 0; q < per; ++q) y ^= __ldcg(prm.partials + (item0 + q) * P + lane);
            cks[it.first + lane] = y;
          }
        }
      }
    }
    ++e;
  }
}

template <int S, int K, int N>
int grid_cap() {
  static int cap[64];   // CTAs the card keeps resident, per device, found once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cap[dev] == 0) {
    auto kernel = fused_update_kernel<S, K, N>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<S, K, N>::kBytes);
    if (e != cudaSuccess) return -static_cast<int>(e);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCtaThreads,
                                                  Ring<S, K, N>::kBytes);
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

template <int S, int K, int N>
int launch(const Params& prm, cudaStream_t stream) {
  const int cap = grid_cap<S, K, N>();
  if (cap < 0) return -cap;
  const int64_t grid = prm.total_items < cap ? prm.total_items : cap;
  fused_update_kernel<S, K, N><<<int(grid), kCtaThreads, Ring<S, K, N>::kBytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// The instance for a stripe width and a tile of `cols` 16-byte columns:
// 512 columns (3 stages) for stripes of up to 4 members with blocks above
// 4 KiB, else 256 (6 stages at up to 4 members, 3 at 8, 2 at 16).
#define K3_DISPATCH(stripe, cols, CALL)                                      \
  ((stripe) <= 4 && (cols) == 512 ? &CALL<4, 2, 3>                            \
   : (stripe) <= 4 && (cols) == 256 ? &CALL<4, 1, 6>                          \
   : (stripe) <= 8 && (cols) == 256 ? &CALL<8, 1, 3>                          \
   : (cols) == 256 ? &CALL<16, 1, 2> : nullptr)

}  // namespace k3
}  // namespace vilamb

extern "C" int vilamb_fused_update_max_jobs() { return vilamb::k3::kMaxJobs; }

// CTAs of the persistent grid for this stripe width and tile (the SM count
// times the instance's occupancy, found once), or minus a CUDA error.
extern "C" int vilamb_fused_update_grid(int64_t stripe, int64_t tile_cols) {
  using namespace vilamb::k3;
  if (stripe < 1 || stripe > kMaxStripe) return -static_cast<int>(cudaErrorInvalidValue);
  int (*fn)() = K3_DISPATCH(stripe, tile_cols, grid_cap);
  return fn ? fn() : -static_cast<int>(cudaErrorInvalidValue);
}

// desc: int64[n_jobs, 11] on the host (see kDescWords), first items counted
// from 0 in this launch; total_items: the launch's items; grab: items a
// ticket hands out; ticket: an int32 zeroed for this launch; counters:
// int32[] zeroed, one a stripe of the jobs whose stripes span several
// items; partials: uint32[] (their items x stripe), both null when there
// are none; tile_cols: 16-byte columns a tile (512 or 256, see
// K3_DISPATCH).  Stripe widths 1..16.
extern "C" int vilamb_fused_update_many(const int64_t* desc, int64_t n_jobs,
                                        int64_t total_items, int64_t grab, int64_t stripe,
                                        int64_t tile_cols, void* ticket, void* counters,
                                        void* partials, void* stream) {
  using namespace vilamb::k3;
  if (stripe < 1 || stripe > kMaxStripe || n_jobs < 1 || n_jobs > kMaxJobs)
    return static_cast<int>(cudaErrorInvalidValue);
  int (*fn)(const Params&, cudaStream_t) = K3_DISPATCH(stripe, tile_cols, launch);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (total_items <= 0) return static_cast<int>(cudaGetLastError());
  Params local;   // copied into the launch's parameters
  for (int64_t i = 0; i < n_jobs * kDescWords; ++i) local.desc[i] = desc[i];
  local.total_items = total_items;
  local.grab = grab < 1 ? 1 : grab;
  local.ticket = static_cast<int32_t*>(ticket);
  local.counters = static_cast<int32_t*>(counters);
  local.partials = static_cast<uint32_t*>(partials);
  local.n_jobs = int(n_jobs);
  local.stripe = int(stripe);
  return fn(local, static_cast<cudaStream_t>(stream));
}
