// Flash attention, forward: causal (or full) softmax attention with an
// online softmax, for the prefill of the serving path.
//
// Replaces: repro/kernels/flash_attn/flash_attn.py `flash_attention_bh`
// (the Pallas kernel, pallas_call at :92), whose grid (BH, q_blocks,
// kv_blocks) carried the running max, sum and accumulator in VMEM scratch
// across the sequential kv axis, on (BH, S, hd) inputs that the JAX wrapper
// first transposed, GQA-expanded and padded to hd = 128.
//
// Computes, per (b, h) and query row r (what the Pallas `_kernel` does):
//   s   = (q[r] . k[c]) * scale in fp32 (q and k taken to fp32; bf16 and
//         fp16 products are exact in fp32, so the tensor cores' fp32
//         accumulation gives the same scores up to summation order);
//   s   = -1e30 where c >= Sk or the causal mask `r >= c` fails (absolute
//         indices, as the Pallas kernel's iotas; not -inf);
//   m, l: the running max and sum, fp32; p = exp(s - m) rounded to v's
//         dtype before p . v, which accumulates in fp32;
//   out = acc / max(l, 1e-30), cast to q's dtype.
// The exponentials are exp2(s * c - m * c), c = scale * log2(e), one FFMA
// and one MUFU op a score (the same p up to fp32 rounding, far below p's
// rounding to bf16).  Query head h reads KV head h / (H / KV): the head
// order of the reference's `expand_kv`, without its copy.
//
// Layouts: q (B, Sq, H, hd), k and v (B, Sk, KV, hd) and out (B, Sq, H, hd),
// each addressed by its (head, seq, batch) byte strides with a unit stride
// on hd, every stride a multiple of 16 bytes and every base 16-byte aligned
// (what a TMA tensor map can describe; the wrapper copies other layouts).
// No transpose, no expansion and no padding of hd; Sq and Sk are any
// lengths >= 1 (cross attention reads an encoder memory of its own length).
// hd is 64 or 128; bf16 or fp16.
//
// Bound: operations.  Causal prefill (Sq = Sk = S) does 4 * B * H * hd *
// S(S+1)/2 FLOPs (both products over the lower triangle) against (2*H +
// 2*KV) * B * S * hd * 2 bytes: at B=8, S=4096, H=24, KV=8, hd=128 that
// is 8.25e11 FLOPs, 0.83 ms of bf16 tensor work at 989 TFLOP/s, against
// 0.54 GB, 0.16 ms of HBM traffic at 3.35 TB/s on an H100 SXM (full
// attention does 4 * B * H * hd * Sq * Sk FLOPs).  So the design keeps the tensor
// cores fed:
//   * one CTA of three warpgroups per (b * H + h, 128-query tile).
//     Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//     and one thread issues every load.  Warpgroups 1 and 2 are consumers,
//     64 query rows each, with the registers the producer gave up
//     (setmaxnreg.inc);
//   * TMA: q is loaded once; K and V tiles of 128 keys come through a ring
//     of stages in dynamic shared memory, under full/empty mbarriers.  The
//     tensor maps are 4-d (hd, heads, S, B) by stride (Sq rows for q and
//     out, Sk for k and v), so TMA reads each input in place and zero-fills
//     rows past its length without touching the next sequence.  A 128-byte swizzle (64 elements: a row of hd = 128 takes
//     two boxes) is the layout wgmma reads without bank conflicts;
//   * S = Q . K^T is `wgmma.mma_async` m64n128k16 with both operands in
//     shared memory (K-major); O += P . V is wgmma with P in registers
//     (the score accumulator repacked as A fragments: the accumulator's
//     layout gives each thread rows g and g + 8 of its warp's 16, so the
//     row max and sum are two quad shuffles) and V read transposed from
//     its hd-contiguous tile (no transpose copy);
//   * within a consumer, the scores of tile j are computed while P . V of
//     tile j - 1 runs, so its softmax overlaps its own products; and the
//     two consumers take turns to issue their products (named barriers),
//     so one's softmax also runs under the other's;
//   * the softmax is instructions, not tensor work: only a CTA's last key
//     tile (the diagonal, or the ragged tail past Sk) gets a masked copy of it (a separate
//     instantiation, so the other tiles carry no mask code), the max is
//     taken on raw scores and the scale folded into the exp2's FFMA;
//   * causal tiles past the diagonal, and tiles past Sk, are never loaded.  Blocks run (b, KV
//     head) by (b, KV head), the query tiles from the heaviest (last) down
//     and the heads of a GQA group side by side, so the CTAs in flight
//     share K/V tiles in L2 and the long rows start first;
//   * the epilogue writes O over the consumer's own rows of the q tile in
//     shared memory and stores it with TMA, which clips rows past Sq.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "vilamb_common.cuh"

namespace vilamb_flash {

constexpr int kBlockM = 128;            // query rows per CTA, 64 per consumer
constexpr int kBlockN = 128;            // keys per K/V tile
constexpr int kThreads = 384;           // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64;                // hd elements a TMA box: 128 bytes
constexpr int kBoxBytes = kBlockN * 128;  // one box of 128 rows
constexpr int kProducerRegs = 40;       // 128 x 40 + 256 x 232 = 384 x 168
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q, then the K stages, then the V stages (each tile
// 128 rows x hd, as hd / 64 boxes of 16 KiB), then the mbarriers.
template <int HD>
struct Layout {
  static constexpr int kStages = 2;     // >= 2: tile 1 starts in stage 1
  static constexpr int kTile = kBlockN * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, then k_full, v_full, k_empty, v_empty for each stage.
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kDynamic = kBytes + 1024;   // slack to align to 1 KiB
};

// ---------------------------------------------------------------- PTX
using vilamb::mbar_arrive;
using vilamb::mbar_expect_tx;
using vilamb::mbar_init;
using vilamb::mbar_wait;
using vilamb::smem_u32;

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define VF_ACC32_STR                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define VF_ACC64_STR                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define VF_ACC32_OPS(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VF_ACC64_OPS(d)                                                       \
  VF_ACC32_OPS(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),            \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),            \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),            \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The three wgmma forms the kernel issues, for one input type:
//   ss128: d (64 x 128) (+)= A (64 x 16, shared, K-major) . B (16 x 128,
//          shared, K-major); the sum starts from zero when `acc` is 0;
//   rs128, rs64: d (64 x N) += A (64 x 16, registers) . B (16 x N, shared,
//          MN-major: transposed).
#define VF_DEFINE_MMA(NAME, PTXTY)                                            \
  struct NAME {                                                               \
    static __device__ __forceinline__ void ss128(float (&d)[64], uint64_t a,  \
                                                 uint64_t b, int acc) {       \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTXTY "." PTXTY " "  \
          VF_ACC64_STR ", %64, %65, p, 1, 1, 0, 0;\n}\n"                      \
          : VF_ACC64_OPS(d) : "l"(a), "l"(b), "r"(acc));                      \
    }                                                                         \
    static __device__ __forceinline__ void rs128(float (&d)[64], uint32_t a0, \
                                                 uint32_t a1, uint32_t a2,    \
                                                 uint32_t a3, uint64_t b) {   \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTXTY "." PTXTY " "  \
          VF_ACC64_STR ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"        \
          : VF_ACC64_OPS(d)                                                   \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));              \
    }                                                                         \
    static __device__ __forceinline__ void rs64(float (&d)[32], uint32_t a0,  \
                                                uint32_t a1, uint32_t a2,     \
                                                uint32_t a3, uint64_t b) {    \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTXTY "." PTXTY " "   \
          VF_ACC32_STR ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"        \
          : VF_ACC32_OPS(d)                                                   \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));              \
    }                                                                         \
  };

VF_DEFINE_MMA(MmaBf16, "bf16")
VF_DEFINE_MMA(MmaFp16, "f16")

struct Bf16 {
  using Mma = MmaBf16;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // Two floats rounded to the type, `lo` in the low half (the lower column).
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

struct Fp16 {
  using Mma = MmaFp16;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// ---------------------------------------------------------------- math
// S = Q . K^T for one consumer: Q's 64 rows at `q` and the K tile at `k`,
// each hd / 64 boxes of 128-byte K-major rows; k-step kk reads 32 bytes
// into box kk / 4.
template <class Ty, int HD>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    Ty::Mma::ss128(s, desc(q + off, 16, 1024), desc(k + off, 16, 1024), kk > 0);
  }
}

// O += P . V: P's A fragments (4 registers a 16-key step) and the V tile at
// `v` read MN-major: 8-key row groups 1 KiB apart, hd blocks of 64 one box
// (16 KiB) apart; k-step kk starts 16 keys (2 KiB) further.
template <class Ty, int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2], const uint32_t (&p)[32], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t b = desc(v + kk * 2048, kBoxBytes, 1024);
    if constexpr (HD == 128) {
      Ty::Mma::rs128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], b);
    } else {
      Ty::Mma::rs64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], b);
    }
  }
}

// One tile's online-softmax step on the raw scores in `s` (rows g and g + 8
// of the warp's 16: element 4j + 2i + e is row g + 8i, column 8j + 2t + e):
// update the running max and sum and leave p = exp2(s * c - m * c) in `s`,
// c = scale * log2(e) >= 0 (the wrapper folds a negative scale into q).
// kMask (the last tile only: the diagonal or the ragged tail): a masked
// score is -1e30 for the max and its p is 0, the reference's exp(-1e30 - m)
// for any row that has a key, as every row here has (key 0, since Sk >= 1).  Returns the correction
// factors of the old accumulator rows in `corr`.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c, bool causal,
                                             int row0, int col0, int Sk) {
  auto masked = [&](int j, int e) {
    const int row = row0 + (e >> 1) * 8;
    const int col = col0 + 8 * j + (e & 1);
    return col >= Sk || (causal && col > row);
  };
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (masked(j, e)) s[4 * j + e] = kNegInf;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[i] = ex2((m[i] - mx) * c);
    m[i] = mx;
    const float mc = mx * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        float p = ex2(fmaf(s[4 * j + e], c, -mc));
        if constexpr (kMask) {
          if (masked(j, e)) p = 0.f;
        }
        s[4 * j + e] = p;
        sum += p;
      }
    }
    l[i] = l[i] * corr[i] + sum;      // this thread's share; quad-summed at the end
  }
}

// The score accumulator of keys 16kk .. 16kk + 15 is the A fragment of
// that k-step: rows (g, g + 8) x columns (2t, 2t + 8) of n-blocks 2kk, 2kk + 1.
template <class Ty>
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = Ty::pack(s[2 * i], s[2 * i + 1]);
}

// ---------------------------------------------------------------- kernel
template <class Ty, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, int Sq, int Sk, int H, int group,
                 float scale_log2, bool causal) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k_full = bar_q + 8, bar_v_full = bar_k_full + 8 * kStages;
  const uint32_t bar_k_empty = bar_v_full + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;

  // Block order: (b, KV head) slowest, then query tiles from the heaviest
  // (last) down, then the query heads of one GQA group: the CTAs in flight
  // share K/V tiles in L2, and the long causal rows start first.
  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  const int per_kv = n_q * group;
  const int bkv = blockIdx.x / per_kv, rem = blockIdx.x % per_kv;
  const int n_kv = H / group;
  const int b = bkv / n_kv, kvh = bkv % n_kv, h = kvh * group + rem % group;
  const int q_tile = n_q - 1 - rem / group;
  const int q0 = q_tile * kBlockM;
  // Key tiles up to the diagonal (causal) and never past Sk.  Only the
  // last one can hold masked keys: the diagonal, or the tail past Sk (a
  // causal CTA whose diagonal lies past Sk ends on the tail tile, whose
  // keys all precede its rows).
  const int n_k = (Sk + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(q_tile + 1, n_k) : n_k;
  const bool mask_last = causal || (Sk % kBlockN) != 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k_full + 8 * s, 1);
      mbar_init(bar_v_full + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, kConsumerWarps);
      mbar_init(bar_v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c)
        tma_load(base + L::kQ + c * kBoxBytes, &tq, bar_q, c * kBox, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = j * kBlockN;
        mbar_wait(bar_k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(bar_k_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(base + L::kK + stage * L::kTile + c * kBoxBytes, &tk,
                   bar_k_full + 8 * stage, c * kBox, kvh, k0, b);
        mbar_wait(bar_v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(bar_v_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(base + L::kV + stage * L::kTile + c * kBoxBytes, &tv,
                   bar_v_full + 8 * stage, c * kBox, kvh, k0, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int cw = wg - 1;                   // rows 64 cw .. 64 cw + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + cw * 64 + warp * 16 + g;   // and row0 + 8
    const uint32_t q_smem = base + L::kQ + cw * 64 * 128;

    float o[HD / 2];
    float s[64];
    uint32_t p[32];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Turns: a consumer issues its products only after the other has
    // issued its own, so one consumer's softmax runs under the other's
    // products.  Consumer 1 lets consumer 0 go first and skips its last
    // hand-over, so every arrival on a turn barrier is waited for.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + cw) : "memory");
    };
    auto hand_over = [&](bool last) {
      if (!(last && cw == 1)) asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - cw) : "memory");
    };
    if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    mbar_wait(bar_q, 0);
    // Tile 0: scores, softmax, P.
    mbar_wait(bar_k_full, 0);
    my_turn();
    wgmma_fence();
    qk<Ty, HD>(s, q_smem, base + L::kK);
    wgmma_commit();
    hand_over(false);
    wgmma_wait<0>();
    fence_regs(s);
    release(bar_k_empty);
    if (mask_last && n_tiles == 1) {
      softmax_tile<true>(s, m, l, corr, scale_log2, causal, row0, 2 * t, Sk);
    } else {
      softmax_tile<false>(s, m, l, corr, scale_log2, causal, row0, 2 * t, Sk);
    }
    pack_p<Ty>(p, s);

    int v_stage = 0;
    uint32_t v_phase = 0;
    int stage = 1;
    uint32_t phase = 0;
    for (int j = 1; j < n_tiles; ++j) {
      // Scores of tile j, then P . V of tile j - 1, both in flight.
      mbar_wait(bar_k_full + 8 * stage, phase);
      my_turn();
      fence_regs(s);
      wgmma_fence();
      qk<Ty, HD>(s, q_smem, base + L::kK + stage * L::kTile);
      wgmma_commit();
      mbar_wait(bar_v_full + 8 * v_stage, v_phase);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      pv<Ty, HD>(o, p, base + L::kV + v_stage * L::kTile);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<1>();                     // the scores are in
      fence_regs(s);
      release(bar_k_empty + 8 * stage);
      if (mask_last && j == n_tiles - 1) {
        softmax_tile<true>(s, m, l, corr, scale_log2, causal, row0, j * kBlockN + 2 * t, Sk);
      } else {
        softmax_tile<false>(s, m, l, corr, scale_log2, causal, row0, j * kBlockN + 2 * t, Sk);
      }
      wgmma_wait<0>();                     // P . V of tile j - 1 is in
      fence_regs(o);
      fence_regs(p);
      release(bar_v_empty + 8 * v_stage);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p<Ty>(p, s);
      v_stage = stage;
      v_phase = phase;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(bar_v_full + 8 * v_stage, v_phase);
    my_turn();
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv<Ty, HD>(o, p, base + L::kV + v_stage * L::kTile);
    wgmma_commit();
    hand_over(true);
    wgmma_wait<0>();
    fence_regs(o);
    release(bar_v_empty + 8 * v_stage);

    // Epilogue: O / max(l, 1e-30) in q's dtype, written over this
    // consumer's q rows (swizzled as the boxes were loaded), then one TMA
    // store per box.  The rows' last wgmma read of q has completed.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;       // row within the 64; r % 8 == g
        const uint32_t addr = q_smem + (j / 8) * kBoxBytes + r * 128 +
                              (((j % 8) ^ g) << 4) + t * 4;
        const uint32_t val = Ty::pack(o[4 * j + 2 * i] * l[i], o[4 * j + 2 * i + 1] * l[i]);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c)
        tma_store(&to, q_smem + c * kBoxBytes, c * kBox, h, q0 + cw * 64, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-d map (hd, heads, S, B) with byte strides (head, seq, batch); boxes
// of 64 x 1 x rows x 1, 128-byte swizzle, zero fill out of bounds.
CUresult make_map(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type,
                  const void* ptr, int64_t hd, int64_t heads, int64_t S, int64_t B,
                  int64_t sh, int64_t ss, int64_t sb, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh), cuuint64_t(ss), cuuint64_t(sb)};
  const cuuint32_t box[4] = {cuuint32_t(kBox), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Strides {
  int64_t h, s, b;                      // bytes
};

template <class Ty, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Sk, int64_t H, int64_t KV, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, bool causal, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  CUresult r = make_map(&tq, fn, Ty::kMapType, q, HD, H, Sq, B, qs.h, qs.s, qs.b, kBlockM);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, fn, Ty::kMapType, k, HD, KV, Sk, B, ks.h, ks.s, ks.b, kBlockN);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, fn, Ty::kMapType, v, HD, KV, Sk, B, vs.h, vs.s, vs.b, kBlockN);
  if (r == CUDA_SUCCESS)
    r = make_map(&to, fn, Ty::kMapType, o, HD, H, Sq, B, os.h, os.s, os.b, kBlockM / 2);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  auto kernel = flash_fwd_kernel<Ty, HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::kDynamic);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(unsigned(B * H * ((Sq + kBlockM - 1) / kBlockM)));
  kernel<<<grid, kThreads, Layout<HD>::kDynamic, stream>>>(
      tq, tk, tv, to, int(Sq), int(Sk), int(H), int(H / KV), scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vilamb_flash

// The dynamic shared memory a CTA of the hd instantiations takes, in bytes.
extern "C" int vilamb_flash_smem_bytes(int64_t hd) {
  using namespace vilamb_flash;
  return hd == 128 ? Layout<128>::kDynamic : hd == 64 ? Layout<64>::kDynamic : 0;
}

// q, out: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); strides in bytes (head, seq,
// batch), hd contiguous, every stride a positive multiple of 16 and every
// pointer 16-byte aligned.  dtype: 0 = bf16, 1 = fp16.  hd: 64 or 128.
// Returns 0, the launch's cudaError (an unsupported dtype or hd returns
// cudaErrorInvalidValue without launching), or minus the CUresult of a
// tensor map that cuTensorMapEncodeTiled refused.
extern "C" int vilamb_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                                 int64_t hd, int64_t dtype, int64_t causal,
                                 int64_t q_sh, int64_t q_ss, int64_t q_sb,
                                 int64_t k_sh, int64_t k_ss, int64_t k_sb,
                                 int64_t v_sh, int64_t v_ss, int64_t v_sb,
                                 int64_t o_sh, int64_t o_ss, int64_t o_sb,
                                 double scale, void* stream) {
  using namespace vilamb_flash;
  const Strides qs{q_sh, q_ss, q_sb}, ks{k_sh, k_ss, k_sb}, vs{v_sh, v_ss, v_sb},
      os{o_sh, o_ss, o_sb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  const bool c = causal != 0;
  if (dtype == 0 && hd == 128) return launch<Bf16, 128>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, sc, c, st);
  if (dtype == 0 && hd == 64) return launch<Bf16, 64>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, sc, c, st);
  if (dtype == 1 && hd == 128) return launch<Fp16, 128>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, sc, c, st);
  if (dtype == 1 && hd == 64) return launch<Fp16, 64>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, sc, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
