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
//   s   = -1e30 where the causal mask `r >= c` fails or c >= S (not -inf);
//   m, l: the running max and sum, fp32; p = exp(s - m) rounded to v's
//         dtype before p . v, which accumulates in fp32;
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Query head h reads KV head h / (H / KV): the head order of the
// reference's `expand_kv`, without its copy.
//
// Layouts: q (B, S, H, hd), k and v (B, S, KV, hd) and out (B, S, H, hd),
// each addressed by its (batch, seq, head) strides with a unit stride on
// hd.  No transpose, no expansion and no padding of hd; S is any length >= 1
// (tails are masked).  hd is 64 or 128; bf16 or fp16.
//
// Bound: operations.  Causal prefill does 2 * B * H * S^2 * hd FLOPs (both
// products over the lower triangle) against (2*H + 2*KV) * B * S * hd * 2
// bytes: at B=8, S=4096, H=24, KV=8, hd=128 that is 0.83 ms of bf16 tensor
// work at 989 TFLOP/s against 0.16 ms of HBM traffic on an H100 SXM.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//   * one CTA of 4 warps per (64-query tile, b*H + h); each warp owns 16
//     query rows and keeps them in registers as mma A fragments;
//   * K and V tiles of 64 keys x hd are staged in shared memory with 16-byte
//     loads (rows padded by 16 bytes, so fragment reads are bank-conflict
//     free); keys past S are zero-filled;
//   * both products are `mma.sync.m16n8k16` with fp32 accumulators.  Its
//     documented fragment layout gives every thread two whole rows' worth
//     of scores (rows g and g+8 of the warp's 16), so the online-softmax
//     max and sum are a quad shuffle, the rescale of O happens in registers,
//     and the S accumulator is repacked as the A fragment of P . V without
//     a round trip through shared memory;
//   * causal tiles past the diagonal are never visited; only the diagonal
//     tile and the ragged tail tile are masked.  CTAs take query tiles from
//     the heaviest (last) down, so the long rows start first.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace vilamb_flash {

constexpr int kBlockM = 64;             // query rows per CTA
constexpr int kBlockN = 64;             // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

struct Bf16 {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // Two floats rounded to the type, `lo` in the low half (the lower column).
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

struct Fp16 {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

struct Strides {
  int64_t b, s, h;                      // in elements; hd has stride 1
};

// Two neighbouring 16-bit elements (cols c, c+1) of row `row`, or 0 past S.
__device__ __forceinline__ uint32_t load2(const uint16_t* base, int64_t row_stride,
                                          int row, int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + int64_t(row) * row_stride + col);
}

template <class Ty, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int S,
                 int H, int group, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, bool causal) {
  constexpr int kStride = HD + 8;       // shared row, padded by 16 bytes
  constexpr int kKSteps = HD / 16;      // k-steps of Q . K^T
  constexpr int kNTiles = HD / 8;       // n-tiles of P . V
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
  __shared__ __align__(16) uint16_t k_tile[kBlockN * kStride];
  __shared__ __align__(16) uint16_t v_tile[kBlockN * kStride];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = q_tile * kBlockM;
  const int r0 = q0 + warp * 16 + g;    // this thread's rows: r0 and r0 + 8

  const uint16_t* qp = q + b * qs.b + h * qs.h;
  const uint16_t* kp = k + b * ks.b + kvh * ks.h;
  const uint16_t* vp = v + b * vs.b + kvh * vs.h;

  // The warp's 16 query rows as A fragments, one set per k-step.
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load2(qp, qs.s, r0, c, S);
    qf[kk][1] = load2(qp, qs.s, r0 + 8, c, S);
    qf[kk][2] = load2(qp, qs.s, r0, c + 8, S);
    qf[kk][3] = load2(qp, qs.s, r0 + 8, c + 8, S);
  }

  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  const int kv_end = causal ? min(S, q0 + kBlockM) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kw = *reinterpret_cast<const uint4*>(kp + int64_t(k0 + r) * ks.s + c);
        vw = *reinterpret_cast<const uint4*>(vp + int64_t(k0 + r) * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r * kStride + c]) = kw;
      *reinterpret_cast<uint4*>(&v_tile[r * kStride + c]) = vw;
    }
    __syncthreads();

    // Scores of the warp's 16 rows against the tile's 64 keys.
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const uint16_t* kr = &k_tile[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        Ty::mma(sc[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    const bool masked = (causal && k0 + kBlockN > q0) || (k0 + kBlockN > S);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * scale;
        if (masked) {
          const int row = r0 + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) s = kNegInf;
        }
        sc[j][e] = s;
      }
    }

    // Online softmax, row by row (i = 0: row r0; i = 1: row r0 + 8).  The
    // four threads of a quad hold the row's 64 scores between them.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
        m_cur = fmaxf(m_cur, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
      const float m_new = fmaxf(m_run[i], m_cur);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        sc[j][2 * i] = expf(sc[j][2 * i] - m_new);
        sc[j][2 * i + 1] = expf(sc[j][2 * i + 1] - m_new);
        sum += sc[j][2 * i] + sc[j][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }

    // acc += P . V: the score accumulators of key tiles 2kk and 2kk + 1 are
    // exactly the A fragment of keys 16kk .. 16kk + 15.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Ty::pack(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = Ty::pack(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = Ty::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = Ty::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const uint16_t* vr = &v_tile[(kk * 16 + 2 * t) * kStride + g];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const uint16_t* vc = vr + n * 8;
        const uint32_t b0 = uint32_t(vc[0]) | (uint32_t(vc[kStride]) << 16);
        const uint32_t b1 = uint32_t(vc[8 * kStride]) | (uint32_t(vc[9 * kStride]) << 16);
        Ty::mma(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= S) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    uint16_t* orow = o + b * os.b + int64_t(row) * os.s + h * os.h;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          Ty::pack(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
  }
}

template <class Ty, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
            int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
            bool causal, cudaStream_t stream) {
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<Ty, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), S, H, H / KV, qs,
      ks, vs, os, scale, causal);
}

}  // namespace vilamb_flash

// q, out: (B, S, H, hd); k, v: (B, S, KV, hd); strides in elements (batch,
// seq, head), hd contiguous, every stride a multiple of 8 and every pointer
// 16-byte aligned.  dtype: 0 = bf16, 1 = fp16.  hd: 64 or 128.  Returns the
// launch's cudaGetLastError (an unsupported dtype or hd returns
// cudaErrorInvalidValue without launching).
extern "C" int vilamb_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 int64_t B, int64_t S, int64_t H, int64_t KV,
                                 int64_t hd, int64_t dtype, int64_t causal,
                                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                 double scale, void* stream) {
  using namespace vilamb_flash;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  const int b = int(B), s = int(S), h = int(H), kv = int(KV);
  if (dtype == 0 && hd == 128) {
    launch<Bf16, 128>(q, k, v, out, b, s, h, kv, qs, ks, vs, os, sc, causal != 0, st);
  } else if (dtype == 0 && hd == 64) {
    launch<Bf16, 64>(q, k, v, out, b, s, h, kv, qs, ks, vs, os, sc, causal != 0, st);
  } else if (dtype == 1 && hd == 128) {
    launch<Fp16, 128>(q, k, v, out, b, s, h, kv, qs, ks, vs, os, sc, causal != 0, st);
  } else if (dtype == 1 && hd == 64) {
    launch<Fp16, 64>(q, k, v, out, b, s, h, kv, qs, ks, vs, os, sc, causal != 0, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
