// K4's flag variants: int8 ("sage") attention with int8_mxu=False, with
// pv_int8=False, or with both, on mma.sync.
//
// Replaces: lightdiffusion_next_tpu/ops/sage_attention.py sage_attention
//   (pallas_call at :226, kernel body _kernel at :53) with
//   - int8_mxu=False (:154; the kernel's bf16 branches :69-80 and :98-104):
//     the int8 codes of Q.K^T and of P.V cast to bf16 and multiplied at the
//     bf16 rate into f32 accumulators;
//   - pv_int8=False (:154; the wrapper's branch :181-191, the kernel's
//     :111-119), the quality variant: Q.K^T on the int8 codes as in K4, P
//     rounded to bf16 and multiplied by the centred V rounded to bf16 (no V
//     codes, no sv), f32 accumulators;
//   - both: Q.K^T's codes at the bf16 rate and the bf16 P.V.
//   (int8_mxu=True, pv_int8=True is K4, sage_attention.cu.)
//
// The function is K4's (sage_attention.cu's header), on the images its
// preparation writes (the pv_int8=False kv images hold bf16 V), in the same
// rounded f32 operations and the base-2 domain (log2e in sq, ex2.approx), per
// softmax block of kv tokens: pass 0 the block's row maxima, pass 1
//   p = ex2(s - m'), l = l * alpha + sum p, and
//   pv_int8:  acc = acc * alpha + f32(round(p * 127) . v8) * (sv / 127)
//   else:     acc = acc * alpha + (bf16(p) . bf16(v - vmu)) in f32
//   out = acc / l + vmu, rounded to bf16 once.
// int8 codes are exact in bf16, their products exact in f32, and every sum of
// Q.K^T (127^2 * 160) and of P.V over a block (127^2 * 1024) is an integer
// below 2^24, so the bf16-rate products give K4's integers exactly; with the
// same per-thread order of the sums of p as K4, int8_mxu=False should give
// K4's output bit for bit (chip_smoke.py logs whether it does).
//
// What bounds it on an H100: one exp per score at the special-function rate
// (3.86e12/s) against 2 d operations per score for each product, at the bf16
// rate (989 TFLOP/s) for every bf16 product and the int8 rate (1979 TOP/s)
// for pv_int8=False's Q.K^T: the exps at d <= 80, the products at d = 128
// and 160 (sage_bound in chip_smoke.py).
//
// The design: a plain tiled kernel, right first (K4's producer warpgroup and
// wgmma are not taken). A block of four warps holds one q image (64 rows);
// each warp runs the online softmax of its 16 rows on m16n8 mma.sync tiles
// (mma_sync.cuh) over every kv tile, twice per softmax block as K4 does. The
// block stages each kv tile into shared memory with 16-byte loads: K's codes
// as they lie (int8 Q.K^T reads them through the 32-byte swizzle) or
// converted to bf16 rows; sk; and in pass 1 V as bf16 rows of tokens, in the
// image's order within each group of 32 (sage_attention.cu's kPermNote),
// where one 8-byte load is a P.V B fragment of a k16 step: stored positions
// 4t..4t+3 of 16 hold tokens 2t, 2t+1, 8+2t, 9+2t, the fragment's order, and
// the A fragment is the s fragment of two n8 tiles, as K4's P is. Q's codes
// stay in registers (converted to bf16 once when int8_mxu=False); acc lives
// in shared memory, one column per thread (the registers hold s and P.V's
// sums). Rows are padded so each warp's fragment loads hit 32 banks.
//
// Left for later: the tiles' copies under the products (cp.async, a ring),
// wgmma, K4's turns of two consumer warpgroups.
#include <math_constants.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace hopper;
using namespace mmasync;

constexpr int kQRows = 64;        // rows of a q image; one block
constexpr int kThreads = 128;     // four warps of 16 rows
constexpr int kErrUnsupported = 1000;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

// The images' geometry (sage_attention.cu's Cfg; ops/sage_attention.geometry)
// and this kernel's shared memory: K (the int8 image's bytes, or bf16 rows of
// KW words), sk, V (bf16 rows of VW words), acc ([D / 2][kThreads] f32).
template <int D, bool QK8, bool PV8>
struct Lay {
  static constexpr int DP = (D + 31) / 32 * 32;
  static constexpr int DV = D == 40 ? 48 : D;
  static constexpr int BN = D <= 80 ? 128 : 64;
  static constexpr int KBytes = BN * DP;
  static constexpr int Pass0Bytes = KBytes + BN * 4;
  static constexpr int Img = Pass0Bytes + (PV8 ? DV * BN : 2 * D * BN);
  static constexpr int QImg = kQRows * DP + kQRows * 4;
  // 32-bit words per row, 8 (mod 32): a half-warp's 8-byte loads of rows
  // g = 0..3 at words 2t hit 32 distinct banks
  static constexpr int KW = DP / 2 + ((8 - DP / 2) % 32 + 32) % 32;
  static constexpr int VW = BN / 2 + 8;
  static constexpr int KSmem = QK8 ? KBytes : BN * KW * 4;
  static constexpr int kSk = KSmem;
  static constexpr int kV = kSk + BN * 4;
  static constexpr int kAcc = kV + D * VW * 4;
  static constexpr int kSmem = kAcc + D / 2 * kThreads * 4;
};

struct Params {
  const unsigned char* qimg;
  const unsigned char* kvimg;
  const float* svs;
  const float* vmu;
  __nv_bfloat16* out;
  long long so_b, so_h, so_l;
  int heads, lq, lk, qt, kt;
  int kv_tiles;  // tiles attended (kt unless a check plants a fault)
  int sb;        // the softmax block in tiles
  int use_sk;    // 0 plants a fault: sk not applied
};

// Byte offset of byte `col` of row `row` in an operand of `rows` rows laid
// out as 32-byte-swizzled k32 blocks (sage_attention.cu's sw32)
__device__ __forceinline__ int sw32(int row, int col, int rows) {
  return (col >> 5) * (rows * 32) + row * 32 + ((((col >> 4) & 1) ^ ((row >> 2) & 1)) << 4) +
         (col & 15);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Kv tile `tile` into shared memory: K and sk, and with `with_v` V
template <int D, bool QK8, bool PV8>
__device__ __forceinline__ void stage_tile(unsigned char* smem, const unsigned char* img,
                                           bool with_v) {
  using L = Lay<D, QK8, PV8>;
  __syncthreads();  // every warp is done with the previous tile
  if constexpr (QK8) {
    for (int i = threadIdx.x; i < L::KBytes / 16; i += kThreads) {
      reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(img) + i);
    }
  } else {
    // chunk i: k32 block c, row r, half h of the swizzled image
    for (int i = threadIdx.x; i < L::KBytes / 16; i += kThreads) {
      const int c = i / (2 * L::BN), r = (i >> 1) % L::BN, h = i & 1;
      uint32_t o[8];
      s8x16_to_bf16(__ldg(reinterpret_cast<const uint4*>(img) + i), o);
      const int col = 32 * c + 16 * (h ^ ((r >> 2) & 1));
      uint4* dst = reinterpret_cast<uint4*>(smem + r * L::KW * 4 + col * 2);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
  for (int i = threadIdx.x; i < L::BN; i += kThreads) {
    reinterpret_cast<float*>(smem + L::kSk)[i] =
        __ldg(reinterpret_cast<const float*>(img + L::KBytes) + i);
  }
  if (with_v) {
    const unsigned char* vimg = img + L::Pass0Bytes;
    unsigned char* vs = smem + L::kV;
    if constexpr (PV8) {
      // chunk i: token group grp, channel c, half h of the swizzled codes
      for (int i = threadIdx.x; i < L::BN / 32 * L::DV * 2; i += kThreads) {
        const int grp = i / (2 * L::DV), c = (i >> 1) % L::DV, h = i & 1;
        if (c >= D) continue;
        uint32_t o[8];
        s8x16_to_bf16(__ldg(reinterpret_cast<const uint4*>(vimg) + i), o);
        const int pos = 32 * grp + 16 * (h ^ ((c >> 2) & 1));
        uint4* dst = reinterpret_cast<uint4*>(vs + c * L::VW * 4 + pos * 2);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    } else {
      // chunk i: channel c, tokens 8 j .. 8 j + 7
      for (int i = threadIdx.x; i < D * L::BN / 8; i += kThreads) {
        const int c = i / (L::BN / 8), j = i % (L::BN / 8);
        *reinterpret_cast<uint4*>(vs + c * L::VW * 4 + j * 16) =
            __ldg(reinterpret_cast<const uint4*>(vimg) + i);
      }
    }
  }
  __syncthreads();
}

// The scores of the staged tile for the warp's 16 rows: s[4 j + e] as an
// m16n8 accumulator of n8 tile j, (f32(q8 . k8) * sq) * sk in the base-2
// domain, -1e30 past lk
template <int D, bool QK8, bool PV8>
__device__ __forceinline__ void scores(float (&s)[Lay<D, QK8, PV8>::BN / 2],
                                       const uint32_t (&qf)[QK8 ? Lay<D, QK8, PV8>::DP / 8
                                                                : Lay<D, QK8, PV8>::DP / 4],
                                       const unsigned char* smem, float sq0, float sq1, int k0,
                                       const Params& p) {
  using L = Lay<D, QK8, PV8>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < L::BN / 8; ++j) {
    const int n = 8 * j + g;
    if constexpr (QK8) {
      int d[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < L::DP / 32; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(smem + sw32(n, 32 * c + 4 * t, L::BN));
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(smem + sw32(n, 32 * c + 16 + 4 * t, L::BN));
        const uint32_t a[4] = {qf[4 * c], qf[4 * c + 1], qf[4 * c + 2], qf[4 * c + 3]};
        mma_s8(d, a, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = __int2float_rn(d[e]);
    } else {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < L::DP / 16; ++ks) {
        const uint2 b = *reinterpret_cast<const uint2*>(smem + n * L::KW * 4 + (16 * ks + 4 * t) * 2);
        const uint32_t a[4] = {qf[4 * ks], qf[4 * ks + 1], qf[4 * ks + 2], qf[4 * ks + 3]};
        mma_bf16(d, a, b.x, b.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = d[e];
    }
  }
  const float* sk = reinterpret_cast<const float*>(smem + L::kSk);
  const bool tail = k0 + L::BN > p.lk;
#pragma unroll
  for (int j = 0; j < L::BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const float x =
          __fmul_rn(__fmul_rn(s[4 * j + e], e < 2 ? sq0 : sq1), p.use_sk ? sk[col] : 1.f);
      s[4 * j + e] = tail && k0 + col >= p.lk ? kNegInf : x;
    }
  }
}

template <int D, bool QK8, bool PV8>
__global__ void __launch_bounds__(kThreads) sage_variant_kernel(const Params p) {
  using L = Lay<D, QK8, PV8>;
  constexpr int NQ = QK8 ? L::DP / 8 : L::DP / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // the thread's rows r0 and r0 + 8 of the q image

  // Q's codes: the A fragments of the k32 steps, or of the k16 steps in bf16
  const unsigned char* qimg = p.qimg + (static_cast<long long>(bh) * p.qt + blockIdx.x) * L::QImg;
  uint32_t qf[NQ];
#pragma unroll
  for (int c = 0; c < L::DP / 32; ++c) {
    uint32_t x[4];
    x[0] = __ldg(reinterpret_cast<const uint32_t*>(qimg + sw32(r0, 32 * c + 4 * t, kQRows)));
    x[1] = __ldg(reinterpret_cast<const uint32_t*>(qimg + sw32(r0 + 8, 32 * c + 4 * t, kQRows)));
    x[2] = __ldg(reinterpret_cast<const uint32_t*>(qimg + sw32(r0, 32 * c + 16 + 4 * t, kQRows)));
    x[3] = __ldg(
        reinterpret_cast<const uint32_t*>(qimg + sw32(r0 + 8, 32 * c + 16 + 4 * t, kQRows)));
    if constexpr (QK8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[4 * c + i] = x[i];
    } else {
      // k16 step 2c + h: row r0's bytes 4t..4t+3 give a[0] (2t, 2t+1) and
      // a[2] (2t+8, 2t+9), row r0 + 8's a[1] and a[3]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* a = qf + 4 * (2 * c + h);
        s8x4_to_bf16(x[2 * h], a[0], a[2]);
        s8x4_to_bf16(x[2 * h + 1], a[1], a[3]);
      }
    }
  }
  const float* sqs = reinterpret_cast<const float*>(qimg + kQRows * L::DP);
  const float sq0 = __fmul_rn(__ldg(sqs + r0), kLog2e);
  const float sq1 = __fmul_rn(__ldg(sqs + r0 + 8), kLog2e);

  float* acc = reinterpret_cast<float*>(smem + L::kAcc) + threadIdx.x;  // acc[i * kThreads]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i * kThreads] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float s[L::BN / 2];
  float pv[D / 8][4];
  const unsigned char* kv = p.kvimg + static_cast<long long>(bh) * p.kt * L::Img;
  const int n_blocks = (p.kv_tiles + p.sb - 1) / p.sb;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * p.sb;
    const int nt = min(p.sb, p.kv_tiles - t0);

    // pass 0: the block's row maxima
    float mb[2] = {kNegInf, kNegInf};
    for (int i = 0; i < nt; ++i) {
      stage_tile<D, QK8, PV8>(smem, kv + static_cast<long long>(t0 + i) * L::Img, false);
      scores<D, QK8, PV8>(s, qf, smem, sq0, sq1, (t0 + i) * L::BN, p);
#pragma unroll
      for (int j = 0; j < L::BN / 8; ++j) {
        mb[0] = fmaxf(mb[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mb[1] = fmaxf(mb[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      const float mn = fmaxf(m_r[r], mb[r]);
      alpha[r] = fast_exp2(__fsub_rn(m_r[r], mn));
      m_r[r] = mn;
    }

    // pass 1: p, its row sums, P.V
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
    for (int i = 0; i < nt; ++i) {
      stage_tile<D, QK8, PV8>(smem, kv + static_cast<long long>(t0 + i) * L::Img, true);
      scores<D, QK8, PV8>(s, qf, smem, sq0, sq1, (t0 + i) * L::BN, p);
#pragma unroll
      for (int k = 0; k < L::BN / 2; ++k) {
        const int r = (k >> 1) & 1;
        const float pr = fast_exp2(__fsub_rn(s[k], m_r[r]));
        lsum[r] = __fadd_rn(lsum[r], pr);
        // P.V's operand: the code round(p * 127) (exact in bf16), or bf16(p)
        s[k] = PV8 ? __fsub_rn(__fadd_rn(__fmul_rn(pr, 127.f), kMagic), kMagic) : pr;
      }
      const unsigned char* vs = smem + L::kV;
#pragma unroll
      for (int kk = 0; kk < L::BN / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                               pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                               pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                               pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const uint2 b = *reinterpret_cast<const uint2*>(vs + (8 * j + g) * L::VW * 4 +
                                                          (16 * kk + 4 * t) * 2);
          mma_bf16(pv[j], a, b.x, b.y);
        }
      }
    }
    // acc and l take alpha and the block's sums
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float& a = acc[(4 * j + e) * kThreads];
        const float add = PV8 ? __fmul_rn(pv[j][e], __ldg(p.svs + bh * D + c)) : pv[j][e];
        a = __fadd_rn(__fmul_rn(a, alpha[e >> 1]), add);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), lsum[r]);
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_r[r];
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int row = blockIdx.x * kQRows + r0;
  __nv_bfloat16* go = p.out + b * p.so_b + h * p.so_h + 2 * t;
  const float* vmu = p.vmu + bh * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float mu0 = __ldg(vmu + 8 * j), mu1 = __ldg(vmu + 8 * j + 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= p.lq) continue;
      const float o0 = __fadd_rn(__fdiv_rn(acc[(4 * j + 2 * half) * kThreads], l[half]), mu0);
      const float o1 =
          __fadd_rn(__fdiv_rn(acc[(4 * j + 2 * half + 1) * kThreads], l[half]), mu1);
      *reinterpret_cast<uint32_t*>(go + r * p.so_l + 8 * j) = pack_bf16(o0, o1);
    }
  }
}

template <int D, bool QK8, bool PV8>
int attend(const Params& p, int batch, cudaStream_t stream) {
  using L = Lay<D, QK8, PV8>;
  auto kernel = sage_variant_kernel<D, QK8, PV8>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.lq + kQRows - 1) / kQRows, batch * p.heads);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const Params& p, int batch, int qk_int8, int pv_int8, cudaStream_t s) {
  const int bn = D <= 80 ? 128 : 64;
  if (p.qt != (p.lq + 2 * kQRows - 1) / (2 * kQRows) * 2 || p.kt != (p.lk + bn - 1) / bn) {
    return kErrUnsupported;
  }
  if (qk_int8 && !pv_int8) return attend<D, true, false>(p, batch, s);
  if (!qk_int8 && pv_int8) return attend<D, false, true>(p, batch, s);
  if (!qk_int8 && !pv_int8) return attend<D, false, false>(p, batch, s);
  return kErrUnsupported;  // int8_mxu and pv_int8 both on: K4
}

}  // namespace

// K4's flag variants on the images of ldt_sage_prepare_fwd (with its pv_int8
// as here); out (B, H, Lq, d) bf16 through its (b, h, l) strides (even, the
// d elements of a row contiguous). qk_int8 1: Q.K^T on int8 mma.sync
// (int8_mxu=True), 0: at the bf16 rate; pv_int8 1: P.V on the codes at the
// bf16 rate, 0: bf16 P times bf16 V. The pair (1, 1) is K4's and refused.
// kv_tiles, sb and use_sk as for ldt_sage_attention_fwd.
extern "C" int ldt_sage_variant_fwd(const void* qimg, const void* kvimg, const void* svs,
                                    const void* vmu, void* out, int batch, int heads, int lq,
                                    int lk, int d, long long so_b, long long so_h,
                                    long long so_l, int qt, int kt, int kv_tiles, int sb,
                                    int use_sk, int qk_int8, int pv_int8, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch * heads > 65535 || sb < 1 ||
      kv_tiles < 1 || kv_tiles > kt || so_b % 2 || so_h % 2 || so_l % 2) {
    return kErrUnsupported;
  }
  const Params p{static_cast<const unsigned char*>(qimg),
                 static_cast<const unsigned char*>(kvimg), static_cast<const float*>(svs),
                 static_cast<const float*>(vmu), static_cast<__nv_bfloat16*>(out),
                 so_b, so_h, so_l, heads, lq, lk, qt, kt, kv_tiles, sb, use_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return dispatch<32>(p, batch, qk_int8, pv_int8, s);
    case 40: return dispatch<40>(p, batch, qk_int8, pv_int8, s);
    case 64: return dispatch<64>(p, batch, qk_int8, pv_int8, s);
    case 80: return dispatch<80>(p, batch, qk_int8, pv_int8, s);
    case 128: return dispatch<128>(p, batch, qk_int8, pv_int8, s);
    case 160: return dispatch<160>(p, batch, qk_int8, pv_int8, s);
  }
  return kErrUnsupported;
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
