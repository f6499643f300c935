// K4: int8 ("sage") attention on integer wgmma, its flag variants on the
// same pipeline, and their preparation.
//
// Replaces: lightdiffusion_next_tpu/ops/sage_attention.py sage_attention
//   (pallas_call at :226, kernel body _kernel at :53) in every flag pair
//   (:154): the defaults int8_mxu=True, pv_int8=True (K4, the configuration
//   the dispatch calls), and the variants the op-level callers may ask for:
//   - int8_mxu=False (the kernel's bf16 branches :69-80 and :98-104): the
//     int8 codes of Q.K^T and of P.V multiplied at the bf16 rate into f32
//     accumulators;
//   - pv_int8=False (the wrapper's branch :181-191, the kernel's :111-119),
//     the quality variant: Q.K^T on the int8 codes as in K4, P rounded to
//     bf16 times the centred V rounded to bf16 (no V codes, no sv), f32
//     accumulators;
//   - both: Q.K^T's codes at the bf16 rate and the bf16 P.V.
//   And the preparation that function runs before its pallas_call as one XLA
//   pass (:169-222), for every flag pair: with pv_int8=False (:187-191) it
//   writes V centred and rounded to bf16 in place of its codes, and svs = 1.
//
// The function, per (batch, head), as the JAX wrapper and kernel compute it:
// K and V centred over tokens (their means kmu, vmu per channel), Q and the
// centred K quantized per token (scales sq with 1/sqrt(d) folded in, and
// sk: s = max(absmax, 1e-12) / 127, codes round(x / s) clamped to +-127),
// the centred V per channel (sv); then per softmax block of kv tokens, in
// rounded f32 operations:
//   s   = (f32(q8 . k8) * sq_i) * sk_j, -1e30 at columns j >= kv_len
//   m'  = max(m, max_j s), p = exp(s - m'), alpha = exp(m - m')
//   l   = l * alpha + sum_j p
//   acc = acc * alpha + f32(round_half_even(p * 127) . v8) * (sv / 127)
//         (pv_int8=False: acc * alpha + (bf16(p) . bf16(v - vmu)) in f32)
//   out = acc / l + vmu, rounded to bf16 once.
// P is quantized against the block's final maximum, so the block width is
// part of the result: the JAX kernel's (ops/sage_attention.softmax_block,
// 1024 tokens at SD1.5's lengths). The kernel works in the base-2 domain
// (log2e folded into sq, p = ex2.approx(s - m')), so its scores differ from
// the plain version's in the last bits and a p at a rounding edge of
// round(p * 127) may take the neighbouring code.
//
// int8 codes are exact in bf16, their products exact in f32, and every sum
// of Q.K^T (127^2 * 160) and of P.V over a block (127^2 * 1024) is an
// integer below 2^24: the bf16-rate products give K4's integers exactly.
// With K4's order of every f32 operation (the scores, the row sums of p, acc
// and l), int8_mxu=False equals K4's output bit for bit, and (int8_mxu,
// pv_int8) = (False, False) equals (True, False) (chip_smoke.py fails the
// run otherwise).
//
// Preparation (two launches, ldt_sage_prepare_fwd). sage_stats_kernel sums
// k and v and takes v's max and min per channel over a slice of the tokens;
// sage_quantize_kernel reduces the slices (kmu, vmu, and max|v - vmu| =
// max(vmax - vmu, vmu - vmin), exact since rounding is monotonic) and
// writes every q, k and v code and scale straight into the tile images the
// attention kernel copies, reading q, k and v through their (b, h, l)
// strides (the head views of the fused projection, no copy). The images
// (byte layouts shared with ops/sage_attention.py's plain layout functions):
//   q image, 64 rows: Q's row operand [KS][64 rows][32 bytes], then sq[64]
//     f32; rows past Lq zero codes and sq 0; ceil(Lq / 128) * 2 images.
//   kv image, BN tokens: K's row operand [KS][BN][32 bytes], sk[BN] f32 (1
//     past Lk), then V; tokens past Lk and channels past d zero.
//     ceil(Lk / BN) images.
//   The row operand of Q and K is a row's codes in 32-byte slices: with
//   int8_mxu, KS = DP / 32 k32 slices of 32 int8 codes (DP = d padded to
//   32); else KS = KP / 16 k16 slices of 16 codes widened to bf16 (KP = d
//   padded to 16), which wgmma reads through the same descriptors.
//   V, for K4 (both flags on): codes transposed, [BN / 32][DV channels][32
//     bytes], the 32 tokens of each group stored in the order of kPermNote
//     below (DV = d with 40 padded to 48: 8-bit wgmma has no N = 40).
//   V, for every variant: bf16 transposed, [BN / 16][d channels][32 bytes],
//     the 16 tokens of each k16 slice in their natural order: the codes
//     widened (int8_mxu=False, pv_int8=True) or the centred values
//     (pv_int8=False).
// Every 32-byte row lies 32-byte-swizzled (hopper.cuh): chunk j of row r at
// j ^ ((r >> 2) & 1). BN = 128 kv tokens for d <= 80, else 64 (registers).
// svs = sv / 127 (1 with pv_int8=False) and vmu go to (B*H, d) f32 arrays.
//
// What bounds it on an H100: one exp per score against 4 d int8 operations
// (160 at d = 40 against the tensor cores' 1979 TOP/s) makes the special
// functions' rate (3.86e12/s) the nominal bound. The work it does is more:
// the int8 products of Q.K^T twice (both passes, d = 40 padded to 64) and
// P.V (padded to 48), and about 15 issue slots of scalar work per score
// (pass 0: int -> float, two multiplies, a max; pass 1: the same scores,
// a subtract, ex2, a sum, a multiply and an add to round, a byte pack).
// ablate_sage.py times the parts (PERF.md): at (2, 8, 16384, 40) the
// products, copies and barriers alone take about a quarter of the call and
// the two passes' scalar work the rest, and they hardly overlap, since a
// warpgroup waits for its own s before its softmax. The variants run their
// bf16 products at half the int8 rate: at d = 128 and 160 those products,
// not the exps, are the bound (chip_smoke.variant_bound).
//
// What the design does about it: K3's shape (csrc/fused_qkv_attention.cu).
// - Products on wgmma: s = q k^T as m64n{BN}k32 s8 (int8_mxu) or
//   m64n{BN}k16 bf16 with both tiles in shared memory; o += p v as
//   m64n{DV}k32 s8 (K4) or m64n{d}k16 bf16 with P from registers (the
//   accumulator fragment of s packed to bytes, or to bf16 pairs, is the
//   register-A fragment) and the V image as B.
// - A producer warpgroup: one thread bulk-copies the q images once and
//   every kv image (the TMA without a tensor map) through a ring of three
//   stages (full and empty mbarriers); the first pass over a softmax block
//   copies only K and sk. Two consumer warpgroups of 64 q rows take turns
//   at the tensor cores (named barriers); setmaxnreg gives the producer's
//   registers to them.
// - Two passes over each softmax block: pass 0 only s and the row maxima;
//   pass 1 s again, p, l and the codes, with o += p v of tile t - 1 in
//   flight while tile t's softmax runs. P.V accumulates in s32 (or exact
//   f32) over the whole block (127 * 127 * 1024 < 2^24), converted and
//   scaled once at the block's end, where acc and l also take alpha. acc
//   waits for it in shared memory (each thread's own column of f32), so the
//   registers hold s, p, the P.V sums and the tile's sk (in registers, acc
//   made d = 80 and 160 spill).
// - The scalar work per score: int -> float by adding 1.5 * 2^23 to the bits
//   and subtracting it (|s| <= 127^2 * 160 < 2^22), ex2.approx, round(p *
//   127) by the same magic add, bytes picked with PRMT; the mask only on the
//   last partial tile.
// - The variants are instantiations of the same kernel, <D, QK8, PV8> (K4 is
//   <D, true, true>): only the products and the operand layouts differ. The
//   preparation widens the codes to bf16 (exact) instead of the kernel: the
//   producer's bulk copies stay the only way into shared memory, and no
//   warp converts a tile under the products. Shared memory: the bf16 rows of
//   Q and K double the q images and K's part of a stage, and V is bf16 in
//   every variant; at d = 160 with int8_mxu=False three stages (250 KB with
//   acc's 80 KB) exceed a block's 227 KB, so that instantiation takes a
//   ring of two (Cfg::Stages), every other one three.
// Tried on the card and dropped (PERF.md): s issued as two halves, pass 0
// two tiles a turn, two FP operations fewer per score in pass 1 (no change
// measured), and a flat sequence with the next tile's s in flight across
// the loop (ptxas serialised the wgmmas, C7514: 40% slower).
//
// kPermNote: a thread of an m64nN accumulator holds columns 2t, 2t+1 of
// each 8-column group (t = lane % 4); the A fragment of an s8 k32 step wants
// k = 4t..4t+3 (and 16 + 4t..). Packing groups 0 and 1 of a 32-token group
// gives k = 4t + i the token (2t, 2t+1, 8+2t, 9+2t)[i] (and 16 + the same for
// groups 2 and 3), which is the order K4's V tokens are stored in. The bf16
// k16 A fragment wants k = 2t, 2t+1, 2t+8, 2t+9: exactly the columns groups
// 2kk and 2kk+1 give thread t, so the variants' bf16 V keeps its tokens in
// their natural order.
#include <math_constants.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQRows = 64;          // rows of a q image: one consumer warpgroup
constexpr int kPrepThreads = 256;   // sage_quantize_kernel
constexpr int kStatThreads = 256;   // sage_stats_kernel
constexpr int kMaxStatSplits = 16;  // token slices of the statistics: one per 1024, at most 16
constexpr int kErrUnsupported = 1000;
constexpr int kMaxSmem = 232448;    // shared memory one block can use on an H100
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMagic = 12582912.0f;       // 1.5 * 2^23
constexpr uint32_t kMagicBits = 0x4B400000u;

constexpr int kConsumers = 256;    // two consumer warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBM = 2 * kQRows;     // q rows per block

// The images and the shared memory of the attention kernel <D, QK8, PV8>:
// the block's two q images, the kv stages, acc ([DV / 2][kConsumers] f32),
// then the full, empty and q mbarriers. QK8: Q.K^T on int8 codes; PV8: P.V
// on codes (round(p * 127) and V's codes), else bf16 P and V; PV_S8 (both):
// P.V on int8 wgmma, K4.
template <int D, bool QK8 = true, bool PV8 = true>
struct Cfg {
  static constexpr bool PV_S8 = QK8 && PV8;
  static constexpr int DP = (D + 31) / 32 * 32;  // int8 codes per q or k row
  static constexpr int KP = (D + 15) / 16 * 16;  // bf16 codes per q or k row
  static constexpr int RowBytes = QK8 ? DP : 2 * KP;
  static constexpr int KS = RowBytes / 32;       // Q.K^T's k steps: 32-byte slices
  static constexpr int DV = PV_S8 ? (D == 40 ? 48 : D) : D;  // P.V's N
  static constexpr int PK = PV_S8 ? 32 : 16;     // P.V's k step in tokens
  static constexpr int BN = D <= 80 ? 128 : 64;  // kv tokens per tile (registers)
  static constexpr int KBytes = BN * RowBytes;
  static constexpr int SkBytes = BN * 4;
  static constexpr int Pass0Bytes = KBytes + SkBytes;
  static constexpr int Img = Pass0Bytes + (PV_S8 ? DV * BN : 2 * D * BN);  // kv image
  static constexpr int QImg = kQRows * RowBytes + kQRows * 4;
  static constexpr int Stage = (Img + 1023) / 1024 * 1024;
  static constexpr int QBytes = (2 * QImg + 1023) / 1024 * 1024;
  static constexpr int AccBytes = DV / 2 * kConsumers * 4;
  // the q images, acc, the q mbarrier and the alignment, then per stage its
  // image and two mbarriers
  static constexpr int Fixed = QBytes + AccBytes + 8 + kAtom;
  static constexpr int Stages = Fixed + 3 * (Stage + 16) <= kMaxSmem ? 3 : 2;  // the kv ring
  static constexpr int kAcc = QBytes + Stages * Stage;
  static constexpr int kBar = kAcc + AccBytes;
  static constexpr int kSmem = Fixed + Stages * (Stage + 16);
  static_assert(kSmem <= kMaxSmem, "the attention kernel's shared memory");
  // sage_quantize_kernel: the image, kmu, vmu and sv, the staged k and v rows
  static constexpr int PrepImg = Img > QImg ? Img : QImg;
  static constexpr int PrepSmem = PrepImg + 3 * D * 4 + 2 * BN * D * 2;
};

// Byte offset of byte `col` of row `row` in an operand of `rows` rows laid
// out as 32-byte-swizzled 32-byte slices
__device__ __forceinline__ int sw32(int row, int col, int rows) {
  return (col >> 5) * (rows * 32) + row * 32 + ((((col >> 4) & 1) ^ ((row >> 2) & 1)) << 4) +
         (col & 15);
}

// Stored position of token r (0..31) of a 32-token group of K4's V (kPermNote)
__device__ __forceinline__ int v_position(int r) {
  const int x = r & 15;
  return (r & 16) + 4 * ((x & 7) >> 1) + (x & 1) + ((x >> 3) << 1);
}

struct PrepParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long qs_b, qs_h, qs_l, ks_b, ks_h, ks_l, vs_b, vs_h, vs_l;  // in elements
  unsigned char* qimg;
  unsigned char* kvimg;
  float* svs;
  float* vmu;
  float* part;   // (B*H, splits, 4, D): sum k, sum v, max v, min v
  int heads, lq, lk, splits, qt, kt;
  float inv_sqrt_d;
};

// Column statistics of one slice of the tokens: thread (pair c, lane) walks
// every kStatThreads / (D / 2)-th token of the slice over channels 2c, 2c + 1
// (4-byte loads, neighbouring threads on neighbouring channels, eight tokens
// in flight), then the lanes are reduced in order through shared memory.
template <int D>
__global__ void __launch_bounds__(kStatThreads) sage_stats_kernel(const PrepParams p) {
  constexpr int kPairs = D / 2;
  constexpr int kLanes = kStatThreads / kPairs;
  __shared__ float red[4][kLanes][D];
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int pair = threadIdx.x % kPairs, lane = threadIdx.x / kPairs;
  const int chunk = (p.lk + p.splits - 1) / p.splits;
  const int t0 = blockIdx.x * chunk;
  const int t1 = min(p.lk, t0 + chunk);
  if (lane < kLanes) {
    float sk[2] = {0.f, 0.f}, sv[2] = {0.f, 0.f};
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, mn[2] = {CUDART_INF_F, CUDART_INF_F};
    const __nv_bfloat16* kp = p.k + b * p.ks_b + h * p.ks_h + 2 * pair;
    const __nv_bfloat16* vp = p.v + b * p.vs_b + h * p.vs_h + 2 * pair;
    // kUnroll tokens' loads in flight per thread, then their sums in order
    constexpr int kUnroll = 8;
    for (int t = t0 + lane; t < t1; t += kLanes * kUnroll) {
      __nv_bfloat162 kw[kUnroll], vw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long tt = t + u * kLanes;
        if (tt < t1) {
          kw[u] = *reinterpret_cast<const __nv_bfloat162*>(kp + tt * p.ks_l);
          vw[u] = *reinterpret_cast<const __nv_bfloat162*>(vp + tt * p.vs_l);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t + u * kLanes >= t1) break;
        const float2 kk = __bfloat1622float2(kw[u]);
        const float2 vv = __bfloat1622float2(vw[u]);
        sk[0] += kk.x;
        sk[1] += kk.y;
        sv[0] += vv.x;
        sv[1] += vv.y;
        mx[0] = fmaxf(mx[0], vv.x);
        mx[1] = fmaxf(mx[1], vv.y);
        mn[0] = fminf(mn[0], vv.x);
        mn[1] = fminf(mn[1], vv.y);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[0][lane][2 * pair + e] = sk[e];
      red[1][lane][2 * pair + e] = sv[e];
      red[2][lane][2 * pair + e] = mx[e];
      red[3][lane][2 * pair + e] = mn[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float a = 0.f, s = 0.f, mxv = -CUDART_INF_F, mnv = CUDART_INF_F;
    for (int i = 0; i < kLanes; ++i) {
      a += red[0][i][c];
      s += red[1][i][c];
      mxv = fmaxf(mxv, red[2][i][c]);
      mnv = fminf(mnv, red[3][i][c]);
    }
    float* out = p.part + (static_cast<long long>(bh) * p.splits + blockIdx.x) * 4 * D + c;
    out[0] = a;
    out[D] = s;
    out[2 * D] = mxv;
    out[3 * D] = mnv;
  }
}

// Rows row0 .. row0 + rows of x (row stride ld elements) copied to shared
// memory as bf16 [rows][D], zero past valid_rows: 4-byte loads,
// neighbouring threads on neighbouring words, four in flight per thread
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ld, int row0, int rows, int valid_rows) {
  constexpr int W = D / 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * W; i += kPrepThreads) {
    const int r = i / W;
    uint32_t x = 0u;
    if (row0 + r < valid_rows) {
      x = __ldg(reinterpret_cast<const unsigned int*>(src + (row0 + r) * ld) + (i - r * W));
    }
    reinterpret_cast<uint32_t*>(dst)[i] = x;
  }
}

// One row of d values quantized by a warp (lane holds columns lane + 32 j):
// x = f32(src) - mu, s = max(max|x|, 1e-12) / 127, codes round(x / s)
// clamped, written into the row operand at `row` of an operand of `rows`
// rows, as int8 (QK8) or widened to bf16; returns s. Rows that are not
// `valid` get zero codes.
template <int D, bool QK8>
__device__ __forceinline__ float quantize_row(const __nv_bfloat16* __restrict__ src,
                                              bool valid, const float* mu,
                                              unsigned char* img, int row, int rows) {
  constexpr int NJ = Cfg<D>::DP / 32;
  const int lane = threadIdx.x & 31;
  float x[NJ];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    x[j] = 0.f;
    if (valid && c < D) {
      x[j] = __bfloat162float(src[c]);
      if (mu != nullptr) x[j] = __fsub_rn(x[j], mu[c]);
    }
    amax = fmaxf(amax, fabsf(x[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    const float code = fminf(fmaxf(rintf(__fdiv_rn(x[j], s)), -127.f), 127.f);
    if constexpr (QK8) {
      img[sw32(row, c, rows)] = static_cast<unsigned char>(static_cast<int>(code) & 0xff);
    } else if (c < D) {  // the padding to KP is zero already
      *reinterpret_cast<__nv_bfloat16*>(img + sw32(row, 2 * c, rows)) = __float2bfloat16_rn(code);
    }
  }
  return s;
}

// The tile images: blocks x < qt write q image x, the others kv image x - qt,
// of (b, h) = blockIdx.y. The rows are staged in shared memory first, the
// image is built there (zeroed first) and written out in 16-byte stores.
// QK8: Q's and K's codes as int8, else widened to bf16. PV8: V as codes,
// else as centred bf16 and svs = 1; V as bf16 in natural token order unless
// both flags are on.
template <int D, bool QK8, bool PV8>
__global__ void __launch_bounds__(kPrepThreads) sage_quantize_kernel(const PrepParams p) {
  using C = Cfg<D, QK8, PV8>;
  extern __shared__ __align__(16) unsigned char img[];
  float* stat = reinterpret_cast<float*>(img + C::PrepImg);
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(img + C::PrepImg + 3 * D * 4);
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const bool is_q = static_cast<int>(blockIdx.x) < p.qt;
  const int item = is_q ? blockIdx.x : blockIdx.x - p.qt;
  const int bytes = is_q ? C::QImg : C::Img;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x * 16; i < bytes; i += kPrepThreads * 16) {
    *reinterpret_cast<uint4*>(img + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (is_q) {
    stage_rows<D>(rows, p.q + b * p.qs_b + h * p.qs_h, p.qs_l, item * kQRows, kQRows, p.lq);
  } else {
    stage_rows<D>(rows, p.k + b * p.ks_b + h * p.ks_h, p.ks_l, item * C::BN, C::BN, p.lk);
    stage_rows<D>(rows + C::BN * D, p.v + b * p.vs_b + h * p.vs_h, p.vs_l, item * C::BN, C::BN,
                  p.lk);
    // kmu, vmu and sv from the slices' statistics, in the slices' order
    for (int c = threadIdx.x; c < D; c += kPrepThreads) {
      const float* part = p.part + static_cast<long long>(bh) * p.splits * 4 * D + c;
      float a = 0.f, s = 0.f, mxv = -CUDART_INF_F, mnv = CUDART_INF_F;
      for (int i = 0; i < p.splits; ++i) {
        a += part[(4 * i) * D];
        s += part[(4 * i + 1) * D];
        mxv = fmaxf(mxv, part[(4 * i + 2) * D]);
        mnv = fminf(mnv, part[(4 * i + 3) * D]);
      }
      const float kmu = __fdiv_rn(a, static_cast<float>(p.lk));
      const float vmu = __fdiv_rn(s, static_cast<float>(p.lk));
      const float amax = fmaxf(__fsub_rn(mxv, vmu), __fsub_rn(vmu, mnv));
      const float sv = __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
      stat[c] = kmu;
      stat[D + c] = vmu;
      stat[2 * D + c] = sv;
      if (item == 0) {
        p.svs[bh * D + c] = PV8 ? __fmul_rn(sv, 1.f / 127.f) : 1.f;
        p.vmu[bh * D + c] = vmu;
      }
    }
  }
  __syncthreads();
  if (is_q) {
    float* sq = reinterpret_cast<float*>(img + kQRows * C::RowBytes);
    for (int r = warp; r < kQRows; r += kPrepThreads / 32) {
      const bool valid = item * kQRows + r < p.lq;
      const float s = quantize_row<D, QK8>(rows + r * D, valid, nullptr, img, r, kQRows);
      if ((threadIdx.x & 31) == 0) sq[r] = valid ? __fmul_rn(s, p.inv_sqrt_d) : 0.f;
    }
  } else {
    float* sk = reinterpret_cast<float*>(img + C::KBytes);
    unsigned char* vimg = img + C::Pass0Bytes;
    const __nv_bfloat16* vrows = rows + C::BN * D;
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < C::BN; r += kPrepThreads / 32) {
      const bool valid = item * C::BN + r < p.lk;
      const float s = quantize_row<D, QK8>(rows + r * D, valid, stat, img, r, C::BN);
      if (lane == 0) sk[r] = valid ? s : 1.f;
      if (valid) {
        const int col = (r & ~31) + v_position(r & 31);
        for (int c = lane; c < D; c += 32) {
          const float x = __fsub_rn(__bfloat162float(vrows[r * D + c]), stat[D + c]);
          const float code =
              PV8 ? fminf(fmaxf(rintf(__fdiv_rn(x, stat[2 * D + c])), -127.f), 127.f) : x;
          if constexpr (C::PV_S8) {
            vimg[sw32(c, col, C::DV)] = static_cast<unsigned char>(static_cast<int>(code) & 0xff);
          } else {  // bf16, token r at k16 slice r / 16, element r % 16
            *reinterpret_cast<__nv_bfloat16*>(vimg + sw32(c, 2 * r, D)) =
                __float2bfloat16_rn(code);
          }
        }
      }
    }
  }
  __syncthreads();
  unsigned char* dst = is_q
      ? p.qimg + (static_cast<long long>(bh) * p.qt + item) * C::QImg
      : p.kvimg + (static_cast<long long>(bh) * p.kt + item) * C::Img;
  for (int i = threadIdx.x * 16; i < bytes; i += kPrepThreads * 16) {
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(img + i);
  }
}

template <int D, bool QK8, bool PV8>
int prepare(const PrepParams& p, int batch, cudaStream_t stream) {
  constexpr int kPrepSmem = Cfg<D, QK8, PV8>::PrepSmem;
  auto quantize = sage_quantize_kernel<D, QK8, PV8>;
  cudaError_t e = cudaFuncSetAttribute(
      quantize, cudaFuncAttributeMaxDynamicSharedMemorySize, kPrepSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sage_stats_kernel<D><<<dim3(p.splits, batch * p.heads), kStatThreads, 0, stream>>>(p);
  quantize<<<dim3(p.qt + p.kt, batch * p.heads), kPrepThreads, kPrepSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int prepare_flags(const PrepParams& p, int batch, int qk_int8, int pv_int8, cudaStream_t s) {
  if (qk_int8) {
    return pv_int8 ? prepare<D, true, true>(p, batch, s) : prepare<D, true, false>(p, batch, s);
  }
  return pv_int8 ? prepare<D, false, true>(p, batch, s) : prepare<D, false, false>(p, batch, s);
}

// --------------------------------------------------------------------------
// K4 and its flag variants
// --------------------------------------------------------------------------

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

// The accumulators: s32 for the int8 products, f32 for the bf16 ones
template <bool S8>
using Acc = std::conditional_t<S8, uint32_t, float>;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// A score register read and written as f32 (its bits, in an s32 accumulator)
__device__ __forceinline__ float as_f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ void set_f32(uint32_t& d, float x) { d = __float_as_uint(x); }
__device__ __forceinline__ void set_f32(float& d, float x) { d = x; }

// Issue s = q k^T over the KS k steps, the first overwriting s
template <int D, bool QK8, bool PV8>
__device__ __forceinline__ void qk_issue(Acc<QK8> (&s)[Cfg<D>::BN / 2], uint32_t qa,
                                         uint32_t kb) {
  using C = Cfg<D, QK8, PV8>;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const uint64_t da = make_desc_sw32(qa + ks * kQRows * 32);
    const uint64_t db = make_desc_sw32(kb + ks * C::BN * 32);
    if constexpr (QK8) {
      wgmma_s8<C::BN>(s, da, db, ks);
    } else {
      wgmma<C::BN, 0>(s, da, db, ks);
    }
  }
}

// Issue o += p v over the tile's BN / PK k steps
template <int D, bool QK8, bool PV8>
__device__ __forceinline__ void pv_issue(
    Acc<Cfg<D, QK8, PV8>::PV_S8> (&o)[Cfg<D, QK8, PV8>::DV / 2],
    const uint32_t (&pf)[Cfg<D>::BN / Cfg<D, QK8, PV8>::PK][4], uint32_t vb) {
  using C = Cfg<D, QK8, PV8>;
#pragma unroll
  for (int kk = 0; kk < C::BN / C::PK; ++kk) {
    if constexpr (C::PV_S8) {
      wgmma_rs_s8<C::DV>(o, pf[kk], make_desc_sw32(vb + kk * C::DV * 32), 1);
    } else {
      wgmma_rs<C::DV, 0>(o, pf[kk], make_desc_sw32(vb + kk * C::DV * 32), 1);
    }
  }
}

// The accumulator fragment: warp w of the warpgroup holds rows 16w + g and
// 16w + g + 8 (g = lane / 4); per 8 columns j, s[4j], s[4j+1] are row g's
// columns 8j + 2 (lane % 4) + {0, 1} and s[4j+2], s[4j+3] row g + 8's.

// The exact int -> float of an s32 accumulator: |x| < 2^22; an f32 one
// holds the exact integer already
__device__ __forceinline__ float exact_float(uint32_t x) {
  return __fsub_rn(__uint_as_float(x + kMagicBits), kMagic);
}
__device__ __forceinline__ float exact_float(float x) { return x; }

__device__ __forceinline__ float2 sk_pair(const float* sk, int j, const Params& p) {
  return p.use_sk ? *reinterpret_cast<const float2*>(sk + 8 * j + (threadIdx.x & 3) * 2)
                  : make_float2(1.f, 1.f);
}

// -1e30 in place at the columns past lk (the last partial tile only)
template <int D, class T>
__device__ __forceinline__ void mask_tail(T (&s)[Cfg<D>::BN / 2], int k0, int lk) {
  if (k0 + Cfg<D>::BN <= lk) return;
  const int c0 = k0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < Cfg<D>::BN / 8; ++j) {
    if (c0 + 8 * j >= lk) {
      set_f32(s[4 * j], kNegInf);
      set_f32(s[4 * j + 2], kNegInf);
    }
    if (c0 + 8 * j + 1 >= lk) {
      set_f32(s[4 * j + 1], kNegInf);
      set_f32(s[4 * j + 3], kNegInf);
    }
  }
}

// The scores of a tile in place: s = (f32(s32) * sq) * sk in the base-2
// domain (log2e is in sq), -1e30 past lk. The same operations in both
// passes, so pass 1 meets pass 0's maxima exactly.
template <int D, class T>
__device__ __forceinline__ void scores(T (&s)[Cfg<D>::BN / 2], const float* sk,
                                       float sq0, float sq1, int k0, const Params& p) {
#pragma unroll
  for (int j = 0; j < Cfg<D>::BN / 8; ++j) {
    const float2 skv = sk_pair(sk, j, p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmul_rn(__fmul_rn(exact_float(s[4 * j + e]), e < 2 ? sq0 : sq1),
                                (e & 1) ? skv.y : skv.x);
      set_f32(s[4 * j + e], x);
    }
  }
  mask_tail<D>(s, k0, p.lk);
}

// Pass 0: the tile's scores into the row maxima mb
template <int D, class T>
__device__ __forceinline__ void row_max(const T (&s)[Cfg<D>::BN / 2], float (&mb)[2]) {
#pragma unroll
  for (int j = 0; j < Cfg<D>::BN / 8; ++j) {
    mb[0] = fmaxf(mb[0], fmaxf(as_f32(s[4 * j]), as_f32(s[4 * j + 1])));
    mb[1] = fmaxf(mb[1], fmaxf(as_f32(s[4 * j + 2]), as_f32(s[4 * j + 3])));
  }
}

// Pass 1: p = ex2(s - m) (p <= 1: ex2.approx(0) is 1), its partial row sums,
// and in place round(p * 127) + 1.5 * 2^23, whose low byte is the code (PV8),
// or p
template <int D, bool PV8, class T>
__device__ __forceinline__ void softmax_codes(T (&s)[Cfg<D>::BN / 2], const float (&m)[2],
                                              float (&lsum)[2]) {
#pragma unroll
  for (int i = 0; i < Cfg<D>::BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float pr = fast_exp2(__fsub_rn(as_f32(s[i]), m[r]));
    lsum[r] = __fadd_rn(lsum[r], pr);
    set_f32(s[i], PV8 ? __fadd_rn(__fmul_rn(pr, 127.f), kMagic) : pr);
  }
}

// P.V's bf16 operand of one score register: the code round(p * 127) (exact
// in bf16) or p
template <bool PV8>
__device__ __forceinline__ float p_operand(float x) {
  return PV8 ? __fsub_rn(x, kMagic) : x;
}

// P as the register-A fragments of the tile's P.V k steps: the codes' bytes
// (K4, kPermNote), or bf16 pairs (k16: groups 2kk and 2kk + 1 of s)
template <int D, bool QK8, bool PV8, class T>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[Cfg<D>::BN / Cfg<D, QK8, PV8>::PK][4],
                                       const T (&s)[Cfg<D>::BN / 2]) {
  using C = Cfg<D, QK8, PV8>;
#pragma unroll
  for (int kk = 0; kk < C::BN / C::PK; ++kk) {
    if constexpr (C::PV_S8) {
      const int i = 16 * kk;
      pf[kk][0] = pack_low_bytes(s[i], s[i + 1], s[i + 4], s[i + 5]);
      pf[kk][1] = pack_low_bytes(s[i + 2], s[i + 3], s[i + 6], s[i + 7]);
      pf[kk][2] = pack_low_bytes(s[i + 8], s[i + 9], s[i + 12], s[i + 13]);
      pf[kk][3] = pack_low_bytes(s[i + 10], s[i + 11], s[i + 14], s[i + 15]);
    } else {
      const int i = 8 * kk;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pf[kk][a] = pack_bf16(p_operand<PV8>(as_f32(s[i + 2 * a])),
                              p_operand<PV8>(as_f32(s[i + 2 * a + 1])));
      }
    }
    fence_operands(pf[kk]);
  }
}

template <int N>
__device__ __forceinline__ void fence_p(uint32_t (&pf)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) fence_operands(pf[kk]);
}

// The consumers' turns at the tensor cores (named barriers 3 and 4,
// warpgroup 0 first); the last turn of warpgroup 1 wakes nobody
struct Turns {
  int left;
  __device__ __forceinline__ void begin() const {
    named_barrier(3 + (threadIdx.x >> 7), kConsumers);
  }
  __device__ __forceinline__ void end() {
    --left;
    if ((threadIdx.x >> 7) == 0 || left > 0) {
      named_barrier_arrive(4 - (threadIdx.x >> 7), kConsumers);
    }
  }
};

// The block-end update of one acc value: P.V's block sum, exact in s32 or
// f32 (PV8: scaled by sv / 127; else the bf16 products' f32 sum)
template <bool PV8>
__device__ __forceinline__ float pv_term(uint32_t x, float sv) {
  return __fmul_rn(__int2float_rn(static_cast<int>(x)), sv);
}
template <bool PV8>
__device__ __forceinline__ float pv_term(float x, float sv) {
  return PV8 ? __fmul_rn(x, sv) : x;
}

// A consumer warpgroup: its 64 q rows against every kv tile, two passes per
// softmax block, then its rows of the output.
template <int D, bool QK8, bool PV8>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint32_t kv_base,
                                        uint32_t full, uint32_t empty, uint32_t qbar) {
  using C = Cfg<D, QK8, PV8>;
  constexpr int NS = C::BN / 2;
  constexpr int NV = C::DV / 2;
  constexpr int kStages = C::Stages;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const uint32_t qa = smem_addr(smem) + wg * C::QImg;
  const int n_blocks = (p.kv_tiles + p.sb - 1) / p.sb;
  // per softmax block: a turn per tile in each pass and the last P.V's
  Turns turns{2 * p.kv_tiles + n_blocks};
  if (wg == 1) named_barrier_arrive(3, kConsumers);
  auto stage_of = [&](int step) { return kv_base + (step % kStages) * C::Stage; };
  auto sk_of = [&](int step) {
    return reinterpret_cast<const float*>(smem + C::QBytes + (step % kStages) * C::Stage +
                                          C::KBytes);
  };
  auto wait_full = [&](int step) {
    mbar_wait(full + 8 * (step % kStages), (step / kStages) & 1);
  };

  mbar_wait(qbar, 0);
  const float* sqs = reinterpret_cast<const float*>(smem + wg * C::QImg + kQRows * C::RowBytes);
  const float sq0 = __fmul_rn(sqs[warp * 16 + (lane >> 2)], kLog2e);
  const float sq1 = __fmul_rn(sqs[warp * 16 + (lane >> 2) + 8], kLog2e);

  Acc<QK8> s[NS];
  Acc<C::PV_S8> pv[NV];
  uint32_t pf[C::BN / C::PK][4];
  float* acc = reinterpret_cast<float*>(smem + C::kAcc) + threadIdx.x;  // acc[i * kConsumers]
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i * kConsumers] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  int st = 0;  // the step: its stage st % kStages, its phase (st / kStages) & 1

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * p.sb;
    const int nt = min(p.sb, p.kv_tiles - t0);

    // pass 0: the block's row maxima
    float mb[2] = {kNegInf, kNegInf};
    for (int i = 0; i < nt; ++i, ++st) {
      wait_full(st);
      turns.begin();
      wgmma_fence();
      qk_issue<D, QK8, PV8>(s, qa, stage_of(st));
      wgmma_commit();
      turns.end();
      wgmma_wait<0>();
      fence_operands(s);
      scores<D>(s, sk_of(st), sq0, sq1, (t0 + i) * C::BN, p);
      mbar_arrive(empty + 8 * (st % kStages));
      row_max<D>(s, mb);
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

    // pass 1, its first tile peeled: s, p and the codes, no P.V yet
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) pv[i] = 0;
    wait_full(st);
    turns.begin();
    wgmma_fence();
    qk_issue<D, QK8, PV8>(s, qa, stage_of(st));
    wgmma_commit();
    turns.end();
    wgmma_wait<0>();
    fence_operands(s);
    scores<D>(s, sk_of(st), sq0, sq1, t0 * C::BN, p);
    softmax_codes<D, PV8>(s, m_r, lsum);
    pack_p<D, QK8, PV8>(pf, s);
    ++st;
    // tile i: s = q k_i^T is issued, then o += p_{i-1} v_{i-1}; tile i's
    // softmax runs while the latter is in flight; tile i - 1's stage is
    // released once its P.V has finished
    for (int i = 1; i < nt; ++i, ++st) {
      wait_full(st);
      turns.begin();
      fence_operands(pv);
      wgmma_fence();
      qk_issue<D, QK8, PV8>(s, qa, stage_of(st));
      wgmma_commit();
      pv_issue<D, QK8, PV8>(pv, pf, stage_of(st - 1) + C::Pass0Bytes);
      wgmma_commit();
      turns.end();
      wgmma_wait<1>();
      fence_operands(s);
      scores<D>(s, sk_of(st), sq0, sq1, (t0 + i) * C::BN, p);
      softmax_codes<D, PV8>(s, m_r, lsum);
      wgmma_wait<0>();
      fence_operands(pv);
      fence_p(pf);
      mbar_arrive(empty + 8 * ((st - 1) % kStages));
      pack_p<D, QK8, PV8>(pf, s);
    }
    // the block's last P.V, then acc and l take alpha and the block's sums
    turns.begin();
    fence_operands(pv);
    wgmma_fence();
    pv_issue<D, QK8, PV8>(pv, pf, stage_of(st - 1) + C::Pass0Bytes);
    wgmma_commit();
    turns.end();
    wgmma_wait<0>();
    fence_operands(pv);
    mbar_arrive(empty + 8 * ((st - 1) % kStages));
    const int c0 = (lane & 3) * 2;
    // the variants read svs through a pointer opaque to the compiler once
    // per block: hoisted out of the block loop, d = 160's 80 loads spilled
    const float* svs = p.svs + bh * D;
    if constexpr (!C::PV_S8) asm volatile("" : "+l"(svs));
#pragma unroll
    for (int j = 0; j < NV / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c0 + (e & 1);
        const float sv = PV8 && c < D ? __ldg(svs + c) : 0.f;
        float& a = acc[(4 * j + e) * kConsumers];
        a = __fadd_rn(__fmul_rn(a, alpha[e >> 1]), pv_term<PV8>(pv[4 * j + e], sv));
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
  const int row = (blockIdx.x * 2 + wg) * kQRows + warp * 16 + (lane >> 2);
  __nv_bfloat16* go = p.out + b * p.so_b + h * p.so_h + (lane & 3) * 2;
  const float* vmu = p.vmu + bh * D + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NV / 4; ++j) {
    if (8 * j + (lane & 3) * 2 >= D) continue;  // DV's padding
    const float mu0 = __ldg(vmu + 8 * j), mu1 = __ldg(vmu + 8 * j + 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= p.lq) continue;
      const float o0 = __fadd_rn(__fdiv_rn(acc[(4 * j + 2 * half) * kConsumers], l[half]), mu0);
      const float o1 =
          __fadd_rn(__fdiv_rn(acc[(4 * j + 2 * half + 1) * kConsumers], l[half]), mu1);
      *reinterpret_cast<uint32_t*>(go + r * p.so_l + 8 * j) = pack_bf16(o0, o1);
    }
  }
}

// Two consumer warpgroups and one producer warpgroup, in which one thread
// issues the copies: the block's q images once, then per softmax block its
// kv tiles twice (K and sk only for pass 0, the whole image for pass 1).
// The producer gives back registers (setmaxnreg: 24 + 2 x 240 of the 512 a
// lane of each SM sub-partition has) for the consumers' s, p and P.V sums.
template <int D, bool QK8, bool PV8>
__global__ void __launch_bounds__(kThreads, 1) sage_attention_kernel(const Params p) {
  using C = Cfg<D, QK8, PV8>;
  constexpr int kStages = C::Stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const uint32_t kv_base = smem_addr(smem) + C::QBytes;
  const uint32_t full = smem_addr(smem) + C::kBar;  // full[i] at full + 8 i
  const uint32_t empty = full + kStages * 8;
  const uint32_t qbar = empty + kStages * 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the role by warpgroup, made visibly uniform across each warp for
  // setmaxnreg
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const long long bh = blockIdx.y;
      mbar_expect_tx(qbar, 2 * C::QImg);
      bulk_copy(smem_addr(smem), p.qimg + (bh * p.qt + blockIdx.x * 2) * C::QImg, 2 * C::QImg,
                qbar);
      const unsigned char* src = p.kvimg + bh * p.kt * C::Img;
      int st = 0;
      for (int t0 = 0; t0 < p.kv_tiles; t0 += p.sb) {
        const int nt = min(p.sb, p.kv_tiles - t0);
        for (int pass = 0; pass < 2; ++pass) {
          const int bytes = pass ? C::Img : C::Pass0Bytes;
          for (int i = 0; i < nt; ++i, ++st) {
            const int stage = st % kStages;
            if (st >= kStages) mbar_wait(empty + 8 * stage, (st / kStages - 1) & 1);
            mbar_expect_tx(full + 8 * stage, bytes);
            bulk_copy(kv_base + stage * C::Stage, src + static_cast<long long>(t0 + i) * C::Img,
                      bytes, full + 8 * stage);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, QK8, PV8>(p, smem, kv_base, full, empty, qbar);
  }
}

template <int D, bool QK8, bool PV8>
int attend(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<D, QK8, PV8>;
  auto kernel = sage_attention_kernel<D, QK8, PV8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.lq + kBM - 1) / kBM, batch * p.heads);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A flag variant: (qk_int8, pv_int8) = (1, 1) is K4 (ldt_sage_attention_fwd)
template <int D>
int attend_variant(const Params& p, int batch, int qk_int8, int pv_int8, cudaStream_t s) {
  if (qk_int8 && !pv_int8) return attend<D, true, false>(p, batch, s);
  if (!qk_int8 && pv_int8) return attend<D, false, true>(p, batch, s);
  if (!qk_int8 && !pv_int8) return attend<D, false, false>(p, batch, s);
  return kErrUnsupported;
}

template <int D>
bool images_fit(int lq, int lk, int qt, int kt) {
  return qt == (lq + kBM - 1) / kBM * 2 && kt == (lk + Cfg<D>::BN - 1) / Cfg<D>::BN;
}

bool params_ok(int batch, int heads, int lq, int lk, int kt, int kv_tiles, int sb,
               long long so_b, long long so_h, long long so_l) {
  return batch >= 1 && heads >= 1 && lq >= 1 && lk >= 1 && batch * heads <= 65535 && sb >= 1 &&
         kv_tiles >= 1 && kv_tiles <= kt && so_b % 2 == 0 && so_h % 2 == 0 && so_l % 2 == 0;
}

}  // namespace

#define LDT_SAGE_DIMS(X) X(32) X(40) X(64) X(80) X(128) X(160)

// The preparation: q, k, v (B, H, L, d) bf16 through their (b, h, l) strides
// in elements (each row's d values contiguous and 4-byte aligned); writes qimg
// (B*H, qt, q image) and kvimg (B*H, kt, kv image) bytes (layout in the
// header; qt = ceil(Lq / 128) * 2, kt = ceil(Lk / BN)), svs and vmu (B*H, d)
// f32, using part (B*H, 16, 4, d) f32 as scratch (one slice of the column
// statistics per 1024 tokens, at most 16). inv_sqrt_d is folded into sq.
// qk_int8 0: Q's and K's codes widened to bf16 (int8_mxu=False); pv_int8 0:
// the kv images hold V as centred bf16, and svs is 1.
extern "C" int ldt_sage_prepare_fwd(const void* q, const void* k, const void* v, void* qimg,
                                    void* kvimg, void* svs, void* vmu, void* part, int batch,
                                    int heads, int lq, int lk, int d, long long qs_b,
                                    long long qs_h, long long qs_l, long long ks_b,
                                    long long ks_h, long long ks_l, long long vs_b,
                                    long long vs_h, long long vs_l, int qt, int kt,
                                    float inv_sqrt_d, int qk_int8, int pv_int8, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch * heads > 65535 || qs_l % 2 || ks_l % 2 || vs_l % 2 || qs_h % 2 || ks_h % 2 || vs_h % 2 ||
      qs_b % 2 || ks_b % 2 || vs_b % 2) {
    return kErrUnsupported;
  }
  const int splits = min(kMaxStatSplits, (lk + 1023) / 1024);
  PrepParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), qs_b, qs_h, qs_l, ks_b, ks_h, ks_l,
               vs_b, vs_h, vs_l, static_cast<unsigned char*>(qimg),
               static_cast<unsigned char*>(kvimg), static_cast<float*>(svs),
               static_cast<float*>(vmu), static_cast<float*>(part), heads, lq, lk, splits,
               qt, kt, inv_sqrt_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDT_SAGE_PREP_CASE(DIM)                                   \
  case DIM:                                                        \
    if (!images_fit<DIM>(lq, lk, qt, kt)) return kErrUnsupported;  \
    return prepare_flags<DIM>(p, batch, qk_int8, pv_int8, s);
  switch (d) {
    LDT_SAGE_DIMS(LDT_SAGE_PREP_CASE)
    default:
      return kErrUnsupported;
  }
#undef LDT_SAGE_PREP_CASE
}

// K4 on the prepared images; out (B, H, Lq, d) bf16 through its (b, h, l)
// strides (even, the d elements of a row contiguous). kv_tiles is the number
// of kv tiles attended (kt unless a check plants a fault), sb the softmax
// block in tiles; use_sk 0 drops sk (a planted fault). Head dims 32, 40, 64,
// 80, 128, 160.
extern "C" int ldt_sage_attention_fwd(const void* qimg, const void* kvimg, const void* svs,
                                      const void* vmu, void* out, int batch, int heads, int lq,
                                      int lk, int d, long long so_b, long long so_h,
                                      long long so_l, int qt, int kt, int kv_tiles, int sb,
                                      int use_sk, void* stream) {
  if (!params_ok(batch, heads, lq, lk, kt, kv_tiles, sb, so_b, so_h, so_l)) {
    return kErrUnsupported;
  }
  Params p{static_cast<const unsigned char*>(qimg), static_cast<const unsigned char*>(kvimg),
           static_cast<const float*>(svs), static_cast<const float*>(vmu),
           static_cast<__nv_bfloat16*>(out), so_b, so_h, so_l, heads, lq, lk, qt, kt,
           kv_tiles, sb, use_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDT_SAGE_CASE(DIM)                                         \
  case DIM:                                                        \
    if (!images_fit<DIM>(lq, lk, qt, kt)) return kErrUnsupported;  \
    return attend<DIM, true, true>(p, batch, s);
  switch (d) {
    LDT_SAGE_DIMS(LDT_SAGE_CASE)
    default:
      return kErrUnsupported;
  }
#undef LDT_SAGE_CASE
}

// K4's flag variants on the images of ldt_sage_prepare_fwd with the same
// flags; out, kv_tiles, sb and use_sk as for ldt_sage_attention_fwd.
// qk_int8 1: Q.K^T on int8 wgmma (int8_mxu=True), 0: at the bf16 rate;
// pv_int8 1: P.V on the codes, 0: bf16 P times bf16 V; both at the bf16 rate.
// The pair (1, 1) is K4's and refused.
extern "C" int ldt_sage_variant_fwd(const void* qimg, const void* kvimg, const void* svs,
                                    const void* vmu, void* out, int batch, int heads, int lq,
                                    int lk, int d, long long so_b, long long so_h,
                                    long long so_l, int qt, int kt, int kv_tiles, int sb,
                                    int use_sk, int qk_int8, int pv_int8, void* stream) {
  if (!params_ok(batch, heads, lq, lk, kt, kv_tiles, sb, so_b, so_h, so_l)) {
    return kErrUnsupported;
  }
  const Params p{static_cast<const unsigned char*>(qimg),
                 static_cast<const unsigned char*>(kvimg), static_cast<const float*>(svs),
                 static_cast<const float*>(vmu), static_cast<__nv_bfloat16*>(out),
                 so_b, so_h, so_l, heads, lq, lk, qt, kt, kv_tiles, sb, use_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDT_SAGE_VARIANT_CASE(DIM)                                 \
  case DIM:                                                        \
    if (!images_fit<DIM>(lq, lk, qt, kt)) return kErrUnsupported;  \
    return attend_variant<DIM>(p, batch, qk_int8, pv_int8, s);
  switch (d) {
    LDT_SAGE_DIMS(LDT_SAGE_VARIANT_CASE)
    default:
      return kErrUnsupported;
  }
#undef LDT_SAGE_VARIANT_CASE
}

#undef LDT_SAGE_DIMS

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
