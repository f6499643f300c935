// K9 and K10: per-row int8 quantization of bf16 activations with a fused
// elementwise prologue, codes int8 (M, K) and scales f32 (M, 1).
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py
//   _row_quantize_fused_2d (K9, pallas_call at :956; bodies
//   _kernel_rowquant_plain and _kernel_rowquant_lnmod) and
//   _row_quantize_concat_gelu_2d (K10, pallas_call at :1032; body
//   _kernel_rowquant_concat_gelu).
//
// The law, per row y of the prologue's f32 output (quantize_rows):
//   sx = max(absmax(y), 1e-12) * (1/127),  codes = clip(rint(y / sx), +-127)
// with IEEE division and round-half-to-even, so for the "none" prologue the
// codes and scales equal the plain version's bit for bit. Prologues: none;
// gelu (tanh form); ln_mod = LayerNorm(eps) * s + t over the whole row with
// (K,) f32 s and t (two-pass mean and centred variance, as the JAX kernel).
// K10 quantizes rows [a ; gelu(b[:, lo:hi])]: the caller passes b already
// offset to lo and its row stride, so only the window is read and the concat
// is never built.
//
// What bounds it on an H100: bytes, 3 per element (each bf16 read once, one
// int8 code written; plus s, t for ln_mod, shared by all rows): the Flux
// ln_mod call at (4352, 3072) moves 40.1 MB, 12.0 us at 3.35 TB/s; K10 at
// (4352, 3072 + 12288 window) 200.5 MB, 59.9 us. With one block per row
// (all of a row's loads in flight before its arithmetic, block-wide
// reductions) most of the time goes elsewhere (ablate_rowquant.py, PERF.md
// §6): to an IEEE division and an accurate tanhf per element at the GELU
// shapes (instruction throughput), to scalar loads of s and t per element for
// ln_mod, and to latency, with nothing in flight while a row is reduced.
//
// What the design does about it:
// - A persistent grid (quant_matmul.rowquant_geometry, passed in): each
//   block holds G groups of W warps, a group takes one row at a time and
//   walks the rows with a stride of G * gridDim.x. While it reduces and
//   quantizes one row, the next row's bytes are already on their way into
//   the other stage of its two-stage shared-memory ring (16-byte cp.async,
//   each lane copying and later reading only its own chunks, so the ring
//   needs no barrier: cp.async.wait_group alone).
// - A row's f32 values stay in registers (kVpt 16-byte chunks per lane), so
//   the prologue runs once per element whatever the passes; reductions are
//   warp shuffles and, across a row's W warps, one named barrier each. The
//   Flux path's widths (3072, 12288, 15360) have instantiations with W and
//   kVpt fixed (offsets known to the compiler, at most 128 registers: 16
//   warps per SM); any other width up to 32768 takes the generic one.
// - ln_mod's s and t are read as 16-byte vectors, the same columns for
//   every row a lane takes, so from the L1 cache after its first row.
// - The division is bracketed: v * (inv (1 -+ 2^-21)), inv = __frcp_rn(sx),
//   lie on either side of the IEEE quotient v / sx, and each is rounded to
//   an integer by one fused add of 1.5 * 2^23 (the code is the sum's low
//   byte; four codes packed by three byte permutes). Where the two round to
//   different integers (about 4e-5 of random elements) the chunk is
//   recomputed with __fdiv_rn, so the law holds bit for bit.
// - The GELU is x / (1 + 2^(x (A + B x^2))), the tanh form rewritten, with
//   ex2.approx and rcp.approx: two MUFU operations and five FMA-pipe ones
//   per element instead of tanhf (within 4 ulps of |x| of torch's tanh form
//   on every finite bf16 input: tests/test_torch_rowquant_design.py).
// What bounds it now: at the wide rows, bytes and the arithmetic that does
// not hide under them (K10: a copy of its bytes reaches 0.85 of the bound,
// the GELU and the bracket add a fifth more); at K = 3072, where a call's
// bound is 11-12 us, latency (PERF.md §6).
// No fast-math flags: every other operation is IEEE, written with the _rn
// intrinsics so that nvcc cannot contract it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kVec = 8;         // bf16 elements per 16-byte chunk
constexpr int kStages = 2;      // a group's ring: its row and the next one
constexpr int kMaxWarps = 8;    // warps per block
constexpr int kMaxK = 32768;
// dynamic shared memory a block may use: the card's 232448 less room for
// the static reduction scratch
constexpr int kMaxSmem = 231424;
constexpr int kErrUnsupported = 1000;

// gelu(x) = 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)), u = c (x + 0.044715
// x^3), c = sqrt(2 / pi); exp(-2u) = 2^(x (kGeluA + kGeluB x^2)) with
// kGeluA = -2 c log2(e), kGeluB = 0.044715 kGeluA (f32, round to nearest)
constexpr float kGeluA = -2.30220819f;
constexpr float kGeluB = -0.102943242f;
// 1.5 * 2^23: adding it rounds |y| < 2^22 to an integer, half to even
constexpr float kRound = 12582912.0f;
// 1 -+ 2^-21: the reciprocal of the scale times these brackets the quotient
constexpr float kBracketLo = 0.999999523162841796875f;
constexpr float kBracketHi = 1.000000476837158203125f;

enum Prologue { kNone = 0, kGelu = 1, kLnMod = 2 };

struct Params {
  const __nv_bfloat16* a;  // first segment (the whole row for K9)
  const __nv_bfloat16* b;  // second segment (K10's window), or null
  long long lda, ldb;      // row strides in elements
  int m;
  int ka, kb;              // segment widths, multiples of 8
  const float* s;          // ln_mod scale (K,), f32
  const float* t;          // ln_mod shift (K,), f32
  float eps;
  int center;              // ln_mod subtracts the mean (1)
  float inv_qmax;          // 1/127 in f32
  int8_t* codes;           // (M, K) contiguous
  float* sx;               // (M,)
  int warps_per_row;       // W
  int rows_per_block;      // G
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu(float x) {
  const float p = __fmaf_rn(__fmul_rn(x, x), kGeluB, kGeluA);
  const float e = ex2_approx(__fmul_rn(x, p));
  return __fmul_rn(x, rcp_approx(__fadd_rn(1.0f, e)));
}

struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// Every thread of the group gets the reduction of `v` over the group's W
// warps, summed in the same order by all of them. `red` is this
// reduction's slot of W words for the group; a slot is written again two
// rows later, after a barrier every reader has passed.
template <typename Op>
__device__ __forceinline__ float group_reduce(float v, Op op, float* red, int w,
                                              int warp, int group) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (w == 1) return v;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  hopper::named_barrier(1 + group, 32 * w);
  v = red[0];
  for (int i = 1; i < w; ++i) v = op(v, red[i]);
  return v;
}

// The 16-byte chunks `lane + j * lanes` of `row` into the stage at `dst`
template <int kVpt, bool kFixed>
__device__ __forceinline__ void load_row(const Params& p, long long row, uint32_t dst,
                                         int lane, int lanes, int nvec, int na) {
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    const int vi = lane + j * lanes;
    if (kFixed || vi < nvec) {
      const __nv_bfloat16* src = vi < na ? p.a + row * p.lda + vi * kVec
                                         : p.b + row * p.ldb + (vi - na) * kVec;
      hopper::cp_async_16(dst + vi * 16, src, 16);
    }
  }
}

// kPA: the prologue of the first segment (K9's whole row), kPB: of the
// second (K10's window); kVpt: 16-byte chunks per lane; kW: warps per row,
// with rows of exactly 32 kW kVpt chunks (every lane's chunks in the row,
// offsets known to the compiler; at most 128 registers, two blocks of 8
// warps per SM), or 0: the geometry's W, rows of any length up to 32 W
// kVpt chunks (up to 255 registers)
template <int kPA, int kPB, int kVpt, int kW>
__global__ void __launch_bounds__(kMaxWarps * 32, kW > 0 ? 2 : 1)
    row_quantize_kernel(Params p) {
  constexpr bool kFixed = kW > 0;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[2][3][kMaxWarps];  // [row parity][reduction][group's warps]
  const int w = kFixed ? kW : p.warps_per_row;
  const int lanes = 32 * w;
  const int nvec = kFixed ? 32 * kW * kVpt : (p.ka + p.kb) / kVec;
  const int k = nvec * kVec;
  const int na = p.ka / kVec;
  const int group = threadIdx.x / lanes;
  const int lane = threadIdx.x - group * lanes;
  const int warp = lane >> 5;

  // shared memory: G groups x kStages x K bf16
  const int stage_bytes = 2 * k;
  uint8_t* ring = smem + group * kStages * stage_bytes;
  const uint32_t ring_addr = hopper::smem_addr(ring);

  // the group's first rows into stages 0 .. kStages - 2, one commit group each
  const long long stride = static_cast<long long>(gridDim.x) * p.rows_per_block;
  long long row = static_cast<long long>(blockIdx.x) * p.rows_per_block + group;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (row + i * stride < p.m) {
      load_row<kVpt, kFixed>(p, row + i * stride, ring_addr + i * stage_bytes, lane, lanes,
                             nvec, na);
    }
    hopper::cp_async_commit();
  }

  for (int it = 0, stage = 0; row < p.m; ++it, row += stride) {
    float(*red_row)[kMaxWarps] = red[it & 1];
    float* slot[3] = {red_row[0] + group * w, red_row[1] + group * w, red_row[2] + group * w};
    // this row's chunks have landed (the next rows' may still be in flight)
    hopper::cp_async_wait<kStages - 2>();
    float v[kVpt][kVec];
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int vi = lane + j * lanes;
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[j][e] = 0.f;
      if (kFixed || vi < nvec) {
        const uint4 raw =
            reinterpret_cast<const uint4*>(ring + stage * stage_bytes)[vi];
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][2 * e] = __uint_as_float(words[e] << 16);
          v[j][2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
        }
        // K9's gelu covers the whole row; K10's the window past ka
        if (kPA == kGelu || (kPB == kGelu && vi >= na)) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[j][e] = gelu(v[j][e]);
        }
      }
    }
    // the row kStages - 1 strides on into the stage read one row ago (every
    // lane read its own chunks of it before this iteration's wait)
    const long long ahead = row + (kStages - 1) * stride;
    const int refill = stage == 0 ? kStages - 1 : stage - 1;
    if (ahead < p.m) {
      load_row<kVpt, kFixed>(p, ahead, ring_addr + refill * stage_bytes, lane, lanes, nvec, na);
    }
    hopper::cp_async_commit();

    if (kPA == kLnMod) {
      // four partial sums per lane: chains a quarter as long
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e & 3] = __fadd_rn(acc[e & 3], v[j][e]);
      }
      const float sum = group_reduce(__fadd_rn(__fadd_rn(acc[0], acc[1]),
                                               __fadd_rn(acc[2], acc[3])),
                                     Sum(), slot[0], w, warp, group);
      const float mean = p.center ? __fdiv_rn(sum, static_cast<float>(k)) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        if (kFixed || lane + j * lanes < nvec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            v[j][e] = __fsub_rn(v[j][e], mean);
            acc[e & 3] = __fmaf_rn(v[j][e], v[j][e], acc[e & 3]);
          }
        }
      }
      const float sq = group_reduce(__fadd_rn(__fadd_rn(acc[0], acc[1]),
                                              __fadd_rn(acc[2], acc[3])),
                                    Sum(), slot[1], w, warp, group);
      const float r = rsqrtf(__fadd_rn(__fdiv_rn(sq, static_cast<float>(k)), p.eps));
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const int vi = lane + j * lanes;
        if (kFixed || vi < nvec) {
          // every lane reads the same columns of s and t for each of its
          // rows: after the first row they come from the L1 cache
          const float4* s4 = reinterpret_cast<const float4*>(p.s) + 2 * vi;
          const float4* t4 = reinterpret_cast<const float4*>(p.t) + 2 * vi;
          const float4 sv[2] = {__ldg(s4), __ldg(s4 + 1)};
          const float4 tv[2] = {__ldg(t4), __ldg(t4 + 1)};
          const float sc[8] = {sv[0].x, sv[0].y, sv[0].z, sv[0].w,
                               sv[1].x, sv[1].y, sv[1].z, sv[1].w};
          const float sh[8] = {tv[0].x, tv[0].y, tv[0].z, tv[0].w,
                               tv[1].x, tv[1].y, tv[1].z, tv[1].w};
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            v[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][e], r), sc[e]), sh[e]);
          }
        }
      }
    }

    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) part[e & 3] = fmaxf(part[e & 3], fabsf(v[j][e]));
    }
    const float amax = group_reduce(fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3])),
                                    Max(), slot[2], w, warp, group);
    const float scale = __fmul_rn(fmaxf(amax, 1e-12f), p.inv_qmax);
    // v * inv_lo and v * inv_hi lie on either side of the IEEE quotient
    // v / scale (each within 2^-22 of it relatively, the bracket 2^-21 wide);
    // where both round to one integer, so does the quotient
    const float inv = __frcp_rn(scale);
    const float inv_lo = __fmul_rn(inv, kBracketLo);
    const float inv_hi = __fmul_rn(inv, kBracketHi);
    if (lane == 0) p.sx[row] = scale;

    int8_t* out = p.codes + row * k;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int vi = lane + j * lanes;
      if (kFixed || vi < nvec) {
        uint32_t bits[kVec];
        bool tie = false;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float r_lo = __fmaf_rn(v[j][e], inv_lo, kRound);
          const float r_hi = __fmaf_rn(v[j][e], inv_hi, kRound);
          tie |= r_lo != r_hi;
          bits[e] = __float_as_uint(fminf(fmaxf(r_lo, kRound - 127.f), kRound + 127.f));
        }
        if (tie) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float y = fminf(fmaxf(__fdiv_rn(v[j][e], scale), -127.f), 127.f);
            bits[e] = __float_as_uint(__fadd_rn(y, kRound));
          }
        }
        const uint32_t lo = __byte_perm(__byte_perm(bits[0], bits[1], 0x0040),
                                        __byte_perm(bits[2], bits[3], 0x0040), 0x5410);
        const uint32_t hi = __byte_perm(__byte_perm(bits[4], bits[5], 0x0040),
                                        __byte_perm(bits[6], bits[7], 0x0040), 0x5410);
        *reinterpret_cast<uint2*>(out + vi * kVec) = make_uint2(lo, hi);
      }
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
}

int smem_bytes(int k, int rows_per_block) { return kStages * 2 * k * rows_per_block; }

template <int kPA, int kPB, int kVpt, int kW>
int run(const Params& p, int blocks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_quantize_kernel<kPA, kPB, kVpt, kW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  row_quantize_kernel<kPA, kPB, kVpt, kW>
      <<<blocks, 32 * p.warps_per_row * p.rows_per_block,
         smem_bytes(p.ka + p.kb, p.rows_per_block), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The geometry (quant_matmul.rowquant_geometry) is checked here: a group's
// lanes cover the row, a block holds at most kMaxWarps warps and fits its
// shared memory; any grid of at least one block covers every row. The
// fixed instantiations (quant_matmul.ROWQ_FIXED) take the Flux path's row
// widths, each for the prologues it has there, at most 128 registers so
// that two blocks of 8 warps fit an SM; every other shape takes the
// generic one, 16 chunks per lane.
int launch(const Params& p, int prologue_a, int prologue_b, int vpt, int blocks,
           cudaStream_t stream) {
  const int k = p.ka + p.kb;
  const int w = p.warps_per_row;
  const int g = p.rows_per_block;
  if (p.m < 1 || k < kVec || k > kMaxK || p.ka % kVec != 0 || p.kb % kVec != 0 ||
      p.lda % kVec != 0 || (p.kb > 0 && p.ldb % kVec != 0) || !aligned(p.a, 16) ||
      (p.kb > 0 && !aligned(p.b, 16)) || !aligned(p.codes, 8) ||
      (prologue_a == kLnMod && (!aligned(p.s, 16) || !aligned(p.t, 16))) || w < 1 ||
      g < 1 || w * g > kMaxWarps || 32 * w * vpt * kVec < k || blocks < 1 ||
      smem_bytes(k, g) > kMaxSmem) {
    return kErrUnsupported;
  }
  const int combo = prologue_a * 3 + prologue_b;
  const bool exact = 32 * w * vpt * kVec == k;
#define RQ_FIXED(PA, PB, VPT, W)                                               \
  if (combo == PA * 3 + PB && vpt == VPT && w == W && exact) {                 \
    return run<PA, PB, VPT, W>(p, blocks, stream);                             \
  }
  RQ_FIXED(kNone, kNone, 6, 2)     // K = 3072
  RQ_FIXED(kLnMod, kNone, 6, 2)
  RQ_FIXED(kNone, kNone, 6, 8)     // K = 12288
  RQ_FIXED(kGelu, kNone, 6, 8)
  RQ_FIXED(kNone, kNone, 10, 6)    // K = 15360
  RQ_FIXED(kNone, kGelu, 10, 6)
#undef RQ_FIXED
  if (vpt != 16) return kErrUnsupported;
  switch (combo) {
    case kNone * 3 + kNone: return run<kNone, kNone, 16, 0>(p, blocks, stream);
    case kGelu * 3 + kNone: return run<kGelu, kNone, 16, 0>(p, blocks, stream);
    case kLnMod * 3 + kNone: return run<kLnMod, kNone, 16, 0>(p, blocks, stream);
    case kNone * 3 + kGelu: return run<kNone, kGelu, 16, 0>(p, blocks, stream);
  }
  return kErrUnsupported;
}

}  // namespace

// K9. x (M, K) bf16 with row stride ldx (elements, a multiple of 8), x
// 16-byte aligned; prologue 0 none, 1 gelu, 2 ln_mod (s, t (K,) f32
// contiguous and 16-byte aligned; null otherwise). center = 1 and inv_qmax
// = 1/127 give the law; the other values exist so that a check can plant a
// fault. vpt, warps_per_row, rows_per_block and blocks: the launch geometry
// (quant_matmul.rowquant_geometry).
extern "C" int ldt_row_quantize_fwd(const void* x, const void* s, const void* t,
                                    void* codes, void* sx, int m, int k,
                                    long long ldx, int prologue, int center,
                                    float eps, float inv_qmax, int vpt,
                                    int warps_per_row, int rows_per_block,
                                    int blocks, void* stream) {
  if (prologue < kNone || prologue > kLnMod ||
      (prologue == kLnMod && (s == nullptr || t == nullptr))) {
    return kErrUnsupported;
  }
  Params p{};
  p.a = static_cast<const __nv_bfloat16*>(x);
  p.lda = ldx;
  p.m = m;
  p.ka = k;
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.eps = eps;
  p.center = center;
  p.inv_qmax = inv_qmax;
  p.codes = static_cast<int8_t*>(codes);
  p.sx = static_cast<float*>(sx);
  p.warps_per_row = warps_per_row;
  p.rows_per_block = rows_per_block;
  return launch(p, prologue, kNone, vpt, blocks, static_cast<cudaStream_t>(stream));
}

// K10. Rows [a ; prologue_b(b)]: a (M, ka) bf16 with row stride lda, b the
// window (M, kb) bf16 with row stride ldb (the caller offsets the pointer to
// the window's first lane), both 16-byte aligned. prologue_b = 1 (gelu) is
// the law. The geometry as for K9.
extern "C" int ldt_row_quantize_concat_fwd(const void* a, const void* b, void* codes,
                                           void* sx, int m, int ka, int kb,
                                           long long lda, long long ldb,
                                           int prologue_b, float inv_qmax, int vpt,
                                           int warps_per_row, int rows_per_block,
                                           int blocks, void* stream) {
  if ((prologue_b != kNone && prologue_b != kGelu) || kb < kVec || b == nullptr) {
    return kErrUnsupported;
  }
  Params p{};
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.lda = lda;
  p.ldb = ldb;
  p.m = m;
  p.ka = ka;
  p.kb = kb;
  p.center = 1;
  p.inv_qmax = inv_qmax;
  p.codes = static_cast<int8_t*>(codes);
  p.sx = static_cast<float*>(sx);
  p.warps_per_row = warps_per_row;
  p.rows_per_block = rows_per_block;
  return launch(p, kNone, prologue_b, vpt, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape, option or geometry not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
