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
// What bounds it on an H100: bytes. It reads each bf16 element once and
// writes one int8 code, 3 bytes per element (plus s, t for ln_mod, shared by
// all rows): the Flux ln_mod call at (4352, 3072) moves 40.1 MB, 12.0 us at
// 3.35 TB/s; K10 at (4352, 3072 + 12288 window) 200.5 MB, 59.9 us.
//
// What the design does about it: one block per row; each thread loads up
// to four 16-byte vectors of the row at once (all its loads in flight
// before any arithmetic) and keeps the row in registers, so the row is
// read from device memory once whatever the prologue's passes (mean,
// variance, absmax). Neighbouring threads read neighbouring 16-byte chunks.
// Reductions are warp shuffles, then one shared word per warp. The codes
// leave as 8-byte stores. Rows up to 32768 elements (1024 threads x 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // bf16 elements per 16-byte load
constexpr int kVecPerThread = 4;   // loads per thread
constexpr int kMaxThreads = 1024;
constexpr int kErrUnsupported = 1000;

enum Prologue { kNone = 0, kGelu = 1, kLnMod = 2 };

struct Params {
  const __nv_bfloat16* a;  // first segment (the whole row for K9)
  const __nv_bfloat16* b;  // second segment (K10's window), or null
  long long lda, ldb;      // row strides in elements
  int ka, kb;              // segment widths, multiples of 8
  int prologue_a;          // kNone, kGelu or kLnMod (whole row)
  int prologue_b;          // kNone or kGelu
  const float* s;          // ln_mod scale (K,), f32
  const float* t;          // ln_mod shift (K,), f32
  float eps;
  int center;              // ln_mod subtracts the mean (1)
  float inv_qmax;          // 1/127 in f32
  int8_t* codes;           // (M, K) contiguous
  float* sx;               // (M,)
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

// Every thread of the block gets the reduction of `v` over the block; 0 is
// the identity of both reductions used (a sum, a max of magnitudes).
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // scratch free from the previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < warps ? scratch[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kConcat: the row has a second segment (K10); K9's rows are one segment.
template <bool kConcat>
__global__ void __launch_bounds__(kMaxThreads) row_quantize_kernel(Params p) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const int k = p.ka + p.kb;
  const int nvec = k / kVec;
  const int na = kConcat ? p.ka / kVec : nvec;
  float v[kVecPerThread][kVec];

  // all loads first, then the elementwise prologue
  uint4 raw[kVecPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    if (vi < nvec) {
      const __nv_bfloat16* src =
          vi < na ? p.a + row * p.lda + vi * kVec
                  : p.b + row * p.ldb + (vi - na) * kVec;
      raw[i] = __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    const int prologue = vi < na ? p.prologue_a : p.prologue_b;
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float x = __bfloat162float(h[j]);
      v[i][j] = prologue == kGelu ? gelu_tanh(x) : x;
    }
  }

  if (p.prologue_a == kLnMod) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc += v[i][j];
      }
    }
    const float mean =
        p.center ? __fdiv_rn(block_reduce(acc, scratch, Sum()), static_cast<float>(k))
                 : 0.f;
    acc = 0.f;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          v[i][j] = __fsub_rn(v[i][j], mean);
          acc = __fadd_rn(acc, __fmul_rn(v[i][j], v[i][j]));
        }
      }
    }
    const float var =
        __fdiv_rn(block_reduce(acc, scratch, Sum()), static_cast<float>(k));
    const float r = rsqrtf(__fadd_rn(var, p.eps));
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int vi = threadIdx.x + i * blockDim.x;
      if (vi < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int col = vi * kVec + j;
          v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), __ldg(p.s + col)),
                              __ldg(p.t + col));
        }
      }
    }
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = block_reduce(amax, scratch, Max());
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), p.inv_qmax);
  if (threadIdx.x == 0) p.sx[row] = scale;

#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float q = rintf(__fdiv_rn(v[i][j], scale));
        q = fminf(fmaxf(q, -127.f), 127.f);
        const uint32_t byte = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
        packed[j >> 2] |= byte << ((j & 3) * 8);
      }
      *reinterpret_cast<uint2*>(p.codes + row * k + vi * kVec) =
          make_uint2(packed[0], packed[1]);
    }
  }
}

int launch(const Params& p, int m, cudaStream_t stream) {
  const int k = p.ka + p.kb;
  if (m < 1 || k < kVec || p.ka % kVec != 0 || p.kb % kVec != 0 ||
      p.lda % kVec != 0 || (p.kb > 0 && p.ldb % kVec != 0) ||
      k > kMaxThreads * kVecPerThread * kVec) {
    return kErrUnsupported;
  }
  const int nvec = k / kVec;
  int threads = (nvec + kVecPerThread - 1) / kVecPerThread;
  threads = (threads + 31) / 32 * 32;
  if (p.kb > 0) {
    row_quantize_kernel<true><<<m, threads, 0, stream>>>(p);
  } else {
    row_quantize_kernel<false><<<m, threads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9. x (M, K) bf16 with row stride ldx (elements, a multiple of 8), every
// pointer 16-byte aligned; prologue 0 none, 1 gelu, 2 ln_mod (s, t (K,) f32
// contiguous; null otherwise). center = 1 and inv_qmax = 1/127 give the
// law; the other values exist so that a check can plant a fault.
extern "C" int ldt_row_quantize_fwd(const void* x, const void* s,
                                    const void* t, void* codes, void* sx,
                                    int m, int k, long long ldx, int prologue,
                                    int center, float eps, float inv_qmax,
                                    void* stream) {
  if (prologue < kNone || prologue > kLnMod ||
      (prologue == kLnMod && (s == nullptr || t == nullptr))) {
    return kErrUnsupported;
  }
  Params p{};
  p.a = static_cast<const __nv_bfloat16*>(x);
  p.lda = ldx;
  p.ka = k;
  p.prologue_a = prologue;
  p.prologue_b = kNone;
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.eps = eps;
  p.center = center;
  p.inv_qmax = inv_qmax;
  p.codes = static_cast<int8_t*>(codes);
  p.sx = static_cast<float*>(sx);
  return launch(p, m, static_cast<cudaStream_t>(stream));
}

// K10. Rows [a ; prologue_b(b)]: a (M, ka) bf16 with row stride lda, b the
// window (M, kb) bf16 with row stride ldb (the caller offsets the pointer to
// the window's first lane). prologue_b = 1 (gelu) is the law.
extern "C" int ldt_row_quantize_concat_fwd(const void* a, const void* b,
                                           void* codes, void* sx, int m,
                                           int ka, int kb, long long lda,
                                           long long ldb, int prologue_b,
                                           float inv_qmax, void* stream) {
  if (prologue_b != kNone && prologue_b != kGelu) return kErrUnsupported;
  Params p{};
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.lda = lda;
  p.ldb = ldb;
  p.ka = ka;
  p.kb = kb;
  p.prologue_a = kNone;
  p.prologue_b = prologue_b;
  p.center = 1;
  p.inv_qmax = inv_qmax;
  p.codes = static_cast<int8_t*>(codes);
  p.sx = static_cast<float*>(sx);
  return launch(p, m, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape or option not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
