// K3: Flux's joint attention straight off the fused qkv projection, with
// QKNorm and RoPE as the kernel's prologue.
//
// Replaces: lightdiffusion_next_tpu/ops/flash_attention.py
//   fused_qkv_attention (pallas_call at :619, kernel body _fused_kernel at
//   :438), in its non-interleaved layout.
//
// What it computes, per (batch, head): q, k and v are the 128-lane stripes
// at columns h*128, (H+h)*128 and (2H+h)*128 of the qkv rows (row width W;
// columns past 3*H*128, such as linear1's MLP lanes, are never read). q and
// k go through the prologue in f32: RMS over the 128 lanes, times
// rsqrt(mean + 1e-6), times the txt QKNorm scale for rows < txt_len and the
// img scale otherwise, then the half-split RoPE x*C + x[j +- 64]*S from the
// (L, 128) cos and sin tables; q is then scaled by LOG2E/sqrt(128). Both are
// rounded to bf16, as the TPU kernel rounds them into its VMEM caches. Then
// exact attention with a base-2 online softmax in f32 (flash_attention.cuh),
// p rounded to bf16, and the output written at column h*128 of
// (B, L, H*128).
//
// What bounds it on an H100: at Flux's L = 4352 tokens and 24 heads the two
// products are 4 * L^2 * 128 * 24 = 2.3e11 FLOP, 0.235 ms at the bf16
// tensor-core rate; the L^2 * 24 exp2 take 0.118 ms at 3.86e12/s. It is
// bound by operations; q, k, v and o are 107 MB (0.032 ms).
//
// What the design does about it: the main loop is the d = 128 bf16 loop of
// flash_attention.cuh (mma.sync on the tensor cores, cp.async K and V tiles,
// base-2 softmax with the scale folded into q). k is normed and roped once
// per call, by a first launch (norm_rope_k_kernel), into a (B, H, L, 128)
// bf16 scratch buffer: every q tile reads all of K, so norming K inside
// each kv-tile load would repeat the prologue L / 64 = 68 times. That costs
// one extra write and read of K (27 MB each way at L = 4352, about 0.016 ms
// of bandwidth). q is normed while its tile is staged, once per block. v is
// read in place through its row stride.
#include "flash_attention.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per (batch, row, head)

// kn[b, h, l, :] = bf16(norm_rope(k[b, l, (H + h) * 128 : ...])), for every
// row l < L.
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    norm_rope_k_kernel(const __nv_bfloat16* __restrict__ qkv,
                       __nv_bfloat16* __restrict__ kn,
                       const float* __restrict__ scale_txt,
                       const float* __restrict__ scale_img,
                       const float* __restrict__ cos,
                       const float* __restrict__ sin, int batch, int heads,
                       int l, long long width, int txt_len, float eps) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const long long n = static_cast<long long>(batch) * heads * l;
  if (item >= n) return;  // uniform across the warp
  const int h = static_cast<int>(item % heads);
  const long long bl = item / heads;
  const int row = static_cast<int>(bl % l);
  const int b = static_cast<int>(bl / l);
  const int lane = threadIdx.x & 31;
  float x[4], scale[4], y[4];
  ldt::load_row4(qkv + bl * width + static_cast<long long>(heads + h) * ldt::kRopeDim, x);
  ldt::load_scale4(row < txt_len ? scale_txt : scale_img, scale);
  ldt::norm_rope_row(x, scale, cos + static_cast<long long>(row) * ldt::kRopeDim,
                     sin + static_cast<long long>(row) * ldt::kRopeDim, eps, y);
  uint2 packed;
  packed.x = ldt::pack_bf16(y[0], y[1]);
  packed.y = ldt::pack_bf16(y[2], y[3]);
  __nv_bfloat16* dst =
      kn + ((static_cast<long long>(b) * heads + h) * l + row) * ldt::kRopeDim;
  reinterpret_cast<uint2*>(dst)[lane] = packed;
}

}  // namespace

// qkv (B, L, W) bf16, W >= 3 * heads * 128 and a multiple of 8; out
// (B, L, heads * 128) bf16; k_scratch (B, heads, L, 128) bf16; the four
// QKNorm scales (128,) f32 in the permuted basis; cos and sin (L, 128) f32.
// lk <= L is the number of kv rows attended (L on the main path).
extern "C" int ldt_fused_qkv_attention_fwd(
    const void* qkv, void* out, void* k_scratch, const float* q_scale_img,
    const float* k_scale_img, const float* q_scale_txt,
    const float* k_scale_txt, const float* cos, const float* sin, int batch,
    int heads, int l, int lk, long long width, int txt_len, float eps,
    float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width < 3LL * heads * ldt::kRopeDim || width % 8 != 0 || lk > l ||
      lk < 1) {
    return ldt::kErrUnsupported;
  }
  const long long rows = static_cast<long long>(batch) * heads * l;
  norm_rope_k_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                       kRowsPerBlock * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(k_scratch), k_scale_txt, k_scale_img, cos,
      sin, batch, heads, l, width, txt_len, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  const long long seq = static_cast<long long>(l) * width;
  const long long hd = static_cast<long long>(heads) * ldt::kRopeDim;
  ldt::Params p = ldt::make_params(
      base, k_scratch, base + 2 * hd, out, heads, l, lk, ldt::kRopeDim,
      /*q*/ seq, ldt::kRopeDim, width,
      /*k*/ static_cast<long long>(heads) * l * ldt::kRopeDim,
      static_cast<long long>(l) * ldt::kRopeDim, ldt::kRopeDim,
      /*v*/ seq, ldt::kRopeDim, width,
      /*o*/ static_cast<long long>(l) * hd, ldt::kRopeDim, hd, q_scale, 1);
  p.scale_txt = q_scale_txt;
  p.scale_img = q_scale_img;
  p.cos = cos;
  p.sin = sin;
  p.txt_len = txt_len;
  p.eps = eps;
  return ldt::launch<__nv_bfloat16, ldt::kRopeDim, ldt::kRopeDim, true>(p, batch, s);
}

extern "C" const char* ldt_error_string(int code) {
  return ldt::error_string(code);
}
