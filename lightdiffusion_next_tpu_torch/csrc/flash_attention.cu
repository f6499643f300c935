// K2: attention at any head dim up to 512, ragged lengths masked.
//
// Replaces: lightdiffusion_next_tpu/ops/flash_attention.py flash_attention
//   (pallas_call at :155, kernel body _kernel at :65).
//
// On the SD1.5 path it runs the UNet's level-1 (d = 80) and level-2
// (d = 160) self-attention in bf16, and the VAE mid-block attention: one
// head, d = 512, 16384 tokens, in f32.
//
// What bounds it on an H100: at d = 80 and d = 160 each logit carries 160
// or 320 multiply-adds, so the bf16 tensor cores set the bound (about
// 0.09 ms and 0.01 ms at the UNet's shapes). At d = 512 the f32 accumulator
// of a 64-row q tile (64 x 512 x 4 bytes) does not fit in registers, and
// the work (5.5e11 FLOP) is again tensor-core bound (about 0.56 ms at the
// bf16 rate).
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate). f32 inputs keep f32
// products, as the JAX kernel computes them: each operand is split into
// bf16 hi and lo halves and each product is three mma (hi*hi + hi*lo +
// lo*hi), about 16 mantissa bits; q is split while its tile is staged, k
// and v once per call into a scratch buffer of four bf16 arrays (each of
// the 1024 blocks of the VAE call then reads 32 MB of bf16 halves, which
// stay in L2, instead of f32 it converts again), p in registers. That
// triples the VAE call's tensor-core work, the price of the JAX semantics.
// Softmax state and both accumulations stay f32. Above d = 160 a block
// computes a slice of 128 output columns and recomputes q k^T over the full
// head dim, so the accumulator stays at 64 registers a thread; at d = 512
// that repeats q k^T four times (2.5x the minimal FLOP), which is the price
// of this simple design. The 16384^2 logits are never formed. See
// flash_attention.cuh for the tiling.
#include "flash_attention.cuh"

namespace {

struct Dispatch {
  template <typename T>
  int operator()(const ldt::Params& p, int batch, cudaStream_t s) const {
    if (p.d <= 64) return ldt::launch<T, 64, 64>(p, batch, s);
    if (p.d <= 80) return ldt::launch<T, 80, 80>(p, batch, s);
    if (p.d <= 96) return ldt::launch<T, 96, 96>(p, batch, s);
    if (p.d <= 128) return ldt::launch<T, 128, 128>(p, batch, s);
    if (p.d <= 160) return ldt::launch<T, 160, 160>(p, batch, s);
    if (p.d <= 256) return ldt::launch<T, 256, 128>(p, batch, s);
    if (p.d <= 512) return ldt::launch<T, 512, 128>(p, batch, s);
    return ldt::kErrUnsupported;
  }
};

}  // namespace

extern "C" int ldt_flash_attention_fwd(LDT_FLASH_ARGS) {
  return ldt::run(LDT_MAKE_PARAMS, dtype, batch, scratch,
                  static_cast<cudaStream_t>(stream), Dispatch{});
}

extern "C" const char* ldt_error_string(int code) {
  return ldt::error_string(code);
}
