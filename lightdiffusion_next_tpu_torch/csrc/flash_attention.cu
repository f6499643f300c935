// K2: attention at any head dim up to 512, ragged lengths masked.
//
// Replaces: lightdiffusion_next_tpu/ops/flash_attention.py flash_attention
//   (pallas_call at :155, kernel body _kernel at :65).
//
// On the SD1.5 path it runs the UNet's level-1 (d = 80) and level-2
// (d = 160) self-attention in bf16, and the VAE mid-block attention: one
// head, d = 512, 16384 tokens, in f32.
//
// Instantiations (flash_attention.cuh has the two designs):
//   bf16, d <= 64                    flash_wgmma_kernel<64, 3>
//   bf16, d <= 80, 96, 128, 160      flash_wgmma_kernel<80|96|128|160, 2>
//   bf16, d <= 256, 512              flash_split_kernel<false, 128|256>
//   f32,  d <= 128, 256, 512         flash_split_kernel<true, 64|128|256>
// each after flash_kv_kernel, which lays k and v out as tile images.
//
// What bounds it on an H100: at d = 80 and d = 160 each logit carries 160
// or 320 multiply-adds against one exp2, so the bf16 tensor cores set the
// bound (about 0.09 ms at (2, 8, 4096, 80), 0.01 ms at (2, 8, 1024, 160)).
// The VAE call's products, kept at f32 precision as three bf16 products
// each (split-bf16), are 1.65e12 FLOP: 1.67 ms at the bf16 rate; its 64 MB
// of hi/lo K and V images are read once per q tile of 64 rows, from L2.
//
// What the design does about it: every product runs on wgmma with the K and
// V tiles bulk-copied by a producer warpgroup, so copies, products and the
// softmax overlap (flash_attention.cuh). At d <= 160 two consumer
// warpgroups take turns at the tensor cores. At d = 512 two consumers split
// the head dim, so S is computed once per (q tile, kv tile) and the 64 x 512
// f32 accumulator fits in registers.
//
// Times on an H100 80GB HBM3 at 700 W (chip_smoke.py, ms per call, the
// prologue included), against the mma.sync design this replaces (which
// recomputed q k^T for four 128-column slices at d = 512),
// scaled_dot_product_attention on the same q, k, v, and the bound:
//   (B, H, L, d) dtype        this   mma.sync  library  bound
//   (2, 8, 4096, 80) bf16     0.242  0.434     0.211    0.087
//   (2, 8, 1024, 160) bf16    0.057  0.081     0.029    0.011
//   (2, 8, 1024, 80) bf16     0.040  0.048     0.020    0.005
//   (1, 1, 16384, 512) f32    3.872  26.92     13.94    0.556
// At d = 80 no single part bounds it (ablate_attention.py: without the
// softmax 0.193, without P.V 0.214, the prologue alone 0.032); at d = 512
// neither the softmax, P.V nor the copies (each 2-5% of the call).
#include "flash_attention.cuh"

namespace {

int launch_f32(const ldt::Params& p, int batch, void* scratch, long long bytes, cudaStream_t s) {
  if (p.d <= 128) return ldt::launch_split<true, 64>(p, batch, scratch, bytes, s);
  if (p.d <= 256) return ldt::launch_split<true, 128>(p, batch, scratch, bytes, s);
  if (p.d <= 512) return ldt::launch_split<true, 256>(p, batch, scratch, bytes, s);
  return ldt::kErrUnsupported;
}

int dispatch(const ldt::Params& p, int dtype, int batch, void* scratch, long long bytes,
             cudaStream_t s) {
  if (p.d < 1) return ldt::kErrUnsupported;
  if (dtype == 1) return launch_f32(p, batch, scratch, bytes, s);
  if (dtype != 0) return ldt::kErrUnsupported;
  if (p.d <= 64) return ldt::launch_tiles<64>(p, batch, scratch, bytes, s);
  if (p.d <= 80) return ldt::launch_tiles<80>(p, batch, scratch, bytes, s);
  if (p.d <= 96) return ldt::launch_tiles<96>(p, batch, scratch, bytes, s);
  if (p.d <= 128) return ldt::launch_tiles<128>(p, batch, scratch, bytes, s);
  if (p.d <= 160) return ldt::launch_tiles<160>(p, batch, scratch, bytes, s);
  if (p.d <= 256) return ldt::launch_split<false, 128>(p, batch, scratch, bytes, s);
  if (p.d <= 512) return ldt::launch_split<false, 256>(p, batch, scratch, bytes, s);
  return ldt::kErrUnsupported;
}

}  // namespace

extern "C" int ldt_flash_attention_fwd(LDT_FLASH_ARGS) {
  return dispatch(LDT_MAKE_PARAMS, dtype, batch, scratch, scratch_bytes,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* ldt_error_string(int code) { return ldt::error_string(code); }
