// K1: attention at small head dims (d <= 64), SD1.5's level-0 self-attention
// at d = 40.
//
// Replaces: lightdiffusion_next_tpu/ops/flash_attention.py
//   packed_flash_attention (pallas_call at :366, kernel body _packed_kernel
//   at :244). That kernel packs floor(128/d) heads into one 128-lane tile
//   through block-diagonal K/V staging, a layout trick for the TPU's matrix
//   unit. The function is plain exact attention per head, and that is what
//   this kernel computes; the packing does not carry over.
//
// Instantiations (flash_attention.cuh has the designs):
//   bf16, d <= 32, 40, 64  flash_wgmma_kernel<32|40|64, 3>
//   f32,  d <= 64          flash_split_kernel<true, 64>
// each after flash_kv_kernel, which lays k and v out as tile images.
//
// What bounds it on an H100: at d = 40 each logit costs 80 multiply-adds
// in the tensor cores but one exp2 in the special-function units, which
// run about 3.9e12 exp2/s against 989e12 bf16 FLOP/s. The unwindowed
// level-0 call (B=2, H=8, L=16384) does 4.3e9 exp2 and 6.9e11 FLOP, so
// the exp units, not the tensor cores or the 84 MB of q/k/v/o, set its
// bound (about 1.1 ms).
//
// What the design does about it: the log2(e)/sqrt(d) scale is folded into
// q once (O(L d)), so every logit needs exactly one ex2.approx and no extra
// multiply; the running max and sum stay in the base-2 domain. S = q k^T
// pads d only to the k16 step (40 -> 48: three wgmma k-steps), and P.V runs
// at N = 40 (V transposed, K-major), so the padded tensor-core work is 1.1x.
// Three consumer warpgroups take turns at the tensor cores, so two run
// their exp2 while the third's products are in flight (flash_attention.cuh;
// 1.2x faster than two at d = 40).
//
// Times on an H100 80GB HBM3 at 700 W (chip_smoke.py, ms per call, the
// prologue included), against the mma.sync design this replaces,
// scaled_dot_product_attention on the same q, k, v, and the bound:
//   (B, H, L, d)          this   mma.sync  library  bound
//   (2, 8, 16384, 40)     1.885  5.475     2.498    1.111
//   (8, 8, 4096, 40)      0.581  1.400     0.615    0.278
//   (2, 8, 4096, 40)      0.156  0.372     0.162    0.070
//   (8, 8, 1024, 40)      0.069  0.103     0.049    0.017
// Two consumers took 2.234 at (2, 8, 16384, 40); without the softmax the
// call takes 1.051 (ablate_attention.py): the exp2 bound it.
#include "flash_attention.cuh"

namespace {

int dispatch(const ldt::Params& p, int dtype, int batch, void* scratch, long long bytes,
             cudaStream_t s) {
  if (p.d < 1 || p.d > 64) return ldt::kErrUnsupported;
  if (dtype == 1) return ldt::launch_split<true, 64>(p, batch, scratch, bytes, s);
  if (dtype != 0) return ldt::kErrUnsupported;
  if (p.d <= 32) return ldt::launch_tiles<32>(p, batch, scratch, bytes, s);
  if (p.d <= 40) return ldt::launch_tiles<40>(p, batch, scratch, bytes, s);
  return ldt::launch_tiles<64>(p, batch, scratch, bytes, s);
}

}  // namespace

extern "C" int ldt_packed_flash_attention_fwd(LDT_FLASH_ARGS) {
  return dispatch(LDT_MAKE_PARAMS, dtype, batch, scratch, scratch_bytes,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* ldt_error_string(int code) { return ldt::error_string(code); }
