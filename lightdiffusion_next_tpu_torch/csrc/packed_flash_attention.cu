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
// What bounds it on an H100: at d = 40 each logit costs 80 multiply-adds
// in the tensor cores but one exp2 in the special-function units, which
// run about 3.9e12 exp2/s against 989e12 bf16 FLOP/s. The unwindowed
// level-0 call (B=2, H=8, L=16384) does 4.3e9 exp2 and 6.9e11 FLOP, so
// the exp units, not the tensor cores or the 84 MB of q/k/v/o, set its
// bound (about 1.1 ms).
//
// What the design does about it: the log2(e)/sqrt(d) scale is folded into
// q once (O(L d)), so every logit needs exactly one ex2.approx and no extra
// multiply; the running max and sum stay in the base-2 domain. The head dim
// pads only to the mma k-step of 16 (40 -> 48, not 64), inside shared
// memory, so the padded tensor-core work is 1.2x and not 1.6x. See
// flash_attention.cuh for the tiling.
#include "flash_attention.cuh"

namespace {

struct Dispatch {
  template <typename T>
  int operator()(const ldt::Params& p, int batch, cudaStream_t s) const {
    if (p.d <= 16) return ldt::launch<T, 16, 16>(p, batch, s);
    if (p.d <= 32) return ldt::launch<T, 32, 32>(p, batch, s);
    if (p.d <= 48) return ldt::launch<T, 48, 48>(p, batch, s);
    if (p.d <= 64) return ldt::launch<T, 64, 64>(p, batch, s);
    return ldt::kErrUnsupported;
  }
};

}  // namespace

extern "C" int ldt_packed_flash_attention_fwd(LDT_FLASH_ARGS) {
  return ldt::run(LDT_MAKE_PARAMS, dtype, batch, scratch,
                  static_cast<cudaStream_t>(stream), Dispatch{});
}

extern "C" const char* ldt_error_string(int code) {
  return ldt::error_string(code);
}
