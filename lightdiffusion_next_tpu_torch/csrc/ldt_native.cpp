// ldt_native: host C++ under the port's GGUF reader, the Q8_0 block split.
//
// The port's own copy of what it needs of native/ldt_native.cpp (the JAX
// package's host library, built by lightdiffusion_next_tpu/utils/native.py):
// half_to_float and ldt_split_q8_0, the same per-block arithmetic, with the
// blocks shared out among threads. The JAX copy's other entry points have no
// caller in the port (utils/native.py says why for each).
//
// Plain C ABI over caller-owned buffers: no Python API, no allocation. Built
// by utils/native.py with g++ -O3 -shared -fPIC -pthread at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f16 -> f32 (IEEE half): normals, subnormals, inf and nan
inline float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(float));
  return f;
}

void split_range(const uint8_t* blocks, int8_t* q_out, float* scales_out, int64_t b0,
                 int64_t b1) {
  for (int64_t b = b0; b < b1; ++b) {
    const uint8_t* blk = blocks + b * 34;
    uint16_t draw;
    std::memcpy(&draw, blk, 2);
    scales_out[b] = half_to_float(draw);
    std::memcpy(q_out + b * 32, blk + 2, 32);
  }
}

constexpr int64_t kBlocksPerThread = 1 << 16;  // below this a thread costs more than it saves

}  // namespace

extern "C" {

// GGUF Q8_0 blocks (34 bytes each: an f16 scale, then 32 int8 codes) split
// into the codes (n_blocks x 32 int8) and the scales as f32 (n_blocks), over
// at most n_threads threads.
void ldt_split_q8_0(const uint8_t* blocks, int8_t* q_out, float* scales_out, int64_t n_blocks,
                    int64_t n_threads) {
  const int64_t threads =
      std::max<int64_t>(1, std::min<int64_t>(n_threads, n_blocks / kBlocksPerThread));
  if (threads == 1) {
    split_range(blocks, q_out, scales_out, 0, n_blocks);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t per = (n_blocks + threads - 1) / threads;
  for (int64_t t = 0; t < threads; ++t) {
    const int64_t b0 = t * per;
    const int64_t b1 = std::min(b0 + per, n_blocks);
    if (b0 >= b1) break;
    ts.emplace_back(split_range, blocks, q_out, scales_out, b0, b1);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
