// K5: x (M, K) bf16 times a Q8_0 weight, out (M, N) bf16; K6: the same
// on block idx of a stack of D Q8_0 weights.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py _quant_matmul_2d
//   (K5, pallas_call at :360, kernel body _kernel at :39; the opt-in
//   weight-stationary grid at :319 computes the same function) and
//   _quant_matmul_stacked_2d (K6, pallas_call at :497, body
//   _kernel_stacked at :134, which takes the block through scalar
//   prefetch). K6 is K5's kernel instantiated with STACKED: the block's
//   codes and scales are read in place from the (D, K, N) and (D, K/32, N)
//   stacks at 64-bit offsets (block 37 of the single blocks' linear1 stack
//   starts 2.4e9 bytes in), never copied out.
//
// The weight is stored transposed, as on the TPU: codes qt int8 (K, N) and
// scales_t f32 (K/32, N), one scale per 32 consecutive K rows of a column.
// Each weight element is dequantized as f32(q) * scale, rounded to nearest
// even bf16 (the Pallas kernel's _dequant for a bf16 x), so the kernel's
// weights equal the plain version's bit for bit; the products accumulate in
// f32 and the result is rounded to bf16.
//
// What bounds it on an H100: 2 M K N FLOP against 2 M K + K N + 4 K N / 32 +
// 2 M N bytes. At the Flux DiT's shapes (M = 4096 or 4352 image/joint rows)
// and T5-XXL's (M = 256) every call is bound by operations at the bf16
// tensor-core rate (989 TFLOP/s): linear1 (4352, 3072, 21504) 0.581 ms,
// img qkv (4096, 3072, 9216) 0.235 ms, txt qkv (256, 3072, 9216) 0.0147 ms.
//
// What the design does about it: tiles of BM x 128 outputs per block, 8
// warps of m16n8 mma tiles each: BM = 256 for M > 2048 (warp tiles of
// 64 x 64), so each dequantized weight tile feeds twice the products,
// BM = 128 (64 x 32) up to M = 2048, and 64 (32 x 32) for M <= 1024 so
// small-M calls still fill the 132 SMs. K steps of 64 rows, i.e. two whole scale rows, so
// a step needs no partial scale. Each step copies the x tile (bf16), the
// int8 code tile and its two f32 scale rows into shared memory with
// cp.async, double-buffered so step t + 1's copies run under step t's work;
// the codes are then dequantized once per block into a bf16 tile (1 byte
// per weight read from device memory, never a bf16 weight), and the
// products run on the tensor cores with ldmatrix(.trans) and mma.sync
// m16n8k16 (bf16 in, f32 accumulate). Blocks walk M fastest, so the blocks
// in flight share their weight tiles through L2 and the weight streams from
// device memory about once. Rows past M are zero-filled by the copy (src
// size 0) and not stored: ragged M needs no padding copy. K must be a
// multiple of 64 and N of 128 (ops/quant_matmul.supported asks for 256 and
// 128, as the JAX package does).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;    // K rows per step: two Q8_0 scale rows
constexpr int kBN = 128;   // output columns per block
constexpr int kQBlock = 32;
constexpr int kPad = 8;     // bf16 row padding: distinct ldmatrix banks
constexpr int kErrUnsupported = 1000;

template <int BM>
struct Smem {
  __nv_bfloat16 x[2][BM][kBK + kPad];
  int8_t q[2][kBK][kBN];
  float s[2][kBK / kQBlock][kBN];
  __nv_bfloat16 w[kBK][kBN + kPad];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the copies of K step `step` into buffer `buf`; kThreads threads.
template <int BM, int kThreads>
__device__ __forceinline__ void load_step(Smem<BM>& sm, int buf, int step,
                                          const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ qt,
                                          const float* __restrict__ scales,
                                          int m, int n, long long lda, int m0,
                                          int n0) {
  const int k0 = step * kBK;
  // x: BM rows x 64 bf16 = 8 chunks of 16 bytes a row
  for (int c = threadIdx.x; c < BM * (kBK / 8); c += kThreads) {
    const int r = c >> 3;
    const int cc = (c & 7) * 8;
    const bool ok = m0 + r < m;
    const __nv_bfloat16* src =
        x + (ok ? static_cast<long long>(m0 + r) * lda + k0 + cc : 0);
    cp_async_16(&sm.x[buf][r][cc], src, ok ? 16 : 0);
  }
  // codes: 64 rows x 128 int8 = 8 chunks a row
  for (int c = threadIdx.x; c < kBK * (kBN / 16); c += kThreads) {
    const int r = c >> 3;
    const int cc = (c & 7) * 16;
    cp_async_16(&sm.q[buf][r][cc],
                qt + static_cast<long long>(k0 + r) * n + n0 + cc, 16);
  }
  // scales: 2 rows x 128 f32 = 32 chunks a row
  if (threadIdx.x < (kBK / kQBlock) * (kBN / 4)) {
    const int r = threadIdx.x >> 5;
    const int cc = (threadIdx.x & 31) * 4;
    cp_async_16(&sm.s[buf][r][cc],
                scales + static_cast<long long>(k0 / kQBlock + r) * n + n0 + cc,
                16);
  }
  cp_async_commit();
}

// codes and scales of buffer `buf` -> the bf16 weight tile, 16 per item
template <int BM, int kThreads>
__device__ __forceinline__ void dequant_step(Smem<BM>& sm, int buf) {
  for (int i = threadIdx.x; i < kBK * (kBN / 16); i += kThreads) {
    const int r = i >> 3;
    const int c0 = (i & 7) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(&sm.q[buf][r][c0]);
    const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
    const float* sc = &sm.s[buf][r / kQBlock][c0];
    uint32_t out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[j] = pack_bf16(static_cast<float>(codes[2 * j]) * sc[2 * j],
                         static_cast<float>(codes[2 * j + 1]) * sc[2 * j + 1]);
    }
    uint4* dst = reinterpret_cast<uint4*>(&sm.w[r][c0]);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// BM rows x 128 columns per block of WARPS_M x WARPS_N warps, each warp
// BM / WARPS_M rows x 128 / WARPS_N columns.
// STACKED: qt and scales are stacks; block idx starts q_block codes and
// s_block scales in.
template <int BM, int WARPS_M, int WARPS_N, bool STACKED>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ qt,
                        const float* __restrict__ scales,
                        __nv_bfloat16* __restrict__ out, int m, int n, int k,
                        long long lda, long long q_block, long long s_block,
                        int idx) {
  if (STACKED) {
    qt += static_cast<long long>(idx) * q_block;
    scales += static_cast<long long>(idx) * s_block;
  }
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;   // warp tile rows
  constexpr int WN = kBN / WARPS_N;  // warp tile columns
  constexpr int MI = WM / 16;        // m16 tiles per warp
  constexpr int NJ = WN / 16;        // n16 column pairs per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BM>& sm = *reinterpret_cast<Smem<BM>*>(smem_raw);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;

  float acc[MI][2 * NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int steps = k / kBK;
  load_step<BM, kThreads>(sm, 0, 0, x, qt, scales, m, n, lda, m0, n0);
  const uint32_t w_base = smem_addr(&sm.w[0][0]);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    cp_async_wait_all();
    __syncthreads();  // step t has landed; step t - 1's reads are done
    if (t + 1 < steps) {
      load_step<BM, kThreads>(sm, buf ^ 1, t + 1, x, qt, scales, m, n, lda, m0, n0);
    }
    dequant_step<BM, kThreads>(sm, buf);
    __syncthreads();
    const uint32_t x_base = smem_addr(&sm.x[buf][0][0]);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm + mi * 16 + (lane & 15);
        const int col = ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], x_base + (row * (kBK + kPad) + col) * 2);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        uint32_t b[4];
        const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, w_base + (row * (kBN + kPad) + col) * 2);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) {
      const int col = n0 + wn + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + (lane >> 2) + half * 8;
        if (row < m) {
          *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * n + col) =
              pack_bf16(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
        }
      }
    }
  }
}

template <int BM, int WARPS_M, int WARPS_N, bool STACKED>
int launch(const __nv_bfloat16* x, const int8_t* qt, const float* scales,
           __nv_bfloat16* out, int m, int n, int k, long long lda,
           long long q_block, long long s_block, int idx, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<BM>));
  auto kernel = quant_matmul_kernel<BM, WARPS_M, WARPS_N, STACKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((m + BM - 1) / BM, n / kBN);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
      x, qt, scales, out, m, n, k, lda, q_block, s_block, idx);
  return static_cast<int>(cudaGetLastError());
}

template <bool STACKED>
int dispatch(const void* x, const void* qt, const void* scales, void* out,
             int m, int n, int k, long long lda, long long q_block,
             long long s_block, int idx, void* stream) {
  if (m < 1 || n < kBN || n % kBN != 0 || k < kBK || k % kBK != 0 ||
      lda < k || lda % 8 != 0) {
    return kErrUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const int8_t*>(qt);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (m <= 1024) {
    return launch<64, 2, 4, STACKED>(xb, q, sc, o, m, n, k, lda, q_block,
                                     s_block, idx, s);
  }
  if (m <= 2048) {
    return launch<128, 2, 4, STACKED>(xb, q, sc, o, m, n, k, lda, q_block,
                                      s_block, idx, s);
  }
  return launch<256, 4, 2, STACKED>(xb, q, sc, o, m, n, k, lda, q_block,
                                    s_block, idx, s);
}

}  // namespace

// K5. x (M, K) bf16 with row stride lda (elements, a multiple of 8), qt
// (K, N) int8 and scales (K/32, N) f32 contiguous, out (M, N) bf16
// contiguous. Every pointer 16-byte aligned. ``k`` is the number of K rows
// summed (K unless a check plants a fault).
extern "C" int ldt_quant_matmul_fwd(const void* x, const void* qt,
                                    const void* scales, void* out, int m,
                                    int n, int k, long long lda,
                                    void* stream) {
  return dispatch<false>(x, qt, scales, out, m, n, k, lda, 0, 0, 0, stream);
}

// K6. As K5 on block idx (0 <= idx < depth) of qt3 (depth, K, N) int8 and
// scales3 (depth, K/32, N) f32, both contiguous, with x contiguous: lda is
// the blocks' K, from which the block strides follow (k <= K rows summed).
extern "C" int ldt_quant_matmul_stacked_fwd(const void* x, const void* qt3,
                                            const void* scales3, void* out,
                                            int m, int n, int k, long long lda,
                                            int depth, int idx, void* stream) {
  if (idx < 0 || idx >= depth || lda % kQBlock != 0) return kErrUnsupported;
  const long long q_block = lda * static_cast<long long>(n);
  return dispatch<true>(x, qt3, scales3, out, m, n, k, lda, q_block,
                        q_block / kQBlock, idx, stream);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
