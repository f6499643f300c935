// K4: int8 ("sage") attention. Q.K^T and P.V as int8 products on the
// tensor cores, online softmax in f32.
//
// Replaces: lightdiffusion_next_tpu/ops/sage_attention.py sage_attention
//   (pallas_call at :226, kernel body _kernel at :52), in the configuration
//   the dispatch calls: int8_mxu=True, pv_int8=True.
//
// The preparation runs before the kernel, in plain PyTorch
// (ops/sage_attention.py): K and V centred over tokens, Q and K quantized
// per token (f32 scales sq with 1/sqrt(d) folded in, and sk), V per channel
// (scales sv, passed as svs = sv * (1/127)), V's mean added back to the
// output afterwards. The kernel computes, per softmax block of kv tokens,
// in the JAX kernel's order of rounded f32 operations (no FMA contraction):
//   s   = (f32(q8 . k8) * sq_i) * sk_j, -1e30 at columns j >= kv_len
//   m'  = max(m, max_j s), p = exp(s - m'), alpha = exp(m - m')
//   l   = l * alpha + sum_j p
//   acc = acc * alpha + f32(round_half_even(p * 127) . v8) * svs
//   out = acc / l, rounded to bf16.
// P is quantized against the running maximum after the whole block, so the
// block width is part of the result. The kernel takes the JAX kernel's
// width (1024 tokens at SD1.5's lengths; ops/sage_attention.softmax_block)
// as sb_tiles tiles of 64 tokens and visits each block twice: a first pass
// over its tiles takes the row maxima of s, a second recomputes s (int8
// products are cheap here, see below) and does the rest. The sums over the
// block run tile by tile, so they round in another order than the JAX
// kernel's one reduction (last bits of l and acc, not codes).
//
// Operands: qq (B*H, Lq, DP) and kq (B*H, Lk, DP) int8 with d padded by zero
// codes to DP, the next multiple of 32 (the k step of mma m16n8k32); vt
// (B*H, D, Lkp) int8, V transposed (int8 mma takes B K-major and ldmatrix
// does not transpose 8-bit elements), Lk padded with zero codes to a
// multiple of 64, and the tokens of every 32-group stored in the order
// 0,1,8,9, 2,3,10,11, ... (see kPermNote) so that the P fragment built from
// the Q.K^T accumulators in registers matches V's fragment as ldmatrix
// loads it; sq (B*H, Lq), sk (B*H, Lk), svs (B*H, D) f32.
//
// What bounds it on an H100: at SD1.5's head dims it does 4 d int8
// operations and one exp per score: at d = 40, 160 operations at 1979
// TOP/s against one exp at the special-function units' rate (3.86e12/s)
// make exp the bound; the int8 products halve nothing that binds there.
//
// What the design does about it: a simple kernel first. Blocks of 64 q rows
// (4 warps of 16 rows), the warp's Q fragments in registers for the whole
// kv loop, K (and in the second pass V) tiles double-buffered with
// cp.async, P never leaves the registers: the s32 accumulator of Q.K^T
// becomes f32 scores, then int8 codes packed straight into the A fragment
// of the P.V product. The first pass costs Q.K^T's int8 products once more
// and no exp.
//
// kPermNote: a thread of an m16n8 accumulator holds columns 2t, 2t+1 of
// each 8-column tile (t = lane % 4); the A fragment of m16n8k32 s8 wants
// k = 4t..4t+3 (and 16 + 4t..). Packing tiles 0 and 1 of a 32-token group
// gives k = 4t + i the token (2t, 2t+1, 8+2t, 9+2t)[i] (and 16 + the same
// for tiles 2 and 3), which is the order V's tokens are stored in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // kv tokens per tile
constexpr int kThreads = 128;   // 4 warps of 16 q rows
constexpr int kVRow = kBK + 16; // shared row stride of the V tile in bytes
constexpr float kNegInf = -1e30f;
constexpr int kErrUnsupported = 1000;

template <int D>
struct Shape {
  static constexpr int DP = (D + 31) / 32 * 32;  // padded q/k row in bytes
  static constexpr int KRow = DP + 16;           // shared row stride
  static constexpr int KS = DP / 32;             // k steps of Q.K^T
  static constexpr int NT = D / 8;               // n tiles of P.V
};

template <int D>
struct Smem {
  int8_t q[kBQ][Shape<D>::KRow];
  int8_t k[2][kBK][Shape<D>::KRow];
  int8_t v[2][D][kVRow];
  float sk[2][kBK];
  float svs[D];
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d (16x8, s32) += a (16x32, s8, row) * b (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return (static_cast<uint32_t>(c0) & 0xff) |
         ((static_cast<uint32_t>(c1) & 0xff) << 8) |
         ((static_cast<uint32_t>(c2) & 0xff) << 16) |
         ((static_cast<uint32_t>(c3) & 0xff) << 24);
}

// Step `step` of the kv loop: every softmax block of sb tiles is visited
// twice, its tiles in order for the maxima (pass 0), then again (pass 1).
struct Step {
  int tile;   // the kv tile
  int pass;   // 0: maxima, 1: p and P.V
  int first;  // the first tile of its pass in the block
  int last;   // the last tile of its pass in the block
};

__device__ __forceinline__ Step step_at(int step, int sb, int kv_tiles) {
  const int start = step / (2 * sb) * sb;
  const int count = min(sb, kv_tiles - start);
  const int r = step - 2 * start;
  const int pass = r >= count;
  const int pos = pass ? r - count : r;
  return {start + pos, pass, pos == 0, pos == count - 1};
}

// Start the copies of kv tile `tile` into stage `buf` (not committed), V's
// only with `with_v`; the sk tile is stored directly (tokens past lk
// read 1).
template <int D>
__device__ __forceinline__ void load_tile(Smem<D>& sm, int buf, int tile,
                                          bool with_v,
                                          const int8_t* __restrict__ kq,
                                          const int8_t* __restrict__ vt,
                                          const float* __restrict__ sk,
                                          int lk, int lkp) {
  constexpr int DP = Shape<D>::DP;
  const int t0 = tile * kBK;
  for (int c = threadIdx.x; c < kBK * (DP / 16); c += kThreads) {
    const int r = c / (DP / 16);
    const int cc = (c % (DP / 16)) * 16;
    const bool ok = t0 + r < lk;
    const int8_t* src = kq + (ok ? static_cast<long long>(t0 + r) * DP + cc : 0);
    cp_async_16(&sm.k[buf][r][cc], src, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < (with_v ? D * (kBK / 16) : 0); c += kThreads) {
    const int r = c >> 2;
    const int cc = (c & 3) * 16;
    cp_async_16(&sm.v[buf][r][cc], vt + static_cast<long long>(r) * lkp + t0 + cc, 16);
  }
  if (threadIdx.x < kBK) {
    const int tok = t0 + threadIdx.x;
    sm.sk[buf][threadIdx.x] = tok < lk ? sk[tok] : 1.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sage_attention_kernel(const int8_t* __restrict__ qq,
                          const int8_t* __restrict__ kq,
                          const int8_t* __restrict__ vt,
                          const float* __restrict__ sq,
                          const float* __restrict__ sk,
                          const float* __restrict__ svs,
                          __nv_bfloat16* __restrict__ out, int heads, int lq,
                          int lk, long long so_b, long long so_h,
                          long long so_l, int kv_tiles, int sb, int use_sk) {
  constexpr int DP = Shape<D>::DP;
  constexpr int KS = Shape<D>::KS;
  constexpr int NT = Shape<D>::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int lkp = (lk + kBK - 1) / kBK * kBK;
  qq += static_cast<long long>(bh) * lq * DP;
  kq += static_cast<long long>(bh) * lk * DP;
  vt += static_cast<long long>(bh) * D * lkp;
  sq += static_cast<long long>(bh) * lq;
  sk += static_cast<long long>(bh) * lk;
  svs += static_cast<long long>(bh) * D;
  out += static_cast<long long>(bh / heads) * so_b +
         static_cast<long long>(bh % heads) * so_h;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;

  for (int c = threadIdx.x; c < kBQ * (DP / 16); c += kThreads) {
    const int r = c / (DP / 16);
    const int cc = (c % (DP / 16)) * 16;
    const bool ok = q0 + r < lq;
    const int8_t* src = qq + (ok ? static_cast<long long>(q0 + r) * DP + cc : 0);
    cp_async_16(&sm.q[r][cc], src, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < D; c += kThreads) sm.svs[c] = svs[c];
  const int steps = 2 * kv_tiles;
  if (steps > 0) load_tile<D>(sm, 0, 0, false, kq, vt, sk, lk, lkp);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  const float sq0 = row0 < lq ? sq[row0] : 1.f;
  const float sq1 = row0 + 8 < lq ? sq[row0 + 8] : 1.f;
  float m_r[2] = {kNegInf, kNegInf};  // the running maxima
  float mb[2] = {kNegInf, kNegInf};   // the maxima of the block's pass 0
  float l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KS][4];

  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    cp_async_wait_all();
    __syncthreads();  // step st's tile (and Q) landed; st - 1's reads are done
    if (st == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldmatrix_x4(qf[ks], smem_addr(&sm.q[warp * 16 + (lane & 15)][ks * 32 + (lane >> 4) * 16]));
      }
    }
    if (st + 1 < steps) {
      const Step nx = step_at(st + 1, sb, kv_tiles);
      load_tile<D>(sm, buf ^ 1, nx.tile, nx.pass == 1, kq, vt, sk, lk, lkp);
    }
    cp_async_commit();
    const Step cur = step_at(st, sb, kv_tiles);
    const int t = cur.tile;

    // s = q8 . k8 over the tile's 64 tokens: 8 tiles of 8 columns
    int s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        const int row = nj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int col = ks * 32 + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(bf, smem_addr(&sm.k[buf][row][col]));
        mma_s8(s[2 * nj], qf[ks], bf[0], bf[1]);
        mma_s8(s[2 * nj + 1], qf[ks], bf[2], bf[3]);
      }
    }

    // scores, masked past kv_len; the tile's row maxima
    float f[8][4];
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);
        const float skv = use_sk ? sm.sk[buf][c] : 1.f;
        const float v = __fmul_rn(__fmul_rn(__int2float_rn(s[j][e]), e < 2 ? sq0 : sq1), skv);
        f[j][e] = t * kBK + c < lk ? v : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(f[j][0], f[j][1]));
      mx1 = fmaxf(mx1, fmaxf(f[j][2], f[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    if (cur.pass == 0) {
      mb[0] = cur.first ? mx0 : fmaxf(mb[0], mx0);
      mb[1] = cur.first ? mx1 : fmaxf(mb[1], mx1);
      if (cur.last) {  // the block's m', alpha: rescale l and acc once
        const float mn0 = fmaxf(m_r[0], mb[0]), mn1 = fmaxf(m_r[1], mb[1]);
        const float al0 = expf(__fsub_rn(m_r[0], mn0)), al1 = expf(__fsub_rn(m_r[1], mn1));
        m_r[0] = mn0;
        m_r[1] = mn1;
        l_r[0] = __fmul_rn(l_r[0], al0);
        l_r[1] = __fmul_rn(l_r[1], al1);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][0] = __fmul_rn(acc[j][0], al0);
          acc[j][1] = __fmul_rn(acc[j][1], al0);
          acc[j][2] = __fmul_rn(acc[j][2], al1);
          acc[j][3] = __fmul_rn(acc[j][3], al1);
        }
      }
      continue;
    }
    const float mn0 = m_r[0], mn1 = m_r[1];

    // p = exp(s - m'), its row sums, and its codes round(p * 127) packed
    // into the A fragments of the two 32-token k steps of P.V
    int pc[8][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(f[j][e], e < 2 ? mn0 : mn1));
        if (e < 2) sum0 = __fadd_rn(sum0, p); else sum1 = __fadd_rn(sum1, p);
        pc[j][e] = static_cast<int>(rintf(__fmul_rn(p, 127.f)));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, o));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, o));
    }
    l_r[0] = __fadd_rn(l_r[0], sum0);
    l_r[1] = __fadd_rn(l_r[1], sum1);
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int j = 4 * kk;
      pa[kk][0] = pack4(pc[j][0], pc[j][1], pc[j + 1][0], pc[j + 1][1]);
      pa[kk][1] = pack4(pc[j][2], pc[j][3], pc[j + 1][2], pc[j + 1][3]);
      pa[kk][2] = pack4(pc[j + 2][0], pc[j + 2][1], pc[j + 3][0], pc[j + 3][1]);
      pa[kk][3] = pack4(pc[j + 2][2], pc[j + 2][3], pc[j + 3][2], pc[j + 3][3]);
    }

    // acc += f32(p8 . v8) * svs, 8 output columns at a time
#pragma unroll
    for (int jn = 0; jn < NT; jn += 2) {
      int pv[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      const bool pair = jn + 1 < NT;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int col = kk * 32 + ((lane >> 3) & 1) * 16;
        if (pair) {
          uint32_t bf[4];
          const int row = jn * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
          ldmatrix_x4(bf, smem_addr(&sm.v[buf][row][col]));
          mma_s8(pv[0], pa[kk], bf[0], bf[1]);
          mma_s8(pv[1], pa[kk], bf[2], bf[3]);
        } else {
          uint32_t b0, b1;
          ldmatrix_x2(b0, b1, smem_addr(&sm.v[buf][jn * 8 + (lane & 7)][col]));
          mma_s8(pv[0], pa[kk], b0, b1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !pair) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = sm.svs[(jn + h) * 8 + 2 * tq + (e & 1)];
          acc[jn + h][e] = __fadd_rn(acc[jn + h][e], __fmul_rn(__int2float_rn(pv[h][e]), sv));
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int col = jn * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row >= lq) continue;
      const float v0 = __fdiv_rn(acc[jn][2 * half], l_r[half]);
      const float v1 = __fdiv_rn(acc[jn][2 * half + 1], l_r[half]);
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * so_l + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int D>
int launch(const void* qq, const void* kq, const void* vt, const void* sq,
           const void* sk, const void* svs, void* out, int batch, int heads,
           int lq, int lk, long long so_b, long long so_h, long long so_l,
           int kv_tiles, int sb, int use_sk, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<D>));
  auto kernel = sage_attention_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((lq + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vt), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(svs),
      static_cast<__nv_bfloat16*>(out), heads, lq, lk, so_b, so_h, so_l,
      kv_tiles, sb, use_sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 on prepared operands (see the header); out (B, H, Lq, D) bf16 through
// its (b, h, l) strides (even, the D elements of a row contiguous). kv_tiles
// is the number of 64-token kv tiles summed (ceil(Lk / 64) unless a check
// plants a fault), sb the softmax block in tiles; use_sk 0 drops sk (a
// planted fault). Head dims 32, 40, 64, 80, 128, 160.
extern "C" int ldt_sage_attention_fwd(const void* qq, const void* kq,
                                      const void* vt, const void* sq,
                                      const void* sk, const void* svs,
                                      void* out, int batch, int heads, int lq,
                                      int lk, int d, long long so_b,
                                      long long so_h, long long so_l,
                                      int kv_tiles, int sb, int use_sk,
                                      void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch * heads > 65535 ||
      sb < 1 ||
      kv_tiles < 0 || kv_tiles > (lk + kBK - 1) / kBK || so_b % 2 || so_h % 2 ||
      so_l % 2) {
    return kErrUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDT_SAGE_CASE(DIM)                                                     \
  case DIM:                                                                    \
    return launch<DIM>(qq, kq, vt, sq, sk, svs, out, batch, heads, lq, lk,     \
                       so_b, so_h, so_l, kv_tiles, sb, use_sk, s);
  switch (d) {
    LDT_SAGE_CASE(32)
    LDT_SAGE_CASE(40)
    LDT_SAGE_CASE(64)
    LDT_SAGE_CASE(80)
    LDT_SAGE_CASE(128)
    LDT_SAGE_CASE(160)
    default:
      return kErrUnsupported;
  }
#undef LDT_SAGE_CASE
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
