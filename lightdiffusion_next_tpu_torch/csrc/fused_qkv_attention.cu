// K3: Flux's joint attention straight off the fused qkv projection, with
// QKNorm and RoPE as the kernel's prologue.
//
// Replaces: lightdiffusion_next_tpu/ops/flash_attention.py
//   fused_qkv_attention (pallas_call at :619, kernel body _fused_kernel at
//   :438), in both of its layouts (the flag `interleaved`, :557, index maps
//   :610-617).
//
// What it computes, per (batch, head): q, k and v are the 128-lane stripes
// at columns h*128, (H+h)*128 and (2H+h)*128 of the qkv rows (row width W;
// columns past 3*H*128, such as linear1's MLP lanes, are never read), or,
// with `interleaved` set (the tensor-parallel layout, whose rows are
// head-major [q_h0 | k_h0 | v_h0 | q_h1 | ...]: each rank holds whole
// heads), at columns 3h*128, (3h+1)*128 and (3h+2)*128. The output is
// head-major either way. q and
// k go through the prologue in f32: RMS over the 128 lanes, times
// rsqrt(mean + 1e-6), times the txt QKNorm scale for rows < txt_len and the
// img scale otherwise, then the half-split RoPE x*C + x[j +- 64]*S from the
// (L, 128) cos and sin tables; q is then scaled by LOG2E/sqrt(128). Both are
// rounded to bf16, as the TPU kernel rounds them into its VMEM caches. Then
// exact attention: f32 logits in the base-2 domain, kv columns >= lk masked
// to -1e30, an online softmax with exp2 and f32 running max, sum and
// accumulator, p rounded to bf16 for P.V, and the output acc / l rounded to
// bf16 at column h*128 of (B, L, H*128).
//
// What bounds it on an H100: at Flux's L = 4352 tokens and 24 heads the two
// products are 4 * L^2 * 128 * 24 = 2.3e11 FLOP, 0.235 ms at the bf16
// tensor-core rate; the L^2 * 24 exp2 take 0.118 ms at 3.86e12/s. It is
// bound by operations; q, k, v and o are 107 MB (0.032 ms).
//
// What the design does about it: both products run on wgmma (m64nNk16,
// bf16 in, f32 accumulators in registers), the only way to Hopper's full
// tensor-core rate; the K and V tiles arrive by bulk copy (the TMA without
// a tensor map) issued by one producer thread, so the consumers spend no
// instruction on copies; and the softmax runs while products are in flight.
// - A first launch (norm_rope_kv_kernel) writes k, normed and roped, and v
//   into a scratch of kv tiles of 128 rows, each tile the exact image of its
//   shared-memory stage: a K image then a V image, each [2 blocks of 64 d
//   columns][128 rows][128 bytes] with the 128-byte swizzle (chunk c of row
//   r at c ^ (r & 7)), rows past L zero. Every q tile reads all of K and V,
//   so norming K inside each tile load would repeat the prologue L / 128
//   times; laid out once, each stage is two contiguous 32 KB bulk copies.
//   This costs one extra write and read of v beside k's (0.048 ms of the
//   0.515 ms call at L = 4352, ablate_attention.py).
// - A block is two consumer warpgroups of 64 q rows each and one producer
//   warpgroup, which gives back its registers (setmaxnreg: 24 + 2 x 240 of
//   the 512 per lane of an SM sub-partition) so a consumer holds o, s and p
//   without spilling. One producer thread walks the kv tiles through a ring
//   of three stages: it waits for the stage's "empty" mbarrier (every
//   consumer thread arrives once its products on the stage have finished),
//   arms the stage's "full" mbarrier with the tile's bytes and issues the
//   copies. Consumers wait on "full" only: no block-wide barrier in the loop.
// - The consumers take turns at the tensor cores (named barriers, warpgroup
//   0 first): one issues its products of a tile while the other runs its
//   softmax. Within a warpgroup, tile t's s = q k^T is issued together with
//   tile t - 1's o += p v, and tile t's softmax runs while the latter is in
//   flight; tile t - 1's stage is released after it.
// - S = q k^T takes the q tile and the K image from shared memory, both
//   K-major (d-contiguous) with the 128-byte swizzle, 8-row atoms 1024 bytes
//   apart. O += P V takes P from registers (the S accumulator's fragment,
//   rounded to bf16 pairs, is wgmma's register-A layout) and the V image as
//   an N-major B read with tnspB = 1 (descriptor leading offset = the
//   64-column block stride, stride offset = the 1024-byte stride of 8-row
//   atoms, as K5's weight tile).
// - q is normed and roped while its tile is staged, once per block, by its
//   own warpgroup, and written swizzled for wgmma.
//
// Times on an H100 80GB HBM3 at 700 W (ablate_attention.py, ms per call,
// the k and v prologue included), against the mma.sync design this
// replaces (about 1.3 at L = 4352), scaled_dot_product_attention on q and k
// normed beforehand, and the bound:
//   (L, width, txt_len)   this   one consumer  library  bound
//   (4352, 21504, 0)      0.515  0.715         0.400    0.235
//   (1280, 9216, 256)     0.080  0.120         0.041    0.020
// Without the softmax the call takes 0.455, without P.V 0.433, without the
// copies 0.519: no one part bounds it. Simpler designs tried first were
// slower (PERF.md): cp.async with every thread copying and a block-wide
// barrier per tile, and the producer without the turns. Left for later: the
// k and v prologue folded into the main launch (TMA tensor maps for v), and
// a persistent grid (816 blocks are 6.2 waves at L = 4352).
#include "softmax_tile.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;            // the head dim: one 128-lane stripe
constexpr int kBN = 128;           // kv rows per tile
constexpr int kTileElems = kBN * kD;          // one K or V image
constexpr int kTileBytes = kTileElems * 2;
constexpr int kErrUnsupported = 1000;
constexpr int kRowsPerBlock = 8;   // norm_rope_kv_kernel: one warp per row

struct Params {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* kv;   // (B, H, tiles, 2, 128 x 128): the tile images
  __nv_bfloat16* out;
  const float* scale_txt;    // q's QKNorm scales for rows < txt_len
  const float* scale_img;    //   and for the other rows
  const float* cos;          // (L, 128) f32
  const float* sin;
  long long width;           // qkv's row stride
  int heads, l, lk, txt_len, tiles;
  int interleaved;           // q, k, v of head h at 128-lane blocks 3h, 3h+1, 3h+2
  float eps, q_scale;
};

// A block of WGS consumer warpgroups (BM = 64 WGS q rows; two on the main
// path) and one producer warpgroup, with a ring of kStages K/V stages.
// Shared memory: the q tile, the stages (K image, V image), each on
// 1024-byte atoms, then the full and empty mbarriers.
constexpr int kStages = 3;  // tile t - 1's V is read while tile t + 1 lands

template <int WGS>
struct Cfg {
  static constexpr int kConsumers = WGS * 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int BM = WGS * 64;
  static constexpr int kQBytes = BM * kD * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBar = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBar + 2 * kStages * 8 + kAtom;  // + alignment
};

// Byte offset of the 8 bytes of columns 4 lane .. 4 lane + 3 of row r in a
// 128-byte-swizzled K-major image of `rows` rows: column block lane / 16,
// 16-byte chunk (lane % 16) / 2, its half lane % 2.
__device__ __forceinline__ int swizzled8(int r, int rows, int lane) {
  return (lane >> 4) * (rows * 128) + r * 128 + ((((lane & 15) >> 1) ^ (r & 7)) << 4) +
         (lane & 1) * 8;
}

// One 128-lane row of a Flux q or k head, normed and roped in f32: each
// lane holds columns 4*lane .. 4*lane+3 of x and gets the same columns of
//   y = (x * rsqrt(mean(x^2) + eps) * scale) * C + partner * S
// where partner is the normed, scaled value at column j +- 64 (held by lane
// lane ^ 16) and C, S are the row of the half-split cos and sin tables.
__device__ __forceinline__ void norm_rope_row(const float (&x)[4],
                                              const float (&scale)[4],
                                              const float* __restrict__ cos_row,
                                              const float* __restrict__ sin_row,
                                              float eps, float (&y)[4]) {
  const int lane = threadIdx.x & 31;
  float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss * (1.0f / kD) + eps);
  const float4 c = reinterpret_cast<const float4*>(cos_row)[lane];
  const float4 s = reinterpret_cast<const float4*>(sin_row)[lane];
  const float cc[4] = {c.x, c.y, c.z, c.w};
  const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float xn = x[j] * inv * scale[j];
    const float partner = __shfl_xor_sync(0xffffffffu, xn, 16);
    y[j] = xn * cc[j] + partner * sc[j];
  }
}

__device__ __forceinline__ void load_row4(const __nv_bfloat16* __restrict__ g,
                                          float (&x)[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[threadIdx.x & 31];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void load_scale4(const float* __restrict__ s,
                                            float (&x)[4]) {
  const float4 v = reinterpret_cast<const float4*>(s)[threadIdx.x & 31];
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// 128-lane block of head h's q (part 0), k (1) or v (2) stripe in a qkv row
__device__ __forceinline__ long long stripe(int part, int h, int heads, int interleaved) {
  return static_cast<long long>(interleaved ? 3 * h + part : part * heads + h) * kD;
}

// The tile images: for every (b, h) and every row l of its tiles' padded
// rows, K's row l = bf16(norm_rope(k[b, l, stripe(1, h) : ...])) and V's
// row l = v[b, l, stripe(2, h) : ...], both zero past L.
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    norm_rope_kv_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ kv,
                        const float* __restrict__ scale_txt,
                        const float* __restrict__ scale_img,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, int batch, int heads,
                        int l, int tiles, long long width, int txt_len,
                        int interleaved, float eps) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const long long padded = static_cast<long long>(tiles) * kBN;
  if (item >= batch * heads * padded) return;  // uniform across the warp
  const int h = static_cast<int>(item % heads);
  const long long bl = item / heads;
  const int row = static_cast<int>(bl % padded);
  const int b = static_cast<int>(bl / padded);
  const int lane = threadIdx.x & 31;
  uint2 k8 = make_uint2(0u, 0u), v8 = make_uint2(0u, 0u);
  if (row < l) {  // uniform across the warp
    const __nv_bfloat16* src = qkv + (static_cast<long long>(b) * l + row) * width;
    float x[4], scale[4], y[4];
    load_row4(src + stripe(1, h, heads, interleaved), x);
    load_scale4(row < txt_len ? scale_txt : scale_img, scale);
    norm_rope_row(x, scale, cos + static_cast<long long>(row) * kD,
                  sin + static_cast<long long>(row) * kD, eps, y);
    k8.x = pack_bf16(y[0], y[1]);
    k8.y = pack_bf16(y[2], y[3]);
    v8 = reinterpret_cast<const uint2*>(src + stripe(2, h, heads, interleaved))[lane];
  }
  unsigned char* tile = reinterpret_cast<unsigned char*>(
      kv + ((static_cast<long long>(b) * heads + h) * tiles + row / kBN) * 2 * kTileElems);
  const int at = swizzled8(row % kBN, kBN, lane);
  *reinterpret_cast<uint2*>(tile + at) = k8;
  *reinterpret_cast<uint2*>(tile + kTileBytes + at) = v8;
}

// Stage the block's q tile: each consumer warp norms, ropes and scales its
// own 16 rows, one row per step, and writes them K-major with the 128-byte
// swizzle. Rows past L are zero.
template <class C>
__device__ __forceinline__ void stage_q(unsigned char* smem,
                                        const __nv_bfloat16* __restrict__ gq,
                                        const Params& p, int q0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float s_img[4], s_txt[4];
  load_scale4(p.scale_img, s_img);
  load_scale4(p.scale_txt, s_txt);
#pragma unroll 4
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = q0 + r;
    uint2 packed = make_uint2(0u, 0u);
    if (row < p.l) {  // uniform across the warp
      float x[4], y[4], sc[4];
      load_row4(gq + static_cast<long long>(row) * p.width, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = row < p.txt_len ? s_txt[j] : s_img[j];
      norm_rope_row(x, sc, p.cos + static_cast<long long>(row) * kD,
                    p.sin + static_cast<long long>(row) * kD, p.eps, y);
      packed.x = pack_bf16(y[0] * p.q_scale, y[1] * p.q_scale);
      packed.y = pack_bf16(y[2] * p.q_scale, y[3] * p.q_scale);
    }
    *reinterpret_cast<uint2*>(smem + swizzled8(r, C::BM, lane)) = packed;
  }
}

// Issue s = q k^T for the warpgroup's 64 rows and the tile's 128 kv columns:
// eight k16 steps over d, the first overwriting s
template <class C>
__device__ __forceinline__ void qk_issue(float (&s)[kBN / 2], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const uint64_t da = make_desc(qa + (ks >> 2) * (C::BM * 128) + (ks & 3) * 32, 16, kAtom);
    const uint64_t db = make_desc(kt + (ks >> 2) * (kBN * 128) + (ks & 3) * 32, 16, kAtom);
    wgmma<kBN, 0>(s, da, db, ks);
  }
}

// Issue o += p v over the tile's 128 kv rows: one k16 step per 16 rows
__device__ __forceinline__ void pv_issue(float (&o)[64], const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    // V: k16 = two 8-row atoms (SBO), 64-column blocks a tile's rows apart (LBO)
    wgmma_rs<128, 1>(o, pf[kk], make_desc(vt + kk * 2 * kAtom, kBN * 128, kAtom));
  }
}

// s of tile t through the softmax: masked past lk, p = exp2(s - m) in
// place, m and l updated, o rescaled; o must be free (no P.V in flight)
__device__ __forceinline__ void softmax_step(float (&s)[kBN / 2], float (&o)[64],
                                             float (&m_i)[2], float (&l_i)[2], int t,
                                             int lk) {
  if ((t + 1) * kBN > lk) mask_tail<kBN>(s, t * kBN, lk);
  float alpha[2] = {1.f, 1.f};
  float rsum[2] = {0.f, 0.f};
  softmax_tile<kBN>(s, m_i, alpha, rsum);
  rescale(o, l_i, alpha, rsum);
}

// A consumer warpgroup: its 64 q rows against every kv tile of the ring,
// then its rows of the output. With two warpgroups they take turns at the
// tensor cores: each issues its products after the other has issued its
// own (named barrier 3 + wg, 256 threads), so one's softmax runs under the
// other's products; warpgroup 0 goes first.
template <class C>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint32_t kv_base,
                                        uint32_t full, uint32_t empty, int n_tiles) {
  constexpr bool kTurns = C::kConsumers == 256;
  const int q0 = blockIdx.x * C::BM;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int wg = threadIdx.x >> 7;
  stage_q<C>(smem,
             p.qkv + static_cast<long long>(b) * p.l * p.width +
                 stripe(0, h, p.heads, p.interleaved),
             p, q0);
  fence_proxy_async();         // own q stores -> wgmma
  named_barrier(1 + wg, 128);  // the warpgroup's q rows are staged

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[kBN / 2];
  uint32_t pf[kBN / 16][4];
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const uint32_t qa = smem_addr(smem) + wg * 64 * 128;
  if (kTurns && wg == 1) named_barrier_arrive(3, 256);

  // Tile 0: s = q k_0^T and its softmax; p stays in registers.
  mbar_wait(full, 0);
  if (kTurns) named_barrier(3 + wg, 256);
  wgmma_fence();
  qk_issue<C>(s, qa, kv_base);
  wgmma_commit();
  if (kTurns && (wg == 0 || n_tiles > 1)) named_barrier_arrive(4 - wg, 256);
  wgmma_wait<0>();
  fence_operands(s);
  softmax_step(s, o, m_i, l_i, 0, p.lk);
  pack_p<kBN, false>(pf, pf, s);

  // Tile t: s = q k_t^T is issued, then o += p_{t-1} v_{t-1}; tile t's
  // softmax runs while the latter is in flight. Tile t - 1's stage is
  // released once its P.V has finished.
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(full + 8 * st, (t / kStages) & 1);  // tile t has landed
    if (kTurns) named_barrier(3 + wg, 256);     // this warpgroup's turn
    fence_operands(o);
    wgmma_fence();
    qk_issue<C>(s, qa, kv_base + st * C::kStageBytes);
    wgmma_commit();
    pv_issue(o, pf, kv_base + prev * C::kStageBytes + kTileBytes);
    wgmma_commit();
    if (kTurns && (wg == 0 || t + 1 < n_tiles)) named_barrier_arrive(4 - wg, 256);
    wgmma_wait<1>();  // s has finished; p_{t-1} v_{t-1} may still run
    fence_operands(s);
    float alpha[2] = {1.f, 1.f};
    float rsum[2] = {0.f, 0.f};
    if ((t + 1) * kBN > p.lk) mask_tail<kBN>(s, t * kBN, p.lk);
    softmax_tile<kBN>(s, m_i, alpha, rsum);
    wgmma_wait<0>();  // p_{t-1} v_{t-1} has finished: o and pf are free
    fence_operands(o);
    fence_p(pf);
    mbar_arrive(empty + 8 * prev);  // done with tile t - 1's stage
    rescale(o, l_i, alpha, rsum);
    pack_p<kBN, false>(pf, pf, s);
  }
  fence_operands(o);
  wgmma_fence();
  pv_issue(o, pf, kv_base + ((n_tiles - 1) % kStages) * C::kStageBytes + kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_i[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long hd = static_cast<long long>(p.heads) * kD;
  const int lane = threadIdx.x & 31;
  const int row = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  __nv_bfloat16* go = p.out + static_cast<long long>(b) * p.l * hd + h * kD + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (row < p.l) {
      *reinterpret_cast<uint32_t*>(go + static_cast<long long>(row) * hd + j * 8) =
          pack_bf16(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    }
    if (row + 8 < p.l) {
      *reinterpret_cast<uint32_t*>(go + static_cast<long long>(row + 8) * hd + j * 8) =
          pack_bf16(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
    }
  }
}

// WGS consumer warpgroups and one producer warpgroup, in which one thread
// issues the copies. With two consumers the producer gives back registers
// (setmaxnreg) so the consumers can hold o, s and p (about 200 registers):
// 24 + 2 x 240 of the 512 a lane of each SM sub-partition has.
template <int WGS>
__global__ void __launch_bounds__(WGS * 128 + 128, 1) fused_attention_kernel(const Params p) {
  using C = Cfg<WGS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const uint32_t kv_base = smem_addr(smem) + C::kQBytes;
  const uint32_t full = smem_addr(smem) + C::kBar;  // full[i] at full + 8 i
  const uint32_t empty = full + kStages * 8;
  const int n_tiles = (p.lk + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the role by warpgroup, made visibly uniform across each warp for
  // setmaxnreg
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WGS) {  // the producer
    if constexpr (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == C::kConsumers) {
      const __nv_bfloat16* src =
          p.kv + static_cast<long long>(blockIdx.y) * p.tiles * 2 * kTileElems;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t dst = kv_base + st * C::kStageBytes;
        if (t >= kStages) mbar_wait(empty + 8 * st, (t / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * st, C::kStageBytes);
        bulk_copy(dst, src + static_cast<long long>(t) * 2 * kTileElems, kTileBytes, full + 8 * st);
        bulk_copy(dst + kTileBytes, src + (2LL * t + 1) * kTileElems, kTileBytes, full + 8 * st);
      }
    }
  } else {
    if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<C>(p, smem, kv_base, full, empty, n_tiles);
  }
}

template <int WGS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<WGS>;
  auto kernel = fused_attention_kernel<WGS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.l + C::BM - 1) / C::BM, batch * p.heads);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tile: 128 q rows (two consumer warpgroups); one consumer of 64 rows
// was slower at both main-path lengths (see the note at the top).
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  return launch<2>(p, batch, stream);
}

// Check the shapes, launch the k and v prologue and fill p for the main
// kernel.
int start(const void* qkv, void* out, void* kv_scratch, const float* q_scale_img,
          const float* k_scale_img, const float* q_scale_txt, const float* k_scale_txt,
          const float* cos, const float* sin, int batch, int heads, int l, int lk,
          long long width, int txt_len, int interleaved, float eps, float q_scale,
          cudaStream_t s, Params& p) {
  if (batch < 1 || heads < 1 || l < 1 || width < 3LL * heads * kD || width % 8 != 0 ||
      lk > l || lk < 1) {
    return kErrUnsupported;
  }
  const int tiles = (l + kBN - 1) / kBN;
  const long long rows = static_cast<long long>(batch) * heads * tiles * kBN;
  norm_rope_kv_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                        kRowsPerBlock * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(kv_scratch),
      k_scale_txt, k_scale_img, cos, sin, batch, heads, l, tiles, width, txt_len,
      interleaved, eps);
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.kv = static_cast<const __nv_bfloat16*>(kv_scratch);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scale_txt = q_scale_txt;
  p.scale_img = q_scale_img;
  p.cos = cos;
  p.sin = sin;
  p.width = width;
  p.heads = heads;
  p.l = l;
  p.lk = lk;
  p.txt_len = txt_len;
  p.tiles = tiles;
  p.interleaved = interleaved;
  p.eps = eps;
  p.q_scale = q_scale;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LDT_FUSED_QKV_ARGS                                                    \
  const void *qkv, void *out, void *kv_scratch, const float *q_scale_img,    \
      const float *k_scale_img, const float *q_scale_txt,                    \
      const float *k_scale_txt, const float *cos, const float *sin,          \
      int batch, int heads, int l, int lk, long long width, int txt_len,     \
      int interleaved, float eps, float q_scale, void *stream
#define LDT_FUSED_QKV_START(p)                                                \
  start(qkv, out, kv_scratch, q_scale_img, k_scale_img, q_scale_txt,         \
        k_scale_txt, cos, sin, batch, heads, l, lk, width, txt_len,          \
        interleaved, eps, q_scale, static_cast<cudaStream_t>(stream), p)

// qkv (B, L, W) bf16, W >= 3 * heads * 128 and a multiple of 8, its heads'
// stripes proj-major ([q heads | k heads | v heads | ...]) or, with
// interleaved != 0, head-major ([q_h0 | k_h0 | v_h0 | q_h1 | ...]); out
// (B, L, heads * 128) bf16; kv_scratch (B, heads, ceil(L / 128) * 128, 256)
// bf16, 16-byte aligned (the tile images); the four QKNorm scales (128,) f32
// in the permuted basis; cos and sin (L, 128) f32. lk <= L is the number of
// kv rows attended (L on the main path).
extern "C" int ldt_fused_qkv_attention_fwd(LDT_FUSED_QKV_ARGS) {
  Params p;
  const int rc = LDT_FUSED_QKV_START(p);
  return rc != 0 ? rc : dispatch(p, batch, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
