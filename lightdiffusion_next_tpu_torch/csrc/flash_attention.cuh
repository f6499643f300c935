// Exact non-causal flash attention on wgmma for Hopper (sm_90a), shared by
// the entry points of K1 (packed_flash_attention.cu) and K2
// (flash_attention.cu).
//
// What it computes (the same function as the Pallas kernels of
// lightdiffusion_next_tpu/ops/flash_attention.py):
//   q is pre-scaled by LOG2E/sqrt(d) in f32 and rounded to the input dtype;
//   s = q k^T with f32 accumulation, already in the base-2 domain;
//   kv columns >= lk are set to -1e30;
//   online softmax with exp2, f32 running max m, sum l and accumulator;
//   p is rounded to the input dtype for the p v product, f32 accumulation;
//   o = acc / l, rounded to the output dtype.
// f32 inputs keep f32 products, as the JAX kernel multiplies f32 operands in
// f32: each operand x is split into hi = bf16(x) and lo = bf16(x - hi)
// (about 16 mantissa bits) and each product is three wgmma, hi*hi + hi*lo +
// lo*hi (TF32's 10 bits or plain bf16 miss the 1e-3 limit the VAE's output is
// held to, ops/flash_attention.py).
//
// Two launches per call. A first one (flash_kv_kernel) writes k and v, read
// through their (batch, head, row) strides (the UNet's head-split views of
// its fused q|k|v projection need no copy), into a scratch of kv tiles, each
// tile the exact image of its shared-memory stage with the 128-byte swizzle
// (16-byte chunk j of a 128-byte row r at chunk j ^ (r & 7)), zero past lk
// and past d; for f32 it writes the bf16 hi and lo images. Then one of two
// kernels, each a producer warpgroup whose one thread bulk-copies the tile
// images (cp.async.bulk, the TMA without a tensor map) through full/empty
// mbarriers, and consumer warpgroups of 64 q rows that stage their own q
// tile (pre-scaled, rounded, split for f32) and run both products on wgmma:
//
// flash_wgmma_kernel<D, WGS>: bf16, d <= 160 (K1 at d = 40, K2 at d = 80 and
// 160). A tile is BN kv rows (128; 64 at d > 128, where three 128-row stages
// do not fit): the K image K-major ([64-column blocks][BN rows][128 B], d
// padded with zeros to DP, the next multiple of 16, so d = 40 takes three
// k16 steps), then V transposed and K-major ([64-row blocks][DV rows][128
// B], DV = d padded to 8: P.V runs at N = 40 at d = 40; V N-major with the
// 128-byte swizzle would need N to be a multiple of 64). Three stages. WGS
// consumer warpgroups take turns at the tensor cores (named barriers): one
// issues S = q k^T of tile t (shared x shared) and o += p v of tile t - 1 (p
// from registers, the S fragment rounded to bf16) while the other runs its
// softmax; within a warpgroup tile t's softmax runs while tile t - 1's P.V is
// in flight. Only the last, ragged kv tile is masked. Three consumer
// warpgroups at d <= 64, where exp2 and not the tensor cores bound the
// kernel (their softmax is most of a tile's time), two above. The producer
// gives back registers (setmaxnreg 24; consumers 240 with two warpgroups,
// 160 with three).
//
// flash_split_kernel<F32, DH>: f32 at any d <= 512 (the VAE's head at d =
// 512) and bf16 above d = 160. 64 q rows a block, the head dim padded to 2 DH
// (DH = 64, 128, 256) and split between two consumer warpgroups: each
// computes its partial S over its DH columns (m64n16k16, three wgmma a k16
// step for f32), the partials are summed through shared memory (one named
// barrier a tile, double-buffered by the tile's parity), both run the same
// softmax, and each accumulates its own 64 x DH slice of o (m64nDHk16 with
// p's hi and lo from registers and V N-major, tnspB = 1). So S is computed
// once per (q tile, kv tile), and the accumulator (64 x 512 f32) fits in
// registers. A tile is 16 kv rows ([parts][64-column blocks][16 rows][128
// B] for K, the same for V); K and V flow through one stage each (32 KB at
// d = 512 in f32), the next K landing under the previous tile's P.V. The
// price is in shared-memory reads: S at N = 16 reads q's 64-row A tile (and
// its lo half) from shared memory for every k16 step, 3 x 2 KB per 16 x 16 x
// 64 x 3 products, about as many bytes as the tensor cores take in.
//
// The output is written through its strides, in the folded (B, L, H, D)
// layout by the wrapper.
#pragma once

#include <type_traits>

#include "softmax_tile.cuh"

namespace ldt {

using namespace hopper;

constexpr int kErrUnsupported = 1000;
constexpr int kQBar = 1;     // named barriers 1..3: a warpgroup's q tile is staged
constexpr int kTurnBar = 4;  // 4..6: a warpgroup's turn at the tensor cores
constexpr int kXBar = 7;     // the split kernel's partial S are written

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const unsigned char* kv;  // the tile images
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long tile_bytes;  // one tile's image: K, then V
  int heads, lq, lk, d, tiles;
  float q_scale;
  int vec;  // 1: base pointers and row strides are 16-byte aligned
};

// The tile images of one call, as flash_kv_kernel writes them: per (batch,
// head) `tiles` images of tile_bytes. K: [parts][blocks][bn rows][128 B];
// V: the same (dv = 0) or transposed, [bn / 64][dv rows][128 B].
struct KvLayout {
  int bn, blocks, parts, dv;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Eight consecutive elements of a row from `src` on, as f32: `valid` of them
// are real (<= 0: none; src is then not read), the rest are zero.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ src, int valid, bool vec,
                                      float (&f)[8]) {
  if (vec && valid >= 8) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
      }
    } else {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = j < valid ? to_float(src[j]) : 0.f;
  }
}

// f32 operands go to the tensor cores as bf16 hi and lo halves
template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;

// Eight values as one 16-byte bf16 chunk at dst; SPLIT: their hi halves
// there and their lo halves lo_offset bytes further
template <bool SPLIT>
__device__ __forceinline__ void store8(unsigned char* dst, int lo_offset, const float (&f)[8]) {
  uint4 hi;
  if constexpr (SPLIT) {
    uint4 lo;
    split_pack(f[0], f[1], hi.x, lo.x);
    split_pack(f[2], f[3], hi.y, lo.y);
    split_pack(f[4], f[5], hi.z, lo.z);
    split_pack(f[6], f[7], hi.w, lo.w);
    *reinterpret_cast<uint4*>(dst + lo_offset) = lo;
  } else {
    hi.x = pack_bf16(f[0], f[1]);
    hi.y = pack_bf16(f[2], f[3]);
    hi.z = pack_bf16(f[4], f[5]);
    hi.w = pack_bf16(f[6], f[7]);
  }
  *reinterpret_cast<uint4*>(dst) = hi;
}

// Byte offset of 16-byte chunk j of row r in an image of `rows`-row blocks
// of 128-byte rows, in 64-column block cb
__device__ __forceinline__ int chunk_at(int cb, int rows, int r, int j) {
  return cb * rows * 128 + r * 128 + ((j ^ (r & 7)) << 4);
}

// The tile images: block (t, b * heads + h) writes tile t of (b, h); f32
// k and v as their bf16 hi and lo halves.
template <typename T>
__global__ void __launch_bounds__(256) flash_kv_kernel(const Params p, const KvLayout lay,
                                                       unsigned char* __restrict__ kv) {
  const int t = blockIdx.x;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int row0 = t * lay.bn;
  const T* gk = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  unsigned char* img = kv + (static_cast<long long>(blockIdx.y) * p.tiles + t) * p.tile_bytes;
  const int part = lay.blocks * lay.bn * 128;
  const int k_bytes = lay.parts * part;
  // K (and V, untransposed): 8 threads a row, chunk j of 64-column block cb
  for (int i = threadIdx.x; i < lay.blocks * lay.bn * 8; i += 256) {
    const int j = i & 7;
    const int r = (i >> 3) % lay.bn;
    const int cb = (i >> 3) / lay.bn;
    const int row = row0 + r;
    const int col = cb * 64 + j * 8;
    const int valid = row < p.lk ? p.d - col : 0;
    const int at = chunk_at(cb, lay.bn, r, j);
    float f[8];
    load8(gk + static_cast<long long>(row) * p.k_sl + col, valid, p.vec, f);
    store8<kSplit<T>>(img + at, part, f);
    if (lay.dv == 0) {
      load8(gv + static_cast<long long>(row) * p.v_sl + col, valid, p.vec, f);
      store8<kSplit<T>>(img + k_bytes + at, part, f);
    }
  }
  if (lay.dv == 0) return;
  // V transposed: row c of 64-row block vb holds v[vb * 64 + x][c] at
  // position x; one thread a chunk of 8 kv rows, neighbouring threads on
  // neighbouring columns
  for (int i = threadIdx.x; i < (lay.bn / 64) * lay.dv * 8; i += 256) {
    const int c = i % lay.dv;
    const int j = (i / lay.dv) & 7;
    const int vb = i / (lay.dv * 8);
    const int row = row0 + vb * 64 + j * 8;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = (row + e < p.lk && c < p.d) ? to_float(gv[static_cast<long long>(row + e) * p.v_sl + c])
                                         : 0.f;
    store8<false>(img + k_bytes + chunk_at(vb, lay.dv, c, j), 0, f);
  }
}

// Stage 64 rows of q from row q0 into a K-major image of 64-column blocks
// (its lo half lo_offset bytes further for f32): the warpgroup's 128
// threads write blocks cb0 .. cb0 + ncb - 1, q pre-scaled in f32, rows
// past lq and columns past d zero.
template <typename T>
__device__ __forceinline__ void stage_q(unsigned char* sq, int cb0, int ncb, int lo_offset,
                                        const Params& p, int q0) {
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int i = threadIdx.x & 127; i < 64 * ncb * 8; i += 128) {
    const int j = i & 7;
    const int cb = cb0 + (i >> 3) % ncb;
    const int r = (i >> 3) / ncb;
    const int row = q0 + r;
    const int col = cb * 64 + j * 8;
    float f[8];
    load8(gq + static_cast<long long>(row) * p.q_sl + col, row < p.lq ? p.d - col : 0, p.vec,
          f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= p.q_scale;
    store8<kSplit<T>>(sq + chunk_at(cb, 64, r, j), lo_offset, f);
  }
}

// o / l of the warpgroup's 64 rows from q row q0, columns c0 .. c0 + N - 1
// (those < d), through the output's strides
template <typename T, int N>
__device__ __forceinline__ void store_o(const Params& p, const float (&o)[N / 2],
                                        const float (&l_i)[2], int q0, int c0) {
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_i[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int row = q0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + half * 8;
      if (r < p.lq) {
        T* dst = go + static_cast<long long>(r) * p.o_sl + col;
        if (col < p.d) store_out(dst, o[4 * j + 2 * half] / l[half]);
        if (col + 1 < p.d) store_out(dst + 1, o[4 * j + 2 * half + 1] / l[half]);
      }
    }
  }
}

// The f32 path's running o folded into the output, which holds an f32
// partial sum between folds: out = out * a + o (the first fold: out = o),
// through store_o's fragment layout; FINAL also divides by l. a is the
// product of the rescales o took since the last fold. The tensor cores do
// not round to nearest when they add a wgmma's products into the
// accumulator, so a sum carried in it through every kv tile drifts towards
// zero in proportion to the tiles: on an H100 the VAE head came out 2.0e-4
// to 4.0e-4 small at 65 536 kv rows (1.6e-8 to 3.3e-8 a wgmma, 3 a tile),
// against a 1e-4 limit. Folded every kFoldTiles tiles with a rounded fma,
// it drifts within a fold only: about 7e-6 in 128 tiles.
constexpr int kFoldTiles = 256;

template <int N, bool FINAL>
__device__ __forceinline__ void fold_o(const Params& p, float (&o)[N / 2], const float (&a)[2],
                                       const float (&l_i)[2], bool first, int q0, int c0) {
  float l[2] = {1.f, 1.f};
  if constexpr (FINAL) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l_i[r];
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int row = q0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + half * 8;
      float* dst = go + static_cast<long long>(r) * p.o_sl + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = o[4 * j + 2 * half + e];
        if (r < p.lq && col + e < p.d) {
          const float sum = first ? v : __fmaf_rn(dst[e], a[half], v);
          dst[e] = FINAL ? sum / l[half] : sum;
        }
        if constexpr (!FINAL) v = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bf16, d <= 160
// ---------------------------------------------------------------------------

template <int D, int WGS>
struct TileCfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // S's k: d padded to the k16 step
  static constexpr int DV = (D + 7) / 8 * 8;     // P.V's N
  static constexpr int KB = (DP + 63) / 64;      // 64-column blocks of q and K
  static constexpr int BN = D > 128 ? 64 : 128;  // kv rows a tile
  static constexpr int kStages = 3;
  static constexpr int kKBytes = KB * BN * 128;
  static constexpr int kVBytes = (BN / 64) * DV * 128;
  static constexpr int kTileBytes = kKBytes + kVBytes;
  static constexpr int kConsumers = WGS * 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int BM = WGS * 64;
  static constexpr int kQBytes = KB * 64 * 128;  // one warpgroup's q tile
  static constexpr int kBar = WGS * kQBytes + kStages * kTileBytes;
  static constexpr int kSmem = kBar + 2 * kStages * 8 + kAtom;  // + alignment
  static constexpr int kRegs = WGS == 3 ? 160 : 240;           // a consumer's
  static KvLayout layout() { return KvLayout{BN, KB, 1, DV}; }
};

// s = q k^T for the warpgroup's 64 rows and the tile's BN kv columns
template <class C>
__device__ __forceinline__ void qk_issue(float (&s)[C::BN / 2], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int ks = 0; ks < C::DP / 16; ++ks) {
    const uint64_t da = make_desc(qa + (ks >> 2) * (64 * 128) + (ks & 3) * 32, 16, kAtom);
    const uint64_t db = make_desc(kt + (ks >> 2) * (C::BN * 128) + (ks & 3) * 32, 16, kAtom);
    wgmma<C::BN, 0>(s, da, db, ks);
  }
}

// o += p v over the tile's BN kv rows: V^T K-major, one k16 step per 16 rows
template <class C>
__device__ __forceinline__ void pv_issue(float (&o)[C::DV / 2],
                                         const uint32_t (&pf)[C::BN / 16][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    wgmma_rs<C::DV, 0>(o, pf[kk],
                       make_desc(vt + (kk >> 2) * (C::DV * 128) + (kk & 3) * 32, 16, kAtom));
  }
}

// A consumer warpgroup: its 64 q rows against every kv tile of the ring,
// then its rows of the output. With WGS > 1 they take turns at the tensor
// cores: each issues its products after the previous one has issued its own
// (named barrier kTurnBar + wg, 256 threads), warpgroup 0 first.
template <class C>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint32_t kv_base,
                                        uint32_t full, uint32_t empty, int n_tiles) {
  constexpr int WGS = C::kConsumers / 128;
  constexpr bool kTurns = WGS > 1;
  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * C::BM + wg * 64;
  unsigned char* sq = smem + wg * C::kQBytes;
  stage_q<__nv_bfloat16>(sq, 0, C::KB, 0, p, q0);
  fence_proxy_async();               // own q stores -> wgmma
  named_barrier(kQBar + wg, 128);    // the warpgroup's q rows are staged

  float o[C::DV / 2];
#pragma unroll
  for (int i = 0; i < C::DV / 2; ++i) o[i] = 0.f;
  float s[C::BN / 2];
  uint32_t pf[C::BN / 16][4];
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const uint32_t qa = smem_addr(sq);
  const int next = kTurnBar + (wg + 1) % WGS;
  const bool last_wg = wg == WGS - 1;
  if (kTurns && last_wg) named_barrier_arrive(kTurnBar, 256);

  // Tile 0: s = q k_0^T and its softmax; p stays in registers.
  mbar_wait(full, 0);
  if (kTurns) named_barrier(kTurnBar + wg, 256);
  wgmma_fence();
  qk_issue<C>(s, qa, kv_base);
  wgmma_commit();
  if (kTurns && (!last_wg || n_tiles > 1)) named_barrier_arrive(next, 256);
  wgmma_wait<0>();
  fence_operands(s);
  {
    if (C::BN > p.lk) mask_tail<C::BN>(s, 0, p.lk);
    float alpha[2], rsum[2];
    softmax_tile<C::BN>(s, m_i, alpha, rsum);
    rescale(o, l_i, alpha, rsum);
  }
  pack_p<C::BN, false>(pf, pf, s);

  // Tile t: s = q k_t^T is issued, then o += p_{t-1} v_{t-1}; tile t's
  // softmax runs while the latter is in flight. Tile t - 1's stage is
  // released once its P.V has finished.
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % C::kStages;
    const int prev = (t - 1) % C::kStages;
    mbar_wait(full + 8 * st, (t / C::kStages) & 1);  // tile t has landed
    if (kTurns) named_barrier(kTurnBar + wg, 256);  // this warpgroup's turn
    fence_operands(o);
    wgmma_fence();
    qk_issue<C>(s, qa, kv_base + st * C::kTileBytes);
    wgmma_commit();
    pv_issue<C>(o, pf, kv_base + prev * C::kTileBytes + C::kKBytes);
    wgmma_commit();
    if (kTurns && (!last_wg || t + 1 < n_tiles)) named_barrier_arrive(next, 256);
    wgmma_wait<1>();  // s has finished; p_{t-1} v_{t-1} may still run
    fence_operands(s);
    float alpha[2], rsum[2];
    if ((t + 1) * C::BN > p.lk) mask_tail<C::BN>(s, t * C::BN, p.lk);
    softmax_tile<C::BN>(s, m_i, alpha, rsum);
    wgmma_wait<0>();  // p_{t-1} v_{t-1} has finished: o and pf are free
    fence_operands(o);
    fence_p(pf);
    mbar_arrive(empty + 8 * prev);  // done with tile t - 1's stage
    rescale(o, l_i, alpha, rsum);
    pack_p<C::BN, false>(pf, pf, s);
  }
  fence_operands(o);
  wgmma_fence();
  pv_issue<C>(o, pf, kv_base + ((n_tiles - 1) % C::kStages) * C::kTileBytes + C::kKBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  store_o<__nv_bfloat16, C::DV>(p, o, l_i, q0, 0);
}

// WGS consumer warpgroups and one producer warpgroup, in which one thread
// issues the copies
template <int D, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 128, 1) flash_wgmma_kernel(const Params p) {
  using C = TileCfg<D, WGS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const uint32_t kv_base = smem_addr(smem) + WGS * C::kQBytes;
  const uint32_t full = smem_addr(smem) + C::kBar;  // full[i] at full + 8 i
  const uint32_t empty = full + C::kStages * 8;
  const int n_tiles = (p.lk + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the role by warpgroup, made visibly uniform across each warp for
  // setmaxnreg
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WGS) {  // the producer
    if constexpr (WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == C::kConsumers) {
      const unsigned char* src = p.kv + static_cast<long long>(blockIdx.y) * p.tiles * C::kTileBytes;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::kStages;
        const uint32_t dst = kv_base + st * C::kTileBytes;
        if (t >= C::kStages) mbar_wait(empty + 8 * st, (t / C::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * st, C::kTileBytes);
        bulk_copy(dst, src + static_cast<long long>(t) * C::kTileBytes, C::kKBytes, full + 8 * st);
        bulk_copy(dst + C::kKBytes, src + static_cast<long long>(t) * C::kTileBytes + C::kKBytes,
                  C::kVBytes, full + 8 * st);
      }
    }
  } else {
    if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if constexpr (WGS == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    consume<C>(p, smem, kv_base, full, empty, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// flash_split_kernel: f32 at d <= 512, bf16 at 160 < d <= 512
// ---------------------------------------------------------------------------

template <bool F32, int DH>
struct SplitCfg {
  static constexpr int BN = 16;  // kv rows a tile
  static constexpr int kParts = F32 ? 2 : 1;
  static constexpr int NB = 2 * DH / 64;  // 64-column blocks of the padded head dim
  static constexpr int kPartBytes = NB * BN * 128;  // one part of a K or V image
  static constexpr int kKBytes = kParts * kPartBytes;
  static constexpr int kTileBytes = 2 * kKBytes;  // K, then V
  static constexpr int kQPart = NB * 64 * 128;
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = 384;
  static constexpr int kK = kParts * kQPart;  // the K stage, then the V stage
  static constexpr int kV = kK + kKBytes;
  static constexpr int kX = kV + kKBytes;  // partial S: [wg][parity][128 x 8 f32]
  static constexpr int kBar = kX + 2 * 2 * 128 * 8 * 4;
  static constexpr int kSmem = kBar + 4 * 8 + kAtom;
  static KvLayout layout() { return KvLayout{BN, NB, kParts, 0}; }
};

// The warpgroup's partial s over its DH columns: DH / 16 k16 steps, each
// three products for f32 (q hi k hi, q hi k lo, q lo k hi). qd and kd are
// the descriptors of the warpgroup's first q and K column; passed through an
// opaque asm each tile, so the compiler cannot hoist the 3 DH / 16 step
// descriptors out of the tile loop (at d = 512 they would hold 96 registers
// beside o's 128 and spill).
template <class C>
__device__ __forceinline__ void qk_split_issue(float (&s)[8], uint64_t qd, uint64_t kd) {
  constexpr int kSteps = C::NB * 2;  // DH / 16
  asm volatile("" : "+l"(qd), "+l"(kd));
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    // descriptor + byte offset / 16: the address field takes no carry below 256 KB
    const uint64_t qh = qd + (((ks >> 2) * (64 * 128) + (ks & 3) * 32) >> 4);
    const uint64_t kh = kd + (((ks >> 2) * (C::BN * 128) + (ks & 3) * 32) >> 4);
    wgmma<16, 0>(s, qh, kh, ks);
    if constexpr (C::kParts == 2) {
      wgmma<16, 0>(s, qh, kh + (C::kPartBytes >> 4));
      wgmma<16, 0>(s, qh + (C::kQPart >> 4), kh);
    }
  }
}

// o (64 x DH) += p v over the tile's 16 kv rows, the warpgroup's DH columns:
// V N-major (tnspB = 1), 64-column blocks a block's 2 KB apart (LBO), 8-row
// atoms 1 KB apart (SBO)
template <class C>
__device__ __forceinline__ void pv_split_issue(float (&o)[C::NB * 16], const uint32_t (&ph)[4],
                                               const uint32_t (&pl)[4], uint32_t va, int wg) {
  constexpr int DH = C::NB * 32;
  const uint32_t vb = va + wg * (C::NB / 2) * (C::BN * 128);
  const uint64_t vh = make_desc(vb, C::BN * 128, kAtom);
  wgmma_rs<DH, 1>(o, ph, vh);
  if constexpr (C::kParts == 2) {
    wgmma_rs<DH, 1>(o, ph, make_desc(vb + C::kPartBytes, C::BN * 128, kAtom));
    wgmma_rs<DH, 1>(o, pl, vh);
  }
}

// Both warpgroups' partial s of tile t summed: each writes its own, waits
// for the other's (named barrier kXBar) and adds it. The buffers alternate
// with t's parity, so one barrier a tile suffices.
__device__ __forceinline__ void sum_partials(float (&s)[8], float* xbuf, int wg, int t) {
  const int tid = threadIdx.x & 127;
  float4* mine = reinterpret_cast<float4*>(xbuf + ((wg * 2 + (t & 1)) * 128 + tid) * 8);
  mine[0] = make_float4(s[0], s[1], s[2], s[3]);
  mine[1] = make_float4(s[4], s[5], s[6], s[7]);
  named_barrier(kXBar, 256);
  const float4* other =
      reinterpret_cast<const float4*>(xbuf + (((1 - wg) * 2 + (t & 1)) * 128 + tid) * 8);
  const float4 a = other[0];
  const float4 b = other[1];
  s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
  s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
}

template <class C, typename T>
__device__ __forceinline__ void consume_split(const Params& p, unsigned char* smem, uint32_t full,
                                              uint32_t empty, int n_tiles) {
  constexpr bool SPLIT = kSplit<T>;
  constexpr int DH = C::NB * 32;
  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * 64;
  stage_q<T>(smem, wg * (C::NB / 2), C::NB / 2, C::kQPart, p, q0);
  fence_proxy_async();
  named_barrier(kQBar + wg, 128);

  const uint32_t qa = smem_addr(smem);
  const uint32_t ka = qa + C::kK;
  const uint32_t va = qa + C::kV;
  float* xbuf = reinterpret_cast<float*>(smem + C::kX);
  // the warpgroup's first k16 step: its DH columns start at block wg NB / 2
  const uint64_t qd = make_desc(qa + wg * (C::NB / 2) * (64 * 128), 16, kAtom);
  const uint64_t kd = make_desc(ka + wg * (C::NB / 2) * (C::BN * 128), 16, kAtom);
  const uint32_t full_k = full, full_v = full + 8;
  const uint32_t empty_k = empty, empty_v = empty + 8;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float s[8];
  uint32_t ph[1][4], pl[1][4];
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  float a_i[2] = {1.f, 1.f};  // f32: the rescales since the last fold_o
  bool folded = false;

  mbar_wait(full_k, 0);
  wgmma_fence();
  qk_split_issue<C>(s, qd, kd);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
  mbar_arrive(empty_k);
  sum_partials(s, xbuf, wg, 0);
  {
    if (C::BN > p.lk) mask_tail<C::BN>(s, 0, p.lk);
    float alpha[2], rsum[2];
    softmax_tile<C::BN>(s, m_i, alpha, rsum);
    rescale(o, l_i, alpha, rsum);
  }
  pack_p<C::BN, SPLIT>(ph, pl, s);

  // Tile t: s of tile t, then o += p_{t-1} v_{t-1}; the partial sums and the
  // softmax of tile t run while the latter is in flight.
  for (int t = 1; t < n_tiles; ++t) {
    mbar_wait(full_k, t & 1);
    fence_operands(o);
    wgmma_fence();
    qk_split_issue<C>(s, qd, kd);
    wgmma_commit();
    mbar_wait(full_v, (t - 1) & 1);  // V_{t-1} lands under S_t
    pv_split_issue<C>(o, ph[0], pl[0], va, wg);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    mbar_arrive(empty_k);  // the next K may land
    sum_partials(s, xbuf, wg, t);
    if ((t + 1) * C::BN > p.lk) mask_tail<C::BN>(s, t * C::BN, p.lk);
    float alpha[2], rsum[2];
    softmax_tile<C::BN>(s, m_i, alpha, rsum);
    wgmma_wait<0>();
    fence_operands(o);
    fence_p(ph);
    if constexpr (SPLIT) fence_p(pl);
    mbar_arrive(empty_v);  // the next V may land
    rescale(o, l_i, alpha, rsum);
    if constexpr (SPLIT) {
      a_i[0] *= alpha[0];
      a_i[1] *= alpha[1];
      if (t % kFoldTiles == 0) {  // o holds the P.V of tiles t - kFoldTiles .. t - 1
        fold_o<DH, false>(p, o, a_i, l_i, !folded, q0, wg * DH);
        a_i[0] = a_i[1] = 1.f;
        folded = true;
      }
    }
    pack_p<C::BN, SPLIT>(ph, pl, s);
  }
  mbar_wait(full_v, (n_tiles - 1) & 1);
  fence_operands(o);
  wgmma_fence();
  pv_split_issue<C>(o, ph[0], pl[0], va, wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  if constexpr (SPLIT) {
    fold_o<DH, true>(p, o, a_i, l_i, !folded, q0, wg * DH);
  } else {
    store_o<T, DH>(p, o, l_i, q0, wg * DH);
  }
}

// Two consumer warpgroups (one half of the head dim each) and one producer
// warpgroup. The producer copies K_t as soon as K_{t-1}'s S has finished and
// V_{t-1} once V_{t-2}'s P.V has: the order in which the consumers release
// them.
template <bool F32, int DH>
__global__ void __launch_bounds__(384, 1) flash_split_kernel(const Params p) {
  using C = SplitCfg<F32, DH>;
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const uint32_t full = smem_addr(smem) + C::kBar;  // K, V
  const uint32_t empty = full + 16;
  const int n_tiles = (p.lk + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == C::kConsumers) {
      const unsigned char* src = p.kv + static_cast<long long>(blockIdx.y) * p.tiles * C::kTileBytes;
      const uint32_t ka = smem_addr(smem) + C::kK;
      const uint32_t va = smem_addr(smem) + C::kV;
      mbar_expect_tx(full, C::kKBytes);
      bulk_copy(ka, src, C::kKBytes, full);
      for (int t = 1; t <= n_tiles; ++t) {
        if (t < n_tiles) {
          mbar_wait(empty, (t - 1) & 1);
          mbar_expect_tx(full, C::kKBytes);
          bulk_copy(ka, src + static_cast<long long>(t) * C::kTileBytes, C::kKBytes, full);
        }
        if (t >= 2) mbar_wait(empty + 8, t & 1);
        mbar_expect_tx(full + 8, C::kKBytes);
        bulk_copy(va, src + static_cast<long long>(t - 1) * C::kTileBytes + C::kKBytes,
                  C::kKBytes, full + 8);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume_split<C, T>(p, smem, full, empty, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// Launch: the prologue, then the kernel. `scratch` holds the tile images
// (scratch_bytes; the wrapper sizes it with ops/flash_attention.py's
// geometry, and a smaller one is refused).
// ---------------------------------------------------------------------------

template <class C, typename T>
int launch_prologue(Params& p, int batch, void* scratch, long long scratch_bytes,
                    cudaStream_t s) {
  const KvLayout lay = C::layout();
  p.tiles = (p.lk + lay.bn - 1) / lay.bn;
  p.tile_bytes = C::kTileBytes;
  if (scratch == nullptr ||
      scratch_bytes < static_cast<long long>(batch) * p.heads * p.tiles * C::kTileBytes) {
    return kErrUnsupported;
  }
  flash_kv_kernel<T><<<dim3(p.tiles, batch * p.heads), 256, 0, s>>>(
      p, lay, static_cast<unsigned char*>(scratch));
  p.kv = static_cast<const unsigned char*>(scratch);
  return static_cast<int>(cudaGetLastError());
}

// three consumers where exp2 bounds the kernel (d <= 64: 1.2x faster than two
// at d = 40, ablate_attention.py), two where the products do
template <int D, int WGS = (D <= 64 ? 3 : 2)>
int launch_tiles(Params p, int batch, void* scratch, long long scratch_bytes, cudaStream_t s) {
  using C = TileCfg<D, WGS>;
  int rc = launch_prologue<C, __nv_bfloat16>(p, batch, scratch, scratch_bytes, s);
  if (rc != 0) return rc;
  auto kernel = flash_wgmma_kernel<D, WGS>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((p.lq + C::BM - 1) / C::BM, batch * p.heads), C::kThreads, C::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32, int DH>
int launch_split(Params p, int batch, void* scratch, long long scratch_bytes, cudaStream_t s) {
  using C = SplitCfg<F32, DH>;
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  int rc = launch_prologue<C, T>(p, batch, scratch, scratch_bytes, s);
  if (rc != 0) return rc;
  auto kernel = flash_split_kernel<F32, DH>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((p.lq + 63) / 64, batch * p.heads), C::kThreads, C::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline Params make_params(const void* q, const void* k, const void* v, void* o, int heads,
                          int lq, int lk, int d, long long q_sb, long long q_sh, long long q_sl,
                          long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                          long long v_sh, long long v_sl, long long o_sb, long long o_sh,
                          long long o_sl, float q_scale, int vec) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.q_scale = q_scale;
  p.vec = vec;
  return p;
}

inline const char* error_string(int code) {
  if (code == kErrUnsupported) return "head dim, dtype or scratch size not supported";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace ldt

#define LDT_FLASH_ARGS                                                             \
  const void *q, const void *k, const void *v, void *o, int dtype, int batch,      \
      int heads, int lq, int lk, int d, long long q_sb, long long q_sh,            \
      long long q_sl, long long k_sb, long long k_sh, long long k_sl,              \
      long long v_sb, long long v_sh, long long v_sl, long long o_sb,              \
      long long o_sh, long long o_sl, float q_scale, int vec, void *scratch,       \
      long long scratch_bytes, void *stream

#define LDT_MAKE_PARAMS                                                            \
  ldt::make_params(q, k, v, o, heads, lq, lk, d, q_sb, q_sh, q_sl, k_sb, k_sh,     \
                   k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, q_scale, vec)
