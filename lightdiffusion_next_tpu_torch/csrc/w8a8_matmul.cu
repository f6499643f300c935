// K7, K8 and K11: int8 activations times int8 weights on the tensor cores,
// s32 accumulator, f32 epilogue, bf16 out.
//
// Replaces: lightdiffusion_next_tpu/ops/quant_matmul.py
//   _w8a8_matmul_2d (K7, pallas_call at :669; body _kernel_w8a8 at :89),
//   _w8a8_matmul_stacked_2d (K8, pallas_call at :793) and
//   _w8a8_matmul_ep_2d (K11, pallas_call at :1293, stacked at :1284;
//   bodies _kernel_w8a8_ep at :1105 and _kernel_w8a8_ep_res at :1128). K8
//   and the stacked K11 launch the very kernel K7 and K11 launch: the
//   weight's tensor map covers the whole stack (D x N rows), the block is a
//   row offset (idx * N) into it, and K8 offsets its column scales by idx * N
//   on the host; block 37 of the single blocks' linear1 stack starts 2.4e9
//   bytes in, read in place, never copied out.
//
// Operands: xq int8 (M, K) with per-row f32 scales sx (M,), from the row
// quantization (K9, K10); the weight's codes int8 (N, K), K-contiguous (the
// port's QTensor8W layout: 8-bit wgmma reads both operands K-major only),
// with per-column f32 scales cs (N,). The accumulator is exact (|acc| <=
// 127 * 127 * K < 2^31). Epilogues, in the JAX kernels' order of f32
// operations, each rounded (no contraction to FMA), so the bf16 result
// equals the plain version's bit for bit:
//   K7:  o = (f32(acc) * sx) * cs
//   K11: o = ((f32(acc) * sx) * cs) + b            (cs, b: gate folded in)
//   K11: o = (r + (f32(acc) * sx) * cs) + b        (gated residual)
//
// What bounds it on an H100: operations at the int8 tensor-core rate
// (1979 TOP/s) at every Flux shape with M >= 1024; at M = 256 (the text
// stream) the weight's bytes: 2 M K N operations against M K + K N + 4 M +
// 8 N + 2 M N bytes (+ 2 M N for the residual). linear1 (4352, 3072, 21504)
// 0.290 ms (operations); txt mlp.2 (256, 12288, 3072) with its residual
// 0.0132 ms (bytes). Behind the products come the copies from L2 into
// shared memory: a block of BM x BN reads (BM + BN) K bytes per 2 BM BN K
// operations, 3.4 GB at linear1 with 256 x 128 blocks, 2.2 GB when pairs of
// them share the A tile. At linear1 the kernel now runs at 1.3x its bound:
// the products alone take 0.315 ms, the copies and the epilogue without
// them 0.310 (ablate_w8a8.py); at N = 3072 the 17 x 12 pairs of linear2 are
// 3.09 a cluster, so most clusters run four (split-K, below).
//
// The design: a warp-specialised, persistent wgmma GEMM.
// - Both operands K-major with the 128-byte swizzle: a K step is 128 codes,
//   one 128-byte row per M or N row, 16-byte chunk c of row r at chunk
//   c ^ (r & 7), which is exactly how a TMA tensor map with
//   CU_TENSOR_MAP_SWIZZLE_128B places a box of 128 codes by its rows; so
//   hopper.cuh's make_desc serves as it is (stride offset = the 1024-byte
//   atom of 8 rows) and each k32 slice advances the descriptor's start by 32
//   bytes. A K step of 64 (the 64-byte swizzle, twice the stages) was slower:
//   0.687 against 0.541 ms at linear1.
// - A producer warpgroup, of which one thread issues the copies: per K step
//   one TMA box of the xq rows and one of the weight's rows into a ring
//   stage, each stage with a "full" mbarrier (the copies' bytes) and an
//   "empty" one (one arrival per consumer warp once its products on the
//   stage are done). It gives back its registers (setmaxnreg 40; the
//   consumers take 232). Rows past M come in as zeros and are never stored,
//   so ragged M needs no padding copy. Each map (xq's, the weight's or its
//   stack's, the output's) is encoded once per address and shape and cached
//   on the host.
// - Clusters of two blocks on neighbouring column tiles (tile 0): each block
//   copies half of the shared A tile into both blocks' stages (TMA
//   multicast) and its own B tile, and each consumer warp releases a stage
//   on both blocks' "empty" mbarriers (a plain CTA-scope arrival on the
//   other's: with .release.cluster the kernel ran at half the rate). A pair
//   whose second column tile lies past N runs it on zeros and stores
//   nothing. Before it exits, the producer waits for the last stages'
//   releases, so no arrival reaches a block that has gone.
// - Consumer warpgroups, each MT m64 tiles of the block's BM rows by BN
//   columns: per K step they wait on "full", issue 4 k32 slices of MT
//   m64nBNk32 s8 wgmmas, and release the step before it once its wgmmas are
//   done (step t's stay in flight). The first step of a tile overwrites the
//   accumulator (scale-d 0) instead of adding to zeroed registers: moves
//   into it made ptxas serialise the wgmmas (C7515).
// - A persistent grid: as many blocks (clusters) as the device holds at
//   once walk the output tiles, M fastest, so the blocks in flight share a
//   few weight column tiles through L2 and the weight streams from device
//   memory about once. The producer runs ahead into the next tile while the
//   consumers finish one, so the ring never drains between tiles.
// - The epilogue from the fragments, its stores drained by TMA: the row
//   scales, column scales and bias are loaded before the tile's products;
//   each 32 columns of a warpgroup's rows go as bf16 into a 64-byte-swizzled
//   staging (4 KB per m64 tile) and out by one TMA store that runs under the
//   next chunk and the next tile's products. With bf16x2 stores straight
//   from the fragments the epilogue added 0.14 ms to the products at
//   linear1 (no copies 0.4415 against MMA alone 0.2984 ms), with the TMA
//   store 0.05; the staging still leaves the ring four stages of 48 KB.
// - Tiles by shape, chosen in Python (ops/quant_matmul.w8a8_tile, which
//   states the same table by id) and passed to the entry points:
//     id  tile       consumers x wgmmas per k32   cluster  stages  blocks/SM
//     0   256 x 128  2 x two m64n128               2        4       1
//     1   64 x 64    1 x one m64n64                1        6       2
//   ms per call on an H100 80GB HBM3 at 700 W, each shape with its epilogue,
//   two turns each in the order parent, this, this, parent
//   (compare_builds.py --w8a8-table): the parent's design (a 4-stage
//   cp.async ring every thread filled, one block per tile), this one,
//   torch._int_mm (no epilogue) and the bound:
//     (M, K, N)            parent          this            _int_mm  bound   x bound
//     (4352, 3072, 21504)  0.5850 0.6301   0.3861 0.4273   0.8064   0.2905  1.40
//     (4352, 15360, 3072)  0.4618 0.4862   0.3446 0.3456   0.5257   0.2075  1.66
//     (4096, 12288, 3072)  0.2616 0.2974   0.2108 0.2251   0.3364   0.1563  1.39
//     (4096, 3072, 12288)  0.3179 0.3845   0.2083 0.2570   0.4588   0.1563  1.49
//     (4096, 3072, 9216)   0.2490 0.2840   0.1557 0.1752   0.3446   0.1172  1.41
//     (4096, 3072, 3072)   0.0915 0.0907   0.0743 0.0740   0.1132   0.0391  1.90
//     (1024, 12288, 3072)  0.0976 0.0973   0.0701 0.0699   0.1157   0.0391  1.79
//     (1280, 3072, 21504)  0.1957 0.2077   0.1246 0.1338   0.2497   0.0855  1.51
//     (256, 3072, 9216)    0.0280 0.0279   0.0211 0.0211   0.0315   0.0101  2.08
//     (256, 12288, 3072)   0.0450 0.0449   0.0392 0.0391   0.0584   0.0132  2.98
//     (256, 3072, 12288)   0.0311 0.0304   0.0247 0.0245   0.0316   0.0134  1.84
//     (256, 3072, 3072)    0.0116 0.0118   0.0120 0.0126   0.0125   0.0040  3.08
//     (4352, 1536, 3072)   0.0705 0.0689   0.0431 0.0428   0.0680   0.0208  2.07
//   (a TP = 2 rank's shape last; the table's other seven shapes:
//   compare_builds.py --w8a8-table). Alone, in one
//   run (ablate_w8a8.py): linear1 0.3713 ms; no MMA 0.3104, no copies
//   0.3539, no epilogue 0.3257, MMA alone 0.3154; 256 x 128 without the
//   cluster 0.4397. 64 x 64 only where 256 x 128 leaves more than half of
//   the SMs idle (M = 256 at N = 3072): 0.0119 against 0.0261 there.
// K must be a positive multiple of 128 and N a multiple of the tile's
// width.
//
// Left for later: split-K or stream-K for N = 3072 (17 x 12 pairs of
// 256 x 128 at M = 4352 are 3.09 a cluster) and M = 256 (s32 partial sums
// are exact, so a split-K stays bit for bit), and K9's row quantization
// folded into K11's A tile.
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types; no libcuda link

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;            // K codes per step: one 128-byte swizzle row
constexpr int kChunk = 32;          // output columns per TMA store (64-byte rows)
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one H100 block
constexpr int kSmemSM = 233472;     // shared memory of one SM; each block also takes 1024
constexpr int kErrUnsupported = 1000;
constexpr int kErrTensorMap = 1001;

enum Mode { kPlain = 0, kBias = 1, kResidual = 2 };

// What the kernel reads besides its three tensor maps; cs already at the
// block of a K8 stack.
struct Args {
  const float* sx;
  const float* cs;
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int m, n, k;
  long long ldr;
  int b_row0;   // the weight's first row in its map: idx * N in a stack
  int tiles_m;  // row tiles
  int tiles;    // units: row tiles x clusters' column tiles (CL of them each)
};

// The shared-memory plan of a block of WGS consumer warpgroups, each MT
// tiles of 64 rows, by BN columns, and one producer warpgroup: a ring of
// stages (their number a parameter of the kernel, set by tile in dispatch),
// each the A tile then the B tile on 1024-byte atoms; each consumer warpgroup's output staging, its rows by
// kChunk columns of bf16 with the 64-byte swizzle; each consumer
// warpgroup's column scales and bias for the epilogue, two tiles' worth; the
// full and the empty mbarriers. One consumer warpgroup alone leaves the
// tensor cores idle between its products: such blocks run kBlocks to an SM.
// CL = 2: clusters of two blocks on column tiles side by side, which share
// the A tile: each loads half of it for both.
template <int WGS, int MT, int BN, int CL>
struct Cfg {
  static constexpr int kConsumers = WGS * 128;
  static constexpr int kArrivals = CL * WGS * 4;  // consumer warps releasing a stage
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kBlocks = WGS == 1 ? 2 : 1;
  static constexpr int BM = WGS * MT * 64;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kStage = kABytes + BN * kBK;
  static constexpr int kOut = MT * 64 * kChunk * 2;    // a warpgroup's staging
  static constexpr int kParams = WGS * 2 * 2 * BN * 4;  // cs and bias, two tiles
  // the dynamic shared memory of a block whose ring has `stages` stages
  __host__ __device__ static constexpr int smem(int stages) {
    return stages * kStage + WGS * kOut + kParams + 16 * stages + kAtom;  // + alignment
  }
  // whether `stages` stages leave the kBlocks blocks of an SM room (each
  // block also takes 1024 bytes of its own)
  __host__ __device__ static constexpr bool fits(int stages) {
    return stages >= 3 &&
           (kBlocks == 1 ? smem(stages) <= kSmemLimit : kBlocks * (smem(stages) + 1024) <= kSmemSM);
  }
  static_assert(BN <= 128 && BN % kChunk == 0, "a consumer thread holds one column's scale");
  static_assert(WGS == 1 || 128 * 40 + kConsumers * 232 <= 65536,
                "the producer's and the consumers' registers (setmaxnreg) fit an SM");
  static_assert(CL == 1 || (CL == 2 && BM % 16 == 0), "the A tile splits in two");
};

// One K step's products: 4 k32 slices of MT m64nBN wgmmas of warpgroup wg on
// the stage at `stage`; scale = 0 (a tile's first step) overwrites the
// accumulator, which is never zeroed: moves into it made ptxas serialise the
// wgmmas (C7515).
template <int WGS, int MT, int BN, int CL>
__device__ __forceinline__ void mma_step(uint32_t (&acc)[MT][BN / 2], uint32_t stage, int wg,
                                         int scale) {
  using C = Cfg<WGS, MT, BN, CL>;
  const uint32_t a0 = stage + wg * MT * 64 * kBK;
  const uint32_t b0 = stage + C::kABytes;
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    // 8-row atoms 1024 bytes apart (SBO); k32 = 32 bytes into the row
    const uint64_t db = make_desc(b0 + ks * 32, 16, kAtom);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wgmma_s8<BN>(acc[mt], make_desc(a0 + mt * 64 * kBK + ks * 32, 16, kAtom), db, scale | ks);
    }
  }
}

// What a consumer thread reads for its tile's epilogue, loaded before the
// tile's products so the loads land under them: the scale of each of its
// rows, and column c = its index in the warpgroup: c's column scale and bias.
template <int MT>
struct Prologue {
  float sx[MT][2];
  float cs, b;
};

template <int WGS, int MT, int BN, int MODE>
__device__ __forceinline__ Prologue<MT> tile_params(const Args& g, int m0, int n0) {
  const int wg = threadIdx.x >> 7;
  const int r0 = m0 + wg * MT * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int c = threadIdx.x & 127;
  Prologue<MT> p;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mt * 64 + h * 8;
      p.sx[mt][h] = r < g.m ? __ldg(g.sx + r) : 0.f;
    }
  }
  const bool col = c < BN && n0 < g.n;  // a cluster's column tile past N stores nothing
  p.cs = col ? __ldg(g.cs + n0 + c) : 0.f;
  p.b = MODE != kPlain && col ? __ldg(g.bias + n0 + c) : 0.f;
  return p;
}

// The residual's words of warpgroup wg's rows in chunk q of the tile, in the
// fragments' layout (0 past M, or past N in a cluster's column tile there).
template <int MT>
__device__ __forceinline__ void load_residual(uint32_t (&res)[MT][kChunk / 8][2], const Args& g,
                                              int m0, int n0, int r0, int q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int jj = 0; jj < kChunk / 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + r0 + mt * 64 + h * 8;
        res[mt][jj][h] = r < g.m && n0 < g.n
                             ? __ldg(reinterpret_cast<const unsigned int*>(
                                   g.res + static_cast<long long>(r) * g.ldr + n0 + q * kChunk +
                                   jj * 8 + (lane & 3) * 2))
                             : 0u;
      }
    }
  }
}

// The epilogue of warpgroup wg's rows, from the fragments (m64nNk32's s32
// fragment is laid out per n8 column block like mma.sync m16n8's: warp w of
// the warpgroup holds rows 16w + (lane >> 2) and 8 below, columns
// 2 (lane & 3) and the next): the column scales and bias through shared
// memory (`par`, this warpgroup's for this tile's parity). Each kChunk
// columns of the warpgroup's rows are written as bf16 into its staging
// (`out`) and stored by one TMA store that drains while the next chunk, and
// then the next tile's products, run; the staging is written again once
// that store has read it. The residual's words of chunk q + 1 are loaded
// while chunk q is written: a store may alias them, so the compiler keeps
// every load behind the stores before it, and loads issued one by one
// between the stores cost 6-9 us a tile.
template <int WGS, int MT, int BN, int MODE>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[MT][BN / 2],
                                           const Prologue<MT>& p, const Args& g,
                                           const CUtensorMap& to, int m0, int n0, float* par,
                                           uint32_t out) {
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int c = threadIdx.x & 127;
  const bool leader = c == 0;
  const int r0 = wg * MT * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // in the tile
  uint32_t res[2][MT][kChunk / 8][2];
  if (MODE == kResidual) load_residual<MT>(res[0], g, m0, n0, r0, 0);
  if (c < BN) {
    par[c] = p.cs;
    par[BN + c] = p.b;
  }
#pragma unroll
  for (int q = 0; q < BN / kChunk; ++q) {
    if (MODE == kResidual && q + 1 < BN / kChunk) {
      load_residual<MT>(res[(q + 1) & 1], g, m0, n0, r0, q + 1);
    }
    if (leader) bulk_wait_read<0>();  // the last store has read the staging
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < kChunk / 8; ++jj) {
      const int j = q * (kChunk / 8) + jj;
      const int cl = j * 8 + (lane & 3) * 2;
      const float2 cs = *reinterpret_cast<const float2*>(par + cl);
      const float2 b = *reinterpret_cast<const float2*>(par + BN + cl);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = p.sx[mt][h];
          float v0 = __fmul_rn(
              __fmul_rn(__int2float_rn(static_cast<int>(acc[mt][4 * j + 2 * h])), s), cs.x);
          float v1 = __fmul_rn(
              __fmul_rn(__int2float_rn(static_cast<int>(acc[mt][4 * j + 2 * h + 1])), s), cs.y);
          if (MODE == kResidual) {
            const __nv_bfloat162 r2 =
                *reinterpret_cast<const __nv_bfloat162*>(&res[q & 1][mt][jj][h]);
            v0 = __fadd_rn(__low2float(r2), v0);
            v1 = __fadd_rn(__high2float(r2), v1);
          }
          if (MODE != kPlain) {
            v0 = __fadd_rn(v0, b.x);
            v1 = __fadd_rn(v1, b.y);
          }
          // row rr of the staging's 64-byte rows: 16-byte chunk jj at
          // jj ^ ((rr >> 1) & 3), as the store's map swizzles it
          const int rr = r0 - wg * MT * 64 + mt * 64 + h * 8;
          const uint32_t at =
              out + rr * (kChunk * 2) + ((jj ^ ((rr >> 1) & 3)) << 4) + (lane & 3) * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(v0, v1)) : "memory");
        }
      }
    }
    fence_proxy_async();  // the staging's writes -> the TMA store
    named_barrier(1 + wg, 128);
    if (leader) {
      tma_store_2d(&to, out, n0 + q * kChunk, m0 + wg * MT * 64);
      bulk_commit();
    }
  }
}

// The producer's copies of K step t of the tile at (m0, n0) into the stage
// at `stage`, counted off the mbarrier at `bar`: the A tile (with CL = 2,
// this block's half of it, for both blocks of the cluster) and the B tile.
template <int WGS, int MT, int BN, int CL>
__device__ __forceinline__ void load_step(const CUtensorMap& ta, const CUtensorMap& tb,
                                          uint32_t stage, uint32_t bar, int t, int m0, int n0,
                                          uint32_t rank, const Args& g) {
  using C = Cfg<WGS, MT, BN, CL>;
  mbar_expect_tx(bar, C::kStage);
  if constexpr (CL == 1) {
    tma_load_2d(stage, &ta, t * kBK, m0, bar);
  } else {
    constexpr int kHalf = C::BM / 2;
    tma_load_2d_multicast(stage + rank * kHalf * kBK, &ta, t * kBK, m0 + rank * kHalf, bar, 3);
  }
  tma_load_2d(stage + C::kABytes, &tb, t * kBK, g.b_row0 + n0, bar);
}

// Release the stage of mbarrier `empty` after this warp's products on it:
// one arrival per consumer warp, on the stage of every block of the cluster
// (with CL = 2 the other block's producer copies into this one's stage too).
template <int CL>
__device__ __forceinline__ void release(uint32_t empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    if constexpr (CL == 1) {
      mbar_arrive(empty);
    } else {
#pragma unroll
      for (int r = 0; r < CL; ++r) mbar_arrive_cluster(empty, r);
    }
  }
}

// WGS consumer warpgroups and one producer warpgroup; BM = WGS x MT x 64
// rows by BN columns per tile, tiles walked by a persistent grid of clusters
// of CL blocks (g.tiles counts the clusters' units: a row tile by CL column
// tiles), each block with a ring of S stages. ta, tb: the xq and weight
// maps; to: the output's.
template <int WGS, int MT, int BN, int CL, int S, int MODE>
__global__ void __launch_bounds__((WGS + 1) * 128, (WGS == 1 ? 2 : 1))
    w8a8_matmul_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap to, const Args g) {
  using C = Cfg<WGS, MT, BN, CL>;
  static_assert(C::fits(S), "three stages or more, and the ring fits the block's share of an SM");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (kAtom - (raw & (kAtom - 1))) & (kAtom - 1);
  const uint32_t base = raw + pad;
  const uint32_t outs = base + S * C::kStage;  // warpgroup w's staging at outs + w kOut
  float* params = reinterpret_cast<float*>(smem_raw + pad + S * C::kStage + WGS * C::kOut);
  const uint32_t full = outs + WGS * C::kOut + C::kParams;  // full[i] at full + 8 i
  const uint32_t empty = full + 8 * S;
  const int steps = g.k / kBK;
  const uint32_t rank = CL == 1 ? 0 : cluster_rank();
  const int unit0 = blockIdx.x / CL;  // this cluster's first unit, and their stride
  const int units = gridDim.x / CL;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, C::kArrivals);
    }
    mbar_init_fence();
  }
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cluster_sync();  // every block's mbarriers are set before any copy or arrival
  }

  // the role by warpgroup, made visibly uniform across each warp for
  // setmaxnreg
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WGS) {  // the producer
    if constexpr (WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == C::kConsumers) {
      prefetch_tensormap(&ta);
      prefetch_tensormap(&tb);
      int it = 0;  // K steps issued by this block, over its tiles
      for (int unit = unit0; unit < g.tiles; unit += units) {
        const int m0 = (unit % g.tiles_m) * C::BM;
        const int n0 = ((unit / g.tiles_m) * CL + rank) * BN;
        for (int t = 0; t < steps; ++t, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          load_step<WGS, MT, BN, CL>(ta, tb, base + st * C::kStage, full + 8 * st, t, m0, n0,
                                     rank, g);
          if (MODE == kResidual && t == 0 && n0 < g.n) {  // the tile's residual into L2
            for (int r = m0; r < m0 + C::BM && r < g.m; ++r) {
              prefetch_l2(g.res + static_cast<long long>(r) * g.ldr + n0, BN * 2);
            }
          }
        }
      }
      // every stage released by every block's consumers: no arrival from
      // the other block comes to this one after it has exited
      for (int i = it > S ? it - S : 0; CL > 1 && i < it; ++i) {
        mbar_wait(empty + 8 * (i % S), (i / S) & 1);
      }
    }
  } else {
    if constexpr (WGS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    uint32_t acc[MT][BN / 2];
    int it = 0;  // K steps consumed by this block, over its tiles
    int parity = 0;
    for (int unit = unit0; unit < g.tiles; unit += units, parity ^= 1) {
      const int m0 = (unit % g.tiles_m) * C::BM;
      const int n0 = ((unit / g.tiles_m) * CL + rank) * BN;
      const Prologue<MT> p = tile_params<WGS, MT, BN, MODE>(g, m0, n0);
      for (int t = 0; t < steps; ++t, ++it) {
        const int st = it % S;
        mbar_wait(full + 8 * st, (it / S) & 1);  // step t has landed
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
        wgmma_fence();
        mma_step<WGS, MT, BN, CL>(acc, base + st * C::kStage, wg, t > 0);
        wgmma_commit();
        wgmma_wait<1>();  // step t - 1's wgmmas are done
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
        if (t > 0) release<CL>(empty + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
      release<CL>(empty + 8 * ((it - 1) % S));
      store_tile<WGS, MT, BN, MODE>(acc, p, g, to, m0, n0, params + (wg * 2 + parity) * 2 * BN,
                                    outs + wg * C::kOut);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait<0>();  // the last stores have landed
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of `rows` rows of `cols` elements (int8 codes, or bf16 for the
// output), `stride` bytes apart: boxes of kBK codes by box_rows rows with the
// 128-byte swizzle (the operands, rows past the end read as zeros), or of
// kChunk bf16 by box_rows rows with the 64-byte swizzle (the output, rows
// past the end not written).
int encode(CUtensorMap* map, const void* base, long long rows, long long cols, long long stride,
           int box_rows, bool out = false) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrTensorMap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(out ? kChunk : kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, out ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
         const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         out ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The maps, encoded once each: a map holds only the address, the shape and
// the box, so a key of those names it whatever the bytes are. The weights'
// addresses stay, and torch's allocator hands the activations and the
// outputs the same few addresses call after call, so all three maps of a
// launch are nearly always found.
struct MapKey {
  const void* base;
  long long rows, cols, stride;
  int box_rows;
  bool out;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && cols == o.cols && stride == o.stride &&
           box_rows == o.box_rows && out == o.out;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.base);
    for (long long v : {k.rows, k.cols, k.stride, static_cast<long long>(k.box_rows),
                        static_cast<long long>(k.out)}) {
      h = h * 1000003u ^ std::hash<long long>()(v);
    }
    return h;
  }
};

int cached_map(CUtensorMap* map, const void* base, long long rows, long long cols,
               long long stride, int box_rows, bool out = false) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{base, rows, cols, stride, box_rows, out};
  std::lock_guard<std::mutex> hold(lock);
  const auto hit = maps.find(key);
  if (hit != maps.end()) {
    *map = hit->second;
    return 0;
  }
  const int rc = encode(map, base, rows, cols, stride, box_rows, out);
  if (rc != 0) return rc;
  if (maps.size() >= 4096) maps.clear();  // buffers freed and drawn anew
  maps.emplace(key, *map);
  return 0;
}

// The streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// A launch as the entry points give it: b at its stack's first block,
// b_rows its map's rows (depth x N), b_row0 the block's first row.
struct Problem {
  const void* a;
  const float* sx;
  const void* b;
  const float* cs;
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int m, n, k;
  long long lda, ldb, ldr;
  long long b_rows;
  int b_row0;
};

// The clusters of cl blocks of `kernel` that the device holds at once (the
// persistent grid's size), after its shared-memory attribute is set; 0 when
// the attribute is refused.
template <class Kernel>
int resident_clusters(Kernel kernel, int cl, int threads, int smem, int blocks) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess) {
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cl * (sm_count() / cl));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1) {
    n = sm_count() * blocks / cl;
  }
  return n;
}

template <int WGS, int MT, int BN, int CL, int S, int MODE>
int run(const Problem& p, cudaStream_t stream) {
  using C = Cfg<WGS, MT, BN, CL>;
  if (p.n % BN != 0) return kErrUnsupported;
  CUtensorMap ta, tb, to;
  int rc = cached_map(&ta, p.a, p.m, p.k, p.lda, C::BM / CL);
  if (rc == 0) rc = cached_map(&tb, p.b, p.b_rows, p.k, p.ldb, BN);
  if (rc == 0) rc = cached_map(&to, p.out, p.m, p.n, 2LL * p.n, MT * 64, true);
  if (rc != 0) return rc;
  auto kernel = w8a8_matmul_kernel<WGS, MT, BN, CL, S, MODE>;
  static int resident[64] = {};  // this instantiation's clusters, set up once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return kErrUnsupported;
  if (resident[dev] == 0) {
    resident[dev] = resident_clusters(kernel, CL, C::kThreads, C::smem(S), C::kBlocks);
  }
  const int slots = resident[dev];
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = p.n / BN;
  Args g{p.sx, p.cs, p.bias, p.res, p.out, p.m, p.n, p.k, p.ldr, p.b_row0,
         (p.m + C::BM - 1) / C::BM, 0};
  g.tiles = g.tiles_m * ((tiles_n + CL - 1) / CL);  // units of a row tile by CL column tiles
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(CL * (g.tiles < slots ? g.tiles : slots));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::smem(S);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, ta, tb, to, g);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The tiles by id, as ops/quant_matmul.W8A8_TILES states them: (consumer
// warpgroups, m64 tiles per warpgroup, BN, blocks a cluster, ring stages:
// as many as fit the block's share of an SM).
template <int MODE>
int dispatch(int tile, const Problem& p, cudaStream_t s) {
  switch (tile) {
    case 0: return run<2, 2, 128, 2, 4, MODE>(p, s);  // 256 x 128, pairs sharing A
    case 1: return run<1, 1, 64, 1, 6, MODE>(p, s);   // 64 x 64, two blocks an SM
  }
  return kErrUnsupported;
}

int launch(const Problem& p, int tile, void* stream) {
  const int mode = p.bias == nullptr ? kPlain : (p.res == nullptr ? kBias : kResidual);
  const auto misaligned = [](const void* q, int bytes) {
    return reinterpret_cast<uintptr_t>(q) % bytes != 0;
  };
  if (p.m < 1 || p.n < 1 || p.k < kBK || p.k % kBK != 0 || p.lda < p.k || p.lda % 16 != 0 ||
      p.ldb < p.k || p.ldb % 16 != 0 || misaligned(p.a, 16) || misaligned(p.b, 16) ||
      misaligned(p.out, 16) ||
      (mode == kResidual && (p.ldr < p.n || p.ldr % 8 != 0 || misaligned(p.res, 16)))) {
    return kErrUnsupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kResidual) return dispatch<kResidual>(tile, p, s);
  if (mode == kBias) return dispatch<kBias>(tile, p, s);
  return dispatch<kPlain>(tile, p, s);
}

// The rows of a stack of depth blocks of n rows, and block idx's first row;
// false outside the stack.
bool stack_rows(int depth, int idx, int n, long long& rows, int& row0) {
  if (idx < 0 || idx >= depth || static_cast<long long>(depth) * n >= (1LL << 31)) return false;
  rows = static_cast<long long>(depth) * n;
  row0 = idx * n;
  return true;
}

}  // namespace

// K7. xq (M, K) int8 with row stride lda, sx (M,) f32, q (N, K) int8 with
// row stride ldb (both strides multiples of 16), cs (N,) f32, out (M, N)
// bf16 contiguous; every pointer 16-byte aligned. ``k`` is the number of K
// bytes summed (a multiple of 128); ``tile`` the tile's id
// (ops/quant_matmul.w8a8_tile).
extern "C" int ldt_w8a8_matmul_fwd(const void* xq, const void* sx,
                                   const void* q, const void* cs, void* out,
                                   int m, int n, int k, long long lda,
                                   long long ldb, int tile, void* stream) {
  const Problem p{xq, static_cast<const float*>(sx), q, static_cast<const float*>(cs), nullptr,
                  nullptr, static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, 0, n, 0};
  return launch(p, tile, stream);
}

// K11. As K7 with bias (N,) f32 and, when res is not null, the residual
// (M, N) bf16, 16-byte aligned, with row stride ldr (a multiple of 8).
extern "C" int ldt_w8a8_matmul_ep_fwd(const void* xq, const void* sx,
                                      const void* q, const void* cs,
                                      const void* bias, const void* res,
                                      void* out, int m, int n, int k,
                                      long long lda, long long ldb,
                                      long long ldr, int tile, void* stream) {
  if (bias == nullptr) return kErrUnsupported;
  const Problem p{xq, static_cast<const float*>(sx), q, static_cast<const float*>(cs),
                  static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
                  static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, ldr, n, 0};
  return launch(p, tile, stream);
}

// K8. As K7 on block idx (0 <= idx < depth) of q3 (depth, N, K) int8 with
// row stride ldb, and of cs3 (depth, 1, N) f32; both contiguous.
extern "C" int ldt_w8a8_matmul_stacked_fwd(const void* xq, const void* sx,
                                           const void* q3, const void* cs3,
                                           void* out, int m, int n, int k,
                                           long long lda, long long ldb,
                                           int tile, int depth, int idx,
                                           void* stream) {
  long long rows;
  int row0;
  if (!stack_rows(depth, idx, n, rows, row0)) return kErrUnsupported;
  const Problem p{xq, static_cast<const float*>(sx), q3,
                  static_cast<const float*>(cs3) + static_cast<long long>(idx) * n, nullptr,
                  nullptr, static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, 0, rows, row0};
  return launch(p, tile, stream);
}

// The stacked K11. As K11 on block idx (0 <= idx < depth) of q3 (depth, N,
// K) int8 with row stride ldb; cs (N,) and bias (N,) are the caller's folds
// of that block's column scales.
extern "C" int ldt_w8a8_matmul_ep_stacked_fwd(
    const void* xq, const void* sx, const void* q3, const void* cs,
    const void* bias, const void* res, void* out, int m, int n, int k,
    long long lda, long long ldb, long long ldr, int tile, int depth, int idx,
    void* stream) {
  long long rows;
  int row0;
  if (bias == nullptr || !stack_rows(depth, idx, n, rows, row0)) return kErrUnsupported;
  const Problem p{xq, static_cast<const float*>(sx), q3, static_cast<const float*>(cs),
                  static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
                  static_cast<__nv_bfloat16*>(out), m, n, k, lda, ldb, ldr, rows, row0};
  return launch(p, tile, stream);
}

extern "C" const char* ldt_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported";
  if (code == kErrTensorMap) return "tensor map not encoded (cuTensorMapEncodeTiled)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
