// Grouped matmul for the MoE expert products, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py (gmm_padded /
// _gmm_kernel, with the padding of pad_groups and the gather-back of gmm):
// out[t] = x[t] @ w[g(t)] for rows x [T, D] sorted by expert, weights
// w [E, D, F] and the experts' row counts group_sizes [E] (int32, on the
// device, summing to T), fp32 accumulation, the output in x's dtype.
//
// Design. The TPU kernel pads each expert's rows to whole row tiles in a
// buffer of T + E * BT rows, so that a tile never spans two experts, and
// gathers the real rows back afterwards; every padding row multiplies a
// real expert's weights. Here nothing is padded or copied. The grid is
// sized for the worst case, min(T, ceil(T / BM) + E) row tiles (a live tile
// holds at least one row) by ceil(F / BN) column tiles; each block reads
// the E group sizes, finds from their prefix which expert and which run of
// at most BM of its rows its row-tile index names, and exits at once when
// the index lies past the live tiles. Row tiles are the fastest grid axis,
// so the tiles of one expert that are in flight together read the same
// column tile of its weights, and that tile comes from device memory once.
// Two kernels share the schedule:
//  * bfloat16 (the served path): a Hopper kernel on wgmma. A block of 384
//    threads computes a BM x 256 output tile (BM = 128, or 64 on the split
//    path at decode): one producer warpgroup, whose single elected thread
//    TMA-loads each 64-deep stage (an x box of BM rows, K-major, through a
//    2-D map over [T, D]; four weight boxes of 64 x 64, MN-major, through a
//    3-D map over [E, D, F]) into a ring of 4-5 stages of 40-48 KB tracked
//    by mbarriers, so that ~200 KB of loads are in flight on each SM; and
//    two consumer warpgroups (setmaxnreg 240 against the producer's 24)
//    that run m64nNk16 wgmmas with both operands in shared memory, the
//    weights through the transpose bit of B. A tile may start at any row:
//    TMA takes any coordinate, and rows past the expert's run (the next
//    expert's, or zeros past T) are multiplied and masked in the store, as
//    are the columns past F; the depth tail past D loads as zeros.
//    At decode (T <= 64, known on the host) a tile holds every row of its
//    expert and the tiles are few (phi3.5-moe: 2 experts x 25 column tiles),
//    so D is split over `splits` blocks of each tile, each writing fp32
//    partial sums to [splits, T, F]; a second small kernel adds them in
//    split order (no atomics: the result does not depend on block order)
//    and rounds to bf16.
//  * float32: CUDA-core FMAs on 32 x 64 tiles in shared memory, each thread
//    a 2 x 4 micro-tile, so that float32 stays float32 (tensor cores would
//    round it to TF32).
//
// What bounds it. At a served prefill (phi3.5-moe, 1024 tokens: 2048 routed
// rows over 16 experts of [4096, 6400]) every expert's weights are read once,
// 839 MB of bf16 a call, against 107 GFLOP: ~122 flops a byte, below the
// ~295 a byte at which the H100 turns from bytes to operations, so the call
// is bound by the weight bytes, and what the kernel must do is keep enough
// loads in flight (Little's law: ~3.35 TB/s x ~1 us of latency spread over
// 132 SMs). At decode (2 to 8 rows) the work is streaming the chosen
// experts' weights once: bytes again, which the split of D spreads over
// enough blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The run of rows that a row-tile index names: its expert (-1 when the index
// lies past the live tiles), its first row and its row count.
struct Tile {
  int expert, row0, rows;
};

// Warp 0 reads the group sizes: each lane sums the rows and the BT-row tiles
// of ceil(E / 32) consecutive experts, a shuffle scan gives every lane the
// tiles and rows before its experts, and the lane whose experts hold the
// tile writes it out. Every thread of the block gets the same answer.
template <int BT>
__device__ __forceinline__ Tile find_tile(const int* __restrict__ sizes, int E, int tile) {
  __shared__ Tile found;
  if (threadIdx.x == 0) found = Tile{-1, 0, 0};
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int e0 = min(E, lane * per), e1 = min(E, e0 + per);
    int tiles = 0, rows = 0;
    for (int e = e0; e < e1; ++e) {
      const int n = sizes[e];
      rows += n;
      tiles += (n + BT - 1) / BT;
    }
    int t_end = tiles, r_end = rows;  // inclusive prefix over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, t_end, o);
      const int r = __shfl_up_sync(0xffffffffu, r_end, o);
      if (lane >= o) {
        t_end += t;
        r_end += r;
      }
    }
    int t0 = t_end - tiles, r0 = r_end - rows;
    if (tile >= t0 && tile < t_end) {
      for (int e = e0; e < e1; ++e) {
        const int n = sizes[e];
        const int nt = (n + BT - 1) / BT;  // 0 for an expert with no rows
        if (tile < t0 + nt) {
          const int first = (tile - t0) * BT;
          found = Tile{e, r0 + first, min(BT, n - first)};
          break;
        }
        t0 += nt;
        r0 += n;
      }
    }
  }
  __syncthreads();
  return found;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA, one producer warp, two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BN = 256;             // output columns per block
constexpr int BK = 64;              // depth per stage: one 128-byte swizzled row
constexpr int WG_THREADS = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr int WG_CONSUMERS = 256;
constexpr int SMEM_MAX = 232448;    // what a block may ask for on sm_90
constexpr int W_CHUNK = BK * 128;   // one 64-column chunk of a weight tile, bytes

// Tiles and shared memory at a row-tile height of BM (64 or 128). A stage is
// an x tile [BM][64] and a weight tile of 4 column chunks [64][64], each as
// one TMA box writes it with the 128-byte swizzle. At BM = 128 each consumer
// warpgroup owns 64 rows and all 256 columns; at BM = 64 both own the 64
// rows and 128 columns each.
template <int BM>
struct GmmCfg {
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (SMEM_MAX - 1024 - BAR_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int WN = BM == 128 ? BN : BN / 2;   // columns per warpgroup
  static_assert(STAGES >= 4, "the ring needs four stages in flight");
  // 1024: slack to round the base up to the swizzle atoms' boundary
  static constexpr size_t bytes = 1024 + static_cast<size_t>(STAGES) * STAGE + BAR_BYTES;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// One (row tile, 256-column tile) of the output, over the depth steps
// [k_begin, k_end) of blockIdx.z's share (all of D without a split). Threads
// 0-255 are the consumers, 256-383 the producer, of which one thread starts
// every TMA load: per stage the x boxes that hold the tile's rows (boxes of
// x_box rows from the tile's first row, 64 columns of D: one or two of 64
// rows at BM = 128, one of 64 at BM = 64, one of T rounded up to 8 on the
// split path) and four weight boxes (64 rows of D, 64 columns of F, of the
// tile's expert). Rows past the expert's run are loaded and multiplied (they
// belong to the next expert, or are zeros past T) and never stored; so are
// the x tile's rows that no box covers, whatever the stage held. The depth
// tail past D and the columns past F load as zeros. Without a
// split the block writes bf16 rows of `out`; with one it writes its fp32
// partial sums to `partial` [splits][T][F], which gmm_sum_splits adds up.
template <int BM, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1) gmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const int* __restrict__ sizes, bf16* __restrict__ out, float* __restrict__ partial, int T,
    int D, int F, int E, int k_per_split, int x_box) {
  namespace hp = repro::hopper;
  using C = GmmCfg<BM>;
  constexpr int S = C::STAGES, WN = C::WN;
  const Tile tile = find_tile<BM>(sizes, E, blockIdx.x);
  if (tile.expert < 0) return;  // past the live tiles: the whole block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = base;                       // stage s at xs + s * X_BYTES
  unsigned char* ws = xs + S * C::X_BYTES;        // stage s at ws + s * W_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + S * C::W_BYTES);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.y * BN;
  const int n_k = (D + BK - 1) / BK;
  const int k_begin = SPLIT ? blockIdx.z * k_per_split : 0;
  const int k_end = SPLIT ? min(n_k, k_begin + k_per_split) : n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], WG_CONSUMERS);
    }
    hp::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // ---- producer ----
    hp::reg_dealloc<24>();
    if (threadIdx.x == WG_CONSUMERS) {
      const int n_box = (tile.rows + x_box - 1) / x_box;
      for (int kt = k_begin, i = 0; kt < k_end; ++kt, ++i) {
        const int s = i % S;
        const uint32_t ph = (i / S) & 1;
        hp::mbar_wait(&empty[s], ph ^ 1);
        hp::mbar_expect_tx(&full[s], n_box * x_box * 128 + C::W_BYTES);
        for (int r = 0; r < n_box; ++r)
          hp::tma_load_2d(xs + s * C::X_BYTES + r * x_box * 128, &tx, &full[s], kt * BK,
                          tile.row0 + r * x_box);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hp::tma_load_3d(ws + s * C::W_BYTES + c * W_CHUNK, &tw, &full[s], n0 + 64 * c,
                          kt * BK, tile.expert);
      }
    }
    return;
  }

  // ---- consumers ----
  hp::reg_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_off = BM == 128 ? 64 * wg : 0;    // this warpgroup's rows
  const int col_off = BM == 128 ? 0 : WN * wg;    // and columns, in the tile
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  // x K-major: SBO = 8 rows of 128 bytes, k-step kk 32 bytes into the row;
  // w MN-major: SBO = 8 rows of D, LBO = the column chunk's stride, k-step
  // kk 16 rows down
  const uint64_t dx = hp::make_desc(xs + row_off * 128, 16, 1024, hp::desc_layout(128));
  const uint64_t dw = hp::make_desc(ws + (col_off / 64) * W_CHUNK, W_CHUNK, 1024,
                                    hp::desc_layout(128));
  for (int kt = k_begin, i = 0; kt < k_end; ++kt, ++i) {
    const int s = i % S;
    const uint32_t ph = (i / S) & 1;
    hp::mbar_wait(&full[s], ph);
    hp::reg_fence(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hp::wgmma_ss_mn<WN>(acc, hp::desc_add(dx, s * C::X_BYTES + 32 * kk),
                          hp::desc_add(dw, s * C::W_BYTES + kk * 16 * 128), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::reg_fence(acc);
    hp::mbar_arrive(&empty[s]);
  }

  // element e: row row_off + 16 * warp + g + 8 * ((e >> 1) & 1), column
  // n0 + col_off + 8 * (e >> 2) + 2 * t4 + (e & 1); F is a multiple of 8, so
  // a pair of columns is all in or all out
  const int r_base = row_off + (tid / 32) * 16 + g;
  const int c_base = n0 + col_off + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + 8 * h;
    if (r >= tile.rows) continue;
    const size_t row = static_cast<size_t>(tile.row0 + r);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int c = c_base + 8 * j;
      if (c >= F) continue;
      const float lo = acc[4 * j + 2 * h], hi = acc[4 * j + 2 * h + 1];
      if (SPLIT) {
        float* p = partial + (static_cast<size_t>(blockIdx.z) * T + row) * F + c;
        *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
      } else {
        *reinterpret_cast<uint32_t*>(out + row * F + c) = pack_bf16(lo, hi);
      }
    }
  }
}

// out = the sum of the split partials [splits][n] (n = T * F), in split
// order, rounded to bf16: two elements a thread
__global__ void __launch_bounds__(256) gmm_sum_splits_kernel(const float* __restrict__ partial,
                                                             bf16* __restrict__ out, int splits,
                                                             size_t n) {
  const size_t i = 2 * (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x);
  if (i >= n) return;
  float2 sum = *reinterpret_cast<const float2*>(partial + i);
  for (int z = 1; z < splits; ++z) {
    const float2 v = *reinterpret_cast<const float2*>(partial + z * n + i);
    sum.x += v.x;
    sum.y += v.y;
  }
  *reinterpret_cast<uint32_t*>(out + i) = pack_bf16(sum.x, sum.y);
}

template <int BM, bool SPLIT>
cudaError_t launch_wgmma(const void* x, const void* w, const int* sizes, void* out,
                         void* partial, int T, int D, int F, int E, int splits,
                         cudaStream_t s) {
  namespace hp = repro::hopper;
  using C = GmmCfg<BM>;
  CUtensorMap tx, tw;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(T)};
  // x in boxes of 64 rows (of T rounded up to a swizzle atom of 8 on the
  // split path, where a tile holds at most T rows), so that a block loads
  // only the boxes its rows reach
  const int x_rows = SPLIT ? (T + 7) / 8 * 8 : 64;
  const uint32_t x_box[2] = {BK, static_cast<uint32_t>(x_rows)};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                              static_cast<uint64_t>(E)};
  const uint32_t w_box[3] = {64, BK, 1};
  cudaError_t err = hp::encode_bf16<2>(&tx, x, x_dims, x_box, 128);
  if (err == cudaSuccess) err = hp::encode_bf16<3>(&tw, w, w_dims, w_box, 128);
  if (err != cudaSuccess) return err;
  const int n_k = (D + BK - 1) / BK;
  const int k_per = (n_k + splits - 1) / splits;
  if (SPLIT && (n_k + k_per - 1) / k_per != splits) return cudaErrorInvalidValue;
  // a live tile holds at least one row, so there are at most T of them
  const int tiles = (T + BM - 1) / BM + E;
  const dim3 grid(tiles < T ? tiles : T, (F + BN - 1) / BN, SPLIT ? splits : 1);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma_kernel<BM, SPLIT>;
  err = repro::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, C::bytes, s>>>(tx, tw, sizes, static_cast<bf16*>(out),
                                            static_cast<float*>(partial), T, D, F, E, k_per,
                                            x_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  const size_t n = static_cast<size_t>(T) * F;
  gmm_sum_splits_kernel<<<static_cast<unsigned>((n / 2 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(out), splits, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int FT = 32;    // rows per tile
constexpr int FN = 64;    // columns per tile
constexpr int FK = 32;    // depth per step
constexpr int FTH = 256;  // threads: 16 x 16, each 2 rows x 4 columns

__global__ void __launch_bounds__(FTH) gmm_f32_kernel(const float* __restrict__ x,
                                                      const float* __restrict__ w,
                                                      const int* __restrict__ sizes,
                                                      float* __restrict__ out, int D, int F,
                                                      int E) {
  const Tile tile = find_tile<FT>(sizes, E, blockIdx.x);
  if (tile.expert < 0) return;
  __shared__ float xs[FT][FK + 1];
  __shared__ __align__(16) float ws[FK][FN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.y * FN;
  const float* xb = x + static_cast<size_t>(tile.row0) * D;
  const float* wb = w + static_cast<size_t>(tile.expert) * D * F;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < D; k0 += FK) {
    __syncthreads();  // the previous step's readers are done
    for (int i = tid; i < FT * FK; i += FTH) {
      const int r = i / FK, c = i % FK;
      xs[r][c] = r < tile.rows && k0 + c < D ? xb[static_cast<size_t>(r) * D + k0 + c] : 0.f;
    }
    for (int i = tid; i < FK * FN; i += FTH) {
      const int r = i / FN, c = i % FN;
      ws[r][c] = k0 + r < D && n0 + c < F ? wb[static_cast<size_t>(k0 + r) * F + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FK; ++kk) {
      const float a0 = xs[2 * ty][kk], a1 = xs[2 * ty + 1][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] = fmaf(a0, bv[j], acc[0][j]);
        acc[1][j] = fmaf(a1, bv[j], acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
    if (r >= tile.rows) continue;
    float* orow = out + static_cast<size_t>(tile.row0 + r) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < F) orow[c] = acc[i][j];
    }
  }
}

}  // namespace

// x [T,D] and out [T,F] in dtype, w [E,D,F] in dtype, sizes [E] int32 on the
// device, summing to T. All contiguous, x and w 16-byte aligned; D and F
// multiples of 8. bfloat16 only: tiles of 128 rows, or with `partial`
// [splits][T][F] fp32 (T at most 64) tiles of 64 rows whose D is split over
// `splits` blocks, the partial sums added by a second kernel. Returns the
// first launch error; the kernels run on `stream`.
extern "C" int repro_gmm_fwd(const void* x, const void* w, const void* sizes, void* out,
                             void* partial, int dtype, int T, int D, int F, int E,
                             int splits, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || D % 8 != 0 || F % 8 != 0 || splits < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(sizes);
  if (dtype == repro::kBFloat16) {
    if (partial != nullptr) {
      if (T > 64) return cudaErrorInvalidValue;
      return launch_wgmma<64, true>(x, w, gs, out, partial, T, D, F, E, splits, s);
    }
    if (splits != 1) return cudaErrorInvalidValue;
    return launch_wgmma<128, false>(x, w, gs, out, nullptr, T, D, F, E, 1, s);
  }
  if (dtype == repro::kFloat32) {
    if (splits != 1) return cudaErrorInvalidValue;
    const dim3 grid((T + FT - 1) / FT + E, (F + FN - 1) / FN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, FTH, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w), gs,
                                        static_cast<float*>(out), D, F, E);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
