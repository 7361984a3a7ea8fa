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
// sized for the worst case, ceil(T / BT) + E row tiles by ceil(F / BN)
// column tiles; each block reads the E group sizes, finds from their prefix
// which expert and which run of at most BT of its rows its row-tile index
// names, and exits at once when the index lies past the live tiles. Rows of
// a tile past its expert's last row, and columns past F, are masked in the
// loads (zero fill) and in the stores, so a tile writes only its own
// expert's rows, and an expert with no rows costs nothing. Row tiles are
// the fastest grid axis, so the tiles of one expert that are in flight
// together read the same column tile of its weights, and that tile comes
// from device memory once.
// Two kernels share the schedule:
//  * bfloat16 (the served path): tensor cores through mma.sync m16n8k16
//    bf16 -> fp32, the idiom of flash_attention.cu. A block of 4 warps
//    computes a 64 x 64 output tile, each warp a 32 x 32 quarter; x and w
//    tiles 64 deep are staged in shared memory by cp.async in a ring of 3
//    stages, so the next tiles' loads are in flight while one is multiplied.
//    A warp whose 32 rows are all past the tile's rows (decode: 1 to 8 rows
//    an expert) loads its share and skips the products.
//  * float32: CUDA-core FMAs on 32 x 64 tiles in shared memory, each thread
//    a 2 x 4 micro-tile, so that float32 stays float32 (tensor cores would
//    round it to TF32).
//
// What bounds it. At a served prefill (phi3.5-moe, 1024 tokens: 2048 routed
// rows over 16 experts of [4096, 6400]) every expert's weights are read once,
// 839 MB of bf16 a call, against 107 GFLOP: ~122 flops a byte, below the
// ~295 a byte at which the H100 turns from bytes to operations, so the call
// is bound by the weight bytes. At decode (2 to 8 rows) the work is streaming
// the chosen experts' weights once: bytes again, and the column tiles give
// the blocks (phi3.5-moe's wi: 100 column tiles x 2 experts). mma.sync fed
// by cp.async reaches part of what wgmma with TMA-fed tiles and a persistent
// schedule reach; that is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
// bfloat16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int BT = 64;      // rows per tile
constexpr int BN = 64;      // columns per tile
constexpr int BK = 64;      // depth per stage
constexpr int STAGES = 3;   // cp.async ring
constexpr int NT = 128;     // threads (4 warps, 2 x 2 over the tile)
// Rows of the staged tiles are padded by 8 elements (16 bytes), so that the
// 8 rows a fragment load touches start 4 banks apart and the 16-byte chunks
// stay aligned.
constexpr int XS = BK + 8;
constexpr int WS = BN + 8;
constexpr int X_TILE = BT * XS;
constexpr int W_TILE = BK * WS;
constexpr size_t SMEM_BF16 = STAGES * (X_TILE + W_TILE) * sizeof(bf16);

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 sum
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 bf16 tiles: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(NT) gmm_bf16_kernel(const bf16* __restrict__ x,
                                                      const bf16* __restrict__ w,
                                                      const int* __restrict__ sizes,
                                                      bf16* __restrict__ out, int D, int F,
                                                      int E) {
  const Tile tile = find_tile<BT>(sizes, E, blockIdx.x);
  if (tile.expert < 0) return;  // past the live tiles: the whole block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BT][XS]
  bf16* ws = xs + STAGES * X_TILE;               // [STAGES][BK][WS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int wm = warp / 2, wn = warp % 2;  // this warp's 32 x 32 quarter
  const bool live = wm * 32 < tile.rows;
  const int n0 = blockIdx.y * BN;
  const bf16* xb = x + static_cast<size_t>(tile.row0) * D;
  const bf16* wb = w + static_cast<size_t>(tile.expert) * D * F;
  const int n_k = (D + BK - 1) / BK;

  // D and F are multiples of 8, so a 16-byte chunk is all in or all out
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* xd = xs + stage * X_TILE;
    bf16* wd = ws + stage * W_TILE;
    for (int i = tid; i < BT * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool in = r < tile.rows && k0 + c < D;
      cp_async16(xd + r * XS + c, in ? xb + static_cast<size_t>(r) * D + k0 + c : xb, in);
    }
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool in = k0 + r < D && n0 + c < F;
      cp_async16(wd + r * WS + c, in ? wb + static_cast<size_t>(k0 + r) * F + n0 + c : wb, in);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();  // one group per stage, empty or not, keeps the count
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // everyone's part; and stage (kt-1) is free
    const int next = kt + STAGES - 1;
    if (next < n_k) load(next % STAGES, next);
    cp_async_commit();
    if (!live) continue;
    const bf16* xt = xs + (kt % STAGES) * X_TILE;
    const bf16* wt = ws + (kt % STAGES) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* xr = xt + (wm * 32 + mi * 16 + g) * XS + kk + t4 * 2;
        a[mi][0] = ld32(xr);
        a[mi][1] = ld32(xr + 8 * XS);
        a[mi][2] = ld32(xr + 8);
        a[mi][3] = ld32(xr + 8 * XS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, wt + (kk + lane % 16) * WS + wn * 32 + ni * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }

  // element (mi, ni, e): row wm*32 + mi*16 + g (+8 for e >= 2), column
  // n0 + wn*32 + ni*8 + 2*t4 + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mi * 16 + g + 8 * h;
      if (r >= tile.rows) continue;
      bf16* orow = out + static_cast<size_t>(tile.row0 + r) * F;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (c < F)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
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
// device, summing to T (rows past the sum are not written). All contiguous,
// x and w 16-byte aligned; D and F multiples of 8. Returns the launch's
// cudaError_t; the kernel runs on `stream`.
extern "C" int repro_gmm_fwd(const void* x, const void* w, const void* sizes, void* out,
                             int dtype, int T, int D, int F, int E, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || D % 8 != 0 || F % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(sizes);
  if (dtype == repro::kBFloat16) {
    const dim3 grid((T + BT - 1) / BT + E, (F + BN - 1) / BN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = repro::allow_smem(gmm_bf16_kernel, SMEM_BF16);
    if (err != cudaSuccess) return err;
    gmm_bf16_kernel<<<grid, NT, SMEM_BF16, s>>>(static_cast<const bf16*>(x),
                                                static_cast<const bf16*>(w), gs,
                                                static_cast<bf16*>(out), D, F, E);
    return cudaGetLastError();
  }
  if (dtype == repro::kFloat32) {
    const dim3 grid((T + FT - 1) / FT + E, (F + FN - 1) / FN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, FTH, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w), gs,
                                        static_cast<float*>(out), D, F, E);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
