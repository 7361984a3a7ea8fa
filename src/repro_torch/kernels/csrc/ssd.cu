// Mamba2 SSD chunked scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd / _ssd_kernel):
// per chunk of L positions,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//          + exp(cum_i) C_i @ state + D x_i                           (inter)
//   state' = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
// with cum the inclusive cumsum of A dt over the chunk. B and C are shared by
// all heads (G = 1). The arithmetic is float32's; x and y are float or
// bfloat16.
//
// Products. Every product runs on the tensor cores with TF32 inputs and
// float32 accumulators, each float32 operand v split into two TF32 pieces,
// hi = v rounded to TF32 and lo = v - hi, which together carry float32's
// precision to 2^-21. A B is then A_lo B_hi + A_hi B_lo + A_hi B_hi; the term
// left out, A_lo B_lo, is 2^-22 of A B. x in bfloat16 is exact in TF32, so the
// products with x (the band times x, the weighted B^T times x) take two
// terms, A_lo x + A_hi x; with float32 x they take three, as C.B^T and C
// times the state always do. No product of a float32 operand is a single
// TF32 pass. The tensor cores truncate as they accumulate, so no sum runs
// through their accumulator for more than one staged step: each step's
// partial is added to float32 registers (rounded to nearest). The large
// products are warpgroup products (wgmma m64n64k8: A, the split band or
// weighted B^T, from registers; B, x or the state, from a K-major tile in
// shared memory, transposed and split there once a step); C.B^T, a few
// percent of the work, is mma.sync m16n8k8.
//
// Design: three kernels, launched back to back on one stream.
//  1. ssd_state_kernel. Its first blocks form C.B^T for every chunk and
//     every 64 x 64 tile with j-tile <= i-tile, once for all heads (B and C
//     do not depend on the head), into the scratch cb [Bsz, S/L, L(i),
//     L(j)], columns in kperm order. The rest, one per (batch, chunk, head,
//     64 columns of P), form the chunk's cumsum, its decay exp(cum_L)
//     (scratch decays [Bsz, S/L, H]) and its local state sum_j exp(cum_L -
//     cum_j) dt_j B_j x_j^T (scratch local [Bsz, S/L, H, N, P]), a warpgroup
//     per 64 rows of N.
//  2. ssd_pass_kernel: walks the chunks in order, state_c = decay_{c-1}
//     state_{c-1} + local_{c-1}, writing the state entering each chunk
//     (scratch entering [Bsz, S/L, H, N, P]) and the final state.
//  3. ssd_out_kernel, two blocks per (batch, chunk, head, 64 columns of P),
//     a warpgroup per 64-row tile of the chunk: the blocks take the tiles
//     (0, T - 1) and (1, T - 2), whose bands have the same area. Off the
//     band's diagonal, exp(cum_i - cum_j) is exp(cum_i - cum_e) exp(cum_e -
//     cum_j) with e the last position of the staged step (j <= e < i, both
//     exponents <= 0): the second factor, times dt_j, weighs the staged C.B^T
//     columns, and the first scales the step's partial rows as they are
//     added. On the diagonal the band is formed element by element, j > i
//     masked (exp2(-inf) = 0). Then exp(cum_i) C_i times the state entering
//     the chunk (nothing for the first chunk), then D x_i.
// The pass and output kernels are programmatic dependents of the kernel
// before them: they start while it drains and wait for its writes in
// grid_wait. Operands stream through rings of cp.async stages. A fragment
// value pair that a lane reads (positions k and k + 4 of a group of 8) is
// kept side by side (kperm), so each is one 8-byte read, and every fragment
// read is free of bank conflicts. The exponentials are exp2 of a cumsum in
// log2 units, evaluated only where the exponent is <= 0. Positions padded
// with dt = 0 add nothing and decay by exp(0) = 1, so a chunk of them leaves
// the state exactly as it was. L must be a multiple of 64 up to 256, N of 64
// up to 256, and P of 8; the binding pads other shapes exactly and runs a
// longer chunk as equal sub-chunks.
//
// What bounds it. Per chunk and head the work is ~L^2/2 P + 2 L N P
// multiply-adds (plus L^2/2 N once per chunk for C.B^T) against L (2 P + 2 N)
// words of traffic; with the split terms that is 1-2.5 G multiply-adds of
// TF32 products a call at the served shapes (S 1024, L 256, P 64, N 64 or
// 128), 4-10 us at the card's 495 TFLOP/s, and 8-23 MB of device memory,
// 2-7 us. Neither bounds it on the card: each staged step of a block is a
// chain (copies landing, the transposition and split into the tile, the
// fragments, the warpgroup products, the add into float32) of ~1.5-2 us,
// and two to four warpgroups an SM overlap too little of it, so the tensor
// cores are busy ~15% of the time (measured per phase with clock64; see
// PERF.md). Fewer, longer steps or more warpgroups an SM are the way on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_float;
using repro::to_float;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PT = 64;   // columns of P per state or output block

// ---------------------------------------------------------------------------
// split-precision products on the tensor cores
// ---------------------------------------------------------------------------

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero),
// lo = v - hi exactly; the tensor cores read lo's top 19 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The A operand of one m16n8k8 product, rows g and g + 8, columns t and
// t + 4 (g = lane / 4, t = lane % 4), as its hi and lo TF32 pieces.
struct FragA {
  uint32_t hi[4], lo[4];
};

// The B operand, rows t and t + 4, column g, as its hi and lo pieces.
struct FragB {
  uint32_t hi[2], lo[2];
};

// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// d += a b over one m16n8k8 tile: d[0..3] = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B in float32's accuracy: the small terms first, then A_hi B_hi
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// 2^v for v <= 0 (the results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// Where position k of a group of 8 is kept: k and k + 4 side by side.
__host__ __device__ constexpr int kperm(int k) {
  return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
}

// ---------------------------------------------------------------------------
// staging, conversion and the chunk's cumsum
// ---------------------------------------------------------------------------

// Copies rows [r0, r1) x columns [c0, c0 + W) of a row-major matrix (leading
// dimension ld elements of E) into dst [r1 - r0][stride] over the block's
// threads, in 16-byte chunks; columns at or past c_end (a multiple of a
// chunk) read as zeros.
template <int W, typename E>
__device__ __forceinline__ void stage(E* dst, int stride, const E* src, size_t ld, int r0, int r1,
                                      int c0, int c_end) {
  constexpr int PER = 16 / sizeof(E), CPR = W / PER;
  static_assert(W % PER == 0, "rows of whole 16-byte chunks");
  const int chunks = (r1 - r0) * CPR;
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int r = q / CPR, col = (q % CPR) * PER;
    const bool in = c0 + col < c_end;
    cp_async16(dst + r * stride + col, in ? src + (r0 + r) * ld + c0 + col : src, in);
  }
}

// Programmatic dependent launch: the next kernel of the call may start
// (into its grid_wait) once every block of this one has passed here
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// waits until the previous kernel of the call has finished, its writes visible
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// 4 bytes from global to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// ---------------------------------------------------------------------------
// warpgroup products (wgmma) on K-major TF32 tiles
// ---------------------------------------------------------------------------

// d (64 x 64, the warpgroup's accumulator: each warp's 16 rows as m16n8k8's)
// (+)= A (64 x 8 from registers: each warp's 16 rows as the m16n8k8 A
// fragment) * B (8 x 64, a K-major tile, descriptor db); scale_d = 0 ignores d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// A K-major TF32 tile as wgmma reads it: 64 rows x 32 k, a row of 128 bytes,
// swizzled 128B: 4 floats (a chunk) c of row r at chunk c ^ (r % 8). 8 KB,
// 1024-byte aligned; k-step kk of 8 starts 32 kk bytes into the rows.
constexpr int TILE_FLOATS = 64 * 32;

__device__ __forceinline__ int tile_at(int r, int c) { return 32 * r + 4 * (c ^ (r & 7)); }

__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  return hp::make_desc(tile, 16, 1024, hp::desc_layout(128));
}

// The B operand's tile (and its lo plane unless EXACT) from a raw tile
// [32 k][64] of E, whose columns are the tile's rows: transposed, split,
// swizzled. bf16 values are exact in TF32 and take the hi plane alone.
template <bool EXACT, typename E>
__device__ __forceinline__ void to_tile(float* hi, float* lo, const E* raw) {
  for (int q = threadIdx.x; q < 64 * 8; q += blockDim.x) {
    const int r = q % 64, c = q / 64;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_float(raw[(4 * c + i) * 64 + r]);
    if constexpr (EXACT) {
      *reinterpret_cast<float4*>(hi + tile_at(r, c)) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
      *reinterpret_cast<float4*>(hi + tile_at(r, c)) =
          make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(lo + tile_at(r, c)) =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
    }
  }
}

// part = A B over a staged step of 32 k, from the step's four A fragments
// (hi and lo) and B's hi and lo tiles: A_lo B_hi (+ A_hi B_lo) + A_hi B_hi,
// the small terms first. Waits for the products.
template <bool EXACT_B>
__device__ __forceinline__ void wg_step(float (&part)[32], FragA (&a)[4], uint64_t dh,
                                        uint64_t dl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hp::reg_fence(a[kk].hi);
    hp::reg_fence(a[kk].lo);
  }
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32(part, a[kk].lo, hp::desc_add(dh, 32 * kk), kk > 0);
    if constexpr (!EXACT_B) wgmma_tf32(part, a[kk].hi, hp::desc_add(dl, 32 * kk), 1);
    wgmma_tf32(part, a[kk].hi, hp::desc_add(dh, 32 * kk), 1);
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::reg_fence(part);
}

// acc += s * part over a warpgroup accumulator, rows g and g + 8 by s0, s1
__device__ __forceinline__ void flush(float (&acc)[32], const float (&part)[32], float s0,
                                        float s1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], s0, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], s1, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], s1, acc[4 * j + 3]);
  }
}

// the 1024-byte aligned start of the dynamic shared memory (1 KB is asked for beyond the use)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hp::smem_u32(raw) & 1023)) & 1023);
}

// cum[j] = sum_{k<=j} a * dts[k] over the block: a shuffle scan per warp,
// then the warps' totals in order, segment by segment of blockDim.x
// positions. Any block size (a multiple of 32) adds in the same order.
__device__ void chunk_cumsum(const float* dts, float* cum, float* wsum, float a, int L) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nth = blockDim.x;
  float carry = 0.f;
  for (int base = 0; base < L; base += nth) {
    const int j = base + tid;
    float v = j < L ? a * dts[j] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    float seg_total = 0.f;
    for (int w = 0; w < nth / 32; ++w) seg_total += wsum[w];
    if (j < L) cum[j] = before + v;
    carry += seg_total;
    __syncthreads();  // wsum is rewritten by the next segment; cum is read next
  }
}

// ---------------------------------------------------------------------------
// 1a. C.B^T per chunk: cb[b, c, i, j] = C[b, cL + i] . B[b, cL + j], j-tile <= i-tile
// ---------------------------------------------------------------------------

constexpr int CB_T = 64;        // output tile
constexpr int CB_K = 32;        // depth of a staged step (of N)
constexpr int CB_S = CB_K + 4;  // row stride of staged rows [64][CB_S], read at 4g + t
constexpr int CB_SMEM = 4 * CB_T * CB_S * 4;   // two stages of C's and B's rows

// One 64 x 64 tile of C.B^T, pair q = it (it + 1) / 2 + jt of chunk bc's
// lower triangle of tiles, by the block's 4, 8 or 16 warps (16 rows each,
// 64, 32 or 16 columns), on mma.sync with all three split terms. cb's columns
// are kept in kperm order in each group of 8 (the output kernel's A
// operand): tile column g of a product is the real column (g >> 1) + 4 (g & 1),
// and each lane's two outputs stay side by side.
__device__ void cb_tile(const float* __restrict__ Bm, const float* __restrict__ Cm,
                        float* __restrict__ cb, int S, int N, int L, int q, int bc,
                        float* smem) {
  int it = 0, jt = q;
  while (jt > it) jt -= ++it;
  float* cs = smem;                    // [2][CB_T * CB_S]
  float* bs = smem + 2 * CB_T * CB_S;  // [2][CB_T * CB_S]
  const int nc = S / L;
  const size_t t0 = static_cast<size_t>(bc / nc) * S + static_cast<size_t>(bc % nc) * L;
  const float* Cc = Cm + (t0 + it * CB_T) * N;
  const float* Bc = Bm + (t0 + jt * CB_T) * N;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int ni_n = 1024 / blockDim.x;   // n8 tiles a warp: 8, 4 or 2
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 8 * ni_n;
  const int jg = (g >> 1) + 4 * (g & 1);
  auto fetch = [&](int step) {
    stage<CB_K>(cs + (step & 1) * CB_T * CB_S, CB_S, Cc, N, 0, CB_T, step * CB_K, N);
    stage<CB_K>(bs + (step & 1) * CB_T * CB_S, CB_S, Bc, N, 0, CB_T, step * CB_K, N);
    cp_async_commit();
  };
  float acc[8][4] = {};
  const int steps = N / CB_K;
  fetch(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      fetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ca = cs + (step & 1) * CB_T * CB_S;
    const float* ba = bs + (step & 1) * CB_T * CB_S;
    FragA a[CB_K / 8];
#pragma unroll
    for (int kk = 0; kk < CB_K / 8; ++kk) {
      const float* r = ca + (wm + g) * CB_S + 8 * kk + t;
      a[kk] = frag_a(r[0], r[8 * CB_S], r[4], r[8 * CB_S + 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      if (ni >= ni_n) break;
      float part[4] = {};
#pragma unroll
      for (int kk = 0; kk < CB_K / 8; ++kk) {
        const float* r = ba + (wn + 8 * ni + jg) * CB_S + 8 * kk + t;   // B^T[k][j] = B rows
        FragB b;
        split(r[0], b.hi[0], b.lo[0]);
        split(r[4], b.hi[1], b.lo[1]);
        mma_split(part, a[kk], b);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ni][i] += part[i];   // in float32, rounded to nearest
    }
    __syncthreads();   // before the next fetch overwrites this stage
  }
  float* out = cb + (static_cast<size_t>(bc) * L + it * CB_T + wm + g) * L + jt * CB_T + wn + 2 * t;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    if (ni >= ni_n) break;
    *reinterpret_cast<float2*>(out + 8 * ni) = make_float2(acc[ni][0], acc[ni][1]);
    *reinterpret_cast<float2*>(out + 8 * L + 8 * ni) = make_float2(acc[ni][2], acc[ni][3]);
  }
}

// ---------------------------------------------------------------------------
// 1b. each chunk's local state and decay, every chunk in parallel
// ---------------------------------------------------------------------------

constexpr int ST_K = 32;          // positions per staged step
constexpr int ST_STAGES = 3;
constexpr int ST_MAX_NT = 512;    // a warpgroup per 64 rows of N, at most 4

__host__ __device__ constexpr int state_b_stride(int N) { return N + 8; }   // B rows, read at 8t + g

template <typename T>
__host__ __device__ constexpr int state_slot_bytes(int N) {
  return ST_K * state_b_stride(N) * 4 + ST_K * 64 * static_cast<int>(sizeof(T));
}

// local[b, c, h] = sum_j exp(cum_L - cum_j) dt_j B_j x_j^T over chunk c,
// decays[b, c, h] = exp(cum_L): A = (w B)^T from registers (a warp per 16
// rows of N), B = x from its tile, a staged step of 32 positions at a time.
template <typename T>
__global__ void __launch_bounds__(ST_MAX_NT) ssd_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ cb,
    float* __restrict__ local, float* __restrict__ decays, int S, int H, int P, int N, int L,
    int cb_blocks) {
  constexpr bool EXACT = sizeof(T) == 2;
  const int BS = state_b_stride(N), slot_bytes = state_slot_bytes<T>(N);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  launch_dependents();
  if (static_cast<int>(blockIdx.x) < cb_blocks) {   // the first blocks: C.B^T tiles
    const int pairs = (L / CB_T) * (L / CB_T + 1) / 2;
    if (blockIdx.y == 0)
      cb_tile(Bm, Cm, cb, S, N, L, blockIdx.x % pairs, blockIdx.x / pairs,
              reinterpret_cast<float*>(smem));
    return;
  }
  float* xh = reinterpret_cast<float*>(smem);   // x's tile, hi and lo
  float* xl = xh + TILE_FLOATS;
  unsigned char* ring = smem + 2 * TILE_FLOATS * 4;
  float* dts = reinterpret_cast<float*>(ring + ST_STAGES * slot_bytes);   // [L]
  float* cum = dts + L;   // log2 units   [L]
  float* wq = cum + L;    // w_j = exp(cum_L - cum_j) dt_j, kperm order   [L]
  float* wsum = wq + L;   // [ST_MAX_NT / 32]
  const int blk = blockIdx.x - cb_blocks;
  const int nc = S / L, c = blk % nc, bh = blk / nc, b = bh / H, h = bh % H;
  const int p0 = blockIdx.y * PT;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int n_w = 16 * warp;   // this warp's rows of N: n_w + g, + 8
  const size_t ldx = static_cast<size_t>(H) * P;
  const T* xb = x + t0 * ldx + static_cast<size_t>(h) * P;
  const float* Bc = Bm + t0 * N;
  const int steps = L / ST_K;
  auto fetch = [&](int step) {
    if (step < steps) {
      unsigned char* st = ring + (step % ST_STAGES) * slot_bytes;
      const int j0 = step * ST_K;
      for (int n0 = 0; n0 < N; n0 += 32)   // B's rows, 32 floats at a time
        stage<32>(reinterpret_cast<float*>(st) + n0, BS, Bc, N, j0, j0 + ST_K, n0, N);
      stage<64>(reinterpret_cast<T*>(st + ST_K * BS * 4), 64, xb, ldx, j0, j0 + ST_K, p0, P);
    }
    cp_async_commit();
  };
  for (int j = tid; j < L; j += blockDim.x) cp_async4(dts + j, dt + (t0 + j) * H + h);
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) fetch(s);
  const uint64_t dh = tile_desc(xh), dl = tile_desc(xl);

  float acc[32] = {};   // rows n_w + g (+ 8), columns p0 + 8 j + 2t (+ 1)
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<ST_STAGES - 2>();
    __syncthreads();   // the step's tiles have landed; the slot refilled next and x's tile are free
    if (step == 0) {
      chunk_cumsum(dts, cum, wsum, A[h] * LOG2E, L);
      const float last = cum[L - 1];
      for (int j = tid; j < L; j += blockDim.x) wq[kperm(j)] = ex2(last - cum[j]) * dts[j];
      if (tid == 0 && blockIdx.y == 0)
        decays[(static_cast<size_t>(b) * nc + c) * H + h] = ex2(last);
    }
    const unsigned char* st = ring + (step % ST_STAGES) * slot_bytes;
    to_tile<EXACT>(xh, xl, reinterpret_cast<const T*>(st + ST_K * BS * 4));
    __syncthreads();   // x's tile and wq visible
    fetch(step + ST_STAGES - 1);
    // A[n][j] = w_j B_j[n], from B's rows: columns j = 8 kk + t, + 4
    const float* bs = reinterpret_cast<const float*>(st);
    const float* w = wq + step * ST_K;
    FragA a[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 wv = *reinterpret_cast<const float2*>(w + 8 * kk + 2 * t);
      const float* r = bs + (8 * kk + t) * BS + n_w + g;
      a[kk] = frag_a(r[0] * wv.x, r[8] * wv.x, r[4 * BS] * wv.y, r[4 * BS + 8] * wv.y);
    }
    float part[32];
    wg_step<EXACT>(part, a, dh, dl);
    flush(acc, part, 1.f, 1.f);
  }
  float* lb = local + ((static_cast<size_t>(b) * nc + c) * H + h) * N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + 8 * j + 2 * t;
    if (p >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(lb + static_cast<size_t>(n_w + g + 8 * half) * P + p) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// 2. the pass over the chunks: local states -> entering states, final state
// ---------------------------------------------------------------------------

constexpr int PASS_NT = 256;   // threads of a pass block, two state elements each
constexpr int PASS_GROUP = 8;  // chunks whose loads the pass starts together

// entering[b, c, h] (c >= 1) = the state entering chunk c: state_c =
// decay_{c-1} state_{c-1} + local_{c-1}; fin = the state after the last.
__global__ void __launch_bounds__(PASS_NT) ssd_pass_kernel(const float* __restrict__ local,
                                                           const float* __restrict__ decays,
                                                           float* __restrict__ entering,
                                                           float* __restrict__ fin, int nc,
                                                           int H, int NP) {
  launch_dependents();
  grid_wait();   // the local states
  const int e = 2 * (blockIdx.x * PASS_NT + threadIdx.x);
  if (e >= NP) return;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  float2 st = make_float2(0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_GROUP) {
    // the group's loads first, all in flight together, then the walk
    float2 loc[PASS_GROUP];
    float decay[PASS_GROUP];
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      const size_t bch = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
      if (c0 + u < nc) {
        loc[u] = *reinterpret_cast<const float2*>(local + bch * NP + e);
        decay[u] = decays[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (c > 0)
        *reinterpret_cast<float2*>(entering + ((static_cast<size_t>(b) * nc + c) * H + h) * NP +
                                   e) = st;
      st = make_float2(fmaf(decay[u], st.x, loc[u].x), fmaf(decay[u], st.y, loc[u].y));
    }
  }
  *reinterpret_cast<float2*>(fin + (static_cast<size_t>(b) * H + h) * NP + e) = st;
}

// ---------------------------------------------------------------------------
// 3. the output, every (chunk, head, half of the row tiles) in parallel
// ---------------------------------------------------------------------------

constexpr int OUT_NT = 256;          // two warpgroups, a 64-row tile each
constexpr int OUT_K = 32;            // positions (or rows of the state) per staged step
constexpr int OUT_STAGES = 2;
constexpr int BAND_S = OUT_K + 8;    // row stride of staged band rows [128][BAND_S], 8-byte reads at 8g + 2t
constexpr int C_S = OUT_K + 4;       // row stride of staged C rows [128][C_S], read at 4g + t
constexpr int OUT_RAW_BYTES = OUT_K * 64 * 4;        // a raw x tile or state slab
constexpr int OUT_ROWS_BYTES = 128 * BAND_S * 4;     // band or C rows
constexpr int OUT_SLOT = OUT_RAW_BYTES + OUT_ROWS_BYTES;

// The 64-row tile of warpgroup wg in half hf of a block pair (T tiles to a
// chunk), or -1: the halves take the pairs (0, T - 1) and (1, T - 2), whose
// bands have the same area.
__device__ __forceinline__ int row_tile(int hf, int wg, int T) {
  if (hf >= (T + 1) / 2) return -1;
  if (wg == 0) return hf;
  return T - 1 - hf > hf ? T - 1 - hf : -1;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(from_float<__nv_bfloat16>(a),
                                                             from_float<__nv_bfloat16>(b));
}

template <typename T>
__global__ void __launch_bounds__(OUT_NT, 2) ssd_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Cm, const float* __restrict__ D, const float* __restrict__ cb,
    const float* __restrict__ entering, T* __restrict__ y, int S, int H, int P, int N, int L) {
  constexpr bool EXACT = sizeof(T) == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* bh_ = reinterpret_cast<float*>(smem);   // the B operand's tile: x's or the state's, hi and lo
  float* bl_ = bh_ + TILE_FLOATS;
  unsigned char* ring = smem + 2 * TILE_FLOATS * 4;
  float* dts = reinterpret_cast<float*>(ring + OUT_STAGES * OUT_SLOT);   // [L]
  float* cum = dts + L;   // log2 units   [L]
  float* cumq = cum + L;  // cum, kperm order   [L]
  float* dtq = cumq + L;  // dt, kperm order   [L]
  float* sq = dtq + L;    // exp(cum_e - cum_j) dt_j, e = j | 31, kperm order   [L]
  float* wsum = sq + L;   // [OUT_NT / 32]
  const int nc = S / L, TT = L / 64, hf = blockIdx.x % 2;
  const int c = nc - 1 - static_cast<int>(blockIdx.x / 2 % nc);   // later chunks (more work) first
  const int bhi = blockIdx.x / 2 / nc, b = bhi / H, h = bhi % H;
  const int p0 = blockIdx.y * PT;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t bc = static_cast<size_t>(b) * nc + c, ldx = static_cast<size_t>(H) * P;
  const T* xb = x + t0 * ldx + static_cast<size_t>(h) * P;
  const float* cbc = cb + bc * L * L;
  const float* Cc = Cm + t0 * N;
  const float* st_in = entering + (bc * H + h) * N * P;
  const int tid = threadIdx.x, warp = tid / 32, wg = warp / 4, g = tid % 32 / 4, t = tid % 4;
  const int tile0 = row_tile(hf, 0, TT), tile1 = row_tile(hf, 1, TT);
  if (tile0 < 0) return;   // a chunk of fewer than two tiles leaves the second half idle
  const int m = wg == 0 ? tile0 : tile1;             // this warpgroup's tile, or -1
  const int i0 = 64 * m + 16 * (warp % 4) + g;       // this thread's rows i0, i0 + 8
  // steps: the sources j up to the block's last row, OUT_K at a time (each
  // tile's band rows that reach them, and x's rows), then the state's rows
  // n (each tile's C rows, and the state's slab)
  const int n_intra = 2 * ((tile1 > tile0 ? tile1 : tile0) + 1);
  const int steps = n_intra + (c > 0 ? N / OUT_K : 0);
  auto fetch = [&](int step) {
    if (step < steps) {
      unsigned char* st = ring + (step % OUT_STAGES) * OUT_SLOT;
      float* rows = reinterpret_cast<float*>(st + OUT_RAW_BYTES);
      const bool intra = step < n_intra;
      const int k0 = intra ? step * OUT_K : (step - n_intra) * OUT_K;
      // each tile's 64 rows x 32 columns: 512 chunks
      for (int q = tid; q < 2 * 512; q += OUT_NT) {
        const int w = q / 512, r = q % 512 / 8, col = q % 8 * 4, mt = w == 0 ? tile0 : tile1;
        if (mt < 0 || (intra && 64 * mt + 63 < k0)) continue;   // no band left to the tile
        if (intra)
          cp_async16(rows + (64 * w + r) * BAND_S + col,
                     cbc + static_cast<size_t>(64 * mt + r) * L + k0 + col, true);
        else
          cp_async16(rows + (64 * w + r) * C_S + col,
                     Cc + static_cast<size_t>(64 * mt + r) * N + k0 + col, true);
      }
      if (intra)
        stage<64>(reinterpret_cast<T*>(st), 64, xb, ldx, k0, k0 + OUT_K, p0, P);
      else
        stage<64>(reinterpret_cast<float*>(st), 64, st_in, P, k0, k0 + OUT_K, p0, P);
    }
    cp_async_commit();
  };
  for (int j = tid; j < L; j += OUT_NT) cp_async4(dts + j, dt + (t0 + j) * H + h);
  grid_wait();   // C.B^T and the entering states
#pragma unroll
  for (int s = 0; s < OUT_STAGES - 1; ++s) fetch(s);
  const uint64_t dh = tile_desc(bh_), dl = tile_desc(bl_);

  float cum_r[2], ecum[2];   // cum_i and exp(cum_i) of rows i0 and i0 + 8
  float acc[32] = {};
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<OUT_STAGES - 2>();
    __syncthreads();   // the step's tiles have landed; the slot refilled next and B's tile are free
    if (step == 0) {
      chunk_cumsum(dts, cum, wsum, A[h] * LOG2E, L);
      for (int j = tid; j < L; j += OUT_NT) {
        const int k = kperm(j);
        cumq[k] = cum[j];
        dtq[k] = dts[j];
        sq[k] = ex2(cum[j | (OUT_K - 1)] - cum[j]) * dts[j];   // exponent <= 0
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = m >= 0 ? i0 + 8 * half : 0;
        cum_r[half] = cum[i];
        ecum[half] = ex2(cum[i]);   // exponent <= 0
      }
    }
    const unsigned char* st = ring + (step % OUT_STAGES) * OUT_SLOT;
    const bool intra = step < n_intra;
    if (intra)
      to_tile<EXACT>(bh_, bl_, reinterpret_cast<const T*>(st));
    else
      to_tile<false>(bh_, bl_, reinterpret_cast<const float*>(st));
    __syncthreads();   // B's tile (and at step 0 the vectors) visible
    fetch(step + OUT_STAGES - 1);
    if (m < 0) continue;
    FragA a[4];
    float part[32];
    if (intra) {
      const int j0 = step * OUT_K;
      if (64 * m + 63 < j0) continue;   // the tile's band ends at its diagonal
      const float* rows =
          reinterpret_cast<const float*>(st + OUT_RAW_BYTES) + (16 * warp + g) * BAND_S + 2 * t;
      float s0 = 1.f, s1 = 1.f;
      if (64 * m >= j0 + OUT_K) {
        // off the diagonal: A = CB_ij exp(cum_e - cum_j) dt_j, rows scaled by exp(cum_i - cum_e)
        const float ce = cum[j0 + OUT_K - 1];
        s0 = ex2(cum_r[0] - ce);   // exponent <= 0
        s1 = ex2(cum_r[1] - ce);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float2 sv = *reinterpret_cast<const float2*>(sq + j0 + 8 * kk + 2 * t);
          const float2 u = *reinterpret_cast<const float2*>(rows + 8 * kk);
          const float2 v = *reinterpret_cast<const float2*>(rows + 8 * BAND_S + 8 * kk);
          a[kk] = frag_a(u.x * sv.x, v.x * sv.x, u.y * sv.y, v.y * sv.y);
        }
      } else {
        // the diagonal: A = CB_ij exp(cum_i - cum_j) dt_j for j <= i, else 0
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ja = j0 + 8 * kk + t, jb = ja + 4;
          const float2 cj = *reinterpret_cast<const float2*>(cumq + j0 + 8 * kk + 2 * t);
          const float2 dj = *reinterpret_cast<const float2*>(dtq + j0 + 8 * kk + 2 * t);
          const float2 u = *reinterpret_cast<const float2*>(rows + 8 * kk);
          const float2 v = *reinterpret_cast<const float2*>(rows + 8 * BAND_S + 8 * kk);
          a[kk] = frag_a(u.x * ex2(ja <= i0 ? cum_r[0] - cj.x : -INFINITY) * dj.x,
                         v.x * ex2(ja <= i0 + 8 ? cum_r[1] - cj.x : -INFINITY) * dj.x,
                         u.y * ex2(jb <= i0 ? cum_r[0] - cj.y : -INFINITY) * dj.y,
                         v.y * ex2(jb <= i0 + 8 ? cum_r[1] - cj.y : -INFINITY) * dj.y);
        }
      }
      wg_step<EXACT>(part, a, dh, dl);
      flush(acc, part, s0, s1);
    } else {
      // A[i][n] = C_i[n], rows scaled by exp(cum_i); B = the state's tile
      const float* rows =
          reinterpret_cast<const float*>(st + OUT_RAW_BYTES) + (16 * warp + g) * C_S + t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* r = rows + 8 * kk;
        a[kk] = frag_a(r[0], r[8 * C_S], r[4], r[8 * C_S + 4]);
      }
      wg_step<false>(part, a, dh, dl);
      flush(acc, part, ecum[0], ecum[1]);
    }
  }
  if (m < 0) return;
  const float dd = D[h];
  T* yb = y + t0 * ldx + static_cast<size_t>(h) * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + 8 * j + 2 * t;
    if (p >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t o = static_cast<size_t>(i0 + 8 * half) * ldx + p;
      store2(yb + o, acc[4 * j + 2 * half] + dd * to_float(xb[o]),
             acc[4 * j + 2 * half + 1] + dd * to_float(xb[o + 1]));
    }
  }
}

// launches `kernel` so that it may start while the previous kernel on the
// stream finishes (programmatic dependent launch): it waits in grid_wait
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, void* y, void* fin, void* cb, void* local, void* entering,
                   void* decays, int Bsz, int S, int H, int P, int N, int L,
                   cudaStream_t stream) {
  const int nc = S / L, tiles_l = L / CB_T, tiles_p = (P + PT - 1) / PT;
  const int cb_blocks = tiles_l * (tiles_l + 1) / 2 * Bsz * nc;
  auto state_kernel = ssd_state_kernel<T>;
  size_t state_bytes = 1024 + 2 * TILE_FLOATS * 4 + ST_STAGES * state_slot_bytes<T>(N) +
                       static_cast<size_t>(3 * L + ST_MAX_NT / 32) * 4;
  if (state_bytes < 1024 + CB_SMEM) state_bytes = 1024 + CB_SMEM;
  cudaError_t err = repro::allow_smem(state_kernel, state_bytes);
  if (err != cudaSuccess) return err;
  state_kernel<<<dim3(cb_blocks + Bsz * nc * H, tiles_p), 2 * N, state_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(cb),
      static_cast<float*>(local), static_cast<float*>(decays), S, H, P, N, L, cb_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_dependent(ssd_pass_kernel, dim3((N * P / 2 + PASS_NT - 1) / PASS_NT, Bsz * H),
                         dim3(PASS_NT), 0, stream, local, decays, entering, fin, nc, H, N * P);
  if (err != cudaSuccess) return err;

  auto out_kernel = ssd_out_kernel<T>;
  const size_t out_bytes = 1024 + 2 * TILE_FLOATS * 4 + OUT_STAGES * OUT_SLOT +
                           static_cast<size_t>(5 * L + OUT_NT / 32) * 4;
  err = repro::allow_smem(out_kernel, out_bytes);
  if (err != cudaSuccess) return err;
  return launch_dependent(out_kernel, dim3(2 * nc * Bsz * H, tiles_p), dim3(OUT_NT), out_bytes,
                          stream, x, dt, A, C, D, cb, entering, y, S, H, P, N, L);
}

}  // namespace

// x [Bsz,S,H,P] (dtype), dt [Bsz,S,H], A [H], B/C [Bsz,S,N], D [H] (fp32),
// y [Bsz,S,H,P] (dtype), fin [Bsz,H,N,P] fp32; scratch cb [Bsz,S/L,L,L],
// local and entering [Bsz,S/L,H,N,P], decays [Bsz,S/L,H], fp32. All
// contiguous and 16-byte aligned; S % L == 0, L % 64 == 0, L <= 256,
// N % 64 == 0, N <= 256, P % 8 == 0. Returns the first launch error; the
// kernels run on `stream`.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, void* y, void* fin, void* cb,
                             void* local, void* entering, void* decays, int dtype, int Bsz,
                             int S, int H, int P, int N, int L, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S % L != 0 || L % 64 != 0 ||
      L > 256 || N % 64 != 0 || N > 256 || P % 8 != 0 || Bsz * H > 65535 ||
      Bsz * (S / L) > 65535 || (P + PT - 1) / PT > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, fin, cb, local, entering, decays, Bsz, S,
                                 H, P, N, L, s);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dt, A, B, C, D, y, fin, cb, local, entering, decays, Bsz, S, H, P,
                         N, L, s);
  return cudaErrorInvalidValue;
}
