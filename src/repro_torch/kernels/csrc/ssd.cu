// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA-core FMAs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd / _ssd_kernel):
// per chunk of L positions,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//          + exp(cum_i) C_i @ state + D x_i                           (inter)
//   state' = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
// with cum the inclusive cumsum of A dt over the chunk. B and C are shared by
// all heads (G = 1). All arithmetic is fp32; x and y are float or bfloat16.
//
// Design: the Mamba2 chunked decomposition, in which every chunk works in
// parallel and only an [N, P] state pass runs over the chunks in order. Four
// kernels, launched back to back on one stream:
//  1. ssd_cb_kernel: C_i . B_j for every chunk and every 64 x 64 tile with
//     j-tile <= i-tile, once for all heads (B and C do not depend on the
//     head), written transposed into the scratch cbt [Bsz, S/L, L(j), L(i)].
//  2. ssd_state_kernel, one block per (batch, head, chunk, 64 x 64 tile of
//     [N, P]): the chunk's cumsum of A dt, its total decay exp(cum_L) (into
//     the scratch decays [Bsz, S/L, H]) and its local state
//     S_c = sum_j exp(cum_L - cum_j) dt_j B_j x_j^T (into the scratch
//     states [Bsz, S/L, H, N, P]).
//  3. ssd_pass_kernel, one thread per (batch, head, state element): walks
//     the chunks in order, turning each local state into the state entering
//     its chunk (in place: state_c = exp(cum_L,c-1) state_c-1 + S_c-1), and
//     writes the final state. This is the only sequential loop over chunks.
//  4. ssd_out_kernel, one block per (batch, head, chunk, 64-row tile, 64
//     columns of P): y_i = sum_{j<=i} G_ij x_j + exp(cum_i) C_i . state_c +
//     D x_i, with the band G_ij = CB_ij exp(cum_i - cum_j) dt_j formed once
//     per row tile for all columns of P.
// The products of kernels 2 and 4 are tiled alike: a block of 256 threads
// owns a 64 x 64 output tile, each thread 4 rows x 4 columns of it in
// registers, read from shared memory as float4s. The operands are read
// k-major ([k][m] and [k][p]: B, x, the state and the transposed C.B^T, all
// rows as they lie in memory), so that cp.async copies each 32-deep step
// straight from global memory, 16 bytes a lane, into a ring of two stages:
// the next step's copies are in flight while the current one is
// multiplied. One pass over the landed stage then applies what depends on
// the head (the decay weights, the band's mask, exp(cum_i)), converts bf16 x
// to float and transposes the C rows of the inter-chunk term. Kernel 1, a
// product of two row-major operands, reads both as float4s along n. The
// output kernel starts its longest row tiles first.
// The [L, L] band never exists whole: each 32 x 64 piece is formed in
// shared memory as it is used, and exp(cum_i - cum_j) is evaluated only for
// j <= i, where the exponent is <= 0 (as are those of exp(cum_L - cum_j) and
// exp(cum_i)); the j > i half, which could overflow to inf and turn inf * 0
// into NaN, is never computed. The exponentials are exp2 of a cumsum in
// log2 units. Positions padded with dt = 0 add nothing
// and decay by exp(0) = 1, so a chunk of them has S_c = 0 and decay 1, and
// leaves the state exactly as it was. L must be a multiple of 8, N of 4 and
// P of 8 (16-byte rows); the binding pads other shapes exactly.
//
// What bounds it. Per chunk and head the work is ~L^2/2 P + 2 L N P FMAs
// (plus L^2/2 N once per chunk for C.B^T) against L (2 P + 2 N) words of
// traffic: operation-bound, on the CUDA cores (float32 stays float32: the
// final state must hold 3e-4, which TF32's 10-bit mantissa does not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_float;
using repro::to_float;

constexpr int NT = 256;        // threads of a state or output block: 16 x 16, 4 x 4 outputs each
constexpr int MIN_BLOCKS = 3;  // such blocks an SM holds at once (caps registers at 85)
constexpr int CB_NT = 128;     // threads of a C.B^T block: 8 x 16, 8 x 4 outputs each
constexpr int CB_MIN_BLOCKS = 4;
constexpr int TM = 64;         // output rows per block
constexpr int TN = 64;         // output columns per block
constexpr int TK = 32;         // depth per staged step
constexpr int AS = TM + 4;     // row stride of a staged A tile [TK][AS]
constexpr int BS = TN;         // row stride of a staged B tile [TK][BS]
constexpr int RS = TK + 4;     // row stride of staged rows [64][RS] read along k
constexpr int PER = TK * TM / NT;   // elements of a staged tile per thread
constexpr int PASS_NT = 256;   // threads of a state-pass block
constexpr int PASS_GROUP = 8;  // chunks whose loads the state pass starts together
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the product kernels, in floats: a ring of two stages of
// A [TK][AS] and B [TK][BS] tiles and a region for raw rows (bf16 x's
// [TK][TN], or with C_ROWS C's [TM][RS]), then per-chunk vectors of L floats.
template <typename T, bool C_ROWS>
struct Ring {
  static constexpr int A = TK * AS;
  static constexpr int B = TK * BS;
  static constexpr int XRAW = sizeof(T) == 2 ? TK * TN / 2 : 0;   // bf16 pairs as floats
  static constexpr int RAW = C_ROWS && TM * RS > XRAW ? TM * RS : XRAW;
  static constexpr int STAGE = A + B + RAW;
  static constexpr int BYTES = 2 * STAGE * 4;
};

// Copies rows [r0, r0 + ROWS) x columns [c0, c0 + W) of a row-major matrix
// (leading dimension ld elements of E) into dst [ROWS][stride] over THREADS
// threads: 16-byte chunks, zeros past row r_end or column c_end (both
// multiples of a chunk).
template <int ROWS, int W, int THREADS, typename E>
__device__ __forceinline__ void stage_rows(E* dst, int stride, const E* src, size_t ld, int r0,
                                           int r_end, int c0, int c_end) {
  constexpr int PERCHUNK = 16 / sizeof(E);
  constexpr int CHUNKS = ROWS * W / PERCHUNK;
  static_assert(CHUNKS % THREADS == 0, "chunks split evenly over the threads");
#pragma unroll
  for (int v = 0; v < CHUNKS / THREADS; ++v) {
    const int q = threadIdx.x + v * THREADS;
    const int k = q / (W / PERCHUNK), col = (q % (W / PERCHUNK)) * PERCHUNK;
    const bool in = r0 + k < r_end && c0 + col < c_end;
    cp_async16(dst + k * stride + col, in ? src + (r0 + k) * ld + c0 + col : src, in);
  }
}

// acc[r][c] += sum_k a[k][4 ty + r] * b[k][4 tx + c] over a staged step: a
// warp's two rows of A are one float4 broadcast, its 16 columns of B 256
// consecutive bytes
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < TK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * AS + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * BS + 4 * tx);
    const float av[4] = {a0.x, a0.y, a0.z, a0.w};
    const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

// x's TK rows of a stage into the stage's B tile: for bf16 from the raw
// rows copied beside it, converted; float32 x was copied there directly.
template <typename T>
__device__ __forceinline__ void stage_x(const T* src, size_t ld, float* b, float* raw, int r0,
                                        int r_end, int p0, int P) {
  if constexpr (sizeof(T) == 2)
    stage_rows<TK, TN, NT>(reinterpret_cast<T*>(raw), TN, src, ld, r0, r_end, p0, P);
  else
    stage_rows<TK, TN, NT>(b, BS, src, ld, r0, r_end, p0, P);
}

template <typename T>
__device__ __forceinline__ void convert_x(float* b, const float* raw) {
  if constexpr (sizeof(T) == 2) {
    const T* xr = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * NT;
      b[(e / TN) * BS + e % TN] = to_float(xr[e]);
    }
  }
}

// cum[j] = sum_{k<=j} a * dts[k] over the block: a shuffle scan per warp,
// then the warps' totals, segment by segment of NT positions. The state and
// output kernels both call it, so they see the same cum.
__device__ void chunk_cumsum(const float* dts, float* cum, float* wsum, float a, int L) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;
  for (int base = 0; base < L; base += NT) {
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
    for (int w = 0; w < NT / 32; ++w) seg_total += wsum[w];
    if (j < L) cum[j] = before + v;
    carry += seg_total;
    __syncthreads();  // wsum is rewritten by the next segment; cum is read next
  }
}

// ---------------------------------------------------------------------------
// 1. C.B^T per chunk, transposed: cbt[b, c, j, i] = C[b, cL + i] . B[b, cL + j]
//    for j-tile <= i-tile
// ---------------------------------------------------------------------------

// The output row of a C.B^T thread's element r (of 8): rows 4 ty .. 4 ty + 3
// and 32 + 4 ty .., each run of 4 one float4 of a cbt row.
__device__ __forceinline__ int row_of(int ty, int r) { return 4 * ty + (r & 3) + 32 * (r >> 2); }

__global__ void __launch_bounds__(CB_NT, CB_MIN_BLOCKS) ssd_cb_kernel(const float* __restrict__ Bm,
                                                                const float* __restrict__ Cm,
                                                                float* __restrict__ cbt, int S,
                                                                int N, int L) {
  const int it = blockIdx.x, jt = blockIdx.y;
  if (jt > it) return;  // above the diagonal: never read
  // a ring of two stages of C's rows i0.. and B's rows j0.., TK of n each
  __shared__ __align__(16) float cs[2][TM * RS];
  __shared__ __align__(16) float bs[2][TN * RS];
  const int nc = S / L;
  const int bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int i0 = it * TM, j0 = jt * TN;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const float* Cc = Cm + t0 * N;
  const float* Bc = Bm + t0 * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  auto fetch = [&](int step) {
    stage_rows<TM, TK, CB_NT>(cs[step & 1], RS, Cc, N, i0, L, step * TK, N);
    stage_rows<TN, TK, CB_NT>(bs[step & 1], RS, Bc, N, j0, L, step * TK, N);
    cp_async_commit();
  };
  fetch(0);
  // acc[r][cc] = C_i . B_j, i = i0 + row_of(ty, r), j = j0 + tx + 16 cc: the
  // 8 lanes of a float4 read of B's rows fall in 32 different banks
  float acc[8][4];
  zero(acc);
  const int steps = (N + TK - 1) / TK;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      fetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ca = cs[step & 1];
    const float* ba = bs[step & 1];
#pragma unroll 2
    for (int k = 0; k < TK; k += 4) {
      float4 a[8], bq[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(ca + row_of(ty, r) * RS + k);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        bq[cc] = *reinterpret_cast<const float4*>(ba + (tx + 16 * cc) * RS + k);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float v = acc[r][cc];
          v = fmaf(a[r].x, bq[cc].x, v);
          v = fmaf(a[r].y, bq[cc].y, v);
          v = fmaf(a[r].z, bq[cc].z, v);
          acc[r][cc] = fmaf(a[r].w, bq[cc].w, v);
        }
    }
    __syncthreads();   // before the next fetch overwrites this stage
  }
  // rows 4 ty .. 4 ty + 3 (and 32 more) of column j are one float4 of cbt
  float* out = cbt + static_cast<size_t>(bc) * L * L;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int j = j0 + tx + 16 * cc;
    if (j >= L) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 4 * ty + 32 * h;
      if (i < L)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(j) * L + i) =
            make_float4(acc[4 * h][cc], acc[4 * h + 1][cc], acc[4 * h + 2][cc], acc[4 * h + 3][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. local states and decays, every chunk in parallel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) ssd_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decays, int S,
    int H, int P, int N, int L) {
  using R = Ring<T, false>;
  extern __shared__ __align__(16) float smem[];
  float* wv = smem + 2 * R::STAGE;   // dt, then w_j = exp(cum_L - cum_j) dt_j   [L]
  float* cum = wv + L;               // log2 units   [L]
  float* wsum = cum + L;             // [NT / 32]
  const int tiles_n = (N + TM - 1) / TM;
  const int n0 = (blockIdx.x % tiles_n) * TM, p0 = (blockIdx.x / tiles_n) * TN;
  const int nc = S / L, c = blockIdx.y;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* xb = x + t0 * H * P + static_cast<size_t>(h) * P;
  const float* Bc = Bm + t0 * N;
  // step s: A = B_j[n0 ..] and B = x_j[p0 ..] for j in [s TK, s TK + TK)
  auto fetch = [&](int step) {
    float* st = smem + (step & 1) * R::STAGE;
    stage_rows<TK, TM, NT>(st, AS, Bc, N, step * TK, L, n0, N);
    stage_x(xb, static_cast<size_t>(H) * P, st + R::A, st + R::A + R::B, step * TK, L, p0, P);
    cp_async_commit();
  };
  fetch(0);

  for (int j = tid; j < L; j += NT) wv[j] = dt[(t0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(wv, cum, wsum, A[h] * LOG2E, L);
  const float cum_last = cum[L - 1];
  for (int j = tid; j < L; j += NT) wv[j] *= exp2f(cum_last - cum[j]);   // exponent <= 0
  if (blockIdx.x == 0 && tid == 0)
    decays[(static_cast<size_t>(b) * nc + c) * H + h] = exp2f(cum_last);

  float acc[4][4];
  zero(acc);
  const int steps = (L + TK - 1) / TK;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      fetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the step's tiles (everyone's copies) and wv have landed
    float* st = smem + (step & 1) * R::STAGE;
    float* a = st, *bt = st + R::A;
#pragma unroll
    for (int u = 0; u < PER; ++u) {   // A[k][m] *= w_j, j = step TK + k (zeros past L)
      const int e = tid + u * NT, k = e / TM, j = step * TK + k;
      a[k * AS + e % TM] *= j < L ? wv[j] : 0.f;
    }
    convert_x<T>(bt, st + R::A + R::B);
    __syncthreads();
    mma_tile(acc, a, bt, ty, tx);
    __syncthreads();   // before the next fetch overwrites this stage
  }
  float* sb = states + ((static_cast<size_t>(b) * nc + c) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {   // rows 4 ty + r, columns 4 tx .. 4 tx + 3: one float4
    const int n = n0 + 4 * ty + r, p = p0 + 4 * tx;
    if (n < N && p < P)
      *reinterpret_cast<float4*>(sb + static_cast<size_t>(n) * P + p) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---------------------------------------------------------------------------
// 3. the pass over the chunks: local states -> incoming states, final state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PASS_NT) ssd_pass_kernel(float* __restrict__ states,
                                                           const float* __restrict__ decays,
                                                           float* __restrict__ fin, int nc,
                                                           int H, int NP) {
  const int e = blockIdx.x * PASS_NT + threadIdx.x;
  if (e >= NP) return;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  float st = 0.f;
  for (int c0 = 0; c0 < nc; c0 += PASS_GROUP) {
    // the group's loads first, all in flight together, then the walk
    float local[PASS_GROUP], decay[PASS_GROUP];
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      const size_t bch = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
      if (c0 + u < nc) {
        local[u] = states[bch * NP + e];
        decay[u] = decays[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_GROUP; ++u) {
      if (c0 + u < nc) {
        states[((static_cast<size_t>(b) * nc + c0 + u) * H + h) * NP + e] = st;  // entering
        st = decay[u] * st + local[u];
      }
    }
  }
  fin[(static_cast<size_t>(b) * H + h) * NP + e] = st;
}

// ---------------------------------------------------------------------------
// 4. the output, every (chunk, row tile) in parallel
// ---------------------------------------------------------------------------

// Where element u of a thread's share of a transposing pass over [TM][RS]
// rows lands: 8 lanes along k by 4 along m, so that the writes to [k][AS]
// fall in 32 different banks.
__device__ __forceinline__ int pass_k(int tid, int u) {
  return 8 * ((tid / 32 + NT / 32 * u) % 4) + tid % 8;
}
__device__ __forceinline__ int pass_m(int tid, int u) {
  return 4 * ((tid / 32 + NT / 32 * u) / 4) + tid % 32 / 8;
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) ssd_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Cm, const float* __restrict__ D, const float* __restrict__ cbt,
    const float* __restrict__ states, T* __restrict__ y, int S, int H, int P, int N, int L) {
  using R = Ring<T, true>;
  extern __shared__ __align__(16) float smem[];
  float* dts = smem + 2 * R::STAGE;   // [L]
  float* cum = dts + L;               // log2 units   [L]
  float* ecum = cum + L;              // exp(cum_i) of the tile's rows   [TM]
  float* wsum = ecum + TM;            // [NT / 32]
  // grid (chunk x batch x head, row tile x column tile): blocks start in
  // order of blockIdx.y, the slowest axis, so the longest row tiles (the most
  // sources) start first
  const int tiles_i = (L + TM - 1) / TM;
  const int i0 = (tiles_i - 1 - blockIdx.y % tiles_i) * TM, p0 = (blockIdx.y / tiles_i) * TN;
  const int nc = S / L, c = blockIdx.x % nc;
  const int b = blockIdx.x / nc / H, h = blockIdx.x / nc % H;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t bc = static_cast<size_t>(b) * nc + c;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* xb = x + t0 * H * P + static_cast<size_t>(h) * P;
  const float* cbc = cbt + bc * L * L;
  const float* Cc = Cm + t0 * N;
  const float* st_in = states + (bc * H + h) * N * P;
  // steps: the sources j up to the tile's last row, TK at a time (A = the
  // band G^T from cbt's rows, B = x), then the state's rows n (A = C^T, from
  // C's rows transposed and scaled by exp(cum_i); B = the state entering the
  // chunk)
  const int n_intra = (min(L, i0 + TM) + TK - 1) / TK;
  const int steps = n_intra + (N + TK - 1) / TK;
  auto fetch = [&](int step) {
    float* st = smem + (step & 1) * R::STAGE;
    float* raw = st + R::A + R::B;
    if (step < n_intra) {
      stage_rows<TK, TM, NT>(st, AS, cbc, L, step * TK, L, i0, L);
      stage_x(xb, static_cast<size_t>(H) * P, st + R::A, raw, step * TK, L, p0, P);
    } else {
      const int k0 = (step - n_intra) * TK;
      stage_rows<TM, TK, NT>(raw, RS, Cc, N, i0, L, k0, N);
      stage_rows<TK, TN, NT>(st + R::A, BS, st_in, P, k0, N, p0, P);
    }
    cp_async_commit();
  };
  fetch(0);

  for (int j = tid; j < L; j += NT) dts[j] = dt[(t0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(dts, cum, wsum, A[h] * LOG2E, L);
  for (int m = tid; m < TM; m += NT) ecum[m] = i0 + m < L ? exp2f(cum[i0 + m]) : 0.f;

  float acc[4][4];
  zero(acc);
  // this thread's column of the band in the pass below: m = tid % TM
  const int m = tid % TM, i = i0 + m;
  const float cum_i = i < L ? cum[i] : 0.f;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      fetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the step's tiles (everyone's copies) and ecum have landed
    float* st = smem + (step & 1) * R::STAGE;
    float* a = st, *bt = st + R::A, *raw = st + R::A + R::B;
    if (step < n_intra) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {   // A[k][m] = CB_ij exp(cum_i - cum_j) dt_j, j <= i
        const int k = (tid + u * NT) / TM, j = step * TK + k;
        float* e = a + k * AS + m;
        *e = i < L && j <= i ? *e * exp2f(cum_i - cum[j]) * dts[j] : 0.f;   // exponent <= 0
      }
      convert_x<T>(bt, raw);
    } else {
#pragma unroll
      for (int u = 0; u < PER; ++u) {   // A[k][m] = exp(cum_i) C_i[k0 + k]
        const int k = pass_k(tid, u), mm = pass_m(tid, u);
        a[k * AS + mm] = raw[mm * RS + k] * ecum[mm];
      }
    }
    __syncthreads();
    mma_tile(acc, a, bt, ty, tx);
    __syncthreads();   // before the next fetch overwrites this stage
  }

  const float dd = D[h];
  T* yb = y + t0 * H * P + static_cast<size_t>(h) * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ir = i0 + 4 * ty + r;
    if (ir >= L) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + 4 * tx + cc;
      if (p < P) {
        const size_t o = static_cast<size_t>(ir) * H * P + p;
        yb[o] = from_float<T>(acc[r][cc] + dd * to_float(xb[o]));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, void* y, void* fin, void* cbt, void* states, void* decays,
                   int Bsz, int S, int H, int P, int N, int L, cudaStream_t stream) {
  const int nc = S / L;
  const int tiles_l = (L + TM - 1) / TM, tiles_n = (N + TM - 1) / TM, tiles_p = (P + TN - 1) / TN;
  ssd_cb_kernel<<<dim3(tiles_l, tiles_l, Bsz * nc), CB_NT, 0, stream>>>(
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(cbt), S, N,
      L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto state_kernel = ssd_state_kernel<T>;
  const size_t state_bytes = Ring<T, false>::BYTES + static_cast<size_t>(2 * L + NT / 32) * 4;
  err = repro::allow_smem(state_kernel, state_bytes);
  if (err != cudaSuccess) return err;
  state_kernel<<<dim3(tiles_n * tiles_p, nc, Bsz * H), NT, state_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(states), static_cast<float*>(decays), S,
      H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ssd_pass_kernel<<<dim3((N * P + PASS_NT - 1) / PASS_NT, Bsz * H), PASS_NT, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(decays), static_cast<float*>(fin),
      nc, H, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto out_kernel = ssd_out_kernel<T>;
  const size_t out_bytes = Ring<T, true>::BYTES + static_cast<size_t>(2 * L + TM + NT / 32) * 4;
  err = repro::allow_smem(out_kernel, out_bytes);
  if (err != cudaSuccess) return err;
  out_kernel<<<dim3(nc * Bsz * H, tiles_l * tiles_p), NT, out_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(C), static_cast<const float*>(D), static_cast<const float*>(cbt),
      static_cast<const float*>(states), static_cast<T*>(y), S, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// x [Bsz,S,H,P] (dtype), dt [Bsz,S,H], A [H], B/C [Bsz,S,N], D [H] (fp32),
// y [Bsz,S,H,P] (dtype), fin [Bsz,H,N,P] fp32; scratch cbt [Bsz,S/L,L,L],
// states [Bsz,S/L,H,N,P] and decays [Bsz,S/L,H], fp32.
// All contiguous and 16-byte aligned; S % L == 0, L % 8 == 0, N % 4 == 0,
// P % 8 == 0. Returns the first launch error; the kernels run on `stream`.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, void* y, void* fin, void* cbt,
                             void* states, void* decays, int dtype, int Bsz, int S, int H, int P,
                             int N, int L, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S % L != 0 || L % 8 != 0 ||
      N % 4 != 0 || P % 8 != 0 || Bsz * H > 65535 || S / L > 65535 || Bsz * (S / L) > 65535 ||
      (L / 64 + 1) * (P / 64 + 1) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, fin, cbt, states, decays, Bsz, S, H, P,
                                 N, L, s);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dt, A, B, C, D, y, fin, cbt, states, decays, Bsz, S, H, P, N, L, s);
  return cudaErrorInvalidValue;
}
