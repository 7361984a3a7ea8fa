// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel): blocked causal attention with GQA,
// a sliding window, gemma2's tanh logit softcap, an fp32 online softmax
// (m, l, acc) and the all-masked-row guards.
//
// Design. One block owns one (batch, query head, query tile) and walks the
// key tiles in order inside itself: that loop replaces the sequential fourth
// grid axis of the TPU kernel, so nothing carries between blocks and no
// atomics are needed. Key tiles that are fully masked (past the diagonal, or
// entirely below the window) are never visited. GQA reads KV head
// n / (N / K) directly, so the expanded KV is never built. Two kernels:
//  * bfloat16 (the serving path), every head_dim of HEAD_DIMS: a Hopper
//    kernel on wgmma. A block of 384 threads owns 128 query rows: one
//    producer warpgroup, whose single elected thread issues TMA loads (Q
//    once; K and V tiles of 64 keys at head_dim 256, else 128, into a ring
//    of 2-4 stages tracked by mbarriers), and two consumer warpgroups of 64
//    rows (setmaxnreg 240 against the producer's 24). S = Q K^T is a wgmma
//    with both operands in shared memory (K rows are K-major as stored);
//    O += P V takes P from the logits' registers as bf16 A fragments (the
//    S accumulator layout is the A-fragment layout) and V through the
//    descriptor's transpose bit. Tiles are stored as TMA's 128/64/32-byte
//    swizzle writes them, in column chunks of 64 elements (128-byte rows)
//    where head_dim is a multiple of 64, else of 32 (64-byte rows: head
//    dims 32, 96 and 160) or 16, so no thread copies or transposes data and
//    no head dim is padded. The softmax runs in log2
//    units with ex2; the softcap is c * (1 - 2 / (1 + 2^(2 log2(e) x / c)))
//    with ex2 and rcp (exact to float rounding at both ends, where
//    tanh.approx's 2^-11 would move a logit near the cap by ~0.02); the
//    mask is built only on diagonal, window-edge and ragged tiles. The two
//    consumer warpgroups take turns to issue QK^T (named barriers), so one's
//    softmax overlaps the other's products. Causal grids run the longest
//    query tiles first.
//  * float32: CUDA-core FMAs on 32x32 tiles held in shared memory as fp32,
//    with each thread's share of the accumulator in registers, so float32
//    stays float32 (tensor cores would round it to TF32). Each output column
//    belongs to NT / H threads (rows apart); where H does not divide the 256
//    threads (96, 160) the threads past (NT / H) * H own no accumulator and
//    only help with the loads, the scores and the softmax.
//
// What bounds it. At the main path's shapes (gemma2-2b: head_dim 256,
// S = 1024..8192) attention is operation-bound: ~4*S*S/2*H flops per head
// against S*H*2 bytes each of Q, K, V, O. With a softcap each logit also
// costs three MUFU operations (two ex2 and one rcp), about three quarters of
// the tensor-core time of its tile at head_dim 256, which is why the two
// warpgroups overlap one's softmax with the other's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.3819763e38f;  // the mask value of the reference

// float32 kernel tiles
constexpr int BQ = 32;   // query rows per block
constexpr int BK = 32;   // keys per tile: one per lane in the softmax pass
constexpr int NT = 256;  // threads per block (8 warps, 4 query rows each)

// Shared memory layout of the float32 kernel, in floats.
template <int H>
struct Layout {
  static constexpr int QS = H + 1;   // padded row strides
  static constexpr int KS = H + 1;
  static constexpr int PS = BK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + BQ * QS;
  static constexpr int v = k + BK * KS;
  static constexpr int p = v + BK * H;
  static constexpr int m = p + BQ * PS;
  static constexpr int l = m + BQ;
  static constexpr int alpha = l + BQ;
  static constexpr size_t bytes = (alpha + BQ) * sizeof(float);
};

__device__ __forceinline__ bool allowed(int qi, int ki, int sk, bool causal, int window) {
  if (ki >= sk) return false;                        // past the (padded) keys
  if (causal && ki > qi) return false;
  if (window > 0 && ki <= qi - window) return false;
  return true;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(NT) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Sq, int Sk, int N, int K, float scale, bool causal,
    int window, float softcap) {
  using L = Layout<H>;
  constexpr int RS = NT / H;        // rows between one thread's accumulators
  constexpr int OWNERS = RS * H;    // threads that own accumulators
  constexpr int ACC = BQ / RS;      // accumulators per owner
  static_assert(RS >= 1 && BQ % RS == 0, "a column's rows split evenly");
  extern __shared__ float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ps = smem + L::p;
  float* ms = smem + L::m;
  float* ls = smem + L::l;
  float* as = smem + L::alpha;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const size_t q_row = static_cast<size_t>(N) * H;   // stride of one position
  const size_t k_row = static_cast<size_t>(K) * H;
  const float* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(n) * H;
  const float* kb = k + static_cast<size_t>(b) * Sk * k_row + static_cast<size_t>(kvh) * H;
  const float* vb = v + static_cast<size_t>(b) * Sk * k_row + static_cast<size_t>(kvh) * H;
  float* ob = out + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(n) * H;

  for (int idx = tid; idx < BQ * H; idx += NT) {
    const int r = idx / H, d = idx % H, qi = q_start + r;
    qs[r * L::QS + d] = qi < Sq ? qb[qi * q_row + d] : 0.f;
  }
  if (tid < BQ) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  const bool owner = tid < OWNERS;
  const int d = tid % H;   // an owner's output column
  const int r0 = tid / H;  // and its first row; rows r0 + i * RS
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int q_last = q_start + BQ - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * BK;
    if (causal && k_start > q_last) break;  // every later tile is masked too
    if (causal && window > 0 && k_start + BK - 1 <= q_start - window) continue;

    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    for (int idx = tid; idx < BK * H; idx += NT) {
      const int r = idx / H, dd = idx % H, ki = k_start + r;
      float kv = 0.f, vv = 0.f;  // zeros past Sk: p = 0 must not meet NaN
      if (ki < Sk) {
        kv = kb[ki * k_row + dd];
        vv = vb[ki * k_row + dd];
      }
      ks[r * L::KS + dd] = kv;
      vs[r * H + dd] = vv;
    }
    __syncthreads();

    // logits: each thread a 2x2 micro-tile (rows ty, ty+16; keys tx, tx+16)
    {
      const int ty = tid / 16, tx = tid % 16;
      const float* q0 = qs + ty * L::QS;
      const float* q1 = qs + (ty + 16) * L::QS;
      const float* k0 = ks + tx * L::KS;
      const float* k1 = ks + (tx + 16) * L::KS;
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int dd = 0; dd < H; ++dd) {
        const float a0 = q0[dd], a1 = q1[dd], b0 = k0[dd], b1 = k1[dd];
        s[0][0] = fmaf(a0, b0, s[0][0]);
        s[0][1] = fmaf(a0, b1, s[0][1]);
        s[1][0] = fmaf(a1, b0, s[1][0]);
        s[1][1] = fmaf(a1, b1, s[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float x = s[i][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the max
          if (!allowed(q_start + r, k_start + c, Sk, causal, window)) x = NEG_INF;
          ps[r * L::PS + c] = x;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 4w..4w+3, lane c owns key c
    {
      const int warp = tid / 32, lane = tid % 32;
#pragma unroll
      for (int rr = 0; rr < BQ / 8; ++rr) {
        const int r = warp * (BQ / 8) + rr;
        const float x = ps[r * L::PS + lane];
        const bool ok = allowed(q_start + r, k_start + lane, Sk, causal, window);
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;   // all-masked rows
        const float p = ok ? expf(x - m_safe) : 0.f;
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        const float psum = warp_sum(p);
        ps[r * L::PS + lane] = p;
        if (lane == 0) {
          ms[r] = m_new;
          ls[r] = alpha * ls[r] + psum;
          as[r] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    if (owner) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] *= as[r0 + i * RS];
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float vv = vs[c * H + d];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = fmaf(ps[(r0 + i * RS) * L::PS + c], vv, acc[i]);
      }
    }
  }
  __syncthreads();
  if (!owner) return;

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = r0 + i * RS, qi = q_start + r;
    if (qi < Sq) {
      const float l = ls[r];
      ob[qi * q_row + d] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA, one producer warp, two consumer warpgroups
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_BQ = 128;        // query rows per block: 2 consumer warpgroups of 64
constexpr int WG_THREADS = 384;   // 2 consumer warpgroups + 1 producer warpgroup
constexpr int WG_CONSUMERS = 256;
constexpr int SMEM_MAX = 232448;  // what a block may ask for on sm_90

// Tiles and shared memory of the wgmma kernel at head_dim H. A Q, K or V
// tile is NC column chunks of CW columns (RB = 2 * CW bytes a row, the
// swizzle width), each chunk a [rows][CW] block as one TMA box writes it:
// 64 columns (128-byte swizzle) where they divide H, else 32 (64-byte: H =
// 32, 96, 160) or 16. A QK^T k-step of 16 columns never crosses a chunk,
// and PV's B descriptor walks the chunks by its leading byte offset.
template <int H>
struct WgCfg {
  static constexpr int BK = H == 256 ? 64 : 128;   // keys per tile
  static constexpr int CW = H % 64 == 0 ? 64 : H % 32 == 0 ? 32 : 16;
  static constexpr int RB = 2 * CW;
  static constexpr int NC = H / CW;
  static constexpr int LAYOUT = repro::hopper::desc_layout(RB);
  static constexpr int Q_BYTES = WG_BQ * H * 2;
  static constexpr int KV_BYTES = BK * H * 2;        // one K or V tile
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (SMEM_MAX - 1024 - BAR_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
  // 1024: slack to round the base up to the 1024-byte boundary that the
  // swizzle atoms (and so the descriptors) assume
  static constexpr size_t bytes = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static_assert(bytes <= SMEM_MAX, "shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Threads 0-255 are the consumers (warpgroup w owns query rows 64w..64w+63
// of the block's tile), threads 256-383 the producer, of which one thread
// issues every TMA load. Q is loaded once; K and V tiles of BK keys pass
// through a ring of STAGES slots, each with a "full" barrier (TMA bytes)
// and an "empty" one (all 256 consumer threads release it). The consumer
// warpgroups take turns to issue their QK^T product (named barriers 1 and
// 2), so that one's softmax runs while the other's products use the tensor
// cores.
template <int H>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Sq, int Sk, int N,
    int K, float scale, bool causal, int window, float softcap) {
  namespace hp = repro::hopper;
  using C = WgCfg<H>;
  constexpr int BK = C::BK, S = C::STAGES, RB = C::RB, CW = C::CW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* ks = qs + C::Q_BYTES;               // slot s at ks + s * KV_BYTES
  unsigned char* vs = ks + S * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + S * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;

  const int n = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_BQ;   // the longest tiles first
  const int kvh = n / (N / K);
  // the block's live key tiles: none past the last row's diagonal, none
  // wholly below the first row's window
  int kt_hi = (Sk + BK - 1) / BK - 1;
  if (causal) kt_hi = min(kt_hi, (q0 + WG_BQ - 1) / BK);
  const int kt_lo = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&k_empty[s], WG_CONSUMERS);
      hp::mbar_init(&v_empty[s], WG_CONSUMERS);
    }
    hp::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // ---- producer ----
    hp::reg_dealloc<24>();
    if (threadIdx.x == WG_CONSUMERS) {
      hp::mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        hp::tma_load_4d(qs + c * WG_BQ * RB, &tq, q_full, c * CW, n, q0, b);
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % S;
        const uint32_t ph = (i / S) & 1;
        hp::mbar_wait(&k_empty[s], ph ^ 1);
        hp::mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NC; ++c)
          hp::tma_load_4d(ks + s * C::KV_BYTES + c * BK * RB, &tk, &k_full[s], c * CW, kvh,
                          kt * BK, b);
        hp::mbar_wait(&v_empty[s], ph ^ 1);
        hp::mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NC; ++c)
          hp::tma_load_4d(vs + s * C::KV_BYTES + c * BK * RB, &tv, &v_full[s], c * CW, kvh,
                          kt * BK, b);
      }
    }
  } else {
    // ---- consumers ----
    hp::reg_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wq0 = q0 + wg * 64;                       // this warpgroup's rows
    const int wq1 = wq0 + 63;
    const int r0 = wq0 + (tid / 32) * 16 + g;           // this thread's rows r0, r0 + 8
    constexpr float LOG2E = 1.4426950408889634f;
    const bool cap = softcap > 0.f;
    // logits in log2 units: s * scale * log2(e), or with the softcap
    // c * tanh(s * scale / c) * log2(e) = cl2 - 2 * cl2 / (1 + 2^(s * tc))
    const float sl2 = scale * LOG2E;
    const float tc = cap ? 2.f * LOG2E * scale / softcap : 0.f;
    const float cl2 = softcap * LOG2E;

    float o[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max (log2 units) of rows r0, r0 + 8
    float l[2] = {0.f, 0.f};               // this thread's share of the row sums

    // descriptors of the warpgroup's 64 Q rows and of slot 0 of K and V
    const uint64_t dq = hp::make_desc(qs + wg * 64 * RB, 16, 8 * RB, C::LAYOUT);
    const uint64_t dk = hp::make_desc(ks, 16, 8 * RB, C::LAYOUT);
    const uint64_t dv = hp::make_desc(vs, BK * RB, 8 * RB, C::LAYOUT);

    if (wg == 1) hp::bar_arrive(1, WG_CONSUMERS);   // warpgroup 0 issues first
    hp::mbar_wait(q_full, 0);
    for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
      const int s = i % S;
      const uint32_t ph = (i / S) & 1;
      const int k0 = kt * BK;

      // S = Q K^T
      float sc[BK / 2];
      hp::mbar_wait(&k_full[s], ph);
      hp::bar_sync(1 + wg, WG_CONSUMERS);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t c = kk * 16 / CW, in_row = (kk * 16 % CW) * 2;   // chunk, bytes
        hp::wgmma_ss<BK>(sc, hp::desc_add(dq, c * WG_BQ * RB + in_row),
                         hp::desc_add(dk, s * C::KV_BYTES + c * BK * RB + in_row), kk > 0);
      }
      hp::wgmma_commit();
      hp::bar_arrive(2 - wg, WG_CONSUMERS);           // the other warpgroup's turn
      hp::wgmma_wait<0>();
      hp::reg_fence(sc);
      hp::mbar_arrive(&k_empty[s]);

      // scale, softcap (before the max), and the mask on edge tiles only:
      // element e is row r0 + 8 * ((e >> 1) & 1), key k0 + 8 * (e >> 2) +
      // 2 * t4 + (e & 1)
      if (cap) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = cl2 - 2.f * cl2 * rcp(1.f + ex2(sc[e] * tc));
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= sl2;
      }
      if (k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) || (window > 0 && k0 <= wq1 - window)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int qi = r0 + 8 * ((e >> 1) & 1);
          const int ki = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          if (ki >= Sk || (causal && ki > qi) || (window > 0 && ki <= qi - window))
            sc[e] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      // online softmax; the 4 lanes of a quad share a row. Masked logits are
      // -inf, so they give p = 0, and a row with nothing live yet keeps
      // m = -inf and takes m_safe = 0 (the reference's guard).
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m[r] - m_safe[r]);   // 0 while m = -inf
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t p[BK / 16][4];   // P as the A fragments of the PV product
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 8 * kk + 2 * f;
          const float p0 = ex2(sc[e] - m_safe[(f & 1)]);
          const float p1 = ex2(sc[e + 1] - m_safe[(f & 1)]);
          l[f & 1] += p0 + p1;
          p[kk][f] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V, V read MN-major from its slot
      hp::mbar_wait(&v_full[s], ph);
      hp::reg_fence(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hp::reg_fence(p[kk]);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hp::wgmma_rs<H>(o, p[kk], hp::desc_add(dv, s * C::KV_BYTES + kk * 16 * RB), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::reg_fence(o);
      hp::mbar_arrive(&v_empty[s]);
    }
    if (wg == 0) hp::bar_sync(1, WG_CONSUMERS);   // warpgroup 1's last turn signal

    // epilogue: the row sums across the quad, the l = 0 guard, bf16 rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qi = r0 + 8 * r;
      if (qi < Sq) {
        const float den = lr == 0.f ? 1.f : lr;
        bf16* orow = out + ((static_cast<size_t>(b) * Sq + qi) * N + n) * H + 2 * t4;
#pragma unroll
        for (int j = 0; j < H / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int H>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                       int Sk, int N, int K, float scale, int causal, int window,
                       float softcap, cudaStream_t stream) {
  auto kernel = flash_f32_kernel<H>;
  const size_t bytes = Layout<H>::bytes;
  cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Sq + BQ - 1) / BQ, N, B), NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, N, K, scale, causal != 0, window, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int N, int K, float scale, int causal, int window,
                        float softcap, cudaStream_t stream) {
  using C = WgCfg<H>;
  namespace hp = repro::hopper;
  // one map per operand over (H, heads, S, B): rows past S inside a batch
  // load as zeros, and a box never reaches into the next batch
  CUtensorMap tq, tk, tv;
  const uint32_t q_box[4] = {C::CW, 1, WG_BQ, 1};
  const uint32_t kv_box[4] = {C::CW, 1, C::BK, 1};
  const uint64_t q_dims[4] = {H, static_cast<uint64_t>(N), static_cast<uint64_t>(Sq),
                              static_cast<uint64_t>(B)};
  const uint64_t kv_dims[4] = {H, static_cast<uint64_t>(K), static_cast<uint64_t>(Sk),
                               static_cast<uint64_t>(B)};
  cudaError_t err = hp::encode_bf16<4>(&tq, q, q_dims, q_box, C::RB);
  if (err == cudaSuccess) err = hp::encode_bf16<4>(&tk, k, kv_dims, kv_box, C::RB);
  if (err == cudaSuccess) err = hp::encode_bf16<4>(&tv, v, kv_dims, kv_box, C::RB);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wgmma_kernel<H>;
  err = repro::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N, B, (Sq + WG_BQ - 1) / WG_BQ), WG_THREADS, C::bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), Sq, Sk, N, K, scale, causal != 0, window, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Sk, int N, int K, float scale, int causal, int window,
                   float softcap, cudaStream_t s) {
  if (dtype == repro::kBFloat16)
    return launch_bf16<H>(q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
  if (dtype == repro::kFloat32)
    return launch_f32<H>(q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// stages of the bf16 kernel's K/V ring at head_dim H (0: no such kernel)
extern "C" int repro_flash_wgmma_stages(int H) {
  switch (H) {
    case 16: return WgCfg<16>::STAGES;
    case 32: return WgCfg<32>::STAGES;
    case 64: return WgCfg<64>::STAGES;
    case 96: return WgCfg<96>::STAGES;
    case 128: return WgCfg<128>::STAGES;
    case 160: return WgCfg<160>::STAGES;
    case 256: return WgCfg<256>::STAGES;
    default: return 0;
  }
}

// q [B,Sq,N,H], k/v [B,Sk,K,H], out [B,Sq,N,H], all contiguous, one dtype,
// 16-byte aligned. window <= 0 means no window, softcap <= 0 no softcap.
// Returns the launch's cudaError_t; the kernel runs on `stream`.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         int dtype, int B, int Sq, int Sk, int N, int K, int H,
                                         float scale, int causal, int window, float softcap,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || N <= 0 || K <= 0 || N % K != 0 || N > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return launch<16>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 32: return launch<32>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 64: return launch<64>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 96: return launch<96>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 128: return launch<128>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 160: return launch<160>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 256: return launch<256>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
