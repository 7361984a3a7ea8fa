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
// entirely below the window) are skipped with the TPU kernel's two tests.
// GQA reads KV head n / (N / K) directly, so the expanded KV is never built.
// Two kernels share that structure:
//  * bfloat16 (the serving path): tensor cores through mma.sync m16n8k16
//    with fp32 accumulation, FlashAttention-2 style. Four warps each own 16
//    of the block's 64 query rows; Q, K and V^T tiles of 64 keys sit in
//    shared memory as bf16 (rows padded against bank conflicts); the logits,
//    the softmax statistics and the output accumulator stay in registers
//    (128 floats a thread at head_dim 256), and the probabilities go to the
//    PV product as bf16 straight from the logits' registers, as the plain
//    version casts them to the compute dtype.
//  * float32: CUDA-core FMAs on 32x32 tiles held in shared memory as fp32,
//    with each thread's share of the accumulator in registers, so float32
//    stays float32 (tensor cores would round it to TF32).
//
// What bounds it. At the main path's shapes (gemma2-2b: head_dim 256,
// S = 1024..8192) attention is operation-bound: ~4*S*S/2*H flops per head
// against S*H*2 bytes each of Q, K, V, O. mma.sync reaches only part of the
// bf16 tensor-core rate that wgmma with TMA-fed tiles gives; that is the
// later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
  static_assert(NT % H == 0, "head_dim must divide the thread count");
  using L = Layout<H>;
  constexpr int RS = NT / H;        // rows between one thread's accumulators
  constexpr int ACC = BQ * H / NT;  // accumulators per thread
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
  const int d = tid % H;   // this thread's output column
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
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] *= as[r0 + i * RS];
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float vv = vs[c * H + d];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = fmaf(ps[(r0 + i * RS) * L::PS + c], vv, acc[i]);
    }
  }
  __syncthreads();

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
// bfloat16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // query rows per block, 16 per warp
constexpr int MK = 64;   // keys per tile
constexpr int MT = 128;  // threads per block (4 warps)

// Shared memory layout of the bf16 kernel, in bf16 elements. Rows are padded
// by 8 elements (16 bytes), so the 8 rows a fragment load touches start 4
// banks apart and 16-byte row chunks stay aligned.
template <int H>
struct MmaLayout {
  static constexpr int RS = H + 8;
  static constexpr int q = 0;                 // Q tile  [MQ][RS]
  static constexpr int k = q + MQ * RS;       // K tile  [MK][RS]
  static constexpr int v = k + MK * RS;       // V tile  [MK][RS]
  static constexpr size_t bytes = (v + MK * RS) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
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

template <int H>
__global__ void __launch_bounds__(MT) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Sk,
    int N, int K, float scale, bool causal, int window, float softcap) {
  static_assert(H % 16 == 0, "head_dim must be a multiple of 16");
  using L = MmaLayout<H>;
  constexpr int NO = H / 8;    // output column tiles of 8
  constexpr int NS = MK / 8;   // logit key tiles of 8
  constexpr int V8 = H / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = sm + L::q;
  __nv_bfloat16* ks = sm + L::k;
  __nv_bfloat16* vs = sm + L::v;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;     // mma fragment coordinates
  const int q_start = blockIdx.x * MQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const size_t q_row = static_cast<size_t>(N) * H;
  const size_t k_row = static_cast<size_t>(K) * H;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(n) * H;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * k_row + static_cast<size_t>(kvh) * H;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * k_row + static_cast<size_t>(kvh) * H;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(n) * H;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < MQ * V8; idx += MT) {
    const int r = idx / V8, c = (idx % V8) * 8, qi = q_start + r;
    *reinterpret_cast<uint4*>(qs + r * L::RS + c) =
        qi < Sq ? *reinterpret_cast<const uint4*>(qb + qi * q_row + c) : zero;
  }

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g and g + 8 of this warp
  float l[2] = {0.f, 0.f};
  const int wq0 = q_start + warp * 16;   // this warp's first and last rows
  const int wq1 = wq0 + 15;
  const int qi0 = wq0 + g, qi1 = qi0 + 8;

  const int q_last = q_start + MQ - 1;
  const int n_kt = (Sk + MK - 1) / MK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * MK;
    if (causal && k_start > q_last) break;   // every later tile is masked too
    if (causal && window > 0 && k_start + MK - 1 <= q_start - window) continue;

    __syncthreads();  // the previous tile's readers are done with ks, vs
    for (int idx = tid; idx < MK * V8; idx += MT) {
      const int r = idx / V8, c = (idx % V8) * 8, ki = k_start + r;
      const bool in = ki < Sk;   // zeros past Sk: p = 0 must not meet NaN
      *reinterpret_cast<uint4*>(ks + r * L::RS + c) =
          in ? *reinterpret_cast<const uint4*>(kb + ki * k_row + c) : zero;
      *reinterpret_cast<uint4*>(vs + r * L::RS + c) =
          in ? *reinterpret_cast<const uint4*>(vb + ki * k_row + c) : zero;
    }
    __syncthreads();
    // the same two tests for this warp's 16 rows alone (no block barrier below)
    if (causal && k_start > wq1) continue;
    if (causal && window > 0 && k_start + MK - 1 <= wq0 - window) continue;

    // logits S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < H; k0 += 16) {
      const __nv_bfloat16* qr = qs + (warp * 16 + g) * L::RS + k0 + t4 * 2;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * L::RS), ld32(qr + 8),
                             ld32(qr + 8 * L::RS + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * L::RS + k0 + t4 * 2;
        mma16816(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, softcap (before the max), mask; element (j, e) is row
    // qi0 (e < 2) or qi1, key k_start + 8 j + 2 t4 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!allowed(e < 2 ? qi0 : qi1, k_start + j * 8 + t4 * 2 + (e & 1), Sk, causal,
                     window))
          x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax; the 4 lanes of a group share a row
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;   // all-masked rows
      alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = allowed(e < 2 ? qi0 : qi1, k_start + j * 8 + t4 * 2 + (e & 1), Sk,
                                causal, window);
        const float p = ok ? expf(s[j][e] - m_safe[e >> 1]) : 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, with P in bf16 straight from the logit registers
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (kk * 16 + lane % 16) * L::RS;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + i * 8);
        mma16816(o[i], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r == 0 ? qi0 : qi1;
    if (qi < Sq) {
      const float den = l[r] == 0.f ? 1.f : l[r];
      __nv_bfloat16* orow = ob + qi * q_row + t4 * 2;
#pragma unroll
      for (int i = 0; i < NO; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8) =
            pack_bf16(o[i][2 * r] / den, o[i][2 * r + 1] / den);
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
  auto kernel = flash_bf16_kernel<H>;
  const size_t bytes = MmaLayout<H>::bytes;
  cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3((Sq + MQ - 1) / MQ, N, B), MT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk, N, K, scale, causal != 0, window, softcap);
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
    case 128: return launch<128>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    case 256: return launch<256>(dtype, q, k, v, out, B, Sq, Sk, N, K, scale, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
