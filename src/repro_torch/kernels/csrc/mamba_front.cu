// Mamba2's front, between in_proj and the SSD scan, in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is plain jnp in
// src/repro/models/ssm.py (ssm_apply: the causal conv, its bias, SiLU, the
// split of x, B and C, and softplus(dt + dt_bias)), which XLA fuses under
// jax.jit. Eagerly PyTorch runs it as 14 launches a block: a transposing
// pad, the depthwise conv, the bias, SiLU, a copy of x to the scan's
// contiguous layout, the casts of B, C and dt, the bias add and the
// softplus. Here one launch reads in_proj's output rows in place and writes
// exactly the buffers the scan takes:
//
//   xbc[s, c] = silu(sum_k w[k, c] xbc_in[s - K + 1 + k, c] + b[c])
//               (K = 4 taps, zeros before the first position)
//   x = xbc[:, :d_inner]  (compute dtype, [B, S, H, P])
//   B = xbc[:, d_inner : d_inner + N], C = xbc[:, d_inner + N :]  (float32)
//   dt[s, h] = softplus(dt_in[s, h] + dt_bias[h])  (float32)
//
// The weights and bias are rounded to the compute dtype, as the plain
// version's conv_w.to(dtype) and conv_b.to(dtype) do; the taps, the bias and
// SiLU are float32 (SiLU's division the fast one, within 2 ulp), and each
// output is rounded to the compute dtype once (B and C then widened to
// float32). The plain version (kernels/ref.py mamba_front) rounds after the
// conv and after the bias as well. softplus is PyTorch's (beta 1, threshold
// 20).
//
// What bounds it: bytes. A position moves the (x|B|C) and dt slices of its
// row in, and x, B, C and dt out, for a few operations a channel. Design:
// each thread owns a pair of channels of one batch row over a tile of 8
// positions. It issues the loads of the tile's rows and of the K - 1 rows
// before it (the causal history; zeros before the sequence) all at once into
// registers, so each input element is read once but for a 3-row halo a tile
// (an L2 hit: the tile before read it), then computes each position from the
// rows in registers. Neighbouring threads own neighbouring pairs of a row, so
// a warp's loads and stores are coalesced. Pairs below d_inner store x, the
// next N channels go to B and the last N to C; the last ceil(H / 2) threads
// of a row's groups compute dt for two heads each. Small threads keep ~44
// registers; at zamba2-2.7b's width a launch is 341k threads, two waves of
// the card, so one wave's arithmetic overlaps the next one's loads. On the
// card, at [1, 1024] with a cold L2: 8 channels and 16 positions a thread
// took 45 us, 2 channels and 16 positions 26.5 us, 2 and 8 21.2 us (the
// byte bound is 6.7 us); 4 channels, or 4 positions, were no faster.
// A pair is one load: zx's address, its batch and row strides and xbc_at
// must be multiples of a pair (every width the port serves has them), and
// d_inner and N must be even, so that no pair straddles x, B and C and the
// outputs' pairs are aligned. The binding checks them; the entry refuses
// them too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTaps = 4;
constexpr int kVec = 2;    // channels (or heads) a thread
constexpr int kTile = 8;   // positions a thread

struct Args {
  const void* zx;  // [Bsz, S, width] in the compute dtype, rows of stride row_stride
  int64_t batch_stride, row_stride;  // in elements
  int xbc_at, dt_at;                 // offsets of (x|B|C) and dt in a row
  const void* conv_w;                // [K, C] float32 or the compute dtype
  const void* conv_b;                // [C]
  const float* dt_bias;              // [H]
  void* x;                           // [Bsz, S, d_inner] compute dtype
  float* B;                          // [Bsz, S, N]
  float* C;                          // [Bsz, S, N]
  float* dt;                         // [Bsz, S, H]
  int S, d_inner, N, H;
  int conv_groups;  // (d_inner + 2 N) / kVec
  int groups;       // conv_groups + ceil(H / kVec)
  int tiles;        // ceil(S / kTile)
  int64_t threads;  // Bsz * tiles * groups
};

template <int Bytes> struct WordOf;
template <> struct WordOf<4> { using type = unsigned int; };
template <> struct WordOf<8> { using type = uint2; };

// kVec values of T, held as one aligned word
template <typename T>
struct Vals {
  using Word = typename WordOf<kVec * static_cast<int>(sizeof(T))>::type;
  Word w;
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(&w); }
  __device__ __forceinline__ const T* v() const { return reinterpret_cast<const T*>(&w); }
};

// kVec values from p, aligned to them
template <typename T>
__device__ __forceinline__ Vals<T> load_vals(const T* p) {
  Vals<T> r;
  r.w = __ldg(reinterpret_cast<const typename Vals<T>::Word*>(p));
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vals(T* p, const float* f) {
  Vals<T> r;
#pragma unroll
  for (int i = 0; i < kVec; ++i) r.v()[i] = repro::from_float<T>(f[i]);
  *reinterpret_cast<typename Vals<T>::Word*>(p) = r.w;
}

template <typename T>
__device__ __forceinline__ void unpack(const Vals<T>& r, float* f) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) f[i] = repro::to_float(r.v()[i]);
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return repro::to_float(repro::from_float<T>(v));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) mamba_front_kernel(const Args a) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= a.threads) return;
  const int g = static_cast<int>(idx % a.groups);
  const int64_t rest = idx / a.groups;
  const int s0 = static_cast<int>(rest % a.tiles) * kTile;
  const int64_t b = rest / a.tiles;
  const int rows = min(kTile, a.S - s0);
  const T* in = static_cast<const T*>(a.zx) + b * a.batch_stride;
  const int64_t out_row = b * a.S + s0;  // first output row of the tile

  if (g >= a.conv_groups) {  // dt: kVec heads over the tile
    const int h0 = (g - a.conv_groups) * kVec;
    float v[kTile][kVec];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const T* src = in + static_cast<int64_t>(s0 + t) * a.row_stride + a.dt_at + h0;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[t][j] = t < rows && h0 + j < a.H ? repro::to_float(__ldg(src + j)) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (h0 + j >= a.H) continue;
      const float bias = a.dt_bias[h0 + j];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t < rows) {
          const float u = v[t][j] + bias;
          a.dt[(out_row + t) * a.H + h0 + j] = u > 20.0f ? u : log1pf(expf(u));
        }
      }
    }
    return;
  }

  const int c0 = g * kVec;
  const int channels = a.d_inner + 2 * a.N;
  float w[kTaps][kVec], bias[kVec];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    unpack(load_vals<W>(static_cast<const W*>(a.conv_w) + static_cast<int64_t>(k) * channels + c0), w[k]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) w[k][j] = round_to<T>(w[k][j]);
  }
  unpack(load_vals<W>(static_cast<const W*>(a.conv_b) + c0), bias);
#pragma unroll
  for (int j = 0; j < kVec; ++j) bias[j] = round_to<T>(bias[j]);

  // rows s0 - K + 1 .. s0 + kTile - 1, all loads in flight together
  Vals<T> r[kTile + kTaps - 1];
#pragma unroll
  for (int i = 0; i < kTile + kTaps - 1; ++i) {
    const int s = s0 - (kTaps - 1) + i;
    r[i] = s >= 0 && s < s0 + rows
               ? load_vals<T>(in + static_cast<int64_t>(s) * a.row_stride + a.xbc_at + c0)
               : Vals<T>{};
  }

#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    if (t < rows) {
      float acc[kVec] = {};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        float v[kVec];
        unpack(r[t + k], v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = fmaf(w[k][j], v[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float u = acc[j] + bias[j];
        acc[j] = __fdividef(u, 1.0f + expf(-u));
      }
      const int64_t row = out_row + t;
      if (c0 < a.d_inner) {
        store_vals(static_cast<T*>(a.x) + row * a.d_inner + c0, acc);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = round_to<T>(acc[j]);
        const int n0 = c0 - a.d_inner;
        store_vals(n0 < a.N ? a.B + row * a.N + n0 : a.C + row * a.N + n0 - a.N, acc);
      }
    }
  }
}

template <typename T, typename W>
cudaError_t launch(Args a, int64_t bsz, cudaStream_t s) {
  a.tiles = (a.S + kTile - 1) / kTile;
  a.threads = bsz * a.tiles * a.groups;
  const int64_t blocks = (a.threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  mamba_front_kernel<T, W><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// zx [Bsz, S, width] (dtype 0 float32, 1 bfloat16; last stride 1, batch and
// row strides in elements), (x|B|C) at xbc_at and dt at dt_at of each row,
// the address, the strides (the batch stride where Bsz > 1) and xbc_at
// multiples of a pair of values;
// conv_w [K, C] and conv_b [C] contiguous, in float32 (w_dtype 0) or zx's
// dtype (w_dtype 1 with bfloat16); dt_bias [H] float32; outputs x [Bsz, S,
// d_inner] in zx's dtype, B and C [Bsz, S, N] and dt [Bsz, S, H] float32,
// contiguous. C = d_inner + 2 N channels, K = 4. Returns a cudaError_t.
extern "C" int repro_mamba_front_fwd(const void* zx, int64_t batch_stride, int64_t row_stride,
                                     int xbc_at, int dt_at, const void* conv_w,
                                     const void* conv_b, const void* dt_bias, void* x, void* B,
                                     void* C, void* dt, int dtype, int w_dtype, int bsz, int S,
                                     int d_inner, int N, int H, int K, void* stream) {
  const int pair_bytes = kVec * (dtype == repro::kBFloat16 ? 2 : 4);
  if (K != kTaps || bsz <= 0 || S <= 0 || d_inner <= 0 || N <= 0 || H <= 0 ||
      d_inner % kVec || N % kVec || reinterpret_cast<uintptr_t>(zx) % pair_bytes ||
      (bsz > 1 && batch_stride % kVec) || row_stride % kVec || xbc_at % kVec)
    return cudaErrorInvalidValue;
  Args a{};
  a.zx = zx;
  a.batch_stride = batch_stride;
  a.row_stride = row_stride;
  a.xbc_at = xbc_at;
  a.dt_at = dt_at;
  a.conv_w = conv_w;
  a.conv_b = conv_b;
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.x = x;
  a.B = static_cast<float*>(B);
  a.C = static_cast<float*>(C);
  a.dt = static_cast<float*>(dt);
  a.S = S;
  a.d_inner = d_inner;
  a.N = N;
  a.H = H;
  a.conv_groups = (d_inner + 2 * N) / kVec;
  a.groups = a.conv_groups + (H + kVec - 1) / kVec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && w_dtype == repro::kFloat32)
    return launch<float, float>(a, bsz, s);
  if (dtype == repro::kBFloat16 && w_dtype == repro::kFloat32)
    return launch<__nv_bfloat16, float>(a, bsz, s);
  if (dtype == repro::kBFloat16 && w_dtype == repro::kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, bsz, s);
  return cudaErrorInvalidValue;
}
