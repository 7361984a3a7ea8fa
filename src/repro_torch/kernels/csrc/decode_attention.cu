// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel): one query token per sequence, q
// [B,N,H], over a cache [B,S,K,H] up to the per-sequence write index pos
// (inclusive), with GQA (the N/K query heads of a KV head share every K/V
// row read), a sliding window (keys (pos - window, pos]), gemma2's tanh logit
// softcap applied before the max, fp32 running (m, l, acc), the guards
// m = -inf -> 0 and l = 0 -> 1, and the output in q's dtype.
//
// What bounds it. Every live cache row is read once and used for G = N/K
// dot products and G axpys: about 2G flops per byte of bf16 cache, far below
// the ~295 flops a byte at which the H100 stops being bound by its 3.35 TB/s.
// So decode is bound by bytes, and the work is to keep enough loads in
// flight over the live rows, and to read no other row.
//
// Design. The TPU kernel walks the key tiles of one (batch, KV head) in order
// on one core. Carried over as one CUDA block per (batch, KV head), gemma2-2b
// at B = 1 would run 4 blocks on 132 SMs. Instead the grid is (B, K, splits):
// the live key range [lo, pos] of each sequence (it differs per sequence, and
// is read from pos on the device) is cut into runs of whole tiles, one run
// per block, so a block never touches a row past pos or before lo. Unfilled
// and stale rows are never read. Inside a block each warp takes keys in turn;
// a key's row is spread over LPK lanes with 16-byte loads (8-byte at a
// group of 16, see ChunkOf), U keys per lane
// group are loaded before any is used (loads in flight), the G scores are
// reduced across the LPK lanes with shuffles, and the lane keeps running
// (m, l, acc) for its share of the columns. The key slots of a warp, then the
// warps (through shared memory), merge their statistics, and each block
// writes its partial (m, l, acc) in fp32. A second small kernel merges the
// splits and writes the output, one block for each (batch, KV head, query
// head of the group, 32 output columns), so that the merge too runs on
// many SMs; a split with no live key carries m = -inf, l = 0 and counts for
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block of the split kernel
constexpr int NW = NT / 32;
constexpr int CT = 256;  // threads per block of the combine kernel
constexpr int MAX_SPLITS = 1024;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* part_acc;  // [B, K, splits, G, H]
  float* part_ml;   // [B, K, splits, G, 2]
  int B, S, N, K, splits, tile;
  float scale;
  int window;       // <= 0: none
  float softcap;    // <= 0: none
  cudaStream_t stream;
};

// The values of a 16-byte chunk (eight bf16 or four float) or of an 8-byte
// chunk (four bf16 or two float), as floats.
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <typename T> __device__ __forceinline__ void unpack(const uint2& u, float* f);
__device__ __forceinline__ void unpack_bf16_pair(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);  // the low half holds the lower index
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  unpack_bf16_pair(u.x, f);
  unpack_bf16_pair(u.y, f + 2);
  unpack_bf16_pair(u.z, f + 4);
  unpack_bf16_pair(u.w, f + 6);
}
template <> __device__ __forceinline__ void unpack<float>(const uint2& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint2& u, float* f) {
  unpack_bf16_pair(u.x, f);
  unpack_bf16_pair(u.y, f + 2);
}

// A group of 16 query heads keeps 16 scores, maxima, sums and accumulator
// rows a lane: with 16-byte chunks (8 bf16 columns a lane at head_dim 128)
// that is over 300 registers and spills. So G = 16 reads 8-byte chunks,
// which spreads a row over twice the lanes and halves each lane's columns,
// and keeps 2 keys in flight a lane group instead of 4.
template <int G> struct ChunkOf { using type = uint4; };
template <> struct ChunkOf<16> { using type = uint2; };

// weight of a partial with max m in a merge whose max is m_new
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

template <typename TQ, typename TKV, int H, int G>
__global__ void __launch_bounds__(NT) decode_split_kernel(Args a) {
  using Chunk = typename ChunkOf<G>::type;
  constexpr int VEC = sizeof(Chunk) / sizeof(TKV);     // elements per chunk
  constexpr int LPK = H / VEC < 32 ? H / VEC : 32;     // lanes per key row
  constexpr int EPL = H / LPK;                         // elements per lane
  constexpr int CH = EPL / VEC;                        // chunks per lane
  constexpr int KPW = 32 / LPK;                        // keys a warp takes at once
  constexpr int U = G >= 16 ? 2 : sizeof(TKV) == 2 ? 4 : 2;  // keys in flight per lane group
  constexpr int STEP = NW * KPW;                       // keys the block takes at once
  static_assert(H % VEC == 0 && EPL % VEC == 0, "head_dim must fill whole chunks");
  __shared__ float sm_acc[NW][G][H];
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / LPK;  // which of the warp's KPW keys
  const int c = lane % LPK;     // which EPL columns of the row

  // the live keys [lo, hi] of this sequence, and this block's run of tiles
  const int p = a.pos[b];
  const int hi = min(p, a.S - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int n_tiles = hi >= lo ? (hi - lo) / a.tile + 1 : 0;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  const int s0 = lo + split * per * a.tile;
  const int s1 = min(hi + 1, s0 + per * a.tile);  // exclusive; s1 <= s0: no keys

  const size_t row = static_cast<size_t>(a.K) * H;
  const TQ* qb = static_cast<const TQ*>(a.q) +
                 (static_cast<size_t>(b) * a.N + static_cast<size_t>(kvh) * G) * H + c * EPL;
  const TKV* kb = static_cast<const TKV*>(a.k) + static_cast<size_t>(b) * a.S * row +
                  static_cast<size_t>(kvh) * H + c * EPL;
  const TKV* vb = static_cast<const TKV*>(a.v) + static_cast<size_t>(b) * a.S * row +
                  static_cast<size_t>(kvh) * H + c * EPL;

  float q[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[g][e] = repro::to_float<TQ>(qb[g * H + e]);
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // the trip count is the same for every lane of a warp, so the shuffles
  // below see the whole warp
  for (int wbase = s0 + warp * KPW; wbase < s1; wbase += STEP * U) {
    const int base = wbase + slot;
    Chunk kr[U][CH], vr[U][CH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * STEP;
      const Chunk* kp = reinterpret_cast<const Chunk*>(kb + key * row);
      const Chunk* vp = reinterpret_cast<const Chunk*>(vb + key * row);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        kr[u][i] = key < s1 ? kp[i] : Chunk{};
        vr[u][i] = key < s1 ? vp[i] : Chunk{};
      }
    }
    float x[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
#pragma unroll
      for (int i = 0; i < CH; ++i) unpack<TKV>(kr[u][i], kf + i * VEC);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(q[g][e], kf[e], s);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= a.scale;
        if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);  // before the max
        x[u][g] = base + u * STEP < s1 ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = x[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, x[u][g]);
      if (mx == -INFINITY) continue;  // no live key in this step
      const float m_new = fmaxf(m[g], mx);
      const float alpha = rescale(m[g], m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * STEP >= s1) continue;
      float vf[EPL];
#pragma unroll
      for (int i = 0; i < CH; ++i) unpack<TKV>(vr[u][i], vf + i * VEC);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = expf(x[u][g] - m[g]);
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
    }
  }

  // merge the warp's key slots (lanes c, c + LPK, ...)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float wa = rescale(m[g], m_new), wb = rescale(m_o, m_new);
      l[g] = wa * l[g] + wb * l_o;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = wa * acc[g][e] + wb * acc_o;
      }
      m[g] = m_new;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][c * EPL + e] = acc[g][e];
      if (c == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write this split's partial
  const size_t part = (static_cast<size_t>(b) * a.K + kvh) * a.splits + split;
  for (int idx = threadIdx.x; idx < G * H; idx += NT) {
    const int g = idx / H, h = idx % H;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = rescale(sm_m[w][g], mm);
      ll += wt * sm_l[w][g];
      aa += wt * sm_acc[w][g][h];
    }
    a.part_acc[part * G * H + idx] = aa;
    if (h == 0) {
      a.part_ml[(part * G + g) * 2] = mm;
      a.part_ml[(part * G + g) * 2 + 1] = ll;
    }
  }
}

// Merges the splits of one (sequence, KV head, query head of the group) for
// CW output columns: the splits' max, their weights and the sum l first
// (every thread), then the weighted sum of the partial accumulators, with
// the splits dealt round-robin over SG groups of threads so that each thread
// has only a few loads to wait for, and the groups summed in order.
template <typename TQ, int H, int G>
__global__ void __launch_bounds__(CT) decode_combine_kernel(Args a) {
  constexpr int CW = H < 32 ? H : 32;  // output columns per block
  constexpr int SG = CT / CW;          // groups of splits
  __shared__ float w[MAX_SPLITS];
  __shared__ float red[CT];
  const int tid = threadIdx.x;
  const int bk = blockIdx.x, g = blockIdx.y;  // bk = b * K + kv head
  const int c = tid % CW, sg = tid / CW;
  const int h = blockIdx.z * CW + c;
  const size_t first = static_cast<size_t>(bk) * a.splits;
  const float* ml = a.part_ml + (first * G + g) * 2;  // split s at ml[s * 2G]

  float m = -INFINITY;
  for (int s = tid; s < a.splits; s += CT) m = fmaxf(m, ml[s * 2 * G]);
  red[tid] = m;
  __syncthreads();
  for (int o = CT / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] = fmaxf(red[tid], red[tid + o]);
    __syncthreads();
  }
  const float mm = red[0];
  __syncthreads();
  float l = 0.f;
  for (int s = tid; s < a.splits; s += CT) {
    const float wt = rescale(ml[s * 2 * G], mm);  // an empty split weighs 0
    w[s] = wt;
    l += wt * ml[s * 2 * G + 1];
  }
  red[tid] = l;
  __syncthreads();
  for (int o = CT / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  const float ll = red[0];
  __syncthreads();

  const float* pa = a.part_acc + (first * G + g) * H + h;  // split s at pa[s * G * H]
  float acc = 0.f;
#pragma unroll 4
  for (int s = sg; s < a.splits; s += SG) acc = fmaf(w[s], pa[static_cast<size_t>(s) * G * H], acc);
  red[tid] = acc;
  __syncthreads();
  if (sg == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < SG; ++i) t += red[i * CW + c];
    TQ* ob = static_cast<TQ*>(a.out) + (static_cast<size_t>(bk) * G + g) * H;
    ob[h] = repro::from_float<TQ>(t / (ll == 0.f ? 1.f : ll));
  }
}

template <typename TQ, typename TKV, int H, int G>
cudaError_t launch(const Args& a) {
  decode_split_kernel<TQ, TKV, H, G><<<dim3(a.B, a.K, a.splits), NT, 0, a.stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int CW = H < 32 ? H : 32;
  decode_combine_kernel<TQ, H, G><<<dim3(a.B * a.K, G, H / CW), CT, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int H>
cudaError_t by_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<TQ, TKV, H, 1>(a);
    case 2: return launch<TQ, TKV, H, 2>(a);
    case 4: return launch<TQ, TKV, H, 4>(a);
    case 8: return launch<TQ, TKV, H, 8>(a);
    case 16:  // up to head_dim 128: 256 would hold 64 KB of static shared memory
      if constexpr (H <= 128) return launch<TQ, TKV, H, 16>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t by_head(int H, int G, const Args& a) {
  switch (H) {
    case 16: return by_group<TQ, TKV, 16>(G, a);
    case 32: return by_group<TQ, TKV, 32>(G, a);
    case 64: return by_group<TQ, TKV, 64>(G, a);
    case 128: return by_group<TQ, TKV, 128>(G, a);
    case 256: return by_group<TQ, TKV, 256>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,N,H] and out [B,N,H] in q_dtype; k/v [B,S,K,H] in kv_dtype (float32 q
// with a float32 or bfloat16 cache, or bfloat16 for both); pos [B] int32 on
// the device, each in [0, S); part_acc [B,K,splits,N/K,H] and part_ml
// [B,K,splits,N/K,2] float32 scratch, splits <= 1024. All contiguous, k and
// v 16-byte aligned. window <= 0 means no window, softcap <= 0 no softcap. The live
// keys of a sequence are cut into runs of whole `tile` keys, one per split.
// Returns the launches' cudaError_t; both kernels run on `stream`.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* pos, void* out, void* part_acc,
                                          void* part_ml, int q_dtype, int kv_dtype, int B,
                                          int S, int N, int K, int H, int splits, int tile,
                                          float scale, int window, float softcap,
                                          void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || K <= 0 || N % K != 0 || K > 65535 || splits <= 0 ||
      splits > MAX_SPLITS || tile <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(pos), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), B, S, N, K, splits, tile, scale, window,
               softcap, static_cast<cudaStream_t>(stream)};
  const int G = N / K;
  using bf16 = __nv_bfloat16;
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kFloat32)
    return by_head<float, float>(H, G, a);
  if (q_dtype == repro::kBFloat16 && kv_dtype == repro::kBFloat16)
    return by_head<bf16, bf16>(H, G, a);
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kBFloat16)
    return by_head<float, bf16>(H, G, a);
  return cudaErrorInvalidValue;
}
