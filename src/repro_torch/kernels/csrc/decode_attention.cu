// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel, pallas_call at :128): one query token
// per sequence, q [B,N,H], over a cache [B,S,K,H] up to the per-sequence
// write index pos (inclusive), with GQA (the G = N/K query heads of a KV
// head share every K/V row read), a sliding window (keys
// [max(0, pos - window + 1), pos]), gemma2's tanh logit softcap applied
// before the max, fp32 running (m, l, acc), the guards m = -inf -> weight 0
// and l = 0 -> 1, and the output in q's dtype.
//
// What bounds it. Every live cache row is read once and used for G dot
// products and G axpys: about 2G flops per byte of bf16 cache (4 at
// gemma2-2b's G = 2, 32 at qwen3-moe's 16), far below the ~295 flops a byte
// at which the H100 stops being bound by its 3.35 TB/s. So decode is bound
// by bytes: the work is to keep the live rows' loads in flight, read no
// other row, and spend as little as possible around them (launches, the
// merge of the splits).
//
// Grid. The TPU kernel walks the key tiles of one (batch, KV head) in order
// on one core; here the live key range [lo, pos] of each sequence (read from
// pos on the device, so a captured CUDA graph stays valid from step to step)
// is cut into 64-key tiles counted from lo, and the tiles are dealt to
// `splits` blocks of that (batch, KV head): grid (B, K, splits). A block never
// touches a row past pos or before lo; `splits` depends on the shapes only
// (kernels/decode_attention.py: num_splits). The bf16 kernel deals the tiles
// evenly (split i takes tiles [i n / splits, (i + 1) n / splits)), the fp32
// one in runs of ceil(n / splits).
//
// bfloat16 (q and cache both bf16: every call of the served decode path):
// decode_mma_kernel.
//  * Staging: the block's K and V tiles are copied by cp.async (16 bytes a
//    lane, .cg) into a ring of up to 4 stages in shared memory (3 at head_dim
//    above 64; 66 KB a stage at 256), all of them in flight before the first
//    is used where the ring holds them, and each stage refilled before the
//    next tile is computed; rows outside [lo, pos] are zero-filled with the
//    src-size-0 form, so a stale row is never read and p = 0 never meets a
//    NaN. Not TMA: a tensor map would be encoded on the host at every call
//    (as gmm's are), which costs more host time than this kernel's whole
//    device time on a path the host already bounds.
//  * Products: mma.sync m16n8k16 bf16 -> fp32 from ldmatrix fragments. The
//    group's query heads are the 16 rows of M (G < 16 padded with zero rows:
//    tensor-core work is free at 2G flops a byte). Each of 4 warps owns 16
//    keys of a tile: S = Q K^T (Q's fragments held in registers, K's by
//    ldmatrix from the tile as stored, key-major), then scale, softcap,
//    mask and the online softmax on the accumulator fragments (running m and
//    l per row, reduced over the 4 lanes of a row only), then O += P V with P
//    rebuilt in registers as bf16 A fragments (probabilities rounded to bf16
//    before the product, as the plain version rounds them) and V through
//    ldmatrix.trans. Above head_dim 128 (160, 256) a second set of 4 warps
//    owns the other half of O's columns (and computes the same S), so O
//    stays at 40 or 64 registers a thread. Every head dim is a multiple of
//    16, so the k-steps of S and the 16-column V loads never run past a row
//    (96: 6 k-steps, 12 n-tiles; 160: 10 k-steps, two halves of 10). wgmma is not used: it needs 64-row tiles, four times
//    the 16 rows a group fills, and its rate buys nothing here.
//  * Merges: the 4 key slices merge their (m, l, O) through shared memory at
//    the end of the block's run, in slice order. With one split the block
//    writes the output. Otherwise it writes its fp32 partial (m, l, acc) and
//    takes a ticket on the per-(batch, KV head) counter (one atomic with
//    release and acquire semantics after a block barrier); the block that
//    draws the last ticket stages every split's partial in shared memory,
//    merges them in split order (so the result is the same bits whatever
//    order the blocks ran in), writes the output and resets the counter to
//    0. One launch a call, no memset: the counters are zeroed once by the
//    binding and left at 0 by each call.
//  * Code size: the merges run once a block, or in one block, from an
//    instruction cache that the cache stream has left cold, so their loops
//    are kept rolled and the tile copy is one out-of-line function (in
//    development, halving the kernel's instructions shortened every call).
//
// float32 q (over a float32 or bf16 cache; parity runs only): the CUDA-core
// kernels decode_split_kernel and decode_combine_kernel, which keep fp32
// products (tensor cores in TF32 or bf16 would miss the fp32 tolerance of
// 3e-5). Inside a block each warp takes keys in turn; a key's row is spread
// over LPK lanes in chunks of up to 16 bytes (8 at a group of 16; see
// SplitGeom, which also takes head dims 96 and 160),
// U keys per lane group are loaded before any is used, the G scores are
// reduced across the LPK lanes with shuffles, and the lane keeps running
// (m, l, acc) for its share of the columns. The key slots of a warp, then the
// warps (through shared memory), merge their statistics, and each block
// writes its partial (m, l, acc) in fp32. decode_combine_kernel merges the
// splits and writes the output, one block for each (batch, KV head, query
// head of the group, 32 output columns); a split with no live key carries
// m = -inf, l = 0 and counts for nothing.
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

// The values of a 16-, 8-, 4- or 2-byte chunk of a row, as floats.
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <typename T> __device__ __forceinline__ void unpack(const uint2& u, float* f);
template <typename T> __device__ __forceinline__ void unpack(const uint32_t& u, float* f);
template <typename T> __device__ __forceinline__ void unpack(const unsigned short& u, float* f);
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
template <> __device__ __forceinline__ void unpack<float>(const uint32_t& u, float* f) {
  f[0] = __uint_as_float(u);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint32_t& u, float* f) {
  unpack_bf16_pair(u, f);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const unsigned short& u, float* f) {
  f[0] = __uint_as_float(static_cast<uint32_t>(u) << 16);
}

template <int BYTES> struct ChunkT;
template <> struct ChunkT<16> { using type = uint4; };
template <> struct ChunkT<8> { using type = uint2; };
template <> struct ChunkT<4> { using type = uint32_t; };
template <> struct ChunkT<2> { using type = unsigned short; };

// How the split kernel spreads a K or V row of H elements of TKV over the
// lanes: LPK lanes a key (a power of two, so the score reduces by xor
// shuffles and a warp takes 32 / LPK keys), EPL consecutive elements a
// lane, read in chunks of VEC elements. Rows of 16-byte chunks spread over
// as many lanes as they have chunks, up to 32. A group of 16 query heads
// keeps 16 scores, maxima, sums and accumulator rows a lane: with 16-byte
// chunks (8 bf16 columns a lane at head_dim 128) that is over 300 registers
// and spills, so G = 16 reads 8-byte chunks, which spreads a row over twice
// the lanes and halves each lane's columns (and keeps 2 keys in flight a
// lane group instead of 4). Where the chunk count is not a power of two
// (head dims 96 and 160: 3 or 5 times a power of two), the row takes all
// 32 lanes, H / 32 elements each (3 or 5), read in the widest chunk that
// divides them: single elements.
template <typename TKV, int H, int G>
struct SplitGeom {
  static constexpr int MAX_VEC = (G >= 16 ? 8 : 16) / static_cast<int>(sizeof(TKV));
  static constexpr int NCH = H / MAX_VEC;
  static constexpr bool POW2 = H % MAX_VEC == 0 && (NCH & (NCH - 1)) == 0;
  static constexpr int LPK = POW2 && NCH < 32 ? NCH : 32;
  static constexpr int EPL = H / LPK;
  static constexpr int VEC = EPL % MAX_VEC == 0 ? MAX_VEC
                             : EPL % 4 == 0 && MAX_VEC >= 4 ? 4
                             : EPL % 2 == 0 && MAX_VEC >= 2 ? 2 : 1;
  using Chunk = typename ChunkT<VEC * static_cast<int>(sizeof(TKV))>::type;
  static_assert(H % LPK == 0 && EPL % VEC == 0, "head_dim must fill whole chunks");
};

// weight of a partial with max m in a merge whose max is m_new
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

template <typename TQ, typename TKV, int H, int G>
__global__ void __launch_bounds__(NT) decode_split_kernel(Args a) {
  using Geom = SplitGeom<TKV, H, G>;
  using Chunk = typename Geom::Chunk;
  constexpr int VEC = Geom::VEC;                       // elements per chunk
  constexpr int LPK = Geom::LPK;                       // lanes per key row
  constexpr int EPL = Geom::EPL;                       // elements per lane
  constexpr int CH = EPL / VEC;                        // chunks per lane
  constexpr int KPW = 32 / LPK;                        // keys a warp takes at once
  constexpr int U = G >= 16 ? 2 : sizeof(TKV) == 2 ? 4 : 2;  // keys in flight per lane group
  constexpr int STEP = NW * KPW;                       // keys the block takes at once
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
    case 96: return by_group<TQ, TKV, 96>(G, a);
    case 128: return by_group<TQ, TKV, 128>(G, a);
    case 160: return by_group<TQ, TKV, 160>(G, a);
    case 256: return by_group<TQ, TKV, 256>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync over a cp.async ring, the split merge fused
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MK = 64;             // keys per tile
constexpr int KS = 4;              // key slices of a tile, one warp each
constexpr int MMA_MAX_SPLITS = 132;
constexpr int STATS_BYTES = 1024;  // the key slices' (m, l), the ticket
constexpr size_t MAX_MERGE_BYTES = 200 * 1024;  // what the merge may stage

// shared memory the merge of `splits` partials stages: (m, l) rows of 16 and
// the accs
inline size_t merge_bytes(int splits, int G, int H) {
  return static_cast<size_t>(splits) * (16 * sizeof(float2) + static_cast<size_t>(G) * H * 4);
}
constexpr float LOG2E = 1.4426950408889634f;

struct MmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* pos;
  bf16* out;
  float* part;   // [B, K, splits, G, H] acc, then [B, K, splits, G] (m, l); splits > 1
  int* tickets;  // [B * K], zero between calls; splits > 1
  int B, S, N, K, G, splits;
  int stages;       // K/V ring stages (set by the launch)
  float scale;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
};

// Shared memory of the bf16 kernel: Q [16][RS] bf16, the key slices' (m, l)
// and the ticket, then a scratch region that holds the K/V ring while the
// tiles are read, then the key slices' O [KS][16][RS] fp32 for their merge,
// and in the block that merges the splits their (m, l) [splits][16] and
// their partial acc [splits][G][H]. Rows are padded by 8 bf16 (16 bytes), so
// the 8 rows an ldmatrix reads start 4 banks apart and 16-byte chunks stay
// aligned.
template <int H>
struct Mma {
  static constexpr int CS = H > 128 ? 2 : 1;  // column halves of O (head_dim 160, 256)
  static constexpr int THREADS = 32 * KS * CS;
  static constexpr int HC = H / CS;           // O's columns per warp
  static constexpr int RS = H + 8;            // row stride, elements
  static constexpr int MAX_STAGES = H > 64 ? 3 : 4;
  static constexpr size_t Q_BYTES = 16 * RS * sizeof(bf16);
  static constexpr size_t STAGE_BYTES = 2 * MK * RS * sizeof(bf16);  // K and V tiles
  static_assert(MAX_STAGES * STAGE_BYTES + Q_BYTES + STATS_BYTES <= 227 * 1024,
                "the ring fits a block");
  static_assert(KS * 16 * RS * sizeof(float) <= STAGE_BYTES, "O's merge fits a stage");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 sum
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the first of the n tiles that split sp of `splits` takes; it takes
// [split_first(sp), split_first(sp + 1)) (32-bit: sp n < 2^32 for any cache
// of fewer than 2^31 rows)
__device__ __forceinline__ int split_first(int sp, int n, int splits) {
  return static_cast<int>(static_cast<unsigned>(sp) * static_cast<unsigned>(n) /
                          static_cast<unsigned>(splits));
}

// 2^x by the SFU alone (relative error ~2^-22; results below 2^-126 flush to
// 0, which no weight here needs): exp2f adds range fix-ups to every call
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cap * tanh(x / cap) as cap * (1 - 2 / (1 + e^(2x / cap))), with
// k = 2 log2(e) / cap: within ~1e-7 of tanh absolutely (what a logit's error
// is measured in), at a few instructions where tanhf takes tens
__device__ __forceinline__ float soft_cap(float x, float cap, float k) {
  const float e = ex2(x * k);
  return cap * (1.f - __fdividef(2.f, 1.f + e));  // e = inf: 2 / inf = 0
}

// atomically adds 1 to *counter and returns its old value: a release of the
// caller's (and, through a barrier before it, its block's) writes and an
// acquire of the writes released before it
__device__ __forceinline__ int ticket(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Copies keys [first, first + MK) of one KV head's K and V rows (row stride
// `row` elements) into a stage: K [MK][H + 8], then V; rows past hi are
// zero-filled. Out of line: the prologue and the refill share one copy of
// the unrolled loop.
template <int H, int THREADS>
__device__ __noinline__ void load_kv_tile(bf16* kt, const bf16* kb, const bf16* vb, size_t row,
                                          int first, int hi) {
  constexpr int RS = H + 8, CPR = H / 8;
  bf16* vt = kt + MK * RS;
#pragma unroll
  for (int j = 0; j < MK * CPR / THREADS; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int rr = idx / CPR, col = (idx % CPR) * 8;
    const bool in = first + rr <= hi;
    const size_t off = in ? static_cast<size_t>(first + rr) * row + col : 0;
    repro::cp_async16(kt + rr * RS + col, kb + off, in);
    repro::cp_async16(vt + rr * RS + col, vb + off, in);
  }
}

// Fragment coordinates: lane = 4 r + c. An m16n8 accumulator holds rows r
// (elements 0, 1) and r + 8 (2, 3), columns 2c and 2c + 1. Scores are kept in
// log2 units (scaled by log2 e after the softcap), so exp2 gives the weights.
template <int H>
__global__ void __launch_bounds__(Mma<H>::THREADS) decode_mma_kernel(MmaArgs a) {
  using L = Mma<H>;
  constexpr int RS = L::RS;
  constexpr int THREADS = L::THREADS;
  constexpr int CPR = H / 8;     // 16-byte chunks of a row
  constexpr int NO = L::HC / 8;  // O's n8 tiles per warp
  constexpr int H4 = H / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* sm_m = reinterpret_cast<float*>(smem + L::Q_BYTES);  // [KS][16]
  float* sm_l = sm_m + KS * 16;                                // [KS][16]
  int* sm_ticket = reinterpret_cast<int*>(sm_l + KS * 16);
  unsigned char* scratch = smem + L::Q_BYTES + STATS_BYTES;
  bf16* ring = reinterpret_cast<bf16*>(scratch);

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ks = warp % KS, cs = warp / KS;  // key slice, column half
  const int r = lane / 4, c = lane % 4;
  const int G = a.G, stages = a.stages, splits = a.splits;
  const size_t bk = static_cast<size_t>(b) * a.K + kvh;
  const bf16* qb = a.q + bk * G * H;
  bf16* ob = a.out + bk * G * H;

  // Q's G rows (zeros below), copied while pos is read: the first group
#pragma unroll 1
  for (int idx = tid; idx < 16 * CPR; idx += THREADS) {
    const int rr = idx / CPR, col = (idx % CPR) * 8;
    const bool in = rr < G;
    repro::cp_async16(qs + rr * RS + col, in ? qb + rr * H + col : qb, in);
  }

  // the live keys [lo, hi] of this sequence, and this block's tiles
  const int p = a.pos[b];
  const int hi = min(p, a.S - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int n_tiles = hi >= lo ? (hi - lo) / MK + 1 : 0;
  const int t0 = split_first(split, n_tiles, splits);
  const int n_blk = split_first(split + 1, n_tiles, splits) - t0;

  const size_t row = static_cast<size_t>(a.K) * H;
  const bf16* kb = a.k + static_cast<size_t>(b) * a.S * row + static_cast<size_t>(kvh) * H;
  const bf16* vb = a.v + static_cast<size_t>(b) * a.S * row + static_cast<size_t>(kvh) * H;

  // tile t0 + i into stage i % stages, zeros past hi
  auto load_tile = [&](int i) {
    load_kv_tile<H, THREADS>(ring + (i % stages) * (2 * MK * RS), kb, vb, row,
                             lo + (t0 + i) * MK, hi);
  };

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows r and r + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  const bool upper = G > 8;             // rows 8-15 hold query heads
  const float cap_k = a.softcap > 0.f ? 2.f * LOG2E / a.softcap : 0.f;

  if (n_blk > 0) {
    int committed = min(stages, n_blk);
    for (int i = 0; i < committed; ++i) {
      load_tile(i);
      repro::cp_async_commit();  // Q joins the first tile's group
    }
    repro::cp_async_wait_upto(committed - 1);
    __syncthreads();
    // Q's A fragments, k-step kk: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
    uint32_t qf[H / 16][4];
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      ldsm_x4(qf[kk], qs + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);

    for (int i = 0; i < n_blk; ++i) {
      repro::cp_async_wait_upto(committed - i - 1);
      __syncthreads();  // tile i is visible, and every warp is done with tile i - 1
      // refill tile i - 1's stage before computing tile i
      if (i > 0 && committed < n_blk) {
        load_tile(committed++);
        repro::cp_async_commit();
      }
      const bf16* kt = ring + (i % stages) * (2 * MK * RS);
      const bf16* vt = kt + MK * RS;

      // S = Q K^T over this warp's 16 keys: two n8 tiles, each summed in
      // two chains (even and odd k-steps) to halve the dependent mma's; the
      // x4 load gives (keys 0-7 | 8-15) x (k 0-7 | 8-15) as b0, b1 of each
      float s[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (ks * 16 + (lane / 16) * 8 + lane % 8) * RS + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma16816(s[kk % 2][0], qf[kk], kf[0], kf[1]);
        mma16816(s[kk % 2][1], qf[kk], kf[2], kf[3]);
      }

      // scale, softcap (before the max), mask; element (j, e) is key
      // kbase + 8 j + 2 c + (e & 1) of row r (e < 2) or r + 8 (skipped
      // while those rows are padding)
      const int kbase = lo + (t0 + i) * MK + ks * 16;
      float x[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = (s[0][j][e] + s[1][j][e]) * a.scale;
          if (e >= 2 && !upper) v = 0.f;
          else if (a.softcap > 0.f) v = soft_cap(v, a.softcap, cap_k);
          v = kbase + 8 * j + 2 * c + (e & 1) <= hi ? v * LOG2E : -INFINITY;
          x[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      // online softmax: the 4 lanes of a row share it
      float m_safe[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
        alpha[h] = ex2(m[h] - m_safe[h]);               // m = -inf: 0
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = e >= 2 && !upper ? 0.f : ex2(x[j][e] - m_safe[e >> 1]);
          x[j][e] = pr;  // masked: 0
          l[e >> 1] += pr;
        }
#pragma unroll
      for (int i2 = 0; i2 < NO; ++i2) {
        o[i2][0] *= alpha[0];
        o[i2][1] *= alpha[0];
        if (upper) {
          o[i2][2] *= alpha[1];
          o[i2][3] *= alpha[1];
        }
      }

      // O += P V over this warp's columns: P from the score registers; the
      // transposed x4 load gives (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
      const uint32_t pa[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                              pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vt + (ks * 16 + lane % 16) * RS + cs * L::HC + nn * 16 + (lane / 16) * 8);
        mma16816(o[2 * nn], pa, vf[0], vf[1]);
        mma16816(o[2 * nn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with the ring
  } else {
    repro::cp_async_wait<0>();  // Q's copies, unused
  }

  const size_t n_part = static_cast<size_t>(a.B) * a.K * splits * G;
  float* part_acc = a.part + bk * splits * G * H;  // [splits][G][H]
  float2* part_ml = reinterpret_cast<float2*>(a.part + n_part * H) + bk * splits * G;
  if (n_blk > 0 || splits == 1) {
    // merge the key slices (in slice order) through the scratch region,
    // which the ring no longer needs
    float* so = reinterpret_cast<float*>(scratch);  // [KS][16][RS]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if (cs == 0 && c == 0) {
      sm_m[ks * 16 + r] = m[0];
      sm_m[ks * 16 + r + 8] = m[1];
      sm_l[ks * 16 + r] = l[0];
      sm_l[ks * 16 + r + 8] = l[1];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = cs * L::HC + i * 8 + 2 * c;
      *reinterpret_cast<float2*>(so + (ks * 16 + r) * RS + col) = make_float2(o[i][0], o[i][1]);
      *reinterpret_cast<float2*>(so + (ks * 16 + r + 8) * RS + col) =
          make_float2(o[i][2], o[i][3]);
    }
    __syncthreads();

    // the block's (m, l, acc): the output itself at one split, else a
    // partial; each thread weighs the slices of its row itself
#pragma unroll 1
    for (int idx = tid; idx < G * H4; idx += THREADS) {
      const int g = idx / H4, h = (idx % H4) * 4;
      float mm = -INFINITY;
#pragma unroll
      for (int j = 0; j < KS; ++j) mm = fmaxf(mm, sm_m[j * 16 + g]);
      const float ms = mm == -INFINITY ? 0.f : mm;
      float ll = 0.f;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float w = ex2(sm_m[j * 16 + g] - ms);
        const float4 u = *reinterpret_cast<const float4*>(so + (j * 16 + g) * RS + h);
        ll = fmaf(w, sm_l[j * 16 + g], ll);
        v.x = fmaf(w, u.x, v.x);
        v.y = fmaf(w, u.y, v.y);
        v.z = fmaf(w, u.z, v.z);
        v.w = fmaf(w, u.w, v.w);
      }
      if (splits == 1) {
        const float inv = ll == 0.f ? 1.f : 1.f / ll;
        *reinterpret_cast<uint2*>(ob + idx * 4) =
            make_uint2(pack_bf16(v.x * inv, v.y * inv), pack_bf16(v.z * inv, v.w * inv));
      } else {
        *reinterpret_cast<float4*>(part_acc + static_cast<size_t>(split) * G * H + idx * 4) = v;
        if (h == 0) part_ml[split * G + g] = make_float2(mm, ll);
      }
    }
    if (splits == 1) return;
  }
  // An empty split writes nothing: the merge knows it from pos, as this
  // block did. The ticket is taken by one thread with release and acquire
  // semantics at device scope, after a barrier that orders the block's
  // partial before it (the barrier and the release are cumulative); the
  // barrier after it orders the merge's reads after the acquire.
  __syncthreads();
  if (tid == 0) *sm_ticket = ticket(a.tickets + bk);
  __syncthreads();
  if (*sm_ticket != splits - 1) return;

  // The last block merges the splits in split order. Their (m, l) come into
  // shared memory, and their partial acc by cp.async (through L2), every
  // copy in flight at once; an empty split's acc is zero-filled and its
  // (m, l) taken as (-inf, 0). Each thread weighs the splits of its row
  // itself: the row's max, then in split order each split's weight, the sum
  // l and the sum of the accs. The loops are kept short: one block runs
  // this code, from a cold instruction cache.
  const int gh4 = G * H4;
  const bool full = n_tiles >= splits;  // then every split took a tile
  float2* mml = reinterpret_cast<float2*>(scratch);               // [splits][16]
  float4* stage = reinterpret_cast<float4*>(mml + splits * 16);    // [splits][G][H / 4]
  const float4* src = reinterpret_cast<const float4*>(part_acc);
#pragma unroll 1
  for (int q = tid; q < splits * gh4; q += THREADS) {
    const int sp = q / gh4;
    const bool in = full || split_first(sp + 1, n_tiles, splits) > split_first(sp, n_tiles, splits);
    repro::cp_async16(stage + q, src + q, in);
  }
  repro::cp_async_commit();
#pragma unroll 1
  for (int idx = tid; idx < splits * G; idx += THREADS) {
    const int sp = idx / G;
    const bool in = full || split_first(sp + 1, n_tiles, splits) > split_first(sp, n_tiles, splits);
    mml[sp * 16 + idx % G] = in ? __ldcg(part_ml + idx) : make_float2(-INFINITY, 0.f);
  }
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int idx = tid; idx < gh4; idx += THREADS) {
    const int g = idx / H4;
    float mm = -INFINITY;
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, mml[sp * 16 + g].x);
    const float ms = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float2 ml = mml[sp * 16 + g];
      const float w = ex2(ml.x - ms);  // an empty split: 0
      const float4 v = stage[sp * gh4 + idx];
      ll = fmaf(w, ml.y, ll);
      x.x = fmaf(w, v.x, x.x);
      x.y = fmaf(w, v.y, x.y);
      x.z = fmaf(w, v.z, x.z);
      x.w = fmaf(w, v.w, x.w);
    }
    const float inv = ll == 0.f ? 1.f : 1.f / ll;
    *reinterpret_cast<uint2*>(ob + idx * 4) =
        make_uint2(pack_bf16(x.x * inv, x.y * inv), pack_bf16(x.z * inv, x.w * inv));
  }
  if (tid == 0) a.tickets[bk] = 0;  // every split has drawn: ready for the next call
}

// Shared memory a launch needs: the ring of `stages` tiles, or, when that is
// less, what the merge stages (every split's (m, l) rows and partial acc).
template <int H>
size_t mma_bytes(int stages, int splits, int G) {
  using L = Mma<H>;
  size_t scratch = stages * L::STAGE_BYTES;
  const size_t merge = splits > 1 ? merge_bytes(splits, G, H) : 0;
  if (merge > scratch) scratch = merge;
  return L::Q_BYTES + STATS_BYTES + scratch;
}

template <int H>
cudaError_t launch_mma(MmaArgs a, cudaStream_t stream) {
  using L = Mma<H>;
  const int live = a.window > 0 && a.window < a.S ? a.window : a.S;
  const int per = ((live + MK - 1) / MK + a.splits - 1) / a.splits;  // most tiles a block takes
  a.stages = per < 1 ? 1 : per > L::MAX_STAGES ? L::MAX_STAGES : per;
  if (a.splits > 1 && merge_bytes(a.splits, a.G, H) > MAX_MERGE_BYTES) return cudaErrorInvalidValue;
  const size_t bytes = mma_bytes<H>(a.stages, a.splits, a.G);
  auto kernel = decode_mma_kernel<H>;
  // the opt-in above 48 KB, set once per device for the largest size asked
  static int set_bytes[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024 && (dev >= 64 || static_cast<int>(bytes) > set_bytes[dev])) {
    err = repro::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) set_bytes[dev] = static_cast<int>(bytes);
  }
  kernel<<<dim3(a.B, a.K, a.splits), L::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// float32 q [B,N,H] and out [B,N,H]; k/v [B,S,K,H] float32 or bfloat16;
// pos [B] int32 on the device, each in [0, S); part_acc [B,K,splits,N/K,H] and
// part_ml [B,K,splits,N/K,2] float32 scratch, splits <= 1024. All contiguous, k
// and v 16-byte aligned. window <= 0 means no window, softcap <= 0 no softcap.
// The live keys of a sequence are cut into runs of whole `tile` keys, one per
// split. Returns the launches' cudaError_t; both kernels run on `stream`.
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
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kFloat32)
    return by_head<float, float>(H, G, a);
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kBFloat16)
    return by_head<float, bf16>(H, G, a);
  return cudaErrorInvalidValue;
}

// bfloat16 q [B,N,H], out [B,N,H] and k/v [B,S,K,H]; pos [B] int32 on the
// device, each in [0, S); N/K <= 16, head_dim 16, 32, 64, 96, 128, 160 or 256. With
// splits > 1 (at most 132, and splits * (128 + 4 * (N/K) * H) bytes at most
// 200 KB, what the merge stages): part, float32 scratch of B*K*splits*(N/K)*(H+2)
// elements, and tickets, B*K int32 that are 0 before the call and are 0 again
// after it; with splits = 1 both may be null. All contiguous, q, k, v and
// part 16-byte aligned. window <= 0 means no window, softcap <= 0 no softcap.
// One launch on `stream`; returns its cudaError_t.
extern "C" int repro_decode_attention_mma_fwd(const void* q, const void* k, const void* v,
                                              const void* pos, void* out, void* part,
                                              void* tickets, int B, int S, int N, int K, int H,
                                              int splits, float scale, int window,
                                              float softcap, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || N <= 0 || K <= 0 || K > 65535 || N % K != 0 ||
      N / K > 16 || splits <= 0 || splits > MMA_MAX_SPLITS ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const int*>(pos), static_cast<bf16*>(out),
            static_cast<float*>(part), static_cast<int*>(tickets), B, S, N, K, N / K, splits,
            1, scale, window, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return launch_mma<16>(a, st);
    case 32: return launch_mma<32>(a, st);
    case 64: return launch_mma<64>(a, st);
    case 96: return launch_mma<96>(a, st);
    case 128: return launch_mma<128>(a, st);
    case 160: return launch_mma<160>(a, st);
    case 256: return launch_mma<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
