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
// Design. Two kernels, launched back to back on one stream:
//  1. ssd_cb_kernel forms C_i . B_j for every chunk and every j <= i tile
//     once, into a float scratch [Bsz, S/L, L, L] that the wrapper allocates.
//     B and C do not depend on the head, so this product (the largest one,
//     L^2/2 N per chunk) is made once instead of once per head.
//  2. ssd_scan_kernel: one block owns one (batch, head, 8-column slice of P)
//     and walks the chunks in order, carrying its [N, 8] slice of the fp32
//     state in shared memory: the chunk loop replaces the TPU kernel's
//     sequential grid axis and nothing carries between blocks. The columns
//     of P are independent (y[:, p] and state[:, p] read x[:, p] only), so
//     slicing P multiplies the blocks in flight (192 at mamba2-130m instead
//     of 24) without any exchange between them.
// The [L, L] decay matrix (256 KB in fp32 at L = 256) never exists whole:
// rows are taken 32 at a time, and for each row tile only the source tiles
// up to the diagonal are formed. exp(cum_i - cum_j) is evaluated only for
// j <= i, where the exponent is <= 0; the j > i half, which could overflow
// to inf and turn inf * 0 into NaN, is never computed. Positions padded with
// dt = 0 add nothing and decay by exp(0) = 1, so they leave the state
// exactly as it was.
//
// What bounds it. Per chunk and head the work is ~L^2/2 P + 2 L N P FMAs
// (plus L^2/2 N once per chunk for C.B^T) against L (2 P + 2 N) words of
// traffic: operation-bound, on the CUDA cores here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int NT = 256;  // threads per block
constexpr int TI = 32;   // output rows per tile
constexpr int TJ = 32;   // source positions per C.B^T tile
constexpr int TS = 64;   // source positions per state-update tile
constexpr int PB = 8;    // columns of P per scan block (when P divides by it)

// sum_k a[k] * b[k * bs] over k < n, in four interleaved partial sums so
// that four FMA chains are in flight instead of one
__device__ __forceinline__ float dot_strided(const float* a, const float* b, int bs, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < n; k += 4) {
    s0 = fmaf(a[k], b[k * bs], s0);
    s1 = fmaf(a[k + 1], b[(k + 1) * bs], s1);
    s2 = fmaf(a[k + 2], b[(k + 2) * bs], s2);
    s3 = fmaf(a[k + 3], b[(k + 3) * bs], s3);
  }
  for (; k < n; ++k) s0 = fmaf(a[k], b[k * bs], s0);
  return (s0 + s1) + (s2 + s3);
}

// the same with both operands strided
__device__ __forceinline__ float dot_strided2(const float* a, int as, const float* b, int bs,
                                              int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < n; k += 4) {
    s0 = fmaf(a[k * as], b[k * bs], s0);
    s1 = fmaf(a[(k + 1) * as], b[(k + 1) * bs], s1);
    s2 = fmaf(a[(k + 2) * as], b[(k + 2) * bs], s2);
    s3 = fmaf(a[(k + 3) * as], b[(k + 3) * bs], s3);
  }
  for (; k < n; ++k) s0 = fmaf(a[k * as], b[k * bs], s0);
  return (s0 + s1) + (s2 + s3);
}

// ---------------------------------------------------------------------------
// 1. C.B^T per chunk: CB[b, c, i, j] = C[b, cL + i] . B[b, cL + j], j-tile <= i-tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) ssd_cb_kernel(const float* __restrict__ Bm,
                                                    const float* __restrict__ Cm,
                                                    float* __restrict__ cb, int S, int N,
                                                    int L) {
  const int it = blockIdx.x, jt = blockIdx.y;
  if (jt > it) return;                       // above the diagonal: never read
  extern __shared__ float smem[];
  const int NS = N + 1;
  float* cs = smem;                          // [TI][N+1]
  float* bs = cs + TI * NS;                  // [TJ][N+1]
  const int nc = S / L;
  const int bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int i0 = it * TI, j0 = jt * TJ;
  const int ti = min(TI, L - i0), tj = min(TJ, L - j0);
  const float* Cb = Cm + (static_cast<size_t>(b) * S + static_cast<size_t>(c) * L) * N;
  const float* Bb = Bm + (static_cast<size_t>(b) * S + static_cast<size_t>(c) * L) * N;
  for (int idx = threadIdx.x; idx < TI * N; idx += NT) {
    const int r = idx / N, n = idx % N;
    cs[r * NS + n] = r < ti ? Cb[static_cast<size_t>(i0 + r) * N + n] : 0.f;
    bs[r * NS + n] = r < tj ? Bb[static_cast<size_t>(j0 + r) * N + n] : 0.f;
  }
  __syncthreads();
  float* out = cb + static_cast<size_t>(bc) * L * L;
  for (int idx = threadIdx.x; idx < TI * TJ; idx += NT) {
    const int i = idx / TJ, j = idx % TJ;
    if (i < ti && j < tj) {
      out[static_cast<size_t>(i0 + i) * L + j0 + j] = dot_strided(cs + i * NS, bs + j * NS, 1, N);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the scan
// ---------------------------------------------------------------------------

// Shared memory layout of the scan, in floats; all sizes known at launch.
struct Layout {
  int xs, st, cs, work, cum, dts, wsum, total;
  __host__ __device__ Layout(int L, int Pb, int N) {
    xs = 0;                      // x of the chunk, this slice   [L][Pb]
    st = xs + L * Pb;            // carried state, this slice    [N][Pb]
    cs = st + N * Pb;            // C of the row tile            [TI][N+1]
    work = cs + TI * (N + 1);    // G band [TI][L+1] of a row tile, or
                                 // w B of a source tile [TS][N+1]
    const int band = TI * (L + 1), wb = TS * (N + 1);
    cum = work + (band > wb ? band : wb);   // cumsum of A dt [L]
    dts = cum + L;               // dt of the chunk              [L]
    wsum = dts + L;              // per-warp sums of the scan    [NT/32]
    total = wsum + NT / 32;
  }
};

// cum[j] = sum_{k<=j} a * dts[k] over the block: a shuffle scan per warp,
// then the warps' totals, segment by segment of NT positions.
__device__ void block_cumsum(const float* dts, float* cum, float* wsum, float a, int L) {
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
    __syncthreads();  // wsum is rewritten by the next segment
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ cb, T* __restrict__ y, float* __restrict__ fin, int S, int H,
    int P, int N, int L, int Pb) {
  extern __shared__ float smem[];
  const Layout lay(L, Pb, N);
  float* xs = smem + lay.xs;
  float* st = smem + lay.st;
  float* cs = smem + lay.cs;
  float* gb = smem + lay.work;   // row-tile phase
  float* bs = smem + lay.work;   // state-update phase
  float* cum = smem + lay.cum;
  float* dts = smem + lay.dts;
  const int NS = N + 1;          // padded row strides
  const int GS = L + 1;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.z * Pb;
  const int nc = S / L;
  const float a = A[h];
  const float dd = D[h];
  const size_t x_row = static_cast<size_t>(H) * P;   // stride of one position
  const T* xb = x + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P + p0;
  T* yb = y + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P + p0;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const float* Bb = Bm + static_cast<size_t>(b) * S * N;
  const float* Cb = Cm + static_cast<size_t>(b) * S * N;

  for (int idx = tid; idx < N * Pb; idx += NT) st[idx] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const float* cbc = cb + (static_cast<size_t>(b) * nc + c) * L * L;
    __syncthreads();  // the previous chunk is done with xs, dts, cum and st
    for (int idx = tid; idx < L * Pb; idx += NT) {
      const int j = idx / Pb, p = idx % Pb;
      xs[idx] = to_float(xb[(t0 + j) * x_row + p]);
    }
    for (int j = tid; j < L; j += NT) dts[j] = dtb[static_cast<size_t>(t0 + j) * H];
    __syncthreads();
    block_cumsum(dts, cum, smem + lay.wsum, a, L);
    const float cum_last = cum[L - 1];

    for (int i0 = 0; i0 < L; i0 += TI) {
      const int ti = min(TI, L - i0);
      const int jn = i0 + ti;    // sources up to the tile's last row
      // C of the tile, and the whole band G[i][j] = (C_i . B_j) exp(cum_i -
      // cum_j) dt_j, j <= i, at once: many loads in flight, one barrier
      for (int idx = tid; idx < TI * N; idx += NT) {
        const int i = idx / N, n = idx % N;
        cs[i * NS + n] = i < ti ? Cb[static_cast<size_t>(t0 + i0 + i) * N + n] : 0.f;
      }
      for (int idx = tid; idx < ti * jn; idx += NT) {
        const int i = idx / jn, j = idx % jn, gi = i0 + i;
        gb[i * GS + j] = j <= gi   // exponent <= 0
            ? cbc[static_cast<size_t>(gi) * L + j] * expf(cum[gi] - cum[j]) * dts[j]
            : 0.f;
      }
      __syncthreads();
      // y_i = G_i @ x + exp(cum_i) C_i @ state_in + D x_i
      for (int idx = tid; idx < ti * Pb; idx += NT) {
        const int i = idx / Pb, p = idx % Pb, gi = i0 + i;
        const float intra = dot_strided(gb + i * GS, xs + p, Pb, jn);
        const float inter = dot_strided(cs + i * NS, st + p, Pb, N);
        const float yv = intra + expf(cum[gi]) * inter + dd * xs[gi * Pb + p];
        yb[(t0 + gi) * x_row + p] = from_float<T>(yv);
      }
      __syncthreads();  // before the next row tile overwrites cs and the band
    }

    // state' = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    const float decay = expf(cum_last);
    for (int idx = tid; idx < N * Pb; idx += NT) st[idx] *= decay;
    for (int j0 = 0; j0 < L; j0 += TS) {
      const int tj = min(TS, L - j0);
      if (j0 > 0) __syncthreads();   // the previous tile's readers are done
      for (int idx = tid; idx < tj * N; idx += NT) {
        const int j = idx / N, n = idx % N;
        const float w = expf(cum_last - cum[j0 + j]) * dts[j0 + j];
        bs[j * NS + n] = Bb[static_cast<size_t>(t0 + j0 + j) * N + n] * w;
      }
      __syncthreads();
      for (int idx = tid; idx < N * Pb; idx += NT) {
        const int n = idx / Pb, p = idx % Pb;
        st[idx] += dot_strided2(bs + n, NS, xs + j0 * Pb + p, Pb, tj);
      }
    }
  }
  __syncthreads();
  float* fb = fin + (static_cast<size_t>(b) * H + h) * N * P + p0;
  for (int idx = tid; idx < N * Pb; idx += NT) {
    const int n = idx / Pb, p = idx % Pb;
    fb[static_cast<size_t>(n) * P + p] = st[idx];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, void* y, void* fin, void* cb, int Bsz, int S, int H, int P,
                   int N, int L, cudaStream_t stream) {
  const int tiles = (L + TI - 1) / TI;
  const size_t cb_bytes = static_cast<size_t>(TI + TJ) * (N + 1) * sizeof(float);
  cudaError_t err = repro::allow_smem(ssd_cb_kernel, cb_bytes);
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<<<dim3(tiles, tiles, Bsz * (S / L)), NT, cb_bytes, stream>>>(
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(cb), S, N,
      L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int Pb = P % PB == 0 ? PB : P;
  auto kernel = ssd_scan_kernel<T>;
  const size_t bytes = static_cast<size_t>(Layout(L, Pb, N).total) * sizeof(float);
  err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bsz, P / Pb), NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(cb), static_cast<T*>(y), static_cast<float*>(fin), S, H, P, N, L,
      Pb);
  return cudaGetLastError();
}

}  // namespace

// x [Bsz,S,H,P] (dtype), dt [Bsz,S,H], A [H], B/C [Bsz,S,N], D [H] (fp32),
// y [Bsz,S,H,P] (dtype), fin [Bsz,H,N,P] fp32, scratch cb [Bsz,S/L,L,L] fp32;
// all contiguous, S % L == 0. Returns the launches' cudaError_t; both kernels
// run on `stream`.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, void* y, void* fin, void* cb,
                             int dtype, int Bsz, int S, int H, int P, int N, int L,
                             void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S % L != 0 ||
      Bsz > 65535 || H > 65535 || Bsz * (S / L) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, fin, cb, Bsz, S, H, P, N, L, s);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dt, A, B, C, D, y, fin, cb, Bsz, S, H, P, N, L, s);
  return cudaErrorInvalidValue;
}
