// The AdamW update of one parameter leaf, in place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port's counterpart of the update that
// src/repro/training/optim.py (apply_updates) leaves to XLA, which fuses the
// whole update under jax.jit into one pass over each leaf. Eagerly, PyTorch
// runs it as 13 to 17 elementwise kernels a leaf, each reading and writing
// whole float32 tensors. Here one launch a leaf reads p, g, m and v once and
// writes p, m and v once:
//
//   g  = g * scale                              (with clipping only)
//   m  = m * b1 + g * (1 - b1)
//   v  = v * b2 + (g * (1 - b2)) * g
//   d  = (m / b1c) / (sqrt(v / b2c) + eps)
//   d  = d + wd * p                             (matrices only: wd = 0 else)
//   p  = p - d * lr                             (in float32, then p's dtype)
//
// Each line is the plain version's (kernels/ref.py adamw) float32
// operations in its order, every one rounded to nearest on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into an FMA),
// so the kernel equals the plain version bit for bit. lr, the two bias
// corrections b1c and b2c and the clip scale are read from device memory:
// they change every step, and a CUDA graph that captured them as values
// would replay one step's learning rate forever. The constants b1, 1 - b1,
// b2, 1 - b2, eps and wd are float32 values rounded from Python's doubles,
// as PyTorch rounds a scalar operand.
//
// What bounds it: bytes. A float32 leaf moves 28 bytes an element (p read
// and written, g read, m and v read and written; 24 with bfloat16 p) for
// 14 to 17 float32 operations, far below the ~20 operations a byte at
// which the card turns from its 3.35 TB/s to its 67 TFLOP/s of float32. The
// design is a plain grid-stride loop of coalesced 4-byte accesses with
// enough blocks in flight to cover the latency; vectorised accesses and one
// launch for many leaves are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks of a launch at most: 8 waves of 2048 threads on each of 132 SMs;
// a larger leaf loops
constexpr int64_t kMaxBlocks = 132 * 8 * 2048 / kThreads;

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

template <typename P>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, int64_t n, const float* __restrict__ lr_ptr,
             const float* __restrict__ b1c_ptr, const float* __restrict__ b2c_ptr,
             const float* __restrict__ scale_ptr, Consts c) {
  const float lr = *lr_ptr;
  const float b1c = *b1c_ptr;
  const float b2c = *b2c_ptr;
  const bool clip = scale_ptr != nullptr;
  const float scale = clip ? *scale_ptr : 1.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i];
    if (clip) gi = __fmul_rn(gi, scale);
    const float mi = __fadd_rn(__fmul_rn(m[i], c.b1), __fmul_rn(gi, c.one_minus_b1));
    const float vi =
        __fadd_rn(__fmul_rn(v[i], c.b2), __fmul_rn(__fmul_rn(gi, c.one_minus_b2), gi));
    m[i] = mi;
    v[i] = vi;
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, b2c)), c.eps);
    float d = __fdiv_rn(__fdiv_rn(mi, b1c), denom);
    const float pi = repro::to_float(p[i]);
    if (c.wd != 0.0f) d = __fadd_rn(d, __fmul_rn(c.wd, pi));
    p[i] = repro::from_float<P>(__fsub_rn(pi, __fmul_rn(d, lr)));
  }
}

template <typename P>
cudaError_t launch(void* p, const void* g, void* m, void* v, int64_t n, const void* lr,
                   const void* b1c, const void* b2c, const void* scale, Consts c,
                   cudaStream_t s) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  adamw_kernel<P><<<blocks, kThreads, 0, s>>>(
      static_cast<P*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, static_cast<const float*>(lr),
      static_cast<const float*>(b1c), static_cast<const float*>(b2c),
      static_cast<const float*>(scale), c);
  return cudaGetLastError();
}

}  // namespace

// p [n] (dtype 0 float32, 1 bfloat16), g, m, v [n] float32, all contiguous;
// lr, b1c, b2c one float32 each on the device; scale one float32 on the
// device, or null for no clipping. Returns a cudaError_t.
extern "C" int repro_adamw_fwd(void* p, const void* g, void* m, void* v, int64_t n, int dtype,
                               const void* lr, const void* b1c, const void* b2c,
                               const void* scale, float b1, float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float wd, void* stream) {
  if (n <= 0 || lr == nullptr || b1c == nullptr || b2c == nullptr)
    return cudaErrorInvalidValue;
  const Consts c{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch<float>(p, g, m, v, n, lr, b1c, b2c, scale, c, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(p, g, m, v, n, lr, b1c, b2c, scale, c, s);
  return cudaErrorInvalidValue;
}
