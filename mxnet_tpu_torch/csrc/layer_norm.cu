// LayerNorm forward on Hopper.
//
// Replaces mxnet_tpu/ops/pallas_kernels/layer_norm.py `_fwd_pallas` /
// `_fwd_kernel`: for each row of x (rows, N) it computes the float32
// mean, then the float32 variance of (x - mean) (two passes over values
// held in registers, as the TPU kernel does over its VMEM block),
// rstd = rsqrt(var + eps), and y = (x - mean) * rstd * gamma + beta in
// x's dtype.  mean and rstd are written as (rows,) float32 for the
// backward.
//
// Bound on the H100: memory.  Each element is read once and written
// once (rows * N * 2 * itemsize bytes at 3.35 TB/s); the arithmetic is a
// few operations per element.  At serving decode (rows = batch <= 8) a
// launch is worth more than the bytes, so the kernel is launch-bound
// there.
//
// Design: one block of 256 threads per row.  Thread t holds elements
// t, t + 256, ... in registers (VPT of them, N <= 256 * 32 = 8192), so
// the row is read from device memory exactly once, neighbouring threads
// read neighbouring addresses, and both reductions are warp shuffles
// plus one shared-memory step.  No vector loads, no rows-per-block
// packing and no persistent blocks yet: those are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Sum of v over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int n, float eps) {
  __shared__ float scratch[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < n ? to_float(xr[i]) : 0.f;
    s += v[k];
  }
  const float mean = block_sum(s, scratch) / n;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const float d = i < n ? v[k] - mean : 0.f;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) / n;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + row * n;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n) {
      yr[i] = from_float<T>((v[k] - mean) * rstd * to_float(gamma[i]) +
                            to_float(beta[i]));
    }
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
void launch(const void* x, const void* g, const void* b, void* y, float* mean,
            float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  const int vpt = (n + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
#define MXT_LN_CASE(V)                                                   \
  ln_fwd_kernel<T, V><<<rows, kThreads, 0, stream>>>(xp, gp, bp, yp, mean, \
                                                    rstd, n, eps)
  if (vpt <= 1) {
    MXT_LN_CASE(1);
  } else if (vpt <= 2) {
    MXT_LN_CASE(2);
  } else if (vpt <= 4) {
    MXT_LN_CASE(4);
  } else if (vpt <= 8) {
    MXT_LN_CASE(8);
  } else if (vpt <= 16) {
    MXT_LN_CASE(16);
  } else {
    MXT_LN_CASE(32);
  }
#undef MXT_LN_CASE
}

}  // namespace

extern "C" {

// Largest row width the kernel holds in registers.
int mxt_layer_norm_max_n() { return kThreads * 32; }

// dtype: 0 float32, 1 bfloat16.  x, y: (rows, n) contiguous; gamma, beta:
// (n,) in x's dtype; mean, rstd: (rows,) float32.
int mxt_layer_norm_fwd(int dtype, const void* x, const void* gamma,
                       const void* beta, void* y, float* mean, float* rstd,
                       int rows, int n, float eps, void* stream) {
  if (n < 1 || n > mxt_layer_norm_max_n() || rows < 0 || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, gamma, beta, y, mean, rstd, rows, n, eps, s);
  } else {
    launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows, n, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
