// LayerNorm forward and backward on Hopper.
//
// Forward: replaces mxnet_tpu/ops/pallas_kernels/layer_norm.py
// `_fwd_pallas` / `_fwd_kernel`: for each row of x (rows, N) it computes
// the float32 mean, then the float32 variance of (x - mean) (two passes
// over values held in registers, as the TPU kernel does over its VMEM
// block), rstd = rsqrt(var + eps), and y = (x - mean) * rstd * gamma +
// beta in x's dtype.  mean and rstd are written as (rows,) float32 for the
// backward.
//
// Backward: replaces `_bwd_pallas` / `_bwd_kernel`: from x, gamma, the
// forward's mean and rstd, and dy it computes
//   dx = rstd * (g dy - mean(g dy) - xhat * mean(g dy * xhat))
// in x's dtype, and dgamma = sum_rows dy * xhat, dbeta = sum_rows dy in
// float32, written in gamma's dtype.
//
// Bound on the H100: memory.  The forward reads each element once and
// writes it once (rows * N * 2 * itemsize bytes at 3.35 TB/s); the
// backward reads x and dy and writes dx (rows * N * 3 * itemsize).  The
// arithmetic is a few operations per element.  At serving decode (rows =
// batch <= 8) a launch is worth more than the bytes, so the forward is
// launch-bound there.
//
// Design, forward: one block of 256 threads per row.  Thread t holds
// elements t, t + 256, ... in registers (VPT of them, N <= 256 * 32 =
// 8192), so the row is read from device memory exactly once, neighbouring
// threads read neighbouring addresses, and both reductions are warp
// shuffles plus one shared-memory step.
//
// Design, backward: the TPU kernel carries dgamma/dbeta across its
// sequential grid; here blocks run in no order.  So each block takes a
// chunk of consecutive rows (the same register layout per row as the
// forward, with gamma and the chunk's dgamma/dbeta partial sums held in
// registers across its rows), writes its partial sums to a float32
// workspace (chunks, N), and a second small kernel sums the chunks of
// each column in a fixed order.  No atomics: the result is the same from
// run to run.  The workspace is (chunks, N) * 2 * 4 bytes, at most 512
// chunks.  No vector loads, no rows-per-block packing and no persistent
// blocks yet: those are for a later change.

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


// Sums of (a, b) over the block; every thread gets the result.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = lane < kWarps ? scratch[lane] : make_float2(0.f, 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
  }
  return t;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int rows, int n,
                  int rows_per_chunk) {
  __shared__ float2 scratch[kWarps];
  float g[VPT], dg[VPT], db[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    g[k] = i < n ? to_float(gamma[i]) : 0.f;
    dg[k] = 0.f;
    db[k] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min((long long)rows, r0 + rows_per_chunk);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * n;
    const T* dyr = dy + row * n;
    const float mu = mean[row], rs = rstd[row];
    float xh[VPT], gd[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n) {
        const float d = to_float(dyr[i]);
        xh[k] = (to_float(xr[i]) - mu) * rs;
        gd[k] = d * g[k];
        dg[k] += d * xh[k];
        db[k] += d;
      } else {
        xh[k] = 0.f;
        gd[k] = 0.f;
      }
      s1 += gd[k];
      s2 += gd[k] * xh[k];
    }
    const float2 s = block_sum2(s1, s2, scratch);
    const float m1 = s.x / n, m2 = s.y / n;
    T* dxr = dx + row * n;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n) dxr[i] = from_float<T>(rs * (gd[k] - m1 - xh[k] * m2));
    }
  }
  float* dgp = dg_part + (long long)blockIdx.x * n;
  float* dbp = db_part + (long long)blockIdx.x * n;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n) {
      dgp[i] = dg[k];
      dbp[i] = db[k];
    }
  }
}

// dgamma/dbeta from the per-chunk partial sums: a block takes 32 columns;
// its 8 warps sum every 8th chunk of them (a warp reads 32 neighbouring
// columns), then one warp adds the 8 sums, always in the same order.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                         const float* __restrict__ db_part,
                         T* __restrict__ dg, T* __restrict__ db, int chunks,
                         int n) {
  __shared__ float sg[8][33], sb[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < n) {
    for (int k = ty; k < chunks; k += 8) {
      a += dg_part[(long long)k * n + c];
      b += db_part[(long long)k * n + c];
    }
  }
  sg[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < n) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      ta += sg[l][tx];
      tb += sb[l][tx];
    }
    dg[c] = from_float<T>(ta);
    db[c] = from_float<T>(tb);
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

template <typename T>
void launch_bwd(const void* x, const void* g, const float* mean,
                const float* rstd, const void* dy, void* dx, float* dg_part,
                float* db_part, void* dg, void* db, int rows, int n,
                int chunks, int rows_per_chunk, cudaStream_t stream) {
  const int vpt = (n + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
#define MXT_LN_BWD_CASE(V)                                              \
  ln_bwd_kernel<T, V><<<chunks, kThreads, 0, stream>>>(                  \
      xp, gp, mean, rstd, dyp, dxp, dg_part, db_part, rows, n,          \
      rows_per_chunk)
  if (vpt <= 1) {
    MXT_LN_BWD_CASE(1);
  } else if (vpt <= 2) {
    MXT_LN_BWD_CASE(2);
  } else if (vpt <= 4) {
    MXT_LN_BWD_CASE(4);
  } else if (vpt <= 8) {
    MXT_LN_BWD_CASE(8);
  } else if (vpt <= 16) {
    MXT_LN_BWD_CASE(16);
  } else {
    MXT_LN_BWD_CASE(32);
  }
#undef MXT_LN_BWD_CASE
  ln_bwd_reduce_kernel<T><<<(n + 31) / 32, 256, 0, stream>>>(
      dg_part, db_part, static_cast<T*>(dg), static_cast<T*>(db), chunks, n);
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

// dtype: 0 float32, 1 bfloat16.  x, dy, dx: (rows, n) contiguous in
// dtype; gamma, dgamma, dbeta: (n,) in dtype; mean, rstd: (rows,)
// float32; dg_part, db_part: (chunks, n) float32 scratch, with
// chunks * rows_per_chunk >= rows and chunks <= rows.  Launches the row
// kernel and the chunk reduction on the stream.
int mxt_layer_norm_bwd(int dtype, const void* x, const void* gamma,
                       const float* mean, const float* rstd, const void* dy,
                       void* dx, float* dg_part, float* db_part, void* dgamma,
                       void* dbeta, int rows, int n, int chunks,
                       int rows_per_chunk, void* stream) {
  if (n < 1 || n > mxt_layer_norm_max_n() || rows < 1 || chunks < 1 ||
      rows_per_chunk < 1 || chunks > rows ||
      (long long)chunks * rows_per_chunk < rows || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(x, gamma, mean, rstd, dy, dx, dg_part, db_part, dgamma,
                      dbeta, rows, n, chunks, rows_per_chunk, s);
  } else {
    launch_bwd<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dg_part, db_part,
                              dgamma, dbeta, rows, n, chunks, rows_per_chunk,
                              s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
