// LayerNorm forward and backward on Hopper.
//
// Forward: replaces mxnet_tpu/ops/pallas_kernels/layer_norm.py
// `_fwd_pallas` / `_fwd_kernel`: for each row of x (rows, N) it computes
// the float32 mean, then the float32 variance of (x - mean) (two passes
// over values held in registers, as the TPU kernel does over its VMEM
// block; never E[x^2] - mean^2), rstd = rsqrtf(var + eps), and y = (x -
// mean) * rstd * gamma + beta rounded to nearest even in x's dtype.  mean
// and rstd are written as (rows,) float32 for the backward.
//
// Backward: replaces `_bwd_pallas` / `_bwd_kernel`: from x, gamma, the
// forward's mean and rstd, and dy it computes
//   dx = rstd * (g dy - mean(g dy) - xhat * mean(g dy * xhat))
// in float32, rounded once to x's dtype, and dgamma = sum_rows dy * xhat,
// dbeta = sum_rows dy in float32, written in gamma's dtype.
//
// Bound on the H100: bytes.  The forward reads x once and writes y once
// (rows * N * 2 * itemsize bytes at 3.35 TB/s); the backward reads x and
// dy and writes dx (rows * N * 3 * itemsize).  The arithmetic is a few
// operations a byte, far below the ridge, so the design is about keeping
// enough bytes in flight and moving each once.
//
// Layouts (the launch plan is `_plan_fwd` / `_plan_bwd` in
// ops/pallas_kernels/layer_norm.py; the entries check it and refuse
// another with cudaErrorInvalidValue):
// * 0, a warp a row (N <= 1024): a lane holds up to EPT = 32 elements
//   in registers; both reductions are warp shuffles with no barrier, and
//   a 256-thread block takes up to 8 rows.
// * 1, warps a row (1024 < N <= 8192, or fewer than 8 rows an SM, as in
//   a prefill or decode): a block of W = 2, 4 or 8 warps takes a row (EPT
//   <= 32 each), with one shared-memory step between two warp shuffles a
//   reduction.
// * 2, wide (N > 8192): the 256 threads of a block take a row, looping
//   over it in device memory (forward: a pass for the mean, one for the
//   variance and one for y; a row of 16384 bf16 is 32 KB and stays in L2
//   between them).
// A lane's elements come in vectors of VW = vec_bytes / itemsize: chunk c
// of thread t of the row's team covers elements (c * 32W + t) * VW ...
// + VW - 1, so neighbouring lanes read neighbouring 16 bytes.  vec_bytes
// is the largest of 16, 8, 4, 2 (at least one element) that divides N *
// itemsize and the alignment of every pointer the kernel reads or writes
// row by row (x, y, gamma, beta; dy, dx): a sliced view or an N of 30 or
// 12300 in bf16 runs at a narrower vector.  All of a lane's x is loaded
// before its first reduction; gamma and beta go through the read-only
// path, after the reductions where a thread holds more than 8 elements
// (early, their registers cost the training shape a sixth of its speed).
//
// Backward: persistent blocks, about SMs * resident blocks an SM, 2 where
// registers allow (two rows' x and dy words and gamma's held a thread), 1
// past that (float32 at N = 768 takes 194 registers with no spill).
// Team k of the T teams of the grid (a warp, up to 8 a block; or the
// block) takes rows k, k + T, k + 2T, ...: a static split, by which the
// teams at work at a moment read neighbouring rows.  Per row it works on
// the words loaded for it while the next row's x and dy are in flight,
// forms xhat and g dy, makes one reduction of the pair (sum g dy, sum g
// dy xhat), forms them again from the words and stores dx (narrower
// vectors load each row, and gamma, as they reach them).  dgamma and
// dbeta of a lane's columns are summed over the team's rows in the team's
// own 2 * N floats of dynamic shared memory, each column read and written
// only by the thread that owns it (in registers they cost the occupancy
// the prefetch needs); at the end the block adds its teams' sums column
// by column in team order and writes one partial row to a (blocks, N)
// float32 workspace.  The wide backward keeps its partial sums in that
// row instead.  A second small kernel sums the blocks' rows of each
// column in a fixed order (a few us at (32768, 768): PERF.md).  No
// atomics: every sum's order depends only on the shape and the plan, so
// two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEpt = 32;  // elements a thread holds in registers
constexpr int kRegisterN = kThreads * kMaxEpt;  // widest row, layouts 0, 1
constexpr int kMaxSmemBytes = 64 * 1024;  // dynamic, the backward's sums

// The words a vector of `BYTES` bytes loads in one instruction.
template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

__device__ __forceinline__ void unpack(uint4 w, unsigned* u) {
  u[0] = w.x;
  u[1] = w.y;
  u[2] = w.z;
  u[3] = w.w;
}
__device__ __forceinline__ void unpack(uint2 w, unsigned* u) {
  u[0] = w.x;
  u[1] = w.y;
}
__device__ __forceinline__ void unpack(unsigned w, unsigned* u) { u[0] = w; }
__device__ __forceinline__ void unpack(unsigned short w, unsigned* u) {
  u[0] = w;
}
__device__ __forceinline__ void pack(uint4* p, const unsigned* u) {
  *p = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void pack(uint2* p, const unsigned* u) {
  *p = make_uint2(u[0], u[1]);
}
__device__ __forceinline__ void pack(unsigned* p, const unsigned* u) {
  *p = u[0];
}
__device__ __forceinline__ void pack(unsigned short* p, const unsigned* u) {
  *p = static_cast<unsigned short>(u[0]);
}

// Element k of a vector held as 32-bit words (a bf16 pair a word, low
// half first).
template <typename T>
__device__ __forceinline__ float element(const unsigned* u, int k);
template <>
__device__ __forceinline__ float element<float>(const unsigned* u, int k) {
  return __uint_as_float(u[k]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const unsigned* u,
                                                        int k) {
  const unsigned w = u[k / 2];
  return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
}

template <typename T>
__device__ __forceinline__ void put(unsigned* u, int k, float v);
template <>
__device__ __forceinline__ void put<float>(unsigned* u, int k, float v) {
  u[k] = __float_as_uint(v);
}
template <>
__device__ __forceinline__ void put<__nv_bfloat16>(unsigned* u, int k,
                                                   float v) {
  // round to nearest even, as torch's cast
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(v));
  u[k / 2] = k % 2 ? (u[k / 2] | (h << 16)) : h;
}

template <typename T, int VW>
using Raw = typename Word<int(sizeof(T)) * VW>::type;

// VW elements at p (aligned to their size) in one load through the
// read-only path, as loaded.
template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, VW>*>(p));
}

// The VW elements of a loaded vector as floats.
template <typename T, int VW>
__device__ __forceinline__ void to_floats(Raw<T, VW> w, float* out) {
  unsigned u[(int(sizeof(T)) * VW + 3) / 4];
  unpack(w, u);
#pragma unroll
  for (int k = 0; k < VW; ++k) out[k] = element<T>(u, k);
}

// VW elements of p as floats, in one load through the read-only path.
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  to_floats<T, VW>(load_raw<T, VW>(p), out);
}

// VW floats rounded to T and stored at p in one store.
template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  unsigned u[(int(sizeof(T)) * VW + 3) / 4];
#pragma unroll
  for (int k = 0; k < VW; ++k) put<T>(u, k, v[k]);
  pack(reinterpret_cast<Raw<T, VW>*>(p), u);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over a row's team: its warp (warps == 1), or the block's
// `warps` warps through `scratch` (a float a warp, not written again before
// the block's next barrier); every thread of the team gets it.
__device__ __forceinline__ float team_sum(float v, float* scratch,
                                          int warps) {
  v = warp_sum(v);
  if (warps == 1) return v;
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  return warp_sum(lane < warps ? scratch[lane] : 0.f);
}

__device__ __forceinline__ float2 team_sum2(float a, float b,
                                            float2* scratch, int warps) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (warps == 1) return make_float2(a, b);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const float2 t = lane < warps ? scratch[lane] : make_float2(0.f, 0.f);
  return make_float2(warp_sum(t.x), warp_sum(t.y));
}

// -- forward ---------------------------------------------------------------

// Layouts 0 and 1: a team of `warps` warps a row (a whole block when
// warps > 1), blockDim.x / (32 * warps) rows a block, EPT elements a
// thread in CH = EPT / VW vectors.
template <typename T, int VW, int EPT>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int n, int warps, float eps) {
  constexpr int CH = EPT / VW;
  __shared__ float scratch[2][kWarps];
  const int tpr = warps * 32;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + team;
  if (row >= rows) return;  // a whole warp of layout 0: no barrier
  const T* xr = x + row * n;
  // gamma and beta are loaded with x where a thread holds a few elements
  // (decode's block a row, where one row's latency is the call's); past
  // that, after the reductions, so that their registers do not cut the
  // warps an SM holds
  constexpr bool kEarly = EPT <= 8;
  float v[EPT];
  Raw<T, VW> gw[kEarly ? CH : 1], bw[kEarly ? CH : 1];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = (c * tpr + t) * VW;
    if (i < n) {
      load_vec<T, VW>(xr + i, v + c * VW);
      if constexpr (kEarly) {
        gw[c] = load_raw<T, VW>(gamma + i);
        bw[c] = load_raw<T, VW>(beta + i);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[c * VW + e] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < EPT; ++k) s += v[k];
  const float mean = team_sum(s, scratch[0], warps) / n;
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if ((c * tpr + t) * VW < n) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float d = v[c * VW + e] - mean;
        ss += d * d;
      }
    }
  }
  const float var = team_sum(ss, scratch[1], warps) / n;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + row * n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = (c * tpr + t) * VW;
    if (i < n) {
      float g[VW], b[VW], o[VW];
      if constexpr (kEarly) {
        to_floats<T, VW>(gw[c], g);
        to_floats<T, VW>(bw[c], b);
      } else {
        load_vec<T, VW>(gamma + i, g);
        load_vec<T, VW>(beta + i, b);
      }
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        o[e] = (v[c * VW + e] - mean) * rstd * g[e] + b[e];
      }
      store_vec<T, VW>(yr + i, o);
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Layout 2: the block's 256 threads take a row and loop over it in device
// memory, a VW-vector at a time, once for each of the three passes.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int rows, int n,
                       int warps, float eps) {
  __shared__ float scratch[2][kWarps];
  const long long row = blockIdx.x;
  const int step = kThreads * VW;
  const T* xr = x + row * n;
  float s = 0.f;
  for (int i = threadIdx.x * VW; i < n; i += step) {
    float v[VW];
    load_vec<T, VW>(xr + i, v);
#pragma unroll
    for (int e = 0; e < VW; ++e) s += v[e];
  }
  const float mean = team_sum(s, scratch[0], kWarps) / n;
  float ss = 0.f;
  for (int i = threadIdx.x * VW; i < n; i += step) {
    float v[VW];
    load_vec<T, VW>(xr + i, v);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float d = v[e] - mean;
      ss += d * d;
    }
  }
  const float var = team_sum(ss, scratch[1], kWarps) / n;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + row * n;
  for (int i = threadIdx.x * VW; i < n; i += step) {
    float v[VW], g[VW], b[VW];
    load_vec<T, VW>(xr + i, v);
    load_vec<T, VW>(gamma + i, g);
    load_vec<T, VW>(beta + i, b);
#pragma unroll
    for (int e = 0; e < VW; ++e) v[e] = (v[e] - mean) * rstd * g[e] + b[e];
    store_vec<T, VW>(yr + i, v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// -- backward --------------------------------------------------------------

// Adds v[0 .. VW) to the floats at p (16-byte aligned where VW % 4 == 0).
template <int VW>
__device__ __forceinline__ void add_to(float* p, const float* v) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VW; j += 4) {
      float4 a = *reinterpret_cast<float4*>(p + j);
      a.x += v[j];
      a.y += v[j + 1];
      a.z += v[j + 2];
      a.w += v[j + 3];
      *reinterpret_cast<float4*>(p + j) = a;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) p[j] += v[j];
  }
}

// Blocks an SM the backward row kernel asks registers for: with 16-byte
// vectors a thread holds two rows' x and dy words and gamma's (EPT *
// itemsize * 5 / 4 32-bit registers) and ~40 more, at most 2 blocks (3
// left ptxas 80 registers and spills at EPT = 24 in bf16, and ran 17%
// slower than 2: PERF.md); with narrower ones, 1.
template <typename T, int VW, int EPT>
struct BwdMinBlocks {
  static constexpr int fit = 256 / (EPT * int(sizeof(T)) * 5 / 4 + 40);
  static constexpr int value =
      VW * sizeof(T) < 16 ? 1 : (fit < 2 ? fit : 2);
};

// Layouts 0 and 1: persistent blocks, each team over every T-th row, the
// next row's loads issued before the row is worked on.  Each team
// sums dgamma/dbeta of its threads' columns in its own 2 * n floats of
// dynamic shared memory (each column read and written only by the thread
// that owns it); at the end the block adds its teams' sums column by
// column in team order and writes one partial row.
template <typename T, int VW, int EPT>
__global__ void __launch_bounds__(kThreads, BwdMinBlocks<T, VW, EPT>::value)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int rows, int n, int warps) {
  constexpr int CH = EPT / VW;
  extern __shared__ float4 sums_raw[];
  __shared__ float2 scratch[2][kWarps];
  const int tpr = warps * 32, teams = blockDim.x / tpr;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  float* sums = reinterpret_cast<float*>(sums_raw);
  float* acc_g = sums + 2LL * team * n;
  float* acc_b = acc_g + n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = (c * tpr + t) * VW;
    if (i < n) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        acc_g[i + e] = 0.f;
        acc_b[i + e] = 0.f;
      }
    }
  }
  const long long first = (long long)blockIdx.x * teams + team;
  const long long stride = (long long)gridDim.x * teams;
  // with 16-byte vectors, the row's x and dy as loaded and the next row's
  // loaded before this one is worked on, and gamma's words held for every
  // row; narrower vectors (a word a register each) load each row, and
  // gamma, as they reach them
  constexpr bool kFull = VW * sizeof(T) == 16;
  Raw<T, VW> xw[CH], dw[CH];
  float mu = 0.f, rs = 0.f;
  auto fetch = [&](long long row, Raw<T, VW>* xv, Raw<T, VW>* dv, float* m,
                   float* r) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = (c * tpr + t) * VW;
      if (i < n) {
        xv[c] = load_raw<T, VW>(x + row * n + i);
        dv[c] = load_raw<T, VW>(dy + row * n + i);
      }
    }
    *m = mean[row];
    *r = rstd[row];
  };
  Raw<T, VW> gw[kFull ? CH : 1];
  auto gamma_at = [&](int c, int i, float* g) {
    if constexpr (kFull) {
      to_floats<T, VW>(gw[c], g);
    } else {
      load_vec<T, VW>(gamma + i, g);
    }
  };
  if constexpr (kFull) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = (c * tpr + t) * VW;
      if (i < n) gw[c] = load_raw<T, VW>(gamma + i);
    }
    if (first < rows) fetch(first, xw, dw, &mu, &rs);
  }
  int parity = 0;
  for (long long row = first; row < rows; row += stride) {
    Raw<T, VW> xn[kFull ? CH : 1], dn[kFull ? CH : 1];
    float mun = 0.f, rsn = 0.f;
    if constexpr (kFull) {
      if (row + stride < rows) fetch(row + stride, xn, dn, &mun, &rsn);
    } else {
      fetch(row, xw, dw, &mu, &rs);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = (c * tpr + t) * VW;
      if (i < n) {
        float xv[VW], dv[VW], g[VW];
        to_floats<T, VW>(xw[c], xv);
        to_floats<T, VW>(dw[c], dv);
        gamma_at(c, i, g);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = (xv[e] - mu) * rs;
          const float gd = dv[e] * g[e];
          s1 += gd;
          s2 += gd * xh;
          xv[e] = dv[e] * xh;  // this row's dgamma term
        }
        add_to<VW>(acc_g + i, xv);
        add_to<VW>(acc_b + i, dv);
      }
    }
    const float2 s = team_sum2(s1, s2, scratch[parity], warps);
    parity ^= 1;
    const float m1 = s.x / n, m2 = s.y / n;
    T* dxr = dx + row * n;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = (c * tpr + t) * VW;
      if (i < n) {
        float xv[VW], dv[VW], g[VW];
        to_floats<T, VW>(xw[c], xv);
        to_floats<T, VW>(dw[c], dv);
        gamma_at(c, i, g);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = (xv[e] - mu) * rs;
          xv[e] = rs * (dv[e] * g[e] - m1 - xh * m2);
        }
        store_vec<T, VW>(dxr + i, xv);
      }
    }
    if constexpr (kFull) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        xw[c] = xn[c];
        dw[c] = dn[c];
      }
      mu = mun;
      rs = rsn;
    }
  }
  // the block's teams in order, column by column
  __syncthreads();
  float* dgp = dg_part + (long long)blockIdx.x * n;
  float* dbp = db_part + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int q = 0; q < teams; ++q) {
      g += sums[2LL * q * n + i];
      b += sums[2LL * q * n + n + i];
    }
    dgp[i] = g;
    dbp[i] = b;
  }
}

// Writes (first) or adds v[0 .. VW) to the floats at p (16-byte aligned
// where VW % 4 == 0).
template <int VW>
__device__ __forceinline__ void put_or_add(float* p, const float* v,
                                           bool first) {
  if (first) {
    if constexpr (VW % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VW; j += 4) {
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) p[j] = v[j];
    }
  } else {
    add_to<VW>(p, v);
  }
}

// Layout 2: persistent blocks of one 256-thread team a row; the partial
// sums live in the block's row of the workspace, each column read and
// written only by the thread that owns it (written by the block's first
// row, added to by the rest); each row is read twice, for its two sums
// and for dx.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dg_part,
                       float* __restrict__ db_part, int rows, int n,
                       int warps) {
  __shared__ float2 scratch[2][kWarps];
  const int step = kThreads * VW;
  float* dgp = dg_part + (long long)blockIdx.x * n;
  float* dbp = db_part + (long long)blockIdx.x * n;
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const T* xr = x + row * n;
    const T* dyr = dy + row * n;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
    for (int i = threadIdx.x * VW; i < n; i += step) {
      float xv[VW], dv[VW], g[VW];
      load_vec<T, VW>(xr + i, xv);
      load_vec<T, VW>(dyr + i, dv);
      load_vec<T, VW>(gamma + i, g);
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xh = (xv[e] - mu) * rs;
        const float gd = dv[e] * g[e];
        s1 += gd;
        s2 += gd * xh;
        xv[e] = dv[e] * xh;  // this row's dgamma term
      }
      put_or_add<VW>(dgp + i, xv, first);
      put_or_add<VW>(dbp + i, dv, first);
    }
    const float2 s = team_sum2(s1, s2, scratch[parity], kWarps);
    parity ^= 1;
    const float m1 = s.x / n, m2 = s.y / n;
    T* dxr = dx + row * n;
#pragma unroll 2
    for (int i = threadIdx.x * VW; i < n; i += step) {
      float xv[VW], dv[VW], g[VW];
      load_vec<T, VW>(xr + i, xv);
      load_vec<T, VW>(dyr + i, dv);
      load_vec<T, VW>(gamma + i, g);
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xh = (xv[e] - mu) * rs;
        xv[e] = rs * (dv[e] * g[e] - m1 - xh * m2);
      }
      store_vec<T, VW>(dxr + i, xv);
    }
  }
}

// dgamma/dbeta from the blocks' partial rows: a block takes 32 columns;
// its 32 warps sum every 32nd block's row of them (a warp reads 32
// neighbouring columns), then one warp adds the 32 sums, always in the
// same order.
template <typename T>
__global__ void __launch_bounds__(1024)
    ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                         const float* __restrict__ db_part,
                         T* __restrict__ dg, T* __restrict__ db, int parts,
                         int n) {
  __shared__ float sg[32][33], sb[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int k = ty; k < parts; k += 32) {
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
    for (int l = 0; l < 32; ++l) {
      ta += sg[l][tx];
      tb += sb[l][tx];
    }
    dg[c] = from_float<T>(ta);
    db[c] = from_float<T>(tb);
  }
}

// -- dispatch ----------------------------------------------------------------

template <typename T>
using FwdFn = void (*)(const T*, const T*, const T*, T*, float*, float*, int,
                       int, int, float);
template <typename T>
using BwdFn = void (*)(const T*, const T*, const float*, const float*,
                       const T*, T*, float*, float*, int, int, int);

template <typename T, int VW>
FwdFn<T> fwd_fn(int layout, int ept) {
  if (layout == 2) return ln_fwd_wide_kernel<T, VW>;
  switch (ept) {
    case 8:
      return ln_fwd_kernel<T, VW, 8>;
    case 16:
      return ln_fwd_kernel<T, VW, 16>;
    case 24:
      return ln_fwd_kernel<T, VW, 24>;
    case 32:
      return ln_fwd_kernel<T, VW, 32>;
  }
  return nullptr;
}

template <typename T, int VW>
BwdFn<T> bwd_fn(int layout, int ept) {
  if (layout == 2) return ln_bwd_wide_kernel<T, VW>;
  switch (ept) {
    case 8:
      return ln_bwd_kernel<T, VW, 8>;
    case 16:
      return ln_bwd_kernel<T, VW, 16>;
    case 24:
      return ln_bwd_kernel<T, VW, 24>;
    case 32:
      return ln_bwd_kernel<T, VW, 32>;
  }
  return nullptr;
}

// The kernel of (layout, VW, EPT) for T, or null for a combination that
// does not exist (VW * itemsize above 16 bytes, an EPT not instantiated).
template <typename T, typename Fn, template <typename, int> class Pick>
Fn pick(int layout, int vw, int ept) {
  switch (vw) {
    case 1:
      return Pick<T, 1>::get(layout, ept);
    case 2:
      return Pick<T, 2>::get(layout, ept);
    case 4:
      return Pick<T, 4>::get(layout, ept);
    case 8:
      if constexpr (sizeof(T) == 2) return Pick<T, 8>::get(layout, ept);
  }
  return nullptr;
}
template <typename T, int VW>
struct PickFwd {
  static FwdFn<T> get(int layout, int ept) { return fwd_fn<T, VW>(layout, ept); }
};
template <typename T, int VW>
struct PickBwd {
  static BwdFn<T> get(int layout, int ept) { return bwd_fn<T, VW>(layout, ept); }
};

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

// Whether (layout, vec_bytes, ept, warps, per_block) is a plan the kernels
// take for rows of n elements of itemsize bytes: threads a block on
// success, else 0.
int check_plan(int itemsize, int n, int layout, int vec_bytes, int ept,
               int warps, int per_block) {
  if (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 && vec_bytes != 2)
    return 0;
  if (vec_bytes < itemsize || (long long)n * itemsize % vec_bytes) return 0;
  if (per_block < 1) return 0;
  if (layout == 2) {
    return warps == kWarps && per_block == 1 && n > kRegisterN ? kThreads
                                                               : 0;
  }
  if (layout == 0 ? warps != 1
                  : layout != 1 || (warps != 2 && warps != 4 && warps != 8))
    return 0;
  if (ept != 8 && ept != 16 && ept != 24 && ept != 32) return 0;
  if (ept % (vec_bytes / itemsize) || (long long)32 * warps * ept < n) return 0;
  if (layout == 1 && per_block != 1) return 0;  // a block a row
  const int threads = 32 * warps * per_block;
  return threads <= kThreads ? threads : 0;
}

bool aligned_to(int bytes, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (addr(p) % bytes) return false;
  }
  return true;
}

// Dynamic shared memory of a backward block: the teams' column sums.
int bwd_smem(int layout, int per_block, int n) {
  return layout != 2 ? per_block * 2 * n * 4 : 0;
}

// Lets `fn` take `smem` bytes of dynamic shared memory (with its static
// scratch, past 48 KB only after this opt-in).
cudaError_t allow_smem(const void* fn, int smem) {
  return smem > 47 * 1024
             ? cudaFuncSetAttribute(
                   fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <typename T>
int launch_fwd(const void* x, const void* g, const void* b, void* y,
               float* mean, float* rstd, int rows, int n, float eps,
               int layout, int vec_bytes, int ept, int warps, int per_block,
               int blocks, cudaStream_t stream) {
  const int threads = check_plan(sizeof(T), n, layout, vec_bytes, ept, warps,
                                 per_block);
  FwdFn<T> fn = pick<T, FwdFn<T>, PickFwd>(layout, vec_bytes / sizeof(T),
                                           ept);
  if (!threads || !fn || rows < 0 ||
      blocks != (rows + per_block - 1) / per_block ||
      !aligned_to(vec_bytes, {x, g, b, y})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  fn<<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, rows, n, warps,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, const float* mean,
               const float* rstd, const void* dy, void* dx, float* dg_part,
               float* db_part, void* dg, void* db, int rows, int n,
               int layout, int vec_bytes, int ept, int warps, int per_block,
               int blocks, cudaStream_t stream) {
  const int threads = check_plan(sizeof(T), n, layout, vec_bytes, ept, warps,
                                 per_block);
  BwdFn<T> fn = pick<T, BwdFn<T>, PickBwd>(layout, vec_bytes / sizeof(T),
                                           ept);
  const int smem = bwd_smem(layout, per_block, n);
  if (!threads || !fn || rows < 1 || blocks < 1 ||
      (long long)blocks * per_block > rows || smem > kMaxSmemBytes ||
      !aligned_to(vec_bytes, {x, g, dy, dx})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), dg_part, db_part, rows,
      n, warps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<T><<<(n + 31) / 32, 1024, 0, stream>>>(
      dg_part, db_part, static_cast<T*>(dg), static_cast<T*>(db), blocks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  x, y: (rows, n) contiguous, n >= 1;
// gamma, beta: (n,) in x's dtype; mean, rstd: (rows,) float32.  The plan
// (`_plan_fwd`): layout 0 a warp a row, 1 `warps` warps a row, 2 wide (n >
// 8192, one 256-thread block a row); vec_bytes the vector width, dividing
// n * itemsize and the alignment of x, y, gamma and beta; ept the
// elements a thread holds (layouts 0 and 1: 8, 16, 24 or 32, with 32 *
// warps * ept >= n); per_block rows a block, blocks = ceil(rows /
// per_block).  A plan the kernels do not take returns
// cudaErrorInvalidValue before any launch.
int mxt_layer_norm_fwd(int dtype, const void* x, const void* gamma,
                       const void* beta, void* y, float* mean, float* rstd,
                       int rows, int n, float eps, int layout, int vec_bytes,
                       int ept, int warps, int per_block, int blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_fwd<float>(x, gamma, beta, y, mean, rstd, rows, n, eps,
                             layout, vec_bytes, ept, warps, per_block, blocks,
                             s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows, n,
                                     eps, layout, vec_bytes, ept, warps,
                                     per_block, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16.  x, dy, dx: (rows, n) contiguous in
// dtype, rows >= 1; gamma, dgamma, dbeta: (n,) in dtype; mean, rstd:
// (rows,) float32; dg_part, db_part: (blocks, n) float32 scratch.  The
// plan (`_plan_bwd`) as the forward's, with vec_bytes also dividing the
// alignment of dy and dx, per_block the teams (rows at a time) a block
// (1 for layout 2) and blocks persistent blocks, blocks * per_block <=
// rows, each team over a contiguous share of the rows.  Launches the row
// kernel and the reduction of the blocks' partial rows on the stream.
int mxt_layer_norm_bwd(int dtype, const void* x, const void* gamma,
                       const float* mean, const float* rstd, const void* dy,
                       void* dx, float* dg_part, float* db_part, void* dgamma,
                       void* dbeta, int rows, int n, int layout, int vec_bytes,
                       int ept, int warps, int per_block, int blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_bwd<float>(x, gamma, mean, rstd, dy, dx, dg_part, db_part,
                             dgamma, dbeta, rows, n, layout, vec_bytes, ept,
                             warps, per_block, blocks, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dg_part,
                                     db_part, dgamma, dbeta, rows, n, layout,
                                     vec_bytes, ept, warps, per_block, blocks,
                                     s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the backward row kernel of this plan that fit on one SM at
// once (the occupancy query, with its dynamic shared memory), written to
// *out.
int mxt_layer_norm_bwd_occupancy(int dtype, int n, int layout, int vec_bytes,
                                 int ept, int warps, int per_block, int* out) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int threads =
      n < 1 || (dtype != 0 && dtype != 1)
          ? 0
          : check_plan(itemsize, n, layout, vec_bytes, ept, warps, per_block);
  const void* fn =
      dtype == 0 ? reinterpret_cast<const void*>(pick<float, BwdFn<float>,
                                                      PickBwd>(
                       layout, vec_bytes / itemsize, ept))
                 : reinterpret_cast<const void*>(
                       pick<__nv_bfloat16, BwdFn<__nv_bfloat16>, PickBwd>(
                           layout, vec_bytes / itemsize, ept));
  const int smem = bwd_smem(layout, per_block, n);
  if (!threads || !fn || smem > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, smem));
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
