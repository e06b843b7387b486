// Flash-attention forward on Hopper.
//
// Replaces mxnet_tpu/ops/pallas_kernels/flash_attention.py
// `_flash_fwd_pallas` / `_fwd_kernel`: softmax(scale * Q K^T) V over
// (B, H, S, D) operands with the online-softmax recurrence (m, l, acc)
// in float32, so the S x S score matrix never reaches device memory.
// Under causal masking query i (global position q_off + i) sees key j
// (global position k_off + j) iff q_off + i >= k_off + j, and each
// query tile's K loop stops at the diagonal computed from the offsets.
// It writes out in q's dtype and, when asked, lse = m + log(l) (B, H, Sq)
// float32.  A row that sees no key gets out = 0 and lse = -1e30 + log 1,
// never NaN: masked scores contribute an exact 0 to l and acc.
//
// Bound on the H100: at the serving prefill's head_dim 64 the work is
// 4 * D flops per visible (query, key) pair against 2 * D * itemsize
// bytes per row of Q, K, V and out, so a long causal prefill is bound by
// operations and a short one by bytes.  This first kernel computes in
// float32 on the CUDA cores (no wgmma, no TMA, no pipelining), so it
// reaches neither bound; `chip_smoke.py` prints its time beside both.
//
// Design: one block of 256 threads per (batch, head, 64-query tile).
// The Q tile is staged once into shared memory, pre-scaled; K and V
// tiles of 64 keys are staged per loop step.  Thread t owns query row
// t / 4 and, with its three neighbours in the warp, splits that row's 64
// scores (16 each, kept in registers) and its D outputs (D / 4 each),
// so the row max and row sum are two shuffles.  P goes through shared
// memory for the P V product.  Rows are padded by one float against bank
// conflicts.  Ragged tails are masked, not padded: keys past Skv load
// as zeros with a masked score, queries past Sq are not stored.  Q, K,
// V and out are read and written through their batch/head/sequence
// strides (the last axis must be contiguous), so the serving prefill's
// (b, s, h, d) -> (b, h, s, d) transpose costs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, sq, skv, q_off, k_off, causal;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
         kBlockQ * (kBlockK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x (D + 1)
  float* ks = qs + kBlockQ * (D + 1);        // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);        // kBlockK x D
  float* ps = vs + kBlockK * D;              // kBlockQ x (kBlockK + 1)

  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row of the tile this thread owns
  const int sub = tid & 3;  // its quarter of the row's scores and outputs
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int qi = q0 + i;
    qs[i * (D + 1) + d] =
        qi < a.sq ? to_float(q[qi * a.q_ss + d]) * a.scale : 0.f;
  }

  int nkb = (a.skv + kBlockK - 1) / kBlockK;
  if (a.causal) {
    // keys past the tile's last query position contribute nothing
    const long long last_q = (long long)a.q_off + min(q0 + kBlockQ, a.sq) - 1;
    const long long hi = last_q - a.k_off;
    nkb = hi < 0 ? 0 : min(nkb, (int)(hi / kBlockK) + 1);
  }

  const long long qpos = (long long)a.q_off + q0 + r;
  float m = kNegInf, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // last step's readers of ks/vs/ps are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int kj = k0 + j;
      const bool in = kj < a.skv;
      ks[j * (D + 1) + d] = in ? to_float(k[kj * a.k_ss + d]) : 0.f;
      vs[j * D + d] = in ? to_float(v[kj * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK / 4];
#pragma unroll
    for (int jj = 0; jj < kBlockK / 4; ++jj) s[jj] = 0.f;
    const float* qrow = qs + r * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < kBlockK / 4; ++jj) {
        s[jj] += qv * ks[(sub + 4 * jj) * (D + 1) + d];
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBlockK / 4; ++jj) {
      const int kj = k0 + sub + 4 * jj;
      const bool ok = kj < a.skv && (!a.causal || qpos >= (long long)a.k_off + kj);
      s[jj] = ok ? s[jj] : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBlockK / 4; ++jj) {
      const int j = sub + 4 * jj;
      const int kj = k0 + j;
      const bool ok = kj < a.skv && (!a.causal || qpos >= (long long)a.k_off + kj);
      const float p = ok ? expf(s[jj] - m_new) : 0.f;
      ps[r * (kBlockK + 1) + j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncthreads();  // the whole P tile is written

    const float* prow = ps + r * (kBlockK + 1);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) acc[c] *= corr;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * D + sub;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) acc[c] += p * vrow[4 * c];
    }
  }

  const int qi = q0 + r;
  if (qi < a.sq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    T* orow = o + qi * a.o_ss + sub;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) orow[4 * c] = from_float<T>(acc[c] * inv);
    if (a.lse != nullptr && sub == 0) {
      a.lse[((long long)b * a.heads + h) * a.sq + qi] = m + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  // above 48 KB only by opt-in; set on every launch, as it holds for the
  // current device only
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  head_dim: 64 or 128.  Strides are in
// elements for the batch, head and sequence axes; the head_dim axis is
// contiguous.  lse may be null; otherwise it is (batch, heads, sq)
// float32 contiguous.
int mxt_flash_attention_fwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, void* o, float* lse,
                            int batch, int heads, int sq, int skv,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            int q_off, int k_off, int causal, float scale,
                            void* stream) {
  if ((head_dim != 64 && head_dim != 128) || dtype < 0 || dtype > 1 ||
      batch < 0 || heads < 0 || sq < 0 || skv < 0 || batch > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  Args a{q,    k,    v,    o,    lse,  q_sb, q_sh,  q_ss,  k_sb,  k_sh,
         k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,  heads, sq,    skv,
         q_off, k_off, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return head_dim == 64 ? launch<float, 64>(a, batch, s)
                          : launch<float, 128>(a, batch, s);
  }
  return head_dim == 64 ? launch<__nv_bfloat16, 64>(a, batch, s)
                        : launch<__nv_bfloat16, 128>(a, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
