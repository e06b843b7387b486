// Flash-attention forward and backward on Hopper.
//
// FORWARD.
// Replaces mxnet_tpu/ops/pallas_kernels/flash_attention.py
// `_flash_fwd_pallas` / `_fwd_kernel` and, through strides,
// `_flash_fwd_pallas_bsd`: softmax(scale * Q K^T) V over (B, H, S, D)
// operands (a (B, S, E) tensor is read as the (B, H, S, D) view of its
// heads) with the online-softmax recurrence (m, l, acc)
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

// BACKWARD, float32.  In bfloat16 the backward runs on the tensor cores,
// in flash_attention_bwd.cu.  Replaces `_flash_bwd_pallas`
// (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) and, through strides,
// `_flash_bwd_pallas_bsd`: two kernels, as the TPU has.  Both recompute
// p = exp(s - lse) from the forward's lse, masked to an exact 0, and read
// delta_i = sum_d dO_id O_id - glse_i (computed by the caller; the lse
// cotangent folds in there).  With ds = p * (dO V^T - delta):
//   dq kernel:    dq = scale * ds K, one block per (batch, head, 64-query
//                 tile), looping over 64-key tiles up to the causal
//                 diagonal, as the forward;
//   dk/dv kernel: dv = p^T dO and dk = scale * ds^T Q, one block per
//                 (batch, head, 64-key tile), looping over 64-query tiles
//                 from the first one whose last query reaches the tile's
//                 first key (computed from the offsets).
// Operands are staged to shared memory as float32 and every sum is
// float32.
// Ragged tails are masked, not padded; every operand is read and written
// through its batch/head/sequence strides.
//
// Bound on the H100: operations.  The TPU cost estimates count 6 + 8 =
// 14 * B * H * Sq * Skv * D flops for the two passes (half of it under
// causal masking) against a few reads of Q, K, V, dO.  Like the forward,
// these first kernels compute in float32 on the CUDA cores (no mma, no
// wgmma, no TMA), so they reach neither bound.  The dk/dv block holds
// its K and V tiles plus the Q, dO, P^T and dS^T tiles in shared memory
// (166 KB at D = 128, one block per SM; 100 KB at D = 64) and its dK and
// dV rows in registers (2 * D / 4 floats a thread).

// THE dS ORIENTATION (layout 1).  Replaces `_flash_fwd_pallas_ds`
// (`_fwd_kernel_ds`) and `_flash_bwd_pallas_ds` (`_bwd_dq_kernel_ds`,
// `_bwd_dkv_kernel_ds`): the same recurrence and the same two backward
// passes over operands shaped (B, H, D, S), the sequence axis
// contiguous.  On the TPU that orientation exists for the tile layout:
// a (.., S, 64) bf16 operand pads every (8, 128) tile 2x, a (.., 64, S)
// one tiles exactly, so the dS kernels hold the saved residuals and the
// boundary copies at half the memory; their scores stay (block_q,
// block_k) and only the operands' orientation changes.  Here no tile
// pads, and every kernel stages its operand tiles into float shared
// memory before any arithmetic, so only the staging changes: in layout
// 1 a (64, D) tile is read along S (consecutive threads take consecutive
// positions of one column, coalesced) and written transposed into the
// same padded (row, D + 1) shared tile as layout 0 fills; outputs (out,
// dq, dk, dv) are staged back through a shared tile and stored along S.
// The score, softmax and accumulate loops are those of layout 0.  In
// layout 1 the forward's V tile is padded too (pitch D + 1), since its
// columns are then written along its rows.  The third stride given for
// each operand is that of the axis that is not contiguous: the sequence
// axis in layout 0, the head_dim axis in layout 1.
//
// Sizes: every element offset is computed in 64 bits (the batch, head
// and third strides are long long; positions and offsets widen before
// they multiply), so a (4, 8192, 768) bsd operand, or any tensor past
// 2**31 elements, indexes right.  The grid is (ceil(S / 64), H, B) with
// H and B at most 65535 (checked); lse and delta rows are addressed as
// ((b * H + h) * Sq + i) in 64 bits.

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

// Offset of element (row i, column d) of an operand: in layout 0 (SC
// false) st is the row (sequence) stride and columns are contiguous; in
// layout 1 (SC true) rows are contiguous and st is the column stride.
template <bool SC>
__device__ __forceinline__ long long at(long long i, int d, long long st) {
  return SC ? i + d * st : i * st + d;
}

// The (row, column) of the idx-th element of a cooperative load of a
// (ROWS, D) tile: column fastest in layout 0, row fastest (along S) in
// layout 1, so that a warp reads consecutive addresses in both.
template <bool SC, int ROWS, int D>
__device__ __forceinline__ void tile_pos(int idx, int& i, int& d) {
  if (SC) {
    i = idx % ROWS;
    d = idx / ROWS;
  } else {
    i = idx / D;
    d = idx % D;
  }
}

// Layout 1's store: a (ROWS, D) float tile staged in shared memory with
// pitch D + 1 goes to rows row0 .. row0 + ROWS - 1 of dst (those below
// nrows), along S.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void store_tile_sc(T* dst, const float* tile,
                                              int row0, int nrows,
                                              long long st) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int i = idx % ROWS, d = idx / ROWS;
    if (row0 + i < nrows) {
      dst[at<true>(row0 + i, d, st)] = from_float<T>(tile[i * (D + 1) + d]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int heads, sq, skv, q_off, k_off, causal;
  float scale;
};

// the V tile's row pitch: padded in layout 1, whose loads write its
// columns along its rows
template <int D, bool SC>
__host__ __device__ constexpr int v_pitch() {
  return SC ? D + 1 : D;
}

template <int D, bool SC>
constexpr int smem_floats() {
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * v_pitch<D, SC>() +
         kBlockQ * (kBlockK + 1);
}

template <typename T, int D, bool SC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int VP = v_pitch<D, SC>();
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x (D + 1)
  float* ks = qs + kBlockQ * (D + 1);        // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);        // kBlockK x VP
  float* ps = vs + kBlockK * VP;             // kBlockQ x (kBlockK + 1)

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
    int i, d;
    tile_pos<SC, kBlockQ, D>(idx, i, d);
    const int qi = q0 + i;
    qs[i * (D + 1) + d] =
        qi < a.sq ? to_float(q[at<SC>(qi, d, a.q_st)]) * a.scale : 0.f;
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
      int j, d;
      tile_pos<SC, kBlockK, D>(idx, j, d);
      const int kj = k0 + j;
      const bool in = kj < a.skv;
      ks[j * (D + 1) + d] = in ? to_float(k[at<SC>(kj, d, a.k_st)]) : 0.f;
      vs[j * VP + d] = in ? to_float(v[at<SC>(kj, d, a.v_st)]) : 0.f;
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
      const float* vrow = vs + j * VP + sub;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) acc[c] += p * vrow[4 * c];
    }
  }

  const int qi = q0 + r;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  if constexpr (SC) {
    __syncthreads();  // every reader of qs is done
#pragma unroll
    for (int c = 0; c < D / 4; ++c) qs[r * (D + 1) + sub + 4 * c] = acc[c] * inv;
    __syncthreads();
    store_tile_sc<T, kBlockQ, D>(o, qs, q0, a.sq, a.o_st);
  } else if (qi < a.sq) {
    T* orow = o + qi * a.o_st + sub;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) orow[4 * c] = from_float<T>(acc[c] * inv);
  }
  if (qi < a.sq && a.lse != nullptr && sub == 0) {
    a.lse[((long long)b * a.heads + h) * a.sq + qi] = m + logf(l_safe);
  }
}

template <typename T, int D, bool SC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_floats<D, SC>() * (int)sizeof(float);
  // above 48 KB only by opt-in; set on every launch, as it holds for the
  // current device only
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
  flash_fwd_kernel<T, D, SC><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_layout(const Args& a, int layout, int batch, cudaStream_t s) {
  return layout ? launch<T, D, true>(a, batch, s)
                : launch<T, D, false>(a, batch, s);
}

// -- backward ---------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (batch, heads, sq) float32 contiguous
  const float* delta;  // (batch, heads, sq) float32 contiguous
  void* out0;          // dq (dq kernel) or dk (dk/dv kernel)
  void* out1;          // unused (dq kernel) or dv (dk/dv kernel)
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long d_sb, d_sh, d_st;
  long long o0_sb, o0_sh, o0_st;
  long long o1_sb, o1_sh, o1_st;
  int heads, sq, skv, q_off, k_off, causal;
  float scale;
};

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBlockQ * (D + 1) + 2 * kBlockK * (D + 1) +
         kBlockQ * (kBlockK + 1);
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kBlockK * (D + 1) + 2 * kBlockQ * (D + 1) +
         2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ;
}

template <typename T, int D, bool SC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                    // kBlockQ x (D + 1), pre-scaled
  float* dos = qs + kBlockQ * (D + 1);  // kBlockQ x (D + 1)
  float* ks = dos + kBlockQ * (D + 1);  // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);   // kBlockK x (D + 1)
  float* dss = vs + kBlockK * (D + 1);  // kBlockQ x (kBlockK + 1)

  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row of the tile this thread owns
  const int sub = tid & 3;  // its quarter of the row's keys and columns
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  T* dq = static_cast<T*>(a.out0) + b * a.o0_sb + h * a.o0_sh;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    int i, d;
    tile_pos<SC, kBlockQ, D>(idx, i, d);
    const int qi = q0 + i;
    const bool in = qi < a.sq;
    qs[i * (D + 1) + d] =
        in ? to_float(q[at<SC>(qi, d, a.q_st)]) * a.scale : 0.f;
    dos[i * (D + 1) + d] = in ? to_float(dout[at<SC>(qi, d, a.d_st)]) : 0.f;
  }

  const int qi = q0 + r;
  const long long row = ((long long)b * a.heads + h) * a.sq + qi;
  const float lse = qi < a.sq ? a.lse[row] : 0.f;
  const float delta = qi < a.sq ? a.delta[row] : 0.f;

  int nkb = (a.skv + kBlockK - 1) / kBlockK;
  if (a.causal) {
    const long long last_q = (long long)a.q_off + min(q0 + kBlockQ, a.sq) - 1;
    const long long hi = last_q - a.k_off;
    nkb = hi < 0 ? 0 : min(nkb, (int)(hi / kBlockK) + 1);
  }
  const long long qpos = (long long)a.q_off + qi;

  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // last step's readers of ks/vs/dss are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      int j, d;
      tile_pos<SC, kBlockK, D>(idx, j, d);
      const int kj = k0 + j;
      const bool in = kj < a.skv;
      ks[j * (D + 1) + d] = in ? to_float(k[at<SC>(kj, d, a.k_st)]) : 0.f;
      vs[j * (D + 1) + d] = in ? to_float(v[at<SC>(kj, d, a.v_st)]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK / 4], dp[kBlockK / 4];
#pragma unroll
    for (int jj = 0; jj < kBlockK / 4; ++jj) {
      s[jj] = 0.f;
      dp[jj] = 0.f;
    }
    const float* qrow = qs + r * (D + 1);
    const float* drow = dos + r * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d], dv = drow[d];
#pragma unroll
      for (int jj = 0; jj < kBlockK / 4; ++jj) {
        const int off = (sub + 4 * jj) * (D + 1) + d;
        s[jj] += qv * ks[off];
        dp[jj] += dv * vs[off];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBlockK / 4; ++jj) {
      const int j = sub + 4 * jj;
      const int kj = k0 + j;
      const bool ok = qi < a.sq && kj < a.skv &&
                      (!a.causal || qpos >= (long long)a.k_off + kj);
      const float p = ok ? expf(s[jj] - lse) : 0.f;
      dss[r * (kBlockK + 1) + j] = p * (dp[jj] - delta);
    }
    __syncthreads();  // the whole dS tile is written

    const float* dsrow = dss + r * (kBlockK + 1);
    for (int j = 0; j < kBlockK; ++j) {
      const float ds = dsrow[j];
      const float* krow = ks + j * (D + 1) + sub;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) acc[c] += ds * krow[4 * c];
    }
  }

  if constexpr (SC) {
    __syncthreads();  // every reader of qs is done
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      qs[r * (D + 1) + sub + 4 * c] = acc[c] * a.scale;
    }
    __syncthreads();
    store_tile_sc<T, kBlockQ, D>(dq, qs, q0, a.sq, a.o0_st);
  } else if (qi < a.sq) {
    T* row_out = dq + qi * a.o0_st + sub;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      row_out[4 * c] = from_float<T>(acc[c] * a.scale);
    }
  }
}

template <typename T, int D, bool SC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;                          // kBlockK x (D + 1)
  float* vs = ks + kBlockK * (D + 1);        // kBlockK x (D + 1)
  float* qs = vs + kBlockK * (D + 1);        // kBlockQ x (D + 1), scaled
  float* dos = qs + kBlockQ * (D + 1);       // kBlockQ x (D + 1)
  float* pts = dos + kBlockQ * (D + 1);      // kBlockK x (kBlockQ + 1)
  float* dsts = pts + kBlockK * (kBlockQ + 1);  // kBlockK x (kBlockQ + 1)
  float* lses = dsts + kBlockK * (kBlockQ + 1);  // kBlockQ
  float* deltas = lses + kBlockQ;                 // kBlockQ

  const int tid = threadIdx.x;
  const int j = tid >> 2;   // key row of the tile this thread owns
  const int sub = tid & 3;  // its quarter of the tile's queries and columns
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  T* dk = static_cast<T*>(a.out0) + b * a.o0_sb + h * a.o0_sh;
  T* dv = static_cast<T*>(a.out1) + b * a.o1_sb + h * a.o1_sh;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.sq;

  for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
    int jj, d;
    tile_pos<SC, kBlockK, D>(idx, jj, d);
    const int kj = k0 + jj;
    const bool in = kj < a.skv;
    ks[jj * (D + 1) + d] = in ? to_float(k[at<SC>(kj, d, a.k_st)]) : 0.f;
    vs[jj * (D + 1) + d] = in ? to_float(v[at<SC>(kj, d, a.v_st)]) : 0.f;
  }

  const int nqb = (a.sq + kBlockQ - 1) / kBlockQ;
  int lo = 0;
  if (a.causal) {
    // query tile qb reaches this key tile iff its last query position
    // q_off + qb * kBlockQ + kBlockQ - 1 >= k_off + k0
    const long long need =
        (long long)a.k_off + k0 - a.q_off - (kBlockQ - 1);
    lo = need <= 0 ? 0
                   : (int)min((long long)nqb, (need + kBlockQ - 1) / kBlockQ);
  }
  const int kj = k0 + j;
  const long long kpos = (long long)a.k_off + kj;

  float dka[D / 4], dva[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  for (int qb = lo; qb < nqb; ++qb) {
    const int q0 = qb * kBlockQ;
    __syncthreads();  // last step's readers of qs/dos/lses/deltas are done
    for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
      int i, d;
      tile_pos<SC, kBlockQ, D>(idx, i, d);
      const int qi = q0 + i;
      const bool in = qi < a.sq;
      qs[i * (D + 1) + d] =
          in ? to_float(q[at<SC>(qi, d, a.q_st)]) * a.scale : 0.f;
      dos[i * (D + 1) + d] = in ? to_float(dout[at<SC>(qi, d, a.d_st)]) : 0.f;
    }
    if (tid < kBlockQ) {
      const int qi = q0 + tid;
      lses[tid] = qi < a.sq ? lse[qi] : 0.f;
      deltas[tid] = qi < a.sq ? delta[qi] : 0.f;
    }
    __syncthreads();

    float s[kBlockQ / 4], dp[kBlockQ / 4];
#pragma unroll
    for (int ii = 0; ii < kBlockQ / 4; ++ii) {
      s[ii] = 0.f;
      dp[ii] = 0.f;
    }
    const float* krow = ks + j * (D + 1);
    const float* vrow = vs + j * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int ii = 0; ii < kBlockQ / 4; ++ii) {
        const int off = (sub + 4 * ii) * (D + 1) + d;
        s[ii] += qs[off] * kv;
        dp[ii] += dos[off] * vv;
      }
    }
#pragma unroll
    for (int ii = 0; ii < kBlockQ / 4; ++ii) {
      const int i = sub + 4 * ii;
      const int qi = q0 + i;
      const bool ok = qi < a.sq && kj < a.skv &&
                      (!a.causal || (long long)a.q_off + qi >= kpos);
      const float p = ok ? expf(s[ii] - lses[i]) : 0.f;
      pts[j * (kBlockQ + 1) + i] = p;
      dsts[j * (kBlockQ + 1) + i] = p * (dp[ii] - deltas[i]);
    }
    // row j of P^T and dS^T was written by this thread's own group of 4
    // lanes
    __syncwarp();

    const float* prow = pts + j * (kBlockQ + 1);
    const float* dsrow = dsts + j * (kBlockQ + 1);
    for (int i = 0; i < kBlockQ; ++i) {
      const float p = prow[i], ds = dsrow[i];
      const float* dorow = dos + i * (D + 1) + sub;
      const float* qrow = qs + i * (D + 1) + sub;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        dva[c] += p * dorow[4 * c];
        dka[c] += ds * qrow[4 * c];
      }
    }
  }

  if constexpr (SC) {
    __syncthreads();  // every reader of ks and vs is done
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      ks[j * (D + 1) + sub + 4 * c] = dka[c];
      vs[j * (D + 1) + sub + 4 * c] = dva[c];
    }
    __syncthreads();
    store_tile_sc<T, kBlockK, D>(dk, ks, k0, a.skv, a.o0_st);
    store_tile_sc<T, kBlockK, D>(dv, vs, k0, a.skv, a.o1_st);
  } else if (kj < a.skv) {
    T* dkrow = dk + kj * a.o0_st + sub;
    T* dvrow = dv + kj * a.o1_st + sub;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      dkrow[4 * c] = from_float<T>(dka[c]);
      dvrow[4 * c] = from_float<T>(dva[c]);
    }
  }
}

template <typename T, int D, bool DKV, bool SC>
int launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  const int bytes =
      (DKV ? dkv_smem_floats<D>() : dq_smem_floats<D>()) * (int)sizeof(float);
  auto kernel =
      DKV ? flash_bwd_dkv_kernel<T, D, SC> : flash_bwd_dq_kernel<T, D, SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int len = DKV ? a.skv : a.sq;
  const int tile = DKV ? kBlockK : kBlockQ;
  dim3 grid((len + tile - 1) / tile, a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool DKV>
int bwd_layout(int layout, const BwdArgs& a, int batch, cudaStream_t s) {
  return layout ? launch_bwd<T, D, DKV, true>(a, batch, s)
                : launch_bwd<T, D, DKV, false>(a, batch, s);
}

template <bool DKV>
int bwd_entry(int head_dim, int layout, const BwdArgs& a, int batch,
              cudaStream_t s) {
  return head_dim == 64 ? bwd_layout<float, 64, DKV>(layout, a, batch, s)
                        : bwd_layout<float, 128, DKV>(layout, a, batch, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  head_dim: 64 or 128.  layout 0: operands
// (batch, heads, seq, head_dim), the head_dim axis contiguous, strides
// given in elements for the batch, head and sequence axes; layout 1 (the
// dS layout): operands (batch, heads, head_dim, seq), the sequence axis
// contiguous, strides given for the batch, head and head_dim axes.  lse
// may be null; otherwise it is (batch, heads, sq) float32 contiguous.
int mxt_flash_attention_fwd(int dtype, int head_dim, int layout,
                            const void* q,
                            const void* k, const void* v, void* o, float* lse,
                            int batch, int heads, int sq, int skv,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long o_sb, long long o_sh, long long o_st,
                            int q_off, int k_off, int causal, float scale,
                            void* stream) {
  if ((head_dim != 64 && head_dim != 128) || dtype < 0 || dtype > 1 ||
      (layout != 0 && layout != 1) || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  Args a{q,    k,    v,    o,    lse,  q_sb, q_sh,  q_st,  k_sb,  k_sh,
         k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st,  heads, sq,    skv,
         q_off, k_off, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return head_dim == 64 ? launch_layout<float, 64>(a, layout, batch, s)
                          : launch_layout<float, 128>(a, layout, batch, s);
  }
  return head_dim == 64
             ? launch_layout<__nv_bfloat16, 64>(a, layout, batch, s)
             : launch_layout<__nv_bfloat16, 128>(a, layout, batch, s);
}

// The two backward passes in float32 (dtype must be 0; bf16 has
// flash_attention_bwd.cu's entry).  head_dim, layout and strides as the
// forward; dout is the cotangent of out; lse and delta are (batch, heads,
// sq) float32 contiguous.  which = 0 launches the dq kernel (out0 = dq, out1
// unused), which = 1 the dk/dv kernel (out0 = dk, out1 = dv).  Strides
// are given for q, k, v, dout, out0 and out1.
int mxt_flash_attention_bwd(int which, int dtype, int head_dim, int layout,
                            const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* out0, void* out1,
                            int batch, int heads, int sq, int skv,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long d_sb, long long d_sh, long long d_st,
                            long long o0_sb, long long o0_sh, long long o0_st,
                            long long o1_sb, long long o1_sh, long long o1_st,
                            int q_off, int k_off, int causal, float scale,
                            void* stream) {
  if ((which != 0 && which != 1) || (head_dim != 64 && head_dim != 128) ||
      (layout != 0 && layout != 1) || dtype != 0 || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535 ||
      (which == 1 && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int len = which == 0 ? sq : skv;
  if (batch == 0 || heads == 0 || len == 0) return 0;
  BwdArgs a{q,     k,     v,     dout,  lse,   delta, out0,  out1,
            q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,  v_sb,  v_sh,
            v_st,  d_sb,  d_sh,  d_st,  o0_sb, o0_sh, o0_st, o1_sb,
            o1_sh, o1_st, heads, sq,    skv,   q_off, k_off, causal,
            scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return which == 0 ? bwd_entry<false>(head_dim, layout, a, batch, s)
                    : bwd_entry<true>(head_dim, layout, a, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
