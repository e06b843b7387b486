// Flash-attention forward in float32 on Hopper.  In bfloat16 the forward
// runs on the tensor cores, in flash_attention_fwd.cu; the backward runs on
// the tensor cores in both dtypes, in flash_attention_bwd.cu (bf16) and
// flash_attention_bwd_f32.cu (float32, through 3xTF32).
//
// Replaces mxnet_tpu/ops/pallas_kernels/flash_attention.py
// `_flash_fwd_pallas` / `_fwd_kernel` and, through strides,
// `_flash_fwd_pallas_bsd`: softmax(scale * Q K^T) V over (B, H, S, D)
// operands (a (B, S, E) tensor is read as the (B, H, S, D) view of its
// heads) with the online-softmax recurrence (m, l, acc)
// in float32, so the S x S score matrix never reaches device memory.
// Under causal masking query i (global position q_off + i) sees key j
// (global position k_off + j) iff q_off + i >= k_off + j, and each
// query tile's K loop stops at the diagonal computed from the offsets.
// It writes out and, when asked, lse = m + log(l) (B, H, Sq) float32.
// A row that sees no key gets out = 0 and lse = -1e30 + log 1, never
// NaN: masked scores contribute an exact 0 to l and acc.
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

// THE dS ORIENTATION (layout 1).  Replaces `_flash_fwd_pallas_ds`
// (`_fwd_kernel_ds`): the same recurrence over operands shaped (B, H, D,
// S), the sequence axis contiguous.  On the TPU that orientation exists
// for the tile layout: a (.., S, 64) bf16 operand pads every (8, 128)
// tile 2x, a (.., 64, S) one tiles exactly, so the dS kernels hold the
// saved residuals and the boundary copies at half the memory; their
// scores stay (block_q, block_k) and only the operands' orientation
// changes.  Here no tile pads, and the kernel stages its operand tiles
// into float shared memory before any arithmetic, so only the staging
// changes: in layout 1 a (64, D) tile is read along S (consecutive
// threads take consecutive positions of one column, coalesced) and
// written transposed into the same padded (row, D + 1) shared tile as
// layout 0 fills; out is staged back through a shared tile and stored
// along S.  The score, softmax and accumulate loops are those of layout
// 0.  In layout 1 the V tile is padded too (pitch D + 1), since its
// columns are then written along its rows.  The third stride given for
// each operand is that of the axis that is not contiguous: the sequence
// axis in layout 0, the head_dim axis in layout 1.
//
// Sizes: every element offset is computed in 64 bits (the batch, head
// and third strides are long long; positions and offsets widen before
// they multiply), so a (4, 8192, 768) bsd operand, or any tensor past
// 2**31 elements, indexes right.  The grid is (ceil(S / 64), H, B) with
// H and B at most 65535 (checked); lse rows are addressed as
// ((b * H + h) * Sq + i) in 64 bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

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
template <int ROWS, int D>
__device__ __forceinline__ void store_tile_sc(float* dst, const float* tile,
                                              int row0, int nrows,
                                              long long st) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int i = idx % ROWS, d = idx / ROWS;
    if (row0 + i < nrows) {
      dst[at<true>(row0 + i, d, st)] = tile[i * (D + 1) + d];
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

template <int D, bool SC>
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

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    int i, d;
    tile_pos<SC, kBlockQ, D>(idx, i, d);
    const int qi = q0 + i;
    qs[i * (D + 1) + d] =
        qi < a.sq ? q[at<SC>(qi, d, a.q_st)] * a.scale : 0.f;
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
      ks[j * (D + 1) + d] = in ? k[at<SC>(kj, d, a.k_st)] : 0.f;
      vs[j * VP + d] = in ? v[at<SC>(kj, d, a.v_st)] : 0.f;
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
    store_tile_sc<kBlockQ, D>(o, qs, q0, a.sq, a.o_st);
  } else if (qi < a.sq) {
    float* orow = o + qi * a.o_st + sub;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) orow[4 * c] = acc[c] * inv;
  }
  if (qi < a.sq && a.lse != nullptr && sub == 0) {
    a.lse[((long long)b * a.heads + h) * a.sq + qi] = m + logf(l_safe);
  }
}

template <int D, bool SC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_floats<D, SC>() * (int)sizeof(float);
  // above 48 KB only by opt-in; set on every launch, as it holds for the
  // current device only
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.heads, batch);
  flash_fwd_kernel<D, SC><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_layout(const Args& a, int layout, int batch, cudaStream_t s) {
  return layout ? launch<D, true>(a, batch, s)
                : launch<D, false>(a, batch, s);
}

}  // namespace

extern "C" {

// The forward in float32 (dtype must be 0; bf16 has
// flash_attention_fwd.cu's entry).  head_dim: 64 or 128.  layout 0: operands
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
  if ((head_dim != 64 && head_dim != 128) || dtype != 0 ||
      (layout != 0 && layout != 1) || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  Args a{q,    k,    v,    o,    lse,  q_sb, q_sh,  q_st,  k_sb,  k_sh,
         k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st,  heads, sq,    skv,
         q_off, k_off, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch_layout<64>(a, layout, batch, s)
                        : launch_layout<128>(a, layout, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
