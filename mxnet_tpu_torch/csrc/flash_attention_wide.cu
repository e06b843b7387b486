// Flash attention at head widths above 256, in bfloat16, on Hopper's
// tensor cores: the forward and the two backward passes.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in bf16 at head_dim > 256, where the JAX package's residency model
// (`_stream_residency_fits` :40-71) still sends short sequences to Pallas:
// `_fwd_kernel` :98 (`_flash_fwd_pallas` :155), `_bwd_dq_kernel` :268 and
// `_bwd_dkv_kernel` :316 (`_flash_bwd_pallas` :372), and, through the same
// strides as flash_attention_fwd.cu and flash_attention_bwd.cu, their dS,
// bsd and grid-streamed bsd forms.  The arithmetic is those two sources':
//   forward:  s = scale Q K^T (float32 sum), the online softmax with p
//             rounded to bf16 as P V's operand, out = acc / l in bf16,
//             lse = m + log l;
//   backward: p = exp(scale Q K^T - lse), ds = p (dO V^T - delta) scale,
//             p and ds rounded to bf16 before dV += p^T dO, dK += ds^T Q
//             and dQ += ds K, every sum in float32.
// A row that sees no key gets out 0, lse -1e30 and zero gradients.
//
// Bound on the H100: operations, 4 D (forward) and 10 D (backward) flops a
// visible pair.  Design, which costs more than that: the head is cut into
// column blocks of 128, one block of the grid per (batch, head, 64-row
// tile, column block), so every accumulator a thread holds is 128 columns
// wide (64 floats a thread), whatever D is.  D is a runtime argument (a
// multiple of 128, the wrapper zero-pads to it).  The score products S = Q
// K^T and dP = dO V^T contract over all of D, so each block sums them over
// chunks of 64 columns streamed through a two-stage cp.async ring of
// 128-byte-swizzled shared tiles (Q and K at D = 512 no longer fit beside
// each other); S (and dP) are therefore recomputed once per column block,
// D / 128 times the score products of one pass (4x at D = 512), and Q (dO;
// K and V in the dk/dv pass) is read again for every key (query) step,
// from L2 where it stays resident.  The 64 x 128 tile of the
// block's own columns (V in the forward, K in the dq pass, Q and dO in the
// dk/dv pass) is staged once per key (query) step beside the ring.
//   forward:    a block per 64 queries streams 64-key tiles up to the
//               causal diagonal: per key tile, D / 64 chunks of Q and K
//               into S (m64n64k16, both from shared memory), then the
//               softmax and O += P V over the block's 128 columns of V,
//               p the register A operand.  Shared memory 64 KB.
//   dq pass:    a block per 64 queries; per 64-key tile, D / 64 chunks of
//               Q, dO, K and V into S and dP, then ds and dQ += ds K over
//               the block's 128 columns of K.  Shared memory 96 KB.
//   dk/dv pass: a block per 64 keys; query steps of 32 from the first that
//               reaches the key tile: D / 64 chunks of K, V, Q and dO into
//               S^T and dP^T (m64n32k16), then dV += p^T dO and dK += ds^T
//               Q over the block's 128 columns of dO and Q.  Shared memory
//               128.5 KB.  dK and dV beside S^T and dP^T are the registers
//               of the head-256 dk/dv kernel (flash_attention_bwd.cu).
// Both layouts read each operand K-major or MN-major as it lies (layout 0
// (B, H, S, D); layout 1 the dS orientation (B, H, D, S)).  No atomics:
// two launches give the same bits.  The column blocks of one row tile add
// nothing into a shared sum; they make the same m and l, and the first
// writes lse.
//
// Requirements, checked by the C entries (the wrapper copies an operand
// that lacks them): every operand 16-byte aligned, its contiguous axis of
// stride 1 and its other strides multiples of 8 elements.  Positions past
// the end are zero-filled, never read; offsets are 64-bit.

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kChunk = 64;  // columns of a streamed chunk of the scores' operands
constexpr int kCols = 128;  // output columns a block computes
constexpr int kStep = 32;   // queries a step of the dk/dv pass

using TC = Tile<kChunk, false>;  // bytes of a chunk tile (either layout)
using TO = Tile<kCols, false>;   // bytes of a column-block tile

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (batch, heads, sq) float32 contiguous, or null
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int heads, sq, skv, q_off, k_off, causal;
  int diag;  // q_off - k_off, clamped to +-2**30: key j is visible to
             // query i iff j <= i + diag
  float scale;
  int d;     // head width, a multiple of kCols
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (batch, heads, sq) float32 contiguous
  const float* delta;  // (batch, heads, sq) float32 contiguous
  bf16* out0;          // dq (dq pass) or dk (dk/dv pass)
  bf16* out1;          // unused (dq pass) or dv (dk/dv pass)
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long d_sb, d_sh, d_st;
  long long o0_sb, o0_sh, o0_st;
  long long o1_sb, o1_sh, o1_st;
  int heads, sq, skv, q_off, k_off, causal;
  int diag;
  float scale;
  int d;
};

// key tiles of 64 that query rows q0 .. q0 + 63 see: up to the causal
// diagonal of the last of them
__device__ __forceinline__ int key_tiles(int q0, int sq, int skv, int q_off,
                                         int k_off, int causal) {
  int nkb = (skv + kTile - 1) / kTile;
  if (causal) {
    const long long last_q = (long long)q_off + min(q0 + kTile, sq) - 1;
    const long long hi = last_q - k_off;
    nkb = hi < 0 ? 0 : (int)min((long long)nkb, hi / kTile + 1);
  }
  return nkb;
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
}

// x += A B^T over one chunk: A's and B's 64-position chunk tiles, kChunk
// columns, m64nN
template <int N, bool SC>
__device__ __forceinline__ void chunk_mma(float (&x)[N / 8][4], uint32_t at,
                                          uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    wgmma_ss<N, SC, SC>(x, desc_pos<kChunk, SC>(at, 0, kk * 16),
                        desc_pos<kChunk, SC>(bt, 0, kk * 16));
  }
}

template <bool SC>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_wide_kernel(FwdArgs a) {
  unsigned char* base = smem_base();
  // the ring: stage i holds a Q chunk and a K chunk; then V's block
  // columns, one stage per key tile parity
  const uint32_t ring = smem_u32(base);
  const uint32_t vt0 = ring + 4 * TC::kBytes;

  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = lane & 3;
  const int col0 = (blockIdx.x % ncb) * kCols;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / ncb - 1 - blockIdx.x / ncb) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = from_col<SC>(a.v + b * a.v_sb + h * a.v_sh, col0, a.v_st);
  bf16* out = from_col<SC>(a.o + b * a.o_sb + h * a.o_sh, col0, a.o_st);

  const int nkb = key_tiles(q0, a.sq, a.skv, a.q_off, a.k_off, a.causal);
  const int nsteps = nkb * nch;
  // step n = (key tile n / nch, chunk n % nch): the chunk of Q and K into
  // ring stage n & 1, and with chunk 0 the key tile's V columns
  auto load_step = [&](int n) {
    const int kb = n / nch, c = n % nch;
    const uint32_t st = ring + (n & 1) * 2 * TC::kBytes;
    load_tile<kChunk, SC>(st, from_col<SC>(q, c * kChunk, a.q_st), q0, a.sq,
                          a.q_st);
    load_tile<kChunk, SC>(st + TC::kBytes,
                          from_col<SC>(k, c * kChunk, a.k_st), kb * kTile,
                          a.skv, a.k_st);
    if (c == 0) {
      load_tile<kCols, SC>(vt0 + (kb & 1) * TO::kBytes, v, kb * kTile, a.skv,
                           a.v_st);
    }
    cp_async_commit();
  };
  if (nsteps > 0) load_step(0);

  // this thread's two query rows, r and r + 8: their running max (log2
  // domain) and its share of their sums
  const int r = q0 + w * 16 + (lane >> 2);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kCols / 8][4];
  zero(o);
  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;  // this warp's first query
  float s[8][4];

  for (int n = 0; n < nsteps; ++n) {
    const int kb = n / nch, c = n % nch;
    if (n + 1 < nsteps) {
      load_step(n + 1);
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t qt = ring + (n & 1) * 2 * TC::kBytes;

    // S += Q K^T over this chunk's columns
    if (c == 0) zero(s);
    hold(s);
    wgmma_fence();
    chunk_mma<64, SC>(s, qt, qt + TC::kBytes);
    wgmma_commit();
    wgmma_wait();
    hold(s);
    if (c + 1 < nch) {
      __syncthreads();  // every warp is done with this stage
      continue;
    }

    // scores in the log2 domain, masked only where a pair of the warp's
    // rows and this key tile can be hidden; the tile's row max
    const int k0 = kb * kTile;
    const bool edge = k0 + kTile > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kTile - 1 > qw + a.diag);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        float x = s[nt][e] * sl2;
        if (edge) {
          const int qi = r + 8 * hi, kj = k0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = qi < a.sq && kj < a.skv &&
                          (!a.causal || kj <= qi + a.diag);
          x = ok ? x : kNegInf;
        }
        s[nt][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      corr[hi] = exp2_ftz(m[hi] - m_new);
      m[hi] = m_new;
      l[hi] *= corr[hi];
    }
    // p, 0 where masked (a row whose every key so far is masked has m at
    // kNegInf, where exp2 of a masked score would give 1)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float x = s[nt][e];
        const float p = x == kNegInf ? 0.f : exp2_ftz(x - m[hi]);
        s[nt][e] = p;
        l[hi] += p;
      }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];

    // O += P V over the block's columns, p rounded to bf16: key steps of 16
    uint32_t pa[4][4];
    pack_a<8>(pa, s);
    const uint32_t vt = vt0 + (kb & 1) * TO::kBytes;
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs<kCols, !SC>(o, pa[j], desc_col<kCols, SC>(vt, j * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(o);
    hold(pa);
    __syncthreads();  // every warp is done with this stage and V
  }

  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = l[hi] == 0.f ? 0.f : 1.f / l[hi];
  }
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];

  cp_async_wait_all_threads<0>();
  stage_acc<kCols, SC>(base, o, w * 16, lane);
  // every column block computes the same m and l: the first writes lse
  if (a.lse != nullptr && t == 0 && col0 == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qi = r + 8 * hi;
      if (qi < a.sq) {
        a.lse[((long long)b * a.heads + h) * a.sq + qi] =
            l[hi] == 0.f ? kNegInf : m[hi] * kLn2 + logf(l[hi]);
      }
    }
  }
  __syncthreads();
  store_tile<kCols, SC>(out, base, q0, a.sq, a.o_st);
}

template <bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel(BwdArgs a) {
  unsigned char* base = smem_base();
  // the ring: stage i holds chunks of Q, dO, K and V; then K's block
  // columns, one stage per key tile parity
  const uint32_t ring = smem_u32(base);
  const uint32_t kc0 = ring + 8 * TC::kBytes;

  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % ncb) * kCols;
  const int q0 = (gridDim.x / ncb - 1 - blockIdx.x / ncb) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + h * a.v_sh;
  const bf16* dout = a.dout + b * a.d_sb + h * a.d_sh;
  const bf16* kcols = from_col<SC>(k, col0, a.k_st);
  bf16* dq_out =
      from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st);

  // this thread's two query rows: r and r + 8
  const int r = q0 + w * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = r + 8 * hi;
    const long long row = ((long long)b * a.heads + h) * a.sq + qi;
    lse2[hi] = qi < a.sq ? a.lse[row] * kLog2e : 0.f;
    dl[hi] = qi < a.sq ? a.delta[row] : 0.f;
  }

  const int nkb = key_tiles(q0, a.sq, a.skv, a.q_off, a.k_off, a.causal);
  const int nsteps = nkb * nch;
  auto load_step = [&](int n) {
    const int kb = n / nch, c = n % nch;
    const uint32_t st = ring + (n & 1) * 4 * TC::kBytes;
    load_tile<kChunk, SC>(st, from_col<SC>(q, c * kChunk, a.q_st), q0, a.sq,
                          a.q_st);
    load_tile<kChunk, SC>(st + TC::kBytes,
                          from_col<SC>(dout, c * kChunk, a.d_st), q0, a.sq,
                          a.d_st);
    load_tile<kChunk, SC>(st + 2 * TC::kBytes,
                          from_col<SC>(k, c * kChunk, a.k_st), kb * kTile,
                          a.skv, a.k_st);
    load_tile<kChunk, SC>(st + 3 * TC::kBytes,
                          from_col<SC>(v, c * kChunk, a.v_st), kb * kTile,
                          a.skv, a.v_st);
    if (c == 0) {
      load_tile<kCols, SC>(kc0 + (kb & 1) * TO::kBytes, kcols, kb * kTile,
                           a.skv, a.k_st);
    }
    cp_async_commit();
  };
  if (nsteps > 0) load_step(0);

  float dq[kCols / 8][4];
  zero(dq);
  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;
  float s[8][4], dp[8][4];

  for (int n = 0; n < nsteps; ++n) {
    const int kb = n / nch, c = n % nch;
    if (n + 1 < nsteps) {
      load_step(n + 1);
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t st = ring + (n & 1) * 4 * TC::kBytes;

    // S += Q K^T and dP += dO V^T over this chunk's columns
    if (c == 0) {
      zero(s);
      zero(dp);
    }
    hold(s);
    hold(dp);
    wgmma_fence();
    chunk_mma<64, SC>(s, st, st + 2 * TC::kBytes);
    chunk_mma<64, SC>(dp, st + TC::kBytes, st + 3 * TC::kBytes);
    wgmma_commit();
    wgmma_wait();
    hold(s);
    hold(dp);
    if (c + 1 < nch) {
      __syncthreads();
      continue;
    }

    // p and ds, into s
    const int k0 = kb * kTile;
    const bool edge = k0 + kTile > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kTile - 1 > qw + a.diag);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        float p = exp2_ftz(s[nt][e] * sl2 - lse2[hi]);
        if (edge) {
          const int qi = r + 8 * hi, kj = k0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = qi < a.sq && kj < a.skv &&
                          (!a.causal || kj <= qi + a.diag);
          p = ok ? p : 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - dl[hi]) * a.scale;
      }

    // dq += ds K over the block's columns, ds rounded to bf16
    uint32_t da[4][4];
    pack_a<8>(da, s);
    const uint32_t kc = kc0 + (kb & 1) * TO::kBytes;
    hold(dq);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs<kCols, !SC>(dq, da[j], desc_col<kCols, SC>(kc, j * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(dq);
    hold(da);
    __syncthreads();
  }

  cp_async_wait_all_threads<0>();
  stage_acc<kCols, SC>(base, dq, w * 16, lane);
  __syncthreads();
  store_tile<kCols, SC>(dq_out, base, q0, a.sq, a.o0_st);
}

template <bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_kernel(BwdArgs a) {
  unsigned char* base = smem_base();
  // the ring: stage i holds chunks of K, V, Q and dO (the Q and dO tiles
  // hold a step's 32 queries, zero-filled past them); then the step's Q
  // and dO block columns, lse and delta, one stage per step parity
  const uint32_t ring = smem_u32(base);
  const uint32_t qc0 = ring + 8 * TC::kBytes;  // stage i: Q, then dO
  float* lses = reinterpret_cast<float*>(base + 8 * TC::kBytes +
                                         4 * TO::kBytes);  // 2 x kStep
  float* dls = lses + 2 * kStep;                           // 2 x kStep

  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % ncb) * kCols;
  const int k0 = (blockIdx.x / ncb) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + h * a.v_sh;
  const bf16* dout = a.dout + b * a.d_sb + h * a.d_sh;
  const bf16* qcols = from_col<SC>(q, col0, a.q_st);
  const bf16* dcols = from_col<SC>(dout, col0, a.d_st);
  bf16* dk_out =
      from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st);
  bf16* dv_out =
      from_col<SC>(a.out1 + b * a.o1_sb + h * a.o1_sh, col0, a.o1_st);
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.sq;

  const int nqs = (a.sq + kStep - 1) / kStep;
  int lo = 0;
  if (a.causal) {
    // query step qs reaches this key tile iff its last query position
    // q_off + qs * 32 + 31 >= k_off + k0
    const long long need = (long long)a.k_off + k0 - a.q_off - (kStep - 1);
    lo = need <= 0 ? 0 : (int)min((long long)nqs, (need + kStep - 1) / kStep);
  }
  const int nsteps = (nqs - lo) * nch;
  auto load_step = [&](int n) {
    const int i = n / nch, c = n % nch;
    const int qq0 = (lo + i) * kStep, qlen = min(a.sq, qq0 + kStep);
    const uint32_t st = ring + (n & 1) * 4 * TC::kBytes;
    load_tile<kChunk, SC>(st, from_col<SC>(k, c * kChunk, a.k_st), k0, a.skv,
                          a.k_st);
    load_tile<kChunk, SC>(st + TC::kBytes,
                          from_col<SC>(v, c * kChunk, a.v_st), k0, a.skv,
                          a.v_st);
    load_tile<kChunk, SC>(st + 2 * TC::kBytes,
                          from_col<SC>(q, c * kChunk, a.q_st), qq0, qlen,
                          a.q_st);
    load_tile<kChunk, SC>(st + 3 * TC::kBytes,
                          from_col<SC>(dout, c * kChunk, a.d_st), qq0, qlen,
                          a.d_st);
    if (c == 0) {
      const int cs = i & 1;
      const uint32_t ct = qc0 + cs * 2 * TO::kBytes;
      load_tile<kCols, SC>(ct, qcols, qq0, qlen, a.q_st);
      load_tile<kCols, SC>(ct + TO::kBytes, dcols, qq0, qlen, a.d_st);
      const int j = threadIdx.x & (kStep - 1);
      const int qi = qq0 + j;
      const bool in = qi < a.sq;
      if (threadIdx.x < kStep) {
        cp_async4(smem_u32(lses + cs * kStep + j), in ? lse + qi : lse,
                  in ? 4 : 0);
      } else if (threadIdx.x < 2 * kStep) {
        cp_async4(smem_u32(dls + cs * kStep + j), in ? delta + qi : delta,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  if (nsteps > 0) load_step(0);

  float dk[kCols / 8][4], dv[kCols / 8][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * kLog2e;
  const int kw = k0 + w * 16;  // this warp's first key
  float s[kStep / 8][4], dp[kStep / 8][4];

  for (int n = 0; n < nsteps; ++n) {
    const int i = n / nch, c = n % nch;
    if (n + 1 < nsteps) {
      load_step(n + 1);
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t st = ring + (n & 1) * 4 * TC::kBytes;

    // S^T += K Q^T and dP^T += V dO^T over this chunk's columns: rows are
    // keys, columns the step's queries
    if (c == 0) {
      zero(s);
      zero(dp);
    }
    hold(s);
    hold(dp);
    wgmma_fence();
    chunk_mma<kStep, SC>(s, st, st + 2 * TC::kBytes);
    chunk_mma<kStep, SC>(dp, st + TC::kBytes, st + 3 * TC::kBytes);
    wgmma_commit();
    wgmma_wait();
    hold(s);
    hold(dp);
    if (c + 1 < nch) {
      __syncthreads();
      continue;
    }

    // p^T into s and ds^T into dp
    const int cs = i & 1;
    const float* l_t = lses + cs * kStep;
    const float* d_t = dls + cs * kStep;
    const int qc = (lo + i) * kStep;
    const bool edge = kw + 16 > a.skv || qc + kStep > a.sq ||
                      (a.causal && kw + 15 > qc + a.diag);
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = exp2_ftz(s[nt][e] * sl2 - l_t[col] * kLog2e);
        if (edge) {
          const int qi = qc + col, kj = kw + g + 8 * (e >> 1);
          const bool ok = qi < a.sq && kj < a.skv &&
                          (!a.causal || kj <= qi + a.diag);
          p = ok ? p : 0.f;
        }
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - d_t[col]) * a.scale;
      }

    // dv += p^T dO and dk += ds^T Q over the block's columns, p and ds
    // rounded to bf16: query steps of 16
    uint32_t pa[kStep / 16][4], sa[kStep / 16][4];
    pack_a<kStep / 8>(pa, s);
    pack_a<kStep / 8>(sa, dp);
    const uint32_t ct = qc0 + cs * 2 * TO::kBytes;
    hold(dv);
    hold(dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      wgmma_rs<kCols, !SC>(dv, pa[j],
                           desc_col<kCols, SC>(ct + TO::kBytes, j * 16));
      wgmma_rs<kCols, !SC>(dk, sa[j], desc_col<kCols, SC>(ct, j * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(dv);
    hold(dk);
    hold(pa);
    hold(sa);
    __syncthreads();
  }

  cp_async_wait_all_threads<0>();
  stage_acc<kCols, SC>(base, dk, w * 16, lane);
  stage_acc<kCols, SC>(base + TO::kBytes, dv, w * 16, lane);
  __syncthreads();
  store_tile<kCols, SC>(dk_out, base, k0, a.skv, a.o0_st);
  store_tile<kCols, SC>(dv_out, base + TO::kBytes, k0, a.skv, a.o1_st);
}

// the checks both entries make; 0 or a CUDA error code
int check_args(int dtype, int head_dim, int layout, int batch, int heads,
               int sq, int skv) {
  if (dtype != 1 || head_dim <= 256 || head_dim % kCols != 0 ||
      (layout != 0 && layout != 1) || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int clamp_diag(int q_off, int k_off) {
  long long diag = (long long)q_off - k_off;
  return (int)(diag < -(1LL << 30) ? -(1LL << 30)
                                   : (diag > (1LL << 30) ? (1LL << 30) : diag));
}

template <typename Kernel, typename A>
int launch(Kernel kernel, const A& a, int bytes, int rows, int batch,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.d / kCols) * ((rows + kTile - 1) / kTile), a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward in bf16 at head_dim > 256, a multiple of 128, with
// `mxt_flash_attention_fwd_bf16`'s argument list (flash_attention_fwd.cu).
int mxt_flash_attention_fwd_wide_bf16(
    int dtype, int head_dim, int layout, const void* q, const void* k,
    const void* v, void* o, float* lse, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st, int q_off,
    int k_off, int causal, float scale, void* stream) {
  int err = check_args(dtype, head_dim, layout, batch, heads, sq, skv);
  if (err) return err;
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (!aligned(q, q_sb, q_sh, q_st) || !aligned(k, k_sb, k_sh, k_st) ||
      !aligned(v, v_sb, v_sh, v_st) || !aligned(o, o_sb, o_sh, o_st)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
            q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
            o_sb, o_sh, o_st, heads, sq, skv, q_off, k_off, causal,
            clamp_diag(q_off, k_off), scale, head_dim};
  // the ring (two stages of a Q and a K chunk), two stages of V's block
  // columns, and room to align them to 1024
  constexpr int bytes = 4 * TC::kBytes + 2 * TO::kBytes + 1024;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout ? launch(flash_fwd_wide_kernel<true>, a, bytes, sq, batch, s)
                : launch(flash_fwd_wide_kernel<false>, a, bytes, sq, batch,
                         s);
}

// The two backward passes in bf16 at head_dim > 256, a multiple of 128,
// with `mxt_flash_attention_bwd_bf16`'s argument list
// (flash_attention_bwd.cu): which = 0 the dq pass, 1 the dk/dv pass.
int mxt_flash_attention_bwd_wide_bf16(
    int which, int dtype, int head_dim, int layout, const void* q,
    const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* out0, void* out1, int batch, int heads, int sq,
    int skv, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long d_sb, long long d_sh, long long d_st,
    long long o0_sb, long long o0_sh, long long o0_st, long long o1_sb,
    long long o1_sh, long long o1_st, int q_off, int k_off, int causal,
    float scale, void* stream) {
  int err = check_args(dtype, head_dim, layout, batch, heads, sq, skv);
  if (err) return err;
  if ((which != 0 && which != 1) || (which == 1 && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int len = which == 0 ? sq : skv;
  if (batch == 0 || heads == 0 || len == 0) return 0;
  if (!aligned(q, q_sb, q_sh, q_st) || !aligned(k, k_sb, k_sh, k_st) ||
      !aligned(v, v_sb, v_sh, v_st) || !aligned(dout, d_sb, d_sh, d_st) ||
      !aligned(out0, o0_sb, o0_sh, o0_st) ||
      (which == 1 && !aligned(out1, o1_sb, o1_sh, o1_st))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            lse, delta, static_cast<bf16*>(out0), static_cast<bf16*>(out1),
            q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
            d_sb, d_sh, d_st, o0_sb, o0_sh, o0_st, o1_sb, o1_sh, o1_st,
            heads, sq, skv, q_off, k_off, causal, clamp_diag(q_off, k_off),
            scale, head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    // the ring (two stages of Q, dO, K and V chunks), two stages of K's
    // block columns, alignment
    constexpr int bytes = 8 * TC::kBytes + 2 * TO::kBytes + 1024;
    return layout
               ? launch(flash_bwd_dq_wide_kernel<true>, a, bytes, sq, batch, s)
               : launch(flash_bwd_dq_wide_kernel<false>, a, bytes, sq, batch,
                        s);
  }
  // the ring, two stages of Q's and dO's block columns, two of lse and
  // delta, alignment
  constexpr int bytes = 8 * TC::kBytes + 4 * TO::kBytes +
                        4 * kStep * (int)sizeof(float) + 1024;
  return layout
             ? launch(flash_bwd_dkv_wide_kernel<true>, a, bytes, skv, batch, s)
             : launch(flash_bwd_dkv_wide_kernel<false>, a, bytes, skv, batch,
                      s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
