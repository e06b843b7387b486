// Flash attention at head widths above 256, in float32, on Hopper's tensor
// cores through 3xTF32: the forward and the two backward passes.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in float32 at head_dim > 256, where the JAX package's residency model
// (`_stream_residency_fits` :40-71) still sends short sequences to Pallas:
// `_fwd_kernel` :98 (`_flash_fwd_pallas` :155), `_bwd_dq_kernel` :268 and
// `_bwd_dkv_kernel` :316 (`_flash_bwd_pallas` :372), and, through the same
// strides as flash_attention_fwd_f32.cu and flash_attention_bwd_f32.cu,
// their dS, bsd and grid-streamed bsd forms.  The arithmetic is those two
// sources': every product in 3xTF32 (each operand split into hi and lo
// TF32 terms, hi hi + hi lo + lo hi, tf32.cuh), the online softmax in the
// log2 domain with the scale on the float32 scores, each streamed tile's P
// V (dQ, dK, dV) in a fresh accumulator added to the float32 sum in
// registers.  A row that sees no key gets out 0, lse -1e30 and zero
// gradients.
//
// Bound on the H100: operations, 3 x 4 D (forward) and 3 x 10 D
// (backward) flops a visible pair at 495 TFLOP/s of TF32.  Design, which
// costs more: as in flash_attention_wide.cu, the head is cut into column
// blocks of 128, one block of the grid per (batch, head, 64-row tile,
// column block), so each float32 sum a warpgroup holds is 64 x 128 (64
// registers a thread) whatever D is; D is a runtime argument, a multiple of
// 128.  The score products contract over all of D, so both of their
// operands stream in chunks of 32 columns: each chunk is copied raw by
// cp.async, split into hi and lo tiles K-major over its columns (`wgmma`
// reads 32-bit operands from shared memory K-major only), and multiplied
// from shared memory (m64n32k8, `wgmma_tf32_ss32`) into a fresh
// accumulator, cross terms first, that is added to S (dP) in registers,
// rounded to nearest: over 1024 columns one accumulator would take 384
// sums rounded toward zero.  S (dP) is recomputed once per column block,
// D / 128 times the score products of one pass.  The block's own 128
// columns of V (forward), K (dq pass), Q and dO (dk/dv pass) are copied
// once per key (query) tile and split transposed, K-major over positions,
// as the B operand of the tile's fresh output product.
//   forward:    one warpgroup a block of 64 queries, 32-key tiles up to
//               the causal diagonal.  Shared memory 84 KB.
//   dq pass:    one warpgroup a block of 64 queries, 32-key tiles.  120 KB.
//   dk/dv pass: two warpgroups a block of 64 keys, query steps of 32; the
//               first accumulates dV, the second dP^T and dK, both S^T
//               (flash_attention_bwd_f32.cu's split).  168.5 KB.
// No atomics: two launches give the same bits.
//
// Requirements, checked by the C entries (the wrapper copies an operand
// that lacks them): every operand and output 16-byte aligned, its
// contiguous axis of stride 1 and its other strides multiples of 4
// elements.  Positions past the end are zero-filled, never read; nothing
// past the end is written.  Offsets are 64-bit.

#include "tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kChunk = 32;  // columns of a streamed chunk of the scores' operands
constexpr int kCols = 128;  // output columns a block computes
constexpr int kSeq = 32;    // keys (forward, dq) or queries (dk/dv) a step

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // (batch, heads, sq) float32 contiguous
  const float* delta;  // (batch, heads, sq) float32 contiguous
  float* out0;         // dq (dq pass) or dk (dk/dv pass)
  float* out1;         // unused (dq pass) or dv (dk/dv pass)
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

// bytes of a raw or split tile of `rows` positions by `cols` columns
__host__ __device__ constexpr int tile_bytes(int rows, int cols) {
  return rows * cols * 4;
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
}

// acc += A B^T over one chunk, in 3xTF32 through a fresh accumulator: A's
// split tiles (ah, al) of 64 rows, B's (bh, bl) of 32, both K-major over
// the chunk's columns
__device__ __forceinline__ void chunk_mma(float (&acc)[4][4], uint32_t ah,
                                          uint32_t al, uint32_t bh,
                                          uint32_t bl) {
  float x[4][4];
  zero(x);
  hold(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    wgmma_tf32_ss32(x, desc_k<kPos>(ah, kk), desc_k<kSeq>(bl, kk));
    wgmma_tf32_ss32(x, desc_k<kPos>(al, kk), desc_k<kSeq>(bh, kk));
  }
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    wgmma_tf32_ss32(x, desc_k<kPos>(ah, kk), desc_k<kSeq>(bh, kk));
  }
  wgmma_commit();
  wgmma_wait();
  hold(x);
  add_acc<kSeq>(acc, x);
}

// the key tiles of kSeq that query rows q0 .. q0 + 63 see: up to the
// causal diagonal of the last of them
__device__ __forceinline__ int key_tiles(int q0, int sq, int skv, int q_off,
                                         int k_off, int causal) {
  int nkb = (skv + kSeq - 1) / kSeq;
  if (causal) {
    const long long last_q = (long long)q_off + min(q0 + kPos, sq) - 1;
    const long long hi = last_q - k_off;
    nkb = hi < 0 ? 0 : (int)min((long long)nkb, hi / kSeq + 1);
  }
  return nkb;
}

// forward shared memory: raw Q chunk, K chunk and V columns; split Q
// chunk, K chunk (hi, lo) and V^T (hi, lo)
constexpr int kFwdRaw = tile_bytes(kPos, kChunk) + tile_bytes(kSeq, kChunk) +
                        tile_bytes(kSeq, kCols);
constexpr int kFwdBytes = kFwdRaw + 2 * tile_bytes(kPos, kChunk) +
                          2 * tile_bytes(kSeq, kChunk) +
                          2 * tile_bytes(kSeq, kCols) + 1024;

template <bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_tf32_kernel(FwdArgs a) {
  constexpr int kQB = tile_bytes(kPos, kChunk);
  constexpr int kKB = tile_bytes(kSeq, kChunk);
  constexpr int kVB = tile_bytes(kSeq, kCols);
  unsigned char* base = smem_base();
  float* qr = reinterpret_cast<float*>(base);  // raw Q chunk
  float* kr = qr + kPos * kChunk;              // raw K chunk
  float* vr = kr + kSeq * kChunk;              // raw V columns
  unsigned char* sp = base + kFwdRaw;
  unsigned char* qh = sp;              // Q chunk hi, lo: K-major
  unsigned char* ql = qh + kQB;
  unsigned char* kh = ql + kQB;        // K chunk hi, lo: K-major
  unsigned char* kl = kh + kKB;
  unsigned char* vth = kl + kKB;       // V^T hi, lo: K-major over keys
  unsigned char* vtl = vth + kVB;

  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % ncb) * kCols;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / ncb - 1 - blockIdx.x / ncb) * kPos;
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = from_col<SC>(a.v + b * a.v_sb + h * a.v_sh, col0, a.v_st);
  float* out = from_col<SC>(a.o + b * a.o_sb + h * a.o_sh, col0, a.o_st);

  // raw chunk c of Q and of key tile kb's K and, with chunk 0, the tile's
  // V columns
  auto stage = [&](int kb, int c) {
    stage_raw<kPos, kChunk, SC, false, kThreads>(
        qr, from_col<SC>(q, c * kChunk, a.q_st), q0, a.sq, a.q_st);
    stage_raw<kSeq, kChunk, SC, false, kThreads>(
        kr, from_col<SC>(k, c * kChunk, a.k_st), kb * kSeq, a.skv, a.k_st);
    if (c == 0) {
      stage_raw<kSeq, kCols, SC, false, kThreads>(vr, v, kb * kSeq, a.skv,
                                                  a.v_st);
    }
    cp_async_commit();
  };
  const int nkb = key_tiles(q0, a.sq, a.skv, a.q_off, a.k_off, a.causal);
  if (nkb > 0) stage(0, 0);

  // this thread's two query rows, r and r + 8: their running max (log2
  // domain) and its share of their sums
  const int r = q0 + w * 16 + g;
  const int qw = q0 + w * 16;  // this warp's first query
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kCols / 8][4];
  zero(o);
  const float sl2 = a.scale * kLog2e;

  for (int kb = 0; kb < nkb; ++kb) {
    float s[4][4];
    zero(s);
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      // this step's raw copies; every warp is done with the split tiles
      cp_async_wait_all_threads<0>();
      split_tile<kChunk, kPos, SC, false, kThreads>(qr, qh, ql, nullptr,
                                                    nullptr);
      split_tile<kChunk, kSeq, SC, false, kThreads>(kr, kh, kl, nullptr,
                                                    nullptr);
      if (c == 0) {
        split_tile<kCols, kSeq, SC, true, kThreads, false>(vr, nullptr,
                                                           nullptr, vth, vtl);
      }
      publish_shared();  // the split tiles; the raw ones are free again
      if (c + 1 < nch) {
        stage(kb, c + 1);
      } else if (kb + 1 < nkb) {
        stage(kb + 1, 0);
      }
      chunk_mma(s, smem_u32(qh), smem_u32(ql), smem_u32(kh), smem_u32(kl));
    }

    // the log2-domain scores, masked only where a pair of the warp's rows
    // and this key tile can be hidden; the tile's row max
    const int k0 = kb * kSeq;
    const bool edge = k0 + kSeq > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kSeq - 1 > qw + a.diag);
    float mx[2] = {kNegInf, kNegInf}, corr[2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
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
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      corr[hi] = exp2_ftz(m[hi] - m_new);
      m[hi] = m_new;
      l[hi] *= corr[hi];
    }
    // p, 0 where masked (a row whose every key so far is masked has m
    // at kNegInf, where 2**(x - m) of a masked score would be 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float x = s[nt][e];
        const float p = x == kNegInf ? 0.f : exp2_ftz(x - m[hi]);
        s[nt][e] = p;
        l[hi] += p;
      }

    // the tile's P V over the block's columns in a fresh accumulator (key
    // steps of 8, p's registers the A operand), then o = o * corr + tile
    uint32_t ph[4][4], pl[4][4];
    split_acc<4>(ph, pl, s);
    float pv[kCols / 8][4];
    tile_mma<kCols, 4>(pv, ph, pl, smem_u32(vth), smem_u32(vtl));
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[nt][e] = o[nt][e] * corr[e >> 1] + pv[nt][e];
      }
  }

  float inv[2], lse[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = l[hi] == 0.f ? 0.f : 1.f / l[hi];
    lse[hi] = l[hi] == 0.f ? kNegInf : m[hi] * kLn2 + logf(l[hi]);
  }
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];

  // every warp is done with its products: the tiles take the block's out
  cp_async_wait_all_threads<0>();
  float* stg = reinterpret_cast<float*>(base);
  stage_acc_f32<kCols, SC>(stg, o, w * 16 + g, t);
  // every column block makes the same m and l: the first writes lse
  if (a.lse != nullptr && t == 0 && col0 == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qi = r + 8 * hi;
      if (qi < a.sq) a.lse[((long long)b * a.heads + h) * a.sq + qi] = lse[hi];
    }
  }
  __syncthreads();
  store_out<kCols, SC>(out, stg, q0, a.sq, a.o_st, threadIdx.x);
}

// dq pass shared memory: raw Q, dO chunks, K, V chunks, K's block columns;
// split Q, dO chunks, K, V chunks and K^T (hi, lo each)
constexpr int kDqRaw = 2 * tile_bytes(kPos, kChunk) +
                       2 * tile_bytes(kSeq, kChunk) + tile_bytes(kSeq, kCols);
constexpr int kDqBytes = kDqRaw + 4 * tile_bytes(kPos, kChunk) +
                         4 * tile_bytes(kSeq, kChunk) +
                         2 * tile_bytes(kSeq, kCols) + 1024;

template <bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_tf32_kernel(BwdArgs a) {
  constexpr int kQB = tile_bytes(kPos, kChunk);
  constexpr int kKB = tile_bytes(kSeq, kChunk);
  constexpr int kTB = tile_bytes(kSeq, kCols);
  unsigned char* base = smem_base();
  float* qr = reinterpret_cast<float*>(base);  // raw Q chunk
  float* dr = qr + kPos * kChunk;              // raw dO chunk
  float* kr = dr + kPos * kChunk;              // raw K chunk
  float* vr = kr + kSeq * kChunk;              // raw V chunk
  float* kcr = vr + kSeq * kChunk;             // raw K columns
  unsigned char* sp = base + kDqRaw;
  unsigned char* qh = sp;             // Q chunk hi, lo
  unsigned char* ql = qh + kQB;
  unsigned char* dh = ql + kQB;       // dO chunk hi, lo
  unsigned char* dlo = dh + kQB;
  unsigned char* kh = dlo + kQB;      // K chunk hi, lo
  unsigned char* kl = kh + kKB;
  unsigned char* vh = kl + kKB;       // V chunk hi, lo
  unsigned char* vl = vh + kKB;
  unsigned char* kth = vl + kKB;      // K^T hi, lo: K-major over keys
  unsigned char* ktl = kth + kTB;

  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % ncb) * kCols;
  const int q0 = (gridDim.x / ncb - 1 - blockIdx.x / ncb) * kPos;
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* dout = a.dout + b * a.d_sb + h * a.d_sh;
  const float* kcols = from_col<SC>(k, col0, a.k_st);
  float* dq_out =
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

  auto stage = [&](int kb, int c) {
    stage_raw<kPos, kChunk, SC, false, kThreads>(
        qr, from_col<SC>(q, c * kChunk, a.q_st), q0, a.sq, a.q_st);
    stage_raw<kPos, kChunk, SC, false, kThreads>(
        dr, from_col<SC>(dout, c * kChunk, a.d_st), q0, a.sq, a.d_st);
    stage_raw<kSeq, kChunk, SC, false, kThreads>(
        kr, from_col<SC>(k, c * kChunk, a.k_st), kb * kSeq, a.skv, a.k_st);
    stage_raw<kSeq, kChunk, SC, false, kThreads>(
        vr, from_col<SC>(v, c * kChunk, a.v_st), kb * kSeq, a.skv, a.v_st);
    if (c == 0) {
      stage_raw<kSeq, kCols, SC, false, kThreads>(kcr, kcols, kb * kSeq,
                                                  a.skv, a.k_st);
    }
    cp_async_commit();
  };
  const int nkb = key_tiles(q0, a.sq, a.skv, a.q_off, a.k_off, a.causal);
  if (nkb > 0) stage(0, 0);

  float dq[kCols / 8][4];
  zero(dq);
  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;  // this warp's first query

  for (int kb = 0; kb < nkb; ++kb) {
    // S = Q K^T and dP = dO V^T, a chunk of the columns at a time
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      cp_async_wait_all_threads<0>();
      split_tile<kChunk, kPos, SC, false, kThreads>(qr, qh, ql, nullptr,
                                                    nullptr);
      split_tile<kChunk, kPos, SC, false, kThreads>(dr, dh, dlo, nullptr,
                                                    nullptr);
      split_tile<kChunk, kSeq, SC, false, kThreads>(kr, kh, kl, nullptr,
                                                    nullptr);
      split_tile<kChunk, kSeq, SC, false, kThreads>(vr, vh, vl, nullptr,
                                                    nullptr);
      if (c == 0) {
        split_tile<kCols, kSeq, SC, true, kThreads, false>(kcr, nullptr,
                                                           nullptr, kth, ktl);
      }
      publish_shared();
      if (c + 1 < nch) {
        stage(kb, c + 1);
      } else if (kb + 1 < nkb) {
        stage(kb + 1, 0);
      }
      chunk_mma(s, smem_u32(qh), smem_u32(ql), smem_u32(kh), smem_u32(kl));
      chunk_mma(dp, smem_u32(dh), smem_u32(dlo), smem_u32(vh), smem_u32(vl));
    }

    // p and ds, into s; the mask only where a pair of the warp's rows and
    // this key tile can be hidden
    const int k0 = kb * kSeq;
    const bool edge = k0 + kSeq > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kSeq - 1 > qw + a.diag);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
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

    // dq += ds K over the block's columns: key steps of 8, ds's registers
    // the A operand, this tile's sum first
    uint32_t sh[4][4], sl[4][4];
    split_acc<4>(sh, sl, s);
    float dt[kCols / 8][4];
    tile_mma<kCols, 4>(dt, sh, sl, smem_u32(kth), smem_u32(ktl));
    add_acc<kCols>(dq, dt);
  }

  cp_async_wait_all_threads<0>();  // every warp is done with the tiles
  float* stg = reinterpret_cast<float*>(base);
  stage_acc_f32<kCols, SC>(stg, dq, w * 16 + g, t);
  __syncthreads();
  store_out<kCols, SC>(dq_out, stg, q0, a.sq, a.o0_st, threadIdx.x);
}

// the dk/dv pass runs two warpgroups that share the block's tiles: the
// first forms p^T and accumulates dV, the second p^T and ds^T and
// accumulates dK
constexpr int kDkvThreads = 2 * kThreads;

// dk/dv pass shared memory: raw K, V chunks, Q, dO chunks, Q's and dO's
// block columns; split K, V chunks, Q, dO chunks, Q^T and dO^T (hi, lo
// each); lse and delta of two steps
constexpr int kDkvRaw = 2 * tile_bytes(kPos, kChunk) +
                        2 * tile_bytes(kSeq, kChunk) +
                        2 * tile_bytes(kSeq, kCols);
constexpr int kDkvSplit = 4 * tile_bytes(kPos, kChunk) +
                          4 * tile_bytes(kSeq, kChunk) +
                          4 * tile_bytes(kSeq, kCols);
constexpr int kDkvBytes = kDkvRaw + kDkvSplit + 4 * kSeq * 4 + 1024;

template <bool SC>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_wide_tf32_kernel(BwdArgs a) {
  constexpr int kKB = tile_bytes(kPos, kChunk);
  constexpr int kQB = tile_bytes(kSeq, kChunk);
  constexpr int kTB = tile_bytes(kSeq, kCols);
  unsigned char* base = smem_base();
  float* kr = reinterpret_cast<float*>(base);  // raw K chunk
  float* vr = kr + kPos * kChunk;              // raw V chunk
  float* qr = vr + kPos * kChunk;              // raw Q chunk
  float* dr = qr + kSeq * kChunk;              // raw dO chunk
  float* qcr = dr + kSeq * kChunk;             // raw Q columns
  float* dcr = qcr + kSeq * kCols;             // raw dO columns
  unsigned char* sp = base + kDkvRaw;
  unsigned char* kh = sp;             // K chunk hi, lo
  unsigned char* kl = kh + kKB;
  unsigned char* vh = kl + kKB;       // V chunk hi, lo
  unsigned char* vl = vh + kKB;
  unsigned char* qh = vl + kKB;       // Q chunk hi, lo
  unsigned char* ql = qh + kQB;
  unsigned char* dh = ql + kQB;       // dO chunk hi, lo
  unsigned char* dlo = dh + kQB;
  unsigned char* qth = dlo + kQB;     // Q^T hi, lo: K-major over queries
  unsigned char* qtl = qth + kTB;
  unsigned char* dth = qtl + kTB;     // dO^T hi, lo
  unsigned char* dtl = dth + kTB;
  float* lses = reinterpret_cast<float*>(sp + kDkvSplit);  // 2 x kSeq
  float* dls = lses + 2 * kSeq;                           // 2 x kSeq

  const int tid = threadIdx.x;
  const bool dk_group = tid >= kThreads;  // the second warpgroup: dK
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ncb = a.d / kCols, nch = a.d / kChunk;
  const int col0 = (blockIdx.x % ncb) * kCols;
  const int k0 = (blockIdx.x / ncb) * kPos;
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* dout = a.dout + b * a.d_sb + h * a.d_sh;
  const float* qcols = from_col<SC>(q, col0, a.q_st);
  const float* dcols = from_col<SC>(dout, col0, a.d_st);
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.sq;

  const int nqs = (a.sq + kSeq - 1) / kSeq;
  int lo = 0;
  if (a.causal) {
    // query step qs reaches this key tile iff its last query position
    // q_off + qs * 32 + 31 >= k_off + k0
    const long long need = (long long)a.k_off + k0 - a.q_off - (kSeq - 1);
    lo = need <= 0 ? 0 : (int)min((long long)nqs, (need + kSeq - 1) / kSeq);
  }
  // raw chunk c of the key tile's K and V and of query step qs's Q and dO,
  // and with chunk 0 the step's Q and dO columns, lse and delta (stage
  // (qs - lo) & 1 of them)
  auto stage = [&](int qs, int c) {
    const int qq0 = qs * kSeq;
    stage_raw<kPos, kChunk, SC, false, kDkvThreads>(
        kr, from_col<SC>(k, c * kChunk, a.k_st), k0, a.skv, a.k_st);
    stage_raw<kPos, kChunk, SC, false, kDkvThreads>(
        vr, from_col<SC>(v, c * kChunk, a.v_st), k0, a.skv, a.v_st);
    stage_raw<kSeq, kChunk, SC, false, kDkvThreads>(
        qr, from_col<SC>(q, c * kChunk, a.q_st), qq0, a.sq, a.q_st);
    stage_raw<kSeq, kChunk, SC, false, kDkvThreads>(
        dr, from_col<SC>(dout, c * kChunk, a.d_st), qq0, a.sq, a.d_st);
    if (c == 0) {
      stage_raw<kSeq, kCols, SC, false, kDkvThreads>(qcr, qcols, qq0, a.sq,
                                                     a.q_st);
      stage_raw<kSeq, kCols, SC, false, kDkvThreads>(dcr, dcols, qq0, a.sq,
                                                     a.d_st);
      const int st = (qs - lo) & 1;
      const int i = tid & (kSeq - 1);
      const int qi = qq0 + i;
      const bool in = qi < a.sq;
      if (tid < kSeq) {
        cp_async4(smem_u32(lses + st * kSeq + i), in ? lse + qi : lse,
                  in ? 4 : 0);
      } else if (tid < 2 * kSeq) {
        cp_async4(smem_u32(dls + st * kSeq + i), in ? delta + qi : delta,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  if (lo < nqs) stage(lo, 0);

  // this warpgroup's sum: dV or dK
  float acc[kCols / 8][4];
  zero(acc);
  const float sl2 = a.scale * kLog2e;
  const int kw = k0 + w * 16;  // this warp's first key

  for (int qs = lo; qs < nqs; ++qs) {
    // S^T = K Q^T and, for dK, dP^T = V dO^T, a chunk of the columns at a
    // time: rows are keys, columns the step's queries
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      cp_async_wait_all_threads<0>();
      split_tile<kChunk, kPos, SC, false, kDkvThreads>(kr, kh, kl, nullptr,
                                                       nullptr);
      split_tile<kChunk, kPos, SC, false, kDkvThreads>(vr, vh, vl, nullptr,
                                                       nullptr);
      split_tile<kChunk, kSeq, SC, false, kDkvThreads>(qr, qh, ql, nullptr,
                                                       nullptr);
      split_tile<kChunk, kSeq, SC, false, kDkvThreads>(dr, dh, dlo, nullptr,
                                                       nullptr);
      if (c == 0) {
        split_tile<kCols, kSeq, SC, true, kDkvThreads, false>(
            qcr, nullptr, nullptr, qth, qtl);
        split_tile<kCols, kSeq, SC, true, kDkvThreads, false>(
            dcr, nullptr, nullptr, dth, dtl);
      }
      publish_shared();
      if (c + 1 < nch) {
        stage(qs, c + 1);
      } else if (qs + 1 < nqs) {
        stage(qs + 1, 0);
      }
      chunk_mma(s, smem_u32(kh), smem_u32(kl), smem_u32(qh), smem_u32(ql));
      if (dk_group) {
        chunk_mma(dp, smem_u32(vh), smem_u32(vl), smem_u32(dh),
                  smem_u32(dlo));
      }
    }
    const float* l_t = lses + ((qs - lo) & 1) * kSeq;
    const float* d_t = dls + ((qs - lo) & 1) * kSeq;

    // p^T into s and, for dK, ds^T into s
    const int qc = qs * kSeq;
    const bool edge = kw + 16 > a.skv || qc + kSeq > a.sq ||
                      (a.causal && kw + 15 > qc + a.diag);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
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
        s[nt][e] = dk_group ? p * (dp[nt][e] - d_t[col]) * a.scale : p;
      }

    // dV += p^T dO or dK += ds^T Q over the block's columns: query steps
    // of 8, the accumulator's registers the A operand, this tile's sum
    // first
    uint32_t fh[4][4], fl[4][4];
    split_acc<4>(fh, fl, s);
    float dt[kCols / 8][4];
    if (dk_group) {
      tile_mma<kCols, 4>(dt, fh, fl, smem_u32(qth), smem_u32(qtl));
    } else {
      tile_mma<kCols, 4>(dt, fh, fl, smem_u32(dth), smem_u32(dtl));
    }
    add_acc<kCols>(acc, dt);
  }

  cp_async_wait_all_threads<0>();  // every warp is done with the tiles
  float* stg = reinterpret_cast<float*>(base) +
               dk_group * stg_floats<kCols, SC>();
  stage_acc_f32<kCols, SC>(stg, acc, w * 16 + g, t);
  __syncthreads();
  if (dk_group) {
    store_out<kCols, SC>(
        from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st), stg,
        k0, a.skv, a.o0_st, tid - kThreads);
  } else {
    store_out<kCols, SC>(
        from_col<SC>(a.out1 + b * a.o1_sb + h * a.o1_sh, col0, a.o1_st), stg,
        k0, a.skv, a.o1_st, tid);
  }
}

int check_args(int dtype, int head_dim, int layout, int batch, int heads,
               int sq, int skv) {
  if (dtype != 0 || head_dim <= 256 || head_dim % kCols != 0 ||
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
int launch(Kernel kernel, const A& a, int bytes, int threads, int rows,
           int batch, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.d / kCols) * ((rows + kPos - 1) / kPos), a.heads, batch);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward in float32 at head_dim > 256, a multiple of 128, with
// `mxt_flash_attention_fwd_f32`'s argument list (flash_attention_fwd_f32.cu).
int mxt_flash_attention_fwd_wide_f32(
    int dtype, int head_dim, int layout, const void* q, const void* k,
    const void* v, void* o, float* lse, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st, int q_off,
    int k_off, int causal, float scale, void* stream) {
  int err = check_args(dtype, head_dim, layout, batch, heads, sq, skv);
  if (err) return err;
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (!aligned_f32(q, q_sb, q_sh, q_st) || !aligned_f32(k, k_sb, k_sh, k_st) ||
      !aligned_f32(v, v_sb, v_sh, v_st) || !aligned_f32(o, o_sb, o_sh, o_st)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), lse,
            q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
            o_sb, o_sh, o_st, heads, sq, skv, q_off, k_off, causal,
            clamp_diag(q_off, k_off), scale, head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout ? launch(flash_fwd_wide_tf32_kernel<true>, a, kFwdBytes,
                         kThreads, sq, batch, s)
                : launch(flash_fwd_wide_tf32_kernel<false>, a, kFwdBytes,
                         kThreads, sq, batch, s);
}

// The two backward passes in float32 at head_dim > 256, a multiple of
// 128, with `mxt_flash_attention_bwd_f32`'s argument list
// (flash_attention_bwd_f32.cu): which = 0 the dq pass, 1 the dk/dv pass.
int mxt_flash_attention_bwd_wide_f32(
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
  if (!aligned_f32(q, q_sb, q_sh, q_st) || !aligned_f32(k, k_sb, k_sh, k_st) ||
      !aligned_f32(v, v_sb, v_sh, v_st) ||
      !aligned_f32(dout, d_sb, d_sh, d_st) ||
      !aligned_f32(out0, o0_sb, o0_sh, o0_st) ||
      (which == 1 && !aligned_f32(out1, o1_sb, o1_sh, o1_st))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(dout),
            lse, delta, static_cast<float*>(out0), static_cast<float*>(out1),
            q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
            d_sb, d_sh, d_st, o0_sb, o0_sh, o0_st, o1_sb, o1_sh, o1_st,
            heads, sq, skv, q_off, k_off, causal, clamp_diag(q_off, k_off),
            scale, head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    return layout ? launch(flash_bwd_dq_wide_tf32_kernel<true>, a, kDqBytes,
                           kThreads, sq, batch, s)
                  : launch(flash_bwd_dq_wide_tf32_kernel<false>, a, kDqBytes,
                           kThreads, sq, batch, s);
  }
  return layout ? launch(flash_bwd_dkv_wide_tf32_kernel<true>, a, kDkvBytes,
                         kDkvThreads, skv, batch, s)
                : launch(flash_bwd_dkv_wide_tf32_kernel<false>, a, kDkvBytes,
                         kDkvThreads, skv, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
