// Flash-attention backward in float32 on Hopper's tensor cores, through
// 3xTF32.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in float32: `_bwd_dq_kernel` :268 and `_bwd_dkv_kernel` :316
// (`_flash_bwd_pallas` :372); their dS forms `_bwd_dq_kernel_ds` :687 and
// `_bwd_dkv_kernel_ds` :738 (`_flash_bwd_pallas_ds` :794); their bsd forms
// :1060 and :1105 (`_flash_bwd_pallas_bsd` :1158); and their grid-streamed
// bsd forms :1407 and :1456 (`_flash_bwd_pallas_bsd_gs` :1510).  The two
// kernels compute what those compute:
//   p  = exp(scale * Q K^T - lse), exactly 0 wherever the causal mask, a
//        ragged tail or a query past Sq hides a pair;
//   ds = p * (dO V^T - delta) * scale, delta = rowsum(dO * O) - glse from
//        the caller;
//   dV = p^T dO, dK = ds^T Q and dQ = ds K, every sum in float32.
// Rows that see no key add exact zeros.
//
// 3xTF32.  The tensor cores take float32 only as TF32 (10 mantissa bits),
// which alone would miss the float32 checks (1e-4 of the largest value)
// by an order of magnitude.  So every operand x is split into hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), both rounded here
// explicitly (with integer operations that give the cvt's bits; nothing
// relies on how the tensor core treats the low 13 bits), and each of the
// five products A B is hi(A) hi(B) + hi(A) lo(B) + lo(A) hi(B): the
// dropped lo lo term and the rounding of lo cost about 2**-22 of each
// product.  The tensor cores round each sum they add into
// their accumulator toward zero, a bias that grows with the number of
// sums: over the thousands of keys (or queries) of a long sequence it
// reaches the float32 checks' bar.  So dQ, dK and dV take each streamed
// tile's sum in a fresh accumulator (its hi lo and lo hi terms first,
// then hi hi) and add it to their float32 sum in registers, rounded to
// nearest.  S and dP are single sums over D in the tensor cores.  No
// atomics, so two launches give the same bits.
//
// Bound on the H100: operations.  The function needs 10 * D flops a
// visible (query, key) pair (Q K^T once, dO V^T, dV, dK, dQ); the two
// passes recompute Q K^T and dO V^T (14 * D), and 3xTF32 triples each, at
// 495 TFLOP/s of TF32: the least time is 3 * 10 * D flops a pair at that
// rate, 2.5x faster than float32 on the CUDA cores (67 TFLOP/s) could be.
//
// Design: `wgmma` m64nNk8 tf32.  Every product takes its A operand from
// registers and its B operand from shared memory:
//   dq pass:    one warpgroup (4 warps) per (batch, head, 64-query tile),
//               the tiles with the longest causal rows first; 32-key
//               tiles of K and V stream up to the causal diagonal.
//               S = Q K^T and
//               dP = dO V^T (N = 32), then p and ds in registers, then
//               dQ += ds K (N = D) with ds's accumulator as the A operand.
//   dk/dv pass: two warpgroups per (batch, head, 64-key tile); BN-query
//               tiles of Q, dO, lse and delta stream from the first that
//               reaches the key tile.  The first warpgroup computes S^T =
//               K Q^T, p^T and dV += p^T dO; the second S^T, dP^T = V
//               dO^T, ds^T and dK += ds^T Q.  S^T is computed twice (5
//               products for 4), so that nothing passes between them and
//               each holds one float32 sum of 64 x D.
// BN, the dk/dv pass's query tile, is 64 at D = 64 and 32 at D = 128.
//
// What TF32 changes against the bf16 kernels (flash_attention_bwd.cu):
// * `wgmma` reads a 32-bit operand from shared memory only K-major (the
//   MN-major descriptors exist for 16-bit types alone), so an operand
//   contracted over two axes needs a tile in each orientation: K in the dq
//   pass (over D for S, over keys for dQ), Q and dO in the dk/dv pass.
//   The split goes through registers anyway: the streamed operand is
//   copied raw by cp.async (16 bytes a thread, into a buffer of its own,
//   while the block computes the tile before), then one pass forms hi and
//   lo and stores both, K-major over D and, where needed, K-major over
//   positions (the transposed copy), in the 128-byte swizzle.  In layout 1
//   (the dS orientation, S contiguous) the same pass reads the raw tile
//   along S; only its reads differ.
// * The A operands never touch a split tile.  ds and p come from the
//   accumulators: a TF32 A fragment holds columns t and t + 4 of an 8-wide
//   k step (lane = 4 g + t) where the accumulator holds 2 t and 2 t + 1,
//   so every k step of 8 is read in the slot order 0 2 4 6 1 3 5 7, the
//   transposed B tiles store their positions in that order, and
//   accumulator registers become A registers with no shuffle.  The owned
//   tiles (Q and dO in the dq pass, K and V in the dk/dv pass) stay raw in
//   shared memory and are split a k step at a time into registers (two
//   buffers: the next step's fragments are formed while the tensor cores
//   run this step's six products); the D axis of the B tiles is stored in
//   the same slot order, so a fragment is two 8-byte loads in layout 0.
// * Shared memory: an f32 tile is twice the bf16 one, and each streamed
//   operand needs hi and lo, one or two orientations, beside its raw copy.
//   Bytes (D = 64 | 128): dq pass: owned raw Q, dO 32 K | 64 K; raw K, V
//   16 K | 32 K; split tiles (K, V, K^T: hi, lo) 48 K | 96 K; total 96 K
//   | 192 K, so two blocks an SM at D = 64 (the second hides the first's
//   latencies: one warpgroup waits on each phase) and one at 128.  dk/dv
//   pass: owned raw K, V 32 K | 64 K; raw Q, dO 32 K | 32 K; split tiles
//   (Q, dO, Q^T, dO^T: hi, lo) 128 K | 128 K; lse and delta 1 K | 0.5 K;
//   total 193 K | 224.5 K, of 227 K: one block an SM, BN halved at D =
//   128.
// * Registers: at D = 128 one warpgroup cannot hold the dK and dV sums
//   (64 + 64 floats a thread) beside the tiles' fresh accumulators (64
//   more), S^T, dP^T and the A fragments within the 255-register cap.
//   Two warpgroups, one sum each, keep every kernel under it with no
//   spill; ptxas's count is in the build log (chip_smoke.py prints it).
//
// Head width 256 (widths 129-255 are zero-padded to it by the wrapper):
// the owned raw tiles alone take 128 K, so the streamed operands come a
// chunk of their columns at a time (64 in the dq pass, 32 in the dk/dv
// pass: `chunk_cols`), raw and then split, S and dP adding each chunk's
// products in their accumulators; and, as in the bf16 kernels, each
// pass's grid is twice as wide, a block computing one half of its
// outputs' columns (`out_cols`) from the transposed split tile of that
// half (K^T; Q^T and dO^T), which the chunks of the half fill as they
// pass.  Bytes: dq pass 128 K owned, 16 K raw, 32 K chunk split, 32 K
// K^T: 208 K; dk/dv pass 128 K owned, 8 K raw, 16 K chunk split, 64 K
// Q^T and dO^T, 0.5 K lse and delta: 216.5 K (+1 K alignment each).  The
// registers are D = 128's (a 64 x 128 sum a warpgroup).
//
// Requirements, checked by the C entry (the wrapper copies an operand
// that lacks them): every operand and output 16-byte aligned, its
// contiguous axis of stride 1 and its other strides multiples of 4
// elements (cp.async copies 16 bytes).  Positions past the end are
// zero-filled (cp.async's source size), never read; nothing past the end
// is written.  Offsets are 64-bit.
//
// The TF32 building blocks (the split, the `wgmma` tf32 products, the
// split tiles and their descriptors) are shared with fused_ce_f32.cu and
// flash_attention_fwd_f32.cu in tf32.cuh, and so are the raw copies in and
// the staged float32 out (with the forward).

#include "tf32.cuh"

namespace {

// positions of a streamed tile: 32 keys in the dq pass (at D = 64 its
// shared memory then fits two blocks an SM), 64 queries in the dk/dv pass
// at D = 64 and 32 at D = 128
template <int D, bool DKV>
__host__ __device__ constexpr int stream_len() {
  return DKV && D == 64 ? 64 : 32;
}

// the columns a streamed chunk holds: all D up to 128; at D = 256 chunks
// of 64 (dq pass) or 32 (dk/dv pass), so that the owned tiles (128 K)
// leave room for the chunk's raw and split copies and the transposed half
template <int D, bool DKV>
__host__ __device__ constexpr int chunk_cols() {
  return D <= 128 ? D : (DKV ? 32 : 64);
}

struct Args {
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
  int diag;  // q_off - k_off, clamped to +-2**30: key j is visible to
             // query i iff j <= i + diag
  float scale;
};

// One k step of `scores`: its products from the fragments in cur, then,
// once the previous step's products (which read next) are done, the next
// step's fragments into next.  kk counts the chunk's steps, kk0 + kk the
// owned tiles'.
template <int D, int DC, int BN, bool SC, bool DP>
__device__ __forceinline__ void scores_step(
    float (&s)[BN / 8][4], float (&dp)[BN / 8][4], uint32_t (&cur)[4][4],
    uint32_t (&next)[4][4], const float* x, const float* z, uint32_t yh,
    uint32_t yl, uint32_t wh, uint32_t wl, int kk, int kk0, int r0, int t) {
  wgmma_fence();
  mma3<BN>(s, cur[0], cur[1], desc_k<BN>(yh, kk), desc_k<BN>(yl, kk));
  if (DP) {
    mma3<BN>(dp, cur[2], cur[3], desc_k<BN>(wh, kk), desc_k<BN>(wl, kk));
  }
  wgmma_commit();
  if (kk + 1 < DC / 8) {
    wgmma_wait1();
    hold(next);
    owned_frag<D, SC>(x, kk0 + kk + 1, r0, t, next[0], next[1]);
    if (DP) owned_frag<D, SC>(z, kk0 + kk + 1, r0, t, next[2], next[3]);
  }
}

// s (64 x BN) += X Y^T and, with DP, dp += Z W^T over the DC columns of a
// chunk (the owned tiles' columns from 8 kk0 on), in 3xTF32: X and Z the
// owned raw tiles (A, split a k step at a time into two register buffers,
// the next step's while this step's products run), Y and W the chunk's hi
// and lo tiles K-major over its columns (B).  Up to D = 128 the chunk is
// all of D.
template <int D, int DC, int BN, bool SC, bool DP>
__device__ __forceinline__ void scores(float (&s)[BN / 8][4],
                                       float (&dp)[BN / 8][4], const float* x,
                                       const float* z, uint32_t yh,
                                       uint32_t yl, uint32_t wh, uint32_t wl,
                                       int r0, int t, int kk0) {
  // two buffers of [x hi, x lo, z hi, z lo][4]: step kk uses a0 when kk
  // is even, a1 when odd
  uint32_t a0[4][4], a1[4][4];
  owned_frag<D, SC>(x, kk0, r0, t, a0[0], a0[1]);
  if (DP) owned_frag<D, SC>(z, kk0, r0, t, a0[2], a0[3]);
  hold(s);
  if (DP) hold(dp);
#pragma unroll
  for (int kk = 0; kk < DC / 8; kk += 2) {
    scores_step<D, DC, BN, SC, DP>(s, dp, a0, a1, x, z, yh, yl, wh, wl, kk,
                                   kk0, r0, t);
    scores_step<D, DC, BN, SC, DP>(s, dp, a1, a0, x, z, yh, yl, wh, wl,
                                   kk + 1, kk0, r0, t);
  }
  wgmma_wait();
  hold(s);
  if (DP) hold(dp);
  hold(a0);
  hold(a1);
}

// s and dp zeroed
template <int BN>
__device__ __forceinline__ void zero2(float (&s)[BN / 8][4],
                                      float (&dp)[BN / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = 0.f;
      dp[nt][e] = 0.f;
    }
}

template <int D, bool SC>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_tf32_kernel(Args a) {
  constexpr int BN = stream_len<D, false>();
  // the chunk's columns, the block's dq columns, chunks, halves
  constexpr int DC = chunk_cols<D, false>(), DO = out_cols<D>();
  constexpr int kChunks = D / DC, kHalves = col_halves<D>();
  constexpr int kCB = BN * DC * 4;  // bytes of a chunk's hi or lo tile
  constexpr int kTB = BN * DO * 4;  // bytes of a K^T hi or lo tile
  float* qo = reinterpret_cast<float*>(smem_base());  // owned raw Q
  float* doo = qo + kPos * D;                         // owned raw dO
  float* kr = doo + kPos * D;                         // raw K chunk
  float* vr = kr + BN * DC;                           // raw V chunk
  unsigned char* sp = reinterpret_cast<unsigned char*>(vr + BN * DC);
  unsigned char* kh = sp;               // K hi, lo: K-major over D
  unsigned char* kl = sp + kCB;
  unsigned char* vh = sp + 2 * kCB;     // V hi, lo: K-major over D
  unsigned char* vl = sp + 3 * kCB;
  unsigned char* kth = sp + 4 * kCB;    // K^T hi, lo: K-major over keys,
  unsigned char* ktl = kth + kTB;       // the block's columns

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / kHalves - 1 - blockIdx.x / kHalves) * kPos;
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* dout = a.dout + b * a.d_sb + h * a.d_sh;
  float* dq_out =
      from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st);

  stage_raw<kPos, D, SC, true, kThreads>(qo, q, q0, a.sq, a.q_st);
  stage_raw<kPos, D, SC, true, kThreads>(doo, dout, q0, a.sq, a.d_st);
  cp_async_commit();

  // this thread's two query rows: r and r + 8
  const int r0 = w * 16 + g;
  const int r = q0 + r0;
  float lse2[2], dl[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = r + 8 * hi;
    const long long row = ((long long)b * a.heads + h) * a.sq + qi;
    lse2[hi] = qi < a.sq ? a.lse[row] * kLog2e : 0.f;
    dl[hi] = qi < a.sq ? a.delta[row] : 0.f;
  }

  int nkb = (a.skv + BN - 1) / BN;
  if (a.causal) {
    const long long last_q = (long long)a.q_off + min(q0 + kPos, a.sq) - 1;
    const long long hi = last_q - a.k_off;
    nkb = hi < 0 ? 0 : (int)min((long long)nkb, hi / BN + 1);
  }
  // raw K and V chunk c of key tile kb
  auto stage_keys = [&](int kb, int c) {
    stage_raw<BN, DC, SC, false, kThreads>(
        kr, from_col<SC>(k, c * DC, a.k_st), kb * BN, a.skv, a.k_st);
    stage_raw<BN, DC, SC, false, kThreads>(
        vr, from_col<SC>(v, c * DC, a.v_st), kb * BN, a.skv, a.v_st);
    cp_async_commit();
  };
  if (nkb > 0) stage_keys(0, 0);

  float dq[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;  // this warp's first query

  for (int kb = 0; kb < nkb; ++kb) {
    // S = Q K^T and dP = dO V^T, a chunk of K's and V's columns at a time
    float s[BN / 8][4], dp[BN / 8][4];
    zero2<BN>(s, dp);
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      cp_async_wait_all_threads<0>();  // raw K and V of this chunk
      // the chunk's K^T rows where its columns are the block's
      const int tr = c * DC - col0;
      if (tr >= 0 && tr < DO) {
        split_tile<DC, BN, SC, true, kThreads>(kr, kh, kl, kth + tr * 128,
                                               ktl + tr * 128);
      } else {
        split_tile<DC, BN, SC, false, kThreads>(kr, kh, kl, nullptr,
                                                nullptr);
      }
      split_tile<DC, BN, SC, false, kThreads>(vr, vh, vl, nullptr, nullptr);
      publish_shared();  // the split tiles; the raw ones are free again
      if (c + 1 < kChunks) {
        stage_keys(kb, c + 1);
      } else if (kb + 1 < nkb) {
        stage_keys(kb + 1, 0);
      }
      scores<D, DC, BN, SC, true>(s, dp, qo, doo, smem_u32(kh), smem_u32(kl),
                                  smem_u32(vh), smem_u32(vl), r0, t,
                                  c * (DC / 8));
      if (c + 1 < kChunks) __syncthreads();  // the chunk's tiles are read
    }

    // p and ds, into s; the mask only where a pair of the warp's rows and
    // this key tile can be hidden
    const int k0 = kb * BN;
    const bool edge = k0 + BN > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + BN - 1 > qw + a.diag);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
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
    uint32_t sh[BN / 8][4], sl[BN / 8][4];
    split_acc<BN / 8>(sh, sl, s);
    float dt[DO / 8][4];
    tile_mma<DO, BN / 8>(dt, sh, sl, smem_u32(kth), smem_u32(ktl));
    add_acc<DO>(dq, dt);
    __syncthreads();  // every warp is done with the split tiles
  }

  cp_async_wait_all_threads<0>();  // the owned copy, when no key tile
  float* stg = reinterpret_cast<float*>(sp);
  stage_acc_f32<DO, SC>(stg, dq, r0, t);
  __syncthreads();
  store_out<DO, SC>(dq_out, stg, q0, a.sq, a.o0_st, threadIdx.x);
}

// The dk/dv pass's copy of chunk c of a query tile (queries q0 ..): raw
// Q and dO columns, and with chunk 0 its lse and delta into lses and dls
// (one stage of each)
template <int D, bool SC>
__device__ __forceinline__ void load_q(float* qr, float* dr, float* lses,
                                       float* dls, const float* q,
                                       const float* dout, const float* lse,
                                       const float* delta, int q0, int c,
                                       int sq, long long q_st,
                                       long long d_st) {
  constexpr int BN = stream_len<D, true>(), DC = chunk_cols<D, true>();
  stage_raw<BN, DC, SC, false, 2 * kThreads>(
      qr, from_col<SC>(q, c * DC, q_st), q0, sq, q_st);
  stage_raw<BN, DC, SC, false, 2 * kThreads>(
      dr, from_col<SC>(dout, c * DC, d_st), q0, sq, d_st);
  const int tid = threadIdx.x;
  const int i = tid & (BN - 1);
  const int qi = q0 + i;
  const bool in = qi < sq;
  if (c == 0 && tid < BN) {
    cp_async4(smem_u32(lses + i), in ? lse + qi : lse, in ? 4 : 0);
  } else if (c == 0 && tid < 2 * BN) {
    cp_async4(smem_u32(dls + i), in ? delta + qi : delta, in ? 4 : 0);
  }
  cp_async_commit();
}

// The dk/dv pass runs two warpgroups that share the block's tiles: the
// first forms p^T and accumulates dV, the second forms p^T and ds^T and
// accumulates dK (S^T is computed by both, so no tile passes between
// them), each holding one 64 x D float32 sum.
constexpr int kDkvThreads = 2 * kThreads;

template <int D, bool SC>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_tf32_kernel(Args a) {
  constexpr int BN = stream_len<D, true>();
  // the chunk's columns, the block's dk and dv columns, chunks, halves
  constexpr int DC = chunk_cols<D, true>(), DO = out_cols<D>();
  constexpr int kChunks = D / DC, kHalves = col_halves<D>();
  constexpr int kCB = BN * DC * 4;  // bytes of a chunk's hi or lo tile
  constexpr int kTB = BN * DO * 4;  // bytes of a transposed hi or lo tile
  float* ko = reinterpret_cast<float*>(smem_base());  // owned raw K
  float* vo = ko + kPos * D;                          // owned raw V
  float* qr = vo + kPos * D;                          // raw Q chunk
  float* dr = qr + BN * DC;                           // raw dO chunk
  unsigned char* sp = reinterpret_cast<unsigned char*>(dr + BN * DC);
  unsigned char* qh = sp;                // Q hi, lo: K-major over D
  unsigned char* ql = sp + kCB;
  unsigned char* dh = sp + 2 * kCB;      // dO hi, lo: K-major over D
  unsigned char* dlo = sp + 3 * kCB;
  unsigned char* qth = sp + 4 * kCB;     // Q^T hi, lo: K-major over
  unsigned char* qtl = qth + kTB;        // queries, the block's columns
  unsigned char* dth = qtl + kTB;        // dO^T hi, lo
  unsigned char* dtl = dth + kTB;
  float* lses = reinterpret_cast<float*>(dtl + kTB);  // 2 x BN
  float* dls = lses + 2 * BN;                          // 2 x BN

  const int tid = threadIdx.x;
  const bool dk_group = tid >= kThreads;  // the second warpgroup: dK
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  const int k0 = (blockIdx.x / kHalves) * kPos;
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* dout = a.dout + b * a.d_sb + h * a.d_sh;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.sq;

  stage_raw<kPos, D, SC, true, kDkvThreads>(ko, k, k0, a.skv, a.k_st);
  stage_raw<kPos, D, SC, true, kDkvThreads>(vo, v, k0, a.skv, a.v_st);
  cp_async_commit();

  const int nqb = (a.sq + BN - 1) / BN;
  int lo = 0;
  if (a.causal) {
    // query tile qb reaches this key tile iff its last query position
    // q_off + qb * BN + BN - 1 >= k_off + k0
    const long long need = (long long)a.k_off + k0 - a.q_off - (BN - 1);
    lo = need <= 0 ? 0 : (int)min((long long)nqb, (need + BN - 1) / BN);
  }

  if (lo < nqb) {
    load_q<D, SC>(qr, dr, lses, dls, q, dout, lse, delta, lo * BN, 0, a.sq,
                  a.q_st, a.d_st);
  }

  // this warpgroup's sum: dV or dK
  float acc[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const int r0 = w * 16 + g;
  const int kw = k0 + w * 16;  // this warp's first key

  for (int qb = lo; qb < nqb; ++qb) {
    const int stage = (qb - lo) & 1;
    // S^T = K Q^T and, for dK, dP^T = V dO^T, a chunk of Q's and dO's
    // columns at a time: rows are keys, columns queries
    float s[BN / 8][4], dp[BN / 8][4];
    zero2<BN>(s, dp);
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      cp_async_wait_all_threads<0>();  // raw Q, dO (lse and delta) of qb
      // the chunk's Q^T and dO^T rows where its columns are the block's
      const int tr = c * DC - col0;
      if (tr >= 0 && tr < DO) {
        split_tile<DC, BN, SC, true, kDkvThreads>(qr, qh, ql, qth + tr * 128,
                                                  qtl + tr * 128);
        split_tile<DC, BN, SC, true, kDkvThreads>(dr, dh, dlo, dth + tr * 128,
                                                  dtl + tr * 128);
      } else {
        split_tile<DC, BN, SC, false, kDkvThreads>(qr, qh, ql, nullptr,
                                                   nullptr);
        split_tile<DC, BN, SC, false, kDkvThreads>(dr, dh, dlo, nullptr,
                                                   nullptr);
      }
      publish_shared();
      if (c + 1 < kChunks) {
        load_q<D, SC>(qr, dr, lses + stage * BN, dls + stage * BN, q, dout,
                      lse, delta, qb * BN, c + 1, a.sq, a.q_st, a.d_st);
      } else if (qb + 1 < nqb) {
        load_q<D, SC>(qr, dr, lses + (stage ^ 1) * BN, dls + (stage ^ 1) * BN,
                      q, dout, lse, delta, (qb + 1) * BN, 0, a.sq, a.q_st,
                      a.d_st);
      }
      if (dk_group) {
        scores<D, DC, BN, SC, true>(s, dp, ko, vo, smem_u32(qh), smem_u32(ql),
                                    smem_u32(dh), smem_u32(dlo), r0, t,
                                    c * (DC / 8));
      } else {
        scores<D, DC, BN, SC, false>(s, dp, ko, vo, smem_u32(qh),
                                     smem_u32(ql), smem_u32(dh),
                                     smem_u32(dlo), r0, t, c * (DC / 8));
      }
      if (c + 1 < kChunks) __syncthreads();  // the chunk's tiles are read
    }
    const float* l_t = lses + stage * BN;
    const float* d_t = dls + stage * BN;

    // p^T into s and, for dK, ds^T into s
    const int qc = qb * BN;
    const bool edge = kw + 16 > a.skv || qc + BN > a.sq ||
                      (a.causal && kw + 15 > qc + a.diag);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
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
    uint32_t fh[BN / 8][4], fl[BN / 8][4];
    split_acc<BN / 8>(fh, fl, s);
    float dt[DO / 8][4];
    if (dk_group) {
      tile_mma<DO, BN / 8>(dt, fh, fl, smem_u32(qth), smem_u32(qtl));
    } else {
      tile_mma<DO, BN / 8>(dt, fh, fl, smem_u32(dth), smem_u32(dtl));
    }
    add_acc<DO>(acc, dt);
    __syncthreads();  // every warp is done with the split tiles
  }

  cp_async_wait_all_threads<0>();  // the owned copy, when no query tile
  float* stg = reinterpret_cast<float*>(sp) + dk_group * stg_floats<DO, SC>();
  stage_acc_f32<DO, SC>(stg, acc, r0, t);
  __syncthreads();
  if (dk_group) {
    store_out<DO, SC>(
        from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st), stg,
        k0, a.skv, a.o0_st, tid - kThreads);
  } else {
    store_out<DO, SC>(
        from_col<SC>(a.out1 + b * a.o1_sb + h * a.o1_sh, col0, a.o1_st), stg,
        k0, a.skv, a.o1_st, tid);
  }
}

// dynamic shared memory of a pass (which 0: dq, 1: dk/dv), with room to
// align the tiles to 1024 bytes
template <int D>
constexpr int smem_bytes(int which) {
  constexpr int dq = stream_len<D, false>(), dkv = stream_len<D, true>();
  constexpr int dq_c = chunk_cols<D, false>(), dkv_c = chunk_cols<D, true>();
  constexpr int cols = out_cols<D>();
  // owned raw tiles; a chunk's 2 raw and 4 split tiles of the streamed
  // length; 2 (dq) or 4 (dk/dv) transposed split tiles of the block's
  // columns; lse and delta (dk/dv); alignment
  return 2 * kPos * D * 4 + 1024 +
         (which ? 6 * dkv * dkv_c * 4 + 4 * dkv * cols * 4 + 4 * dkv * 4
                : 6 * dq * dq_c * 4 + 2 * dq * cols * 4);
}

template <int D, bool SC>
int launch(int which, const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_bytes<D>(which);
  auto kernel = which ? flash_bwd_dkv_tf32_kernel<D, SC>
                      : flash_bwd_dq_tf32_kernel<D, SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int len = which ? a.skv : a.sq;
  dim3 grid(col_halves<D>() * ((len + kPos - 1) / kPos), a.heads, batch);
  kernel<<<grid, which ? kDkvThreads : kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The two backward passes in float32, with `mxt_flash_attention_bwd_bf16`'s
// argument list (flash_attention_bwd.cu): which = 0 the dq pass (out0 =
// dq), 1 the dk/dv pass (out0 = dk, out1 = dv); dtype must be 0
// (float32); head_dim 64, 128 or 256; layout 0 (batch, heads, seq, head_dim) or
// 1 (batch, heads, head_dim, seq), strides in elements for the batch, head
// and non-contiguous axes; lse and delta (batch, heads, sq) float32
// contiguous.  Every operand and output must be 16-byte aligned with
// strides that are multiples of 4 elements.
int mxt_flash_attention_bwd_f32(
    int which, int dtype, int head_dim, int layout, const void* q,
    const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* out0, void* out1, int batch, int heads, int sq,
    int skv, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long d_sb, long long d_sh, long long d_st,
    long long o0_sb, long long o0_sh, long long o0_st, long long o1_sb,
    long long o1_sh, long long o1_st, int q_off, int k_off, int causal,
    float scale, void* stream) {
  if ((which != 0 && which != 1) || dtype != 0 ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (layout != 0 && layout != 1) ||
      batch < 0 || heads < 0 || sq < 0 || skv < 0 || batch > 65535 ||
      heads > 65535 || (which == 1 && out1 == nullptr)) {
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
  long long diag = (long long)q_off - k_off;
  diag = diag < -(1LL << 30) ? -(1LL << 30)
                             : (diag > (1LL << 30) ? (1LL << 30) : diag);
  Args a{static_cast<const float*>(q),
         static_cast<const float*>(k),
         static_cast<const float*>(v),
         static_cast<const float*>(dout),
         lse,
         delta,
         static_cast<float*>(out0),
         static_cast<float*>(out1),
         q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
         d_sb, d_sh, d_st, o0_sb, o0_sh, o0_st, o1_sb, o1_sh, o1_st,
         heads, sq, skv, q_off, k_off, causal, (int)diag, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return layout ? launch<64, true>(which, a, batch, s)
                  : launch<64, false>(which, a, batch, s);
  }
  if (head_dim == 128) {
    return layout ? launch<128, true>(which, a, batch, s)
                  : launch<128, false>(which, a, batch, s);
  }
  return layout ? launch<256, true>(which, a, batch, s)
                : launch<256, false>(which, a, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
