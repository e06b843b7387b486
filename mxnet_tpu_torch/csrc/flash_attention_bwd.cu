// Flash-attention backward in bfloat16 on Hopper's tensor cores.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in bf16: `_bwd_dq_kernel` :268 and `_bwd_dkv_kernel` :316
// (`_flash_bwd_pallas` :372); their dS forms `_bwd_dq_kernel_ds` :687 and
// `_bwd_dkv_kernel_ds` :738 (`_flash_bwd_pallas_ds` :794); their bsd forms
// :1060 and :1105 (`_flash_bwd_pallas_bsd` :1158); and their grid-streamed
// bsd forms :1407 and :1456 (`_flash_bwd_pallas_bsd_gs` :1510).  The two
// kernels compute what those compute:
//   p  = exp(scale * Q K^T - lse), exactly 0 wherever the causal mask, a
//        ragged tail or a query past Sq hides a pair;
//   ds = p * (dO V^T - delta) * scale, delta = rowsum(dO * O) - glse from
//        the caller;
//   p and ds rounded to bf16 (round to nearest even) before
//   dV += p^T dO, dK += ds^T Q and dQ += ds K, every sum in float32,
// at the Pallas kernels' rounding points (`:307-309`, `:354-356`,
// `:360-362`); dq, dk and dv are written in bf16.  The scale is applied to
// the float32 scores, never to Q in bf16 (1/sqrt(128) is not a power of
// two, so a pre-scaled Q would round where the reference does not).
//
// Bound on the H100: operations.  The function needs 10 * D flops a
// visible (query, key) pair (Q K^T once, dO V^T, dV, dK, dQ), which at the
// training shapes is 30-60x the time its bytes take at 3.35 TB/s.  The two
// passes recompute Q K^T and dO V^T (14 * D a pair) and keep no atomics,
// as the TPU has it, so the gradients are deterministic run to run.
//
// Design: `wgmma` (m64nNk16, bf16 in, float32 accumulate), one warpgroup
// of 4 warps a block, operand tiles copied by `cp.async` 16 bytes at a
// time into a two-stage ring of shared tiles in the 128-byte swizzle that
// `wgmma` reads through its matrix descriptors.
//   dq pass:    one block per (batch, head, 64-query tile), the tiles with
//               the longest causal rows launched first.  The Q and dO
//               tiles are staged once; 64-key K and V tiles stream through
//               the ring up to the causal diagonal.  S = Q K^T and
//               dP = dO V^T (m64n64, both operands in shared memory) land
//               in float32 registers, where p and ds are made (masked only
//               on diagonal and ragged tiles); ds, packed to bf16, is the
//               register A operand of dQ += ds K (m64nD).
//   dk/dv pass: one block per (batch, head, 64-key tile); the K and V
//               tiles are staged once, 64-query Q, dO, lse and delta tiles
//               stream through the ring from the first query tile that
//               reaches the key tile.  S^T = K Q^T and dP^T = V dO^T, then
//               p^T and ds^T from registers into dV += p^T dO and
//               dK += ds^T Q.  At D = 128 a query tile goes in two steps of
//               32 queries, so that S^T and dP^T fit beside the dK and dV
//               accumulators (2 * D / 2 floats a thread).
// Each warp of the warpgroup holds 16 rows of every accumulator, in the
// layout `mma.sync`'s m16n8 fragments have, which is also the layout of a
// register A operand: S's registers become dQ's A operand in place.
// Shared tiles keep each operand as it lies in device memory: a (64, D)
// tile of a D-contiguous operand (layout 0) is D / 64 blocks of [64
// positions][64 columns], a (D, 64) tile of an S-contiguous one (layout
// 1, the dS orientation) is [D][64 positions], rows of 128 bytes either
// way.  `wgmma` reads each operand K-major or MN-major as its descriptor
// says, so the two layouts differ only in which operands are read
// MN-major and no element is transposed by hand.  Shared memory: 6 tiles
// of 16 KB at D = 128 (8 KB at 64), plus lse and delta in dk/dv, so two
// blocks share an SM.  Outputs are staged through a tile and stored 16
// bytes at a time.
//
// Head width 256 (widths 129-255 are zero-padded to it by the wrapper):
// dK and dV of 64 x 256 would be 256 float32 registers a thread, and dQ
// 128 beside S and dP, so each pass's grid is twice as wide and a block
// computes one half of its outputs' columns (`out_cols`), as at D = 128
// (dk/dv in query steps of 32): S (S^T) and dP (dP^T) over all 256
// columns, recomputed by both halves, then dQ += ds K, dV += p^T dO and
// dK += ds^T Q over the half's 128 columns of K, dO and Q.  Shared memory:
// 6 tiles of 32 KB, 193 KB (dq) and 193.5 KB (dk/dv), one block an SM.
// The two halves add nothing into a shared sum, so the bits are fixed.
//
// Requirements, checked by the wrapper (and the alignment again by the C
// entry): every operand 16-byte aligned, its contiguous axis of stride 1
// and its other strides multiples of 8 elements (cp.async copies 16
// bytes); positions past the end are zero-filled (cp.async's source
// size), never read.  Offsets are 64-bit.
//
// float32 operands go to flash_attention_bwd_f32.cu, the same passes on
// the tensor cores through 3xTF32: the float32 gradient checks hold the
// kernels to 1e-4 of the plain path, which one TF32 term (10 mantissa
// bits) would miss.

#include "wgmma.cuh"

namespace {

struct Args {
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
  int diag;  // q_off - k_off, clamped to +-2**30: key j is visible to
             // query i iff j <= i + diag
  float scale;
};

template <int D, bool SC>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_bwd_dq_mma_kernel(Args a) {
  // the dq columns this block computes: all D up to 128, a half at 256
  constexpr int DO = out_cols<D>(), kHalves = col_halves<D>();
  using T = Tile<D, SC>;
  unsigned char* qs = smem_base();
  unsigned char* dos = qs + T::kBytes;
  unsigned char* ks = dos + T::kBytes;     // two stages
  unsigned char* vs = ks + 2 * T::kBytes;  // two stages
  const uint32_t qt = smem_u32(qs), dot = smem_u32(dos);
  const uint32_t kt0 = smem_u32(ks), vt0 = smem_u32(vs);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / kHalves - 1 - blockIdx.x / kHalves) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + h * a.v_sh;
  const bf16* dout = a.dout + b * a.d_sb + h * a.d_sh;
  bf16* dq_out =
      from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st);

  load_tile<D, SC>(qt, q, q0, a.sq, a.q_st);
  load_tile<D, SC>(dot, dout, q0, a.sq, a.d_st);
  cp_async_commit();

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

  int nkb = (a.skv + kTile - 1) / kTile;
  if (a.causal) {
    const long long last_q = (long long)a.q_off + min(q0 + kTile, a.sq) - 1;
    const long long hi = last_q - a.k_off;
    nkb = hi < 0 ? 0 : (int)min((long long)nkb, hi / kTile + 1);
  }
  if (nkb > 0) {
    load_tile<D, SC>(kt0, k, 0, a.skv, a.k_st);
    load_tile<D, SC>(vt0, v, 0, a.skv, a.v_st);
    cp_async_commit();
  }

  float dq[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;  // this warp's first query

  for (int kb = 0; kb < nkb; ++kb) {
    const int stage = kb & 1;
    if (kb + 1 < nkb) {
      load_tile<D, SC>(kt0 + (stage ^ 1) * T::kBytes, k, (kb + 1) * kTile,
                       a.skv, a.k_st);
      load_tile<D, SC>(vt0 + (stage ^ 1) * T::kBytes, v, (kb + 1) * kTile,
                       a.skv, a.v_st);
      cp_async_commit();
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t kt = kt0 + stage * T::kBytes;
    const uint32_t vt = vt0 + stage * T::kBytes;

    // S = Q K^T and dP = dO V^T
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        dp[nt][e] = 0.f;
      }
    hold(s);
    hold(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64, SC, SC>(s, desc_pos<D, SC>(qt, 0, kk * 16),
                           desc_pos<D, SC>(kt, 0, kk * 16));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64, SC, SC>(dp, desc_pos<D, SC>(dot, 0, kk * 16),
                           desc_pos<D, SC>(vt, 0, kk * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);
    hold(dp);

    // p and ds, into s; the mask only where a pair of the warp's rows and
    // this key tile can be hidden
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

    // dq += ds K over the block's columns of K, ds rounded to bf16: key
    // steps of 16
    uint32_t da[4][4];
    pack_a<8>(da, s);
    hold(dq);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs<DO, !SC>(dq, da[j],
                        desc_col<DO, SC>(col_tile<SC>(kt, col0), j * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(dq);
    hold(da);
    __syncthreads();  // every warp is done with this stage
  }

  cp_async_wait_all_threads<0>();  // the Q tile's copy, when no key tile
  stage_acc<DO, SC>(qs, dq, w * 16, lane);
  __syncthreads();
  store_tile<DO, SC>(dq_out, qs, q0, a.sq, a.o0_st);
}

template <int D, bool SC>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_bwd_dkv_mma_kernel(Args a) {
  // the dk and dv columns this block computes: all D up to 128, a half at
  // 256
  constexpr int DO = out_cols<D>(), kHalves = col_halves<D>();
  using T = Tile<D, SC>;
  unsigned char* ks = smem_base();
  unsigned char* vs = ks + T::kBytes;
  unsigned char* qs = vs + T::kBytes;       // two stages
  unsigned char* dos = qs + 2 * T::kBytes;  // two stages
  float* lses = reinterpret_cast<float*>(dos + 2 * T::kBytes);  // 2 x 64
  float* dls = lses + 2 * kTile;                                 // 2 x 64
  const uint32_t kt = smem_u32(ks), vt = smem_u32(vs);
  const uint32_t qt0 = smem_u32(qs), dot0 = smem_u32(dos);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  const int k0 = (blockIdx.x / kHalves) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + h * a.v_sh;
  const bf16* dout = a.dout + b * a.d_sb + h * a.d_sh;
  bf16* dk_out =
      from_col<SC>(a.out0 + b * a.o0_sb + h * a.o0_sh, col0, a.o0_st);
  bf16* dv_out =
      from_col<SC>(a.out1 + b * a.o1_sb + h * a.o1_sh, col0, a.o1_st);
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.sq;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.sq;

  load_tile<D, SC>(kt, k, k0, a.skv, a.k_st);
  load_tile<D, SC>(vt, v, k0, a.skv, a.v_st);
  cp_async_commit();

  const int nqb = (a.sq + kTile - 1) / kTile;
  int lo = 0;
  if (a.causal) {
    // query tile qb reaches this key tile iff its last query position
    // q_off + qb * 64 + 63 >= k_off + k0
    const long long need = (long long)a.k_off + k0 - a.q_off - (kTile - 1);
    lo = need <= 0 ? 0
                   : (int)min((long long)nqb, (need + kTile - 1) / kTile);
  }

  // a query tile's Q, dO, lse and delta into ring stage `stage`
  auto load_q = [&](int qb, int stage) {
    const int q0 = qb * kTile;
    load_tile<D, SC>(qt0 + stage * T::kBytes, q, q0, a.sq, a.q_st);
    load_tile<D, SC>(dot0 + stage * T::kBytes, dout, q0, a.sq, a.d_st);
    const int i = threadIdx.x & (kTile - 1);
    const int qi = q0 + i;
    const bool in = qi < a.sq;
    if (threadIdx.x < kTile) {
      cp_async4(smem_u32(lses + stage * kTile + i), in ? lse + qi : lse,
                in ? 4 : 0);
    } else {
      cp_async4(smem_u32(dls + stage * kTile + i), in ? delta + qi : delta,
                in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (lo < nqb) load_q(lo, 0);

  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[nt][e] = 0.f;
      dv[nt][e] = 0.f;
    }

  const float sl2 = a.scale * kLog2e;
  const int kw = k0 + w * 16;  // this warp's first key
  constexpr int kStep = DO == 128 ? 32 : kTile;  // queries a step

  for (int qb = lo; qb < nqb; ++qb) {
    const int stage = (qb - lo) & 1;
    if (qb + 1 < nqb) {
      load_q(qb + 1, stage ^ 1);
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t qt = qt0 + stage * T::kBytes;
    const uint32_t dot = dot0 + stage * T::kBytes;
    const float* l_t = lses + stage * kTile;
    const float* d_t = dls + stage * kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      // S^T = K Q^T and dP^T = V dO^T over queries c0 .. c0 + kStep - 1
      float s[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
      for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = 0.f;
          dp[nt][e] = 0.f;
        }
      hold(s);
      hold(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kStep, SC, SC>(s, desc_pos<D, SC>(kt, 0, kk * 16),
                                desc_pos<D, SC>(qt, c0, kk * 16));
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kStep, SC, SC>(dp, desc_pos<D, SC>(vt, 0, kk * 16),
                                desc_pos<D, SC>(dot, c0, kk * 16));
      }
      wgmma_commit();
      wgmma_wait();
      hold(s);
      hold(dp);

      // p^T into s and ds^T into dp: rows are keys, columns queries
      const int qc = qb * kTile + c0;
      const bool edge = kw + 16 > a.skv || qc + kStep > a.sq ||
                        (a.causal && kw + 15 > qc + a.diag);
#pragma unroll
      for (int nt = 0; nt < kStep / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          float p = exp2_ftz(s[nt][e] * sl2 - l_t[col] * kLog2e);
          if (edge) {
            const int qi = qb * kTile + col, kj = kw + g + 8 * (e >> 1);
            const bool ok = qi < a.sq && kj < a.skv &&
                            (!a.causal || kj <= qi + a.diag);
            p = ok ? p : 0.f;
          }
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - d_t[col]) * a.scale;
        }

      // dv += p^T dO and dk += ds^T Q, p and ds rounded to bf16: query
      // steps of 16
      uint32_t pa[kStep / 16][4], sa[kStep / 16][4];
      pack_a<kStep / 8>(pa, s);
      pack_a<kStep / 8>(sa, dp);
      hold(dv);
      hold(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kStep / 16; ++j) {
        wgmma_rs<DO, !SC>(
            dv, pa[j], desc_col<DO, SC>(col_tile<SC>(dot, col0), c0 + j * 16));
        wgmma_rs<DO, !SC>(
            dk, sa[j], desc_col<DO, SC>(col_tile<SC>(qt, col0), c0 + j * 16));
      }
      wgmma_commit();
      wgmma_wait();
      hold(dv);
      hold(dk);
      hold(pa);
      hold(sa);
    }
    __syncthreads();  // every warp is done with this stage
  }

  cp_async_wait_all_threads<0>();  // the K/V copy, when no query tile
  stage_acc<DO, SC>(ks, dk, w * 16, lane);
  stage_acc<DO, SC>(vs, dv, w * 16, lane);
  __syncthreads();
  store_tile<DO, SC>(dk_out, ks, k0, a.skv, a.o0_st);
  store_tile<DO, SC>(dv_out, vs, k0, a.skv, a.o1_st);
}

template <int D, bool SC>
int launch(int which, const Args& a, int batch, cudaStream_t stream) {
  // 6 tiles, lse and delta (dk/dv), and room to align the tiles to 1024
  constexpr int tiles = 6 * Tile<D, SC>::kBytes + 1024;
  const int bytes = which ? tiles + 4 * kTile * (int)sizeof(float) : tiles;
  auto kernel = which ? flash_bwd_dkv_mma_kernel<D, SC>
                      : flash_bwd_dq_mma_kernel<D, SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int len = which ? a.skv : a.sq;
  dim3 grid(col_halves<D>() * ((len + kTile - 1) / kTile), a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The two backward passes in bf16 (`mxt_flash_attention_bwd_f32` in
// flash_attention_bwd_f32.cu takes the same arguments): which = 0 the dq
// pass (out0 = dq), 1 the dk/dv pass (out0 = dk, out1 = dv); dtype must be
// 1 (bfloat16); head_dim 64, 128 or 256; layout 0 (batch, heads, seq,
// head_dim) or 1 (batch, heads, head_dim, seq), strides in elements for
// the batch, head and non-contiguous axes; lse and delta (batch, heads,
// sq) float32 contiguous.  Every operand and output must be 16-byte
// aligned with strides that are multiples of 8 elements.
int mxt_flash_attention_bwd_bf16(
    int which, int dtype, int head_dim, int layout, const void* q,
    const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* out0, void* out1, int batch, int heads, int sq,
    int skv, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long d_sb, long long d_sh, long long d_st,
    long long o0_sb, long long o0_sh, long long o0_st, long long o1_sb,
    long long o1_sh, long long o1_st, int q_off, int k_off, int causal,
    float scale, void* stream) {
  if ((which != 0 && which != 1) || dtype != 1 ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (layout != 0 && layout != 1) ||
      batch < 0 || heads < 0 || sq < 0 || skv < 0 || batch > 65535 ||
      heads > 65535 || (which == 1 && out1 == nullptr)) {
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
  long long diag = (long long)q_off - k_off;
  diag = diag < -(1LL << 30) ? -(1LL << 30)
                             : (diag > (1LL << 30) ? (1LL << 30) : diag);
  Args a{static_cast<const bf16*>(q),
         static_cast<const bf16*>(k),
         static_cast<const bf16*>(v),
         static_cast<const bf16*>(dout),
         lse,
         delta,
         static_cast<bf16*>(out0),
         static_cast<bf16*>(out1),
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
