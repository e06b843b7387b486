// Fused projection + softmax cross-entropy head in bfloat16 on Hopper's
// tensor cores: the four kernels of fused_ce_f32.cu (modes A, B, C, D)
// for bf16 operands, on `wgmma`, never writing the (tokens x vocab) logits.
//
// Replaces, in bf16, the Pallas kernels of
// mxnet_tpu/ops/pallas_kernels/fused_ce.py: `_fwd_pallas` :155 (A),
// `_bwd_pallas` :289 (D then C), `_fwd_sp_pallas` :520 (B),
// `_bwd_dw_rs_pallas` :700 (C) and `_bwd_dx_rs_pallas` :744 (D).  With x
// (n, d), W (V, d), b (V,), int32 labels, s = x W^T + b in float32
// (masked to -1e30 past V) and dl = (exp(s - lse) - onehot(label)) * r:
//   A  lse = m + log l over the online (m, l), nll = lse - s[label],
//      zeroed on ignored rows;
//   B  lse, the picked logit and dxp = (sum_v p W[v]) / l, float32, with
//      p = exp(s - m) rounded to bf16 before the product and the sum
//      rescaled by exp(m_old - m_new) at each tile;
//   C  dW = dl^T x (dl rounded to bf16 first), db = sum of the float32
//      dl over tokens, both written in bf16;
//   D  dx = dl W (dl rounded to bf16 first), written in bf16.
// The rounding points are the Pallas kernels' and the plain versions'
// (ops/pallas_kernels/fused_ce.py): logits, bias and every sum in
// float32, p and dl rounded to bf16 only as a product's operand.  A label
// < 0 or >= V matches no column.
//
// Bound on the H100: operations.  A is one pass over the logit tiles, 2 n
// V d flops; B, C and D two (S, then coef . streamed), 4 n V d.  At the
// training shape (n = 32768, d = 768, V = 32768) that is 1.65e12 and
// 3.3e12 flops, 1.7 and 3.3 ms at 989 TFLOP/s, on 100 MB of operands.
//
// Design.  One template for all four modes.  A cluster of CL blocks owns
// 64 rows of one matrix (tokens of x for A, B, D; vocabulary rows of W for
// C) and streams 64-row tiles of the other past them in a two-stage
// cp.async ring (the next tile's copies issued after step 2's block
// barrier, which timed faster than issuing them at the top of the tile:
// by either point the other stage's readers are done); every cluster
// walks the streamed matrix in the same order, so a wave's clusters read
// each tile from L2 about together.
// The depth d is cut into 64-column chunks (zero-filled past d) and
// dealt out to the 2 CL warpgroups of the cluster, CPW chunks each
// (block b of the cluster holds columns [2 b CPW 64, 2 (b + 1) CPW 64) of
// both the owned rows and each streamed tile, its warpgroup k the k-th
// half of that).  Per streamed tile each warpgroup
//   1. forms its partial S = owned . streamed^T over its own chunks
//      (m64n64k16, both operands K-major in shared memory);
//   2. adds the other warpgroup's partial (through shared memory) to
//      make the block's pair sum q, and hands q to the other blocks of
//      the cluster through distributed shared memory (at CL = 2 each
//      block stores q into its peer's shared memory, so that no read is
//      remote; past 2 each block stores q in its own and reads all of
//      them); after one cluster barrier the pair sums are added in rank
//      order, so every warpgroup holds the same bits of S;
//   3. runs the mode's epilogue in registers (bias, the mask past V, the
//      label pick, the online (m, l) with row maxima over each row's 4
//      threads, or dl), the same in every warpgroup;
//   4. adds coef . streamed[:, its chunks] to its (64, 64 CPW) float32
//      accumulator, coef (p or dl) packed to bf16 as the register A
//      operand and the streamed tile read MN-major (m64n{64,128,192}k16).
// So S's depth and the accumulator's columns are split the same way: the
// logit pass runs once (no warpgroup recomputes S), and the accumulator,
// 64 x 768 float32 at d = 768 (75% of one SM's registers), is spread
// over a cluster of two SMs: 96 registers a thread.  The cost is the
// exchange of S partials: a block barrier and a cluster barrier a tile,
// 16 KB through the block's shared memory and 16 KB to each other block.
// Widths: d <= 384 takes CL = 1, 768 CL = 2, 1536 CL = 4, 3072 CL = 8
// (CPW 2 or 3, the smallest that holds d).  Past 3072 the clusters of 8
// walk the depth in windows of 3072 columns: window y's cluster keeps the
// accumulator of its columns (a second grid axis) but forms S over every
// window, staging the others' rows a window at a time (no prefetch), so
// each extra window costs one more logit pass (2 n V d flops) for every
// window's cluster and one more read of both operands per tile.
// Shared memory at CPW = 3: owned 48 KB, two streamed stages 96 KB, the
// partials 32 KB, the pair sums 32 KB (two sets, one per tile parity, so
// one cluster barrier a tile suffices), the tile's bias or lse/r/labels
// 1.5 KB: one block of 256 threads an SM.  Ragged edges: rows past n or
// V and columns past d stage as zeros (cp.async zero-fill); columns past
// V score -1e30 and add exact zeros; nothing past n, V or d is written.
// No atomics: dW and db are summed in a fixed order, so two launches give
// the same bits.
//
// Requirements, checked by the wrapper and again here: d a multiple of 8;
// x, W, b, labels, lse and r 16-byte aligned and contiguous.

#include <climits>

#include "wgmma.cuh"

namespace {

constexpr int kCeThreads = 256;  // two warpgroups
constexpr int kWindow = 2 * 8 * 3 * 64;  // the widest cluster's columns
constexpr float kNegInf = -1e30f;
constexpr int kPartFloats = 32 * 128;  // one warpgroup's S fragments
constexpr int kColBytes = 3 * 64 * 4;  // a tile's column vectors

enum Mode { kStats = 0, kSinglePass = 1, kGradW = 2, kGradX = 3 };

struct Args {
  const bf16* x;
  const bf16* w;
  const bf16* b;
  const int* label;
  const float* lse;   // C, D: the forward's lse (n,)
  const float* coef;  // C, D: the per-token coefficient r (n,)
  float* nll;         // A
  float* lse_out;     // A, B
  float* picked;      // B
  float* dxp;         // B (n, d)
  bf16* dx;           // D (n, d)
  bf16* dw;           // C (V, d)
  bf16* db;           // C (V,)
  int n, d, v, ignore_label, use_ignore;
};

// Rows r0 .. r0 + 63 of src (rows_total x d, contiguous), columns c0 ..
// c0 + W - 1, into a shared tile of W columns; zeros past rows_total and
// past d.
template <int W>
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* src,
                                          int r0, int rows_total, int c0,
                                          int d) {
  constexpr int kPerRow = W / 8;
#pragma unroll
  for (int it = 0; it < kTile * kPerRow / kCeThreads; ++it) {
    const int c = threadIdx.x + it * kCeThreads;
    const int s = c / kPerRow, col = (c % kPerRow) * 8;
    const int gcol = c0 + col;
    const bool in = r0 + s < rows_total && gcol < d;
    cp_async16(tile + Tile<W, false>::chunk(s, col),
               in ? src + (long long)(r0 + s) * d + gcol : src, in ? 16 : 0);
  }
}

template <int CPW>
constexpr int smem_bytes() {
  return 3 * Tile<2 * CPW * 64, false>::kBytes + 2 * 2 * kPartFloats * 4 +
         2 * kColBytes + 1024;
}

template <int MODE, int CL, int CPW, bool WIDE>
__global__ void __launch_bounds__(kCeThreads, 1) fused_ce_mma_kernel(Args a) {
  constexpr int W = 2 * CPW * 64;  // this block's columns
  constexpr int CW = CPW * 64;     // this warpgroup's columns
  constexpr int kParts = 2 * CL;
  constexpr bool kOwnW = MODE == kGradW;
  constexpr bool kAcc = MODE != kStats;
  constexpr bool kStatsOut = MODE == kStats || MODE == kSinglePass;
  using T = Tile<W, false>;

  unsigned char* smem = smem_base();
  const uint32_t ot = smem_u32(smem);        // owned columns
  const uint32_t st0 = ot + T::kBytes;       // two streamed stages
  // the warpgroups' partials [warpgroup][8][128] float4, then the pair
  // sums [tile parity][8][128] float4
  float* slots_p = reinterpret_cast<float*>(smem + 3 * T::kBytes);
  const uint32_t pairs = st0 + 2 * T::kBytes + 2 * kPartFloats * 4;
  unsigned char* colv = smem + 3 * T::kBytes + 4 * kPartFloats * 4;
  const uint32_t colv0 = smem_u32(colv);     // [stage] bias, or lse | r | label

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const int o0 = (blockIdx.x / CL) * kTile;
  // WIDE: the cluster's columns are window blockIdx.y of nwin; S sums
  // every window, the accumulator holds this one
  const int nwin = WIDE ? (a.d + CL * W - 1) / (CL * W) : 1;
  const int y = WIDE ? blockIdx.y : 0;
  const int c0 = y * CL * W + rank * W;  // this block's first column
  const int wc0 = c0 + wg * CW;          // this warpgroup's first column
  const bool writer = rank == 0 && wg == 0 && y == 0;  // per-row outputs

  const bf16* own = kOwnW ? a.w : a.x;
  const bf16* str = kOwnW ? a.x : a.w;
  const int n_own = kOwnW ? a.v : a.n;
  const int n_str = kOwnW ? a.n : a.v;
  const int ntiles = (n_str + kTile - 1) / kTile;

  auto load_stage = [&](int tb, int stage) {
    const int s0 = tb * kTile;
    load_rows<W>(st0 + stage * T::kBytes, str, s0, n_str, c0, a.d);
    const uint32_t cv = colv0 + stage * kColBytes;
    if (kOwnW) {  // the tokens' lse, r and labels: 16 chunks each
      if (tid < 48) {
        const int vec = tid >> 4, k = tid & 15;
        const void* src = vec == 0 ? static_cast<const void*>(a.lse)
                          : vec == 1 ? static_cast<const void*>(a.coef)
                                     : static_cast<const void*>(a.label);
        load_vec16(cv + vec * 256 + k * 16, src, s0 + 4 * k, a.n, 4);
      }
    } else if (tid < 8) {  // the vocabulary rows' bias: 8 chunks
      load_vec16(cv + tid * 16, a.b, s0 + 8 * tid, a.v, 2);
    }
  };

  load_rows<W>(ot, own, o0, n_own, c0, a.d);
  cp_async_commit();
  if (!WIDE && ntiles > 0) {
    load_stage(0, 0);
    cp_async_commit();
  }

  // this thread's two rows of every fragment, and what it needs of them;
  // past A (which compares the label with ignore_label) a label outside
  // [0, V) becomes INT_MIN, which no column matches
  const int rl = warp * 16 + g;
  int lab[2];
  float own_lse[2], own_coef[2], own_b[2];  // lse and b times log2(e)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = o0 + rl + 8 * hi;
    const bool in = row < n_own;
    lab[hi] = (!kOwnW && in) ? a.label[row] : INT_MIN;
    if (MODE != kStats && (lab[hi] < 0 || lab[hi] >= a.v)) lab[hi] = INT_MIN;
    own_lse[hi] = (MODE == kGradX && in) ? a.lse[row] * kLog2e : 0.f;
    own_coef[hi] = (MODE == kGradX && in) ? a.coef[row] : 0.f;
    own_b[hi] = (kOwnW && in) ? __bfloat162float(a.b[row]) * kLog2e : 0.f;
  }

  // m is the row's own (the same in the row's 4 threads); l, the pick
  // and db are this thread's share of its 16 columns a tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float pick[2] = {0.f, 0.f}, dbs[2] = {0.f, 0.f};
  float acc[kAcc ? CW / 8 : 1][4];
#pragma unroll
  for (int nt = 0; nt < (kAcc ? CW / 8 : 1); ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int tb = 0; tb < ntiles; ++tb) {
    const int stage = WIDE ? 0 : tb & 1;
    const uint32_t st = st0 + stage * T::kBytes;
    const unsigned char* cv = colv + stage * kColBytes;
    const int s0 = tb * kTile;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (WIDE) {
      // the other windows' part of S first, staged one at a time (owned
      // rows into the second stage, streamed rows into the first), then
      // this window's streamed rows, which stay for the product; each
      // window recomputes what the others' blocks do
      for (int qi = 1; qi < nwin; ++qi) {
        const int cq = ((y + qi) % nwin) * CL * W + rank * W;
        __syncthreads();  // the last readers of both stages are done
        load_rows<W>(st0 + T::kBytes, own, o0, n_own, cq, a.d);
        load_rows<W>(st0, str, s0, n_str, cq, a.d);
        cp_async_commit();
        cp_async_wait_all_threads<0>();
        hold(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) {
          wgmma_ss<64, 0, 0>(
              s, desc_pos<W, false>(st0 + T::kBytes, 0, wg * CW + kk * 16),
              desc_pos<W, false>(st0, 0, wg * CW + kk * 16));
        }
        wgmma_commit();
        wgmma_wait();
        hold(s);
      }
      __syncthreads();
      load_stage(tb, 0);
      cp_async_commit();
    }
    cp_async_wait_all_threads<0>();  // tile tb has landed, and both
                                      // warpgroups are past tile tb - 1

    // 1. this warpgroup's partial S over its CPW chunks
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CW / 16; ++kk) {
      wgmma_ss<64, 0, 0>(s, desc_pos<W, false>(ot, 0, wg * CW + kk * 16),
                         desc_pos<W, false>(st, 0, wg * CW + kk * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);

    // 2. the block's two partials make its pair sum q (a + b = b + a: the
    // same bits in both warpgroups); the cluster's pair sums, added in
    // rank order, make S, the same bits in every block
    {
      float4* mine = reinterpret_cast<float4*>(slots_p + wg * kPartFloats);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mine[nt * 128 + wtid] =
            make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();
    if (!WIDE && tb + 1 < ntiles) {  // the other stage's readers are done
      load_stage(tb + 1, stage ^ 1);
      cp_async_commit();
    }
    {
      const float4* other = reinterpret_cast<const float4*>(
          slots_p + (wg ^ 1) * kPartFloats);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 o = other[nt * 128 + wtid];
        s[nt][0] += o.x, s[nt][1] += o.y, s[nt][2] += o.z, s[nt][3] += o.w;
      }
    }
    const uint32_t pset = pairs + (tb & 1) * (kPartFloats * 4);
    if constexpr (CL == 2) {
      // each warpgroup stores half of q into the peer's set, so that no
      // read is remote; after the cluster barrier, q_0 + q_1 = q_1 + q_0
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // static indices keep s in registers
        if ((nt >> 2) != wg) continue;
        store_remote(pset + (nt * 128 + wtid) * 16, rank ^ 1,
                     make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]));
      }
      cluster_sync<CL>();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 v = load_part<1>(pset + (nt * 128 + wtid) * 16, 0);
        s[nt][0] += v.x, s[nt][1] += v.y, s[nt][2] += v.z, s[nt][3] += v.w;
      }
    } else if constexpr (CL > 2) {
      // each warpgroup stores half of q into its own set; after one
      // cluster barrier every block reads all of them, its own included
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if ((nt >> 2) != wg) continue;
        store_local(pset + (nt * 128 + wtid) * 16,
                    make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]));
      }
      cluster_sync<CL>();
#pragma unroll 1
      for (int r = 0; r < CL; ++r) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 v = load_part<CL>(pset + (nt * 128 + wtid) * 16, r);
          if (r == 0) {
            s[nt][0] = v.x, s[nt][1] = v.y, s[nt][2] = v.z, s[nt][3] = v.w;
          } else {
            s[nt][0] += v.x, s[nt][1] += v.y, s[nt][2] += v.z;
            s[nt][3] += v.w;
          }
        }
      }
    }

    // 3. the epilogue: s becomes p (A, B) or dl (C, D)
    if constexpr (kStatsOut) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float2 bj = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cv + col * 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, j = s0 + col + (e & 1);
          const float x =
              j < a.v ? s[nt][e] + ((e & 1) ? bj.y : bj.x) : kNegInf;
          if ((MODE != kStats || j < a.v) && j == lab[hi]) pick[hi] += x;
          s[nt][e] = x;
          mx[hi] = fmaxf(mx[hi], x);
        }
      }
      float factor[2], ml[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
        const float m_new = fmaxf(m[hi], mx[hi]);
        factor[hi] = exp2_ftz((m[hi] - m_new) * kLog2e);
        m[hi] = m_new;
        ml[hi] = m_new * kLog2e;
        l[hi] *= factor[hi];
      }
      // a masked score (-1e30) gives exactly 0: m is finite from the
      // first tile on, whose column 0 is below V
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          const float p = exp2_ftz(fmaf(s[nt][e], kLog2e, -ml[hi]));
          s[nt][e] = p;
          l[hi] += p;
        }
      if constexpr (MODE == kSinglePass) {
#pragma unroll
        for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= factor[e >> 1];
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        float cb[2], cr[2] = {0.f, 0.f};
        int cl[2] = {0, 0};
        if (kOwnW) {  // the columns are tokens
          const float2 ls = *reinterpret_cast<const float2*>(cv + col * 4);
          const float2 rs = *reinterpret_cast<const float2*>(cv + 256 + col * 4);
          const int2 lb = *reinterpret_cast<const int2*>(cv + 512 + col * 4);
          cb[0] = ls.x, cb[1] = ls.y, cr[0] = rs.x, cr[1] = rs.y;
          cl[0] = lb.x, cl[1] = lb.y;
        } else {  // the columns are vocabulary rows
          const float2 bj = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cv + col * 2));
          cb[0] = bj.x, cb[1] = bj.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, j = s0 + col + (e & 1);
          float dl = 0.f;
          if (kOwnW) {  // owned: vocabulary row o0 + rl + 8 hi; column: token j
            const int vr = o0 + rl + 8 * hi;
            if (vr < a.v && j < a.n) {
              const float p = exp2_ftz(
                  fmaf(s[nt][e], kLog2e, own_b[hi] - cb[e & 1] * kLog2e));
              dl = (p - (cl[e & 1] == vr ? 1.f : 0.f)) * cr[e & 1];
            }
            dbs[hi] += dl;
          } else {  // owned: token o0 + rl + 8 hi; column: vocabulary row j
            if (o0 + rl + 8 * hi < a.n && j < a.v) {
              const float p = exp2_ftz(
                  fmaf(s[nt][e] + cb[e & 1], kLog2e, -own_lse[hi]));
              dl = (p - (lab[hi] == j ? 1.f : 0.f)) * own_coef[hi];
            }
          }
          s[nt][e] = dl;
        }
      }
    }

    // 4. acc += coef . streamed[:, this warpgroup's columns]
    if constexpr (kAcc) {
      uint32_t pa[4][4];
      pack_a<8>(pa, s);
      const uint32_t bt = st + wg * CPW * 8192;
      hold(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs<CW, 1>(acc, pa[j], desc_col<W, false>(bt, j * 16));
      }
      wgmma_commit();
      wgmma_wait();
      hold(acc);
      hold(pa);
    }
  }
  cp_async_wait_all_threads<0>();  // the owned copy, when no tile came
  cluster_sync<CL>();  // no block leaves while another reads its partials

  const int row0 = o0 + rl;
  if constexpr (kStatsOut) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
      pick[hi] += __shfl_xor_sync(0xffffffffu, pick[hi], 1);
      pick[hi] += __shfl_xor_sync(0xffffffffu, pick[hi], 2);
      const int row = row0 + 8 * hi;
      if (writer && t == 0 && row < a.n) {
        const float lse = m[hi] + logf(l[hi]);
        a.lse_out[row] = lse;
        if (MODE == kStats) {
          const bool valid = !(a.use_ignore && lab[hi] == a.ignore_label);
          a.nll[row] = valid ? lse - pick[hi] : 0.f;
        } else {
          a.picked[row] = pick[hi];
        }
      }
    }
  }
  if constexpr (MODE == kSinglePass) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row >= a.n) continue;
      const float inv = 1.f / l[hi];
      float* out = a.dxp + (long long)row * a.d;
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int col = wc0 + nt * 8 + 2 * t;
        if (col < a.d) {
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[nt][2 * hi] * inv, acc[nt][2 * hi + 1] * inv);
        }
      }
    }
  }
  if constexpr (MODE == kGradW || MODE == kGradX) {
    bf16* out = kOwnW ? a.dw : a.dx;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row >= n_own) continue;
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int col = wc0 + nt * 8 + 2 * t;
        if (col < a.d) {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * a.d +
                                             col) =
              __floats2bfloat162_rn(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
        }
      }
    }
  }
  if constexpr (MODE == kGradW) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      dbs[hi] += __shfl_xor_sync(0xffffffffu, dbs[hi], 1);
      dbs[hi] += __shfl_xor_sync(0xffffffffu, dbs[hi], 2);
      const int row = row0 + 8 * hi;
      if (writer && t == 0 && row < a.v) a.db[row] = __float2bfloat16(dbs[hi]);
    }
  }
}

template <int MODE, int CL, int CPW, bool WIDE = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<CPW>();
  auto kern = fused_ce_mma_kernel<MODE, CL, CPW, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int owners = MODE == kGradW ? a.v : a.n;
  cudaLaunchConfig_t cfg = {};
  // WIDE: one cluster per window of the accumulator's columns (A has no
  // accumulator)
  const int windows = WIDE && MODE != kStats ? (a.d + kWindow - 1) / kWindow
                                             : 1;
  cfg.gridDim = dim3(CL * ((owners + kTile - 1) / kTile), windows, 1);
  cfg.blockDim = dim3(kCeThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the smallest cluster, then the fewest chunks a warpgroup, that hold d
template <int MODE>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  const int chunks = (a.d + 63) / 64;
  if (chunks <= 2) return launch<MODE, 1, 1>(a, s);
  if (chunks <= 4) return launch<MODE, 1, 2>(a, s);
  if (chunks <= 6) return launch<MODE, 1, 3>(a, s);
  if (chunks <= 8) return launch<MODE, 2, 2>(a, s);
  if (chunks <= 12) return launch<MODE, 2, 3>(a, s);
  if (chunks <= 16) return launch<MODE, 4, 2>(a, s);
  if (chunks <= 24) return launch<MODE, 4, 3>(a, s);
  if (chunks <= 32) return launch<MODE, 8, 2>(a, s);
  if (chunks <= 48) return launch<MODE, 8, 3>(a, s);
  return launch<MODE, 8, 3, true>(a, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MODE>
int run(int dtype, const Args& a, void* stream) {
  if (dtype != 1 || a.n < 0 || a.v < 1 || a.d < 8 || a.d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((MODE == kGradW ? a.v : a.n) == 0) return 0;
  if (!aligned16(a.x) || !aligned16(a.w) || !aligned16(a.b) ||
      !aligned16(a.label) ||
      ((MODE == kGradW || MODE == kGradX) &&
       (!aligned16(a.lse) || !aligned16(a.coef)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaError_t err =
      launch_d<MODE>(a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

Args make_args(const void* x, const void* w, const void* b, const int* label,
               int n, int d, int v) {
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.label = label;
  a.n = n;
  a.d = d;
  a.v = v;
  return a;
}

}  // namespace

extern "C" {

// The bf16 kernels, with fused_ce_f32.cu's argument lists: dtype must be 1
// (bfloat16) for x (n, d), w (v, d) and b (v,), all contiguous and
// 16-byte aligned; label (n,) int32, lse and r (n,) float32, 16-byte
// aligned; d a multiple of 8.  Each entry launches one kernel
// on the stream and returns its launch error.

// A: nll and lse (n,) float32.
int mxt_fused_ce_fwd_bf16(int dtype, const void* x, const void* w,
                          const void* b, const int* label, float* nll,
                          float* lse, int n, int d, int v, int ignore_label,
                          int use_ignore, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.nll = nll;
  a.lse_out = lse;
  a.ignore_label = ignore_label;
  a.use_ignore = use_ignore;
  return run<kStats>(dtype, a, stream);
}

// B: lse and the picked logit (n,) float32, dxp (n, d) float32.
int mxt_fused_ce_fwd_sp_bf16(int dtype, const void* x, const void* w,
                             const void* b, const int* label, float* lse,
                             float* picked, float* dxp, int n, int d, int v,
                             void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse_out = lse;
  a.picked = picked;
  a.dxp = dxp;
  return run<kSinglePass>(dtype, a, stream);
}

// C: dw (v, d) and db (v,) in bf16, from lse and r (n,) float32.
int mxt_fused_ce_bwd_dw_bf16(int dtype, const void* x, const void* w,
                             const void* b, const int* label,
                             const float* lse, const float* coef, void* dw,
                             void* db, int n, int d, int v, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse = lse;
  a.coef = coef;
  a.dw = static_cast<bf16*>(dw);
  a.db = static_cast<bf16*>(db);
  return run<kGradW>(dtype, a, stream);
}

// D: dx (n, d) in bf16, from lse and r (n,) float32.
int mxt_fused_ce_bwd_dx_bf16(int dtype, const void* x, const void* w,
                             const void* b, const int* label,
                             const float* lse, const float* coef, void* dx,
                             int n, int d, int v, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse = lse;
  a.coef = coef;
  a.dx = static_cast<bf16*>(dx);
  return run<kGradX>(dtype, a, stream);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
