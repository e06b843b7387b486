// Fused projection + softmax cross-entropy head in float32 on Hopper's
// tensor cores, through 3xTF32: the four kernels of the head (modes A, B,
// C, D) for float32 operands, on `wgmma`, never writing the (tokens x
// vocab) logits.  bfloat16 operands take fused_ce_bf16.cu.
//
// Replaces, in float32, the Pallas kernels of
// mxnet_tpu/ops/pallas_kernels/fused_ce.py: `_fwd_pallas` :155 (A),
// `_bwd_pallas` :289 (D then C), `_fwd_sp_pallas` :520 (B),
// `_bwd_dw_rs_pallas` :700 (C) and `_bwd_dx_rs_pallas` :744 (D).  With x
// (n, d), W (V, d), b (V,), int32 labels, s = x W^T + b (masked to -1e30
// past V) and dl = (exp(s - lse) - onehot(label)) * r:
//   A  lse = m + log l over the online (m, l), nll = lse - s[label],
//      zeroed on ignored rows;
//   B  lse, the picked logit and dxp = (sum_v p W[v]) / l, with p =
//      exp(s - m) and the sum rescaled by exp(m_old - m_new) each tile;
//   C  dW = dl^T x, db = sum of dl over tokens;
//   D  dx = dl W.
// Every value and sum is float32; outputs are float32.  A label < 0 or
// >= V matches no column.
//
// 3xTF32 (tf32.cuh): each operand split into hi and lo TF32 terms, each
// product hi hi + hi lo + lo hi, so the products keep float32's accuracy
// on the TF32 tensor cores.
//
// Bound on the H100: operations.  A is one pass over the logit tiles, 2 n
// V d flops; B, C and D two (S, then coef . streamed), 4 n V d; 3xTF32
// triples each, at 495 TFLOP/s of TF32.  At the training shape (n =
// 32768, d = 768, V = 32768): 3 x 1.65e12 and 3 x 3.3e12 flops, 10.0 and
// 20.0 ms, 2.5x under what float32 on the CUDA cores (67 TFLOP/s) could
// reach; 201 MB of operands, 0.06 ms at 3.35 TB/s.
//
// Design.  One template for all four modes, the shape of fused_ce_bf16.cu:
// a cluster of CL blocks owns 64 rows of one matrix (tokens of x for A, B,
// D; vocabulary rows of W for C) and streams 32-row tiles of the other
// past them; the depth d is dealt out to the cluster's 2 CL warpgroups,
// CW columns each (block b holds columns [2 b CW, 2 (b + 1) CW) of the
// owned rows and of each streamed tile).  Per streamed tile:
//   0. the block splits its columns of the tile (copied raw by cp.async
//      while the tile before computed) into hi and lo tiles K-major over
//      the depth (B of step 1) and K-major over the tile's rows (B of
//      step 4): `wgmma` reads a 32-bit operand from shared memory K-major
//      only, so the streamed tile, contracted over d in step 1 and over
//      its rows in step 4, needs both orientations;
//   1. each warpgroup forms its partial S (64 x 32) = owned . streamed^T
//      over its CW columns (m64n32k8), the owned rows as the register A
//      operand, split from the raw owned tile four k steps at a time (one
//      past 1536 columns, where the registers do not hold four) while
//      the tensor cores run the four before; the hi lo and lo hi terms
//      sum in one accumulator, hi hi in another, added at the end: a
//      third of the roundings toward zero against hi hi;
//   2. the partials meet: the block's two by shared memory, the cluster's
//      pair sums by a reduce-scatter through distributed shared memory
//      (each block sends the pair sums of slice r to block r, adds the
//      rank-ordered pair sums of its own slice and stores that slice of S
//      in every block); every warpgroup holds the same bits of S.  Both
//      rounds' stores are `st.async`, each completing an mbarrier of the
//      block it lands in, which that block waits on: two cluster barriers
//      (release, acquire) a tile took more time than the data they
//      guarded;
//   3. the mode's epilogue in registers (bias, the mask past V, the label
//      pick, the online (m, l) with row maxima over each row's 4 threads,
//      or dl), the same in every warpgroup;
//   4. coef (p or dl) from S's accumulator is the register A operand, its
//      columns read in the slot order, of coef . streamed[:, its columns]
//      (m64n{64,96}k8, the transposed split tile as B), taken in a fresh
//      accumulator (cross terms first) and added to the (64, CW) float32
//      sum in registers, rounded to nearest; B rescales that sum by
//      exp(m_old - m_new) before the add.
// So the logit pass runs once, and no rounding toward zero spans more
// than one warpgroup's columns (S) or one tile (the sums over the
// 32768-50257 streamed rows).
// Cluster and width: CW is 64 or 96 (the 96 x 4 bytes a row that fit the
// shared memory below), CL the smallest of 1, 2, 4, 8 that holds d: d <=
// 192 CL = 1, 384 CL = 2, 768 CL = 4 (the training shape: CW = 96, 4
// SMs a cluster, 32 clusters on the card), 1536 CL = 8.  Past 1536 the
// clusters of 8 walk the depth in windows of 1536 columns: window y's
// cluster keeps the sum of its columns (a second grid axis) but forms S
// over every window, staging the others' rows a window at a time with no
// prefetch, so each extra window costs every window's cluster one more
// partial logit pass: d = 1600 runs 2 windows (S twice, 3 passes for B,
// C, D's 2), d = 4096 3 (4 passes).  A keeps no sum and runs one window's
// clusters.  Shared memory (CW = 96 | 64): the owned raw tile 48 | 32 KB,
// one raw streamed tile 24 | 16 KB (free again once split, so the next
// tile's copy runs during the tile), four split tiles 96 | 64 KB, the
// partials, the pair sums received and S 32 KB, two sets of the tile's
// bias or lse/r/labels 1 KB: 201 | 145 KB, one block of 256 threads an
// SM.  Registers: the (64, CW)
// sum and its fresh copy 2 x 48 a thread at CW = 96, S and the cross
// accumulator 32, the A fragments of the owned rows 16 and of coef 32;
// ptxas's count is in the build log (chip_smoke.py prints it).  Ragged
// edges: rows past n or V and columns past d stage as zeros (cp.async
// zero-fill: a d that is 4 more than a multiple of 8 leaves the last k
// step half zero), columns past V score -1e30 and add exact zeros;
// nothing past n, V or d is written.  No atomics: every sum runs in a
// fixed order, so two launches give the same bits.
//
// Requirements, checked by the C entry (the wrapper passes contiguous,
// 16-byte-aligned operands): d a positive multiple of 4; x, W, b, labels,
// lse and r 16-byte aligned.

#include <climits>

#include "tf32.cuh"

namespace {

constexpr int kCeThreads = 256;     // two warpgroups
constexpr int kRows = 32;           // streamed rows a tile
constexpr int kWindow = 2 * 8 * 96;  // the widest cluster's columns
constexpr float kNegInf = -1e30f;
constexpr int kS4 = kTile * kRows / 4;  // float4 of one S tile (512)
constexpr int kColBytes = 512;      // a tile's column vectors, one set

enum Mode { kStats = 0, kSinglePass = 1, kGradW = 2, kGradX = 3 };

struct Args {
  const float* x;
  const float* w;
  const float* b;
  const int* label;
  const float* lse;   // C, D: the forward's lse (n,)
  const float* coef;  // C, D: the per-token coefficient r (n,)
  float* nll;         // A
  float* lse_out;     // A, B
  float* picked;      // B
  float* dxp;         // B (n, d)
  float* dx;          // D (n, d)
  float* dw;          // C (V, d)
  float* db;          // C (V,)
  int n, d, v, ignore_label, use_ignore;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// -- the exchange's transactions: an mbarrier per round, completed by the
// bytes that the cluster's blocks store into this block's shared memory

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// this block's one arrival of the phase, which then completes once
// `bytes` have landed (they may land before it)
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; the stores that
// completed it are then visible
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes to shared address `addr` of block `rank`, counted on that
// block's mbarrier `bar`
__device__ __forceinline__ void store_counted(uint32_t addr, uint32_t bar,
                                              uint32_t rank, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(cluster_addr(addr, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(cluster_addr(bar, rank))
      : "memory");
}

// Rows r0 .. r0 + ROWS - 1 of src (rows_total x d, contiguous), columns
// c0 .. c0 + W - 1, into a raw tile: the owned one (ROWS = 64, `own_at`)
// or a streamed one (ROWS = 32, `raw_at`); zeros past rows_total and past
// d.  d and c0 are multiples of 4, so a 16-byte chunk is all in or all
// out.
template <int ROWS, int W>
__device__ __forceinline__ void stage_f32(float* tile, const float* src,
                                          int r0, int rows_total, int c0,
                                          int d) {
  constexpr int kChunks = ROWS * W / 4;
  static_assert(kChunks % kCeThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kChunks / kCeThreads; ++it) {
    const int i = threadIdx.x + it * kCeThreads;
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    const int gcol = c0 + c;
    const bool in = r0 + r < rows_total && gcol < d;
    const int off =
        ROWS == kTile ? own_at<W, false>(r, c) : raw_at<W, ROWS, false>(r, c);
    cp_async16(smem_u32(tile + off),
               in ? src + (long long)(r0 + r) * d + gcol : src, in ? 16 : 0);
  }
}

// One group of `partial_scores` (its k steps G g .. G g + G - 1): its
// products from the fragments in cur, then, once the group before (which
// read next) is done, the next group's fragments into next.
template <int W, int CW, int G>
__device__ __forceinline__ void score_group(
    float (&s)[4][4], float (&x)[4][4], uint32_t (&cur)[G][2][4],
    uint32_t (&next)[G][2][4], const float* own, uint32_t nh, uint32_t nl,
    int k0, int g, int r0, int t) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int k = k0 + g * G + j;
    mma_tf32<kRows>(x, cur[j][0], desc_k<kRows>(nl, k));
    mma_tf32<kRows>(x, cur[j][1], desc_k<kRows>(nh, k));
    mma_tf32<kRows>(s, cur[j][0], desc_k<kRows>(nh, k));
  }
  wgmma_commit();
  if (g + 1 < CW / 8 / G) {
    wgmma_wait1();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      hold(next[j]);
      owned_frag<W, false>(own, k0 + (g + 1) * G + j, r0, t, next[j][0],
                           next[j][1]);
    }
  }
}

// s += own[:, 8 k0 ..] . streamed[:, 8 k0 ..]^T over this warpgroup's CW
// columns (64 x 32), in 3xTF32: own the raw owned tile (A, split G k steps
// at a time into two register buffers, the next group's while this
// group's products run), the streamed rows the split tiles nh, nl K-major
// over the block's columns (B).  The cross terms and hi hi sum in two
// accumulators, added to s at the end rounded to nearest.
template <int W, int CW, int G>
__device__ __forceinline__ void partial_scores(float (&s)[4][4],
                                               const float* own, uint32_t nh,
                                               uint32_t nl, int k0, int r0,
                                               int t) {
  constexpr int kGroups = CW / 8 / G;
  static_assert(kGroups * G * 8 == CW, "whole groups of k steps");
  float hh[4][4], x[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[nt][e] = x[nt][e] = 0.f;
  uint32_t a0[G][2][4], a1[G][2][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    owned_frag<W, false>(own, k0 + j, r0, t, a0[j][0], a0[j][1]);
  }
  hold(hh);
  hold(x);
#pragma unroll
  for (int g = 0; g < kGroups; g += 2) {
    score_group<W, CW, G>(hh, x, a0, a1, own, nh, nl, k0, g, r0, t);
    if (g + 1 < kGroups) {
      score_group<W, CW, G>(hh, x, a1, a0, own, nh, nl, k0, g + 1, r0, t);
    }
  }
  wgmma_wait();
  hold(hh);
  hold(x);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    hold(a0[j]);
    hold(a1[j]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += x[nt][e] + hh[nt][e];
}

template <int CW>
constexpr int smem_bytes() {
  // the owned raw tile, one raw streamed tile, four split tiles, the
  // partials, the pair sums received, S, two sets of column vectors, the
  // exchange's two mbarriers, alignment
  return 1024 + (kTile + kRows + 4 * kRows) * 2 * CW * 4 + 4 * kS4 * 16 +
         2 * kColBytes + 16;
}

template <int MODE, int CL, int CW, bool WIDE>
__global__ void __launch_bounds__(kCeThreads, 1) fused_ce_tf32_kernel(Args a) {
  constexpr int W = 2 * CW;  // this block's columns
  constexpr int kSplit = kRows * W * 4;  // bytes of one split tile
  constexpr int kSlice = kS4 / CL;       // float4 of S a block reduces
  constexpr bool kOwnW = MODE == kGradW;
  constexpr bool kAcc = MODE != kStats;
  constexpr bool kStatsOut = MODE == kStats || MODE == kSinglePass;

  float* own = reinterpret_cast<float*>(smem_base());  // owned raw
  float* raw = own + kTile * W;                         // streamed raw
  unsigned char* nat_h = reinterpret_cast<unsigned char*>(raw + kRows * W);
  unsigned char* nat_l = nat_h + kSplit;  // K-major over the depth
  unsigned char* tr_h = nat_l + kSplit;   // K-major over the tile's rows
  unsigned char* tr_l = tr_h + kSplit;
  // the warpgroups' partials [2][kS4], the pair sums received
  // [CL][kSlice], S [kS4]
  float4* part = reinterpret_cast<float4*>(tr_l + kSplit);
  float4* recv = part + 2 * kS4;
  float4* sum = recv + kS4;
  unsigned char* colv = reinterpret_cast<unsigned char*>(sum + kS4);
  // the exchange's rounds: the pair sums received, S received
  const uint32_t recv_bar = smem_u32(colv + 2 * kColBytes);
  const uint32_t sum_bar = recv_bar + 8;

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
  const int k0 = wg * CW / 8;            // ... as a k step of the block's
  const bool writer = rank == 0 && wg == 0 && y == 0;  // per-row outputs

  const float* own_src = kOwnW ? a.w : a.x;
  const float* str = kOwnW ? a.x : a.w;
  const int n_own = kOwnW ? a.v : a.n;
  const int n_str = kOwnW ? a.n : a.v;
  const int ntiles = (n_str + kRows - 1) / kRows;

  // tile tb's raw rows and, into set tb & 1, its column vectors
  auto load_stage = [&](int tb) {
    const int s0 = tb * kRows;
    stage_f32<kRows, W>(raw, str, s0, n_str, c0, a.d);
    const uint32_t cv = smem_u32(colv + (tb & 1) * kColBytes);
    if (kOwnW) {  // the tokens' lse, r and labels: 8 chunks each
      if (tid < 24) {
        const int vec = tid >> 3, k = tid & 7;
        const void* src = vec == 0 ? static_cast<const void*>(a.lse)
                          : vec == 1 ? static_cast<const void*>(a.coef)
                                     : static_cast<const void*>(a.label);
        load_vec16(cv + vec * 128 + k * 16, src, s0 + 4 * k, a.n, 4);
      }
    } else if (tid < 8) {  // the vocabulary rows' bias: 8 chunks
      load_vec16(cv + tid * 16, a.b, s0 + 4 * tid, a.v, 4);
    }
  };

  stage_f32<kTile, W>(own, own_src, o0, n_own, c0, a.d);
  cp_async_commit();
  if (!WIDE && ntiles > 0) {
    load_stage(0);
    cp_async_commit();
  }
  // every block of the cluster runs, its mbarriers ready, before any
  // stores into its shared memory
  if constexpr (CL > 1) {
    if (tid == 0) {
      mbar_init(recv_bar);
      mbar_init(sum_bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync<CL>();
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
    own_b[hi] = (kOwnW && in) ? a.b[row] * kLog2e : 0.f;
  }

  // m is the row's own (the same in the row's 4 threads); l, the pick
  // and db are this thread's share of its 8 columns a tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float pick[2] = {0.f, 0.f}, dbs[2] = {0.f, 0.f};
  float acc[kAcc ? CW / 8 : 1][4];
#pragma unroll
  for (int nt = 0; nt < (kAcc ? CW / 8 : 1); ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // k steps a group of the partial scores (`partial_scores`): four,
  // except past 1536 columns, where the registers do not hold them
  constexpr int kG = WIDE ? 1 : 4;

  for (int tb = 0; tb < ntiles; ++tb) {
    const unsigned char* cv = colv + (tb & 1) * kColBytes;
    const int s0 = tb * kRows;
    float s[4][4] = {};
    if constexpr (WIDE) {
      // the other windows' part of S first, staged one at a time (their
      // owned rows into the transposed split tiles, free until step 0),
      // then this window's streamed rows, which stay for the product;
      // each window recomputes what the others' clusters do
      float* other_own = reinterpret_cast<float*>(tr_h);
      for (int qi = 1; qi < nwin; ++qi) {
        const int cq = ((y + qi) % nwin) * CL * W + rank * W;
        __syncthreads();  // the last readers of every tile are done
        stage_f32<kTile, W>(other_own, own_src, o0, n_own, cq, a.d);
        stage_f32<kRows, W>(raw, str, s0, n_str, cq, a.d);
        cp_async_commit();
        cp_async_wait_all_threads<0>();
        split_tile<W, kRows, false, false, kCeThreads>(raw, nat_h, nat_l,
                                                       nullptr, nullptr);
        publish_shared();
        partial_scores<W, CW, kG>(s, other_own, smem_u32(nat_h),
                                  smem_u32(nat_l), k0, rl, t);
      }
      __syncthreads();
      load_stage(tb);
      cp_async_commit();
    }
    cp_async_wait_all_threads<0>();  // tile tb has landed, and every warp
                                      // is past tile tb - 1

    // 0. this block's columns of the tile, split; the raw tile is then
    // free for the next one's copy
    split_tile<W, kRows, false, kAcc, kCeThreads>(raw, nat_h, nat_l, tr_h,
                                                  tr_l);
    publish_shared();
    if (!WIDE && tb + 1 < ntiles) {
      load_stage(tb + 1);
      cp_async_commit();
    }

    // 1. this warpgroup's partial S over its CW columns
    partial_scores<W, CW, kG>(s, own, smem_u32(nat_h), smem_u32(nat_l), k0,
                              rl, t);

    // 2. the block's two partials make its pair sum (a + b = b + a: the
    // same bits in both warpgroups); the cluster's pair sums, added in
    // rank order by the block that owns each slice, make S, the same bits
    // in every block.  Each round's stores complete an mbarrier of the
    // block they land in (8 KB a round from the cluster).  No buffer is
    // written before its last read: a block sends its next pair sums only
    // after all of S has reached it, which each owner sends after reading
    // the pair sums it received; S lands after the block has sent its
    // pair sums, which it reads after every thread has read the S before.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      part[wg * kS4 + nt * 128 + wtid] =
          make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    }
    __syncthreads();
    if constexpr (CL == 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 o = part[(wg ^ 1) * kS4 + nt * 128 + wtid];
        s[nt][0] += o.x, s[nt][1] += o.y, s[nt][2] += o.z, s[nt][3] += o.w;
      }
    } else {
      const uint32_t parity = tb & 1;
      if (tid == 0) {
        mbar_expect(recv_bar, kS4 * 16);
        mbar_expect(sum_bar, kS4 * 16);
      }
      // reduce-scatter: the pair sum of slice r goes to block r
      const uint32_t recv_u = smem_u32(recv), sum_u = smem_u32(sum);
#pragma unroll
      for (int i = tid; i < kS4; i += kCeThreads) {
        store_counted(recv_u + (rank * kSlice + i % kSlice) * 16, recv_bar,
                      i / kSlice, add4(part[i], part[kS4 + i]));
      }
      mbar_wait(recv_bar, parity);
      // this block's slice of S, from every block's pair sum in rank
      // order, into every block's S
      for (int j = tid; j < kSlice; j += kCeThreads) {
        float4 v = recv[j];
#pragma unroll
        for (int r = 1; r < CL; ++r) v = add4(v, recv[r * kSlice + j]);
#pragma unroll
        for (int r = 0; r < CL; ++r) {
          store_counted(sum_u + (rank * kSlice + j) * 16, sum_bar, r, v);
        }
      }
      mbar_wait(sum_bar, parity);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v = sum[nt * 128 + wtid];
        s[nt][0] = v.x, s[nt][1] = v.y, s[nt][2] = v.z, s[nt][3] = v.w;
      }
    }

    // 3. the epilogue: s becomes p (A, B) or dl (C, D)
    if constexpr (kStatsOut) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float2 bj = *reinterpret_cast<const float2*>(cv + col * 4);
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
      for (int nt = 0; nt < 4; ++nt)
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
      for (int nt = 0; nt < 4; ++nt) {
        const int col = nt * 8 + 2 * t;
        float cb[2], cr[2] = {0.f, 0.f};
        int cl[2] = {0, 0};
        if (kOwnW) {  // the columns are tokens
          const float2 ls = *reinterpret_cast<const float2*>(cv + col * 4);
          const float2 rs =
              *reinterpret_cast<const float2*>(cv + 128 + col * 4);
          const int2 lb = *reinterpret_cast<const int2*>(cv + 256 + col * 4);
          cb[0] = ls.x, cb[1] = ls.y, cr[0] = rs.x, cr[1] = rs.y;
          cl[0] = lb.x, cl[1] = lb.y;
        } else {  // the columns are vocabulary rows
          const float2 bj = *reinterpret_cast<const float2*>(cv + col * 4);
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

    // 4. acc += coef . streamed[:, this warpgroup's columns], the tile's
    // sum in a fresh accumulator, added rounded to nearest
    if constexpr (kAcc) {
      uint32_t ch[4][4], cl[4][4];
      split_acc<4>(ch, cl, s);
      float fresh[CW / 8][4];
      tile_mma<CW, 4>(fresh, ch, cl, smem_u32(tr_h) + wg * CW * 128,
                      smem_u32(tr_l) + wg * CW * 128);
      add_acc<CW>(acc, fresh);
    }
  }
  cp_async_wait_all_threads<0>();  // the owned copy, when no tile came
  // no block leaves while a store into its shared memory may be in flight
  cluster_sync<CL>();

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
  if constexpr (kAcc) {
    float* out = MODE == kSinglePass ? a.dxp : (kOwnW ? a.dw : a.dx);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row >= n_own) continue;
      const float inv = MODE == kSinglePass ? 1.f / l[hi] : 1.f;
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int col = wc0 + nt * 8 + 2 * t;
        if (col < a.d) {
          float2 v = make_float2(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
          if (MODE == kSinglePass) v.x *= inv, v.y *= inv;
          *reinterpret_cast<float2*>(out + (long long)row * a.d + col) = v;
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
      if (writer && t == 0 && row < a.v) a.db[row] = dbs[hi];
    }
  }
}

template <int MODE, int CL, int CW, bool WIDE = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<CW>();
  auto kern = fused_ce_tf32_kernel<MODE, CL, CW, WIDE>;
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

// the smallest cluster, then the narrower warpgroup width, that hold d
template <int MODE>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 128) return launch<MODE, 1, 64>(a, s);
  if (a.d <= 192) return launch<MODE, 1, 96>(a, s);
  if (a.d <= 256) return launch<MODE, 2, 64>(a, s);
  if (a.d <= 384) return launch<MODE, 2, 96>(a, s);
  if (a.d <= 512) return launch<MODE, 4, 64>(a, s);
  if (a.d <= 768) return launch<MODE, 4, 96>(a, s);
  if (a.d <= 1024) return launch<MODE, 8, 64>(a, s);
  if (a.d <= kWindow) return launch<MODE, 8, 96>(a, s);
  return launch<MODE, 8, 96, true>(a, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MODE>
int run(int dtype, const Args& a, void* stream) {
  if (dtype != 0 || a.n < 0 || a.v < 1 || a.d < 4 || a.d % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((MODE == kGradW ? a.v : a.n) == 0) return 0;
  if (!aligned16(a.x) || !aligned16(a.w) || !aligned16(a.b) ||
      !aligned16(a.label) ||
      ((MODE == kGradW || MODE == kGradX) &&
       (!aligned16(a.lse) || !aligned16(a.coef)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(
      launch_d<MODE>(a, static_cast<cudaStream_t>(stream)));
}

Args make_args(const void* x, const void* w, const void* b, const int* label,
               int n, int d, int v) {
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.label = label;
  a.n = n;
  a.d = d;
  a.v = v;
  return a;
}

}  // namespace

extern "C" {

// The float32 kernels, with fused_ce_bf16.cu's argument lists: dtype must
// be 0 (float32) for x (n, d), w (v, d) and b (v,), all contiguous and
// 16-byte aligned; label (n,) int32, lse and r (n,) float32, 16-byte
// aligned; d a positive multiple of 4.  Each entry launches one kernel
// on the stream and returns its launch error.

// A: nll and lse (n,) float32.
int mxt_fused_ce_fwd_f32(int dtype, const void* x, const void* w,
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
int mxt_fused_ce_fwd_sp_f32(int dtype, const void* x, const void* w,
                            const void* b, const int* label, float* lse,
                            float* picked, float* dxp, int n, int d, int v,
                            void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse_out = lse;
  a.picked = picked;
  a.dxp = dxp;
  return run<kSinglePass>(dtype, a, stream);
}

// C: dw (v, d) and db (v,) float32, from lse and r (n,) float32.
int mxt_fused_ce_bwd_dw_f32(int dtype, const void* x, const void* w,
                            const void* b, const int* label, const float* lse,
                            const float* coef, void* dw, void* db, int n,
                            int d, int v, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse = lse;
  a.coef = coef;
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  return run<kGradW>(dtype, a, stream);
}

// D: dx (n, d) float32, from lse and r (n,) float32.
int mxt_fused_ce_bwd_dx_f32(int dtype, const void* x, const void* w,
                            const void* b, const int* label, const float* lse,
                            const float* coef, void* dx, int n, int d, int v,
                            void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse = lse;
  a.coef = coef;
  a.dx = static_cast<float*>(dx);
  return run<kGradX>(dtype, a, stream);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
