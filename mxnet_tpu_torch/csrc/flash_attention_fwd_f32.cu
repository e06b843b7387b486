// Flash-attention forward in float32 on Hopper's tensor cores, through
// 3xTF32.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in float32: `_fwd_kernel` :98 (`_flash_fwd_pallas` :155); its dS form
// `_fwd_kernel_ds` :558 (`_flash_fwd_pallas_ds` :623); its bsd form
// `_fwd_kernel_bsd` :937 (`_flash_fwd_pallas_bsd` :988); and its
// grid-streamed bsd form `_fwd_kernel_bsd_gs` :1285
// (`_flash_fwd_pallas_bsd_gs` :1342).  For each (batch, head, query tile)
// it runs the online softmax over the key tiles with float32 (m, l, o):
//   s = Q K^T, one tensor-core sum over D;
//   x = s * scale * log2(e), masked past Skv and, under causal masking,
//       where q_off + i < k_off + j; the key loop stops at the diagonal;
//   p = 2**(x - m), exactly 0 wherever a pair is masked;
//   l = l * 2**(m_old - m) + rowsum(p), from the float32 p;
//   o = o * 2**(m_old - m) + p V, each key tile's p V in a fresh
//       accumulator added to o in float32 registers, rounded to nearest;
// then out = o / l and lse = m ln 2 + ln l.  A row that sees no key gets
// out 0 and lse -1e30, never NaN.  The Pallas kernel scales Q before the
// product; here the scale goes onto the float32 scores, with log2(e), in
// one multiply (the CPU model in tests/test_torch_flash_fwd_f32.py does
// the same).  No atomics: two launches give the same bits.
//
// 3xTF32 (tf32.cuh): every operand x is split into hi = cvt.rna.tf32(x)
// and lo = cvt.rna.tf32(x - hi), and each product is hi hi + hi lo + lo
// hi.  The tensor cores round each sum they add into their accumulator
// toward zero, so S takes its hi lo and lo hi terms first and P V takes
// one key tile (32 keys) a fresh accumulator, never one carried or
// rescaled across tiles: over 8192 keys a carried one would drift.
//
// Bound on the H100: operations.  The function needs 4 * D flops a
// visible (query, key) pair (Q K^T and P V); 3xTF32 triples them, at 495
// TFLOP/s of TF32: the least time is 3 * 4 * D flops a pair at that rate,
// 2.5x below what float32 on the CUDA cores (67 TFLOP/s) could reach.  Q,
// K, V, out and lse once are 10-25x below it at the training shapes.
//
// Design: `wgmma` m64nNk8 tf32, two warpgroups (8 warps) a block, each
// owning 64 of its 128 queries and both sharing every streamed tile; the
// blocks with the longest causal rows launch first.
//   * Q is copied raw once (cp.async, 16 bytes a thread) and split once
//     into hi and lo tiles K-major over D in the 128-byte swizzle: S = Q
//     K^T then reads both operands from shared memory (`wgmma_tf32_ss32`,
//     m64n32k8), so no Q fragment is formed per key tile and all 3 D / 8
//     products of S issue as one group.
//   * Key tiles of 32 stream up to the diagonal: K and V come in raw by
//     cp.async (zero-filled past Skv) into a buffer of their own while the
//     block computes the tile before; then the block's 256 threads split
//     K into hi and lo K-major over D, and V into hi and lo K-major over
//     keys (its key axis in the slot order that makes S's accumulator the
//     A operand of P V).  In layout 1 (the dS orientation, S contiguous)
//     only that pass's reads change.
//   * p is formed in S's registers, split in slot order (`split_acc`) and
//     multiplies V's tile in a fresh accumulator, cross terms first
//     (`tile_mma`, m64nDk8); o = o * corr + tile.
//   * A warpgroup whose 64 rows end before a key tile skips its products.
//   * out is staged through the warpgroup's Q tiles and stored 16 bytes at
//     a time along the layout's contiguous axis; lse likewise where its
//     rows are 16-byte aligned.
// Shared memory (D = 64 | 128): Q split 64 K | 128 K (hi and lo, two
// warpgroups); raw K, V 16 K | 32 K; split K and V 32 K | 64 K; Q's raw
// copy goes through the split tiles' room before the first key tile:
// 112 K | 224 K (+1 K alignment; 227 K is the most a block may take).
// Registers (D = 128): the f32 sum (64 a thread), the tile's fresh
// accumulator (64), S (16) and p's hi and lo (32); ptxas gives 181-224 a
// thread with no spill (181, 185 at D = 64; 221, 224 at 128), so one
// block of 256 threads an SM at either width.  With one warpgroup a block
// (80 K | 160 K) two blocks share an SM at D = 64 and one holds it alone
// at 128, splitting every tile for half the queries: as fast at D = 64,
// 1.4-1.5x slower at 128.  Two warpgroups with two blocks an SM at D = 64
// cap the registers at 128 a thread and spill.  scripts/flash_fwd_f32_ab.py
// times that alternative, and the kernel without its softmax or without
// the split of every key tile after the first, by building edited copies
// of this source.
//
// Head width 256 (widths 129-255 are zero-padded to it by the wrapper),
// `flash_fwd_tf32_wide_kernel`: Q's split tiles for two warpgroups would
// take 256 KB alone, so a block is one warpgroup of 64 queries; K streams
// each key tile in four chunks of 64 columns (raw, then split), S adding
// each chunk's products (its cross terms, then hi hi) in the same
// accumulator; and, as in the bf16 kernel, the grid is twice as wide, each
// block computing one half of O's columns from its half of V
// (`out_cols`).  Shared memory: Q split 128 K, raw K chunk 8 K and V half
// 16 K, split K chunk 16 K and V half 32 K: 200 K (+1 K alignment).  The
// registers are D = 128's.
//
// Requirements, checked by the C entry (the wrapper copies an operand
// that lacks them): every operand and out 16-byte aligned, its contiguous
// axis of stride 1 and its other strides multiples of 4 elements.
// Positions past the end are zero-filled (cp.async's source size), never
// read; nothing past the end is written.  Offsets are 64-bit; the grid is
// (ceil(Sq / 128), H, B) (at D = 256: (2 ceil(Sq / 64), H, B)) with H and
// B at most 65535 (checked).

#include "tf32.cuh"

namespace {

constexpr int kKeys = 32;  // keys a streamed tile

constexpr int kWarpgroups = 2;  // warpgroups a block, 64 queries each
constexpr int NT = kWarpgroups * kThreads;  // threads a block

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
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
};

// bytes of dynamic shared memory of a block: Q split (hi, lo a
// warpgroup), raw K and V, split K and V, and room to align the tiles to
// 1024 bytes
template <int D>
constexpr int smem_bytes() {
  return 2 * kWarpgroups * kPos * D * 4 + 6 * kKeys * D * 4 + 1024;
}

// the number of key tiles that rows first .. last (last excluded, capped
// at Sq) see: up to the causal diagonal of the last of them
__device__ __forceinline__ int key_tiles(const Args& a, int first, int last) {
  const int nkb = (a.skv + kKeys - 1) / kKeys;
  if (first >= a.sq) return 0;
  if (!a.causal) return nkb;
  const long long last_q = (long long)a.q_off + min(last, a.sq) - 1;
  const long long hi = last_q - a.k_off;
  return hi < 0 ? 0 : (int)min((long long)nkb, hi / kKeys + 1);
}

template <int D, bool SC>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tf32_kernel(Args a) {
  constexpr int kQB = kPos * D * 4;   // bytes of a Q hi or lo tile
  constexpr int kKB = kKeys * D * 4;  // bytes of a raw, hi or lo key tile
  unsigned char* base = smem_base();
  // raw K, raw V
  float* kr = reinterpret_cast<float*>(base + 2 * kWarpgroups * kQB);
  float* vr = kr + kKeys * D;
  unsigned char* sp = reinterpret_cast<unsigned char*>(vr + kKeys * D);
  unsigned char* kh = sp;             // K hi, lo: K-major over D
  unsigned char* kl = sp + kKB;
  unsigned char* vth = sp + 2 * kKB;  // V hi, lo: K-major over keys
  unsigned char* vtl = sp + 3 * kKB;
  float* qraw = reinterpret_cast<float*>(sp);  // Q's raw copy, first

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;  // this thread's warpgroup
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kWarpgroups * kPos);
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  float* out = a.o + b * a.o_sb + h * a.o_sh;

#pragma unroll
  for (int i = 0; i < kWarpgroups; ++i) {
    stage_raw<kPos, D, SC, false, NT>(qraw + i * kPos * D, q, q0 + i * kPos,
                                      a.sq, a.q_st);
  }
  cp_async_commit();
  const int nkb = key_tiles(a, q0, q0 + kWarpgroups * kPos);
  // the key tiles this warpgroup's rows see (under causal masking the
  // first warpgroup's end up to 64 keys before the block's)
  const int nkw = key_tiles(a, q0 + wg * kPos, q0 + (wg + 1) * kPos);
  if (nkb > 0) {
    stage_raw<kKeys, D, SC, false, NT>(kr, k, 0, a.skv, a.k_st);
    stage_raw<kKeys, D, SC, false, NT>(vr, v, 0, a.skv, a.v_st);
    cp_async_commit();
  }
  cp_async_wait_all_threads<0>();  // raw Q, and K and V of tile 0
#pragma unroll
  for (int i = 0; i < kWarpgroups; ++i) {
    split_tile<D, kPos, SC, false, NT>(qraw + i * kPos * D,
                                       base + 2 * i * kQB,
                                       base + (2 * i + 1) * kQB, nullptr,
                                       nullptr);
  }
  __syncthreads();  // Q's raw copy is read: its room is the split tiles'

  const uint32_t qh = smem_u32(base + 2 * wg * kQB), ql = qh + kQB;
  const uint32_t khs = smem_u32(kh), kls = smem_u32(kl);
  // this thread's two query rows, r and r + 8: their running max (log2
  // domain) and its share of their sums
  const int r = q0 + wg * kPos + w * 16 + g;
  const int qw = q0 + wg * kPos + w * 16;  // this warp's first query
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int kb = 0; kb < nkb; ++kb) {
    // raw K and V of this tile; every warp is done with the split tiles
    if (kb > 0) cp_async_wait_all_threads<0>();
    split_tile<D, kKeys, SC, false, NT>(kr, kh, kl, nullptr, nullptr);
    split_tile<D, kKeys, SC, true, NT, false>(vr, nullptr, nullptr, vth, vtl);
    publish_shared();  // the split tiles; the raw ones are free again
    if (kb + 1 < nkb) {
      stage_raw<kKeys, D, SC, false, NT>(kr, k, (kb + 1) * kKeys, a.skv,
                                         a.k_st);
      stage_raw<kKeys, D, SC, false, NT>(vr, v, (kb + 1) * kKeys, a.skv,
                                         a.v_st);
      cp_async_commit();
    }
    if (kb >= nkw) continue;  // past this warpgroup's diagonal

    // S = Q K^T over D: the hi lo and lo hi terms, then hi hi
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss32(s, desc_k<kPos>(qh, kk), desc_k<kKeys>(kls, kk));
      wgmma_tf32_ss32(s, desc_k<kPos>(ql, kk), desc_k<kKeys>(khs, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss32(s, desc_k<kPos>(qh, kk), desc_k<kKeys>(khs, kk));
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);

    // scores in the log2 domain, masked only where a pair of the warp's
    // rows and this key tile can be hidden; the tile's row max
    const int k0 = kb * kKeys;
    const bool edge = k0 + kKeys > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kKeys - 1 > qw + a.diag);
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

    // this tile's P V in a fresh accumulator (key steps of 8, p's
    // registers the A operand), then o = o * corr + tile
    uint32_t ph[4][4], pl[4][4];
    split_acc<4>(ph, pl, s);
    float pv[D / 8][4];
    tile_mma<D, 4>(pv, ph, pl, smem_u32(vth), smem_u32(vtl));
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
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
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];

  // every warp is done with its products: the warpgroup's Q tiles take
  // its out, the raw K tile the block's lse
  __syncthreads();
  float* stg = reinterpret_cast<float*>(base + 2 * wg * kQB);
  stage_acc_f32<D, SC>(stg, o, w * 16 + g, t);
  if (t == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      kr[wg * kPos + w * 16 + g + 8 * hi] = lse[hi];
    }
  }
  __syncthreads();
  store_out<D, SC>(out, stg, q0 + wg * kPos, a.sq, a.o_st, tid - wg * kThreads);
  if (a.lse != nullptr && tid < kWarpgroups * kPos / 4) {
    const int i = 4 * tid, left = a.sq - (q0 + i);
    float* to = a.lse + ((long long)b * a.heads + h) * a.sq + q0 + i;
    if (left >= 4 && reinterpret_cast<uintptr_t>(to) % 16 == 0) {
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(kr + i);
    } else {
      for (int j = 0; j < 4 && j < left; ++j) to[j] = kr[i + j];
    }
  }
}

template <int D, bool SC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_fwd_tf32_kernel<D, SC>;
  // above 48 KB only by opt-in; set on every launch, as it holds for the
  // current device only
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kWarpgroups * kPos - 1) / (kWarpgroups * kPos), a.heads,
            batch);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Head width 256: one warpgroup of 64 queries a block (its split Q tiles
// alone take 128 KB), K streamed in chunks of kWideChunk columns, the
// block's half of V's columns (see the file's note)
constexpr int kWideChunk = 64;

constexpr int wide_smem_bytes() {
  // Q split (hi, lo), raw K chunk and V half, split K chunk and V half
  // (hi, lo), alignment
  return 2 * kPos * 256 * 4 + 3 * kKeys * (kWideChunk + out_cols<256>()) * 4 +
         1024;
}

template <bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_wide_kernel(Args a) {
  constexpr int D = 256, kWG = 1, NTW = kThreads;
  // K's chunk columns, the block's output columns (V's), chunks, halves
  constexpr int DC = kWideChunk, DO = out_cols<D>();
  constexpr int kChunks = D / DC, kHalves = col_halves<D>();
  constexpr int kQB = kPos * D * 4;    // bytes of a Q hi or lo tile
  constexpr int kKB = kKeys * DC * 4;  // bytes of a raw, hi or lo K chunk
  constexpr int kVB = kKeys * DO * 4;  // bytes of a raw, hi or lo V tile
  unsigned char* base = smem_base();
  // raw K chunk, raw V columns
  float* kr = reinterpret_cast<float*>(base + 2 * kWG * kQB);
  float* vr = kr + kKeys * DC;
  unsigned char* sp = reinterpret_cast<unsigned char*>(vr + kKeys * DO);
  unsigned char* kh = sp;                // K hi, lo: K-major over D
  unsigned char* kl = sp + kKB;
  unsigned char* vth = sp + 2 * kKB;     // V hi, lo: K-major over keys
  unsigned char* vtl = sp + 2 * kKB + kVB;
  // Q's raw copy, first: 64 KB, more than the split tiles' room, so in
  // all the room from the raw K chunk on
  float* qraw = kr;

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;  // this thread's warpgroup
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / kHalves - 1 - blockIdx.x / kHalves) *
                 (kWG * kPos);
  const int h = blockIdx.y, b = blockIdx.z;

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = from_col<SC>(a.v + b * a.v_sb + h * a.v_sh, col0, a.v_st);
  float* out = from_col<SC>(a.o + b * a.o_sb + h * a.o_sh, col0, a.o_st);

  // raw K chunk c of key tile kb and, with chunk 0, its V columns
  auto stage_keys = [&](int kb, int c) {
    stage_raw<kKeys, DC, SC, false, NTW>(kr, from_col<SC>(k, c * DC, a.k_st),
                                        kb * kKeys, a.skv, a.k_st);
    if (c == 0) {
      stage_raw<kKeys, DO, SC, false, NTW>(vr, v, kb * kKeys, a.skv, a.v_st);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kWG; ++i) {
    stage_raw<kPos, D, SC, false, NTW>(qraw + i * kPos * D, q, q0 + i * kPos,
                                      a.sq, a.q_st);
  }
  cp_async_commit();
  const int nkb = key_tiles(a, q0, q0 + kWG * kPos);
  // the key tiles this warpgroup's rows see (under causal masking the
  // first warpgroup's end up to 64 keys before the block's)
  const int nkw = key_tiles(a, q0 + wg * kPos, q0 + (wg + 1) * kPos);
  cp_async_wait_all_threads<0>();  // raw Q
#pragma unroll
  for (int i = 0; i < kWG; ++i) {
    split_tile<D, kPos, SC, false, NTW>(qraw + i * kPos * D,
                                       base + 2 * i * kQB,
                                       base + (2 * i + 1) * kQB, nullptr,
                                       nullptr);
  }
  __syncthreads();  // Q's raw copy is read: its room is free
  if (nkb > 0) {
    stage_keys(0, 0);
    cp_async_wait_all_threads<0>();
  }

  const uint32_t qh = smem_u32(base + 2 * wg * kQB), ql = qh + kQB;
  const uint32_t khs = smem_u32(kh), kls = smem_u32(kl);
  // this thread's two query rows, r and r + 8: their running max (log2
  // domain) and its share of their sums
  const int r = q0 + wg * kPos + w * 16 + g;
  const int qw = q0 + wg * kPos + w * 16;  // this warp's first query
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int kb = 0; kb < nkb; ++kb) {
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      // raw K chunk (and V) of this tile; every warp is done with the
      // split tiles
      if (kb > 0 || c > 0) cp_async_wait_all_threads<0>();
      split_tile<DC, kKeys, SC, false, NTW>(kr, kh, kl, nullptr, nullptr);
      if (c == 0) {
        split_tile<DO, kKeys, SC, true, NTW, false>(vr, nullptr, nullptr, vth,
                                                   vtl);
      }
      publish_shared();  // the split tiles; the raw ones are free again
      if (c + 1 < kChunks) {
        stage_keys(kb, c + 1);
      } else if (kb + 1 < nkb) {
        stage_keys(kb + 1, 0);
      }
      if (kb >= nkw) continue;  // past this warpgroup's diagonal

      // S += Q K^T over the chunk's columns: the hi lo and lo hi terms,
      // then hi hi
      const int kk0 = c * (DC / 8);
      hold(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        wgmma_tf32_ss32(s, desc_k<kPos>(qh, kk0 + kk), desc_k<kKeys>(kls, kk));
        wgmma_tf32_ss32(s, desc_k<kPos>(ql, kk0 + kk), desc_k<kKeys>(khs, kk));
      }
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        wgmma_tf32_ss32(s, desc_k<kPos>(qh, kk0 + kk), desc_k<kKeys>(khs, kk));
      }
      wgmma_commit();
      wgmma_wait();
      hold(s);
    }
    if (kb >= nkw) continue;

    // the log2-domain scores, masked only where a pair of the warp's rows
    // and this key tile can be hidden; the tile's row max
    const int k0 = kb * kKeys;
    const bool edge = k0 + kKeys > a.skv || qw + 16 > a.sq ||
                      (a.causal && k0 + kKeys - 1 > qw + a.diag);
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

    // the tile's P V in a fresh accumulator (key steps of 8, p's
    // registers the A operand), then o = o * corr + tile
    uint32_t ph[4][4], pl[4][4];
    split_acc<4>(ph, pl, s);
    float pv[DO / 8][4];
    tile_mma<DO, 4>(pv, ph, pl, smem_u32(vth), smem_u32(vtl));
#pragma unroll
    for (int nt = 0; nt < DO / 8; ++nt)
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
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];

  // every warp is done with its products: the warpgroup's Q tiles take
  // its out, the raw K tile the block's lse
  __syncthreads();
  float* stg = reinterpret_cast<float*>(base + 2 * wg * kQB);
  stage_acc_f32<DO, SC>(stg, o, w * 16 + g, t);
  if (t == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      kr[wg * kPos + w * 16 + g + 8 * hi] = lse[hi];
    }
  }
  __syncthreads();
  store_out<DO, SC>(out, stg, q0 + wg * kPos, a.sq, a.o_st,
                    tid - wg * kThreads);
  // both halves make the same m and l: the first writes lse
  if (a.lse != nullptr && col0 == 0 && tid < kWG * kPos / 4) {
    const int i = 4 * tid, left = a.sq - (q0 + i);
    float* to = a.lse + ((long long)b * a.heads + h) * a.sq + q0 + i;
    if (left >= 4 && reinterpret_cast<uintptr_t>(to) % 16 == 0) {
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(kr + i);
    } else {
      for (int j = 0; j < 4 && j < left; ++j) to[j] = kr[i + j];
    }
  }
}

template <bool SC>
int launch_wide(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = wide_smem_bytes();
  auto kernel = flash_fwd_tf32_wide_kernel<SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(col_halves<256>() * ((a.sq + kPos - 1) / kPos), a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward in float32, with `mxt_flash_attention_fwd_bf16`'s argument
// list (flash_attention_fwd.cu): dtype must be 0 (float32); head_dim 64,
// 128 or 256; layout 0 (batch, heads, seq, head_dim) or 1 (batch, heads,
// head_dim, seq), strides in elements for the batch, head and
// non-contiguous axes; lse null or (batch, heads, sq) float32
// contiguous.  Every operand and out must be 16-byte aligned with strides
// that are multiples of 4 elements.
int mxt_flash_attention_fwd_f32(
    int dtype, int head_dim, int layout, const void* q, const void* k,
    const void* v, void* o, float* lse, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st, int q_off,
    int k_off, int causal, float scale, void* stream) {
  if (dtype != 0 ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (layout != 0 && layout != 1) || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (!aligned_f32(q, q_sb, q_sh, q_st) || !aligned_f32(k, k_sb, k_sh, k_st) ||
      !aligned_f32(v, v_sb, v_sh, v_st) || !aligned_f32(o, o_sb, o_sh, o_st)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  long long diag = (long long)q_off - k_off;
  diag = diag < -(1LL << 30) ? -(1LL << 30)
                             : (diag > (1LL << 30) ? (1LL << 30) : diag);
  Args a{static_cast<const float*>(q),
         static_cast<const float*>(k),
         static_cast<const float*>(v),
         static_cast<float*>(o),
         lse,
         q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
         o_sb, o_sh, o_st,
         heads, sq, skv, q_off, k_off, causal, (int)diag, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return layout ? launch<64, true>(a, batch, s)
                  : launch<64, false>(a, batch, s);
  }
  if (head_dim == 128) {
    return layout ? launch<128, true>(a, batch, s)
                  : launch<128, false>(a, batch, s);
  }
  return layout ? launch_wide<true>(a, batch, s) : launch_wide<false>(a, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
