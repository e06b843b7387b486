// Flash-attention forward in bfloat16 on Hopper's tensor cores.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels/flash_attention.py
// in bf16: `_fwd_kernel` :98 (`_flash_fwd_pallas` :155); its dS form
// `_fwd_kernel_ds` :558 (`_flash_fwd_pallas_ds` :623); its bsd form
// `_fwd_kernel_bsd` :937 (`_flash_fwd_pallas_bsd` :988); and its
// grid-streamed bsd form `_fwd_kernel_bsd_gs` :1285
// (`_flash_fwd_pallas_bsd_gs` :1342).  For each (batch, head, query tile)
// it runs the online softmax over the K tiles with float32 (m, l, acc):
//   s   = scale * Q K^T, masked past Skv and, under causal masking, where
//         q_off + i < k_off + j; the K loop stops at the causal diagonal;
//   p   = exp(s - m), exactly 0 wherever a pair is masked;
//   l   = l * exp(m_old - m) + rowsum(p), from the float32 p;
//   acc = acc * exp(m_old - m) + p V, with p rounded to bf16 (round to
//         nearest even) as the mma's operand, the sum in float32;
// then out = acc / l in bf16 and lse = m + log l in float32.  A row that
// sees no key gets out 0 and lse -1e30.  The Pallas kernel keeps p in
// float32 (the TPU's default-precision matmul rounds it to bf16 in the
// product, as here); the scale is applied to the float32 scores, never to
// Q in bf16 (1/sqrt(128) is not a power of two).
//
// Bound on the H100: operations.  The function needs 4 * D flops a
// visible (query, key) pair (Q K^T and P V), which at the training shapes
// is 10-30x the time its bytes (Q, K, V and out once) take at 3.35 TB/s.
//
// Design: `wgmma` (m64nNk16, bf16 in, float32 accumulate), one warpgroup
// of 4 warps a block, one block per (batch, head, 64-query tile), the
// tiles with the longest causal rows launched first.  The Q tile is
// staged once; 64-key K and V tiles stream through a two-stage `cp.async`
// ring of 128-byte-swizzled shared tiles up to the causal diagonal.
// S = Q K^T (m64n64, both operands in shared memory) lands in float32
// registers; the running max is taken over each row's 4 threads (quad
// shuffles) in the log2 domain (scale * log2(e) folded into one multiply,
// then ex2); the mask is applied only on diagonal and ragged tiles.  p,
// packed to bf16 in place, is the register A operand of O += P V
// (m64nD), so P never reaches shared memory.  Each thread keeps partial
// row sums of its own columns and adds its quad's at the end.  The output
// is scaled by 1 / l, staged through the Q tile and stored 16 bytes at a
// time.  Both layouts use the same products: the descriptors read each
// operand K-major or MN-major as it lies (layout 0 (B, H, S, D); layout 1
// the dS orientation (B, H, D, S)), so nothing is transposed by hand.
// Shared memory: 5 tiles of 16 KB at D = 128 (8 KB at 64), two blocks to
// an SM.  No atomics: two launches give the same bits.
//
// Head width 256 (widths 129-255 are zero-padded to it by the wrapper):
// the O accumulator of 64 x 256 would be 128 registers a thread beside
// S's 32, so the grid is twice as wide and each block computes one half
// of O's columns (`out_cols`): S = Q K^T over all 256 columns (recomputed
// by both halves, 1.5x the products of one block), P V over the block's
// 128 columns of V.  Shared memory: Q and two stages of K at 32 KB, two
// stages of V's half at 16 KB: 129 KB, one block an SM.  Both halves make
// the same m and l; the first writes lse.
//
// Requirements, checked by the wrapper (and the alignment again by the C
// entry): every operand 16-byte aligned, its contiguous axis of stride 1
// and its other strides multiples of 8 elements (cp.async copies 16
// bytes); positions past the end are zero-filled, never read.  Element
// offsets are 64-bit.
//
// float32 operands go to flash_attention_fwd_f32.cu, the same online
// softmax on the tensor cores through 3xTF32 (each operand split into two
// TF32 terms, three products for one): one TF32 term (10 mantissa bits)
// would move the served logits past their 1e-3 bar against the plain
// float32 path; three keep the forward within ~1e-6 of it.

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
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
};

template <int D, bool SC>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
    flash_fwd_mma_kernel(Args a) {
  // the output columns this block computes (all D up to 128, a half at
  // 256): V's tiles hold only those
  constexpr int DO = out_cols<D>(), kHalves = col_halves<D>();
  using T = Tile<D, SC>;
  using TV = Tile<DO, SC>;
  unsigned char* qs = smem_base();
  unsigned char* ks = qs + T::kBytes;      // two stages
  unsigned char* vs = ks + 2 * T::kBytes;  // two stages
  const uint32_t qt = smem_u32(qs);
  const uint32_t kt0 = smem_u32(ks), vt0 = smem_u32(vs);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = lane & 3;
  const int col0 = (blockIdx.x % kHalves) * DO;  // the block's columns
  // the last query tiles see the most keys under causal masking: first
  const int q0 = (gridDim.x / kHalves - 1 - blockIdx.x / kHalves) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* v = from_col<SC>(a.v + b * a.v_sb + h * a.v_sh, col0, a.v_st);
  bf16* out = from_col<SC>(a.o + b * a.o_sb + h * a.o_sh, col0, a.o_st);

  load_tile<D, SC>(qt, q, q0, a.sq, a.q_st);
  cp_async_commit();

  int nkb = (a.skv + kTile - 1) / kTile;
  if (a.causal) {
    const long long last_q = (long long)a.q_off + min(q0 + kTile, a.sq) - 1;
    const long long hi = last_q - a.k_off;
    nkb = hi < 0 ? 0 : (int)min((long long)nkb, hi / kTile + 1);
  }
  if (nkb > 0) {
    load_tile<D, SC>(kt0, k, 0, a.skv, a.k_st);
    load_tile<DO, SC>(vt0, v, 0, a.skv, a.v_st);
    cp_async_commit();
  }

  // this thread's two query rows, r and r + 8: their running max (log2
  // domain) and its share of their sums
  const int r = q0 + w * 16 + (lane >> 2);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DO / 8][4];
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const int qw = q0 + w * 16;  // this warp's first query

  for (int kb = 0; kb < nkb; ++kb) {
    const int stage = kb & 1;
    if (kb + 1 < nkb) {
      load_tile<D, SC>(kt0 + (stage ^ 1) * T::kBytes, k, (kb + 1) * kTile,
                       a.skv, a.k_st);
      load_tile<DO, SC>(vt0 + (stage ^ 1) * TV::kBytes, v, (kb + 1) * kTile,
                        a.skv, a.v_st);
      cp_async_commit();
      cp_async_wait_all_threads<1>();
    } else {
      cp_async_wait_all_threads<0>();
    }
    const uint32_t kt = kt0 + stage * T::kBytes;
    const uint32_t vt = vt0 + stage * TV::kBytes;

    // S = Q K^T
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64, SC, SC>(s, desc_pos<D, SC>(qt, 0, kk * 16),
                           desc_pos<D, SC>(kt, 0, kk * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);

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
    for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];

    // O += P V, p rounded to bf16: key steps of 16
    uint32_t pa[4][4];
    pack_a<8>(pa, s);
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs<DO, !SC>(o, pa[j], desc_col<DO, SC>(vt, j * 16));
    }
    wgmma_commit();
    wgmma_wait();
    hold(o);
    hold(pa);
    __syncthreads();  // every warp is done with this stage
  }

  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    inv[hi] = l[hi] == 0.f ? 0.f : 1.f / l[hi];
  }
#pragma unroll
  for (int nt = 0; nt < DO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];

  cp_async_wait_all_threads<0>();  // the Q tile's copy, when no key tile
  stage_acc<DO, SC>(qs, o, w * 16, lane);
  // both halves compute the same m and l: the first writes lse
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
  store_tile<DO, SC>(out, qs, q0, a.sq, a.o_st);
}

template <int D, bool SC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // Q and two stages of K (D columns), two stages of V (the block's
  // columns), and room to align them to 1024
  constexpr int bytes = 3 * Tile<D, SC>::kBytes +
                        2 * Tile<out_cols<D>(), SC>::kBytes + 1024;
  auto kernel = flash_fwd_mma_kernel<D, SC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(col_halves<D>() * ((a.sq + kTile - 1) / kTile), a.heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward in bf16 (`mxt_flash_attention_fwd_f32` in
// flash_attention_fwd_f32.cu takes the same arguments): dtype must be 1
// (bfloat16); head_dim 64, 128 or 256; layout 0 (batch, heads, seq, head_dim)
// or 1 (batch, heads, head_dim, seq), strides in elements for the batch,
// head and non-contiguous axes; lse null or (batch, heads, sq) float32
// contiguous.  Every operand and out must be 16-byte aligned with strides
// that are multiples of 8 elements.
int mxt_flash_attention_fwd_bf16(
    int dtype, int head_dim, int layout, const void* q, const void* k,
    const void* v, void* o, float* lse, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st, int q_off,
    int k_off, int causal, float scale, void* stream) {
  if (dtype != 1 ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (layout != 0 && layout != 1) || batch < 0 || heads < 0 || sq < 0 ||
      skv < 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (!aligned(q, q_sb, q_sh, q_st) || !aligned(k, k_sb, k_sh, k_st) ||
      !aligned(v, v_sb, v_sh, v_st) || !aligned(o, o_sb, o_sh, o_st)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  long long diag = (long long)q_off - k_off;
  diag = diag < -(1LL << 30) ? -(1LL << 30)
                             : (diag > (1LL << 30) ? (1LL << 30) : diag);
  Args a{static_cast<const bf16*>(q),
         static_cast<const bf16*>(k),
         static_cast<const bf16*>(v),
         static_cast<bf16*>(o),
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
  return layout ? launch<256, true>(a, batch, s)
                : launch<256, false>(a, batch, s);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
