// Fused projection + softmax cross-entropy head on Hopper, float32: four
// kernels that never write the (tokens x vocab) logits to device memory.
// bfloat16 operands take fused_ce_bf16.cu's tensor-core kernels instead.
//
// Replaces the Pallas kernels of mxnet_tpu/ops/pallas_kernels/fused_ce.py.
// With x (n, d), W (V, d), b (V,), int32 labels, s = x W^T + b in float32
// (masked to -1e30 past V) and, for the backward, dl = (exp(s - lse) -
// onehot(label)) * r with a per-token coefficient r (`_valid_coef`):
//   A, stats forward   (`_fwd_pallas` / `_fwd_kernel`): per token the
//      online (m, l) over vocabulary tiles and the picked logit a; writes
//      lse = m + log l and nll = lse - a, zeroed on ignored rows;
//   B, single pass     (`_fwd_sp_pallas` / `_fwd_sp_kernel`): the same
//      statistics plus the rescaled accumulator acc * exp(m_prev - m_new)
//      + exp(s - m) W_tile; writes lse, a and dxp = acc / l (n, d);
//   C, dW/db           (`_bwd_dw_rs_pallas` and `_bwd_pallas`'s
//      `_bwd_dw_kernel`): dW = sum over tokens of dl^T x, db = sum of dl;
//   D, dx              (`_bwd_dx_rs_pallas` and `_bwd_pallas`'s
//      `_bwd_dx_kernel`): dx = sum over the vocabulary of dl W.
// A label < 0 or >= V matches no column.  Every sum is float32.
//
// Bound on the H100: operations.  One pass over the logit tiles is
// 2 n V d flops against reading x and W once, so at the training shape
// (n = 32768, d = 768, V = 32768) every kernel needs 1.65e12 (A) or
// 3.3e12 (B, C, D) flops on 200 MB of float32 operands: thousands of
// flops a byte.  These kernels compute on the CUDA cores (67 TFLOP/s
// peak; no mma: the tensor cores' float32 route, TF32, keeps 10 mantissa
// bits and would not hold the 1e-4 checks).
//
// Design.  All four are one kernel template: a block owns 32 rows of one
// matrix (tokens of x for A, B, D; vocabulary rows of W for C), holds
// them in shared memory, and streams 32-row tiles of the other matrix
// past them.  For each tile it computes the 32 x 32 score tile S =
// owned . streamed^T on the CUDA cores (each thread 2 x 2 scores, four
// floats of depth per shared-memory load), applies the mode's epilogue
// in registers (the online softmax, with row maxima across the 16 lanes
// of a row by shuffles; or dl), writes the coefficient tile (p or dl)
// transposed to shared memory, and adds coefficient . streamed to a 32 x
// 32 NC float32 accumulator that lives in registers: thread (rg, cg)
// holds rows 4rg..4rg+3 at columns cg + 32k, k < NC, so NC = 24 covers
// 768 columns in 96 registers.  That is the TPU kernels' VMEM
// accumulator, spread over the register file instead of shared memory.
// The TPU grid's sequential vocabulary axis becomes the loop inside the
// block; C gives each vocabulary tile to one block that loops over every
// token, so dW and db are summed in a fixed order without atomics, like
// the LayerNorm backward.
//
// Widths.  Up to 768 columns a block holds the whole depth (NC = 8, 16 or
// 24), stages its owned rows once, and does each tile's S in one sweep.
// Past 768, d is cut into chunks of 768: the accumulator's columns are
// split over a second grid axis (block y owns chunk y of dxp, dW or dx;
// A needs no accumulator and runs one slice), and S's depth is staged a
// chunk at a time, owned and streamed rows both, the block's own chunk
// last so that it stays in shared memory for coef . streamed.  Each
// extra slice recomputes S: a d of k chunks costs k times the logit pass
// of one.  Ragged edges are masked, not padded: rows past n or V and
// columns past d stage as zeros and are never written; columns past V
// score -1e30 and contribute exact zeros.  Shared memory: (32 + 32) *
// (32 NC + 4) floats plus the coefficient tile, 203 KB at NC = 24, so
// one block of 256 threads runs on each SM.  ptxas's registers and
// spills for each instantiation are in the build log, and chip_smoke.py
// prints them.  The tiles are staged with plain loads (no cp.async
// double buffering).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;         // owned rows a block
constexpr int kTile = 32;         // streamed rows a step
constexpr int kQld = kRows + 4;   // row stride of the coefficient tile
constexpr float kNegInf = -1e30f;

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

// Rows row0 .. row0 + 31 of src (rows_total x d, contiguous), columns c0
// .. c0 + width - 1, into dst (32 x LD floats), zeros past rows_total and
// past width up to LD - 4.  d and width are multiples of 4.
template <int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int rows_total, int c0,
                                           int width, int d) {
  constexpr int kGroups = (LD - 4) / 4;
  for (int idx = threadIdx.x; idx < 32 * kGroups; idx += kThreads) {
    const int rr = idx / kGroups;
    const int c = (idx - rr * kGroups) * 4;
    const int row = row0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows_total && c < width) {
      val = *reinterpret_cast<const float4*>(src + (long long)row * d + c0 +
                                             c);
    }
    *reinterpret_cast<float4*>(dst + rr * LD + c) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kRows + kTile) * (32 * NC + 4) + kTile * kQld +
                          kRows + 4 * kTile);
}

template <int MODE, int NC>
__global__ void __launch_bounds__(kThreads, 1) fused_ce_kernel(Args a) {
  constexpr int kLd = 32 * NC + 4;  // float4-aligned, 4 banks apart a row
  constexpr int kChunk = 32 * NC;   // columns a block holds
  constexpr bool kOwnW = MODE == kGradW;
  constexpr bool kAcc = MODE != kStats;
  extern __shared__ float4 smem4[];
  float* os = reinterpret_cast<float*>(smem4);  // kRows x kLd owned
  float* rs = os + kRows * kLd;                 // kTile x kLd streamed
  float* qt = rs + kTile * kLd;                 // kTile x kQld coefficients
  float* row_f = qt + kTile * kQld;             // kRows: factor, then l
  float* t_bias = row_f + kRows;                // kTile: streamed bias (A B D)
  float* t_lse = t_bias + kTile;                // kTile: streamed lse (C)
  float* t_coef = t_lse + kTile;                // kTile: streamed r (C)
  int* t_lab = reinterpret_cast<int*>(t_coef + kTile);  // kTile (C)

  const float* x = a.x;
  const float* w = a.w;
  const float* bias = a.b;
  const int n_own = kOwnW ? a.v : a.n;
  const int n_str = kOwnW ? a.n : a.v;
  const int o0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rp = tid >> 4, jp = tid & 15;  // scores: rows 2rp+i, cols jp+16jj
  const int rg = tid >> 5, cg = tid & 31;  // accumulator: rows 4rg+rr, cols cg+32k
  // the depth in chunks of kChunk; this block's accumulator holds chunk
  // blockIdx.y, staged last of each tile's chunks
  const int nq = (a.d + kChunk - 1) / kChunk;
  const int y = blockIdx.y;
  const int wc = y * kChunk;
  const bool first = y == 0;  // writes the per-row outputs and db

  if (nq == 1) stage_rows<kLd>(os, kOwnW ? w : x, o0, n_own, 0, a.d, a.d);

  // what each thread needs of its two score rows
  int lab[2];
  float own_lse[2], own_coef[2], own_b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = o0 + 2 * rp + i;
    const bool in = row < n_own;
    lab[i] = (!kOwnW && in) ? a.label[row] : INT_MIN;
    own_lse[i] = (MODE == kGradX && in) ? a.lse[row] : 0.f;
    own_coef[i] = (MODE == kGradX && in) ? a.coef[row] : 0.f;
    own_b[i] = (kOwnW && in) ? bias[row] : 0.f;
  }

  // this thread's share of each row's l, picked logit and db; m is the
  // row's own, the same in all 16 lanes of the row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float pick[2] = {0.f, 0.f}, dbs[2] = {0.f, 0.f};
  float acc[4][NC];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[rr][k] = 0.f;
  }

  const int ntiles = (n_str + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int s0 = t * kTile;
    __syncthreads();  // the last tile's readers of rs, qt and row_f are done
    if (tid < kTile) {
      const int j = s0 + tid;
      const bool in = j < n_str;
      if (kOwnW) {
        t_lse[tid] = in ? a.lse[j] : 0.f;
        t_coef[tid] = in ? a.coef[j] : 0.f;
        t_lab[tid] = in ? a.label[j] : INT_MIN;
      } else {
        t_bias[tid] = in ? bias[j] : 0.f;
      }
    }

    // the score tile, 2 x 2 a thread, a chunk of the depth at a time
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int qi = 0; qi < nq; ++qi) {
      const int q = nq == 1 ? 0 : (y + 1 + qi) % nq;
      const int width = min(kChunk, a.d - q * kChunk);
      if (qi > 0) __syncthreads();  // the last chunk's readers are done
      if (nq > 1) {
        stage_rows<kLd>(os, kOwnW ? w : x, o0, n_own, q * kChunk, width,
                        a.d);
      }
      stage_rows<kLd>(rs, kOwnW ? x : w, s0, n_str, q * kChunk, width, a.d);
      __syncthreads();
      const float* xa = os + (2 * rp) * kLd;
      const float* xb = xa + kLd;
      const float* ya = rs + jp * kLd;
      const float* yb = rs + (jp + 16) * kLd;
#pragma unroll 4
      for (int k = 0; k < width; k += 4) {
        const float4 p0 = *reinterpret_cast<const float4*>(xa + k);
        const float4 p1 = *reinterpret_cast<const float4*>(xb + k);
        const float4 q0 = *reinterpret_cast<const float4*>(ya + k);
        const float4 q1 = *reinterpret_cast<const float4*>(yb + k);
        s[0][0] = fmaf(p0.x, q0.x, s[0][0]);
        s[0][0] = fmaf(p0.y, q0.y, s[0][0]);
        s[0][0] = fmaf(p0.z, q0.z, s[0][0]);
        s[0][0] = fmaf(p0.w, q0.w, s[0][0]);
        s[0][1] = fmaf(p0.x, q1.x, s[0][1]);
        s[0][1] = fmaf(p0.y, q1.y, s[0][1]);
        s[0][1] = fmaf(p0.z, q1.z, s[0][1]);
        s[0][1] = fmaf(p0.w, q1.w, s[0][1]);
        s[1][0] = fmaf(p1.x, q0.x, s[1][0]);
        s[1][0] = fmaf(p1.y, q0.y, s[1][0]);
        s[1][0] = fmaf(p1.z, q0.z, s[1][0]);
        s[1][0] = fmaf(p1.w, q0.w, s[1][0]);
        s[1][1] = fmaf(p1.x, q1.x, s[1][1]);
        s[1][1] = fmaf(p1.y, q1.y, s[1][1]);
        s[1][1] = fmaf(p1.z, q1.z, s[1][1]);
        s[1][1] = fmaf(p1.w, q1.w, s[1][1]);
      }
    }

    if (MODE == kStats || MODE == kSinglePass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sv[2];
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = s0 + jp + 16 * jj;
          const bool ok = c < a.v;
          sv[jj] = ok ? s[i][jj] + t_bias[jp + 16 * jj] : kNegInf;
          if (ok && c == lab[i]) pick[i] += sv[jj];
          mx = fmaxf(mx, sv[jj]);
        }
        const float m_new = fmaxf(m[i], half_warp_max(mx));
        const float factor = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = s0 + jp + 16 * jj;
          const float p = c < a.v ? expf(sv[jj] - m_new) : 0.f;
          psum += p;
          if (MODE == kSinglePass) qt[(jp + 16 * jj) * kQld + 2 * rp + i] = p;
        }
        l[i] = l[i] * factor + psum;
        m[i] = m_new;
        if (MODE == kSinglePass && jp == 0) row_f[2 * rp + i] = factor;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int orow = o0 + 2 * rp + i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = jp + 16 * jj;
          const int scol = s0 + j;
          float dl = 0.f;
          if (kOwnW) {  // owned: vocabulary row orow; streamed: token scol
            if (orow < a.v && scol < a.n) {
              const float p = expf(s[i][jj] + own_b[i] - t_lse[j]);
              dl = (p - (t_lab[j] == orow ? 1.f : 0.f)) * t_coef[j];
            }
            dbs[i] += dl;
          } else {  // owned: token orow; streamed: vocabulary row scol
            if (orow < a.n && scol < a.v) {
              const float p = expf(s[i][jj] + t_bias[j] - own_lse[i]);
              dl = (p - (lab[i] == scol ? 1.f : 0.f)) * own_coef[i];
            }
          }
          qt[j * kQld + 2 * rp + i] = dl;
        }
      }
    }

    if (kAcc) {
      __syncthreads();  // qt and row_f are written
      if (MODE == kSinglePass) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float f = row_f[4 * rg + rr];
#pragma unroll
          for (int k = 0; k < NC; ++k) acc[rr][k] *= f;
        }
      }
#pragma unroll 2
      for (int j = 0; j < kTile; ++j) {
        const float4 q = *reinterpret_cast<const float4*>(qt + j * kQld +
                                                          4 * rg);
        const float* yrow = rs + j * kLd + cg;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float yv = yrow[32 * k];
          acc[0][k] = fmaf(q.x, yv, acc[0][k]);
          acc[1][k] = fmaf(q.y, yv, acc[1][k]);
          acc[2][k] = fmaf(q.z, yv, acc[2][k]);
          acc[3][k] = fmaf(q.w, yv, acc[3][k]);
        }
      }
    }
  }

  if (MODE == kStats || MODE == kSinglePass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = half_warp_sum(l[i]);
      pick[i] = half_warp_sum(pick[i]);
    }
    if (MODE == kSinglePass) __syncthreads();  // the last factors are read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = o0 + 2 * rp + i;
      const float lse = m[i] + logf(l[i]);
      if (first && jp == 0 && row < a.n) {
        a.lse_out[row] = lse;
        if (MODE == kStats) {
          const bool valid = !(a.use_ignore && lab[i] == a.ignore_label);
          a.nll[row] = valid ? lse - pick[i] : 0.f;
        } else {
          a.picked[row] = pick[i];
        }
      }
      if (MODE == kSinglePass && jp == 0) row_f[2 * rp + i] = l[i];
    }
    if (MODE == kSinglePass) {
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int row = o0 + 4 * rg + rr;
        if (row >= a.n) continue;
        const float lr = row_f[4 * rg + rr];
        float* out = a.dxp + (long long)row * a.d;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = wc + cg + 32 * k;
          if (c < a.d) out[c] = acc[rr][k] / lr;
        }
      }
    }
  } else {
    float* out = kOwnW ? a.dw : a.dx;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = o0 + 4 * rg + rr;
      if (row >= n_own) continue;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = wc + cg + 32 * k;
        if (c < a.d) out[(long long)row * a.d + c] = acc[rr][k];
      }
    }
    if (kOwnW) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float total = half_warp_sum(dbs[i]);
        const int row = o0 + 2 * rp + i;
        if (first && jp == 0 && row < a.v) a.db[row] = total;
      }
    }
  }
}

template <int MODE, int NC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>();
  auto kern = fused_ce_kernel<MODE, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int owners = MODE == kGradW ? a.v : a.n;
  // one slice of the accumulator's columns per chunk of the depth; A has
  // no accumulator
  const int slices = MODE == kStats ? 1 : (a.d + 32 * NC - 1) / (32 * NC);
  const dim3 grid((owners + kRows - 1) / kRows, slices);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  if (a.d <= 256) return launch<MODE, 8>(a, stream);
  if (a.d <= 512) return launch<MODE, 16>(a, stream);
  return launch<MODE, 24>(a, stream);
}

template <int MODE>
int run(int dtype, const Args& a, void* stream) {
  if (dtype != 0 || a.n < 0 || a.v < 1 || a.d < 4 || a.d % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((MODE == kGradW ? a.v : a.n) == 0) return 0;
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

// Common arguments: dtype must be 0 (float32) for x (n, d), w (v, d) and b
// (v,), all contiguous, 16-byte aligned; label (n,) int32; d a multiple of
// 4.  Each entry launches one kernel on the stream and returns
// cudaGetLastError().

// A: nll and lse (n,) float32.
int mxt_fused_ce_fwd(int dtype, const void* x, const void* w, const void* b,
                     const int* label, float* nll, float* lse, int n, int d,
                     int v, int ignore_label, int use_ignore, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.nll = nll;
  a.lse_out = lse;
  a.ignore_label = ignore_label;
  a.use_ignore = use_ignore;
  return run<kStats>(dtype, a, stream);
}

// B: lse and the picked logit (n,) float32, dxp (n, d) float32.
int mxt_fused_ce_fwd_sp(int dtype, const void* x, const void* w,
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
int mxt_fused_ce_bwd_dw(int dtype, const void* x, const void* w,
                        const void* b, const int* label, const float* lse,
                        const float* coef, void* dw, void* db, int n, int d,
                        int v, void* stream) {
  Args a = make_args(x, w, b, label, n, d, v);
  a.lse = lse;
  a.coef = coef;
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  return run<kGradW>(dtype, a, stream);
}

// D: dx (n, d) float32, from lse and r (n,) float32.
int mxt_fused_ce_bwd_dx(int dtype, const void* x, const void* w,
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
