// Building blocks of the bfloat16 kernels on Hopper's tensor cores
// (flash_attention_fwd.cu, flash_attention_bwd.cu, fused_ce_bf16.cu):
// shared operand tiles in the 128-byte swizzle, their cp.async copies in
// and out, the `wgmma` matrix descriptors that read a tile K-major or
// MN-major, the `wgmma` products themselves, and the conversions between
// a float32 accumulator and a bf16 register A operand or a staged output
// tile; and the thread-block-cluster helpers of both fused CE sources
// (fused_ce_bf16.cu, fused_ce_f32.cu).  The float32 kernels' TF32 blocks
// are in tf32.cuh.
//
// A flash block is one warpgroup (4 warps, 128 threads; `load_tile` and
// `store_tile` copy with that many threads), at head_dim 256 one of the
// two blocks that split the output columns (`out_cols`); a fused CE block
// is two,
// with loaders of its own.  Each warp holds 16 rows of every 64-row
// accumulator, in the layout `mma.sync`'s m16n8 fragments have, which is
// also the layout of a register A operand: thread (lane = 4 g + t) of
// warp w holds rows 16 w + g and 16 w + g + 8 and, in each 8-column group
// nt, columns 8 nt + 2 t and 8 nt + 2 t + 1 (x[nt][0..1] the first row,
// x[nt][2..3] the second).
//
// Operand tiles keep an operand as it lies in device memory: a (64, D)
// tile of a D-contiguous operand (layout 0) is D / 64 blocks of [64
// positions][64 columns], a (D, 64) tile of an S-contiguous one (layout
// 1, the dS orientation) is [D][64 positions], rows of 128 bytes either
// way.  Every operand must be 16-byte aligned, its contiguous axis of
// stride 1 and its other strides multiples of 8 elements (`aligned`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // one warpgroup: 4 warps of 16 rows
constexpr int kTile = 64;      // positions a block stages per operand tile
constexpr float kLog2e = 1.4426950408889634f;

// A shared tile of 64 positions by D columns, rows of 128 bytes in the
// 128-byte swizzle (the 16-byte chunk c of row r sits at chunk c ^ (r %
// 8)); 1024-byte aligned.  Layout 0 (SC false): D / 64 blocks of 64 rows
// (positions) by 64 columns, 8 KB apart; layout 1: D rows (columns) of 64
// positions.
template <int D, bool SC>
struct Tile {
  static constexpr int kBytes = kTile * D * 2;
  // byte offset of the 8 elements (s, d .. d + 7), d % 8 == 0 (layout 0),
  // or (s .. s + 7, d), s % 8 == 0 (layout 1)
  static __device__ __forceinline__ uint32_t chunk(int s, int d) {
    if (SC) return d * 128 + ((((s >> 3) ^ d) & 7) << 4);
    return (d >> 6) * 8192 + s * 128 + ((((d >> 3) ^ s) & 7) << 4);
  }
  // byte offset of element (s, d)
  static __device__ __forceinline__ uint32_t at(int s, int d) {
    return SC ? chunk(s & ~7, d) + (s & 7) * 2 : chunk(s, d & ~7) + (d & 7) * 2;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Head widths above 128 (the flash kernels, both dtypes): a 64 x 256
// float32 accumulator is 128 registers a thread, too many beside the
// score tiles, so a block computes one half of the output columns and the
// grid is twice as wide: block x is (tile x / 2, half x % 2).  The scores
// still contract over all D.  The columns a block writes, and the halves:
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}
template <int D>
__host__ __device__ constexpr int col_halves() {
  return D / out_cols<D>();
}

// An operand's columns from c0 on, from its (batch, head) slice at p with
// third stride st: a column offset in layout 0, c0 rows in layout 1
template <bool SC, typename T>
__device__ __forceinline__ T* from_col(T* p, int c0, long long st) {
  return p + (SC ? (long long)c0 * st : (long long)c0);
}

// The shared address of column c0 (a multiple of 64) of a (64, D) bf16
// tile: where an operand over its columns c0 .. starts (`Tile` below)
template <bool SC>
__device__ __forceinline__ uint32_t col_tile(uint32_t tile, int c0) {
  return tile + (SC ? c0 * 128 : (c0 >> 6) * 8192);
}

// 16 bytes from src to shared dst, of which the first `bytes` are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for this thread's copies (all but the newest N groups), make every
// thread's visible to the block and to wgmma's reads
template <int N>
__device__ __forceinline__ void cp_async_wait_all_threads() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The operand whose rows (M or N) are positions s0 .. of a tile at shared
// address `tile` and whose k are columns d0 .. d0 + 15: the Q of Q K^T,
// the K^T of it.  K-major in layout 0; MN-major (transposed) in layout 1,
// where 8-column groups are 1024 bytes apart.
template <int D, bool SC>
__device__ __forceinline__ uint64_t desc_pos(uint32_t tile, int s0, int d0) {
  if (SC) return gmma_desc(tile + d0 * 128 + s0 * 2, 8192, 1024);
  return gmma_desc(tile + (d0 >> 6) * 8192 + s0 * 128 + (d0 & 63) * 2, 16,
                   1024);
}

// The operand whose k are positions s0 .. s0 + 15 and whose n are all D
// columns: the K of ds K.  MN-major in layout 0 (64-column blocks 8 KB
// apart, 8-position groups 1024 bytes apart); K-major in layout 1.
template <int D, bool SC>
__device__ __forceinline__ uint64_t desc_col(uint32_t tile, int s0) {
  if (SC) return gmma_desc(tile + s0 * 2, 16, 1024);
  return gmma_desc(tile + s0 * 128, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across the points where it is issued and waited
template <int R>
__device__ __forceinline__ void hold(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void hold(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d (64 x 32) += A (64 x 16, shared) B (16 x 32, shared); TA, TB: the
// operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[4][4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64) += A (64 x 16, shared) B (16 x 64, shared); TA, TB: the
// operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared); TB: B is
// MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared); TB: B is
// MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs128(float (&d)[16][4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d (64 x 192) += A (64 x 16, registers) B (16 x 192, shared); TB: B is
// MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs192(float (&d)[24][4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d (64 x D) += A (64 x 16, registers) B (16 x D, shared)
template <int D, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 192) {
    wgmma_rs192<TB>(d, a, b);
  } else if constexpr (D == 128) {
    wgmma_rs128<TB>(d, a, b);
  } else {
    wgmma_rs64<TB>(d, a, b);
  }
}

// d (64 x N) += A (64 x 16, shared) B (16 x N, shared)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a,
                                         uint64_t b) {
  if constexpr (N == 64) {
    wgmma_ss64<TA, TB>(d, a, b);
  } else {
    wgmma_ss32<TA, TB>(d, a, b);
  }
}

// 2**x, flushing results below 2**-126 to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operands (16 x 16 a warp, 4 registers) of key or query steps of 16
// from a (16, 8 * NT) float32 accumulator, rounded to bf16.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4],
                                       const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    a[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    a[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// Stage positions s0 .. s0 + 63 of an operand (its (batch, head) slice at
// src, third stride st) into a shared tile; positions at or past len read
// as zeros.
template <int D, bool SC>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src,
                                          int s0, int len, long long st) {
  using T = Tile<D, SC>;
  constexpr int kChunks = kTile * D / 8;
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    int s, d, bytes;
    const bf16* from;
    if (SC) {
      d = c / (kTile / 8);
      s = (c % (kTile / 8)) * 8;
      const int left = len - (s0 + s);
      bytes = left >= 8 ? 16 : (left > 0 ? 2 * left : 0);
      from = src + (long long)d * st + (s0 + s);
    } else {
      s = c / (D / 8);
      d = (c % (D / 8)) * 8;
      bytes = s0 + s < len ? 16 : 0;
      from = src + (long long)(s0 + s) * st + d;
    }
    cp_async16(tile + T::chunk(s, d), bytes ? from : src, bytes);
  }
}

// A staged tile's positions 0 .. 63 to positions s0 .. s0 + 63 of dst
// (those below len).
template <int D, bool SC>
__device__ __forceinline__ void store_tile(bf16* dst, const unsigned char* tile,
                                           int s0, int len, long long st) {
  using T = Tile<D, SC>;
  constexpr int kChunks = kTile * D / 8;
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    int s, d;
    if (SC) {
      d = c / (kTile / 8);
      s = (c % (kTile / 8)) * 8;
    } else {
      s = c / (D / 8);
      d = (c % (D / 8)) * 8;
    }
    const int left = len - (s0 + s);
    if (left <= 0) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + T::chunk(s, d));
    if (SC) {
      bf16* to = dst + (long long)d * st + (s0 + s);
      if (left >= 8) {
        *reinterpret_cast<uint4*>(to) = v;
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        for (int i = 0; i < left; ++i) to[i] = e[i];
      }
    } else {
      *reinterpret_cast<uint4*>(dst + (long long)(s0 + s) * st + d) = v;
    }
  }
}

// A warp's 16 rows of a (64, D) float32 accumulator, rounded to bf16, into
// a shared tile (rows r0 .. r0 + 15 are this warp's).
template <int D, bool SC>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[D / 8][4],
                                          int r0, int lane) {
  using T = Tile<D, SC>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int s = r0 + g + 8 * hi;
      const float v0 = acc[nt][2 * hi], v1 = acc[nt][2 * hi + 1];
      if (SC) {
        *reinterpret_cast<bf16*>(tile + T::at(s, d)) = __float2bfloat16(v0);
        *reinterpret_cast<bf16*>(tile + T::at(s, d + 1)) =
            __float2bfloat16(v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(tile + T::at(s, d)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// -- thread block clusters (the fused CE kernels): the block's rank, the
// cluster barrier, and 16-byte stores and loads of shared memory by
// address in any block of the cluster

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: shared-memory writes before
// it are visible to reads after it, in any block of the cluster
template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

__device__ __forceinline__ void store_local(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// 16 bytes to shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ void store_remote(uint32_t addr, uint32_t rank,
                                             float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// 16 bytes at shared address `addr` of block `rank` of the cluster
template <int CL>
__device__ __forceinline__ float4 load_part(uint32_t addr, uint32_t rank) {
  float4 v;
  if constexpr (CL == 1) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(addr)
                 : "memory");
  } else {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(addr), "r"(rank));
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(remote)
                 : "memory");
  }
  return v;
}

// 16 bytes of a vector of `count` elements of `size` bytes from element
// j0, zero-filled past its end
__device__ __forceinline__ void load_vec16(uint32_t dst, const void* src,
                                           int j0, int count, int size) {
  const int left = (count - j0) * size;
  const int bytes = left >= 16 ? 16 : (left > 0 ? left : 0);
  const char* from = static_cast<const char*>(src) + (long long)j0 * size;
  cp_async16(dst, bytes ? from : src, bytes);
}

// the first 1024-byte-aligned byte of dynamic shared memory
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + ((1024 - (a & 1023)) & 1023);
}

// whether an operand can be copied in 16-byte rows: 16-byte aligned, its
// batch, head and third strides multiples of 8 elements
bool aligned(const void* p, long long sb, long long sh, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         sh % 8 == 0 && st % 8 == 0;
}

}  // namespace
