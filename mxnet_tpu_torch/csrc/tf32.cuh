// Building blocks of the float32 kernels on Hopper's tensor cores in
// 3xTF32 (flash_attention_fwd_f32.cu, flash_attention_bwd_f32.cu,
// fused_ce_f32.cu).
//
// 3xTF32.  The tensor cores take float32 only as TF32 (10 mantissa bits).
// Every operand x is split into hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi), both rounded here explicitly (integer operations
// that give the cvt's bits; nothing relies on how the tensor core treats
// the low 13 bits), and each product A B is taken as hi(A) hi(B) + hi(A)
// lo(B) + lo(A) hi(B): the dropped lo lo term and the rounding of lo cost
// about 2**-22 of each product.  The tensor cores round each sum they add
// into their accumulator toward zero, so a long sum is taken a tile at a
// time in a fresh accumulator (its hi lo and lo hi terms first) and added
// to a float32 sum in registers, rounded to nearest (`tile_mma`).
//
// `wgmma` reads a 32-bit operand from shared memory K-major only, so an A
// operand contracted over its rows comes from registers: from an
// accumulator (`split_acc`), whose columns 2 t and 2 t + 1 a TF32 A
// fragment holds as the slots t and t + 4 of its k step of 8 (the slot
// order 0 2 4 6 1 3 5 7, `slot8`), or from a raw float32 tile in shared
// memory, split a k step at a time (`owned_frag`).  Split tiles
// (`split_tile`) are K-major in the 128-byte swizzle (`kmaj`, `desc_k`),
// their k axis in slot order: every B operand, and an A operand that is
// K-major as it lies and read by many products (the forward's Q,
// `wgmma_tf32_ss32`).

#pragma once

#include "wgmma.cuh"

namespace {

// cvt.rna.tf32.f32 on integers: half of the dropped 13 bits added to the
// magnitude, then the mask.  The same bits as the cvt for finite x (the
// operands here are), in two integer operations, where the compiler
// expands the cvt into compares and selects for NaN and infinity.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (at most 2**-22 |x|): both TF32, rounded to nearest, ties
// away from zero
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// wait until at most one committed group of wgmma is pending
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// after generic-proxy writes to shared memory: visible to the block and
// to wgmma's reads
__device__ __forceinline__ void publish_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The slot of position (or column) j in the slot order of its k step of
// 8: slots 0..3 hold 0, 2, 4, 6 and slots 4..7 hold 1, 3, 5, 7, so that
// the accumulator's columns 2 t, 2 t + 1 are an A fragment's slots t,
// t + 4.
__device__ __forceinline__ int slot8(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j >> 1) & 3);
}

// Byte offset of element (r, c) of a K-major float tile of ROWS rows (M or
// N) by its k columns, in the 128-byte swizzle: blocks of 32 columns,
// ROWS * 128 bytes apart, rows of 128 bytes, the 16-byte chunk q of row r
// at chunk q ^ (r % 8).  The tile is 1024-byte aligned.
template <int ROWS>
__device__ __forceinline__ uint32_t kmaj(int r, int c) {
  return (c >> 5) * (ROWS * 128) + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
         (c & 3) * 4;
}

// wgmma's descriptor of k step kk (columns 8 kk .. 8 kk + 7, all ROWS rows)
// of such a tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// d (64 x 32) += A (64 x 8, registers) B (8 x 32, shared), tf32
__device__ __forceinline__ void wgmma_tf32_32(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 8, registers) B (8 x 64, shared), tf32
__device__ __forceinline__ void wgmma_tf32_64(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 96) += A (64 x 8, registers) B (8 x 96, shared), tf32
__device__ __forceinline__ void wgmma_tf32_96(float (&d)[12][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 8, registers) B (8 x 128, shared), tf32
__device__ __forceinline__ void wgmma_tf32_128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 8, shared) B (8 x 32, shared), tf32: both
// K-major
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[4][4], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N) += A (64 x 8, registers) B (8 x N, shared), tf32
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) {
    wgmma_tf32_128(d, a, b);
  } else if constexpr (N == 96) {
    wgmma_tf32_96(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_tf32_64(d, a, b);
  } else {
    wgmma_tf32_32(d, a, b);
  }
}

// d += A B in 3xTF32: hi hi, hi lo, lo hi
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 8][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh,
                                     uint64_t bl) {
  mma_tf32<N>(d, ah, bh);
  mma_tf32<N>(d, ah, bl);
  mma_tf32<N>(d, al, bh);
}

// d = A B over J k steps of 8 (d zeroed first), A in registers (hi, lo)
// and B's hi and lo tiles K-major over the steps (ROWS = N), in 3xTF32:
// the small terms hi lo and lo hi of every step first, then hi hi.  The
// tensor cores round each sum toward zero; this order puts those
// roundings against the large accumulator once a step, not three times,
// and the caller adds d into its float32 sum (rounded to nearest), so no
// rounding toward zero spans more than one tile.
template <int N, int J>
__device__ __forceinline__ void tile_mma(float (&d)[N / 8][4],
                                         uint32_t (&h)[J][4],
                                         uint32_t (&l)[J][4], uint32_t bh,
                                         uint32_t bl) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
  hold(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < J; ++j) {
    mma_tf32<N>(d, h[j], desc_k<N>(bl, j));
    mma_tf32<N>(d, l[j], desc_k<N>(bh, j));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32<N>(d, h[j], desc_k<N>(bh, j));
  wgmma_commit();
  wgmma_wait();
  hold(d);
  hold(h);
  hold(l);
}

// acc += d, rounded to nearest
template <int N>
__device__ __forceinline__ void add_acc(float (&acc)[N / 8][4],
                                        const float (&d)[N / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += d[nt][e];
}

// The A fragments (hi, lo) of the k steps of 8 of a float32 accumulator
// of 64 x (8 NT), its columns read in slot order.
template <int NT>
__device__ __forceinline__ void split_acc(uint32_t (&h)[NT][4],
                                          uint32_t (&l)[NT][4],
                                          const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(x[j][0], h[j][0], l[j][0]);
    split(x[j][2], h[j][1], l[j][1]);
    split(x[j][1], h[j][2], l[j][2]);
    split(x[j][3], h[j][3], l[j][3]);
  }
}

// Float offset of element (position r, column c) of an owned raw tile (64
// positions by D): layout 0 [64][D], layout 1 [D][64], XOR-swizzled so
// that a warp's A fragment loads hit 32 banks.
template <int D, bool SC>
__device__ __forceinline__ int own_at(int r, int c) {
  return SC ? c * kTile + (r ^ (((c >> 1) & 3) << 3))
            : r * D + (c ^ ((r & 3) << 3));
}

// Float offset of element (position r, column c) of a streamed raw tile
// (BN positions by D): layout 0 [BN][D], XOR-swizzled so that the split
// pass's 16-byte reads of 8 rows hit 32 banks; layout 1 [D][BN].
template <int D, int BN, bool SC>
__device__ __forceinline__ int raw_at(int r, int c) {
  return SC ? c * BN + r : r * D + (c ^ ((r & 7) << 2));
}

// Split a streamed raw tile (BN positions by D) into its TF32 hi and lo
// tiles: K-major over D (BN rows; the D axis of each k step in slot
// order; not with NAT false) and, with TR, K-major over positions (D
// rows; positions in slot order).  Each of the block's NT / 32 warps
// takes 32 consecutive positions and 8 columns at a time; where a tile has
// fewer such items than the block has warps, the warps past them idle.
template <int D, int BN, bool SC, bool TR, int NT, bool NAT = true>
__device__ __forceinline__ void split_tile(const float* raw,
                                           unsigned char* nat_hi,
                                           unsigned char* nat_lo,
                                           unsigned char* tr_hi,
                                           unsigned char* tr_lo) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int kBlocks = BN / 32;
  constexpr int kItems = kBlocks * (D / 8);
  static_assert(kItems % kWarps == 0 || kItems < kWarps,
                "whole items a warp");
  constexpr int kRounds = kItems < kWarps ? 1 : kItems / kWarps;
#pragma unroll
  for (int it = 0; it < kRounds; ++it) {
    const int wi = w + kWarps * it;
    if (kItems < kWarps && wi >= kItems) break;
    const int p = (wi % kBlocks) * 32 + lane;
    const int c0 = (wi / kBlocks) * 8;
    float x[8];
    if (SC) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = raw[(c0 + e) * BN + p];
    } else {
      const float4 a =
          *reinterpret_cast<const float4*>(raw + raw_at<D, BN, false>(p, c0));
      const float4 b = *reinterpret_cast<const float4*>(
          raw + raw_at<D, BN, false>(p, c0 + 4));
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    }
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) split(x[e], hi[e], lo[e]);
    if (NAT) {
      *reinterpret_cast<uint4*>(nat_hi + kmaj<BN>(p, c0)) =
          make_uint4(hi[0], hi[2], hi[4], hi[6]);
      *reinterpret_cast<uint4*>(nat_hi + kmaj<BN>(p, c0 + 4)) =
          make_uint4(hi[1], hi[3], hi[5], hi[7]);
      *reinterpret_cast<uint4*>(nat_lo + kmaj<BN>(p, c0)) =
          make_uint4(lo[0], lo[2], lo[4], lo[6]);
      *reinterpret_cast<uint4*>(nat_lo + kmaj<BN>(p, c0 + 4)) =
          make_uint4(lo[1], lo[3], lo[5], lo[7]);
    }
    if (TR) {
      const int col = slot8(p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        *reinterpret_cast<uint32_t*>(tr_hi + kmaj<D>(c0 + e, col)) = hi[e];
        *reinterpret_cast<uint32_t*>(tr_lo + kmaj<D>(c0 + e, col)) = lo[e];
      }
    }
  }
}

// This thread's A fragment of k step kk of an owned raw tile, split: rows
// r0 and r0 + 8 (r0 = 16 w + g), slots t and t + 4, i.e. columns
// 8 kk + 2 t and 8 kk + 2 t + 1.
template <int D, bool SC>
__device__ __forceinline__ void owned_frag(const float* own, int kk, int r0,
                                           int t, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  const int c = 8 * kk + 2 * t;
  float x[4];
  if (SC) {
    x[0] = own[own_at<D, true>(r0, c)];
    x[1] = own[own_at<D, true>(r0 + 8, c)];
    x[2] = own[own_at<D, true>(r0, c + 1)];
    x[3] = own[own_at<D, true>(r0 + 8, c + 1)];
  } else {
    const float2 a =
        *reinterpret_cast<const float2*>(own + own_at<D, false>(r0, c));
    const float2 b =
        *reinterpret_cast<const float2*>(own + own_at<D, false>(r0 + 8, c));
    x[0] = a.x; x[1] = b.x; x[2] = a.y; x[3] = b.y;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
}

// -- the float32 flash kernels' tiles (flash_attention_fwd_f32.cu,
// flash_attention_bwd_f32.cu): raw copies in, staged float32 out

constexpr int kPos = 64;  // positions of the owned tile (wgmma's M)

// cp.async positions s0 .. s0 + ROWS - 1 of an operand (its (batch, head)
// slice at src, third stride st) into a raw tile, owned (OWN) or
// streamed, by the block's NT threads; positions at or past len read as
// zeros.
template <int ROWS, int D, bool SC, bool OWN, int NT>
__device__ __forceinline__ void stage_raw(float* tile, const float* src,
                                          int s0, int len, long long st) {
  constexpr int kChunks = ROWS * D / 4;
  static_assert(kChunks % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    int r, c, bytes;
    const float* from;
    if (SC) {
      c = i / (ROWS / 4);
      r = (i % (ROWS / 4)) * 4;
      const int left = len - (s0 + r);
      bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
      from = src + (long long)c * st + (s0 + r);
    } else {
      r = i / (D / 4);
      c = (i % (D / 4)) * 4;
      bytes = s0 + r < len ? 16 : 0;
      from = src + (long long)(s0 + r) * st + c;
    }
    const int off = OWN ? own_at<D, SC>(r, c) : raw_at<D, ROWS, SC>(r, c);
    cp_async16(smem_u32(tile + off), bytes ? from : src, bytes);
  }
}

// Float offset of element (position r, column c) of an output staging
// tile: layout 0 [64][D + 8], layout 1 [D][68] (rows padded against bank
// conflicts)
template <int D, bool SC>
__device__ __forceinline__ int stg_at(int r, int c) {
  return SC ? c * (kPos + 4) + r : r * (D + 8) + c;
}

template <int D, bool SC>
__host__ __device__ constexpr int stg_floats() {
  return SC ? D * (kPos + 4) : kPos * (D + 8);
}

// A warp's 16 rows of a (64, D) float32 accumulator into a staging tile
template <int D, bool SC>
__device__ __forceinline__ void stage_acc_f32(float* stg,
                                              const float (&acc)[D / 8][4],
                                              int r0, int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r0 + 8 * hi, c = 8 * nt + 2 * t;
      if (SC) {
        stg[stg_at<D, true>(r, c)] = acc[nt][2 * hi];
        stg[stg_at<D, true>(r, c + 1)] = acc[nt][2 * hi + 1];
      } else {
        *reinterpret_cast<float2*>(stg + stg_at<D, false>(r, c)) =
            make_float2(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
      }
    }
}

// A staging tile's positions 0 .. 63 to positions s0 .. s0 + 63 of dst
// (those below len), 16 bytes at a time, by the 128 threads of a
// warpgroup (tid its thread)
template <int D, bool SC>
__device__ __forceinline__ void store_out(float* dst, const float* stg,
                                          int s0, int len, long long st,
                                          int tid) {
  constexpr int kChunks = kPos * D / 4;
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (SC) {
      const int c = i / (kPos / 4), r = (i % (kPos / 4)) * 4;
      const int left = len - (s0 + r);
      if (left <= 0) continue;
      const float4 v =
          *reinterpret_cast<const float4*>(stg + stg_at<D, true>(r, c));
      float* to = dst + (long long)c * st + (s0 + r);
      if (left >= 4) {
        *reinterpret_cast<float4*>(to) = v;
      } else {
        to[0] = v.x;
        if (left > 1) to[1] = v.y;
        if (left > 2) to[2] = v.z;
      }
    } else {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      if (s0 + r >= len) continue;
      *reinterpret_cast<float4*>(dst + (long long)(s0 + r) * st + c) =
          *reinterpret_cast<const float4*>(stg + stg_at<D, false>(r, c));
    }
  }
}

// whether a float32 operand can be copied in 16-byte rows: 16-byte
// aligned, its batch, head and third strides multiples of 4 elements
bool aligned_f32(const void* p, long long sb, long long sh, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && st % 4 == 0;
}

}  // namespace
