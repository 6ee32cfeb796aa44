// Hopper (sm_90a) building blocks shared by the port's wgmma kernels
// (flash_attention.cu: forward, dQ, dK/dV; conv1x1.cu: the 1x1-conv GEMM).
//
// * cp.async copies from global to shared memory (16 or 4 bytes; a false
//   predicate copies nothing and zero-fills, src-size 0), their commit and
//   wait, and the fence that orders landed copies before wgmma's reads.
// * 128-byte-swizzled tiles of 16-bit elements and the wgmma descriptors
//   that read them K-major or MN-major (the transpose bit).
// * wgmma.mma_async m64nNk16 with f32 sums, A from shared memory (SS) or
//   from registers (RS), for bf16 and f16 inputs; the packing of an f32
//   accumulator fragment into the register A operand of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

template <typename T> constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, asynchronously. ok == false
// copies nothing and zero-fills (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's landed copies before wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that use them.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory tiles. A tile of R rows at a padded width of W (a multiple
// of 64) 16-bit columns is W / 64 column blocks of R rows x 128 bytes,
// block c at byte c * R * 128, each tile on a 1024-byte boundary. Within a
// block the 16-byte chunk j of row r lies at r * 128 + ((j ^ (r % 8)) *
// 16): the 128-byte swizzle, so the 8 rows of a 1024-byte atom spread over
// all banks, and the layout the descriptors below name.
//
// wgmma descriptor: start address, leading and stride byte offsets (each
// in 16-byte units) and the swizzle mode (1 = 128 bytes) in bits 62-63;
// base offset 0, as every atom starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// The tile as a K-major operand (the product sums over its columns: Q and
// K in Q K^T, X in X W): k step kk (16 columns, 32 bytes) starts in block
// kk / 4 at byte (kk % 4) * 32; rows 128 bytes apart, 8-row groups 1024
// apart. The leading offset is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// The tile as an MN-major operand (the product sums over its rows: V in
// P V, K in dS K, dO and Q in P^T dO and dS^T Q, W in X W; wgmma's
// transpose bit set): k step kk (16 rows) starts at kk * 2048; 8-row
// groups 1024 apart (stride), 64-column blocks rows * 128 apart (leading).
// Column block c of the tile starts at tile + c * rows * 128.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 2048, rows * 128, 1024);
}

// Starts the copies of rows [row0, row0 + R) of a row-major matrix of
// 16-bit elements (src at its row 0, column 0 of the part copied; rows ld
// elements apart, 16-byte aligned) into a tile of width W; rows at or past
// nrows and columns at or past ncols (a multiple of 8) are zero-filled.
// All kThreads threads of the block take part; neighbouring threads copy
// neighbouring 16-byte chunks of a row.
template <int R, int W, int kThreads, typename T>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const T* src, int row0, int nrows,
                                                size_t ld, int ncols) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  constexpr int kChunks = W / 8;
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, j = idx % kChunks;
    const int t = row0 + r;
    const bool ok = t < nrows && j * 8 < ncols;
    const T* g = ok ? src + (size_t)t * ld + j * 8 : src;
    cp_async16(tile + (j / 8) * R * 128 + r * 128 + (((j % 8) ^ (r % 8)) << 4), g, ok);
  }
}

// Accumulator fragments. For wgmma.m64nNk16 with f32 sums, thread x of a
// warpgroup (warp w = x / 32, lane l) holds, for each 8-column group n,
// d[4n + 2h + e] = D(16 w + l / 4 + 8 h, 8 n + 2 (l % 4) + e), h, e in
// {0, 1}. The register A operand of m64nNk16 (16 columns per k step kk)
// wants a[kk][i] = the 16-bit pair of columns 16 kk + 8 (i / 2) + 2 (l %
// 4) + {0, 1} in row 16 w + l / 4 + 8 (i % 2): the same places, so the
// scores of one product become the A operand of the next by packing
// neighbouring pairs, the lower column in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsBf16<T>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
template <typename T, int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// ------------------------------------------------------------------ wgmma
// D (64 x N per warpgroup, f32) [+]= A B. wgmma_ss<T, kTransB> takes A and
// B from shared memory, A K-major, B K-major (kTransB 0) or MN-major (1);
// accumulate == 0 overwrites D. wgmma_rs<T> takes A from registers and B
// from shared memory, MN-major, and accumulates. N = 2 * (registers of d).
#define DTT_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DTT_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DTT_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DTT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DTT_F16(i) DTT_F4(i), DTT_F4(i + 4), DTT_F4(i + 8), DTT_F4(i + 12)
#define DTT_F32(i) DTT_F16(i), DTT_F16(i + 16)
#define DTT_F64 DTT_F32(0), DTT_F32(32)

// IA, IB, IP, IT: operand numbers of the A and B descriptors, the
// accumulate flag and the transpose bit, after the accumulators.
#define DTT_SS(SHAPE, TY, DSTR, DOPS, IA, IB, IP, IT)                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " DSTR ", %" IA    \
               ", %" IB ", p, 1, 1, 0, %" IT ";\n}\n"                                        \
               : DOPS                                                                       \
               : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB))
#define DTT_RS(SHAPE, TY, DSTR, DOPS, IA0, IA1, IA2, IA3, IB, IP)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " DSTR ", {%" IA0 \
               ", %" IA1 ", %" IA2 ", %" IA3 "}, %" IB ", p, 1, 1, 1;\n}\n"                 \
               : DOPS                                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    DTT_SS("m64n32k16", "bf16", DTT_D16, DTT_F16(0), "16", "17", "18", "19");
  else
    DTT_SS("m64n32k16", "f16", DTT_D16, DTT_F16(0), "16", "17", "18", "19");
}
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    DTT_SS("m64n64k16", "bf16", DTT_D32, DTT_F32(0), "32", "33", "34", "35");
  else
    DTT_SS("m64n64k16", "f16", DTT_D32, DTT_F32(0), "32", "33", "34", "35");
}
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (kIsBf16<T>)
    DTT_SS("m64n128k16", "bf16", DTT_D64, DTT_F64, "64", "65", "66", "67");
  else
    DTT_SS("m64n128k16", "f16", DTT_D64, DTT_F64, "64", "65", "66", "67");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsBf16<T>)
    DTT_RS("m64n64k16", "bf16", DTT_D32, DTT_F32(0), "32", "33", "34", "35", "36", "37");
  else
    DTT_RS("m64n64k16", "f16", DTT_D32, DTT_F32(0), "32", "33", "34", "35", "36", "37");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsBf16<T>)
    DTT_RS("m64n128k16", "bf16", DTT_D64, DTT_F64, "64", "65", "66", "67", "68", "69");
  else
    DTT_RS("m64n128k16", "f16", DTT_D64, DTT_F64, "64", "65", "66", "67", "68", "69");
}

#undef DTT_SS
#undef DTT_RS
#undef DTT_F64
#undef DTT_F32
#undef DTT_F16
#undef DTT_F4
#undef DTT_D64
#undef DTT_D32
#undef DTT_D16

}  // namespace hopper
