// The GEMM of a 1x1 convolution over NHWC rows, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of examples/pallas_conv1x1.py:
//   _mm_kernel (:33)  o = dot(x, w, preferred_element_type=f32).astype(x)
// which both pallas_gemm (:44) and pallas_gemm_packed (:68) launch; the
// packed variant multiplies row pairs against a block-diagonal weight to
// fill the TPU's 128 lanes at K = 64, a layout matter this kernel has no
// need of.
//
// What it computes (the plain PyTorch version is conv1x1_ref in
// distributed_tpu_torch/ops/conv1x1.py): out (M, N) = x (M, K) @ w (K, N),
// all row-major, every product summed in f32 and the sum rounded once to
// the input dtype. bf16 runs on the tensor cores (nvcuda::wmma 16x16x16,
// f32 accumulators); f32 runs on the CUDA cores in full f32 (no TF32).
//
// What bounds it: bytes, at ResNet-50's shapes. A 1x1 convolution has
// K = 64-2,048 input channels and N = 64-2,048 filters over M = 12,544-
// 802,816 rows at batch 256; the product does 2K operations per output
// and the output is as large as the input or larger, so the arithmetic
// intensity is at most K*N/(K+N) operations per byte -- 51 at (64, 256),
// 410 at (1,024, 2,048) -- mostly below the 295 the card needs to be
// bound by its tensor cores. At (802,816, 64, 256): 514 MB moved (153 us
// at 3.35 TB/s), 26.3 GFLOP (27 us at 989 TFLOP/s).
//
// The design: one block computes a 128 x 128 output tile with 8 warps,
// each warp a 32 x 64 piece (2 x 4 wmma fragments); K is walked in chunks
// of 32 staged in shared memory with 16-byte loads. Blocks are numbered
// with the N tiles fastest, so the blocks in flight at once share their x
// rows and x is read from device memory about once; w is small and stays
// in L2. The output is written once: each warp stages one 16 x 16
// fragment in shared memory, rounds it and stores it with 16-byte
// vectors. Rows past M, and columns past K or N, are masked (the Pallas
// version needs M % block_m == 0; this one does not). The f32 kernel is
// a 64 x 64 tile of 4 x 4 outputs per thread. Simple first: no cp.async,
// TMA or wgmma, no double buffering; its time beside its bound is in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;             // 8 warps: 4 along M x 2 along N
constexpr int kLdA = kBK + 8;             // padded rows, 16-byte aligned
constexpr int kLdB = kBN + 8;

// One 16-byte vector (8 bf16) of a row-major (rows, cols) matrix at
// (r, c), zero where it leaves the matrix. `vec`: every row starts on a
// 16-byte boundary and cols % 8 == 0, so a vector inside is aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, long long rows, int cols,
                                       long long r, int c, bool vec) {
  if (vec && r < rows && c + 8 <= cols)
    return *reinterpret_cast<const uint4*>(p + r * cols + c);
  union {  // raw bits: unsigned short is trivial, as a union member must be
    uint4 u;
    unsigned short h[8];
  } v;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v.h[i] = (r < rows && c + i < cols) ? __bfloat16_as_ushort(p[r * cols + c + i]) : 0;
  return v.u;
}

__global__ void __launch_bounds__(kThreads)
    conv1x1_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, long long M, int K, int N, int tiles_n,
                        int vec) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(32) float stage[kThreads / 32][16 * 16];

  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_n) * kBM;
  const int col0 = (int)(tile % tiles_n) * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // this warp's 32 x 64 piece

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: 128 rows x 4 vectors; B: 32 rows x 16 vectors; 2 vectors each.
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int e = tid + t * kThreads;
      const int ar = e >> 2, ac = (e & 3) * 8;
      *reinterpret_cast<uint4*>(&As[ar * kLdA + ac]) =
          load8(x, M, K, row0 + ar, k0 + ac, vec);
      const int br = e >> 4, bc = (e & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[br * kLdB + bc]) =
          load8(w, K, N, k0 + br, col0 + bc, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * kLdA + kk], kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[kk * kLdB + wn * 64 + j * 16], kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: one fragment at a time through this warp's stage; lane l
  // writes 8 columns of row l / 2.
  float* st = stage[warp];
  const int sr = lane >> 1, sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long r = row0 + wm * 32 + i * 16 + sr;
      const int c = col0 + wn * 64 + j * 16 + sc;
      if (r < M) {
        union {
          uint4 u;
          unsigned short h[8];
        } v;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v.h[q] = __bfloat16_as_ushort(__float2bfloat16_rn(st[sr * 16 + sc + q]));
        if (vec && c + 8 <= N) {
          *reinterpret_cast<uint4*>(out + r * N + c) = v.u;
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (c + q < N) out[r * N + c + q] = __ushort_as_bfloat16(v.h[q]);
        }
      }
      __syncwarp();
    }
}

// ----------------------------------------------------------------- f32
constexpr int kFM = 64, kFN = 64, kFK = 16;  // 256 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
    conv1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, long long M, int K, int N, int tiles_n) {
  __shared__ float As[kFK][kFM + 4];  // transposed: As[k][row]
  __shared__ float Bs[kFK][kFN + 4];
  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_n) * kFM;
  const int col0 = (int)(tile % tiles_n) * kFN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = tid + t * kThreads;
      const int ar = e >> 4, ak = e & 15;  // 64 rows x 16 k
      const long long r = row0 + ar;
      As[ak][ar] = (r < M && k0 + ak < K) ? x[r * K + k0 + ak] : 0.f;
      const int bk = e >> 6, bc = e & 63;  // 16 k x 64 columns
      Bs[bk][bc] = (k0 + bk < K && col0 + bc < N) ? w[(long long)(k0 + bk) * N + col0 + bc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) out[r * N + c] = acc[i][j];
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// out (M, N) = x (M, K) @ w (K, N), row-major and contiguous, in one
// launch. dtype: 0 = float32, 1 = bfloat16 (x, w and out alike). Returns
// the cudaError_t of the launch (0 = cudaSuccess).
int dtt_conv1x1(int dtype, const void* x, const void* w, void* out, long long M, int K, int N,
                void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int tiles_n = (N + kBN - 1) / kBN;
    const long long blocks = ((M + kBM - 1) / kBM) * tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out);
    conv1x1_bf16_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, K, N, tiles_n, vec);
  } else if (dtype == 0) {
    const int tiles_n = (N + kFN - 1) / kFN;
    const long long blocks = ((M + kFM - 1) / kFM) * tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    conv1x1_f32_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), M,
        K, N, tiles_n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
