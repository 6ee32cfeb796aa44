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
// the input dtype.
//
// What bounds it: bytes, at most of ResNet-50's shapes. A 1x1 convolution
// has K = 64-2,048 input channels and N = 64-2,048 filters over M =
// 12,544-802,816 rows at batch 256; the product does 2K operations per
// output and the output is as large as the input or larger, so the
// arithmetic intensity is at most K*N/(K+N) operations per byte -- 51 at
// (64, 256), 410 at (1,024, 2,048) -- mostly below the 295 the card needs
// to be bound by its tensor cores. At (802,816, 64, 256): 514 MB moved
// (153 us at 3.35 TB/s), 26.3 GFLOP (27 us at 989 TFLOP/s).
//
// Two routes, by dtype (conv1x1_route in ops/conv1x1.py):
// * "wgmma", bf16 and f16: conv1x1_wgmma_kernel<T>, designed for Hopper
//   (f16 takes the same tiles and wgmma's f16 form). Its rows
//   are whole 16-byte chunks: K and N are multiples of 8 and the pointers
//   16-byte aligned (every shape of ResNet-50; the wrapper zero-pads other
//   shapes to that in a copy). A block owns a 128 x 128 output tile, two
//   warpgroups of 64 rows each, the sums in registers (64 a thread), two
//   blocks an SM, so one block's products run while the other waits for
//   its copies or writes its tile out. K is walked in chunks of 64 through
//   a ring of kStages = 3 cp.async stages in 128-byte-swizzled shared
//   memory, the copies of chunk j + 2 in flight while chunk j is
//   multiplied: X is the A operand, K-major; W, (K, N) row-major, is the B
//   operand, MN-major (wgmma's transpose bit). Rows past M and the K and N
//   tails are zero-filled by the copies (src-size 0). Blocks are numbered
//   with the N tiles fastest, so the blocks in flight at once share their
//   X rows and X is read from device memory about once; W is small and
//   stays in L2. The epilogue rounds the tile to T, stages it in shared
//   memory and writes it with 16-byte vectors, masked at M and N. Two
//   blocks an SM cap a thread at 128 registers, and ptxas spills at that
//   cap: an 8-byte stack frame, 4 bytes of spill stores and 4 of loads.
//   Other ring depths and tiles, and a persistent grid, were slower
//   (PERF.md).
// * "cuda_core", float32: conv1x1_f32_kernel, a 64 x 64 tile of 4 x 4
//   outputs a thread in full f32 (no TF32), rows past M and columns past
//   K or N masked.
// (The Pallas version needs M % block_m == 0; these do not.) The times
// beside the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

// ------------------------------------------------------- bf16 and f16, wgmma
constexpr int kStages = 3;
constexpr int kGM = 128, kGN = 128, kGK = 64, kGThreads = 256;  // two warpgroups
constexpr uint32_t kATile = kGM * kGK * 2, kStage = kATile + kGK * kGN * 2;
constexpr int kLdC = kGN + 8;  // staged output rows: 16-byte aligned, no bank conflicts
constexpr size_t kGemmSmem = kStages * kStage + 1024;
static_assert(kGM * kLdC * 2 <= kStages * kStage, "the output tile fits in the stages");
constexpr int kGemmBlocks = 2;  // blocks an SM: 128 registers a thread
static_assert(kGemmBlocks * (kGemmSmem + 1024) <= 232448, "two blocks fit in an SM");

template <typename T>
__global__ void __launch_bounds__(kGThreads, kGemmBlocks)
    conv1x1_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                         int M, int K, int N, int tiles_n) {
  using namespace hopper;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const int row0 = (int)(blockIdx.x / tiles_n) * kGM, col0 = (int)(blockIdx.x % tiles_n) * kGN;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int n_chunks = (K + kGK - 1) / kGK;

  // Chunk j into stage j % kStages: X rows [row0, +128) x columns [k0,
  // +64) and W rows [k0, +64) x columns [col0, +128). One commit group
  // per chunk, empty past the last, so wait counts stay uniform.
  auto load_chunk = [&](int j) {
    if (j < n_chunks) {
      const uint32_t st = base + (j % kStages) * kStage;
      const int k0 = j * kGK;
      load_tile_async<kGM, kGK, kGThreads>(st, x + k0, row0, M, (size_t)K, K - k0);
      load_tile_async<kGK, kGN, kGThreads>(st + kATile, w + col0, k0, K, (size_t)N, N - col0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_chunk(j);

  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<kStages - 2>();  // chunk j has landed (this thread's copies)
    fence_async_shared();
    __syncthreads();  // ... everyone's; and every product of chunk j - 1 is done
    load_chunk(j + kStages - 1);  // into the stage chunk j - 1 used
    const uint32_t st = base + (j % kStages) * kStage;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk)
      wgmma_ss<T, 1>(acc, kmajor_desc(st + wg * 64 * 128, kGM, kk),
                                 mnmajor_desc(st + kATile, kGK, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the stages

  // Epilogue: round to T into shared memory (thread: rows r and r + 8,
  // column pairs 8n + 2 quad), then 16-byte vectors to global memory.
  T* tile = reinterpret_cast<T*>(smem + (base - smem_addr(smem)));
  const int r = wg * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < kGN / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (r + 8 * h) * kLdC + 8 * n + 2 * quad) =
          pack2<T>(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kGM * kGN / 8 / kGThreads; ++i) {
    const int idx = threadIdx.x + i * kGThreads;
    const int tr = idx / (kGN / 8), tc = idx % (kGN / 8) * 8;
    const int gr = row0 + tr, gc = col0 + tc;
    if (gr < M && gc < N)
      *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) =
          *reinterpret_cast<const uint4*>(tile + tr * kLdC + tc);
  }
}

// ----------------------------------------------------------------- f32
constexpr int kFM = 64, kFN = 64, kFK = 16, kThreads = 256;  // 4 x 4 outputs a thread

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

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int M, int K, int N,
                         int tiles_n, unsigned blocks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  conv1x1_wgmma_kernel<T><<<blocks, kGThreads, kGemmSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), M, K, N, tiles_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) = x (M, K) @ w (K, N), row-major and contiguous, in one
// launch. dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16, 2 =
// float16 (the wgmma kernel: K and N multiples of 8, 16-byte aligned
// pointers); x, w and out share it. Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int dtt_conv1x1(int dtype, const void* x, const void* w, void* out, long long M, int K, int N,
                void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 || dtype == 2) {
    if (K % 8 || N % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out) ||
        M > 0x7fffffffLL - kGM)
      return (int)cudaErrorInvalidValue;
    const int tiles_n = (N + kGN - 1) / kGN;
    const long long blocks = ((M + kGM - 1) / kGM) * tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 1 ? launch_wgmma<__nv_bfloat16>(x, w, out, (int)M, K, N, tiles_n,
                                                         (unsigned)blocks, st)
                            : launch_wgmma<__half>(x, w, out, (int)M, K, N, tiles_n,
                                                   (unsigned)blocks, st));
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

// Dynamic shared memory of a conv1x1_wgmma_kernel<T> block.
int dtt_conv1x1_wgmma_smem() { return (int)kGemmSmem; }

}  // extern "C"
