// BatchNorm's per-channel reductions, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of examples/bn_pallas.py:
//   _stats_kernel (:80)  (sum(x - shift), sum((x - shift)^2)) per channel
//   _bwd_kernel   (:119) (sum(dy), sum(dy * (x - mean) * inv)) per channel
// which the port's nn.BatchNorm runs in every training forward (K13) and
// backward (K14).
//
// What they compute (the plain PyTorch versions are bn_stats_ref and
// bn_bwd_reduce_ref in distributed_tpu_torch/ops/bn_reduce.py): over an
// (M, C) row-major activation in bf16 or f32, two f32 sums per channel,
// written as one (2, C) f32 array:
//   stats:  t1 = x - shift[c],  t2 = t1 * t1
//   bwd:    t1 = dy,            t2 = dy * ((x - mean[c]) * inv[c])
// every input converted to f32 before its first operation.
//
// What bounds them: bytes. Each reads the activation once (K14 reads two)
// and does 3-5 operations per entry: at ResNet-50's stem BN, (3,211,264,
// 64) bf16, K13 reads 411 MB, 123 us at 3.35 TB/s.
//
// The design. The TPU version carries its sum across a sequential grid in
// its output block and folds C = 64 into 128 lanes; neither carries over,
// since the card's blocks run in parallel and in no order. Here a first
// kernel gives each block a channel slice and a fixed range of rows: a
// thread owns one 16-byte vector of channels (8 bf16 or 4 f32) and walks
// the range's rows with a stride of 256 / (vectors in the slice), so a
// warp reads whole rows of consecutive addresses; the threads of a column
// are then added in shared memory by a fixed tree, and the block writes
// its (2, slice) partial sums. A second kernel adds each channel's
// partials, 32 threads to a channel in a fixed partition and a fixed tree.
// No atomics: the sums are the same bits on every run, so a world-1
// DataParallel run equals a SingleDevice one. Two launches per call. The
// row ranges are a function of (M, C, dtype) only: about 1,024 blocks in
// the first launch, 8 per SM, each over a few thousand rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (kVec * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_f32(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_f32(p[i]);
  }
}

// Partial sums of rows [blockIdx.y * rows_per_block, +rows_per_block) for
// the tw vector columns of blockIdx.x. partial is (gridDim.y, 2, C).
template <typename T, int kVec, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    bn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ partial, long long M, int C, long long rows_per_block,
                      int tw) {
  __shared__ float sh[2][kThreads * kVec];
  const int th = kThreads / tw;
  const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
  const int cvecs = C / kVec;
  const int cv = blockIdx.x * tw + tx;
  const bool active = cv < cvecs;
  const int c0 = cv * kVec;
  float s1[kVec], s2[kVec], av[kVec], bv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s1[i] = 0.f;
    s2[i] = 0.f;
    av[i] = active ? a[c0 + i] : 0.f;
    bv[i] = (kBwd && active) ? b[c0 + i] : 0.f;
  }
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = r0 + rows_per_block < M ? r0 + rows_per_block : M;
  if (active) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += th) {
      float xv[kVec];
      load_vec<T, kVec>(x + r * C + c0, xv);
      if constexpr (kBwd) {
        float dv[kVec];
        load_vec<T, kVec>(dy + r * C + c0, dv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          s1[i] += dv[i];
          s2[i] += dv[i] * ((xv[i] - av[i]) * bv[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float t = xv[i] - av[i];
          s1[i] += t;
          s2[i] += t * t;
        }
      }
    }
  }
  // Add the th threads of each column, by a fixed tree over ty.
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    sh[0][(ty * tw + tx) * kVec + i] = s1[i];
    sh[1][(ty * tw + tx) * kVec + i] = s2[i];
  }
  __syncthreads();
  for (int half = th / 2; half > 0; half /= 2) {
    if (ty < half) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sh[0][(ty * tw + tx) * kVec + i] += sh[0][((ty + half) * tw + tx) * kVec + i];
        sh[1][(ty * tw + tx) * kVec + i] += sh[1][((ty + half) * tw + tx) * kVec + i];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && active) {
    float* out = partial + (long long)blockIdx.y * 2 * C;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      out[c0 + i] = sh[0][tx * kVec + i];
      out[C + c0 + i] = sh[1][tx * kVec + i];
    }
  }
}

// out[j] = sum over the nparts (2C)-long rows of partial of entry j, for
// the 32 entries of blockIdx.x: 32 threads per entry, each adding the
// rows p = ty, ty + 32, ... in order, then a fixed tree over ty.
__global__ void __launch_bounds__(1024)
    bn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ out, int nparts,
                       int width) {
  __shared__ float sh[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (j < width) {
#pragma unroll 4
    for (int p = ty; p < nparts; p += 32) s += partial[(long long)p * width + j];
  }
  sh[ty][tx] = s;
  __syncthreads();
  for (int half = 16; half > 0; half /= 2) {
    if (ty < half) sh[ty][tx] += sh[ty + half][tx];
    __syncthreads();
  }
  if (ty == 0 && j < width) out[j] = sh[0][tx];
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename T, int kVec, bool kBwd>
cudaError_t launch(const void* x, const void* dy, const float* a, const float* b, float* partial,
                   float* out, long long M, int C, int nparts, long long rows_per_block, int tw,
                   int tiles_c, cudaStream_t st) {
  bn_partial_kernel<T, kVec, kBwd><<<dim3(tiles_c, nparts), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), a, b, partial, M, C, rows_per_block,
      tw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_kernel<<<(2 * C + 31) / 32, 1024, 0, st>>>(partial, out, nparts, 2 * C);
  return cudaGetLastError();
}

// The partition of an (M, C) reduction: tw vector columns per block,
// tiles_c blocks across the channels, nparts blocks along M of
// rows_per_block rows each. per_vec: channels per vector (1 without
// 16-byte vectors).
struct Plan {
  int tw, tiles_c, nparts;
  long long rows_per_block;
};

inline Plan plan(long long M, int C, int per_vec) {
  Plan p;
  const int cvecs = C / per_vec;
  p.tw = pow2_at_least(cvecs) < 32 ? pow2_at_least(cvecs) : 32;
  p.tiles_c = (cvecs + p.tw - 1) / p.tw;
  const int th = kThreads / p.tw;
  long long want = (kTargetBlocks + p.tiles_c - 1) / p.tiles_c;
  const long long max_parts = (M + th - 1) / th;
  if (want > max_parts) want = max_parts;
  if (want < 1) want = 1;
  long long rows = (M + want - 1) / want;
  rows = (rows + th - 1) / th * th;
  p.rows_per_block = rows;
  p.nparts = (int)((M + rows - 1) / rows);
  return p;
}

inline int per_vec(int dtype, int vec) { return vec ? (dtype == 1 ? 8 : 4) : 1; }

cudaError_t run(int dtype, bool bwd, int vec, const void* x, const void* dy, const float* a,
                const float* b, void* scratch, float* out, long long M, int C, cudaStream_t st) {
  if (M < 1 || C < 1 || C > (1 << 20) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (vec && (C % per_vec(dtype, vec) || !aligned16(x) || (bwd && !aligned16(dy))))
    return cudaErrorMisalignedAddress;
  const Plan p = plan(M, C, per_vec(dtype, vec));
  float* partial = static_cast<float*>(scratch);
#define DTT_BN_LAUNCH(T, V, B)                                                                  \
  return launch<T, V, B>(x, dy, a, b, partial, out, M, C, p.nparts, p.rows_per_block, p.tw, \
                         p.tiles_c, st)
  if (dtype == 1) {
    if (vec) {
      if (bwd) DTT_BN_LAUNCH(__nv_bfloat16, 8, true);
      DTT_BN_LAUNCH(__nv_bfloat16, 8, false);
    }
    if (bwd) DTT_BN_LAUNCH(__nv_bfloat16, 1, true);
    DTT_BN_LAUNCH(__nv_bfloat16, 1, false);
  }
  if (vec) {
    if (bwd) DTT_BN_LAUNCH(float, 4, true);
    DTT_BN_LAUNCH(float, 4, false);
  }
  if (bwd) DTT_BN_LAUNCH(float, 1, true);
  DTT_BN_LAUNCH(float, 1, false);
#undef DTT_BN_LAUNCH
}

}  // namespace

extern "C" {

// Floats of scratch (the partial sums, nparts * 2 * C, nparts <= 1,024)
// a call with these arguments needs; -1 for arguments no call takes.
// vec = 1: 16-byte vectors (C a multiple of 8 bf16 or 4 f32, every input
// 16-byte aligned); 0: one channel per thread.
int dtt_bn_scratch_floats(int dtype, long long M, int C, int vec) {
  if (M < 1 || C < 1 || C > (1 << 20)) return -1;
  return plan(M, C, per_vec(dtype, vec)).nparts * 2 * C;
}

// K13: out (2, C) f32 = (sum(x - shift), sum((x - shift)^2)) over the M
// rows of x (M, C), contiguous. dtype: 0 = float32, 1 = bfloat16. Two
// launches; returns the cudaError_t of the first that failed (0 =
// cudaSuccess).
int dtt_bn_stats(int dtype, const void* x, const void* shift, void* scratch, void* out,
                 long long M, int C, int vec, void* stream) {
  return (int)run(dtype, false, vec, x, nullptr, static_cast<const float*>(shift), nullptr,
                  scratch, static_cast<float*>(out), M, C, static_cast<cudaStream_t>(stream));
}

// K14: out (2, C) f32 = (sum(dy), sum(dy * ((x - mean) * inv))) over the
// M rows of dy and x (M, C), contiguous, of one dtype. Two launches.
int dtt_bn_bwd_reduce(int dtype, const void* dy, const void* x, const void* mean,
                      const void* inv, void* scratch, void* out, long long M, int C, int vec,
                      void* stream) {
  return (int)run(dtype, true, vec, x, dy, static_cast<const float*>(mean),
                  static_cast<const float*>(inv), scratch, static_cast<float*>(out), M, C,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
