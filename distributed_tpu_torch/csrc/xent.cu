// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of distributed_tpu/ops/pallas_kernels.py:
//   _xent_fwd_kernel  (:35)  per-row logsumexp - picked logit, (N,) f32
//   _xent_bwd_kernel  (:46)  (softmax - onehot) * g, in the logits' dtype
//
// What they compute (the plain PyTorch versions are xent_fwd_ref and
// xent_bwd_ref in distributed_tpu_torch/ops/pallas_kernels.py), for row r
// of the (N, C) logits x, all in f32:
//   m = max(NEG, max_c x[c])             (NEG = -1e30, the TPU's padding)
//   s = sum_c exp(x[c] - m)
//   forward:  loss[r] = (log(s) + m) - x[label]   (x[label] read as 0 for a
//             label outside [0, C), which is not valid input)
//   backward: dx[c] = (exp(x[c] - m) / s - (c == label)) * g[r], cast to
//             the logits' dtype. The softmax is recomputed from the logits,
//             never saved, and divided by s, as the TPU kernel does.
//
// What bounds them: bytes. Each logit is read, and in the backward each
// dlogit written, for a handful of flops per element; at the LM head
// (N = C = 32768, bf16) the forward reads 2.15 GB (641 us at 3.35 TB/s)
// and the backward reads and writes 4.3 GB (1282 us). The design is one
// block of 512 threads per row, reading the row in 16-byte vectors: pass 1
// takes the max, pass 2 the sum (and the backward's pass 3 writes). The
// row (64 KB in bf16) is read again by the later passes right after the
// first, while it is still in L2 (two or three blocks per SM, about 20 MB
// of rows in flight against 50 MB of L2), so HBM sees it about once.
// Simple first: no row kept in registers or shared memory, no split of a
// row across blocks. Its time beside its bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Calls f(column, value) for every element of one row, in 16-byte vectors
// when the row allows it (vec != 0), element by element otherwise.
template <typename T, typename F>
__device__ __forceinline__ void for_each(const T* row, int C, int vec, F f) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int i = threadIdx.x; i < C / kVec; i += kThreads) {
      const uint4 u = r4[i];
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kVec; ++j) f(i * kVec + j, to_float<T>(v[j]));
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) f(c, to_float<T>(row[c]));
  }
}

// Block-wide reduction of one float per thread; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarps ? scratch[lane] : (kMax ? kNeg : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  return v;
}

// Row max (at least NEG) and sum of exp(x - max), both in f32.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int C, int vec, float* scratch,
                                          float& m, float& s) {
  float mx = kNeg;
  for_each(row, C, vec, [&](int, float x) { mx = fmaxf(mx, x); });
  m = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  const float mm = m;
  for_each(row, C, vec, [&](int, float x) { sum += expf(x - mm); });
  s = block_reduce<false>(sum, scratch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                    float* __restrict__ loss, int C, int vec) {
  __shared__ float scratch[kWarps];
  const T* row = logits + (size_t)blockIdx.x * C;
  float m, s;
  row_stats(row, C, vec, scratch, m, s);
  if (threadIdx.x == 0) {
    const int64_t lbl = labels[blockIdx.x];
    const float picked = (lbl >= 0 && lbl < C) ? to_float<T>(row[lbl]) : 0.f;
    loss[blockIdx.x] = (logf(s) + m) - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                    const float* __restrict__ g, T* __restrict__ dlogits, int C, int vec) {
  __shared__ float scratch[kWarps];
  const size_t base = (size_t)blockIdx.x * C;
  const T* row = logits + base;
  T* out = dlogits + base;
  float m, s;
  row_stats(row, C, vec, scratch, m, s);
  const int64_t lbl = labels[blockIdx.x];
  const float gr = g[blockIdx.x];
  constexpr int kVec = 16 / sizeof(T);
  auto grad = [&](int c, float x) {
    const float p = expf(x - m) / s;
    return from_float<T>((p - (c == lbl ? 1.f : 0.f)) * gr);
  };
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < C / kVec; i += kThreads) {
      const uint4 u = r4[i];
      const T* v = reinterpret_cast<const T*>(&u);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = grad(i * kVec + j, to_float<T>(v[j]));
      o4[i] = w;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) out[c] = grad(c, to_float<T>(row[c]));
  }
}

template <typename T>
cudaError_t launch_fwd(const void* logits, const void* labels, void* loss, int N, int C,
                       int vec, cudaStream_t stream) {
  xent_fwd_kernel<T><<<N, kThreads, 0, stream>>>(static_cast<const T*>(logits),
                                                 static_cast<const int64_t*>(labels),
                                                 static_cast<float*>(loss), C, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const void* labels, const void* g, void* dlogits,
                       int N, int C, int vec, cudaStream_t stream) {
  xent_bwd_kernel<T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int64_t*>(labels),
      static_cast<const float*>(g), static_cast<T*>(dlogits), C, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the logits and dlogits). labels are
// int64, loss and g float32. vec = 1 when every row starts on a 16-byte
// boundary and C fills whole 16-byte vectors. Returns the cudaError_t of
// the launch (0 = cudaSuccess).
int dtt_xent_fwd(int dtype, const void* logits, const void* labels, void* loss, int N, int C,
                 int vec, void* stream) {
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(logits, labels, loss, N, C, vec, st);
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(logits, labels, loss, N, C, vec, st);
  return (int)cudaErrorInvalidValue;
}

int dtt_xent_bwd(int dtype, const void* logits, const void* labels, const void* g,
                 void* dlogits, int N, int C, int vec, void* stream) {
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<float>(logits, labels, g, dlogits, N, C, vec, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(logits, labels, g, dlogits, N, C, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
