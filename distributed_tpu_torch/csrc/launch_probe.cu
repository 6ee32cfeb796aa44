// The launch-cost probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of examples/profile_op_floor.py:
//   k (:92)  o = x * 1.0001 on one (8, 128) f32 tile
// the smallest kernel the JAX package launches, kept to measure what one
// launch costs whatever it computes (scripts/torch_op_floor.py, section
// (d); chip_smoke.py, phase p).
//
// What it computes (the plain PyTorch version is launch_probe_ref in
// distributed_tpu_torch/ops/launch_probe.py): out[i] = x[i] * 1.0001f for
// n f32 entries, one rounded multiply each, so it equals the plain
// version bit for bit.
//
// What bounds it: neither bytes nor operations. The tile is 8 KB read and
// written (2.4 ns at 3.35 TB/s) and 1,024 multiplies; the launch itself,
// a few microseconds of host and device work, is the whole cost. So the
// design is the least there is: one block of 256 threads, one float4 per
// thread where the tile is whole vectors, nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    launch_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int vec) {
  if (vec) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
      float4 v = *reinterpret_cast<const float4*>(x + i);
      v.x = __fmul_rn(v.x, 1.0001f);
      v.y = __fmul_rn(v.y, 1.0001f);
      v.z = __fmul_rn(v.z, 1.0001f);
      v.w = __fmul_rn(v.w, 1.0001f);
      *reinterpret_cast<float4*>(out + i) = v;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) out[i] = __fmul_rn(x[i], 1.0001f);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// out = x * 1.0001f over n f32 entries, in one launch of one block.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dtt_launch_probe(const void* x, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(out);
  launch_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
