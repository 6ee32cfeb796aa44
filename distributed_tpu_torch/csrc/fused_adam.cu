// Fused Adam/AdamW update for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tpu/ops/fused_update.py:
//   _adam_kernel (:82)  moments, bias correction and step of Adam/AdamW
//                       over the flat same-dtype segments of the tree
// and the optax.apply_updates that follows it in the JAX step.
//
// What it computes (the plain PyTorch version is adam_update_ref in
// distributed_tpu_torch/ops/fused_update.py), for every element of every
// leaf, IN PLACE on p, m and v, all in f32:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   u  = (m'/bc1) / (sqrt(v'/bc2) + eps)      bc = 1 - b**count
//   u  = u + wd*p                             only when wd != 0 (AdamW)
//   p' = p + u*(-lr)
// Every product, sum, quotient and root is rounded once, in this order,
// with the _rn intrinsics: nvcc would otherwise contract a*b + c into one
// fused multiply-add, which rounds differently from the plain version
// (separate foreach kernels) and from XLA. With them the kernel and its
// plain version agree bit for bit on the card.
//
// What bounds it: bytes. Each element reads p, g, m, v and writes p, m, v,
// 28 bytes for about a dozen operations; at GPT-2-small's 136.2M entries
// that is 3.81 GB, 1,138 us at 3.35 TB/s (the operations take 24 us at the
// f32 rate). The design: one launch takes a table of up to kMaxLeaves
// leaves by value, as kernel parameters, so the leaves are never
// concatenated or padded (the TPU's 128-lane rows were a layout matter of
// its own); the wrapper launches once per table-full of leaves. Each leaf
// is cut into chunks of kChunk elements, one block per chunk; a block
// finds its leaf by a binary search over the table's first-block offsets.
// A leaf whose four pointers are 16-byte aligned is read and written in
// float4 vectors, any other element by element. Simple first: no
// persistent blocks, no prefetching.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements per block, a multiple of 4 * kThreads

struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_block[kMaxLeaves + 1];  // [count] holds the launch's block count
  int vec[kMaxLeaves];
  int count;
};

struct Hyper {
  float neg_lr, b1, b2, c1, c2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.c1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.c2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1), den);
  if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(p, h.wd));
  p = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
}

__global__ void __launch_bounds__(kThreads) fused_adam_kernel(const Table t, const Hyper h) {
  // The leaf whose chunks hold this block: the last with first_block <= b.
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const long long start = (long long)(b - t.first_block[lo]) * kChunk;
  const long long n = t.n[lo];
  const long long end = start + kChunk < n ? start + kChunk : n;
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  long long i = start + threadIdx.x;
  if (t.vec[lo]) {
    // start is a multiple of kChunk, so the vectors stay 16-byte aligned.
    const long long end4 = start + ((end - start) & ~3LL);
    for (long long k = start + 4LL * threadIdx.x; k < end4; k += 4LL * kThreads) {
      float4 pv = *reinterpret_cast<const float4*>(p + k);
      const float4 gv = *reinterpret_cast<const float4*>(g + k);
      float4 mv = *reinterpret_cast<const float4*>(m + k);
      float4 vv = *reinterpret_cast<const float4*>(v + k);
      adam_elem(pv.x, gv.x, mv.x, vv.x, h);
      adam_elem(pv.y, gv.y, mv.y, vv.y, h);
      adam_elem(pv.z, gv.z, mv.z, vv.z, h);
      adam_elem(pv.w, gv.w, mv.w, vv.w, h);
      *reinterpret_cast<float4*>(p + k) = pv;
      *reinterpret_cast<float4*>(m + k) = mv;
      *reinterpret_cast<float4*>(v + k) = vv;
    }
    i = end4 + threadIdx.x;
  }
  for (; i < end; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_elem(pi, g[i], mi, vi, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// One launch over `count` (1..kMaxLeaves, MAX_LEAVES in the wrapper)
// leaves of f32 tensors, updated in
// place: p[i], m[i], v[i] are written, g[i] read, each of n[i] > 0
// elements. The scalars are f32 values computed by the caller (c1 = 1-b1,
// c2 = 1-b2, bc1 = 1-b1**count, bc2 = 1-b2**count). Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int dtt_fused_adam(int count, void* const* p, const void* const* g, void* const* m,
                   void* const* v, const long long* n, float neg_lr, float b1, float b2,
                   float c1, float c2, float eps, float wd, float bc1, float bc2,
                   void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table t;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return (int)cudaErrorInvalidValue;
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.m[i] = static_cast<float*>(m[i]);
    t.v[i] = static_cast<float*>(v[i]);
    t.n[i] = n[i];
    t.vec[i] = aligned16(p[i]) && aligned16(g[i]) && aligned16(m[i]) && aligned16(v[i]);
    t.first_block[i] = (int)blocks;
    blocks += (n[i] + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  t.first_block[count] = (int)blocks;
  t.count = count;
  const Hyper h{neg_lr, b1, b2, c1, c2, eps, wd, bc1, bc2};
  fused_adam_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
