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
// (M, C) row-major activation in f32, bf16 or f16, two f32 sums per
// channel, written as one (2, C) f32 array:
//   stats:  t1 = x - shift[c],  t2 = t1 * t1
//   bwd:    t1 = dy,            t2 = dy * ((x - mean[c]) * inv[c])
// every input converted to f32 before its first operation.
//
// What bounds them: bytes. Each reads the activation once (K14 reads two)
// and does 4-5 operations per entry: at ResNet-50's stem BN, (3,211,264,
// 64) bf16, K13 reads 411 MB, 123 us at 3.35 TB/s; at its smallest,
// (12,544, 512), 12.8 MB, 3.8 us, about the cost of one launch.
//
// The design: one launch per call, one wave of blocks. The TPU version
// carries its sum across a sequential grid in its output block; the
// card's blocks run in parallel and in no order, so each block owns a
// channel tile and a fixed range of rows (the partition, planned in
// Python from the shape and the SM count: bn_reduce.plan) and writes its
// f32 partial sums to scratch; the last block of a channel tile to arrive
// (an int32 counter after a __threadfence, set back to 0 by that block)
// adds the tile's partials and writes the result. No float atomics, and
// every sum is taken in a fixed order, so a call gives the same bits every
// time (world-1 DataParallel == SingleDevice).
// * Reads: a thread owns one 16-byte vector of channels (8 of a 16-bit
//   type, 4 f32) of a tile of tw = 8 vectors (4 for narrow rows, which
//   are cut into at least 4 tiles), so a warp reads whole 128- or 64-byte
//   row segments, and walks its rows th = 256 / tw apart. It issues the
//   loads of kUnroll rows th apart (4 in K13; 2 in K14, which reads two
//   inputs a row) into registers before it adds any of them (the register
//   batch), so enough bytes are in flight to stream near HBM rate with
//   two blocks an SM. Batches of 2 and 8 rows in K13, 4 in K14, and tiles
//   of up to 32 vectors measured no faster (PERF.md).
// * Within the block: lanes tx and tx + tw of a warp hold the same
//   channels and are added by shuffles; the 8 warps' sums then in shared
//   memory, in warp order. One barrier.
// * The merge: the tile's partials in partition order, kThreads / (2 x
//   tile width / 4) groups of threads each over every groups-th partition
//   with 16-byte loads, then the groups in order. A call of one
//   partition writes its sums directly and takes no counter.
// * Rows that are not whole vectors (C not a multiple of the vector
//   width, or an input not on a 16-byte boundary) take the per-element
//   instantiation (kVec = 1), chosen by the wrapper from the shape and the
//   pointers before the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

extern "C" {

// The launcher's arguments, packed by the Python wrapper into one buffer
// of 64-bit fields (ops/_build.py, packed(17)), in this order.
struct BnArgs {
  const void* x;
  const void* dy;     // K14; null for K13
  const void* a;      // f32 (C,): shift (K13) or mean (K14)
  const void* b;      // f32 (C,): inv (K14); null for K13
  void* out;          // f32 (2, C)
  void* partials;     // f32, nparts * 2 * C (unused when nparts == 1)
  void* counters;     // int32, tiles_c, zero between calls
  void* stream;
  int64_t dtype;      // 0 = float32, 1 = bfloat16, 2 = float16 (x, dy)
  int64_t bwd;        // 0 = K13, 1 = K14
  int64_t vec;        // 1 = 16-byte vectors: C a multiple of 16 / sizeof(T), x and dy aligned
  int64_t M, C;
  int64_t tw;         // vectors (channels when vec = 0) in a block's tile, a power of two
  int64_t tiles_c;    // channel tiles: ceil(C / (tw * per vector))
  int64_t nparts;     // row partitions: ceil(M / rows)
  int64_t rows;       // rows of a partition
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
// Rows a thread loads before it adds them (the register batch), for K13
// and for K14, which loads two inputs a row.
constexpr int kUnrollStats = 4;
constexpr int kUnrollBwd = 2;
constexpr int kMaxTile = 64;    // floats of one sum in a block's tile: tw * kVec
constexpr int kMaxParts = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// kVec channels of one row: one 16-byte load when they fill 16 bytes,
// else one element.
template <typename T, int kVec>
struct Row {
  static constexpr bool kWide = kVec * sizeof(T) == 16;
  static_assert(kWide || kVec == 1, "16-byte vectors or single elements");
  using Raw = typename std::conditional<kWide, uint4, T>::type;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kVec]) {
    const T* h = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = to_f32(h[i]);
  }
};

template <typename T, int kVec, bool kBwd>
__device__ __forceinline__ void add_row(const typename Row<T, kVec>::Raw& xr,
                                        const typename Row<T, kVec>::Raw& dr,
                                        const float (&av)[kVec], const float (&bv)[kVec],
                                        float (&s1)[kVec], float (&s2)[kVec]) {
  float xv[kVec];
  Row<T, kVec>::unpack(xr, xv);
  if constexpr (kBwd) {
    float dv[kVec];
    Row<T, kVec>::unpack(dr, dv);
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

// Block (blockIdx.x, blockIdx.y): channel tile blockIdx.x (tw vectors),
// rows [blockIdx.y * rows, +rows).
template <typename T, int kVec, bool kBwd>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) bn_reduce_kernel(const BnArgs p) {
  using R = Row<T, kVec>;
  constexpr int kUnroll = kBwd ? kUnrollBwd : kUnrollStats;
  __shared__ float sh[2][kWarps][kMaxTile];
  __shared__ float4 red[kThreads];
  __shared__ int is_last;
  const int tw = (int)p.tw, th = kThreads / tw, width = tw * kVec;
  const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int C = (int)p.C, nparts = (int)p.nparts;
  const int c0 = (blockIdx.x * tw + tx) * kVec;
  const bool active = c0 < C;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  float* out = static_cast<float*>(p.out);
  float* partials = static_cast<float*>(p.partials);
  float s1[kVec], s2[kVec], av[kVec], bv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s1[i] = 0.f;
    s2[i] = 0.f;
    av[i] = active ? a[c0 + i] : 0.f;
    bv[i] = (kBwd && active) ? b[c0 + i] : 0.f;
  }
  const long long r_end = min((long long)(blockIdx.y + 1) * p.rows, (long long)p.M);
  if (active) {
    long long r = (long long)blockIdx.y * p.rows + ty;
    // Whole batches: kUnroll loads in flight, then their sums in row order.
    for (; r + (long long)(kUnroll - 1) * th < r_end; r += (long long)kUnroll * th) {
      typename R::Raw xr[kUnroll], dr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(r + (long long)u * th) * C + c0;
        xr[u] = R::load(x + off);
        if constexpr (kBwd)
          dr[u] = R::load(dy + off);
        else
          dr[u] = xr[u];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_row<T, kVec, kBwd>(xr[u], dr[u], av, bv, s1, s2);
    }
    for (; r < r_end; r += th) {
      const size_t off = (size_t)r * C + c0;
      typename R::Raw xr = R::load(x + off), dr = xr;
      if constexpr (kBwd) dr = R::load(dy + off);
      add_row<T, kVec, kBwd>(xr, dr, av, bv, s1, s2);
    }
  }
  // The lanes of a warp that hold the same channels, by shuffles...
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (o < tw) break;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
    }
  }
  if (lane < tw) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      sh[0][warp][tx * kVec + i] = s1[i];
      sh[1][warp][tx * kVec + i] = s2[i];
    }
  }
  __syncthreads();
  // ... then the warps in order: this block's (2, width) sums.
  const bool single = gridDim.y == 1;
  const int cbase = blockIdx.x * width;
  for (int v = threadIdx.x; v < 2 * width; v += kThreads) {
    const int s = v / width, j = v % width;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sh[s][w][j];
    if (cbase + j < C) {
      if (single)
        out[(size_t)s * C + cbase + j] = acc;
      else
        partials[((size_t)blockIdx.y * 2 + s) * C + cbase + j] = acc;
    }
  }
  if (single) return;

  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = static_cast<int*>(p.counters) + blockIdx.x;
    const int last = atomicAdd(counter, 1) == nparts - 1;
    if (last) {
      *counter = 0;  // every partition has arrived: zero for the next call
      __threadfence();
    }
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;

  // The merge, in partition order.
  if constexpr (kVec >= 4) {
    // 16-byte loads: C and the tile's width are multiples of 4.
    const int quads = 2 * width / 4;  // a power of two, <= kThreads
    const int groups = kThreads / quads;
    const int v = threadIdx.x % quads, g = threadIdx.x / quads;
    const int s = v / (width / 4), j = (v % (width / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cbase + j < C) {
#pragma unroll 8
      for (int q = g; q < nparts; q += groups) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(
            partials + ((size_t)q * 2 + s) * C + cbase + j));
        acc.x += t.x;
        acc.y += t.y;
        acc.z += t.z;
        acc.w += t.w;
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < quads && cbase + j < C) {
      float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gg = 0; gg < groups; ++gg) {
        const float4 t = red[gg * quads + threadIdx.x];
        tot.x += t.x;
        tot.y += t.y;
        tot.z += t.z;
        tot.w += t.w;
      }
      *reinterpret_cast<float4*>(out + (size_t)s * C + cbase + j) = tot;
    }
  } else {
    const int vals = 2 * width;  // a power of two, <= kThreads
    const int groups = kThreads / vals;
    const int v = threadIdx.x % vals, g = threadIdx.x / vals;
    const int s = v / width, j = v % width;
    float acc = 0.f;
    if (cbase + j < C) {
#pragma unroll 8
      for (int q = g; q < nparts; q += groups)
        acc += __ldcg(partials + ((size_t)q * 2 + s) * C + cbase + j);
    }
    red[threadIdx.x].x = acc;
    __syncthreads();
    if (threadIdx.x < vals && cbase + j < C) {
      float tot = 0.f;
      for (int gg = 0; gg < groups; ++gg) tot += red[gg * vals + threadIdx.x].x;
      out[(size_t)s * C + cbase + j] = tot;
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int kVec, bool kBwd>
int launch(const BnArgs& a) {
  bn_reduce_kernel<T, kVec, kBwd><<<dim3((unsigned)a.tiles_c, (unsigned)a.nparts), kThreads, 0,
                                    static_cast<cudaStream_t>(a.stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const BnArgs& a) {
  constexpr int kWide = 16 / sizeof(T);
  const int per = a.vec ? kWide : 1;
  if (a.tw * per > kMaxTile || a.tiles_c != (a.C + a.tw * per - 1) / (a.tw * per))
    return (int)cudaErrorInvalidValue;
  if (a.vec && (a.C % kWide || !aligned16(a.x) || (a.bwd && !aligned16(a.dy))))
    return (int)cudaErrorMisalignedAddress;
  if (a.vec) return a.bwd ? launch<T, kWide, true>(a) : launch<T, kWide, false>(a);
  return a.bwd ? launch<T, 1, true>(a) : launch<T, 1, false>(a);
}

}  // namespace

extern "C" {

int dtt_bn_reduce_args_bytes() { return (int)sizeof(BnArgs); }
// Threads a block of the kernel has, which the Python plan divides among
// a tile's vectors (read once a process).
int dtt_bn_reduce_threads() { return kThreads; }

// K13 (bwd = 0): out = (sum(x - shift), sum((x - shift)^2)); K14 (bwd =
// 1): out = (sum(dy), sum(dy * ((x - mean) * inv))), over the M rows of x
// (and dy), contiguous, of one dtype, in one launch on the given stream.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dtt_bn_reduce(const BnArgs* a) {
  if (a->M < 1 || a->C < 1 || a->C > (1 << 30) || a->tw < 1 || a->tw > 32 ||
      (a->tw & (a->tw - 1)) || a->nparts < 1 || a->nparts > kMaxParts || a->rows < 1 ||
      a->tiles_c < 1 || a->tiles_c > 0x7fffffffLL || (a->nparts - 1) * a->rows >= a->M ||
      a->nparts * a->rows < a->M || (a->nparts > 1 && (!a->partials || !a->counters)) ||
      (a->bwd && (!a->dy || !a->b)) || !a->x || !a->a || !a->out)
    return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return launch<float>(*a);
  if (a->dtype == 1) return launch<__nv_bfloat16>(*a);
  if (a->dtype == 2) return launch<__half>(*a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
