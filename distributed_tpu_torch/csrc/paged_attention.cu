// Paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernels of distributed_tpu/ops/paged_attention.py:
//   _decode_kernel        (:93)   plain f32/bf16/f16 pools    -> kQuant = false
//   _decode_kernel_quant  (:151)  int8 {"q","scale"} pools    -> kQuant = true
//
// What it computes (the plain PyTorch version is paged_attention_ref in
// distributed_tpu_torch/ops/paged_attention.py): for slot s, query row
// k < kw and head h, attention of q[s, k, h] over the slot's cached K/V
// rows, read through the block table (position p of slot s lives in pool
// block tables[s, p / bs] at offset p % bs) and masked causally to
// positions <= positions[s] + k. Scores are (q . k) / sqrt(hd) in f32;
// the softmax is online (running max m, sum l, accumulator acc in f32);
// the unnormalized probabilities are rounded to the value dtype before
// the product with V; the output is acc / max(l, 1e-30) in q's dtype.
// int8 pools dequantize each row as float(q) * scale, rounded once to
// q's dtype, before it is used.
//
// What bounds it: bytes. Decode reads every visible K/V row once and does
// 4 flops per element read (two dot products), far below the ~295
// flop/byte where an H100's bf16 tensor cores would become the limit. So
// the design goal is to read each K/V byte once and nothing else: one
// CTA per (slot, head) walks the slot's visible positions in tiles of 32
// rows and never touches a block past the last visible position (fully
// masked tiles would add exp(NEG - m) = 0, so stopping there gives the
// same result). Each tile is loaded as 16-byte chunks into registers while
// the previous tile is computed on from shared memory, so the HBM round
// trip overlaps the compute. Positions past a row's own position are
// skipped, never weighted, so stale or trash rows cannot leak in even when
// they hold non-finite values.
//
// Head widths: any hd up to 256, in two classes (kHd 128 or 256; the
// 256 class runs 256 threads, so the per-thread registers stay those of
// 128). Rows whose bytes are a multiple of 16 (kVec) are read as 16-byte
// chunks through the register prefetch; other widths (hd = 8 or 24 in
// int8, odd hd) read each element straight into shared memory, with no
// prefetch.
//
// This version is still simple: no cp.async or TMA, no split over the
// sequence (S * H CTAs, so the longest slot sets the time), CUDA-core
// FMAs rather than tensor cores. Its time beside its bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;  // positions per tile: one per lane
constexpr int kMaxKw = 8;
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;
__host__ __device__ constexpr int threads_for(int hd_class) { return hd_class; }

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Round an f32 value to T (round to nearest even) and widen it back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raw bits of one pool element (trivial types, so they fit in a union with
// the 16-byte chunk they arrive in), and their value as f32.
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };
template <> struct Raw<__half> { using type = short; };  // a type of its own for the overload
template <> struct Raw<int8_t> { using type = int8_t; };
__device__ __forceinline__ float raw_to_float(float v) { return v; }
__device__ __forceinline__ float raw_to_float(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float raw_to_float(short v) {
  return __half2float(__short_as_half(v));
}
__device__ __forceinline__ float raw_to_float(int8_t v) { return (float)v; }

// Per-thread register buffer for one tile of K/V rows, loaded as 16-byte
// chunks. Loading the NEXT tile into registers while the current one is
// computed on keeps HBM busy through the compute phases.
template <typename T, bool kQuant, int kHd>
struct TileRegs {
  using E = typename Raw<typename std::conditional<kQuant, int8_t, T>::type>::type;
  static constexpr int kVec = 16 / sizeof(E);                     // elements per chunk
  static constexpr int kChunks = kTile * kHd / kVec / threads_for(kHd);
  uint4 k[kChunks], v[kChunks];
  float ks[kChunks], vs[kChunks];  // per-row scales (kQuant only)
};

// Grid (S, H), threads_for(kHd) threads, hd <= kHd. Layouts (all
// contiguous; with kVec, pool rows are whole 16-byte chunks and the pools
// 16-byte aligned):
//   q, out        (S, kw, H, hd)      T
//   k_pool/v_pool (NB, bs, H, hd)     T, or int8 when kQuant
//   k/v_scale     (NB, bs, H)         f32, read only when kQuant
//   tables        (S, nb)             int32
//   positions     (S,)                int32
template <typename T, bool kQuant, bool kVec, int kHd>
__global__ void __launch_bounds__(threads_for(kHd)) paged_attention_kernel(
    const T* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out, int kw, int H,
    int hd, int bs, int nb, float sqrt_hd) {
  using Regs = TileRegs<T, kQuant, kHd>;
  using E = typename Regs::E;
  constexpr int kThreads = threads_for(kHd), kWarps = kThreads / 32;
  constexpr int kAccPerThread = kMaxKw * kHd / kThreads;
  constexpr int kVecElems = Regs::kVec;
  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded K row stride: fewer bank conflicts in the dot
  float* q_s = smem;                   // kw * hd
  float* k_s = q_s + kw * hd;          // kTile * ks
  float* v_s = k_s + kTile * ks;       // kTile * hd
  float* p_s = v_s + kTile * hd;       // kw * kTile: scores, then probabilities
  float* alpha_s = p_s + kw * kTile;   // kw
  float* m_s = alpha_s + kw;           // kw
  float* l_s = m_s + kw;               // kw

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = positions[s];
  // Positions any query row of this slot can see: [0, pos + kw - 1].
  const int len = min(pos + kw, nb * bs);
  const int* table = tables + (size_t)s * nb;
  const E* kp = static_cast<const E*>(k_pool);
  const E* vp = static_cast<const E*>(v_pool);
  const int cpr = hd / kVecElems;     // chunks per row
  const int n_chunks = kTile * cpr;   // chunks per tile, per pool

  Regs regs;
  // Issue every load of the tile at t0 before any is used (kVec only).
  auto load_tile = [&](int t0) {
    if constexpr (!kVec) return;
#pragma unroll
    for (int j = 0; j < Regs::kChunks; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_chunks) {
        const int c = i / cpr;
        const int part = i - c * cpr;
        const int p = t0 + c;
        regs.k[j] = regs.v[j] = make_uint4(0u, 0u, 0u, 0u);
        regs.ks[j] = regs.vs[j] = 1.f;
        if (p < len) {
          const size_t row = ((size_t)table[p / bs] * bs + (p % bs)) * H + h;
          regs.k[j] = *reinterpret_cast<const uint4*>(kp + row * hd + part * kVecElems);
          regs.v[j] = *reinterpret_cast<const uint4*>(vp + row * hd + part * kVecElems);
          if constexpr (kQuant) {
            regs.ks[j] = k_scale[row];
            regs.vs[j] = v_scale[row];
          }
        }
      }
    }
  };
  // Widen (and for int8, dequantize: float(q) * scale rounded once to T)
  // the registers, or without kVec the tile at t0 read element by element,
  // into the shared-memory tile.
  auto store_tile = [&](int t0) {
    if constexpr (!kVec) {
      for (int i = tid; i < kTile * hd; i += kThreads) {
        const int c = i / hd;
        const int d = i - c * hd;
        const int p = t0 + c;
        float kv = 0.f, vv = 0.f;
        if (p < len) {
          const size_t row = ((size_t)table[p / bs] * bs + (p % bs)) * H + h;
          kv = raw_to_float(kp[row * hd + d]);
          vv = raw_to_float(vp[row * hd + d]);
          if constexpr (kQuant) {
            kv = round_to<T>(kv * k_scale[row]);
            vv = round_to<T>(vv * v_scale[row]);
          }
        }
        k_s[c * ks + d] = kv;
        v_s[c * hd + d] = vv;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < Regs::kChunks; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_chunks) {
        const int c = i / cpr;
        const int d0 = (i - c * cpr) * kVecElems;
        union { uint4 u; E e[kVecElems]; } kc, vc;
        kc.u = regs.k[j];
        vc.u = regs.v[j];
#pragma unroll
        for (int u = 0; u < kVecElems; ++u) {
          if constexpr (kQuant) {
            k_s[c * ks + d0 + u] = round_to<T>(raw_to_float(kc.e[u]) * regs.ks[j]);
            v_s[c * hd + d0 + u] = round_to<T>(raw_to_float(vc.e[u]) * regs.vs[j]);
          } else {
            k_s[c * ks + d0 + u] = raw_to_float(kc.e[u]);
            v_s[c * hd + d0 + u] = raw_to_float(vc.e[u]);
          }
        }
      }
    }
  };

  load_tile(0);
  for (int i = tid; i < kw * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    q_s[i] = to_float<T>(q[(((size_t)s * kw + r) * H + h) * hd + d]);
  }
  if (tid < kw) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int e = 0; e < kAccPerThread; ++e) acc[e] = 0.f;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    store_tile(t0);
    __syncthreads();
    if (t0 + kTile < len) load_tile(t0 + kTile);  // in flight during compute

    // Scores of every (query row, tile column) the causal mask exposes:
    // four threads per pair, each a quarter of the dot (the last quarter
    // shorter where 4 does not divide hd), then two shuffles.
    {
      const int g = tid >> 2;
      const int part = tid & 3;
      const int dq = (hd + 3) >> 2;
      const int n = max(0, min(dq, hd - part * dq));  // this quarter's length
      // (kw * kTile is a multiple of 32, so a warp's 8 pairs are all in
      // the loop or all out, as its shuffles need.)
      for (int i = g; i < kw * kTile; i += kThreads / 4) {
        const int r = i / kTile;
        const int c = i - r * kTile;
        const float* qr = q_s + r * hd + part * dq;
        const float* kr = k_s + c * ks + part * dq;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int d = 0;
        for (; d + 4 <= n; d += 4) {
          a0 = fmaf(qr[d], kr[d], a0);
          a1 = fmaf(qr[d + 1], kr[d + 1], a1);
          a2 = fmaf(qr[d + 2], kr[d + 2], a2);
          a3 = fmaf(qr[d + 3], kr[d + 3], a3);
        }
        for (; d < n; ++d) a0 = fmaf(qr[d], kr[d], a0);
        float dot = (a0 + a1) + (a2 + a3);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (part == 0) {
          const int p = t0 + c;
          p_s[i] = (p <= pos + r && p < len) ? dot / sqrt_hd : kNeg;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per query row, one lane per column.
    for (int r = warp; r < kw; r += kWarps) {
      const int p = t0 + lane;
      const bool visible = p <= pos + r && p < len;
      const float sc = p_s[r * kTile + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float pr = visible ? expf(sc - m_new) : 0.f;
      const float psum = warp_sum(pr);
      p_s[r * kTile + lane] = round_to<T>(pr);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, each thread owning (row, d) elements.
#pragma unroll
    for (int e = 0; e < kAccPerThread; ++e) {
      const int i = tid + e * kThreads;
      if (i < kw * hd) {
        const int r = i / hd;
        const int d = i - r * hd;
        const float* pr = p_s + r * kTile;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int c = 0; c < kTile; c += 4) {
          a0 = fmaf(pr[c], v_s[c * hd + d], a0);
          a1 = fmaf(pr[c + 1], v_s[(c + 1) * hd + d], a1);
          a2 = fmaf(pr[c + 2], v_s[(c + 2) * hd + d], a2);
          a3 = fmaf(pr[c + 3], v_s[(c + 3) * hd + d], a3);
        }
        acc[e] = acc[e] * alpha_s[r] + ((a0 + a1) + (a2 + a3));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < kAccPerThread; ++e) {
    const int i = tid + e * kThreads;
    if (i < kw * hd) {
      const int r = i / hd;
      const int d = i - r * hd;
      out[(((size_t)s * kw + r) * H + h) * hd + d] =
          from_float<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, bool kQuant, bool kVec, int kHd>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* positions, void* out, int S, int kw, int H, int hd,
                   int bs, int nb, float sqrt_hd, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kw * hd + (size_t)kTile * (hd + 1) +
                       (size_t)kTile * hd + (size_t)kw * kTile + 3 * (size_t)kw);
  auto kernel = paged_attention_kernel<T, kQuant, kVec, kHd>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, H), threads_for(kHd), smem, stream>>>(
      static_cast<const T*>(q), k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), kw, H, hd, bs, nb,
      sqrt_hd);
  return cudaGetLastError();
}

// The instantiation for this call's pool type, read path and hd class.
template <typename T, bool kQuant>
cudaError_t launch(int vec, const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* positions, void* out, int S, int kw, int H, int hd, int bs,
                   int nb, float sqrt_hd, cudaStream_t st) {
  using E = typename std::conditional<kQuant, int8_t, T>::type;
  if (vec && (hd * sizeof(E)) % 16) return cudaErrorInvalidValue;
#define DTT_LAUNCH(V, HD)                                                                   \
  return launch<T, kQuant, V, HD>(q, k_pool, v_pool, k_scale, v_scale, tables, positions, \
                                  out, S, kw, H, hd, bs, nb, sqrt_hd, st)
  if (vec) {
    if (hd <= 128) DTT_LAUNCH(true, 128);
    DTT_LAUNCH(true, 256);
  }
  if (hd <= 128) DTT_LAUNCH(false, 128);
  DTT_LAUNCH(false, 256);
#undef DTT_LAUNCH
}

}  // namespace

extern "C" {

// Limits the Python wrapper checks before it launches.
int dtt_paged_attention_max_kw() { return kMaxKw; }
int dtt_paged_attention_max_hd() { return kMaxHd; }

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, out, and plain pools).
// quant: 0 = plain pools of dtype, 1 = int8 pools with f32 scales.
// vec: 1 = read pool rows as 16-byte chunks (rows of a multiple of 16
// bytes, pools 16-byte aligned), 0 = element by element.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dtt_paged_attention(int dtype, int quant, int vec, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale, const void* v_scale,
                        const void* tables, const void* positions, void* out, int S,
                        int kw, int H, int hd, int bs, int nb, float sqrt_hd,
                        void* stream) {
  if (S < 1 || H < 1 || kw < 1 || kw > kMaxKw || hd < 1 || hd > kMaxHd || bs < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_ARGS \
  vec, q, k_pool, v_pool, k_scale, v_scale, tables, positions, out, S, kw, H, hd, bs, nb, sqrt_hd, st
  if (dtype == 0)
    return (int)(quant ? launch<float, true>(DTT_ARGS) : launch<float, false>(DTT_ARGS));
  if (dtype == 1)
    return (int)(quant ? launch<__nv_bfloat16, true>(DTT_ARGS)
                       : launch<__nv_bfloat16, false>(DTT_ARGS));
  if (dtype == 2)
    return (int)(quant ? launch<__half, true>(DTT_ARGS) : launch<__half, false>(DTT_ARGS));
#undef DTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
