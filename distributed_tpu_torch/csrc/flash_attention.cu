// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of distributed_tpu/ops/flash_attention.py.
// The kernels here cover the six TPU kernels, because they read q, k, v
// (and dO) straight from the (B, T, H, D) layout the projections produce,
// by strides, with no transpose in either direction:
//   forward  <- _fwd_kernel (:83)  and _fwd_kernel_packed (:384)
//   dQ       <- _dq_kernel  (:199) and _dq_kernel_packed  (:448)
//   dK, dV   <- _dkv_kernel (:238) and _dkv_kernel_packed (:490)
// (the TPU needed the folded (B*H, T, D) and the lane-packed (B, T, H*D)
// variants for its 128-lane vector tiles; the card does not).
//
// What they compute (the plain PyTorch versions are flash_fwd_ref and
// flash_bwd_ref in distributed_tpu_torch/ops/flash_attention.py), per
// (batch, head), with scale = 1/sqrt(D) and valid(i, j) = j < T and, when
// causal, j <= i (masked scores are NEG = -1e30):
//   forward:  s = (q_i . k_j) * scale in f32; online softmax over kv tiles
//             (running max m and sum l in f32, alpha = exp(m_prev - m_new),
//             p = exp(s - m_new)); acc = acc * alpha + p.to(v) @ v in f32;
//             out = acc / max(l, 1e-30) in q's dtype; m and l written per row.
//   dQ:       p = valid ? exp(s - m) / max(l, 1e-30) : 0,
//             ds = p * (dO_i . v_j - delta_i) * scale,
//             dq += ds.to(k) @ k (f32), cast to q's dtype.
//   dK, dV:   dv += p.to(dO)^T @ dO and dk += ds.to(q)^T @ q (f32).
// delta_i = sum_d dO . O is computed outside, as the TPU path does.
//
// What bounds them: at GPT-2-small training (B 32, T 1024, H 12, D 64,
// causal, bf16) operations and bytes about equally in the forward (51.6
// GFLOP of products, 52 us at 989 TFLOP/s, on 205 MB of q, k, v, out, 61
// us at 3.35 TB/s), operations in the backward (2-3x the products on
// similar bytes). Each block owns the rows it writes, so no atomics, and
// the loop over kv tiles (over q tiles for dK/dV) takes the place of the
// TPU's sequential grid dimension; tiles strictly above the diagonal are
// skipped.
//
// Two routes, chosen by dtype in the wrapper:
// * bf16, forward and dK/dV: flash_fwd_wgmma_kernel and
//   flash_dkv_wgmma_kernel (the Hopper section below): warpgroup products
//   (wgmma) with the sums in registers, tiles brought in by cp.async into
//   a two-stage ring while the previous tile is multiplied, softmax and
//   rescaling on the register fragments. Head widths are padded to 64 or
//   128 in shared memory (zero columns add nothing).
// * float32 inputs, and dQ in both dtypes: flash_fwd_kernel<float>,
//   flash_dq_kernel<T> and flash_dkv_kernel<float>, the first design: a
//   block of 4 warps over a 64-row tile, tiles staged synchronously,
//   products by nvcuda::wmma bf16 16x16x16 (dQ in bf16) or on the CUDA
//   cores in full f32 (no TF32, for checks against the plain version),
//   scores and accumulators kept in shared memory between the products.
// Their times beside their bounds are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kRows = 64;  // rows of a q tile and of a kv tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

template <typename T> constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

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

// Leading dimensions in shared memory. bf16 tiles are padded by 8 elements
// (rows stay 32-byte aligned, as wmma needs); f32 tiles by 1 (an odd
// stride, so a column walk hits every bank once). f32 accumulators by 4.
template <typename T> __host__ __device__ constexpr int ld_tile(int cols) {
  return cols + (kIsBf16<T> ? 8 : 1);
}
__host__ __device__ constexpr int ld_acc(int cols) { return cols + 4; }

// C (16 x N, f32, row-major, ldc) = [C +] A (16 x K) @ B (K x N), for one
// warp. A is row-major (ld lda). B is row-major, B(k, n) = B[k * ldb + n],
// or column-major, B(k, n) = B[k + n * ldb]. N and K are multiples of 16.
template <typename T, bool kBColMajor, bool kAccumulate>
__device__ __forceinline__ void warp_mm(const T* A, int lda, const T* B, int ldb, float* C,
                                        int ldc, int N, int K) {
  if constexpr (kIsBf16<T>) {
    using BLayout = typename std::conditional<kBColMajor, wmma::col_major, wmma::row_major>::type;
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (kAccumulate)
        wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, kBColMajor ? B + k0 + n0 * ldb : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int e = lane; e < 16 * N; e += 32) {
      const int i = e / N, n = e - i * N;
      float acc = kAccumulate ? C[i * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k)
        acc += to_float<T>(A[i * lda + k]) *
               to_float<T>(kBColMajor ? B[k + n * ldb] : B[k * ldb + n]);
      C[i * ldc + n] = acc;
    }
  }
  __syncwarp();
}

// Copies kRows rows [row0, row0 + kRows) of one head of a (B, T, H, D)
// tensor into shared memory (ld ldt); rows at or past T read as zeros.
// src points at element (b, 0, h, 0). All threads of the block take part.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldt, const T* src, int row0, int T_,
                                          int H, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = D / kVec;
  for (int idx = threadIdx.x; idx < kRows * vpr; idx += kThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * kVec;
    const int t = row0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < T_) u = *reinterpret_cast<const uint4*>(src + (size_t)t * H * D + c);
    if constexpr (kIsBf16<T>) {
      *reinterpret_cast<uint4*>(dst + r * ldt + c) = u;
    } else {
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[r * ldt + c + j] = v[j];
    }
  }
}

// Zeroes this warp's 16 rows of an f32 accumulator (cols wide).
__device__ __forceinline__ void zero_rows(float* acc, int ld, int cols) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * cols; e += 32) acc[(e / cols) * ld + e % cols] = 0.f;
  __syncwarp();
}

// Writes this warp's 16 accumulator rows to one head of a (B, T, H, D)
// tensor: lane l handles row l / 2, half l % 2.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, int ld, int row0, int T_,
                                           int H, int D) {
  const int lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  const int t = row0 + r;
  if (t >= T_) return;
  T* out = dst + (size_t)t * H * D;
  for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
    out[d] = from_float<T>(acc[r * ld + d]);
}

struct Shape {
  int T, H, D, causal;
  float scale;
};

// Element (b, 0, h, 0) of a (B, T, H, D) tensor, and (b, h, 0) of (B, H, T).
template <typename T> __device__ __forceinline__ T* head(T* p, const Shape& s, int bh) {
  const int b = bh / s.H, h = bh - b * s.H;
  return p + ((size_t)b * s.T * s.H + h) * s.D;
}

// ----------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile<T>(D), ldp = ld_tile<T>(kRows);
  const int lds = ld_acc(kRows), ldo = ld_acc(D);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * ldt;
  T* v_s = k_s + kRows * ldt;
  T* p_s = v_s + kRows * ldt;
  float* s_s = reinterpret_cast<float*>(p_s + kRows * ldp);
  float* o_s = s_s + kRows * lds;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * 16 + r;  // this lane's query row
  const T* qh = head(q, s, bh);
  const T* kh = head(k, s, bh);
  const T* vh = head(v, s, bh);

  T* pw = p_s + warp * 16 * ldp;
  float* sw = s_s + warp * 16 * lds;
  float* ow = o_s + warp * 16 * ldo;
  load_tile(q_s, ldt, qh, q0, s.T, s.H, D);
  zero_rows(ow, ldo, D);
  float m = kNeg, l = 0.f;

  const int kv_end = s.causal ? min(s.T, q0 + kRows) : s.T;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();  // every warp is done with the previous k/v tiles
    load_tile(k_s, ldt, kh, k0, s.T, s.H, D);
    load_tile(v_s, ldt, vh, k0, s.T, s.H, D);
    __syncthreads();
    warp_mm<T, true, false>(q_s + warp * 16 * ldt, ldt, k_s, ldt, sw, lds, kRows, D);

    // Online softmax over this lane's half row (32 columns).
    float sc[32];
    float m_cur = kNeg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      const bool valid = col < s.T && (!s.causal || col <= row);
      sc[c] = valid ? __fmul_rn(sw[r * lds + half * 32 + c], s.scale) : kNeg;
      m_cur = fmaxf(m_cur, sc[c]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sc[c] - m_new);
      psum += p;
      pw[r * ldp + half * 32 + c] = from_float<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) ow[r * ldo + d] *= alpha;
    __syncwarp();
    warp_mm<T, false, true>(pw, ldp, v_s, ldt, ow, ldo, D, kRows);
  }
  // out = acc / max(l, 1e-30): divide, as the TPU kernel does.
  if (row < s.T) {
    T* orow = head(o, s, bh) + (size_t)row * s.H * D;
    const float denom = fmaxf(l, 1e-30f);
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      orow[d] = from_float<T>(ow[r * ldo + d] / denom);
    if (half == 0) {
      m_out[(size_t)bh * s.T + row] = m;
      l_out[(size_t)bh * s.T + row] = l;
    }
  }
}

// ---------------------------------------------------------------------- dQ
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta_in, T* __restrict__ dq, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile<T>(D), ldp = ld_tile<T>(kRows);
  const int lds = ld_acc(kRows), ldo = ld_acc(D);
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kRows * ldt;
  T* k_s = do_s + kRows * ldt;
  T* v_s = k_s + kRows * ldt;
  T* ds_s = v_s + kRows * ldt;
  float* s_s = reinterpret_cast<float*>(ds_s + kRows * ldp);
  float* dp_s = s_s + kRows * lds;
  float* dq_s = dp_s + kRows * lds;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * 16 + r;
  const T* kh = head(k, s, bh);
  const T* vh = head(v, s, bh);
  load_tile(q_s, ldt, head(q, s, bh), q0, s.T, s.H, D);
  load_tile(do_s, ldt, head(dout, s, bh), q0, s.T, s.H, D);
  const size_t stat = (size_t)bh * s.T + row;
  const float m = row < s.T ? m_in[stat] : 0.f;
  const float l = row < s.T ? fmaxf(l_in[stat], 1e-30f) : 1.f;
  const float delta = row < s.T ? delta_in[stat] : 0.f;

  T* dsw = ds_s + warp * 16 * ldp;
  float* sw = s_s + warp * 16 * lds;
  float* dpw = dp_s + warp * 16 * lds;
  float* dqw = dq_s + warp * 16 * ldo;
  zero_rows(dqw, ldo, D);

  const int kv_end = s.causal ? min(s.T, q0 + kRows) : s.T;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();
    load_tile(k_s, ldt, kh, k0, s.T, s.H, D);
    load_tile(v_s, ldt, vh, k0, s.T, s.H, D);
    __syncthreads();
    warp_mm<T, true, false>(q_s + warp * 16 * ldt, ldt, k_s, ldt, sw, lds, kRows, D);
    warp_mm<T, true, false>(do_s + warp * 16 * ldt, ldt, v_s, ldt, dpw, lds, kRows, D);
#pragma unroll 4
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int col = k0 + c;
      const bool valid = row < s.T && col < s.T && (!s.causal || col <= row);
      const float p = valid ? expf(__fmul_rn(sw[r * lds + c], s.scale) - m) / l : 0.f;
      dsw[r * ldp + c] = from_float<T>(p * (dpw[r * lds + c] - delta) * s.scale);
    }
    __syncwarp();
    warp_mm<T, false, true>(dsw, ldp, k_s, ldt, dqw, ldo, D, kRows);
  }
  store_rows(head(dq, s, bh), dqw, ldo, q0 + warp * 16, s.T, s.H, D);
}

// ------------------------------------------------------------------ dK, dV
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta_in, T* __restrict__ dk,
                     T* __restrict__ dv, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile<T>(D), ldp = ld_tile<T>(kRows);
  const int lds = ld_acc(kRows), ldo = ld_acc(D);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kRows * ldt;
  T* q_s = v_s + kRows * ldt;
  T* do_s = q_s + kRows * ldt;
  T* pt_s = do_s + kRows * ldt;
  T* dst_s = pt_s + kRows * ldp;
  float* st_s = reinterpret_cast<float*>(dst_s + kRows * ldp);
  float* dpt_s = st_s + kRows * lds;
  float* dk_s = dpt_s + kRows * lds;
  float* dv_s = dk_s + kRows * ldo;
  float* m_s = dv_s + kRows * ldo;
  float* l_s = m_s + kRows;
  float* delta_s = l_s + kRows;

  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int krow = k0 + warp * 16 + r;  // this lane's key row
  const T* qh = head(q, s, bh);
  const T* doh = head(dout, s, bh);
  load_tile(k_s, ldt, head(k, s, bh), k0, s.T, s.H, D);
  load_tile(v_s, ldt, head(v, s, bh), k0, s.T, s.H, D);

  T* ptw = pt_s + warp * 16 * ldp;
  T* dstw = dst_s + warp * 16 * ldp;
  float* stw = st_s + warp * 16 * lds;
  float* dptw = dpt_s + warp * 16 * lds;
  float* dkw = dk_s + warp * 16 * ldo;
  float* dvw = dv_s + warp * 16 * ldo;
  zero_rows(dkw, ldo, D);
  zero_rows(dvw, ldo, D);

  // Causal: q tiles wholly above this kv tile's diagonal see none of it.
  const int q_begin = s.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < s.T; q0 += kRows) {
    __syncthreads();
    load_tile(q_s, ldt, qh, q0, s.T, s.H, D);
    load_tile(do_s, ldt, doh, q0, s.T, s.H, D);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int t = q0 + i;
      const size_t stat = (size_t)bh * s.T + t;
      m_s[i] = t < s.T ? m_in[stat] : 0.f;
      l_s[i] = t < s.T ? fmaxf(l_in[stat], 1e-30f) : 1.f;
      delta_s[i] = t < s.T ? delta_in[stat] : 0.f;
    }
    __syncthreads();
    // Transposed scores: this warp's 16 key rows against the 64 q rows.
    warp_mm<T, true, false>(k_s + warp * 16 * ldt, ldt, q_s, ldt, stw, lds, kRows, D);
    warp_mm<T, true, false>(v_s + warp * 16 * ldt, ldt, do_s, ldt, dptw, lds, kRows, D);
#pragma unroll 4
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int qrow = q0 + c;
      const bool valid = krow < s.T && qrow < s.T && (!s.causal || krow <= qrow);
      const float p = valid ? expf(__fmul_rn(stw[r * lds + c], s.scale) - m_s[c]) / l_s[c] : 0.f;
      ptw[r * ldp + c] = from_float<T>(p);
      dstw[r * ldp + c] = from_float<T>(p * (dptw[r * lds + c] - delta_s[c]) * s.scale);
    }
    __syncwarp();
    warp_mm<T, false, true>(ptw, ldp, do_s, ldt, dvw, ldo, D, kRows);
    warp_mm<T, false, true>(dstw, ldp, q_s, ldt, dkw, ldo, D, kRows);
  }
  store_rows(head(dk, s, bh), dkw, ldo, k0 + warp * 16, s.T, s.H, D);
  store_rows(head(dv, s, bh), dvw, ldo, k0 + warp * 16, s.T, s.H, D);
}


// ============================================================ bf16 (wgmma)
// The bf16 forward and dK/dV, designed for Hopper. A block is one or two
// warpgroups; each issues wgmma.m64nNk16 over its own 64 rows, so the
// softmax statistics of a row never leave the four threads of its quad.
// No producer warp: every thread issues its share of the next tile's
// cp.async copies before the products of the current tile, and waits for
// them only after.

constexpr float kLog2e = 1.4426950408889634f;

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

// Shared-memory tiles. A tile of R rows at a padded width of W (64 or 128)
// bf16 columns is W / 64 column blocks of R rows x 128 bytes, block c at
// byte c * R * 128, each tile on a 1024-byte boundary. Within a block the
// 16-byte chunk j of row r lies at r * 128 + ((j ^ (r % 8)) * 16): the
// 128-byte swizzle, so the 8 rows of a 1024-byte atom spread over all
// banks, and the layout the descriptors below name.
//
// wgmma descriptor: start address, leading and stride byte offsets (each
// in 16-byte units) and the swizzle mode (1 = 128 bytes) in bits 62-63;
// base offset 0, as every atom starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// The tile as a K-major operand (the product sums over its columns: Q and
// K in Q K^T): k step kk (16 columns, 32 bytes) starts in block kk / 4 at
// byte (kk % 4) * 32; rows 128 bytes apart, 8-row groups 1024 apart. The
// leading offset is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// The tile as an MN-major operand (the product sums over its rows: V in
// P V, dO and Q in P^T dO and dS^T Q; wgmma's transpose bit set): k step
// kk (16 rows) starts at kk * 2048; 8-row groups 1024 apart (stride),
// 64-column blocks rows * 128 apart (leading).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 2048, rows * 128, 1024);
}

// Starts the copies of rows [row0, row0 + R) of one head of a (B, T, H, D)
// bf16 tensor (src at element (b, 0, h, 0)) into a tile of width W; rows
// at or past T and columns at or past D are zero-filled. All kThreads
// threads of the block take part; neighbouring threads copy neighbouring
// 16-byte chunks of a row.
template <int R, int W, int kThreads>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const __nv_bfloat16* src,
                                                int row0, int T_, int H, int D) {
  constexpr int kChunks = W / 8;
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, j = idx % kChunks;
    const int t = row0 + r;
    const bool ok = t < T_ && j * 8 < D;
    const __nv_bfloat16* g = ok ? src + (size_t)t * H * D + j * 8 : src;
    cp_async16(tile + (j / 8) * R * 128 + r * 128 + (((j % 8) ^ (r % 8)) << 4), g, ok);
  }
}

// Accumulator fragments. For wgmma.m64nNk16 with f32 sums, thread x of a
// warpgroup (warp w = x / 32, lane l) holds, for each 8-column group n,
// d[4n + 2h + e] = D(16 w + l / 4 + 8 h, 8 n + 2 (l % 4) + e), h, e in
// {0, 1}. The register A operand of m64nNk16 (16 columns per k step kk)
// wants a[kk][i] = the bf16 pair of columns 16 kk + 8 (i / 2) + 2 (l % 4)
// + {0, 1} in row 16 w + l / 4 + 8 (i % 2): the same places, so the
// scores of one product become the A operand of the next by packing
// neighbouring pairs, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// D (64 x N per warpgroup, f32) [+]= A B: wgmma_ss takes A and B from
// shared memory (both K-major; accumulate == 0 overwrites D), wgmma_rs
// takes A from registers and B from shared memory, MN-major (the
// transpose bit), and accumulates.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Writes rows row and row + 8 of a warpgroup's 64 x W accumulator, divided
// by den[h], to one head of a (B, T, H, D) bf16 tensor (dst at element
// (b, 0, h, 0)); rows at or past T and padded columns are not written.
template <int W>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, const float (&acc)[W / 2],
                                                const float (&den)[2], int row, int quad,
                                                int T_, int H, int D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h;
    if (t >= T_) continue;
    __nv_bfloat16* out = dst + (size_t)t * H * D;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const int col = 8 * n + 2 * quad;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h] / den[h], acc[4 * n + 2 * h + 1] / den[h]);
    }
  }
}

// Block shapes of the wgmma kernels: warpgroups a block (64 rows each),
// blocks an SM holds at once (which caps a thread's registers at 65536 /
// (128 * warpgroups * blocks); blocks of one SM run out of step, so one
// block's softmax overlaps another's products), and the rows of the tiles
// the block walks. dK/dV takes q tiles of 32 rows so that its four 64 x 32
// fragments fit beside dK and dV in 168 registers (three blocks an SM)
// without spilling; at 64 rows it spills.
constexpr int kFwdWarpgroups = 2, kDkvWarpgroups = 1;
__host__ __device__ constexpr int fwd_blocks_per_sm(int W) { return W == 64 ? 2 : 1; }
__host__ __device__ constexpr int dkv_blocks_per_sm(int W) { return W == 64 ? 3 : 2; }
constexpr int kFwdKvRows = 64;  // kv rows of a forward tile
constexpr int kDkvQRows = 32;   // q rows of a dK/dV tile

// ----------------------------------------------------------- forward, bf16
// A block owns 64 query rows per warpgroup and walks kv tiles of 64 rows,
// K and V double-buffered: S = Q K^T (64 x 64 f32 a warpgroup, 32
// registers a thread), the online softmax on those registers (row max and
// sum across the quad by shuffles), O rescaled in registers, then O += P V
// with P packed to bf16 as the register A operand and V MN-major. O never
// leaves registers until the epilogue. Blocks run the heaviest causal q
// tiles first, so the tail of the grid is light. Shared memory: Q plus two
// stages of K and V (49 KB at W = 64).
template <int W>
__global__ void __launch_bounds__(128 * kFwdWarpgroups, fwd_blocks_per_sm(W))
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ m_out, float* __restrict__ l_out, Shape s) {
  constexpr int kThreads = 128 * kFwdWarpgroups, kM = 64 * kFwdWarpgroups, kN = kFwdKvRows;
  constexpr uint32_t kTile = kN * W * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kM * W * 2, v_s = k_s + 2 * kTile;  // stage i at + i * kTile

  const int T_ = s.T, H = s.H, D = s.D, bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int wg_q0 = q0 + wg * 64;
  const int row = wg_q0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and row + 8
  const __nv_bfloat16* kh = head(k, s, bh);
  const __nv_bfloat16* vh = head(v, s, bh);
  load_tile_async<kM, W, kThreads>(q_s, head(q, s, bh), q0, T_, H, D);
  load_tile_async<kN, W, kThreads>(k_s, kh, 0, T_, H, D);
  load_tile_async<kN, W, kThreads>(v_s, vh, 0, T_, H, D);
  cp_async_commit();

  const int n_tiles = ((s.causal ? min(T_, q0 + kM) : T_) + kN - 1) / kN;
  const float sl2e = s.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2e)
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  // Running max of the raw scores q . k (scaled after: rounding is
  // monotonic, so max(s * scale) = max(s) * scale), and this thread's
  // share of the row sums, added across the quad at the end.
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kN;
    const uint32_t kt = k_s + (j & 1) * kTile, vt = v_s + (j & 1) * kTile;
    if (j + 1 < n_tiles) {
      const uint32_t next = ((j + 1) & 1) * kTile;
      load_tile_async<kN, W, kThreads>(k_s + next, kh, k0 + kN, T_, H, D);
      load_tile_async<kN, W, kThreads>(v_s + next, vh, k0 + kN, T_, H, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // Causal: a tile wholly above this warpgroup's diagonal adds nothing.
    if (!s.causal || k0 <= wg_q0 + 63) {
      float sc[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss(sc, kmajor_desc(q_s + wg * 64 * 128, kM, kk), kmajor_desc(kt, kN, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if (k0 + kN > T_ || (s.causal && k0 + kN - 1 > wg_q0)) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = k0 + i / 4 * 8 + 2 * quad + i % 2, r = row + i / 2 % 2 * 8;
          if (col >= T_ || (s.causal && col > r)) sc[i] = kNeg;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) mx[i / 2 % 2] = fmaxf(mx[i / 2 % 2], sc[i]);
      float alpha[2], mb[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f((m_run[h] - mx[h]) * sl2e);
        mb[h] = mx[h] * sl2e;
        m_run[h] = mx[h];
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2e, -mb[i / 2 % 2]));
        psum[i / 2 % 2] += sc[i];
      }
      uint32_t pa[kN / 16][4];
      to_a_operand<kN>(sc, pa);
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + psum[h];
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i] *= alpha[i / 2 % 2];

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs(acc, pa[kk], mnmajor_desc(vt, kN, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    den[h] = fmaxf(l_run[h], 1e-30f);
    const int t = row + 8 * h;
    if (quad == 0 && t < T_) {
      m_out[(size_t)bh * T_ + t] = m_run[h] * s.scale;
      l_out[(size_t)bh * T_ + t] = l_run[h];
    }
  }
  store_rows_bf16<W>(head(o, s, bh), acc, den, row, quad, T_, H, D);
}

// ------------------------------------------------------------ dK, dV, bf16
// P^T and dS^T of one q tile on the S^T and dP^T fragments (rows: keys,
// columns: the tile's queries), in the plain version's arithmetic:
// p = valid ? exp(s * scale - m) / max(l, 1e-30) : 0 and
// ds = p * (dO . v - delta) * scale. kMask: some (key, query) pair of the
// tile may be invalid (the diagonal, or rows at or past T).
template <bool kMask, int kM>
__device__ __forceinline__ void dkv_probs(float (&st)[kM / 2], float (&dpt)[kM / 2],
                                          const float* stats, int krow, int q0, int quad,
                                          const Shape& s) {
#pragma unroll
  for (int i = 0; i < kM / 2; ++i) {
    const int c = i / 4 * 8 + 2 * quad + i % 2;  // the query's place in the tile
    const int kr = krow + i / 2 % 2 * 8, qr = q0 + c;
    const bool valid = !kMask || (kr < s.T && qr < s.T && (!s.causal || kr <= qr));
    const float p =
        valid ? expf(__fmul_rn(st[i], s.scale) - stats[c]) / fmaxf(stats[kM + c], 1e-30f) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - stats[2 * kM + c]) * s.scale;
  }
}

// A block owns 64 key rows per warpgroup, holds its K and V tiles, and
// walks q tiles of 32 rows from the diagonal on, Q, dO and the tile's m, l
// and delta double-buffered. Per q tile and warpgroup: S^T = K Q^T and
// dP^T = V dO^T (64 x 32 f32 each, 16 registers a thread), P^T and dS^T on
// those fragments, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// packed to bf16 as the register A operand and dO, Q MN-major. dK and dV
// stay in registers for the whole walk and are written once. Shared
// memory: K, V and two stages of Q, dO and the statistics (35 KB at
// W = 64).
template <int W>
__global__ void __launch_bounds__(128 * kDkvWarpgroups, dkv_blocks_per_sm(W))
    flash_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ delta_in, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Shape s) {
  constexpr int kThreads = 128 * kDkvWarpgroups, kN = 64 * kDkvWarpgroups, kM = kDkvQRows;
  constexpr uint32_t kKV = kN * W * 2, kQ = kM * W * 2;
  constexpr uint32_t kStage = 2 * kQ + 1024;  // Q, dO, then m, l, delta (kM f32 each)
  extern __shared__ unsigned char smem[];
  const uint32_t k_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t v_s = k_s + kKV, stage0 = v_s + kKV;
  const unsigned char* smem_k = smem + (k_s - smem_addr(smem));  // generic address of k_s

  const int T_ = s.T, H = s.H, D = s.D, bh = blockIdx.x, k0 = blockIdx.y * kN;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int wg_k0 = k0 + wg * 64;
  const int krow = wg_k0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and krow + 8
  const __nv_bfloat16* qh = head(q, s, bh);
  const __nv_bfloat16* doh = head(dout, s, bh);
  const size_t stat0 = (size_t)bh * T_;
  // Causal: q tiles wholly above this block's diagonal see none of it.
  const int q_begin = s.causal ? k0 : 0;
  const int n_tiles = (T_ - q_begin + kM - 1) / kM;

  auto load_q_tile = [&](int j) {
    const uint32_t st = stage0 + (j & 1) * kStage;
    const int q0 = q_begin + j * kM;
    load_tile_async<kM, W, kThreads>(st, qh, q0, T_, H, D);
    load_tile_async<kM, W, kThreads>(st + kQ, doh, q0, T_, H, D);
    for (int i = threadIdx.x; i < 3 * kM; i += kThreads) {
      const int t = q0 + i % kM;
      const float* src = (i < kM ? m_in : i < 2 * kM ? l_in : delta_in) + stat0;
      cp_async4(st + 2 * kQ + i * 4, t < T_ ? src + t : src, t < T_);
    }
  };
  load_tile_async<kN, W, kThreads>(k_s, head(k, s, bh), k0, T_, H, D);
  load_tile_async<kN, W, kThreads>(v_s, head(v, s, bh), k0, T_, H, D);
  load_q_tile(0);
  cp_async_commit();

  float dk_acc[W / 2], dv_acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * kM;
    const uint32_t qt = stage0 + (j & 1) * kStage, dot = qt + kQ;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // Causal: skip the tile when this warpgroup's keys all follow its queries.
    if (!s.causal || wg_k0 <= q0 + kM - 1) {
      const float* stats = reinterpret_cast<const float*>(smem_k + (qt + 2 * kQ - k_s));
      float st[kM / 2], dpt[kM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss(st, kmajor_desc(k_s + wg * 64 * 128, kN, kk), kmajor_desc(qt, kM, kk), kk);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss(dpt, kmajor_desc(v_s + wg * 64 * 128, kN, kk), kmajor_desc(dot, kM, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      if ((s.causal && q0 < wg_k0 + 64) || q0 + kM > T_ || wg_k0 + 64 > T_)
        dkv_probs<true, kM>(st, dpt, stats, krow, q0, quad, s);
      else
        dkv_probs<false, kM>(st, dpt, stats, krow, q0, quad, s);
      uint32_t pa[kM / 16][4], da[kM / 16][4];
      to_a_operand<kM>(st, pa);
      to_a_operand<kM>(dpt, da);

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) wgmma_rs(dv_acc, pa[kk], mnmajor_desc(dot, kM, kk));
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) wgmma_rs(dk_acc, da[kk], mnmajor_desc(qt, kM, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16<W>(head(dk, s, bh), dk_acc, one, krow, quad, T_, H, D);
  store_rows_bf16<W>(head(dv, s, bh), dv_acc, one, krow, quad, T_, H, D);
}

// ------------------------------------------------------------------ launch
template <typename T> size_t smem_fwd(int D) {
  return sizeof(T) * (3 * kRows * ld_tile<T>(D) + kRows * ld_tile<T>(kRows)) +
         sizeof(float) * (kRows * ld_acc(kRows) + kRows * ld_acc(D));
}
template <typename T> size_t smem_dq(int D) {
  return sizeof(T) * (4 * kRows * ld_tile<T>(D) + kRows * ld_tile<T>(kRows)) +
         sizeof(float) * (2 * kRows * ld_acc(kRows) + kRows * ld_acc(D));
}
template <typename T> size_t smem_dkv(int D) {
  return sizeof(T) * (4 * kRows * ld_tile<T>(D) + 2 * kRows * ld_tile<T>(kRows)) +
         sizeof(float) * (2 * kRows * ld_acc(kRows) + 2 * kRows * ld_acc(D) + 3 * kRows);
}
// The wgmma kernels' tiles, plus 1024 bytes to align the first one.
constexpr size_t smem_fwd_wgmma(int W) {
  return (64 * kFwdWarpgroups + 4 * kFwdKvRows) * W * 2 + 1024;
}
constexpr size_t smem_dkv_wgmma(int W) {
  return 2 * 64 * kDkvWarpgroups * W * 2 + 2 * (2 * kDkvQRows * W * 2 + 1024) + 1024;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int B, int T, int H, int D) {
  return B < 1 || T < 1 || H < 1 || D < 16 || D > kMaxD || D % 16 != 0;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                       int B, Shape s, cudaStream_t stream) {
  const size_t smem = smem_fwd<T>(s.D);
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.T + kRows - 1) / kRows, B * s.H);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(m), static_cast<float*>(l), s);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* m,
                             void* l, int B, Shape s, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int kRowsPerBlock = 64 * kFwdWarpgroups;
  const size_t smem = smem_fwd_wgmma(W);
  cudaError_t err = prepare(flash_fwd_wgmma_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * s.H, (s.T + kRowsPerBlock - 1) / kRowsPerBlock);
  flash_fwd_wgmma_kernel<W><<<grid, 128 * kFwdWarpgroups, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(m), static_cast<float*>(l), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* m, const void* l, const void* delta, void* dq, int B, Shape s,
                      cudaStream_t stream) {
  const size_t smem = smem_dq<T>(s.D);
  cudaError_t err = prepare(flash_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.T + kRows - 1) / kRows, B * s.H);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dq), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* m, const void* l, const void* delta, void* dk, void* dv,
                       int B, Shape s, cudaStream_t stream) {
  const size_t smem = smem_dkv<T>(s.D);
  cudaError_t err = prepare(flash_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.T + kRows - 1) / kRows, B * s.H);
  flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* m, const void* l, const void* delta, void* dk,
                             void* dv, int B, Shape s, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int kRowsPerBlock = 64 * kDkvWarpgroups;
  const size_t smem = smem_dkv_wgmma(W);
  cudaError_t err = prepare(flash_dkv_wgmma_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * s.H, (s.T + kRowsPerBlock - 1) / kRowsPerBlock);
  flash_dkv_wgmma_kernel<W><<<grid, 128 * kDkvWarpgroups, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout and the outputs are contiguous (B, T, H, D), float32 for
// the *_f32 entry points, bfloat16 for the *_wgmma ones (width: the padded
// head width, 64 or 128, at least D); m, l and delta are contiguous
// (B, H, T) float32. dtype (dQ): 0 = float32, 1 = bfloat16. scale is
// 1/sqrt(D) rounded to f32. Each returns the cudaError_t of its launch
// (0 = cudaSuccess).
// Dynamic shared memory of a wgmma kernel's block at head width 64 or 128
// (kernel 0: forward, 1: dK/dV); 0 for another width.
int dtt_flash_wgmma_smem(int kernel, int width) {
  if (width != 64 && width != 128) return 0;
  return (int)(kernel == 0 ? smem_fwd_wgmma(width) : smem_dkv_wgmma(width));
}

int dtt_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                      int B, int T, int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  return (int)launch_fwd<float>(q, k, v, o, m, l, B, s, static_cast<cudaStream_t>(stream));
}

int dtt_flash_fwd_wgmma(int width, const void* q, const void* k, const void* v, void* o,
                        void* m, void* l, int B, int T, int H, int D, int causal, float scale,
                        void* stream) {
  if (bad_shape(B, T, H, D) || D > width) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 64) return (int)launch_fwd_wgmma<64>(q, k, v, o, m, l, B, s, st);
  if (width == 128) return (int)launch_fwd_wgmma<128>(q, k, v, o, m, l, B, s, st);
  return (int)cudaErrorInvalidValue;
}

int dtt_flash_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                 const void* m, const void* l, const void* delta, void* dq, int B, int T, int H,
                 int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dq<float>(q, k, v, dout, m, l, delta, dq, B, s, st);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, dout, m, l, delta, dq, B, s, st);
  return (int)cudaErrorInvalidValue;
}

int dtt_flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                      const void* m, const void* l, const void* delta, void* dk, void* dv, int B,
                      int T, int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  return (int)launch_dkv<float>(q, k, v, dout, m, l, delta, dk, dv, B, s,
                                static_cast<cudaStream_t>(stream));
}

int dtt_flash_dkv_wgmma(int width, const void* q, const void* k, const void* v,
                        const void* dout, const void* m, const void* l, const void* delta,
                        void* dk, void* dv, int B, int T, int H, int D, int causal, float scale,
                        void* stream) {
  if (bad_shape(B, T, H, D) || D > width) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 64)
    return (int)launch_dkv_wgmma<64>(q, k, v, dout, m, l, delta, dk, dv, B, s, st);
  if (width == 128)
    return (int)launch_dkv_wgmma<128>(q, k, v, dout, m, l, delta, dk, dv, B, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
