// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of distributed_tpu/ops/flash_attention.py.
// Three kernels here cover the six TPU kernels, because they read q, k, v
// (and dO) straight from the (B, T, H, D) layout the projections produce,
// by strides, with no transpose in either direction:
//   flash_fwd_kernel  <- _fwd_kernel (:83)  and _fwd_kernel_packed (:384)
//   flash_dq_kernel   <- _dq_kernel  (:199) and _dq_kernel_packed  (:448)
//   flash_dkv_kernel  <- _dkv_kernel (:238) and _dkv_kernel_packed (:490)
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
// causal, bf16) operations, not bytes: the forward does 51.5 GFLOP of
// products (52 us at 989 TFLOP/s) on 201 MB of q, k, v, out (60 us at
// 3.35 TB/s) -- the two are close, and the backward's 2-3x the products
// on similar bytes is operations-bound. So the products run on the tensor
// cores: nvcuda::wmma bf16 16x16x16 with f32 accumulation. A block is 4
// warps over a 64-row tile, each warp owning 16 rows, so a warp's softmax
// and its share of every product touch only its own rows and the warps
// meet only at tile loads. The loop over kv tiles (over q tiles for dK/dV)
// takes the place of the TPU's sequential grid dimension; tiles strictly
// above the diagonal are skipped. Each block owns the rows it writes, so
// no atomics. float32 inputs take the same path with CUDA-core products in
// full f32 (no TF32), for checks against the plain version.
//
// Simple first: tiles staged synchronously in shared memory (no cp.async,
// TMA or double buffering), wmma rather than wgmma, scores and
// accumulators kept in shared memory between the products. Its time beside
// its bound is in PERF.md.

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs). All
// of them are contiguous (B, T, H, D); m, l and delta are contiguous
// (B, H, T) float32. scale is 1/sqrt(D) rounded to f32. Each returns the
// cudaError_t of its launch (0 = cudaSuccess).
int dtt_flash_max_d() { return kMaxD; }

int dtt_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* m,
                  void* l, int B, int T, int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(q, k, v, o, m, l, B, s, st);
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(q, k, v, o, m, l, B, s, st);
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

int dtt_flash_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const void* m, const void* l, const void* delta, void* dk, void* dv, int B,
                  int T, int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dkv<float>(q, k, v, dout, m, l, delta, dk, dv, B, s, st);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, m, l, delta, dk, dv, B, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
