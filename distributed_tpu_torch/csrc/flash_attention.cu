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
// (batch, head), with scale = 1/sqrt(D) of the real head width (the
// wrapper pads narrow or ragged heads with zero columns, which add nothing
// to a score and give zero output columns) and valid(i, j) = j < T and,
// when causal, j <= i (masked scores are NEG = -1e30):
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
// similar bytes). Each block owns the rows it writes, so no atomics (every
// output is the same bits from run to run), and the loop over kv tiles
// (over q tiles for dK/dV) takes the place of the TPU's sequential grid
// dimension; tiles strictly above the diagonal are skipped.
//
// Two routes, chosen by dtype in the wrapper (flash_route):
// * bf16 and f16: flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel and
//   flash_dkv_wgmma_kernel (the Hopper section below): warpgroup products
//   (wgmma, hopper_wgmma.cuh) with the sums in registers, tiles brought in
//   by cp.async into a two-stage ring while the previous tile is
//   multiplied, softmax and the gradients' elementwise terms on the
//   register fragments. Head widths are padded to W = 64, 128 or 256 in
//   shared memory (zero columns add nothing); at W = 256 the block's
//   output columns are one 128-column half (blockIdx.z), the scores still
//   taken over all 256.
// * float32: flash_fwd_f32_kernel, flash_dq_f32_kernel and
//   flash_dkv_f32_kernel, on the CUDA cores in full f32 (no TF32, for
//   checks against the plain version): a block of R / 16 warps over an
//   R-row tile (R = 64, or 32 where a 64-row block's tiles would not fit
//   in shared memory), tiles staged synchronously, scores and
//   accumulators kept in shared memory between the products.
// Their times beside their bounds are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;
constexpr size_t kSmemLimit = 232448;  // shared memory a block can use

struct Shape {
  int T, H, D, causal;
  float scale;
};

// Element (b, 0, h, 0) of a (B, T, H, D) tensor.
template <typename T> __device__ __forceinline__ T* head(T* p, const Shape& s, int bh) {
  const int b = bh / s.H, h = bh - b * s.H;
  return p + ((size_t)b * s.T * s.H + h) * s.D;
}

// ================================================================ float32
// Leading dimensions in shared memory: tiles padded by 1 (an odd stride,
// so a column walk hits every bank once), accumulators by 4.
__host__ __device__ constexpr int ld_tile(int cols) { return cols + 1; }
__host__ __device__ constexpr int ld_acc(int cols) { return cols + 4; }

// C (16 x N, row-major, ldc) = [C +] A (16 x K) @ B (K x N), for one warp
// on the CUDA cores. A is row-major (ld lda). B is row-major, B(k, n) =
// B[k * ldb + n], or column-major, B(k, n) = B[k + n * ldb].
template <bool kBColMajor, bool kAccumulate>
__device__ __forceinline__ void warp_mm(const float* A, int lda, const float* B, int ldb, float* C,
                                        int ldc, int N, int K) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * N; e += 32) {
    const int i = e / N, n = e - i * N;
    float acc = kAccumulate ? C[i * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) acc += A[i * lda + k] * (kBColMajor ? B[k + n * ldb] : B[k * ldb + n]);
    C[i * ldc + n] = acc;
  }
  __syncwarp();
}

// Copies R rows [row0, row0 + R) of one head of a (B, T, H, D) tensor (D a
// multiple of 4) into shared memory (ld ldt); rows at or past T read as
// zeros. src points at element (b, 0, h, 0). All 2R threads take part.
template <int R>
__device__ __forceinline__ void load_tile(float* dst, int ldt, const float* src, int row0, int T_,
                                          int H, int D) {
  const int vpr = D / 4;
  for (int idx = threadIdx.x; idx < R * vpr; idx += 2 * R) {
    const int r = idx / vpr, c = (idx - r * vpr) * 4;
    const int t = row0 + r;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T_) u = *reinterpret_cast<const float4*>(src + (size_t)t * H * D + c);
    dst[r * ldt + c] = u.x;
    dst[r * ldt + c + 1] = u.y;
    dst[r * ldt + c + 2] = u.z;
    dst[r * ldt + c + 3] = u.w;
  }
}

// Zeroes this warp's 16 rows of an accumulator (cols wide).
__device__ __forceinline__ void zero_rows(float* acc, int ld, int cols) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * cols; e += 32) acc[(e / cols) * ld + e % cols] = 0.f;
  __syncwarp();
}

// Writes this warp's 16 accumulator rows to one head of a (B, T, H, D)
// tensor: lane l handles row l / 2, half l % 2 (D is even).
__device__ __forceinline__ void store_rows(float* dst, const float* acc, int ld, int row0, int T_,
                                           int H, int D) {
  const int lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  const int t = row0 + r;
  if (t >= T_) return;
  float* out = dst + (size_t)t * H * D;
  for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) out[d] = acc[r * ld + d];
}

// ----------------------------------------------------------------- forward
template <int R>
__global__ void __launch_bounds__(2 * R)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, Shape s) {
  constexpr int kHalf = R / 2;  // columns of a kv tile per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile(D), ldp = ld_tile(R);
  const int lds = ld_acc(R), ldo = ld_acc(D);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + R * ldt;
  float* v_s = k_s + R * ldt;
  float* p_s = v_s + R * ldt;
  float* s_s = p_s + R * ldp;
  float* o_s = s_s + R * lds;

  const int bh = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * 16 + r;  // this lane's query row
  const float* qh = head(q, s, bh);
  const float* kh = head(k, s, bh);
  const float* vh = head(v, s, bh);

  float* pw = p_s + warp * 16 * ldp;
  float* sw = s_s + warp * 16 * lds;
  float* ow = o_s + warp * 16 * ldo;
  load_tile<R>(q_s, ldt, qh, q0, s.T, s.H, D);
  zero_rows(ow, ldo, D);
  float m = kNeg, l = 0.f;

  const int kv_end = s.causal ? min(s.T, q0 + R) : s.T;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();  // every warp is done with the previous k/v tiles
    load_tile<R>(k_s, ldt, kh, k0, s.T, s.H, D);
    load_tile<R>(v_s, ldt, vh, k0, s.T, s.H, D);
    __syncthreads();
    warp_mm<true, false>(q_s + warp * 16 * ldt, ldt, k_s, ldt, sw, lds, R, D);

    // Online softmax over this lane's half row.
    float sc[kHalf];
    float m_cur = kNeg;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const int col = k0 + half * kHalf + c;
      const bool valid = col < s.T && (!s.causal || col <= row);
      sc[c] = valid ? __fmul_rn(sw[r * lds + half * kHalf + c], s.scale) : kNeg;
      m_cur = fmaxf(m_cur, sc[c]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const float p = expf(sc[c] - m_new);
      psum += p;
      pw[r * ldp + half * kHalf + c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) ow[r * ldo + d] *= alpha;
    __syncwarp();
    warp_mm<false, true>(pw, ldp, v_s, ldt, ow, ldo, D, R);
  }
  // out = acc / max(l, 1e-30): divide, as the TPU kernel does.
  if (row < s.T) {
    float* orow = head(o, s, bh) + (size_t)row * s.H * D;
    const float denom = fmaxf(l, 1e-30f);
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) orow[d] = ow[r * ldo + d] / denom;
    if (half == 0) {
      m_out[(size_t)bh * s.T + row] = m;
      l_out[(size_t)bh * s.T + row] = l;
    }
  }
}

// ---------------------------------------------------------------------- dQ
template <int R>
__global__ void __launch_bounds__(2 * R)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        const float* __restrict__ delta_in, float* __restrict__ dq, Shape s) {
  constexpr int kHalf = R / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile(D), ldp = ld_tile(R);
  const int lds = ld_acc(R), ldo = ld_acc(D);
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + R * ldt;
  float* k_s = do_s + R * ldt;
  float* v_s = k_s + R * ldt;
  float* ds_s = v_s + R * ldt;
  float* s_s = ds_s + R * ldp;
  float* dp_s = s_s + R * lds;
  float* dq_s = dp_s + R * lds;

  const int bh = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * 16 + r;
  const float* kh = head(k, s, bh);
  const float* vh = head(v, s, bh);
  load_tile<R>(q_s, ldt, head(q, s, bh), q0, s.T, s.H, D);
  load_tile<R>(do_s, ldt, head(dout, s, bh), q0, s.T, s.H, D);
  const size_t stat = (size_t)bh * s.T + row;
  const float m = row < s.T ? m_in[stat] : 0.f;
  const float l = row < s.T ? fmaxf(l_in[stat], 1e-30f) : 1.f;
  const float delta = row < s.T ? delta_in[stat] : 0.f;

  float* dsw = ds_s + warp * 16 * ldp;
  float* sw = s_s + warp * 16 * lds;
  float* dpw = dp_s + warp * 16 * lds;
  float* dqw = dq_s + warp * 16 * ldo;
  zero_rows(dqw, ldo, D);

  const int kv_end = s.causal ? min(s.T, q0 + R) : s.T;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();
    load_tile<R>(k_s, ldt, kh, k0, s.T, s.H, D);
    load_tile<R>(v_s, ldt, vh, k0, s.T, s.H, D);
    __syncthreads();
    warp_mm<true, false>(q_s + warp * 16 * ldt, ldt, k_s, ldt, sw, lds, R, D);
    warp_mm<true, false>(do_s + warp * 16 * ldt, ldt, v_s, ldt, dpw, lds, R, D);
#pragma unroll 4
    for (int c = half * kHalf; c < half * kHalf + kHalf; ++c) {
      const int col = k0 + c;
      const bool valid = row < s.T && col < s.T && (!s.causal || col <= row);
      const float p = valid ? expf(__fmul_rn(sw[r * lds + c], s.scale) - m) / l : 0.f;
      dsw[r * ldp + c] = p * (dpw[r * lds + c] - delta) * s.scale;
    }
    __syncwarp();
    warp_mm<false, true>(dsw, ldp, k_s, ldt, dqw, ldo, D, R);
  }
  store_rows(head(dq, s, bh), dqw, ldo, q0 + warp * 16, s.T, s.H, D);
}

// ------------------------------------------------------------------ dK, dV
template <int R>
__global__ void __launch_bounds__(2 * R)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ delta_in, float* __restrict__ dk,
                         float* __restrict__ dv, Shape s) {
  constexpr int kHalf = R / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = s.D, ldt = ld_tile(D), ldp = ld_tile(R);
  const int lds = ld_acc(R), ldo = ld_acc(D);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + R * ldt;
  float* q_s = v_s + R * ldt;
  float* do_s = q_s + R * ldt;
  float* pt_s = do_s + R * ldt;
  float* dst_s = pt_s + R * ldp;
  float* st_s = dst_s + R * ldp;
  float* dpt_s = st_s + R * lds;
  float* dk_s = dpt_s + R * lds;
  float* dv_s = dk_s + R * ldo;
  float* m_s = dv_s + R * ldo;
  float* l_s = m_s + R;
  float* delta_s = l_s + R;

  const int bh = blockIdx.y, k0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int krow = k0 + warp * 16 + r;  // this lane's key row
  const float* qh = head(q, s, bh);
  const float* doh = head(dout, s, bh);
  load_tile<R>(k_s, ldt, head(k, s, bh), k0, s.T, s.H, D);
  load_tile<R>(v_s, ldt, head(v, s, bh), k0, s.T, s.H, D);

  float* ptw = pt_s + warp * 16 * ldp;
  float* dstw = dst_s + warp * 16 * ldp;
  float* stw = st_s + warp * 16 * lds;
  float* dptw = dpt_s + warp * 16 * lds;
  float* dkw = dk_s + warp * 16 * ldo;
  float* dvw = dv_s + warp * 16 * ldo;
  zero_rows(dkw, ldo, D);
  zero_rows(dvw, ldo, D);

  // Causal: q tiles wholly above this kv tile's diagonal see none of it.
  const int q_begin = s.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < s.T; q0 += R) {
    __syncthreads();
    load_tile<R>(q_s, ldt, qh, q0, s.T, s.H, D);
    load_tile<R>(do_s, ldt, doh, q0, s.T, s.H, D);
    for (int i = threadIdx.x; i < R; i += 2 * R) {
      const int t = q0 + i;
      const size_t stat = (size_t)bh * s.T + t;
      m_s[i] = t < s.T ? m_in[stat] : 0.f;
      l_s[i] = t < s.T ? fmaxf(l_in[stat], 1e-30f) : 1.f;
      delta_s[i] = t < s.T ? delta_in[stat] : 0.f;
    }
    __syncthreads();
    // Transposed scores: this warp's 16 key rows against the R q rows.
    warp_mm<true, false>(k_s + warp * 16 * ldt, ldt, q_s, ldt, stw, lds, R, D);
    warp_mm<true, false>(v_s + warp * 16 * ldt, ldt, do_s, ldt, dptw, lds, R, D);
#pragma unroll 4
    for (int c = half * kHalf; c < half * kHalf + kHalf; ++c) {
      const int qrow = q0 + c;
      const bool valid = krow < s.T && qrow < s.T && (!s.causal || krow <= qrow);
      const float p = valid ? expf(__fmul_rn(stw[r * lds + c], s.scale) - m_s[c]) / l_s[c] : 0.f;
      ptw[r * ldp + c] = p;
      dstw[r * ldp + c] = p * (dptw[r * lds + c] - delta_s[c]) * s.scale;
    }
    __syncwarp();
    warp_mm<false, true>(ptw, ldp, do_s, ldt, dvw, ldo, D, R);
    warp_mm<false, true>(dstw, ldp, q_s, ldt, dkw, ldo, D, R);
  }
  store_rows(head(dk, s, bh), dkw, ldo, k0 + warp * 16, s.T, s.H, D);
  store_rows(head(dv, s, bh), dvw, ldo, k0 + warp * 16, s.T, s.H, D);
}

// Shared memory of the f32 kernels' blocks at tile rows R and width D.
constexpr size_t smem_fwd_f32(int R, int D) {
  return 4 * ((size_t)3 * R * ld_tile(D) + R * ld_tile(R) + R * ld_acc(R) + R * ld_acc(D));
}
constexpr size_t smem_dq_f32(int R, int D) {
  return 4 * ((size_t)4 * R * ld_tile(D) + R * ld_tile(R) + 2 * R * ld_acc(R) + R * ld_acc(D));
}
constexpr size_t smem_dkv_f32(int R, int D) {
  return 4 * ((size_t)4 * R * ld_tile(D) + 2 * R * ld_tile(R) + 2 * R * ld_acc(R) +
              2 * R * ld_acc(D) + 3 * R);
}

// =============================================================== 16-bit
// The bf16 and f16 kernels, designed for Hopper. A block is one or two
// warpgroups; each issues wgmma.m64nNk16 over its own 64 rows, so the
// statistics of a row never leave the four threads of its quad. No
// producer warp: every thread issues its share of the next tile's
// cp.async copies before the products of the current tile, and waits for
// them only after.

constexpr float kLog2e = 1.4426950408889634f;

// Output columns of one block at padded width W: all of them up to 128,
// one 128-column half (blockIdx.z) at 256, so that no accumulator needs
// more than 64 registers a thread.
__host__ __device__ constexpr int out_width(int W) { return W < 128 ? W : 128; }

// Writes rows row and row + 8 of a warpgroup's 64 x WO accumulator,
// divided by den[h], to a (B, T, H, D) tensor (dst at element (b, 0, h,
// col0) of the block's first output column; rows ld elements apart);
// rows at or past T and columns at or past cols are not written.
template <typename T, int WO>
__device__ __forceinline__ void store_rows16(T* dst, const float (&acc)[WO / 2],
                                             const float (&den)[2], int row, int quad, int T_,
                                             size_t ld, int cols) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h;
    if (t >= T_) continue;
    T* out = dst + (size_t)t * ld;
#pragma unroll
    for (int n = 0; n < WO / 8; ++n) {
      const int col = 8 * n + 2 * quad;
      if (col < cols)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2<T>(acc[4 * n + 2 * h] / den[h], acc[4 * n + 2 * h + 1] / den[h]);
    }
  }
}

// Block shapes of the wgmma kernels: warpgroups a block (64 rows each),
// blocks an SM holds at once (which caps a thread's registers at 65536 /
// (128 * warpgroups * blocks); blocks of one SM run out of step, so one
// block's elementwise work overlaps another's products), and the rows of
// the tiles the block walks. dK/dV takes q tiles of 32 rows so that its
// four 64 x 32 fragments fit beside dK and dV in 168 registers (three
// blocks an SM) without spilling; at 64 rows it spills. dQ: one
// warpgroup, kv tiles of 32 rows (S and dP 16 registers each beside dQ's
// 32 at W = 64), four blocks an SM at W = 64, no spills; the other shapes
// timed (PERF.md) were slower or spilled, and at W = 256 kv tiles of 64
// rows spill beside dQ's 64 registers.
constexpr int kFwdWarpgroups = 2, kDkvWarpgroups = 1, kDqWarpgroups = 1;
__host__ __device__ constexpr int fwd_blocks_per_sm(int W) { return W == 64 ? 2 : 1; }
__host__ __device__ constexpr int dkv_blocks_per_sm(int W) {
  return W == 64 ? 3 : W == 128 ? 2 : 1;
}
__host__ __device__ constexpr int dq_blocks_per_sm(int W) {
  return W == 64 ? 4 : W == 128 ? 2 : 1;
}
constexpr int kFwdKvRows = 64;  // kv rows of a forward tile
constexpr int kDqKvRows = 32;   // kv rows of a dQ tile
constexpr int kDkvQRows = 32;   // q rows of a dK/dV tile

// ----------------------------------------------------------- forward, 16-bit
// A block owns 64 query rows per warpgroup and walks kv tiles of 64 rows,
// K and V double-buffered: S = Q K^T (64 x 64 f32 a warpgroup, 32
// registers a thread), the online softmax on those registers (row max and
// sum across the quad by shuffles), O rescaled in registers, then O += P V
// with P packed to 16 bits as the register A operand and V MN-major. O
// never leaves registers until the epilogue. Blocks run the heaviest
// causal q tiles first, so the tail of the grid is light. Shared memory:
// Q plus two stages of K and of V's output columns (49 KB at W = 64).
template <typename T, int W>
__global__ void __launch_bounds__(128 * kFwdWarpgroups, fwd_blocks_per_sm(W))
    flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, Shape s) {
  constexpr int kThreads = 128 * kFwdWarpgroups, kM = 64 * kFwdWarpgroups, kN = kFwdKvRows;
  constexpr int WO = out_width(W);
  constexpr uint32_t kKTile = kN * W * 2, kVTile = kN * WO * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kM * W * 2, v_s = k_s + 2 * kKTile;  // stage i at + i * tile

  const int T_ = s.T, D = s.D, bh = blockIdx.x, col0 = blockIdx.z * WO;
  const size_t ld = (size_t)s.H * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int wg_q0 = q0 + wg * 64;
  const int row = wg_q0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and row + 8
  const T* kh = head(k, s, bh);
  const T* vh = head(v, s, bh) + col0;
  load_tile_async<kM, W, kThreads>(q_s, head(q, s, bh), q0, T_, ld, D);
  load_tile_async<kN, W, kThreads>(k_s, kh, 0, T_, ld, D);
  load_tile_async<kN, WO, kThreads>(v_s, vh, 0, T_, ld, D - col0);
  cp_async_commit();

  const int n_tiles = ((s.causal ? min(T_, q0 + kM) : T_) + kN - 1) / kN;
  const float sl2e = s.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2e)
  float acc[WO / 2];
#pragma unroll
  for (int i = 0; i < WO / 2; ++i) acc[i] = 0.f;
  // Running max of the raw scores q . k (scaled after: rounding is
  // monotonic, so max(s * scale) = max(s) * scale), and this thread's
  // share of the row sums, added across the quad at the end.
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kN;
    const uint32_t kt = k_s + (j & 1) * kKTile, vt = v_s + (j & 1) * kVTile;
    if (j + 1 < n_tiles) {
      load_tile_async<kN, W, kThreads>(k_s + ((j + 1) & 1) * kKTile, kh, k0 + kN, T_, ld, D);
      load_tile_async<kN, WO, kThreads>(v_s + ((j + 1) & 1) * kVTile, vh, k0 + kN, T_, ld,
                                        D - col0);
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
        wgmma_ss<T, 0>(sc, kmajor_desc(q_s + wg * 64 * 128, kM, kk), kmajor_desc(kt, kN, kk), kk);
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
      to_a_operand<T, kN>(sc, pa);
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + psum[h];
#pragma unroll
      for (int i = 0; i < WO / 2; ++i) acc[i] *= alpha[i / 2 % 2];

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs<T>(acc, pa[kk], mnmajor_desc(vt, kN, kk));
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
    if (blockIdx.z == 0 && quad == 0 && t < T_) {
      m_out[(size_t)bh * T_ + t] = m_run[h] * s.scale;
      l_out[(size_t)bh * T_ + t] = l_run[h];
    }
  }
  store_rows16<T, WO>(head(o, s, bh) + col0, acc, den, row, quad, T_, ld, D - col0);
}

// ---------------------------------------------------------------- dQ, 16-bit
// A block owns 64 query rows per warpgroup, loads its Q and dO tiles once
// and keeps each row's m, l and delta in the registers of its quad, and
// walks kv tiles of kDqKvRows rows from the first to the diagonal, K and V
// double-buffered. Per kv tile and warpgroup: S = Q K^T and dP = dO V^T
// (K and V K-major; 64 x kN f32 each), P and dS on those fragments in the
// plain version's arithmetic, then dQ += dS K with dS packed to 16 bits
// as the register A operand and K MN-major (the transpose bit). dQ stays
// in registers for the whole walk and is written once. Only diagonal and
// ragged tiles are masked; blocks run the heaviest causal q tiles first.
// Shared memory: Q, dO and two stages of K and V (33 KB at W = 64 with one
// warpgroup and kv tiles of 32).
template <bool kMask, int kN>
__device__ __forceinline__ void dq_probs(float (&sc)[kN / 2], const float (&dp)[kN / 2],
                                         const float (&m)[2], const float (&l)[2],
                                         const float (&delta)[2], int row, int k0, int quad,
                                         const Shape& s) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = i / 2 % 2;
    const int col = k0 + i / 4 * 8 + 2 * quad + i % 2, r = row + 8 * h;
    const bool valid = !kMask || (col < s.T && (!s.causal || col <= r));
    const float p = valid ? expf(__fmul_rn(sc[i], s.scale) - m[h]) / l[h] : 0.f;
    sc[i] = p * (dp[i] - delta[h]) * s.scale;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(128 * kDqWarpgroups, dq_blocks_per_sm(W))
    flash_dq_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta_in, T* __restrict__ dq, Shape s) {
  constexpr int kThreads = 128 * kDqWarpgroups, kM = 64 * kDqWarpgroups, kN = kDqKvRows;
  constexpr int WO = out_width(W);
  constexpr uint32_t kQTile = kM * W * 2, kTile = kN * W * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQTile, k_s = do_s + kQTile, v_s = k_s + 2 * kTile;

  const int T_ = s.T, D = s.D, bh = blockIdx.x, col0 = blockIdx.z * WO;
  const size_t ld = (size_t)s.H * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int wg_q0 = q0 + wg * 64;
  const int row = wg_q0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and row + 8
  const T* kh = head(k, s, bh);
  const T* vh = head(v, s, bh);
  load_tile_async<kM, W, kThreads>(q_s, head(q, s, bh), q0, T_, ld, D);
  load_tile_async<kM, W, kThreads>(do_s, head(dout, s, bh), q0, T_, ld, D);
  load_tile_async<kN, W, kThreads>(k_s, kh, 0, T_, ld, D);
  load_tile_async<kN, W, kThreads>(v_s, vh, 0, T_, ld, D);
  cp_async_commit();

  // Rows at or past T: any finite stand-ins (their dQ is not written).
  float m[2], l[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h;
    const size_t stat = (size_t)bh * T_ + t;
    m[h] = t < T_ ? m_in[stat] : 0.f;
    l[h] = t < T_ ? fmaxf(l_in[stat], 1e-30f) : 1.f;
    delta[h] = t < T_ ? delta_in[stat] : 0.f;
  }

  const int n_tiles = ((s.causal ? min(T_, q0 + kM) : T_) + kN - 1) / kN;
  float dq_acc[WO / 2];
#pragma unroll
  for (int i = 0; i < WO / 2; ++i) dq_acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kN;
    const uint32_t kt = k_s + (j & 1) * kTile, vt = v_s + (j & 1) * kTile;
    if (j + 1 < n_tiles) {
      load_tile_async<kN, W, kThreads>(k_s + ((j + 1) & 1) * kTile, kh, k0 + kN, T_, ld, D);
      load_tile_async<kN, W, kThreads>(v_s + ((j + 1) & 1) * kTile, vh, k0 + kN, T_, ld, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // Causal: a tile wholly above this warpgroup's diagonal adds nothing.
    if (!s.causal || k0 <= wg_q0 + 63) {
      float sc[kN / 2], dp[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss<T, 0>(sc, kmajor_desc(q_s + wg * 64 * 128, kM, kk), kmajor_desc(kt, kN, kk), kk);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss<T, 0>(dp, kmajor_desc(do_s + wg * 64 * 128, kM, kk), kmajor_desc(vt, kN, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      if (k0 + kN > T_ || (s.causal && k0 + kN - 1 > wg_q0))
        dq_probs<true, kN>(sc, dp, m, l, delta, row, k0, quad, s);
      else
        dq_probs<false, kN>(sc, dp, m, l, delta, row, k0, quad, s);
      uint32_t da[kN / 16][4];
      to_a_operand<T, kN>(sc, da);

      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<T>(dq_acc, da[kk], mnmajor_desc(kt + (col0 / 64) * kN * 128, kN, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }
  const float one[2] = {1.f, 1.f};
  store_rows16<T, WO>(head(dq, s, bh) + col0, dq_acc, one, row, quad, T_, ld, D - col0);
}

// ------------------------------------------------------------ dK, dV, 16-bit
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
// packed to 16 bits as the register A operand and dO, Q MN-major (their
// output columns' half at W = 256). dK and dV stay in registers for the
// whole walk and are written once. Shared memory: K, V and two stages of
// Q, dO and the statistics (35 KB at W = 64).
template <typename T, int W>
__global__ void __launch_bounds__(128 * kDkvWarpgroups, dkv_blocks_per_sm(W))
    flash_dkv_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ delta_in, T* __restrict__ dk,
                           T* __restrict__ dv, Shape s) {
  constexpr int kThreads = 128 * kDkvWarpgroups, kN = 64 * kDkvWarpgroups, kM = kDkvQRows;
  constexpr int WO = out_width(W);
  constexpr uint32_t kKV = kN * W * 2, kQ = kM * W * 2;
  constexpr uint32_t kStage = 2 * kQ + 1024;  // Q, dO, then m, l, delta (kM f32 each)
  extern __shared__ unsigned char smem[];
  const uint32_t k_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t v_s = k_s + kKV, stage0 = v_s + kKV;
  const unsigned char* smem_k = smem + (k_s - smem_addr(smem));  // generic address of k_s

  const int T_ = s.T, D = s.D, bh = blockIdx.x, k0 = blockIdx.y * kN, col0 = blockIdx.z * WO;
  const size_t ld = (size_t)s.H * D;
  const uint32_t half = (col0 / 64) * kM * 128;  // the output columns' block in a q tile
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, quad = lane % 4;
  const int wg_k0 = k0 + wg * 64;
  const int krow = wg_k0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // and krow + 8
  const T* qh = head(q, s, bh);
  const T* doh = head(dout, s, bh);
  const size_t stat0 = (size_t)bh * T_;
  // Causal: q tiles wholly above this block's diagonal see none of it.
  const int q_begin = s.causal ? k0 : 0;
  const int n_tiles = (T_ - q_begin + kM - 1) / kM;

  auto load_q_tile = [&](int j) {
    const uint32_t st = stage0 + (j & 1) * kStage;
    const int q0 = q_begin + j * kM;
    load_tile_async<kM, W, kThreads>(st, qh, q0, T_, ld, D);
    load_tile_async<kM, W, kThreads>(st + kQ, doh, q0, T_, ld, D);
    for (int i = threadIdx.x; i < 3 * kM; i += kThreads) {
      const int t = q0 + i % kM;
      const float* src = (i < kM ? m_in : i < 2 * kM ? l_in : delta_in) + stat0;
      cp_async4(st + 2 * kQ + i * 4, t < T_ ? src + t : src, t < T_);
    }
  };
  load_tile_async<kN, W, kThreads>(k_s, head(k, s, bh), k0, T_, ld, D);
  load_tile_async<kN, W, kThreads>(v_s, head(v, s, bh), k0, T_, ld, D);
  load_q_tile(0);
  cp_async_commit();

  float dk_acc[WO / 2], dv_acc[WO / 2];
#pragma unroll
  for (int i = 0; i < WO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
        wgmma_ss<T, 0>(st, kmajor_desc(k_s + wg * 64 * 128, kN, kk), kmajor_desc(qt, kM, kk), kk);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss<T, 0>(dpt, kmajor_desc(v_s + wg * 64 * 128, kN, kk), kmajor_desc(dot, kM, kk),
                       kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      if ((s.causal && q0 < wg_k0 + 64) || q0 + kM > T_ || wg_k0 + 64 > T_)
        dkv_probs<true, kM>(st, dpt, stats, krow, q0, quad, s);
      else
        dkv_probs<false, kM>(st, dpt, stats, krow, q0, quad, s);
      uint32_t pa[kM / 16][4], da[kM / 16][4];
      to_a_operand<T, kM>(st, pa);
      to_a_operand<T, kM>(dpt, da);

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
        wgmma_rs<T>(dv_acc, pa[kk], mnmajor_desc(dot + half, kM, kk));
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
        wgmma_rs<T>(dk_acc, da[kk], mnmajor_desc(qt + half, kM, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }
  const float one[2] = {1.f, 1.f};
  store_rows16<T, WO>(head(dk, s, bh) + col0, dk_acc, one, krow, quad, T_, ld, D - col0);
  store_rows16<T, WO>(head(dv, s, bh) + col0, dv_acc, one, krow, quad, T_, ld, D - col0);
}

// The wgmma kernels' tiles, plus 1024 bytes to align the first one.
constexpr size_t smem_fwd_wgmma(int W) {
  return (64 * kFwdWarpgroups * W + 2 * kFwdKvRows * (W + out_width(W))) * 2 + 1024;
}
constexpr size_t smem_dq_wgmma(int W) {
  return (2 * 64 * kDqWarpgroups * W + 4 * kDqKvRows * W) * 2 + 1024;
}
constexpr size_t smem_dkv_wgmma(int W) {
  return 2 * 64 * kDkvWarpgroups * W * 2 + 2 * (2 * kDkvQRows * W * 2 + 1024) + 1024;
}
static_assert(smem_fwd_wgmma(256) <= kSmemLimit && smem_dq_wgmma(256) <= kSmemLimit &&
                  smem_dkv_wgmma(256) <= kSmemLimit,
              "the W = 256 blocks fit in shared memory");

// ------------------------------------------------------------------ launch
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int B, int T, int H, int D) {
  return B < 1 || T < 1 || H < 1 || D < 1 || D > kMaxD;
}

struct Ptrs {
  const void *q, *k, *v, *dout, *m_in, *l_in, *delta;
  void *o, *m_out, *l_out, *dq, *dk, *dv;
};

// kernel: 0 forward, 1 dQ, 2 dK/dV.
template <int R>
cudaError_t launch_f32(int kernel, const Ptrs& p, int B, const Shape& s, cudaStream_t st) {
  const dim3 grid((s.T + R - 1) / R, B * s.H);
  auto in = [](const void* x) { return static_cast<const float*>(x); };
  auto out = [](void* x) { return static_cast<float*>(x); };
  cudaError_t err;
  if (kernel == 0) {
    const size_t smem = smem_fwd_f32(R, s.D);
    if ((err = prepare(flash_fwd_f32_kernel<R>, smem)) != cudaSuccess) return err;
    flash_fwd_f32_kernel<R><<<grid, 2 * R, smem, st>>>(in(p.q), in(p.k), in(p.v), out(p.o),
                                                       out(p.m_out), out(p.l_out), s);
  } else if (kernel == 1) {
    const size_t smem = smem_dq_f32(R, s.D);
    if ((err = prepare(flash_dq_f32_kernel<R>, smem)) != cudaSuccess) return err;
    flash_dq_f32_kernel<R><<<grid, 2 * R, smem, st>>>(in(p.q), in(p.k), in(p.v), in(p.dout),
                                                      in(p.m_in), in(p.l_in), in(p.delta),
                                                      out(p.dq), s);
  } else {
    const size_t smem = smem_dkv_f32(R, s.D);
    if ((err = prepare(flash_dkv_f32_kernel<R>, smem)) != cudaSuccess) return err;
    flash_dkv_f32_kernel<R><<<grid, 2 * R, smem, st>>>(in(p.q), in(p.k), in(p.v), in(p.dout),
                                                       in(p.m_in), in(p.l_in), in(p.delta),
                                                       out(p.dk), out(p.dv), s);
  }
  return cudaGetLastError();
}

// The f32 kernels take 64-row tiles where those fit in shared memory at
// this D, 32-row tiles otherwise (D above 96-128, by kernel).
cudaError_t launch_f32(int kernel, const Ptrs& p, int B, const Shape& s, cudaStream_t st) {
  const size_t smem64 = kernel == 0   ? smem_fwd_f32(64, s.D)
                        : kernel == 1 ? smem_dq_f32(64, s.D)
                                      : smem_dkv_f32(64, s.D);
  return smem64 <= kSmemLimit ? launch_f32<64>(kernel, p, B, s, st)
                              : launch_f32<32>(kernel, p, B, s, st);
}

template <typename T, int W>
cudaError_t launch_wgmma(int kernel, const Ptrs& p, int B, const Shape& s, cudaStream_t st) {
  auto in = [](const void* x) { return static_cast<const T*>(x); };
  auto out = [](void* x) { return static_cast<T*>(x); };
  auto fin = [](const void* x) { return static_cast<const float*>(x); };
  constexpr int kZ = W / out_width(W);
  cudaError_t err;
  if (kernel == 0) {
    constexpr int kRows = 64 * kFwdWarpgroups;
    const size_t smem = smem_fwd_wgmma(W);
    if ((err = prepare(flash_fwd_wgmma_kernel<T, W>, smem)) != cudaSuccess) return err;
    const dim3 grid(B * s.H, (s.T + kRows - 1) / kRows, kZ);
    flash_fwd_wgmma_kernel<T, W><<<grid, 128 * kFwdWarpgroups, smem, st>>>(
        in(p.q), in(p.k), in(p.v), out(p.o), static_cast<float*>(p.m_out),
        static_cast<float*>(p.l_out), s);
  } else if (kernel == 1) {
    constexpr int kRows = 64 * kDqWarpgroups;
    const size_t smem = smem_dq_wgmma(W);
    if ((err = prepare(flash_dq_wgmma_kernel<T, W>, smem)) != cudaSuccess) return err;
    const dim3 grid(B * s.H, (s.T + kRows - 1) / kRows, kZ);
    flash_dq_wgmma_kernel<T, W><<<grid, 128 * kDqWarpgroups, smem, st>>>(
        in(p.q), in(p.k), in(p.v), in(p.dout), fin(p.m_in), fin(p.l_in), fin(p.delta),
        out(p.dq), s);
  } else {
    constexpr int kRows = 64 * kDkvWarpgroups;
    const size_t smem = smem_dkv_wgmma(W);
    if ((err = prepare(flash_dkv_wgmma_kernel<T, W>, smem)) != cudaSuccess) return err;
    const dim3 grid(B * s.H, (s.T + kRows - 1) / kRows, kZ);
    flash_dkv_wgmma_kernel<T, W><<<grid, 128 * kDkvWarpgroups, smem, st>>>(
        in(p.q), in(p.k), in(p.v), in(p.dout), fin(p.m_in), fin(p.l_in), fin(p.delta),
        out(p.dk), out(p.dv), s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(int kernel, int width, const Ptrs& p, int B, const Shape& s,
                         cudaStream_t st) {
  if (s.D > width || s.D % 8) return cudaErrorInvalidValue;  // 16-byte rows
  if (width == 64) return launch_wgmma<T, 64>(kernel, p, B, s, st);
  if (width == 128) return launch_wgmma<T, 128>(kernel, p, B, s, st);
  if (width == 256) return launch_wgmma<T, 256>(kernel, p, B, s, st);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32 (CUDA cores; width unused), 1 = bfloat16, 2 = float16
// (wgmma at the padded width 64, 128 or 256).
int launch(int kernel, int dtype, int width, const Ptrs& p, int B, int T, int H, int D, int causal,
           float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return (int)cudaErrorInvalidValue;
  const Shape s{T, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;  // 16-byte rows
    return (int)launch_f32(kernel, p, B, s, st);
  }
  if (dtype == 1) return (int)launch_wgmma<__nv_bfloat16>(kernel, width, p, B, s, st);
  if (dtype == 2) return (int)launch_wgmma<__half>(kernel, width, p, B, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, dout and the outputs are contiguous (B, T, H, D) tensors of
// one dtype on 16-byte boundaries, D a multiple of 4 (float32) or 8
// (16-bit; narrower heads are padded with zero columns by the caller); m,
// l and delta are contiguous (B, H, T) float32. dtype and width: see
// launch() above. scale is 1/sqrt(head width) rounded to f32. Each returns
// the cudaError_t of its launch (0 = cudaSuccess).
int dtt_flash_fwd(int dtype, int width, const void* q, const void* k, const void* v, void* o,
                  void* m, void* l, int B, int T, int H, int D, int causal, float scale,
                  void* stream) {
  Ptrs p{};
  p.q = q, p.k = k, p.v = v, p.o = o, p.m_out = m, p.l_out = l;
  return launch(0, dtype, width, p, B, T, H, D, causal, scale, stream);
}

int dtt_flash_dq(int dtype, int width, const void* q, const void* k, const void* v,
                 const void* dout, const void* m, const void* l, const void* delta, void* dq,
                 int B, int T, int H, int D, int causal, float scale, void* stream) {
  Ptrs p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.m_in = m, p.l_in = l, p.delta = delta, p.dq = dq;
  return launch(1, dtype, width, p, B, T, H, D, causal, scale, stream);
}

int dtt_flash_dkv(int dtype, int width, const void* q, const void* k, const void* v,
                  const void* dout, const void* m, const void* l, const void* delta, void* dk,
                  void* dv, int B, int T, int H, int D, int causal, float scale, void* stream) {
  Ptrs p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.m_in = m, p.l_in = l, p.delta = delta;
  p.dk = dk, p.dv = dv;
  return launch(2, dtype, width, p, B, T, H, D, causal, scale, stream);
}

// Dynamic shared memory of a wgmma kernel's block (kernel 0: forward, 1:
// dQ, 2: dK/dV) at padded width 64, 128 or 256; 0 for another width.
int dtt_flash_wgmma_smem(int kernel, int width) {
  if (width != 64 && width != 128 && width != 256) return 0;
  return (int)(kernel == 0 ? smem_fwd_wgmma(width)
               : kernel == 1 ? smem_dq_wgmma(width)
                             : smem_dkv_wgmma(width));
}

}  // extern "C"
