// Paged-attention decode kernel for Hopper (sm_90a), split over the sequence.
//
// Replaces the Pallas kernels of distributed_tpu/ops/paged_attention.py:
//   _decode_kernel        (:93)   plain f32/bf16/f16 pools    -> kQuant = false
//   _decode_kernel_quant  (:151)  int8 {"q","scale"} pools    -> kQuant = true
//
// What it computes (the plain PyTorch version is paged_attention_ref in
// distributed_tpu_torch/ops/paged_attention.py): for slot s, query row
// k < kw (any kw >= 1) and head h, attention of q[s, k, h] over the
// slot's cached K/V rows, read through the block table (position p of
// slot s lives in pool block tables[s, p / bs] at offset p % bs) and
// masked causally to positions <= positions[s] + k. Scores are
// (q . k) / sqrt(hd) in f32, masked with -1e30; the softmax is online
// (running max m, sum l, accumulator acc in f32); the unnormalized
// probabilities are rounded to the value dtype before the product with V;
// the output is acc / max(l, 1e-30) in q's dtype. int8 pools dequantize
// each row as float(q) * scale, rounded once to q's dtype, before it is
// used.
//
// What bounds it: bytes. Decode reads every visible K/V row once and does
// 4 flops per element read (two dot products), far below the ~295
// flop/byte where an H100's bf16 tensor cores would become the limit: no
// tensor cores. At the serving shapes the bytes are a few MB, a few
// microseconds at 3.35 TB/s, so what stands between the kernel and its
// bound is latency: enough blocks to fill the card, enough bytes in
// flight on each SM, and a short chain from a row's arrival to its use.
//
// The design:
// * Split over the sequence. Each (slot, head)'s visible range
//   [0, min(pos + kw, nb * bs)) is cut into chunks of chunk_blocks whole
//   pool blocks (chosen by the wrapper from the shapes so the grid fills
//   the card, see chunk_blocks in ops/paged_attention.py), one CTA per
//   (chunk, head, slot); a CTA whose chunk starts past the slot's last
//   position exits at once. The CTA reads its chunk's block-table entries
//   itself, one per lane, and hands them out with shuffles.
// * Warps work on their own. Each of the 4 warps walks its own rows of the
//   chunk (interleaved), with its own online softmax and q in registers.
//   The lanes split hd into slices of 16 bytes (8 int8 values) and reduce
//   the dot product with shuffles; a warp takes 32 / lanes-per-row rows a
//   step. Rows arrive by cp.async into a ring of 4 stages per warp in
//   shared memory, each lane copying and later reading only its own
//   slices, so no barrier is needed until the end.
// * Merging. The warps' (m, l, acc) are merged once through shared memory.
//   A slot of one chunk writes its output there. Otherwise each chunk
//   writes its (m, l, acc) to f32 scratch, and the last CTA of the (slot,
//   head) to arrive (an arrival counter, left at zero again) merges all
//   the chunks in chunk order: out = sum_i acc_i e^(m_i - M) /
//   max(sum_i l_i e^(m_i - M), 1e-30), M = max_i m_i. The order is fixed,
//   so the bits are the same on every run. One launch per call.
// * Masking. Positions past a query row's own position get probability 0;
//   rows past the slot's last position are never read (their registers
//   are zero), so stale or trash rows cannot leak in. A chunk that a
//   query row cannot see at all merges as (m, l, acc) = (-1e30, 0, 0),
//   which contributes nothing.
//
// * Row groups. Query row r of a slot masks itself to positions <=
//   positions[s] + r, so rows 8g..8g+7 are a kw <= 8 problem at positions
//   positions[s] + 8g. A call of any kw is one launch: the grid's x
//   dimension runs over (row group, chunk), each row group with its own
//   chunks, partials and arrival counter, the last group partial. A call's
//   rows therefore come out bit for bit as the same rows would from calls
//   of at most 8 rows at the shifted positions.
//
// Head widths: any hd up to 256. Rows whose bytes are a multiple of 16
// (kVec) are read as slices through the cp.async ring; other widths (hd =
// 8 or 24 in int8, odd hd) read each element straight from global memory
// into registers. f32 heads above 128 give each lane two slices (kCpl).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // ring depth per warp (8 cost more in occupancy than it saved)
constexpr int kSlotBytes = 16;      // one lane's slice of one row, in the ring
constexpr int kKwGroup = 8;  // query rows a CTA holds in registers
constexpr int kMaxHd = 256;
constexpr int kMaxChunkBlocks = 32;  // table entries a chunk holds, one per lane
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// Raw bits of one pool element (trivial types, so they fit in a union with
// the slice they arrive in), and their value as f32.
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

// One lane's slice of a pool row: 16 bytes of f32/bf16/f16, 8 int8 values.
template <typename T, bool kQuant> struct Slice {
  using E = typename Raw<typename std::conditional<kQuant, int8_t, T>::type>::type;
  static constexpr int kElems = kQuant ? 8 : 16 / (int)sizeof(T);
  static constexpr int kBytes = kElems * (int)sizeof(E);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// kBytes (16, 8 or 4) from global to shared memory, asynchronously.
template <int kBytes> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(kBytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What the kernel reads. Layouts (all contiguous; with kVec, pool rows are
// whole 16-byte chunks and the pools 16-byte aligned):
//   q, out        (S, kw, H, hd)             T, any kw >= 1
//   k_pool/v_pool (NB, bs, H, hd)            T, or int8 when kQuant
//   k/v_scale     (NB, bs, H)                f32, read only when kQuant
//   tables        (S, nb)                    int32
//   positions     (S,)                       int32
//   partials      (S, H, n_groups, n_chunks, min(kw, 8), 2+hd)
//                                            f32 scratch: m, l, acc
//   counters      (S, H, n_groups)           int32, zero between calls
struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* positions;
  void* out;
  float* partials;
  int* counters;
  int kw, H, hd, bs, nb, chunk_blocks, n_chunks, n_groups;
  float sqrt_hd;
};

// Grid (n_groups * n_chunks, H, S), kThreads threads. kCpl slices per lane
// (2 only for f32 rows of more than 32 slices); kKw: 1 for decode, 8 for a
// row group of up to 8 query rows.
template <typename T, bool kQuant, bool kVec, int kCpl, int kKw>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Params p) {
  using Sl = Slice<T, kQuant>;
  using E = typename Sl::E;
  constexpr int V = Sl::kElems;
  constexpr int kSl = kCpl * V;  // floats a lane holds of one row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[kKw], red_l[kKw], wgt[kWarps][kKw];
  __shared__ int is_last;

  const int chunk = blockIdx.x % p.n_chunks, grp = blockIdx.x / p.n_chunks;
  const int h = blockIdx.y, s = blockIdx.z;
  const int H = p.H, hd = p.hd, bs = p.bs;
  // This CTA's row group: rows r0 .. r0 + kw - 1 of the call's p.kw, read
  // as a call of kw rows whose first row sits at positions[s] + r0.
  const int r0 = grp * kKwGroup;
  const int kw = min(kKwGroup, p.kw - r0);
  const int kst = min(kKwGroup, p.kw);  // rows a chunk's partials hold
  const int pos = p.positions[s] + r0;
  // Positions any query row of this slot can see: [0, len).
  const int len = max(0, min(pos + kw, p.nb * bs));
  const int rows = p.chunk_blocks * bs;
  const int c0 = chunk * rows;
  if (chunk > 0 && c0 >= len) return;
  const int c1 = min(c0 + rows, len);
  const int nch = max(1, (len + rows - 1) / rows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slices = (hd + V - 1) / V;
  int lpr = 1;  // lanes per row, a power of two
  while (lpr * kCpl < n_slices && lpr < 32) lpr <<= 1;
  const int rpw = 32 / lpr;  // rows a warp takes per step
  const int g = lane / lpr, li = lane - g * lpr;
  const int per_step = kWarps * rpw;
  const int n_steps = (c1 - c0 + per_step - 1) / per_step;

  // q in registers: this lane's slices of each query row, zero past hd.
  float qv[kKw][kSl];
#pragma unroll
  for (int r = 0; r < kKw; ++r) {
#pragma unroll
    for (int i = 0; i < kSl; ++i) {
      const int d = (li + (i / V) * lpr) * V + i % V;
      qv[r][i] = (r < kw && d < hd)
                     ? to_float<T>(static_cast<const T*>(p.q)[(((size_t)s * p.kw + r0 + r) * H + h) * hd + d])
                     : 0.f;
    }
  }
  // The chunk's block-table entries, one per lane.
  const int b0 = c0 / bs;
  const int tbl = (lane < p.chunk_blocks && b0 + lane < p.nb)
                      ? p.tables[(size_t)s * p.nb + b0 + lane] : 0;
  const E* kp = static_cast<const E*>(p.k_pool);
  const E* vp = static_cast<const E*>(p.v_pool);
  auto row_of = [&](int t) { return c0 + (t * kWarps + warp) * rpw + g; };
  // Pool row (block, offset, head) of position `row` of this chunk; every
  // lane of the warp calls it (the shuffle).
  auto pool_row = [&](int row) {
    const int blk = __shfl_sync(kFull, tbl, min((row - c0) / bs, 31));
    return ((size_t)blk * bs + (row - c0) % bs) * H + h;
  };

  // This warp's ring: [stage][K, V][kCpl][lane] slots of 16 bytes, then
  // (kQuant) [stage][K, V][lane] scales after all the warps' rings.
  unsigned char* ring = smem + (size_t)warp * kStages * 2 * kCpl * 32 * kSlotBytes;
  float* scl = reinterpret_cast<float*>(smem + (size_t)kWarps * kStages * 2 * kCpl * 32 * kSlotBytes) +
               warp * kStages * 2 * 32;
  auto slot = [&](int stage, int kv, int j) {
    return ring + (((stage * 2 + kv) * kCpl + j) * 32 + lane) * kSlotBytes;
  };
  auto issue = [&](int t) {
    if constexpr (kVec) {
      const int row = row_of(t);
      const size_t prow = pool_row(row);
      if (t < n_steps && row < c1) {
        const int stage = t % kStages;
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int sl = li + j * lpr;
          if (sl < n_slices) {
            cp_async<Sl::kBytes>(slot(stage, 0, j), kp + prow * hd + sl * V);
            cp_async<Sl::kBytes>(slot(stage, 1, j), vp + prow * hd + sl * V);
          }
        }
        if constexpr (kQuant) {
          cp_async<4>(scl + (stage * 2) * 32 + lane, p.k_scale + prow);
          cp_async<4>(scl + (stage * 2 + 1) * 32 + lane, p.v_scale + prow);
        }
      }
      cp_async_commit();  // empty groups too: the wait counts groups
    }
  };

  float m[kKw], l[kKw], acc[kKw][kSl];
#pragma unroll
  for (int r = 0; r < kKw; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kSl; ++i) acc[r][i] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < n_steps; ++t) {
    issue(t + kStages - 1);
    const int row = row_of(t);
    const bool valid = row < c1;
    float kf[kSl], vf[kSl];
    if constexpr (kVec) {
      cp_async_wait<kStages - 1>();  // this lane's copies of step t have landed
      const int stage = t % kStages;
      float ks = 1.f, vs = 1.f;
      if constexpr (kQuant) {
        ks = scl[(stage * 2) * 32 + lane];
        vs = scl[(stage * 2 + 1) * 32 + lane];
      }
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const bool on = valid && li + j * lpr < n_slices;
        union { uint4 u; E e[16 / sizeof(E)]; } kc, vc;
        if (on) {
          if constexpr (Sl::kBytes == 16) {
            kc.u = *reinterpret_cast<const uint4*>(slot(stage, 0, j));
            vc.u = *reinterpret_cast<const uint4*>(slot(stage, 1, j));
          } else {
            const uint2 k2 = *reinterpret_cast<const uint2*>(slot(stage, 0, j));
            const uint2 v2 = *reinterpret_cast<const uint2*>(slot(stage, 1, j));
            kc.u = make_uint4(k2.x, k2.y, 0u, 0u);
            vc.u = make_uint4(v2.x, v2.y, 0u, 0u);
          }
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          float kx = 0.f, vx = 0.f;
          if (on) {
            kx = raw_to_float(kc.e[u]);
            vx = raw_to_float(vc.e[u]);
            if constexpr (kQuant) {
              kx = round_to<T>(kx * ks);
              vx = round_to<T>(vx * vs);
            }
          }
          kf[j * V + u] = kx;
          vf[j * V + u] = vx;
        }
      }
    } else {
      const size_t prow = pool_row(row);
      float ks = 1.f, vs = 1.f;
      if constexpr (kQuant) {
        if (valid) {
          ks = p.k_scale[prow];
          vs = p.v_scale[prow];
        }
      }
#pragma unroll
      for (int i = 0; i < kSl; ++i) {
        const int d = (li + (i / V) * lpr) * V + i % V;
        float kx = 0.f, vx = 0.f;
        if (valid && d < hd) {
          kx = raw_to_float(kp[prow * hd + d]);
          vx = raw_to_float(vp[prow * hd + d]);
          if constexpr (kQuant) {
            kx = round_to<T>(kx * ks);
            vx = round_to<T>(vx * vs);
          }
        }
        kf[i] = kx;
        vf[i] = vx;
      }
    }

#pragma unroll
    for (int r = 0; r < kKw; ++r) {
      if (r < kw) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < kSl; i += 2) {
          d0 = fmaf(qv[r][i], kf[i], d0);
          d1 = fmaf(qv[r][i + 1], kf[i + 1], d1);
        }
        float dot = d0 + d1;
        for (int o = 1; o < lpr; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
        const bool vis = valid && row <= pos + r;
        const float sc = vis ? dot / p.sqrt_hd : kNeg;
        float mx = sc;
        for (int o = lpr; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        const float pr = vis ? expf(sc - m_new) : 0.f;
        const float pv = round_to<T>(pr);
        l[r] = l[r] * alpha + pr;
#pragma unroll
        for (int i = 0; i < kSl; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i] * alpha);
        m[r] = m_new;
      }
    }
  }
  if constexpr (kVec) cp_async_wait<0>();

  // The warp's (m, l, acc): m is the same on every lane; l and acc are
  // summed over the lane groups (a fixed butterfly).
#pragma unroll
  for (int r = 0; r < kKw; ++r) {
    if (r < kw) {
      for (int o = lpr; o < 32; o <<= 1) {
        l[r] += __shfl_xor_sync(kFull, l[r], o);
#pragma unroll
        for (int i = 0; i < kSl; ++i) acc[r][i] += __shfl_xor_sync(kFull, acc[r][i], o);
      }
    }
  }
  __syncthreads();  // the merge area overlaps the rings
  float* mw = reinterpret_cast<float*>(smem);  // [kWarps][kKw]
  float* lw = mw + kWarps * kKw;               // [kWarps][kKw]
  float* aw = lw + kWarps * kKw;               // [kWarps][kKw][hd]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kKw; ++r) {
      mw[warp * kKw + r] = m[r];
      lw[warp * kKw + r] = l[r];
    }
  }
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < kKw; ++r) {
      if (r < kw) {
#pragma unroll
        for (int i = 0; i < kSl; ++i) {
          const int d = (li + (i / V) * lpr) * V + i % V;
          if (d < hd) aw[(warp * kKw + r) * hd + d] = acc[r][i];
        }
      }
    }
  }
  __syncthreads();
  // Merge the warps, in warp order.
  if (tid < kw) {
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kKw + tid]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(mw[w * kKw + tid] - mx);
      wgt[w][tid] = e;
      sum += lw[w * kKw + tid] * e;
    }
    red_m[tid] = mx;
    red_l[tid] = sum;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  if (nch == 1) {
    for (int i = tid; i < kw * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += aw[(w * kKw + r) * hd + d] * wgt[w][r];
      out[(((size_t)s * p.kw + r0 + r) * H + h) * hd + d] = from_float<T>(a / fmaxf(red_l[r], 1e-30f));
    }
    return;
  }

  // A chunk of several: write this chunk's (m, l, acc), then the last CTA
  // of the (slot, head, row group) to arrive merges every chunk, in chunk
  // order.
  const int rec = 2 + hd;
  const size_t group = ((size_t)s * H + h) * p.n_groups + grp;
  float* base = p.partials + group * p.n_chunks * kst * rec;
  float* mine = base + (size_t)chunk * kst * rec;
  for (int i = tid; i < kw * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += aw[(w * kKw + r) * hd + d] * wgt[w][r];
    mine[r * rec + 2 + d] = a;
  }
  if (tid < kw) {
    mine[tid * rec] = red_m[tid];
    mine[tid * rec + 1] = red_l[tid];
  }
  __threadfence();  // this CTA's partials before its arrival
  __syncthreads();
  if (tid == 0) {
    int* counter = p.counters + group;
    const int last = atomicAdd(counter, 1) == nch - 1;
    if (last) {
      *counter = 0;  // every chunk has arrived: zero for the next call
      __threadfence();
    }
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  if (tid < kw) {
    float mx = kNeg;
    for (int c = 0; c < nch; ++c) mx = fmaxf(mx, __ldcg(base + ((size_t)c * kst + tid) * rec));
    float sum = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float* pc = base + ((size_t)c * kst + tid) * rec;
      sum += __ldcg(pc + 1) * expf(__ldcg(pc) - mx);
    }
    red_m[tid] = mx;
    red_l[tid] = sum;
  }
  __syncthreads();
  for (int i = tid; i < kw * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float a = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float* pc = base + ((size_t)c * kst + r) * rec;
      a += __ldcg(pc + 2 + d) * expf(__ldcg(pc) - red_m[r]);
    }
    out[(((size_t)s * p.kw + r0 + r) * H + h) * hd + d] = from_float<T>(a / fmaxf(red_l[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

// The launcher's arguments, packed by the Python wrapper into one buffer
// of 64-bit fields (ops/_build.py, packed(21)), in this order.
struct PagedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* positions;
  void* out;
  void* partials;  // f32, S * H * n_groups * n_chunks * min(kw, 8) * (2 + hd)
  void* counters;  // int32, S * H * n_groups, zero
  void* stream;
  int64_t dtype;   // 0 = float32, 1 = bfloat16, 2 = float16 (q, out, plain pools)
  int64_t quant;   // 1 = int8 pools with f32 scales
  int64_t vec;     // 1 = pool rows of whole 16-byte chunks, pools 16-byte aligned
  int64_t S, kw, H, hd, bs, nb;
  int64_t chunk_blocks;  // pool blocks per chunk, 1..32
};

}  // extern "C"

namespace {

template <typename T, bool kQuant, bool kVec, int kCpl, int kKw>
int launch(const PagedArgs& a) {
  Params p;
  p.q = a.q;
  p.k_pool = a.k_pool;
  p.v_pool = a.v_pool;
  p.k_scale = static_cast<const float*>(a.k_scale);
  p.v_scale = static_cast<const float*>(a.v_scale);
  p.tables = static_cast<const int*>(a.tables);
  p.positions = static_cast<const int*>(a.positions);
  p.out = a.out;
  p.partials = static_cast<float*>(a.partials);
  p.counters = static_cast<int*>(a.counters);
  p.kw = (int)a.kw;
  p.H = (int)a.H;
  p.hd = (int)a.hd;
  p.bs = (int)a.bs;
  p.nb = (int)a.nb;
  p.chunk_blocks = (int)a.chunk_blocks;
  p.n_chunks = (int)((a.nb + a.chunk_blocks - 1) / a.chunk_blocks);
  p.n_groups = (int)((a.kw + kKwGroup - 1) / kKwGroup);
  p.sqrt_hd = sqrtf((float)a.hd);
  // Dynamic shared memory: the warps' rings (kVec), then the merge area
  // over them.
  size_t smem = sizeof(float) * kWarps * kKw * (2 + (size_t)a.hd);
  if constexpr (kVec) {
    const size_t ring = (size_t)kWarps * kStages * 2 * kCpl * 32 * kSlotBytes +
                        (kQuant ? (size_t)kWarps * kStages * 2 * 32 * sizeof(float) : 0);
    if (ring > smem) smem = ring;
  }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  paged_decode_kernel<T, kQuant, kVec, kCpl, kKw>
      <<<dim3((unsigned)(p.n_groups * p.n_chunks), p.H, (unsigned)a.S), kThreads, smem,
         static_cast<cudaStream_t>(a.stream)>>>(p);
  return (int)cudaGetLastError();
}

// The instantiation for this call's read path, slices per lane and kw class.
template <typename T, bool kQuant>
int launch(const PagedArgs& a) {
  using Sl = Slice<T, kQuant>;
  const int n_slices = (int)((a.hd + Sl::kElems - 1) / Sl::kElems);
  if (a.vec && (a.hd * (int64_t)sizeof(typename Sl::E)) % 16) return (int)cudaErrorInvalidValue;
#define DTT_LAUNCH(V, C, K) return launch<T, kQuant, V, C, K>(a)
#define DTT_KW(V, C) \
  if (a.kw == 1) DTT_LAUNCH(V, C, 1); \
  DTT_LAUNCH(V, C, kKwGroup)
  if (n_slices <= 32) {
    if (a.vec) { DTT_KW(true, 1); }
    DTT_KW(false, 1);
  }
  if constexpr (std::is_same<T, float>::value && !kQuant) {
    if (a.vec) { DTT_KW(true, 2); }
    DTT_KW(false, 2);
  }
  return (int)cudaErrorInvalidValue;
#undef DTT_KW
#undef DTT_LAUNCH
}

}  // namespace

extern "C" {

// The row group the wrapper sizes the scratch by, and the head-width limit
// it checks before it launches (each read once a process).
int dtt_paged_attention_kw_group() { return kKwGroup; }
int dtt_paged_attention_max_hd() { return kMaxHd; }
int dtt_paged_attention_args_bytes() { return (int)sizeof(PagedArgs); }

// Paged decode over the packed arguments. Returns the cudaError_t of the
// launch (0 = cudaSuccess).
int dtt_paged_attention(const PagedArgs* a) {
  if (a->S < 1 || a->S > 65535 || a->H < 1 || a->H > 65535 || a->kw < 1 || a->kw > INT32_MAX ||
      a->hd < 1 || a->hd > kMaxHd || a->bs < 1 || a->nb < 1 || a->chunk_blocks < 1 ||
      a->chunk_blocks > kMaxChunkBlocks || a->chunk_blocks > a->nb ||
      a->nb * a->bs > INT32_MAX ||
      (a->kw + kKwGroup - 1) / kKwGroup * ((a->nb + a->chunk_blocks - 1) / a->chunk_blocks) >
          INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return a->quant ? launch<float, true>(*a) : launch<float, false>(*a);
  if (a->dtype == 1)
    return a->quant ? launch<__nv_bfloat16, true>(*a) : launch<__nv_bfloat16, false>(*a);
  if (a->dtype == 2) return a->quant ? launch<__half, true>(*a) : launch<__half, false>(*a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
