// SATA decode gather attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX reference,
//   repro/kernels/sata_decode.py::sata_decode_attention_kernel       (contiguous cache)
//   repro/kernels/sata_decode.py::sata_decode_attention_paged_kernel (page pool)
// which share one body (_decode_kernel -> sata_attention.py::_flash_update_tile).
// Here one kernel body serves both layouts: a null page table means the
// contiguous cache (B, S, KV, D), read as slot b's pages b*nkb .. b*nkb+nkb-1;
// a non-null table means the pool (n_pages, page, KV, D) with
// physical page = page_table[b * max_pages + kv_indices[row, j]].
//
// What it computes, per (slot b, KV head h) row: walk the kv_counts[row]
// planned LOGICAL k-blocks kv_indices[row, 0..count), score the G grouped
// query heads against each block's keys in fp32 scaled by 1/sqrt(D), keep
// entries with bf16(s) >= bf16(thr) (round-to-nearest-even on both sides,
// the planner's bisect predicate) AND logical position <= pos[b], and run
// an online softmax.  Masked entries get p = 0 explicitly (the finite
// sentinel -2^30 would otherwise give exp(0) = 1 in a row masked so far);
// p is rounded to the cache dtype before the PV product, accumulated in
// fp32; a row with no admissible key returns zeros.
//
// What bounds it on an H100: bytes read from HBM.  The output needs the K
// rows of the planned blocks up to pos (every one is scored) and only the
// V rows of keys that at least one of the G heads selects (top-k per head,
// so at most G·k of them), plus q, out and the plan.  At ~4·G·D flops per
// key row that is at most ~8 flops per bf16 byte at G = 4, far below the
// ~295 flops/byte where the tensor cores would become the limit.  The least
// time is those bytes / 3.35 TB/s.
//
// What the design does about it: the G query heads of a row share every
// K/V row the block reads, so each crosses HBM once per row (the
// reference's "repeat the resident tile" padding has no GPU counterpart —
// padding slots past the count are never visited).  K rows past pos and V
// rows that no head selected are not read.  Loads are coalesced along D.
// This first version is simple on purpose: one
// CUDA block per row, FMA loops and warp reductions, no cp.async/TMA
// pipelining and no split of a long row across blocks, so at B·KV rows it
// fills at most B·KV of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;        // <= kThreads: thread d owns output column d
constexpr int kMaxBlock = 128;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sata_decode_kernel(const T* __restrict__ q,              // (B, KV, G, D)
                   const T* __restrict__ k,              // pages of kb rows x (KV, D)
                   const T* __restrict__ v,
                   const int32_t* __restrict__ page_table,   // (B, nkb) or null
                   const int32_t* __restrict__ kv_indices,   // (B*KV, P)
                   const int32_t* __restrict__ kv_counts,    // (B*KV,)
                   const float* __restrict__ thr,            // (B*KV, G)
                   const int32_t* __restrict__ pos,          // (B,)
                   T* __restrict__ out,                      // (B, KV, G, D)
                   int n_kv, int G, int D, int P, int kb, int nkb,
                   float sm_scale) {
  const int row = blockIdx.x;
  const int b = row / n_kv, h = row % n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float q_sh[kMaxG][kMaxD];
  __shared__ float s_sh[kMaxG][kMaxBlock];      // masked scores, then rounded p
  __shared__ unsigned char sel_sh[kMaxG][kMaxBlock];
  __shared__ unsigned char row_sel_sh[kMaxBlock];   // any head selects row t
  __shared__ float thr_sh[kMaxG], m_sh[kMaxG], l_sh[kMaxG], alpha_sh[kMaxG];

  for (int i = tid; i < G * D; i += kThreads)
    q_sh[i / D][i % D] = to_f32(q[(size_t)row * G * D + i]);
  if (tid < G) {
    thr_sh[tid] = bf16_rn(thr[(size_t)row * G + tid]);
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  const int count = min(kv_counts[row], P);
  const int pos_b = pos[b];
  const size_t tok_stride = (size_t)n_kv * D;   // elements between token rows
  __syncthreads();

  for (int j = 0; j < count; ++j) {
    const int lblk = kv_indices[(size_t)row * P + j];
    const size_t page = page_table ? (size_t)page_table[(size_t)b * nkb + lblk]
                                   : (size_t)b * nkb + lblk;
    const size_t base = (page * kb * n_kv + h) * D;
    const T* kt = k + base;
    const T* vt = v + base;

    // phase A: one warp per key row, lanes split D; all G heads reuse the row
    for (int t = warp; t < kb; t += kWarps) {
      bool any = false;
      if (lblk * kb + t <= pos_b) {   // LOGICAL position; warp-uniform
        float kd[kMaxD / 32];
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int d = lane + 32 * i;
          kd[i] = d < D ? to_f32(kt[t * tok_stride + d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < kMaxD / 32; ++i) {
              const int d = lane + 32 * i;
              if (d < D) part += q_sh[g][d] * kd[i];
            }
            // the xor butterfly leaves the same sum in every lane
            const float s = warp_sum(part) * sm_scale;
            const bool sel = bf16_rn(s) >= thr_sh[g];
            any |= sel;
            if (lane == 0) {
              s_sh[g][t] = sel ? s : kNegInf;
              sel_sh[g][t] = sel;
            }
          }
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) {
          s_sh[g][t] = kNegInf;
          sel_sh[g][t] = 0;
        }
      }
      if (lane == 0) row_sel_sh[t] = any;
    }
    __syncthreads();

    // phase B: running max / sum per query head, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < kb; t += 32) mx = fmaxf(mx, s_sh[g][t]);
      mx = warp_max(mx);
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kb; t += 32) {
        const float p = sel_sh[g][t] ? expf(s_sh[g][t] - m_new) : 0.f;
        sum += p;
        s_sh[g][t] = to_f32(from_f32<T>(p));     // p.astype(v.dtype)
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_sh[g] = l_sh[g] * alpha + sum;
        m_sh[g] = m_new;
        alpha_sh[g] = alpha;
      }
    }
    __syncthreads();

    // phase C: acc = acc * alpha + p @ V; thread d owns column d of all G heads
    if (tid < D) {
      float pv[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) pv[g] = 0.f;
      for (int t = 0; t < kb; ++t) {
        if (!row_sel_sh[t]) continue;   // p == 0 for every head: skip the V row
        const float vv = to_f32(vt[t * tok_stride + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) pv[g] += s_sh[g][t] * vv;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = acc[g] * alpha_sh[g] + pv[g];
    }
    __syncthreads();   // s_sh / alpha_sh are rewritten by the next block
  }

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = l_sh[g];
        out[((size_t)row * G + g) * D + tid] = from_f32<T>(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  nkb: the page table's row stride
// (max_pages) for the pool, or S / k_block for the contiguous cache.
extern "C" int sata_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* kv_indices, const void* kv_counts, const void* thresholds,
    const void* pos, void* out, int batch, int n_kv, int G, int D, int P,
    int k_block, int nkb, int dtype, void* stream) {
  const dim3 grid(batch * n_kv), block(kThreads);
  // rounded once from double, as the plain version's fp32 scale is
  const float sm_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tbl = static_cast<const int32_t*>(page_table);
  const int32_t* idx = static_cast<const int32_t*>(kv_indices);
  const int32_t* cnt = static_cast<const int32_t*>(kv_counts);
  const float* th = static_cast<const float*>(thresholds);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    sata_decode_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        tbl, idx, cnt, th, ps, static_cast<T*>(out), n_kv, G, D, P, k_block, nkb,
        sm_scale);
  } else {
    sata_decode_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), tbl, idx, cnt, th, ps, static_cast<float*>(out),
        n_kv, G, D, P, k_block, nkb, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
