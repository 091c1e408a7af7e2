// SATA block-sparse flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX reference,
//   repro/kernels/sata_attention.py::sata_block_attention_compact  (compacted grid)
//   repro/kernels/sata_attention.py::sata_block_attention          (dense grid)
// whose bodies (_compact_kernel, _kernel) share _flash_update_tile.  Here one
// body serves both: the compacted grid walks kv_indices[row, 0..kv_counts[row]),
// the dense grid walks every k-block 0..nkb-1 and skips those block_map does not
// set.  Both visit the occupied tiles in ascending order with the same
// arithmetic, so they agree bitwise on the same plan.  Padding slots past the
// count are never visited (the TPU's sequential grid had to step through them).
//
// What it computes, per (row bh, q-block i): flash attention of the q tile over
// the listed k-blocks.  Per tile, s = (q . k) / sqrt(D) in fp32, then one of
//   threshold mode: sel = bf16(s) >= bf16(thr[row])  (round-to-nearest-even,
//                   the planner's bisect predicate), AND k_pos <= q_pos when
//                   positions are given (causal);
//   mask mode:      sel = mask[bh, row, key] != 0 (the mask carries causality);
//   block mode:     sel = k_pos <= q_pos when positions are given, else every key.
// Masked scores take the finite sentinel -2^30 and masked p is set to 0
// explicitly, so a row with no admissible key keeps l == 0 and returns zeros.
// m_new is the max over the whole tile; p = exp(s - m_new) is rounded to V's
// dtype before the PV product, which accumulates in fp32; l sums the unrounded
// p.  Dot products run in one fixed order over D (fma for bf16 operands, whose
// products are exact in fp32; a rounded product then a rounded add for fp32),
// the order the plain PyTorch version uses, so both select the same keys.  No
// atomics: every launch on the same inputs gives the same bits.
//
// What bounds it on an H100: operations.  At the training shape (B*H = 32,
// S = 4096, D = 128, 128 x 128 tiles, about half of them planned under
// causality) threshold mode needs a score (2*D flops) for each causally
// admissible pair of the planned tiles, ~68.7 GFLOP, and a PV product (2*D)
// only for each admitted key, ~2.2 GFLOP at top-64: ~71 GFLOP per call
// against ~134 MB of unique q/k/v/out bytes, ~530 flops per byte, above the
// ~295 where the tensor cores rather than HBM become the limit, so the least
// time is ~0.072 ms at 989 TFLOP/s.  This first version
// does not reach for it on purpose: FMA loops on the CUDA cores from shared
// memory (no wgmma, no TMA, no cp.async pipelining), a 64-row slice of a
// q-block per CUDA block so that 2048 blocks fill the 132 SMs, and K/V staged
// through shared memory in 32-key chunks.  Limits: D <= 128,
// q_block and k_block <= 128 (the wrapper raises outside them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // query rows per CUDA block: a slice of a q-block
constexpr int kKeys = 32;        // keys per K/V chunk staged in shared memory
constexpr int kMaxD = 128;
constexpr int kMaxBlock = 128;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to V's dtype (p.astype(v.dtype) in the reference)
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one step of the dot product: bf16 products are exact in fp32, so the fma
// rounds once, as the plain version's product-then-add does; fp32 products
// round first, so the fp32 path keeps the two roundings apart
template <typename T> __device__ __forceinline__ float mac(float acc, float a, float b);
template <> __device__ __forceinline__ float mac<__nv_bfloat16>(float acc, float a, float b) {
  return fmaf(a, b, acc);
}
template <> __device__ __forceinline__ float mac<float>(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Params {
  const void* q;                 // (BH, Sq, D)
  const void* k;                 // (BH, Sk, D)
  const void* v;
  const int32_t* kv_indices;     // (BH, nqb, P)   compacted grid
  const int32_t* kv_counts;      // (BH, nqb)
  const uint8_t* block_map;      // (BH, nqb, nkb) dense grid, or null
  const uint8_t* mask;           // (BH, Sq, Sk) or null
  const float* thr;              // (BH, Sq) or null
  const int32_t* q_pos;          // (BH, Sq) or null: no position gate
  const int32_t* k_pos;          // (BH, Sk)
  void* out;                     // (BH, Sq, D)
  int32_t* admitted;             // (BH, Sq) admitted-key count per row, or null
  int P, Sq, Sk, D, q_block, k_block, nqb, nkb, nsub;
  float sm_scale;
};

size_t smem_bytes(int D, int k_block) {
  const int ld = D + 1, lds = k_block + 1;
  const size_t floats = (size_t)kRows * ld + (size_t)kKeys * ld + (size_t)kRows * lds
                        + 4 * kRows;                       // m, l, alpha, thr
  const size_t ints = 2 * kRows + kMaxBlock;                // q_pos, admitted, k_pos
  return 4 * (floats + ints) + (size_t)kRows * k_block;     // + sel bytes
}

// thread layout: ty = tid / 16, tx = tid % 16.  Scores: the thread owns rows
// ty + 16 i (i < 4) x keys tx + 16 j (j < 2) of a 64 x 32 chunk.  Output: rows
// ty + 16 i x columns tx + 16 c (c < 8).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sata_block_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  const int KB = p.k_block, lds = KB + 1;
  float* q_sh = smem;                          // [kRows][ld]
  float* kv_sh = q_sh + kRows * ld;            // [kKeys][ld]  K chunk, then V chunk
  float* s_sh = kv_sh + kKeys * ld;            // [kRows][lds] masked s, then rounded p
  float* m_sh = s_sh + kRows * lds;
  float* l_sh = m_sh + kRows;
  float* alpha_sh = l_sh + kRows;
  float* thr_sh = alpha_sh + kRows;
  int* qpos_sh = reinterpret_cast<int*>(thr_sh + kRows);
  int* adm_sh = qpos_sh + kRows;
  int* kpos_sh = adm_sh + kRows;               // [kMaxBlock]
  uint8_t* sel_sh = reinterpret_cast<uint8_t*>(kpos_sh + kMaxBlock);   // [kRows][KB]

  int id = blockIdx.x;
  const int sub = id % p.nsub;
  id /= p.nsub;
  const int qi = id % p.nqb;
  const int bh = id / p.nqb;
  const int row0 = qi * p.q_block + sub * kRows;       // first query row of the slice
  const int nrows = min(kRows, p.q_block - sub * kRows);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  const T* q = static_cast<const T*>(p.q) + ((size_t)bh * p.Sq + row0) * D;
  const T* kbase = static_cast<const T*>(p.k) + (size_t)bh * p.Sk * D;
  const T* vbase = static_cast<const T*>(p.v) + (size_t)bh * p.Sk * D;
  const size_t rbase = (size_t)bh * p.Sq + row0;       // (bh, row0) in (BH, Sq)

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_sh[r * ld + d] = r < nrows ? to_f32(q[(size_t)r * D + d]) : 0.f;
  }
  if (tid < kRows) {
    const bool valid = tid < nrows;
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
    adm_sh[tid] = 0;
    thr_sh[tid] = (p.thr && valid) ? bf16_rn(p.thr[rbase + tid]) : 0.f;
    qpos_sh[tid] = (p.q_pos && valid) ? p.q_pos[rbase + tid] : 0;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const size_t prow = (size_t)bh * p.nqb + qi;         // this q-block's plan row
  const int n_visit = p.block_map ? p.nkb : min(p.kv_counts[prow], p.P);

  for (int j = 0; j < n_visit; ++j) {
    int kblk = j;
    if (p.block_map) {
      if (!p.block_map[prow * p.nkb + j]) continue;    // uniform across the block
    } else {
      kblk = p.kv_indices[prow * p.P + j];
    }
    const int key0 = kblk * KB;
    __syncthreads();                // the previous tile is done with kv_sh, s_sh, kpos_sh
    if (p.k_pos)
      for (int t = tid; t < KB; t += kThreads) kpos_sh[t] = p.k_pos[(size_t)bh * p.Sk + key0 + t];

    // phase A: masked scores of the tile, 32 keys at a time
    for (int c0 = 0; c0 < KB; c0 += kKeys) {
      const int nk = min(kKeys, KB - c0);
      if (c0 > 0) __syncthreads();                     // kv_sh consumed
      for (int i = tid; i < kKeys * D; i += kThreads) {
        const int t = i / D, d = i % D;
        kv_sh[t * ld + d] = t < nk ? to_f32(kbase[(size_t)(key0 + c0 + t) * D + d]) : 0.f;
      }
      __syncthreads();
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[4], b[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_sh[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) b[jj] = kv_sh[(tx + 16 * jj) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) s[i][jj] = mac<T>(s[i][jj], a[i], b[jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = ty + 16 * i, t = tx + 16 * jj;
          if (t >= nk) continue;
          const int key = c0 + t;                      // key within the tile
          const float sc = s[i][jj] * p.sm_scale;
          bool sel = false;
          if (r < nrows) {
            if (p.mask) {
              sel = p.mask[(rbase + r) * p.Sk + key0 + key] != 0;
            } else {
              sel = true;
              if (p.thr) sel = bf16_rn(sc) >= thr_sh[r];
              if (p.q_pos) sel = sel && (kpos_sh[key] <= qpos_sh[r]);
            }
          }
          s_sh[r * lds + key] = sel ? sc : kNegInf;
          sel_sh[r * KB + key] = sel;
        }
      }
    }
    __syncthreads();

    // phase B: running max and sum per row, p rounded in place; one warp per 8 rows
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      if (r >= nrows) break;                           // uniform across the warp
      float mx = kNegInf;
      for (int t = lane; t < KB; t += 32) mx = fmaxf(mx, s_sh[r * lds + t]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      int cnt = 0;
      for (int t = lane; t < KB; t += 32) {
        const bool sel = sel_sh[r * KB + t];
        const float pe = sel ? expf(s_sh[r * lds + t] - m_new) : 0.f;
        sum += pe;
        cnt += sel;
        s_sh[r * lds + t] = round_p<T>(pe);
      }
      sum = warp_sum(sum);
      cnt = warp_sum_int(cnt);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_sh[r] = l_sh[r] * alpha + sum;
        m_sh[r] = m_new;
        alpha_sh[r] = alpha;
        adm_sh[r] += cnt;
      }
    }

    // phase C: acc = acc * alpha + p @ V, V staged 32 keys at a time
    float pv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
    for (int c0 = 0; c0 < KB; c0 += kKeys) {
      const int nk = min(kKeys, KB - c0);
      __syncthreads();                                 // p written / kv_sh consumed
      for (int i = tid; i < kKeys * D; i += kThreads) {
        const int t = i / D, d = i % D;
        kv_sh[t * ld + d] = t < nk ? to_f32(vbase[(size_t)(key0 + c0 + t) * D + d]) : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < nk; ++t) {
        float pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = s_sh[(ty + 16 * i) * lds + c0 + t];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = tx + 16 * c;
          if (col < D) {
            const float vv = kv_sh[t * ld + col];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i][c] = fmaf(pr[i], vv, pv[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float alpha = r < nrows ? alpha_sh[r] : 1.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] * alpha + pv[i][c];
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) + rbase * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const float l = l_sh[r];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[(size_t)r * D + col] = from_f32<T>(l > 0.f ? acc[i][c] / l : 0.f);
    }
  }
  if (p.admitted && tid < nrows) p.admitted[rbase + tid] = adm_sh[tid];
}

template <typename T>
int launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.D, p.k_block);
  cudaError_t err = cudaFuncSetAttribute(
      sata_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)bh * p.nqb * p.nsub), block(kThreads);
  sata_block_kernel<T><<<grid, block, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a cudaError_t code (0 = ok).  With block_map
// null the compacted grid walks kv_indices/kv_counts (P slots per row); with
// block_map set the dense grid walks all nkb k-blocks.  mask, thr, q_pos/k_pos
// and admitted may each be null.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int sata_block_attention(
    const void* q, const void* k, const void* v, const void* kv_indices,
    const void* kv_counts, const void* block_map, const void* mask,
    const void* thresholds, const void* q_pos, const void* k_pos, void* out,
    void* admitted, int bh, int Sq, int Sk, int D, int P, int q_block,
    int k_block, int dtype, void* stream) {
  if (D < 1 || D > kMaxD || q_block < 1 || q_block > kMaxBlock || k_block < 1 ||
      k_block > kMaxBlock || Sq % q_block || Sk % k_block)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_indices = static_cast<const int32_t*>(kv_indices);
  p.kv_counts = static_cast<const int32_t*>(kv_counts);
  p.block_map = static_cast<const uint8_t*>(block_map);
  p.mask = static_cast<const uint8_t*>(mask);
  p.thr = static_cast<const float*>(thresholds);
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.k_pos = static_cast<const int32_t*>(k_pos);
  p.out = out;
  p.admitted = static_cast<int32_t*>(admitted);
  p.P = P;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.q_block = q_block;
  p.k_block = k_block;
  p.nqb = Sq / q_block;
  p.nkb = Sk / k_block;
  p.nsub = (q_block + kRows - 1) / kRows;
  // rounded once from double, as the plain version's fp32 scale is
  p.sm_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, bh, s) : launch<float>(p, bh, s);
}
