// SATA block-sparse flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX reference,
//   repro/kernels/sata_attention.py::sata_block_attention_compact  (compacted grid)
//   repro/kernels/sata_attention.py::sata_block_attention          (dense grid)
// whose bodies (_compact_kernel, _kernel) share _flash_update_tile.  Here one
// body serves both grids: the compacted grid walks kv_indices[row, 0..kv_counts[row]),
// the dense grid the k-blocks block_map sets, both in ascending order with
// the same arithmetic, so they agree bitwise on the same plan.  Padding
// slots past the count are never visited (the TPU's sequential grid had to
// step through them).
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
// p.  No atomics: every launch on the same inputs gives the same bits.
//
// What bounds it on an H100: operations.  At the training shape (B*H = 32,
// S = 4096, D = 128, 128 x 128 tiles, about half of them planned under
// causality) threshold mode needs a score (2*D flops) for each causally
// admissible pair of the planned tiles, ~68.7 GFLOP, and a PV product (2*D)
// only for each admitted key, ~2.2 GFLOP at top-64: ~71 GFLOP per call
// against ~134 MB of unique q/k/v/out bytes, ~530 flops per byte, above the
// ~295 where the tensor cores rather than HBM become the limit, so the least
// time is ~0.072 ms at 989 TFLOP/s.
//
// Two bodies, chosen by shape in the entry point (never on a failure):
//  - bf16 with D, q_block and k_block multiples of 16 (the path's shapes):
//    the tensor-core body.  One block of 8 warps per (bh, q-block), the
//    heaviest q-blocks (the last, under causality) launched first; a warp
//    owns 16 query rows.  The body always works on 128 x 128 tiles at
//    D 128 (smaller shapes are zero-padded in shared memory; zero products
//    add nothing), so its unrolled loops carry no bounds tests, which would
//    cut them into basic blocks the scheduler cannot overlap.  S = Q K^T and
//    O += P V run on mma.sync m16n8k16 (bf16 in, fp32 accumulation), Q and K
//    by ldmatrix and V by ldmatrix.trans from rows padded to an odd multiple
//    of 16 bytes (no bank conflicts); a k-step's fragments are loaded
//    together, then its 16 independent products issued.  Scale, predicate
//    (one compare against the row's admission edge, the least fp32 score
//    that bf16 rounds to >= thr), causal compare and sentinel apply to the
//    accumulator fragments in registers; row max, row sum and the admitted
//    count reduce over the lane quad; the score accumulators are the A
//    operand of the PV product, packed to bf16 (p rounded to V's dtype).
//    The plan row is read into shared memory once; the next planned
//    k-block's K and V rows (and mask bytes, and key positions) are copied
//    by 16-byte cp.async into the second of two stages while the current one
//    is computed, issued after Q K^T, with one barrier a k-block (two in
//    threshold mode).  PV is skipped for a warp none of whose rows selects a
//    key of the tile (p == 0 there: the same result).
//    The tensor cores sum each score's products in their own order, which
//    neither the plain version nor the CUDA-core body reproduces.  So a
//    threshold-mode score that lies within a bound on the gap between two
//    fp32 summation orders of its row's edge (kernels/sata_attention.py::
//    admitted_window derives it) is recomputed in the plain version's order
//    on the CUDA cores: the kernel admits exactly the keys the plain version
//    admits.  Such scores are rare, but each stalls its block while one lane
//    sums 128 products in sequence.
//  - fp32, and bf16 off the 16-grid: the CUDA-core body.  Dot products in
//    one fixed order over D (fma for bf16 operands, whose products are exact
//    in fp32; a rounded product then a rounded add for fp32), the order the
//    plain PyTorch version uses, so both admit the same keys; a 64-row
//    slice of a q-block per block, K/V widened to fp32 through shared
//    memory 32 keys at a time.
// Limits: D <= 128, q_block and k_block <= 128 (the wrapper raises outside
// them).

#include <cmath>

#include "sata_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // CUDA-core body: query rows a block, a slice of a q-block
constexpr int kKeys = 32;        // CUDA-core body: keys a K/V chunk in shared memory
constexpr int kMaxD = 128;
constexpr int kMaxBlock = 128;

// p rounded to V's dtype (p.astype(v.dtype) in the reference)
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
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

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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
  int n_bh, P, Sq, Sk, D, q_block, k_block, nqb, nkb, nsub;
  float sm_scale;
};

// ---------------------------------------------------------------------------
// CUDA-core body: fp32, and bf16 off the 16-grid

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
sata_block_fma_kernel(const Params p) {
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

// ---------------------------------------------------------------------------
// tensor-core body: bf16, D and both block edges multiples of 16

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;    // 16 query rows a warp: up to 128
constexpr int kStages = 2;                   // k-block tiles in shared memory
constexpr int kMaxSmem = 232448;             // shared memory a block may use

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of the tensor-core body, byte offsets.  The body
// works on 128 x 128 tiles at D 128 whatever the shape (smaller ones are
// zero-padded: zero products add nothing), so that its loops have no
// bounds to test.  A stage holds one k-block: its 128 K and V rows (bf16,
// rows of 2 * 128 + 16 bytes, an odd multiple of 16, so the eight rows an
// ldmatrix reads fall on eight bank groups), its mask bytes (q_block rows of
// 128 + 16), its key positions and, in threshold mode, its keys' norms.
// Then the q-block's 128 rows (laid out as K's), the plan row (up to n_plan
// k-blocks) and its length.
struct TcLayout {
  int rk, ms, k, v, mask, kpos, kn, stage, q, plan, n, total;
};

__host__ __device__ inline TcLayout tc_layout(int q_block, bool mask, bool pos, bool thr,
                                              int n_plan) {
  TcLayout L{};
  L.rk = 2 * kMaxD + 16;
  L.ms = kMaxBlock + 16;
  int off = 0;
  L.k = off;
  off += round16(kMaxBlock * L.rk);
  L.v = off;
  off += round16(kMaxBlock * L.rk);
  L.mask = off;
  off += mask ? round16(q_block * L.ms) : 0;
  L.kpos = off;
  off += pos ? round16(kMaxBlock * 4) : 0;
  L.kn = off;
  off += thr ? round16(kMaxBlock * 4) : 0;
  L.stage = off;
  off = kStages * L.stage;
  L.q = off;
  off += round16(kMaxBlock * L.rk);
  L.plan = off;
  off += round16(n_plan * 4);
  L.n = off;
  off += 16;
  L.total = off;
  return L;
}

// half-width of the score window around the admission edge inside which a
// tensor-core score is recomputed in the plain version's order, in units of
// (D + 16) 2^-24 |q| |k| (kernels/sata_attention.py::admitted_window
// derives the bound; |q| |k| >= sum_d |q_d k_d| by Cauchy-Schwarz)
constexpr float kWindowSlack = 4.f;

// The least fp32 x with bf16(x) >= t: rounding to bf16 is monotone, so a
// bisection over the fp32 values in order finds it (NaN where none is).
// `s >= admit_edge(t)` is then the predicate bf16(s) >= t in one compare.
__device__ float admit_edge(float t) {
  auto val = [](uint32_t k) {
    return __uint_as_float(k >= 0x80000000u ? k - 0x80000000u : ~k);
  };
  auto ok = [&](uint32_t k) { return bf16_rn(val(k)) >= t; };
  uint32_t lo = 0x007fffffu, hi = 0xff800000u;    // -inf and +inf, in order
  if (!ok(hi)) return __uint_as_float(0x7fc00000u);
  if (ok(lo)) return val(lo);
  while (hi - lo > 1) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (ok(mid)) hi = mid;
    else lo = mid;
  }
  return val(hi);
}

// (q . k) * scale with the products summed in the plain version's order, one
// fma per element of D, d = 0, 1, ...: q and k are bf16 rows in shared
// memory (16-byte aligned, D a multiple of 8), read 16 bytes at a time.  Out
// of line, as it runs rarely.
__device__ __noinline__ float plain_score(const unsigned char* q, const unsigned char* k,
                                          int D, float scale) {
  float dot = 0.f;
#pragma unroll 4
  for (int c = 0; c < 2 * D; c += 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(q + c);
    const uint4 b = *reinterpret_cast<const uint4*>(k + c);
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> fp32 is a 16-bit shift
      dot = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16), dot);
      dot = fmaf(__uint_as_float(wa[i] & 0xffff0000u), __uint_as_float(wb[i] & 0xffff0000u),
                 dot);
    }
  }
  return dot * scale;
}

// One block per (row bh, q-block), the last q-blocks first (under causality
// the heaviest, so the launch's tail runs the lightest); warp w owns
// query rows 16 w .. 16 w + 15 of the q-block.  In the m16n8k16 accumulator
// layout a lane holds rows g = lane / 4 and g + 8 of its warp's 16 (half
// h = 0, 1: elements 2 h and 2 h + 1) at columns 2 (lane % 4) and + 1 of
// each 8-column tile.  The selection mode is a template parameter, so each
// instantiation carries only its own per-score code.
template <bool kMask, bool kThr, bool kPos>
__global__ void __launch_bounds__(kTcThreads, 1)
sata_block_tc_kernel(const Params p, const TcLayout L) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int qi = p.nqb - 1 - (int)blockIdx.x / p.n_bh;
  const int bh = (int)blockIdx.x % p.n_bh;
  const int D = p.D, KB = p.k_block, QB = p.q_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool rows_here = warp * 16 < QB;               // uniform across the warp
  const size_t rbase = (size_t)bh * p.Sq + (size_t)qi * QB;   // (bh, first row)
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + rbase * D;
  const unsigned char* kg = static_cast<const unsigned char*>(p.k) + (size_t)bh * p.Sk * D * 2;
  const unsigned char* vg = static_cast<const unsigned char*>(p.v) + (size_t)bh * p.Sk * D * 2;
  int* plan = reinterpret_cast<int*>(tc_smem + L.plan);
  int* n_sh = reinterpret_cast<int*>(tc_smem + L.n);

  // the plan row, once: the listed k-blocks, or the set bits of the map
  const size_t prow = (size_t)bh * p.nqb + qi;
  if (p.block_map) {
    if (warp == 0) {
      int n = 0;
      for (int j0 = 0; j0 < p.nkb; j0 += 32) {
        const bool set = j0 + lane < p.nkb && p.block_map[prow * p.nkb + j0 + lane];
        const unsigned bal = __ballot_sync(0xffffffffu, set);
        if (set) plan[n + __popc(bal & ((1u << lane) - 1u))] = j0 + lane;
        n += __popc(bal);
      }
      if (lane == 0) *n_sh = n;
    }
  } else {
    const int n = min(p.kv_counts[prow], p.P);
    for (int j = tid; j < n; j += kTcThreads) plan[j] = p.kv_indices[prow * p.P + j];
    if (tid == 0) *n_sh = n;
  }
  if (D < kMaxD || KB < kMaxBlock || QB < kMaxBlock) {
    // the padding the copies never write: zero once (the K/V stages and the
    // q rows lie in one piece)
    for (int x = tid; x < (L.q + kMaxBlock * L.rk) / 16; x += kTcThreads)
      reinterpret_cast<uint4*>(tc_smem)[x] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int n_visit = *n_sh;

  const int cpr = D / 8, cpm = KB / 16;               // 16-byte copies a K/V, mask row
  const unsigned long long cpr_m = div_magic(cpr), cpm_m = div_magic(cpm);
  // the copies of planned k-block j into stage j % kStages, one commit group
  // per k-block (empty past the plan, so that the wait counts hold)
  auto issue = [&](int j) {
    if (j < n_visit) {
      unsigned char* st = tc_smem + (j % kStages) * L.stage;
      const int key0 = plan[j] * KB;
      const unsigned char* kt = kg + (size_t)key0 * D * 2;
      const unsigned char* vt = vg + (size_t)key0 * D * 2;
      for (int x = tid; x < KB * cpr; x += kTcThreads) {
        const int r = div_by(x, cpr_m), c = x - r * cpr;
        copy_async(st + L.k + r * L.rk + c * 16, kt + (size_t)x * 16, 16);
        copy_async(st + L.v + r * L.rk + c * 16, vt + (size_t)x * 16, 16);
      }
      if constexpr (kMask) {
        const uint8_t* mt = p.mask + rbase * p.Sk + key0;
        for (int x = tid; x < QB * cpm; x += kTcThreads) {
          const int r = div_by(x, cpm_m), c = x - r * cpm;
          copy_async(st + L.mask + r * L.ms + c * 16, mt + (size_t)r * p.Sk + c * 16, 16);
        }
      }
      if constexpr (kPos)
        for (int x = tid; x < KB; x += kTcThreads)
          copy_async(st + L.kpos + 4 * x, p.k_pos + (size_t)bh * p.Sk + key0 + x, 4);
    }
    commit_group();
  };
  // the q-block's rows, with the first k-block's copies
  for (int x = tid; x < QB * cpr; x += kTcThreads) {
    const int r = div_by(x, cpr_m), c = x - r * cpr;
    copy_async(tc_smem + L.q + r * L.rk + c * 16,
               reinterpret_cast<const unsigned char*>(q) + (size_t)x * 16, 16);
  }
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // per lane: its two rows' admission edge, score window per unit of key
  // norm, position, running max and sum and admitted count
  float edge[2], qeps[2], m[2], l[2];
  int qpos[2], adm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const float t = (kThr && rows_here) ? bf16_rn(p.thr[rbase + r]) : 0.f;
    edge[h] = admit_edge(t);
    float qq = 0.f;
    if (kThr && rows_here)
      for (int d = t4; d < D; d += 4) {
        const float x = __bfloat162float(q[(size_t)r * D + d]);
        qq = fmaf(x, x, qq);
      }
    qq += __shfl_xor_sync(0xffffffffu, qq, 1);
    qq += __shfl_xor_sync(0xffffffffu, qq, 2);
    qeps[h] = kWindowSlack * (D + 16) * 0x1p-24f * p.sm_scale * sqrtf(qq);
    qpos[h] = (kPos && rows_here) ? p.q_pos[rbase + r] : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
    adm[h] = 0;
  }
  float acc[kMaxD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMaxD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int j = 0; j < n_visit; ++j) {
    wait_pending(kStages - 2);    // k-block j's copies (this thread's) landed
    __syncthreads();              // ... every thread's, and every warp is done
                                  // with k-block j - 1: its stage is free
    unsigned char* st = tc_smem + (j % kStages) * L.stage;
    float* kn = reinterpret_cast<float*>(st + L.kn);
    if constexpr (kThr) {     // the keys' norms, two lanes a key
      for (int x = tid; x < 2 * kMaxBlock; x += kTcThreads) {
        const unsigned char* kr = st + L.k + (x >> 1) * L.rk + (x & 1) * kMaxD;
        float kk = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxD; c += 16) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(kr + c);
          const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
            kk = fmaf(lo, lo, fmaf(hi, hi, kk));
          }
        }
        kk += __shfl_xor_sync(0xffffffffu, kk, 1);
        if (!(x & 1)) kn[x >> 1] = sqrtf(kk);
      }
      __syncthreads();
    }
    if (!rows_here) {             // a q-block of fewer rows: these warps only copy
      issue(j + kStages - 1);
      continue;
    }
    {
      // S = Q K^T for the warp's 16 rows, 8 keys an accumulator tile: a
      // k-step's fragments (Q's by ldmatrix, K's by ldmatrix) are loaded
      // together, then its 16 independent products issued
      float s[kMaxBlock / 8][4];
#pragma unroll
      for (int nt = 0; nt < kMaxBlock / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const unsigned char* qp = tc_smem + L.q +
                                (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.rk +
                                (lane >> 4) * 16;
      const unsigned char* kp = st + L.k + ((lane & 7) + ((lane >> 4) << 3)) * L.rk +
                                ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int ks = 0; ks < kMaxD / 16; ++ks) {
        uint32_t a[4], b[kMaxBlock / 16][4];
        ldmatrix_x4(a, qp + ks * 32);
#pragma unroll
        for (int n2 = 0; n2 < kMaxBlock / 16; ++n2)
          ldmatrix_x4(b[n2], kp + n2 * 16 * L.rk + ks * 32);
#pragma unroll
        for (int n2 = 0; n2 < kMaxBlock / 16; ++n2) {
          mma_bf16(s[2 * n2], a, b[n2][0], b[n2][1]);
          mma_bf16(s[2 * n2 + 1], a, b[n2][2], b[n2][3]);
        }
      }
      // the copies that fly while k-block j is computed (after Q K^T, whose
      // ldmatrix loads they would slow)
      issue(j + kStages - 1);
      // scale.  A threshold-mode score within the error bound of two
      // summation orders of its row's edge is recomputed in the plain
      // version's order (sequential fma over D), so that the selection is
      // the plain version's; such scores are rare, so one flag a lane says
      // whether the warp looks for them
      bool near = false;
#pragma unroll
      for (int nt = 0; nt < kMaxBlock / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= p.sm_scale;
          if constexpr (kThr)
            near |= fabsf(s[nt][e] - edge[e >> 1]) <=
                                       qeps[e >> 1] * kn[nt * 8 + 2 * t4 + (e & 1)];
        }
      }
      if constexpr (kThr) {
        if (__any_sync(0xffffffffu, near)) {
#pragma unroll
          for (int nt = 0; nt < kMaxBlock / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, key = nt * 8 + 2 * t4 + (e & 1);
              if (fabsf(s[nt][e] - edge[h]) <= qeps[h] * kn[key])
                s[nt][e] = plain_score(tc_smem + L.q + (warp * 16 + g + 8 * h) * L.rk,
                                       st + L.k + key * L.rk, D, p.sm_scale);
            }
          }
        }
      }
      // select; masked scores take the sentinel; bit 2 nt + e % 2 of selb[h]
      // says element e of tile nt (row half h) is selected
      const uint8_t* mk = st + L.mask;
      const int* kpos = reinterpret_cast<const int*>(st + L.kpos);
      uint32_t selb[2] = {0u, 0u};
#pragma unroll
      for (int nt = 0; nt < kMaxBlock / 8; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t mm = 0;
          if constexpr (kMask)
            mm = *reinterpret_cast<const uint16_t*>(
                mk + (warp * 16 + g + 8 * h) * L.ms + nt * 8 + 2 * t4);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c, key = nt * 8 + 2 * t4 + c;
            bool sel = true;
            if constexpr (kMask) sel = (mm >> (8 * c)) & 0xffu;
            if constexpr (kThr) sel = s[nt][e] >= edge[h];
            if constexpr (kPos) sel = sel && kpos[key] <= qpos[h];
            s[nt][e] = sel ? s[nt][e] : kNegInf;
            selb[h] |= static_cast<uint32_t>(sel) << (2 * nt + c);
          }
        }
      }
      if (KB < kMaxBlock) {     // keys past a narrower k-block are padding
#pragma unroll
        for (int nt = 0; nt < kMaxBlock / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nt * 8 + 2 * t4 + (e & 1) >= KB) {
              s[nt][e] = kNegInf;
              selb[e >> 1] &= ~(1u << (2 * nt + (e & 1)));
            }
      }
      // the tile's max per row
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kMaxBlock / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      // the online-softmax step: the tile's row max over the lane quad
      float alpha[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        // a row that has admitted no key yet has m == the sentinel, where
        // exp(s - m) would be 1 for its masked scores: its p are all 0
        live[h] = m_new != kNegInf;
      }
      // p = exp(s - m_new), 0 for masked scores (exp of the sentinel less a
      // finite max underflows): l sums it unrounded, the PV product takes it
      // rounded to bf16 as A fragments (k-step kk is accumulator tiles 2 kk
      // and 2 kk + 1)
      uint32_t pa[kMaxBlock / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kMaxBlock / 8; ++nt) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __expf(s[nt][e] - m[e >> 1]);
          pe[e] = live[e >> 1] ? x : 0.f;
          rs[e >> 1] += pe[e];
        }
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(pe[0], pe[1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int cnt = __popc(selb[h]);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
        l[h] = l[h] * alpha[h] + rs[h];
        adm[h] += cnt;
      }
      // acc *= alpha, skipped where alpha is 1 for the whole warp (exact)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int dn = 0; dn < kMaxD / 8; ++dn) {
          acc[dn][0] *= alpha[0];
          acc[dn][1] *= alpha[0];
          acc[dn][2] *= alpha[1];
          acc[dn][3] *= alpha[1];
        }
      }
      // O += P V, skipped where no row of the warp selected a key of the
      // tile (its p are all 0 and alpha 1: the same result)
      if (__any_sync(0xffffffffu, (selb[0] | selb[1]) != 0u)) {
#pragma unroll
        for (int kk = 0; kk < kMaxBlock / 16; ++kk) {
          const unsigned char* vp = st + L.v +
                                    (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.rk +
                                    (lane >> 4) * 16;
          uint32_t b[kMaxD / 16][4];
#pragma unroll
          for (int d2 = 0; d2 < kMaxD / 16; ++d2) ldmatrix_x4_trans(b[d2], vp + d2 * 32);
#pragma unroll
          for (int d2 = 0; d2 < kMaxD / 16; ++d2) {
            mma_bf16(acc[2 * d2], pa[kk], b[d2][0], b[d2][1]);
            mma_bf16(acc[2 * d2 + 1], pa[kk], b[d2][2], b[d2][3]);
          }
        }
      }
    }
  }
  wait_pending(0);            // no copy outlives the block (an empty plan)

  if (!rows_here) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + rbase * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int dn = 0; dn < kMaxD / 8; ++dn) {
      if (dn * 8 < D) {
        const float o0 = l[h] > 0.f ? acc[dn][2 * h] / l[h] : 0.f;
        const float o1 = l[h] > 0.f ? acc[dn][2 * h + 1] / l[h] : 0.f;
        *reinterpret_cast<uint32_t*>(out + (size_t)r * D + dn * 8 + 2 * t4) = pack_bf16(o0, o1);
      }
    }
    if (p.admitted && t4 == 0) p.admitted[rbase + r] = adm[h];
  }
}

// ---------------------------------------------------------------------------

template <typename T>
int launch_fma(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.D, p.k_block);
  cudaError_t err = cudaFuncSetAttribute(
      sata_block_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)p.n_bh * p.nqb * p.nsub), block(kThreads);
  sata_block_fma_kernel<T><<<grid, block, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMask, bool kThr, bool kPos>
int launch_tc_as(const Params& p, const TcLayout& L, cudaStream_t stream) {
  auto* fn = sata_block_tc_kernel<kMask, kThr, kPos>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<(unsigned)p.n_bh * p.nqb, kTcThreads, L.total, stream>>>(p, L);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of the selection mode: a mask (which carries
// causality), or thresholds and / or positions
int launch_tc(const Params& p, const TcLayout& L, cudaStream_t stream) {
  if (p.mask) return launch_tc_as<true, false, false>(p, L, stream);
  if (p.thr)
    return p.q_pos ? launch_tc_as<false, true, true>(p, L, stream)
                   : launch_tc_as<false, true, false>(p, L, stream);
  return p.q_pos ? launch_tc_as<false, false, true>(p, L, stream)
                 : launch_tc_as<false, false, false>(p, L, stream);
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

// the shapes the tensor-core body takes: bf16 on the 16-grid whose layout
// fits a block's shared memory (the entry point also needs 16-byte aligned
// q, k, v, out and mask)
bool tensor_core_shape(int D, int q_block, int k_block, int dtype, const TcLayout& L) {
  return dtype == 1 && D % 16 == 0 && q_block % 16 == 0 && k_block % 16 == 0 &&
         L.total <= kMaxSmem;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t code (0 = ok).  With block_map
// null the compacted grid walks kv_indices/kv_counts (P slots per row); with
// block_map set the dense grid walks all nkb k-blocks.  mask, thr, q_pos/k_pos
// and admitted may each be null.  dtype: 0 = float32, 1 = bfloat16.  The body
// follows from the shape alone: bf16 with D, q_block and k_block multiples of
// 16, 16-byte aligned q/k/v/out/mask and a layout that fits shared memory
// takes the tensor cores, everything else the CUDA cores.
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
  p.n_bh = bh;
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
  if (dtype != 1) return launch_fma<float>(p, s);
  const TcLayout L = tc_layout(q_block, mask != nullptr, q_pos != nullptr,
                               thresholds != nullptr, block_map ? p.nkb : P);
  const bool tc = tensor_core_shape(D, q_block, k_block, dtype, L) && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(out) &&
                  (mask == nullptr || aligned16(mask));
  return tc ? launch_tc(p, L, s) : launch_fma<__nv_bfloat16>(p, s);
}

// The body sata_block_attention takes for a shape (aligned operands): 1 the
// tensor cores, 0 the CUDA cores; *smem receives its dynamic shared memory
// in bytes.  n_plan: nkb on the dense grid, P on the compacted one.
extern "C" int sata_block_attention_body(int D, int q_block, int k_block, int has_mask,
                                         int has_pos, int has_thr, int n_plan, int dtype,
                                         void* smem) {
  const TcLayout L = tc_layout(q_block, has_mask != 0, has_pos != 0, has_thr != 0, n_plan);
  const bool tc = tensor_core_shape(D, q_block, k_block, dtype, L);
  *static_cast<int*>(smem) = tc ? L.total : static_cast<int>(smem_bytes(D, k_block));
  return tc ? 1 : 0;
}
