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
// What bounds it on an H100 SXM: operations.  At the training shape (B*H =
// 32, S = 4096, D = 128, 128 x 128 tiles, about half of them planned under
// causality) threshold mode needs a score (2*D flops) for each causally
// admissible pair of the planned tiles, ~68.7 GFLOP, and a PV product (2*D)
// only for each admitted key, ~2.2 GFLOP at top-64: ~71 GFLOP per call
// against ~134 MB of unique q/k/v/out bytes, ~530 flops per byte, above the
// ~295 where the tensor cores rather than HBM become the limit, so the least
// time is ~0.072 ms at the data sheet's 989 TFLOP/s (bf16, dense).  The
// tiles the kernel computes in full are about twice that work.
//
// Two bodies, chosen by shape in the entry point (never on a failure):
//  - bf16 with D, q_block and k_block multiples of 16 (every shape of the
//    path): the tensor-core body, built on what Hopper added.
//    * D is a compile-time width: 64 (whisper-base; D 16..48 padded), 80
//      (zamba2-2.7b) or 128 (the rest; D 96, 112 padded), times the five
//      selection modes.  Columns past D are the zeros TMA writes for
//      coordinates outside the tensor; at D 80 no product is wider than 80.
//    * One block per (bh, q-block), the heaviest (last) q-blocks first:
//      one consumer warpgroup per 64 query rows (two at q_block 128) and a
//      producer warpgroup that gives its registers to them (setmaxnreg:
//      40 a thread, the consumers 232).  The producer's first warp walks
//      the plan row (the listed k-blocks, or the map's set bits) and, per
//      planned k-block, issues one TMA copy a chunk of its K and V tiles
//      (and its mask tile, a bulk copy of its key positions) into a ring
//      of 2 to 4 stages (as many as shared memory holds: 3 at D 128 but
//      in mask mode, 3 or 4 at D <= 80), each stage with a full and an
//      empty mbarrier; nothing else synchronises the block.  In
//      threshold mode its other three warps take each stage's largest
//      key norm (summed over the width) while the consumers' Q K^T runs.
//    * Tiles are chunks of [rows][W] columns, W = 64 with 128-byte
//      swizzled rows where the width is a multiple of 64, W = 16 with
//      32-byte rows at D 80, so every k16 step of a product reads one
//      swizzle atom.  S = Q K^T is wgmma m64n128k16 with Q and K read by
//      descriptor from shared memory (K-major); O += P V is wgmma
//      m64n{64,80,128}k16 with P in registers (the score accumulators,
//      rounded to V's dtype) and V by a transposing (MN-major) descriptor.
//      The accumulators stay fp32.
//    * The predicate is one compare of the dot product x against the
//      row's admission edge over the scale (the edge: the least fp32
//      score that bf16 rounds to >= thr); the causal compare is skipped
//      for a warp whose rows all lie at or after every key of the tile;
//      the scale goes into the exponent, p = 2^(x c - m c) with c =
//      scale log2(e).  Row max, row sum and the admitted count reduce
//      over the lane quad; PV is skipped where no row of the warpgroup
//      selects a key of the tile (a barrier's OR vote; p == 0 there:
//      the same result).
//    * The tensor cores sum each score's products in their own order, which
//      neither the plain version nor the CUDA-core body reproduces.  So a
//      threshold-mode dot product that lies within a bound on the gap
//      between two fp32 summation orders of its row's edge
//      (kernels/sata_attention.py::admitted_window derives it, here with
//      the stage's largest key norm for each key's) is recomputed in the
//      plain version's order on the CUDA cores, and moved to the side of
//      the edge the plain score is on: the kernel admits exactly the keys
//      the plain version admits.  A warp with such a dot product puts its
//      near ones through a queue in shared memory; its lanes recompute
//      them side by side, 16 a round, each summing one in the plain
//      order, and a ballot returns the decisions.  A dot product further
//      from the edge than the window lies on the plain score's side of it.
//  - fp32, and bf16 off the 16-grid: the CUDA-core body.  Dot products in
//    one fixed order over D (fma for bf16 operands, whose products are exact
//    in fp32; a rounded product then a rounded add for fp32), the order the
//    plain PyTorch version uses, so both admit the same keys; a 64-row
//    slice of a q-block per block, K/V widened to fp32 through shared
//    memory 32 keys at a time.
// Limits: D <= 128, q_block and k_block <= 128 (the wrapper raises outside
// them).  Times: PERF.md (chip_smoke.py phase 10 and --ab).

#include <cmath>
#include <cstring>
#include <type_traits>

#include <cuda.h>   // CUtensorMap and its enums (the encoder: through the runtime)

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
  int qpos_stride, kpos_stride;  // elements between two rows' positions (0: shared)
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
    qpos_sh[tid] = (p.q_pos && valid) ? p.q_pos[(size_t)bh * p.qpos_stride + row0 + tid] : 0;
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
      for (int t = tid; t < KB; t += kThreads)
        kpos_sh[t] = p.k_pos[(size_t)bh * p.kpos_stride + key0 + t];

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

constexpr int kTcRows = 64;                  // query rows a consumer warpgroup
constexpr int kTcKeys = 128;                 // key rows a stage: a k-block, padded
constexpr int kMaxStages = 4;
constexpr int kTcMaxThreads = 3 * 128;       // two consumer warpgroups, the producer's
constexpr int kProducerRegs = 40;            // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kHelpers = 3;                  // the producer's warps that take key norms
constexpr int kQueue = 16;                   // near-edge recheck slots a consumer warp
constexpr int kMaxSmem = 232448;             // shared memory a block may use

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The head width a D takes on the tensor cores, one of the instantiated
// 64 (whisper-base; D 16..48 padded), 80 (zamba2-2.7b) and 128 (the rest;
// D 96, 112 padded).  Its columns past D are the zeros the TMA fills in
// for columns outside the tensor, so nothing is zeroed for D.
__host__ __device__ constexpr int tc_width(int D) { return D <= 64 ? 64 : D <= 80 ? 80 : 128; }

// The columns of one swizzled row, a TMA box's width and a wgmma atom's:
// 64 (128-byte rows, 128B swizzle) where the width is a multiple of 64,
// else 16 (32-byte rows, 32B swizzle).  A tile of the width is Dk / W
// chunks of [rows][W], each loaded by one TMA copy.
__host__ __device__ constexpr int tc_chunk(int Dk) { return Dk % 64 == 0 ? 64 : 16; }

// Shared-memory layout of the tensor-core body, byte offsets from the
// dynamic shared memory's base, which is 1024-byte aligned (the kernel
// traps otherwise; the swizzle patterns repeat every 1024 bytes at most).
// First the small parts: the mbarriers (full, empty and, in threshold
// mode, normed a stage; one for q) and the plan's length, a recheck queue
// a consumer warp, for each stage its k-block's key positions and its
// keys' largest norm (one a helper warp), and the rows' admitted counts.  Then, from the next 1024
// bytes on, the q rows (64 a consumer warpgroup) as chunks, and a ring of
// `stages` stages, each one k-block's K and V tiles (128 key rows,
// chunked) and its mask bytes (the block's q rows by 128 keys, 128B
// swizzle).
struct TcLayout {
  int dk, nwg, stages;                       // width, consumer warpgroups, stages
  int bar, queue, kpos, kn, adm;             // the small parts
  int q, ring, stage;                        // q tile; first stage; a stage's bytes
  int k, v, mask;                            // offsets within a stage
  int total;
};

__host__ __device__ inline TcLayout tc_layout_as(int dk, int nwg, int stages, bool mask,
                                                 bool pos, bool thr) {
  TcLayout L{};
  L.dk = dk;
  L.nwg = nwg;
  L.stages = stages;
  const int rows = kTcRows * nwg, tile = round_up(kTcKeys * dk * 2, 1024);
  L.bar = 0;
  L.queue = L.bar + 8 * (3 * kMaxStages + 2);            // + the plan's length
  L.kpos = L.queue + (thr ? 4 * nwg * kQueue * 4 : 0);
  L.kn = L.kpos + (pos ? stages * kTcKeys * 4 : 0);
  L.adm = L.kn + (thr ? stages * 16 : 0);
  L.q = round_up(L.adm + rows * 4, 1024);
  L.ring = L.q + round_up(rows * dk * 2, 1024);
  L.k = 0;
  L.v = tile;
  L.mask = 2 * tile;
  L.stage = 2 * tile + (mask ? round_up(rows * kTcKeys, 1024) : 0);
  L.total = L.ring + stages * L.stage;
  return L;
}

// The layout for a shape: one consumer warpgroup a 64-row q-block (or
// less), two above; as many stages as fit a block's shared memory, 2 to 4.
__host__ __device__ inline TcLayout tc_layout(int D, int q_block, bool mask, bool pos,
                                              bool thr) {
  const int dk = tc_width(D), nwg = q_block > kTcRows ? 2 : 1;
  TcLayout L = tc_layout_as(dk, nwg, 2, mask, pos, thr);
  for (int s = 3; s <= kMaxStages; ++s) {
    const TcLayout M = tc_layout_as(dk, nwg, s, mask, pos, thr);
    if (M.total > kMaxSmem) break;
    L = M;
  }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers: init, arrive (with the bytes a TMA copy will complete), wait
// for a phase.  A wait that lasts 2 s means an arrival was lost: it traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  if (mbar_try(b, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(b, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// the TMA: a box of a 3-d tensor map (coordinates innermost first), and a
// plain bulk copy, each completing its bytes on an mbarrier
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a named barrier among a consumer warpgroup's warps that ORs a vote
__device__ __forceinline__ bool named_any(int id, int n, bool x) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// 2^x, the MUFU's approximation (exp(s) = 2^(s log2 e), as __expf takes it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma: a shared-memory matrix descriptor (start, leading and stride byte
// offsets, swizzle: 1 = 128B, 3 = 32B), and the group fence / commit / wait
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | swizzle << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers a wgmma reads or writes asynchronously: no access may move
// across the fence, the commit or the wait
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// the accumulators of a wgmma m64nN: N / 2 fp32 registers a thread, as
// operands %0 .. %(N / 2 - 1) eight at a time
#define SATA_R0_31 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SATA_R32_39 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define SATA_R40_63 ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
                    "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SATA_ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SATA_ACC32 SATA_ACC8(0), SATA_ACC8(8), SATA_ACC8(16), SATA_ACC8(24)
#define SATA_ACC32_HI SATA_ACC8(32), SATA_ACC8(40), SATA_ACC8(48), SATA_ACC8(56)

// D (64 x 128 fp32) (+)= A (64 x 16 bf16, shared, K-major) * B (16 x 128 bf16,
// shared, K-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SATA_R0_31 SATA_R32_39
               SATA_R40_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
               : SATA_ACC32, SATA_ACC32_HI
               : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x N fp32) += A (64 x 16 bf16, registers) * B (16 x N bf16, shared,
// MN-major: the descriptor's transpose), N = 64, 80, 128
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SATA_R0_31
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : SATA_ACC32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" SATA_R0_31 SATA_R32_39
               "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
               : SATA_ACC32, SATA_ACC8(32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SATA_R0_31 SATA_R32_39
               SATA_R40_63 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : SATA_ACC32, SATA_ACC32_HI
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int Dk>
__device__ __forceinline__ void wgmma_pv(float (&o)[Dk / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (Dk == 64) wgmma_rs_n64(o, a, b);
  else if constexpr (Dk == 80) wgmma_rs_n80(o, a, b);
  else wgmma_rs_n128(o, a, b);
}

// the 16-byte unit a swizzled row r keeps its unit u in (W = 64: 128B
// swizzle, the unit XOR r mod 8; W = 16: 32B swizzle, XOR bit 2 of r)
template <int W> __device__ __forceinline__ int swizzled(int u, int r) {
  return W == 64 ? u ^ (r & 7) : u ^ ((r >> 2) & 1);
}

// (q . k) * scale with the products summed in the plain version's order, one
// fma per element of D, d = 0, 1, ...: q row qr of a chunked tile of q_rows
// rows and key row kr of a stage's K tile, bf16, swizzled, read 16 bytes at
// a time.
template <int W>
__device__ __forceinline__ float plain_score(const unsigned char* qt, int q_rows, int qr,
                                          const unsigned char* kt, int kr, int D, float scale) {
  constexpr int kUnits = W / 8;               // 16-byte units a swizzled row
  float dot = 0.f;
#pragma unroll 2
  for (int u = 0; u < D / 8; ++u) {
    const int c = u / kUnits, uu = u % kUnits;
    const uint4 a = *reinterpret_cast<const uint4*>(qt + (c * q_rows + qr) * 2 * W +
                                                    16 * swizzled<W>(uu, qr));
    const uint4 b = *reinterpret_cast<const uint4*>(kt + (c * kTcKeys + kr) * 2 * W +
                                                    16 * swizzled<W>(uu, kr));
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

// sum of squares of a bf16 row of `units` 16-byte units (any order: a
// swizzle only permutes a row's units)
__device__ __forceinline__ float sum_squares(const unsigned char* row, int units) {
  float ss = 0.f;
  for (int u = 0; u < units; ++u) {
    const uint4 w4 = *reinterpret_cast<const uint4*>(row + 16 * u);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
      ss = fmaf(lo, lo, fmaf(hi, hi, ss));
    }
  }
  return ss;
}

// One block per (row bh, q-block), the last q-blocks first (under causality
// the heaviest, so the launch's tail runs the lightest).  Warps 0 .. 4 nwg - 1
// are the consumer warpgroups, warpgroup w owning the q-block's rows
// 64 w .. 64 w + 63; the last warpgroup is the producer's, which gives its
// registers to the consumers (setmaxnreg): its first warp issues the
// copies, the other three (threshold mode) take the largest key norm of
// each stage.  In the wgmma accumulator layout a consumer lane holds rows
// g = lane / 4 and g + 8 of its warp's 16 (half h = 0, 1: elements 2 h and
// 2 h + 1 of each group of four) at columns 2 (lane % 4) and + 1 of each
// 8-column group.  The width and the selection mode are template
// parameters, so each instantiation carries only its own per-score code.
template <int Dk, bool kMask, bool kThr, bool kPos>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
sata_block_tc_kernel(const Params p, const TcLayout L, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tm) {
  constexpr int W = tc_chunk(Dk), kChunks = Dk / W, kRowB = 2 * W;
  constexpr uint64_t kSwizzle = W == 64 ? 1 : 3;
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* empty = full + kMaxStages;
  uint64_t* normed = empty + kMaxStages;
  uint64_t* qbar = normed + kMaxStages;
  int* n_sh = reinterpret_cast<int*>(qbar + 1);
  float* knorm = reinterpret_cast<float*>(sm + L.kn);        // [stage][4]
  const int nwg = L.nwg, rows = kTcRows * nwg;
  const int qi = p.nqb - 1 - (int)blockIdx.x / p.n_bh;
  const int bh = (int)blockIdx.x % p.n_bh;
  const int D = p.D, KB = p.k_block, QB = p.q_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t prow = (size_t)bh * p.nqb + qi;             // this q-block's plan row
  const size_t rbase = (size_t)bh * p.Sq + (size_t)qi * QB;   // (bh, first row)

  if (tid == 0) {
    if (smem_u32(sm) & 1023u) __trap();       // the layout needs an aligned base
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * nwg);          // one arrival a consumer warp
      mbar_init(normed + s, kHelpers);        // one arrival a helper warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the q rows, in flight while the plan is read
    mbar_expect_tx(qbar, rows * Dk * 2);
    for (int c = 0; c < kChunks; ++c)
      tma_3d(sm + L.q + c * rows * kRowB, &tq, c * W, qi * QB, bh, qbar);
  }
  // the plan's length: the row's count, or the set bits of its map row
  if (warp == 0) {
    int n = 0;
    if (p.block_map) {
      for (int j0 = 0; j0 < p.nkb; j0 += 32)
        n += __popc(__ballot_sync(0xffffffffu,
                                  j0 + lane < p.nkb && p.block_map[prow * p.nkb + j0 + lane]));
    } else {
      n = min(p.kv_counts[prow], p.P);
    }
    if (lane == 0) *n_sh = n;
  }
  // a consumer lane's rows' thresholds and positions, loaded while the
  // plan's length is read
  float thr_in[2] = {0.f, 0.f};
  int qpos_in[2] = {0, 0};
  if (warp < 4 * nwg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      if (r < QB) {
        if (kThr) thr_in[h] = p.thr[rbase + r];
        if (kPos) qpos_in[h] = p.q_pos[(size_t)bh * p.qpos_stride + (size_t)qi * QB + r];
      }
    }
  __syncthreads();
  const int n_visit = *n_sh;

  if (warp >= 4 * nwg) {
    // ---- the producer warpgroup, with the fewest registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pw = warp - 4 * nwg;
    if (pw == 0) {
      // planned k-block j's K and V tiles (and mask bytes, key positions)
      // into stage j % stages once its consumers have released it; lane 0
      // issues, the warp walks the plan
      const int kv_chunks = kChunks;
      const uint32_t bytes = 2 * kv_chunks * kTcKeys * kRowB + (kMask ? rows * kTcKeys : 0) +
                             (kPos ? KB * 4 : 0);
      int j0 = -32, idx = 0, w0 = -32;
      uint32_t bits = 0;
      for (int j = 0; j < n_visit; ++j) {
        int kblk;
        if (p.block_map) {                     // the next set bit of the map row
          while (bits == 0) {
            w0 += 32;
            bits = __ballot_sync(0xffffffffu,
                                 w0 + lane < p.nkb && p.block_map[prow * p.nkb + w0 + lane]);
          }
          kblk = w0 + __ffs(bits) - 1;
          bits &= bits - 1;
        } else {                               // the listed k-blocks, 32 read at a time
          if (j - j0 >= 32) {
            j0 = j;
            idx = j + lane < n_visit ? p.kv_indices[prow * p.P + j + lane] : 0;
          }
          kblk = __shfl_sync(0xffffffffu, idx, j - j0);
        }
        const int s = j % L.stages;
        if (j >= L.stages) mbar_wait(empty + s, (j / L.stages - 1) & 1);
        if (lane == 0) {
          unsigned char* st = sm + L.ring + s * L.stage;
          const int key0 = kblk * KB;
          mbar_expect_tx(full + s, bytes);
          for (int c = 0; c < kv_chunks; ++c) {
            tma_3d(st + L.k + c * kTcKeys * kRowB, &tk, c * W, key0, bh, full + s);
            tma_3d(st + L.v + c * kTcKeys * kRowB, &tv, c * W, key0, bh, full + s);
          }
          if constexpr (kMask) tma_3d(st + L.mask, &tm, key0, qi * QB, bh, full + s);
          if constexpr (kPos)
            bulk_copy(sm + L.kpos + s * kTcKeys * 4,
                      p.k_pos + (size_t)bh * p.kpos_stride + key0, KB * 4, full + s);
        }
        __syncwarp();
      }
    } else if (kThr) {
      // the helpers: each stage's largest key norm, summed over the width
      // (zeros past D) while the consumers' Q K^T runs, a thread a key
      const int hl = tid - 32 * (4 * nwg + 1);
      for (int j = 0; j < n_visit; ++j) {
        const int s = j % L.stages;
        mbar_wait(full + s, (j / L.stages) & 1);
        const unsigned char* kt = sm + L.ring + s * L.stage + L.k;
        float kk = 0.f;
#pragma unroll 1
        for (int key = hl; key < kTcKeys; key += 32 * kHelpers) {
          float ss = 0.f;  // four 16-byte units in flight: 40 registers a thread
#pragma unroll 4
          for (int u = 0; u < Dk / 8; ++u)
            ss += sum_squares(kt + ((u / (W / 8)) * kTcKeys + key) * kRowB + 16 * (u % (W / 8)), 1);
          kk = fmaxf(kk, ss);
        }
        kk = warp_max(kk);
        if (lane == 0) {
          knorm[4 * s + pw - 1] = sqrtf(kk);
          mbar_arrive(normed + s);
        }
      }
    }
  } else {
    // ---- the consumer warpgroups, with the most registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int row0 = 16 * warp + g;           // the lane's first row in the q-block
    // per lane, for its two rows: the admission edge over the scale, on
    // the dot product (NaN past the q-block: never near, never selected;
    // a dot product further than the window from it takes the score's
    // side of the edge), the window per unit of key norm, the running max
    // (of dot products) and sum; the warp's least position; the admitted
    // counts in shared memory (the registers go to the tiles)
    float edge[2], eu[2], qn[2], m[2], l[2];
    int* adm = reinterpret_cast<int*>(sm + L.adm);
    int qmin = 0x7fffffff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const bool valid = r < QB;
      edge[h] = eu[h] = qn[h] = 0.f;
      if constexpr (kThr) {
        const float t = valid ? bf16_rn(thr_in[h]) : 0.f;
        edge[h] = admit_edge(t);
        if (!valid) edge[h] = __uint_as_float(0x7fc00000u);
        eu[h] = edge[h] / p.sm_scale;
      }
      if (kPos && valid) qmin = min(qmin, qpos_in[h]);
      m[h] = kNegInf;
      l[h] = 0.f;
      if (t4 == 0) adm[r] = 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, d));
    mbar_wait(qbar, 0);
    if constexpr (kThr) {
      // |q| of the lane's rows from the q tile, a quarter of the units a lane
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float qq = 0.f;
        for (int u = t4; u < Dk / 8; u += 4)
          qq += sum_squares(sm + L.q + ((u / (W / 8)) * rows + row0 + 8 * h) * kRowB +
                                16 * (u % (W / 8)), 1);
        qq += __shfl_xor_sync(0xffffffffu, qq, 1);
        qq += __shfl_xor_sync(0xffffffffu, qq, 2);
        qn[h] = kWindowSlack * (D + 16) * 0x1p-24f * sqrtf(qq);
      }
    }
    // p = 2^(x c2 - m c2) for a dot product x: exp((x - m) * scale)
    const float c2 = p.sm_scale * 1.4426950408889634f;
    float o[Dk / 2];
#pragma unroll
    for (int i = 0; i < Dk / 2; ++i) o[i] = 0.f;
    const uint32_t q_addr = smem_u32(sm + L.q) + wg * kTcRows * kRowB;

    for (int j = 0; j < *n_sh; ++j) {
      const int s = j % L.stages, ph = (j / L.stages) & 1;
      unsigned char* st = sm + L.ring + s * L.stage;
      const int* kpos = reinterpret_cast<const int*>(sm + L.kpos) + s * kTcKeys;
      mbar_wait(full + s, ph);
      {
        // S = Q K^T for the warpgroup's 64 rows by the stage's 128 keys,
        // issued; the tile's positions and (threshold mode) its keys'
        // largest norm while it runs
        const uint32_t k_addr = smem_u32(st + L.k);
        uint32_t qa = q_addr;           // opaque: its descriptors are made
        asm volatile("" : "+r"(qa));    // here, not held across the loop
        float x[kTcKeys / 8][4];
        float(&sv)[kTcKeys / 2] = reinterpret_cast<float(&)[kTcKeys / 2]>(x);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < Dk / 16; ++ks) {
          const int c = ks * 16 / W, off = (ks * 16 % W) * 2;
          wgmma_ss_n128(sv, gmma_desc(qa + c * rows * kRowB + off, 16, 8 * kRowB, kSwizzle),
                        gmma_desc(k_addr + c * kTcKeys * kRowB + off, 16, 8 * kRowB, kSwizzle),
                        ks > 0);
        }
        wgmma_commit();
        // every key of the tile at or before every row of the warp: the
        // positions need no test (keys past the k-block: never copied)
        bool causal_all = true;
        if constexpr (kPos) {
          int kp = -0x7fffffff - 1;
          if (4 * lane < KB) {
            const int4 k4 = reinterpret_cast<const int4*>(kpos)[lane];
            kp = max(max(k4.x, k4.y), max(k4.z, k4.w));
          }
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) kp = max(kp, __shfl_xor_sync(0xffffffffu, kp, d));
          causal_all = kp <= qmin;
        }
        float w[2] = {0.f, 0.f};
        if constexpr (kThr) {
          mbar_wait(normed + s, ph);
          const float* kn = knorm + 4 * s;
          const float km = fmaxf(fmaxf(kn[0], kn[1]), kn[2]);
          w[0] = qn[0] * km;
          w[1] = qn[1] * km;
        }
        wgmma_wait();
        fence_regs(sv);
        // threshold mode: a dot product within the error bound of two
        // summation orders (the window, with the stage's largest key norm
        // for each key's) of its row's edge is near; a warp with a near
        // one recomputes each in the plain version's order and moves the
        // dot product to the side of the edge the plain score is on
        bool near = false;
        if constexpr (kThr) {
#pragma unroll
          for (int i = 0; i < kTcKeys / 2; ++i)
            near |= fabsf(sv[i] - eu[(i >> 1) & 1]) <= w[(i >> 1) & 1];
          if (__any_sync(0xffffffffu, near)) {
            // bit i of nb: element i is near.  The warp's near elements go
            // through a queue in shared memory, kQueue a round, so that
            // its lanes recompute them side by side; a ballot returns
            // the decisions in queue order
            uint64_t nb = 0, ok = 0;
#pragma unroll
            for (int i = 0; i < kTcKeys / 2; ++i)
              nb |= static_cast<uint64_t>(fabsf(sv[i] - eu[(i >> 1) & 1]) <= w[(i >> 1) & 1]) << i;
            const int cnt = __popcll(nb);
            int incl = cnt;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int y = __shfl_up_sync(0xffffffffu, incl, d);
              if (lane >= d) incl += y;
            }
            const int total = __shfl_sync(0xffffffffu, incl, 31), first = incl - cnt;
            uint32_t* qe = reinterpret_cast<uint32_t*>(sm + L.queue) + warp * kQueue;
            for (int r0 = 0; r0 < total; r0 += kQueue) {
              int n = first;
              for (uint64_t b = nb; b != 0ull && n < r0 + kQueue; b &= b - 1, ++n)
                if (n >= r0) qe[n - r0] = lane << 8 | (__ffsll(static_cast<long long>(b)) - 1);
              __syncwarp();
              const bool mine = lane < kQueue && r0 + lane < total;
              const uint32_t ent = mine ? qe[lane] : 0u;
              const int src = ent >> 8, i = ent & 255;
              const int r = 16 * warp + (src >> 2) + 8 * ((i >> 1) & 1);
              // bf16(s) >= bf16(thr), the predicate admit_edge stands for
              // (the row's threshold read again: no register holds it)
              bool dec = false;
              if (mine)
                dec = bf16_rn(plain_score<W>(sm + L.q, rows, r, st + L.k,
                                             8 * (i >> 2) + 2 * (src & 3) + (i & 1), D,
                                             p.sm_scale)) >= bf16_rn(p.thr[rbase + r]);
              const uint32_t votes = __ballot_sync(0xffffffffu, dec);
              n = first;
              for (uint64_t b = nb; b != 0ull && n < r0 + kQueue; b &= b - 1, ++n)
                if (n >= r0 && ((votes >> (n - r0)) & 1u)) ok |= b & (~b + 1);
              __syncwarp();
            }
            const float below[2] = {nextafterf(eu[0], -INFINITY), nextafterf(eu[1], -INFINITY)};
#pragma unroll
            for (int i = 0; i < kTcKeys / 2; ++i)
              if ((nb >> i) & 1)
                sv[i] = (ok >> i) & 1 ? fmaxf(sv[i], eu[(i >> 1) & 1])
                                      : fminf(sv[i], below[(i >> 1) & 1]);
          }
        }
        // select; masked dot products take the sentinel
        const uint8_t* mk = st + L.mask;
        int cnt[2] = {0, 0};
        auto select = [&](auto test_pos) {
          int qpos[2] = {0, 0};    // the rows' positions, read again
          if constexpr (decltype(test_pos)::value)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (row0 + 8 * h < QB)
                qpos[h] = p.q_pos[(size_t)bh * p.qpos_stride + (size_t)qi * QB + row0 + 8 * h];
#pragma unroll
          for (int nt = 0; nt < kTcKeys / 8; ++nt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              [[maybe_unused]] uint32_t mm = 0;
              if constexpr (kMask) {   // the mask tile's rows are 128 bytes, 128B-swizzled
                const int r = row0 + 8 * h;
                mm = *reinterpret_cast<const uint16_t*>(
                    mk + r * kTcKeys + 16 * (((nt >> 1) ^ (r & 7))) + 8 * (nt & 1) + 2 * t4);
              }
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = 2 * h + c, key = nt * 8 + 2 * t4 + c;
                bool sel = true;
                if constexpr (kMask) sel = (mm >> (8 * c)) & 0xffu;
                if constexpr (kThr) sel = x[nt][e] >= eu[h];
                if constexpr (decltype(test_pos)::value) sel = sel && kpos[key] <= qpos[h];
                x[nt][e] = sel ? x[nt][e] : kNegInf;
                cnt[h] += sel;
              }
            }
          }
        };
        if (kPos && !causal_all) select(std::true_type{});
        else select(std::false_type{});
        if (KB < kTcKeys) {     // keys past a narrower k-block are the next blocks'
#pragma unroll
          for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (nt * 8 + 2 * t4 + (e & 1) >= KB) {
                cnt[e >> 1] -= x[nt][e] != kNegInf;
                x[nt][e] = kNegInf;
              }
        }
        // the online-softmax step: the tile's row max over the lane quad
        float mx[2] = {kNegInf, kNegInf}, alpha[2], mc[2];
#pragma unroll
        for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[nt][e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          alpha[h] = ex2((m[h] - m_new) * c2);
          m[h] = m_new;
          // a row that has admitted no key yet has m == the sentinel: its
          // p, 2^((sentinel - 0) c2), underflow to 0, as every masked p
          // does against a finite max
          mc[h] = (m_new == kNegInf ? 0.f : m_new) * c2;
        }
        // p: l sums it unrounded, the PV product takes it rounded to bf16
        // as register A fragments (k-step kk is accumulator tiles 2 kk and
        // 2 kk + 1, the wgmma A layout of the same rows)
        uint32_t pa[kTcKeys / 16][4];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < kTcKeys / 8; ++nt) {
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pe[e] = ex2(fmaf(x[nt][e], c2, -mc[e >> 1]));
            rs[e >> 1] += pe[e];
          }
          pa[nt >> 1][(nt & 1) * 2] = pack_bf16(pe[0], pe[1]);
          pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 1);
          cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 2);
          l[h] = l[h] * alpha[h] + rs[h];
          if (t4 == 0) adm[row0 + 8 * h] += cnt[h];
        }
        // acc *= alpha, skipped where alpha is 1 for the whole warp (exact)
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int dn = 0; dn < Dk / 8; ++dn) {
            o[4 * dn] *= alpha[0];
            o[4 * dn + 1] *= alpha[0];
            o[4 * dn + 2] *= alpha[1];
            o[4 * dn + 3] *= alpha[1];
          }
        }
        // O += P V, skipped where no row of the warpgroup selected a key of
        // the tile (its p are all 0 and alpha 1: the same result)
        const bool pv = named_any(1 + wg, 128, cnt[0] + cnt[1] != 0);
        if (pv) {
          const uint32_t v_addr = smem_u32(st + L.v);
          fence_regs(o);
          fence_regs(pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTcKeys / 16; ++kk)
            wgmma_pv<Dk>(o, pa[kk], gmma_desc(v_addr + kk * 16 * kRowB, kTcKeys * kRowB,
                                              8 * kRowB, kSwizzle));
          wgmma_commit();
          wgmma_wait();
          fence_regs(o);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);    // the warp is done with the stage
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + rbase * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= QB) continue;
#pragma unroll
      for (int dn = 0; dn < Dk / 8; ++dn) {
        if (dn * 8 < D) {
          const float o0 = l[h] > 0.f ? o[4 * dn + 2 * h] / l[h] : 0.f;
          const float o1 = l[h] > 0.f ? o[4 * dn + 2 * h + 1] / l[h] : 0.f;
          *reinterpret_cast<uint32_t*>(out + (size_t)r * D + dn * 8 + 2 * t4) = pack_bf16(o0, o1);
        }
      }
      if (p.admitted && t4 == 0) p.admitted[rbase + r] = adm[r];
    }
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

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// without -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static_assert(CUDART_VERSION >= 12050, "cudaGetDriverEntryPointByVersion needs CUDA 12.5");

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 3-d map of (n_bh, n_rows, inner) elements of `elem` bytes, row-major,
// cut in boxes of box_rows x box_inner
bool encode_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int inner,
               int n_rows, int n_bh, int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)n_rows, (cuuint64_t)n_bh};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * elem, (cuuint64_t)inner * n_rows * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dk, bool kMask, bool kThr, bool kPos>
int launch_tc_as(const Params& p, const TcLayout& L, const CUtensorMap (&maps)[4],
                 cudaStream_t stream) {
  auto* fn = sata_block_tc_kernel<Dk, kMask, kThr, kPos>;
  // setmaxnreg moves registers within the block: what the block holds at
  // launch must cover the producer's and the consumers' shares, or a
  // consumer would wait for registers forever.  Checked once.
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return static_cast<int>(e);
    regs = fa.numRegs;
  }
  if (regs * (L.nwg + 1) < kProducerRegs + kConsumerRegs * L.nwg)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<(unsigned)p.n_bh * p.nqb, 128 * (L.nwg + 1), L.total, stream>>>(p, L, maps[0], maps[1],
                                                                      maps[2], maps[3]);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of the selection mode: a mask (which carries
// causality), or thresholds and / or positions
template <int Dk>
int launch_tc_width(const Params& p, const TcLayout& L, const CUtensorMap (&maps)[4],
                    cudaStream_t stream) {
  if (p.mask) return launch_tc_as<Dk, true, false, false>(p, L, maps, stream);
  if (p.thr)
    return p.q_pos ? launch_tc_as<Dk, false, true, true>(p, L, maps, stream)
                   : launch_tc_as<Dk, false, true, false>(p, L, maps, stream);
  return p.q_pos ? launch_tc_as<Dk, false, false, true>(p, L, maps, stream)
                 : launch_tc_as<Dk, false, false, false>(p, L, maps, stream);
}

// the tensor maps of q, k, v (chunks of W columns: 128B or 32B swizzle)
// and of the mask (128 keys by the block's q rows, 128B swizzle), then the
// launch at the instantiated width
int launch_tc(const Params& p, const TcLayout& L, cudaStream_t stream) {
  const int W = tc_chunk(L.dk), rows = kTcRows * L.nwg;
  const CUtensorMapSwizzle sw =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = encode_3d(&maps[0], p.q, bf16, 2, p.D, p.Sq, p.n_bh, W, rows, sw) &&
            encode_3d(&maps[1], p.k, bf16, 2, p.D, p.Sk, p.n_bh, W, kTcKeys, sw) &&
            encode_3d(&maps[2], p.v, bf16, 2, p.D, p.Sk, p.n_bh, W, kTcKeys, sw);
  if (ok && p.mask)
    ok = encode_3d(&maps[3], p.mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.Sk, p.Sq, p.n_bh,
                   kTcKeys, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (L.dk) {
    case 64: return launch_tc_width<64>(p, L, maps, stream);
    case 80: return launch_tc_width<80>(p, L, maps, stream);
    default: return launch_tc_width<128>(p, L, maps, stream);
  }
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

// the shapes the tensor-core body takes: bf16 on the 16-grid (the layout
// fits a block's shared memory at every such shape)
bool tensor_core_shape(int D, int q_block, int k_block, int dtype, const TcLayout& L) {
  return dtype == 1 && D % 16 == 0 && q_block % 16 == 0 && k_block % 16 == 0 &&
         L.total <= kMaxSmem;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t code (0 = ok).  With block_map
// null the compacted grid walks kv_indices/kv_counts (P slots per row); with
// block_map set the dense grid walks all nkb k-blocks.  mask, thr, q_pos/k_pos
// and admitted may each be null; q_pos / k_pos rows lie q_pos_stride /
// k_pos_stride elements apart (0: every row shares one).  dtype: 0 =
// float32, 1 = bfloat16.  The body follows from the shape alone: bf16 with
// D, q_block and k_block multiples of 16 takes the tensor cores and needs
// 16-byte aligned q, k, v, out, mask and key positions (else
// cudaErrorMisalignedAddress: nothing falls back); everything else takes
// the CUDA cores.
extern "C" int sata_block_attention(
    const void* q, const void* k, const void* v, const void* kv_indices,
    const void* kv_counts, const void* block_map, const void* mask,
    const void* thresholds, const void* q_pos, const void* k_pos, void* out,
    void* admitted, int bh, int Sq, int Sk, int D, int P, int q_block,
    int k_block, int dtype, int q_pos_stride, int k_pos_stride, void* stream) {
  if (D < 1 || D > kMaxD || q_block < 1 || q_block > kMaxBlock || k_block < 1 ||
      k_block > kMaxBlock || Sq % q_block || Sk % k_block || q_pos_stride < 0 ||
      k_pos_stride < 0)
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
  p.qpos_stride = q_pos_stride;
  p.kpos_stride = k_pos_stride;
  // rounded once from double, as the plain version's fp32 scale is
  p.sm_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return launch_fma<float>(p, s);
  const TcLayout L = tc_layout(D, q_block, mask != nullptr, q_pos != nullptr,
                               thresholds != nullptr);
  if (!tensor_core_shape(D, q_block, k_block, dtype, L)) return launch_fma<__nv_bfloat16>(p, s);
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
                       (mask == nullptr || aligned16(mask)) &&
                       (k_pos == nullptr || (aligned16(k_pos) && k_pos_stride % 4 == 0));
  return aligned ? launch_tc(p, L, s) : static_cast<int>(cudaErrorMisalignedAddress);
}

// The body sata_block_attention takes for a shape (aligned operands): 1 the
// tensor cores, 0 the CUDA cores; *smem receives its dynamic shared memory
// in bytes.  n_plan (nkb on the dense grid, P on the compacted one) no
// longer changes it: the plan is read as the producer walks it.
extern "C" int sata_block_attention_body(int D, int q_block, int k_block, int has_mask,
                                         int has_pos, int has_thr, int n_plan, int dtype,
                                         void* smem) {
  (void)n_plan;
  const TcLayout L = tc_layout(D, q_block, has_mask != 0, has_pos != 0, has_thr != 0);
  const bool tc = tensor_core_shape(D, q_block, k_block, dtype, L);
  *static_cast<int*>(smem) = tc ? L.total : static_cast<int>(smem_bytes(D, k_block));
  return tc ? 1 : 0;
}
