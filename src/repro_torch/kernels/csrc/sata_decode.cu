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
// an online softmax, one step per block: m_new is the max over the whole
// block, masked entries get p = 0 explicitly (the finite sentinel -2^30
// would otherwise give exp(0) = 1 in a row masked so far), p is rounded to
// the cache dtype before the PV product, l sums the unrounded p, and the
// accumulation is fp32.  A row with no admissible key returns zeros.
// The partial mode (sata_decode_attention_partial, context-parallel decode:
// a rank's share of the keys) writes the fp32 output o / l unrounded and
// lse = m + log(l) per (row, head), -inf where l == 0, for the ranks'
// partials to be combined; it differs only in the epilogue.
//
// What bounds it on an H100.  The work is bound by bytes: the output needs
// the K rows of the planned blocks up to pos (every one is scored), only
// the V rows of keys that at least one of the G heads selects (top-k per
// head, so at most G·k of them), q, out and the plan, once each.  At
// ~4·G·D flops per key row that is at most ~32 flops per bf16 byte at
// G = 16, far below the ~295 flops/byte where the tensor cores would become
// the limit, so the least time is those bytes / 3.35 TB/s.  The kernel does
// not reach it: a block's time goes to the latencies of the instructions
// that score, stage, synchronise and sum each chunk of its row, with few
// warps to hide them, not to the bytes (PERF.md: a deeper ring or a warm L2
// changes little; at G = 16 taking the scoring, the K copies or the PV
// product out each saved a third to a half of one block a row's time).
//
// The split over a thread-block cluster.  With one block a row, B8 KV4
// (qwen3-moe: 16 heads a KV head) is 32 blocks on 132 SMs, each with a
// whole row's instruction path.  So a row is split over a cluster of cs
// blocks (kernels/sata_decode.py::cluster_for: 1 at G = 1, 4 for bf16
// past G = 8, staged so that two blocks fit an SM, else 2):
//  - rank r of the cluster takes the contiguous share [r·per, min(count,
//    (r + 1)·per)) of the row's plan entries, per = ceil(count / cs), and
//    runs the body below on it alone, with its own online softmax: p is
//    rounded against the share's own running max.  A share may be empty;
//    an empty share publishes l = 0 and nothing else.
//  - The combine reads every rank's (m, l, o) through distributed shared
//    memory after a cluster barrier, in rank order, no atomics: M = the
//    largest m of the ranks with l > 0, w_r = exp(m_r - M) for those ranks
//    and 0 for the others, y = sum_r w_r o_r / sum_r w_r l_r (0 where that
//    is 0), lse = M + log(sum_r w_r l_r).  A rank with l == 0 is left out
//    explicitly: its m and o were never written.  Each rank writes D / cs
//    of the columns; a second cluster barrier keeps every block resident
//    until the others have read it.  One block a row (cs = 1) skips the
//    combine and ends, as the kernel always did, with o / l.
//  - cs depends on the shape (G and the dtype) alone, never on the
//    grid (B·KV, the SM count, the device), so a row's output is the same
//    bits whatever the batch or the heads a tensor-parallel rank holds.
//    The plain version models the split (sata_decode_attention_ref's
//    `splits`).
//
// The body, per share, and what it does about the memory side and to keep
// the instruction path short:
//  - Prologue: the block loads its share's plan (kv_indices and, for the
//    pool, the page-table entries) into shared memory once, so a row's
//    address is known before its copy is issued; the dependent
//    index -> table -> data chain is paid once per share, not per block.
//  - A ring of `stages` chunks of `chunk` K rows in shared memory (whole
//    k-blocks, or a divisor of one, so the depth does not depend on the
//    page size or the dtype), filled with 16-byte cp.async.cg copies where
//    the rows allow (narrower ones otherwise) in one commit group per chunk,
//    `stages` - 1 chunks ahead of the one being scored.  K rows past pos are
//    not copied; a flag per row beside the ring says so.
//  - Scoring: bf16 scores on the tensor cores (mma.sync m16n8k16, fp32
//    accumulation; K tiles by ldmatrix from rows padded to an odd multiple
//    of 16 bytes, so without bank conflicts; q as the B operand, one n-tile
//    of 8 heads per 8 grouped heads, so a K tile read from shared memory
//    scores all G; q's fragments stay in registers up to G = 8 and come
//    from shared memory by ldmatrix past it).  That is not for the flops (the
//    bound is bytes) but for the instruction path: 16 instructions score 16
//    rows for all heads.  fp32 stays exact on the CUDA cores: the lanes of
//    a row group split D into 16-byte vectors (no bank conflicts), q stays
//    in registers, and a reduce-scatter butterfly leaves each head's sum in
//    its own lanes (log2(lanes) + G - 1 shuffles a row group instead of
//    G·log2(lanes)).  G <= 8 is instantiated as such; 9..16 share one
//    instantiation padded to 16 with G read at run time.
//  - Windows instead of a softmax step per block: the scores of up to
//    `win_blocks` blocks stay in shared memory; when the window closes the
//    steps of all its blocks run at once from the prefix max over its
//    blocks (block j's running max = max(the max before the window, the
//    window's block maxima up to j): the max the sequential step uses, so
//    p is rounded exactly as there), and the V rows some head selected are
//    copied then, packed, `v_rows` at a time, while the block maxima, the
//    prefix max and p are computed, a warp per (block, head) with its lanes
//    over the block's rows (the scores' odd head stride keeps the heads'
//    reads off each other's banks).  V rows of unselected keys are not read.
//  - PV, G <= 8 and fp32: on the CUDA cores, a thread owns one 16-byte
//    column vector of the output for every head of its group (at most 8:
//    the registers; two groups above 8) and a subset of the selected rows;
//    the subsets' partial sums are added in a fixed order at the end.
//  - PV, bf16 at G > 8: on the tensor cores.  The padded 16 heads are one
//    m16 tile: A = p of the heads by a window block's packed rows (already
//    rounded to bf16, so exact), B = those V rows by ldmatrix .trans from
//    rows padded as K's, mma.sync m16n8k16 with fp32 sums; warp w owns the
//    output columns 16 w .. 16 w + 15.  A block's sum is weighted by its
//    w_j = exp(m_j - m_last) in fp32 before it is added, as the CUDA cores
//    weight each row (p is rounded against the block's running max, so the
//    weight cannot go into the bf16 operand).  The inputs are the CUDA
//    cores' product's; only the fp32 summation order differs.
// Every sum has a fixed order, so a launch is deterministic and both
// layouts agree bitwise.  The chunk, the ring depth, the window, the V
// batch and the cluster come from kernels/sata_decode.py::launch_config;
// the layout below must match its smem_bytes (the entry point checks).

#include <cmath>
#include <type_traits>

#include <cooperative_groups.h>

#include "sata_common.cuh"

namespace cg = cooperative_groups;

namespace {

// threads a block: 512 for G <= 4 (more warps to hide the latencies of
// scoring), 256 above (the registers of q and the CUDA cores' accumulators)
__host__ __device__ constexpr int threads_for(int G) { return G <= 4 ? 512 : 256; }
// head groups of the PV product: a thread accumulates one 16-byte column
// vector for the heads of its group, at most 8 heads (the registers)
__host__ __device__ constexpr int head_groups(int G) { return G <= 8 ? 1 : 2; }
// the PV product on the tensor cores: bf16 with G in 9..16, the padded 16
// heads one m16 tile (fp32 stays exact on the CUDA cores)
__host__ __device__ constexpr bool tc_pv(int G, int es) { return G > 8 && es == 2; }
constexpr int kMaxG = 16;
constexpr int kMaxD = 128;
constexpr int kMaxBlock = 128;
constexpr int kPlanWin = 1024;    // plan entries kept in shared memory
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;    // the portable cluster sizes: 1, 2, 4, 8

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory layout, byte offsets (kernels/sata_decode.py::smem_bytes
// computes the same total).  rs: bytes of one K/V row, rounded up to 16;
// a window holds the scores of up to `wp` blocks; its selected V rows go
// through a buffer of `vr` rows (rv bytes each).
struct Layout {
  int rs, rk, rv, nvec, nrs, wrows, ws;
  int ring, live, vbuf, s, sel, rowsel, vlist, gcount, pm, pw, psum;
  int m, l, thr, cw, plan_l, plan_p, nv, boff, qs;
  int total;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int o = off;
  off += round16(bytes);
  return o;
}

__host__ __device__ inline Layout make_layout(int G, int D, int kb, int es, int chunk,
                                              int stages, int wp, int vr) {
  Layout L{};
  L.rs = round16(D * es);
  // a bf16 K row in the ring: D rounded up to a multiple of 16 (the
  // tensor cores' k-step), and 16 bytes more, so that the eight rows an
  // ldmatrix reads fall on eight different bank groups
  L.rk = es == 2 ? (D * 2 + 31) / 32 * 32 + 16 : L.rs;
  const bool tc = tc_pv(G, es);
  // V rows read by ldmatrix (the tensor-core PV) are padded as K rows
  L.rv = tc ? L.rk : L.rs;
  L.nvec = L.rs / 16;
  // PV row subsets (the CUDA cores); the tensor cores keep one sum
  L.nrs = tc ? 1 : threads_for(G) / (L.nvec * head_groups(G));
  L.wrows = wp * kb;
  // a head's scores: an odd stride, so that the heads of a warp's loads
  // fall on different banks
  L.ws = L.wrows + 1;
  int off = 0;
  const int ring = stages * chunk * L.rk;                   // K ring, then the
  const int red = L.nrs * G * (L.rs / es) * 4;              // final reduction
  L.ring = take(off, ring > red ? ring : red);
  L.live = take(off, stages * chunk);
  L.vbuf = take(off, vr * L.rv);
  L.s = take(off, G * L.ws * 4);
  L.sel = take(off, G * L.wrows);
  L.rowsel = take(off, L.wrows);
  L.vlist = take(off, L.wrows * 2);
  L.gcount = take(off, (L.wrows + 31) / 32 * 4);
  L.pm = take(off, wp * G * 4);
  L.pw = take(off, wp * G * 4);
  L.psum = take(off, wp * G * 4);
  L.m = take(off, G * 4);
  L.l = take(off, G * 4);
  L.thr = take(off, G * 4);
  L.cw = take(off, G * 4);
  L.plan_l = take(off, kPlanWin * 4);
  L.plan_p = take(off, kPlanWin * 4);
  L.nv = take(off, 4);
  L.boff = take(off, tc ? (wp + 1) * 4 : 0);   // a window's blocks in the packed rows
  L.qs = take(off, tc ? 16 * L.rk : 0);         // q of the 16 heads, rows as K's
  L.total = off;
  return L;
}


// the selection predicate: bf16(s) >= bf16(thr), with thr already rounded
__device__ __forceinline__ bool admit(float s, float thr) { return bf16_rn(s) >= thr; }

// a 16-byte vector of shared memory as E = 16 / sizeof(T) floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void load(const unsigned char* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void load(const unsigned char* p, float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> fp32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Sum GP per-lane values over each aligned group of LPR lanes.  The first
// log2(GP) stages split the values between the two halves of the group (a
// lane keeps one half and receives its partner's part of it); the rest is
// a plain xor butterfly.  Returns the group's sum of value head_of(lane);
// every lane with the same head holds the same bits.
template <int GP, int LPR>
__device__ __forceinline__ float reduce_scatter(float (&v)[GP], int lane) {
  int n = GP;
#pragma unroll
  for (int o = LPR / 2; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < GP / 2; ++i) {
        if (i < n / 2) {
          const float send = up ? v[i] : v[i + n / 2];
          const float keep = up ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

template <int GP, int LPR>
__device__ __forceinline__ int head_of(int lane) {
  int head = 0, n = GP;
  for (int o = LPR / 2; o >= 1 && n > 1; o >>= 1, n /= 2)
    if (lane & o) head += n / 2;
  return head;
}

struct Args {
  const void* q;             // (B, KV, G, D)
  const void* k;             // pages of kb rows x (KV, D)
  const void* v;
  const int32_t* page_table; // (B, nkb) or null
  const int32_t* kv_indices; // (B*KV, P)
  const int32_t* kv_counts;  // (B*KV,)
  const float* thr;          // (B*KV, G)
  const int32_t* pos;        // (B,)
  void* out;                 // (B, KV, G, D); fp32 in the partial mode
  float* lse;                // (B*KV, G), or null: the partial mode's
  int n_kv, G, D, P, kb, nkb, chunk, stages, wp, vr, copy_bytes;
  int cs;                    // the cluster's blocks a row is split over
  float sm_scale;
};

template <typename P>
__device__ __forceinline__ P* at_rank(P* p, int r, int cs) {
  return cs > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
}

__device__ __forceinline__ void cluster_sync(int cs) {
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// One block's share of (slot b, KV head h) row `row`: the `count` plan
// entries from j_lo on (count > 0 unless the share is the whole row).
// Their planned rows (count blocks of kb rows, in plan order) stream
// through the K ring `chunk` rows at a time; each chunk is scored into the
// current window, whose selected rows are packed and their V copies issued
// when the window closes.  A window closes when its scores or
// its V rows could overflow, and at the end of the share: its
// online-softmax steps run then, all blocks at once, from the prefix max
// over its blocks (m after block j = max(m before the window, the window's
// block maxima up to j)), which gives every block the max the sequential
// step over the share would have used, so p is rounded exactly as there.
// Split over a cluster, leaves the share's running max and sum in m and l
// and its unnormalised output (the sum of p v over its keys) o[g][d] at
// the start of the ring; one block a row (cs = 1: G <= 8, the CUDA cores'
// PV) ends as the kernel always did, with o / l written out.
// GC: G itself for G <= 8, 16 for G in 9..16 (then G comes from a.G).
template <typename T, int GC>
__device__ __forceinline__ void row_share(const Args& a, const Layout& L,
                                          unsigned char* smem, int row, int j_lo,
                                          int count) {
  constexpr int kThreads = threads_for(GC), kWarps = kThreads / 32;
  const int G = GC <= 8 ? GC : a.G;
  using V = Vec<T>;
  constexpr int E = V::E;                        // elements per 16-byte vector
  constexpr int LPR = kMaxD * (int)sizeof(T) / 16;   // lanes per row: 16 bf16, 32 fp32
  constexpr int RPW = 32 / LPR;                  // rows per warp per pass
  constexpr int U = 1024 / kThreads;             // passes scored together
  constexpr int GP = GC <= 1 ? 1 : GC <= 2 ? 2 : GC <= 4 ? 4 : GC <= 8 ? 8 : 16;
  constexpr int NT = (GC + 7) / 8;               // n-tiles of 8 heads (tensor cores)
  constexpr int NHG = head_groups(GC), HPG = GC / NHG;   // PV head groups, heads each
  constexpr int es = sizeof(T);
  constexpr bool use_mma = es == 2;              // bf16 scores on the tensor cores
  constexpr bool tc = tc_pv(GC, es);             // and the PV product, G > 8

  const int b = row / a.n_kv, h = row % a.n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, kb = a.kb, C = a.chunk, S = a.stages, WP = a.wp, VR = a.vr;
  const int RS = L.rs, RK = L.rk, RV = L.rv, nvec = L.nvec, WR = L.wrows, WS = L.ws;
  const int rb = D * es;                         // bytes of a row in global memory
  const int cb = a.copy_bytes, ppr = rb / cb;    // copies per row
  // a window grows by whole units: one chunk of whole blocks, or the
  // chunks of one block
  const int unit = C >= kb ? C : kb;
  const int cpu = unit / C;                      // chunks per unit

  unsigned char* ring = smem + L.ring;
  unsigned char* live_sh = smem + L.live;                      // [S][C]
  unsigned char* vbuf = smem + L.vbuf;
  float* s_w = reinterpret_cast<float*>(smem + L.s);          // [G][WS]
  unsigned char* sel_w = smem + L.sel;                         // [G][WR]
  unsigned char* rowsel = smem + L.rowsel;                     // [WR]
  int16_t* vlist = reinterpret_cast<int16_t*>(smem + L.vlist); // [WR]
  int* gcount = reinterpret_cast<int*>(smem + L.gcount);       // [WR / 32]
  float* pm = reinterpret_cast<float*>(smem + L.pm);          // [WP][G]
  float* pw = reinterpret_cast<float*>(smem + L.pw);          // [WP][G]
  float* psum = reinterpret_cast<float*>(smem + L.psum);      // [WP][G]
  float* m_sh = reinterpret_cast<float*>(smem + L.m);
  float* l_sh = reinterpret_cast<float*>(smem + L.l);
  float* thr_sh = reinterpret_cast<float*>(smem + L.thr);
  float* cw_sh = reinterpret_cast<float*>(smem + L.cw);
  int* plan_l = reinterpret_cast<int*>(smem + L.plan_l);
  int* plan_p = reinterpret_cast<int*>(smem + L.plan_p);
  int* nv_sh = reinterpret_cast<int*>(smem + L.nv);           // V rows packed
  int* boff = reinterpret_cast<int*>(smem + L.boff);          // [WP + 1] (tc)

  const T* q = static_cast<const T*>(a.q);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  const int pos_b = a.pos[b];
  const size_t tok_bytes = (size_t)a.n_kv * rb;  // bytes between token rows
  const int total_rows = count * kb;
  const int n_chunks = (total_rows + C - 1) / C;
  const unsigned long long kb_m = div_magic(kb), ppr_m = div_magic(ppr);

  // --- prologue: the row's plan, thresholds, running max / sum, q
  const int32_t* idx = a.kv_indices + (size_t)row * a.P + j_lo;
  const int32_t* table = a.page_table;
  const int nkb = a.nkb;
  auto phys_of = [&](int lblk) -> int {
    return table ? table[(size_t)b * nkb + lblk] : b * nkb + lblk;
  };
  for (int j = tid; j < min(count, kPlanWin); j += kThreads) {
    const int lblk = idx[j];
    plan_l[j] = lblk;
    plan_p[j] = phys_of(lblk);
  }
  if (tid < G) {
    thr_sh[tid] = bf16_rn(a.thr[(size_t)row * G + tid]);
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  if constexpr (tc) {
    // q of the 16 (padded) heads in shared memory, the scores' B operand
    // by ldmatrix (32 registers fewer than holding it)
    T* qs = reinterpret_cast<T*>(smem + L.qs);
    const int hw = RK / 2;
    for (int x = tid; x < 16 * hw; x += kThreads) {
      const int hh = x / hw, d = x - hh * hw;
      qs[x] = hh < G && d < D ? q[((size_t)row * G + hh) * D + d] : from_f32<T>(0.f);
    }
  }
  // the copies never write a row's padding, which scoring reads: zero it once
  if ((es == 2 ? (rb + 31) / 32 * 32 : RS) != rb)
    for (int i = tid; i < S * C * RK / 4; i += kThreads)
      reinterpret_cast<float*>(ring)[i] = 0.f;
  const int lir = lane % LPR;                    // lane within its row group
  float qr[GP][E];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lir * E + e;
      qr[g][e] = (g < G && d < D) ? to_f32(q[((size_t)row * G + g) * D + d]) : 0.f;
    }
  __syncthreads();

  auto block_of = [&](int j, int& lblk, int& phys) {
    if (j < kPlanWin) {
      lblk = plan_l[j];
      phys = plan_p[j];
    } else {
      lblk = idx[j];
      phys = phys_of(lblk);
    }
  };
  // K copies of chunk i: its rows with token <= pos, into ring slot i % S;
  // each row's flag (0: past the plan, 1: past pos, 2: live) beside them
  auto issue_k = [&](int i) {
    if (i >= n_chunks) return;
    const int slot = i % S;
    unsigned char* dst = ring + slot * C * RK;
    auto one = [&](int x, auto copy) {
      const int r = div_by(x, ppr_m), w = x - r * ppr;
      const int f = i * C + r;                   // row in the row's plan order
      const int j = div_by(f, kb_m), t = f - j * kb;
      int flag = 0;
      if (j < count) {
        int lblk, phys;
        block_of(j, lblk, phys);
        const int tok = lblk * kb + t;
        const bool live = tok <= pos_b;          // LOGICAL position
        flag = live ? 2 : 1;
        if (live)
          copy(dst + r * RK + w * cb,
               kg + ((size_t)phys * kb + t) * tok_bytes + (size_t)h * rb + w * cb);
      }
      if (w == 0) live_sh[slot * C + r] = flag;
    };
    if (cb == 16) {
#pragma unroll 4
      for (int x = tid; x < C * ppr; x += kThreads)
        one(x, [](void* d, const void* g) { copy_async(d, g, 16); });
    } else {
      for (int x = tid; x < C * ppr; x += kThreads)
        one(x, [&](void* d, const void* g) { copy_async(d, g, cb); });
    }
  };
  // one commit group per chunk: K_0 .. K_{S-1} now, then at step i the
  // copies of K chunk i + S and of chunk i's selected V rows
  for (int i = 0; i < S; ++i) {
    issue_k(i);
    commit_group();
  }

  // PV on the CUDA cores: column vector cv of heads hg * HPG .. + HPG,
  // over row subset rs_id
  const int cv = tid % nvec, hg = (tid / nvec) % NHG, rs_id = tid / (nvec * NHG);
  const int h0 = hg * HPG;
  float acc[HPG][E];
#pragma unroll
  for (int g = 0; g < HPG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  // PV on the tensor cores: warp w owns columns 16 w .. 16 w + 15 (two
  // n-tiles of 8) of heads hr and hr + 8, in the m16n8 accumulator layout
  const int hr = lane >> 2, tq = lane & 3;
  float acc_t[2][4] = {};

  // V copies of the packed rows [v0, v0 + n) into the V buffer
  auto issue_v = [&](int j0, int v0, int n) {
    for (int x = tid; x < n * ppr; x += kThreads) {
      const int k = div_by(x, ppr_m), w = x - k * ppr;
      const int fw = vlist[v0 + k];
      const int jw = div_by(fw, kb_m);
      int lblk, phys;
      block_of(j0 + jw, lblk, phys);
      copy_async(vbuf + k * RV + w * cb,
                 vg + ((size_t)phys * kb + (fw - jw * kb)) * tok_bytes + (size_t)h * rb +
                     w * cb,
                 cb);
    }
    commit_group();
  };

  // --- the online-softmax steps and the PV products of window blocks
  // [j0, j0 + nw): pack the rows some head selected, start their V copies,
  // run the softmax steps, then the PV product in batches of VR rows
  auto close_window = [&](int j0, int nw) {
    const int wr = nw * kb, ngr = (wr + 31) / 32;
    for (int gi = warp; gi < ngr; gi += kWarps) {
      const unsigned bal = __ballot_sync(0xffffffffu, gi * 32 + lane < wr &&
                                                          rowsel[gi * 32 + lane]);
      if (lane == 0) gcount[gi] = __popc(bal);
    }
    __syncthreads();
    if (warp == 0) {          // exclusive prefix sum of the group counts
      int carry = 0;
      for (int g0 = 0; g0 < ngr; g0 += 32) {
        const int x = g0 + lane < ngr ? gcount[g0 + lane] : 0;
        int inc = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        if (g0 + lane < ngr) gcount[g0 + lane] = carry + inc - x;
        carry += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) *nv_sh = carry;
    }
    __syncthreads();
    for (int gi = warp; gi < ngr; gi += kWarps) {
      const int f = gi * 32 + lane;
      const bool fl = f < wr && rowsel[f];
      const unsigned bal = __ballot_sync(0xffffffffu, fl);
      if (fl) vlist[gcount[gi] + __popc(bal & ((1u << lane) - 1u))] = f;
    }
    __syncthreads();
    const int nv = *nv_sh;
    issue_v(j0, 0, min(nv, VR));
    if constexpr (tc) {
      // boff[jj]: the packed rows before window block jj (vlist ascends)
      for (int jj = tid; jj <= nw; jj += kThreads) {
        int lo = 0, hi = nv;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (vlist[mid] < jj * kb)
            lo = mid + 1;
          else
            hi = mid;
        }
        boff[jj] = lo;
      }
    }
    // block maxima, a warp per (block, head), its lanes over the rows
    for (int x = warp; x < nw * G; x += kWarps) {
      const int jj = x / G, g = x - jj * G;
      const float* sg = s_w + g * WS + jj * kb;
      float mx = kNegInf;
#pragma unroll 1
      for (int t = lane; t < kb; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      if (lane == 0) pm[x] = mx;
    }
    __syncthreads();
    // prefix max over the blocks, one warp per head in turn; block weights
    // exp(m_j - m_last) and the earlier windows' weight exp(m - m_last)
    for (int g = warp; g < G; g += kWarps) {
      const float m_prev = m_sh[g];
      float carry = m_prev;
      for (int j = 0; j < nw; j += 32) {
        float x = j + lane < nw ? pm[(j + lane) * G + g] : kNegInf;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x = fmaxf(x, y);
        }
        x = fmaxf(x, carry);
        if (j + lane < nw) pm[(j + lane) * G + g] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
      for (int j = lane; j < nw; j += 32) pw[j * G + g] = expf(pm[j * G + g] - carry);
      if (lane == 0) {
        cw_sh[g] = expf(m_prev - carry);
        m_sh[g] = carry;
      }
    }
    __syncthreads();
    // p of every (block, head, row) against its block's running max,
    // rounded in place, and the unrounded sum per (block, head); a warp
    // per (block, head), its lanes over the rows
    for (int x = warp; x < nw * G; x += kWarps) {
      const int jj = x / G, g = x - jj * G;
      const float mj = pm[x];
      float* sg = s_w + g * WS + jj * kb;
      const unsigned char* selg = sel_w + g * WR + jj * kb;
      float sum = 0.f;
#pragma unroll 1
      for (int t = lane; t < kb; t += 32) {
        const float p = selg[t] ? expf(sg[t] - mj) : 0.f;
        sum += p;
        const float pr = to_f32(from_f32<T>(p));     // p.astype(v.dtype)
        sg[t] = pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) psum[x] = sum;
    }
    __syncthreads();
    // l = l * cw + sum_j psum_j * w_j; acc = acc * cw + the V rows' terms
    for (int g = warp; g < G; g += kWarps) {
      float part = 0.f;
      for (int j = lane; j < nw; j += 32) part += psum[j * G + g] * pw[j * G + g];
      part = warp_sum(part);
      if (lane == 0) l_sh[g] = l_sh[g] * cw_sh[g] + part;
    }
    if constexpr (tc) {
      const float c0 = hr < G ? cw_sh[hr] : 0.f, c1 = hr + 8 < G ? cw_sh[hr + 8] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc_t[nt][0] *= c0;
        acc_t[nt][1] *= c0;
        acc_t[nt][2] *= c1;
        acc_t[nt][3] *= c1;
      }
    } else if (rs_id < L.nrs) {
#pragma unroll
      for (int g = 0; g < HPG; ++g) {
        if (h0 + g < G) {
          const float c = cw_sh[h0 + g];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= c;
        }
      }
    }
    for (int v0 = 0; v0 < nv; v0 += VR) {
      if (v0 > 0) issue_v(j0, v0, min(nv - v0, VR));
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      const int nb = min(nv - v0, VR);               // the batch's packed rows
      if constexpr (tc) {
        // one window block at a time (its p share one running max): heads
        // by the block's packed rows in this batch (p as A, bf16 and exact)
        // times their V rows (B, by ldmatrix .trans) for the warp's
        // columns, fp32 sums; the block's sum then weighted by w_j in fp32,
        // as the CUDA cores' product weights each row
        if (16 * warp < D) {
          for (int jj = 0; jj < nw; ++jj) {
            const int lo = max(boff[jj], v0), hi = min(boff[jj + 1], v0 + nb);
            if (lo >= hi) continue;
            float c[2][4] = {};
            for (int k0 = lo; k0 < hi; k0 += 16) {
              auto pa = [&](int hh, int i) {
                return hh < G && i < hi ? s_w[hh * WS + vlist[i]] : 0.f;
              };
              const int i0 = k0 + 2 * tq;
              uint32_t af[4], bv[4];
              af[0] = pack_bf16(pa(hr, i0), pa(hr, i0 + 1));
              af[1] = pack_bf16(pa(hr + 8, i0), pa(hr + 8, i0 + 1));
              af[2] = pack_bf16(pa(hr, i0 + 8), pa(hr, i0 + 9));
              af[3] = pack_bf16(pa(hr + 8, i0 + 8), pa(hr + 8, i0 + 9));
              // rows past the block read its last row (finite; p is 0 there)
              const int vi = min(k0 + (lane & 7) + (lane & 8), hi - 1) - v0;
              ldmatrix_x4_trans(bv, vbuf + vi * RV + (16 * warp + (lane >> 4) * 8) * 2);
              mma_bf16(c[0], af, bv[0], bv[1]);
              mma_bf16(c[1], af, bv[2], bv[3]);
            }
            const float w0 = hr < G ? pw[jj * G + hr] : 0.f;
            const float w1 = hr + 8 < G ? pw[jj * G + hr + 8] : 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              acc_t[nt][0] += w0 * c[nt][0];
              acc_t[nt][1] += w0 * c[nt][1];
              acc_t[nt][2] += w1 * c[nt][2];
              acc_t[nt][3] += w1 * c[nt][3];
            }
          }
        }
      } else if (rs_id < L.nrs) {
        const unsigned char* vb = vbuf + cv * 16;
        for (int i = rs_id; i < nb; i += L.nrs) {
          const int fw = vlist[v0 + i];
          const int jw = div_by(fw, kb_m);
          float vf[E];
          V::load(vb + i * RS, vf);
#pragma unroll
          for (int g = 0; g < HPG; ++g) {
            if (h0 + g < G) {
              const float w = s_w[(h0 + g) * WS + fw] * pw[jw * G + h0 + g];
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][e] += w * vf[e];
            }
          }
        }
      }
      __syncthreads();
    }
  };

  // --- main loop: one K chunk per step
  const int row_in_warp = lane / LPR;
  // after the reduce-scatter, lane lir holds head hd's score; the lanes
  // whose low bits are zero write it
  const int hd = head_of<GP, LPR>(lir);
  const bool head_lane = (lir & (LPR / GP - 1)) == 0 && hd < G;
  const float thr_hd = hd < G ? thr_sh[hd] : 0.f;
  const unsigned row_mask = (LPR == 32 ? 0xffffffffu : ((1u << (LPR & 31)) - 1u))
                            << (row_in_warp * LPR);
  // bf16 scores on the tensor cores: q as the B operand, head
  // nt * 8 + lane/4 of k-step ks in qb[nt][ks], heads past G and d past D
  // zero (fp32 uses qr; past G = 8 the fragments come from shared memory,
  // both n-tiles of a k-step by one ldmatrix at qp)
  uint32_t qb[tc ? 1 : NT][kMaxD / 16][2];
  float thr_mma[NT][2];
  const unsigned char* qp =
      smem + L.qs + ((lane & 7) + ((lane >> 4) << 3)) * RK + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if constexpr (!tc) {
#pragma unroll
      for (int ks = 0; ks < kMaxD / 16; ++ks) {
        const int n = nt * 8 + (lane >> 2), d0 = ks * 16 + (lane & 3) * 2;
        auto qv = [&](int d) {
          return n < G && d < D ? to_f32(q[((size_t)row * G + n) * D + d]) : 0.f;
        };
        qb[nt][ks][0] = pack_bf16(qv(d0), qv(d0 + 1));
        qb[nt][ks][1] = pack_bf16(qv(d0 + 8), qv(d0 + 9));
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = nt * 8 + 2 * (lane & 3) + e;
      thr_mma[nt][e] = h < G ? thr_sh[h] : 0.f;
    }
  }
  int j0 = 0;                                    // first block of the window
  for (int i = 0; i < n_chunks; ++i) {
    wait_pending(S - 1);      // chunk i has landed
    __syncthreads();
    const int f0 = i * C;                        // first row of the chunk
    const int jc = div_by(f0, kb_m);             // its block
    if (i % cpu == 0 && jc > j0 && jc - j0 + max(1, C / kb) > WP) {
      close_window(j0, jc - j0);
      j0 = jc;
    }
    const unsigned char* kt = ring + (i % S) * C * RK;
    const unsigned char* lv = live_sh + (i % S) * C;
    const int fw0 = f0 - j0 * kb;                // the chunk's first row in the window
    if constexpr (use_mma) {
      // tensor cores: each warp takes 16-row tiles; a lane's accumulators
      // hold rows lane/4 and lane/4 + 8 for heads nt * 8 + 2 (lane % 4)
      // and + 1 of each n-tile nt
      for (int mt = warp; mt * 16 < C; mt += kWarps) {
        float c[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
        const int lr = min(mt * 16 + (lane & 7) + (lane & 8), C - 1);
        const unsigned char* ap = kt + lr * RK + (lane >> 4) * 16;
#pragma unroll
        for (int ks = 0; ks < kMaxD / 16; ++ks) {
          if (ks * 16 < D) {
            uint32_t af[4];
            ldmatrix_x4(af, ap + ks * 32);
            if constexpr (tc) {
              uint32_t qf[4];
              ldmatrix_x4(qf, qp + ks * 32);
              mma_bf16(c[0], af, qf[0], qf[1]);
              mma_bf16(c[1], af, qf[2], qf[3]);
            } else {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_bf16(c[nt], af, qb[nt][ks][0], qb[nt][ks][1]);
            }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + (lane >> 2) + half * 8;
          const int flag = r < C ? lv[r] : 0;
          bool any = false;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int h = nt * 8 + 2 * (lane & 3) + e;
              const float s = c[nt][2 * half + e] * a.sm_scale;
              const bool sel = flag == 2 && h < G && admit(s, thr_mma[nt][e]);
              if (h < G && flag != 0) {
                s_w[h * WS + fw0 + r] = sel ? s : kNegInf;
                sel_w[h * WR + fw0 + r] = sel;
              }
              any |= sel;
            }
          }
          const unsigned bal = __ballot_sync(0xffffffffu, any);
          if ((lane & 3) == 0 && flag != 0)
            rowsel[fw0 + r] = ((bal >> (lane & ~3)) & 0xfu) != 0;
        }
      }
    } else {
      for (int r0 = warp * RPW; r0 < C; r0 += kWarps * RPW * U) {
        float kf[U][E];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // rows past the chunk load a valid row and are masked below
          const int r = min(r0 + u * kWarps * RPW + row_in_warp, C - 1);
          if (lir < nvec) {
            V::load(kt + r * RK + lir * 16, kf[u]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kf[u][e] = 0.f;
          }
        }
        // the U rows' dot products and reductions, free of branches so that
        // their latencies overlap
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part[GP];
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            part[g] = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) part[g] += qr[g][e] * kf[u][e];
          }
          sc[u] = reduce_scatter<GP, LPR>(part, lir) * a.sm_scale;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float s = sc[u];
          const int r = r0 + u * kWarps * RPW + row_in_warp;
          const int flag = r < C ? lv[r] : 0;
          const bool in = flag != 0;
          const bool sel = flag == 2 && hd < G && admit(s, thr_hd);
          const bool writer = head_lane && in;
          if (writer) {
            s_w[hd * WS + fw0 + r] = sel ? s : kNegInf;
            sel_w[hd * WR + fw0 + r] = sel;
          }
          const unsigned grp = __ballot_sync(0xffffffffu, writer && sel);
          if (lir == 0 && in) rowsel[fw0 + r] = (grp & row_mask) != 0;
        }
      }
    }
    __syncthreads();          // the slot is free; the chunk's selection is visible
    issue_k(i + S);
    commit_group();
  }
  if (count > 0) close_window(j0, count - j0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // --- the share's output o[g][d] at the start of the ring; one block a
  // row (cs = 1) divides by l and writes the output at once
  float* red = reinterpret_cast<float*>(ring);
  const int dpad = RS / es;
  if constexpr (tc) {
    // one owner per (head, column)
    if (16 * warp < D) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = hr + (e >> 1) * 8, d = 16 * warp + nt * 8 + 2 * tq + (e & 1);
          if (hh < G && d < D) red[hh * dpad + d] = acc_t[nt][e];
        }
    }
  } else {
    // the row subsets' partial sums, added in a fixed order into subset 0's
    if (rs_id < L.nrs) {
#pragma unroll
      for (int g = 0; g < HPG; ++g)
        if (h0 + g < G)
#pragma unroll
          for (int e = 0; e < E; ++e)
            red[(rs_id * G + h0 + g) * dpad + cv * E + e] = acc[g][e];
    }
    __syncthreads();
    for (int x = tid; x < G * D; x += kThreads) {
      const int g = x / D, d = x - g * D;
      float o = 0.f;
      for (int s2 = 0; s2 < L.nrs; ++s2) o += red[(s2 * G + g) * dpad + d];
      if (a.cs > 1) {
        red[g * dpad + d] = o;
      } else {
        const float l = l_sh[g];
        const float y = l > 0.f ? o / l : 0.f;
        if (a.lse)
          static_cast<float*>(a.out)[((size_t)row * G + g) * D + d] = y;
        else
          static_cast<T*>(a.out)[((size_t)row * G + g) * D + d] = from_f32<T>(y);
      }
    }
    if (a.cs == 1 && a.lse && tid < G) {
      const float l = l_sh[tid];
      a.lse[(size_t)row * G + tid] =
          l > 0.f ? m_sh[tid] + logf(l) : -__int_as_float(0x7f800000);
    }
  }
}

// The rank-order combine of head g over the cluster's shares: the weight
// w_r = exp(m_r - M) of each rank, M the largest m of the ranks that
// admitted a key (kNegInf if none did); returns the denominator
// sum_r w_r l_r.
__device__ __forceinline__ float share_weights(const float* m_sh, const float* l_sh, int g,
                                               int cs, float (&w)[kMaxCluster], float& M) {
  bool live[kMaxCluster];
  float lr[kMaxCluster];
  M = kNegInf;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    lr[r] = r < cs ? at_rank(l_sh, r, cs)[g] : 0.f;
    // a rank that admitted no key contributes nothing, explicitly: an
    // empty share never writes its m or its o, and with the finite
    // sentinel exp(m - M) would be 1 where every rank is empty
    live[r] = lr[r] > 0.f;
    if (live[r]) M = fmaxf(M, at_rank(m_sh, r, cs)[g]);
  }
  float den = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    w[r] = 0.f;
    if (live[r]) {
      const float m = at_rank(m_sh, r, cs)[g];
      w[r] = m == M ? 1.f : expf(m - M);
      den = fmaf(w[r], lr[r], den);
    }
  }
  return den;
}

// A cluster of cs blocks per (slot b, KV head h) row, rank r taking the
// contiguous share [r * per, min(count, (r + 1) * per)) of the row's
// `count` plan entries, per = ceil(count / cs); a share may be empty.
// After the shares, each rank combines D / cs of the columns from every
// rank's (m, l, o) through distributed shared memory, in rank order.
// Launch bounds: two blocks an SM where a split row's blocks are staged
// for two (the tensor cores' PV, 128 registers), else one, so that ptxas
// may take the registers it needs without spilling.
template <typename T, int GC>
__global__ void __launch_bounds__(threads_for(GC), tc_pv(GC, (int)sizeof(T)) ? 2 : 1)
sata_decode_kernel(const Args a) {
  constexpr int kThreads = threads_for(GC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = GC <= 8 ? GC : a.G;
  const int cs = a.cs, rank = blockIdx.x % cs, row = blockIdx.x / cs;
  const int tid = threadIdx.x, D = a.D;
  const Layout L = make_layout(G, D, a.kb, sizeof(T), a.chunk, a.stages, a.wp, a.vr);
  float* m_sh = reinterpret_cast<float*>(smem + L.m);
  float* l_sh = reinterpret_cast<float*>(smem + L.l);
  const float* o_sh = reinterpret_cast<const float*>(smem + L.ring);
  const int count = min(a.kv_counts[row], a.P), per = (count + cs - 1) / cs;
  const int j_lo = min(count, rank * per), n = min(count - j_lo, per);
  // one block a row on the CUDA cores writes its output itself
  const bool whole = cs == 1 && !tc_pv(GC, (int)sizeof(T));
  if (n > 0 || whole)
    row_share<T, GC>(a, L, smem, row, j_lo, n);
  else if (tid < G)
    l_sh[tid] = 0.f;          // an empty share publishes l = 0 and nothing else
  if (whole) return;
  cluster_sync(cs);           // every rank's m, l and o are written

  const int dpad = L.rs / (int)sizeof(T);
  const int dper = (D + cs - 1) / cs, d0 = min(D, rank * dper), nd = min(D - d0, dper);
  for (int x = tid; x < G * nd; x += kThreads) {
    const int g = x / nd, d = d0 + x - g * nd;
    float w[kMaxCluster], M;
    const float den = share_weights(m_sh, l_sh, g, cs, w, M);
    float num = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (w[r] > 0.f) num = fmaf(w[r], at_rank(o_sh, r, cs)[g * dpad + d], num);
    const float y = den > 0.f ? num / den : 0.f;
    if (a.lse)
      static_cast<float*>(a.out)[((size_t)row * G + g) * D + d] = y;
    else
      static_cast<T*>(a.out)[((size_t)row * G + g) * D + d] = from_f32<T>(y);
  }
  if (a.lse && rank == 0 && tid < G) {
    float w[kMaxCluster], M;
    const float den = share_weights(m_sh, l_sh, tid, cs, w, M);
    a.lse[(size_t)row * G + tid] = den > 0.f ? M + logf(den) : -__int_as_float(0x7f800000);
  }
  if (cs > 1) cluster_sync(cs);   // no rank leaves while another reads its memory
}

// The kernel's attributes for a launch of `smem_bytes` in clusters of cs,
// and that launch's configuration (its grid: rows x cs blocks).  A split
// row's blocks may be staged to fit two an SM: the carveout asks for all
// of the SM's 228 KB as shared memory.
template <typename T, int GC>
cudaError_t configure(int rows, int cs, int smem_bytes, cudaStream_t s,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto* fn = sata_decode_kernel<T, GC>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e == cudaSuccess && cs > 1)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  cfg = {};
  cfg.gridDim = dim3(rows * cs);
  cfg.blockDim = dim3(threads_for(GC));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return e;
}

template <typename T, int GC>
int launch(const Args& a, int rows, int smem_bytes, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, GC>(rows, a.cs, smem_bytes, s, cfg, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.cs == 1) {
    sata_decode_kernel<T, GC><<<rows, threads_for(GC), smem_bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  e = cudaLaunchKernelEx(&cfg, sata_decode_kernel<T, GC>, a);   // cs blocks a row
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GC>
int max_clusters(int cs, int smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, GC>(1, cs, smem_bytes, nullptr, cfg, attr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, sata_decode_kernel<T, GC>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// f(std::integral_constant<int, GC>) for G's instantiation: G itself up to
// 8, 16 for 9..16
template <typename F>
int by_g(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  if (G > 8 && G <= kMaxG) return f(std::integral_constant<int, 16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream`; returns 0 when the launch was accepted, else a
// cudaError_t (cudaErrorInvalidValue for arguments outside the kernel's
// limits or a shared-memory size that does not match the layout).
// dtype: 0 = float32, 1 = bfloat16.  nkb: the page table's row stride
// (max_pages) for the pool, or S / k_block for the contiguous cache.
// chunk, stages, win_blocks, v_rows, smem_bytes, cluster:
// kernels/sata_decode.py::launch_config; copy_bytes: 16, 8, 4 or 2,
// dividing D * sizeof(dtype) and the alignment of k and v.
static int run(const void* q, const void* k, const void* v, const void* page_table,
               const void* kv_indices, const void* kv_counts, const void* thresholds,
               const void* pos, void* out, void* lse, int batch, int n_kv, int G, int D,
               int P, int k_block, int nkb, int dtype, int chunk, int stages,
               int win_blocks, int v_rows, int smem_bytes, int copy_bytes, int cluster,
               void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  const int unit = chunk >= k_block ? chunk : k_block;
  const bool ok = G >= 1 && G <= kMaxG && D >= 1 && D <= kMaxD && k_block >= 1 &&
                  k_block <= kMaxBlock && chunk >= 1 &&
                  (chunk >= k_block ? chunk % k_block : k_block % chunk) == 0 &&
                  stages >= 2 && stages <= kMaxStages &&
                  win_blocks * k_block >= unit && v_rows >= 1 &&
                  win_blocks * k_block <= 32767 &&
                  (copy_bytes == 16 || copy_bytes == 8 || copy_bytes == 4 ||
                   copy_bytes == 2) && (D * es) % copy_bytes == 0 &&
                  (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
                  make_layout(G, D, k_block, es, chunk, stages, win_blocks, v_rows).total ==
                      smem_bytes;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.page_table = static_cast<const int32_t*>(page_table);
  a.kv_indices = static_cast<const int32_t*>(kv_indices);
  a.kv_counts = static_cast<const int32_t*>(kv_counts);
  a.thr = static_cast<const float*>(thresholds);
  a.pos = static_cast<const int32_t*>(pos);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.n_kv = n_kv; a.G = G; a.D = D; a.P = P; a.kb = k_block; a.nkb = nkb;
  a.chunk = chunk; a.stages = stages; a.wp = win_blocks; a.vr = v_rows;
  a.copy_bytes = copy_bytes;
  a.cs = cluster;
  // rounded once from double, as the plain version's fp32 scale is
  a.sm_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n_kv;
  return by_g(G, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    return dtype == 1 ? launch<__nv_bfloat16, GC>(a, rows, smem_bytes, s)
                      : launch<float, GC>(a, rows, smem_bytes, s);
  });
}

extern "C" int sata_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* kv_indices, const void* kv_counts, const void* thresholds,
    const void* pos, void* out, int batch, int n_kv, int G, int D, int P,
    int k_block, int nkb, int dtype, int chunk, int stages, int win_blocks,
    int v_rows, int smem_bytes, int copy_bytes, int cluster, void* stream) {
  return run(q, k, v, page_table, kv_indices, kv_counts, thresholds, pos, out, nullptr,
             batch, n_kv, G, D, P, k_block, nkb, dtype, chunk, stages, win_blocks,
             v_rows, smem_bytes, copy_bytes, cluster, stream);
}

// The partial mode: `out` is fp32 (B, KV, G, D) whatever the dtype, and
// `lse` fp32 (B, KV, G): m + log(l) of each (row, head), -inf where the
// row admitted no key.  Arguments otherwise as sata_decode_attention's.
extern "C" int sata_decode_attention_partial(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* kv_indices, const void* kv_counts, const void* thresholds,
    const void* pos, void* out, void* lse, int batch, int n_kv, int G, int D,
    int P, int k_block, int nkb, int dtype, int chunk, int stages,
    int win_blocks, int v_rows, int smem_bytes, int copy_bytes, int cluster,
    void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, page_table, kv_indices, kv_counts, thresholds, pos, out, lse,
             batch, n_kv, G, D, P, k_block, nkb, dtype, chunk, stages, win_blocks,
             v_rows, smem_bytes, copy_bytes, cluster, stream);
}

// The clusters of `cluster` blocks of G's instantiation, each with
// `smem_bytes` of dynamic shared memory, that the card holds at once
// (cudaOccupancyMaxActiveClusters), for the timing scripts; a negative
// cudaError_t on an error.
extern "C" int sata_decode_max_clusters(int G, int dtype, int cluster, int smem_bytes) {
  return by_g(G, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    return dtype == 1 ? max_clusters<__nv_bfloat16, GC>(cluster, smem_bytes)
                      : max_clusters<float, GC>(cluster, smem_bytes);
  });
}
