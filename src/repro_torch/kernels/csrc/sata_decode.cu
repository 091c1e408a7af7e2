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
//
// What bounds it on an H100.  The work is bound by bytes: the output needs
// the K rows of the planned blocks up to pos (every one is scored), only
// the V rows of keys that at least one of the G heads selects (top-k per
// head, so at most G·k of them), q, out and the plan, once each.  At
// ~4·G·D flops per key row that is at most ~8 flops per bf16 byte at G = 4,
// far below the ~295 flops/byte where the tensor cores would become the
// limit, so the least time is those bytes / 3.35 TB/s.  This kernel does
// not reach it: with one block per row (B·KV blocks) each block works
// through its row's keys alone, and its time goes to the instructions that
// score, stage and synchronise each chunk, not to waiting for memory
// (PERF.md: a deeper ring or a warm L2 changes little).
//
// What the design does about the memory side, and to keep the instruction
// path short:
//  - Prologue: the block loads its row's plan (kv_indices[0..count) and,
//    for the pool, the page-table entries) into shared memory once, so a
//    row's address is known before its copy is issued; the dependent
//    index -> table -> data chain is paid once per row, not per block.
//  - A ring of `stages` chunks of `chunk` K rows in shared memory (whole
//    k-blocks, or a divisor of one, so the depth does not depend on the
//    page size or the dtype), filled with 16-byte cp.async.cg copies where
//    the rows allow (narrower ones otherwise) in one commit group per chunk,
//    `stages` - 1 chunks ahead of the one being scored.  K rows past pos are
//    not copied; a flag per row beside the ring says so.
//  - Scoring, the largest share of the instructions: bf16 scores on the
//    tensor cores (mma.sync m16n8k16, fp32 accumulation; K tiles by
//    ldmatrix from rows padded to an odd multiple of 16 bytes, so without
//    bank conflicts; q, heads padded to 8, as the B operand in registers).
//    That is not for the flops (the bound is bytes) but for the
//    instruction path: 16 instructions score 16 rows for all heads.  fp32
//    stays exact on the CUDA cores: the lanes of a row group split D into
//    16-byte vectors (no bank conflicts), q stays in registers, and a
//    reduce-scatter butterfly leaves each head's sum in its own lanes
//    (log2(lanes) + G - 1 shuffles a row group instead of G·log2(lanes)).
//  - Windows instead of a softmax step per block: the scores of up to
//    `win_blocks` blocks stay in shared memory; when the window closes the
//    steps of all its blocks run at once from the prefix max over its
//    blocks (block j's running max = max(the max before the window, the
//    window's block maxima up to j): the max the sequential step uses, so
//    p is rounded exactly as there), and the V rows some head selected are
//    copied then, packed, `v_rows` at a time, while the block maxima, the
//    prefix max and p are computed.  V rows of unselected keys are not read.
//  - PV: a thread owns one 16-byte column vector of the output for every
//    head and a subset of the selected rows; the subsets' partial sums are
//    added in a fixed order at the end.  Every sum has a fixed order, so a
//    launch is deterministic and both layouts agree bitwise.
// The chunk, the ring depth, the window and the V batch come from
// kernels/sata_decode.py::launch_config; the layout below must match its
// smem_bytes (the entry point checks).

#include <cmath>

#include "sata_common.cuh"

namespace {

// threads a block: 512 for G <= 4 (more warps to hide the latencies of
// scoring), 256 above (the registers of q and the accumulators)
__host__ __device__ constexpr int threads_for(int G) { return G <= 4 ? 512 : 256; }
constexpr int kMaxG = 8;          // <= warps: one warp per head in the softmax step
constexpr int kMaxD = 128;
constexpr int kMaxBlock = 128;
constexpr int kPlanWin = 1024;    // plan entries kept in shared memory
constexpr int kMaxStages = 8;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory layout, byte offsets (kernels/sata_decode.py::smem_bytes
// computes the same total).  rs: bytes of one K/V row, rounded up to 16;
// a window holds the scores of up to `wp` blocks; its selected V rows go
// through a buffer of `vr` rows.
struct Layout {
  int rs, rk, nvec, nrs, wrows;
  int ring, live, vbuf, s, sel, rowsel, vlist, gcount, pm, pw, psum;
  int m, l, thr, cw, plan_l, plan_p, nv;
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
  L.nvec = L.rs / 16;
  L.nrs = threads_for(G) / L.nvec;
  L.wrows = wp * kb;
  int off = 0;
  const int ring = stages * chunk * L.rk;                   // K ring, then the
  const int red = L.nrs * G * (L.rs / es) * 4;              // final reduction
  L.ring = take(off, ring > red ? ring : red);
  L.live = take(off, stages * chunk);
  L.vbuf = take(off, vr * L.rs);
  L.s = take(off, G * L.wrows * 4);
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
  void* out;                 // (B, KV, G, D)
  int n_kv, D, P, kb, nkb, chunk, stages, wp, vr, copy_bytes;
  float sm_scale;
};

// One block per (slot b, KV head h) row.  The row's planned rows (count
// blocks of kb rows, in plan order) stream through the K ring `chunk` rows
// at a time; each chunk is scored into the current window and the rows
// some head selected get their V copies issued at once.  A window closes
// when its scores or its V rows could overflow, and at the end of the row:
// its online-softmax steps run then, all blocks at once, from the prefix
// max over its blocks (m after block j = max(m before the window, the
// window's block maxima up to j)), which gives every block the max the
// sequential step would have used, so p is rounded exactly as there.
template <typename T, int G>
__global__ void __launch_bounds__(threads_for(G))
sata_decode_kernel(const Args a) {
  constexpr int kThreads = threads_for(G), kWarps = kThreads / 32;
  using V = Vec<T>;
  constexpr int E = V::E;                        // elements per 16-byte vector
  constexpr int LPR = kMaxD * (int)sizeof(T) / 16;   // lanes per row: 16 bf16, 32 fp32
  constexpr int RPW = 32 / LPR;                  // rows per warp per pass
  constexpr int U = 1024 / kThreads;             // passes scored together
  constexpr int GP = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  constexpr int es = sizeof(T);
  constexpr bool use_mma = es == 2;              // bf16 scores on the tensor cores
  extern __shared__ __align__(16) unsigned char smem[];

  const int row = blockIdx.x;
  const int b = row / a.n_kv, h = row % a.n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, kb = a.kb, C = a.chunk, S = a.stages, WP = a.wp, VR = a.vr;
  const Layout L = make_layout(G, D, kb, es, C, S, WP, VR);
  const int RS = L.rs, RK = L.rk, nvec = L.nvec, WR = L.wrows;
  const int rb = D * es;                         // bytes of a row in global memory
  const int cb = a.copy_bytes, ppr = rb / cb;    // copies per row
  // a window grows by whole units: one chunk of whole blocks, or the
  // chunks of one block
  const int unit = C >= kb ? C : kb;
  const int cpu = unit / C;                      // chunks per unit

  unsigned char* ring = smem + L.ring;
  unsigned char* live_sh = smem + L.live;                      // [S][C]
  unsigned char* vbuf = smem + L.vbuf;
  float* s_w = reinterpret_cast<float*>(smem + L.s);          // [G][WR]
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

  const T* q = static_cast<const T*>(a.q);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int count = min(a.kv_counts[row], a.P);
  const int pos_b = a.pos[b];
  const size_t tok_bytes = (size_t)a.n_kv * rb;  // bytes between token rows
  const int total_rows = count * kb;
  const int n_chunks = (total_rows + C - 1) / C;
  const unsigned long long kb_m = div_magic(kb), ppr_m = div_magic(ppr);

  // --- prologue: the row's plan, thresholds, running max / sum, q
  const int32_t* idx = a.kv_indices + (size_t)row * a.P;
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

  float acc[GP][E];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  const int cv = tid % nvec, rs_id = tid / nvec;  // PV: column vector, row subset

  // V copies of the packed rows [v0, v0 + n) into the V buffer
  auto issue_v = [&](int j0, int v0, int n) {
    for (int x = tid; x < n * ppr; x += kThreads) {
      const int k = div_by(x, ppr_m), w = x - k * ppr;
      const int fw = vlist[v0 + k];
      const int jw = div_by(fw, kb_m);
      int lblk, phys;
      block_of(j0 + jw, lblk, phys);
      copy_async(vbuf + k * RS + w * cb,
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
    // block maxima, one thread per (block, head)
    for (int x = tid; x < nw * G; x += kThreads) {
      const int jj = x / G, g = x - jj * G;
      const float* sg = s_w + g * WR + jj * kb;
      float mx = kNegInf;
      for (int t = 0; t < kb; ++t) mx = fmaxf(mx, sg[t]);
      pm[x] = mx;
    }
    __syncthreads();
    // prefix max over the blocks, one warp per head; block weights
    // exp(m_j - m_last) and the earlier windows' weight exp(m - m_last)
    if (warp < G) {
      const int g = warp;
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
    // rounded in place, and the unrounded sum per (block, head); a team of
    // ts lanes per (block, head)
    {
      const int pairs = nw * G;
      int ts = 32;
      while (ts > 1 && pairs * ts > kThreads) ts >>= 1;
      const int team = tid / ts, mem = tid % ts, nteams = kThreads / ts;
      for (int base = 0; base < pairs; base += nteams) {
        const int x = base + team;
        float sum = 0.f;
        if (x < pairs) {
          const int jj = x / G, g = x - jj * G;
          const float mj = pm[x];
          float* sg = s_w + g * WR + jj * kb;
          const unsigned char* selg = sel_w + g * WR + jj * kb;
          for (int t = mem; t < kb; t += ts) {
            const float p = selg[t] ? expf(sg[t] - mj) : 0.f;
            sum += p;
            const float pr = to_f32(from_f32<T>(p));     // p.astype(v.dtype)
            sg[t] = pr;
          }
        }
        for (int o = ts / 2; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (x < pairs && mem == 0) psum[x] = sum;
      }
    }
    __syncthreads();
    // l = l * cw + sum_j psum_j * w_j; acc = acc * cw + the V rows' terms
    if (warp < G) {
      const int g = warp;
      float part = 0.f;
      for (int j = lane; j < nw; j += 32) part += psum[j * G + g] * pw[j * G + g];
      part = warp_sum(part);
      if (lane == 0) l_sh[g] = l_sh[g] * cw_sh[g] + part;
    }
    if (rs_id < L.nrs) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = cw_sh[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= c;
      }
    }
    for (int v0 = 0; v0 < nv; v0 += VR) {
      if (v0 > 0) issue_v(j0, v0, min(nv - v0, VR));
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (rs_id < L.nrs) {
        const unsigned char* vb = vbuf + cv * 16;
        for (int i = rs_id; i < min(nv - v0, VR); i += L.nrs) {
          const int fw = vlist[v0 + i];
          const int jw = div_by(fw, kb_m);
          float vf[E];
          V::load(vb + i * RS, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float w = s_w[g * WR + fw] * pw[jw * G + g];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] += w * vf[e];
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
  // bf16 scores on the tensor cores: q as the B operand, head lane/4 of
  // k-step ks in qb[ks], heads past G and d past D zero (fp32 uses qr)
  uint32_t qb[kMaxD / 16][2];
  float thr_mma[2];
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    const int n = lane >> 2, d0 = ks * 16 + (lane & 3) * 2;
    auto qv = [&](int d) {
      return n < G && d < D ? to_f32(q[((size_t)row * G + n) * D + d]) : 0.f;
    };
    qb[ks][0] = pack_bf16(qv(d0), qv(d0 + 1));
    qb[ks][1] = pack_bf16(qv(d0 + 8), qv(d0 + 9));
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = 2 * (lane & 3) + e;
    thr_mma[e] = h < G ? thr_sh[h] : 0.f;
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
      // hold rows lane/4 and lane/4 + 8 for heads 2 (lane % 4) and + 1
      for (int mt = warp; mt * 16 < C; mt += kWarps) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const int lr = min(mt * 16 + (lane & 7) + (lane & 8), C - 1);
        const unsigned char* ap = kt + lr * RK + (lane >> 4) * 16;
#pragma unroll
        for (int ks = 0; ks < kMaxD / 16; ++ks) {
          if (ks * 16 < D) {
            uint32_t af[4];
            ldmatrix_x4(af, ap + ks * 32);
            mma_bf16(c, af, qb[ks][0], qb[ks][1]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + (lane >> 2) + half * 8;
          const int flag = r < C ? lv[r] : 0;
          bool any = false;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int h = 2 * (lane & 3) + e;
            const float s = c[2 * half + e] * a.sm_scale;
            const bool sel = flag == 2 && h < G && admit(s, thr_mma[e]);
            if (h < G && flag != 0) {
              s_w[h * WR + fw0 + r] = sel ? s : kNegInf;
              sel_w[h * WR + fw0 + r] = sel;
            }
            any |= sel;
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
            s_w[hd * WR + fw0 + r] = sel ? s : kNegInf;
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

  // --- the row subsets' partial sums, added in a fixed order
  float* red = reinterpret_cast<float*>(ring);
  const int dpad = RS / es;
  if (rs_id < L.nrs) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) red[(rs_id * G + g) * dpad + cv * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int x = tid; x < G * D; x += kThreads) {
    const int g = x / D, d = x - g * D;
    float o = 0.f;
    for (int s2 = 0; s2 < L.nrs; ++s2) o += red[(s2 * G + g) * dpad + d];
    const float l = l_sh[g];
    out[((size_t)row * G + g) * D + d] = from_f32<T>(l > 0.f ? o / l : 0.f);
  }
}

template <typename T, int G>
int launch(const Args& a, int rows, int smem_bytes, cudaStream_t s) {
  auto* fn = sata_decode_kernel<T, G>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fn<<<rows, threads_for(G), smem_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_g(const Args& a, int G, int rows, int smem_bytes, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, 1>(a, rows, smem_bytes, s);
    case 2: return launch<T, 2>(a, rows, smem_bytes, s);
    case 3: return launch<T, 3>(a, rows, smem_bytes, s);
    case 4: return launch<T, 4>(a, rows, smem_bytes, s);
    case 5: return launch<T, 5>(a, rows, smem_bytes, s);
    case 6: return launch<T, 6>(a, rows, smem_bytes, s);
    case 7: return launch<T, 7>(a, rows, smem_bytes, s);
    case 8: return launch<T, 8>(a, rows, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream`; returns 0 when the launch was accepted, else a
// cudaError_t (cudaErrorInvalidValue for arguments outside the kernel's
// limits or a shared-memory size that does not match the layout).
// dtype: 0 = float32, 1 = bfloat16.  nkb: the page table's row stride
// (max_pages) for the pool, or S / k_block for the contiguous cache.
// chunk, stages, win_blocks, v_rows, smem_bytes:
// kernels/sata_decode.py::launch_config; copy_bytes: 16, 8, 4 or 2,
// dividing D * sizeof(dtype) and the alignment of k and v.
extern "C" int sata_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* kv_indices, const void* kv_counts, const void* thresholds,
    const void* pos, void* out, int batch, int n_kv, int G, int D, int P,
    int k_block, int nkb, int dtype, int chunk, int stages, int win_blocks,
    int v_rows, int smem_bytes, int copy_bytes, void* stream) {
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
  a.n_kv = n_kv; a.D = D; a.P = P; a.kb = k_block; a.nkb = nkb;
  a.chunk = chunk; a.stages = stages; a.wp = win_blocks; a.vr = v_rows;
  a.copy_bytes = copy_bytes;
  // rounded once from double, as the plain version's fp32 scale is
  a.sm_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n_kv;
  return dtype == 1 ? launch_g<__nv_bfloat16>(a, G, rows, smem_bytes, s)
                    : launch_g<float>(a, G, rows, smem_bytes, s);
}
