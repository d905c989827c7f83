// K1 and K2 of the PyTorch port: the Louvain best-move scan over one degree
// bucket's CSR rows, hand-written for Hopper (sm_90a).  Three row layouts
// (a row per thread, a row per warp, a row per CTA), each a __global__
// template whose K1 instantiation adds the move decision to K2's scan.
//
// Replaces
//   K1  src/repro/kernels/louvain_scan/fused.py, louvain_fused_pallas
//       (kernel body _make_fused_kernel = dense_scan_tile +
//       fused_decision_tile): scan + improvement test + singleton-swap
//       guard + Weyl round gate + frontier mask, out (best_c, best_dq,
//       do_move).
//   K2  src/repro/kernels/louvain_scan/louvain_scan.py, louvain_scan_pallas
//       (kernel body _scan_kernel over dense_scan_tile): the scan only, out
//       (best_c with -1 = none, best_dq with -inf = none).
// together with the per-slot gathers that the JAX package leaves to XLA
// (repro/kernels/louvain_scan/ops.py, prepare_ell_inputs /
// prepare_fused_inputs) and the padded matrices of to_ell_blocks.
//
// Design.  The TPU kernel takes pre-gathered dense (R, D) tiles and builds a
// D x D equality tile per row for the matrix unit.  Here the kernel takes
// the bucket's vertex ids, the CSR and the per-vertex state, and reads only
// the live slots [indptr[v], indptr[v+1]) of each row; comm[col] is
// gathered per slot, and sigma (K1: and |c|) once per distinct candidate
// community.  At R-MAT scale 22 the per-vertex arrays (16.8 MB each) stay
// in the 50 MB L2, so the gathers cost L2 sectors, not HBM traffic.  Slots
// are grouped by community label instead of compared pairwise:
//   * widths <= 16 (the bucket that holds most vertices; at R-MAT scale 22
//     3.58M of its 4.08M bucketed rows): one row per thread.  The thread
//     issues its row's loads together, then bitonic-sorts the (community,
//     slot) keys with their weights in registers, so each community's
//     slots are one run in ascending slot order;
//   * wider rows, one per warp, loaded coalesced: rows of at most 32 slots
//     put one slot per lane and __match_any_sync gives every lane the mask
//     of lanes holding its community; longer rows stage their 64-bit
//     (community, slot) keys in the warp's shared memory and bitonic-sort
//     them in registers (kE keys per lane, shuffles across lanes), and the
//     head of each run reads the run back.  Each bucket width launches its
//     own instantiation (kMaxE), so a narrow bucket does not carry the
//     registers of the widest sort;
//   * widths 1025 .. 16384 (hub rows, when ell_widths reach past 1024): one
//     row per CTA of kCtaThreads threads.  The row's 64-bit (community,
//     slot) keys and float weights are staged in dynamic shared memory (12 B
//     per sorted slot: 196,608 B at a capacity of 16,384, above the 48 KB
//     that needs no opt-in, so the launch sets
//     cudaFuncAttributeMaxDynamicSharedMemorySize), bitonic-sorted across
//     the block with __syncthreads between stages, and the head of each run
//     sums it.  Each sort capacity (2048 .. 16384) launches its own
//     instantiation.
// One thread sums each group's weights, then evaluates Eq. 2 once; a warp
// butterfly of (max dQ, min id) gives a warp's row, and a CTA's row folds
// its warps' answers through shared memory.
//
// Bound on the card: bytes.  The function must read the indices and weights
// of the bucketed rows' live slots (8 B each), the row ids and their indptr
// entries, comm of every vertex it touches, sigma of every own and candidate
// community, k (K1: sizes and front) per row, and write 8 B (K2) or 12 B
// (K1) per row; at 3.35 TB/s that is the least time.  Operations (one add
// per live slot, one Eq. 2 per distinct (row, candidate community)) are
// three orders of magnitude below the float32 peak.
//
// Exactness: the plain PyTorch version (louvain_scan.py / fused.py beside
// the wrappers) builds the padded tile and sums over every slot; this kernel
// must agree with it bit for bit on any weights.
//   * Summation order.  A group's K_{i->c} is added one float32 add at a
//     time in ascending slot order by one thread, starting from 0.0f.  The
//     plain loop adds the same values in the same order plus +0.0 for every
//     other slot, and x + 0.0 == x for every x the sum can hold (it never
//     is -0.0), so the sums are identical.  No tree or shuffle reduction of
//     weights and no shared-memory atomics: they change the float32 sum.
//   * No FMA contraction.  The tie test dq == best_dq needs IEEE-identical
//     dq, so dq is evaluated in exactly the reference's order,
//     (k_to - k_own) / m - k_i * ((k_i + sig) - sig_own) / ((2 * m) * m),
//     and the build passes --fmad=false and never --use_fast_math.
//   * Ties go to the smallest community id (keep_better).
//   * K1's |best community| is sizes[best_c] when a best exists; without
//     one the target is not a singleton (the plain version's min over no
//     slots, INT_MAX), and sizes[sentinel] is never read.
//   * The Weyl gate.  GATE_MUL = -1640531535 and GATE_INC = 40503 act on
//     int32 with wraparound in the reference.  Signed overflow is undefined
//     in C++, so the hash is multiplied and added in uint32_t, converted to
//     int32_t (two's complement), shifted arithmetically >> 13, then
//     abs and % gate_fraction.
//   * Dead slots (col == n_cap, padding; col == v, a self loop) and pad rows
//     (v == n_cap, degree 0) are never candidates.  A row whose degree
//     exceeds the bucket's width, or a row id outside [0, n_cap], sets a bit
//     of *err and is scanned as if empty; the wrapper raises on it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned long long kDeadKey = ~0ull;
constexpr uint32_t kGateMul = 2654435761u;  // int32 -1640531535
constexpr uint32_t kGateInc = 40503u;
constexpr int kErrDegree = 1;
constexpr int kErrRow = 2;

struct Args {
  const int* rows;
  const int* indptr;
  const int* indices;
  const float* weights;
  const int* comm;
  const float* sigma;
  const float* k;
  const int* sizes;             // K1 only
  const unsigned char* front;   // K1 only: frontier & move-valid (bool)
  const float* m;
  int n_rows;
  int n_cap;
  int width;
  int sort_cap;                 // keys per warp (per CTA above 1024) in
                                // shared memory
  int round_ix;
  int gate_fraction;
  int sentinel;
  int* out_c;
  float* out_dq;
  int* out_move;
  int* err;
};

// (dq, c) <- the better of (dq, c) and (dq2, c2): larger dQ, then the
// smaller community id.  Commutative and associative, so the warp
// butterfly yields the reference's max-then-min-id answer.
__device__ __forceinline__ void keep_better(float& dq, int& c, float dq2,
                                            int c2) {
  if (dq2 > dq || (dq2 == dq && c2 < c)) {
    dq = dq2;
    c = c2;
  }
}

// Eq. 2 in the reference's operation order (see the header).
__device__ __forceinline__ float delta_q(float k_to, float k_own, float k_i,
                                         float sig, float sig_own, float m,
                                         float two_m_m) {
  const float gain = (k_to - k_own) / m;
  const float cost = k_i * ((k_i + sig) - sig_own) / two_m_m;
  return gain - cost;
}

struct Row {
  int v;          // vertex id (n_cap for a pad row)
  int own;        // comm[v]
  float k_i;
  float sig_own;  // sigma[comm[v]]
  int beg;        // first CSR slot
  int deg;        // live slots to read (0 for a pad or rejected row)
};

__device__ __forceinline__ Row load_row(const Args& a, int r, bool lead) {
  Row row;
  int v = a.rows[r];
  if (v < 0 || v > a.n_cap) {
    if (lead) atomicOr(a.err, kErrRow);
    v = a.n_cap;
  }
  row.v = v;
  row.own = a.comm[v];
  row.k_i = a.k[v];
  row.sig_own = a.sigma[row.own];
  row.beg = 0;
  row.deg = 0;
  if (v < a.n_cap) {
    row.beg = a.indptr[v];
    const int deg = a.indptr[v + 1] - row.beg;
    if (deg > a.width) {
      if (lead) atomicOr(a.err, kErrDegree);
    } else {
      row.deg = deg;
    }
  }
  return row;
}

// Community of CSR slot `slot` of row `row`, -1 when the slot is dead.
__device__ __forceinline__ int slot_comm(const Args& a, const Row& row,
                                         int slot, float& w) {
  const int col = a.indices[row.beg + slot];
  w = a.weights[row.beg + slot];
  return (col == a.n_cap || col == row.v) ? -1 : a.comm[col];
}

// Rows of at most 32 slots, one per warp: lane j holds slot j.  Returns
// this lane's best (dQ, id) over the groups it leads; `wbuf` is the warp's
// 32 floats of shared memory.
__device__ __forceinline__ void scan_match(const Args& a, const Row& row,
                                           int lane, float* wbuf, float m,
                                           float two_m_m, float& bdq,
                                           int& bc) {
  float w = 0.0f;
  const int c = lane < row.deg ? slot_comm(a, row, lane, w) : -1;
  const unsigned grp = __match_any_sync(kFull, c);
  wbuf[lane] = w;
  __syncwarp();
  const bool lead = c >= 0 && __ffs(grp) - 1 == lane;
  float sum = 0.0f;
  if (lead)
    for (unsigned g = grp; g; g &= g - 1) sum += wbuf[__ffs(g) - 1];
  const unsigned own_lead = __ballot_sync(kFull, lead && c == row.own);
  const float own_sum =
      __shfl_sync(kFull, sum, own_lead ? __ffs(own_lead) - 1 : lane);
  const float k_own = own_lead ? own_sum : 0.0f;
  bdq = -INFINITY;
  bc = kIntMax;
  if (lead && c != row.own)
    keep_better(bdq, bc,
                delta_q(sum, k_own, row.k_i, a.sigma[c], row.sig_own, m,
                        two_m_m),
                c);
  __syncwarp();  // wbuf is rewritten by the next row
}

// The community of a sorted key; -1 for a dead slot's kDeadKey.
__device__ __forceinline__ int key_comm(unsigned long long key) {
  return (int)(key >> 32);
}

// K_{i->c} of the run of community c that starts at sorted position p: its
// weights added one at a time in ascending slot order (the run's order).
__device__ __forceinline__ float run_sum(const unsigned long long* keys,
                                         const float* wbuf, int p, int n) {
  const int c = key_comm(keys[p]);
  float sum = 0.0f;
  for (; p < n && key_comm(keys[p]) == c; ++p)
    sum += wbuf[(unsigned)keys[p]];
  return sum;
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// Sorts the warp's 32 * kE keys in shared memory, ascending, by a bitonic
// network in registers: lane l holds keys l * kE .. l * kE + kE - 1, pairs
// closer than kE are compared within the lane, the others with lane
// l ^ (stride / kE) by shuffles.
template <int kE>
__device__ __forceinline__ void warp_sort(unsigned long long* keys,
                                          int lane) {
  constexpr int kLog = log2i(kE * kWarp);
  unsigned long long x[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) x[e] = keys[lane * kE + e];
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int stride = 1 << lj;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const bool up = (((lane * kE + e) >> ls) & 1) == 0;
        if (stride < kE) {
          const int f = e ^ stride;
          if (f > e) {
            const unsigned long long lo = x[e], hi = x[f];
            const bool swap = (lo > hi) == up;
            x[e] = swap ? hi : lo;
            x[f] = swap ? lo : hi;
          }
        } else {
          const int lstride = stride / kE;
          const unsigned long long y = __shfl_xor_sync(kFull, x[e], lstride);
          const bool keep_min = ((lane & lstride) == 0) == up;
          x[e] = (x[e] < y) == keep_min ? x[e] : y;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) keys[lane * kE + e] = x[e];
  __syncwarp();
}

// warp_sort of the smallest kE >= p2 / 32; kMaxE bounds the instantiations
// (and so the registers) a kernel carries.
template <int kE, int kMaxE>
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int lane,
                                          int p2) {
  if constexpr (kE < kMaxE) {
    if (p2 > kE * kWarp) {
      sort_keys<kE * 2, kMaxE>(keys, lane, p2);
      return;
    }
  }
  warp_sort<kE>(keys, lane);
}

// Rows of 33 .. 32 * kMaxE slots, one per warp: sort the (community, slot)
// keys (warp_sort), then the head of each community's run sums it in
// ascending slot order out of shared memory.
template <int kMaxE>
__device__ __forceinline__ void scan_sorted(const Args& a, const Row& row,
                                            int lane,
                                            unsigned long long* keys,
                                            float* wbuf, float m,
                                            float two_m_m, float& bdq,
                                            int& bc) {
  int p2 = kWarp;
  while (p2 < row.deg) p2 <<= 1;
  for (int j = lane; j < p2; j += kWarp) {
    unsigned long long key = kDeadKey;
    float w = 0.0f;
    if (j < row.deg) {
      const int c = slot_comm(a, row, j, w);
      if (c >= 0)
        key = ((unsigned long long)(unsigned)c << 32) | (unsigned)j;
    }
    keys[j] = key;
    wbuf[j] = w;
  }
  __syncwarp();
  sort_keys<2, kMaxE>(keys, lane, p2);
  // K_{i->own}: the head of own's run sums it; one lane holds it.
  float own_sum = 0.0f;
  bool has_own = false;
  for (int p = lane; p < p2; p += kWarp) {
    if (key_comm(keys[p]) == row.own &&
        (p == 0 || key_comm(keys[p - 1]) != row.own)) {
      own_sum = run_sum(keys, wbuf, p, p2);
      has_own = true;
    }
  }
  const unsigned own_lane = __ballot_sync(kFull, has_own);
  const float got = __shfl_sync(kFull, own_sum,
                                own_lane ? __ffs(own_lane) - 1 : lane);
  const float k_own = own_lane ? got : 0.0f;
  bdq = -INFINITY;
  bc = kIntMax;
  for (int p = lane; p < p2; p += kWarp) {
    const int c = key_comm(keys[p]);
    if (c < 0 || c == row.own || (p > 0 && key_comm(keys[p - 1]) == c))
      continue;
    keep_better(bdq, bc,
                delta_q(run_sum(keys, wbuf, p, p2), k_own, row.k_i,
                        a.sigma[c], row.sig_own, m, two_m_m),
                c);
  }
  __syncwarp();  // keys and wbuf are rewritten by the next row
}

// The widest row one lane scans alone.
constexpr int kLaneSlots = 16;

// Rows of at most kLaneSlots slots, one per lane.  The lane loads its
// row's slots and their communities into registers (all loads independent,
// so they are in flight together), sorts the (community, slot) keys with
// their weights by a bitonic network over kLaneSlots registers (dead slots
// sort last), then walks the runs in order.
__device__ __forceinline__ void scan_lane(const Args& a, const Row& row,
                                          float m, float two_m_m, float& bdq,
                                          int& bc) {
  unsigned long long key[kLaneSlots];
  float w[kLaneSlots];
  int col[kLaneSlots];
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    col[j] = a.n_cap;
    w[j] = 0.0f;
    if (j < row.deg) {
      col[j] = a.indices[row.beg + j];
      w[j] = a.weights[row.beg + j];
    }
  }
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    key[j] = kDeadKey;
    if (col[j] != a.n_cap && col[j] != row.v)
      key[j] = ((unsigned long long)(unsigned)a.comm[col[j]] << 32) |
               (unsigned)j;
  }
#pragma unroll
  for (int ls = 1; ls <= log2i(kLaneSlots); ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) {
        const int l = i ^ (1 << lj);
        if (l > i) {
          const unsigned long long x = key[i], y = key[l];
          const float wx = w[i], wy = w[l];
          const bool swap = (x > y) == ((i & (1 << ls)) == 0);
          key[i] = swap ? y : x;
          key[l] = swap ? x : y;
          w[i] = swap ? wy : wx;
          w[l] = swap ? wx : wy;
        }
      }
    }
  }
  // K_{i->own}: own's run, in ascending slot order.
  float k_own = 0.0f;
#pragma unroll
  for (int p = 0; p < kLaneSlots; ++p)
    if (key_comm(key[p]) == row.own) k_own += w[p];
  bdq = -INFINITY;
  bc = kIntMax;
  float run = 0.0f;
#pragma unroll
  for (int p = 0; p < kLaneSlots; ++p) {
    const int c = key_comm(key[p]);  // -1 for a dead slot
    run = ((p > 0 && key_comm(key[p - 1]) == c) ? run : 0.0f) + w[p];
    const bool last = p == kLaneSlots - 1 || key_comm(key[p + 1]) != c;
    if (c >= 0 && last && c != row.own)
      keep_better(bdq, bc,
                  delta_q(run, k_own, row.k_i, a.sigma[c], row.sig_own, m,
                          two_m_m),
                  c);
  }
}

// One row's best (dQ, id) in every lane of the warp; (-inf, INT_MAX) when
// the row has no candidate.  Rows of up to 32 * kMaxE slots.
template <int kMaxE>
__device__ __forceinline__ void scan_row(const Args& a, const Row& row,
                                         int lane, unsigned long long* keys,
                                         float* wbuf, float m, float two_m_m,
                                         float& bdq, int& bc) {
  if constexpr (kMaxE > 1) {
    if (row.deg > kWarp)  // warp-uniform: one row per warp
      scan_sorted<kMaxE>(a, row, lane, keys, wbuf, m, two_m_m, bdq, bc);
    else
      scan_match(a, row, lane, wbuf, m, two_m_m, bdq, bc);
  } else {
    scan_match(a, row, lane, wbuf, m, two_m_m, bdq, bc);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float odq = __shfl_xor_sync(kFull, bdq, off);
    const int oc = __shfl_xor_sync(kFull, bc, off);
    keep_better(bdq, bc, odq, oc);
  }
}

// Threads of a one-row CTA (widths above 1024).
constexpr int kCtaThreads = 512;

// Rows of up to kCap slots, one per CTA: the keys and weights of the row
// are staged in dynamic shared memory (kCap keys, then kCap weights) and
// sorted by a bitonic network over the block, the next power of two >= the
// row's degree wide (dead keys sort last).  The head of each community's
// run sums it (run_sum: one thread, ascending slot order, from 0.0f); the
// block's (max dQ, min id) is folded warp by warp.  Returns the row's best
// in thread 0.
template <int kCap>
__device__ __forceinline__ void scan_cta(const Args& a, const Row& row,
                                         unsigned long long* keys,
                                         float* wbuf, float m, float two_m_m,
                                         float& bdq, int& bc) {
  __shared__ float s_dq[kCtaThreads / kWarp];
  __shared__ int s_c[kCtaThreads / kWarp];
  __shared__ float s_own;
  __shared__ int s_has_own;
  const int tid = threadIdx.x;
  int p2 = 1;
  while (p2 < row.deg) p2 <<= 1;
  for (int j = tid; j < p2; j += kCtaThreads) {
    unsigned long long key = kDeadKey;
    float w = 0.0f;
    if (j < row.deg) {
      const int c = slot_comm(a, row, j, w);
      if (c >= 0)
        key = ((unsigned long long)(unsigned)c << 32) | (unsigned)j;
    }
    keys[j] = key;
    wbuf[j] = w;
  }
  if (tid == 0) s_has_own = 0;
  __syncthreads();
  // Pair t of a stage compares keys i and i + j, where i has bit j clear;
  // the run of 2k keys holding i ascends when bit k of i is clear.
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < p2 / 2; t += kCtaThreads) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
  // K_{i->own}: the head of own's run sums it.
  for (int p = tid; p < p2; p += kCtaThreads) {
    if (key_comm(keys[p]) == row.own &&
        (p == 0 || key_comm(keys[p - 1]) != row.own)) {
      s_own = run_sum(keys, wbuf, p, p2);
      s_has_own = 1;
    }
  }
  __syncthreads();
  const float k_own = s_has_own ? s_own : 0.0f;
  bdq = -INFINITY;
  bc = kIntMax;
  for (int p = tid; p < p2; p += kCtaThreads) {
    const int c = key_comm(keys[p]);
    if (c < 0 || c == row.own || (p > 0 && key_comm(keys[p - 1]) == c))
      continue;
    keep_better(bdq, bc,
                delta_q(run_sum(keys, wbuf, p, p2), k_own, row.k_i,
                        a.sigma[c], row.sig_own, m, two_m_m),
                c);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float odq = __shfl_xor_sync(kFull, bdq, off);
    const int oc = __shfl_xor_sync(kFull, bc, off);
    keep_better(bdq, bc, odq, oc);
  }
  if (tid % kWarp == 0) {
    s_dq[tid / kWarp] = bdq;
    s_c[tid / kWarp] = bc;
  }
  __syncthreads();
  if (tid == 0)
    for (int w = 1; w < kCtaThreads / kWarp; ++w)
      keep_better(bdq, bc, s_dq[w], s_c[w]);
  __syncthreads();  // keys, wbuf, s_dq and s_c are rewritten by the next row
}

// Row r's outputs from its best (dQ, id): K2's pair, or K1's gated decision.
template <bool kFused>
__device__ __forceinline__ void finish_row(const Args& a, long long r,
                                           const Row& row, float bdq,
                                           int bc) {
  const bool found = isfinite(bdq);
  if (!kFused) {
    a.out_c[r] = found ? bc : -1;
    a.out_dq[r] = found ? bdq : -INFINITY;
    return;
  }
  const int bcs = found ? bc : a.sentinel;
  const int size_best = found ? a.sizes[bcs] : kIntMax;
  const float best = found ? bdq : -INFINITY;
  const bool in_front = a.front[row.v] != 0;
  const bool swap_blocked =
      a.sizes[row.own] == 1 && size_best == 1 && bcs > row.own;
  bool do_move = best > 0.0f && bcs != row.own && bcs < a.sentinel &&
                 in_front && !swap_blocked;
  if (a.gate_fraction > 1) {
    const uint32_t h =
        (uint32_t)row.v * kGateMul + (uint32_t)a.round_ix * kGateInc;
    const int32_t hs = (int32_t)h;          // two's complement
    const int32_t sh = hs >> 13;            // arithmetic shift
    const int32_t mag = sh < 0 ? -sh : sh;  // |sh| <= 2^18
    do_move = do_move && (mag % a.gate_fraction == 0);
  }
  a.out_c[r] = bcs;
  a.out_dq[r] = in_front ? best : -INFINITY;
  a.out_move[r] = do_move ? 1 : 0;
}

// Widths <= kLaneSlots: one row per thread.
template <bool kFused>
__global__ void lane_rows_kernel(Args a) {
  const float m = *a.m;
  const float two_m_m = (2.0f * m) * m;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < a.n_rows; r += (long long)gridDim.x * blockDim.x) {
    const Row row = load_row(a, (int)r, true);
    float bdq;
    int bc;
    scan_lane(a, row, m, two_m_m, bdq, bc);
    finish_row<kFused>(a, r, row, bdq, bc);
  }
}

// Wider rows: one row per warp, in the warp's slice of shared memory; rows
// of up to 32 * kMaxE slots.
template <bool kFused, int kMaxE>
__global__ void warp_rows_kernel(Args a) {
  extern __shared__ unsigned long long smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  unsigned long long* keys = smem + (size_t)warp * a.sort_cap;
  float* wbuf = reinterpret_cast<float*>(smem + (size_t)warps * a.sort_cap) +
                (size_t)warp * a.sort_cap;
  const float m = *a.m;
  const float two_m_m = (2.0f * m) * m;
  for (long long r = (long long)blockIdx.x * warps + warp; r < a.n_rows;
       r += (long long)gridDim.x * warps) {
    const Row row = load_row(a, (int)r, lane == 0);
    float bdq;
    int bc;
    scan_row<kMaxE>(a, row, lane, keys, wbuf, m, two_m_m, bdq, bc);
    if (lane == 0) finish_row<kFused>(a, r, row, bdq, bc);
  }
}

// Widths above 1024: one row per CTA, its kCap keys and weights in dynamic
// shared memory.
template <bool kFused, int kCap>
__global__ void __launch_bounds__(kCtaThreads) cta_rows_kernel(Args a) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;
  float* wbuf = reinterpret_cast<float*>(smem + kCap);
  const float m = *a.m;
  const float two_m_m = (2.0f * m) * m;
  for (long long r = blockIdx.x; r < a.n_rows; r += gridDim.x) {
    const Row row = load_row(a, (int)r, threadIdx.x == 0);
    float bdq;
    int bc;
    scan_cta<kCap>(a, row, keys, wbuf, m, two_m_m, bdq, bc);
    if (threadIdx.x == 0) finish_row<kFused>(a, r, row, bdq, bc);
  }
}

// rows_per_block: one row per thread at widths <= kLaneSlots, one per warp
// up to 1024, one per CTA above (the wrapper's block_rows_for_width).
template <bool kFused>
int launch(Args a, int rows_per_block, void* stream) {
  if (a.n_rows <= 0) return (int)cudaSuccess;
  const bool lane_rows = a.width <= kLaneSlots;
  const int threads = lane_rows ? rows_per_block : rows_per_block * kWarp;
  const long long want = (a.n_rows + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(want < 1048576 ? want : 1048576);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_rows) {
    lane_rows_kernel<kFused><<<blocks, threads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.sort_cap > 1024) {
    if (rows_per_block != 1) return (int)cudaErrorInvalidValue;
    void (*cta)(Args);
    switch (a.sort_cap) {
      case 2048: cta = cta_rows_kernel<kFused, 2048>; break;
      case 4096: cta = cta_rows_kernel<kFused, 4096>; break;
      case 8192: cta = cta_rows_kernel<kFused, 8192>; break;
      case 16384: cta = cta_rows_kernel<kFused, 16384>; break;
      default: return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)a.sort_cap *
                        (sizeof(unsigned long long) + sizeof(float));
    const cudaError_t set = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(cta),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (set != cudaSuccess) return (int)set;
    cta<<<blocks, kCtaThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  void (*kernel)(Args);
  switch (a.sort_cap) {
    case 32: kernel = warp_rows_kernel<kFused, 1>; break;
    case 64: kernel = warp_rows_kernel<kFused, 2>; break;
    case 128: kernel = warp_rows_kernel<kFused, 4>; break;
    case 256: kernel = warp_rows_kernel<kFused, 8>; break;
    case 512: kernel = warp_rows_kernel<kFused, 16>; break;
    case 1024: kernel = warp_rows_kernel<kFused, 32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)rows_per_block * a.sort_cap *
                      (sizeof(unsigned long long) + sizeof(float));
  kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* rows, const void* indptr, const void* indices,
               const void* weights, const void* comm, const void* sigma,
               const void* k, const void* m, int n_rows, int n_cap,
               int width, int sort_cap, void* out_c, void* out_dq,
               void* err) {
  Args a{};
  a.rows = (const int*)rows;
  a.indptr = (const int*)indptr;
  a.indices = (const int*)indices;
  a.weights = (const float*)weights;
  a.comm = (const int*)comm;
  a.sigma = (const float*)sigma;
  a.k = (const float*)k;
  a.m = (const float*)m;
  a.n_rows = n_rows;
  a.n_cap = n_cap;
  a.width = width;
  a.sort_cap = sort_cap;
  a.gate_fraction = 1;
  a.out_c = (int*)out_c;
  a.out_dq = (float*)out_dq;
  a.err = (int*)err;
  return a;
}

}  // namespace

extern "C" int louvain_fused_launch(
    const void* rows, const void* indptr, const void* indices,
    const void* weights, const void* comm, const void* sigma, const void* k,
    const void* sizes, const void* front, const void* m, int n_rows,
    int n_cap, int width, int round_ix, int gate_fraction, int sentinel,
    void* out_c, void* out_dq, void* out_move, void* err,
    int rows_per_block, int sort_cap, void* stream) {
  Args a = make_args(rows, indptr, indices, weights, comm, sigma, k, m,
                     n_rows, n_cap, width, sort_cap, out_c, out_dq, err);
  a.sizes = (const int*)sizes;
  a.front = (const unsigned char*)front;
  a.round_ix = round_ix;
  a.gate_fraction = gate_fraction;
  a.sentinel = sentinel;
  a.out_move = (int*)out_move;
  return launch<true>(a, rows_per_block, stream);
}

extern "C" int louvain_scan_launch(
    const void* rows, const void* indptr, const void* indices,
    const void* weights, const void* comm, const void* sigma, const void* k,
    const void* m, int n_rows, int n_cap, int width, void* out_c,
    void* out_dq, void* err, int rows_per_block, int sort_cap,
    void* stream) {
  return launch<false>(make_args(rows, indptr, indices, weights, comm, sigma,
                                 k, m, n_rows, n_cap, width, sort_cap, out_c,
                                 out_dq, err),
                       rows_per_block, stream);
}
