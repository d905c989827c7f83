// K3 of the PyTorch port: the aggregation group-resolve sweep, hand-written
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/aggregate/coarsen.py, coarsen_groups_pallas
// (kernel body _coarsen_kernel).  Over the (ci, cj)-sorted relabelled edge
// slots it detects group boundaries, takes a segmented inclusive weight sum,
// and at each boundary emits the group that just ended: per slot i of the
// list padded by one trailing sentinel slot (length total + 1),
//   g_src[i], g_dst[i] = key of slot i - 1 ((-2, -2) for i = 0)
//   g_w[i]             = open-group weight sum through slot i - 1 (0 for i = 0)
//   emit[i]            = is_first[i] & g_src[i] != sent & g_src[i] >= 0
//   pos[i]             = number of emits before slot i
//
// Design.  The TPU grid runs in order and carries (previous key, open-group
// sum, emitted count) from tile to tile in SMEM.  Here one launch does a
// single-pass segmented scan with decoupled look-back over tiles of 4096
// slots (segscan.cuh): a block loads its tile's ci/cj/w and the one
// predecessor key, scans (boundary flag, trailing open-group sum, emit
// count) under
//   (f1, s1, n1) . (f2, s2, n2) = (f1 | f2, f2 ? s2 : s1 + s2, n1 + n2),
// sequentially over each thread's 16 slots and with shuffles across
// threads, publishes the tile's aggregate, looks back for its carry,
// publishes its inclusive prefix and writes the five records.
//
// The float carry is deterministic.  A look-back that added whatever it
// found first would associate the open-group sum in an order set by
// timing.  Instead the carry into tile j is defined as the sequential fold
// P_j = A_j.f ? A_j.s : P_{j-1} + A_j.s over the tiles' aggregates A, and
// every published prefix holds exactly that value: warp 0 takes the
// nearest tile before j that holds a boundary (its P is its A.s) or a
// published prefix, and adds the aggregates after it one at a time, oldest
// first.  If none of the 32 tiles before j holds either yet, it reads the
// window again until one does (only inside a group longer than 32 tiles).
// The emit count is exact, so it takes the usual look-back back to the
// nearest prefix in any order.  So the output is bit-identical from call to
// call.  Float sums still associate differently from the TPU kernel's and
// from the plain version's: they agree bit for bit whenever the sums are
// exact (integer-valued weights below 2^24, every golden corpus) and to
// float32 rounding otherwise (|g_w - plain| <= m * 2^-23 * sum |w| over the
// m slots summed).
//
// Bound on the card: bytes.  The function reads 12 B per slot (ci, cj, w)
// and writes 17 B per slot (emit, pos, g_src, g_dst, g_w): 29 B/slot at
// 3.35 TB/s.  This design moves each byte once, plus 16 B of status words
// per 4096-slot tile and the look-back's reads of them.

#include "segscan.cuh"

namespace {

using namespace segscan;

struct Seg {
  int f;    // a group boundary lies inside the span
  float s;  // weight sum since the span's last boundary
  int n;    // emits in the span
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.s : a.s + b.s, a.n + b.n};
}

struct ShflSeg {
  __device__ Seg operator()(Seg v, int d) const {
    return Seg{__shfl_up_sync(kFull, v.f, d), __shfl_up_sync(kFull, v.s, d),
               __shfl_up_sync(kFull, v.n, d)};
  }
};

struct Combine {
  __device__ Seg operator()(Seg a, Seg b) const { return combine(a, b); }
};

// Status words: aggregate lo = bits of s, hi = n << 2 | f << 1 | 1 (n <=
// kTile); inclusive prefix lo = bits of s, hi = n << 1 | 1 (n < 2^31).
__device__ __forceinline__ unsigned long long agg_word(Seg a) {
  return pack(__float_as_uint(a.s), ((uint32_t)a.n << 2) | (a.f << 1) | 1u);
}

__device__ __forceinline__ unsigned long long inc_word(float s, int n) {
  return pack(__float_as_uint(s), ((uint32_t)n << 1) | 1u);
}

struct Smem {
  int ci[kTile];
  int cj[kTile];
  float w[kTile];  // the weights, then the g_w records
  int pos[kTile];
  Seg warp_tot[kWarps];
  int pred_ci, pred_cj;
  int tile;
  float carry_s;
  int carry_n;
};

// Warp 0: the carry (open-group sum, emit count) into tile j > 0.
__device__ __forceinline__ void look_back(const unsigned long long* agg,
                                          const unsigned long long* inc,
                                          long long j, float& carry_s,
                                          int& carry_n) {
  const int lane = threadIdx.x & 31;
  long long top = j - 1;
  bool have_s = false;
  float s = 0.0f;
  int n = 0;
  for (;;) {
    const Status st = read_window(agg, inc, top - lane);
    const bool pre = st.kind == kPrefix;
    const uint32_t hi = hi_of(st.word);
    const float v = __uint_as_float(lo_of(st.word));
    if (!have_s) {
      const unsigned stop = __ballot_sync(kFull, pre || ((hi >> 1) & 1u));
      if (!stop) {
        __nanosleep(64);
        continue;  // no boundary and no prefix in the window yet
      }
      // Fold from the nearest stop towards tile j - 1 (lane 0), in order.
      const int first = __ffs(stop) - 1;
      s = __shfl_sync(kFull, v, first);
      for (int l = first - 1; l >= 0; --l) s = s + __shfl_sync(kFull, v, l);
      have_s = true;
    }
    const unsigned pmask = __ballot_sync(kFull, pre);
    const int p = pmask ? __ffs(pmask) - 1 : 32;
    if (lane <= p) n += pre ? (int)(hi >> 1) : (int)(hi >> 2);
    if (pmask) break;
    top -= 32;
  }
  carry_s = s;
  carry_n = __reduce_add_sync(kFull, n);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    coarsen_onepass(const int* __restrict__ ci, const int* __restrict__ cj,
                    const float* __restrict__ w, long long total, int sent,
                    unsigned long long* __restrict__ agg,
                    unsigned long long* __restrict__ inc,
                    int* __restrict__ counter, int vec_in, int vec_out,
                    uint8_t* __restrict__ emit, int* __restrict__ pos,
                    int* __restrict__ g_src, int* __restrict__ g_dst,
                    float* __restrict__ g_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const long long j = next_tile(counter, &sm.tile);
  const long long base = j * kTile;
  const int limit = (int)min((long long)kTile, total + 1 - base);

  load_tile4(sm.ci, ci, base, total, sent, vec_in);
  load_tile4(sm.cj, cj, base, total, sent, vec_in);
  load_tile4(reinterpret_cast<int*>(sm.w), reinterpret_cast<const int*>(w),
             base, total, 0, vec_in);
  if (t == 0) {  // slot base - 1 is a real slot whenever base > 0
    sm.pred_ci = base ? ci[base - 1] : -2;
    sm.pred_cj = base ? cj[base - 1] : -2;
  }
  cp_async_wait_all();
  __syncthreads();

  write_shifted(g_src, sm.ci, sm.pred_ci, base, limit, vec_out);
  write_shifted(g_dst, sm.cj, sm.pred_cj, base, limit, vec_out);

  // Pass 1: this thread's aggregate over its kItems slots.
  const int k0 = t * kItems;
  const int4* ci4 = reinterpret_cast<const int4*>(sm.ci) + t * (kItems / 4);
  const int4* cj4 = reinterpret_cast<const int4*>(sm.cj) + t * (kItems / 4);
  float4* w4 = reinterpret_cast<float4*>(sm.w) + t * (kItems / 4);
  const int start_ci = t ? sm.ci[k0 - 1] : sm.pred_ci;
  const int start_cj = t ? sm.cj[k0 - 1] : sm.pred_cj;
  Seg acc{0, 0.0f, 0};
  {
    int pa = start_ci, pb = start_cj;
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = ci4[q], b = cj4[q];
      const float4 x = w4[q];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ae = comp(a, e), be = comp(b, e);
        if (k0 + 4 * q + e < limit) {
          const int first = (ae != pa) | (be != pb);
          const int em = first & (pa != sent) & (pa >= 0);
          acc = combine(acc, Seg{first, comp(x, e), em});
        }
        pa = ae;
        pb = be;
      }
    }
  }
  Seg tile_tot;
  const Seg ex = block_exclusive_scan(acc, Seg{0, 0.0f, 0}, Combine(),
                                      ShflSeg(), sm.warp_tot, tile_tot);

  // Publish, look back, publish.
  if (j == 0) {
    if (t == 0) {
      const Seg p = combine(Seg{0, 0.0f, 0}, tile_tot);
      publish(inc, inc_word(p.s, p.n));
      sm.carry_s = 0.0f;
      sm.carry_n = 0;
    }
  } else {
    if (t == 0) publish(agg + j, agg_word(tile_tot));
    if (t < 32) {
      float cs;
      int cn;
      look_back(agg, inc, j, cs, cn);
      if (t == 0) {
        const Seg p = combine(Seg{0, cs, cn}, tile_tot);
        publish(inc + j, inc_word(p.s, p.n));
        sm.carry_s = cs;
        sm.carry_n = cn;
      }
    }
  }
  __syncthreads();

  // Pass 2: the records of this thread's slots; g_w replaces w in place
  // (each thread reads and writes only its own slots of sm.w).
  const Seg carry{0, sm.carry_s, sm.carry_n};
  Seg run = t ? combine(carry, ex) : carry;
  uint32_t flags[kItems / 4];
  {
    int pa = start_ci, pb = start_cj;
    int4* pos4 = reinterpret_cast<int4*>(sm.pos) + t * (kItems / 4);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = ci4[q], b = cj4[q];
      const float4 x = w4[q];
      uint32_t f = 0;
      int p[4];
      float gw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ae = comp(a, e), be = comp(b, e);
        const int first = (ae != pa) | (be != pb);
        const int em = first & (pa != sent) & (pa >= 0);
        p[e] = run.n;
        gw[e] = run.s;
        f |= (uint32_t)em << (8 * e);
        run = combine(run, Seg{first, comp(x, e), em});
        pa = ae;
        pb = be;
      }
      flags[q] = f;
      pos4[q] = make_int4(p[0], p[1], p[2], p[3]);
      w4[q] = make_float4(gw[0], gw[1], gw[2], gw[3]);
    }
  }
  write_flags(emit, flags, base, limit, vec_out);
  __syncthreads();
  write_tile4(pos, sm.pos, base, limit, vec_out);
  write_tile4(reinterpret_cast<int*>(g_w), reinterpret_cast<const int*>(sm.w),
              base, limit, vec_out);
}

}  // namespace

// Scratch: 2 * n_tiles + 1 zeroed 64-bit words (the tiles' aggregate words,
// their prefix words, then the tile counter), n_tiles = ceil((total + 1) /
// chunk_slots).  Outputs hold total + 1 entries.  The caller sizes the
// scratch with its own tile size, which must be kTile.
extern "C" int coarsen_groups_launch(const void* ci, const void* cj,
                                     const void* w, int total, int sent,
                                     int chunk_slots, void* scratch,
                                     void* emit, void* pos, void* g_src,
                                     void* g_dst, void* g_w, void* stream) {
  if (chunk_slots != kTile || total < 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)total + kTile) / kTile);
  unsigned long long* agg = static_cast<unsigned long long*>(scratch);
  unsigned long long* inc = agg + n_tiles;
  int* counter = reinterpret_cast<int*>(inc + n_tiles);
  const int vec_in = aligned16(ci) && aligned16(cj) && aligned16(w);
  const int vec_out = aligned16(emit) && aligned16(pos) && aligned16(g_src) &&
                      aligned16(g_dst) && aligned16(g_w);
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      coarsen_onepass, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  coarsen_onepass<<<n_tiles, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      (const int*)ci, (const int*)cj, (const float*)w, total, sent, agg, inc,
      counter, vec_in, vec_out, (uint8_t*)emit, (int*)pos, (int*)g_src,
      (int*)g_dst, (float*)g_w);
  return (int)cudaGetLastError();
}
