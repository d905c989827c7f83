// K4 of the PyTorch port: the batch-apply group-resolve sweep, hand-written
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/batch_apply/resolve.py, resolve_groups_pallas
// (kernel body _resolve_kernel).  Over the (src, dst)-sorted unified slot
// list of one edge batch (existing slots, then batch slots; dead slots keyed
// (sent, sent)), padded by one trailing sentinel slot (length total + 1), it
// resolves each group of equal keys to its last slot's weight and, at each
// group boundary, emits the group that just ended: per slot i,
//   f_src[i], f_dst[i] = key of slot i - 1 ((-2, -2) for i = 0)
//   f_w[i]             = w[i - 1] (0 for i = 0): the last write wins
//   old_w              = w[g] unless batch[g], else 0, where g is the first
//                        slot of slot i - 1's group (0 for i = 0)
//   keep[i]            = first[i] & f_src[i] != sent & f_w[i] > 0
//   changed[i]         = first[i] & f_src[i] != sent & batch[i - 1]
//                        & old_w != f_w[i]
//   pos[i]             = number of keeps before slot i
// with first[i] = key(i) != key(i - 1).  Weights are selected, never summed,
// so the output equals the plain version bit for bit.
//
// Design.  The TPU grid runs in order and carries (previous slot, the open
// group's first (w, batch), kept count) from tile to tile in SMEM.  Here
// the carry is two exact associative scans, an exclusive SUM of keep (for
// pos) and a MAX of (first[i] ? i : -1) (each slot's group start), in one
// launch: a single-pass scan with decoupled look-back over tiles of 4096
// slots (segscan.cuh).  A block loads its tile's src/dst/w/batch and the
// predecessor slot, scans (keep count, last group start) with shuffles,
// publishes the tile's aggregate, looks back for its carry (both parts are
// exact, so the order in which aggregates combine does not matter),
// publishes its inclusive prefix and writes the six records.  The open
// group's first (w, batch) comes from shared memory when the group starts
// inside the tile, and from one global read per tile when it started in an
// earlier one.
//
// Bound on the card: bytes.  The function reads 13 B per slot (src, dst,
// w, batch) and writes 18 B per slot (keep 1, pos 4, src 4, dst 4, w 4,
// changed 1): 31 B/slot at 3.35 TB/s.  This design moves each byte once,
// plus 16 B of status words per tile, the look-back's reads of them and
// one 5-byte read per tile.

#include "segscan.cuh"

namespace {

using namespace segscan;

struct Agg {
  int n;  // keeps in the span
  int g;  // index of the last group start in the span, -1 if none
};

__device__ __forceinline__ Agg combine(Agg a, Agg b) {
  return Agg{a.n + b.n, b.g > a.g ? b.g : a.g};
}

struct ShflAgg {
  __device__ Agg operator()(Agg v, int d) const {
    return Agg{__shfl_up_sync(kFull, v.n, d), __shfl_up_sync(kFull, v.g, d)};
  }
};

struct Combine {
  __device__ Agg operator()(Agg a, Agg b) const { return combine(a, b); }
};

// Status words (aggregate and prefix alike): lo = g + 1, hi = n << 1 | 1
// (n < 2^31).
__device__ __forceinline__ unsigned long long word(Agg a) {
  return pack((uint32_t)(a.g + 1), ((uint32_t)a.n << 1) | 1u);
}

struct Smem {
  int src[kTile];
  int dst[kTile];
  float w[kTile];
  int pos[kTile];
  uint8_t batch[kTile];
  Agg warp_tot[kWarps];
  int pred_src, pred_dst, pred_b;
  float pred_w;
  int tile;
  Agg carry;
  float carry_old;  // old_w of the group open at the tile's start
};

// Warp 0: the carry (keeps, last group start) into tile j > 0.
__device__ __forceinline__ Agg look_back(const unsigned long long* agg,
                                         const unsigned long long* inc,
                                         long long j) {
  const int lane = threadIdx.x & 31;
  long long top = j - 1;
  int n = 0, g = -1;
  for (;;) {
    const Status st = read_window(agg, inc, top - lane);
    const bool pre = st.kind == kPrefix;
    const unsigned pmask = __ballot_sync(kFull, pre);
    const int p = pmask ? __ffs(pmask) - 1 : 32;
    if (lane <= p) {
      n += (int)(hi_of(st.word) >> 1);
      g = max(g, (int)lo_of(st.word) - 1);
    }
    if (pmask) break;
    top -= 32;
  }
  return Agg{__reduce_add_sync(kFull, n), __reduce_max_sync(kFull, g)};
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) resolve_onepass(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ batch,
    long long total, int sent, unsigned long long* __restrict__ agg,
    unsigned long long* __restrict__ inc, int* __restrict__ counter,
    int vec_in, int vec_out, uint8_t* __restrict__ keep,
    int* __restrict__ pos, int* __restrict__ f_src, int* __restrict__ f_dst,
    float* __restrict__ f_w, uint8_t* __restrict__ changed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const long long j = next_tile(counter, &sm.tile);
  const long long base = j * kTile;
  const int limit = (int)min((long long)kTile, total + 1 - base);

  load_tile4(sm.src, src, base, total, sent, vec_in);
  load_tile4(sm.dst, dst, base, total, sent, vec_in);
  load_tile4(reinterpret_cast<int*>(sm.w), reinterpret_cast<const int*>(w),
             base, total, 0, vec_in);
  load_tile1(sm.batch, batch, base, total, vec_in);
  if (t == 0) {  // slot base - 1 is a real slot whenever base > 0
    sm.pred_src = base ? src[base - 1] : -2;
    sm.pred_dst = base ? dst[base - 1] : -2;
    sm.pred_w = base ? w[base - 1] : 0.0f;
    sm.pred_b = base ? (int)(batch[base - 1] != 0) : 0;
  }
  cp_async_wait_all();
  __syncthreads();

  write_shifted(f_src, sm.src, sm.pred_src, base, limit, vec_out);
  write_shifted(f_dst, sm.dst, sm.pred_dst, base, limit, vec_out);
  write_shifted(reinterpret_cast<int*>(f_w), reinterpret_cast<int*>(sm.w),
                __float_as_int(sm.pred_w), base, limit, vec_out);

  // Pass 1: this thread's aggregate over its kItems slots.
  const int k0 = t * kItems;
  const int4* src4 = reinterpret_cast<const int4*>(sm.src) + t * (kItems / 4);
  const int4* dst4 = reinterpret_cast<const int4*>(sm.dst) + t * (kItems / 4);
  const float4* w4 = reinterpret_cast<const float4*>(sm.w) + t * (kItems / 4);
  const uint4 b16 = reinterpret_cast<const uint4*>(sm.batch)[t];
  const uint32_t bw[4] = {b16.x, b16.y, b16.z, b16.w};
  const int start_src = t ? sm.src[k0 - 1] : sm.pred_src;
  const int start_dst = t ? sm.dst[k0 - 1] : sm.pred_dst;
  const float start_w = t ? sm.w[k0 - 1] : sm.pred_w;
  const int start_b = t ? (int)(sm.batch[k0 - 1] != 0) : sm.pred_b;
  Agg acc{0, -1};
  {
    int pa = start_src, pb = start_dst;
    float pw = start_w;
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = src4[q], b = dst4[q];
      const float4 x = w4[q];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ae = comp(a, e), be = comp(b, e);
        const int k = k0 + 4 * q + e;
        if (k < limit) {
          const int first = (ae != pa) | (be != pb);
          const int kp = first & (pa != sent) & (pw > 0.0f);
          acc = combine(acc, Agg{kp, first ? (int)(base + k) : -1});
        }
        pa = ae;
        pb = be;
        pw = comp(x, e);
      }
    }
  }
  Agg tile_tot;
  const Agg ex = block_exclusive_scan(acc, Agg{0, -1}, Combine(), ShflAgg(),
                                      sm.warp_tot, tile_tot);

  // Publish, look back, publish; then the carried group's first (w, batch).
  if (j == 0) {
    if (t == 0) {
      publish(inc, word(tile_tot));
      sm.carry = Agg{0, -1};
      sm.carry_old = 0.0f;
    }
  } else {
    if (t == 0) publish(agg + j, word(tile_tot));
    if (t < 32) {
      const Agg c = look_back(agg, inc, j);
      if (t == 0) {
        publish(inc + j, word(combine(c, tile_tot)));
        sm.carry = c;
        // c.g < base: the open group started in an earlier tile.
        sm.carry_old = batch[c.g] ? 0.0f : w[c.g];
      }
    }
  }
  __syncthreads();

  // Pass 2: the records of this thread's slots.
  const Agg run0 = t ? combine(sm.carry, ex) : sm.carry;
  int kept = run0.n;
  float open_old;  // old_w of slot k - 1's group
  if (run0.g < 0) {
    open_old = 0.0f;
  } else if (run0.g >= base) {
    const int k = (int)(run0.g - base);
    open_old = sm.batch[k] ? 0.0f : sm.w[k];
  } else {
    open_old = sm.carry_old;
  }
  uint32_t keep_f[kItems / 4], chg_f[kItems / 4];
  {
    int pa = start_src, pb = start_dst, pbat = start_b;
    float pw = start_w;
    int4* pos4 = reinterpret_cast<int4*>(sm.pos) + t * (kItems / 4);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = src4[q], b = dst4[q];
      const float4 x = w4[q];
      uint32_t kf = 0, cf = 0;
      int p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ae = comp(a, e), be = comp(b, e);
        const float xe = comp(x, e);
        const int be_batch = (int)((bw[q] >> (8 * e)) & 0xffu) != 0;
        const int first = (ae != pa) | (be != pb);
        const int live = first & (pa != sent);
        const int kp = live & (pw > 0.0f);
        const int ch = live & pbat & (open_old != pw);
        p[e] = kept;
        kept += kp;
        kf |= (uint32_t)kp << (8 * e);
        cf |= (uint32_t)ch << (8 * e);
        if (first) open_old = be_batch ? 0.0f : xe;
        pa = ae;
        pb = be;
        pw = xe;
        pbat = be_batch;
      }
      keep_f[q] = kf;
      chg_f[q] = cf;
      pos4[q] = make_int4(p[0], p[1], p[2], p[3]);
    }
  }
  write_flags(keep, keep_f, base, limit, vec_out);
  write_flags(changed, chg_f, base, limit, vec_out);
  __syncthreads();
  write_tile4(pos, sm.pos, base, limit, vec_out);
}

}  // namespace

// Scratch: 2 * n_tiles + 1 zeroed 64-bit words (the tiles' aggregate words,
// their prefix words, then the tile counter), n_tiles = ceil((total + 1) /
// chunk_slots).  Outputs hold total + 1 entries; keep and changed are one
// byte each (torch.bool).  The caller sizes the scratch with its own tile
// size, which must be kTile.
extern "C" int resolve_groups_launch(const void* src, const void* dst,
                                     const void* w, const void* batch,
                                     int total, int sent, int chunk_slots,
                                     void* scratch, void* keep, void* pos,
                                     void* f_src, void* f_dst, void* f_w,
                                     void* changed, void* stream) {
  if (chunk_slots != kTile || total < 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)total + kTile) / kTile);
  unsigned long long* agg = static_cast<unsigned long long*>(scratch);
  unsigned long long* inc = agg + n_tiles;
  int* counter = reinterpret_cast<int*>(inc + n_tiles);
  const int vec_in = aligned16(src) && aligned16(dst) && aligned16(w) &&
                     aligned16(batch);
  const int vec_out = aligned16(keep) && aligned16(pos) && aligned16(f_src) &&
                      aligned16(f_dst) && aligned16(f_w) && aligned16(changed);
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      resolve_onepass, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  resolve_onepass<<<n_tiles, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      (const int*)src, (const int*)dst, (const float*)w,
      (const uint8_t*)batch, total, sent, agg, inc, counter, vec_in, vec_out,
      (uint8_t*)keep, (int*)pos, (int*)f_src, (int*)f_dst, (float*)f_w,
      (uint8_t*)changed);
  return (int)cudaGetLastError();
}
