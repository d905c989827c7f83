// Shared pieces of the single-pass segmented scans K3 (coarsen.cu) and K4
// (batch_apply.cu), hand-written for Hopper (sm_90a).
//
// Both kernels walk a sorted slot list of total + 1 slots (the real slots
// and one trailing sentinel pad) in tiles of kTile slots, one tile per
// block of kThreads threads, kItems consecutive slots per thread.  Each
// block takes its tile id from an atomic counter, not from blockIdx, so
// every tile it waits on belongs to a block that is already resident and
// the wait always ends.  The carry from tile to tile is a decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016): a block publishes its tile's
// aggregate as soon as it has it, then warp 0 reads the status words of the
// 32 tiles before it at a time, back to the nearest published inclusive
// prefix, and publishes its own inclusive prefix.
//
// Status words.  Each tile has two 64-bit words in scratch that the wrapper
// zeroes on every call: its aggregate and its inclusive prefix.  A word
// packs the value with a valid bit in one aligned 64-bit store, so a reader
// that sees the bit sees the value with it; 0 means "not yet published".
// The counter sits after the 2 * n_tiles words.
//
// Memory traffic.  A tile's inputs come in with 16-byte cp.async copies
// into shared memory (no register staging); the per-slot work reads its
// consecutive slots from there as 16-byte vectors; outputs leave 16 bytes
// per thread, coalesced: the shifted copies (the predecessor's key, weight)
// straight from the input tiles with one shuffle, the counts and sums
// through a staging tile, the byte flags as each thread's 16 bytes.  A
// tile's load overlaps the scans of the other resident blocks of its SM
// (three per SM at 256 threads), not a second buffer of its own.  Inputs that are not
// 16-byte aligned (a view with an offset) and the ragged last tile take
// scalar, still coalesced, loads and stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segscan {

// Threads per block; the tile is 16 slots per thread.
constexpr int kThreads = 256;
constexpr int kItems = 16;
// Blocks per SM the launch bounds ask for: three blocks of ~66-70 KB of
// shared memory.
constexpr int kMinBlocks = 3;
constexpr int kTile = kThreads * kItems;
// One 16-byte vector per thread holds its byte flags (load_tile1,
// write_flags, K4's batch flags).
static_assert(kItems == 16, "a thread's byte flags are one 16-byte vector");
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kTile / 4;  // 16-byte vectors of a 4-byte tile
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ unsigned long long pack(uint32_t lo, uint32_t hi) {
  return (unsigned long long)lo | ((unsigned long long)hi << 32);
}

__device__ __forceinline__ uint32_t lo_of(unsigned long long x) {
  return (uint32_t)x;
}

__device__ __forceinline__ uint32_t hi_of(unsigned long long x) {
  return (uint32_t)(x >> 32);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The next tile id, taken by thread 0 and handed to the whole block.
__device__ __forceinline__ long long next_tile(int* counter, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

struct Status {
  int kind;
  unsigned long long word;
};

// The status of tile i (one per lane of warp 0), read again until every
// lane's tile has published at least its aggregate.  Tiles before tile 0
// read as a zero prefix; tile 0 always publishes its prefix, so they never
// contribute.
__device__ __forceinline__ Status read_window(const unsigned long long* agg,
                                              const unsigned long long* inc,
                                              long long i) {
  Status s;
  for (;;) {
    if (i < 0) {
      s.kind = kPrefix;
      s.word = 0;
    } else {
      s.word = peek(inc + i);
      s.kind = kPrefix;
      if (s.word == 0) {
        s.word = peek(agg + i);
        s.kind = s.word ? kAggregate : kInvalid;
      }
    }
    if (__all_sync(kFull, s.kind != kInvalid)) return s;
    __nanosleep(32);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Starts the copy of a tile of 4-byte values from g[base, base + kTile)
// into s, or fills it with scalar loads: slots at or past `total` (the pad
// and beyond) get `fill`.  `vec` says that g is 16-byte aligned.
__device__ __forceinline__ void load_tile4(int* s, const int* g,
                                           long long base, long long total,
                                           int fill, bool vec) {
  if (vec && base + kTile <= total) {
    for (int m = threadIdx.x; m < kVecs; m += kThreads)
      cp_async16(s + 4 * m, g + base + 4 * m);
  } else {
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const long long i = base + k;
      s[k] = i < total ? g[i] : fill;
    }
  }
}

// The same for a tile of bytes (one 16-byte copy per thread).
__device__ __forceinline__ void load_tile1(uint8_t* s, const uint8_t* g,
                                           long long base, long long total,
                                           bool vec) {
  if (vec && base + kTile <= total) {
    cp_async16(s + 16 * threadIdx.x, g + base + 16 * threadIdx.x);
  } else {
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const long long i = base + k;
      s[k] = i < total ? g[i] : 0;
    }
  }
}

// out[base + k] = s[k - 1] (pred for k = 0) for k < limit: the shifted copy
// of a 4-byte input tile, 16 bytes per thread when the tile is whole.
__device__ __forceinline__ void write_shifted(int* out, const int* s, int pred,
                                              long long base, int limit,
                                              bool vec) {
  const int t = threadIdx.x, lane = t & 31;
  if (vec && limit == kTile) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* o4 = reinterpret_cast<int4*>(out + base);
    for (int m = t; m < kVecs; m += kThreads) {
      const int4 v = s4[m];
      int left = __shfl_up_sync(kFull, v.w, 1);
      if (lane == 0) left = m ? s[4 * m - 1] : pred;
      o4[m] = make_int4(left, v.x, v.y, v.z);
    }
  } else {
    for (int k = t; k < limit; k += kThreads)
      out[base + k] = k ? s[k - 1] : pred;
  }
}

// out[base + k] = s[k] for k < limit (a staged output tile).
__device__ __forceinline__ void write_tile4(int* out, const int* s,
                                            long long base, int limit,
                                            bool vec) {
  if (vec && limit == kTile) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* o4 = reinterpret_cast<int4*>(out + base);
    for (int m = threadIdx.x; m < kVecs; m += kThreads) o4[m] = s4[m];
  } else {
    for (int k = threadIdx.x; k < limit; k += kThreads) out[base + k] = s[k];
  }
}

// Each thread's kItems byte flags (slots t * kItems ...), packed four to a
// word, written as one 16-byte store when the tile is whole.
__device__ __forceinline__ void write_flags(uint8_t* out, const uint32_t* f,
                                            long long base, int limit,
                                            bool vec) {
  const int k0 = threadIdx.x * kItems;
  if (vec && limit == kTile) {
    *reinterpret_cast<uint4*>(out + base + k0) =
        make_uint4(f[0], f[1], f[2], f[3]);
  } else {
    for (int e = 0; e < kItems && k0 + e < limit; ++e)
      out[base + k0 + e] = (uint8_t)(f[e >> 2] >> (8 * (e & 3)));
  }
}

// Exclusive scan of one value per thread across the block, in a fixed
// order (warp shuffles, then the warps' totals folded left to right), so
// float operands associate the same way on every call.  `shfl(v, d)` is
// __shfl_up_sync for the value type; `warp_tot` holds kWarps values in
// shared memory.  Returns the thread's exclusive prefix (`id` for thread
// 0) and the block's total in `total`.
template <class T, class Op, class Shfl>
__device__ __forceinline__ T block_exclusive_scan(T v, T id, Op op, Shfl shfl,
                                                  T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl(inc, d);
    if (lane >= d) inc = op(o, inc);
  }
  const T ex = shfl(inc, 1);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T run = id, before = id;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before = run;
    run = w ? op(run, warp_tot[w]) : warp_tot[0];
  }
  total = run;
  if (lane == 0) return before;
  return warp ? op(before, ex) : ex;
}

__device__ __forceinline__ int comp(int4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace segscan
