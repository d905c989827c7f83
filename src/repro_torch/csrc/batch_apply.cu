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
// group's first (w, batch), kept count) from tile to tile in SMEM.  Blocks
// on Hopper run in no order, so the carry becomes two associative scans:
// an exclusive SUM of keep (for pos) and an inclusive MAX of
// (first[i] ? i : -1), which gives every slot the start of its group, so
// the group's first (w, batch) is one gather.  Three launches, as K3
// (csrc/coarsen.cu):
//   1. resolve_reduce: each block reduces its chunk of 2048 slots (256
//      threads x 8 consecutive slots) to (keep count, last group start);
//   2. resolve_scan: one block scans those per-chunk carries in order;
//   3. resolve_finalize: each block rescans its chunk from its carry and
//      writes the six records of every slot.
// Boundaries need no carry: a slot reads its predecessor's key straight
// from device memory.  Decoupled look-back (one pass) is later work.
//
// Bound on the card: bytes.  The function reads 13 B per slot (src, dst,
// w, batch) and writes 18 B per slot (keep 1, pos 4, src 4, dst 4, w 4,
// changed 1): 31 B/slot at 3.35 TB/s.  This design reads the keys twice
// (launches 1 and 3) and spends one serial block on the chunk carries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kScanThreads = 1024;

struct Agg {
  int n;  // keeps in the span
  int g;  // index of the last group start in the span, -1 if none
};

__device__ __forceinline__ Agg combine(Agg a, Agg b) {
  return Agg{a.n + b.n, b.g > a.g ? b.g : a.g};
}

// Key of slot i of the padded list: i == total is the trailing sentinel pad
// and i == -1 the phantom predecessor (-2 differs from every real key).
__device__ __forceinline__ void slot_key(const int* __restrict__ src,
                                         const int* __restrict__ dst,
                                         long long i, long long total,
                                         int sent, int& a, int& b) {
  if (i < 0) {
    a = -2;
    b = -2;
  } else if (i >= total) {
    a = sent;
    b = sent;
  } else {
    a = src[i];
    b = dst[i];
  }
}

struct Slot {
  int prev_src, prev_dst;
  int first, keep, prev_batch;
  float prev_w;
};

__device__ __forceinline__ Slot read_slot(const int* __restrict__ src,
                                          const int* __restrict__ dst,
                                          const float* __restrict__ w,
                                          const uint8_t* __restrict__ batch,
                                          long long i, long long total,
                                          int sent) {
  Slot s;
  int a, b;
  slot_key(src, dst, i - 1, total, sent, s.prev_src, s.prev_dst);
  slot_key(src, dst, i, total, sent, a, b);
  s.first = (a != s.prev_src) | (b != s.prev_dst);
  // i <= total, so slot i - 1 is a real slot whenever i > 0.
  s.prev_w = i > 0 ? w[i - 1] : 0.0f;
  s.prev_batch = i > 0 ? (int)(batch[i - 1] != 0) : 0;
  s.keep = s.first & (s.prev_src != sent) & (s.prev_w > 0.0f);
  return s;
}

// One thread's aggregate over its kItems consecutive slots.
__device__ __forceinline__ Agg thread_aggregate(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ batch,
    long long start, long long total, int sent) {
  Agg acc{0, -1};
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + k;
    if (i > total) break;
    const Slot s = read_slot(src, dst, w, batch, i, total, sent);
    acc = combine(acc, Agg{s.keep, s.first ? (int)i : -1});
  }
  return acc;
}

__global__ void resolve_reduce(const int* __restrict__ src,
                               const int* __restrict__ dst,
                               const float* __restrict__ w,
                               const uint8_t* __restrict__ batch,
                               long long total, int sent,
                               int* __restrict__ chunk_n,
                               int* __restrict__ chunk_g) {
  __shared__ int sn[kThreads];
  __shared__ int sg[kThreads];
  const int t = threadIdx.x;
  const long long start =
      (long long)blockIdx.x * kChunk + (long long)t * kItems;
  const Agg acc = thread_aggregate(src, dst, w, batch, start, total, sent);
  sn[t] = acc.n;
  sg[t] = acc.g;
  __syncthreads();
  for (int d = kThreads / 2; d > 0; d >>= 1) {
    if (t < d) {
      const Agg o = combine(Agg{sn[t], sg[t]}, Agg{sn[t + d], sg[t + d]});
      sn[t] = o.n;
      sg[t] = o.g;
    }
    __syncthreads();
  }
  if (t == 0) {
    chunk_n[blockIdx.x] = sn[0];
    chunk_g[blockIdx.x] = sg[0];
  }
}

// Inclusive Hillis-Steele scan of the block's shared (n, g) arrays
// (blockDim.x entries).
__device__ __forceinline__ void block_inclusive_scan(int* sn, int* sg) {
  const int t = threadIdx.x;
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    Agg left{0, -1};
    const bool has = t >= d;
    if (has) left = Agg{sn[t - d], sg[t - d]};
    __syncthreads();
    if (has) {
      const Agg o = combine(left, Agg{sn[t], sg[t]});
      sn[t] = o.n;
      sg[t] = o.g;
    }
    __syncthreads();
  }
}

__global__ void resolve_scan(const int* __restrict__ chunk_n,
                             const int* __restrict__ chunk_g, int n_chunks,
                             int* __restrict__ carry_n,
                             int* __restrict__ carry_g) {
  __shared__ int sn[kScanThreads];
  __shared__ int sg[kScanThreads];
  const int t = threadIdx.x;
  Agg run{0, -1};
  for (int base = 0; base < n_chunks; base += kScanThreads) {
    const int i = base + t;
    const bool live = i < n_chunks;
    sn[t] = live ? chunk_n[i] : 0;
    sg[t] = live ? chunk_g[i] : -1;
    __syncthreads();
    block_inclusive_scan(sn, sg);
    const Agg ex = t ? Agg{sn[t - 1], sg[t - 1]} : Agg{0, -1};
    if (live) {
      const Agg c = combine(run, ex);
      carry_n[i] = c.n;
      carry_g[i] = c.g;
    }
    const Agg tile{sn[kScanThreads - 1], sg[kScanThreads - 1]};
    __syncthreads();  // the next tile overwrites the shared arrays
    run = combine(run, tile);
  }
}

__global__ void resolve_finalize(
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const uint8_t* __restrict__ batch,
    long long total, int sent, const int* __restrict__ carry_n,
    const int* __restrict__ carry_g, uint8_t* __restrict__ keep,
    int* __restrict__ pos, int* __restrict__ f_src, int* __restrict__ f_dst,
    float* __restrict__ f_w, uint8_t* __restrict__ changed) {
  __shared__ int sn[kThreads];
  __shared__ int sg[kThreads];
  const int t = threadIdx.x;
  const long long start =
      (long long)blockIdx.x * kChunk + (long long)t * kItems;
  const Agg acc = thread_aggregate(src, dst, w, batch, start, total, sent);
  sn[t] = acc.n;
  sg[t] = acc.g;
  __syncthreads();
  block_inclusive_scan(sn, sg);
  const Agg ex = t ? Agg{sn[t - 1], sg[t - 1]} : Agg{0, -1};
  Agg run = combine(Agg{carry_n[blockIdx.x], carry_g[blockIdx.x]}, ex);
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + k;
    if (i > total) break;
    const Slot s = read_slot(src, dst, w, batch, i, total, sent);
    // run.g is the first slot of slot i - 1's group (-1 only for i = 0).
    float old_w = 0.0f;
    if (run.g >= 0 && batch[run.g] == 0) old_w = w[run.g];
    keep[i] = (uint8_t)s.keep;
    pos[i] = run.n;
    f_src[i] = s.prev_src;
    f_dst[i] = s.prev_dst;
    f_w[i] = s.prev_w;
    changed[i] = (uint8_t)(s.first & (s.prev_src != sent) & s.prev_batch &
                           (old_w != s.prev_w));
    run = combine(run, Agg{s.keep, s.first ? (int)i : -1});
  }
}

}  // namespace

// Scratch: 4 * n_chunks ints (chunk keep counts, chunk group starts,
// carried counts, carried starts), n_chunks = ceil((total + 1) /
// chunk_slots).  Outputs hold total + 1 entries; keep and changed are one
// byte each (torch.bool).  The caller sizes the scratch with its own chunk
// size, which must be kChunk.
extern "C" int resolve_groups_launch(const void* src, const void* dst,
                                     const void* w, const void* batch,
                                     int total, int sent, int chunk_slots,
                                     void* scratch, void* keep, void* pos,
                                     void* f_src, void* f_dst, void* f_w,
                                     void* changed, void* stream) {
  if (chunk_slots != kChunk || total < 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (total + 1 + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* chunk_n = static_cast<int*>(scratch);
  int* chunk_g = chunk_n + n_chunks;
  int* carry_n = chunk_g + n_chunks;
  int* carry_g = carry_n + n_chunks;
  resolve_reduce<<<n_chunks, kThreads, 0, s>>>(
      (const int*)src, (const int*)dst, (const float*)w,
      (const uint8_t*)batch, total, sent, chunk_n, chunk_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resolve_scan<<<1, kScanThreads, 0, s>>>(chunk_n, chunk_g, n_chunks,
                                          carry_n, carry_g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resolve_finalize<<<n_chunks, kThreads, 0, s>>>(
      (const int*)src, (const int*)dst, (const float*)w,
      (const uint8_t*)batch, total, sent, carry_n, carry_g, (uint8_t*)keep,
      (int*)pos, (int*)f_src, (int*)f_dst, (float*)f_w, (uint8_t*)changed);
  return (int)cudaGetLastError();
}
