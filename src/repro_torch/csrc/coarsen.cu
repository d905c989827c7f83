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
// sum, emitted count) from tile to tile in SMEM.  Blocks on Hopper run in
// no order, so the carry becomes a three-launch segmented scan:
//   1. coarsen_reduce: each block reduces its chunk of 2048 slots (256
//      threads x 8 consecutive slots) to one segment aggregate
//      (has-a-boundary flag, trailing open-group sum) and an emit count;
//   2. coarsen_scan: one block scans those per-chunk carries in order;
//   3. coarsen_finalize: each block rescans its chunk from its carry and
//      writes the five records of every slot.
// Boundary detection needs no carry at all: a slot reads its predecessor's
// key straight from device memory.  The segment operator is
//   (f1, s1) . (f2, s2) = (f1 | f2, f2 ? s2 : s1 + s2),
// sequential within a thread and a Hillis-Steele tree across threads and
// chunks.  Float sums therefore associate differently from the TPU kernel's
// tree and from the plain version: they agree bit for bit whenever the sums
// are exact (integer-valued weights below 2^24, every golden corpus) and to
// float32 rounding otherwise.  Decoupled look-back (one pass) is later work.
//
// Bound on the card: bytes.  The function reads 12 B per slot (ci, cj, w)
// and writes 17 B per slot (emit, pos, g_src, g_dst, g_w): 29 B/slot at
// 3.35 TB/s.  This design reads the inputs twice (launches 1 and 3), 41
// B/slot in all, and spends one serial block on the chunk carries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kScanThreads = 1024;

struct Seg {
  int f;    // a group boundary lies inside the span
  float s;  // weight sum since the span's last boundary
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.s : a.s + b.s};
}

// Key of slot i of the padded list: i == total is the trailing sentinel pad
// and i == -1 the phantom predecessor (-2 differs from every real key).
__device__ __forceinline__ void slot_key(const int* __restrict__ ci,
                                         const int* __restrict__ cj,
                                         long long i, long long total,
                                         int sent, int& a, int& b) {
  if (i < 0) {
    a = -2;
    b = -2;
  } else if (i >= total) {
    a = sent;
    b = sent;
  } else {
    a = ci[i];
    b = cj[i];
  }
}

struct Slot {
  int prev_ci, prev_cj;
  int first, emit;
  float w;
};

__device__ __forceinline__ Slot read_slot(const int* __restrict__ ci,
                                          const int* __restrict__ cj,
                                          const float* __restrict__ w,
                                          long long i, long long total,
                                          int sent) {
  Slot s;
  int a, b;
  slot_key(ci, cj, i - 1, total, sent, s.prev_ci, s.prev_cj);
  slot_key(ci, cj, i, total, sent, a, b);
  s.first = (a != s.prev_ci) | (b != s.prev_cj);
  s.emit = s.first & (s.prev_ci != sent) & (s.prev_ci >= 0);
  s.w = i < total ? w[i] : 0.0f;
  return s;
}

// One thread's aggregate over its kItems consecutive slots.
__device__ __forceinline__ void thread_aggregate(
    const int* __restrict__ ci, const int* __restrict__ cj,
    const float* __restrict__ w, long long start, long long total, int sent,
    Seg& acc, int& count) {
  acc = Seg{0, 0.0f};
  count = 0;
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + k;
    if (i > total) break;
    const Slot s = read_slot(ci, cj, w, i, total, sent);
    acc = combine(acc, Seg{s.first, s.w});
    count += s.emit;
  }
}

__global__ void coarsen_reduce(const int* __restrict__ ci,
                               const int* __restrict__ cj,
                               const float* __restrict__ w, long long total,
                               int sent, int* __restrict__ chunk_f,
                               float* __restrict__ chunk_s,
                               int* __restrict__ chunk_n) {
  __shared__ int sf[kThreads];
  __shared__ float ss[kThreads];
  __shared__ int sn[kThreads];
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * kChunk + (long long)t * kItems;
  Seg acc;
  int count;
  thread_aggregate(ci, cj, w, start, total, sent, acc, count);
  sf[t] = acc.f;
  ss[t] = acc.s;
  sn[t] = count;
  __syncthreads();
  // Ordered tree reduction: the left operand always precedes the right.
  for (int d = 1; d < kThreads; d <<= 1) {
    if ((t % (2 * d)) == 0) {
      const Seg o = combine(Seg{sf[t], ss[t]}, Seg{sf[t + d], ss[t + d]});
      sf[t] = o.f;
      ss[t] = o.s;
      sn[t] += sn[t + d];
    }
    __syncthreads();
  }
  if (t == 0) {
    chunk_f[blockIdx.x] = sf[0];
    chunk_s[blockIdx.x] = ss[0];
    chunk_n[blockIdx.x] = sn[0];
  }
}

// Inclusive Hillis-Steele scan of (seg, count) over the block's shared
// arrays (n = blockDim.x entries).
__device__ __forceinline__ void block_inclusive_scan(int* sf, float* ss,
                                                     int* sn) {
  const int t = threadIdx.x;
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    Seg left{0, 0.0f};
    int left_n = 0;
    const bool has = t >= d;
    if (has) {
      left = Seg{sf[t - d], ss[t - d]};
      left_n = sn[t - d];
    }
    __syncthreads();
    if (has) {
      const Seg o = combine(left, Seg{sf[t], ss[t]});
      sf[t] = o.f;
      ss[t] = o.s;
      sn[t] += left_n;
    }
    __syncthreads();
  }
}

__global__ void coarsen_scan(const int* __restrict__ chunk_f,
                             const float* __restrict__ chunk_s,
                             const int* __restrict__ chunk_n, int n_chunks,
                             float* __restrict__ carry_s,
                             int* __restrict__ carry_n) {
  __shared__ int sf[kScanThreads];
  __shared__ float ss[kScanThreads];
  __shared__ int sn[kScanThreads];
  const int t = threadIdx.x;
  Seg run{0, 0.0f};
  int run_n = 0;
  for (int base = 0; base < n_chunks; base += kScanThreads) {
    const int i = base + t;
    const bool live = i < n_chunks;
    sf[t] = live ? chunk_f[i] : 0;
    ss[t] = live ? chunk_s[i] : 0.0f;
    sn[t] = live ? chunk_n[i] : 0;
    __syncthreads();
    block_inclusive_scan(sf, ss, sn);
    const Seg ex = t ? Seg{sf[t - 1], ss[t - 1]} : Seg{0, 0.0f};
    const int ex_n = t ? sn[t - 1] : 0;
    if (live) {
      carry_s[i] = combine(run, ex).s;
      carry_n[i] = run_n + ex_n;
    }
    const Seg tile = Seg{sf[kScanThreads - 1], ss[kScanThreads - 1]};
    const int tile_n = sn[kScanThreads - 1];
    __syncthreads();  // the next tile overwrites the shared arrays
    run = combine(run, tile);
    run_n += tile_n;
  }
}

__global__ void coarsen_finalize(
    const int* __restrict__ ci, const int* __restrict__ cj,
    const float* __restrict__ w, long long total, int sent,
    const float* __restrict__ carry_s, const int* __restrict__ carry_n,
    uint8_t* __restrict__ emit, int* __restrict__ pos,
    int* __restrict__ g_src, int* __restrict__ g_dst,
    float* __restrict__ g_w) {
  __shared__ int sf[kThreads];
  __shared__ float ss[kThreads];
  __shared__ int sn[kThreads];
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * kChunk + (long long)t * kItems;
  Seg acc;
  int count;
  thread_aggregate(ci, cj, w, start, total, sent, acc, count);
  sf[t] = acc.f;
  ss[t] = acc.s;
  sn[t] = count;
  __syncthreads();
  block_inclusive_scan(sf, ss, sn);
  const Seg ex = t ? Seg{sf[t - 1], ss[t - 1]} : Seg{0, 0.0f};
  const int ex_n = t ? sn[t - 1] : 0;
  // Only the carry's sum matters: combine never reads its left flag.
  Seg run = combine(Seg{0, carry_s[blockIdx.x]}, ex);
  int run_n = carry_n[blockIdx.x] + ex_n;
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + k;
    if (i > total) break;
    const Slot s = read_slot(ci, cj, w, i, total, sent);
    emit[i] = (uint8_t)s.emit;
    pos[i] = run_n;
    g_src[i] = s.prev_ci;
    g_dst[i] = s.prev_cj;
    g_w[i] = run.s;
    run = combine(run, Seg{s.first, s.w});
    run_n += s.emit;
  }
}

}  // namespace

// Scratch: int_scratch holds 3 * n_chunks ints (chunk flags, chunk counts,
// carried counts), float_scratch 2 * n_chunks floats (chunk sums, carried
// sums), n_chunks = ceil((total + 1) / chunk_slots).  Outputs hold
// total + 1 entries.  The caller sizes the scratch with its own chunk size,
// which must be kChunk.
extern "C" int coarsen_groups_launch(const void* ci, const void* cj,
                                     const void* w, int total, int sent,
                                     int chunk_slots, void* int_scratch,
                                     void* float_scratch, void* emit,
                                     void* pos, void* g_src, void* g_dst,
                                     void* g_w, void* stream) {
  if (chunk_slots != kChunk || total < 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (total + 1 + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* chunk_f = static_cast<int*>(int_scratch);
  int* chunk_n = chunk_f + n_chunks;
  int* carry_n = chunk_n + n_chunks;
  float* chunk_s = static_cast<float*>(float_scratch);
  float* carry_s = chunk_s + n_chunks;
  coarsen_reduce<<<n_chunks, kThreads, 0, s>>>(
      (const int*)ci, (const int*)cj, (const float*)w, total, sent, chunk_f,
      chunk_s, chunk_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  coarsen_scan<<<1, kScanThreads, 0, s>>>(chunk_f, chunk_s, chunk_n,
                                          n_chunks, carry_s, carry_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  coarsen_finalize<<<n_chunks, kThreads, 0, s>>>(
      (const int*)ci, (const int*)cj, (const float*)w, total, sent, carry_s,
      carry_n, (uint8_t*)emit, (int*)pos, (int*)g_src, (int*)g_dst,
      (float*)g_w);
  return (int)cudaGetLastError();
}
