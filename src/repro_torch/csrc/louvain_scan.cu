// K1 and K2 of the PyTorch port: the Louvain best-move scan over ELL rows,
// hand-written for Hopper (sm_90a).  One device routine (scan_row), two
// __global__ entry points.
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
//
// Design.  The TPU kernel carries a B x D x D equality tile per block into
// VMEM and contracts it on the matrix unit.  Here one warp owns one ELL row:
// the row's D community ids and weights are staged once into the warp's
// slice of shared memory, and each lane owns slots j = lane, lane + 32, ...
// For a live slot j the lane sums K_{i->c_j} = sum_e w[e] * [c[e] == c[j]]
// over e in ascending order out of shared memory, evaluates Eq. 2, and
// keeps the lexicographic best (largest dQ, then smallest community id);
// five xor-shuffles reduce the warp to the row's answer.  K1 then takes
// |best community| as the min size over the slots holding it (a second
// warp min) and applies the gated decision in registers.
//
// Bound on the card: bytes.  The function must read the id c of every
// slot (4 B; it marks the padding), w of every occupied slot (4 B), and
// Sigma (K1: and |c|) of every candidate slot (c >= 0, c != c_own; 4 or
// 8 B), plus 12 B (K2) or 24 B (K1) per row, and write 8 or 12 B per row;
// at 3.35 TB/s that is the least time.  Padding (c = -1) is most of an
// R-MAT graph's ELL slots, so the bound depends on the data.  The design
// reads c and w of every slot once, coalesced (lane-strided), padding
// included, and Sigma and |c| only at candidate slots; it keeps the D x D
// compare in shared memory and registers, so the padding's w and the
// compare's instruction count at the widest tiles (D = 256 is 64K
// compare-adds per row) put it above the bound.  Making it fast (skipping
// padded slots, a sort or hash of the D labels per row) is later work.
//
// Exactness hazards, which the plain PyTorch version (fused.py /
// louvain_scan.py beside this file's wrappers) mirrors operation for
// operation so that the two agree bit for bit on any weights:
//   * No FMA contraction.  The tie test dq == best_dq needs IEEE-identical
//     dq, so dq is evaluated in exactly the reference's order,
//     (k_to - k_own) / m - k_i * ((k_i + sig) - sig_own) / ((2 * m) * m),
//     and the build passes --fmad=false and never --use_fast_math.  Sums
//     over a row run in ascending slot order, as the plain version's loop.
//   * The Weyl gate.  GATE_MUL = -1640531535 and GATE_INC = 40503 act on
//     int32 with wraparound in the reference.  Signed overflow is undefined
//     in C++, so the hash is multiplied and added in uint32_t, converted to
//     int32_t (two's complement), shifted arithmetically >> 13, then
//     abs and % gate_fraction.
//   * Pad rows carry vertex id n_cap (the sentinel); dead slots (padding
//     or self loops) have c = -1 and w = 0 and are never candidates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kIntMax = 0x7fffffff;
constexpr uint32_t kGateMul = 2654435761u;  // int32 -1640531535
constexpr uint32_t kGateInc = 40503u;

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

// The scan of one staged row; every lane returns the row's best (dQ, id),
// (-inf, INT_MAX) when the row has no candidate.
__device__ __forceinline__ void scan_row(const int* sc, const float* sw,
                                         const float* sig_row, int d,
                                         int c_own, float k_i, float sig_own,
                                         float m, int lane, float& best_dq,
                                         int& best_c) {
  float k_own = 0.0f;
  for (int e = 0; e < d; ++e) k_own += (sc[e] == c_own) ? sw[e] : 0.0f;
  const float two_m_m = (2.0f * m) * m;
  float bdq = -INFINITY;
  int bc = kIntMax;
  for (int j = lane; j < d; j += kWarp) {
    const int cj = sc[j];
    if (cj < 0 || cj == c_own) continue;
    float k_to = 0.0f;
    for (int e = 0; e < d; ++e) k_to += (sc[e] == cj) ? sw[e] : 0.0f;
    const float gain = (k_to - k_own) / m;
    const float cost = k_i * ((k_i + sig_row[j]) - sig_own) / two_m_m;
    keep_better(bdq, bc, gain - cost, cj);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float odq = __shfl_xor_sync(0xffffffffu, bdq, off);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
    keep_better(bdq, bc, odq, oc);
  }
  best_dq = bdq;
  best_c = bc;
}

template <bool kFused>
__global__ void ell_scan_kernel(
    const int* __restrict__ c, const float* __restrict__ w,
    const float* __restrict__ sig, const int* __restrict__ size_nbr,
    const float* __restrict__ k_i, const int* __restrict__ c_own,
    const float* __restrict__ sig_own, const int* __restrict__ size_own,
    const int* __restrict__ rows, const int* __restrict__ front,
    const float* __restrict__ m_ptr, int round_ix, int n_rows, int d,
    int gate_fraction, int sentinel, int* __restrict__ out_c,
    float* __restrict__ out_dq, int* __restrict__ out_move) {
  extern __shared__ unsigned char smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int* sc = reinterpret_cast<int*>(smem) + warp * d;
  float* sw = reinterpret_cast<float*>(smem + sizeof(int) * warps * d) +
              warp * d;
  const float m = *m_ptr;

  for (long long r = (long long)blockIdx.x * warps + warp; r < n_rows;
       r += (long long)gridDim.x * warps) {
    const long long base = r * d;
    for (int j = lane; j < d; j += kWarp) {
      sc[j] = c[base + j];
      sw[j] = w[base + j];
    }
    __syncwarp();
    const int own = c_own[r];
    float bdq;
    int bc;
    scan_row(sc, sw, sig + base, d, own, k_i[r], sig_own[r], m, lane, bdq,
             bc);
    const bool found = isfinite(bdq);
    if (!kFused) {
      if (lane == 0) {
        out_c[r] = found ? bc : -1;
        out_dq[r] = found ? bdq : -INFINITY;
      }
    } else {
      const int bcs = found ? bc : sentinel;
      // sizes[best_c] without a gather: every live slot holding the best
      // community carries its size; the min over them (INT_MAX if none).
      int size_best = kIntMax;
      for (int j = lane; j < d; j += kWarp) {
        const int cj = sc[j];
        if (cj >= 0 && cj != own && cj == bcs)
          size_best = min(size_best, size_nbr[base + j]);
      }
      for (int off = kWarp / 2; off > 0; off >>= 1)
        size_best =
            min(size_best, __shfl_xor_sync(0xffffffffu, size_best, off));
      if (lane == 0) {
        const float best = found ? bdq : -INFINITY;
        const bool in_front = front[r] > 0;
        const bool swap_blocked =
            size_own[r] == 1 && size_best == 1 && bcs > own;
        bool do_move = best > 0.0f && bcs != own && bcs < sentinel &&
                       in_front && !swap_blocked;
        if (gate_fraction > 1) {
          const uint32_t h = (uint32_t)rows[r] * kGateMul +
                             (uint32_t)round_ix * kGateInc;
          const int32_t hs = (int32_t)h;     // two's complement
          const int32_t sh = hs >> 13;       // arithmetic shift
          const int32_t mag = sh < 0 ? -sh : sh;  // |sh| <= 2^18
          do_move = do_move && (mag % gate_fraction == 0);
        }
        out_c[r] = bcs;
        out_dq[r] = in_front ? best : -INFINITY;
        out_move[r] = do_move ? 1 : 0;
      }
    }
    __syncwarp();  // the next row overwrites this warp's staging slice
  }
}

int launch(bool fused, const void* c, const void* w, const void* sig,
           const void* size_nbr, const void* k_i, const void* c_own,
           const void* sig_own, const void* size_own, const void* rows,
           const void* front, const void* m, int round_ix, int n_rows, int d,
           int gate_fraction, int sentinel, void* out_c, void* out_dq,
           void* out_move, int rows_per_block, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int threads = rows_per_block * kWarp;
  const long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(want < 1048576 ? want : 1048576);
  const size_t smem = (size_t)rows_per_block * d * (sizeof(int) + sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    ell_scan_kernel<true><<<blocks, threads, smem, s>>>(
        (const int*)c, (const float*)w, (const float*)sig,
        (const int*)size_nbr, (const float*)k_i, (const int*)c_own,
        (const float*)sig_own, (const int*)size_own, (const int*)rows,
        (const int*)front, (const float*)m, round_ix, n_rows, d,
        gate_fraction, sentinel, (int*)out_c, (float*)out_dq,
        (int*)out_move);
  } else {
    ell_scan_kernel<false><<<blocks, threads, smem, s>>>(
        (const int*)c, (const float*)w, (const float*)sig, nullptr,
        (const float*)k_i, (const int*)c_own, (const float*)sig_own, nullptr,
        nullptr, nullptr, (const float*)m, 0, n_rows, d, 1, 0, (int*)out_c,
        (float*)out_dq, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int louvain_fused_launch(
    const void* c, const void* w, const void* sig, const void* size_nbr,
    const void* k_i, const void* c_own, const void* sig_own,
    const void* size_own, const void* rows, const void* front,
    const void* m, int round_ix, int n_rows, int d, int gate_fraction,
    int sentinel, void* out_c, void* out_dq, void* out_move,
    int rows_per_block, void* stream) {
  return launch(true, c, w, sig, size_nbr, k_i, c_own, sig_own, size_own,
                rows, front, m, round_ix, n_rows, d, gate_fraction, sentinel,
                out_c, out_dq, out_move, rows_per_block, stream);
}

extern "C" int louvain_scan_launch(const void* c, const void* w,
                                   const void* sig, const void* k_i,
                                   const void* c_own, const void* sig_own,
                                   const void* m, int n_rows, int d,
                                   void* out_c, void* out_dq,
                                   int rows_per_block, void* stream) {
  return launch(false, c, w, sig, nullptr, k_i, c_own, sig_own, nullptr,
                nullptr, nullptr, m, 0, n_rows, d, 1, 0, out_c, out_dq,
                nullptr, rows_per_block, stream);
}
