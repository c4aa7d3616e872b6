// Kernel K1: the factored market's merged min pass, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// p2pmicrogrid_tpu/ops/pallas_factored.py::merged_min_sums_pallas
// (body _merged_min_kernel). For each scenario s and agents i, j < A:
//
//   m[i, j] = min(alpha_i * (pb_i > 0 ? wplus_j : 1),
//                 (ps_j > 0 ? wminus_i : 1) * gamma_j)
//   row_i = sum_j m[i, j],   col_j = sum_i m[i, j]
//
// Inputs are six [S, A] float32 arrays (row-major, contiguous; the masks pb
// and ps as 0/1 floats); outputs are two [S, A] float32 arrays.
//
// What bounds it: about 7 float32 operations per entry (two products, two
// selects, a min, two sums) over S * A^2 entries, against 32 * S * A bytes
// moved. At S = 64, A = 1000 that is about 0.45 GFLOP for 2 MB, far above
// the card's operations-per-byte balance, so the pass is compute bound and
// nothing the kernel does with memory changes that.
//
// Design, simple and deterministic first. The Pallas kernel carries the
// column sums across its sequential i-tiles in scratch; blocks on Hopper run
// in parallel in no order, so that carry does not translate. Instead two
// kernels run back to back on the caller's stream: in the first each thread
// owns one row i and walks all j, in the second each thread owns one column
// j and walks all i. The walked side's three vectors are staged through
// shared memory in tiles that every thread of the block reads at the same
// address (a broadcast, no bank conflicts). Each thread sums its entries in
// a fixed order (four interleaved partial sums per tile, then tile by tile),
// so the result is bit-identical from launch to launch and needs no float
// atomics. Both kernels recompute each entry with the same
// formula (slot_ops.cuh, shared with the fused slot K7), so the arithmetic is
// done twice; a single fused pass with
// per-tile column partials and a second deterministic reduce is later work.
// Ragged A: threads past A load zeros and store nothing, and tiles stop at
// A. A zero factor gives a zero entry (min against a nonnegative side).

#include <cuda_runtime.h>

#include "slot_ops.cuh"

namespace {

using slot_ops::merged_min_entry;
using slot_ops::tile_sum;

constexpr int kThreads = 128;  // rows (columns) owned by one block
constexpr int kTile = slot_ops::kMergedMinTile;  // walked entries staged per shared tile
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
merged_min_rows(const float* __restrict__ alpha, const float* __restrict__ wplus,
                const float* __restrict__ wminus, const float* __restrict__ gamma,
                const float* __restrict__ pb, const float* __restrict__ ps,
                float* __restrict__ row, int S, int A) {
  __shared__ float sh_wplus[kTile];
  __shared__ float sh_gamma[kTile];
  __shared__ float sh_ps[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const size_t base = static_cast<size_t>(s) * A;
    float al = 0.f, wm = 0.f, pbi = 0.f;
    if (i < A) {
      al = alpha[base + i];
      wm = wminus[base + i];
      pbi = pb[base + i];
    }
    float acc = 0.f;
    for (int j0 = 0; j0 < A; j0 += kTile) {
      const int n = min(kTile, A - j0);
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += kThreads) {
        sh_wplus[t] = wplus[base + j0 + t];
        sh_gamma[t] = gamma[base + j0 + t];
        sh_ps[t] = ps[base + j0 + t];
      }
      __syncthreads();
      // Four interleaved partial sums per tile, combined in a fixed order:
      // independent add chains, and a shorter run of rounding per sum.
      acc += tile_sum(n, [&](int t) {
        return merged_min_entry(al, wm, pbi, sh_wplus[t], sh_gamma[t], sh_ps[t]);
      });
    }
    if (i < A) row[base + i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
merged_min_cols(const float* __restrict__ alpha, const float* __restrict__ wplus,
                const float* __restrict__ wminus, const float* __restrict__ gamma,
                const float* __restrict__ pb, const float* __restrict__ ps,
                float* __restrict__ col, int S, int A) {
  __shared__ float sh_alpha[kTile];
  __shared__ float sh_wminus[kTile];
  __shared__ float sh_pb[kTile];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const size_t base = static_cast<size_t>(s) * A;
    float wp = 0.f, ga = 0.f, psj = 0.f;
    if (j < A) {
      wp = wplus[base + j];
      ga = gamma[base + j];
      psj = ps[base + j];
    }
    float acc = 0.f;
    for (int i0 = 0; i0 < A; i0 += kTile) {
      const int n = min(kTile, A - i0);
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += kThreads) {
        sh_alpha[t] = alpha[base + i0 + t];
        sh_wminus[t] = wminus[base + i0 + t];
        sh_pb[t] = pb[base + i0 + t];
      }
      __syncthreads();
      acc += tile_sum(n, [&](int t) {
        return merged_min_entry(sh_alpha[t], sh_wminus[t], sh_pb[t], wp, ga, psj);
      });
    }
    if (j < A) col[base + j] = acc;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches both kernels on `stream` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int merged_min_sums_launch(const float* alpha, const float* wplus,
                                      const float* wminus, const float* gamma,
                                      const float* pb, const float* ps,
                                      float* row, float* col, int S, int A,
                                      cudaStream_t stream) {
  if (S <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((A + kThreads - 1) / kThreads, S < kMaxGridY ? S : kMaxGridY);
  merged_min_rows<<<grid, kThreads, 0, stream>>>(alpha, wplus, wminus, gamma,
                                                 pb, ps, row, S, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merged_min_cols<<<grid, kThreads, 0, stream>>>(alpha, wplus, wminus, gamma,
                                                 pb, ps, col, S, A);
  return static_cast<int>(cudaGetLastError());
}
