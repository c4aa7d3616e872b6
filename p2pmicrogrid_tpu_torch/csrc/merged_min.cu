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
// What bounds it: operations. About 7 float32 operations an entry (two
// products, two selects, a min, two sums) over S * A^2 entries, against 32 *
// S * A bytes moved: at S = 64, A = 1000 about 0.45 GFLOP for 2 MB, far above
// the card's operations-per-byte balance. So the design is about the
// instructions issued per entry.
//
// Design: each entry computed once, in registers. A block of 8 warps owns one
// scenario's tile of 64 rows i (8 a warp, the same in every lane) and walks
// the columns j in steps of 32 * kCols; lane L takes the columns j = L + 32k
// of each step. A thread holds its 8 rows' factors in registers for the whole
// walk, and each step's column factors come from shared memory, one 16-byte
// read a column (a warp reads 32 consecutive columns, free of bank
// conflicts), each reused over the 8 rows. Where every factor of the block's
// rows and of the step's columns is finite with its sign bit clear (the
// market's factors are nonnegative), the selects are folded into the
// factors (fold_row, fold_col) and an entry is two fused multiply-adds, a
// min and two adds: 4 float32-pipe instructions and one min (the design it
// replaced computed every entry twice, in a kernel over rows and one over
// columns, and read three factors from shared memory for each). Any other
// step takes the exact form (entry_exact: the selects, torch.minimum's NaN
// rule); both forms give every entry's bits, so the choice changes no
// result. On an H100 the kernel runs at about a third of that issue rate:
// each block's row loads and two barriers a step, not the arithmetic, set
// its time (PERF.md).
//
// Order of the sums, fixed, so a repeat is bit-identical and needs no
// atomics: row i is lane L's sum of the columns j = L, L + 32, ... in order,
// then the xor-butterfly 16, 8, 4, 2, 1 over the lanes (the order of the
// matrix kernels' row totals); column j of a tile is each warp's 8 rows in
// order, then the 8 warps in order, into partials [S, tiles, A] that
// merged_min_colsum_kernel adds tile by tile in order (with one tile, the
// tiles kernel writes the column sums itself). Ragged A: rows and columns
// past A stage zero factors, whose entries are +0 and add nothing; the exact
// form masks them.

#include <cuda_runtime.h>

#include "slot_ops.cuh"

namespace {

using slot_ops::min_nan;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 8;                     // rows i of a warp
constexpr int kTileRows = kWarps * kWarpRows;    // rows i of a block (ops/merged_min.py)
constexpr int kMaxGridY = 65535;
constexpr int kReduceThreads = 256;

// x is finite with its sign bit clear (+0 included).
__device__ __forceinline__ bool plain_nonneg(float x) {
  return __float_as_uint(x) < 0x7f800000u;
}

// A row's factors (a1, a0, wminus) and a column's (wplus, g1, g0), with the
// masks pb and ps as flags, folded so that
//   lhs = pb ? alpha * wplus : alpha   = fma(a1, wplus, a0)
//   rhs = ps ? wminus * gamma : gamma  = fma(wminus, g1, g0)
// with a1 = pb ? alpha : 0, a0 = pb ? -0 : alpha (g1, g0 alike). With every
// factor finite and its sign bit clear, one term of each fma is a zero that
// leaves the other as it is (x + -0 = x; +0 * y + x = x), so lhs and rhs are
// the selected products' bits, and neither is NaN or -0, so fminf is
// torch.minimum. tests/test_torch_merged_min_tiles.py checks the fold. The
// exact form recovers alpha = pb ? a1 : a0 and gamma = ps ? g1 : g0.
struct RowFactors {
  float a1, a0, wm;
};

__device__ __forceinline__ RowFactors fold_row(float alpha, float wminus, bool pb) {
  return {pb ? alpha : 0.f, pb ? -0.f : alpha, wminus};
}

// A column's factors as staged: wplus, g1, g0, and ps as 1 or 0.
__device__ __forceinline__ float4 fold_col(float wplus, float gamma, float ps) {
  const bool p = ps > 0.f;
  return make_float4(wplus, p ? gamma : 0.f, p ? -0.f : gamma, p ? 1.f : 0.f);
}

__device__ __forceinline__ float entry_folded(const RowFactors& r, const float4& c) {
  return fminf(__fmaf_rn(r.a1, c.x, r.a0), __fmaf_rn(r.wm, c.y, c.z));
}

// The entry with the selects, for any inputs.
__device__ __forceinline__ float entry_exact(const RowFactors& r, bool pb, const float4& c) {
  const float lhs = pb ? __fmul_rn(r.a1, c.x) : r.a0;
  const float rhs = c.w > 0.f ? __fmul_rn(r.wm, c.y) : c.z;
  return min_nan(lhs, rhs);
}

// Grid (row tiles, scenarios). col_out: the column sums [S, A] when there is
// one tile, else the partials [S, tiles, A].
template <int kCols>
__global__ void __launch_bounds__(kThreads, 4)
merged_min_tiles_kernel(const float* __restrict__ alpha, const float* __restrict__ wplus,
                        const float* __restrict__ wminus, const float* __restrict__ gamma,
                        const float* __restrict__ pb, const float* __restrict__ ps,
                        float* __restrict__ row, float* __restrict__ col_out, int S, int A) {
  constexpr int kStep = 32 * kCols;  // columns j a step
  __shared__ float4 sh_col[kStep];
  __shared__ float sh_part[kWarps][kStep];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int i0 = tile * kTileRows + warp * kWarpRows;  // this warp's first row

  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const size_t base = static_cast<size_t>(s) * A;
    // The warp's rows, the same in every lane (the loads broadcast); bit r
    // of pbm is row r's pb.
    RowFactors rf[kWarpRows];
    unsigned pbm = 0;
    bool rows_ok = true;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const int i = i0 + r;
      rf[r] = {0.f, 0.f, 0.f};
      if (i < A) {
        const float a = alpha[base + i], wm = wminus[base + i];
        const bool p = pb[base + i] > 0.f;
        rows_ok &= plain_nonneg(a) & plain_nonneg(wm);
        rf[r] = fold_row(a, wm, p);
        pbm |= static_cast<unsigned>(p) << r;
      }
    }
    float racc[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) racc[r] = 0.f;

    for (int j0 = 0; j0 < A; j0 += kStep) {
      // Stage the step's columns (zero past A); any factor outside the
      // folded form's domain sends the whole step to the exact form.
      int bad = 0;
      if (threadIdx.x < kStep) {
        const int j = j0 + threadIdx.x;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < A) {
          const float wp = wplus[base + j], g = gamma[base + j];
          bad = !(plain_nonneg(wp) & plain_nonneg(g));
          c = fold_col(wp, g, ps[base + j]);
        }
        sh_col[threadIdx.x] = c;
      }
      const bool folded = !__syncthreads_or(bad) && rows_ok;
      // Each column's sum over the warp's rows goes to shared memory at once
      // (fewer live registers).
      float* part = sh_part[warp] + lane;
      if (folded) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float4 c = sh_col[lane + 32 * k];
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            const float m = entry_folded(rf[r], c);
            racc[r] = __fadd_rn(racc[r], m);
            acc = __fadd_rn(acc, m);
          }
          part[32 * k] = acc;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float4 c = sh_col[lane + 32 * k];
          const bool col_in = j0 + lane + 32 * k < A;
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            const float m = (col_in && i0 + r < A) ? entry_exact(rf[r], (pbm >> r) & 1u, c) : 0.f;
            racc[r] = __fadd_rn(racc[r], m);
            acc = __fadd_rn(acc, m);
          }
          part[32 * k] = acc;
        }
      }
      __syncthreads();
      // Column j of the tile: the warps in order.
      if (threadIdx.x < kStep && j0 + threadIdx.x < A) {
        float c = sh_part[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) c = __fadd_rn(c, sh_part[w][threadIdx.x]);
        col_out[(static_cast<size_t>(s) * n_tiles + tile) * A + j0 + threadIdx.x] = c;
      }
    }
    // Row i: the lanes by the xor-butterfly (the same in every lane).
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      float v = racc[r];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
      if (lane == 0 && i0 + r < A) row[base + i0 + r] = v;
    }
  }
}

// col[s, j]: the tiles' partials of column j added in tile order.
__global__ void __launch_bounds__(kReduceThreads)
merged_min_colsum_kernel(const float* __restrict__ part, float* __restrict__ col, int S,
                         int n_tiles, int A) {
  const int j = blockIdx.x * kReduceThreads + threadIdx.x;
  if (j >= A) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float* p = part + static_cast<size_t>(s) * n_tiles * A + j;
    float c = 0.f;
    for (int t = 0; t < n_tiles; ++t) c = __fadd_rn(c, p[static_cast<size_t>(t) * A]);
    col[static_cast<size_t>(s) * A + j] = c;
  }
}

// Columns a thread takes a step: 2 (steps of 64) where A fits one such step,
// else 8 (steps of 256).
int cols_per_thread(int A) { return A <= 64 ? 2 : 8; }

dim3 tiles_grid(int S, int A) {
  return dim3((A + kTileRows - 1) / kTileRows, S < kMaxGridY ? S : kMaxGridY);
}

}  // namespace

// Plain C entry points for ctypes.

// The launch at [S, A]: out = grid x, grid y, threads a block, static shared
// memory a block in bytes, columns a thread takes a step, steps a block.
extern "C" int merged_min_config(int S, int A, int* out) {
  if (S <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = cols_per_thread(A);
  cudaFuncAttributes attr;
  const cudaError_t err = cols == 2 ? cudaFuncGetAttributes(&attr, merged_min_tiles_kernel<2>)
                                    : cudaFuncGetAttributes(&attr, merged_min_tiles_kernel<8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tiles_grid(S, A);
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = cols;
  out[5] = (A + 32 * cols - 1) / (32 * cols);
  return 0;
}

// Launches the tiles kernel, and the column sums' kernel where there is more
// than one row tile, on `stream`; returns cudaGetLastError() (0 on success)
// and does not synchronise. partial: [S, tiles, A] float32 scratch, unused
// (may be null) with one tile.
extern "C" int merged_min_sums_launch(const float* alpha, const float* wplus,
                                      const float* wminus, const float* gamma,
                                      const float* pb, const float* ps,
                                      float* row, float* col, float* partial, int S, int A,
                                      cudaStream_t stream) {
  if (S <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = tiles_grid(S, A);
  float* col_out = grid.x > 1 ? partial : col;
  if (col_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (cols_per_thread(A) == 2)
    merged_min_tiles_kernel<2><<<grid, kThreads, 0, stream>>>(alpha, wplus, wminus, gamma,
                                                              pb, ps, row, col_out, S, A);
  else
    merged_min_tiles_kernel<8><<<grid, kThreads, 0, stream>>>(alpha, wplus, wminus, gamma,
                                                              pb, ps, row, col_out, S, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid.x == 1) return static_cast<int>(err);
  const dim3 rgrid((A + kReduceThreads - 1) / kReduceThreads, grid.y);
  merged_min_colsum_kernel<<<rgrid, kReduceThreads, 0, stream>>>(partial, col, S, grid.x, A);
  return static_cast<int>(cudaGetLastError());
}
