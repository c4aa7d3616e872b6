// Device functions of the merged min matrix: the fused slot (kernel K7,
// slot_fused.cu) sums its entries with merged_min_entry and tile_sum; the
// merged min pass (kernel K1, merged_min.cu) shares min_nan only and sums
// the same entries in another order (each entry once, with the selects
// folded into its factors), so the two card paths agree to rounding, not
// bit for bit.
//
// One entry of the merged min matrix, for agents i (row) and j (column):
//
//   m[i, j] = min(alpha_i * (pb_i > 0 ? wplus_j : 1),
//                 (ps_j > 0 ? wminus_i : 1) * gamma_j)
//
// In K7, a row or column sum walks its A entries in tiles of
// kMergedMinTile, sums each tile with four interleaved partials combined as
// (p0 + p1) + (p2 + p3), and adds the tiles in order.

#pragma once

#include <cuda_runtime.h>

namespace slot_ops {

constexpr int kMergedMinTile = 256;

// torch.minimum semantics: a NaN on either side propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float merged_min_entry(float alpha_i, float wminus_i,
                                                  float pb_i, float wplus_j,
                                                  float gamma_j, float ps_j) {
  const float lhs = pb_i > 0.f ? alpha_i * wplus_j : alpha_i;
  const float rhs = ps_j > 0.f ? wminus_i * gamma_j : gamma_j;
  return min_nan(lhs, rhs);
}

// Sum of entry(t) over t < n in the fixed order above.
template <typename Entry>
__device__ __forceinline__ float tile_sum(int n, Entry entry) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
  int t = 0;
  for (; t + 4 <= n; t += 4) {
    p0 += entry(t);
    p1 += entry(t + 1);
    p2 += entry(t + 2);
    p3 += entry(t + 3);
  }
  for (; t < n; ++t) p0 += entry(t);
  return (p0 + p1) + (p2 + p3);
}

}  // namespace slot_ops
