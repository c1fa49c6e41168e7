// Lane groups for the row kernels (gather_rows in detect_ops.cu, scatter_sum
// in sparse_conv.cu): a group of G lanes (G a power of two up to 32, so a
// group never straddles a warp) owns one table row at a time.  The lanes
// share the row's index through the warp's shuffles instead of each loading
// it, and copy or add the row's channels side by side.
#pragma once

#include <cuda_runtime.h>

namespace row_groups {

// The lanes of the calling thread's group, as a warp mask.
template <int G>
__device__ __forceinline__ unsigned mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// Lane `src`'s v, for every lane of the group.
template <int G>
__device__ __forceinline__ int shfl(int v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(mask<G>(), v, src, G);
  }
}

// Bit l set where the group's lane l has `pred`.
template <int G>
__device__ __forceinline__ unsigned ballot(bool pred) {
  if constexpr (G == 1) {
    return pred ? 1u : 0u;
  } else if constexpr (G == 32) {
    return __ballot_sync(0xffffffffu, pred);
  } else {
    return (__ballot_sync(mask<G>(), pred) >> ((threadIdx.x & 31) & ~(G - 1))) &
           ((1u << G) - 1u);
  }
}

// The group size for rows of C floats, copied as float4s when `vec`: one
// thread a row for C <= 8 (gather_rows then copies a warp's 32 rows
// together), else the least power of two (4 to 32) of lanes that covers the
// row's float4s (or floats) in one pass, a warp at most.
inline int size_for(int C, bool vec) {
  if (C <= 8) return 1;
  const int units = vec ? C / 4 : C;
  int g = 4;
  while (g < units && g < 32) g *= 2;
  return g;
}

}  // namespace row_groups
