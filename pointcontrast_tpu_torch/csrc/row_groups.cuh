// Lane groups for the row kernels (gather_rows and scatter_add_rows in
// detect_ops.cu; gather_sum, scatter_sum and scatter_parent in
// sparse_conv.cu): a group of G lanes (G a power of two up to 32, so a
// group never straddles a warp) owns one table row at a time, or, in
// scatter_add_rows, a run of consecutive rows whose repeats of one index it
// merges in registers before its atomics.  The lanes share the rows' indices through the
// warp's shuffles instead of each loading them, and copy or add the rows'
// channels side by side.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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
// thread a row for C <= 8 (gather_rows and scatter_add_rows then move a
// warp's 32 rows together), else the least power of two (4 to 32) of lanes
// that covers the row's float4s (or floats) in one pass, a warp at most.
inline int size_for(int C, bool vec) {
  if (C <= 8) return 1;
  const int units = vec ? C / 4 : C;
  int g = 4;
  while (g < units && g < 32) g *= 2;
  return g;
}

// f(std::integral_constant<int, G>, std::bool_constant<VEC>) for the group
// size g (1, 4, 8, 16 or 32, as size_for gives) and `vec`: the one place the
// row kernels' C entries turn those runtime values into template arguments.
template <class F>
void dispatch(int g, bool vec, F&& f) {
  auto with = [&](auto G) {
    if (vec) {
      f(G, std::true_type());
    } else {
      f(G, std::false_type());
    }
  };
  switch (g) {
    case 1: return with(std::integral_constant<int, 1>());
    case 4: return with(std::integral_constant<int, 4>());
    case 8: return with(std::integral_constant<int, 8>());
    case 16: return with(std::integral_constant<int, 16>());
    default: return with(std::integral_constant<int, 32>());
  }
}

}  // namespace row_groups
