// Hand-written Hopper (sm_90a) kernels for the sparse convolutions and the
// per-sample pooling: the same-level 3x3x3 conv, the k2s2 down conv, the
// k2s2 transposed conv, the k3s2 down conv and the flat-map conv, forward
// and backward, the segment sum under global pooling, the gather-sum under
// the k2s2 sum / average pooling and unpooling, with its adjoint, and the
// same-level conv of the brick layout, forward and weight gradient (see
// pointcontrast_tpu_torch/sparse/kernels.py for the Python wrappers, their
// plain-torch twins and which JAX op each one replaces).
//
// Layout (chunked): a feature table is [B, S, C] row-major f32 with each
// chunk's last row a pad row whose features are exactly zero.  A gather map
// is [K, B, S_out] int32 holding frame-LOCAL row indices, already checked to
// lie inside their chunk on the host (PairBatch.to).
//
// A gathered operand names its rows in one of two ways:
//   map != nullptr : row(j, b, s) = map[taps.idx[j]][b][s]
//   map == nullptr : row(j, b, s) = j * tap_stride + s   (stacked table)
//
// The two gather GEMMs, gather_gemm (a) and gather_wgrad (b), take 65-84%
// of a sparse-conv step's device time.  Both are bound by f32 operations on
// the (row, tap) pairs whose gathered rows are live, and a map sends every
// missing neighbour to the chunk's pad row, whose features and cotangent
// are zero: 48-82% of the pairs of a pretraining batch.  So the caller names
// that row (`skip`), and gather_gemm skips (16-row fragment, tap) pairs with
// no live row while gather_wgrad compacts its live pairs and computes only
// those; both stage rows and weights with cp.async in a 3-stage ring, one
// barrier a step, and fit their tiles to the channels (their notes below
// give the designs).  The f32 forms stay on the SIMT pipes: the port's
// twins, CPU tests and step checks rest on f32 products, TF32 keeps ~3
// digits and 3xTF32 on mma.sync costs about what SIMT f32 does; their bf16
// forms run the same pipelines with the products on the tensor cores
// (mma.sync bf16 -> f32, below).  parent_gemm (c) and its bf16 form run
// the same pipelines over the fine rows in the pyramid's up order, one
// offset's weights a step, and the brick layout's brick_gemm (i) and brick_wgrad
// (j) run the two pipelines over a level's occupied slots, tiled in its
// slot order (occupied first), their sources from the plan's slot table.
// scatter_gemm (e), K4's and the flat conv's dF, runs gather_gemm's
// pipeline over the cotangent rows in the map's live order, computing
// each tile's live rows a tap (compacted), and adds each tap's products
// with float4 atomics.  gather_sum and its adjoint scatter_sum (the pooling ops,
// and JAX's jnp.take and its autodiff in the brick layout's placement and
// up gathers, pointcontrast_tpu/sparse/brick.py:465, :491) only move rows,
// so HBM bytes bound them.  Both give each row a lane group
// (row_groups.cuh) that reads the row's indices before its data.
// gather_sum adds the kept rows in tap order (bit-equal to the twin) with
// float4 loads, and at one tap is a row copy.  scatter_sum adds 16 bytes an
// atomic and leaves out every destination at or past a bound, the
// source's pad rows, because each map sends its missing sources to one pad
// row: on a brick table (slot 0 of the pad brick) 17k adds of a batch
// landed on one row and ran one after another.  A new map kind must check
// where its pad sources point.  scatter_parent, JAX K3's backward scatter
// (the port's K3 gathers through the down map; this is its parent design,
// which no op runs), is a row store in the same lane groups: it leaves out the coarse pad slot,
// the one destination many fine rows name, and stores every other row
// once, with no atomic.  Each C entry returns cudaGetLastError() of its
// launch.
//
// bf16 forms (JAX's bf16 mode, pointcontrast_tpu/sparse/ops.py:376-414,
// :650-684, :768-840: bf16 x bf16 products with f32 sums, one rounding;
// the flat _conv_core, :74-118, rounds each tap's product first):
// gather_gemm_mma_kernel (gather_gemm's bf16 form, ROUND: each tap
// rounded), parent_gemm_mma_kernel (parent_gemm's, TRANS_W: K2's dF on the
// untransposed W), and gather_wgrad and scatter_parent templated on
// their element types, the f32 instances as they were.  A bf16 form stages
// bf16 rows and weights through the same cp.async ring (16-byte copies of
// 8 values where the width is a multiple of 8 and the table aligned, plain
// 2-byte loads otherwise: the stem's Cin = 3 rows are only 2-byte
// aligned).  gather_gemm_bf16, parent_gemm_bf16 and gather_wgrad with a
// bf16 A and G run their products on the tensor cores (mma.sync.m16n8k16
// bf16 -> f32 on ldmatrix fragments of the same live- or up-ordered tiles:
// their notes below); gather_wgrad with an f32 G (the dW of K3's parent
// design, against its f32 scatter dy: tensor cores cannot take an f32
// operand exactly) widens
// the values in registers (exact) and runs the f32 FMAs on the SIMT pipes.
// An output is rounded to bf16 once, after its f32 sum (split partials
// stay f32 in ws; the last block rounds their sum); gather_wgrad writes
// f32; scatter_parent widens a bf16 cotangent into the f32 dy.  The SIMT
// forms are bound as the f32 forms are (f32 issue on the live pairs;
// scatter_parent HBM bytes); the tensor-core forms by the gathered rows'
// bytes and the pipeline's latency.  scatter_gemm's bf16 form
// (scatter_gemm_mma_kernel, K4's and the flat conv's dF) runs its f32
// kernel's pipeline with the products on the tensor cores and adds them
// with f32 atomics into an f32 dF, rounded once by the wrapper.  The pools'
// bf16 forms (gather_sum_bf16_kernel, scatter_store_bf16_kernel,
// scatter_sum_inv_bf16_kernel) keep XLA's rounding after every bf16 add,
// in its order, with no atomics (their notes below).  The brick conv's bf16
// forms (pointcontrast_tpu/sparse/brick.py:360-440 in bf16) run on the
// tensor cores: brick_gemm_mma_kernel runs the f32 kernel's slot-row tiles
// and rounds each output once; brick_wgrad_mma_kernel compacts each tap's
// live pairs brick by brick, and at the stem's narrow Cin
// brick_wgrad_mma_dense_kernel runs one dense product a neighbour row over
// whole bricks (JAX's own block product); both sum into an f32 dW that the
// wrapper rounds once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

#include "row_groups.cuh"

#define MAX_TAPS 32
// brick_wgrad_bf16 takes its brick form up to this Cin (8 Cin <= 64 rows of
// a tensor-core tile; sparse/kernels.py BRICK_NARROW)
#define BRICK_NARROW 8

struct TapList {
  int idx[MAX_TAPS];
};

namespace {

__device__ __forceinline__ int row_of(const int* __restrict__ map,
                                      const TapList& taps, int tap_stride,
                                      int j, int b, int s, int B, int S) {
  if (map != nullptr) {
    return __ldg(map + ((int64_t)taps.idx[j] * B + b) * S + s);
  }
  return j * tap_stride + s;
}

// row_of in 32-bit arithmetic, for maps of fewer than 2^31 entries (the
// row kernels' wrappers check that)
__device__ __forceinline__ int row_of32(const int* __restrict__ map,
                                        const TapList& taps, int tap_stride,
                                        int j, int b, int s, int B, int S) {
  if (map != nullptr) {
    return __ldg(map + (taps.idx[j] * B + b) * S + s);
  }
  return j * tap_stride + s;
}

// 16- and 4-byte asynchronous copies from global to shared memory (sm_80
// on), zero-filled where `full` is false: the source is then not read.  The
// 16-byte copies bypass L1 (.cg), the 4-byte ones cannot (.ca).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Store the 4 columns n..n+3 of a row (float4 when `vec`: C % 4 == 0),
// those at or past C left out.
__device__ __forceinline__ void store4(float* row, int n, int C, bool vec, const float4& v) {
  if (vec) {
    if (n < C) *reinterpret_cast<float4*>(row + n) = v;
    return;
  }
  if (n < C) row[n] = v.x;
  if (n + 1 < C) row[n + 1] = v.y;
  if (n + 2 < C) row[n + 2] = v.z;
  if (n + 3 < C) row[n + 3] = v.w;
}

// bf16 forms: a row of n bf16 values, and 4 of them to or from float4.
// bf16 -> f32 is exact (the 16 bits move to the top of the word);
// f32 -> bf16 rounds to nearest even (__float2bfloat16_rn), once per output.
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// 4 consecutive values as f32: one 16-byte load of f32, one 8-byte load of
// bf16 (shared or global memory, 16- or 8-byte aligned).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

__device__ __forceinline__ void store4(bf16* row, int n, int C, bool vec, const float4& v) {
  if (vec) {  // C % 4 == 0: 8-byte stores
    if (n < C) {
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(row + n);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    return;
  }
  if (n < C) row[n] = __float2bfloat16_rn(v.x);
  if (n + 1 < C) row[n + 1] = __float2bfloat16_rn(v.y);
  if (n + 2 < C) row[n + 2] = __float2bfloat16_rn(v.z);
  if (n + 3 < C) row[n + 3] = __float2bfloat16_rn(v.w);
}

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16((unsigned short)0); }

__device__ __forceinline__ float4 load4_cg(const float* row, int n, int C, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const float4*>(row + n));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n < C) v.x = __ldcg(row + n);
  if (n + 1 < C) v.y = __ldcg(row + n + 1);
  if (n + 2 < C) v.z = __ldcg(row + n + 2);
  if (n + 3 < C) v.w = __ldcg(row + n + 3);
  return v;
}

// (a) gather_gemm: out[b,s,:] = [X[b,s,:] . Wc] + sum_j X[b, row(j,b,s), :] . W[j],
// every product whose gathered row is `skip` (or outside [0, S_in)) left
// out; the centre tap Wc reads row s.  JAX K1 _conv_chunk_fused (forward and
// dF), K2 _conv_chunk_down2 and K4 _conv_chunk_down_fused (forward), K3
// _conv_tr_chunk's dF (through the level's down map), the flat _conv_core /
// _conv_sym at B = 1.  What bounds it: 2 Cin Cout f32 operations per (row, tap) pair
// whose gathered row is live (f32 SIMT: 67 TFLOP/s on an H100), so the
// design spends FMAs on live pairs only, as far as tiles allow, and keeps
// the FMA pipes fed:
//  - a block owns BM = 128 output rows of one chunk and a Cout tile of
//    32 Q channels (Q = 1..3: 32, 64 or 96, fitted to Cout); 8 warps,
//    warp w the 16-row fragment [16w, 16w + 16), each thread 4 rows x 4Q
//    columns (tx*4 + 32q) in registers;
//  - the tile's rows are 128 consecutive entries of `order` (the map's
//    live order, built with the pyramid: each chunk's rows sorted by the
//    set of taps at which they gather a live row, topology.live_order) or,
//    without it, 128 consecutive rows; either way
//    each output row is written once, so the order changes no result.  It
//    matters at the large levels, whose rows lie in first-occurrence order:
//    there nearly every 16 consecutive rows hold a live row at every tap
//    (chip_smoke.py prints the computed share with and without the order);
//  - prologue: the block reads its rows' indices for all its taps into
//    shared memory once and a ballot per 32 rows marks the live ones.  A tap
//    with no live row in the tile is dropped from the block's step list; a
//    warp whose fragment has no live row at a tap skips that tap's FMAs;
//  - main loop over (live tap, 32-deep Cin chunk) steps through a 3-stage
//    ring in dynamic shared memory (2 blocks an SM): the gathered rows
//    arrive by 16-byte cp.async (4-byte where Cin % 4 != 0 or X is
//    unaligned), zero-filled for skipped rows and past Cin, and the tap's
//    weight tile by cp.async too;
//    one wait + __syncthreads a step, the copies of step i + 2 in flight
//    while step i computes.  Row tiles are stored with the 16-byte chunk
//    index XOR (row / 4) % 8, so a warp's 4 distinct rows read 4 banks
//    groups apart;
//  - few blocks (deep levels): the wrapper splits the taps over `splits`
//    blocks per tile; each writes its partial tile to `ws` [splits, B,
//    S_out, Cout], and the block that takes the last of the tile's integer
//    tickets adds the partials in split order (no float atomics: the result
//    is the same from run to run).
namespace gg {
constexpr int BM = 128;      // output rows a block
constexpr int BK = 32;       // Cin depth of a pipeline step
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TM = 4;        // rows a thread: 4 * (tid / 8) + i
constexpr int BALLOTS = BM / 32;
static_assert((THREADS / 8) * TM == BM, "8 threads a row group");

// Q of a Cout: the Cout tile is 32 Q channels, Q in 1..3 (at Q = 4 the
// 64 accumulators spill past 128 registers), the one that pads Cout least,
// the larger on a tie: 32 -> 1, 64, 128, 256 -> 2, 96, 192, 384 -> 3.
inline int q_for(int Cout) {
  int best = 1;
  for (int q = 2; q <= 3; ++q) {
    const int pad = (Cout + 32 * q - 1) / (32 * q) * 32 * q;
    if (pad <= (Cout + 32 * best - 1) / (32 * best) * 32 * best) best = q;
  }
  return best;
}

// element size: 4 (f32) or 2 (the tensor-core forms: the tiles hold bf16,
// half the bytes)
inline size_t smem_bytes(int Q, int per, int esize = 4) {
  return (size_t)esize * STAGES * (BM * BK + BK * 32 * Q) +
         sizeof(int) * (per * BM + per * BALLOTS + per + 1 + BM);
}
}  // namespace gg

// One step's products: the thread's 4 rows (shared-memory row tile `as`,
// whose rows are 8 16-byte chunks, chunk index XOR `sw`) times its 4Q
// columns of the weight tile `bs`, over the 32-deep chunk, in f32.  The
// zero-filled depth past a ragged Cin is multiplied too, so the unrolled
// loop holds no branch.
template <int Q>
__device__ __forceinline__ void gg_fma(float4 (&acc)[gg::TM][Q], const float* as,
                                       const float* bs, int sw) {
  constexpr int BK = gg::BK, BN = 32 * Q;
#pragma unroll
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float4 a[gg::TM];
#pragma unroll
    for (int i = 0; i < gg::TM; ++i) a[i] = ld4(as + i * BK + ((k4 ^ sw) << 2));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 w = ld4(bs + (4 * k4 + kk) * BN + 32 * q);
#pragma unroll
        for (int i = 0; i < gg::TM; ++i) fma4(acc[i][q], lane_of(a[i], kk), w);
      }
    }
  }
}

// The 16-byte chunk that holds chunk c of row r in a bf16 tile of CPR
// chunks a row (a multiple of 4) read by ldmatrix, whose 8 row addresses at
// one chunk must land in 8 distinct 16-byte bank groups: rows of 8 chunks
// or more (128 bytes: every row starts in bank group 0), c XOR r % 8; rows
// of 4 or 12 chunks (rows r and r + 2 start in one bank group), c XOR
// (r / 2) % 4.
template <int CPR>
__device__ __forceinline__ int mma_chunk(int r, int c) {
  static_assert(CPR % 4 == 0, "whole 64-byte spans a row");
  return CPR % 8 == 0 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// Stage a step's row tile: row m of `as` [ROWS][BK] is Xb's row row(m) at
// depth k0 (zero-filled where row(m) < 0 and past Cin), by 16-byte cp.async
// (4-byte where Cin % 4 != 0 or Xb is unaligned), the 16-byte chunks of row
// m at index XOR (m / 4) % 8.  scatter_gemm stages its W[j]^T tile this way
// too, with ROWS = 32 Q rows of W[j].  bf16 rows (the tensor-core forms):
// 16-byte cp.async of 8 values where Cin % 8 == 0 and Xb is aligned, the
// chunk at mma_chunk<4> for ldmatrix; else plain 2-byte loads and stores
// (a row of odd Cin, such as the stem's Cin = 3, is only 2-byte aligned),
// finished before the step's barrier like the copies.
template <int ROWS = gg::BM, typename T, typename RowOf>
__device__ __forceinline__ void gg_load_rows(T* as, const T* Xb, RowOf row, int k0,
                                             int Cin, int vec_x, int tid) {
  constexpr int BM = ROWS, BK = gg::BK, THREADS = gg::THREADS;
  static_assert(BM * BK % ((is_bf16<T> ? 8 : 4) * THREADS) == 0,
                "whole 16-byte chunks a thread");
  if constexpr (is_bf16<T>) {
    auto chunk = [](int m, int c) { return mma_chunk<BK / 8>(m, c); };
    if (vec_x) {
#pragma unroll
      for (int u = 0; u < BM * BK / 8 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int m = e >> 2, c = e & 3;
        const int r = row(m);
        const bool ok = r >= 0 && k0 + 8 * c < Cin;
        cp_async16(as + m * BK + (chunk(m, c) << 3),
                   ok ? Xb + (int64_t)r * Cin + k0 + 8 * c : Xb, ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < BM * BK / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int m = e >> 5, k = e & 31;
        const int r = row(m);
        const bool ok = r >= 0 && k0 + k < Cin;
        as[m * BK + (chunk(m, k >> 3) << 3) + (k & 7)] =
            ok ? Xb[(int64_t)r * Cin + k0 + k] : bf16_zero();
      }
    }
    return;
  }
  if (vec_x) {
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int m = e >> 3, c = e & 7;
      const int r = row(m);
      const bool ok = r >= 0 && k0 + 4 * c < Cin;
      cp_async16(as + m * BK + ((c ^ ((m >> 2) & 7)) << 2),
                 ok ? Xb + (int64_t)r * Cin + k0 + 4 * c : Xb, ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < BM * BK / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int m = e >> 5, k = e & 31;
      const int r = row(m);
      const bool ok = r >= 0 && k0 + k < Cin;
      cp_async4(as + m * BK + ((((k >> 2) ^ ((m >> 2) & 7))) << 2) + (k & 3),
                ok ? Xb + (int64_t)r * Cin + k0 + k : Xb, ok);
    }
  }
}

// Stage a step's weight tile: `bs` [BK][32 Q] is Wt [Cin][Cout] at (k0, n0),
// zero-filled past Cin and Cout, by 16-byte cp.async (4-byte unless vec_w;
// bf16, the tensor-core forms: 16-byte copies of 8 values where vec_w,
// else plain 2-byte loads, row kk's chunks at mma_chunk, for ldmatrix).
template <int Q, typename T = float>
__device__ __forceinline__ void gg_load_w(T* bs, const T* Wt, int k0, int n0,
                                          int Cin, int Cout, int vec_w, int tid) {
  constexpr int BN = 32 * Q, THREADS = gg::THREADS;
  if constexpr (is_bf16<T>) {
    auto chunk = [](int kk, int c) { return mma_chunk<BN / 8>(kk, c); };
    if (vec_w) {
      for (int e = tid; e < gg::BK * BN / 8; e += THREADS) {
        const int kk = e / (BN / 8), c = e % (BN / 8);
        const int n = n0 + 8 * c;
        const bool ok = k0 + kk < Cin && n < Cout;
        cp_async16(bs + kk * BN + (chunk(kk, c) << 3),
                   ok ? Wt + (int64_t)(k0 + kk) * Cout + n : Wt, ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < 4 * Q; ++u) {
        const int e = tid + u * THREADS;
        const int kk = e / BN, c = e % BN;
        const int n = n0 + c;
        const bool ok = k0 + kk < Cin && n < Cout;
        bs[kk * BN + (chunk(kk, c >> 3) << 3) + (c & 7)] =
            ok ? Wt[(int64_t)(k0 + kk) * Cout + n] : bf16_zero();
      }
    }
    return;
  }
  if (vec_w) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {  // BK * BN / 4 / THREADS
      const int e = tid + u * THREADS;
      const int kk = e / (BN / 4), c = e % (BN / 4);
      const int n = n0 + 4 * c;
      const bool ok = k0 + kk < Cin && n < Cout;
      cp_async16(bs + kk * BN + 4 * c, ok ? Wt + (int64_t)(k0 + kk) * Cout + n : Wt, ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 4 * Q; ++u) {
      const int e = tid + u * THREADS;
      const int kk = e / BN, c = e % BN;
      const int n = n0 + c;
      const bool ok = k0 + kk < Cin && n < Cout;
      cp_async4(bs + kk * BN + c, ok ? Wt + (int64_t)(k0 + kk) * Cout + n : Wt, ok);
    }
  }
}

// The gather GEMMs' prologue (gather_gemm_kernel, gather_gemm_mma_kernel):
// the tile's output rows `srow` [BM] (through `order` where given, -1 past
// S_out), every row of taps t_lo .. t_lo + nt - 1 of this split `rows`
// [nt][BM] (tap G: the centre, the row itself; -1 where skipped or out of
// the table), a ballot a 32 rows of which are live `ball` [nt][BALLOTS],
// and the taps with a live row `live` (their count, then their indices).
// Ends with a __syncthreads.
__device__ __forceinline__ void gg_prologue(int* srow, int* rows, unsigned* ball, int* live,
                                            const int* __restrict__ map, const TapList& taps,
                                            int tap_stride, int G,
                                            const int* __restrict__ order, int b, int s0,
                                            int t_lo, int nt, int B, int S_in, int S_out,
                                            int skip) {
  constexpr int BM = gg::BM, THREADS = gg::THREADS, BALLOTS = gg::BALLOTS;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < BM) {
    const int s = s0 + tid;
    srow[tid] = s >= S_out ? -1 : order != nullptr ? __ldg(order + (int64_t)b * S_out + s) : s;
  }
  __syncthreads();
  for (int e = tid; e < nt * BM; e += THREADS) {  // whole warps: nt * BM % 32 == 0
    const int j = t_lo + e / BM, s = srow[e % BM];
    int r = -1;
    if (s >= 0) {
      r = j == G ? s : row_of(map, taps, tap_stride, j, b, s, B, S_out);
      if (r == skip || r < 0 || r >= S_in) r = -1;
    }
    rows[e] = r;
    const unsigned bits = __ballot_sync(0xffffffffu, r >= 0);
    if (lane == 0) ball[e >> 5] = bits;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < nt; ++t) {
      unsigned any = 0;
#pragma unroll
      for (int c = 0; c < BALLOTS; ++c) any |= ball[t * BALLOTS + c];
      if (any) live[1 + n++] = t;
    }
    live[0] = n;
  }
  __syncthreads();
}

template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
gather_gemm_kernel(const float* __restrict__ X, const int* __restrict__ map,
                   const __grid_constant__ TapList taps, int tap_stride, int G,
                   const float* __restrict__ W, const float* __restrict__ Wc,
                   const int* __restrict__ order, float* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets, int splits, int B,
                   int S_in, int S_out, int Cin, int Cout, int skip, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES, THREADS = gg::THREADS;
  constexpr int TM = gg::TM, BALLOTS = gg::BALLOTS, BN = 32 * Q;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                   // [STAGES][BM][BK]
  float* Bs = As + STAGES * BM * BK;                  // [STAGES][BK][BN]
  const int ntap = G + (Wc != nullptr ? 1 : 0);       // tap G: the centre
  const int per = (ntap + splits - 1) / splits;
  int* rows = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [per][BM]
  unsigned* ball = reinterpret_cast<unsigned*>(rows + per * BM);  // [per][BALLOTS]
  int* live = reinterpret_cast<int*>(ball + per * BALLOTS);  // count, then taps
  int* srow = live + per + 1;  // [BM] the tile's output rows, -1 past S_out

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int t_lo = sp * ntap / splits, nt = (sp + 1) * ntap / splits - t_lo;
  const float* Xb = X + (int64_t)b * S_in * Cin;

  gg_prologue(srow, rows, ball, live, map, taps, tap_stride, G, order, b, s0, t_lo, nt, B,
              S_in, S_out, skip);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = live[0] * kchunks;

  auto load = [&](int step, int buf) {
    const int t = live[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    const int* rt = rows + t * BM;
    gg_load_rows(As + buf * BM * BK, Xb, [&](int m) { return rt[m]; }, k0, Cin, vec_x, tid);
    const int j = t_lo + t;
    gg_load_w<Q>(Bs + buf * BK * BN, j == G ? Wc : W + (int64_t)j * Cin * Cout, k0, n0, Cin,
                    Cout, vec_w, tid);
  };

  float4 acc[TM][Q];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  const int sw = ty & 7;  // the swizzle of this thread's rows: (4 ty + i) / 4 % 8
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    const int t = live[1 + step / kchunks];
    if (((ball[t * BALLOTS + (warp >> 1)] >> (16 * (warp & 1))) & 0xffffu) == 0)
      continue;  // this warp's 16 rows gather nothing at this tap
    gg_fma<Q>(acc, As + (step % STAGES) * BM * BK + 4 * ty * BK,
                 Bs + (step % STAGES) * BK * BN + 4 * tx, sw);
  }
  cp_async_wait<0>();

  // one split: the sums; several: partials in ws
  const bool vec_o = Cout % 4 == 0;
  float* dst = splits == 1 ? out : ws + (int64_t)sp * B * S_out * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = srow[4 * ty + i];
    if (s < 0) continue;
    float* row = dst + ((int64_t)b * S_out + s) * Cout;
#pragma unroll
    for (int q = 0; q < Q; ++q) store4(row, n0 + 4 * tx + 32 * q, Cout, vec_o, acc[i][q]);
  }
  if (splits == 1) return;
  // the tile's last block adds the splits' partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    live[0] = atomicAdd(tickets + tile, 1) == splits - 1;
  }
  __syncthreads();
  if (!live[0]) return;
  __threadfence();
  const int64_t plane = (int64_t)B * S_out * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = srow[4 * ty + i];
    if (s < 0) continue;
    const int64_t off = ((int64_t)b * S_out + s) * Cout;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = n0 + 4 * tx + 32 * q;
      if (n >= Cout) continue;
      float4 v = load4_cg(ws + off, n, Cout, vec_o);
      for (int p = 1; p < splits; ++p) add4(v, load4_cg(ws + p * plane + off, n, Cout, vec_o));
      store4(out + off, n, Cout, vec_o, v);
    }
  }
}

// gather_gemm_bf16 on the tensor cores (the bf16 form of (a)): the f32
// kernel's prologue, live orders, 16-row fragment skip, 3-stage cp.async
// ring and tap splits, with the products on mma.sync.m16n8k16 bf16 -> f32.
// What bounds it: the bf16 tensor cores' 989 TFLOP/s lie far above what
// the gathers feed them (a 32 x 32 conv does ~32 operations a byte of
// gathered row, the card's balance point ~295), so the gathered rows'
// bytes and the pipeline's latency set its pace.  The design:
//  - warp w computes its 16-row fragment [16 w, 16 w + 16) x the block's
//    Cout tile BN = 32 Q (Q = 1..4: registers hold BN / 2 f32 sums a
//    thread, so the tile grows to 128 and wide layers gather each row
//    fewer times; 64 under ROUND, which keeps a second set), two k16
//    steps a 32-deep chunk, the second left out past Cin (the stem);
//  - A fragments by ldmatrix.x4 from the row tile, B fragments by
//    ldmatrix.x4.trans from the [BK][BN] weight tile, both staged with
//    mma_chunk's swizzle (8 row addresses of one ldmatrix phase in 8 bank
//    groups); the Cin = 3 stem's rows by 2-byte loads, as the SIMT form;
//  - ROUND (the voxel layout's forward, JAX's flat _conv_core): at a live
//    tap's last chunk each thread rounds its tap sums to bf16, widens them
//    and adds them into the second set, the taps in list order, the
//    centre last;
//  - epilogue: one split rounds each sum once to bf16 and stages the tile
//    in shared memory (rows padded by 16 bytes: the fragments' 4-byte
//    stores hit 32 banks), so each output row leaves as 16-byte stores;
//    several splits store f32 partials to ws, and the tile's last block (an
//    integer ticket) adds them in split order and rounds once;
//  - F32 (a conv's taps past the 32 a launch takes, sparse/ops.py: K4's
//    flat forward with ROUND, K1's forward and dF in either mode): the same
//    sums left in f32, unrounded, so that the caller adds its launches'
//    sums in f32 and rounds once, as JAX's one f32 accumulator over every
//    tap does.
namespace gm {
constexpr int PAD = 8;  // bf16 a staged output row past its BN

// Q of a Cout: the Cout tile 32 Q that pads Cout least, the larger on a
// tie, up to 4 (ROUND: 2): 32 -> 1, 64 -> 2, 96 -> 3, 128, 256 -> 4.
inline int q_for(int Cout, bool round) {
  int best = 1;
  for (int q = 2; q <= (round ? 2 : 4); ++q) {
    const int pad = (Cout + 32 * q - 1) / (32 * q) * 32 * q;
    if (pad <= (Cout + 32 * best - 1) / (32 * best) * 32 * best) best = q;
  }
  return best;
}
}  // namespace gm

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a . b: one m16n8k16 product, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One step's products for warp w: its 16 rows of the row tile `as`
// [BM][BK] times the weight tile `bs` [BK][BN], `depth` of the 32 depths
// live (a k16 step wholly past Cin is left out), into acc[n]: the
// m16n8 fragment of columns [8 n, 8 n + 8).
template <int Q>
__device__ __forceinline__ void gm_mma(float (&acc)[4 * Q][4], const bf16* as, const bf16* bs,
                                       int warp, int lane, int depth) {
  constexpr int BK = gg::BK, BN = 32 * Q;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if (16 * kk >= depth) break;
    unsigned a[4];  // rows 16 w + lane % 16, depths 16 kk + 8 (lane / 16) ..
    const int m = 16 * warp + (lane & 15);
    ldsm_x4(a, as + m * BK + (mma_chunk<BK / 8>(m, 2 * kk + (lane >> 4)) << 3));
    const int k = 16 * kk + (lane & 15);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {  // columns [16 j, 16 j + 16): two fragments
      unsigned b[4];
      ldsm_x4_t(b, bs + k * BN + (mma_chunk<BN / 8>(k, 2 * j + (lane >> 4)) << 3));
      mma_bf16(acc[2 * j], a, b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// W[j]^T's tile for one step (scatter_gemm_mma_kernel; parent_gemm_mma_kernel
// under TRANS_W): `bs` [BN][BK], row n W[j]'s row n0 + n at Cout depths
// k0.., zero-filled past Cin and Cout.  W[j]^T is never transposed in
// memory: its rows are the m16n8k16 B operand's column-major form.
template <int Q>
__device__ __forceinline__ void sg_load_wt(bf16* bs, const bf16* Wj, int n0, int k0, int Cin,
                                           int Cout, int vec_w, int tid) {
  constexpr int BN = 32 * Q, BK = gg::BK, THREADS = gg::THREADS;
  if (vec_w) {  // Cout % 8 == 0, W 16-byte aligned: 16-byte copies of 8 depths
    for (int e = tid; e < BN * BK / 8; e += THREADS) {
      const int n = e >> 2, c = e & 3;
      const bool ok = n0 + n < Cin && k0 + 8 * c < Cout;
      cp_async16(bs + n * BK + (mma_chunk<BK / 8>(n, c) << 3),
                 ok ? Wj + (int64_t)(n0 + n) * Cout + k0 + 8 * c : Wj, ok);
    }
  } else {
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int n = e >> 5, k = e & 31;
      const bool ok = n0 + n < Cin && k0 + k < Cout;
      bs[n * BK + (mma_chunk<BK / 8>(n, k >> 3) << 3) + (k & 7)] =
          ok ? Wj[(int64_t)(n0 + n) * Cout + k0 + k] : bf16_zero();
    }
  }
}

// One step's products for warp w: its 16 rows of `as` [BM][BK] (compacted
// in scatter_gemm) times W[j]^T, staged as `bs` [BN][BK] (row n: W[j]'s row n0 + n), `depth`
// of the 32 Cout depths live, into acc[n]: the m16n8 fragment of Cin
// columns [8 n, 8 n + 8).
template <int Q>
__device__ __forceinline__ void sg_mma_bf16(float (&acc)[4 * Q][4], const bf16* as,
                                            const bf16* bs, int warp, int lane, int depth) {
  constexpr int BK = gg::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if (16 * kk >= depth) break;
    unsigned a[4];  // rows 16 w + lane % 16, depths 16 kk + 8 (lane / 16) ..
    const int m = 16 * warp + (lane & 15);
    ldsm_x4(a, as + m * BK + (mma_chunk<BK / 8>(m, 2 * kk + (lane >> 4)) << 3));
#pragma unroll
    for (int j = 0; j < 2 * Q; ++j) {  // columns [16 j, 16 j + 16): two fragments
      unsigned b[4];  // matrices (columns + 0 | + 8) x (depths + 0 | + 8)
      const int n = 16 * j + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(b, bs + n * BK + (mma_chunk<BK / 8>(n, 2 * kk + ((lane >> 3) & 1)) << 3));
      mma_bf16(acc[2 * j], a, b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// grid (ceil(S_out / BM), ceil(Cout / 32 Q), B * splits)
template <int Q, bool ROUND, bool F32 = false>
__global__ void __launch_bounds__(gg::THREADS, 2)
gather_gemm_mma_kernel(const bf16* __restrict__ X, const int* __restrict__ map,
                       const __grid_constant__ TapList taps, int tap_stride, int G,
                       const bf16* __restrict__ W, const bf16* __restrict__ Wc,
                       const int* __restrict__ order,
                       std::conditional_t<F32, float, bf16>* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ tickets, int splits, int B,
                       int S_in, int S_out, int Cin, int Cout, int skip, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES, THREADS = gg::THREADS;
  constexpr int BALLOTS = gg::BALLOTS, BN = 32 * Q, NF = 4 * Q, LDC = BN + gm::PAD;
  extern __shared__ __align__(16) float smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);           // [STAGES][BM][BK]
  bf16* Bs = As + STAGES * BM * BK;                    // [STAGES][BK][BN]
  const int ntap = G + (Wc != nullptr ? 1 : 0);        // tap G: the centre
  const int per = (ntap + splits - 1) / splits;
  int* rows = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [per][BM]
  unsigned* ball = reinterpret_cast<unsigned*>(rows + per * BM);  // [per][BALLOTS]
  int* live = reinterpret_cast<int*>(ball + per * BALLOTS);  // count, then taps
  int* srow = live + per + 1;  // [BM] the tile's output rows, -1 past S_out

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int t_lo = sp * ntap / splits, nt = (sp + 1) * ntap / splits - t_lo;
  const bf16* Xb = X + (int64_t)b * S_in * Cin;

  gg_prologue(srow, rows, ball, live, map, taps, tap_stride, G, order, b, s0, t_lo, nt, B,
              S_in, S_out, skip);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = live[0] * kchunks;

  auto load = [&](int step, int buf) {
    const int t = live[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    const int* rt = rows + t * BM;
    gg_load_rows<BM>(As + buf * BM * BK, Xb, [&](int m) { return rt[m]; }, k0, Cin,
                           vec_x, tid);
    const int j = t_lo + t;
    gg_load_w<Q, bf16>(Bs + buf * BK * BN, j == G ? Wc : W + (int64_t)j * Cin * Cout,
                             k0, n0, Cin, Cout, vec_w, tid);
  };

  float acc[NF][4];  // fragment n: columns 8 n + 2 (lane % 4) + {0, 1}, rows lane / 4 + {0, 8}
  float sum[ROUND ? NF : 1][4];  // ROUND: the rounded taps' sum
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  if constexpr (ROUND) {
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[n][i] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    const int t = live[1 + step / kchunks];
    if (((ball[t * BALLOTS + (warp >> 1)] >> (16 * (warp & 1))) & 0xffffu) == 0)
      continue;  // this warp's 16 rows gather nothing at this tap
    const int k0 = (step % kchunks) * BK;
    gm_mma<Q>(acc, As + (step % STAGES) * BM * BK, Bs + (step % STAGES) * BK * BN, warp, lane,
              Cin - k0);
    if constexpr (ROUND) {
      if (step % kchunks == kchunks - 1) {  // the tap's last chunk: round, widen, add
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum[n][i] += __bfloat162float(__float2bfloat16_rn(acc[n][i]));
            acc[n][i] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (ROUND) {
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = sum[n][i];
  }

  const int g = lane >> 2, c2 = 2 * (lane & 3);  // a fragment's row and column pair
  using TO = std::conditional_t<F32, float, bf16>;
  if (!F32 && splits == 1) {
    // round once, stage the tile's rows in shared memory (the ring is free
    // once every warp is past its last step), store 16 bytes at a time
    bf16* Cs = As;  // [BM][LDC]
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(Cs + (16 * warp + g + 8 * h) * LDC + 8 * n + c2) =
            __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
    __syncwarp();
    const bool vec_o = Cout % 8 == 0;
#pragma unroll
    for (int u = 0; u < BN / 16; ++u) {  // the warp's 16 rows x BN / 8 chunks
      const int e = lane + 32 * u;
      const int m = 16 * warp + e / (BN / 8), c = e % (BN / 8);
      const int s = srow[m], n = n0 + 8 * c;
      if (s < 0 || n >= Cout) continue;
      TO* dst = out + ((int64_t)b * S_out + s) * Cout + n;
      const bf16* src = Cs + m * LDC + 8 * c;
      if (vec_o) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 8 && n + i < Cout; ++i) dst[i] = TO(src[i]);
      }
    }
    return;
  }
  // several splits: f32 partials in ws, the tile's last block adds them in
  // split order and rounds once (F32: one split's sums go to out as they
  // are, several splits' sum unrounded)
  const int64_t plane = (int64_t)B * S_out * Cout;
  float* part = F32 && splits == 1 ? reinterpret_cast<float*>(out) : ws + sp * plane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = srow[16 * warp + g + 8 * h];
    if (s < 0) continue;
    float* row = part + ((int64_t)b * S_out + s) * Cout;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int col = n0 + 8 * n + c2;
      if (Cout % 2 == 0) {
        if (col < Cout)
          *reinterpret_cast<float2*>(row + col) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      } else {
        if (col < Cout) row[col] = acc[n][2 * h];
        if (col + 1 < Cout) row[col + 1] = acc[n][2 * h + 1];
      }
    }
  }
  if constexpr (F32) {
    if (splits == 1) return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    live[0] = atomicAdd(tickets + tile, 1) == splits - 1;
  }
  __syncthreads();
  if (!live[0]) return;
  __threadfence();
  const bool vec4 = Cout % 4 == 0;
  for (int e = tid; e < BM * BN / 4; e += THREADS) {
    const int m = e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
    const int s = srow[m];
    if (s < 0 || n >= Cout) continue;
    const int64_t off = ((int64_t)b * S_out + s) * Cout;
    float4 v = load4_cg(ws + off, n, Cout, vec4);
#pragma unroll 4  // the splits' loads in flight together, added in split order
    for (int p = 1; p < splits; ++p) add4(v, load4_cg(ws + p * plane + off, n, Cout, vec4));
    store4(out + off, n, Cout, vec4, v);
  }
}

// (b) gather_wgrad: dW[k] = sum over the rows r = (b, s) of the block's
// slice of A[b, rowA(k,b,s)]^T . G[b, rowG(k,b,s)], every pair in which
// rowA is `skip_a` or rowG is `skip_g` (or either lies outside its table)
// left out.  JAX K1-K4's dW and the flat _conv_core's.  What bounds it: 2 Ca
// Cg f32 operations per live (row, tap) pair (f32 SIMT), and at narrow
// channels (32 x 32 at pretraining's level 0: 1024 FMAs per 256 bytes of
// two rows) the rows' bytes from L2.  The design:
//  - a block owns one tap k, one output tile of 32 QA x 32 QG channels
//    fitted to Ca x Cg (QA, QG in 1..3, QA QG <= 4) and a slice of the B * S
//    rows;
//  - compaction: the block takes its slice CHUNK rows at a time; each thread
//    reads one row's two indices, a ballot and the warps' counts give every
//    live pair its place, and the compacted pairs (table rows of A and G)
//    land in shared memory in row order.  The FMAs then run on live pairs
//    only: the work equals what chip_smoke.py's work() counts, up to the
//    last stage's 32-row rounding;
//  - the pairs' A and G row tiles arrive by 16-byte cp.async (4-byte where
//    a width is not a multiple of 4), 32 pairs a stage in a 3-stage ring,
//    one wait + __syncthreads a stage;
//  - 4 row groups of 64 threads each take every 4th pair of a stage; a
//    thread keeps 4 QA x 4 QG outputs in registers, and at the end the
//    groups' tiles are added in group order in shared memory; the (bf16,
//    bf16) form instead gives each warp its own m16n8 fragments of the
//    tile and runs the pairs through mma.sync (gw_pairs_mma);
//  - the slices of one (tap, tile) are combined by the tile's last block
//    (integer tickets), which adds the partials the slices left in `ws`
//    [slices, K, Ca, Cg] in slice order, so dW is the same from run to run
//    (f32 atomics into a zeroed dW were 3-4% faster on the pretraining and
//    semseg checks, PERF.md, and give a sum whose order changes).
namespace gw {
constexpr int THREADS = 256;
constexpr int ROWS = 32;     // pairs a pipeline stage
constexpr int STAGES = 3;
constexpr int CHUNK = 2048;  // rows compacted at a time
constexpr int GROUPS = 4;    // row groups of 64 threads (8 x 8 a tile)

inline int q_for(int C) { return C <= 32 ? 1 : (C % 96 == 0 && C % 64 != 0) ? 3 : 2; }

// The tensor-core form's q of a width: 32 q channels, q in 1..4 (a warp
// holds 4 q_a q_g sums a thread), the one that pads C least, the larger on
// a tie: 32 -> 1, 64 -> 2, 96 -> 3, 128, 256 -> 4.
inline int mma_q_for(int C) {
  int best = 1;
  for (int q = 2; q <= 4; ++q) {
    if ((C + 32 * q - 1) / (32 * q) * 32 * q <= (C + 32 * best - 1) / (32 * best) * 32 * best)
      best = q;
  }
  return best;
}

// (QA, QG): each fitted to its width, their product at most 4 (the
// registers of a thread's tile); the tensor-core form (mma): each up to 4,
// so that one tile covers most layers' channels and a pair's rows are
// compacted and gathered once, their product at most 9 (4 x 3 and 4 x 4
// spilled past the 128 registers of two blocks an SM: a 4 halves to 2)
inline void qs_for(int Ca, int Cg, int* qa, int* qg, bool mma = false) {
  if (mma) {
    *qa = mma_q_for(Ca);
    *qg = mma_q_for(Cg);
    if (*qa * *qg > 9) {
      if (*qg == 4) *qg = 2; else *qa = 2;
    }
    return;
  }
  *qa = q_for(Ca);
  *qg = q_for(Cg);
  if (*qa * *qg > 4) {
    if (*qa == 3) *qa = 1; else *qg = 1;
  }
}

// The bytes before the pair lists: the stage ring of A's and G's row tiles
// (ea, eg: their element sizes, 4 for f32, 2 for bf16), which gw_finish
// reuses for the row groups' tiles (a bf16 ring can be the smaller); the
// tensor-core form (two bf16 operands) keeps its sums in registers: the
// ring alone.
__host__ __device__ constexpr size_t tile_bytes(int qa, int qg, int ea = 4, int eg = 4) {
  return (size_t)STAGES * ROWS * 32 * (qa * ea + qg * eg) >
                     sizeof(float) * (GROUPS - 1) * 16 * qa * qg * 64 ||
                 (ea == 2 && eg == 2)
             ? (size_t)STAGES * ROWS * 32 * (qa * ea + qg * eg)
             : sizeof(float) * (GROUPS - 1) * 16 * qa * qg * 64;
}

inline size_t smem_bytes(int qa, int qg, int ea = 4, int eg = 4) {
  return tile_bytes(qa, qg, ea, eg) + sizeof(int) * (2 * CHUNK + 32);
}
}  // namespace gw

// One compaction step of a wgrad kernel: the pair (ra, rg) of each thread
// whose `ok` holds lands after the n pairs already in pa / pg, in thread
// order (a ballot and the warps' counts in `cnt` [8], one of two buffers
// taken in turn, so one barrier a step); returns the pairs the block added.
__device__ __forceinline__ int gw_append(bool ok, int ra, int rg, int* pa, int* pg, int* cnt,
                                         int n, int lane, int warp) {
  const unsigned bits = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) cnt[warp] = __popc(bits);
  __syncthreads();
  int base = n, all = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    base += w < warp ? cnt[w] : 0;
    all += cnt[w];
  }
  if (ok) {
    const int at = base + __popc(bits & ((1u << lane) - 1u));
    pa[at] = ra;
    pg[at] = rg;
  }
  return all;
}

// Stage pairs [st ROWS, st ROWS + ROWS) of a bf16 operand's rows: tile row
// i is row p[st ROWS + i] of M at channels c0 + [0, TW), zero-filled past
// n and C; 16-byte cp.async of 8 values where `vec` (C % 8 == 0, M
// aligned), else plain 2-byte loads (odd C rows are only 2-byte aligned).
// MMA: row i's chunks at mma_chunk, for ldmatrix.  BRICKS: M's rows are
// whole bricks of 8 slots of sw channels (C = 8 sw) and p[q] = row << 8 |
// the row's occupied slots: an empty slot's channels are staged as zeros
// (a 16-byte chunk of empty slots zero-filled; one that holds both kinds
// copied whole, and masked by gw_mask_bricks once it has landed).
template <int TW, bool MMA = false, bool BRICKS = false>
__device__ __forceinline__ void gw_load_bf16(bf16* tile, const int* p, int st, int n,
                                             const bf16* __restrict__ M, int C, int c0,
                                             int vec, int tid, int sw = 0) {
  constexpr int THREADS = gw::THREADS, ROWS = gw::ROWS;
  auto chunk = [](int i, int c) { return MMA ? mma_chunk<TW / 8>(i, c) : c; };
  if (vec) {
    for (int e = tid; e < ROWS * TW / 8; e += THREADS) {
      const int i = e / (TW / 8), c = e % (TW / 8);
      const int q = st * ROWS + i;
      const bool ok = q < n && c0 + 8 * c < C;
      bf16* dst = tile + i * TW + (chunk(i, c) << 3);
      if constexpr (BRICKS) {
        const int w = ok ? p[q] : 0, k0 = c0 + 8 * c;
        // an occupied slot among those the chunk spans
        const bool any = ok && (w & ((2u << ((k0 + 7) / sw)) - (1u << (k0 / sw))));
        cp_async16(dst, any ? M + (int64_t)(w >> 8) * C + k0 : M, any);
      } else {
        cp_async16(dst, ok ? M + (int64_t)p[q] * C + c0 + 8 * c : M, ok);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < ROWS * TW / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int i = e / TW, c = e % TW;
      const int q = st * ROWS + i;
      bool ok = q < n && c0 + c < C;
      int row = ok ? p[q] : 0;
      if constexpr (BRICKS) {
        ok = ok && ((row >> ((c0 + c) / sw)) & 1);
        row >>= 8;
      }
      tile[i * TW + (chunk(i, c >> 3) << 3) + (c & 7)] =
          ok ? M[(int64_t)row * C + c0 + c] : bf16_zero();
    }
  }
}

// A BRICKS stage of gw_load_bf16 (vec) once this thread's copies of it have
// landed: the chunks it staged that hold both occupied and empty slots get
// zeros at the empty slots' channels (before the barrier that hands the
// stage to the other warps)
template <int TW>
__device__ __forceinline__ void gw_mask_bricks(bf16* tile, const int* p, int st, int n, int C,
                                               int c0, int sw, int tid) {
  constexpr int THREADS = gw::THREADS, ROWS = gw::ROWS;
  for (int e = tid; e < ROWS * TW / 8; e += THREADS) {
    const int i = e / (TW / 8), c = e % (TW / 8);
    const int q = st * ROWS + i, k0 = c0 + 8 * c;
    if (q >= n || k0 >= C) continue;
    const int w = p[q];
    const unsigned span = (2u << ((k0 + 7) / sw)) - (1u << (k0 / sw));
    const unsigned have = (unsigned)w & span;
    if (have == 0 || have == span) continue;
    bf16* h = tile + i * TW + (mma_chunk<TW / 8>(i, c) << 3);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (!((w >> ((k0 + k) / sw)) & 1)) h[k] = bf16_zero();
  }
}

// The products of n compacted pairs: A's row pa[p] (channels a0 + [0, 32
// QA)) times G's row pg[p] (g0 + [0, 32 QG)), added into each thread's
// tile (the SIMT forms: G f32, A f32 or bf16).  The rows arrive by
// cp.async in the 3-stage ring at `smem`, 32 pairs a stage; on return the
// ring and the pair list are free.
template <int QA, int QG, typename TA_ = float>
__device__ __forceinline__ void gw_pairs(float4 (&acc)[QA][4][QG], float* smem,
                                         const int* pa, const int* pg, int n,
                                         const TA_* __restrict__ A, int Ca, int a0,
                                         const float* __restrict__ Gm, int Cg, int g0,
                                         int vec_a, int vec_g, int tid) {
  constexpr int THREADS = gw::THREADS, ROWS = gw::ROWS, STAGES = gw::STAGES;
  constexpr int GROUPS = gw::GROUPS;
  constexpr int TA = 32 * QA, TG = 32 * QG;
  TA_* As = reinterpret_cast<TA_*>(smem);                        // [STAGES][ROWS][TA]
  float* Gs = reinterpret_cast<float*>(As + STAGES * ROWS * TA); // [STAGES][ROWS][TG]
  const int grp = tid >> 6, gt = tid & 63;
  const int ta = gt >> 3, tg = gt & 7;
  const int nst = (n + ROWS - 1) / ROWS;
  auto load = [&](int st, int buf) {
    TA_* as = As + buf * ROWS * TA;
    float* gs = Gs + buf * ROWS * TG;
    if constexpr (is_bf16<TA_>) {
      gw_load_bf16<TA>(as, pa, st, n, A, Ca, a0, vec_a, tid);
    } else if (vec_a) {
#pragma unroll
      for (int u = 0; u < QA; ++u) {  // ROWS * TA / 4 / THREADS
        const int e = tid + u * THREADS;
        const int i = e / (TA / 4), c = e % (TA / 4);
        const int p = st * ROWS + i;
        const bool ok = p < n && a0 + 4 * c < Ca;
        cp_async16(as + i * TA + 4 * c, ok ? A + (int64_t)pa[p] * Ca + a0 + 4 * c : A, ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < 4 * QA; ++u) {
        const int e = tid + u * THREADS;
        const int i = e / TA, c = e % TA;
        const int p = st * ROWS + i;
        const bool ok = p < n && a0 + c < Ca;
        cp_async4(as + i * TA + c, ok ? A + (int64_t)pa[p] * Ca + a0 + c : A, ok);
      }
    }
    if (vec_g) {
#pragma unroll
      for (int u = 0; u < QG; ++u) {
        const int e = tid + u * THREADS;
        const int i = e / (TG / 4), c = e % (TG / 4);
        const int p = st * ROWS + i;
        const bool ok = p < n && g0 + 4 * c < Cg;
        cp_async16(gs + i * TG + 4 * c, ok ? Gm + (int64_t)pg[p] * Cg + g0 + 4 * c : Gm, ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < 4 * QG; ++u) {
        const int e = tid + u * THREADS;
        const int i = e / TG, c = e % TG;
        const int p = st * ROWS + i;
        const bool ok = p < n && g0 + c < Cg;
        cp_async4(gs + i * TG + c, ok ? Gm + (int64_t)pg[p] * Cg + g0 + c : Gm, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; stage st - 1's buffer is free
    {
      const int next = st + STAGES - 1;
      if (next < nst) load(next, next % STAGES);
      cp_async_commit();
    }
    const int here = min(ROWS, n - st * ROWS);
    const TA_* as = As + (st % STAGES) * ROWS * TA + 4 * ta;
    const float* gs = Gs + (st % STAGES) * ROWS * TG + 4 * tg;
#pragma unroll
    for (int u = 0; u < ROWS / GROUPS; ++u) {
      const int i = grp + GROUPS * u;
      if (i >= here) break;
      float4 av[QA], gv[QG];
#pragma unroll
      for (int p = 0; p < QA; ++p) av[p] = ld4(as + i * TA + 32 * p);
#pragma unroll
      for (int q = 0; q < QG; ++q) gv[q] = ld4(gs + i * TG + 32 * q);
#pragma unroll
      for (int p = 0; p < QA; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int q = 0; q < QG; ++q) fma4(acc[p][c][q], lane_of(av[p], c), gv[q]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the pair list are rewritten by the next round
}

// A wgrad block's end, its grid (tiles, taps, slices): the row groups'
// tiles added in group order in shared memory (the stage ring is free),
// then dW[tap] (one slice) or the slice's partial in ws [slices, taps, Ca,
// Cg], of which the (tap, tile)'s last block, by an integer ticket, adds
// the slices in slice order.  `flag`: one int of shared memory.
template <int QA, int QG>
__device__ __forceinline__ void gw_finish(float4 (&acc)[QA][4][QG], float* smem, int* flag,
                                          float* __restrict__ dW, float* __restrict__ ws,
                                          int* __restrict__ tickets, int Ca, int Cg, int a0,
                                          int g0, int tid) {
  constexpr int THREADS = gw::THREADS, GROUPS = gw::GROUPS;
  constexpr int TA = 32 * QA, TG = 32 * QG;
  constexpr int NACC = 16 * QA * QG;  // outputs a thread
  const int grp = tid >> 6, gt = tid & 63;
  const int ta = gt >> 3, tg = gt & 7;
  const int k = blockIdx.y;
  float* red = smem;  // [GROUPS - 1][NACC][64]
  if (grp > 0) {
#pragma unroll
    for (int p = 0; p < QA; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < QG; ++q) {
          const int idx = ((p * 4 + c) * QG + q) * 4;
          float* d = red + ((grp - 1) * NACC + idx) * 64 + gt;
          d[0] = acc[p][c][q].x;
          d[64] = acc[p][c][q].y;
          d[128] = acc[p][c][q].z;
          d[192] = acc[p][c][q].w;
        }
  }
  __syncthreads();
  const bool vec_o = Cg % 4 == 0;
  const int slices = gridDim.z;
  const int64_t tap_off = (int64_t)k * Ca * Cg;
  if (grp == 0) {
#pragma unroll
    for (int g = 1; g < GROUPS; ++g)
#pragma unroll
      for (int p = 0; p < QA; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int q = 0; q < QG; ++q) {
            const int idx = ((p * 4 + c) * QG + q) * 4;
            const float* s_ = red + ((g - 1) * NACC + idx) * 64 + gt;
            add4(acc[p][c][q], make_float4(s_[0], s_[64], s_[128], s_[192]));
          }
    float* dst = slices == 1 ? dW : ws + (int64_t)blockIdx.z * gridDim.y * Ca * Cg;
#pragma unroll
    for (int p = 0; p < QA; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = a0 + 4 * ta + 32 * p + c;
        if (m >= Ca) continue;
        float* row = dst + tap_off + (int64_t)m * Cg;
#pragma unroll
        for (int q = 0; q < QG; ++q) store4(row, g0 + 4 * tg + 32 * q, Cg, vec_o, acc[p][c][q]);
      }
  }
  if (slices == 1) return;
  // the (tap, tile)'s last block adds the slices' partials in slice order
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + k * gridDim.x + blockIdx.x, 1) == slices - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int64_t plane = (int64_t)gridDim.y * Ca * Cg;
  for (int e = tid; e < TA * TG; e += THREADS) {
    const int m = a0 + e / TG, nn = g0 + e % TG;
    if (m >= Ca || nn >= Cg) continue;
    const int64_t off = tap_off + (int64_t)m * Cg + nn;
    float v = __ldcg(ws + off);
    for (int z = 1; z < slices; ++z) v += __ldcg(ws + z * plane + off);
    dW[off] = v;
  }
}

// The (bf16, bf16) form's products on the tensor cores: the dW tile
// [32 QA][32 QG] is A^T G over the compacted pairs, the pairs the mma's K.
// Warp w owns QA QG of the tile's 2 QA x 4 QG m16n8 fragments (w QA QG
// on, row-major), so no warp's sums meet another's; a stage's 32 pairs
// are two k16 steps (the second left out past n; zero-filled pairs add
// nothing).  A^T's fragment comes by ldmatrix.x4.trans from the [pairs]
// [32 QA] tile, G's by ldmatrix.x2.trans from the [pairs][32 QG] tile,
// both staged with mma_chunk's swizzle.  Same ring, stages and pair
// lists as gw_pairs.  BRICKS: the pairs name whole bricks with their
// occupied slots, of sa and sg channels a slot (gw_load_bf16).
template <int QA, int QG, bool BRICKS = false>
__device__ __forceinline__ void gw_pairs_mma(float (&acc)[QA * QG][4], float* smem,
                                             const int* pa, const int* pg, int n,
                                             const bf16* __restrict__ A, int Ca, int a0,
                                             const bf16* __restrict__ Gm, int Cg, int g0,
                                             int vec_a, int vec_g, int tid, int sa = 0,
                                             int sg = 0) {
  constexpr int ROWS = gw::ROWS, STAGES = gw::STAGES;
  constexpr int TA = 32 * QA, TG = 32 * QG, PT = QA * QG, NG = TG / 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][ROWS][TA]
  bf16* Gs = As + STAGES * ROWS * TA;         // [STAGES][ROWS][TG]
  const int lane = tid & 31, warp = tid >> 5;
  const int nst = (n + ROWS - 1) / ROWS;
  auto load = [&](int st, int buf) {
    gw_load_bf16<TA, true, BRICKS>(As + buf * ROWS * TA, pa, st, n, A, Ca, a0, vec_a, tid, sa);
    gw_load_bf16<TG, true, BRICKS>(Gs + buf * ROWS * TG, pg, st, n, Gm, Cg, g0, vec_g, tid, sg);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    if constexpr (BRICKS) {  // where a slot is whole 16-byte chunks, none straddles two
      if (vec_a && sa % 8)
        gw_mask_bricks<TA>(As + (st % STAGES) * ROWS * TA, pa, st, n, Ca, a0, sa, tid);
      if (vec_g && sg % 8)
        gw_mask_bricks<TG>(Gs + (st % STAGES) * ROWS * TG, pg, st, n, Cg, g0, sg, tid);
    }
    __syncthreads();  // stage st has landed; stage st - 1's buffer is free
    {
      const int next = st + STAGES - 1;
      if (next < nst) load(next, next % STAGES);
      cp_async_commit();
    }
    const int here = min(ROWS, n - st * ROWS);
    const bf16* as = As + (st % STAGES) * ROWS * TA;
    const bf16* gs = Gs + (st % STAGES) * ROWS * TG;
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      if (16 * kk >= here) break;
      const int pa_ = 16 * kk + (lane & 7) + ((lane >> 4) << 3);  // A^T: pairs as columns
      const int pg_ = 16 * kk + (lane & 15);
      unsigned a[4];
      int loaded = -1;  // the m16 rows of A^T in a
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int e = warp * PT + i, mt = e / NG, nt = e % NG;
        if (mt != loaded) {  // a warp's fragments span one or two m16 rows
          ldsm_x4_t(a, as + pa_ * TA + (mma_chunk<TA / 8>(pa_, 2 * mt + ((lane >> 3) & 1)) << 3));
          loaded = mt;
        }
        unsigned b[2];
        ldsm_x2_t(b, gs + pg_ * TG + (mma_chunk<TG / 8>(pg_, nt) << 3));
        mma_bf16(acc[i], a, b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the pair list are rewritten by the next round
}

// gw_finish for gw_pairs_mma's fragments: each warp stores its own, dW[tap]
// (one slice) or the slice's partial in ws, and the (tap, tile)'s last
// block, by an integer ticket, adds the slices in slice order.
template <int QA, int QG>
__device__ __forceinline__ void gw_finish_mma(float (&acc)[QA * QG][4], int* flag,
                                              float* __restrict__ dW, float* __restrict__ ws,
                                              int* __restrict__ tickets, int Ca, int Cg,
                                              int a0, int g0, int tid) {
  constexpr int THREADS = gw::THREADS, TA = 32 * QA, TG = 32 * QG, PT = QA * QG, NG = TG / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // a fragment's row and column pair
  const int k = blockIdx.y, slices = gridDim.z;
  const int64_t tap_off = (int64_t)k * Ca * Cg;
  float* dst = (slices == 1 ? dW : ws + (int64_t)blockIdx.z * gridDim.y * Ca * Cg) + tap_off;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int e = warp * PT + i, mt = e / NG, nt = e % NG;
    const int col = g0 + 8 * nt + c2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = a0 + 16 * mt + g + 8 * h;
      if (m >= Ca) continue;
      float* row = dst + (int64_t)m * Cg;
      if (Cg % 2 == 0) {
        if (col < Cg) *reinterpret_cast<float2*>(row + col) = make_float2(acc[i][2 * h],
                                                                          acc[i][2 * h + 1]);
      } else {
        if (col < Cg) row[col] = acc[i][2 * h];
        if (col + 1 < Cg) row[col + 1] = acc[i][2 * h + 1];
      }
    }
  }
  if (slices == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + k * gridDim.x + blockIdx.x, 1) == slices - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the slices' partials, 8 loads in flight a thread, added in slice order
  constexpr int BATCH = 8;
  const int64_t plane = (int64_t)gridDim.y * Ca * Cg;
  if (Cg % 4 == 0) {  // 16-byte loads of 4 columns
    for (int e = tid; e < TA * TG / 4; e += THREADS) {
      const int m = a0 + e / (TG / 4), nn = g0 + 4 * (e % (TG / 4));
      if (m >= Ca || nn >= Cg) continue;
      const float4* src = reinterpret_cast<const float4*>(ws + tap_off + (int64_t)m * Cg + nn);
      const int64_t step = plane / 4;
      float4 v = __ldcg(src);
      int z = 1;
      for (; z + BATCH <= slices; z += BATCH) {
        float4 t[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) t[u] = __ldcg(src + (z + u) * step);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) add4(v, t[u]);
      }
      for (; z < slices; ++z) add4(v, __ldcg(src + z * step));
      *reinterpret_cast<float4*>(dW + tap_off + (int64_t)m * Cg + nn) = v;
    }
    return;
  }
  for (int e = tid; e < TA * TG; e += THREADS) {
    const int m = a0 + e / TG, nn = g0 + e % TG;
    if (m >= Ca || nn >= Cg) continue;
    const int64_t off = tap_off + (int64_t)m * Cg + nn;
    float v = __ldcg(ws + off);
    for (int z = 1; z < slices; ++z) v += __ldcg(ws + z * plane + off);
    dW[off] = v;
  }
}

template <int QA, int QG, typename TA_, typename TG_>
__global__ void __launch_bounds__(gw::THREADS, 2)
gather_wgrad_kernel(const TA_* __restrict__ A, const int* __restrict__ a_map,
                    const __grid_constant__ TapList a_taps, int a_stride, int Sa,
                    int Ca, int skip_a, const TG_* __restrict__ Gm,
                    const int* __restrict__ g_map, const __grid_constant__ TapList g_taps,
                    int g_stride, int Sg, int Cg, int skip_g, float* __restrict__ dW,
                    float* __restrict__ ws, int* __restrict__ tickets, int B, int S,
                    int rows_per_block, int vec_a, int vec_g) {
  constexpr int THREADS = gw::THREADS;
  constexpr int CHUNK = gw::CHUNK;
  constexpr int TA = 32 * QA, TG = 32 * QG;
  constexpr size_t TILES = gw::tile_bytes(QA, QG, sizeof(TA_), sizeof(TG_));
  extern __shared__ __align__(16) float smem[];
  int* pa = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) + TILES);  // [CHUNK]
  int* pg = pa + CHUNK;                                                // [CHUNK] G rows
  int* wcount = pg + CHUNK;                                            // [2][8], flag

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_g = (Cg + TG - 1) / TG;
  const int a0 = (blockIdx.x / tiles_g) * TA, g0 = (blockIdx.x % tiles_g) * TG;
  const int k = blockIdx.y;
  const int total = B * S;
  const int r_begin = blockIdx.z * rows_per_block;
  const int r_end = min(r_begin + rows_per_block, total);

  // compaction of rows [c0, c0 + CHUNK): live pairs in row order
  auto compact = [&](int c0) {
    int n = 0;
#pragma unroll 1
    for (int it = 0; it < CHUNK / THREADS; ++it) {
      const int r = c0 + it * THREADS + tid;
      bool ok = false;
      int ra = 0, rg = 0;
      if (r < r_end) {
        const int bb = r / S, s = r - bb * S;
        ra = row_of(a_map, a_taps, a_stride, k, bb, s, B, S);
        rg = row_of(g_map, g_taps, g_stride, k, bb, s, B, S);
        ok = ra != skip_a && rg != skip_g && ra >= 0 && ra < Sa && rg >= 0 && rg < Sg;
        ra += bb * Sa;
        rg += bb * Sg;
      }
      n += gw_append(ok, ra, rg, pa, pg, wcount + 8 * (it & 1), n, lane, warp);
    }
    __syncthreads();
    return n;
  };

  if constexpr (is_bf16<TA_> && is_bf16<TG_>) {  // the tensor cores
    float acc[QA * QG][4];
#pragma unroll
    for (int i = 0; i < QA * QG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int c0 = r_begin; c0 < r_end; c0 += CHUNK) {
      const int n = compact(c0);
      gw_pairs_mma<QA, QG>(acc, smem, pa, pg, n, A, Ca, a0, Gm, Cg, g0, vec_a, vec_g, tid);
    }
    gw_finish_mma<QA, QG>(acc, wcount + 16, dW, ws, tickets, Ca, Cg, a0, g0, tid);
  } else {
    float4 acc[QA][4][QG];  // A channel ta*4 + 32p + c, G channels tg*4 + 32q + 0..3
#pragma unroll
    for (int p = 0; p < QA; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < QG; ++q) acc[p][c][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = r_begin; c0 < r_end; c0 += CHUNK) {
      const int n = compact(c0);
      gw_pairs<QA, QG, TA_>(acc, smem, pa, pg, n, A, Ca, a0, Gm, Cg, g0, vec_a, vec_g, tid);
    }
    gw_finish<QA, QG>(acc, smem, wcount + 16, dW, ws, tickets, Ca, Cg, a0, g0, tid);
  }
}

// (c) parent_gemm: out[b,i,:] = X[b, parent[b,i], :] . W[off[b,i]], zeros
// where parent[b,i] is `skip` (or outside [0, S_c)).  JAX K3 _conv_tr_chunk's
// forward (skip: the coarse pad row, whose features are zero) and K2
// _conv_chunk_down2's dF with W^T (skip -1: an orphaned fine voxel reads the
// cotangent's pad row, which only the output mask's adjoint zeroes).  What
// bounds it: 2 Cin Cout f32 operations a fine row whose parent is live
// (f32 SIMT), and at Cin = Cout = 32 the parents' rows (each read by up to 8
// children) and the output.  A row multiplies one of 8 weight matrices,
// chosen by its offset, so the design tiles the rows by offset and runs
// gather_gemm's pipeline over (offset, Cin chunk) steps:
//  - a block owns BM = 128 consecutive entries of `order` (the up order,
//    built with the pyramid: each chunk's fine rows by offset, those whose
//    parent is the coarse pad row last, topology.up_order) or, without it,
//    128 consecutive rows, and a Cout tile of 32 Q channels (gg::q_for);
//    each output row is written once, so the order changes no result.  In
//    the up order a tile spans one offset, or a few at a run boundary and
//    at the small levels;
//  - prologue: the tile's rows, parents and offsets into shared memory,
//    and per 16-row warp fragment the set of offsets of its live rows;
//    the block steps over the offsets present in the tile (with `splits`
//    blocks a tile, at small grids, over every splits-th of them: the rows
//    of different offsets are disjoint, so each block writes its own rows
//    and nothing is added across blocks);
//  - main loop over (offset, 32-deep Cin chunk) steps through gather_gemm's
//    3-stage cp.async ring: that offset's weight tile and the tile's rows
//    of that offset, the other rows zero-filled (their products add +-0,
//    which changes no bit of a row's sum), swizzled as gather_gemm's; a
//    warp whose fragment holds no row of the offset skips the step's FMAs
//    (gg_fma), accumulators in registers;
//  - every row's sum runs over its own offset's Cin in order: the same
//    bits from run to run, no atomics.
namespace pg {
constexpr int KO = 8;  // offsets of a k2s2 kernel (2^3)
constexpr int FRAGS = gg::BM / 16;

// element size: 4 (f32) or 2 (parent_gemm_mma_kernel's bf16 tiles)
inline size_t smem_bytes(int Q, int esize = 4) {
  return (size_t)esize * gg::STAGES * (gg::BM * gg::BK + gg::BK * 32 * Q) +
         sizeof(int) * (3 * gg::BM + FRAGS + KO + 2);
}
}  // namespace pg

// The parent GEMMs' prologue (parent_gemm_kernel, parent_gemm_mma_kernel):
// the tile's output rows `srow` [BM] (through `order` where given, -1 past
// S_f), their parents `prow` (-1 where skipped or out of the table) and
// offsets `poff`, per 16-row warp fragment the mask of its live rows'
// offsets `fmask` [FRAGS], and this split's offsets `offs` (their count,
// the offsets, then their mask at offs[1 + KO]).  Ends with a
// __syncthreads.
__device__ __forceinline__ void pg_prologue(int* srow, int* prow, int* poff, unsigned* fmask,
                                            int* offs, const int* __restrict__ parent,
                                            const int* __restrict__ off,
                                            const int* __restrict__ order, int b, int s0,
                                            int sp, int splits, int S_c, int S_f, int skip) {
  constexpr int BM = gg::BM, KO = pg::KO, FRAGS = pg::FRAGS;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < BM) {  // whole warps
    const int e = s0 + tid;
    int s = -1, r = -1, o = 0;
    if (e < S_f) {
      s = order != nullptr ? __ldg(order + (int64_t)b * S_f + e) : e;
      r = __ldg(parent + (int64_t)b * S_f + s);
      o = __ldg(off + (int64_t)b * S_f + s);
      if (r == skip || r < 0 || r >= S_c || o < 0 || o >= KO) r = -1;
    }
    srow[tid] = s;
    prow[tid] = r;
    poff[tid] = o;
    unsigned bits = r >= 0 ? 1u << o : 0u;
#pragma unroll
    for (int d = 8; d > 0; d >>= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, d);
    if ((lane & 15) == 0) fmask[tid >> 4] = bits;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned any = 0;
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) any |= fmask[f];
    int n = 0, seen = 0;
    unsigned own = 0;
    for (int o = 0; o < KO; ++o) {
      if (!((any >> o) & 1u)) continue;
      if (seen++ % splits == sp) {
        offs[1 + n++] = o;
        own |= 1u << o;
      }
    }
    offs[0] = n;
    offs[1 + KO] = (int)own;
  }
  __syncthreads();
}

template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
parent_gemm_kernel(const float* __restrict__ X, const int* __restrict__ parent,
                   const int* __restrict__ off, const float* __restrict__ W,
                   const int* __restrict__ order, float* __restrict__ out, int splits,
                   int S_c, int S_f, int Cin, int Cout, int skip, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES;
  constexpr int TM = gg::TM, BN = 32 * Q, KO = pg::KO, FRAGS = pg::FRAGS;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                           // [STAGES][BM][BK]
  float* Bs = As + STAGES * BM * BK;                          // [STAGES][BK][BN]
  int* prow = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [BM] parent, -1: none
  int* poff = prow + BM;                                      // [BM] offset
  int* srow = poff + BM;                                      // [BM] output row, -1 past S_f
  unsigned* fmask = reinterpret_cast<unsigned*>(srow + BM);   // [FRAGS] offsets present
  int* offs = reinterpret_cast<int*>(fmask + FRAGS);  // count, the offsets, own mask

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const float* Xb = X + (int64_t)b * S_c * Cin;

  pg_prologue(srow, prow, poff, fmask, offs, parent, off, order, b, s0, sp, splits, S_c, S_f,
              skip);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = offs[0] * kchunks;

  auto load = [&](int step, int buf) {
    const int o = offs[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    gg_load_rows(As + buf * BM * BK, Xb, [&](int m) { return poff[m] == o ? prow[m] : -1; },
                 k0, Cin, vec_x, tid);
    gg_load_w<Q>(Bs + buf * BK * BN, W + (int64_t)o * Cin * Cout, k0, n0, Cin, Cout, vec_w,
                 tid);
  };

  float4 acc[TM][Q];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  const int sw = ty & 7;  // the swizzle of this thread's rows: (4 ty + i) / 4 % 8
  const unsigned mine = fmask[warp];  // warp w's fragment: rows [16 w, 16 w + 16)
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    if (!((mine >> offs[1 + step / kchunks]) & 1u)) continue;  // no row of this offset
    gg_fma<Q>(acc, As + (step % STAGES) * BM * BK + 4 * ty * BK,
              Bs + (step % STAGES) * BK * BN + 4 * tx, sw);
  }
  cp_async_wait<0>();

  // each row by the block that owns its offset; skipped rows (zeros) by split 0
  const unsigned own = (unsigned)offs[1 + KO];
  const bool vec_o = Cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = 4 * ty + i;
    const int s = srow[m];
    if (s < 0 || (prow[m] >= 0 ? !((own >> poff[m]) & 1u) : sp != 0)) continue;
    float* row = out + ((int64_t)b * S_f + s) * Cout;
#pragma unroll
    for (int q = 0; q < Q; ++q) store4(row, n0 + 4 * tx + 32 * q, Cout, vec_o, acc[i][q]);
  }
}

// parent_gemm_bf16 on the tensor cores (the bf16 form of (c): JAX K3's
// forward and K2's dF in bf16, pointcontrast_tpu/sparse/ops.py:650-671,
// :768-790): the f32 kernel's up-order tiles, prologue and offset splits
// with gather_gemm_mma_kernel's products and epilogue.  What bounds it: a
// live fine row costs 2 Cin Cout bf16 x bf16 operations, and each parent
// row is read for up to 8 children, far under the tensor cores' 989
// TFLOP/s at the card's balance point (~295 operations a byte), so the
// parents' rows, the bf16 output and the pipeline's latency set its pace.
// The design:
//  - the f32 kernel's tiles (128 entries of the up order: one offset, or a
//    few at a run boundary), prologue (pg_prologue: per 16-row fragment the
//    mask of its live rows' offsets) and steps over (offset, 32-deep Cin
//    chunk), the rows of the step's offset staged through the bf16 cp.async
//    ring and the others zero-filled (gg_load_rows, mma_chunk's swizzle);
//  - warp w runs gm_mma (ldmatrix + mma.sync.m16n8k16 bf16 -> f32) on its
//    fragment x the Cout tile BN = 32 Q (gm::q_for: 32 -> 1, 64 -> 2, 96 ->
//    3, 128 and 256 -> 4) where its fragment holds a row of the step's
//    offset, and skips the step where it holds none; a zero-filled row adds
//    +-0 to its sums, so each row's f32 sum runs over its own offset's
//    products;
//  - TRANS_W (K2's dF, out = ct W[o]^T): W is the forward's untransposed
//    [8, Cout, Cin]; the tile stages BN rows of W[o] (sg_load_wt) and
//    plain ldmatrix reads the B fragments (sg_mma_bf16), so the caller
//    makes no transposed copy of W;
//  - epilogue: each sum rounded once to bf16, the tile staged in shared
//    memory (rows padded by gm::PAD) and stored as 16-byte rows; each row
//    by the block of its offset's split (skipped rows, zeros, by split 0):
//    no partial sums, no atomics, no workspace, the same bits run to run.
// grid (ceil(S_f / BM), ceil(Cout / 32 Q), B * splits)
template <int Q, bool TRANS_W>
__global__ void __launch_bounds__(gg::THREADS, 2)
parent_gemm_mma_kernel(const bf16* __restrict__ X, const int* __restrict__ parent,
                       const int* __restrict__ off, const bf16* __restrict__ W,
                       const int* __restrict__ order, bf16* __restrict__ out, int splits,
                       int S_c, int S_f, int Cin, int Cout, int skip, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES;
  constexpr int BN = 32 * Q, NF = 4 * Q, LDC = BN + gm::PAD, KO = pg::KO, FRAGS = pg::FRAGS;
  extern __shared__ __align__(16) float smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                   // [STAGES][BM][BK]
  bf16* Bs = As + STAGES * BM * BK;  // [STAGES][BK][BN] (TRANS_W: [STAGES][BN][BK])
  int* prow = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [BM] parent, -1: none
  int* poff = prow + BM;                                      // [BM] offset
  int* srow = poff + BM;                                      // [BM] output row, -1 past S_f
  unsigned* fmask = reinterpret_cast<unsigned*>(srow + BM);   // [FRAGS] offsets present
  int* offs = reinterpret_cast<int*>(fmask + FRAGS);  // count, the offsets, own mask

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const bf16* Xb = X + (int64_t)b * S_c * Cin;

  pg_prologue(srow, prow, poff, fmask, offs, parent, off, order, b, s0, sp, splits, S_c, S_f,
              skip);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = offs[0] * kchunks;

  auto load = [&](int step, int buf) {
    const int o = offs[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    gg_load_rows(As + buf * BM * BK, Xb, [&](int m) { return poff[m] == o ? prow[m] : -1; },
                 k0, Cin, vec_x, tid);
    const bf16* Wo = W + (int64_t)o * Cin * Cout;
    if constexpr (TRANS_W) {
      sg_load_wt<Q>(Bs + buf * BK * BN, Wo, n0, k0, Cout, Cin, vec_w, tid);
    } else {
      gg_load_w<Q, bf16>(Bs + buf * BK * BN, Wo, k0, n0, Cin, Cout, vec_w, tid);
    }
  };

  float acc[NF][4];  // fragment n: columns 8 n + 2 (lane % 4) + {0, 1}, rows lane / 4 + {0, 8}
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  const unsigned mine = fmask[warp];  // warp w's fragment: rows [16 w, 16 w + 16)
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    if (!((mine >> offs[1 + step / kchunks]) & 1u)) continue;  // no row of this offset
    const int k0 = (step % kchunks) * BK;
    const bf16* as = As + (step % STAGES) * BM * BK;
    const bf16* bs = Bs + (step % STAGES) * BK * BN;
    if constexpr (TRANS_W) {
      sg_mma_bf16<Q>(acc, as, bs, warp, lane, Cin - k0);
    } else {
      gm_mma<Q>(acc, as, bs, warp, lane, Cin - k0);
    }
  }
  cp_async_wait<0>();

  // round once, stage the tile's rows in shared memory (the ring is free
  // once every warp is past its last step), store 16 bytes at a time; each
  // row by the block that owns its offset, skipped rows (zeros) by split 0
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // a fragment's row and column pair
  bf16* Cs = As;  // [BM][LDC]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(Cs + (16 * warp + g + 8 * h) * LDC + 8 * n + c2) =
          __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  __syncwarp();
  const unsigned own = (unsigned)offs[1 + KO];
  const bool vec_o = Cout % 8 == 0;
#pragma unroll
  for (int u = 0; u < BN / 16; ++u) {  // the warp's 16 rows x BN / 8 chunks
    const int e = lane + 32 * u;
    const int m = 16 * warp + e / (BN / 8), c = e % (BN / 8);
    const int s = srow[m], n = n0 + 8 * c;
    if (s < 0 || n >= Cout || (prow[m] >= 0 ? !((own >> poff[m]) & 1u) : sp != 0)) continue;
    bf16* dst = out + ((int64_t)b * S_f + s) * Cout + n;
    const bf16* src = Cs + m * LDC + 8 * c;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && n + i < Cout; ++i) dst[i] = src[i];
    }
  }
}

// (d) dy[b, off[b,i] * S_c + parent[b,i], :] = ct[b, i, :] for every fine
// row i whose parent is not the coarse pad row S_c - 1 (dy zero-filled by
// the wrapper): the scatter in JAX K3's backward (_conv_tr_chunk_bwd), the
// parent design of the port's down-map gathers.  The
// (offset, parent) pairs of a chunk's valid fine voxels are distinct
// (pointcontrast_tpu/sparse/topology.py:320-324); only the pad slot (0,
// S_c - 1) is named many times, by every pad fine row and every fine voxel
// that truncation orphaned.  Its sum reaches nothing valid (dF's row c
// reads only dy[k S_c + c], so only dF's pad row, and dW multiplies it by
// the zero pad features), so the kernel leaves those rows out, as
// scatter_sum leaves out the source's pad rows; every other destination is
// named once, so the rows are stored, with no atomic, and the result
// equals the twin's bit for bit.  A group of G lanes (row_groups) owns one
// fine row: lane 0 loads its parent and offset and a shuffle hands them on,
// and the lanes copy neighbouring float4s (C % 4 == 0, both tables 16-byte
// aligned) or floats.  HBM bytes bound it: the zero fill of dy, one read
// and one write of each kept row.  No division, 32-bit offsets (the
// wrapper refuses B S_f C or B 8 S_c C of 2^31 or more).
// grid (ceil(S_f / (256 / G)), B), one fine row a group: no cap.
template <int G, bool VEC, typename T>
__global__ void __launch_bounds__(256)
scatter_parent_kernel(const T* __restrict__ ct,
                      const int* __restrict__ parent,
                      const int* __restrict__ off, float* __restrict__ dy,
                      int S_f, int S_c, int C) {
  const int i = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (i >= S_f) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int row = b * S_f + i;
  int p = 0, o = 0;
  if (lane == 0) {
    p = __ldg(parent + row);
    o = __ldg(off + row);
  }
  p = row_groups::shfl<G>(p, 0);
  o = row_groups::shfl<G>(o, 0);
  if (p == S_c - 1) return;  // the pad slot: left out
  const T* src = ct + row * C;
  float* dst = dy + ((b * pg::KO + o) * S_c + p) * C;
  if constexpr (is_bf16<T>) {  // widened to f32 (exact) as it is stored
    if constexpr (VEC) {
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
      for (int u = lane; u < C / 4; u += G) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + u);
        d4[u] = make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < C; c += G) dst[c] = __bfloat162float(src[c]);
    }
  } else if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int u = lane; u < C / 4; u += G) d4[u] = __ldg(s4 + u);
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += G) dst[c] = __ldg(src + c);
  }
}

// (e) scatter_gemm: dF[b, map[taps[j]][b][s], :] += G[b, s, :] . W[j]^T for
// every listed tap j (W[j] is [Cin, Cout]), destination rows equal to
// `skip` (or outside [0, S_in)) left out: JAX K4 _conv_chunk_down_fused's
// dF (k3s2 windows overlap, so up to 8 coarse rows add into one fine row)
// and the flat _conv_core's, a scatter because a map may name a row many
// times.  What bounds it: 2 Cin Cout f32 operations per (row, tap) pair
// whose destination is live (f32 SIMT), and a map sends every missing
// neighbour to the pad row (a plain tiled kernel that computes every pair
// runs at 0.03-0.04 of that bound on the ResNets' K4 dF).  The design is
// gather_gemm's, with the roles turned round:
//  - a block owns BM = 128 cotangent rows of one chunk (128 consecutive
//    entries of `order`, the map's live order that K4's forward tiles by,
//    or 128 consecutive rows without it) and a Cin tile of 32 Q channels
//    (gg::q_for(Cin)); each thread 4 rows x 4Q columns in registers;
//  - prologue: the block reads its rows' destinations for all its taps
//    into shared memory, a ballot per 32 rows marks the live ones and
//    their counts place them: each tap's live rows are compacted, in row
//    order, to the front of the tile.  A tap with none leaves the step
//    list; at a tap, warp w computes compacted rows [16 w, 16 w + 16) and
//    skips the tap if they are past its live count, so a (tile, tap) costs
//    its live rows rounded up to 16 (the order still gathers each tap's
//    live rows into few tiles);
//  - main loop over (live tap, 32-deep Cout chunk) steps through
//    gather_gemm's 3-stage cp.async ring: the tap's compacted cotangent
//    rows (zero-filled past its live count), and W[j]^T's tile staged
//    as 32 Q rows of W[j] by gg_load_rows (16-byte chunks of row n at
//    index XOR (n / 4) % 8), so a quarter-warp's 8 row reads in sg_mma hit
//    8 distinct bank groups.  W is never transposed in memory;
//  - after a tap's last Cout chunk each thread adds its 4 rows x 4Q
//    columns into their live destination rows, by float4 atomics where
//    Cin % 4 == 0 and dF is 16-byte aligned (sm_90 has vector atomics on
//    global memory), scalar ones otherwise, and clears its accumulators.
//    The atomics stay because a map may repeat a destination, so the sums'
//    order, and their last bits, change from run to run;
//  - few blocks (the deep levels, the 1-tap maps at Cout 1024-2048): the
//    wrapper splits each tile's step list over `splits` blocks, each adding
//    its part with the same atomics (no combine).
namespace sg {
// the layout scatter_gemm_kernel carves: gather_gemm's ring (As, Bs), then
// each tap's destinations and ballots, the live tap list (count, then
// taps), each tap's live count, the tile's cotangent rows, and each tap's
// compacted rows (one byte each)
inline size_t smem_bytes(int Q, int T, int esize = 4) {
  return (size_t)esize * gg::STAGES * (gg::BM * gg::BK + gg::BK * 32 * Q) +
         sizeof(int) * (T * gg::BM + T * gg::BALLOTS + (T + 1) + T + gg::BM) +
         (size_t)T * gg::BM;
}
}  // namespace sg

template <int Q>
__device__ __forceinline__ void sg_mma(float4 (&acc)[gg::TM][Q], const float* as,
                                       const float* bs, int sw, int tx) {
  constexpr int BK = gg::BK;
#pragma unroll
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float4 a[gg::TM];
#pragma unroll
    for (int i = 0; i < gg::TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + i * BK + ((k4 ^ sw) << 2));
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float4 w[4];  // rows 4 tx + 32 q + c of W[j], depths 4 k4 .. 4 k4 + 3
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = *reinterpret_cast<const float4*>(bs + (4 * tx + 32 * q + c) * BK +
                                                ((k4 ^ tx) << 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wk = make_float4(lane_of(w[0], kk), lane_of(w[1], kk),
                                      lane_of(w[2], kk), lane_of(w[3], kk));
#pragma unroll
        for (int i = 0; i < gg::TM; ++i) fma4(acc[i][q], lane_of(a[i], kk), wk);
      }
    }
  }
}

// Add the 4 columns n..n+3 of v into a row (one float4 atomic when `vec`:
// C % 4 == 0 and the row 16-byte aligned), those at or past C left out.
__device__ __forceinline__ void atomic_add4(float* row, int n, int C, bool vec,
                                            const float4& v) {
  if (vec) {
    if (n < C) atomicAdd(reinterpret_cast<float4*>(row + n), v);
    return;
  }
  if (n < C) atomicAdd(row + n, v.x);
  if (n + 1 < C) atomicAdd(row + n + 1, v.y);
  if (n + 2 < C) atomicAdd(row + n + 2, v.z);
  if (n + 3 < C) atomicAdd(row + n + 3, v.w);
}

// grid (ceil(S_out / BM), ceil(Cin / 32 Q), B * splits)
// The scatter GEMMs' prologue (scatter_gemm_kernel, scatter_gemm_mma_kernel):
// the tile's cotangent rows `srow` [BM] (through `order` where given, -1
// past S_out), their destinations at each of the T taps `rows` [T][BM] (-1
// where skipped or out of the table), a ballot a 32 rows of which are live
// `ball` [T][BALLOTS], each tap's live rows compacted in row order `crow`
// [T][BM] and counted `nlive` [T], and the taps with a live row `live`
// (their count, then their indices).  Ends with a __syncthreads.
__device__ __forceinline__ void sg_prologue(int* srow, int* rows, unsigned* ball, int* live,
                                            int* nlive, unsigned char* crow,
                                            const int* __restrict__ map, const TapList& taps,
                                            int T, const int* __restrict__ order, int b, int s0,
                                            int B, int S_in, int S_out, int skip) {
  constexpr int BM = gg::BM, THREADS = gg::THREADS, BALLOTS = gg::BALLOTS;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < BM) {
    const int s = s0 + tid;
    srow[tid] = s >= S_out ? -1 : order != nullptr ? __ldg(order + (int64_t)b * S_out + s) : s;
  }
  __syncthreads();
  for (int e = tid; e < T * BM; e += THREADS) {  // whole warps: T * BM % 32 == 0
    const int s = srow[e % BM];
    int r = -1;
    if (s >= 0) {
      r = row_of(map, taps, 0, e / BM, b, s, B, S_out);
      if (r == skip || r < 0 || r >= S_in) r = -1;
    }
    rows[e] = r;
    const unsigned bits = __ballot_sync(0xffffffffu, r >= 0);
    if (lane == 0) ball[e >> 5] = bits;
  }
  __syncthreads();
  for (int e = tid; e < T * BM; e += THREADS) {
    if (rows[e] < 0) continue;
    const int t = e / BM, c = (e % BM) >> 5;
    int at = __popc(ball[e >> 5] & ((1u << lane) - 1u));
    for (int p = 0; p < c; ++p) at += __popc(ball[t * BALLOTS + p]);
    crow[t * BM + at] = (unsigned char)(e % BM);
  }
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t) {
      int k = 0;
#pragma unroll
      for (int c = 0; c < BALLOTS; ++c) k += __popc(ball[t * BALLOTS + c]);
      nlive[t] = k;
      if (k) live[1 + n++] = t;
    }
    live[0] = n;
  }
  __syncthreads();
}

template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
scatter_gemm_kernel(const float* __restrict__ G, const int* __restrict__ map,
                    const __grid_constant__ TapList taps, int T, const float* __restrict__ W,
                    const int* __restrict__ order, float* __restrict__ dF, int splits, int B,
                    int S_out, int S_in, int Cin, int Cout, int skip, int vec_g, int vec_w,
                    int vec_o) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES, THREADS = gg::THREADS;
  constexpr int TM = gg::TM, BALLOTS = gg::BALLOTS, BN = 32 * Q;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                   // [STAGES][BM][BK]
  float* Bs = As + STAGES * BM * BK;                  // [STAGES][BN][BK]: W[j] rows
  int* rows = reinterpret_cast<int*>(Bs + STAGES * BN * BK);  // [T][BM] destinations
  unsigned* ball = reinterpret_cast<unsigned*>(rows + T * BM);  // [T][BALLOTS]
  int* live = reinterpret_cast<int*>(ball + T * BALLOTS);  // count, then taps
  int* nlive = live + T + 1;  // [T] live rows a tap
  int* srow = nlive + T;      // [BM] the tile's cotangent rows, -1 past S_out
  unsigned char* crow = reinterpret_cast<unsigned char*>(srow + BM);  // [T][BM]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const float* Gb = G + (int64_t)b * S_out * Cout;
  float* dFb = dF + (int64_t)b * S_in * Cin;

  sg_prologue(srow, rows, ball, live, nlive, crow, map, taps, T, order, b, s0, B, S_in,
              S_out, skip);
  const int kchunks = (Cout + BK - 1) / BK;
  const int total = live[0] * kchunks;  // this split: steps [lo, hi) of the tile's list
  const int lo = sp * total / splits, nsteps = (sp + 1) * total / splits - lo;

  auto load = [&](int step, int buf) {
    const int t = live[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    const unsigned char* ct = crow + t * BM;
    const int n = nlive[t];
    gg_load_rows(As + buf * BM * BK, Gb, [&](int m) { return m < n ? srow[ct[m]] : -1; },
                 k0, Cout, vec_g, tid);
    gg_load_rows<BN>(Bs + buf * BN * BK, W + (int64_t)t * Cin * Cout,
                     [&](int n) { return n0 + n < Cin ? n0 + n : -1; }, k0, Cout, vec_w, tid);
  };

  float4 acc[TM][Q];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(lo + st, st);
    cp_async_commit();
  }
  const int sw = ty & 7;  // the swizzle of this thread's rows: (4 ty + i) / 4 % 8
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(lo + next, next % STAGES);
      cp_async_commit();
    }
    const int gstep = lo + step;
    const int t = live[1 + gstep / kchunks];
    if (16 * warp >= nlive[t]) continue;  // this warp's 16 compacted rows are past the tap's
    sg_mma<Q>(acc, As + (step % STAGES) * BM * BK + 4 * ty * BK, Bs + (step % STAGES) * BN * BK,
              sw, tx);
    if ((gstep + 1) % kchunks != 0 && step != nsteps - 1) continue;
    // the tap's last chunk (of this split): add into the destinations
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int j = 4 * ty + i;
      const int r = j < nlive[t] ? rows[t * BM + crow[t * BM + j]] : -1;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (r >= 0) atomic_add4(dFb + (int64_t)r * Cin, n0 + 4 * tx + 32 * q, Cin, vec_o, acc[i][q]);
        acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  cp_async_wait<0>();
}

// scatter_gemm_bf16 on the tensor cores (the bf16 form of (e), JAX
// _conv_chunk_down_fused_bwd's dF in bf16, pointcontrast_tpu/sparse/ops.py
// :578-615, and the flat conv's): ct and W^T widened to f32 there, so each
// product is bf16 x bf16, exact in f32, and the sums f32 in an f32 dF, one
// rounding to the features' bf16 after the whole scatter (the wrapper's).
// The f32 kernel's prologue (sg_prologue: each tap's live cotangent rows
// compacted), live orders, 3-stage cp.async ring and step splits, with the
// products on mma.sync.m16n8k16 bf16 -> f32:
//  - warp w computes compacted rows [16 w, 16 w + 16) x the block's Cin
//    tile BN = 32 Q (Q = 1..4, gm::q_for), two k16 steps a 32-deep Cout
//    chunk, the second left out past Cout;
//  - A fragments by ldmatrix.x4 from the compacted row tile; W[j]^T is
//    staged as BN rows of W[j] (Cin rows of Cout depths, never transposed
//    in memory), which is the m16n8k16 B operand's column-major form, so
//    plain ldmatrix.x4 gives its fragments; both tiles in mma_chunk's
//    swizzle;
//  - after a tap's last Cout chunk (or the split's last step) each quad of
//    lanes swaps its rows' column pairs (one __shfl_xor_sync), so that each
//    lane holds 4 neighbouring columns of one row, and adds them into the
//    f32 dF with one float4 atomic (scalar ones where Cin % 4 != 0 or dF is
//    unaligned).  The atomics' order changes the sums' last bits from run
//    to run: the checks hold dF to a bound of the exact sum
//    (sparse/kernels.py scatter_gemm_bf16_bound), not to bits.
// grid (ceil(S_out / BM), ceil(Cin / 32 Q), B * splits)
template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
scatter_gemm_mma_kernel(const bf16* __restrict__ G, const int* __restrict__ map,
                        const __grid_constant__ TapList taps, int T, const bf16* __restrict__ W,
                        const int* __restrict__ order, float* __restrict__ dF, int splits, int B,
                        int S_out, int S_in, int Cin, int Cout, int skip, int vec_g, int vec_w,
                        int vec_o) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES, THREADS = gg::THREADS;
  constexpr int BALLOTS = gg::BALLOTS, BN = 32 * Q, NF = 4 * Q;
  extern __shared__ __align__(16) float smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);           // [STAGES][BM][BK]
  bf16* Bs = As + STAGES * BM * BK;                    // [STAGES][BN][BK]: W[j] rows
  int* rows = reinterpret_cast<int*>(Bs + STAGES * BN * BK);  // [T][BM] destinations
  unsigned* ball = reinterpret_cast<unsigned*>(rows + T * BM);  // [T][BALLOTS]
  int* live = reinterpret_cast<int*>(ball + T * BALLOTS);  // count, then taps
  int* nlive = live + T + 1;  // [T] live rows a tap
  int* srow = nlive + T;      // [BM] the tile's cotangent rows, -1 past S_out
  unsigned char* crow = reinterpret_cast<unsigned char*>(srow + BM);  // [T][BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const bf16* Gb = G + (int64_t)b * S_out * Cout;
  float* dFb = dF + (int64_t)b * S_in * Cin;

  sg_prologue(srow, rows, ball, live, nlive, crow, map, taps, T, order, b, s0, B, S_in,
              S_out, skip);
  const int kchunks = (Cout + BK - 1) / BK;
  const int total = live[0] * kchunks;  // this split: steps [lo, hi) of the tile's list
  const int lo = sp * total / splits, nsteps = (sp + 1) * total / splits - lo;

  auto load = [&](int step, int buf) {
    const int t = live[1 + step / kchunks];
    const int k0 = (step % kchunks) * BK;
    const unsigned char* ct = crow + t * BM;
    const int n = nlive[t];
    gg_load_rows<BM>(As + buf * BM * BK, Gb,
                           [&](int m) { return m < n ? srow[ct[m]] : -1; }, k0, Cout, vec_g,
                           tid);
    sg_load_wt<Q>(Bs + buf * BN * BK, W + (int64_t)t * Cin * Cout, n0, k0, Cin, Cout, vec_w,
                  tid);
  };

  float acc[NF][4];  // fragment n: columns 8 n + 2 (lane % 4) + {0, 1}, rows lane / 4 + {0, 8}
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(lo + st, st);
    cp_async_commit();
  }
  const int g = lane >> 2, odd = lane & 1;
  // after the swap: this lane's row (g, or g + 8 on odd lanes) and its 4
  // columns' offset in a fragment
  const int half = odd ? 8 : 0, col4 = 2 * (lane & 3) - 2 * odd;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(lo + next, next % STAGES);
      cp_async_commit();
    }
    const int gstep = lo + step;
    const int t = live[1 + gstep / kchunks];
    if (16 * warp >= nlive[t]) continue;  // this warp's 16 compacted rows are past the tap's
    const int k0 = (gstep % kchunks) * BK;
    sg_mma_bf16<Q>(acc, As + (step % STAGES) * BM * BK, Bs + (step % STAGES) * BN * BK, warp,
                   lane, Cout - k0);
    if ((gstep + 1) % kchunks != 0 && step != nsteps - 1) continue;
    // the tap's last chunk (of this split): add into the destinations
    const int m = 16 * warp + g + half;
    const int r = m < nlive[t] ? rows[t * BM + crow[t * BM + m]] : -1;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      // even lanes keep row g's pair and take the partner's; odd lanes row g + 8's
      const float s0v = odd ? acc[n][0] : acc[n][2], s1v = odd ? acc[n][1] : acc[n][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0v, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1v, 1);
      const float4 v = odd ? make_float4(r0, r1, acc[n][2], acc[n][3])
                           : make_float4(acc[n][0], acc[n][1], r0, r1);
      if (r >= 0) atomic_add4(dFb + (int64_t)r * Cin, n0 + 8 * n + col4, Cin, vec_o, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    }
  }
  cp_async_wait<0>();
}

namespace seg {
constexpr int THREADS = 256;
constexpr int SMEM = 16;               // segments the deterministic path takes
constexpr int U = 8;                   // rows a group loads before it adds them
constexpr int STAGE = 80 * 1024;       // bytes of partials a combine round stages
constexpr int MAX_BLOCKS = 1024;       // blocks a channel tile (the combine's lists)
constexpr int WARPS = THREADS / 32;
constexpr int VEC_GROUP = 8;           // lanes a float4 row at most: 32 channels

// Floats a lane holds of a row: a float4, or 4 scalars at G = 1 and 32
// (lane + G k), else one; a channel tile is G of those (a multiple of 4:
// the combine stages partial rows 16 bytes at a time).
template <int G, bool VEC>
__host__ __device__ constexpr int per_lane() {
  return VEC || G == 1 || G == 32 ? 4 : 1;
}
template <int G, bool VEC>
__host__ __device__ constexpr int tile() {
  return G * per_lane<G, VEC>();
}
// old = *t; *t = old >= last ? 0 : old + 1; returns old.  Release: every
// write that happens before it (the block's, through __syncthreads) is
// seen by the block that reads `last` from it (acquire).
__device__ __forceinline__ unsigned ticket(unsigned* t, unsigned last) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(t), "r"(last) : "memory");
  return old;
}
// The tile channel of a lane's value k.
template <int G, bool VEC>
__device__ __forceinline__ int chan(int lane, int k) {
  return VEC ? 4 * lane + k : lane + G * k;
}
}  // namespace seg

// (f) segment_sum: out[ids[i], :] += X[i, :] over N rows of C channels,
// rows with an id outside [0, S) left out.  JAX K5: jax.ops.segment_sum
// under global_pool, its counts over ones, and the adjoint of
// broadcast_to_points (pointcontrast_tpu/sparse/ops.py:967-998).  It reads
// each row once, so HBM bytes bound it, and at the callers' sizes (0.6-68
// MB a launch) the latency of a launch's dependent steps weighs as much.
// Its callers' ids come in long runs (a chunk's valid prefix carries its
// sample and its pad tail num_batch; flat ids are sorted), at S =
// num_batch + 1 <= 9.  The design:
//  - a group of G lanes (row_groups::size_for, at most seg::VEC_GROUP on
//    float4s) owns a row at a time; lane l holds the channels seg::chan of
//    the block's channel tile, a float4 where C % 4 == 0 and X is 16-byte
//    aligned (tiles of 32 channels, a row's 128-byte line), so at C = 1
//    (the counts) a warp reads 32 rows a step; the tiles are the grid's y;
//  - a block owns one contiguous span of rows (the wrapper aims at about
//    one block an SM over all the tiles); its NG groups take rows g,
//    g + NG, ... of it, each loading seg::U rows (ids with them) before it
//    adds any: 32 KB in flight a block at float4s;
//  - a group keeps (cur, acc) in registers and, where the id changes, adds
//    acc into a shared-memory slot that it alone owns, [group][S][tile], a
//    plain add in the group's row order; at the span's end a fixed
//    pairwise tree adds the groups' slots, and the block writes one partial
//    for each segment it touched, and a bit mask of them, into the
//    wrapper's workspace;
//  - the tile's last block, by an integer ticket (seg::ticket, an acq_rel
//    atomicInc that wraps to 0 for the next launch on the stream), lists
//    each segment's blocks in block order (ballots over the masks), stages
//    their partials with cp.async (seg::STAGE bytes a round), adds them in
//    that order, 256 threads over (segment, channel), and writes every row
//    of out (zeros for an untouched segment).
// So for S <= seg::SMEM (det) the sum is the same from launch to launch,
// with no f32 atomic.  The general path (S > seg::SMEM) runs the same loop
// and adds each run's sum to out (zeroed by the wrapper) with f32 atomics
// (16 bytes an atomic on float4 rows), whose order varies.  `combine` = 0 stops before the last block's combine
// (chip_smoke.py times that to give the combine's share).
// grid (blocks, tiles), seg::THREADS threads; dynamic shared memory: the
// slots, or the combine's lists and stage (pc_segment_sum sizes it).
template <int G, bool VEC>
__global__ void __launch_bounds__(seg::THREADS)
segment_sum_kernel(const float* __restrict__ X, const int* __restrict__ ids,
                   float* __restrict__ out, float* __restrict__ ws,
                   unsigned* __restrict__ tickets, int N, int C, int S, int span,
                   int stage_rows, int det, int combine) {
  constexpr int F = seg::per_lane<G, VEC>(), TW = seg::tile<G, VEC>();
  constexpr int NG = seg::THREADS / G;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned block_mask;
  __shared__ int last;
  __shared__ int start[seg::SMEM + 1];
  const int tid = threadIdx.x, g = tid / G, lane = tid % G;
  const int c0 = blockIdx.y * TW;
  const int tw = min(TW, C - c0);
  float* slot = smem;  // [NG][S][tw]
  if (det) {
    for (int i = tid; i < NG * S * tw; i += seg::THREADS) slot[i] = 0.f;
  }
  if (tid == 0) block_mask = 0u;
  __syncthreads();

  const int r0 = blockIdx.x * span;
  const int r1 = min(N, r0 + span);
  int cur = -1;
  unsigned touched = 0u;  // bit s: this group added a run of segment s
  float acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.f;
  auto flush = [&]() {
    if (cur < 0 || cur >= S) return;
    if (det) {
      float* d = slot + (g * S + cur) * tw;
      if constexpr (VEC) {
        if (4 * lane < tw) {
          float4* p = reinterpret_cast<float4*>(d + 4 * lane);
          float4 v = *p;
          v.x += acc[0];
          v.y += acc[1];
          v.z += acc[2];
          v.w += acc[3];
          *p = v;
        }
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const int c = seg::chan<G, VEC>(lane, k);
          if (c < tw) d[c] += acc[k];
        }
      }
      touched |= 1u << cur;
    } else {  // float4 atomics on float4 rows (out is 16-byte aligned)
      float* d = out + (int64_t)cur * C + c0;
      if constexpr (VEC) {
        atomic_add4(d, 4 * lane, tw, true, make_float4(acc[0], acc[1], acc[2], acc[3]));
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const int c = seg::chan<G, VEC>(lane, k);
          if (c < tw) atomicAdd(d + c, acc[k]);
        }
      }
    }
  };
  for (int base = r0 + g; base < r1; base += NG * seg::U) {
    int id[seg::U];
    float v[seg::U][F];
#pragma unroll
    for (int u = 0; u < seg::U; ++u) {
      const int r = base + u * NG;
      const bool in = r < r1;
      id[u] = in ? __ldg(ids + r) : -1;
      const float* row = X + (in ? r : 0) * C + c0;  // N C < 2^31: the wrapper checks
      if constexpr (VEC) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && 4 * lane < tw) q = __ldg(reinterpret_cast<const float4*>(row + 4 * lane));
        v[u][0] = q.x;
        v[u][1] = q.y;
        v[u][2] = q.z;
        v[u][3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const int c = seg::chan<G, VEC>(lane, k);
          v[u][k] = in && c < tw ? __ldg(row + c) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < seg::U; ++u) {
      if (id[u] != cur) {
        flush();
        cur = id[u];
#pragma unroll
        for (int k = 0; k < F; ++k) acc[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < F; ++k) acc[k] += v[u][k];
    }
  }
  flush();
  if (!det) return;

  // the block's partial: the groups' slots added by a fixed pairwise tree
  if (lane == 0 && touched) atomicOr(&block_mask, touched);
  __syncthreads();
  const int E = S * tw;  // elements (segment, channel) of a partial
  for (int h = NG / 2; h >= 1; h >>= 1) {
    const int n = h * E;
    for (int e = tid; e < n; e += seg::THREADS) slot[e] += slot[e + n];
    __syncthreads();
  }
  const unsigned mask = block_mask;
  const int nb = gridDim.x;
  const int blk = blockIdx.y * nb + blockIdx.x;
  float* part = ws + (int64_t)blk * S * TW;  // [S][TW]: the rows of touched segments
  for (int e = tid; e < E; e += seg::THREADS) {
    const int s = e / tw;
    if (mask >> s & 1u) part[s * TW + e - s * tw] = slot[e];
  }
  unsigned* masks = reinterpret_cast<unsigned*>(ws + (int64_t)nb * gridDim.y * S * TW);
  if (tid == 0) masks[blk] = mask;
  __syncthreads();  // the block's writes happen before its ticket's release
  if (tid == 0) last = seg::ticket(tickets + blockIdx.y, nb - 1) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last || !combine) return;

  // the tile's last block: each segment's blocks in block order, as
  // (s << 16 | b) in list[start[s] ...], then their partials added in it
  unsigned* bm = reinterpret_cast<unsigned*>(smem);  // [nb]
  int* list = reinterpret_cast<int*>(bm + nb);        // [nb * S]
  float* stage = smem + ((nb + nb * S + 3) & ~3);     // [stage_rows][TW]
  for (int b = tid; b < nb; b += seg::THREADS) bm[b] = __ldcg(masks + blockIdx.y * nb + b);
  __syncthreads();
  const int warp = tid >> 5, wl = tid & 31;
  for (int s = warp; s < S; s += seg::WARPS) {
    int k = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + wl;
      k += __popc(__ballot_sync(0xffffffffu, b < nb && (bm[b] >> s & 1u)));
    }
    if (wl == 0) start[s + 1] = k;
  }
  __syncthreads();
  if (tid == 0) {
    start[0] = 0;
    for (int s = 0; s < S; ++s) start[s + 1] += start[s];
  }
  __syncthreads();
  for (int s = warp; s < S; s += seg::WARPS) {
    int k = start[s];
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + wl;
      const bool hit = b < nb && (bm[b] >> s & 1u);
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (hit) list[k + __popc(bits & ((1u << wl) - 1u))] = s << 16 | b;
      k += __popc(bits);
    }
  }
  __syncthreads();
  constexpr int OUTS = (seg::SMEM * TW + seg::THREADS - 1) / seg::THREADS;
  float sum[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) sum[i] = 0.f;
  const int pairs = start[S];
  for (int p0 = 0; p0 < pairs; p0 += stage_rows) {
    const int len = min(stage_rows, pairs - p0);
    for (int e = tid; e < len * (TW / 4); e += seg::THREADS) {
      const int p = e / (TW / 4), q = e % (TW / 4);
      const int pr = list[p0 + p];
      const float* src =
          ws + ((int64_t)(blockIdx.y * nb + (pr & 0xffff)) * S + (pr >> 16)) * TW + 4 * q;
      cp_async16(stage + p * TW + 4 * q, src, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int e = tid + i * seg::THREADS;
      if (e < E) {
        const int s = e / tw, c = e - s * tw;
        // the round's rows of segment s: [lo, hi) of the stage
        const int lo = max(start[s], p0) - p0, hi = min(start[s + 1], p0 + len) - p0;
        const float* col = stage + c;
        float v = sum[i];
        int p = lo;
        for (; p + 4 <= hi; p += 4) {  // four loads in flight, added in order
          const float a0 = col[p * TW], a1 = col[(p + 1) * TW], a2 = col[(p + 2) * TW],
                      a3 = col[(p + 3) * TW];
          v += a0;
          v += a1;
          v += a2;
          v += a3;
        }
        for (; p < hi; ++p) v += col[p * TW];
        sum[i] = v;
      }
    }
    __syncthreads();  // the stage is refilled next round
  }
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int e = tid + i * seg::THREADS;
    if (e < E) {
      const int s = e / tw;
      out[(int64_t)s * C + c0 + e - s * tw] = sum[i];
    }
  }
}

// (g) out[b,s,:] = sum_j X[b, row(j,b,s), :] over the T listed taps, added
// in tap order from zero, as JAX's sum(...) of row gathers adds them (so the
// result equals the plain twin bit for bit).  Rows outside [0, S_in) add
// nothing.  It runs the K5 pools (K = 8; the average's count at C = 1), the
// unpools and the brick placement and up gathers (K = 1), and is the port
// of the nine Pallas gather probes (K = 1 and 27).  No multiply: the work is
// one read of each gathered row and one write of each output row, so HBM
// bytes bound it.  The design:
//  - a group of G lanes (row_groups::size_for) owns one output row.  Its
//    lanes first read the row's T indices once (tap l, l + G, ... for lane
//    l) and a ballot keeps a bit per tap whose row lies in [0, S_in);
//  - the lanes then read neighbouring float4s (C % 4 == 0, both tables
//    16-byte aligned; else neighbouring floats) of each kept row, in tap
//    order, the row coming from the lane that read it through a shuffle
//    (T <= G) or again from L1 (T > G), and write the sum once;
//  - the tap list is a __grid_constant__ parameter, read in place: a plain
//    by-value struct indexed by a lane's tap is copied to each thread's
//    stack (ptxas: 128 bytes a thread);
//  - no division, 32-bit offsets (the wrapper refuses index spaces of 2^31
//    or more): the grid's y is the chunk b.
// K = 1 takes gather_one_kernel below.
// grid (ceil(S_out / (256 / G)), B), one output row a group: no cap.
template <int G, bool VEC>
__global__ void __launch_bounds__(256)
gather_sum_kernel(const float* __restrict__ X, const int* __restrict__ map,
                  const __grid_constant__ TapList taps, int tap_stride, int T,
                  float* __restrict__ out, int B, int S_in, int S_out, int C) {
  const int s = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (s >= S_out) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  unsigned kept = 0;  // bit j: tap j's row lies in [0, S_in)
  int mine = -1;      // the row of tap `lane` (T <= G)
  for (int j0 = 0; j0 < T; j0 += G) {
    const int j = j0 + lane;
    const int r = j < T ? row_of32(map, taps, tap_stride, j, b, s, B, S_out) : -1;
    if (j0 == 0) mine = r;
    kept |= row_groups::ballot<G>(r >= 0 && r < S_in) << j0;
  }
  const float* xb = X + b * S_in * C;
  float* o = out + (b * S_out + s) * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u0 = 0; u0 < units; u0 += G) {  // the same trip count for every lane
    const int u = u0 + lane;
    const bool live = u < units;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      int r = T <= G ? row_groups::shfl<G>(mine, j) : 0;  // every lane shuffles
      if (!live || !((kept >> j) & 1u)) continue;
      if (T > G) r = row_of32(map, taps, tap_stride, j, b, s, B, S_out);
      if constexpr (VEC) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(xb + r * C) + u);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      } else {
        acc.x += __ldg(xb + r * C + u);
      }
    }
    if (!live) continue;
    if constexpr (VEC) {
      reinterpret_cast<float4*>(o)[u] = acc;
    } else {
      o[u] = acc.x;
    }
  }
}

// (g) at one tap, a row gather: out[b,s,:] = X[b, row(0,b,s), :], or zeros
// where that row lies outside [0, S_in).  Lane 0 of the group loads the
// row's index and a shuffle hands it on; the lanes copy the row as
// gather_rows_kernel does (detect_ops.cu), with no accumulator.
// grid (ceil(S_out / (256 / G)), B).
template <int G, bool VEC>
__global__ void __launch_bounds__(256)
gather_one_kernel(const float* __restrict__ X, const int* __restrict__ map,
                  int tap, float* __restrict__ out, int B, int S_in, int S_out,
                  int C) {
  const int s = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (s >= S_out) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  int r = 0;
  if (lane == 0) r = map != nullptr ? __ldg(map + (tap * B + b) * S_out + s) : s;
  r = row_groups::shfl<G>(r, 0);
  const bool in = r >= 0 && r < S_in;
  const float* src = X + (b * S_in + (in ? r : 0)) * C;
  float* dst = out + (b * S_out + s) * C;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int u = lane; u < C / 4; u += G)
      d4[u] = in ? __ldg(s4 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += G) dst[c] = in ? __ldg(src + c) : 0.f;
  }
}

// (h) out[b, row(j,b,s), :] += G[b,s,:] for every listed tap j, rows at or
// past `limit` (and below 0) left out: the adjoint of (g), under JAX's
// autodiff of the pooling ops' and the brick layout's row gathers.  It reads
// each kept cotangent row once and adds it into out, so HBM bytes bound it,
// as long as the adds do not pile onto a few rows: f32 atomics on one
// address run one after another.  Every map that feeds it sends its missing
// sources to one pad row (the chunk's last row; on a brick table slot 0 of
// the pad brick), which is why the skip is a bound and not a row: a brick
// table's caller passes (NB - 1) * 8, so the pad brick's 8 slots are left
// out, and a new map kind has to check where its pad sources point before
// it passes a limit.  The design:
//  - a group of G lanes (row_groups::size_for) owns one G row; its lanes
//    first read the row's T destinations (tap l, l + G, ... for lane l) and
//    a ballot keeps a bit per destination below the limit.  A row with no
//    kept destination leaves without reading G;
//  - the lanes then read neighbouring float4s (or floats) of the row once
//    and add them to each kept destination, one 16-byte atomicAdd a float4
//    (sm_90 has it for global memory), the destination coming from the
//    lane that read it through a shuffle (T <= G) or from L1 (T > G);
//  - no division, 32-bit offsets (the wrapper refuses index spaces of 2^31
//    or more): the grid's y is the sample;
//  - the tap list is a __grid_constant__ parameter: a lane's own tap is read
//    from the parameter bank, where a plain by-value struct indexed by a
//    lane-dependent tap would be copied to each thread's local memory
//    (128 bytes a thread, more traffic than the rows themselves).
// With the pad rows left out, the brick adjoints name every destination at
// most once and the result equals the plain twin bit for bit; the unpools'
// adjoint adds up to 8 children into one parent in no fixed order.
// grid (ceil(S_g / (256 / G)), B), one G row a group: no cap.
template <int G, bool VEC>
__global__ void __launch_bounds__(256)
scatter_sum_kernel(const float* __restrict__ Gr, const int* __restrict__ map,
                   const __grid_constant__ TapList taps, int tap_stride, int T,
                   float* __restrict__ out,
                   int B, int S_g, int S_out, int C, int limit) {
  const int s = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (s >= S_g) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  unsigned kept = 0;  // bit j: tap j's destination is added
  int mine = -1;      // the destination of tap `lane` (T <= G)
  for (int j0 = 0; j0 < T; j0 += G) {
    const int j = j0 + lane;
    const int r = j < T ? row_of32(map, taps, tap_stride, j, b, s, B, S_g) : -1;
    if (j0 == 0) mine = r;
    kept |= row_groups::ballot<G>(r >= 0 && r < limit) << j0;
  }
  if (kept == 0) return;
  const float* g = Gr + (b * S_g + s) * C;
  float* ob = out + b * S_out * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u0 = 0; u0 < units; u0 += G) {  // the same trip count for every lane
    const int u = u0 + lane;
    const bool live = u < units;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      if constexpr (VEC) {
        v = __ldg(reinterpret_cast<const float4*>(g) + u);
      } else {
        v.x = __ldg(g + u);
      }
    }
    for (unsigned k = kept; k != 0; k &= k - 1) {
      const int j = __ffs(k) - 1;
      const int r = T <= G ? row_groups::shfl<G>(mine, j)
                           : row_of32(map, taps, tap_stride, j, b, s, B, S_g);
      if (!live) continue;
      float* o = ob + r * C + u * V;
      if constexpr (VEC) {  // one 16-byte atomic (sm_90, global memory)
        atomicAdd(reinterpret_cast<float4*>(o), v);
      } else {
        atomicAdd(o, v.x);
      }
    }
  }
}

// The bf16 forms of (g) and (h): JAX's bf16 pools and their autodiff
// (pointcontrast_tpu/sparse/ops.py:906-964), whose rounding points XLA's CPU
// code fixes, and the CPU tests pin bit for bit:
//  - the chunked sum and average pools add the K gathered bf16 tables with
//    Python's sum, each add a bf16 op: ((0 + x[r_0]) + x[r_1]) + ..., every
//    add rounded, in tap order (EACH); the flat pools sum a [K, N, C] gather
//    with jnp.sum, which adds in f32 and rounds once (EACH false);
//  - the adjoint of a row gather is XLA's bf16 scatter-add, which adds each
//    destination's contributions in ascending source-row order, every add
//    rounded.  Through the pools' down maps every fine row below the pad
//    rows is one (tap, coarse row)'s at most, so each value is a copy
//    (scatter_store_bf16_kernel); the unpool's adjoint adds up to 8 children
//    into each parent (scatter_sum_inv_bf16_kernel, destination-major over
//    the children the level's down map names, sorted: no atomics).
// Each value is widened to f32 (exact), added in f32 (the sum of two bf16
// values is exact in f32 wherever a bf16 rounding of it could depend on
// the bits past f32) and rounded to bf16 with __float2bfloat16_rn after each
// add: bit-equal to the plain twins, the same bits from run to run.  Like
// the f32 forms, HBM bytes bound them.
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void bf_round4(float4& v) {
  v.x = bf_round(v.x);
  v.y = bf_round(v.y);
  v.z = bf_round(v.z);
  v.w = bf_round(v.w);
}

// 4 bf16 values from global memory (8 bytes, read-only path), widened
__device__ __forceinline__ float4 ldg4_bf16(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

// (g) in bf16: out[b,s,:] = sum_j X[b, row(j,b,s), :] over the listed taps in
// tap order, from zero, rounded to bf16 after every add (EACH) or once
// after the f32 sum.  gather_sum_kernel's lane groups (VEC: 4 values a
// lane a step, C % 4 == 0 and both tables 8-byte aligned).
// grid (ceil(S_out / (256 / G)), B).
template <int G, bool VEC, bool EACH>
__global__ void __launch_bounds__(256)
gather_sum_bf16_kernel(const bf16* __restrict__ X, const int* __restrict__ map,
                       const __grid_constant__ TapList taps, int tap_stride, int T,
                       bf16* __restrict__ out, int B, int S_in, int S_out, int C) {
  const int s = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (s >= S_out) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  unsigned kept = 0;  // bit j: tap j's row lies in [0, S_in)
  int mine = -1;      // the row of tap `lane` (T <= G)
  for (int j0 = 0; j0 < T; j0 += G) {
    const int j = j0 + lane;
    const int r = j < T ? row_of32(map, taps, tap_stride, j, b, s, B, S_out) : -1;
    if (j0 == 0) mine = r;
    kept |= row_groups::ballot<G>(r >= 0 && r < S_in) << j0;
  }
  const bf16* xb = X + b * S_in * C;
  bf16* o = out + (b * S_out + s) * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u0 = 0; u0 < units; u0 += G) {  // the same trip count for every lane
    const int u = u0 + lane;
    const bool live = u < units;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      int r = T <= G ? row_groups::shfl<G>(mine, j) : 0;  // every lane shuffles
      if (!live || !((kept >> j) & 1u)) continue;
      if (T > G) r = row_of32(map, taps, tap_stride, j, b, s, B, S_out);
      if constexpr (VEC) {
        add4(acc, ldg4_bf16(xb + r * C + 4 * u));
        if constexpr (EACH) bf_round4(acc);
      } else {
        acc.x += __bfloat162float(xb[r * C + u]);
        if constexpr (EACH) acc.x = bf_round(acc.x);
      }
    }
    if (!live) continue;
    if constexpr (VEC) {
      store4(o, 4 * u, C, true, acc);  // rounds (exact under EACH)
    } else {
      o[u] = __float2bfloat16_rn(acc.x);
    }
  }
}

// (h) in bf16 where no destination below `limit` is named twice (the sum and
// average pools' down maps: one (tap, coarse row) a fine row): each kept
// destination row is stored once, 0 + the cotangent row rounded (a copy,
// but for -0, which becomes +0 as in the scatter-add into zeros), no
// atomic on the values; the rest of `out` stays the wrapper's zeros.  The
// kernel checks its condition as it runs (given `check`): each kept (tap,
// row) claims its destination in `check[1..]` (the wrapper's zeroed table
// of B S_out counts, one atomicAdd each, a word a destination row), and
// one that finds it claimed sets check[0], which the wrapper asserts is 0.
// scatter_sum_kernel's lane groups.  grid (ceil(S_g / (256 / G)), B).
template <int G, bool VEC>
__global__ void __launch_bounds__(256)
scatter_store_bf16_kernel(const bf16* __restrict__ Gr, const int* __restrict__ map,
                          const __grid_constant__ TapList taps, int tap_stride, int T,
                          bf16* __restrict__ out, int B, int S_g, int S_out, int C,
                          int limit, unsigned* __restrict__ check) {
  const int s = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (s >= S_g) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  unsigned kept = 0;  // bit j: tap j's destination is stored
  int mine = -1;      // the destination of tap `lane` (T <= G)
  for (int j0 = 0; j0 < T; j0 += G) {
    const int j = j0 + lane;
    const int r = j < T ? row_of32(map, taps, tap_stride, j, b, s, B, S_g) : -1;
    if (j0 == 0) mine = r;
    const bool keep = r >= 0 && r < limit;
    kept |= row_groups::ballot<G>(keep) << j0;
    if (check != nullptr && keep) {  // claim it: a second claim breaks the condition
      if (atomicAdd(check + 1 + b * S_out + r, 1u) != 0u) atomicOr(check, 1u);
    }
  }
  if (kept == 0) return;
  const bf16* g = Gr + (b * S_g + s) * C;
  bf16* ob = out + b * S_out * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u0 = 0; u0 < units; u0 += G) {
    const int u = u0 + lane;
    const bool live = u < units;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      if constexpr (VEC) {
        add4(v, ldg4_bf16(g + 4 * u));  // 0 + x: -0 -> +0
      } else {
        v.x = 0.f + __bfloat162float(g[u]);
      }
    }
    for (unsigned k = kept; k != 0; k &= k - 1) {
      const int j = __ffs(k) - 1;
      const int r = T <= G ? row_groups::shfl<G>(mine, j)
                           : row_of32(map, taps, tap_stride, j, b, s, B, S_g);
      if (!live) continue;
      if constexpr (VEC) {
        store4(ob + r * C, 4 * u, C, true, v);
      } else {
        ob[r * C + u] = __float2bfloat16_rn(v.x);
      }
    }
  }
}

// (h) in bf16 through the sources of each destination: out[b,d,:] = the
// rows G[b,i,:] with map[tap][b][i] == d, added in ascending i from zero,
// every add rounded, for each destination d below `limit` (the rest stays
// the wrapper's zeros).  The unpool's adjoint: `map` is the level's parent
// map [1, B, S_g] (fine rows -> coarse), `inv` [K, B, S_out] (K <= 8) the
// level's k2s2 down map, which names each coarse row's children, missing
// ones at the fine pad row.  A group of G lanes owns one destination: every
// lane reads its K candidates, keeps those whose own parent is d (the pad
// row's is the coarse pad row, which no kept d is), sorts them with a
// fixed network in registers and adds them in order.  Where the down map is
// exactly the parent map's inverse below the pad rows, this is the ordered
// scatter-add bit for bit, with no atomics.  The kernel checks that
// condition as it runs (given `check`): the grid's last `src_blocks`
// x-blocks take a thread a source row, and a kept source that its
// destination's K entries do not name exactly once sets check[0], which
// the wrapper asserts is 0.  grid (ceil(S_out / (256 / G)) + src_blocks,
// B), src_blocks = ceil(S_g / 256), or 0 without `check`.
constexpr int INV_MAX = 8;

__device__ __forceinline__ void cswap(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

template <int G, bool VEC>
__global__ void __launch_bounds__(256)
scatter_sum_inv_bf16_kernel(const bf16* __restrict__ Gr, const int* __restrict__ map, int tap,
                            const int* __restrict__ inv, int K, bf16* __restrict__ out,
                            int B, int S_g, int S_out, int C, int limit,
                            unsigned* __restrict__ check) {
  const int b = blockIdx.y;
  const int dst_blocks = (S_out + 256 / G - 1) / (256 / G);
  if ((int)blockIdx.x >= dst_blocks) {  // the check: each kept source named once
    const int i = (blockIdx.x - dst_blocks) * 256 + threadIdx.x;
    if (i >= S_g) return;
    const int p = __ldg(map + (tap * B + b) * S_g + i);
    if (p < 0 || p >= limit || p >= S_out) return;
    int named = 0;
    for (int k = 0; k < K; ++k) named += __ldg(inv + (k * B + b) * S_out + p) == i;
    if (named != 1) atomicOr(check, 1u);
    return;
  }
  const int d = blockIdx.x * (256 / G) + threadIdx.x / G;
  if (d >= S_out || d >= limit) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  int c[INV_MAX];
#pragma unroll
  for (int k = 0; k < INV_MAX; ++k) {
    int i = k < K ? __ldg(inv + (k * B + b) * S_out + d) : INT_MAX;
    if (i != INT_MAX && (i < 0 || i >= S_g || __ldg(map + (tap * B + b) * S_g + i) != d))
      i = INT_MAX;
    c[k] = i;
  }
  // Batcher's odd-even merge sort of 8 keys (19 compare-swaps), unrolled
  cswap(c[0], c[1]); cswap(c[2], c[3]); cswap(c[4], c[5]); cswap(c[6], c[7]);
  cswap(c[0], c[2]); cswap(c[1], c[3]); cswap(c[4], c[6]); cswap(c[5], c[7]);
  cswap(c[1], c[2]); cswap(c[5], c[6]);
  cswap(c[0], c[4]); cswap(c[1], c[5]); cswap(c[2], c[6]); cswap(c[3], c[7]);
  cswap(c[2], c[4]); cswap(c[3], c[5]);
  cswap(c[1], c[2]); cswap(c[3], c[4]); cswap(c[5], c[6]);
  const bf16* gb = Gr + b * S_g * C;
  bf16* o = out + (b * S_out + d) * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u = lane; u < units; u += G) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < INV_MAX; ++k) {
      // a child named twice is added once (the down map names each once)
      if (c[k] == INT_MAX || (k > 0 && c[k] == c[k - 1])) continue;
      if constexpr (VEC) {
        add4(acc, ldg4_bf16(gb + c[k] * C + 4 * u));
        bf_round4(acc);
      } else {
        acc.x = bf_round(acc.x + __bfloat162float(gb[c[k] * C + u]));
      }
    }
    if constexpr (VEC) {
      store4(o, 4 * u, C, true, acc);
    } else {
      o[u] = __float2bfloat16_rn(acc.x);
    }
  }
}

// The brick layout (pointcontrast_tpu/sparse/brick.py): a level's features
// are [NB * 8, C] with voxel (brick b, slot s) at row b * 8 + s, slot id
// s = s_x + 2 s_y + 4 s_z; empty slots and pad bricks hold zeros.  A
// same-level conv adds, for output row b * 8 + p and tap t, the source row
// src * 8 + s, src = (d == centre ? b : nbr[d][b]): on each axis
// offset(t) + p = 2 d + s, so (d, s) is one entry of the plan's slot table
// (`table` [taps][8] = 8 d + s, sparse/kernels.py::brick_slot_table).
// `valid` [NB * 8] marks the occupied slots (nullptr: every slot); `order`
// [NB * 8] (nullptr: the rows' own order) is the level's slot order, built
// with the pyramid: occupied slots first, in brick order, then the empty
// slots and the pad bricks (sparse/brick.py::slot_order).
namespace bg {
constexpr int NS = 8;          // slots of a brick (2^3)
constexpr int MAX_NBRS = 27;   // rows of a brick map (3^3 neighbour bricks)
// brick_wgrad_bf16's compaction issues the loads of this many runs together,
// before their appends' barriers (4 spilled past the 128 registers of 2
// blocks an SM)
constexpr int HOIST = 2;

// esize: the tiles' element size, 4 (f32) or 2 (brick_gemm_mma_kernel's bf16)
inline size_t smem_bytes(int Q, int taps, int esize = 4) {
  return (size_t)esize * gg::STAGES * (gg::BM * gg::BK + gg::BK * 32 * Q) +
         sizeof(int) * (MAX_NBRS * gg::BM + taps * NS + 2 * gg::BM);
}

// A brick's occupied slots as 8 bits (slot s: bit s), from its 8 valid
// entries (two float4s: a brick's slots are 32 aligned bytes)
__device__ __forceinline__ int occupied(const float* __restrict__ valid, int brick) {
  if (valid == nullptr) return 0xff;
  const float4* v = reinterpret_cast<const float4*>(valid) + 2 * brick;
  const float4 a = __ldg(v), c = __ldg(v + 1);
  return (a.x != 0.f) | (a.y != 0.f) << 1 | (a.z != 0.f) << 2 | (a.w != 0.f) << 3 |
         (c.x != 0.f) << 4 | (c.y != 0.f) << 5 | (c.z != 0.f) << 6 | (c.w != 0.f) << 7;
}
}  // namespace bg

// The brick GEMMs' prologue (brick_gemm_kernel, brick_gemm_mma_kernel): the
// tile's output rows `srow` [BM] (entries blockIdx.x BM .. of `order`, -1
// past the level) and whether each is occupied `live` [BM], the slot table
// `tab` [taps][NS], and, where the tile holds an occupied row, for each of
// the K3 neighbour rows d and each tile row the neighbour brick with its 8
// occupancy bits `nbx` [K3][BM] (brick << 8 | bits; 0 for an empty output
// row).  Returns whether the tile holds an occupied row; ends with a
// barrier.
__device__ __forceinline__ int bg_prologue(int* srow, int* live, int* tab, int* nbx,
                                           const int* __restrict__ nbr, int K3,
                                           const int* __restrict__ table, int taps,
                                           int centre, const float* __restrict__ valid,
                                           const int* __restrict__ order, int NB) {
  constexpr int BM = gg::BM, THREADS = gg::THREADS, NS = bg::NS;
  const int tid = threadIdx.x;
  const int rows = NB * NS;
  int any = 0;
  if (tid < BM) {
    const int e = blockIdx.x * BM + tid;
    int r = -1, ok = 0;
    if (e < rows) {
      r = order != nullptr ? __ldg(order + e) : e;
      ok = valid == nullptr || __ldg(valid + r) != 0.f;
    }
    srow[tid] = r;
    live[tid] = ok;
    any = ok;
  }
  for (int i = tid; i < taps * NS; i += THREADS) tab[i] = __ldg(table + i);
  any = __syncthreads_or(any);
  if (any) {
    for (int e = tid; e < K3 * BM; e += THREADS) {
      const int d = e / BM, m = e % BM;
      int v = 0;
      if (live[m]) {
        const int b = srow[m] / NS;
        const int nb = d == centre ? b : __ldg(nbr + (int64_t)d * NB + b);
        v = nb << 8 | bg::occupied(valid, nb);
      }
      nbx[e] = v;
    }
    __syncthreads();
  }
  return any;
}

// Tile row m's source row at tap t (bg_prologue's tables), -1 where the
// source slot or the output slot m is empty
__device__ __forceinline__ int bg_source(const int* tab, const int* nbx, const int* srow,
                                         int t, int m) {
  const int ds = tab[t * bg::NS + (srow[m] & (bg::NS - 1))];
  const int v = nbx[(ds >> 3) * gg::BM + m];
  return (v >> (ds & 7)) & 1 ? (v >> 8) * bg::NS + (ds & 7) : -1;
}

// (i) brick_gemm: out[r, :] = sum_t X[src(t, r), :] . W[t] over the taps
// whose source slot is occupied, for every occupied output slot r; exact
// zeros at the empty slots and pad bricks (JAX _brick_core, masked as
// brick_conv masks it; also its dF with W'[t] = W[rev[t]]^T, the cotangent
// being zero at empty slots).  What bounds it: 2 Cin Cout f32 operations a
// (tap, output slot) pair whose source and output slots are both occupied
// (f32 SIMT).  A brick level holds ~3 slot rows per occupied one (pretrain
// brick:2, level 0: 398,464 rows, 125,751 occupied) and about half the
// sources of an occupied slot are empty, so the design spends FMAs on
// occupied slots only and runs gather_gemm's pipeline over them:
//  - a block owns BM = 128 consecutive entries of `order` and a Cout tile of
//    32 Q channels (gg::q_for).  In the slot order the tiles past the
//    occupied count hold no occupied row: such a block writes zeros and
//    leaves.  Each output row is written once, so the order changes no
//    result;
//  - prologue: the tile's output rows, the slot table, and for each of the
//    27 neighbour rows d and each tile row the neighbour brick with its
//    8 occupancy bits (0 for an empty output row);
//  - main loop over (tap, 32-deep Cin chunk) steps through gather_gemm's
//    3-stage cp.async ring (gg_load_rows, gg_load_w, gg_fma): tile row m's
//    source at tap t comes from the table and the prologue's bricks,
//    zero-filled and not read where its slot is empty; a warp whose 16 rows
//    have no occupied source at the step's tap skips the step's FMAs.  The
//    taps come from the table, so the 125 taps of a k = 5 stem run as the
//    27 of k = 3;
//  - every row's sum runs over its taps in order: the same bits from run
//    to run, no atomics.
// grid (ceil(NB * 8 / BM), ceil(Cout / 32 Q))
template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
brick_gemm_kernel(const float* __restrict__ X, const int* __restrict__ nbr, int K3,
                  const int* __restrict__ table, int taps, int centre,
                  const float* __restrict__ W, const float* __restrict__ valid,
                  const int* __restrict__ order, float* __restrict__ out, int NB,
                  int Cin, int Cout, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES;
  constexpr int TM = gg::TM, BN = 32 * Q, NS = bg::NS;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                          // [STAGES][BM][BK]
  float* Bs = As + STAGES * BM * BK;                         // [STAGES][BK][BN]
  int* nbx = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [K3][BM] brick << 8 | bits
  int* tab = nbx + bg::MAX_NBRS * BM;                        // [taps][NS] 8 d + s
  int* srow = tab + taps * NS;                               // [BM] output row, -1 past
  int* live = srow + BM;                                     // [BM] output slot occupied

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int n0 = blockIdx.y * BN;

  const int any = bg_prologue(srow, live, tab, nbx, nbr, K3, table, taps, centre, valid,
                              order, NB);
  auto source = [&](int t, int m) { return bg_source(tab, nbx, srow, t, m); };
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = any ? taps * kchunks : 0;

  auto load = [&](int step, int buf) {
    const int t = step / kchunks, k0 = (step % kchunks) * BK;
    gg_load_rows(As + buf * BM * BK, X, [&](int m) { return source(t, m); }, k0, Cin, vec_x,
                 tid);
    gg_load_w<Q>(Bs + buf * BK * BN, W + (int64_t)t * Cin * Cout, k0, n0, Cin, Cout, vec_w,
                 tid);
  };

  float4 acc[TM][Q];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  const int sw = ty & 7;  // the swizzle of this thread's rows: (4 ty + i) / 4 % 8
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    // warp w's fragment: rows [16 w, 16 w + 16), lanes 16-31 repeat 0-15
    if (!__ballot_sync(0xffffffffu, source(step / kchunks, 16 * warp + (lane & 15)) >= 0))
      continue;  // no occupied source in this warp's 16 rows at this tap
    gg_fma<Q>(acc, As + (step % STAGES) * BM * BK + 4 * ty * BK,
              Bs + (step % STAGES) * BK * BN + 4 * tx, sw);
  }
  cp_async_wait<0>();

  const bool vec_o = Cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = 4 * ty + i;
    const int r = srow[m];
    if (r < 0) continue;
    const bool ok = live[m];
    float* row = out + (int64_t)r * Cout;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float4 v = acc[i][q];  // by value: a reference to acc[i][q] or a zero spills acc
      if (!ok) v = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(row, n0 + 4 * tx + 32 * q, Cout, vec_o, v);
    }
  }
}

// brick_gemm_bf16 on the tensor cores (the bf16 form of (i): JAX's
// _brick_core in bf16, pointcontrast_tpu/sparse/brick.py:400-440, and the
// dF of _brick_sym_bwd, :366-370): bf16 rows and weights, every output the
// f32 sum of its bf16 x bf16 products (exact in f32) rounded once to bf16,
// as JAX's one f32 accumulator over the plan's steps.  What bounds it: as
// gather_gemm_bf16, the bf16 tensor cores lie far above what the gathered
// rows feed them, so the rows' bytes and the pipeline's latency set its
// pace.  The design is brick_gemm_kernel's (bg_prologue, the tiles of the
// slot order, the taps from the slot table, a warp's step skipped where its
// 16 rows have no occupied source at the tap) with gather_gemm_mma_kernel's
// products and epilogue:
//  - warp w computes its 16 rows x the block's Cout tile BN = 32 Q (Q =
//    1..4, gm::q_for) by mma.sync.m16n8k16 on ldmatrix fragments of the
//    same cp.async ring (gm_mma, mma_chunk's swizzle); a k16 step wholly
//    past Cin is left out, and the rest of a ragged chunk is zero-filled
//    (the Cin = 3 stem: one k16 step, rows by 2-byte loads);
//  - epilogue: each sum rounded once to bf16 and staged in shared memory,
//    each output row stored 16 bytes at a time; exact zeros at the empty
//    slots and pad bricks;
//  - every row's sum runs over its taps in order, in one block: the same
//    bits from run to run, no atomics.
// grid (ceil(NB * 8 / BM), ceil(Cout / 32 Q))
template <int Q>
__global__ void __launch_bounds__(gg::THREADS, 2)
brick_gemm_mma_kernel(const bf16* __restrict__ X, const int* __restrict__ nbr, int K3,
                      const int* __restrict__ table, int taps, int centre,
                      const bf16* __restrict__ W, const float* __restrict__ valid,
                      const int* __restrict__ order, bf16* __restrict__ out, int NB,
                      int Cin, int Cout, int vec_x, int vec_w) {
  constexpr int BM = gg::BM, BK = gg::BK, STAGES = gg::STAGES;
  constexpr int BN = 32 * Q, NF = 4 * Q, LDC = BN + gm::PAD, NS = bg::NS;
  static_assert(BM * LDC <= STAGES * (BM * BK + BK * BN), "the staged tile fits the ring");
  extern __shared__ __align__(16) float smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                  // [STAGES][BM][BK]
  bf16* Bs = As + STAGES * BM * BK;                          // [STAGES][BK][BN]
  int* nbx = reinterpret_cast<int*>(Bs + STAGES * BK * BN);  // [K3][BM] brick << 8 | bits
  int* tab = nbx + bg::MAX_NBRS * BM;                        // [taps][NS] 8 d + s
  int* srow = tab + taps * NS;                               // [BM] output row, -1 past
  int* live = srow + BM;                                     // [BM] output slot occupied

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;

  const int any = bg_prologue(srow, live, tab, nbx, nbr, K3, table, taps, centre, valid,
                              order, NB);
  const int kchunks = (Cin + BK - 1) / BK;
  const int nsteps = any ? taps * kchunks : 0;

  auto load = [&](int step, int buf) {
    const int t = step / kchunks, k0 = (step % kchunks) * BK;
    gg_load_rows<BM>(As + buf * BM * BK, X,
                           [&](int m) { return bg_source(tab, nbx, srow, t, m); }, k0, Cin,
                           vec_x, tid);
    gg_load_w<Q, bf16>(Bs + buf * BK * BN, W + (int64_t)t * Cin * Cout, k0, n0, Cin,
                             Cout, vec_w, tid);
  };

  float acc[NF][4];  // fragment n: columns 8 n + 2 (lane % 4) + {0, 1}, rows lane / 4 + {0, 8}
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; step - 1's buffer is free
    {
      const int next = step + STAGES - 1;
      if (next < nsteps) load(next, next % STAGES);
      cp_async_commit();
    }
    // warp w's fragment: rows [16 w, 16 w + 16), lanes 16-31 repeat 0-15
    if (!__ballot_sync(0xffffffffu,
                       bg_source(tab, nbx, srow, step / kchunks, 16 * warp + (lane & 15)) >= 0))
      continue;  // no occupied source in this warp's 16 rows at this tap
    const int k0 = (step % kchunks) * BK;
    gm_mma<Q>(acc, As + (step % STAGES) * BM * BK, Bs + (step % STAGES) * BK * BN, warp, lane,
              Cin - k0);
  }
  cp_async_wait<0>();

  // round once, stage the warp's 16 rows in shared memory (the ring is free
  // once every warp is past its last step), store 16 bytes at a time
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // a fragment's row and column pair
  bf16* Cs = As;  // [BM][LDC]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(Cs + (16 * warp + g + 8 * h) * LDC + 8 * n + c2) =
          __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  __syncwarp();
  const bool vec_o = Cout % 8 == 0;
#pragma unroll
  for (int u = 0; u < BN / 16; ++u) {  // the warp's 16 rows x BN / 8 chunks
    const int e = lane + 32 * u;
    const int m = 16 * warp + e / (BN / 8), c = e % (BN / 8);
    const int r = srow[m], n = n0 + 8 * c;
    if (r < 0 || n >= Cout) continue;
    bf16* dst = out + (int64_t)r * Cout + n;
    const bf16* src = Cs + m * LDC + 8 * c;
    const bool ok = live[m];
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) =
          ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int i = 0; i < 8 && n + i < Cout; ++i) dst[i] = ok ? src[i] : bf16_zero();
    }
  }
}

// (j) brick_wgrad: dW[t] = sum_r X[src(t, r), :]^T . G[r, :] over the
// occupied output slots r whose source at tap t is occupied too (JAX
// _brick_sym_bwd's gs^T @ cp blocks, at the pairs that are not zero).
// What bounds it: 2 Cin Cout f32 operations a live pair (f32 SIMT).  It is
// gather_wgrad with its pairs taken from the slot table:
//  - a block owns one tap t, one output tile (gw::qs_for) and a share of
//    the rows of `order`: runs of 256 entries, run z, z + slices, ... for
//    block z, so the occupied rows, first in the slot order, fall to
//    every block alike;
//  - compaction: each thread reads one entry's output row r, its
//    occupancy, its source (the table, nbr) and the source's occupancy; a
//    ballot and the warps' counts give every live pair its place in
//    shared memory (gw_append), and the FMAs run on live pairs only
//    (gw_pairs: the rows by cp.async in a 3-stage ring, G's rows in the
//    slot order);
//  - the blocks of a (tap, tile) are combined by its last block (integer
//    tickets, gw_finish) in block order: dW is the same from run to run,
//    no f32 atomics.
// grid (tiles, taps, slices)
template <int QA, int QG>
__global__ void __launch_bounds__(gw::THREADS, 2)
brick_wgrad_kernel(const float* __restrict__ X, const int* __restrict__ nbr,
                   const int* __restrict__ table, int centre, const float* __restrict__ Gm,
                   const float* __restrict__ valid, const int* __restrict__ order,
                   float* __restrict__ dW, float* __restrict__ ws, int* __restrict__ tickets,
                   int NB, int Cin, int Cout, int vec_a, int vec_g) {
  constexpr int THREADS = gw::THREADS, ROWS = gw::ROWS, STAGES = gw::STAGES;
  constexpr int CHUNK = gw::CHUNK, RUNS = CHUNK / THREADS;
  constexpr int TA = 32 * QA, TG = 32 * QG, NS = bg::NS;
  constexpr size_t TILES = sizeof(float) * STAGES * ROWS * (TA + TG);  // the pair lists follow
  extern __shared__ __align__(16) float smem[];
  int* pa = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) + TILES);  // X rows
  int* pg = pa + CHUNK;                                                // [CHUNK] G rows
  int* wcount = pg + CHUNK;                                            // [2][8], flag

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_g = (Cout + TG - 1) / TG;
  const int a0 = (blockIdx.x / tiles_g) * TA, g0 = (blockIdx.x % tiles_g) * TG;
  const int t = blockIdx.y, z = blockIdx.z, slices = gridDim.z;
  const int rows = NB * NS;
  const int runs = (rows + THREADS - 1) / THREADS;
  const int mine = runs > z ? (runs - z + slices - 1) / slices : 0;  // runs z, z + slices, ...

  // the live pairs of runs u0 .. u0 + RUNS - 1 of this block's, in order
  auto compact = [&](int u0) {
    int n = 0;
#pragma unroll 1
    for (int it = 0; it < RUNS; ++it) {
      const int u = u0 + it;
      const int e = (z + u * slices) * THREADS + tid;
      bool ok = false;
      int ra = 0, rg = 0;
      if (u < mine && e < rows) {
        rg = order != nullptr ? __ldg(order + e) : e;
        if (valid == nullptr || __ldg(valid + rg) != 0.f) {
          const int ds = __ldg(table + t * NS + (rg & (NS - 1)));
          const int b = rg / NS, d = ds >> 3;
          ra = (d == centre ? b : __ldg(nbr + (int64_t)d * NB + b)) * NS + (ds & 7);
          ok = valid == nullptr || __ldg(valid + ra) != 0.f;
        }
      }
      n += gw_append(ok, ra, rg, pa, pg, wcount + 8 * (it & 1), n, lane, warp);
    }
    __syncthreads();
    return n;
  };

  float4 acc[QA][4][QG];
#pragma unroll
  for (int p = 0; p < QA; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < QG; ++q) acc[p][c][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u0 = 0; u0 < mine; u0 += RUNS) {
    const int n = compact(u0);
    gw_pairs<QA, QG>(acc, smem, pa, pg, n, X, Cin, a0, Gm, Cout, g0, vec_a, vec_g, tid);
  }
  gw_finish<QA, QG>(acc, smem, wcount + 16, dW, ws, tickets, Cin, Cout, a0, g0, tid);
}

// The level's occupied slots, one word a brick (bg::occupied): what
// brick_wgrad_bf16's kernels read for a brick and each of its neighbours,
// 4 bytes in place of the 32 of its valid entries
__global__ void brick_occupancy_kernel(const float* __restrict__ valid, int* __restrict__ occ,
                                       int NB) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < NB) occ[b] = bg::occupied(valid, b);
}

// brick_wgrad_bf16 on the tensor cores (the dW of _brick_sym_bwd in bf16,
// pointcontrast_tpu/sparse/brick.py:372-396: f32 sums of the bf16 x bf16
// products, which the wrapper rounds once to bf16, JAX's dw.astype(bf16)).
// What bounds it: the bytes of the live pairs' rows and, at the stem's Cin
// 3, the fixed cost of finding them.  Run on the tensor cores, the f32
// kernel's slot-row compaction (the order, the valid mask twice, the slot
// table and the brick map read per row and tap: 27 x 398,464 rows at level
// 0 of pretrain brick:2) and, at Cin 3, 32-wide A tiles staged by plain
// 2-byte loads were slower than the f32 kernel itself.  Two forms:
//  - Cin > BRICK_NARROW (brick_wgrad_mma_kernel): a block owns one tap t, a
//    tensor-core tile (gw::qs_for) and the runs z, z + slices, ... of 32
//    bricks (the blocks' runs interleave, so the live bricks spread over
//    them alike); a thread takes one (brick b,
//    output slot p) of a run: p occupied and the source (d, s) =
//    table[t][p] of brick nbr[d, b] occupied (the bricks' occupancy words,
//    `occ`, made from `valid` by brick_occupancy_kernel first) make a
//    live pair; the pairs are compacted (gw_append) and multiplied on the
//    tensor cores (gw_pairs_mma), and the blocks of a (tap, tile) added in
//    block order (gw_finish_mma);
//  - Cin <= BRICK_NARROW (brick_wgrad_mma_dense_kernel): JAX's own block
//    product.  X and ct read as [NB, 8 Cin] and [NB, 8 Cout] (a brick one
//    row of 16 C aligned bytes, however odd C is), a block owns one
//    neighbour row d of the brick map, a column tile of 8 Cout and runs of
//    256 bricks: R_d = sum_b X[nbr[d, b]]^T ct[b] over the bricks and
//    neighbours with an occupied slot, on the tensor cores (gw_pairs_mma,
//    K running over bricks: 8 Cin <= 64 rows, so the stem's Cin 3 fills
//    24 of 32 instead of 3), the empty slots' channels loaded as zeros
//    (gw_load_bf16's BRICKS form, the bricks' occupied slots packed with
//    their rows), partials in ws [slices][K3][8 Cin][8 Cout]; the last
//    block of a (d, tile), by an integer ticket, adds the slices in order,
//    and the last of those, by a second ticket, gathers dW[t] = sum over
//    the output slots p of R_d at (s, p), (d, s) = table[t][p], in slot
//    order;
//  - either way every sum runs in a fixed order: the same bits from run
//    to run, no f32 atomics.
// grid (tiles, taps, slices)
template <int QA, int QG>
__global__ void __launch_bounds__(gw::THREADS, 2)
brick_wgrad_mma_kernel(const bf16* __restrict__ X, const int* __restrict__ nbr,
                       const int* __restrict__ table, int centre, const bf16* __restrict__ Gm,
                       const int* __restrict__ occ, float* __restrict__ dW,
                       float* __restrict__ ws, int* __restrict__ tickets, int NB, int Cin,
                       int Cout, int vec_a, int vec_g) {
  constexpr int THREADS = gw::THREADS, CHUNK = gw::CHUNK, RUNS = CHUNK / THREADS;
  constexpr int TA = 32 * QA, TG = 32 * QG, NS = bg::NS, RUN = THREADS / NS;
  constexpr size_t TILES = gw::tile_bytes(QA, QG, 2, 2);
  extern __shared__ __align__(16) float smem[];
  int* pa = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) + TILES);  // X rows
  int* pg = pa + CHUNK;                                                // [CHUNK] G rows
  int* wcount = pg + CHUNK;                                            // [2][8], flag

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_g = (Cout + TG - 1) / TG;
  const int a0 = (blockIdx.x / tiles_g) * TA, g0 = (blockIdx.x % tiles_g) * TG;
  const int t = blockIdx.y, z = blockIdx.z, slices = gridDim.z;
  const int runs = (NB + RUN - 1) / RUN;
  const int mine = runs > z ? (runs - z + slices - 1) / slices : 0;  // runs z, z + slices, ...
  const int p = tid % NS, ds = __ldg(table + t * NS + p), d = ds >> 3, s = ds & (NS - 1);

  // the live pairs of runs u0 .. u0 + RUNS - 1 of this block's, in order
  auto compact = [&](int u0) {
    int n = 0;
#pragma unroll 1
    for (int h = u0; h < u0 + RUNS; h += bg::HOIST) {
      int src[bg::HOIST], own[bg::HOIST];
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i) {
        const int e = (z + (h + i) * slices) * RUN + tid / NS;
        const bool in = h + i < mine && e < NB;
        src[i] = !in ? 0 : d == centre ? e : __ldg(nbr + (int64_t)d * NB + e);
        own[i] = in ? __ldg(occ + e) : 0;
      }
      unsigned live = 0;  // bit i: run h + i's pair is live
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i)
        if ((own[i] >> p) & 1) live |= ((__ldg(occ + src[i]) >> s) & 1u) << i;
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i) {
        const int e = (z + (h + i) * slices) * RUN + tid / NS;
        n += gw_append((live >> i) & 1, src[i] * NS + s, e * NS + p, pa, pg,
                       wcount + 8 * (i & 1), n, lane, warp);
      }
    }
    __syncthreads();
    return n;
  };

  float acc[QA * QG][4];
#pragma unroll
  for (int i = 0; i < QA * QG; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int u0 = 0; u0 < mine; u0 += RUNS) {
    const int n = compact(u0);
    gw_pairs_mma<QA, QG>(acc, smem, pa, pg, n, X, Cin, a0, Gm, Cout, g0, vec_a, vec_g, tid);
  }
  gw_finish_mma<QA, QG>(acc, wcount + 16, dW, ws, tickets, Cin, Cout, a0, g0, tid);
}

// grid (tiles of 8 Cout, K3, slices); ws [slices][K3][8 Cin][8 Cout] f32,
// tickets [K3 tiles + 1] zeroed
template <int QA, int QG>
__global__ void __launch_bounds__(gw::THREADS, 2)
brick_wgrad_mma_dense_kernel(const bf16* __restrict__ X, const int* __restrict__ nbr,
                             const int* __restrict__ table, int taps, int centre,
                             const bf16* __restrict__ Gm, const int* __restrict__ occ,
                             float* __restrict__ dW, float* __restrict__ ws,
                             int* __restrict__ tickets, int NB, int Cin, int Cout, int vec_a,
                             int vec_g) {
  constexpr int THREADS = gw::THREADS, CHUNK = gw::CHUNK, RUNS = CHUNK / THREADS;
  constexpr int TA = 32 * QA, TG = 32 * QG, PT = QA * QG, NG = TG / 8, NS = bg::NS;
  constexpr size_t TILES = gw::tile_bytes(QA, QG, 2, 2);
  extern __shared__ __align__(16) float smem[];
  int* pa = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) + TILES);  // X bricks
  int* pg = pa + CHUNK;                                                // [CHUNK] ct bricks
  int* wcount = pg + CHUNK;                                            // [2][8], flag

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ca = NS * Cin, Cg = NS * Cout;  // a brick as one row
  const int g0 = blockIdx.x * TG, d = blockIdx.y, z = blockIdx.z, slices = gridDim.z;
  const int runs = (NB + THREADS - 1) / THREADS;
  const int mine = runs > z ? (runs - z + slices - 1) / slices : 0;

  // the (neighbour, brick) pairs of runs u0 .. u0 + RUNS - 1 of this block's
  // whose bricks both hold an occupied slot, in order, each a brick << 8 |
  // its occupied slots (bricks fit 23 bits: the wrapper's BRICK_LIMIT)
  auto compact = [&](int u0) {
    int n = 0;
#pragma unroll 1
    for (int h = u0; h < u0 + RUNS; h += bg::HOIST) {
      int src[bg::HOIST], own[bg::HOIST], bits[bg::HOIST];
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i) {
        const int e = (z + (h + i) * slices) * THREADS + tid;
        const bool in = h + i < mine && e < NB;
        src[i] = !in ? 0 : d == centre ? e : __ldg(nbr + (int64_t)d * NB + e);
        own[i] = in ? __ldg(occ + e) : 0;
      }
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i) bits[i] = own[i] ? __ldg(occ + src[i]) : 0;
#pragma unroll
      for (int i = 0; i < bg::HOIST; ++i) {
        const int e = (z + (h + i) * slices) * THREADS + tid;
        n += gw_append(own[i] && bits[i], src[i] << 8 | bits[i], e << 8 | own[i], pa, pg,
                       wcount + 8 * (i & 1), n, lane, warp);
      }
    }
    __syncthreads();
    return n;
  };

  float acc[PT][4];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int u0 = 0; u0 < mine; u0 += RUNS) {
    const int n = compact(u0);
    gw_pairs_mma<QA, QG, true>(acc, smem, pa, pg, n, X, Ca, 0, Gm, Cg, g0, vec_a, vec_g, tid,
                               Cin, Cout);
  }

  // this block's part of R_d into its slice's plane
  const int64_t plane = (int64_t)Ca * Cg, kplane = (int64_t)gridDim.y * plane;
  float* part = ws + z * kplane + d * plane;
  const int gq = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int e = warp * PT + i, mt = e / NG, nt = e % NG;
    const int col = g0 + 8 * nt + c2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mt + gq + 8 * h;
      if (m >= Ca) continue;
      if (col < Cg) part[(int64_t)m * Cg + col] = acc[i][2 * h];
      if (col + 1 < Cg) part[(int64_t)m * Cg + col + 1] = acc[i][2 * h + 1];
    }
  }
  int* flag = wcount + 16;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + d * gridDim.x + blockIdx.x, 1) == slices - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the (d, tile)'s last block: the slices in order, into slice 0's plane
  for (int e = tid; e < TA * TG; e += THREADS) {
    const int m = e / TG, nn = g0 + e % TG;
    if (m >= Ca || nn >= Cg) continue;
    const int64_t off = d * plane + (int64_t)m * Cg + nn;
    float v = __ldcg(ws + off);
    for (int zz = 1; zz < slices; ++zz) v += __ldcg(ws + zz * kplane + off);
    ws[off] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int last = gridDim.x * gridDim.y;
    *flag = atomicAdd(tickets + last, 1) == last - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the last of them: dW[t][c][co] = sum over the output slots p, in order,
  // of R_d[s Cin + c][p Cout + co], (d, s) = table[t][p]
  for (int e = tid; e < taps * Cin * Cout; e += THREADS) {
    const int t = e / (Cin * Cout), c = (e / Cout) % Cin, co = e % Cout;
    float v = 0.f;
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const int ds = __ldg(table + t * NS + p);
      v += __ldcg(ws + (ds >> 3) * plane + (int64_t)((ds & (NS - 1)) * Cin + c) * Cg +
                  p * Cout + co);
    }
    dW[e] = v;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// segment_sum's launch shape for X [N, C] (the C entries below share it):
// lane group G, channel tile, tiles (grid y), blocks a tile (grid x) and
// their span of rows, about `blocks` blocks in all.
struct SegPlan {
  int G, tile, tiles, nb, span;
};

SegPlan seg_plan(const void* X, int N, int C, int blocks) {
  const bool vec = C % 4 == 0 && aligned16(X);
  // float4 rows: at most seg::VEC_GROUP lanes, a tile of 32 channels (a
  // row's 128-byte line), so that a tile's combine gathers a quarter of a
  // 128-channel tile's bytes, and more tiles' last blocks combine at once
  const int g = row_groups::size_for(C, vec);
  SegPlan p{};
  row_groups::dispatch(vec ? std::min(g, seg::VEC_GROUP) : g, vec, [&](auto G_, auto VEC_) {
    constexpr int G = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    constexpr int TW = seg::tile<G, VEC>();
    const int rows = seg::THREADS / G * seg::U;  // a block's rows a step
    p.G = G;
    p.tile = TW;
    p.tiles = (C + TW - 1) / TW;
    const int want = std::max(1, std::min(seg::MAX_BLOCKS, blocks / p.tiles));
    p.span = ((N + want - 1) / want + rows - 1) / rows * rows;
    p.nb = (N + p.span - 1) / p.span;
  });
  return p;
}

}  // namespace

extern "C" {

// bf16_: the tensor-core kernel on bf16 operands (round_: each tap's
// product rounded, gather_gemm_mma_kernel's ROUND; f32out_: its sums left in
// f32, out an f32 table, in either mode: the partial sums of a conv of more
// than MAX_TAPS taps, added and rounded once by the caller); else the f32
// kernel
int pc_gather_gemm(const void* X, const void* map, TapList taps, int tap_stride,
                   int G, const void* W, const void* Wc, const void* order, void* out, void* ws,
                   void* tickets, int splits, int B, int S_in, int S_out, int Cin,
                   int Cout, int skip, int bf16_, int round_, int f32out_, void* stream) {
  if ((round_ || f32out_) && !bf16_) return (int)cudaErrorInvalidValue;
  const int q = bf16_ ? gm::q_for(Cout, round_) : gg::q_for(Cout);
  const int ntap = G + (Wc != nullptr ? 1 : 0);
  const size_t smem = gg::smem_bytes(q, (ntap + splits - 1) / splits, bf16_ ? 2 : 4);
  // 16-byte copies: 4 f32 or 8 bf16 a chunk
  const int vec = bf16_ ? 8 : 4;
  const int vec_x = Cin % vec == 0 && aligned16(X);
  const int vec_w = Cout % vec == 0 && aligned16(W) && (Wc == nullptr || aligned16(Wc));
  const dim3 grid((S_out + gg::BM - 1) / gg::BM, (Cout + 32 * q - 1) / (32 * q), B * splits);
  static size_t granted[17] = {};  // dynamic shared memory allowed so far, by kernel
  auto go = [&](auto kernel, auto t, int slot, auto to) {
    using T = decltype(t);
    using TO = decltype(to);
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gg::THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)X, (const int*)map, taps, tap_stride, G, (const T*)W,
        (const T*)Wc, (const int*)order, (TO*)out, (float*)ws, (int*)tickets, splits,
        B, S_in, S_out,
        Cin, Cout, skip, vec_x, vec_w);
  };
  if (!bf16_) {
    switch (q) {
      case 1: go(gather_gemm_kernel<1>, 0.f, 1, 0.f); break;
      case 2: go(gather_gemm_kernel<2>, 0.f, 2, 0.f); break;
      default: go(gather_gemm_kernel<3>, 0.f, 3, 0.f); break;
    }
  } else if (f32out_ && round_) {
    if (q == 1) go(gather_gemm_mma_kernel<1, true, true>, bf16(), 11, 0.f);
    else go(gather_gemm_mma_kernel<2, true, true>, bf16(), 12, 0.f);
  } else if (f32out_) {
    switch (q) {
      case 1: go(gather_gemm_mma_kernel<1, false, true>, bf16(), 13, 0.f); break;
      case 2: go(gather_gemm_mma_kernel<2, false, true>, bf16(), 14, 0.f); break;
      case 3: go(gather_gemm_mma_kernel<3, false, true>, bf16(), 15, 0.f); break;
      default: go(gather_gemm_mma_kernel<4, false, true>, bf16(), 16, 0.f); break;
    }
  } else if (round_) {
    if (q == 1) go(gather_gemm_mma_kernel<1, true>, bf16(), 9, bf16());
    else go(gather_gemm_mma_kernel<2, true>, bf16(), 10, bf16());
  } else {
    switch (q) {
      case 1: go(gather_gemm_mma_kernel<1, false>, bf16(), 5, bf16()); break;
      case 2: go(gather_gemm_mma_kernel<2, false>, bf16(), 6, bf16()); break;
      case 3: go(gather_gemm_mma_kernel<3, false>, bf16(), 7, bf16()); break;
      default: go(gather_gemm_mma_kernel<4, false>, bf16(), 8, bf16()); break;
    }
  }
  return (int)cudaGetLastError();
}

// gather_gemm's Cout tile for Cout channels (the wrapper sizes its split):
// the f32 kernel's, or (bf16_) the tensor-core kernel's in its mode
int pc_gather_gemm_tile_n(int Cout, int bf16_, int round_) {
  return 32 * (bf16_ ? gm::q_for(Cout, round_) : gg::q_for(Cout));
}

// a_bf16 / g_bf16: the element type of A and of G (f32 / f32, bf16 / bf16:
// the tensor cores, or bf16 / f32: the dW of K3's parent design, the
// features against its f32 scatter dy)
int pc_gather_wgrad(const void* A, const void* a_map, TapList a_taps, int a_stride,
                    int Sa, int Ca, int skip_a, const void* Gm, const void* g_map,
                    TapList g_taps, int g_stride, int Sg, int Cg, int skip_g, void* dW,
                    void* ws, void* tickets, int K, int B, int S, int rows_per_block,
                    int a_bf16, int g_bf16, void* stream) {
  const int types = a_bf16 ? (g_bf16 ? 1 : 2) : 0;  // f32/f32, bf16/bf16, bf16/f32
  if (!a_bf16 && g_bf16) return (int)cudaErrorInvalidValue;
  int qa, qg;
  gw::qs_for(Ca, Cg, &qa, &qg, types == 1);
  const int tiles = ((Ca + 32 * qa - 1) / (32 * qa)) * ((Cg + 32 * qg - 1) / (32 * qg));
  const int slices = (int)(((int64_t)B * S + rows_per_block - 1) / rows_per_block);
  const size_t smem = gw::smem_bytes(qa, qg, a_bf16 ? 2 : 4, g_bf16 ? 2 : 4);
  const int vec_a = Ca % (a_bf16 ? 8 : 4) == 0 && aligned16(A);
  const int vec_g = Cg % (g_bf16 ? 8 : 4) == 0 && aligned16(Gm);
  const dim3 grid(tiles, K, slices);
  static size_t granted[75] = {};  // by types, 5 qa + qg
  auto go = [&](auto kernel, auto ta, auto tg) {
    using TA = decltype(ta);
    using TG = decltype(tg);
    const int slot = 25 * types + 5 * qa + qg;
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gw::THREADS, smem, (cudaStream_t)stream>>>(
        (const TA*)A, (const int*)a_map, a_taps, a_stride, Sa, Ca, skip_a,
        (const TG*)Gm, (const int*)g_map, g_taps, g_stride, Sg, Cg, skip_g,
        (float*)dW, (float*)ws, (int*)tickets, B, S, rows_per_block, vec_a, vec_g);
  };
  auto by_q = [&](auto ta, auto tg) {
    using TA = decltype(ta);
    using TG = decltype(tg);
    switch (4 * qa + qg) {
      case 5: go(gather_wgrad_kernel<1, 1, TA, TG>, ta, tg); break;
      case 6: go(gather_wgrad_kernel<1, 2, TA, TG>, ta, tg); break;
      case 7: go(gather_wgrad_kernel<1, 3, TA, TG>, ta, tg); break;
      case 9: go(gather_wgrad_kernel<2, 1, TA, TG>, ta, tg); break;
      case 10: go(gather_wgrad_kernel<2, 2, TA, TG>, ta, tg); break;
      default: go(gather_wgrad_kernel<3, 1, TA, TG>, ta, tg); break;
    }
  };
  auto by_mma_q = [&](auto qa_) {  // the tensor-core form: QA, QG in 1..4, QA QG <= 9
    constexpr int QA = decltype(qa_)::value;
    switch (qg) {
      case 1: go(gather_wgrad_kernel<QA, 1, bf16, bf16>, bf16(), bf16()); break;
      case 2: go(gather_wgrad_kernel<QA, 2, bf16, bf16>, bf16(), bf16()); break;
      case 3:
        if constexpr (QA <= 3) go(gather_wgrad_kernel<QA, 3, bf16, bf16>, bf16(), bf16());
        break;
      default:
        if constexpr (QA <= 2) go(gather_wgrad_kernel<QA, 4, bf16, bf16>, bf16(), bf16());
        break;
    }
  };
  if (types == 0) {
    by_q(0.f, 0.f);
  } else if (types == 1) {
    switch (qa) {
      case 1: by_mma_q(std::integral_constant<int, 1>()); break;
      case 2: by_mma_q(std::integral_constant<int, 2>()); break;
      case 3: by_mma_q(std::integral_constant<int, 3>()); break;
      default: by_mma_q(std::integral_constant<int, 4>()); break;
    }
  } else {
    by_q(bf16(), 0.f);
  }
  return (int)cudaGetLastError();
}

// gather_wgrad's output tiles for Ca x Cg channels (the wrapper sizes its
// row slices): the SIMT forms', or (mma) the tensor-core form's
int pc_gather_wgrad_tiles(int Ca, int Cg, int mma) {
  int qa, qg;
  gw::qs_for(Ca, Cg, &qa, &qg, mma != 0);
  return ((Ca + 32 * qa - 1) / (32 * qa)) * ((Cg + 32 * qg - 1) / (32 * qg));
}

// bf16_: parent_gemm_mma_kernel (the tensor cores); trans_w (bf16 only):
// W is [8, Cout, Cin], read as W[o]^T (K2's dF on the forward's weights)
int pc_parent_gemm(const void* X, const void* parent, const void* off, const void* W,
                   const void* order, void* out, int B, int S_c, int S_f, int Cin,
                   int Cout, int skip, int splits, int bf16_, int trans_w, void* stream) {
  if (trans_w && !bf16_) return (int)cudaErrorInvalidValue;
  const int q = bf16_ ? gm::q_for(Cout, false) : gg::q_for(Cout);
  const size_t smem = pg::smem_bytes(q, bf16_ ? 2 : 4);
  const int vec = bf16_ ? 8 : 4;
  const int vec_x = Cin % vec == 0 && aligned16(X);
  const int vec_w = (trans_w ? Cin : Cout) % vec == 0 && aligned16(W);
  const dim3 grid((S_f + gg::BM - 1) / gg::BM, (Cout + 32 * q - 1) / (32 * q), B * splits);
  static size_t granted[16] = {};  // dynamic shared memory allowed so far, by kernel
  auto go = [&](auto kernel, auto t, int slot) {
    using T = decltype(t);
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gg::THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)X, (const int*)parent, (const int*)off, (const T*)W,
        (const int*)order, (T*)out, splits, S_c, S_f, Cin, Cout, skip, vec_x, vec_w);
  };
  if (!bf16_) {
    switch (q) {
      case 1: go(parent_gemm_kernel<1>, 0.f, 1); break;
      case 2: go(parent_gemm_kernel<2>, 0.f, 2); break;
      default: go(parent_gemm_kernel<3>, 0.f, 3); break;
    }
  } else if (trans_w) {
    switch (q) {
      case 1: go(parent_gemm_mma_kernel<1, true>, bf16(), 9); break;
      case 2: go(parent_gemm_mma_kernel<2, true>, bf16(), 10); break;
      case 3: go(parent_gemm_mma_kernel<3, true>, bf16(), 11); break;
      default: go(parent_gemm_mma_kernel<4, true>, bf16(), 12); break;
    }
  } else {
    switch (q) {
      case 1: go(parent_gemm_mma_kernel<1, false>, bf16(), 5); break;
      case 2: go(parent_gemm_mma_kernel<2, false>, bf16(), 6); break;
      case 3: go(parent_gemm_mma_kernel<3, false>, bf16(), 7); break;
      default: go(parent_gemm_mma_kernel<4, false>, bf16(), 8); break;
    }
  }
  return (int)cudaGetLastError();
}

// ct: f32 or (bf16_) bf16 rows; dy f32 either way
int pc_scatter_parent(const void* ct, const void* parent, const void* off,
                      void* dy, int B, int S_f, int S_c, int C, int bf16_, void* stream) {
  const bool vec = C % 4 == 0 && aligned16(dy) && ((uintptr_t)ct & (bf16_ ? 7 : 15)) == 0;
  row_groups::dispatch(row_groups::size_for(C, vec), vec, [&](auto G_, auto VEC_) {
    constexpr int G = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    const dim3 grid((S_f + 256 / G - 1) / (256 / G), B);
    if (bf16_) {
      scatter_parent_kernel<G, VEC, bf16><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const bf16*)ct, (const int*)parent, (const int*)off, (float*)dy, S_f, S_c, C);
    } else {
      scatter_parent_kernel<G, VEC, float><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const float*)ct, (const int*)parent, (const int*)off, (float*)dy, S_f,
          S_c, C);
    }
  });
  return (int)cudaGetLastError();
}

// bf16_: the tensor-core kernel on bf16 G and W (dF f32 either way)
int pc_scatter_gemm(const void* G, const void* map, TapList taps, int T,
                    const void* W, const void* order, void* dF, int splits, int B,
                    int S_out, int S_in, int Cin, int Cout, int skip, int bf16_, void* stream) {
  const int q = bf16_ ? gm::q_for(Cin, false) : gg::q_for(Cin);
  const size_t smem = sg::smem_bytes(q, T, bf16_ ? 2 : 4);
  const int vec = bf16_ ? 8 : 4;  // 16-byte copies: 4 f32 or 8 bf16 a chunk
  const int vec_g = Cout % vec == 0 && aligned16(G);
  const int vec_w = Cout % vec == 0 && aligned16(W);
  const int vec_o = Cin % 4 == 0 && aligned16(dF);
  const dim3 grid((S_out + gg::BM - 1) / gg::BM, (Cin + 32 * q - 1) / (32 * q), B * splits);
  static size_t granted[8] = {};  // dynamic shared memory allowed so far, by kernel
  auto go = [&](auto kernel, auto t, int slot) {
    using T_ = decltype(t);
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gg::THREADS, smem, (cudaStream_t)stream>>>(
        (const T_*)G, (const int*)map, taps, T, (const T_*)W, (const int*)order,
        (float*)dF, splits, B, S_out, S_in, Cin, Cout, skip, vec_g, vec_w, vec_o);
  };
  if (!bf16_) {
    switch (q) {
      case 1: go(scatter_gemm_kernel<1>, 0.f, 1); break;
      case 2: go(scatter_gemm_kernel<2>, 0.f, 2); break;
      default: go(scatter_gemm_kernel<3>, 0.f, 3); break;
    }
  } else {
    switch (q) {
      case 1: go(scatter_gemm_mma_kernel<1>, bf16(), 4); break;
      case 2: go(scatter_gemm_mma_kernel<2>, bf16(), 5); break;
      case 3: go(scatter_gemm_mma_kernel<3>, bf16(), 6); break;
      default: go(scatter_gemm_mma_kernel<4>, bf16(), 7); break;
    }
  }
  return (int)cudaGetLastError();
}

// scatter_gemm's Cin tile (the wrapper sizes its splits): the f32
// kernel's, or (bf16_) the tensor-core kernel's
int pc_scatter_gemm_tile_n(int Cin, int bf16_) {
  return 32 * (bf16_ ? gm::q_for(Cin, false) : gg::q_for(Cin));
}

// plan: {G, tile, tiles, blocks a tile, span} of pc_segment_sum's launch.
int pc_segment_sum_plan(const void* X, int N, int C, int blocks, int* plan) {
  const SegPlan p = seg_plan(X, N, C, blocks);
  plan[0] = p.G;
  plan[1] = p.tile;
  plan[2] = p.tiles;
  plan[3] = p.nb;
  plan[4] = p.span;
  return 0;
}

// The workspace (ws_floats) pc_segment_sum needs is at most
// max(blocks, ceil(C / 4)) * (seg::SMEM * 128 + 1) floats: the wrapper
// allocates that.
int pc_segment_sum(const void* X, const void* ids, void* out, void* ws, long long ws_floats,
                   void* tickets, int N, int C, int S, int blocks, int combine,
                   void* stream) {
  const bool vec = C % 4 == 0 && aligned16(X);
  const SegPlan p = seg_plan(X, N, C, blocks);
  const int det = S <= seg::SMEM;
  size_t smem = 0;
  int stage_rows = 0;
  if (det) {
    if ((long long)p.tiles * p.nb * (S * p.tile + 1) > ws_floats) return -1;
    stage_rows = std::max(1, std::min(p.nb * S, seg::STAGE / (p.tile * 4)));
    const size_t slots = (size_t)(seg::THREADS / p.G) * S * std::min(p.tile, C) * 4;
    const size_t lists = (size_t)((p.nb + p.nb * S + 3) & ~3) * 4;
    smem = std::max(slots, lists + (size_t)stage_rows * p.tile * 4);
  }
  cudaError_t rc = cudaSuccess;
  row_groups::dispatch(p.G, vec, [&](auto G_, auto VEC_) {
    auto kernel = segment_sum_kernel<decltype(G_)::value, decltype(VEC_)::value>;
    // dynamic shared memory allowed so far, this instance (the default 48 KB
    // counts the static shared memory too: 48 KB of slots at C 3, S 16)
    static size_t granted = 0;
    if (smem > granted) {
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != cudaSuccess) return;
      granted = smem;
    }
    kernel<<<dim3(p.nb, p.tiles), seg::THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)X, (const int*)ids, (float*)out, (float*)ws, (unsigned*)tickets, N, C,
        S, p.span, stage_rows, det, combine);
  });
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

// bf16_: the bf16 form (each_: a rounding after every add, else one)
int pc_gather_sum(const void* X, const void* map, TapList taps, int tap_stride,
                  int T, void* out, int B, int S_in, int S_out, int C, int bf16_,
                  int each_, void* stream) {
  const int align = bf16_ ? 7 : 15;  // a lane's 4 values: 8 or 16 bytes
  const bool vec = C % 4 == 0 && ((uintptr_t)X & align) == 0 && ((uintptr_t)out & align) == 0;
  row_groups::dispatch(row_groups::size_for(C, vec), vec, [&](auto G_, auto VEC_) {
    constexpr int G = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    const dim3 grid((S_out + 256 / G - 1) / (256 / G), B);
    if (bf16_) {
      auto kernel = each_ ? gather_sum_bf16_kernel<G, VEC, true>
                          : gather_sum_bf16_kernel<G, VEC, false>;
      kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const bf16*)X, (const int*)map, taps, tap_stride, T, (bf16*)out, B, S_in, S_out,
          C);
    } else if (T == 1) {
      gather_one_kernel<G, VEC><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const float*)X, (const int*)map, taps.idx[0], (float*)out, B, S_in, S_out, C);
    } else {
      gather_sum_kernel<G, VEC><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const float*)X, (const int*)map, taps, tap_stride, T, (float*)out, B, S_in,
          S_out, C);
    }
  });
  return (int)cudaGetLastError();
}

// bf16_: the bf16 form into a zeroed bf16 out: without inv, stores (no
// destination below the limit named twice); with inv [K, B, S_out] (K <=
// INV_MAX, one tap), destination-major through it
int pc_scatter_sum(const void* G, const void* map, TapList taps, int tap_stride,
                   int T, void* out, int B, int S_g, int S_out, int C,
                   int skip_from, int bf16_, const void* inv, int K, void* check,
                   void* stream) {
  const int limit = skip_from < 0 || skip_from > S_out ? S_out : skip_from;
  if (inv != nullptr && (!bf16_ || T != 1 || K < 1 || K > INV_MAX || map == nullptr))
    return (int)cudaErrorInvalidValue;
  const int align = bf16_ ? 7 : 15;
  const bool vec = C % 4 == 0 && ((uintptr_t)G & align) == 0 && ((uintptr_t)out & align) == 0;
  row_groups::dispatch(row_groups::size_for(C, vec), vec, [&](auto G_, auto VEC_) {
    constexpr int GS = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    if (inv != nullptr) {
      const int src_blocks = check != nullptr ? (S_g + 255) / 256 : 0;
      const dim3 grid((S_out + 256 / GS - 1) / (256 / GS) + src_blocks, B);
      scatter_sum_inv_bf16_kernel<GS, VEC><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const bf16*)G, (const int*)map, taps.idx[0], (const int*)inv, K, (bf16*)out, B,
          S_g, S_out, C, limit, (unsigned*)check);
      return;
    }
    const dim3 grid((S_g + 256 / GS - 1) / (256 / GS), B);
    if (bf16_) {
      scatter_store_bf16_kernel<GS, VEC><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const bf16*)G, (const int*)map, taps, tap_stride, T, (bf16*)out, B, S_g, S_out, C,
          limit, (unsigned*)check);
    } else {
      scatter_sum_kernel<GS, VEC><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const float*)G, (const int*)map, taps, tap_stride, T, (float*)out, B, S_g,
          S_out, C, limit);
    }
  });
  return (int)cudaGetLastError();
}

// bf16_: the tensor-core kernel on bf16 X, W and out (brick_gemm_bf16)
int pc_brick_gemm(const void* X, const void* nbr, int K3, const void* table, int taps,
                  int centre, const void* W, const void* valid, const void* order,
                  void* out, int NB, int Cin, int Cout, int bf16_, void* stream) {
  const int q = bf16_ ? gm::q_for(Cout, false) : gg::q_for(Cout);
  const size_t smem = bg::smem_bytes(q, taps, bf16_ ? 2 : 4);
  const int vec = bf16_ ? 8 : 4;  // 16-byte copies: 4 f32 or 8 bf16 a chunk
  const int vec_x = Cin % vec == 0 && aligned16(X);
  const int vec_w = Cout % vec == 0 && aligned16(W);
  const dim3 grid((NB * bg::NS + gg::BM - 1) / gg::BM, (Cout + 32 * q - 1) / (32 * q));
  static size_t granted[9] = {};  // dynamic shared memory allowed so far: f32 q, bf16 4 + q
  auto go = [&](auto kernel, auto t, int slot) {
    using T = decltype(t);
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gg::THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)X, (const int*)nbr, K3, (const int*)table, taps, centre, (const T*)W,
        (const float*)valid, (const int*)order, (T*)out, NB, Cin, Cout, vec_x, vec_w);
  };
  if (!bf16_) {
    switch (q) {
      case 1: go(brick_gemm_kernel<1>, 0.f, 1); break;
      case 2: go(brick_gemm_kernel<2>, 0.f, 2); break;
      default: go(brick_gemm_kernel<3>, 0.f, 3); break;
    }
  } else {
    switch (q) {
      case 1: go(brick_gemm_mma_kernel<1>, bf16(), 5); break;
      case 2: go(brick_gemm_mma_kernel<2>, bf16(), 6); break;
      case 3: go(brick_gemm_mma_kernel<3>, bf16(), 7); break;
      default: go(brick_gemm_mma_kernel<4>, bf16(), 8); break;
    }
  }
  return (int)cudaGetLastError();
}

// brick_wgrad (f32)
int pc_brick_wgrad(const void* X, const void* nbr, const void* table, int taps, int centre,
                   const void* G, const void* valid, const void* order, void* dW, void* ws,
                   void* tickets, int NB, int Cin, int Cout, int slices, void* stream) {
  int qa, qg;
  gw::qs_for(Cin, Cout, &qa, &qg);
  const int tiles = ((Cin + 32 * qa - 1) / (32 * qa)) * ((Cout + 32 * qg - 1) / (32 * qg));
  const size_t smem = gw::smem_bytes(qa, qg);
  const int vec_a = Cin % 4 == 0 && aligned16(X);
  const int vec_g = Cout % 4 == 0 && aligned16(G);
  const dim3 grid(tiles, taps, slices);
  static size_t granted[25] = {};  // by 5 qa + qg
  auto go = [&](auto kernel) {
    const int slot = 5 * qa + qg;
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
    kernel<<<grid, gw::THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)X, (const int*)nbr, (const int*)table, centre, (const float*)G,
        (const float*)valid, (const int*)order, (float*)dW, (float*)ws, (int*)tickets, NB,
        Cin, Cout, vec_a, vec_g);
  };
  switch (4 * qa + qg) {
    case 5: go(brick_wgrad_kernel<1, 1>); break;
    case 6: go(brick_wgrad_kernel<1, 2>); break;
    case 7: go(brick_wgrad_kernel<1, 3>); break;
    case 9: go(brick_wgrad_kernel<2, 1>); break;
    case 10: go(brick_wgrad_kernel<2, 2>); break;
    default: go(brick_wgrad_kernel<3, 1>); break;
  }
  return (int)cudaGetLastError();
}

// brick_wgrad_bf16's tensor-core tile (qa, qg) and column tiles: Cin <=
// BRICK_NARROW, the brick form ([8 Cin] x [8 Cout] a neighbour row: tiles
// of 32 qg of 8 Cout); else the pair form's gw::qs_for tiles
static void brick_wgrad_tile(int Cin, int Cout, int* qa, int* qg, int* tiles) {
  if (Cin <= BRICK_NARROW) {
    *qa = (bg::NS * Cin + 31) / 32;
    *qg = 4;
    *tiles = (bg::NS * Cout + 127) / 128;
    return;
  }
  gw::qs_for(Cin, Cout, qa, qg, true);
  *tiles = ((Cin + 32 * *qa - 1) / (32 * *qa)) * ((Cout + 32 * *qg - 1) / (32 * *qg));
}

// brick_wgrad_bf16 into an f32 dW: Cin <= BRICK_NARROW, grid (tiles, K3,
// slices), ws [slices][K3][8 Cin][8 Cout], tickets [K3 tiles + 1]; else
// grid (tiles, taps, slices), ws [slices][taps][Cin][Cout] (slices > 1),
// tickets [tiles taps]; table [taps][8] the slot table, nbr [K3, NB] the
// brick map, valid [NB 8] the occupied slots (null: all), occ [NB] int32
// workspace for their words; two launches: the words, then the products
int pc_brick_wgrad_bf16(const void* X, const void* nbr, int K3, const void* table, int taps,
                        int centre, const void* G, const void* valid, void* occ, void* dW,
                        void* ws, void* tickets, int NB, int Cin, int Cout, int slices,
                        void* stream) {
  int qa, qg, tiles;
  brick_wgrad_tile(Cin, Cout, &qa, &qg, &tiles);
  const bool narrow = Cin <= BRICK_NARROW;
  if (narrow && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = gw::smem_bytes(qa, qg, 2, 2);
  const int vec_a = (narrow || Cin % 8 == 0) && aligned16(X);  // a brick row: 16 Cin bytes
  const int vec_g = (narrow || Cout % 8 == 0) && aligned16(G);
  const dim3 grid(tiles, narrow ? K3 : taps, slices);
  brick_occupancy_kernel<<<(NB + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)valid, (int*)occ, NB);
  static size_t granted[50] = {};  // by 25 narrow + 5 qa + qg
  auto allow = [&](auto kernel) {
    const int slot = 25 * narrow + 5 * qa + qg;
    if (smem > 48 * 1024 && smem > granted[slot]) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      granted[slot] = smem;
    }
  };
  auto go = [&](auto kernel) {  // the pair form
    allow(kernel);
    kernel<<<grid, gw::THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)X, (const int*)nbr, (const int*)table, centre, (const bf16*)G,
        (const int*)occ, (float*)dW, (float*)ws, (int*)tickets, NB, Cin, Cout, vec_a, vec_g);
  };
  auto go_dense = [&](auto kernel) {  // the brick form
    allow(kernel);
    kernel<<<grid, gw::THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)X, (const int*)nbr, (const int*)table, taps, centre, (const bf16*)G,
        (const int*)occ, (float*)dW, (float*)ws, (int*)tickets, NB, Cin, Cout, vec_a, vec_g);
  };
  if (narrow) {  // qa 1 (Cin <= 4) or 2, qg 4
    if (qa == 1) go_dense(brick_wgrad_mma_dense_kernel<1, 4>);
    else go_dense(brick_wgrad_mma_dense_kernel<2, 4>);
    return (int)cudaGetLastError();
  }
  auto by_q = [&](auto qa_) {  // QA, QG in 1..4, QA QG <= 9
    constexpr int QA = decltype(qa_)::value;
    switch (qg) {
      case 1: go(brick_wgrad_mma_kernel<QA, 1>); break;
      case 2: go(brick_wgrad_mma_kernel<QA, 2>); break;
      case 3:
        if constexpr (QA <= 3) go(brick_wgrad_mma_kernel<QA, 3>);
        break;
      default:
        if constexpr (QA <= 2) go(brick_wgrad_mma_kernel<QA, 4>);
        break;
    }
  };
  switch (qa) {
    case 1: by_q(std::integral_constant<int, 1>()); break;
    case 2: by_q(std::integral_constant<int, 2>()); break;
    case 3: by_q(std::integral_constant<int, 3>()); break;
    default: by_q(std::integral_constant<int, 4>()); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
