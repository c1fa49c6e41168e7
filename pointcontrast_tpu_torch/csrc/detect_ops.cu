// Hand-written Hopper (sm_90a) kernels for the PointNet++ ops of the VoteNet
// detection step (see pointcontrast_tpu_torch/detect/kernels.py for the
// Python wrappers, their plain-torch twins and which JAX op each replaces):
//   K6 fps_kernel             furthest point sampling, one thread-block
//                             cluster a cloud, points in registers
//   K7 ball_query_kernel      first nsample in-radius points per centre, a
//                             warp a centre over point tiles in shared memory
//   K8 gather_rows_kernel     out[b, m, :] = table[b, idx[b, m], :], a lane
//                             group a row (row_groups.cuh), HBM-bound
//      scatter_add_rows_kernel  its backward, a lane group a run of rows
//                             that merges repeats of one index before its
//                             f32 atomics (16 bytes a float4)
//   K9 three_nn_kernel        the 3 nearest known points of each unknown one,
//                             a lane group a point, merged by shuffles
//      three_interpolate_kernel       out[b, n, :] = sum_j w_j f[b, idx_j, :]
//      three_interpolate_grad_kernel  its backward to f: a warp sums each
//                             known row in registers, in entry order, and
//                             stores it once
//
// Layout: clouds are [B, N, 3] row-major f32, feature tables [B, N, C]
// row-major f32, indices int32.  No kernel tests bounds: the indices come
// from fps_kernel / ball_query_kernel / three_nn_kernel (in range by
// construction) or were checked per sample on the host (DetectionBatch.to).
//
// Bit-exact agreement with the plain twins and the JAX ops: every distance
// and weighted sum is spelt out with __fmaf_rn/__fmul_rn/__fadd_rn/__fsub_rn
// in the order XLA's CPU code computes the JAX ops, which contracts each
// 3-term sum of products into a chain of FMAs (dot3_fma).  nvcc would
// otherwise choose for itself where to contract a*b + c into one FMA, which
// rounds once instead of twice; on 40000-point clouds in which 3/4 of the
// points are duplicates, one such rounding difference flips an argmax, and
// at the ball-query radius one decides membership.
//
// Each C entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "row_groups.cuh"

namespace {

constexpr int FPS_MAX_THREADS = 1024;
constexpr int BQ_WARPS = 8;                      // centres a block, a warp each
constexpr int BQ_THREADS = 32 * BQ_WARPS;
constexpr int BQ_TILE = 1024;                    // points a staged tile
constexpr int BQ_PER = BQ_TILE / BQ_THREADS;     // points a thread stages
constexpr int ROW_THREADS = 256;

// fma(a2, b2, fma(a1, b1, a0 b0)): XLA's CPU spelling of a 3-term dot
__device__ __forceinline__ float dot3_fma(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// K6: idx[b, 0] = 0; idx[b, t] = argmax_i min_{s<t} |p_i - p_idx[b,s]|^2,
// ties to the lower index (jnp.argmax / torch.argmax).  What bounds it: the
// npoint - 1 picks are serial, each a pass over the cloud (9 f32
// operations a point) and an argmax over it, so a pick's latency, not the
// card's rates: one block a cloud held 8 of 132 SMs at batch 8 and re-read
// ~40 points and distances a thread from global memory at every pick.  The
// design:
//  - one thread-block cluster of cs CTAs a cloud (cudaLaunchKernelEx with
//    the cluster attribute; cs up to 16, non-portable past 8, chosen by
//    pc_fps_cluster so that the batch's clusters run at once): CTA r owns
//    points [r per_cta, (r + 1) per_cta) and thread t points t + j T of
//    them, j < P, held with their running distances in registers for the
//    whole launch (P a template parameter, <= FPS_MAX_P at 1024 threads and
//    64 registers), or in shared memory for a cloud past the registers'
//    capacity (FPS_SMEM);
//  - a pick: every thread updates its distances from the last pick with
//    the twin's spelling (__fsub_rn, dot3_fma, fminf) and keeps its best
//    (distance, index) and that point's xyz; two warp reductions
//    (redux.sync: the largest key, a distance's bits, then the lowest
//    index that holds it: ties to the lower index) give the warp's winner,
//    which the lane holding it stores with its xyz; after __syncthreads
//    warp 0 reduces the warps' winners the same way and stores the CTA's,
//    through DSMEM (mapa, st.shared::cluster), into its slot in every CTA
//    of the cluster, double-buffered by the pick's parity, then arrives on
//    that CTA's mbarrier of the parity (release, cluster scope); every
//    thread waits on its own CTA's mbarrier (acquire) for the cs slots and
//    every warp reduces them to the same winner, with its xyz; rank 0
//    writes out[b, t].  A pick costs one __syncthreads and one wait for cs
//    point-to-point arrivals (a cluster barrier over all the cluster's
//    threads cost ~0.85 us a pick more than one CTA alone, PERF.md), and no
//    global memory is touched between the first and the last pick but the
//    output;
//  - a slot of parity t & 1 (and its mbarrier) is used again at pick t + 2
//    by a CTA that has the winner of pick t + 1, so every CTA's
//    contribution to it, made after its __syncthreads of pick t + 1, after
//    its threads' reads and waits of pick t: two of each suffice.
constexpr int FPS_MAX_P = 6;  // points a thread holds in registers at most
constexpr int FPS_MAX_CLUSTER = 16;
constexpr int FPS_SMEM = 0;   // the template's P of the shared-memory form
// dynamic shared memory of the shared-memory form at most: 227 KB a block
// less the kernel's static slots
constexpr size_t FPS_SMEM_BYTES = 232448 - 1024;

__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();  // .aligned: the warp's lanes arrive together
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory by hand: the address of a shared variable in
// CTA `rank` of the cluster, a store there, and an arrival on an mbarrier
// there whose release orders the thread's stores before it.
__device__ __forceinline__ unsigned cluster_addr(const void* local, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"((unsigned)__cvta_generic_to_shared(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void mbar_arrive_cluster(unsigned addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(addr) : "memory");
}

// Wait until the phase of parity `parity` of this CTA's mbarrier is done,
// acquiring what the arrivals released.
__device__ __forceinline__ void mbar_wait(const void* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// The argmax key of a thread's best distance: a non-negative float's bits
// order as unsigned ints, and + 1 leaves 0 to a thread with no point (its
// best -1).
__device__ __forceinline__ unsigned fps_key(float best) {
  return best < 0.f ? 0u : __float_as_uint(best) + 1u;
}

// The warp's winner of (key, index) pairs: the largest key, and the lowest
// index among the lanes that hold it (ties to the lower index),
// in two warp reductions (redux.sync); every lane ends with it.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned k = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == k ? idx : 0xffffffffu);
  key = k;
}

// The lane that holds the warp's winner (k, i) among the lanes whose own
// pair (ok, oi) is valid: the first that holds it.
__device__ __forceinline__ int winner_lane(bool valid, unsigned ok, unsigned oi, unsigned k,
                                           unsigned i) {
  return __ffs(__ballot_sync(0xffffffffu, valid && ok == k && oi == i)) - 1;
}

// One point's update: its distance to the last pick (lx, ly, lz), the
// running minimum, and the thread's best so far (points visited in
// increasing index, so a strict > keeps the lowest index of a tie).
__device__ __forceinline__ void fps_visit(float x, float y, float z, float& d, unsigned i,
                                          float lx, float ly, float lz, float& best,
                                          unsigned& besti, float& bx, float& by, float& bz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  d = fminf(d, dot3_fma(dx, dy, dz, dx, dy, dz));
  if (d > best) {
    best = d;
    besti = i;
    bx = x;
    by = y;
    bz = z;
  }
}

// P > 0: P points a thread in registers; P == FPS_SMEM: `per_thread` points
// a thread in dynamic shared memory (x, y, z, distance: 4 arrays of
// per_thread * blockDim.x floats).  Points past the cloud hold distance -1,
// below every real one, so they never win.  A cluster of one CTA (the
// small clouds) skips the cluster barrier and DSMEM: every warp reduces the
// warps' winners itself, one __syncthreads a pick (the warps' slots
// double-buffered by parity, like the CTAs').
template <int P>
__global__ void __launch_bounds__(FPS_MAX_THREADS, 1)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int npoint,
           int per_cta, int per_thread) {
  namespace cg = cooperative_groups;
  extern __shared__ float fps_pts[];
  __shared__ uint4 wslot[2][FPS_MAX_THREADS / 32];  // warp winners: key, index, x, y
  __shared__ float wz[2][FPS_MAX_THREADS / 32];
  // the CTAs' winners by parity and rank (each CTA stores its own into every
  // CTA of the cluster): key, index, x, y; and z
  __shared__ uint4 cslot[2][FPS_MAX_CLUSTER];
  __shared__ float cz[2][FPS_MAX_CLUSTER];
  // by parity: the pick's cs slots have landed (each CTA arrives once)
  __shared__ __align__(8) unsigned long long landed[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const float* p = xyz + (int64_t)b * N * 3;
  int* o = out + (int64_t)b * npoint;
  const int base = rank * per_cta, end = min(N, base + per_cta);

  constexpr int PR = P > 0 ? P : 1;
  float px[PR], py[PR], pz[PR], pd[PR];
  float *sx = fps_pts, *sy = sx + per_thread * T, *sz = sy + per_thread * T,
        *sd = sz + per_thread * T;
  if constexpr (P > 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = base + tid + j * T;
      const bool in = i < end;
      px[j] = in ? p[3 * i] : 0.f;
      py[j] = in ? p[3 * i + 1] : 0.f;
      pz[j] = in ? p[3 * i + 2] : 0.f;
      pd[j] = in ? INFINITY : -1.f;
    }
  } else {
    for (int j = 0; j < per_thread; ++j) {
      const int l = j * T + tid, i = base + l;
      const bool in = i < end;
      sx[l] = in ? p[3 * i] : 0.f;
      sy[l] = in ? p[3 * i + 1] : 0.f;
      sz[l] = in ? p[3 * i + 2] : 0.f;
      sd[l] = in ? INFINITY : -1.f;
    }
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"((unsigned)__cvta_generic_to_shared(&landed[q])), "r"(cs) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_barrier();  // every CTA runs, its barriers set, before a DSMEM store

  for (int t = 1; t < npoint; ++t) {
    const int par = t & 1;
    float best = -1.f, bx = 0.f, by = 0.f, bz = 0.f;
    unsigned besti = 0xffffffffu;
    if constexpr (P > 0) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        fps_visit(px[j], py[j], pz[j], pd[j], base + tid + j * T, lx, ly, lz, best, besti,
                  bx, by, bz);
    } else {
      for (int j = 0; j < per_thread; ++j) {
        const int l = j * T + tid;
        float d = sd[l];
        fps_visit(sx[l], sy[l], sz[l], d, base + l, lx, ly, lz, best, besti, bx, by, bz);
        sd[l] = d;
      }
    }
    {  // the warp's winner, stored by the lane that holds it (lane 0: none)
      const unsigned mk = fps_key(best);
      unsigned k = mk, i = besti;
      warp_argmax(k, i);
      if (lane == winner_lane(true, mk, besti, k, i)) {
        wslot[par][warp] = make_uint4(k, i, __float_as_uint(bx), __float_as_uint(by));
        wz[par][warp] = bz;
      }
    }
    __syncthreads();
    if (cs == 1 || warp == 0) {  // the CTA's winner: every warp, or warp 0
      unsigned k = 0u, i = 0xffffffffu;
      if (lane < nwarps) {
        const uint4 s = wslot[par][lane];
        k = s.x;
        i = s.y;
      }
      const unsigned mk = k, mi = i;
      warp_argmax(k, i);
      const int src = winner_lane(lane < nwarps, mk, mi, k, i);
      const uint4 s = wslot[par][src];
      if (cs == 1) {
        lx = __uint_as_float(s.z);
        ly = __uint_as_float(s.w);
        lz = wz[par][src];
        if (tid == 0) o[t] = (int)i;
        continue;
      }
      if (lane < cs) {  // into every CTA of the cluster, lane r into rank r
        st_cluster(cluster_addr(&cslot[par][rank], lane), s);
        st_cluster(cluster_addr(&cz[par][rank], lane), wz[par][src]);
        mbar_arrive_cluster(cluster_addr(&landed[par], lane));
      }
    }
    mbar_wait(&landed[par], ((t - 1) >> 1) & 1);  // landed[par]'s ((t - 1) / 2)-th phase
    {  // the cluster's winner: every warp, from its CTA's copies
      unsigned k = 0u, i = 0xffffffffu;
      if (lane < cs) {
        const uint4 s = cslot[par][lane];
        k = s.x;
        i = s.y;
      }
      const unsigned mk = k, mi = i;
      warp_argmax(k, i);
      const int src = winner_lane(lane < cs, mk, mi, k, i);
      const uint4 s = cslot[par][src];
      lx = __uint_as_float(s.z);
      ly = __uint_as_float(s.w);
      lz = cz[par][src];
      if (rank == 0 && tid == 0) o[t] = (int)i;
    }
  }
  // no barrier to leave on: a CTA waits for every store into it, and reads
  // nothing of its peers
}

// K7: for centre (b, m), the first nsample points j (in point order) with
// max(|a|^2 + |b_j|^2 - 2 a.b_j, 0) < r2; slots past the hit count repeat
// the first hit, and a centre with no hit gets index 0.  What bounds it:
// ~10 f32 operations per (centre, point) pair scanned, up to the
// nsample-th hit (a.b, then the distance and its test; |b|^2 is once a
// point), and the scan's latency: with one thread a centre, SA1's
// 16,384 centres fill 4 warps an SM and a warp waits for its slowest
// thread's scan.  The design:
//  - a warp owns a centre; each step its lanes test 32 consecutive points,
//    __ballot_sync gathers the hits and __popc of the lanes below each hit
//    gives its slot, so hits land in point order; lanes whose slot is past
//    nsample (a step that straddles the end) write nothing.  The warp adds
//    the step's count and leaves together at nsample (a warp-uniform exit),
//    and its lanes fill the tail (the first hit, or 0);
//  - a block owns BQ_WARPS consecutive centres of one cloud and streams
//    the cloud through two shared-memory tiles of BQ_TILE points: each
//    thread loads its BQ_PER points of tile t + 1 into registers before its
//    warp scans tile t, and stores them after it, as float4 (x, y, z,
//    |b|^2), |b|^2 spelt by dot3_fma once per point (the same bits as the
//    per-pair form), so a pair costs one 16-byte shared load and a.b.  One
//    __syncthreads_or a tile: the block stops staging once none of its
//    warps is still short of nsample; a finished warp keeps staging and
//    arriving at the barrier.
// grid (ceil(M / BQ_WARPS), B)
__global__ void __launch_bounds__(BQ_THREADS)
ball_query_kernel(const float* __restrict__ centres,
                  const float* __restrict__ xyz, int* __restrict__ out, int M,
                  int N, float r2, int nsample) {
  __shared__ float4 tile[2][BQ_TILE];
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, m = blockIdx.x * BQ_WARPS + (tid >> 5);
  const bool mine = m < M;  // a warp past the last centre only stages
  const int64_t c = (int64_t)b * M + (mine ? m : 0);
  const float* p = xyz + (int64_t)b * N * 3;
  int* o = out + c * nsample;
  const float ax = centres[3 * c], ay = centres[3 * c + 1], az = centres[3 * c + 2];
  const float a2 = dot3_fma(ax, ay, az, ax, ay, az);
  int cnt = mine ? 0 : nsample, first = 0;

  float px[BQ_PER], py[BQ_PER], pz[BQ_PER];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < BQ_PER; ++u) {
      const int j = base + tid + u * BQ_THREADS;
      px[u] = py[u] = pz[u] = 0.0f;
      if (j < N) {
        px[u] = __ldg(p + 3 * j);
        py[u] = __ldg(p + 3 * j + 1);
        pz[u] = __ldg(p + 3 * j + 2);
      }
    }
  };
  auto stage = [&](float4* dst) {
#pragma unroll
    for (int u = 0; u < BQ_PER; ++u)
      dst[tid + u * BQ_THREADS] =
          make_float4(px[u], py[u], pz[u], dot3_fma(px[u], py[u], pz[u], px[u], py[u], pz[u]));
  };

  const int ntiles = (N + BQ_TILE - 1) / BQ_TILE;
  fetch(0);
  stage(tile[0]);
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed, and tile t - 1's buffer is read no more
    if (!__syncthreads_or(cnt < nsample)) break;
    const bool more = t + 1 < ntiles;
    if (more) fetch((t + 1) * BQ_TILE);
    if (cnt < nsample) {  // warp-uniform
      const float4* tl = tile[t & 1];
      const int base = t * BQ_TILE, len = min(BQ_TILE, N - base);
      for (int j0 = 0; j0 < len; j0 += 32) {
        const int j = j0 + lane;
        bool hit = false;
        if (j < len) {
          const float4 q = tl[j];
          const float ab = dot3_fma(ax, ay, az, q.x, q.y, q.z);
          hit = fmaxf(__fsub_rn(__fadd_rn(a2, q.w), __fmul_rn(2.0f, ab)), 0.0f) < r2;
        }
        const unsigned bits = __ballot_sync(0xffffffffu, hit);
        if (bits == 0u) continue;
        if (cnt == 0) first = base + j0 + __ffs(bits) - 1;
        if (hit) {
          const int slot = cnt + __popc(bits & ((1u << lane) - 1u));
          if (slot < nsample) o[slot] = base + j;
        }
        cnt += __popc(bits);
        if (cnt >= nsample) break;
      }
    }
    if (more) stage(tile[(t + 1) & 1]);
  }
  if (!mine) return;
  const int fill = cnt == 0 ? 0 : first;
  for (int k = cnt + lane; k < nsample; k += 32) o[k] = fill;
}

// K8 forward: out[b, m, :] = table[b, idx[b, m], :], the copy under JAX's
// gather_points / group_points.  It moves 4 C bytes of each row in and out
// and computes nothing, so the card's HBM bandwidth bounds it.  A group of
// G lanes (row_groups::size_for, 4 to 32 by C) owns one output row: lane 0
// loads the row's index once and a shuffle hands it to the group, and the
// lanes copy neighbouring float4s (C % 4 == 0, both tables 16-byte aligned)
// or neighbouring floats, so each 128-byte line is read once.  No division:
// the grid's y is the sample.  All offsets are 32-bit (the wrapper refuses
// B N C or B M C of 2^31 or more).  grid (ceil(M / (ROW_THREADS / G)), B),
// one row a group, as many groups as rows: no cap.
template <int G, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
gather_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int M, int C) {
  const int m = blockIdx.x * (ROW_THREADS / G) + threadIdx.x / G;
  if (m >= M) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int row = b * M + m;
  int r = 0;
  if (lane == 0) r = __ldg(idx + row);
  r = row_groups::shfl<G>(r, 0);
  const float* src = table + (b * N + r) * C;
  float* dst = out + row * C;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int u = lane; u < C / 4; u += G) d4[u] = __ldg(s4 + u);
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += G) dst[c] = __ldg(src + c);
  }
}

// K8 forward for C <= 8 (the clouds' xyz): one lane owns each row and reads
// its index, and a warp copies its 32 rows together.  Their 32 C output
// floats are contiguous, so lane l writes floats l, l + 32, ... of them,
// taking each one's row index from the lane that owns it: every store is a
// whole 128-byte line (a thread writing its own row of 3 would spread each
// store over 384 bytes).  grid (ceil(M / ROW_THREADS), B).
__global__ void __launch_bounds__(ROW_THREADS)
gather_narrow_rows_kernel(const float* __restrict__ table,
                          const int* __restrict__ idx, float* __restrict__ out,
                          int N, int M, int C) {
  const int m0 = blockIdx.x * ROW_THREADS + (threadIdx.x & ~31);  // warp's first
  if (m0 >= M) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int rows = min(32, M - m0);
  const int r = lane < rows ? __ldg(idx + b * M + m0 + lane) : 0;
  const float* tb = table + b * N * C;
  float* dst = out + (b * M + m0) * C;
  for (int f = lane; f < 32 * C; f += 32) {  // C passes for every lane
    const int i = f / C;
    const int src = __shfl_sync(0xffffffffu, r, i);
    if (i < rows) dst[f] = __ldg(tb + src * C + (f - i * C));
  }
}

// K8 backward: dtable[b, idx[b, m], :] += grad[b, m, :], the transpose of
// gather_rows (JAX's autodiff of group_points / gather_points).  It reads
// each grad row once and adds it into the table, so HBM bytes bound it as
// long as the adds do not pile onto a few rows: f32 atomics on one address
// run one after another.  They do pile up on the path: ball query fills
// every slot past a ball's hit count with its first hit, so in a sparse
// ball up to nsample - 1 consecutive grad rows name one table row.  The
// design:
//  - a group of G lanes (row_groups::size_for, 4 to 32 by C) owns a run of
//    SCATTER_RUN consecutive rows of one sample.  Lane i (< SCATTER_RUN)
//    loads row i's index once and shuffles hand the run's indices to the
//    group;
//  - run merge: the lanes read neighbouring float4s (C % 4 == 0, both
//    pointers 16-byte aligned; else neighbouring floats) of all the run's
//    rows first, then walk the run keeping the sum in registers while the
//    index repeats, and add it with one atomic (16 bytes a float4, sm_90)
//    when the index changes and at the run's end.  Correct for any index
//    sequence (the same sum up to f32 order); for ball query's tail it
//    turns 16 atomics on a 1-hit ball's row into 2;
//  - no division, 32-bit offsets (the wrapper refuses B M C or B N C of
//    2^31 or more): the grid's y is the sample.
// SCATTER_RUN = 8: half a ball of nsample 16 (the aligned runs of a ball's
// rows add its tail with one atomic each), 8 float4s in flight a lane, and
// enough groups to fill the card at the path's 32k rows.
// grid (ceil(M / (ROW_THREADS / G * SCATTER_RUN)), B).
constexpr int SCATTER_RUN = 8;

// d[0:4] += v (one 16-byte atomic, sm_90, global memory) or d[0] += v.x
template <bool VEC>
__device__ __forceinline__ void add_unit(float* d, float4 v) {
  if constexpr (VEC) {
    atomicAdd(reinterpret_cast<float4*>(d), v);
  } else {
    atomicAdd(d, v.x);
  }
}

template <int G, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
scatter_add_rows_kernel(const float* __restrict__ grad,
                        const int* __restrict__ idx, float* __restrict__ dtable,
                        int N, int M, int C) {
  const int m0 = (blockIdx.x * (ROW_THREADS / G) + threadIdx.x / G) * SCATTER_RUN;
  if (m0 >= M) return;  // the whole group leaves together
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int rows = min(SCATTER_RUN, M - m0);
  constexpr int HELD = (SCATTER_RUN + G - 1) / G;  // indices a lane loads
  int held[HELD];
#pragma unroll
  for (int q = 0; q < HELD; ++q) {
    const int i = q * G + lane;
    held[q] = i < rows ? __ldg(idx + b * M + m0 + i) : -1;
  }
  int r[SCATTER_RUN];  // the run's indices, in every lane of the group
#pragma unroll
  for (int i = 0; i < SCATTER_RUN; ++i) r[i] = row_groups::shfl<G>(held[i / G], i % G);
  const float* g = grad + (b * M + m0) * C;
  float* dt = dtable + b * N * C;
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  for (int u = lane; u < units; u += G) {  // no shuffle below: lanes may leave
    float4 v[SCATTER_RUN];
#pragma unroll
    for (int i = 0; i < SCATTER_RUN; ++i) {
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows) {
        if constexpr (VEC) {
          v[i] = __ldg(reinterpret_cast<const float4*>(g + i * C) + u);
        } else {
          v[i].x = __ldg(g + i * C + u);
        }
      }
    }
    float4 acc = v[0];
    int cur = r[0];
#pragma unroll
    for (int i = 1; i < SCATTER_RUN; ++i) {
      if (i >= rows) break;
      if (r[i] == cur) {
        acc.x += v[i].x;
        acc.y += v[i].y;
        acc.z += v[i].z;
        acc.w += v[i].w;
      } else {
        add_unit<VEC>(dt + cur * C + u * V, acc);
        cur = r[i];
        acc = v[i];
      }
    }
    add_unit<VEC>(dt + cur * C + u * V, acc);
  }
}

// K8 backward for C <= 8 (the centres' xyz): the mirror of
// gather_narrow_rows_kernel.  One lane owns each row and loads its index;
// a warp reads its 32 rows' 32 C contiguous floats together, lane l taking
// floats l, l + 32, ..., and adds each into the row the owning lane's
// index names.  No merge: these maps (FPS picks) name each row once.
// grid (ceil(M / ROW_THREADS), B).
__global__ void __launch_bounds__(ROW_THREADS)
scatter_add_narrow_rows_kernel(const float* __restrict__ grad,
                               const int* __restrict__ idx,
                               float* __restrict__ dtable, int N, int M, int C) {
  const int m0 = blockIdx.x * ROW_THREADS + (threadIdx.x & ~31);  // warp's first
  if (m0 >= M) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int rows = min(32, M - m0);
  const int r = lane < rows ? __ldg(idx + b * M + m0 + lane) : 0;
  const float* g = grad + (b * M + m0) * C;
  float* dt = dtable + b * N * C;
  for (int f = lane; f < 32 * C; f += 32) {  // C passes for every lane
    const int i = f / C;
    const int dst = __shfl_sync(0xffffffffu, r, i);
    if (i < rows) atomicAdd(dt + dst * C + (f - i * C), __ldg(g + f));
  }
}

constexpr int NN_THREADS = 256;
constexpr int NN_TILE = 1024;  // known points a staged tile (16 KB of float4)

// (d, i) before (e, j): the lexicographic order of lax.top_k and of the
// twin's stable sort on (distance, index)
__device__ __forceinline__ bool nn_before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// The first three of two sorted triples (a: this lane's, b: its partner's)
// under nn_before, into a.  Indices of two lanes never meet (each known
// point is one lane's) but for the sentinels, which are equal: so both
// lanes of a pair end with the same triple.
__device__ __forceinline__ void nn_merge(float (&a)[3], int (&ia)[3], const float (&b)[3],
                                         const int (&ib)[3]) {
  const bool t0 = nn_before(a[0], ia[0], b[0], ib[0]);
  const float o0 = t0 ? a[0] : b[0];
  const int j0 = t0 ? ia[0] : ib[0];
  const float x = t0 ? a[1] : a[0], y = t0 ? b[0] : b[1];  // the heads left
  const int ix = t0 ? ia[1] : ia[0], iy = t0 ? ib[0] : ib[1];
  const bool t1 = nn_before(x, ix, y, iy);
  const float o1 = t1 ? x : y;
  const int j1 = t1 ? ix : iy;
  // two taken: both of a (a2 vs b0), one each (a1 vs b1) or both of b (a0 vs b2)
  const bool aa = t0 && t1, bb = !t0 && !t1;
  const float xa = aa ? a[2] : bb ? a[0] : a[1], yb = aa ? b[0] : bb ? b[2] : b[1];
  const int ixa = aa ? ia[2] : bb ? ia[0] : ia[1], iyb = aa ? ib[0] : bb ? ib[2] : ib[1];
  const bool t2 = nn_before(xa, ixa, yb, iyb);
  a[0] = o0;
  ia[0] = j0;
  a[1] = o1;
  ia[1] = j1;
  a[2] = t2 ? xa : yb;
  ia[2] = t2 ? ixa : iyb;
}

// K9: for unknown point (b, n), the three known points of least
// d2 = max((|u|^2 + |k|^2) - 2 u.k, 0), ascending, ties to the lower index
// (lax.top_k, the twin's stable sort), and their exact distances
// sqrt(|u - k|^2).  What bounds it: ~13 f32 operations a (unknown, known)
// pair, and, with one thread a point as before, the scan's latency: FP1
// and FP2 made 64 and 128 blocks of 2 warps, each thread scanning all M
// known points serially.  The design:
//  - a group of G lanes (32, or 16 / 8 where M / G falls below 8 points a
//    lane) owns an unknown point; lane l scans the known points j = l mod
//    G in increasing j, keeping a running top-3 with strict < (ties keep
//    the lower index), from (INF, INT_MAX) sentinels, which no real point
//    follows;
//  - log2 G butterfly rounds of __shfl_xor_sync merge two sorted triples
//    under the lexicographic (d, index) order (nn_merge), which gives the
//    serial scan's answer whichever lane saw which point; a group past the
//    cloud's last point runs them too (full masks), on point 0;
//  - a block owns NN_THREADS / G points of one cloud and stages the known
//    cloud in shared memory, NN_TILE points a tile, as float4 (x, y, z,
//    |k|^2), |k|^2 spelt by dot3_fma once a point, so a pair costs one
//    16-byte shared load and u.k;
//  - lanes 0-2 of the group then recompute one winner's exact distance
//    each (from the staged tile where it holds the whole cloud) and write
//    it with its index.
// grid (ceil(N / (NN_THREADS / G)), B)
template <int G>
__global__ void __launch_bounds__(NN_THREADS)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, float* __restrict__ dist,
                int* __restrict__ idx, int N, int M) {
  __shared__ float4 tile[NN_TILE];
  const int tid = threadIdx.x, lane = tid % G;
  const int64_t b = blockIdx.y;
  const int n = blockIdx.x * (NN_THREADS / G) + tid / G;
  const bool active = n < N;
  const float* kp = known + b * M * 3;
  const float* up = unknown + (b * N + (active ? n : 0)) * 3;
  const float ux = up[0], uy = up[1], uz = up[2];
  const float uu = dot3_fma(ux, uy, uz, ux, uy, uz);
  float d[3] = {INFINITY, INFINITY, INFINITY};
  int i[3] = {INT_MAX, INT_MAX, INT_MAX};
  for (int base = 0; base < M; base += NN_TILE) {
    const int cnt = min(NN_TILE, M - base);
    if (base > 0) __syncthreads();  // the previous tile is read no more
    for (int j = tid; j < cnt; j += NN_THREADS) {
      const float x = kp[3 * (base + j)], y = kp[3 * (base + j) + 1],
                  z = kp[3 * (base + j) + 2];
      tile[j] = make_float4(x, y, z, dot3_fma(x, y, z, x, y, z));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = lane; j < cnt; j += G) {
      const float4 q = tile[j];
      const float ab = dot3_fma(ux, uy, uz, q.x, q.y, q.z);
      const float e = fmaxf(__fsub_rn(__fadd_rn(uu, q.w), __fmul_rn(2.0f, ab)), 0.0f);
      if (e < d[2]) {
        const int k = base + j;
        if (e < d[1]) {
          d[2] = d[1];
          i[2] = i[1];
          if (e < d[0]) {
            d[1] = d[0];
            i[1] = i[0];
            d[0] = e;
            i[0] = k;
          } else {
            d[1] = e;
            i[1] = k;
          }
        } else {
          d[2] = e;
          i[2] = k;
        }
      }
    }
  }
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) {
    float e[3];
    int k[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e[r] = __shfl_xor_sync(0xffffffffu, d[r], m);
      k[r] = __shfl_xor_sync(0xffffffffu, i[r], m);
    }
    nn_merge(d, i, e, k);
  }
  if (!active || lane >= 3) return;
  const int w = lane == 0 ? i[0] : lane == 1 ? i[1] : i[2];
  float kx, ky, kz;
  if (M <= NN_TILE) {  // the cloud is still staged
    const float4 q = tile[w];
    kx = q.x;
    ky = q.y;
    kz = q.z;
  } else {
    kx = kp[3 * w];
    ky = kp[3 * w + 1];
    kz = kp[3 * w + 2];
  }
  const float dx = __fsub_rn(ux, kx);
  const float dy = __fsub_rn(uy, ky);
  const float dz = __fsub_rn(uz, kz);
  const int64_t o = (b * N + n) * 3 + lane;
  dist[o] = __fsqrt_rn(fmaxf(dot3_fma(dx, dy, dz, dx, dy, dz), 0.0f));
  idx[o] = w;
}

// K9: out[b, n, c] = fma(f[i2, c], w2, fma(f[i1, c], w1, f[i0, c] w0)) with
// f = feats[b].  One thread per (n, VEC channels): float4 loads and stores
// when C % 4 == 0 and the pointers are 16-byte aligned (C = 256 on the
// path).  Bound by device-memory bandwidth.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS)
three_interpolate_kernel(const float* __restrict__ feats,
                         const int* __restrict__ idx,
                         const float* __restrict__ weight,
                         float* __restrict__ out, int M, int N, int C,
                         int64_t total) {
  const int CV = C / VEC;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = e / CV;  // b * N + n
    const int c = (int)(e - row * CV) * VEC;
    const int64_t b = row / N;
    const int* ip = idx + row * 3;
    const float* wp = weight + row * 3;
    const float w0 = __ldg(wp), w1 = __ldg(wp + 1), w2 = __ldg(wp + 2);
    const float* f0 = feats + (b * M + __ldg(ip)) * C + c;
    const float* f1 = feats + (b * M + __ldg(ip + 1)) * C + c;
    const float* f2 = feats + (b * M + __ldg(ip + 2)) * C + c;
    float* o = out + row * C + c;
    if constexpr (VEC == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(f0));
      const float4 p = __ldg(reinterpret_cast<const float4*>(f1));
      const float4 q = __ldg(reinterpret_cast<const float4*>(f2));
      float4 r;
      r.x = __fmaf_rn(q.x, w2, __fmaf_rn(p.x, w1, __fmul_rn(a.x, w0)));
      r.y = __fmaf_rn(q.y, w2, __fmaf_rn(p.y, w1, __fmul_rn(a.y, w0)));
      r.z = __fmaf_rn(q.z, w2, __fmaf_rn(p.z, w1, __fmul_rn(a.z, w0)));
      r.w = __fmaf_rn(q.w, w2, __fmaf_rn(p.w, w1, __fmul_rn(a.w, w0)));
      *reinterpret_cast<float4*>(o) = r;
    } else {
      *o = __fmaf_rn(__ldg(f2), w2,
                     __fmaf_rn(__ldg(f1), w1, __fmul_rn(__ldg(f0), w0)));
    }
  }
}

// K9 backward: dfeats[b, m, c] = the sum of grad[b, n, c] * w[b, n, j]
// over every entry e = 3 n + j of sample b with idx[b, n, j] = m, the
// transpose of the interpolation (JAX's autodiff of the inline gather at
// detect/modules.py:113-120).  The unknown points outnumber the known ones
// (FP1 512 over 256, FP2 1024 over 512), so each known row takes ~6
// products; as f32 atomics on device memory (the first design, 12 a
// float4) they ran one after another in L2, and shared-memory f32 atomics
// are no cure on sm_90 (a compare-and-swap loop).  So each output row is
// summed by one warp in registers, in entry order, and written once:
//  - a block owns INTERP_ROWS consecutive known rows of sample b, a warp
//    each.  Phase 1: warp w reads the entries [w L, (w + 1) L) of the
//    sample's index (coalesced, INTERP_SCAN loads of 32 in flight) and
//    keeps those that name one of the block's rows, packed as
//    (e << 3) | row, in shared memory in entry order (a ballot and a prefix
//    count: no atomic);
//  - phase 2, after one __syncthreads: the warp of row m reads the kept
//    entries of all warps in order, 32 at a time, and queues its own (a
//    ballot) in shared memory; a full queue (or the end) is flushed: the
//    grad rows n = e / 3 of INTERP_BATCH entries are loaded at once (one
//    round trip for the ~6 entries of a row on the path) and the rounded
//    products (__fmul_rn, as the twin's scatter-add of rounded products)
//    with the entries' weights are added in entry order into up to
//    INTERP_ACC float4s (C % 4 == 0 and both tables 16-byte aligned; else
//    floats) a lane, lanes on neighbouring channels; then it stores the
//    row.  A known row that no entry names comes out as exact zeros,
//    so the wrapper allocates with torch.empty; the sums run in entry
//    order from +0, the order of the twin's scatter-add on the CPU (a
//    batch's missing entries add +0 products, which change no sum);
//  - every block reads the sample's 3 N indices (12 KB at FP2, from L2);
//    grad rows are read once per entry that names them, from L2 (8 MB at
//    FP2); shared memory holds 3 N packed entries (the wrapper refuses an
//    N past a block's 227 KB: three_interp_entries);
//  - no division by a variable, 32-bit offsets (the wrapper refuses B N C
//    or B M C of 2^31 or more): the grid's y is the sample.
// grid (ceil(M / INTERP_ROWS), B), ROW_THREADS threads, INTERP_ROWS L ints
// of dynamic shared memory.
constexpr int INTERP_ROWS = ROW_THREADS / 32;  // known rows a block, a warp each
constexpr int INTERP_ACC = 2;    // units a lane sums in one walk: C 256 in one
constexpr int INTERP_SCAN = 8;   // index loads a lane has in flight in phase 1
constexpr int INTERP_BATCH = 8;  // entries whose grad rows a warp loads together

// acc[a] += x * w for the INTERP_ACC units of a lane
template <bool VEC>
__device__ __forceinline__ void add_products(float4 (&acc)[INTERP_ACC],
                                             const float4 (&x)[INTERP_ACC], float w) {
#pragma unroll
  for (int a = 0; a < INTERP_ACC; ++a) {
    acc[a].x += __fmul_rn(x[a].x, w);
    if constexpr (VEC) {
      acc[a].y += __fmul_rn(x[a].y, w);
      acc[a].z += __fmul_rn(x[a].z, w);
      acc[a].w += __fmul_rn(x[a].w, w);
    }
  }
}

// acc += the products of a warp's `pending` queued entries e (in order):
// grad row e / 3 at the lane's units u0, u0 + 32, ... times weight e, the
// grad rows of INTERP_BATCH entries loaded at once
template <bool VEC>
__device__ __forceinline__ void flush_queue(float4 (&acc)[INTERP_ACC],
                                            const int* queue, int pending,
                                            const float* __restrict__ gb,
                                            const float* __restrict__ wb,
                                            int C, int units, int u0) {
  __syncwarp();  // the queue's writes, before any lane reads them
  for (int j0 = 0; j0 < pending; j0 += INTERP_BATCH) {
    float w[INTERP_BATCH];
    float4 x[INTERP_BATCH][INTERP_ACC];
#pragma unroll
    for (int q = 0; q < INTERP_BATCH; ++q) {
      const bool have = j0 + q < pending;
      const int e = have ? queue[j0 + q] : 0;
      w[q] = have ? __ldg(wb + e) : 0.f;  // past the entries: + (+0)
      const float* g = gb + (e / 3) * C;
#pragma unroll
      for (int a = 0; a < INTERP_ACC; ++a) {
        const int u = u0 + 32 * a;
        x[q][a] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!have || u >= units) continue;
        if constexpr (VEC) {
          x[q][a] = __ldg(reinterpret_cast<const float4*>(g) + u);
        } else {
          x[q][a].x = __ldg(g + u);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < INTERP_BATCH; ++q) add_products<VEC>(acc, x[q], w[q]);
  }
  __syncwarp();  // every read, before the queue is written again
}

template <bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
three_interpolate_grad_kernel(const float* __restrict__ grad,
                              const int* __restrict__ idx,
                              const float* __restrict__ weight,
                              float* __restrict__ dfeats, int M, int N, int C,
                              int L) {
  extern __shared__ int kept[];  // [INTERP_ROWS][L]: warp w's (e << 3) | row
  __shared__ int counts[INTERP_ROWS];
  __shared__ int queues[INTERP_ROWS][2 * 32];  // a warp's entries to load
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * INTERP_ROWS;
  const int E = 3 * N;
  const int* ib = idx + b * E;
  int* mine = kept + warp * L;
  int cnt = 0;
  const int end = min(E, (warp + 1) * L);
  for (int e0 = warp * L; e0 < end; e0 += 32 * INTERP_SCAN) {  // warp-uniform
    unsigned r[INTERP_SCAN];
#pragma unroll
    for (int q = 0; q < INTERP_SCAN; ++q) {
      const int e = e0 + 32 * q + lane;
      r[q] = e < end ? (unsigned)(__ldg(ib + e) - m0) : INTERP_ROWS;
    }
#pragma unroll
    for (int q = 0; q < INTERP_SCAN; ++q) {
      const bool hit = r[q] < INTERP_ROWS;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (hit) mine[cnt + __popc(bal & below)] = ((e0 + 32 * q + lane) << 3) | (int)r[q];
      cnt += __popc(bal);
    }
  }
  if (lane == 0) counts[warp] = cnt;
  __syncthreads();
  const int m = m0 + warp;
  if (m >= M) return;  // no barrier below
  constexpr int V = VEC ? 4 : 1;
  const int units = C / V;
  const float* gb = grad + b * N * C;
  const float* wb = weight + b * E;
  float* o = dfeats + (b * M + m) * C;
  int* queue = queues[warp];
  for (int c0 = 0; c0 < units; c0 += 32 * INTERP_ACC) {  // warp-uniform
    float4 acc[INTERP_ACC];
#pragma unroll
    for (int a = 0; a < INTERP_ACC; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    int pending = 0;
    for (int v = 0; v < INTERP_ROWS; ++v) {  // the lists in entry order
      const int* list = kept + v * L;
      const int n_kept = counts[v];
      for (int k0 = 0; k0 < n_kept; k0 += 32) {
        const bool in = k0 + lane < n_kept;
        const int h = in ? list[k0 + lane] : 0;
        const bool own = in && (h & (INTERP_ROWS - 1)) == warp;
        const unsigned bal = __ballot_sync(0xffffffffu, own);
        if (own) queue[pending + __popc(bal & below)] = h >> 3;
        pending += __popc(bal);
        if (pending >= 32) {  // at most 63 queued
          flush_queue<VEC>(acc, queue, pending, gb, wb, C, units, c0 + lane);
          pending = 0;
        }
      }
    }
    flush_queue<VEC>(acc, queue, pending, gb, wb, C, units, c0 + lane);
#pragma unroll
    for (int a = 0; a < INTERP_ACC; ++a) {
      const int u = c0 + 32 * a + lane;
      if (u >= units) break;
      if constexpr (VEC) {
        reinterpret_cast<float4*>(o)[u] = acc[a];
      } else {
        o[u] = acc[a].x;
      }
    }
  }
}

bool vec4_ok(int C, const void* a, const void* b) {
  return C % 4 == 0 && ((uintptr_t)a & 15) == 0 && ((uintptr_t)b & 15) == 0;
}

int grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return blocks < 1 ? 1 : (int)blocks;
}

// FPS's launch shape for a cluster of cs CTAs over N points: per_cta
// points a CTA, per_thread a thread, T threads, and P, the template (0: the
// points in shared memory, smem bytes of them); false when the cloud is past
// both forms' capacity at this cs.
bool fps_shape(int N, int cs, int* per_cta, int* per_thread, int* T, int* P, size_t* smem) {
  *per_cta = (N + cs - 1) / cs;
  const int per = (*per_cta + FPS_MAX_THREADS - 1) / FPS_MAX_THREADS;  // points a thread
  const int t = (*per_cta + per - 1) / per;
  *T = (t + 31) / 32 * 32;
  *per_thread = per;
  *P = per <= FPS_MAX_P ? per : FPS_SMEM;
  *smem = *P == FPS_SMEM ? sizeof(float) * 4 * per * *T : 0;
  return *smem <= FPS_SMEM_BYTES;
}

// The kernel instance of P (FPS_SMEM: the shared-memory form).
void* fps_instance(int P) {
  switch (P) {
    case 1: return (void*)fps_kernel<1>;
    case 2: return (void*)fps_kernel<2>;
    case 3: return (void*)fps_kernel<3>;
    case 4: return (void*)fps_kernel<4>;
    case 5: return (void*)fps_kernel<5>;
    case 6: return (void*)fps_kernel<6>;
    default: return (void*)fps_kernel<FPS_SMEM>;
  }
}

// The launch configuration of B clouds at cs CTAs a cloud (the cluster
// attribute set; `attr` holds it), after the kernel's one-time attributes:
// non-portable cluster sizes, and the dynamic shared memory it needs.
cudaError_t fps_config(int B, int cs, int T, int P, size_t smem, cudaStream_t stream,
                       cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static bool portable_off[FPS_MAX_P + 1] = {};  // by P
  static size_t granted[FPS_MAX_P + 1] = {};
  void* kernel = fps_instance(P);
  if (!portable_off[P]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    portable_off[P] = true;
  }
  if (smem > granted[P]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted[P] = smem;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * cs);
  cfg->blockDim = dim3(T);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// FPS: the cluster size for B clouds of N points, at most FPS_MAX_CLUSTER
// CTAs a cloud (1, 2, 4, 8 or 16).  One CTA while its registers hold the cloud
// (N <= FPS_MAX_THREADS FPS_MAX_P): a pick across CTAs costs ~0.7 us more
// than within one (PERF.md), more than a few more points a thread do.
// Past that, the largest that gives each CTA at least FPS_MAX_THREADS
// points while the batch's B clusters fit on the card's SMs at once
// (cudaOccupancyMaxActiveClusters), with the points in registers or shared
// memory; failing both, the smallest that holds the cloud and fits.
// Returns cs, -1 when no cluster size holds the cloud, or -(CUDA error)
// when the card refuses every one that does.
int pc_fps_cluster(int B, int N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool one_cta = (N + FPS_MAX_THREADS - 1) / FPS_MAX_THREADS <= FPS_MAX_P;
  int fallback = -1, err = 0;
  for (int cs = FPS_MAX_CLUSTER; cs >= 1; cs >>= 1) {
    int per_cta, per_thread, T, P;
    size_t smem;
    if (!fps_shape(N, cs, &per_cta, &per_thread, &T, &P, &smem)) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = fps_config(B, cs, T, P, smem, nullptr, &cfg, &attr);
    int clusters = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, fps_instance(P), &cfg);
    if (e != cudaSuccess || clusters < 1) {
      cudaGetLastError();  // a refused size is not the caller's error
      err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidClusterSize;
      continue;
    }
    fallback = cs;  // the smallest that fits, so far
    const bool preferred = cs == 1 || (!one_cta && per_cta >= FPS_MAX_THREADS);
    if (preferred && clusters >= B && B * cs <= sms) return cs;
  }
  return fallback > 0 ? fallback : err != 0 ? -err : -1;
}

int pc_fps(const void* xyz, void* out, int B, int N, int npoint, int cs, void* stream) {
  int per_cta, per_thread, T, P;
  size_t smem;
  if (!fps_shape(N, cs, &per_cta, &per_thread, &T, &P, &smem))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = fps_config(B, cs, T, P, smem, (cudaStream_t)stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  const float* xp = (const float*)xyz;
  int* op = (int*)out;
  void* args[] = {&xp, &op, &N, &npoint, &per_cta, &per_thread};
  const cudaError_t l = cudaLaunchKernelExC(&cfg, fps_instance(P), args);
  return (int)(l != cudaSuccess ? l : cudaGetLastError());
}

int pc_ball_query(const void* centres, const void* xyz, void* out, int B, int M,
                  int N, float r2, int nsample, void* stream) {
  const dim3 grid((M + BQ_WARPS - 1) / BQ_WARPS, B);
  ball_query_kernel<<<grid, BQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)centres, (const float*)xyz, (int*)out, M, N, r2, nsample);
  return (int)cudaGetLastError();
}

int pc_gather_rows(const void* table, const void* idx, void* out, int B, int N,
                   int M, int C, void* stream) {
  const bool vec = vec4_ok(C, table, out);
  row_groups::dispatch(row_groups::size_for(C, vec), vec, [&](auto G_, auto VEC_) {
    constexpr int G = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    const int rows_per_block = ROW_THREADS / G;
    const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
    if constexpr (G == 1) {
      gather_narrow_rows_kernel<<<grid, ROW_THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)table, (const int*)idx, (float*)out, N, M, C);
    } else {
      gather_rows_kernel<G, VEC><<<grid, ROW_THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)table, (const int*)idx, (float*)out, N, M, C);
    }
  });
  return (int)cudaGetLastError();
}

int pc_scatter_add_rows(const void* grad, const void* idx, void* dtable, int B,
                        int N, int M, int C, void* stream) {
  const bool vec = vec4_ok(C, grad, dtable);
  row_groups::dispatch(row_groups::size_for(C, vec), vec, [&](auto G_, auto VEC_) {
    constexpr int G = decltype(G_)::value;
    constexpr bool VEC = decltype(VEC_)::value;
    if constexpr (G == 1) {
      const dim3 grid((M + ROW_THREADS - 1) / ROW_THREADS, B);
      scatter_add_narrow_rows_kernel<<<grid, ROW_THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)grad, (const int*)idx, (float*)dtable, N, M, C);
    } else {
      const int rows_per_block = ROW_THREADS / G * SCATTER_RUN;
      const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
      scatter_add_rows_kernel<G, VEC><<<grid, ROW_THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)grad, (const int*)idx, (float*)dtable, N, M, C);
    }
  });
  return (int)cudaGetLastError();
}

int pc_three_nn(const void* unknown, const void* known, void* dist, void* idx,
                int B, int N, int M, void* stream) {
  // a group of G lanes a point: 32, or 16 / 8 where M / G falls below 8
  const int G = M >= 8 * 32 ? 32 : M >= 8 * 16 ? 16 : 8;
  auto go = [&](auto kernel) {
    const int per = NN_THREADS / G;
    const dim3 grid((N + per - 1) / per, B);
    kernel<<<grid, NN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)unknown, (const float*)known, (float*)dist, (int*)idx, N, M);
  };
  switch (G) {
    case 32: go(three_nn_kernel<32>); break;
    case 16: go(three_nn_kernel<16>); break;
    default: go(three_nn_kernel<8>); break;
  }
  return (int)cudaGetLastError();
}

int pc_three_interpolate(const void* feats, const void* idx, const void* weight,
                         void* out, int B, int M, int N, int C, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4_ok(C, feats, out)) {
    const int64_t total = (int64_t)B * N * (C / 4);
    three_interpolate_kernel<4><<<grid_for(total, ROW_THREADS), ROW_THREADS, 0, s>>>(
        (const float*)feats, (const int*)idx, (const float*)weight, (float*)out,
        M, N, C, total);
  } else {
    const int64_t total = (int64_t)B * N * C;
    three_interpolate_kernel<1><<<grid_for(total, ROW_THREADS), ROW_THREADS, 0, s>>>(
        (const float*)feats, (const int*)idx, (const float*)weight, (float*)out,
        M, N, C, total);
  }
  return (int)cudaGetLastError();
}

int pc_three_interpolate_grad(const void* grad, const void* idx,
                              const void* weight, void* dfeats, int B, int M,
                              int N, int C, int L, void* stream) {
  const size_t smem = (size_t)INTERP_ROWS * L * sizeof(int);
  const dim3 grid((M + INTERP_ROWS - 1) / INTERP_ROWS, B);
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024) {  // dynamic shared memory past the default cap
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, ROW_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)grad, (const int*)idx, (const float*)weight,
        (float*)dfeats, M, N, C, L);
    return (int)cudaGetLastError();
  };
  return vec4_ok(C, grad, dfeats) ? launch(three_interpolate_grad_kernel<true>)
                                  : launch(three_interpolate_grad_kernel<false>);
}

}  // extern "C"
