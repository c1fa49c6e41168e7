// Hand-written Hopper (sm_90a) kernels for the PointNet++ ops of the VoteNet
// detection step (see pointcontrast_tpu_torch/detect/kernels.py for the
// Python wrappers, their plain-torch twins and which JAX op each replaces):
//   K6 fps_kernel             furthest point sampling, one block per cloud
//   K7 ball_query_kernel      first nsample in-radius points per centre
//   K8 gather_rows_kernel     out[b, m, :] = table[b, idx[b, m], :]
//      scatter_add_rows_kernel  its backward, f32 atomics
//
// Layout: clouds are [B, N, 3] row-major f32, feature tables [B, N, C]
// row-major f32, indices int32.  No kernel tests bounds: the indices come
// from fps_kernel / ball_query_kernel (in range by construction) or were
// checked per sample on the host (DetectionBatch.to).
//
// Bit-exact agreement with the plain twins and the JAX ops: every distance
// is spelt out with __fmul_rn/__fadd_rn/__fsub_rn in the twins' order.
// nvcc would otherwise contract a*b + c into one FMA, which rounds once
// instead of twice; on 40000-point clouds in which 3/4 of the points are
// duplicates, one such rounding difference flips an argmax.
//
// Each C entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FPS_MAX_THREADS = 1024;
constexpr int BQ_THREADS = 128;
constexpr int ROW_THREADS = 256;

// (x^2 + y^2) + z^2, each product and sum rounded on its own
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (value, index) pair order of an argmax that keeps the FIRST maximum
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// K6: idx[b, 0] = 0; idx[b, t] = argmax_i min_{s<t} |p_i - p_idx[b,s]|^2.
// One block per cloud.  dist [B, N] is scratch holding each point's running
// min-distance; thread t owns points t, t + blockDim, ... (so its local
// argmax with a strict > keeps the lowest index), then a warp-shuffle and a
// shared-memory stage reduce (value, index) with ties to the lower index,
// as jnp.argmax / torch.argmax do.
__global__ void __launch_bounds__(FPS_MAX_THREADS)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ dist,
           int* __restrict__ out, int N, int npoint) {
  __shared__ float wval[FPS_MAX_THREADS / 32];
  __shared__ int widx[FPS_MAX_THREADS / 32];
  __shared__ int chosen;
  const int b = blockIdx.x;
  const float* p = xyz + (int64_t)b * N * 3;
  float* d = dist + (int64_t)b * N;
  int* o = out + (int64_t)b * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  for (int i = tid; i < N; i += blockDim.x) d[i] = INFINITY;
  if (tid == 0) o[0] = 0;
  int last = 0;
  for (int t = 1; t < npoint; ++t) {
    const float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
    float best = -1.0f;  // below every distance
    int besti = 0x7fffffff;
    for (int i = tid; i < N; i += blockDim.x) {
      const float di = sq3(__fsub_rn(p[3 * i], lx), __fsub_rn(p[3 * i + 1], ly),
                           __fsub_rn(p[3 * i + 2], lz));
      const float m = fminf(d[i], di);
      d[i] = m;
      if (m > best) {
        best = m;
        besti = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      if (beats(ov, oi, best, besti)) {
        best = ov;
        besti = oi;
      }
    }
    if (lane == 0) {
      wval[warp] = best;
      widx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? wval[lane] : -1.0f;
      besti = lane < nwarps ? widx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, besti, off);
        if (beats(ov, oi, best, besti)) {
          best = ov;
          besti = oi;
        }
      }
      if (lane == 0) {
        chosen = besti;
        o[t] = besti;
      }
    }
    __syncthreads();
    last = chosen;
  }
}

// K7: for centre (b, m), the first nsample points j (in point order) with
// max(|a|^2 + |b_j|^2 - 2 a.b_j, 0) < r2; slots past the hit count repeat
// the first hit, and a centre with no hit gets index 0.  One thread per
// centre; the threads of a warp read the same point at the same time.
__global__ void __launch_bounds__(BQ_THREADS)
ball_query_kernel(const float* __restrict__ centres,
                  const float* __restrict__ xyz, int* __restrict__ out, int B,
                  int M, int N, float r2, int nsample) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (int64_t)B * M) return;
  const int64_t b = c / M;
  const float* p = xyz + b * N * 3;
  int* o = out + c * nsample;
  const float ax = centres[3 * c], ay = centres[3 * c + 1], az = centres[3 * c + 2];
  const float a2 = sq3(ax, ay, az);
  int cnt = 0;
  for (int j = 0; j < N && cnt < nsample; ++j) {
    const float bx = p[3 * j], by = p[3 * j + 1], bz = p[3 * j + 2];
    const float ab = __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                               __fmul_rn(az, bz));
    const float d2 = fmaxf(
        __fsub_rn(__fadd_rn(a2, sq3(bx, by, bz)), __fmul_rn(2.0f, ab)), 0.0f);
    if (d2 < r2) {
      if (cnt == 0)
        for (int k = 1; k < nsample; ++k) o[k] = j;
      o[cnt++] = j;
    }
  }
  if (cnt == 0)
    for (int k = 0; k < nsample; ++k) o[k] = 0;
}

// K8 forward: out[b, m, c] = table[b, idx[b, m], c], one thread per output
// element (neighbouring threads copy neighbouring channels of one row).
__global__ void __launch_bounds__(ROW_THREADS)
gather_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int M, int C,
                   int64_t total) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = e / C;  // b * M + m
    const int c = (int)(e - row * C);
    const int64_t b = row / M;
    out[e] = __ldg(table + (b * N + __ldg(idx + row)) * C + c);
  }
}

// K8 backward: dtable[b, idx[b, m], c] += grad[b, m, c].  Rows collide (one
// vote sits in many groups, several points share a voxel), so the f32
// atomics add in no fixed order.
__global__ void __launch_bounds__(ROW_THREADS)
scatter_add_rows_kernel(const float* __restrict__ grad,
                        const int* __restrict__ idx, float* __restrict__ dtable,
                        int N, int M, int C, int64_t total) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = e / C;
    const int c = (int)(e - row * C);
    const int64_t b = row / M;
    atomicAdd(dtable + (b * N + __ldg(idx + row)) * C + c, __ldg(grad + e));
  }
}

int grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

int pc_fps(const void* xyz, void* dist, void* out, int B, int N, int npoint,
           void* stream) {
  int threads = ((N + 31) / 32) * 32;
  if (threads > FPS_MAX_THREADS) threads = FPS_MAX_THREADS;
  fps_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (float*)dist, (int*)out, N, npoint);
  return (int)cudaGetLastError();
}

int pc_ball_query(const void* centres, const void* xyz, void* out, int B, int M,
                  int N, float r2, int nsample, void* stream) {
  const int64_t total = (int64_t)B * M;
  const int blocks = (int)((total + BQ_THREADS - 1) / BQ_THREADS);
  ball_query_kernel<<<blocks, BQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)centres, (const float*)xyz, (int*)out, B, M, N, r2, nsample);
  return (int)cudaGetLastError();
}

int pc_gather_rows(const void* table, const void* idx, void* out, int B, int N,
                   int M, int C, void* stream) {
  const int64_t total = (int64_t)B * M * C;
  gather_rows_kernel<<<grid_for(total, ROW_THREADS), ROW_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, N, M, C, total);
  return (int)cudaGetLastError();
}

int pc_scatter_add_rows(const void* grad, const void* idx, void* dtable, int B,
                        int N, int M, int C, void* stream) {
  const int64_t total = (int64_t)B * M * C;
  scatter_add_rows_kernel<<<grid_for(total, ROW_THREADS), ROW_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)grad, (const int*)idx, (float*)dtable, N, M, C, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
