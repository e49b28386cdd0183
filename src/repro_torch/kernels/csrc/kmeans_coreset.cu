// Batched fixed-budget k-means coresets: (B, N, D) -> centres (B, K, D),
// radii (B, K), int32 counts (B, K).
//
// Replaces the TPU kernel src/repro/kernels/kmeans_coreset.py,
// kmeans_coreset_pallas (body _kmeans_kernel): strided init
// (j * N) / K, then `iters` Lloyd rounds of argmin assignment, per-cluster
// sum and count, and a mean update in which an empty cluster keeps its
// centre; a final assignment gives the counts and the radii, each radius the
// largest distance of a member from its centre.
//
// What bounds it on the card: at the fleet's shape (B = 9000 per-channel
// clouds of N = 60 points in D = 2, K = 12, 4 rounds) the call reads 4.3 MB
// and writes 1.3 MB, and does about 200 MFLOP of fp32 work: a few
// microseconds each.  The work is thousands of tiny independent problems, so
// what bounds it is instruction issue and the dependent chain of one cloud.
// The first design (one warp per cloud) spent it on shuffles: every round,
// for each of the K clusters, three 5-level warp sums (count, sum x, sum y),
// about 840 shuffles a cloud in all, and its 1125 blocks of 8 warps did not
// fit in one wave.  What is left is the assignment, N * K * D subtractions,
// multiplies and adds and a compare-and-select per point and centre, each
// round: about 8 instructions per (point, centre), issue-bound.
//
// Design: a group of kGroup = 8 lanes owns one cloud, so a warp holds 4
// clouds and the fleet's 9000 clouds are 2250 warps in 1125 blocks of 64
// threads, one wave on 132 SMs (12 blocks an SM, see MinBlocks below).
//   * The block's clouds are one contiguous range of `pts`: it is staged in
//     shared memory with coalesced (16-byte where aligned) loads, and each
//     lane takes a contiguous run of ceil(N / 8) point indices into
//     registers.  The cloud's K centres live in shared memory, D_MAX floats
//     each, zero beyond D.
//   * Assignment scans the centres with a strict `<`, so ties go to the
//     lowest index like torch.argmin and jnp.argmin.  The squared distances
//     use __fsub_rn/__fmul_rn/__fadd_rn and no fused multiply-add, so given
//     the same centres every argmin sees the plain version's distances; a
//     coordinate beyond D is 0 in point and centre and adds an exact +0, so
//     the loop needs no guard.
//   * Update, a reduce-scatter through shared memory: each lane adds the
//     count and the D coordinates of each of its points, in index order,
//     into its own column of a (K * (D + 1), 64 + 4) array of partial sums;
//     then lane g of the cloud owns clusters g, g + 8, ...: it reads the
//     cloud's 8 columns of each row as two float4s, sums them lane 0 first,
//     zeroes them for the next round, and writes the centre (sum / count,
//     IEEE division).  An empty cluster keeps its centre.  No shuffles, and
//     no atomics, on floats or otherwise: the result is bit-identical from
//     launch to launch.  The sums are taken in another order than the plain
//     version's einsum, so a point within an ulp of equidistant may still
//     flip its cluster.
//   * The final pass gathers counts (sum) and radii (max of sqrt of the
//     squared distance) through the same columns, and the block writes its
//     clouds' centres, radii and counts as contiguous, coalesced ranges.
// Four instantiations serve the wrapper's range (N <= 128, D <= 4,
// K <= 32), each (K_MAX, D_MAX, N_MAX): (16, 2, 64), the fleet's, and
// (32, 4, 64); for clouds of 65 to 128 points, such as the 120-sample
// windows of the bearing config with k = 18, (32, 2, 128) and (32, 4, 128),
// whose lanes hold twice the points in registers.  The wrapper
// (repro_torch.kernels.ops.kmeans_coreset_geometry) picks the first that
// holds the shape.  At (N, D, K) = (64, 4, 32) the block needs 57.9 KB of
// shared memory, at (128, 4, 32) 66.1 KB, which the launch opts in to.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kGroup = 8;                 // lanes per cloud
constexpr int kThreads = 64;              // threads per block
constexpr int kClouds = kThreads / kGroup;
constexpr int kMaxN = 128;                // the widest instantiation's N_MAX

// Shared memory a block needs, in this order: points; centres (one padded
// row per cloud so the 4 clouds of a warp read distinct banks); radii;
// counts; the lanes' partial sums (row k * (D + 1) + v holds value v of
// cluster k, one column per thread; the row stride of kThreads + 4 floats
// puts the 8 lanes of a quarter-warp that reduce 8 clusters on distinct
// banks).
constexpr int kPartStride = kThreads + 4;
__host__ __device__ constexpr int centre_stride(int kmax, int dmax) {
  return kmax * dmax + 1;
}
__host__ __device__ constexpr long long smem_bytes(int kmax, int dmax, int N,
                                                   int D, int K) {
  return 4LL * (kClouds * (N * D + centre_stride(kmax, dmax) + 2 * kmax) +
                K * (D + 1) * kPartStride);
}

// Sum (or max) of the kGroup partial values of one cloud in a row, lane 0
// first, and zero them for the next round.
template <bool Max>
__device__ __forceinline__ float combine(float* row) {
  float4* q = reinterpret_cast<float4*>(row);
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kGroup / 4; ++i) {
    const float4 v = q[i];
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (Max) {
      r = fmaxf(fmaxf(fmaxf(fmaxf(r, v.x), v.y), v.z), v.w);
    } else {
      r = i == 0 ? v.x : r + v.x;
      r = ((r + v.y) + v.z) + v.w;
    }
  }
  return r;
}

// MinBlocks caps the registers so that at least that many 64-thread blocks
// fit on an SM: 12 (80 registers) for the fleet's instantiation, whose 1125
// blocks then make one wave on 132 SMs.  A lane holds NMAX / kGroup points.
template <int KMAX, int DMAX, int NMAX, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
kmeans_coreset_kernel(const float* __restrict__ pts,
                      float* __restrict__ centers_out,
                      float* __restrict__ radii_out,
                      int* __restrict__ counts_out, int B, int N, int D,
                      int K, int iters) {
  constexpr int kCen = centre_stride(KMAX, DMAX);
  constexpr int kPoints = NMAX / kGroup;  // points per lane at most
  extern __shared__ float smem[];
  const int nd = N * D;
  float* pts_s = smem;                          // (kClouds, N, D)
  float* cen_s = pts_s + kClouds * nd;          // (kClouds, kCen)
  float* rad_s = cen_s + kClouds * kCen;        // (kClouds, KMAX)
  int* cnt_s = reinterpret_cast<int*>(rad_s + kClouds * KMAX);
  float* part = reinterpret_cast<float*>(cnt_s + kClouds * KMAX);
  const int dv = D + 1;                         // count, then the D sums
  for (int r = 0; r < K * dv; ++r) part[r * kPartStride + threadIdx.x] = 0.f;

  const int b0 = blockIdx.x * kClouds;
  const int nb = min(kClouds, B - b0);
  {
    const float* src = pts + static_cast<size_t>(b0) * nd;
    const int n = nb * nd;
    int e0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(pts_s);
      for (int i = threadIdx.x; i < n / 4; i += kThreads) d4[i] = s4[i];
      e0 = (n / 4) * 4;
    }
    for (int e = e0 + threadIdx.x; e < n; e += kThreads) pts_s[e] = src[e];
  }
  __syncthreads();

  const int cloud = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  const bool live = cloud < nb;
  const float* p = pts_s + cloud * nd;
  float* cen = cen_s + cloud * kCen;
  const int per = (N + kGroup - 1) / kGroup;

  float x[kPoints][DMAX];
  bool valid[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int n = g * per + j;
    valid[j] = live && j < per && n < N;
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      x[j][d] = (valid[j] && d < D) ? p[n * D + d] : 0.f;
  }
  // centre k at cen[k * DMAX + d], zero beyond D: a zero coordinate of a
  // point and a centre adds an exact +0 to a squared distance
  if (live)
    for (int i = g; i < K * DMAX; i += kGroup) {
      const int d = i % DMAX;
      cen[i] = d < D ? p[(((i / DMAX) * N) / K) * D + d] : 0.f;
    }
  __syncwarp();

  int assign[kPoints];
  float best[kPoints];
  for (int it = 0;; ++it) {
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      best[j] = CUDART_INF_F;
      assign[j] = 0;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float c[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d) c[d] = cen[k * DMAX + d];
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        float d2 = 0.f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
          const float diff = __fsub_rn(x[j][d], c[d]);
          const float sq = __fmul_rn(diff, diff);
          d2 = d == 0 ? sq : __fadd_rn(d2, sq);
        }
        if (d2 < best[j]) {
          best[j] = d2;
          assign[j] = k;
        }
      }
    }
    if (it == iters) break;
    __syncwarp();  // every lane has read the centres before they move
    // each lane's count and sums per cluster over its points, index order
    float* mine = part + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      if (valid[j]) {
        float* col = mine + assign[j] * dv * kPartStride;
        col[0] += 1.f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) col[(d + 1) * kPartStride] += x[j][d];
      }
    }
    __syncwarp();
    // lane g owns clusters g, g + 8, ...: it combines the cloud's 8 columns
    float* ours = part + cloud * kGroup;
    for (int k = g; k < K; k += kGroup) {
      float* row = ours + k * dv * kPartStride;
      const float cnt = combine<false>(row);
      float s[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        s[d] = d < D ? combine<false>(row + (d + 1) * kPartStride) : 0.f;
      if (live && cnt > 0.f) {
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) cen[k * DMAX + d] = s[d] / fmaxf(cnt, 1.f);
      }
    }
    __syncwarp();
  }

  // final pass: counts and radii through the same columns (rows k * dv and
  // k * dv + 1; D >= 1, so both exist)
  {
    float* mine = part + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      if (valid[j]) {
        float* col = mine + assign[j] * dv * kPartStride;
        col[0] += 1.f;
        col[kPartStride] = fmaxf(col[kPartStride], sqrtf(best[j]));
      }
    }
    __syncwarp();
    float* ours = part + cloud * kGroup;
    for (int k = g; k < K; k += kGroup) {
      float* row = ours + k * dv * kPartStride;
      cnt_s[cloud * KMAX + k] = static_cast<int>(combine<false>(row));
      rad_s[cloud * KMAX + k] = combine<true>(row + kPartStride);
    }
  }
  __syncthreads();

  const int kd = K * D;
  for (int e = threadIdx.x; e < nb * kd; e += kThreads) {
    const int r = e % kd;
    centers_out[static_cast<size_t>(b0) * kd + e] =
        cen_s[(e / kd) * kCen + (r / D) * DMAX + r % D];
  }
  for (int e = threadIdx.x; e < nb * K; e += kThreads) {
    const int i = (e / K) * KMAX + e % K;
    radii_out[static_cast<size_t>(b0) * K + e] = rad_s[i];
    counts_out[static_cast<size_t>(b0) * K + e] = cnt_s[i];
  }
}

template <int KMAX, int DMAX, int NMAX, int MinBlocks>
int launch(const void* pts, void* centers, void* radii, void* counts, int B,
           int N, int D, int K, int iters, int blocks, int smem,
           cudaStream_t stream) {
  if (K > KMAX || D > DMAX || N > NMAX ||
      smem != smem_bytes(KMAX, DMAX, N, D, K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmeans_coreset_kernel<KMAX, DMAX, NMAX, MinBlocks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kmeans_coreset_kernel<KMAX, DMAX, NMAX, MinBlocks>
      <<<blocks, kThreads, smem, stream>>>(
          static_cast<const float*>(pts), static_cast<float*>(centers),
          static_cast<float*>(radii), static_cast<int*>(counts), B, N, D, K,
          iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry comes from the wrapper
// (repro_torch.kernels.ops.kmeans_coreset_geometry): `variant` 0 is the
// (K_MAX, D_MAX, N_MAX) = (16, 2, 64) instantiation, 1 is (32, 4, 64), 2 is
// (32, 2, 128) and 3 is (32, 4, 128).  A geometry that does not fit this
// kernel is refused with cudaErrorInvalidValue.
extern "C" int kmeans_coreset_launch(const void* pts, void* centers,
                                     void* radii, void* counts, int B, int N,
                                     int D, int K, int iters, int variant,
                                     int blocks, int threads, int smem,
                                     void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxN || D < 1 || K < 1 || iters < 0 ||
      threads != kThreads || blocks != (B + kClouds - 1) / kClouds)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<16, 2, 64, 12>(pts, centers, radii, counts, B, N, D, K, iters, blocks, smem, s);
    case 1: return launch<32, 4, 64, 8>(pts, centers, radii, counts, B, N, D, K, iters, blocks, smem, s);
    case 2: return launch<32, 2, 128, 6>(pts, centers, radii, counts, B, N, D, K, iters, blocks, smem, s);
    case 3: return launch<32, 4, 128, 4>(pts, centers, radii, counts, B, N, D, K, iters, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
