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
// and writes 1.3 MB, and does about 200 MFLOP of fp32 work; both are a few
// microseconds.  The work is thousands of tiny independent problems, so the
// design gives each its own warp and keeps every intermediate on chip.
//
// Design: one warp per cloud, 8 clouds per block.  Each lane holds points
// `lane` and `lane + 32` in registers; the K centres of the cloud live in
// shared memory.  Assignment is a scan over the centres with a strict `<`,
// so ties go to the lowest index like jnp.argmin.  The per-cluster sums and
// counts are warp shuffle reductions.  The squared distances are computed
// without fused multiply-adds (__fmul_rn/__fadd_rn) so that, given the same
// centres, every argmin sees the same distances as the plain version; the
// sums are taken in another order than torch's, so a point within an ulp of
// equidistant may still flip.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;     // clouds per block
constexpr int kSteps = 2;     // points per lane: N <= 64
constexpr int kMaxD = 4;
constexpr int kMaxK = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void kmeans_coreset_kernel(const float* __restrict__ pts,
                                      float* __restrict__ centers_out,
                                      float* __restrict__ radii_out,
                                      int* __restrict__ counts_out, int B,
                                      int N, int D, int K, int iters) {
  __shared__ float cen_all[kWarps][kMaxK * kMaxD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no block-wide barrier below
  float* cen = cen_all[warp];
  const float* p = pts + static_cast<size_t>(b) * N * D;

  float x[kSteps][kMaxD];
  bool valid[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int n = lane + 32 * j;
    valid[j] = n < N;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      x[j][d] = (valid[j] && d < D) ? p[n * D + d] : 0.f;
  }
  for (int i = lane; i < K * D; i += 32) {
    const int k = i / D, d = i % D;
    cen[i] = p[((k * N) / K) * D + d];
  }
  __syncwarp();

  int assign[kSteps];
  float best[kSteps];
  for (int it = 0;; ++it) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      best[j] = CUDART_INF_F;
      assign[j] = 0;
      for (int k = 0; k < K; ++k) {
        float d2 = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) {
            const float diff = __fsub_rn(x[j][d], cen[k * D + d]);
            const float sq = __fmul_rn(diff, diff);
            d2 = d == 0 ? sq : __fadd_rn(d2, sq);
          }
        }
        if (d2 < best[j]) {
          best[j] = d2;
          assign[j] = k;
        }
      }
    }
    if (it == iters) break;
    __syncwarp();  // every lane has read the centres before they move
    for (int k = 0; k < K; ++k) {
      float cnt = 0.f;
      float s[kMaxD];
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) s[d] = 0.f;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (valid[j] && assign[j] == k) {
          cnt += 1.f;
#pragma unroll
          for (int d = 0; d < kMaxD; ++d) s[d] += x[j][d];
        }
      }
      cnt = warp_sum(cnt);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          s[d] = warp_sum(s[d]);
          if (cnt > 0.f && lane == d) cen[k * D + d] = s[d] / fmaxf(cnt, 1.f);
        }
      }
    }
    __syncwarp();
  }

  for (int k = 0; k < K; ++k) {
    float cnt = 0.f, rad = 0.f;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (valid[j] && assign[j] == k) {
        cnt += 1.f;
        rad = fmaxf(rad, sqrtf(best[j]));
      }
    }
    cnt = warp_sum(cnt);
    rad = warp_max(rad);
    if (lane == 0) {
      counts_out[static_cast<size_t>(b) * K + k] = static_cast<int>(cnt);
      radii_out[static_cast<size_t>(b) * K + k] = rad;
    }
  }
  for (int i = lane; i < K * D; i += 32)
    centers_out[static_cast<size_t>(b) * K * D + i] = cen[i];
}

}  // namespace

extern "C" int kmeans_coreset_launch(const void* pts, void* centers,
                                     void* radii, void* counts, int B, int N,
                                     int D, int K, int iters, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  kmeans_coreset_kernel<<<blocks, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<float*>(centers),
      static_cast<float*>(radii), static_cast<int*>(counts), B, N, D, K,
      iters);
  return static_cast<int>(cudaGetLastError());
}
