// Deterministic top-m importance selection: (B, T, C) windows -> ascending
// indices (B, m) int32, values (B, m, C), Horvitz-Thompson weights (B, m).
//
// Replaces the TPU kernel src/repro/kernels/importance_select.py,
// importance_select_pallas (body _select_kernel).  Per window: an
// edge-padded `width`-tap box moving average, |x - ma| summed over the
// channels, normalised by its sum over time and blended with the `spread`
// floor into weights w; the m largest w are picked (ties to the lower
// index), sorted by time, and their values and 1 / max(m * w, 1e-9) are
// written out.
//
// What bounds it on the card: bytes, barely.  At the HAR shape (B = 3000,
// T = 60, C = 3, m = 20) the call reads 2.2 MB and writes 1.2 MB, about
// 1 us at 3.35 TB/s; the arithmetic is a few hundred operations per
// sample.  What it costs is instruction issue and latency: about 23
// windows (warps) an SM, each a few hundred instructions of box filter and
// rank counting, behind a load, a chain of T dependent adds and IEEE
// divisions.  The first design spent its time on m = 20 dependent rounds of
// a 5-step butterfly argmax (two shuffles and a select a step), with the
// box filter and the channel loop on runtime bounds and an IEEE division
// per (t, c).
//
// Design: one warp per window, `tile` windows (warps) per block, chosen by
// the wrapper (repro_torch.kernels.ops.importance_select_geometry) so that
// the HAR fleet's 3000 windows make about one block per SM.  Each warp
// stages its window in its own slice of shared memory (16-byte loads where
// the window is 16-byte aligned); lane l owns time steps l and l + 32.
//   * Scores, in the plain version's order, so the weights are bit-equal to
//     it: the shifted values added j = 0..width-1, the channel sum
//     c = 0..C-1, the normalising sum t = 0..T-1, no fused multiply-add.
//     The kernel is instantiated for the HAR case (C, width) = (3, 8), with
//     both loops unrolled, and once for any (C, width).  A power-of-two
//     width divides by multiplying with its reciprocal, which is exact;
//     other widths keep the IEEE division.  The sum over t is one chain of
//     T dependent adds; every lane takes it from broadcast float4 reads, so
//     no lane waits on a shuffle of the result.
//   * Selection by rank, with no dependent rounds: the weights go to shared
//     memory, and each lane counts, for each of its steps t,
//       rank(t) = #{u : w[u] > w[t] or (w[u] == w[t] and u < t)}
//     from broadcast float4 reads of all T weights (independent loads, no
//     shuffles).  The first pass counts only #{u : w[u] > w[t]}, each
//     compare one subtract and one shift-add of its sign bit into one of
//     four accumulators (the difference of two finite floats is 0 only
//     when they are equal, and its sign is exact).  Those counts are a
//     permutation of 0..T-1 exactly when no two weights tie, that is when
//     their warp sum is T(T-1)/2; otherwise (a flat window, repeated
//     values) a second pass adds #{u < t : w[u] == w[t]}.
//     (weight descending, index ascending) is a strict total order, so the
//     steps of rank < m are exactly the m that the stable descending sort
//     of the plain version (and a sequential argmax with ties to the lower
//     index) picks; m distinct indices even where all weights tie.  A
//     pick's output slot is the number of picks at lower steps: a ballot
//     per step set and a population count below the lane.
// Every lane of a warp reaches its __syncwarp()s and ballots; there is no
// block-wide barrier, so a warp without a window leaves at once.
// Windows of up to 128 samples (the bearing config's 120): lane l owns time
// steps l, l + 32, ..., STEPS of them; STEPS = 2 serves T <= 64 (the HAR
// fleet's 60, unchanged) and STEPS = 4 serves T <= 128.  The picks are
// written in time order: step set s before s + 1, lanes in order within a
// set.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxSteps = 4;  // time steps per lane at most: T <= 128
constexpr int kMaxWarps = 32;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of shared memory per warp: the window, then the T weights, each
// rounded up to whole float4s.
__host__ __device__ constexpr int warp_floats(int T, int C) {
  return round4(T * C) + round4(T);
}

// CT, WT: the channel count and box width, or 0 where they are runtime;
// STEPS: time steps per lane, T <= 32 * STEPS.
template <int CT, int WT, int STEPS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
importance_select_kernel(const float* __restrict__ windows,
                         int* __restrict__ idx_out,
                         float* __restrict__ vals_out,
                         float* __restrict__ weights_out, int B, int T,
                         int c_rt, int m, int width_rt, float keep,
                         float floor_w) {
  extern __shared__ float4 smem4[];
  const int C = CT ? CT : c_rt;
  const int width = WT ? WT : width_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // no block-wide barrier below
  const int tc = T * C;
  float* win = reinterpret_cast<float*>(smem4) + warp * warp_floats(T, C);
  float* wsh = win + round4(tc);
  const float* x = windows + static_cast<size_t>(b) * tc;
  if (tc % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* w4 = reinterpret_cast<float4*>(win);
    for (int i = lane; i < tc / 4; i += 32) w4[i] = x4[i];
  } else {
    for (int i = lane; i < tc; i += 32) win[i] = x[i];
  }
  // the padding of the T sums up to a whole float4: +0 adds nothing
  if (lane < round4(T) - T) wsh[T + lane] = 0.f;
  __syncwarp();

  // deviation from the moving average, summed over channels
  const int pad_l = width / 2;
  const bool pow2 = (width & (width - 1)) == 0;
  const float inv_width = 1.f / static_cast<float>(width);  // exact if pow2
  float detr[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int t = lane + 32 * s;
    detr[s] = 0.f;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < (CT ? CT : C); ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < (WT ? WT : width); ++j) {
        const int tj = min(max(t + j - pad_l, 0), T - 1);
        acc = __fadd_rn(acc, win[tj * C + c]);
      }
      const float mean = pow2 ? __fmul_rn(acc, inv_width)
                              : __fdiv_rn(acc, static_cast<float>(width));
      const float dev = fabsf(__fsub_rn(win[t * C + c], mean));
      detr[s] = c == 0 ? dev : __fadd_rn(detr[s], dev);
    }
    wsh[t] = detr[s];
  }
  __syncwarp();
  // the sum over t in order, by every lane from broadcast float4 reads
  const float4* w4 = reinterpret_cast<const float4*>(wsh);
  const int n4 = round4(T) / 4;
  float total = 0.f;
#pragma unroll 4
  for (int k = 0; k < n4; ++k) {
    const float4 q = w4[k];
    total = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(total, q.x), q.y), q.z),
                      q.w);
  }
  total = fmaxf(total, 1e-9f);

  // + 0 turns a -0 into the +0 it ties with in the plain version's sort
  float w[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    w[s] = __fadd_rn(
        __fadd_rn(__fmul_rn(keep, __fdiv_rn(detr[s], total)), floor_w), 0.f);
  __syncwarp();  // every lane has read every detr before they become weights
  // the weights, padded with -inf: never above a weight, never tied
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    if (lane + 32 * s < round4(T))
      wsh[lane + 32 * s] = lane + 32 * s < T ? w[s] : -CUDART_INF_F;
  __syncwarp();

  // rank of each own step in (weight descending, index ascending): the
  // larger weights (the padding, -inf, is never larger) ...
  unsigned part[STEPS][4] = {};
#pragma unroll 4
  for (int k = 0; k < n4; ++k) {
    const float4 q = w4[k];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      part[s][0] += __float_as_uint(__fsub_rn(w[s], q.x)) >> 31;
      part[s][1] += __float_as_uint(__fsub_rn(w[s], q.y)) >> 31;
      part[s][2] += __float_as_uint(__fsub_rn(w[s], q.z)) >> 31;
      part[s][3] += __float_as_uint(__fsub_rn(w[s], q.w)) >> 31;
    }
  }
  int rank[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    rank[s] = part[s][0] + part[s][1] + part[s][2] + part[s][3];
  // ... then, where two weights tie, the equal ones before the step
  int own = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) own += lane + 32 * s < T ? rank[s] : 0;
  const int sum = __reduce_add_sync(0xffffffffu, own);
  if (sum != T * (T - 1) / 2) {
    for (int u = 0; u < T; ++u) {
      const float wu = wsh[u];
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        rank[s] += wu == w[s] && u < lane + 32 * s;
    }
  }
  bool pick[STEPS];
  unsigned ballot[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    pick[s] = lane + 32 * s < T && rank[s] < m;
    ballot[s] = __ballot_sync(0xffffffffu, pick[s]);
  }
  const unsigned below = (1u << lane) - 1u;
  int slot = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int t = lane + 32 * s;
    const int at = slot + __popc(ballot[s] & below);
    if (pick[s] && at < m) {
      const size_t row = static_cast<size_t>(b) * m + at;
      idx_out[row] = t;
      for (int c = 0; c < C; ++c) vals_out[row * C + c] = win[t * C + c];
      weights_out[row] =
          __fdiv_rn(1.f, fmaxf(__fmul_rn(static_cast<float>(m), w[s]), 1e-9f));
    }
    slot += __popc(ballot[s]);
  }
}

template <int CT, int WT, int STEPS>
int launch(const void* windows, void* idx, void* vals, void* weights, int B,
           int T, int C, int m, int width, float keep, float floor_w,
           int blocks, int threads, int smem, cudaStream_t stream) {
  if (T > 32 * STEPS) return static_cast<int>(cudaErrorInvalidValue);
  importance_select_kernel<CT, WT, STEPS><<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(windows), static_cast<int*>(idx),
      static_cast<float*>(vals), static_cast<float*>(weights), B, T, C, m,
      width, keep, floor_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry comes from the wrapper
// (repro_torch.kernels.ops.importance_select_geometry): `variant` 0 is the
// (C, width) = (3, 8) instantiation, 1 the runtime one, both for T <= 64;
// 2 and 3 are the same two for T <= 128; `tile` windows (one warp each) per
// block.  A geometry that does not fit is refused with
// cudaErrorInvalidValue.
extern "C" int importance_select_launch(const void* windows, void* idx,
                                        void* vals, void* weights, int B,
                                        int T, int C, int m, int width,
                                        float keep, float floor_w,
                                        int variant, int tile, int blocks,
                                        int threads, int smem, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T > 32 * kMaxSteps || C < 1 || C > 8 || m < 1 || m > T ||
      width < 1 || tile < 1 || tile > kMaxWarps || threads != 32 * tile ||
      blocks != (B + tile - 1) / tile ||
      smem != 4 * tile * warp_floats(T, C) || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool har = C == 3 && width == 8;
  switch (variant) {
    case 0: if (!har) break;
      return launch<3, 8, 2>(windows, idx, vals, weights, B, T, C, m, width, keep, floor_w, blocks, threads, smem, s);
    case 1:
      return launch<0, 0, 2>(windows, idx, vals, weights, B, T, C, m, width, keep, floor_w, blocks, threads, smem, s);
    case 2: if (!har) break;
      return launch<3, 8, 4>(windows, idx, vals, weights, B, T, C, m, width, keep, floor_w, blocks, threads, smem, s);
    case 3:
      return launch<0, 0, 4>(windows, idx, vals, weights, B, T, C, m, width, keep, floor_w, blocks, threads, smem, s);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
