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
// sample.  What it really costs is latency: m dependent rounds of a warp
// argmax per window.
//
// Design: one warp per window, 8 windows per block.  The window is staged
// in shared memory, since each moving average reads its neighbours.  Each
// lane owns time steps `lane` and `lane + 32`.  The arithmetic repeats the
// plain version's order, so the weights are bit-equal to it and the picks
// equal: the shifted values added j = 0..width-1, the channel sum
// c = 0..C-1, and the normalising sum t = 0..T-1 by one lane from shared
// memory; multiplies and adds are kept apart (no fused multiply-add).  Each
// of the m rounds is a butterfly argmax over the warp, larger weight first,
// then lower index; a picked sample is excluded by its index (not by
// zeroing its weight, which the Pallas body does and which repeats an index
// where all weights are 0).  Lane r keeps pick r; its rank among the m picks
// (a count of smaller indices) is its output slot.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // windows per block
constexpr int kSteps = 2;     // time steps per lane: T <= 64
constexpr int kMaxT = 32 * kSteps;
constexpr int kMaxC = 8;

__global__ void importance_select_kernel(const float* __restrict__ windows,
                                         int* __restrict__ idx_out,
                                         float* __restrict__ vals_out,
                                         float* __restrict__ weights_out,
                                         int B, int T, int C, int m, int width,
                                         float keep, float floor_w) {
  __shared__ float win_all[kWarps][kMaxT * kMaxC];
  __shared__ float w_all[kWarps][kMaxT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no block-wide barrier below
  float* win = win_all[warp];
  float* wsh = w_all[warp];
  const float* x = windows + static_cast<size_t>(b) * T * C;
  for (int i = lane; i < T * C; i += 32) win[i] = x[i];
  __syncwarp();

  // deviation from the moving average, summed over channels
  const int pad_l = width / 2;
  float detr[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int t = lane + 32 * s;
    detr[s] = 0.f;
    if (t >= T) continue;
    for (int c = 0; c < C; ++c) {
      float acc = 0.f;
      for (int j = 0; j < width; ++j) {
        const int tj = min(max(t + j - pad_l, 0), T - 1);
        acc = __fadd_rn(acc, win[tj * C + c]);
      }
      const float dev =
          fabsf(__fsub_rn(win[t * C + c], __fdiv_rn(acc, float(width))));
      detr[s] = c == 0 ? dev : __fadd_rn(detr[s], dev);
    }
    wsh[t] = detr[s];
  }
  __syncwarp();
  float total = 0.f;
  if (lane == 0)
    for (int t = 0; t < T; ++t) total = __fadd_rn(total, wsh[t]);
  total = fmaxf(__shfl_sync(0xffffffffu, total, 0), 1e-9f);
  __syncwarp();  // lane 0 has read every detr before they become weights

  float w[kSteps];
  bool picked[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int t = lane + 32 * s;
    picked[s] = t >= T;
    w[s] = __fadd_rn(__fmul_rn(keep, __fdiv_rn(detr[s], total)), floor_w);
    if (t < T) wsh[t] = w[s];
  }

  // m rounds of a warp argmax; lane r keeps the r-th pick
  int mine = 0;
  for (int r = 0; r < m; ++r) {
    float bv = 0.f;
    int bi = -1;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (!picked[s] && (bi < 0 || w[s] > bv)) {  // lane's own steps ascend
        bv = w[s];
        bi = lane + 32 * s;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const bool better = oi >= 0 && (bi < 0 || ov > bv ||
                                      (ov == bv && oi < bi));
      if (better) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == r) mine = bi;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) picked[s] |= bi == lane + 32 * s;
  }
  __syncwarp();

  // rank-by-count sort of the m distinct picks, then the gathers
  int rank = 0;
  for (int q = 0; q < m; ++q) {
    const int other = __shfl_sync(0xffffffffu, mine, q);
    rank += other < mine;
  }
  if (lane < m) {
    const size_t row = static_cast<size_t>(b) * m + rank;
    idx_out[row] = mine;
    for (int c = 0; c < C; ++c) vals_out[row * C + c] = win[mine * C + c];
    weights_out[row] =
        __fdiv_rn(1.f, fmaxf(__fmul_rn(float(m), wsh[mine]), 1e-9f));
  }
}

}  // namespace

extern "C" int importance_select_launch(const void* windows, void* idx,
                                        void* vals, void* weights, int B,
                                        int T, int C, int m, int width,
                                        float keep, float floor_w,
                                        void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  importance_select_kernel<<<blocks, kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<int*>(idx),
      static_cast<float*>(vals), static_cast<float*>(weights), B, T, C, m,
      width, keep, floor_w);
  return static_cast<int>(cudaGetLastError());
}
