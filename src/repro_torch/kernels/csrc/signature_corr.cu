// Batched signature-bank Pearson correlation: (B, T, C) x (L, T, C) -> (B, L).
//
// Replaces the TPU kernel src/repro/kernels/signature_corr.py,
// signature_corr_pallas (body _corr_kernel): per-channel Pearson correlation
// of every node's window with every stored class signature, averaged over
// channels.  Both operands are centred along T; the denominator is the
// product of the two L2 norms, clamped at 1e-9.
//
// What bounds it on the card: at the fleet's shape (B = 3000 nodes, T = 60,
// C = 3, L = 12) the call reads 2.2 MB of windows and writes 144 KB, about
// 0.7 us at 3.35 TB/s, and does about 13 MFLOP, which is negligible.  So the
// launch itself dominates, and the design keeps it to ONE launch per slot
// with nothing but the windows and the result touching device memory.
//
// Design: one block per tile of 8 nodes, one warp per node.  The block
// stages the whole bank (12 x 60 x 3 floats, 8.6 KB) in shared memory and
// centres it there, with one thread per (signature, channel) column, so the
// bank is read from device memory once per block.  Each lane holds time
// steps `lane` and `lane + 32` of its node's window in registers; the
// channel means, the window norms and the L x C dot products are warp
// shuffle reductions.  The mean over T is a sum divided by T, as in the
// reference.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // nodes per block
constexpr int kMaxC = 4;      // channels held in registers per lane
constexpr int kSteps = 2;     // time steps per lane: T <= 64

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void signature_corr_kernel(const float* __restrict__ win,
                                      const float* __restrict__ sig,
                                      float* __restrict__ out, int B, int L,
                                      int T, int C) {
  extern __shared__ float smem[];
  float* sm = smem;                  // (L, T, C) centred signatures
  float* sn = smem + L * T * C;      // (L, C) signature norms

  for (int i = threadIdx.x; i < L * T * C; i += blockDim.x) sm[i] = sig[i];
  __syncthreads();
  for (int lc = threadIdx.x; lc < L * C; lc += blockDim.x) {
    float* col = sm + (lc / C) * T * C + (lc % C);
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += col[t * C];
    const float mean = s / T;
    float ss = 0.f;
    for (int t = 0; t < T; ++t) {
      const float v = col[t * C] - mean;
      col[t * C] = v;
      ss += v * v;
    }
    sn[lc] = sqrtf(ss);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps leave together, after the last barrier

  const float* w = win + static_cast<size_t>(b) * T * C;
  float x[kSteps][kMaxC];
  float wn[kMaxC];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int t = lane + 32 * j;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      x[j][c] = (t < T && c < C) ? w[t * C + c] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    const float mean = warp_sum(x[0][c] + x[1][c]) / T;
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      x[j][c] = (lane + 32 * j < T) ? x[j][c] - mean : 0.f;
    wn[c] = sqrtf(warp_sum(x[0][c] * x[0][c] + x[1][c] * x[1][c]));
  }

  for (int l = 0; l < L; ++l) {
    const float* s = sm + l * T * C;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int t = lane + 32 * j;
          if (t < T) p += x[j][c] * s[t * C + c];
        }
        const float num = warp_sum(p);
        const float den = fmaxf(wn[c] * sn[l * C + c], 1e-9f);
        acc += num / den;
      }
    }
    if (lane == 0) out[static_cast<size_t>(b) * L + l] = acc / C;
  }
}

}  // namespace

extern "C" int signature_corr_launch(const void* win, const void* sig,
                                     void* out, int B, int L, int T, int C,
                                     void* stream) {
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(L * T * C + L * C) * sizeof(float);
  const int blocks = (B + kWarps - 1) / kWarps;
  signature_corr_kernel<<<blocks, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(sig),
      static_cast<float*>(out), B, L, T, C);
  return static_cast<int>(cudaGetLastError());
}
