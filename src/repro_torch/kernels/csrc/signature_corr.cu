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
// 0.7 us at 3.35 TB/s, and does about 13 MFLOP.  Nothing in it is big: the
// time is latency, the dependent steps one block has to take.  The first
// design (one warp per node, 8 nodes a block) lost on three counts: every
// one of its 375 blocks centred the whole bank again with 36 threads walking
// 60-step columns serially while the rest waited; each node's warp did
// L x C dependent 5-level shuffle sums; and lane 0 wrote the L outputs one
// by one.
//
// Design: one block per tile of `tile` consecutive nodes, `tile` chosen by
// the wrapper (repro_torch.kernels.ops.signature_corr_geometry) so that the
// fleet's 3000 nodes make about one block per SM (23 nodes, 131 blocks).
//   1. Staging.  The tile's windows (one contiguous tile*T*C range) and the
//      bank are copied into shared memory with 16-byte loads where the
//      source is 16-byte aligned.  Each row is zero padded to whole groups
//      of 4 time steps and to a stride of 4 mod 8 floats: rows are 16-byte
//      aligned, and the 8 lanes of a quarter-warp reading 8 rows hit
//      distinct banks.
//   2. Centring.  Every (row, channel) column of the tile and of the bank is
//      centred in parallel, 2 lanes a column (one shuffle for each sum), so
//      the fleet's 105 columns take one pass of the block's 288 threads.
//   3. Products.  One thread per (node, l) pair reads both rows as float4s,
//      4 time steps (C float4s) at a time, with one accumulator per position
//      of the step; the kernel is instantiated for each C <= 4, so every
//      position's channel is known at compile time.  It then computes
//      sum_c num / max(wn * sn, 1e-9) / C, as the plain version does (the
//      bank is not pre-divided by its norm).  Pairs are node-major, so the
//      block's outputs are one contiguous, coalesced range of `out`.
// Parity: no tensor cores (TF32 would not meet rtol 1e-4), no atomics (the
// result is bit-identical from launch to launch); the sums over t are taken
// in another order than the plain version's, within rtol 1e-4 / atol 1e-5.
// Every thread reaches both barriers; the ragged last tile only skips work.
// Nothing in the layout depends on T beyond the row stride, so windows of up
// to kMaxT = 128 samples (the bearing config's 120) take the same kernel; a
// longer row only makes the staged tile smaller.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 2;       // lanes per column in the centring pass
constexpr int kMaxThreads = 1024;
constexpr int kMaxT = 128;      // the longest window: the bearing config's 120

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Floats per staged row: room for T rounded up to 4 time steps, zero padded,
// and a stride of 4 mod 8 floats, so the rows are 16-byte aligned and the 8
// lanes of a quarter-warp reading 8 different rows hit distinct banks.
__host__ __device__ constexpr int row_stride(int T, int C) {
  const int s = ((T + 3) / 4) * 4 * C;
  return s % 8 == 4 ? s : s + 4;
}

// Copy `rows` rows of `tc` floats from src into rows of `stride` floats;
// the padding of each row is zeroed.
__device__ __forceinline__ void stage(const float* __restrict__ src, int rows,
                                     int tc, int stride, float* dst) {
  const int n = rows * tc;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const float4 v = s4[i];
      const float vals[4] = {v.x, v.y, v.z, v.w};
      int row = (4 * i) / tc, col = (4 * i) % tc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[row * stride + col] = vals[j];
        if (++col == tc) { col = 0; ++row; }
      }
    }
    e0 = (n / 4) * 4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x)
    dst[(e / tc) * stride + e % tc] = src[e];
  const int pad = stride - tc;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    dst[(e / pad) * stride + tc + e % pad] = 0.f;
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
signature_corr_kernel(const float* __restrict__ win,
                      const float* __restrict__ sig, float* __restrict__ out,
                      int B, int L, int T, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tc = T * C;
  const int stride = row_stride(T, C);
  float* ws = smem;                    // (tile, stride) windows
  float* ss = ws + tile * stride;      // (L, stride) signatures
  float* wn = ss + L * stride;         // (tile, C) window norms
  float* sn = wn + tile * C;           // (L, C) signature norms

  const int b0 = blockIdx.x * tile;
  const int tb = min(tile, B - b0);
  stage(win + static_cast<size_t>(b0) * tc, tb, tc, stride, ws);
  stage(sig, L, tc, stride, ss);
  __syncthreads();

  // centre every column: rows 0..tb-1 are windows, tb..tb+L-1 signatures
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols_per_warp = 32 / kGroup;
  const int ncols = (tb + L) * C;
  for (int c0 = warp * cols_per_warp; c0 < ncols;
       c0 += (blockDim.x >> 5) * cols_per_warp) {
    const int col = c0 + lane / kGroup, g = lane % kGroup;
    const bool on = col < ncols;
    float* base = nullptr;
    float* norm = nullptr;
    if (on) {
      const int row = col / C, ch = col % C;
      base = (row < tb ? ws + row * stride : ss + (row - tb) * stride) + ch;
      norm = (row < tb ? wn + row * C : sn + (row - tb) * C) + ch;
    }
    float s = 0.f;
    if (on)
      for (int t = g; t < T; t += kGroup) s += base[t * C];
    const float mean = group_sum(s) / T;
    float q = 0.f;
    if (on)
      for (int t = g; t < T; t += kGroup) {
        const float v = base[t * C] - mean;
        base[t * C] = v;
        q += v * v;
      }
    q = group_sum(q);
    if (on && g == 0) *norm = sqrtf(q);
  }
  __syncthreads();

  // one (node, l) pair per thread: 4 time steps (C float4s) per step, one
  // accumulator per position in the step; the zero padding adds +0
  for (int p = threadIdx.x; p < tb * L; p += blockDim.x) {
    const int node = p / L, l = p % L;
    const float4* w = reinterpret_cast<const float4*>(ws + node * stride);
    const float4* s = reinterpret_cast<const float4*>(ss + l * stride);
    float acc[4 * C];
#pragma unroll
    for (int i = 0; i < 4 * C; ++i) acc[i] = 0.f;
    const int steps = (T + 3) / 4;
#pragma unroll 2
    for (int i = 0; i < steps; ++i) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float4 a = w[i * C + q], b = s[i * C + q];
        acc[4 * q + 0] += a.x * b.x;
        acc[4 * q + 1] += a.y * b.y;
        acc[4 * q + 2] += a.z * b.z;
        acc[4 * q + 3] += a.w * b.w;
      }
    }
    float corr = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float num = 0.f;
#pragma unroll
      for (int i = c; i < 4 * C; i += C) num += acc[i];
      corr += num / fmaxf(wn[node * C + c] * sn[l * C + c], 1e-9f);
    }
    out[static_cast<size_t>(b0) * L + p] = corr / C;
  }
}

template <int C>
int launch(const void* win, const void* sig, void* out, int B, int L, int T,
           int tile, int blocks, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        signature_corr_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  signature_corr_kernel<C><<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(win), static_cast<const float*>(sig),
      static_cast<float*>(out), B, L, T, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry comes from the wrapper
// (repro_torch.kernels.ops.signature_corr_geometry); the instantiation is
// the channel count C.  A geometry that does not fit this kernel's layout is
// refused with cudaErrorInvalidValue.
extern "C" int signature_corr_launch(const void* win, const void* sig,
                                     void* out, int B, int L, int T, int C,
                                     int tile, int blocks, int threads,
                                     int smem, void* stream) {
  if (B <= 0) return 0;
  const long long need = 4LL * (static_cast<long long>(tile) + L) *
                         (row_stride(T, C) + C);
  if (T < 1 || T > kMaxT || L < 1 || tile < 1 ||
      blocks != (B + tile - 1) / tile || threads < 32 || threads % 32 ||
      threads > kMaxThreads || smem != need)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(win, sig, out, B, L, T, tile, blocks, threads, smem, s);
    case 2: return launch<2>(win, sig, out, B, L, T, tile, blocks, threads, smem, s);
    case 3: return launch<3>(win, sig, out, B, L, T, tile, blocks, threads, smem, s);
    case 4: return launch<4>(win, sig, out, B, L, T, tile, blocks, threads, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
