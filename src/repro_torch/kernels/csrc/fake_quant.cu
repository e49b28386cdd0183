// Symmetric fake quantization, scale included:
//   s = max(amax, 1e-9) * rq,  out = clip(rint(x / s), -qmax, qmax) * s,
// with amax = max |x| over the scale's group: one group per node of a
// batched activation (per_sample), the whole tensor, or one last-dim column
// of the (R, C) view (per_channel).  rq is float32(1) / float32(qmax), the
// multiply XLA compiles the JAX package's division by qmax to.
//
// Replaces the TPU kernel src/repro/kernels/fake_quant.py, fake_quant_pallas
// (body _quant_kernel), and the amax reduction and scale that its wrapper
// computes before it: the whole function in one launch, one read and one
// write of every element.
//
// What bounds it on the card: bytes.  One slot's three per-node activations
// are about 2,100 floats per node: at 3000 nodes 25 MB read and 25 MB
// written, about 15 us at 3.35 TB/s.  Per element there is an abs and a max,
// an IEEE division, a rounding, a clamp and a multiply: a few hundred
// thousand warp instructions a call, well under the bytes.  The first design
// took the scale from a four-op PyTorch chain (abs, amax, clamp, multiply:
// another read and a write and read of a copy) and then spent its pass on
// 64-bit integer division and modulo for every element's scale index.
//
// Design (the wrapper, repro_torch.kernels.ops.fake_quant_geometry, picks
// the kernel and its launch):
//   * Per-node groups: a warp owns one group.  Each lane loads its first
//     kHeld items (16-byte float4s where the group's length and base allow,
//     else floats) into registers, the warp takes amax as the largest bit
//     pattern of |x| (__reduce_max_sync), computes the scale, and quantizes
//     and stores the held items: 1024 floats a group (the fleet's are 180
//     and 960); a longer group is read a second time, from the cache, past
//     what the registers hold.  The scale is uniform per warp: no element
//     computes an index.  A read that is an element's last
//     is marked evict-first (__ldcs), so the cache keeps the outputs, which
//     the next layer reads.
//   * Per tensor and per channel: one cooperative launch with a grid-wide
//     barrier between the amax phase and the quantize phase.  Each block
//     writes its maxima to a scratch row of its own (no atomics in global
//     memory, no zeroing); after the barrier every block reduces all rows.
//     Per tensor, each thread keeps its first kHeld items in registers across
//     the barrier; per channel (off the fleet path) the column maxima are
//     taken with shared-memory atomics and the second phase reads x again.
//   * Per channel with more than kMaxCols = 4096 columns (the reference
//     takes any count): the same launch, but each block takes its column
//     maxima with atomics straight into its own row of the scratch in
//     device memory, and a second grid-wide barrier separates the scale of
//     each column, computed once and written to the scratch, from the
//     quantize phase, which reads it through L2.
// Parity with the plain version (repro_torch.kernels.ref.fake_quant_scale
// and fake_quant_ref), bit for bit:
//   * max is exact in any order, and the unsigned order of the bits of a
//     non-negative float is its numeric order with every NaN above +inf, so
//     a group holding a NaN gets a NaN amax and scale, as torch.amax gives;
//     max(amax, 1e-9) is taken on the bits for the same reason (fmaxf would
//     drop the NaN that torch.clamp keeps);
//   * the scale is one float32 multiply by rq, the quotient IEEE division
//     (no fast math), the rounding rintf (half to even, like torch.round and
//     jnp.round), the clamp keeps a NaN like torch.clamp, then one multiply.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // threads per block, every kernel
constexpr int kBlocksPerSm = 4;   // __launch_bounds__ minimum
constexpr int kSms = 132;         // H100 SXM
constexpr int kHeld = 8;          // items a thread holds in registers
constexpr int kChannelItems = 8;  // per-channel: elements per thread a block
constexpr int kMaxCols = 4096;    // per-channel: column maxima in shared memory

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}
__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)),
             max(abs_bits(v.z), abs_bits(v.w)));
}

// max(amax, 1e-9) * rq, on the bits of the non-negative amax
__device__ __forceinline__ float scale_of(unsigned amax, float rq) {
  return __fmul_rn(__uint_as_float(max(amax, __float_as_uint(1e-9f))), rq);
}

__device__ __forceinline__ float quant(float x, float s, float qmax) {
  const float q = rintf(__fdiv_rn(x, s));
  return __fmul_rn(isnan(q) ? q : fminf(fmaxf(q, -qmax), qmax), s);
}
__device__ __forceinline__ float4 quant(float4 v, float s, float qmax) {
  return make_float4(quant(v.x, s, qmax), quant(v.y, s, qmax),
                     quant(v.z, s, qmax), quant(v.w, s, qmax));
}

// The max over the block.  Every thread calls it, once per phase that a
// barrier separates from the next call.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned red[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max(m, red[w]);
  return m;
}

// A thread's share of n items, first + k * stride: the first kHeld into
// `held`, and the max of all of their |x| bits.
template <typename V, typename I>
__device__ __forceinline__ unsigned load_share(const V* __restrict__ x, I first,
                                               I stride, I n, V (&held)[kHeld]) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const I i = first + k * stride;
    if (i < n) {
      held[k] = __ldcs(x + i);  // read once: evict first
      m = max(m, abs_bits(held[k]));
    }
  }
  for (I i = first + kHeld * stride; i < n; i += stride)
    m = max(m, abs_bits(x[i]));
  return m;
}

template <typename V, typename I>
__device__ __forceinline__ void store_share(const V* __restrict__ x,
                                            V* __restrict__ out, I first,
                                            I stride, I n,
                                            const V (&held)[kHeld], float s,
                                            float qmax) {
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const I i = first + k * stride;
    if (i < n) out[i] = quant(held[k], s, qmax);
  }
  for (I i = first + kHeld * stride; i < n; i += stride)
    out[i] = quant(__ldcs(x + i), s, qmax);  // the last read
}

// One group of `group_elems` consecutive floats per warp.
template <typename V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fake_quant_group_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int groups, int group_elems, float rq, float qmax) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (g >= groups) return;  // the whole warp
  const size_t base = static_cast<size_t>(g) * group_elems;
  const V* gx = reinterpret_cast<const V*>(x + base);
  V* gout = reinterpret_cast<V*>(out + base);
  const int lane = threadIdx.x & 31, items = group_elems / kW;
  V held[kHeld];
  const unsigned m = load_share(gx, lane, 32, items, held);
  const float s = scale_of(__reduce_max_sync(0xffffffffu, m), rq);
  store_share(gx, gout, lane, 32, items, held, s, qmax);
}

// One scale for the whole tensor; a cooperative launch.  partial: one word
// per block.
template <typename V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fake_quant_tensor_kernel(const float* __restrict__ x, float* __restrict__ out,
                         unsigned* __restrict__ partial, long long n, float rq,
                         float qmax) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const V* vx = reinterpret_cast<const V*>(x);
  V* vout = reinterpret_cast<V*>(out);
  const long long items = n / kW;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  V held[kHeld];
  const unsigned m = block_max(load_share(vx, first, stride, items, held));
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
  cg::this_grid().sync();
  unsigned a = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads)
    a = max(a, __ldcg(partial + b));
  const float s = scale_of(block_max(a), rq);
  store_share(vx, vout, first, stride, items, held, s, qmax);
}

// One scale per last-dim column of the (n / cols, cols) view; a cooperative
// launch.  partial: `cols` words per block.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fake_quant_channel_kernel(const float* __restrict__ x, float* __restrict__ out,
                          unsigned* __restrict__ partial, long long n, int cols,
                          float rq, float qmax) {
  extern __shared__ unsigned colmax[];  // the block's column maxima, then
  float* scale = reinterpret_cast<float*>(colmax);  // the scales
  for (int c = threadIdx.x; c < cols; c += kThreads) colmax[c] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int step = static_cast<int>(stride % cols);  // column advance a step
  const int c0 = static_cast<int>(first % cols);
  int c = c0;
  for (long long i = first; i < n; i += stride) {
    atomicMax(colmax + c, abs_bits(x[i]));
    c += step;
    if (c >= cols) c -= cols;
  }
  __syncthreads();
  unsigned* row = partial + static_cast<size_t>(blockIdx.x) * cols;
  for (int j = threadIdx.x; j < cols; j += kThreads) row[j] = colmax[j];
  cg::this_grid().sync();
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    unsigned a = 0;
    for (int b = 0; b < gridDim.x; ++b)
      a = max(a, __ldcg(partial + static_cast<size_t>(b) * cols + j));
    scale[j] = scale_of(a, rq);
  }
  __syncthreads();
  c = c0;
  for (long long i = first; i < n; i += stride) {
    out[i] = quant(__ldcs(x + i), scale[c], qmax);
    c += step;
    if (c >= cols) c -= cols;
  }
}

// One scale per column of any number of columns; a cooperative launch.
// partial: `cols` words per block, then the `cols` scales.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fake_quant_channel_wide_kernel(const float* __restrict__ x,
                               float* __restrict__ out,
                               unsigned* __restrict__ partial, long long n,
                               int cols, float rq, float qmax) {
  cg::grid_group grid = cg::this_grid();
  unsigned* row = partial + static_cast<size_t>(blockIdx.x) * cols;
  float* scale =
      reinterpret_cast<float*>(partial + static_cast<size_t>(gridDim.x) * cols);
  for (int j = threadIdx.x; j < cols; j += kThreads) row[j] = 0;
  __syncthreads();  // the row is zero before any thread of the block adds
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int step = static_cast<int>(stride % cols);
  const int c0 = static_cast<int>(first % cols);
  int c = c0;
  for (long long i = first; i < n; i += stride) {
    atomicMax(row + c, abs_bits(x[i]));
    c += step;
    if (c >= cols) c -= cols;
  }
  grid.sync();
  for (long long j = first; j < cols; j += stride) {
    unsigned a = 0;
    for (int b = 0; b < gridDim.x; ++b)
      a = max(a, __ldcg(partial + static_cast<size_t>(b) * cols + j));
    scale[j] = scale_of(a, rq);
  }
  grid.sync();
  c = c0;
  for (long long i = first; i < n; i += stride) {
    out[i] = quant(__ldcs(x + i), __ldcg(scale + c), qmax);
    c += step;
    if (c >= cols) c -= cols;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename V>
bool aligned(const void* x, const void* out) {
  return (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
             sizeof(V) == 0;
}

template <typename V>
int launch_group(const void* x, void* out, long long n, long long group_elems,
                 float rq, float qmax, int blocks, int smem,
                 cudaStream_t stream) {
  constexpr long long kW = sizeof(V) / sizeof(float);
  const long long groups = n / group_elems;
  if (n % group_elems || group_elems % kW || group_elems > INT32_MAX ||
      groups > INT32_MAX || smem != 0 ||
      blocks != cdiv(groups, kThreads / 32) || !aligned<V>(x, out))
    return static_cast<int>(cudaErrorInvalidValue);
  fake_quant_group_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int>(groups), static_cast<int>(group_elems), rq, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_tensor(const void* x, void* out, void* partial, long long n,
                  float rq, float qmax, int blocks, int smem,
                  cudaStream_t stream) {
  constexpr long long kW = sizeof(V) / sizeof(float);
  const long long want =
      std::min(cdiv(n / kW, 1LL * kThreads * kHeld), 1LL * kSms * kBlocksPerSm);
  if (n % kW || smem != 0 || blocks != std::max(want, 1LL) ||
      !aligned<V>(x, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  unsigned* pp = static_cast<unsigned*>(partial);
  void* args[] = {&xp, &op, &pp, &n, &rq, &qmax};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fake_quant_tensor_kernel<V>), blocks,
      kThreads, args, 0, stream));
}

int launch_channel(const void* x, void* out, void* partial, long long n,
                   int cols, float rq, float qmax, int blocks, int smem,
                   cudaStream_t stream) {
  const long long want = std::min(cdiv(n, 1LL * kThreads * kChannelItems),
                                  static_cast<long long>(kSms));
  if (cols < 1 || cols > kMaxCols || n % cols || blocks != want ||
      smem != 4 * cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  unsigned* pp = static_cast<unsigned*>(partial);
  void* args[] = {&xp, &op, &pp, &n, &cols, &rq, &qmax};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fake_quant_channel_kernel), blocks,
      kThreads, args, static_cast<size_t>(smem), stream));
}

int launch_channel_wide(const void* x, void* out, void* partial,
                        long long n, int cols, float rq, float qmax,
                        int blocks, int smem, cudaStream_t stream) {
  const long long want = std::min(cdiv(n, 1LL * kThreads * kChannelItems),
                                  static_cast<long long>(kSms));
  if (cols <= kMaxCols || n % cols || blocks != want || smem != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  unsigned* pp = static_cast<unsigned*>(partial);
  void* args[] = {&xp, &op, &pp, &n, &cols, &rq, &qmax};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fake_quant_channel_wide_kernel), blocks,
      kThreads, args, 0, stream));
}

}  // namespace

// The kernel and its launch geometry come from the wrapper
// (repro_torch.kernels.ops.fake_quant_geometry): `variant` 0 and 1 are the
// per-group kernel (float4 or float items), 2 and 3 the per-tensor kernel
// (float4 or float), 4 the per-channel kernel, 5 the per-channel kernel for
// more than 4096 columns.  `partial` is scratch of one word per block (per
// channel: `cols` words per block, and for variant 5 `cols` more) for
// variants 2-5, unused otherwise.  A geometry that does not fit
// is refused with cudaErrorInvalidValue.
extern "C" int fake_quant_launch(const void* x, void* out, void* partial,
                                 long long n, int cols, long long group_elems,
                                 float rq, float qmax, int variant, int blocks,
                                 int threads, int smem, void* stream) {
  if (n <= 0 || group_elems <= 0 || threads != kThreads ||
      (variant >= 2 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_group<float4>(x, out, n, group_elems, rq, qmax, blocks, smem, s);
    case 1: return launch_group<float>(x, out, n, group_elems, rq, qmax, blocks, smem, s);
    case 2: return launch_tensor<float4>(x, out, partial, n, rq, qmax, blocks, smem, s);
    case 3: return launch_tensor<float>(x, out, partial, n, rq, qmax, blocks, smem, s);
    case 4: return launch_channel(x, out, partial, n, cols, rq, qmax, blocks, smem, s);
    case 5: return launch_channel_wide(x, out, partial, n, cols, rq, qmax, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
