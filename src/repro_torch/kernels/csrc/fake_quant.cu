// Symmetric quantize-dequantize: out = clip(rint(x / s), -qmax, qmax) * s.
//
// Replaces the TPU kernel src/repro/kernels/fake_quant.py, fake_quant_pallas
// (body _quant_kernel).  As there, the scale s = max(amax, 1e-9) / qmax is
// computed outside the kernel (the wrapper's amax reduction); the kernel is
// the fused elementwise pass.  It takes a scale per group of consecutive
// rows of the (R, C) view (one per node for the fleet's activations, one per
// tensor for the weights) or per last-dim channel.
//
// What bounds it on the card: bytes.  One slot's activations are about
// 2,100 floats per node, read once and written once: at 3000 nodes about
// 50 MB, about 15 us at 3.35 TB/s.  The arithmetic (one division, one
// rounding, one multiply per element) is negligible.
//
// Design: a grid-stride loop, one element per thread per step, neighbouring
// threads on neighbouring addresses so the loads and stores coalesce.  The
// division is IEEE (no fast math) and the rounding is rintf, half to even,
// like jnp.round: the kernel is bit-equal to the plain version.
#include <cuda_runtime.h>

namespace {

__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, long long n,
                                  int cols, long long group_elems,
                                  int per_channel, float qmax) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float s = per_channel ? scale[i % cols] : scale[i / group_elems];
    const float q = fminf(fmaxf(rintf(x[i] / s), -qmax), qmax);
    out[i] = q * s;
  }
}

}  // namespace

extern "C" int fake_quant_launch(const void* x, const void* scale, void* out,
                                 long long n, int cols, long long group_elems,
                                 int per_channel, float qmax, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride past this
  fake_quant_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), n, cols, group_elems, per_channel, qmax);
  return static_cast<int>(cudaGetLastError());
}
