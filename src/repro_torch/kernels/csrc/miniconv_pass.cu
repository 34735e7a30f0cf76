// One MiniConv shader pass: a VALID strided convolution on a pre-padded
// NHWC input that writes exactly 4 output channels (one RGBA target).
//
// Replaces the TPU kernel src/repro/kernels/miniconv_pass.py:
// miniconv_pass -> _pass_kernel (Pallas; grid (batch, out_row, kernel_row)
// with an fp32 row accumulator in VMEM).
//
// What bounds it on an H100: neither bytes nor FLOPs at MiniConv sizes.
// One 84x84 frame's passes move well under a megabyte and do a few MFLOP,
// which the card does in about a microsecond, so a launch costs what its
// fixed overhead costs.  The design is therefore the simplest right one:
// one thread per output pixel with a float4 accumulator for the pass's 4
// channels, fp32 throughout, the pass's weights (kh*kw*C_in float4 taps,
// at most 4 KB under the shader budget) staged once per block in shared
// memory, and the input read straight from global memory, where
// neighbouring threads read neighbouring pixels.  The sum over taps runs
// in a fixed order, so a run repeats bit for bit.
//
// C interface, bound with ctypes by repro_torch/kernels/miniconv_pass.py.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pass_kernel(
    const float* __restrict__ x, const float4* __restrict__ w,
    const float4* __restrict__ b, float4* __restrict__ y, int batch,
    int h_in, int w_in, int c_in, int kh, int kw, int stride, int h_out,
    int w_out) {
  extern __shared__ float4 taps[];  // (kh, kw, c_in) taps of 4 channels
  const int n_taps = kh * kw * c_in;
  for (int i = threadIdx.x; i < n_taps; i += blockDim.x) taps[i] = w[i];
  __syncthreads();

  const long long total = static_cast<long long>(batch) * h_out * w_out;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= total) return;
  const int ox = static_cast<int>(p % w_out);
  const long long r = p / w_out;
  const int oy = static_cast<int>(r % h_out);
  const long long n = r / h_out;

  float4 acc = __ldg(b);
  const float* xn =
      x + ((n * h_in + static_cast<long long>(oy) * stride) * w_in +
           static_cast<long long>(ox) * stride) * c_in;
  for (int i = 0; i < kh; ++i) {
    const float* row = xn + static_cast<long long>(i) * w_in * c_in;
    for (int j = 0; j < kw; ++j) {
      const float* px = row + j * c_in;
      const float4* tw = taps + (i * kw + j) * c_in;
      for (int c = 0; c < c_in; ++c) {
        const float v = __ldg(px + c);
        const float4 t = tw[c];
        acc.x = fmaf(v, t.x, acc.x);
        acc.y = fmaf(v, t.y, acc.y);
        acc.z = fmaf(v, t.z, acc.z);
        acc.w = fmaf(v, t.w, acc.w);
      }
    }
  }
  y[p] = acc;
}

}  // namespace

// x: (batch, h_in, w_in, c_in) fp32, pre-padded; w: (kh, kw, c_in, 4) fp32;
// b: (4,) fp32; y: (batch, h_out, w_out, 4) fp32.  w, b and y must be
// 16-byte aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int miniconv_pass_launch(const float* x, const float* w,
                                    const float* b, float* y, int batch,
                                    int h_in, int w_in, int c_in, int kh,
                                    int kw, int stride, int h_out, int w_out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * h_out * w_out;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float4) * kh * kw * c_in;
  pass_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(w),
      reinterpret_cast<const float4*>(b), reinterpret_cast<float4*>(y),
      batch, h_in, w_in, c_in, kh, kw, stride, h_out, w_out);
  return static_cast<int>(cudaGetLastError());
}
