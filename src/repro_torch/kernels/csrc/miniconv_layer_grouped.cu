// One MiniConv layer: a VALID strided convolution on a pre-padded NHWC
// input that writes all c_out = 4 * n_groups output channels (every RGBA
// target of the layer) in one launch.
//
// Replaces the TPU kernel src/repro/kernels/miniconv_pass.py:
// miniconv_layer_grouped -> _layer_group_kernel (Pallas; grid (batch,
// out_row, kernel_row, group) with the group innermost, so the input row
// block stays resident in VMEM across the group sweep, and one fp32
// accumulator per group in VMEM scratch).
//
// What bounds it on an H100: neither bytes nor FLOPs at MiniConv sizes.
// Layer 0 of the 84x84x12 standard encoder reads a 355 KB padded frame and
// does 10.8 MFLOP, which the card does in well under a microsecond per
// frame, so a launch costs what its fixed overhead costs.  The design
// keeps what the TPU kernel kept, reuse of an input pixel across the
// output groups, in the card's terms:
//
// * One thread per (output pixel, 4-channel group), the group the fastest
//   index.  The threads that share a pixel are neighbours in a warp and
//   read the same input addresses, which L1 serves as one broadcast; the
//   next pixel's threads read the input `stride * c_in` floats further on.
// * The whole layer's weights, kh*kw*c_in*n_groups float4 taps (12 KB for
//   layer 0 of the standard encoder), are staged once per block in shared
//   memory.  Threads of one pixel read neighbouring taps; threads of other
//   pixels read the same tap (a broadcast).
// * Each thread sums into a float4 in the order bias, then kernel row i,
//   column j, input channel c, with fmaf: the order of the per-pass kernel
//   (miniconv_pass.cu), so the `grouped` tier equals the `reference` tier
//   bit for bit, and a run repeats bit for bit.
//
// C interface, bound with ctypes by repro_torch/kernels/miniconv_pass.py.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) layer_grouped_kernel(
    const float* __restrict__ x, const float4* __restrict__ w,
    const float4* __restrict__ b, float4* __restrict__ y, int batch,
    int h_in, int w_in, int c_in, int kh, int kw, int stride, int h_out,
    int w_out, int n_groups) {
  extern __shared__ float4 taps[];  // (kh, kw, c_in, n_groups) float4 taps
  const int n_taps = kh * kw * c_in * n_groups;
  for (int i = threadIdx.x; i < n_taps; i += blockDim.x) taps[i] = w[i];
  __syncthreads();

  const long long total =
      static_cast<long long>(batch) * h_out * w_out * n_groups;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= total) return;
  const int g = static_cast<int>(p % n_groups);
  const long long pix = p / n_groups;
  const int ox = static_cast<int>(pix % w_out);
  const long long r = pix / w_out;
  const int oy = static_cast<int>(r % h_out);
  const long long n = r / h_out;

  float4 acc = __ldg(b + g);
  const float* xn =
      x + ((n * h_in + static_cast<long long>(oy) * stride) * w_in +
           static_cast<long long>(ox) * stride) * c_in;
  for (int i = 0; i < kh; ++i) {
    const float* row = xn + static_cast<long long>(i) * w_in * c_in;
    for (int j = 0; j < kw; ++j) {
      const float* px = row + j * c_in;
      const float4* tw = taps + (i * kw + j) * c_in * n_groups + g;
      for (int c = 0; c < c_in; ++c) {
        const float v = __ldg(px + c);
        const float4 t = tw[c * n_groups];
        acc.x = fmaf(v, t.x, acc.x);
        acc.y = fmaf(v, t.y, acc.y);
        acc.z = fmaf(v, t.z, acc.z);
        acc.w = fmaf(v, t.w, acc.w);
      }
    }
  }
  y[p] = acc;  // output channels 4g .. 4g+3 of pixel `pix`
}

}  // namespace

// x: (batch, h_in, w_in, c_in) fp32, pre-padded; w: (kh, kw, c_in, c_out)
// fp32; b: (c_out,) fp32; y: (batch, h_out, w_out, c_out) fp32, with
// c_out % 4 == 0.  w, b and y must be 16-byte aligned.  The weights take
// 4*kh*kw*c_in*c_out bytes of shared memory, at most what a block may use.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int miniconv_layer_grouped_launch(
    const float* x, const float* w, const float* b, float* y, int batch,
    int h_in, int w_in, int c_in, int kh, int kw, int stride, int h_out,
    int w_out, int c_out, int device, void* stream) {
  if (c_out < 4 || c_out % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = c_out / 4;
  const long long total =
      static_cast<long long>(batch) * h_out * w_out * n_groups;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kh * kw * c_in * c_out;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(layer_grouped_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layer_grouped_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float4*>(w),
      reinterpret_cast<const float4*>(b), reinterpret_cast<float4*>(y),
      batch, h_in, w_in, c_in, kh, kw, stride, h_out, w_out, n_groups);
  return static_cast<int>(cudaGetLastError());
}
