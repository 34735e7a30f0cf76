// The whole MiniConv encoder (every layer of a PassPlan) in one launch,
// with an optional projection epilogue z = act(flatten_NHWC(feats) @ W + b).
//
// Replaces the TPU kernel src/repro/kernels/miniconv_pass.py:
// miniconv_encoder -> _miniconv_encoder -> _encoder_kernel (Pallas; grid
// (batch, out_row_tile), layers chained through VMEM, the head carried
// across row tiles in a VMEM scratch).
//
// What bounds it on an H100.  Per 84x84x12 frame the encoder does 13.0
// MFLOP of fp32 multiply-adds and reads 339 KB of input: by the card's
// peaks (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s) both take well
// under a microsecond, so neither bounds a serving batch of 1 to 8
// frames.  What does is the layers' sequential dependence inside a frame
// and the traffic of the intermediates between layers.  The design keeps
// that traffic on the SM:
//
// * One thread block per frame.  The blocks of the grid run in no order,
//   so nothing crosses frames: a frame's layers run one after another in
//   its block, separated by __syncthreads(), and its projection is summed
//   by the same block.
// * Layer intermediates live in two ping-pong buffers (layers 0, 2, ...
//   write the first, layers 1, 3, ... the second; the last layer writes
//   the output).  The wrapper places them from the plan: in the block's
//   dynamic shared memory when one frame's fit (84x84: 42x42x16 + 21x21x16
//   fp32 = 138 KB of the 227 KB a block may use), else in a per-frame
//   global workspace that stays resident in the 50 MB L2 (400x400: 3.2 MB
//   a frame).  Both go through one generic pointer, so both branches run
//   the same code.
// * SAME padding is never materialised: a tap outside the input is
//   skipped, which adds what the padded zero would have.  The layer input
//   is read unpadded, so the TPU kernel's RGBA channel padding, 8-row
//   output tiles and 128-lane head padding have no counterpart here; any
//   c_out and any D are taken directly.
// * Within a layer, thread t computes output element t of the (h, w, c)
//   order, then t + blockDim.x, ...: neighbouring threads share an input
//   pixel (a broadcast) and read neighbouring weights (coalesced).
// * The epilogue gives each thread one or more columns d of W and sums
//   the flat features in ascending order.  No float atomics: a run
//   repeats bit for bit.
//
// Known cost of this simple form: a batch of B frames occupies B of the
// card's 132 SMs, and every multiply-add issues two loads.  Spreading a
// frame over a thread-block cluster and register-blocking the output
// channels are the next steps.
//
// K4, the streamed encoder (encoder_stream_kernel), replaces the TPU
// kernel miniconv_encoder_stream -> _miniconv_encoder_pipelined (Pallas;
// grid (n_chunks, chunk_b, out_row_tile), one chunk's input block resident
// in VMEM at a time, the next chunk fetched while this one computes).  On
// the card it is a persistent kernel: chunk_b resident blocks, block k
// encoding frames k, k + chunk_b, k + 2*chunk_b, ... through workspace
// slot k, so the global workspace holds chunk_b frames rather than the
// batch (51 MB instead of 205 MB for 64 frames of 400x400x4).  Both
// kernels run one frame with the same device function (encode_frame); only
// the staging slot differs (the frame in K1, the block in K4), so K4 equals
// K1 bit for bit at every batch, a ragged last round included.  What
// bounds it is K1's frame time: chunk_b SMs work, so a batch of B takes
// ceil(B / chunk_b) frame times where K1 takes ceil(B / 132).  Fetching
// the next frame's input while this one computes (cp.async or TMA) is
// later work.
//
// C interface, bound with ctypes by repro_torch/kernels/miniconv_pass.py.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 512;
constexpr int kDescInts = 11;  // ints per layer in the host descriptor

enum Act { kRelu = 0, kSigmoid = 1, kLinear = 2 };

struct Layer {
  int kernel, stride, c_in, c_out, in_h, in_w, out_h, out_w, pad_top,
      pad_left, act;
  const float* w;  // (kernel, kernel, c_in, c_out) HWIO
  const float* b;  // (c_out,)
};

struct Params {
  Layer layers[kMaxLayers];
  int n_layers;
  const float* x;      // (B, in_h, in_w, c_in) NHWC
  float* feats;        // (B, out_h, out_w, c_out) of the last layer
  float* z;            // (B, head_dim) or null
  float* workspace;    // (slots, ws_frame) or null when staging in shared
  const float* head_w;  // (F, head_dim), F = out_h * out_w * c_out
  const float* head_b;  // (head_dim,) or null
  int head_dim, head_act;
  int buf1_offset;      // floats from the first buffer to the second
  long long ws_frame;   // floats of workspace per slot; 0: shared memory
  long long batch;      // frames in x
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-v));
  return v;
}

// One SAME conv layer of one frame.  `in` and `out` may point to shared or
// global memory, so they are read and written through generic pointers.
__device__ void conv_layer(const Layer& L, const float* in, float* out) {
  const int n_out = L.out_h * L.out_w * L.c_out;
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int co = idx % L.c_out;
    const int pix = idx / L.c_out;
    const int ox = pix % L.out_w;
    const int oy = pix / L.out_w;
    const int iy0 = oy * L.stride - L.pad_top;
    const int ix0 = ox * L.stride - L.pad_left;
    float acc = __ldg(L.b + co);
    for (int i = 0; i < L.kernel; ++i) {
      const int iy = iy0 + i;
      if (iy < 0 || iy >= L.in_h) continue;
      for (int j = 0; j < L.kernel; ++j) {
        const int ix = ix0 + j;
        if (ix < 0 || ix >= L.in_w) continue;
        const float* px = in + (iy * L.in_w + ix) * L.c_in;
        const float* pw = L.w + (i * L.kernel + j) * L.c_in * L.c_out + co;
        for (int c = 0; c < L.c_in; ++c)
          acc = fmaf(px[c], __ldg(pw + c * L.c_out), acc);
      }
    }
    out[idx] = activate(acc, L.act);
  }
}

// One frame, run by the whole block: every layer, then the projection
// epilogue.  `buf0` is the frame's staging slot: the block's shared memory,
// or a ws_frame-float slice of the global workspace.
__device__ __forceinline__ void encode_frame(const Params& p, long long n,
                                             float* buf0) {
  float* buf1 = buf0 + p.buf1_offset;
  const int last = p.n_layers - 1;
  const Layer& first = p.layers[0];
  const Layer& fin = p.layers[last];
  const long long n_feats =
      static_cast<long long>(fin.out_h) * fin.out_w * fin.c_out;
  const float* in =
      p.x + n * first.in_h * first.in_w * static_cast<long long>(first.c_in);
  float* feats = p.feats + n * n_feats;

  for (int l = 0; l < p.n_layers; ++l) {
    float* out = l == last ? feats : ((l & 1) ? buf1 : buf0);
    conv_layer(p.layers[l], in, out);
    __syncthreads();  // the layer's output is the next layer's input
    in = out;
  }

  if (p.z == nullptr) return;
  // Projection epilogue: the features this block just wrote are visible to
  // all its threads after the barrier above.
  for (int d = threadIdx.x; d < p.head_dim; d += blockDim.x) {
    float acc = p.head_b ? __ldg(p.head_b + d) : 0.0f;
    const float* wd = p.head_w + d;
    for (long long f = 0; f < n_feats; ++f)
      acc = fmaf(feats[f], __ldg(wd + f * p.head_dim), acc);
    p.z[n * p.head_dim + d] = activate(acc, p.head_act);
  }
}

// K1: one block per frame, the frame's own workspace slot.
// __grid_constant__: layers are indexed at run time without a local copy
// of the parameter block.
__global__ void __launch_bounds__(kThreads)
    encoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const long long n = blockIdx.x;
  encode_frame(p, n, p.ws_frame ? p.workspace + n * p.ws_frame : smem);
}

// K4: gridDim.x resident blocks walk the batch; block k owns slot k.
__global__ void __launch_bounds__(kThreads)
    encoder_stream_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* slot = p.ws_frame ? p.workspace + blockIdx.x * p.ws_frame : smem;
  for (long long n = blockIdx.x; n < p.batch; n += gridDim.x) {
    encode_frame(p, n, slot);
    __syncthreads();  // the slot is free before the next frame writes it
  }
}

// Fills the parameter block and launches K1 (chunk_b == 0: one block per
// frame) or K4 (chunk_b > 0: min(chunk_b, batch) persistent blocks).
int launch(const float* x, float* feats, float* z, float* workspace,
           const int* desc, int n_layers, const void* const* weights,
           const void* const* biases, const float* head_w,
           const float* head_b, int head_dim, int head_act, int batch,
           int chunk_b, int buf1_offset, long long ws_frame, int smem_bytes,
           int device, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || chunk_b < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int l = 0; l < n_layers; ++l) {
    const int* d = desc + l * kDescInts;
    Layer& L = p.layers[l];
    L.kernel = d[0];
    L.stride = d[1];
    L.c_in = d[2];
    L.c_out = d[3];
    L.in_h = d[4];
    L.in_w = d[5];
    L.out_h = d[6];
    L.out_w = d[7];
    L.pad_top = d[8];
    L.pad_left = d[9];
    L.act = d[10];
    L.w = static_cast<const float*>(weights[l]);
    L.b = static_cast<const float*>(biases[l]);
  }
  p.n_layers = n_layers;
  p.x = x;
  p.feats = feats;
  p.z = z;
  p.workspace = workspace;
  p.head_w = head_w;
  p.head_b = head_b;
  p.head_dim = head_dim;
  p.head_act = head_act;
  p.buf1_offset = buf1_offset;
  p.ws_frame = ws_frame;
  p.batch = batch;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const bool stream_frames = chunk_b > 0;
  const void* kernel =
      stream_frames ? reinterpret_cast<const void*>(encoder_stream_kernel)
                    : reinterpret_cast<const void*>(encoder_kernel);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int resident = chunk_b < batch ? chunk_b : batch;
  if (stream_frames)
    encoder_stream_kernel<<<resident, kThreads, smem_bytes, s>>>(p);
  else
    encoder_kernel<<<batch, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// desc: n_layers x kDescInts host ints per layer, in the order (kernel,
// stride, c_in, c_out, in_h, in_w, out_h, out_w, pad_top, pad_left, act).
// weights, biases: host arrays of n_layers device pointers.  z, head_w and
// head_b may be null (no epilogue; no bias).  With ws_frame > 0 the
// intermediates go to `workspace` (batch * ws_frame floats) and smem_bytes
// must be 0; with ws_frame == 0 they go to smem_bytes of shared memory.
// Launches K1 on `stream` and returns cudaGetLastError().
extern "C" int miniconv_encoder_launch(
    const float* x, float* feats, float* z, float* workspace,
    const int* desc, int n_layers, const void* const* weights,
    const void* const* biases, const float* head_w, const float* head_b,
    int head_dim, int head_act, int batch, int buf1_offset,
    long long ws_frame, int smem_bytes, int device, void* stream) {
  return launch(x, feats, z, workspace, desc, n_layers, weights, biases,
                head_w, head_b, head_dim, head_act, batch, 0, buf1_offset,
                ws_frame, smem_bytes, device, stream);
}

// K4: the arguments of miniconv_encoder_launch plus chunk_b >= 1, the
// resident blocks; `workspace` then holds min(chunk_b, batch) * ws_frame
// floats.  Launches on `stream` and returns cudaGetLastError().
extern "C" int miniconv_encoder_stream_launch(
    const float* x, float* feats, float* z, float* workspace,
    const int* desc, int n_layers, const void* const* weights,
    const void* const* biases, const float* head_w, const float* head_b,
    int head_dim, int head_act, int batch, int chunk_b, int buf1_offset,
    long long ws_frame, int smem_bytes, int device, void* stream) {
  if (chunk_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, feats, z, workspace, desc, n_layers, weights, biases,
                head_w, head_b, head_dim, head_act, batch, chunk_b,
                buf1_offset, ws_frame, smem_bytes, device, stream);
}
