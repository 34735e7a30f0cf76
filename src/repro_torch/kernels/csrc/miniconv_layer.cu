// One MiniConv layer as a tiled convolution: a VALID strided convolution
// on a pre-padded NHWC fp32 input.  Two kernels run one tile body:
//
// K2 (pass_kernel) replaces the TPU kernel src/repro/kernels/
// miniconv_pass.py: miniconv_pass -> _pass_kernel (Pallas; grid (batch,
// out_row, kernel_row) with an fp32 row accumulator in VMEM).  It writes
// one 4-channel output group, reading that group's weights in place out
// of the layer's weight tensor (a tap stride of the layer's C_out floats),
// so the `reference` tier's `kernel[..., g:g+4]` views are never copied.
// K3 (layer_grouped_kernel) replaces miniconv_layer_grouped ->
// _layer_group_kernel (Pallas; grid (batch, out_row, kernel_row, group),
// the input row resident in VMEM across the group sweep).  It writes
// every output group of the layer in one launch.
//
// What bounds them on an H100.  A layer of the standard encoder moves a
// few hundred KB (one 84x84 frame) to 10 MB (two 400x400 frames) and does
// 4-165 MFLOP of fp32 multiply-adds: at 3.35 TB/s and 67 TFLOP/s that is
// 0.1-3 us, bytes and operations about even.  At the served frame no
// launch has enough work to fill the card, so what counts is how many SMs
// share it and how long one thread's chain of loads and FMAs is.
//
// The design (K1's, in miniconv_encoder.cu, for one layer):
//
// * Tiles, not pixels, are the unit of work.  A block owns a tile_h x
//   tile_w tile of one frame's output and co_block of its channels.  It
//   stages the input region under the tile, ((tile_h-1)*s+kh) x
//   ((tile_w-1)*s+kw) x c_in, with 16-byte cp.async (4-byte copies when
//   c_in % 4 != 0 or the input is not 16-byte aligned), zero past the
//   input's edge, and its channels' weights once.  PassPlan's
//   plan_conv_tiles (core/passplan.py) picks the tile, the channel block,
//   the register tile and the threads so that a launch spreads over every
//   SM; the host passes them in the argument array.
// * The region is kept as planes of float4 (input channels 4q..4q+3),
//   each row's columns split by phase modulo the stride: neighbouring
//   threads own neighbouring output columns and read neighbouring float4s
//   (no bank conflict at stride 2), one 16-byte load feeding 4 input
//   channels.
// * Registers hold P pixels x CB channels a thread (core/passplan.py
//   TASK_SHAPES; K2 the CB = 4 ones): each input value read from shared
//   memory feeds CB FMAs, each float4 of weights (one address across the
//   warp) feeds P.
// * (kh, kw, stride, c_in) are template arguments for the standard
//   layers, (4,4,2,12), (3,3,2,16) and (4,4,2,4), so that the tap loops
//   unroll; one generic instantiation runs every other shape with runtime
//   loops.
// * Each output sums bias, then (i, j, c) in order, with fmaf, in every
//   instantiation, tile and register tile: K3 equals K2 bit for bit (the
//   `grouped` tier equals `reference`), and a run repeats bit for bit.
//
// C interface: miniconv_layer_launch, one array of int64 (enum Arg),
// called from repro_torch/kernels/miniconv_pass.py through _build.launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // PassPlan: CONV_MAX_THREADS
constexpr int kMinBlocks = 2;     // 128 registers a thread at most
constexpr int kMaxDevices = 64;

// The launch arguments, packed by the wrapper as one int64 array.
enum Arg {
  kX, kW, kB, kY,              // device pointers
  kBatch, kHin, kWin, kCin,    // x (batch, h_in, w_in, c_in), pre-padded
  kKh, kKw, kStride,           // the kernel's taps and stride
  kHout, kWout, kCout,         // y (batch, h_out, w_out, c_out)
  kWld,                        // floats between neighbouring (i, j, c)
                               // taps of w; b holds c_out floats
  kTileH, kTileW, kCoBlock,    // a block: tile_h x tile_w outputs of
                               // co_block channels
  kPix, kCb, kThreads,         // a thread: pix pixels x cb channels
  kSmemBytes,
  kLayerGrouped,               // 1: K3, every output group; 0: K2, one
  kDevice, kStream,
  kNArgs
};

struct Conv {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  int h_in, w_in, c_in, kh, kw, stride, h_out, w_out, c_out, w_ld;
  int tile_h, tile_w, tiles_y, tiles_x, co_block, co_blocks;
  // the staged region: ext_h x ext_w positions, c4 planes of float4, each
  // row `row` float4 slots split by phase modulo the stride
  int ext_h, ext_w, row, c4;
  int b_off, in_off;  // shared-memory offsets in floats; weights at 0
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 fills the 4 bytes with zeros and reads nothing.
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One block: stage the tile's input region and its channels' weights and
// bias, then each thread computes its P x CB register tiles and stores
// them.  KH, KW, S, C are the layer's shape, or 0 for the launch's.
template <int KH, int KW, int S, int C, int P, int CB>
__device__ __forceinline__ void conv_tile(const Conv& p) {
  extern __shared__ __align__(16) float smem[];
  const int kh = KH ? KH : p.kh, kw = KW ? KW : p.kw;
  const int s = S ? S : p.stride, c_in = C ? C : p.c_in;
  const int c4 = C ? (C + 3) / 4 : p.c4;
  const int co_block = p.co_block, tile_w = p.tile_w;
  const int ext_h = p.ext_h, ext_w = p.ext_w, row = p.row;
  const int plane = ext_h * row, half = row / s;
  constexpr int kRowUnroll = CB >= 16 || KH == 0 ? 1 : KH;

  // block -> (frame, tile row, tile column, channel block), channel
  // blocks of one tile neighbours, so they share the region in L2
  int blk = blockIdx.x;
  const int cob = blk % p.co_blocks;
  blk /= p.co_blocks;
  const int tx = blk % p.tiles_x;
  blk /= p.tiles_x;
  const int ty = blk % p.tiles_y;
  const long long n = blk / p.tiles_y;
  const int co0 = cob * co_block;
  const int oy0 = ty * p.tile_h, ox0 = tx * tile_w;

  // weights: (kh, kw, c_in) rows of co_block floats at 0
  float* ws = smem;
  const int n_rows = kh * kw * c_in, quads = co_block / 4;
  const bool w_vec = (p.w_ld & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.w + co0) & 15) == 0;
  for (int e = threadIdx.x; e < n_rows * quads; e += blockDim.x) {
    const int r = e / quads, q = e - r * quads;
    float* dst = ws + r * co_block + 4 * q;
    const float* src = p.w + static_cast<long long>(r) * p.w_ld + co0 + 4 * q;
    if (w_vec) {
      cp_async16(dst, src, true);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(dst + k, src + k, true);
    }
  }
  for (int e = threadIdx.x; e < co_block; e += blockDim.x)
    cp_async4(smem + p.b_off + e, p.b + co0 + e, true);

  // the input region: c4 planes of ext_h rows, float4 slots split by phase
  float4* reg = reinterpret_cast<float4*>(smem + p.in_off);
  const int iy0 = oy0 * s, ix0 = ox0 * s;
  const float* frame =
      p.x + n * p.h_in * static_cast<long long>(p.w_in) * c_in;
  const bool x_vec = (c_in & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  const int per_row = ext_w * c4;
  for (int e = threadIdx.x; e < ext_h * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int rem = e - r * per_row;
    const int col = rem / c4, q = rem - col * c4;  // channels fastest
    const int gy = iy0 + r, gx = ix0 + col;
    const bool ok = gy < p.h_in && gx < p.w_in;
    float* dst = reinterpret_cast<float*>(reg + q * plane + r * row +
                                          (col % s) * half + col / s);
    const float* src =
        ok ? frame + (static_cast<long long>(gy) * p.w_in + gx) * c_in + 4 * q
           : frame;
    if (x_vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool okk = ok && 4 * q + k < c_in;
        cp_async4(dst + k, okk ? src + k : frame, okk);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // P pixels (groups apart, so a warp's lanes own neighbouring pixels) x
  // CB channels a task
  const float* bs = smem + p.b_off;
  const int n_pix = p.tile_h * tile_w;
  const int groups = (n_pix + P - 1) / P;
  const int tasks = groups * (co_block / CB);
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int cb = task / groups;
    const int g = task - cb * groups;
    int base[P], pix[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int px = g + k * groups;
      pix[k] = px < n_pix ? px : -1;
      const int py = px < n_pix ? px / tile_w : 0;
      const int pxx = px < n_pix ? px - py * tile_w : 0;
      // input column pxx * s + j sits at phase j % s, slot pxx + j / s
      base[k] = py * s * row + pxx;
    }
    float acc[P][CB];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int q = 0; q < CB; ++q) acc[k][q] = bs[cb * CB + q];
    // kernel rows unrolled too, but for 16 channels a thread: ptxas then
    // keeps the hoisted loads in registers (it spilled 1.4 KB a thread)
#pragma unroll kRowUnroll
    for (int i = 0; i < kh; ++i) {
#pragma unroll
      for (int j = 0; j < kw; ++j) {
        const float4* src = reg + i * row + (j % s) * half + j / s;
        const float* wt = ws + (i * kw + j) * c_in * co_block + cb * CB;
#pragma unroll
        for (int q4 = 0; q4 < c4; ++q4) {
          float4 v[P];
#pragma unroll
          for (int k = 0; k < P; ++k) v[k] = src[q4 * plane + base[k]];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int c = 4 * q4 + cc;
            if (c >= c_in) break;  // generic shapes only: c_in % 4 != 0
            float wv[CB];
#pragma unroll
            for (int q = 0; q < CB; q += 4) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(wt + c * co_block + q);
              wv[q] = w4.x;
              wv[q + 1] = w4.y;
              wv[q + 2] = w4.z;
              wv[q + 3] = w4.w;
            }
#pragma unroll
            for (int k = 0; k < P; ++k) {
              const float a = lane(v[k], cc);
#pragma unroll
              for (int q = 0; q < CB; ++q)
                acc[k][q] = fmaf(a, wv[q], acc[k][q]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (pix[k] < 0) continue;
      const int py = pix[k] / tile_w;
      const int oy = oy0 + py, ox = ox0 + pix[k] - py * tile_w;
      if (oy >= p.h_out || ox >= p.w_out) continue;
      float* dst = p.y +
                   ((n * p.h_out + oy) * static_cast<long long>(p.w_out) +
                    ox) * p.c_out + co0 + cb * CB;
#pragma unroll
      for (int q = 0; q < CB; q += 4)
        *reinterpret_cast<float4*>(dst + q) = make_float4(
            acc[k][q], acc[k][q + 1], acc[k][q + 2], acc[k][q + 3]);
    }
  }
}

// K2: one 4-channel output group.
template <int KH, int KW, int S, int C, int P, int CB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    pass_kernel(const __grid_constant__ Conv p) {
  conv_tile<KH, KW, S, C, P, CB>(p);
}

// K3: every output group of the layer.
template <int KH, int KW, int S, int C, int P, int CB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    layer_grouped_kernel(const __grid_constant__ Conv p) {
  conv_tile<KH, KW, S, C, P, CB>(p);
}

// Raises a kernel's dynamic shared-memory limit once per device and size.
int allow_smem(const void* kernel, int* allowed, int device, int bytes) {
  if (bytes <= 48 * 1024 || bytes <= allowed[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed[device] = bytes;
  return 0;
}

struct Launch {
  unsigned blocks;
  int threads, smem, device;
  cudaStream_t stream;
};

template <bool kGrouped, int KH, int KW, int S, int C, int P, int CB>
int launch_kernel(const Conv& p, const Launch& l) {
  static int allowed[kMaxDevices];
  // (the pass kernel is instantiated for CB = 4 alone)
  if constexpr (kGrouped) {
    const int err = allow_smem(reinterpret_cast<const void*>(
                                   layer_grouped_kernel<KH, KW, S, C, P, CB>),
                               allowed, l.device, l.smem);
    if (err) return err;
    layer_grouped_kernel<KH, KW, S, C, P, CB>
        <<<l.blocks, l.threads, l.smem, l.stream>>>(p);
  } else {
    const int err = allow_smem(
        reinterpret_cast<const void*>(pass_kernel<KH, KW, S, C, P, CB>),
        allowed, l.device, l.smem);
    if (err) return err;
    pass_kernel<KH, KW, S, C, P, CB>
        <<<l.blocks, l.threads, l.smem, l.stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The register tile: K2 writes 4 channels, so only CB = 4 (PassPlan:
// PASS_TASK_SHAPES); K3 takes every shape of TASK_SHAPES.
template <bool kGrouped, int KH, int KW, int S, int C>
int dispatch_task(const Conv& p, const Launch& l, int pix, int cb) {
  switch (pix * 100 + cb) {
    case 204:
      return launch_kernel<kGrouped, KH, KW, S, C, 2, 4>(p, l);
    case 104:
      return launch_kernel<kGrouped, KH, KW, S, C, 1, 4>(p, l);
    default:
      break;
  }
  if constexpr (kGrouped) {
    switch (pix * 100 + cb) {
      case 208:
        return launch_kernel<kGrouped, KH, KW, S, C, 2, 8>(p, l);
      case 116:
        return launch_kernel<kGrouped, KH, KW, S, C, 1, 16>(p, l);
      case 108:
        return launch_kernel<kGrouped, KH, KW, S, C, 1, 8>(p, l);
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The layer's shape: the standard encoder's at compile time, any other
// through the generic instantiation.
template <bool kGrouped>
int dispatch(const Conv& p, const Launch& l, int pix, int cb) {
  if (p.kh == 4 && p.kw == 4 && p.stride == 2 && p.c_in == 12)
    return dispatch_task<kGrouped, 4, 4, 2, 12>(p, l, pix, cb);
  if (p.kh == 3 && p.kw == 3 && p.stride == 2 && p.c_in == 16)
    return dispatch_task<kGrouped, 3, 3, 2, 16>(p, l, pix, cb);
  if (p.kh == 4 && p.kw == 4 && p.stride == 2 && p.c_in == 4)
    return dispatch_task<kGrouped, 4, 4, 2, 4>(p, l, pix, cb);
  return dispatch_task<kGrouped, 0, 0, 0, 0>(p, l, pix, cb);
}

}  // namespace

// a: the kNArgs launch arguments in the order of `enum Arg`.  x (batch,
// h_in, w_in, c_in) contiguous; w (kh, kw, c_in, c_out) read as w[(i * kw
// + j) * c_in + c) * w_ld + o] (K2: a layer weight's 4-channel group view,
// w_ld its C_out; K3: c_out % 4 == 0 channels, w_ld >= c_out); b c_out
// contiguous floats; y (batch, h_out, w_out, c_out) contiguous and 16-byte
// aligned.  The plan's tile, channel block (K2: 4), register tile (pix,
// cb) of PassPlan's TASK_SHAPES, threads and shared-memory bytes come from
// PassPlan's plan_conv_tiles.  Launches K3 (layer_grouped 1) or K2 on the
// stream and returns cudaGetLastError().
extern "C" int miniconv_layer_launch(const long long* a) {
  const int batch = static_cast<int>(a[kBatch]);
  const long long grouped = a[kLayerGrouped];
  Conv p{};
  p.x = reinterpret_cast<const float*>(a[kX]);
  p.w = reinterpret_cast<const float*>(a[kW]);
  p.b = reinterpret_cast<const float*>(a[kB]);
  p.y = reinterpret_cast<float*>(a[kY]);
  p.h_in = static_cast<int>(a[kHin]);
  p.w_in = static_cast<int>(a[kWin]);
  p.c_in = static_cast<int>(a[kCin]);
  p.kh = static_cast<int>(a[kKh]);
  p.kw = static_cast<int>(a[kKw]);
  p.stride = static_cast<int>(a[kStride]);
  p.h_out = static_cast<int>(a[kHout]);
  p.w_out = static_cast<int>(a[kWout]);
  p.c_out = static_cast<int>(a[kCout]);
  p.w_ld = static_cast<int>(a[kWld]);
  p.tile_h = static_cast<int>(a[kTileH]);
  p.tile_w = static_cast<int>(a[kTileW]);
  p.co_block = static_cast<int>(a[kCoBlock]);
  const int pix = static_cast<int>(a[kPix]), cb = static_cast<int>(a[kCb]);
  const int threads = static_cast<int>(a[kThreads]);
  const int device = static_cast<int>(a[kDevice]);
  if (batch < 0 || p.c_in < 1 || p.kh < 1 || p.kw < 1 || p.stride < 1 ||
      p.h_in < p.kh || p.w_in < p.kw ||
      p.h_out != (p.h_in - p.kh) / p.stride + 1 ||
      p.w_out != (p.w_in - p.kw) / p.stride + 1 || p.c_out < 4 ||
      p.c_out % 4 != 0 || (!grouped && p.c_out != 4) || p.w_ld < p.c_out ||
      p.tile_h < 1 || p.tile_w < 1 || p.co_block < 4 ||
      p.co_block % 4 != 0 || p.c_out % p.co_block != 0 || cb < 4 ||
      p.co_block % cb != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || device < 0 || device >= kMaxDevices ||
      (grouped != 0 && grouped != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_y = (p.h_out + p.tile_h - 1) / p.tile_h;
  p.tiles_x = (p.w_out + p.tile_w - 1) / p.tile_w;
  p.co_blocks = p.c_out / p.co_block;
  p.ext_h = (p.tile_h - 1) * p.stride + p.kh;
  p.ext_w = (p.tile_w - 1) * p.stride + p.kw;
  p.row = p.stride * ((p.ext_w + p.stride - 1) / p.stride);
  p.c4 = (p.c_in + 3) / 4;
  // shared memory, as PassPlan's conv_tile_layout lays it out
  p.b_off = p.kh * p.kw * p.c_in * p.co_block;
  p.in_off = p.b_off + p.co_block;
  const long long smem =
      4LL * (p.in_off + 4LL * p.c4 * p.ext_h * p.row);
  if (smem != a[kSmemBytes]) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(batch) * p.tiles_y *
                           p.tiles_x * p.co_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return 0;
  const Launch l{static_cast<unsigned>(blocks), threads,
                 static_cast<int>(smem), device,
                 reinterpret_cast<cudaStream_t>(a[kStream])};
  return grouped ? dispatch<true>(p, l, pix, cb)
                 : dispatch<false>(p, l, pix, cb);
}
