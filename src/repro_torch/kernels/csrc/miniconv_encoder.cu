// The whole MiniConv encoder (every layer of a PassPlan) in one launch,
// with an optional projection epilogue z = act(flatten_NHWC(feats) @ W + b).
//
// K1 (encoder_kernel) replaces the TPU kernel
// src/repro/kernels/miniconv_pass.py: miniconv_encoder -> _miniconv_encoder
// -> _encoder_kernel (Pallas; grid (batch, out_row_tile), layers chained
// through VMEM, the head carried across row tiles in a VMEM scratch).
// K4 (encoder_stream_kernel) replaces miniconv_encoder_stream ->
// _miniconv_encoder_pipelined (Pallas; one chunk's input block resident in
// VMEM at a time, the next chunk fetched while this one computes).
//
// What bounds them on an H100.  The encoder is fp32 multiply-adds on the
// CUDA cores (TF32 would break the 1e-5 feature tolerance): 141 MFLOP a
// 400x400x4 frame with the 512-wide head, 13 MFLOP an 84x84x12 frame.  At
// 67 TFLOP/s a batch of 64 400x400 frames takes 0.135 ms and reads 164 MB
// of input (0.049 ms at 3.35 TB/s): operations bound it.  A frame of
// 84x84 is a few microseconds of work, so a served frame is bound by how
// many SMs share it and by the latency of its layer chain.
//
// The design:
//
// * Halo tiles, not frames, are the unit of work.  An item is one
//   tile_h x tile_w block of the last layer's output of one frame.  Its
//   block stages the input region the item needs (zero outside the frame:
//   the first layer's SAME padding), then computes every earlier layer
//   over the region the next one reads, recomputing the overlap of
//   neighbouring tiles (1.5x with the 4x4 tiles of 400x400).  A region's
//   positions outside its layer's output are stored as zero, the next
//   layer's padding, and never computed: bias plus activation is not
//   zero.  All regions stay in shared memory, so no intermediate reaches
//   device memory; a batch of B frames spreads over B x tiles blocks
//   instead of B.  PassPlan.tile_plan (core/passplan.py) picks the tile
//   size, the regions, their origins and every shared-memory offset on
//   the host, and passes them in `desc`.
// * Registers hold a pixel's output channels.  A thread owns P output
//   pixels and CB of their channels (P x CB accumulators, the shape chosen
//   per layer on the host).  Regions are CHW in shared memory, each row's
//   columns split by phase modulo the reading layer's stride, so
//   neighbouring threads of a stride-2 layer read neighbouring floats (no
//   bank conflict); the layer's weights, staged once per block as (tap,
//   c_in, co_pad), are read as 16-byte vectors at one address across the
//   warp.  Per (tap, input channel) a thread issues P + CB/4 loads for
//   P x CB FMAs.
// * Each output's sum runs bias, then (i, j, c) in order, whatever the
//   tile size or the frames of a pass: features repeat bit for bit, and
//   K4 equals K1.
// * A layer pass covers `frames` (F) frames of an item at once.  Its
//   tasks are indexed over (frame, pixel group, channel block), so the F
//   frames share one sweep of the block's threads and one __syncthreads
//   a layer; each region holds F frames, one after the other.  A layer
//   pass is a chain of (tap, channel) steps as long as a thread's tasks,
//   however few warps carry it: a tile's later layers fill one or two
//   warps, and an 84x84 tile's first fills half the block.  F frames a
//   pass fill F times the warps for the chain of one, and pay each
//   layer's barrier and its short tail once for F frames.
// * K4 is persistent: its blocks walk the items, each one tile of up to
//   four consecutive frames, a pass of F frames at a time.  The next
//   pass's input region is fetched with cp.async into the one input
//   buffer as soon as the first layer, its only reader, has finished with
//   it, so that it lands while the later layers, the projection and the
//   SM's other block run.  One F-frame buffer, and not two, lets larger
//   tiles and F frames' regions fit beside two resident blocks an SM.  K1
//   runs the same pass body with F = 1, one block per tile of one frame
//   and no prefetch.
// * The projection needs all of a frame's tiles, and uses no float
//   atomics.  Each item multiplies its frames' features by their rows of
//   W, in ascending feature order, into a partial sum per (frame, tile,
//   column), reading each row of W once for all the item's frames (W is
//   20 MB at 400x400: read once a frame it would cost more than the
//   convolutions); an int counter per frame (atomicAdd after
//   __threadfence()) picks the block that finishes the frame's last tile,
//   and that block sums the bias and the partials in a fixed order.  K1 and
//   K4 take the same tile size at the same batch and sum each frame alike,
//   so their z agree bit for bit too.
// * PassPlan.tile_plan picks K4's tile size and F with its cost model
//   (core/passplan.py: tile_cost), which charges each pass the chain of
//   its busiest thread beside the issue slots of its warps.
//
// C interface: miniconv_encoder_launch, one array of int64 (enum Arg),
// called from repro_torch/kernels/miniconv_pass.py through _build.launch.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxGroup = 4;       // PassPlan: FRAMES_PER_ITEM
constexpr int kThreads = 256;      // PassPlan: ENCODER_THREADS
constexpr int kMinBlocks = 2;      // PassPlan: MAX_BLOCKS_PER_SM
constexpr int kHeaderInts = 15;    // tile header ints in the descriptor
constexpr int kLayerInts = 25;     // ints per layer in the descriptor

enum Act { kRelu = 0, kSigmoid = 1, kLinear = 2 };

struct Layer {
  // geometry of the whole frame
  int kernel, stride, c_in, c_out, in_h, in_w, out_h, out_w, act;
  // one tile's output region: ext_h x ext_w from
  // (ty * mul_h - add_h, tx * mul_w - add_w); `row` floats a region row,
  // its columns split by phase modulo next_stride (0: the last layer,
  // whose region is the tile, HWC, one slot per frame of the item); a
  // pass's frames lie ext_h * row * c_out floats apart
  int ext_h, ext_w, row, next_stride, mul_h, add_h, mul_w, add_w;
  int pix, co_block, co_pad;  // register tile: pix x co_block accumulators
  int w_off, b_off, out_off;  // shared-memory offsets, floats
  // (kernel, kernel, c_in, c_out) HWIO, staged at w_off; with w_off < 0
  // read in place, padded by the caller to (kernel, kernel, c_in, co_pad)
  const float* w;
  const float* b;             // (c_out,)
};

struct Params {
  Layer layers[kMaxLayers];
  int n_layers;
  int tile_h, tile_w, tiles_y, tiles_x, group;
  int frames;                 // frames of one layer pass (K1: 1)
  int in_ext_h, in_ext_w, in_row, in_mul_h, in_add_h, in_mul_w, in_add_w;
  int in_off;                 // the input buffer, `frames` frames
  const float* x;             // (B, in_h, in_w, c_in) NHWC
  float* feats;               // (B, out_h, out_w, c_out) of the last layer
  float* z;                   // (B, head_dim) or null
  float* partial;             // (B, n_tiles, head_parts, head_dim) with z
  int* done;                  // zeros: (B,) frame counts when z is set,
                              // then K4's item counter
  const float* head_w;        // (F, head_dim), F = out_h * out_w * c_out
  const float* head_b;        // (head_dim,) or null
  int head_dim, head_act;
  int head_parts;             // runs of a tile's features the head splits
  long long batch;
  long long n_items;          // ceil(batch / group) * tiles_y * tiles_x
};

// An item: one tile of `nf` consecutive frames from n0.
struct Item {
  long long n0;
  int nf, t, ty, tx;
};

__device__ __forceinline__ Item item_of(const Params& p, long long s) {
  const int n_tiles = p.tiles_y * p.tiles_x;
  const long long g = s / n_tiles;
  Item it;
  it.t = static_cast<int>(s - g * n_tiles);
  it.ty = it.t / p.tiles_x;
  it.tx = it.t - it.ty * p.tiles_x;
  it.n0 = g * p.group;
  const long long left = p.batch - it.n0;
  it.nf = left < p.group ? static_cast<int>(left) : p.group;
  return it;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-v));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 fills the 4 bytes with zeros and reads nothing.
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Issues the cp.async copies of every layer's weights (zero past c_out;
// unless they are read in place) and bias into shared memory: 16 bytes at
// a time where the staged rows are the device rows (co_pad == c_out).
// The caller commits and waits.
__device__ void stage_weights(const Params& p, float* smem) {
  for (int l = 0; l < p.n_layers; ++l) {
    const Layer& L = p.layers[l];
    if (L.w_off >= 0) {
      const int n = L.kernel * L.kernel * L.c_in * L.co_pad;
      if (L.co_pad == L.c_out) {
        for (int idx = 4 * threadIdx.x; idx < n; idx += 4 * kThreads)
          cp_async16(smem + L.w_off + idx, L.w + idx);
      } else {
        for (int idx = threadIdx.x; idx < n; idx += kThreads) {
          const int co = idx % L.co_pad;
          const int tc = idx / L.co_pad;  // (tap, c_in) row
          const bool ok = co < L.c_out;
          cp_async4(smem + L.w_off + idx, L.w + (ok ? tc * L.c_out + co : 0),
                    ok);
        }
      }
    }
    for (int co = threadIdx.x; co < L.co_pad; co += kThreads)
      cp_async4(smem + L.b_off + co, L.b + (co < L.c_out ? co : 0),
                co < L.c_out);
  }
}

// Issues the cp.async copies of the input regions of frames n .. n+nf-1
// under tile (ty, tx) into `dst` (per frame CHW, rows split by phase
// modulo the first layer's stride; the frames one after the other), zeros
// outside the frame.  Warp w copies (frame, row) pairs w, w + 8, ..., its
// lanes neighbouring columns, so no copy divides.  The caller commits and
// waits.
__device__ void fetch_input(const Params& p, long long n, int nf, int ty,
                            int tx, float* dst) {
  const Layer& L = p.layers[0];
  const int C = L.c_in, S = L.stride, Eh = p.in_ext_h, Ew = p.in_ext_w;
  const int iy0 = ty * p.in_mul_h - p.in_add_h;
  const int ix0 = tx * p.in_mul_w - p.in_add_w;
  const long long frame_len = L.in_h * L.in_w * static_cast<long long>(C);
  const int plane = Eh * p.in_row, half = p.in_row / S;
  const int lane = threadIdx.x & 31;
  for (int fr = threadIdx.x >> 5; fr < nf * Eh; fr += kThreads / 32) {
    const int f = fr / Eh, r = fr - f * Eh;
    const float* frame = p.x + (n + f) * frame_len;
    const int gy = iy0 + r;
    const bool row_ok = gy >= 0 && gy < L.in_h;
    const float* src_row = frame + static_cast<long long>(gy) * L.in_w * C;
    float* dst_row = dst + f * plane * C + r * p.in_row;
    for (int col = lane; col < Ew; col += 32) {
      const int gx = ix0 + col;
      const bool ok = row_ok && gx >= 0 && gx < L.in_w;
      const float* src = ok ? src_row + gx * C : frame;
      float* d = dst_row + (col % S) * half + col / S;
      for (int c = 0; c < C; ++c)
        cp_async4(d + c * plane, src + (ok ? c : 0), ok);
    }
  }
}

// One layer over one tile's output region of `nf` frames.  `in` holds the
// previous region of each frame (CHW, in_row floats a row split by phase
// modulo this layer's stride; frames in_plane * c_in floats apart);
// `smem` holds the staged bias and weights; (oy0, ox0) is the region's
// first output position in the layer's output.  A task is (frame, pixel
// group, channel block): the frames' pixels are numbered one frame after
// the other and cut into groups like one region's.  An intermediate layer
// writes each frame's region to `out` (CHW, split for the next layer),
// zero where it lies outside the layer's output.  The last layer (feats
// != null) writes the tile's positions inside the frame to `feats` (the
// first frame's NHWC features; the next frames follow) and to `out`, the
// frames' HWC slots (zero outside), for the head.
template <int P, int CB, bool kStaged>
__device__ void conv_region(const Layer& L, const float* in, int in_row,
                            int in_plane, const float* smem, int oy0,
                            int ox0, float* out, float* feats, int nf) {
  // weights staged in shared memory, or read in place from device memory:
  // two instantiations, so that the hot loop's loads are of one kind
  const float* ws = kStaged ? smem + L.w_off : L.w;
  const float* bs = smem + L.b_off;
  // the layer's fields in registers: the loops below read no parameter
  const int K = L.kernel, S = L.stride, C = L.c_in, c_out = L.c_out;
  const int ext_h = L.ext_h, ext_w = L.ext_w, out_h = L.out_h;
  const int out_w = L.out_w, co_pad = L.co_pad, act = L.act;
  const int row = L.row, NS = L.next_stride;
  const int n_pix = ext_h * ext_w;
  const int all_pix = nf * n_pix;
  const int groups = (all_pix + P - 1) / P;
  const int tasks = groups * (co_pad / CB);
  const int in_half = in_row / S;
  const int in_frame = in_plane * C;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int cb = task / groups;
    const int g = task - cb * groups;
    int base[P], pix[P];
    bool live[P];
    bool any = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int px = g + k * groups;  // pixels groups apart: lanes adjacent
      const bool ok = px < all_pix;
      pix[k] = ok ? px : -1;
      const int f = ok ? px / n_pix : 0;
      const int lp = ok ? px - f * n_pix : 0;
      const int py = lp / ext_w;
      const int pxx = lp - py * ext_w;
      const int gy = oy0 + py, gx = ox0 + pxx;
      live[k] = ok && gy >= 0 && gy < out_h && gx >= 0 && gx < out_w;
      any |= live[k];
      // input column pxx * S + j sits at phase j % S, index pxx + j / S
      base[k] = f * in_frame + py * S * in_row + pxx;
    }
    float acc[P][CB];
    if (any) {
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int q = 0; q < CB; ++q) acc[k][q] = bs[cb * CB + q];
      for (int i = 0; i < K; ++i) {
        for (int j = 0; j < K; ++j) {
          const float* wt = ws + (i * K + j) * C * co_pad + cb * CB;
          const float* src = in + i * in_row + (j % S) * in_half + j / S;
#pragma unroll 4
          for (int c = 0; c < C; ++c) {
            float v[P];
#pragma unroll
            for (int k = 0; k < P; ++k) v[k] = src[c * in_plane + base[k]];
            float wv[CB];
#pragma unroll
            for (int q = 0; q < CB; q += 4) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(wt + c * co_pad + q);
              wv[q] = w4.x;
              wv[q + 1] = w4.y;
              wv[q + 2] = w4.z;
              wv[q + 3] = w4.w;
            }
#pragma unroll
            for (int k = 0; k < P; ++k)
#pragma unroll
              for (int q = 0; q < CB; ++q)
                acc[k][q] = fmaf(v[k], wv[q], acc[k][q]);
          }
        }
      }
    }
    const int out_plane = ext_h * row;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (pix[k] < 0) continue;
      const int f = pix[k] / n_pix;
      const int lp = pix[k] - f * n_pix;
      const int py = lp / ext_w;
      const int pxx = lp - py * ext_w;
      const int at = NS ? py * row + (pxx % NS) * (row / NS) + pxx / NS : 0;
      float* o = out + f * out_plane * c_out;
      float* fo = feats == nullptr
                      ? nullptr
                      : feats + static_cast<long long>(f) * out_h * out_w *
                                    c_out;
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        const int co = cb * CB + q;
        if (co >= c_out) continue;
        const float v = live[k] ? activate(acc[k][q], act) : 0.0f;
        if (fo == nullptr) {
          o[co * out_plane + at] = v;
        } else {
          o[lp * c_out + co] = v;
          if (live[k])
            fo[((oy0 + py) * out_w + ox0 + pxx) * c_out + co] = v;
        }
      }
    }
  }
}

template <int P, int CB>
__device__ void conv_layer(const Layer& L, const float* in, int in_row,
                           int in_plane, const float* smem, int oy0, int ox0,
                           float* out, float* feats, int nf) {
  if (L.w_off >= 0)
    conv_region<P, CB, true>(L, in, in_row, in_plane, smem, oy0, ox0, out,
                             feats, nf);
  else
    conv_region<P, CB, false>(L, in, in_row, in_plane, smem, oy0, ox0, out,
                              feats, nf);
}

__device__ void run_layer(const Layer& L, const float* in, int in_row,
                          int in_plane, const float* smem, int oy0, int ox0,
                          float* out, float* feats, int nf) {
  switch (L.pix * 100 + L.co_block) {  // PassPlan: TASK_SHAPES
    case 208:
      conv_layer<2, 8>(L, in, in_row, in_plane, smem, oy0, ox0, out, feats,
                       nf);
      break;
    case 116:
      conv_layer<1, 16>(L, in, in_row, in_plane, smem, oy0, ox0, out, feats,
                        nf);
      break;
    case 108:
      conv_layer<1, 8>(L, in, in_row, in_plane, smem, oy0, ox0, out, feats,
                       nf);
      break;
    case 204:
      conv_layer<2, 4>(L, in, in_row, in_plane, smem, oy0, ox0, out, feats,
                       nf);
      break;
    default:  // 104; the launcher refuses any other shape
      conv_layer<1, 4>(L, in, in_row, in_plane, smem, oy0, ox0, out, feats,
                       nf);
      break;
  }
}

// Layer l of one pass: frames j .. j+nf-1 of item `it`, layer 0 from the
// staged input regions `x_in`; the last layer's tiles land in the frames'
// slots.  All threads of the block call this, and it ends with them in
// step.  Each kernel calls it from one loop over the layers, so that its
// register-tile instantiations are inlined once.
__device__ void encode_layer(const Params& p, float* smem, const float* x_in,
                             const Item& it, int j, int nf, int l) {
  const Layer& L = p.layers[l];
  const float* in = x_in;
  int in_row = p.in_row, in_plane = p.in_ext_h * p.in_row;
  if (l > 0) {
    const Layer& Q = p.layers[l - 1];
    in = smem + Q.out_off;
    in_row = Q.row;
    in_plane = Q.ext_h * Q.row;
  }
  float* out = smem + L.out_off;
  float* feats = nullptr;
  if (l == p.n_layers - 1) {
    out += j * p.tile_h * p.tile_w * L.c_out;
    feats = p.feats + (it.n0 + j) * L.out_h * L.out_w *
                          static_cast<long long>(L.c_out);
  }
  run_layer(L, in, in_row, in_plane, smem, it.ty * L.mul_h - L.add_h,
            it.tx * L.mul_w - L.add_w, out, feats, nf);
  __syncthreads();  // the region is the next layer's input
}

// The projection's share of item `it`, once all its frames' tiles sit in
// their slots.  The tile's features split into head_parts consecutive
// runs; thread (part, lane) multiplies its run of each frame's features
// by their rows of W, 4 columns a lane (16-byte loads) where D allows, in
// ascending feature order, each W element read once for all the item's
// frames, and stores one partial per (frame, tile, part).  The block that
// completes a frame's last tile then sums the bias and the frame's
// partials in (tile, part) order.
__device__ void head_item(const Params& p, const float* smem, const Item& it) {
  __shared__ int last_of[kMaxGroup];
  __shared__ __align__(16) float red[4 * kThreads];  // run sums, chunk x D
  const int n_tiles = p.tiles_y * p.tiles_x;
  const Layer& fin = p.layers[p.n_layers - 1];
  const int D = p.head_dim, C = fin.c_out, parts = p.head_parts;
  const int gy0 = it.ty * p.tile_h, gx0 = it.tx * p.tile_w;
  const int vh = min(p.tile_h, fin.out_h - gy0);
  const int run = min(p.tile_w, fin.out_w - gx0) * C;
  const int slot = p.tile_h * p.tile_w * C;
  const float* tiles = smem + fin.out_off;
  const bool vec = (D & 3) == 0;
  const int lanes = vec ? D >> 2 : D;
  const int n_feat = vh * run;
  for (int u = threadIdx.x; u < lanes * parts; u += kThreads) {
    const int part = u / lanes;
    const int ln = u - part * lanes;
    const int col = vec ? ln << 2 : ln;
    const int e0 = part * n_feat / parts, e1 = (part + 1) * n_feat / parts;
    float4 acc[kMaxGroup];
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) acc[j] = make_float4(0, 0, 0, 0);
    int py = e0 / run, e = e0 - py * run;
    const float* w = p.head_w + col;
    for (int k = e0; k < e1; ++k) {
      const long long f =
          (static_cast<long long>(gy0 + py) * fin.out_w + gx0) * C + e;
      const float* fv = tiles + py * p.tile_w * C + e;
      if (vec) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + f * D));
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j) {
          if (j < it.nf) {
            const float a = fv[j * slot];
            acc[j].x = fmaf(a, w4.x, acc[j].x);
            acc[j].y = fmaf(a, w4.y, acc[j].y);
            acc[j].z = fmaf(a, w4.z, acc[j].z);
            acc[j].w = fmaf(a, w4.w, acc[j].w);
          }
        }
      } else {
        const float w1 = __ldg(w + f * D);
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j)
          if (j < it.nf) acc[j].x = fmaf(fv[j * slot], w1, acc[j].x);
      }
      if (++e == run) {
        e = 0;
        ++py;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j >= it.nf) continue;
      float* dst = p.partial +
                   (((it.n0 + j) * n_tiles + it.t) * parts + part) * D + col;
      if (vec)
        *reinterpret_cast<float4*>(dst) = acc[j];
      else
        *dst = acc[j].x;
    }
  }
  __threadfence();  // the partials are visible before the counts say so
  __syncthreads();
  if (threadIdx.x < it.nf)
    last_of[threadIdx.x] =
        atomicAdd(p.done + it.n0 + threadIdx.x, 1) == n_tiles - 1;
  __syncthreads();
  // The frame's partials in (tile, part) order, cut into `chunks`
  // consecutive runs, one per group of `lanes` threads when more than one
  // group fits the block; each run summed in order, then the runs in order
  // onto the bias.
  const int n_parts = n_tiles * parts;
  const int chunks = 2 * lanes > kThreads ? 1 : kThreads / lanes;
  for (int j = 0; j < it.nf; ++j) {
    if (!last_of[j]) continue;
    __threadfence();
    const long long n = it.n0 + j;
    const float* src = p.partial + n * n_parts * static_cast<long long>(D);
    if (chunks == 1) {
      for (int d = threadIdx.x; d < D; d += kThreads) {
        float acc = p.head_b ? __ldg(p.head_b + d) : 0.0f;
#pragma unroll 16
        for (int k = 0; k < n_parts; ++k) acc += __ldcg(src + k * D + d);
        p.z[n * D + d] = activate(acc, p.head_act);
      }
      continue;
    }
    for (int u = threadIdx.x; u < lanes * chunks; u += kThreads) {
      const int ch = u / lanes;
      const int ln = u - ch * lanes;
      const int k0 = ch * n_parts / chunks, k1 = (ch + 1) * n_parts / chunks;
      if (vec) {
        const int col = ln << 2;
        float4 acc = make_float4(0, 0, 0, 0);
#pragma unroll 16
        for (int k = k0; k < k1; ++k) {
          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(src + k * D + col));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        *reinterpret_cast<float4*>(red + ch * D + col) = acc;
      } else {
        float acc = 0.0f;
#pragma unroll 16
        for (int k = k0; k < k1; ++k) acc += __ldcg(src + k * D + ln);
        red[ch * D + ln] = acc;
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc = p.head_b ? __ldg(p.head_b + d) : 0.0f;
      for (int ch = 0; ch < chunks; ++ch) acc += red[ch * D + d];
      p.z[n * D + d] = activate(acc, p.head_act);
    }
    __syncthreads();  // `red` is free for the next frame
  }
}

// K1: one block per item (group 1: one tile of one frame).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    encoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item it = item_of(p, blockIdx.x);
  fetch_input(p, it.n0, 1, it.ty, it.tx, smem + p.in_off);
  stage_weights(p, smem);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int l = 0; l < p.n_layers; ++l)
    encode_layer(p, smem, smem + p.in_off, it, 0, 1, l);
  if (p.z != nullptr) head_item(p, smem, it);
}

// K4: gridDim.x resident blocks walk the items: block k starts with item
// k, and each block that finishes an item takes the next one nobody has
// taken (an int counter after the frames' `done` counts), so a block that
// reduces a frame's projection delays no other block's items.  Each
// item's frames run `frames` at a time, one pass of every layer each.  The
// next pass's input regions (of this item or the next) land in the input
// buffer as soon as this pass's first layer has read it.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    encoder_stream_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long next_item;
  float* const in = smem + p.in_off;
  long long s = blockIdx.x;
  int j = 0;
  Item it = item_of(p, s < p.n_items ? s : 0);
  if (s < p.n_items)
    fetch_input(p, it.n0, min(p.frames, it.nf), it.ty, it.tx, in);
  stage_weights(p, smem);
  cp_async_commit();
  while (s < p.n_items) {
    const int nf = min(p.frames, it.nf - j);
    const bool ends_item = j + nf == it.nf;
    long long s2 = s;
    int j2 = j + nf;
    if (ends_item) {
      if (threadIdx.x == 0)
        next_item = gridDim.x + atomicAdd(p.done + p.batch, 1);
      __syncthreads();
      s2 = next_item;
      j2 = 0;
    }
    const bool more = s2 < p.n_items;
    const Item it2 = item_of(p, more ? s2 : s);
    cp_async_wait<0>();  // this pass's regions have landed
    __syncthreads();
    for (int l = 0; l < p.n_layers; ++l) {
      encode_layer(p, smem, in, it, j, nf, l);
      if (l == 0 && more) {  // the first layer has read the buffer
        fetch_input(p, it2.n0 + j2, min(p.frames, it2.nf - j2), it2.ty,
                    it2.tx, in);
        cp_async_commit();
      }
    }
    if (ends_item && p.z != nullptr) head_item(p, smem, it);
    __syncthreads();  // the regions are free before the next pass
    s = s2;
    j = j2;
    it = it2;
  }
  cp_async_wait<0>();
}

bool valid_shape(int pix, int co_block) {
  return (pix == 1 && (co_block == 4 || co_block == 8 || co_block == 16)) ||
         (pix == 2 && (co_block == 4 || co_block == 8));
}

// The launch's arguments, packed by the wrapper into one array of int64.
enum Arg {
  kX, kFeats, kZ, kPartial, kDone,  // device pointers (z, partial, done 0
                                    // for none)
  kDesc,                            // host address of the int32 descriptor
  kNLayers,
  kWeights,                         // kMaxLayers device pointers each,
  kBiases = kWeights + kMaxLayers,  // the first n_layers used
  kHeadW = kBiases + kMaxLayers, kHeadB,
  kHeadDim, kHeadAct, kHeadParts, kBatch,
  kBlocks,                          // 0: K1; >= 1: K4's persistent blocks
  kSmemBytes, kDevice, kStream,
  kNArgs
};

}  // namespace

// a: the kNArgs launch arguments in the order of `enum Arg`.  desc:
// kHeaderInts tile ints (tile_h, tile_w, tiles_y, tiles_x, group,
// in_ext_h, in_ext_w, in_row, in_mul_h, in_add_h, in_mul_w, in_add_w,
// in_off, smem_floats, frames), then kLayerInts per layer: the geometry
// (kernel, stride, c_in, c_out, in_h, in_w, out_h, out_w, pad_top,
// pad_left, act) and the tile (ext_h, ext_w, row, next_stride, mul_h,
// add_h, mul_w, add_w, pix, co_block, co_pad, w_off, b_off, out_off), all
// from PassPlan.tile_plan.  z, head_w and head_b may be null (no epilogue;
// no bias); with z, `partial` holds batch * tiles * head_parts * head_dim
// floats and `done` batch zeroed ints.  blocks 0 launches K1 (group 1);
// blocks >= 1 launches K4 with that many persistent blocks (at most one
// per item), `desc` then carrying up to kMaxGroup frames an item and
// passes of 1 .. group frames, and `done` holding batch + 1 zeroed ints,
// with or without z.  Launches on the stream and returns
// cudaGetLastError().
extern "C" int miniconv_encoder_launch(const long long* a) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int n_layers = static_cast<int>(a[kNLayers]),
            blocks = static_cast<int>(a[kBlocks]),
            smem_bytes = static_cast<int>(a[kSmemBytes]),
            device = static_cast<int>(a[kDevice]);
  const long long batch = a[kBatch];
  if (n_layers < 1 || n_layers > kMaxLayers || blocks < 0 || batch < 0 ||
      a[kHeadParts] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  const int* h = static_cast<const int*>(ptr(kDesc));
  p.tile_h = h[0];
  p.tile_w = h[1];
  p.tiles_y = h[2];
  p.tiles_x = h[3];
  p.group = h[4];
  p.in_ext_h = h[5];
  p.in_ext_w = h[6];
  p.in_row = h[7];
  p.in_mul_h = h[8];
  p.in_add_h = h[9];
  p.in_mul_w = h[10];
  p.in_add_w = h[11];
  p.in_off = h[12];
  p.frames = h[14];
  if (h[13] * 4 != smem_bytes || p.group < 1 || p.group > kMaxGroup ||
      p.frames < 1 || p.frames > p.group || (blocks == 0 && p.group != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers; ++l) {
    const int* d = h + kHeaderInts + l * kLayerInts;
    Layer& L = p.layers[l];
    L.kernel = d[0];
    L.stride = d[1];
    L.c_in = d[2];
    L.c_out = d[3];
    L.in_h = d[4];
    L.in_w = d[5];
    L.out_h = d[6];
    L.out_w = d[7];
    // d[8], d[9]: pad_top, pad_left, folded into the region origins
    L.act = d[10];
    L.ext_h = d[11];
    L.ext_w = d[12];
    L.row = d[13];
    L.next_stride = d[14];
    L.mul_h = d[15];
    L.add_h = d[16];
    L.mul_w = d[17];
    L.add_w = d[18];
    L.pix = d[19];
    L.co_block = d[20];
    L.co_pad = d[21];
    L.w_off = d[22];
    L.b_off = d[23];
    L.out_off = d[24];
    L.w = static_cast<const float*>(ptr(kWeights + l));
    L.b = static_cast<const float*>(ptr(kBiases + l));
    if (!valid_shape(L.pix, L.co_block) || L.co_pad % L.co_block ||
        (L.w_off >= 0 && L.w_off % 4) ||
        (L.next_stride != 0) != (l < n_layers - 1))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_layers = n_layers;
  p.x = static_cast<const float*>(ptr(kX));
  p.feats = static_cast<float*>(ptr(kFeats));
  p.z = static_cast<float*>(ptr(kZ));
  p.partial = static_cast<float*>(ptr(kPartial));
  p.done = static_cast<int*>(ptr(kDone));
  p.head_w = static_cast<const float*>(ptr(kHeadW));
  p.head_b = static_cast<const float*>(ptr(kHeadB));
  p.head_dim = static_cast<int>(a[kHeadDim]);
  p.head_act = static_cast<int>(a[kHeadAct]);
  p.head_parts = static_cast<int>(a[kHeadParts]);
  p.batch = batch;
  p.n_items = (batch + p.group - 1) / p.group * p.tiles_y * p.tiles_x;
  if ((p.z != nullptr && (p.partial == nullptr || p.done == nullptr)) ||
      (blocks > 0 && p.done == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.n_items == 0) return 0;
  if (blocks == 0 && p.n_items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      blocks > 0 ? reinterpret_cast<const void*>(encoder_stream_kernel)
                 : reinterpret_cast<const void*>(encoder_kernel);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[kStream]);
  if (blocks > 0) {
    const long long grid = blocks < p.n_items ? blocks : p.n_items;
    encoder_stream_kernel<<<static_cast<int>(grid), kThreads, smem_bytes,
                            s>>>(p);
  } else {
    encoder_kernel<<<static_cast<int>(p.n_items), kThreads, smem_bytes, s>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}
