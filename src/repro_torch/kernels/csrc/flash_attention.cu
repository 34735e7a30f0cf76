// K5: causal online-softmax (flash) attention over (B, H, S, D), with an
// optional sliding window, for f32 or bf16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention -> _flash_kernel (Pallas; grid (batch, head, q_block,
// kv_block) with the kv axis sequential and the running max, normaliser
// and accumulator in fp32 VMEM scratch).  It computes what that kernel
// computes, not its block schedule: q is scaled by `scale` before the
// product; a key k is seen by query q when k <= q (causal) and k > q -
// window (window > 0); the softmax runs online in fp32; the output is the
// accumulator over max(l, 1e-30), written in the inputs' dtype (bf16 with
// __float2bfloat16, round to nearest even).
//
// What bounds it on an H100: at prefill lengths, operations.  The causal
// pairs of (1, 16, 4096, 128) take 68.7 GFLOP, 0.07 ms at the 989 TFLOP/s
// of bf16 tensor cores.  At the served length (S = 128) it moves 2 MB, a
// bound of under a microsecond, and a launch costs more than its work.
//
// The design is the simple right one.  One block of 8 warps takes 64
// query rows of one (batch, head), 8 rows a warp, and walks 64-row K/V
// tiles staged in shared memory as fp32 (Q and K rows padded by 4 floats,
// so a warp's float4 reads of 32 different K rows hit distinct banks).
// For the scores each lane owns two keys of the tile and reads the warp's
// query rows as broadcasts; the row max is a warp shuffle reduction.  The
// probabilities go through a per-warp buffer in shared memory, and for P.V
// each lane owns the output columns lane, lane + 32, ...  Tiles wholly
// above the causal diagonal or wholly outside the window are never
// loaded; a masked pair inside a tile contributes exactly p = 0 (the
// Pallas kernel's -1e30 trick, which needs a later tile to wipe a row's
// all-masked start, is not carried over).  Every sum runs in a fixed
// order, so a run repeats bit for bit.
//
// What it leaves on the table: scores and P.V are fp32 FMAs on the CUDA
// cores (67 TFLOP/s), not wgmma on the tensor cores; tiles are loaded by
// the threads, synchronously, not by TMA or cp.async behind a pipeline;
// at D = 128 a block takes 114 KB of shared memory, so one block runs per
// SM; and GQA heads are repeated by the caller rather than mapped here.
//
// C interface, bound with ctypes by repro_torch/kernels/flash_attention.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // key / value rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one head's (S, D) matrix into shared memory as
// fp32 times `mul`, row stride `ld`; rows at or past S become zeros.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int S,
                          int D, float mul) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    float x[8];
    if (row0 + r < S) {
      load8(src + static_cast<long long>(row0 + r) * D + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
    out[0] = make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    out[1] = make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool sees(int qp, int kp, int S, int causal,
                                     int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2ull * kBlockQ * (D + 4) + 1ull * kBlockK * D +
                          1ull * kWarps * kRows * kBlockK);
}

// NC: output columns per lane, ceil(D / 32) rounded up to 1, 2, 4 or 8.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int S,
                 int D, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;
  float* qs = smem;                   // (64, ld), pre-scaled
  float* ks = qs + kBlockQ * ld;      // (64, ld)
  float* vs = ks + kBlockK * ld;      // (64, D)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* pw = vs + kBlockK * D + warp * kRows * kBlockK;  // (8, 64) per warp

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;  // heaviest first
  const long long head =
      (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * S * D;
  const int r0 = warp * kRows;

  load_tile(qs, ld, q + head, q0, S, D, scale);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this lane's share of the row's normaliser
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // KV tiles that hold a key some row of this block sees.
  const int q_last = min(q0 + kBlockQ - 1, S - 1);
  int t_hi = (S + kBlockK - 1) / kBlockK;
  if (causal) t_hi = min(t_hi, q_last / kBlockK + 1);
  const int t_lo = window > 0 ? max(q0 - window + 1, 0) / kBlockK : 0;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    load_tile(ks, ld, k + head, k0, S, D, 1.f);
    load_tile(vs, D, v + head, k0, S, D, 1.f);
    __syncthreads();

    // scores of the warp's rows against keys k0 + lane and k0 + lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = ks + lane * ld;
    const float* kb = ks + (lane + 32) * ld;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ka + d);
      const float4 b = *reinterpret_cast<const float4*>(kb + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qs + (r0 + r) * ld + d);
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, b.x, s[r][1]);
        s[r][1] = fmaf(x.y, b.y, s[r][1]);
        s[r][1] = fmaf(x.z, b.z, s[r][1]);
        s[r][1] = fmaf(x.w, b.w, s[r][1]);
      }
    }

    // online softmax; masked pairs give p = 0 exactly
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
      const bool see0 = sees(qp, k0 + lane, S, causal, window);
      const bool see1 = sees(qp, k0 + lane + 32, S, causal, window);
      const float mx = warp_max(fmaxf(see0 ? s[r][0] : -INFINITY,
                                      see1 ? s[r][1] : -INFINITY));
      const float m_new = fmaxf(m[r], mx);
      // nothing summed yet while m is -inf: alpha only scales zeros
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      const float p0 = see0 ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = see1 ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * alpha + p0 + p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

    // P.V: this lane's output columns lane + 32 c (clamped for D < 32 NC;
    // the clamped columns are never written)
    int col[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) col[c] = min(lane + 32 * c, D - 1);
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[jj][c] = vs[(j + jj) * D + col[c]];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(p.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vv[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lsum = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    T* orow = o + head + static_cast<long long>(qp) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / lsum);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, S, D, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int S, int D, int causal, int window, float scale,
             cudaStream_t stream) {
  const int nc = (D + 31) / 32;
  if (nc <= 1) return launch<T, 1>(q, k, v, o, B, H, S, D, causal, window, scale, stream);
  if (nc <= 2) return launch<T, 2>(q, k, v, o, B, H, S, D, causal, window, scale, stream);
  if (nc <= 4) return launch<T, 4>(q, k, v, o, B, H, S, D, causal, window, scale, stream);
  return launch<T, 8>(q, k, v, o, B, H, S, D, causal, window, scale, stream);
}

}  // namespace

// q, k, v, o: (B, H, S, D) contiguous, all of one dtype (0: f32, 1: bf16),
// 16-byte aligned; D a multiple of 8 up to 256; window <= 0 for none.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int S, int D, int causal, int window,
                                      float scale, int dtype, int device,
                                      void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 256 || B < 0 || H < 0 || S < 0 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, S, D, causal, window, scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, S, D, causal, window,
                                 scale, st);
}
