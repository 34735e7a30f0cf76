// K5: causal online-softmax (flash) attention over (B, H, S, D), with an
// optional sliding window and grouped KV heads, for f32 or bf16 inputs, and
// values of their own width D_v <= D (multi-head latent attention: query
// and key heads of 192, values of 128) on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention -> _flash_kernel (Pallas; grid (batch, head, q_block,
// kv_block) with the kv axis sequential and the running max, normaliser
// and accumulator in fp32 VMEM scratch).  It computes what that kernel
// computes, not its block schedule: the scores q.k times D**-0.5 in fp32;
// a key k is seen by query q when k <= q (causal) and k > q - window
// (window > 0); the softmax runs online in fp32; the output is the
// accumulator over max(l, 1e-30), written in the inputs' dtype (bf16 with
// round to nearest even).
//
// Both routes read q, k, v and write o through element strides for batch,
// head and sequence (the last dim is unit-stride), so a (B, S, H, D)
// projection is read in place, and take H_kv KV heads with H % H_kv == 0:
// query head h reads KV head h / (H / H_kv), which is what repeating the
// KV heads builds.  The wrapper (kernels/flash_attention.py) picks the
// route from the dtype and D alone:
//
// * The tensor-core route (bf16, D <= 128; or D_v != D, D <= 192 and
//   D_v <= 128), flash_kernel_tc<NWG, DQ, DV>.  What bounds
//   it on an H100: at prefill lengths, operations (the causal pairs of
//   (1, 16, 4096, 128) are 68.7 GFLOP, 0.07 ms at the 989 TFLOP/s of bf16
//   wgmma); at the served length (S = 128) bytes, under a microsecond, so
//   there a launch's latency is the cost.  Design: a block takes 64 query
//   rows per consumer warpgroup (two warpgroups, 128 rows, when the grid
//   of 128-row blocks fills the SMs, else one) and one producer warp.
//   The producer loads the Q tile once and K/V tiles of 128 keys by TMA
//   (cp.async.bulk.tensor, 4-d tensor maps over the strided views, 128-byte
//   swizzle, D zero-padded to DQ = 64, 128 or 192 and D_v to DV = 64 or
//   128, a ragged last tile zero-filled by TMA's out-of-bounds fill) into a
//   two-stage ring completed on mbarriers, so the next tile is in flight
//   while the consumers compute.  With D_v != D a V tile is narrower than
//   a K tile: Q.K^T runs DQ / 16 wgmma steps deep, P.V and the output DV
//   wide (DQ 192, DV 128: 209 KB of shared memory at two warpgroups).
//   Each consumer warpgroup computes S = Q.K^T with wgmma from shared
//   memory into fp32 registers, scales the fp32 scores by
//   D**-0.5 * log2(e) and runs the online softmax on the fragments (a
//   row's max and sum over the four threads that hold it), rounds P to
//   bf16 in registers and accumulates O += P.V with wgmma, P as the
//   register operand and V transposed from shared memory.  P never
//   touches shared memory.  Tiles wholly above the diagonal or outside the
//   window are never loaded; masked pairs give p = 0 exactly.
// * The CUDA-core route (f32 at any D, and bf16 at 128 < D <= 256, both
//   with D_v = D alone), flash_kernel: fp32 FMAs, as ported first.  wgmma has no fp32 mode, and
//   TF32 would break the 2e-4 agreement the f32 checks rest on.  One block
//   of 8 warps takes 64 query rows, 8 a warp, and walks 64-row K/V tiles
//   staged in shared memory as fp32 (Q pre-scaled); each lane owns two
//   keys of a tile for the scores and output columns lane + 32 c for P.V;
//   the probabilities go through a per-warp buffer in shared memory.
//
// Every sum on both routes runs in a fixed order, so a run repeats bit for
// bit.  C interface: flash_attention_launch, one array of int64 (enum Arg),
// called from kernels/flash_attention.py through _build.launch.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is
                   // reached through cudaGetDriverEntryPoint, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

// Element strides of one tensor's batch, head and sequence dims.
struct Strides {
  long long b, h, s;
};

// ===========================================================================
// The CUDA-core route
// ===========================================================================

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

// Rows [row0, row0 + 64) of one head's (S, D) matrix, row stride `stride`
// elements, into shared memory as fp32 times `mul`, row stride `ld`; rows
// at or past S become zeros.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, long long stride,
                          int row0, int S, int D, float mul) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    float x[8];
    if (row0 + r < S) {
      load8(src + static_cast<long long>(row0 + r) * stride + c, x);
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
                 const T* __restrict__ v, T* __restrict__ o, Strides qst,
                 Strides kst, Strides vst, Strides ost, int n_rep, int S,
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
  const int b = blockIdx.z, h = blockIdx.y, hk = h / n_rep;
  const T* qh = q + b * qst.b + h * qst.h;
  const T* kh = k + b * kst.b + hk * kst.h;
  const T* vh = v + b * vst.b + hk * vst.h;
  const int r0 = warp * kRows;

  load_tile(qs, ld, qh, qst.s, q0, S, D, scale);

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
    load_tile(ks, ld, kh, kst.s, k0, S, D, 1.f);
    load_tile(vs, D, vh, vst.s, k0, S, D, 1.f);
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

  T* oh = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lsum = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    T* orow = oh + static_cast<long long>(qp) * ost.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / lsum);
    }
  }
}

// Everything one launch of either route needs.
struct Problem {
  const void *q, *k, *v;
  void* o;
  Strides qst, kst, vst, ost;
  int B, H, H_kv, S, D, Dv, causal, window;
  float scale;
  cudaStream_t stream;
  int device;
};

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit once per device: `done`
// is one flag word per kernel, a bit per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The device's SM count, asked once; 0 when it cannot be read.
int sm_count(int device) {
  static std::atomic<int> cache[kMaxDevices];
  int n = cache[device].load(std::memory_order_relaxed);
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) ==
          cudaSuccess)
    cache[device].store(n);
  return n;
}

template <typename T, int NC>
int launch(const Problem& p) {
  // the widest D this instantiation serves sets its limit
  static std::atomic<unsigned long long> done{0};
  const size_t smem = smem_bytes(p.D);
  const cudaError_t err = allow_smem(flash_kernel<T, NC>,
                                     static_cast<int>(smem_bytes(32 * NC)),
                                     p.device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_kernel<T, NC><<<grid, kThreads, smem, p.stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<T*>(p.o), p.qst, p.kst, p.vst,
      p.ost, p.H / p.H_kv, p.S, p.D, p.causal, p.window, p.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Problem& p) {
  const int nc = (p.D + 31) / 32;
  if (nc <= 1) return launch<T, 1>(p);
  if (nc <= 2) return launch<T, 2>(p);
  if (nc <= 4) return launch<T, 4>(p);
  return launch<T, 8>(p);
}

// ===========================================================================
// The tensor-core route
// ===========================================================================

namespace tc {

constexpr int kBlockN = 128;  // keys a K/V tile
constexpr int kStages = 2;    // K/V tiles in the ring
constexpr int kChunk = 64;    // bf16 columns of one 128-byte swizzled row

// Shared memory of one block: the Q tile, then kStages (K, V) tile pairs,
// then the mbarriers.  A tile of R rows and padded width W is stored as
// W / 64 chunks of (R, 64) bf16, each a run of 128-byte rows in TMA's
// 128-byte swizzle, so every chunk starts on a 1024-byte boundary and
// wgmma reads it through a descriptor.  Q and K are DQ wide, V DV wide.
template <int NWG, int DQ, int DV>
struct Layout {
  static constexpr int kBlockM = 64 * NWG;
  static constexpr int kQBytes = kBlockM * DQ * 2;
  static constexpr int kKBytes = kBlockN * DQ * 2;  // one K tile
  static constexpr int kVBytes = kBlockN * DV * 2;  // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBars = kQBytes + kStages * kStageBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]; plus the
  // slack that aligns the base to 1024 bytes
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// Which of a tensor map's dims 1..3 holds the sequence, the head and the
// batch (dim 0 is D); the host orders them by stride.
struct MapDims {
  int s, h, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts about ten seconds traps, so a fault in the ring
// surfaces as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One TMA load of the box at (col, row, head, batch) into shared memory at
// `dst`, completed on the barrier `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, MapDims m,
                                         uint32_t dst, uint32_t bar, int col,
                                         int row, int head, int batch) {
  const int c1 = m.s == 1 ? row : (m.h == 1 ? head : batch);
  const int c2 = m.s == 2 ? row : (m.h == 2 ? head : batch);
  const int c3 = m.s == 3 ? row : (m.h == 3 ? head : batch);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Fetch a tensor map into the TMA unit's cache ahead of its first use.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the special-function unit (ex2.approx: relative error about
// 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D[64x128] (+)= A[64x16] * B[16x128], A and B from shared memory by
// descriptor, both K-major; the sum is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x128] += A[64x16] * B[16x128], A from registers (four bf16 pairs a
// thread, the accumulator's layout), B from shared memory by descriptor,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x64] += A[64x16] * B[16x64], A from registers (four bf16 pairs a
// thread, the accumulator's layout), B from shared memory by descriptor,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// NWG consumer warpgroups of 64 query rows each (warps 0 .. 4 NWG - 1) and
// one producer warp (warp 4 NWG).  DQ: D zero-padded to 64, 128 or 192;
// DV: D_v zero-padded to 64 or 128 (DV = DQ where D_v = D).
template <int NWG, int DQ, int DV>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    flash_kernel_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, MapDims mq,
                    MapDims mk, MapDims mv, __nv_bfloat16* __restrict__ o,
                    Strides ost, int n_rep, int S, int Dv, int causal,
                    int window, float scale_log2) {
  using L = Layout<NWG, DQ, DV>;
  constexpr int kBlockM = L::kBlockM;
  constexpr int kChunksQ = DQ / kChunk, kChunksV = DV / kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto k_tile = [&](int st) { return base + L::kQBytes + st * L::kStageBytes; };
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };

  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockM;  // heaviest first
  const int b = blockIdx.z, h = blockIdx.y, hk = h / n_rep;
  // KV tiles that hold a key some row of this block sees
  const int q_last = min(q0 + kBlockM - 1, S - 1);
  int t_hi = (S + kBlockN - 1) / kBlockN;
  if (causal) t_hi = min(t_hi, q_last / kBlockN + 1);
  const int t_lo = window > 0 ? max(q0 - window + 1, 0) / kBlockN : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool producer = warp == 4 * NWG && lane == 0;
  // K and V of the i-th tile of this block into its stage of the ring
  auto load_kv = [&](int i) {
    const int st = i % kStages, row = (t_lo + i) * kBlockN;
    const uint32_t kt = k_tile(st), vt = kt + L::kKBytes;
    mbar_expect_tx(k_full(st), L::kKBytes);
    for (int c = 0; c < kChunksQ; ++c)
      tma_load(&tk, mk, kt + c * kBlockN * 128, k_full(st), c * kChunk, row,
               hk, b);
    mbar_expect_tx(v_full(st), L::kVBytes);
    for (int c = 0; c < kChunksV; ++c)
      tma_load(&tv, mv, vt + c * kBlockN * 128, v_full(st), c * kChunk, row,
               hk, b);
  };
  // The producer thread sets up the barriers and starts the first loads
  // before the block meets, so they are in flight while it does.
  if (producer) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_full, L::kQBytes);
    for (int c = 0; c < kChunksQ; ++c)
      tma_load(&tq, mq, base + c * kBlockM * 128, q_full, c * kChunk, q0, h,
               b);
    for (int i = 0; i < kStages && t_lo + i < t_hi; ++i) load_kv(i);
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one thread keeps the ring full -----------------------
    if (producer) {
      for (int i = kStages; t_lo + i < t_hi; ++i) {
        // the stage's previous tile, i - kStages, has been consumed
        mbar_wait(empty(i % kStages), ((i / kStages) & 1) ^ 1);
        load_kv(i);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) ---
    const int wg = warp / 4;
    const int row_a = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int row_b = row_a + 8;  // each thread holds two rows
    const int q_first = q0 + 64 * wg, q_lastw = q_first + 63;
    const int col_t = 2 * (lane % 4);  // this thread's columns of an 8-block
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const uint32_t q_wg = base + 64 * wg * 128;

    mbar_wait(q_full, 0);
    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = t * kBlockN;
      const uint32_t kt = k_tile(st), vt = kt + L::kKBytes;

      // S = Q K^T: fp32 accumulators, 64 a thread
      float s[kBlockN / 2];
      mbar_wait(k_full(st), phase);
      __syncwarp();  // wgmma is issued by converged warps
      wg_fence();
      reg_fence(s);
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n128(s, gmma_desc(q_wg + c * kBlockM * 128 + off, 1, 64),
                      gmma_desc(kt + c * kBlockN * 128 + off, 1, 64), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(s);

      // mask the pairs no row may see, only on tiles that hold some
      const bool masked = k0 + kBlockN > S ||
                          (causal && k0 + kBlockN - 1 > q_first) ||
                          (window > 0 && k0 <= q_lastw - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = e < 2 ? row_a : row_b;
            const int kp = k0 + 8 * j + col_t + (e & 1);
            if (!sees(qp, kp, S, causal, window)) s[4 * j + e] = -INFINITY;
          }
      }

      // online softmax on the fragments, in base 2 on scaled scores
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      // a row that has seen no key yet keeps p = 0 and alpha = 0
      const float base_a = mx_a == -INFINITY ? 0.f : mx_a * scale_log2;
      const float base_b = mx_b == -INFINITY ? 0.f : mx_b * scale_log2;
      const float alpha_a = exp2_approx(m_a * scale_log2 - base_a);
      const float alpha_b = exp2_approx(m_b * scale_log2 - base_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -base_a));
        s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -base_a));
        s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -base_b));
        s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -base_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;  // this thread's share of the row sum
      l_b = l_b * alpha_b + sum_b;
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }

      // P in bf16 as wgmma's register operand: the 16 keys of step kk are
      // the accumulator's 8-column blocks 2 kk and 2 kk + 1
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V, V transposed from shared memory
      mbar_wait(v_full(st), phase);
      __syncwarp();
      wg_fence();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_pv<DV>(acc, pa[kk],
                     gmma_desc(vt + kk * 16 * 128, kBlockN * 128 / 16, 64));
      wg_commit();
      wg_wait0();
      reg_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // the row sums over the four threads of a row, in a fixed order
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    l_a = fmaxf(l_a, 1e-30f);
    l_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* oh = o + b * ost.b + h * ost.h;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int d = 8 * j + col_t;
      if (d >= Dv) continue;
      if (row_a < S)
        *reinterpret_cast<uint32_t*>(oh + row_a * ost.s + d) =
            pack_bf16(acc[4 * j] / l_a, acc[4 * j + 1] / l_a);
      if (row_b < S)
        *reinterpret_cast<uint32_t*>(oh + row_b * ost.s + d) =
            pack_bf16(acc[4 * j + 2] / l_b, acc[4 * j + 3] / l_b);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d bf16 tensor map over one (S, heads, batch) x D strided tensor with
// a box of (64 columns, `rows` rows), 128-byte swizzle; columns past D and
// rows past S read as zeros.  The three outer dims are ordered by stride,
// a dim of extent 1 last with a stride that follows the one before it.
// Returns 0, or kEncodeError + the CUresult.
constexpr int kEncodeError = 100000;

int make_map(CUtensorMap* map, MapDims* dims, const void* ptr, int S,
             int heads, int batch, int D, Strides st, int rows) {
  struct Dim {
    long long size, stride;
    int role;  // 0 sequence, 1 head, 2 batch
  } d[3] = {{S, st.s, 0}, {heads, st.h, 1}, {batch, st.b, 2}};
  auto before = [](const Dim& x, const Dim& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  long long prev_stride = 1, prev_size = D;
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {kChunk, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    if (d[i].size == 1) d[i].stride = prev_stride * prev_size;
    gdim[i + 1] = static_cast<cuuint64_t>(d[i].size);
    gstride[i] = static_cast<cuuint64_t>(d[i].stride) * 2;
    if (d[i].role == 0) box[i + 1] = rows;
    pos[d[i].role] = i + 1;
    prev_stride = d[i].stride;
    prev_size = d[i].size;
  }
  *dims = MapDims{pos[0], pos[1], pos[2]};
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
      gstride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int NWG, int DQ, int DV>
int launch(const Problem& p) {
  using L = Layout<NWG, DQ, DV>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err =
      allow_smem(flash_kernel_tc<NWG, DQ, DV>, L::kBytes, p.device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  MapDims mq, mk, mv;
  int rc = make_map(&tq, &mq, p.q, p.S, p.H, p.B, p.D, p.qst, L::kBlockM);
  if (rc == 0) rc = make_map(&tk, &mk, p.k, p.S, p.H_kv, p.B, p.D, p.kst, kBlockN);
  if (rc == 0) rc = make_map(&tv, &mv, p.v, p.S, p.H_kv, p.B, p.Dv, p.vst, kBlockN);
  if (rc != 0) return rc;
  const dim3 grid((p.S + L::kBlockM - 1) / L::kBlockM, p.H, p.B);
  flash_kernel_tc<NWG, DQ, DV><<<grid, 128 * NWG + 32, L::kBytes, p.stream>>>(
      tq, tk, tv, mq, mk, mv, static_cast<__nv_bfloat16*>(p.o), p.ost,
      p.H / p.H_kv, p.S, p.Dv, p.causal, p.window,
      p.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Two consumer warpgroups (128 query rows a block) when blocks of 128 rows
// fill every SM at least once, else one (64 rows), for twice the blocks.
template <int DQ, int DV>
int dispatch(const Problem& p, int sms) {
  const long long blocks128 =
      static_cast<long long>(p.B) * p.H * ((p.S + 127) / 128);
  return blocks128 >= sms ? launch<2, DQ, DV>(p) : launch<1, DQ, DV>(p);
}

}  // namespace tc
}  // namespace

// The launch's arguments, packed into one array of int64.
enum Arg {
  kQ, kK, kV, kO,            // device pointers
  kB, kH, kHkv, kS, kD, kDv, // q (B, H, S, D); k (B, H_kv, S, D);
                             // v (B, H_kv, S, Dv); o (B, H, S, Dv)
  kStrides,                  // 12 element strides: (batch, head, sequence)
                             // of q, k, v, o in turn
  kCausal = kStrides + 12, kWindow, kDtype,
  kScale,                    // the float32 scale's bit pattern
  kDevice, kStream,
  kNArgs
};

// q, k, v, o at 16-byte aligned bases, of one dtype (0: f32, 1: bf16),
// their strides multiples of 16 bytes, the last dim unit-stride; D a
// multiple of 8 up to 256; D_v = D, or in bf16 a multiple of 8 below D
// with D <= 192 and D_v <= 128; H % H_kv == 0; window <= 0 for none; the
// scores multiplied by the scale.  bf16 at D <= 128 and every D_v != D
// take the tensor-core route, the rest the CUDA-core route.  Launches on
// the stream and returns
// cudaGetLastError(), or 100000 + the CUresult when a TMA descriptor
// cannot be encoded.
extern "C" int flash_attention_launch(const long long* a) {
  const int B = static_cast<int>(a[kB]), H = static_cast<int>(a[kH]),
            H_kv = static_cast<int>(a[kHkv]), S = static_cast<int>(a[kS]),
            D = static_cast<int>(a[kD]), Dv = static_cast<int>(a[kDv]),
            dtype = static_cast<int>(a[kDtype]),
            device = static_cast<int>(a[kDevice]);
  const bool narrow_v = Dv != D;
  if (D <= 0 || D % 8 != 0 || D > 256 || Dv <= 0 || Dv % 8 != 0 ||
      (narrow_v && (dtype != 1 || Dv > D || D > 192 || Dv > 128)) ||
      B < 0 || H < 0 || S < 0 ||
      H_kv <= 0 || H % H_kv != 0 || B > 65535 || H > 65535 || device < 0 ||
      device >= kMaxDevices || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || S == 0) return 0;
  const uint32_t scale_bits = static_cast<uint32_t>(a[kScale]);
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  const long long* st = a + kStrides;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const Problem p{ptr(kQ), ptr(kK), ptr(kV), ptr(kO),
                  {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                  {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                  B, H, H_kv, S, D, Dv, static_cast<int>(a[kCausal]),
                  static_cast<int>(a[kWindow]), scale,
                  reinterpret_cast<cudaStream_t>(a[kStream]), device};
  if (dtype == 1 && (D <= 128 || narrow_v)) {   // the tensor-core route
    const int sms = sm_count(device);
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    if (!narrow_v)
      return D <= 64 ? tc::dispatch<64, 64>(p, sms)
                     : tc::dispatch<128, 128>(p, sms);
    // D_v < D: Q and K padded to 64, 128 or 192 columns, V to 64 or 128
    if (D <= 64) return tc::dispatch<64, 64>(p, sms);
    if (D <= 128)
      return Dv <= 64 ? tc::dispatch<128, 64>(p, sms)
                      : tc::dispatch<128, 128>(p, sms);
    return Dv <= 64 ? tc::dispatch<192, 64>(p, sms)
                    : tc::dispatch<192, 128>(p, sms);
  }
  if (dtype == 0) return dispatch<float>(p);
  return dispatch<__nv_bfloat16>(p);
}
