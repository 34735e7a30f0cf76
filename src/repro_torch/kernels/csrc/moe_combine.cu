// K9: the combine of a dropless mixture of experts, a gather-sum.  For each
// token t:
//
//   y[t] = round_bf16( sum_{k=0..K-1} out[pos[t K + k]] + float(shared[t]) )
//
// out is K7's (M, D) float32 output, rows sorted by expert and already
// scaled by their gates; pos (T, K) int32 holds the sorted row of pair
// (t, k), the inverse of the routing's stable sort; shared is the shared
// expert's (T, D) bf16 output, or null.
//
// Replaces no TPU kernel.  The reference's MoE (src/repro/nn/moe.py)
// combines capacity slots by a one-hot einsum; the port's dropless route
// (nn/moe.py, _moe_dropless) summed its pairs with a float32 index_add_, a
// scalar atomic add an element into a zeroed (T, D) buffer, then added the
// shared expert and cast in two more passes.  At granite-4.0-h's served
// shape (T 8,192 tokens, K 10, D 4,096) that chain took 2.45 ms a layer on
// an H100, about 0.6 TB/s, and its atomics summed in an order that changes
// from run to run.
//
// What bounds it on an H100: bytes.  A call adds T K D floats, and must
// read K7's T K rows once (1.342 GB at that shape), the shared rows once
// (67 MB) and write the bf16 result once (67 MB): 1.476 GB, 0.44 ms at
// 3.35 TB/s, against 0.3 GFLOP.  Design: one block of 128 threads (a
// warpgroup) a token, each thread 8 neighbouring columns a pass over the
// row (D / 1,024 passes at D 4,096).  A thread reads the token's K row
// numbers first, then issues all 2 K of a pass's 16-byte loads before it
// adds any, so every row of the token is in flight at once.  It sums in
// float32 in the fixed order k = 0..K-1, adds the shared row in float32
// and rounds once to bf16, as the index_add_ chain rounded, and stores 16
// bytes.  No atomics and no shared memory: a run repeats bit for bit, and
// a grid of T blocks (8,192 at the served shape) fills the card.  K is a
// template argument (1..16), so a pass's loads sit in registers.
//
// The rows are read through the non-coherent path (__ldg), not with
// streaming (evict-first) loads, though each is read once: at the served
// shape this kernel with evict-first loads of the rows took 0.58-0.59 ms a
// call and with __ldg 0.49 (89% of the bound; a grid-stride read of the
// rows alone takes 0.42 ms), on one H100.  The cause was not measured; a
// thread's two 16-byte loads share one 32-byte sector, and an evict-first
// line may leave L1 before the second load reaches it.
//
// C interface: moe_combine_launch, one array of int64 (enum Arg), called
// from kernels/moe_combine.py through _build.launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a block: one token
constexpr int kCols = 8;       // columns a thread a pass: 32 bytes of a row
constexpr int kMaxK = 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void add4(float* acc, const float4& v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <int K>
__global__ void __launch_bounds__(kThreads) moe_combine_kernel(
    const float* __restrict__ out, const int* __restrict__ pos,
    const __nv_bfloat16* __restrict__ shared, __nv_bfloat16* __restrict__ y,
    int D) {
  const long long t = blockIdx.x;
  const float* rows[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    rows[k] = out + static_cast<long long>(__ldg(pos + t * K + k)) * D;
  const long long base = t * D;
  for (int c = threadIdx.x * kCols; c < D; c += kThreads * kCols) {
    float4 v[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k][0] = __ldg(reinterpret_cast<const float4*>(rows[k] + c));
      v[k][1] = __ldg(reinterpret_cast<const float4*>(rows[k] + c + 4));
    }
    uint4 s = make_uint4(0u, 0u, 0u, 0u);
    if (shared != nullptr)
      s = __ldcs(reinterpret_cast<const uint4*>(shared + base + c));
    float acc[kCols] = {v[0][0].x, v[0][0].y, v[0][0].z, v[0][0].w,
                        v[0][1].x, v[0][1].y, v[0][1].z, v[0][1].w};
#pragma unroll
    for (int k = 1; k < K; ++k) {
      add4(acc, v[k][0]);
      add4(acc + 4, v[k][1]);
    }
    if (shared != nullptr) {
      const uint32_t w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(w[j]);
        acc[2 * j] += f.x;
        acc[2 * j + 1] += f.y;
      }
    }
    *reinterpret_cast<uint4*>(y + base + c) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
  }
}

template <int K>
cudaError_t launch_k(const float* out, const int* pos,
                     const __nv_bfloat16* shared, __nv_bfloat16* y, int T,
                     int D, cudaStream_t stream) {
  moe_combine_kernel<K><<<T, kThreads, 0, stream>>>(out, pos, shared, y, D);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const float*, const int*,
                               const __nv_bfloat16*, __nv_bfloat16*, int,
                               int, cudaStream_t);

constexpr Launch kLaunch[kMaxK] = {
    launch_k<1>,  launch_k<2>,  launch_k<3>,  launch_k<4>,
    launch_k<5>,  launch_k<6>,  launch_k<7>,  launch_k<8>,
    launch_k<9>,  launch_k<10>, launch_k<11>, launch_k<12>,
    launch_k<13>, launch_k<14>, launch_k<15>, launch_k<16>};

}  // namespace

// The launch's arguments, packed into one array of int64.
enum Arg {
  kOut, kPos, kShared, kY,  // pointers
  kT, kK, kM, kD, kDevice, kStream,
  kNArgs
};

// out (M, D) float32, pos (T, K) int32 with every entry in [0, M), shared
// (T, D) bf16 or 0 for none, y (T, D) bf16, all contiguous at 16-byte
// aligned bases; 1 <= K <= 16, D a multiple of 8.  Launches the kernel on
// the stream and returns cudaGetLastError().
extern "C" int moe_combine_launch(const long long* a) {
  const long long T = a[kT], K = a[kK], M = a[kM], D = a[kD],
                  device = a[kDevice];
  bool aligned = true;
  for (int i : {kOut, kPos, kShared, kY}) aligned = aligned && a[i] % 16 == 0;
  if (T < 0 || T > 2147483647LL || K < 1 || K > kMaxK || M < 0 || D <= 0 ||
      D % kCols != 0 || D > 2147483647LL || device < 0 ||
      device >= kMaxDevices || !aligned || (T > 0 && M == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device)
    err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  err = kLaunch[K - 1](static_cast<const float*>(ptr(kOut)),
                       static_cast<const int*>(ptr(kPos)),
                       static_cast<const __nv_bfloat16*>(ptr(kShared)),
                       static_cast<__nv_bfloat16*>(ptr(kY)),
                       static_cast<int>(T), static_cast<int>(D),
                       reinterpret_cast<cudaStream_t>(a[kStream]));
  return static_cast<int>(err);
}
