// K8: the chunked SSD scan of a Mamba-2 mixer (state-space duality,
// arXiv:2405.21060) in float32, as its plain version (kernels/ref.py,
// ssd_chunked) computes it: for each chunk of Q steps the quadratic term
// within the chunk, the chunk's state, the recurrence over the chunk
// states, and the output of the state entering each chunk.
//
// Replaces no TPU kernel: the reference's src/repro/nn/ssm.py is plain
// jnp (einsums, a cumulative sum and a loop over chunks), and so was the
// port's ssd_chunked.  At granite-4.0-h's shape (4 prompts x 2,048 steps,
// 128 heads of 64, N 128, one group of B and C, Q 256) that chain spends
// 17.2 ms a layer on an H100: B and C copied once per head, C B^T computed
// once per head, and three (b, c, H, Q, Q) float32 tensors written and
// read back.
//
// What bounds it on an H100: float32 operations on the CUDA cores.  A layer
// needs about 50 GFLOP (the lower triangle of (C B^T . L . dt) x, the chunk
// states, the incoming states' output, C B^T once per group), 0.75 ms at
// 67 TFLOP/s, against about 0.3 GB of inputs and outputs, 0.1 ms at
// 3.35 TB/s.  Every product and sum is an f32 FFMA: no operand is rounded
// to TF32 or bf16, nothing is built with fast math.
//
// Design, four launches on one stream:
//
// * prep, one warp a (prompt, chunk, head): dA = dt A rounded to f32 as the
//   reference rounds it, its inclusive prefix sums cs in float64, and from
//   them the chunk's decays;
// * cb, one block a 64 x 64 tile on or below the diagonal of C B^T for each
//   (prompt, chunk, group): B and C are read as they lie in the conv's
//   output, once, and the product is shared by every head of the group
//   (no per-head copies of B or C);
// * state, one block a (prompt, head), its 64 x 128 state in registers:
//   chunk after chunk it stores the state entering the chunk, then takes
//   h = h exp(cs_{Q-1}) + sum_q x_q (exp(seg(Q-1, q)) dt_q B_q);
// * out, one block a (prompt, chunk, head, 64 rows of the chunk): it
//   builds each 64 x 8 slice of M = C B^T . exp(seg) . dt in shared
//   memory from the cb tile, skips the slices above the diagonal, and
//   accumulates M x and (C exp(cs)) h_in^T into one register tile, then
//   adds x D and rounds y once to x's type.
//
// No (Q x Q) tensor of a head is ever written to device memory: C B^T is
// one (Q x Q) tensor a group, and M lives one slice at a time in shared
// memory.  The products are 64-row register tiles, 8 x 8 a thread, read
// from 8-deep slices in two shared-memory buffers: the loads of the next
// slice are in flight while the block multiplies the current one.
//
// Segment sums keep the plain version's accuracy.  seg(q, k), the sum of
// dA over (k, q], is the float64 difference cs_q - cs_k rounded once to
// f32, never a difference of f32 cumulative sums: over a 256-step chunk
// |cs| reaches 10^3, and such differences would carry absolute errors near
// 1e-4 into the short segments near the diagonal, whose exp weigh most.
//
// Shapes: head size P <= 64 and state size N <= 128, both multiples of 8
// (mamba2-130m and granite-4.0-h: 64 and 128), any number of heads a
// multiple of the groups, any chunk length Q <= 256 with S a multiple of
// Q.  x, B and C are float32 or bf16 with unit stride inside a step, read
// 16 bytes at a time; dt, A, D and h0 float32.
//
// C interface: ssd_scan_launch, one array of int64 (enum Arg), called from
// kernels/ssd_scan.py through _build.launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // rows of an output tile (q or p)
constexpr int kDepth = 8;     // depth of a slice staged in shared memory
constexpr int kCbDepth = 32;  // depth of the cb kernel's slices
constexpr int kMaxP = 64;     // the largest head size; h_in is kMaxN x kMaxP
constexpr int kMaxN = 128;    // the largest state size
constexpr int kMaxQ = 256;    // the longest chunk: its cs and dt fit a block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K neighbouring values of type T held as raw 32-bit words, read with one
// or two vector loads (16-byte aligned for 16 bytes, 8 for 8): a slice's
// next values stay packed in few registers while the block multiplies.
template <typename T, int K>
struct Pack {
  static constexpr int kWords = K * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 2 || kWords % 4 == 0, "8 or 16n bytes");
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const T* src) {
    if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  // value i as float32 (a bf16 is the upper half of its float32)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
};

// A thread's 8 x 8 outputs: rows 4 tr + (0..3) and 32 + 4 tr + (0..3),
// columns 4 tc + (0..3) and kHalf + 4 tc + (0..3), so that the eight
// threads of a quarter warp read neighbouring 16-byte words.
__device__ __forceinline__ int row_of(int tr, int i) {
  return (i < 4 ? 0 : 32) + 4 * tr + (i & 3);
}
template <int kHalf>
__device__ __forceinline__ int col_of(int tc, int j) {
  return (j < 4 ? 0 : kHalf) + 4 * tc + (j & 3);
}

// The row length of C B^T: Q rounded up to a multiple of 8.
__host__ __device__ __forceinline__ int padded_q(int Q) {
  return (Q + 7) & ~7;
}

// acc[i][j] += sum over the slice's kD rows kk of
// A[kk][row_of(i)] * B[kk][col_of(j)]: A (kD x 64, row length LDA) and
// B (kD x 2 kHalf, row length LDB) in shared memory.
template <int kD, int LDA, int LDB, int kHalf>
__device__ __forceinline__ void mac_slice(float (&acc)[8][8],
                                          const float* As, const float* Bs,
                                          int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < kD; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDA + 4 * tr);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * LDA + 32 + 4 * tr);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDB + 4 * tc);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * LDB + kHalf + 4 * tc);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One warp a (b, c, h), warps numbered ((b nc + c) H + h), which is also
// the row of the head-major buffers (cs, dtq, wst, eo: Q values a row).
__global__ void __launch_bounds__(256) ssd_prep_kernel(
    const float* __restrict__ dt, const float* __restrict__ A, int S, int H,
    int Q, int nc, long long warps, double* __restrict__ cs,
    float* __restrict__ dtq, float* __restrict__ wst, float* __restrict__ eo,
    float* __restrict__ decay) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;  // whole warps: blockDim is a multiple of 32
  const int h = static_cast<int>(w % H);
  const long long bc = w / H;
  const long long b = bc / nc, c = bc % nc;
  const float a = A[h];
  const float* dtp = dt + (b * S + c * Q) * H + h;
  const long long row = w * Q;
  double carry = 0.0;
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    const float d = q < Q ? dtp[static_cast<long long>(q) * H] : 0.f;
    double v = q < Q ? static_cast<double>(d * a) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    carry = __shfl_sync(0xffffffffu, v, 31);
    if (q < Q) {
      cs[row + q] = v;
      dtq[row + q] = d;
    }
  }
  // carry is cs_{Q-1}; each lane reads back only what it wrote
  for (int q = lane; q < Q; q += 32) {
    const double v = cs[row + q];
    wst[row + q] = expf(static_cast<float>(carry - v)) * dtq[row + q];
    eo[row + q] = expf(static_cast<float>(v));
  }
  if (lane == 0) decay[w] = expf(static_cast<float>(carry));
}

// C B^T of (b, c, g): cb[((b nc + c) G + g)][q][k] = sum_n C[q, n] B[k, n]
// over the 64 x 64 tiles (ti, tj), tj <= ti, numbered row by row; rows of
// Q rounded up to 8 values (padded_q), so that 8 of them are one 32-byte
// aligned read.
template <typename T>
__global__ void __launch_bounds__(64, 8) ssd_cb_kernel(
    const T* __restrict__ Bp, const T* __restrict__ Cp, long long sBb,
    long long sBs, long long sCb, long long sCs, int Q, int N, int G, int nc,
    float* __restrict__ cb) {
  __shared__ __align__(16) float As[kCbDepth][kRows];  // C^T slice [n][q]
  __shared__ __align__(16) float Bs[kCbDepth][kRows];  // B^T slice [n][k]
  int t = blockIdx.x, ti = 0;
  while (t > ti) t -= ++ti;
  const int tj = t;
  const int g = blockIdx.y % G, bc = blockIdx.y / G;
  const int b = bc / nc, c = bc % nc;
  const int q0 = ti * kRows, k0 = tj * kRows;
  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
  const int qa = q0 + tid, kb = k0 + tid;  // the rows this thread stages
  const T* crow = Cp + b * sCb + (static_cast<long long>(c) * Q + qa) * sCs +
                  g * N;
  const T* brow = Bp + b * sBb + (static_cast<long long>(c) * Q + kb) * sBs +
                  g * N;
  float acc[8][8] = {};
  for (int n0 = 0; n0 < N; n0 += kCbDepth) {
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kCbDepth; ++j) {
      const bool in_n = n0 + j < N;
      As[j][tid] = qa < Q && in_n ? to_f32(crow[n0 + j]) : 0.f;
      Bs[j][tid] = kb < Q && in_n ? to_f32(brow[n0 + j]) : 0.f;
    }
    __syncthreads();
    mac_slice<kCbDepth, kRows, kRows, 32>(acc, &As[0][0], &Bs[0][0], tr, tc);
  }
  const int Qp = padded_q(Q);
  float* out = cb + static_cast<long long>(blockIdx.y) * Q * Qp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + row_of(tr, i);
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + col_of<32>(tc, j);
      if (k < Q) out[static_cast<long long>(q) * Qp + k] = acc[i][j];
    }
  }
}

// The chunk states and their recurrence for (b = blockIdx.y, h =
// blockIdx.x): h_in[c] (stored [n][p], kMaxN x kMaxP, zero past N and P)
// is the state entering chunk c; h_final the state after the last.  The
// slices of every chunk run as one pipeline: a slice's loads are in
// flight while the block multiplies the one before, from the other of two
// buffers.
template <typename T>
__global__ void __launch_bounds__(128, 4) ssd_state_kernel(
    const T* __restrict__ x, const T* __restrict__ Bp, long long sxb,
    long long sxs, long long sBb, long long sBs, int H, int G, int P, int N,
    int Q, int nc, const float* __restrict__ wst,
    const float* __restrict__ decay, const float* __restrict__ h0,
    float* __restrict__ hin, float* __restrict__ hfin) {
  __shared__ __align__(16) float Xs[2][kDepth][kMaxP];  // x slice [q][p]
  __shared__ __align__(16) float Bs[2][kDepth][kMaxN];  // (w B) [q][n]
  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  // tr, tc: the thread's outputs, and the slice row tr it stages (x's
  // columns 4 tc.., B's 8 tc..)
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long hb = (static_cast<long long>(b) * H + h) * P * N;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = row_of(tr, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = col_of<64>(tc, j);
      acc[i][j] = h0 != nullptr && p < P && n < N ? h0[hb + p * N + n] : 0.f;
    }
  }
  const int spc = (Q + kDepth - 1) / kDepth;  // slices a chunk
  const int ns = nc * spc;
  Pack<T, 4> xv;
  Pack<T, 8> bv;
  float wv;
  auto load = [&](int s) {
    const int c = s / spc, q = (s % spc) * kDepth + tr;
    const bool in = q < Q;
    const long long row = static_cast<long long>(c) * Q + q;
    if (in && 4 * tc < P)
      xv.load(x + b * sxb + row * sxs + static_cast<long long>(h) * P +
              4 * tc);
    else
      xv.clear();
    if (in && 8 * tc < N)
      bv.load(Bp + b * sBb + row * sBs + static_cast<long long>(g) * N +
              8 * tc);
    else
      bv.clear();
    wv = in ? wst[((static_cast<long long>(b) * nc + c) * H + h) * Q + q]
            : 0.f;
  };
  auto stage = [&](int s) {
    float* xs = &Xs[s & 1][tr][4 * tc];
    float* bs = &Bs[s & 1][tr][8 * tc];
    *reinterpret_cast<float4*>(xs) =
        make_float4(xv.get(0), xv.get(1), xv.get(2), xv.get(3));
    *reinterpret_cast<float4*>(bs) =
        make_float4(bv.get(0) * wv, bv.get(1) * wv, bv.get(2) * wv,
                    bv.get(3) * wv);
    *reinterpret_cast<float4*>(bs + 4) =
        make_float4(bv.get(4) * wv, bv.get(5) * wv, bv.get(6) * wv,
                    bv.get(7) * wv);
  };
  load(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    if (s % spc == 0) {  // chunk c starts: store the state entering it
      const long long bch = (static_cast<long long>(b) * nc + s / spc) * H + h;
      float* hi = hin + bch * kMaxN * kMaxP;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = col_of<64>(tc, j);
#pragma unroll
        for (int ih = 0; ih < 2; ++ih)
          *reinterpret_cast<float4*>(hi + n * kMaxP + 32 * ih + 4 * tr) =
              make_float4(acc[4 * ih][j], acc[4 * ih + 1][j],
                          acc[4 * ih + 2][j], acc[4 * ih + 3][j]);
      }
      const float dec = decay[bch];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= dec;
    }
    if (s + 1 < ns) load(s + 1);
    mac_slice<kDepth, kMaxP, kMaxN, 64>(acc, &Xs[s & 1][0][0],
                                        &Bs[s & 1][0][0], tr, tc);
    if (s + 1 < ns) stage(s + 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = row_of(tr, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = col_of<64>(tc, j);
      if (p < P && n < N) hfin[hb + p * N + n] = acc[i][j];
    }
  }
}

// y for the rows [q0, q0 + 64) of chunk c of prompt b, head h: blockIdx.x
// counts the row tiles from the last (the longest run of slices) down,
// blockIdx.y is h, blockIdx.z is b nc + c.  Two pipelines of slices, each
// slice's loads in flight while the block multiplies the one before: the
// incoming state's (C exp(cs)) h_in^T, then M x over the slices on and
// below the diagonal.
template <typename T>
__global__ void __launch_bounds__(64, 6) ssd_out_kernel(
    const T* __restrict__ x, const T* __restrict__ Cp, long long sxb,
    long long sxs, long long sCb, long long sCs, int H, int G, int P, int N,
    int Q, int nc, int has_h0, const double* __restrict__ cs,
    const float* __restrict__ dtq, const float* __restrict__ eo,
    const float* __restrict__ cb, const float* __restrict__ hin,
    const float* __restrict__ D, T* __restrict__ y) {
  __shared__ __align__(16) float As[2][kDepth][kRows];  // M^T, (C eo)^T
  __shared__ __align__(16) float Bs[2][kDepth][kMaxP];  // x, h_in
  __shared__ double css[kMaxQ];
  __shared__ float dts[kMaxQ];
  const int nqt = (Q + kRows - 1) / kRows;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int h = blockIdx.y, bc = blockIdx.z, g = h / (H / G);
  const int b = bc / nc, c = bc % nc;
  // tr, tc: the thread's outputs, and the slice row tr of x or h_in it
  // stages (columns 8 tc..)
  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
  const long long bch = static_cast<long long>(bc) * H + h;
  const int qa = q0 + tid;  // the row of M and C this thread stages
  const bool row_in = qa < Q;
  const T* xr = x + b * sxb + static_cast<long long>(c) * Q * sxs +
                static_cast<long long>(h) * P;
  const int kend = min(Q, q0 + kRows);
  for (int k = tid; k < kend; k += kRows) {
    css[k] = cs[bch * Q + k];
    dts[k] = dtq[bch * Q + k];
  }
  float acc[8][8] = {};

  // the output of the state entering the chunk: (C exp(cs)) h_in^T
  if (c > 0 || has_h0) {
    const float e = row_in ? eo[bch * Q + qa] : 0.f;
    const T* crow = Cp + b * sCb + (static_cast<long long>(c) * Q + qa) * sCs +
                    static_cast<long long>(g) * N;
    const float* hi = hin + bch * kMaxN * kMaxP;
    const int ns = (N + kDepth - 1) / kDepth;
    Pack<T, kDepth> cv;
    float4 hv[2];
    auto load = [&](int s) {
      const int n0 = s * kDepth;
      if (row_in)
        cv.load(crow + n0);
      else
        cv.clear();
      const float* src = hi + (n0 + tr) * kMaxP + 8 * tc;
      hv[0] = *reinterpret_cast<const float4*>(src);
      hv[1] = *reinterpret_cast<const float4*>(src + 4);
    };
    auto stage = [&](int s) {
#pragma unroll
      for (int j = 0; j < kDepth; ++j) As[s & 1][j][tid] = cv.get(j) * e;
      *reinterpret_cast<float4*>(&Bs[s & 1][tr][8 * tc]) = hv[0];
      *reinterpret_cast<float4*>(&Bs[s & 1][tr][8 * tc + 4]) = hv[1];
    };
    load(0);
    stage(0);
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) load(s + 1);
      mac_slice<kDepth, kRows, kMaxP, 32>(acc, &As[s & 1][0][0],
                                          &Bs[s & 1][0][0], tr, tc);
      if (s + 1 < ns) stage(s + 1);
      __syncthreads();
    }
  }

  // within the chunk: M = C B^T . exp(seg) . dt on and below the diagonal
  __syncthreads();  // css and dts are in place
  const double cs_q = row_in ? css[qa] : 0.0;
  const int Qp = padded_q(Q);
  const float* cbr = cb + (static_cast<long long>(bc) * G + g) * Q * Qp +
                     static_cast<long long>(qa) * Qp;
  const int ns = (kend + kDepth - 1) / kDepth;
  Pack<float, kDepth> cbv;
  Pack<T, 8> xv;
  auto load = [&](int s) {
    const int k0 = s * kDepth, k = k0 + tr;
    if (row_in && k0 <= qa)
      cbv.load(cbr + k0);
    else
      cbv.clear();
    if (k < Q && 8 * tc < P)
      xv.load(xr + k * sxs + 8 * tc);
    else
      xv.clear();
  };
  auto stage = [&](int s) {
    const int k0 = s * kDepth;
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int k = k0 + j;
      As[s & 1][j][tid] =
          row_in && k <= qa
              ? cbv.get(j) * expf(static_cast<float>(cs_q - css[k])) * dts[k]
              : 0.f;
    }
    float* xs = &Bs[s & 1][tr][8 * tc];
    *reinterpret_cast<float4*>(xs) =
        make_float4(xv.get(0), xv.get(1), xv.get(2), xv.get(3));
    *reinterpret_cast<float4*>(xs + 4) =
        make_float4(xv.get(4), xv.get(5), xv.get(6), xv.get(7));
  };
  load(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) load(s + 1);
    mac_slice<kDepth, kRows, kMaxP, 32>(acc, &As[s & 1][0][0],
                                        &Bs[s & 1][0][0], tr, tc);
    if (s + 1 < ns) stage(s + 1);
    __syncthreads();
  }

  // y = acc + x D, rounded once to y's type
  const float d = D[h];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + row_of(tr, i);
    if (q >= Q) continue;
    T* yr = y + ((static_cast<long long>(b) * nc + c) * Q + q) * H * P +
            static_cast<long long>(h) * P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = col_of<32>(tc, j);
      if (p < P)
        store(yr + p,
              __fadd_rn(acc[i][j], __fmul_rn(to_f32(xr[q * sxs + p]), d)));
    }
  }
}

// The launch's arguments, packed into one array of int64.
enum Arg {
  kX, kDt, kA, kB, kC, kD, kH0, kY, kHFinal,   // tensors
  kCs, kDtq, kWst, kEo, kDecay, kCb, kHin,     // scratch
  kBatch, kS, kH, kG, kP, kN, kQ,
  kSxb, kSxs, kSBb, kSBs, kSCb, kSCs,          // strides, in elements
  kBf16, kDevice, kStream,
  kNArgs
};

template <typename T>
cudaError_t launch_all(const long long* a, cudaStream_t stream) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int batch = static_cast<int>(a[kBatch]), S = static_cast<int>(a[kS]),
            H = static_cast<int>(a[kH]), G = static_cast<int>(a[kG]),
            P = static_cast<int>(a[kP]), N = static_cast<int>(a[kN]),
            Q = static_cast<int>(a[kQ]);
  const int nc = S / Q, nt = (Q + kRows - 1) / kRows;
  const T* x = static_cast<const T*>(ptr(kX));
  const T* Bp = static_cast<const T*>(ptr(kB));
  const T* Cp = static_cast<const T*>(ptr(kC));
  double* cs = static_cast<double*>(ptr(kCs));
  float* dtq = static_cast<float*>(ptr(kDtq));
  float* wst = static_cast<float*>(ptr(kWst));
  float* eo = static_cast<float*>(ptr(kEo));
  float* decay = static_cast<float*>(ptr(kDecay));
  float* cb = static_cast<float*>(ptr(kCb));
  float* hin = static_cast<float*>(ptr(kHin));
  const long long warps = static_cast<long long>(batch) * nc * H;
  ssd_prep_kernel<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0,
                    stream>>>(static_cast<const float*>(ptr(kDt)),
                              static_cast<const float*>(ptr(kA)), S, H, Q, nc,
                              warps, cs, dtq, wst, eo, decay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, batch * nc * G), kRows, 0,
                     stream>>>(Bp, Cp, a[kSBb], a[kSBs], a[kSCb], a[kSCs], Q,
                               N, G, nc, cb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_kernel<T><<<dim3(H, batch), 128, 0, stream>>>(
      x, Bp, a[kSxb], a[kSxs], a[kSBb], a[kSBs], H, G, P, N, Q, nc, wst,
      decay, static_cast<const float*>(ptr(kH0)), hin,
      static_cast<float*>(ptr(kHFinal)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out_kernel<T><<<dim3(nt, H, batch * nc), kRows, 0, stream>>>(
      x, Cp, a[kSxb], a[kSxs], a[kSCb], a[kSCs], H, G, P, N, Q, nc,
      ptr(kH0) != nullptr, cs, dtq, eo, cb, hin,
      static_cast<const float*>(ptr(kD)), static_cast<T*>(ptr(kY)));
  return cudaGetLastError();
}

}  // namespace

// x (b, S, H, P) at strides (sxb, sxs, P, 1); B and C (b, S, G, N) at
// (sBb, sBs, N, 1) and (sCb, sCs, N, 1), all float32 or all bf16 (bf16
// 1), their bases 16-byte aligned and their strides whole 16 bytes; P and
// N multiples of 8; dt (b, S, H), A (H), D (H) and h0 (b, H, P, N)
// float32, contiguous (h0 0 for none); y (b, S, H, P) contiguous in x's
// type, h_final (b, H, P, N) float32; the scratch: cs float64 and dtq,
// wst, eo float32 (b, nc, H, Q), decay (b, nc, H), cb (b, nc, G, Q,
// padded_q(Q)) and hin (b, nc, H, 128, 64) float32, 16-byte aligned.
// Launches the four kernels on the stream and returns cudaGetLastError().
extern "C" int ssd_scan_launch(const long long* a) {
  const long long batch = a[kBatch], S = a[kS], H = a[kH], G = a[kG],
                  P = a[kP], N = a[kN], Q = a[kQ], device = a[kDevice];
  const long long vec = a[kBf16] ? 8 : 4;  // elements in 16 bytes
  bool aligned = true;
  for (int i : {kX, kB, kC, kCb, kHin}) aligned = aligned && a[i] % 16 == 0;
  for (int i : {kSxb, kSxs, kSBb, kSBs, kSCb, kSCs})
    aligned = aligned && a[i] % vec == 0;
  if (batch < 0 || S < 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || P % 8 != 0 || N <= 0 || N > kMaxN || N % 8 != 0 ||
      Q <= 0 || Q > kMaxQ || S % Q != 0 || H > 65535 || batch > 65535 ||
      batch * (S / Q) * G > 65535 || device < 0 || device >= kMaxDevices ||
      (a[kBf16] != 0 && a[kBf16] != 1) || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device)
    err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || S == 0) return 0;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[kStream]);
  err = a[kBf16] ? launch_all<__nv_bfloat16>(a, stream)
                 : launch_all<float>(a, stream);
  return static_cast<int>(err);
}
