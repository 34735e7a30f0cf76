// K7: a grouped expert GEMM over rows sorted by expert: each expert's
// SwiGLU, out = (silu(x Wg) * (x Wu)) Wd, on its own contiguous rows, for
// a dropless mixture of experts (granite-4.0-h: 72 experts of width 768 at
// d_model 4,096, top-10).
//
// Replaces no TPU kernel.  The reference's MoE (src/repro/nn/moe.py)
// dispatches tokens into capacity slots by one-hot einsums and drops the
// pairs past capacity; without a capacity every expert would compute every
// row of its group.  Here the (token, k) pairs are sorted by expert on the
// card (nn/moe.py, _moe_dropless), expert e's rows are x[off[e], off[e+1]),
// and a tile of rows belongs to one expert.  Two kernels, launched in turn
// on one stream:
//
// * gate|up: hidden[r, n] = bf16(silu(x_r . Wg_e[:, n]) * (x_r . Wu_e[:, n]))
//   over depth D, a tile of 128 rows by 128 hidden columns, both products
//   summed in fp32 beside each other and fused in the epilogue;
// * down: out[r, n] = scale[r] * (hidden_r . Wd_e[:, n]) in fp32 over depth
//   F, a tile of 128 rows by 256 output columns (two halves of 128).
//
// What bounds it on an H100: operations.  At the served shape (81,920
// routed rows, D 4,096, F 768) one call is 1.55 TFLOP, 1.56 ms at the bf16
// peak of 989 TFLOP/s, against 3.4 GB of rows, weights and output, 1.0 ms
// at 3.35 TB/s.  Design: a block of two consumer warpgroups (64 rows each)
// and one producer warp.  The producer thread loads, by TMA with 128-byte
// swizzle, a stage of one (128 rows x 64 deep) A tile and two (64 deep x
// 128 columns) B tiles into a four-stage ring completed on mbarriers; each
// warpgroup runs m64n128k16 wgmma from shared memory, A K-major and B
// MN-major (the weights are stored (in, out), out contiguous), into two
// fp32 accumulators of 64 registers a thread.  The grid is (column tiles,
// a bound on the row tiles: ceil(M / 128) + E), computed on the host without
// reading the offsets; a block finds its expert by walking the offsets and
// a block past the last expert's tiles exits.  Rows of a tile past its
// expert's end are loaded (the next expert's rows, or zeros past M by TMA's
// out-of-bounds fill) and never stored, so each output row is written by
// exactly one block, in a fixed order of sums: a run repeats bit for bit.
//
// C interface: moe_grouped_launch, one array of int64 (enum Arg), called from
// kernels/moe_grouped.py through _build.launch.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is
                   // reached through cudaGetDriverEntryPoint, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockM = 128;   // rows a tile: two warpgroups of 64
constexpr int kBlockK = 64;    // depth a stage: one 128-byte row of bf16
constexpr int kHalfN = 128;    // columns of one of a stage's two B tiles
constexpr int kStages = 4;
constexpr int kThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kATile = kBlockM * kBlockK * 2;   // 16 KB
constexpr int kBChunk = kBlockK * 64 * 2;       // 8 KB: 64 deep x 64 columns
constexpr int kBTile = 2 * kBChunk;             // 16 KB: 64 deep x 128
constexpr int kStage = kATile + 2 * kBTile;     // 48 KB
constexpr int kBars = kStages * kStage;
constexpr int kSmem = kBars + 8 * 2 * kStages + 1024;  // + 1024-byte slack
constexpr int kMaxDevices = 64;

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

// The box at (col, row) of a 2-d map into shared memory at `dst`.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map,
                                            uint32_t dst, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The box at (col, row, expert) of a 3-d map.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map,
                                            uint32_t dst, uint32_t bar,
                                            int col, int row, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(e)
      : "memory");
}

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

template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x128] += A[64x16] * B[16x128], both from shared memory by
// descriptor, A K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + __expf(-g));
}

// kGateUp: A = x (M, D) over depth D, B = Wg and Wu (E, D, F) at the same
// 128 columns; writes hidden (M, F) in bf16.  Else A = hidden (M, F) over
// depth F, B = Wd (E, F, D) at two neighbouring 128-column halves; writes
// out (M, D) in fp32 times row_scale.  `ldo` is the output's row length.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 1)
    moe_grouped_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb0,
                       const __grid_constant__ CUtensorMap tb1,
                       const int* __restrict__ offsets, int E, int depth,
                       int ldo, void* __restrict__ out,
                       const float* __restrict__ row_scale) {
  // this block's expert and row tile: walk the experts' tile counts
  const int t = blockIdx.y;
  int e = 0, first = 0, lo = 0, hi = 0;
  for (; e < E; ++e) {
    lo = offsets[e];
    hi = offsets[e + 1];
    const int n = (hi - lo + kBlockM - 1) / kBlockM;
    if (t < first + n) break;
    first += n;
  }
  if (e == E) return;  // past the last expert's tiles: the whole block
  const int row0 = lo + (t - first) * kBlockM;
  const int col0 = blockIdx.x * (kGateUp ? kHalfN : 2 * kHalfN);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto a_tile = [&](int st) { return base + st * kStage; };
  auto b_tile = [&](int st, int h) {
    return base + st * kStage + kATile + h * kBTile;
  };
  auto full = [&](int st) { return base + kBars + 8 * st; };
  auto empty = [&](int st) { return base + kBars + 8 * (kStages + st); };
  const int nk = depth / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool producer = warp == 8 && lane == 0;

  // the i-th stage of depth into its slot of the ring
  auto load = [&](int i) {
    const int st = i % kStages, k0 = i * kBlockK;
    mbar_expect_tx(full(st), kStage);
    tma_load_2d(&ta, a_tile(st), full(st), k0, row0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const CUtensorMap* m = (kGateUp && h == 1) ? &tb1 : &tb0;
      const int c0 = kGateUp ? col0 : col0 + h * kHalfN;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        tma_load_3d(m, b_tile(st, h) + c * kBChunk, full(st), c0 + 64 * c,
                    k0, e);
    }
  };
  if (producer) {
    prefetch_map(&ta);
    prefetch_map(&tb0);
    prefetch_map(&tb1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages && i < nk; ++i) load(i);
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread keeps the ring full ------------------------
    if (producer) {
      for (int i = kStages; i < nk; ++i) {
        // the slot's previous stage, i - kStages, has been consumed
        mbar_wait(empty(i % kStages), ((i / kStages) & 1) ^ 1);
        load(i);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 + 64 wg + [0, 64) ----------
  const int wg = warp / 4;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);
    __syncwarp();  // wgmma is issued by converged warps
    wg_fence();
    reg_fence(acc0);
    reg_fence(acc1);
    const uint32_t a = a_tile(st) + wg * 64 * 128;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint64_t da = gmma_desc(a + kk * 32, 1, 64);
      wgmma_n128(acc0, da,
                 gmma_desc(b_tile(st, 0) + kk * 16 * 128, kBChunk / 16, 64));
      wgmma_n128(acc1, da,
                 gmma_desc(b_tile(st, 1) + kk * 16 * 128, kBChunk / 16, 64));
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc0);
    reg_fence(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // each thread holds rows row_a and row_a + 8, two columns of each block
  // of 8 (wgmma's accumulator layout)
  const int row_a = row0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int col_t = 2 * (lane % 4);
  if (kGateUp) {
    __nv_bfloat16* h = static_cast<__nv_bfloat16*>(out);
#pragma unroll
    for (int j = 0; j < kHalfN / 8; ++j) {
      const int n = col0 + 8 * j + col_t;
      if (row_a < hi)
        *reinterpret_cast<uint32_t*>(h + static_cast<long long>(row_a) * ldo +
                                     n) =
            pack_bf16(silu(acc0[4 * j]) * acc1[4 * j],
                      silu(acc0[4 * j + 1]) * acc1[4 * j + 1]);
      if (row_b < hi)
        *reinterpret_cast<uint32_t*>(h + static_cast<long long>(row_b) * ldo +
                                     n) =
            pack_bf16(silu(acc0[4 * j + 2]) * acc1[4 * j + 2],
                      silu(acc0[4 * j + 3]) * acc1[4 * j + 3]);
    }
  } else {
    float* o = static_cast<float*>(out);
    const float sa = row_scale != nullptr && row_a < hi ? row_scale[row_a] : 1.f;
    const float sb = row_scale != nullptr && row_b < hi ? row_scale[row_b] : 1.f;
#pragma unroll
    for (int j = 0; j < kHalfN / 8; ++j) {
      const int n = col0 + 8 * j + col_t;
      if (row_a < hi) {
        float* p = o + static_cast<long long>(row_a) * ldo + n;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc0[4 * j] * sa, acc0[4 * j + 1] * sa);
        *reinterpret_cast<float2*>(p + kHalfN) =
            make_float2(acc1[4 * j] * sa, acc1[4 * j + 1] * sa);
      }
      if (row_b < hi) {
        float* p = o + static_cast<long long>(row_b) * ldo + n;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc0[4 * j + 2] * sb, acc0[4 * j + 3] * sb);
        *reinterpret_cast<float2*>(p + kHalfN) =
            make_float2(acc1[4 * j + 2] * sb, acc1[4 * j + 3] * sb);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime's entry points.
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

constexpr int kEncodeError = 100000;

// A bf16 tensor map of `rank` dims (innermost first) with a box of 64
// columns by `rows` rows (by 1 along a third dim), 128-byte swizzle; what
// lies past the tensor reads as zeros.  Returns 0, or kEncodeError + the
// CUresult.
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, int rows) {
  cuuint64_t stride[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// The launch's arguments, packed into one array of int64.
enum Arg {
  kX, kOffsets, kWGate, kWUp, kWDown, kHidden, kOut, kScale,  // pointers
  kM, kD, kF, kE, kTiles, kDevice, kStream,
  kNArgs
};

// x (M, D), hidden (M, F) and the weights bf16, offsets int32 (E + 1),
// out (M, D) and the scale (M,) fp32 (scale 0 for none), all contiguous at
// 16-byte aligned bases; D a multiple of 256 and F of 128; tiles at least
// ceil(M / 128) + E.  Launches both kernels on the stream and returns
// cudaGetLastError(), or 100000 + the CUresult when a tensor map cannot be
// encoded.
extern "C" int moe_grouped_launch(const long long* a) {
  const int M = static_cast<int>(a[kM]), D = static_cast<int>(a[kD]),
            F = static_cast<int>(a[kF]), E = static_cast<int>(a[kE]),
            tiles = static_cast<int>(a[kTiles]),
            device = static_cast<int>(a[kDevice]);
  if (M < 0 || D <= 0 || D % (2 * kHalfN) != 0 || F <= 0 || F % kHalfN != 0 ||
      E <= 0 || tiles < 0 || tiles > 65535 || device < 0 ||
      device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || tiles == 0) return 0;
  static std::atomic<unsigned long long> done_gu{0}, done_dn{0};
  err = allow_smem(moe_grouped_kernel<true>, device, done_gu);
  if (err == cudaSuccess)
    err = allow_smem(moe_grouped_kernel<false>, device, done_dn);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t h_dims[2] = {static_cast<cuuint64_t>(F),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t gu_dims[3] = {static_cast<cuuint64_t>(F),
                                 static_cast<cuuint64_t>(D),
                                 static_cast<cuuint64_t>(E)};
  const cuuint64_t dn_dims[3] = {static_cast<cuuint64_t>(D),
                                 static_cast<cuuint64_t>(F),
                                 static_cast<cuuint64_t>(E)};
  CUtensorMap tx, tg, tu, th, td;
  int rc = make_map(&tx, ptr(kX), 2, x_dims, kBlockM);
  if (rc == 0) rc = make_map(&tg, ptr(kWGate), 3, gu_dims, kBlockK);
  if (rc == 0) rc = make_map(&tu, ptr(kWUp), 3, gu_dims, kBlockK);
  if (rc == 0) rc = make_map(&th, ptr(kHidden), 2, h_dims, kBlockM);
  if (rc == 0) rc = make_map(&td, ptr(kWDown), 3, dn_dims, kBlockK);
  if (rc != 0) return rc;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[kStream]);
  const int* offsets = static_cast<const int*>(ptr(kOffsets));
  moe_grouped_kernel<true><<<dim3(F / kHalfN, tiles), kThreads, kSmem,
                             stream>>>(tx, tg, tu, offsets, E, D, F,
                                       ptr(kHidden), nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_grouped_kernel<false><<<dim3(D / (2 * kHalfN), tiles), kThreads, kSmem,
                              stream>>>(th, td, td, offsets, E, F, D,
                                        ptr(kOut),
                                        static_cast<const float*>(ptr(kScale)));
  return static_cast<int>(cudaGetLastError());
}
