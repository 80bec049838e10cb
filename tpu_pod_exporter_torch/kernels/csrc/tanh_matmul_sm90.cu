// y = tanh(h @ W) for Hopper: a warp-specialised kernel that feeds wgmma
// from shared memory filled by TMA. bf16 operands, f32 accumulation, tanh
// on the f32 sum, one round to bf16 on the store.
//
// Replaces the layer body that XLA fuses on the TPU,
// tpu_pod_exporter/loadgen/workload.py:40-43 (forward.layer), run once per
// layer of every forward. Two C entries launch it:
//
// - tanh_matmul_bf16_sm90, the aligned main path: every shape whose rows TMA
//   can address as they lie (K and N multiples of 8, h and W 16-byte
//   aligned, K > 0), each row stride equal to its extent;
// - tanh_matmul_bf16_sm90_strided, the staged route, for every other shape:
//   row strides ldh, ldw and ldy apart from K and N. TMA needs a row stride
//   that is a multiple of 16 bytes and a 16-byte-aligned base, but not an
//   extent that is a multiple of 8: it fills reads past K or N with zeros as
//   it does for any ragged tile. So the wrapper (kernels/tanh_matmul.py)
//   copies an operand that fails those two demands into a buffer with
//   ld = roundup(extent, 8) at an aligned base (stage_rows.cu), and y is
//   written in place at ldy = N, as bf16 pairs where ldy is even and y
//   4-byte aligned, else one value at a time. K = 0 reads nothing and
//   stores tanh(0) = 0.
//
// Bound on an H100 SXM at the main-path shape (M=4096, K=N=8192): the
// product is 2*M*N*K = 5.5e11 operations, 0.556 ms at the 989 TFLOP/s
// dense bf16 peak, while its 256 MiB of operands and result take 0.08 ms
// at 3.35 TB/s. The tensor cores bound it, and wgmma is the only way to
// their full rate. The design:
//
// - block tile 128x256, K in slices of 64, one block per output tile in a
//   grouped order (GROUP_M tiles down M, then across N), so that the blocks
//   in flight share the slices of h and W they read through the L2;
// - 3 warpgroups: warpgroup 0 is the producer, one thread of which issues
//   the TMA loads of each slice into a ring of STAGES buffers and arms the
//   stage's "full" mbarrier with the bytes to expect; warpgroups 1 and 2
//   are consumers, each owning 64 rows of the tile, and run
//   wgmma.m64n256k16 (4 per slice) with 128 f32 accumulators a thread;
// - a consumer keeps one wgmma group in flight and releases a stage on its
//   "empty" mbarrier once wgmma.wait_group shows the group reading it done;
// - setmaxnreg moves registers from the producer (40) to the consumers
//   (232): 128*40 + 256*232 fits the SM's 65,536;
// - operands land in shared memory in the 128-byte swizzle that wgmma
//   reads. h is K-major: one 128-row box of 64 K (128 bytes a row). W is
//   [in, out] and so N-contiguous: B is read MN-major (wgmma's transpose
//   bit for B) from four boxes of 64 N by 64 K, without transposing W;
// - the epilogue applies tanhf to the accumulators in registers and stores
//   bf16 pairs with masks, so the f32 pre-activation never reaches device
//   memory;
// - ragged M, N and K: TMA fills loads past the matrix with zeros, and
//   stores past M or N are masked.
//
// Layout is the JAX package's: h (M,K), W (K,N) indexed [in, out], y (M,N),
// all row-major and contiguous. TMA descriptors are made on the host for
// each call, through the CUDA driver entry point that the runtime hands
// out, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;              // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;        // warpgroups, 64 rows of the tile each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int GROUP_M = 8;
constexpr int B_BOX = 64;           // N columns of W per TMA box
constexpr int A_BYTES = BM * BK * 2;             // 16 KiB
constexpr int B_BOX_BYTES = BK * B_BOX * 2;      // 8 KiB
constexpr int B_BYTES = BK * BN * 2;             // 32 KiB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// Tile buffers, a full and an empty barrier per stage, and room to align
// the buffers to the 1024 bytes of a swizzle pattern.
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "dynamic shared memory limit");
static_assert(BM == CONSUMERS * 64, "one wgmma row block per consumer");

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy the box at (c0 innermost, c1) of `map` into shared memory at `dst`;
// the bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64x16, K-major) * B (16x256, MN-major), both read from shared
// memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"  // scale A and B by 1; A K-major, B MN-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ y, int N,
                                           int row, int col, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(row) * N + col) =
      __floats2bfloat162_rn(tanhf(a), tanhf(b));
}

// Columns col and col + 1 of a row of y at row stride ldy: one bf16 pair
// where `pairs` (ldy even, y 4-byte aligned) and col + 1 < N, else the
// values inside N one at a time.
__device__ __forceinline__ void store_strided(__nv_bfloat16* __restrict__ y, int N,
                                              int ldy, bool pairs, int row, int col,
                                              float a, float b) {
  __nv_bfloat16* p = y + static_cast<size_t>(row) * ldy + col;
  if (pairs && col + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(tanhf(a), tanhf(b));
  } else {
    p[0] = __float2bfloat16_rn(tanhf(a));
    if (col + 1 < N) p[1] = __float2bfloat16_rn(tanhf(b));
  }
}

// kStrided: y's row stride is ldy (the staged route); otherwise it is N and
// N is even (the aligned main path, whose code this leaves as it was).
template <bool kStrided>
__global__ void __launch_bounds__(THREADS, 1)
tanh_matmul_sm90_kernel(const __grid_constant__ CUtensorMap map_h,
                        const __grid_constant__ CUtensorMap map_w,
                        __nv_bfloat16* __restrict__ y, int M, int N, int K, int ldy) {
  extern __shared__ unsigned char smem[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t a_tiles = base;
  const uint32_t b_tiles = a_tiles + STAGES * A_BYTES;
  const uint32_t full_bar = b_tiles + STAGES * B_BYTES;
  const uint32_t empty_bar = full_bar + STAGES * 8;

  // Grouped order: GROUP_M tiles down M, then the next column of N.
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * GROUP_M;
  const int group_rows = min(tiles_m - first_m, GROUP_M);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % group_rows) * BM;
  const int n0 = in_group / group_rows * BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty_bar + 8 * s, (kt / STAGES - 1) & 1);
        const uint32_t full = full_bar + 8 * s;
        // Boxes past the matrix are filled with zeros and still count
        // their bytes, so every stage expects the same.
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load_2d(a_tiles + s * A_BYTES, &map_h, full, kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / B_BOX; ++j)
          tma_load_2d(b_tiles + s * B_BYTES + j * B_BOX_BYTES, &map_w, full,
                      n0 + j * B_BOX, kt * BK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      // A: this consumer's 64 rows, 128 bytes each, 8-row groups 1024
      // bytes apart (SBO); a step of 16 along K moves 32 bytes inside the
      // swizzled row. B: 64-column boxes 8 KiB apart (LBO), 8-row groups of
      // K 1024 bytes apart (SBO); a step of 16 along K moves 16 rows.
      const uint32_t a = a_tiles + s * A_BYTES + c * 64 * BK * 2;
      const uint32_t b = b_tiles + s * B_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, smem_desc(a + kk * 32, 1, 64),
                         smem_desc(b + kk * 16 * B_BOX * 2, B_BOX_BYTES / 16, 64));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // The group of the previous slice is done: release its stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty_bar + 8 * ((kt - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16w + lane/4 and 16w + lane/4 + 8; register 4j + {0,1} (first row)
    // and 4j + {2,3} (second row) hold columns 8j + 2*(lane%4) + {0,1}.
    const int lane = threadIdx.x % 32;
    const int row = m0 + c * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    if constexpr (!kStrided) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < N) {  // N is even, so col + 1 < N too
          if (row < M) store_pair(y, N, row, col, acc[4 * j], acc[4 * j + 1]);
          if (row + 8 < M) store_pair(y, N, row + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    } else {
      // col is even, so a pair starts 4-byte aligned where ldy is even.
      const bool pairs =
          ldy % 2 == 0 && reinterpret_cast<std::uintptr_t>(y) % 4 == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < N) {
          if (row < M)
            store_strided(y, N, ldy, pairs, row, col, acc[4 * j], acc[4 * j + 1]);
          if (row + 8 < M)
            store_strided(y, N, ldy, pairs, row + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, looked up once.
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  static cudaError_t err = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
    return cudaSuccess;
  }();
  *fn = found;
  return err;
}

// A 2-D bf16 row-major matrix (rows x cols, row stride ld elements) read in
// boxes of box_cols x box_rows, 128-byte swizzled, zeros past its edge.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  uint64_t rows, uint64_t cols, uint64_t ld, uint32_t box_cols,
                  uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Launch the kernel on `stream` once the caller has checked the arguments.
// K = 0 reads nothing: the maps stay zero and are never used.
template <bool kStrided>
int launch(const void* h, const void* w, void* y, int M, int N, int K, int ldh, int ldw,
           int ldy, void* stream) {
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);

  // The CUDA driver's encode needs a current context, and a thread that has only
  // launched on cached allocations may have none yet: setting the current
  // device makes its primary context current on this thread.
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_h{}, map_w{};
  if (K > 0) {
    EncodeTiled encode;
    err = encode_tiled(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    CUresult res = make_map(encode, &map_h, h, M, K, ldh, BK, BM);
    if (res == CUDA_SUCCESS) res = make_map(encode, &map_w, w, K, N, ldw, B_BOX, BK);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }

  err = cudaFuncSetAttribute(tanh_matmul_sm90_kernel<kStrided>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  tanh_matmul_sm90_kernel<kStrided><<<static_cast<unsigned>(tiles), THREADS, SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(
      map_h, map_w, static_cast<__nv_bfloat16*>(y), M, N, K, ldy);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes != 0;
}

}  // namespace

// Launch y = tanh(h @ w) on `stream` (a cudaStream_t, or null for the
// legacy default stream). h is (M,K), w is (K,N), y is (M,N), all bf16,
// row-major and contiguous; K and N multiples of 8, K > 0, h, w and y
// 16-byte aligned. Returns 0, a cudaError_t (> 0), or minus the CUresult
// of a failed tensor-map encode (< 0).
extern "C" int tanh_matmul_bf16_sm90(const void* h, const void* w, void* y, int M,
                                     int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || misaligned(h, 16) ||
      misaligned(w, 16) || misaligned(y, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(h, w, y, M, N, K, K, N, N, stream);
}

// The same product at row strides of their own: h (M,K) at row stride ldh,
// w (K,N) at ldw, y (M,N) at ldy, in elements. Any K >= 0 and N; for K > 0,
// ldh and ldw multiples of 8 at least K and N, h and w 16-byte aligned (what
// TMA demands); y 2-byte aligned, ldy >= N. Returns as tanh_matmul_bf16_sm90.
extern "C" int tanh_matmul_bf16_sm90_strided(const void* h, const void* w, void* y, int M,
                                             int N, int K, int ldh, int ldw, int ldy,
                                             void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || ldy < N || misaligned(y, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > 0 && (ldh < K || ldw < N || ldh % 8 != 0 || ldw % 8 != 0 ||
                misaligned(h, 16) || misaligned(w, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(h, w, y, M, N, K, ldh, ldw, ldy, stream);
}
