// y = tanh(h @ W) in one kernel: bf16 operands, f32 accumulation, tanh on
// the f32 sum, one round to bf16 on the store.
//
// Replaces the layer body that XLA fuses on the TPU,
// tpu_pod_exporter/loadgen/workload.py:40-43 (forward.layer), run once per
// layer of every forward.
//
// Bound on an H100 SXM at the main-path shape (M=4096, K=N=8192): the
// product is 2*M*N*K = 5.5e11 operations, 0.56 ms at the 989 TFLOP/s dense
// bf16 peak, while its 256 MiB of operands and result take 0.08 ms at
// 3.35 TB/s. So it is bound by the tensor cores, and the design keeps them
// fed from shared memory and keeps the f32 result out of device memory:
//
// - block tile 128x128 over 8 warps (2 along M, 4 along N), each warp a
//   64x32 tile held as 4x2 wmma 16x16x16 bf16 fragments with f32
//   accumulators in registers;
// - K walked in slices of 32, staged through shared memory in two buffers:
//   cp.async fills the next slice while the tensor cores consume this one;
// - the epilogue stages each accumulator fragment through a per-warp patch
//   of shared memory, applies tanhf to the f32 value and stores bf16 with
//   __float2bfloat16_rn, so the pre-activation never reaches device memory;
// - any M, N, K: a 16-byte chunk that lies inside the matrix (and whose
//   rows are 16-byte aligned) is copied with cp.async, every other chunk
//   element by element with zeros past the edge; stores are masked.
//
// Layout is the JAX package's: h (M,K), W (K,N) indexed [in, out], y (M,N),
// all row-major and contiguous. The main path runs tanh_matmul_sm90.cu
// (wgmma fed by TMA); this kernel takes the shapes TMA cannot address: K or
// N not a multiple of 8, a misaligned h or W, K = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int FM = WM / 16;       // 4 fragments along M
constexpr int FN = WN / 16;       // 2 fragments along N
// Row pitch of the staged tiles, padded by 8 elements (16 bytes) against
// bank conflicts; wmma wants a multiple of 8 for 16-bit types.
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;  // elements
constexpr int B_STAGE = BK * B_LD;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = WARPS_M * WARPS_N * 16 * 16 * 4;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(EPI_BYTES <= SMEM_BYTES, "epilogue reuses the tile buffers");
static_assert((BM * BK / 8) % THREADS == 0, "A chunks per thread");
static_assert((BK * BN / 8) % THREADS == 0, "B chunks per thread");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the rows x cols tile of src (ld columns, nrows x ncols in all) at
// (r0, c0) into dst (pitch dld). Each thread moves chunks of 8 elements.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int dld,
                                          const __nv_bfloat16* __restrict__ src,
                                          int nrows, int ncols, int r0, int c0,
                                          bool vec) {
  constexpr int CHUNKS_PER_ROW = COLS / 8;
  constexpr int CHUNKS = ROWS * CHUNKS_PER_ROW;
#pragma unroll
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int r = c / CHUNKS_PER_ROW;
    const int col = (c % CHUNKS_PER_ROW) * 8;
    const int gr = r0 + r;
    const int gc = c0 + col;
    __nv_bfloat16* d = dst + r * dld + col;
    if (vec && gr < nrows && gc + 8 <= ncols) {
      cp_async16(d, src + static_cast<size_t>(gr) * ncols + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < nrows && gc + e < ncols)
                   ? src[static_cast<size_t>(gr) * ncols + gc + e]
                   : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tanh_matmul_kernel(const __nv_bfloat16* __restrict__ h,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K,
                   bool vec_h, bool vec_w) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* const a_tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const b_tiles = a_tiles + STAGES * A_STAGE;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  fragment<accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = (K + BK - 1) / BK;
  if (k_tiles > 0) {
    load_tile<BM, BK>(a_tiles, A_LD, h, M, K, m0, 0, vec_h);
    load_tile<BK, BN>(b_tiles, B_LD, w, K, N, 0, n0, vec_w);
  }
  cp_async_commit();

  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      const int s = (kt + 1) % STAGES;
      load_tile<BM, BK>(a_tiles + s * A_STAGE, A_LD, h, M, K, m0,
                        (kt + 1) * BK, vec_h);
      load_tile<BK, BN>(b_tiles + s * B_STAGE, B_LD, w, K, N, (kt + 1) * BK,
                        n0, vec_w);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* a_s = a_tiles + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* b_s = b_tiles + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> a[FM];
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        nvcuda::wmma::load_matrix_sync(a[i], a_s + (wm * WM + i * 16) * A_LD + kk,
                                       A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::load_matrix_sync(b[j], b_s + kk * B_LD + wn * WN + j * 16,
                                       B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // The next iteration overwrites the buffer just read.
    __syncthreads();
  }

  // Epilogue: the tile buffers are free (the loop ends on a barrier), so
  // each warp takes a 16x16 f32 patch of them to turn fragments into rows.
  float* patch = reinterpret_cast<float*>(smem) + warp * 16 * 16;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      nvcuda::wmma::store_matrix_sync(patch, acc[i][j], 16, mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * WM + i * 16;
      const int c0 = n0 + wn * WN + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + e * 32;
        const int gr = r0 + idx / 16;
        const int gc = c0 + idx % 16;
        if (gr < M && gc < N) {
          y[static_cast<size_t>(gr) * N + gc] = __float2bfloat16_rn(tanhf(patch[idx]));
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Launch y = tanh(h @ w) on `stream` (a cudaStream_t, or null for the
// legacy default stream). h is (M,K), w is (K,N), y is (M,N), all bf16,
// row-major and contiguous. Returns the cudaError_t of the launch.
extern "C" int tanh_matmul_bf16(const void* h, const void* w, void* y, int M,
                                int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_h = K % 8 == 0 && reinterpret_cast<std::uintptr_t>(h) % 16 == 0;
  const bool vec_w = N % 8 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tanh_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), M, N, K, vec_h, vec_w);
  return static_cast<int>(cudaGetLastError());
}
