// Copy a (rows, cols) bf16 matrix, row-major and contiguous at any 2-byte
// aligned base, into a buffer whose rows are ld = roundup(cols, 8) elements
// apart at a 16-byte-aligned base, with zeros in the pad columns.
//
// It serves the staged route of tanh_matmul (kernels/tanh_matmul.py), which
// replaces the same TPU layer body as tanh_matmul_sm90.cu,
// tpu_pod_exporter/loadgen/workload.py:40-43, at the shapes TMA cannot
// address as they lie: an operand whose row stride is not a multiple of 16
// bytes (K or N not a multiple of 8) or whose base is not 16-byte aligned is
// copied here first, and the wgmma kernel reads the copy through TMA.
//
// Bound: it moves rows*cols*2 bytes in and rows*ld*2 bytes out, and does no
// arithmetic, so the memory rate bounds it. At 3.35 TB/s, w at 8190 x 8190
// (134.2 MB read, 134.2 MB written) takes 0.080 ms; h at 4096 x 8190
// (67.1 MB each way) 0.040 ms. The design: one thread writes one 16-byte
// chunk of the destination with one store, after gathering its 8 values
// with 2-byte loads. Neighbouring threads take neighbouring chunks, so a
// warp's loads cover one span of 512 contiguous bytes of the source (the
// L1 keeps the lines between a thread's 8 loads) and its stores 512
// contiguous bytes of the destination. The pad columns of a row's last
// chunk are written as zeros and never read from the source. A grid-stride
// loop covers any number of chunks.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;

__global__ void __launch_bounds__(THREADS)
stage_rows_kernel(const unsigned short* __restrict__ src, uint4* __restrict__ dst,
                  long long rows, int cols, int chunks_per_row) {
  const long long total = rows * chunks_per_row;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; c < total;
       c += step) {
    const long long row = c / chunks_per_row;
    const int col0 = static_cast<int>(c - row * chunks_per_row) * 8;
    const unsigned short* s = src + row * cols + col0;
    unsigned short v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = col0 + i < cols ? __ldg(s + i) : 0;
    dst[c] = make_uint4(v[0] | static_cast<unsigned>(v[1]) << 16,
                        v[2] | static_cast<unsigned>(v[3]) << 16,
                        v[4] | static_cast<unsigned>(v[5]) << 16,
                        v[6] | static_cast<unsigned>(v[7]) << 16);
  }
}

}  // namespace

// Launch the copy of src (rows, cols) into dst (rows, ld) on `stream` (a
// cudaStream_t, or null for the legacy default stream); bf16 bits are
// copied as they are. src 2-byte aligned, dst 16-byte aligned, ld a
// multiple of 8 and at least cols. Returns 0 or a cudaError_t.
extern "C" int stage_rows_bf16(const void* src, void* dst, long long rows, int cols, int ld,
                               void* stream) {
  if (rows < 0 || cols < 0 || ld < cols || ld % 8 != 0 ||
      reinterpret_cast<std::uintptr_t>(src) % 2 != 0 ||
      reinterpret_cast<std::uintptr_t>(dst) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * (ld / 8);
  if (total == 0) return 0;
  const long long blocks = std::min((total + THREADS - 1) / THREADS, MAX_BLOCKS);
  stage_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(src), static_cast<uint4*>(dst), rows, cols, ld / 8);
  return static_cast<int>(cudaGetLastError());
}
