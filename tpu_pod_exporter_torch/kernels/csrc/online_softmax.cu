// One step of ring attention's running softmax, in place, one block a row.
//
// Replaces the body that XLA fuses on the TPU inside ring attention's scan,
// tpu_pod_exporter/loadgen/parallel.py:88-95 (ring_attention_fn.local_block
// .body). With r = q @ kb.T already taken (a plain product), one step is
//
//   s     = r / sqrt(f32(d))
//   m_new = max(m, rowmax(s))
//   corr  = exp(m - m_new)
//   p     = exp(s - m_new)
//   l     = l * corr + rowsum(p)
//   o     = o * corr              (the caller then adds p @ vb, a product)
//
// and this kernel does all of it in one launch: p is written over r, m and
// l are updated, and o's row is multiplied by corr. The division is a true
// f32 division and sqrt a correctly rounded sqrtf, as JAX's (the build has
// no fast math), so m agrees with the plain version exactly and p and l to a
// few f32 ulps (expf against torch.exp, and another order of the row sum).
//
// The first step has m = -inf and l = 0: corr = expf(-inf) = 0, so l
// becomes the row sum and o (zeros) stays zero, as in JAX.
//
// Bound on an H100 SXM at the main-path shape (Tq = Tkv = 4096, o 4096 x
// 8192): r read and written (2 x 64 MiB) and o read and written (2 x 128
// MiB), 384 MiB in all, take 0.120 ms at 3.35 TB/s; a few operations an
// element are nothing beside that. So memory bounds it, and the design
// reads each byte of r once: a block takes one row, keeps its scaled
// scores in shared memory (Tkv floats, 16 KiB at Tkv = 4096) between the
// max and the exponentials, and writes p once. Loads are coalesced, one
// float a thread; wider loads and several rows a block are later work.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The butterfly leaves the same sum in every lane (IEEE addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Max of v over the block, in every thread. `scratch` holds WARPS floats.
__device__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < WARPS ? scratch[threadIdx.x & 31] : -INFINITY;
  v = warp_max(v);
  __syncthreads();  // scratch may be written again
  return v;
}

// Sum of v over the block, in every thread.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < WARPS ? scratch[threadIdx.x & 31] : 0.0f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(THREADS)
online_softmax_kernel(float* __restrict__ r, float* __restrict__ m, float* __restrict__ l,
                      float* __restrict__ o, int tkv, int dv, float denom) {
  extern __shared__ float s[];  // this row's scaled scores
  __shared__ float scratch[WARPS];
  const long long row = blockIdx.x;
  float* const rr = r + row * tkv;

  float mx = -INFINITY;
  for (int j = threadIdx.x; j < tkv; j += THREADS) {
    const float v = rr[j] / denom;
    s[j] = v;
    mx = fmaxf(mx, v);
  }
  const float m_old = m[row];
  const float m_new = fmaxf(m_old, block_max(mx, scratch));

  // Each thread reads back only the scores it wrote itself.
  float sum = 0.0f;
  for (int j = threadIdx.x; j < tkv; j += THREADS) {
    const float p = expf(s[j] - m_new);
    rr[j] = p;
    sum += p;
  }
  sum = block_sum(sum, scratch);

  const float corr = expf(m_old - m_new);
  float* const orow = o + row * dv;
  for (int j = threadIdx.x; j < dv; j += THREADS) orow[j] *= corr;
  if (threadIdx.x == 0) {
    m[row] = m_new;
    l[row] = l[row] * corr + sum;
  }
}

}  // namespace

// One running-softmax step on `stream` (a cudaStream_t, or null for the
// legacy default stream): r (tq, tkv) f32 scores becomes p in place; m and
// l (tq,) f32 are updated; o (tq, dv) f32 is multiplied row by row by corr.
// All four are contiguous and do not overlap; d is the width the scores are
// scaled by (s = r / sqrt(d)). A row of tkv floats must fit in a block's
// shared memory (227 KiB: tkv <= 58,104). Returns the cudaError_t of the
// launch.
extern "C" int online_softmax_f32(void* r, void* m, void* l, void* o, int tq, int tkv,
                                  int dv, int d, void* stream) {
  if (tq < 0 || tkv < 1 || dv < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tq == 0) return 0;
  const size_t smem = static_cast<size_t>(tkv) * sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KiB a block gets dynamic shared memory only when asked for.
    const cudaError_t err = cudaFuncSetAttribute(
        online_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float denom = sqrtf(static_cast<float>(d));
  online_softmax_kernel<<<static_cast<unsigned>(tq), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(r), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(o), tkv, dv, denom);
  return static_cast<int>(cudaGetLastError());
}
