// p = bf16(f32(p) - f32(bf16(lr * g))) in place: the parameter update of
// the dp x tp training step, in one pass over p and g.
//
// Replaces the update that XLA fuses on the TPU,
// tpu_pod_exporter/loadgen/sharded.py:103-107 (step's tree_map):
// (p.astype(f32) - lr * g).astype(bf16), with p and g bf16 and lr a Python
// float. JAX's weak typing rounds lr to bf16 and lr * g to bf16 before the
// f32 subtraction. This kernel takes lr already rounded to bf16 (as a
// float, which holds it exactly) and rounds at the same places: the product
// of two bf16 values is exact in f32, so rounding it once gives JAX's
// bf16 product, and the f32 difference is rounded once to bf16. It agrees
// with the JAX update, and with sgd_update_plain, bit for bit.
//
// In place: the JAX step donates its parameters (donate_argnums=(0,),
// sharded.py:114), which lets XLA write the new parameters over the old.
// Here p is overwritten, and no second copy of the layers is made.
//
// Bound on an H100 SXM at the full size (8 layers of 8192 x 8192 bf16,
// 536,870,912 elements): p read and written and g read, 3 GiB in all, take
// 0.962 ms at 3.35 TB/s; three operations an element are nothing beside
// that. So memory bounds it, and the design moves each byte once with the
// widest load a thread can make: 16 bytes (8 values) of p and of g a
// thread, in a grid-stride loop over a grid sized to fill the card, when
// both are 16-byte aligned; the last n % 8 elements, or all of them when
// either pointer is not aligned, one by one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads, an SM's most

__device__ __forceinline__ __nv_bfloat16 updated(__nv_bfloat16 p, __nv_bfloat16 g,
                                                 float lr) {
  const __nv_bfloat16 step = __float2bfloat16_rn(lr * __bfloat162float(g));
  return __float2bfloat16_rn(__bfloat162float(p) - __bfloat162float(step));
}

// Two bf16 values packed in a 32-bit word, the first in the low half.
__device__ __forceinline__ unsigned updated2(unsigned p2, unsigned g2, float lr) {
  const unsigned short lo = __bfloat16_as_ushort(
      updated(__ushort_as_bfloat16(static_cast<unsigned short>(p2 & 0xffffu)),
              __ushort_as_bfloat16(static_cast<unsigned short>(g2 & 0xffffu)), lr));
  const unsigned short hi = __bfloat16_as_ushort(
      updated(__ushort_as_bfloat16(static_cast<unsigned short>(p2 >> 16)),
              __ushort_as_bfloat16(static_cast<unsigned short>(g2 >> 16)), lr));
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sgd_update_kernel(__nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ g,
                  long long n, float lr) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long chunks = n / 8;
    uint4* const pv = reinterpret_cast<uint4*>(p);
    const uint4* const gv = reinterpret_cast<const uint4*>(g);
    for (long long i = tid; i < chunks; i += stride) {
      uint4 a = pv[i];
      const uint4 b = gv[i];
      a.x = updated2(a.x, b.x, lr);
      a.y = updated2(a.y, b.y, lr);
      a.z = updated2(a.z, b.z, lr);
      a.w = updated2(a.w, b.w, lr);
      pv[i] = a;
    }
    done = chunks * 8;
  }
  for (long long i = done + tid; i < n; i += stride) p[i] = updated(p[i], g[i], lr);
}

}  // namespace

// Update p (n bf16 values) in place from g (n bf16 values) on `stream` (a
// cudaStream_t, or null for the legacy default stream); lr is the learning
// rate already rounded to bf16. p and g must not overlap. Returns the
// cudaError_t of the launch.
extern "C" int sgd_update_bf16(void* p, const void* g, long long n, float lr,
                               void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const long long items = vec ? std::max(n / 8, n % 8) : n;
  const long long blocks = std::min<long long>((items + THREADS - 1) / THREADS,
                                               static_cast<long long>(sms) * BLOCKS_PER_SM);
  auto* pp = static_cast<__nv_bfloat16*>(p);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    sgd_update_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(pp, gp, n, lr);
  } else {
    sgd_update_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(pp, gp, n, lr);
  }
  return static_cast<int>(cudaGetLastError());
}
