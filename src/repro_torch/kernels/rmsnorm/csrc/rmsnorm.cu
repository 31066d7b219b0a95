// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:rmsnorm
// (_rmsnorm_kernel). Same function: the mean of squares is reduced in
// fp32, the scale is read as fp32, the output is written in x's dtype.
//
// What bounds it on this card: bytes. Each element is read once and
// written once and costs three flops, far below the H100's ~295 flops per
// byte, so the least time is (2 * rows * d * sizeof(T) + 4 * d) / 3.35 TB/s.
//
// Design: one CTA of 128 threads (one warp group) per row. The TPU tiled
// many rows per grid step to fill VMEM; here the rows are the grid, so
// the 8 rows of a decode step and the thousands of a prefill both spread
// over the SMs. Loads and stores are 16-byte vectors when the row allows
// it (d a multiple of the vector width, pointers 16-byte aligned), else
// scalar. The sum of squares is a warp-shuffle fp32 reduction followed by
// one shared-memory step across the four warps. The second pass re-reads
// the row, which the first pass just brought into L1/L2, so device
// memory sees each byte once. The kernel allocates nothing and runs on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  return total;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float partial[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)d;
  T* yr = out + row * (size_t)d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / N; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss, partial) / (float)d + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / N; i += kThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < N; ++j)
        o[j] = from_f32<T>((to_f32(e[j]) * inv) * scale[i * N + j]);
      yv[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      yr[i] = from_f32<T>((to_f32(xr[i]) * inv) * scale[i]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = d % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)rows);
  if (vec)
    rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16.
// scale: (d,) float32. Returns 0, a cudaError_t, or a negative code.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale,
                              void* out, long long rows, int d, float eps,
                              void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return kErrBadArgs;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) return launch<float>(x, s, out, rows, d, eps, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(x, s, out, rows, d, eps, st);
  return kErrDtype;
}

extern "C" const char* rmsnorm_error_string(int code) {
  if (code == kErrBadArgs) return "rmsnorm: rows must be in [1, 2^31), d >= 1";
  if (code == kErrDtype) return "rmsnorm: dtype must be float32 or bfloat16";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
