// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:rmsnorm
// (_rmsnorm_kernel). Same function: the mean of squares is reduced in
// fp32, the scale is read as fp32, the output is written in x's dtype.
//
// What bounds it on this card: bytes at many rows, latency at few. Each
// element is read once and written once and costs three flops, far below
// the H100's ~295 flops per byte, so the least time is
// (2 * rows * d * sizeof(T) + 4 * d) / 3.35 TB/s; at the decode step's 8
// rows that is under 0.1 us, and the time is the launch and the chain of
// memory round trips a row takes.
//
// Design: one trip to memory per row. A row group of `tpr` threads (a
// multiple of 32) owns one row; thread t holds the row's 16-byte vectors
// t, t + tpr, ..., VPT of them, in registers: it issues all its loads
// before it uses any, sums their squares, and after the row's sum scales
// the same registers and stores them, so device memory sees x once and
// pass 2 reads nothing but `scale` (as float4, from L1/L2). The host's
// plan (kernel.py plan_rows) picks tpr and VPT: few rows get one CTA a
// row of up to 256 threads (at 8 rows of 4096, 256 threads of 2 bf16
// vectors beat 512 of 1 and 128 of 4); many rows get a few warps a row,
// up to 8 vectors a thread, and several rows a CTA (at 8192 rows of 4096
// bf16, 8 vectors a thread over 2 warps beat 16 over 1: 126 registers a
// thread held 16 warps an SM). Rows wider than 256 threads of 8 vectors
// take up to kMaxThreads threads of up to 16. The sum
// is a warp-shuffle tree, plus one shared-memory step across the row's
// warps when tpr > 32, in a fixed order: a repeat is bitwise, no float
// atomics. Where VPT * N <= 16 the scale is loaded before x.
//
// Rows the registers cannot hold (past 16 vectors a thread of kMaxThreads),
// a d that is not a multiple of the vector width and a misaligned x go to
// the loop kernel: one CTA of kLoopThreads a row, two passes over the row
// (the second from L1/L2), 16-byte vectors where the row allows.
//
// Both kernels are launched with programmatic stream serialization
// (programmatic dependent launch): a CTA may start while the kernel
// before it in the stream finishes, loads what does not depend on it
// (the scale), and waits (griddepcontrol.wait) before it reads x.
// The kernels allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoopThreads = 256;
constexpr int kMaxThreads = 512;   // of a CTA of the register path
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;
constexpr int kErrPlan = -3;

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

// Wait for the kernel before this one in the stream (a no-op when the
// launch was not programmatic).
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The sum of v over a row group of tpr threads (tpr a multiple of 32,
// rows packed tpr threads apart): shuffles, then one shared-memory step
// in warp order when the row spans warps. Every thread of the CTA must
// call it.
__device__ __forceinline__ float row_sum(float v, int tpr, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr == 32) return v;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  const int w0 = (threadIdx.x / tpr) * (tpr >> 5);
  float total = 0.f;
  for (int w = 0; w < (tpr >> 5); ++w) total += partial[w0 + w];
  return total;
}

template <typename T>
__device__ __forceinline__ uint4 scale_vec(uint4 raw, float inv,
                                           const float4* s) {
  constexpr int N = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  const float* sf = reinterpret_cast<const float*>(s);
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int j = 0; j < N; ++j)
    o[j] = from_f32<T>((to_f32(e[j]) * inv) * sf[j]);
  return res;
}

// The register path: rows of d = nv * N elements, x and out 16-byte
// aligned, nv <= VPT * tpr, blockDim.x = rows a CTA * tpr.
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, long long rows, int d, int tpr,
                   float eps) {
  constexpr int N = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int Q = N / 4;            // float4 of scale per vector
  constexpr bool kEarly = VPT * N <= 16;
  __shared__ float partial[kMaxWarps];
  const int nv = d / N;
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const float4* s4 = reinterpret_cast<const float4*>(scale);

  float4 s[kEarly ? VPT * Q : 1];
  if (kEarly) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = t + k * tpr;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        s[k * Q + q] = i < nv ? s4[i * Q + q] : make_float4(0, 0, 0, 0);
    }
  }
  wait_for_previous_kernel();

  const uint4* xv = reinterpret_cast<const uint4*>(x + row * (size_t)d);
  uint4 v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = t + k * tpr;
    v[k] = live && i < nv ? xv[i] : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const T* e = reinterpret_cast<const T*>(&v[k]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(row_sum(ss, tpr, partial) / (float)d + eps);
  if (!live) return;

  uint4* yv = reinterpret_cast<uint4*>(out + row * (size_t)d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = t + k * tpr;
    if (i >= nv) continue;
    if (kEarly) {
      yv[i] = scale_vec<T>(v[k], inv, &s[k * Q]);
    } else {
      float4 sk[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) sk[q] = s4[i * Q + q];
      yv[i] = scale_vec<T>(v[k], inv, sk);
    }
  }
}

// The loop path: one CTA of kLoopThreads per row, any d; 16-byte vectors
// when kVec (d a multiple of N, x and out 16-byte aligned), else scalars.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kLoopThreads)
    rmsnorm_kernel_loop(const T* __restrict__ x,
                        const float* __restrict__ scale, T* __restrict__ out,
                        int d, float eps) {
  constexpr int N = 16 / sizeof(T);
  constexpr int Q = N / 4;
  __shared__ float partial[kLoopThreads / 32];
  const T* xr = x + blockIdx.x * (size_t)d;
  T* yr = out + blockIdx.x * (size_t)d;
  wait_for_previous_kernel();

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / N; i += kLoopThreads) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float inv =
      rsqrtf(row_sum(ss, kLoopThreads, partial) / (float)d + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / N; i += kLoopThreads) {
      float4 sk[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) sk[q] = s4[i * Q + q];
      yv[i] = scale_vec<T>(xv[i], inv, sk);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads)
      yr[i] = from_f32<T>((to_f32(xr[i]) * inv) * scale[i]);
  }
}

template <typename... Params, typename... Args>
int launch_programmatic(void (*kernel)(Params...), unsigned grid,
                        unsigned threads, cudaStream_t stream,
                        Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clear it either way
  return (int)(rc != cudaSuccess ? rc : last);
}

template <typename T, int VPT>
int launch_rows(const void* x, const float* scale, void* out,
                long long rows, int d, int tpr, int rpc, float eps,
                cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  if (rpc * tpr > kMaxThreads || (long long)VPT * tpr < d / N)
    return kErrPlan;
  const long long ctas = (rows + rpc - 1) / rpc;
  if (ctas > 0x7fffffffLL) return kErrBadArgs;
  return launch_programmatic(rmsnorm_kernel<T, VPT>, (unsigned)ctas,
                             (unsigned)(rpc * tpr), st,
                             static_cast<const T*>(x), scale,
                             static_cast<T*>(out), rows, d, tpr, eps);
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, int vpt, int tpr, int rpc, float eps, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (vpt == 0) {
    if (tpr != kLoopThreads || rpc != 1 || rows > 0x7fffffffLL)
      return kErrPlan;
    if (aligned && d % N == 0)
      return launch_programmatic(rmsnorm_kernel_loop<T, true>,
                                 (unsigned)rows, kLoopThreads, st,
                                 static_cast<const T*>(x), scale,
                                 static_cast<T*>(out), d, eps);
    return launch_programmatic(rmsnorm_kernel_loop<T, false>,
                               (unsigned)rows, kLoopThreads, st,
                               static_cast<const T*>(x), scale,
                               static_cast<T*>(out), d, eps);
  }
  if (!aligned || d % N || tpr < 32 || tpr % 32 || rpc < 1) return kErrPlan;
  switch (vpt) {
    case 1: return launch_rows<T, 1>(x, scale, out, rows, d, tpr, rpc, eps, st);
    case 2: return launch_rows<T, 2>(x, scale, out, rows, d, tpr, rpc, eps, st);
    case 4: return launch_rows<T, 4>(x, scale, out, rows, d, tpr, rpc, eps, st);
    case 8: return launch_rows<T, 8>(x, scale, out, rows, d, tpr, rpc, eps, st);
    case 16:
      return launch_rows<T, 16>(x, scale, out, rows, d, tpr, rpc, eps, st);
  }
  return kErrPlan;
}

}  // namespace

// x, out: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16; out and
// scale 16-byte aligned, x any alignment of its dtype. scale: (d,)
// float32. The plan (kernel.py plan_rows): vpt vectors a thread (0: the
// loop kernel), tpr threads a row, rpc rows a CTA. Returns 0, a
// cudaError_t, or a negative code.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale,
                              void* out, long long rows, int d, float eps,
                              int vpt, int tpr, int rpc, void* stream) {
  if (rows < 1 || d < 1) return kErrBadArgs;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch<float>(x, s, out, rows, d, vpt, tpr, rpc, eps, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(x, s, out, rows, d, vpt, tpr, rpc, eps, st);
  return kErrDtype;
}

extern "C" const char* rmsnorm_error_string(int code) {
  if (code == kErrBadArgs)
    return "rmsnorm: rows must be in [1, 2^31 * rows a CTA), d >= 1";
  if (code == kErrDtype) return "rmsnorm: dtype must be float32 or bfloat16";
  if (code == kErrPlan)
    return "rmsnorm: the launch plan does not fit the shape or alignment";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
