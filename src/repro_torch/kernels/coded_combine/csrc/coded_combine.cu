// The coded gradient combine for Hopper (sm_90a): three streaming
// weighted row-sums over an (n, D) payload, out[i] = sum_b u[b] * x[b][i].
//
// Replaces the TPU kernels of repro/kernels/coded_combine/kernel.py:
//   coded_combine        (_combine_kernel)             x = gradient rows,
//                        f32 or bf16, u = the decode weights w, output
//                        in the gradients' dtype;
//   quantized_combine    (_quantized_combine_kernel)   x = an int8 (or
//                        f32) codec payload, u = w * scales folded by the
//                        caller, float32 output;
//   packed_sign_combine  (_packed_sign_combine_kernel) x = +-1 signs
//                        unpacked from little-endian uint8 bit planes
//                        (bit k of byte j is component 8j + k), float32
//                        output, positions >= d dropped.
//
// What bounds them on this card: bytes. Each payload byte is read once
// and each output written once, for 2 flops per component and row, far
// below the H100's ~295 flops per byte; the least time is
// (n * D * sizeof(x) + D * sizeof(out)) / 3.35 TB/s.
//
// Design. The Pallas kernels tile D into VMEM strips walked by a
// sequential grid; here every thread owns whole output positions of a
// grid-stride loop over D and walks the n rows itself, b = 0..n-1 in
// order, with one fp32 accumulator per position. Loads are 16-byte
// vectors when every row is 16-byte aligned (D a multiple of the vector
// width, base pointers aligned), else scalar. The packed kernel gives
// each thread whole payload bytes: it unpacks a byte to 8 positions in
// registers and stores them as two 16-byte vectors, masking the tail.
// Every multiply and add is rounded on its own (__fmul_rn, __fadd_rn:
// no FMA contraction), so the result is the plain torch chain
// `acc = acc + u[b] * x[b]` bit for bit, whatever the input; a dead row
// (u[b] = 0) adds exact zeros. Offsets are 64-bit (n * D reaches
// 4 x 104.9 M on the training path). No atomics: results are
// deterministic. The kernels allocate nothing and run on the caller's
// stream; each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 CTAs per SM, H100 SXM
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

// One 16-byte vector of x per row, VEC = 16 / sizeof(TIn) positions.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    combine_vec(const TIn* __restrict__ x, const float* __restrict__ u,
                TOut* __restrict__ out, int n, long long d) {
  constexpr int VEC = 16 / sizeof(TIn);
  static_assert((VEC * sizeof(TOut)) % 16 == 0, "output vector width");
  const long long nvec = d / VEC;
  for (long long v = first_index(); v < nvec; v += grid_stride()) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const TIn* col = x + v * VEC;
#pragma unroll 4
    for (int b = 0; b < n; ++b) {
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(
          col + (long long)b * d));
      const TIn* e = reinterpret_cast<const TIn*>(&raw);
      const float ub = __ldg(u + b);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(ub, to_f32(e[j])));
    }
    constexpr int kChunks = VEC * sizeof(TOut) / 16;
    constexpr int kPer = 16 / sizeof(TOut);
    uint4* dst = reinterpret_cast<uint4*>(out + v * VEC);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      uint4 res;
      TOut* o = reinterpret_cast<TOut*>(&res);
#pragma unroll
      for (int j = 0; j < kPer; ++j) o[j] = from_f32<TOut>(acc[c * kPer + j]);
      dst[c] = res;
    }
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    combine_scalar(const TIn* __restrict__ x, const float* __restrict__ u,
                   TOut* __restrict__ out, int n, long long d) {
  for (long long i = first_index(); i < d; i += grid_stride()) {
    float acc = 0.f;
    for (int b = 0; b < n; ++b)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(u + b),
                                     to_f32(x[(long long)b * d + i])));
    out[i] = from_f32<TOut>(acc);
  }
}

// One payload byte (8 output positions) per thread and grid step.
__global__ void __launch_bounds__(kThreads)
    packed_sign_kernel(const uint8_t* __restrict__ q,
                       const float* __restrict__ u, float* __restrict__ out,
                       int n, long long db, long long d) {
  for (long long j = first_index(); j < db; j += grid_stride()) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int b = 0; b < n; ++b) {
      const unsigned byte = __ldcs(q + (long long)b * db + j);
      const float ub = __ldg(u + b);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] = __fadd_rn(acc[k], ((byte >> k) & 1u) ? ub : -ub);
    }
    const long long o = 8 * j;
    if (o + 8 <= d) {  // out is 16-byte aligned, so is out + 8j
      float4* dst = reinterpret_cast<float4*>(out + o);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (o + k < d) out[o + k] = acc[k];
    }
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* u, void* out, int n, long long d,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TIn);
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* ot = static_cast<TOut*>(out);
  if (d % VEC == 0 && aligned16(x) && aligned16(out))
    combine_vec<TIn, TOut><<<blocks_for(d / VEC), kThreads, 0, stream>>>(
        xt, u, ot, n, d);
  else
    combine_scalar<TIn, TOut><<<blocks_for(d), kThreads, 0, stream>>>(
        xt, u, ot, n, d);
  return (int)cudaGetLastError();
}

bool bad(int n, long long d) { return n < 1 || d < 1; }

}  // namespace

// grads: (n, d) contiguous, dtype 0 = float32, 1 = bfloat16; w: (n,)
// float32; out: (d,) in the grads' dtype. Returns 0, a cudaError_t, or a
// negative code for a rejected argument.
extern "C" int coded_combine_launch(int dtype, const void* grads,
                                    const void* w, void* out, int n,
                                    long long d, void* stream) {
  if (bad(n, d)) return kErrBadArgs;
  const float* wf = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float, float>(grads, wf, out, n, d, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(grads, wf, out, n, d, st);
  return kErrDtype;
}

// q: (n, d) contiguous, dtype 2 = int8 or 0 = float32; u = w * scales:
// (n,) float32; out: (d,) float32.
extern "C" int quantized_combine_launch(int dtype, const void* q,
                                        const void* u, void* out, int n,
                                        long long d, void* stream) {
  if (bad(n, d)) return kErrBadArgs;
  const float* uf = static_cast<const float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kInt8) return launch<int8_t, float>(q, uf, out, n, d, st);
  if (dtype == kF32) return launch<float, float>(q, uf, out, n, d, st);
  return kErrDtype;
}

// q: (n, db) contiguous uint8 with db = ceil(d / 8); u: (n,) float32;
// out: (d,) float32, 16-byte aligned.
extern "C" int packed_sign_combine_launch(const void* q, const void* u,
                                          void* out, int n, long long db,
                                          long long d, void* stream) {
  if (bad(n, d) || db != (d + 7) / 8 || !aligned16(out)) return kErrBadArgs;
  packed_sign_kernel<<<blocks_for(db), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(u),
      static_cast<float*>(out), n, db, d);
  return (int)cudaGetLastError();
}

extern "C" const char* coded_combine_error_string(int code) {
  if (code == kErrBadArgs)
    return "coded_combine: need n >= 1 rows, d >= 1, a packed width of "
           "ceil(d/8) and a 16-byte aligned output";
  if (code == kErrDtype)
    return "coded_combine: unsupported payload dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
