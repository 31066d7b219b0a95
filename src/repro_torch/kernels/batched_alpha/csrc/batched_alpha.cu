// The fused debias + decoding-error reduction for Hopper (sm_90a):
// errs[t] = inv_n * sum_i (scale * a[t][i] - 1)^2 over a (trials, n)
// float32 batch of decoded alphas, one float32 error per trial.
//
// Replaces the TPU kernel repro/kernels/batched_alpha/kernel.py
// (fused_error, pallas_call at :58).
//
// What bounds it on this card: bytes. Each alpha is read once for 3
// flops (a multiply-subtract and a square-add), far below the H100's
// ~295 flops per byte; the least time is (trials * n + trials) * 4 bytes
// over 3.35 TB/s. At the paper's n = 2184 and trials = 30 the work is a
// quarter of a megabyte, and the launch itself is the floor.
//
// Design. The Pallas kernel walks (block_t, n) strips on a sequential
// grid and pads n to the 128-lane boundary with 1/scale so the padding
// adds exact zeros. Here one warp owns one trial row: its lanes stride
// over the row, reading 16-byte vectors from the first 16-byte aligned
// element on, with a scalar head before it and a scalar tail after it,
// so any n and any row offset are read in full-width loads where they
// can be and nothing is padded. Each lane accumulates d = a*scale - 1,
// d*d in fp32; a shuffle tree sums the 32 lanes, and lane 0 writes the
// sum times inv_n = float(1/n) with the true n. Eight warps (eight rows)
// per CTA. No atomics and no shared memory: the result is deterministic.
// The kernel allocates nothing and runs on the caller's stream; the entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kErrBadArgs = -1;

__device__ __forceinline__ float sq_err(float a, float scale) {
  const float d = a * scale - 1.f;
  return d * d;
}

__global__ void __launch_bounds__(kThreads)
    fused_error_kernel(const float* __restrict__ a, float scale, float inv_n,
                       float* __restrict__ out, long long trials,
                       long long n) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= trials) return;
  const float* row = a + t * n;
  // floats before the first 16-byte aligned element of this row
  long long head = (long long)(((16 - (reinterpret_cast<uintptr_t>(row) &
                                       15)) & 15) >> 2);
  if (head > n) head = n;
  float acc = 0.f;
  for (long long i = lane; i < head; i += 32) acc += sq_err(row[i], scale);
  const long long nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (long long i = lane; i < nvec; i += 32) {
    const float4 v = __ldcs(body + i);
    acc += sq_err(v.x, scale) + sq_err(v.y, scale) + sq_err(v.z, scale) +
           sq_err(v.w, scale);
  }
  for (long long i = head + 4 * nvec + lane; i < n; i += 32)
    acc += sq_err(row[i], scale);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[t] = acc * inv_n;
}

}  // namespace

// a: (trials, n) contiguous float32 (4-byte aligned); out: (trials,)
// float32. Returns 0, a cudaError_t, or a negative code for a rejected
// argument.
extern "C" int fused_error_launch(const void* a, float scale, float inv_n,
                                  void* out, long long trials, long long n,
                                  void* stream) {
  if (trials < 1 || n < 1 ||
      reinterpret_cast<uintptr_t>(a) % 4 != 0 ||
      (trials + kWarps - 1) / kWarps > 0x7fffffffLL)
    return kErrBadArgs;
  const unsigned blocks = (unsigned)((trials + kWarps - 1) / kWarps);
  fused_error_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), scale, inv_n, static_cast<float*>(out),
      trials, n);
  return (int)cudaGetLastError();
}

extern "C" const char* batched_alpha_error_string(int code) {
  if (code == kErrBadArgs)
    return "fused_error: need trials >= 1, n >= 1 and a 4-byte aligned "
           "float32 batch";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
