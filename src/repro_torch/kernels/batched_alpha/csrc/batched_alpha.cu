// The fused debias + decoding-error reduction for Hopper (sm_90a):
// errs[t] = inv_n * sum_i (scale * a[t][i] - 1)^2 over a (trials, n)
// float32 batch of decoded alphas, one float32 error per trial.
//
// Replaces the TPU kernel repro/kernels/batched_alpha/kernel.py
// (fused_error, pallas_call at :58).
//
// What bounds it on this card: bytes, in principle. Each alpha is read
// once for 3 flops (a multiply-subtract and a square-add), far below the
// H100's ~295 flops per byte; the least time is (trials * n + trials) * 4
// bytes over 3.35 TB/s. At the paper's n = 2184 and trials = 30 the work
// is a quarter of a megabyte, and the time is the launch and the memory
// round trips a row takes.
//
// Design. The Pallas kernel walks (block_t, n) strips on a sequential
// grid and pads n to the 128-lane boundary with 1/scale so the padding
// adds exact zeros. Here a row group of `tpr` threads (a multiple of 32)
// owns one trial row, with a plan from the host (kernel.py plan_error):
// a CTA of up to 256 threads a row, as many as leave each thread a few
// loads, at few trials and many alike (at 1000 trials of n = 2184 that
// beat two warps a row and a warp a row); narrow rows share a CTA. A
// row is read in 16-byte vectors from its first 16-byte aligned element
// on, with a scalar head before it and a scalar tail after it (at most
// 3 floats each), so any n and any row
// offset are read in full-width loads where they can be and nothing is
// padded. Each thread issues VPT vector loads (__ldcs: read once) before
// it accumulates any; a row longer than VPT * tpr vectors takes several
// such rounds. Each thread accumulates d = a*scale - 1, d*d in fp32
// (head, rounds, tail); a shuffle tree sums a warp, one shared-memory
// step sums a row's warps in warp order, and the row's first thread
// writes the sum times inv_n = float(1/n) with the true n. The order is
// fixed for a plan: a repeat is bitwise, no atomics. The kernel allocates
// nothing and runs on the caller's stream; the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kErrBadArgs = -1;
constexpr int kErrPlan = -3;

__device__ __forceinline__ float sq_err(float a, float scale) {
  const float d = a * scale - 1.f;
  return d * d;
}

template <int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    fused_error_kernel(const float* __restrict__ a, float scale, float inv_n,
                       float* __restrict__ out, long long trials,
                       long long n, int tpr) {
  __shared__ float partial[kMaxThreads / 32];
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < trials;
  float acc = 0.f;
  if (live) {
    const float* r = a + row * n;
    // floats before the first 16-byte aligned element of this row
    long long head =
        (long long)(((16 - (reinterpret_cast<uintptr_t>(r) & 15)) & 15) >> 2);
    if (head > n) head = n;
    if (t < head) acc += sq_err(r[t], scale);
    const long long nvec = (n - head) >> 2;
    const float4* body = reinterpret_cast<const float4*>(r + head);
    for (long long c = t; c < nvec; c += (long long)VPT * tpr) {
      float4 v[VPT];
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (c + k * tpr < nvec) v[k] = __ldcs(body + c + k * tpr);
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (c + k * tpr < nvec)
          acc += sq_err(v[k].x, scale) + sq_err(v[k].y, scale) +
                 sq_err(v[k].z, scale) + sq_err(v[k].w, scale);
    }
    const long long tail = head + 4 * nvec;
    if (t < n - tail) acc += sq_err(r[tail + t], scale);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (tpr > 32) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
    __syncthreads();
    const int w0 = (threadIdx.x / tpr) * (tpr >> 5);
    acc = 0.f;
    for (int w = 0; w < (tpr >> 5); ++w) acc += partial[w0 + w];
  }
  if (live && t == 0) out[row] = acc * inv_n;
}

template <int VPT>
int launch(const float* a, float scale, float inv_n, float* out,
           long long trials, long long n, int tpr, int rpc,
           cudaStream_t st) {
  const long long ctas = (trials + rpc - 1) / rpc;
  if (ctas > 0x7fffffffLL) return kErrBadArgs;
  fused_error_kernel<VPT><<<(unsigned)ctas, rpc * tpr, 0, st>>>(
      a, scale, inv_n, out, trials, n, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (trials, n) contiguous float32 (4-byte aligned); out: (trials,)
// float32. The plan (kernel.py plan_error): vpt vector loads a thread a
// round, tpr threads a row, rpc rows a CTA. Returns 0, a cudaError_t, or
// a negative code for a rejected argument.
extern "C" int fused_error_launch(const void* a, float scale, float inv_n,
                                  void* out, long long trials, long long n,
                                  int vpt, int tpr, int rpc, void* stream) {
  if (trials < 1 || n < 1 || reinterpret_cast<uintptr_t>(a) % 4 != 0)
    return kErrBadArgs;
  if (tpr < 32 || tpr % 32 || rpc < 1 || rpc * tpr > kMaxThreads)
    return kErrPlan;
  const float* ap = static_cast<const float*>(a);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vpt) {
    case 1: return launch<1>(ap, scale, inv_n, op, trials, n, tpr, rpc, st);
    case 2: return launch<2>(ap, scale, inv_n, op, trials, n, tpr, rpc, st);
    case 4: return launch<4>(ap, scale, inv_n, op, trials, n, tpr, rpc, st);
    case 8: return launch<8>(ap, scale, inv_n, op, trials, n, tpr, rpc, st);
    case 16: return launch<16>(ap, scale, inv_n, op, trials, n, tpr, rpc, st);
  }
  return kErrPlan;
}

extern "C" const char* batched_alpha_error_string(int code) {
  if (code == kErrBadArgs)
    return "fused_error: need trials >= 1, n >= 1 and a 4-byte aligned "
           "float32 batch";
  if (code == kErrPlan)
    return "fused_error: the launch plan is not one the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
