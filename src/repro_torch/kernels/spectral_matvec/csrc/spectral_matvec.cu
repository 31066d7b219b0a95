// The tall-skinny Gram matvec for Hopper (sm_90a): for every slice b of
// a (B, R, k) float32 stack and its bv right-hand sides V_b (bv, k),
// out_b = (X_b V_b^T)^T X_b, i.e. out[b][j][c] = sum_r y[r][j] x[b][r][c]
// with y[r][j] = sum_c' x[b][r][c'] v[b][j][c'].
//
// Replaces the TPU kernels of repro/kernels/spectral_matvec/kernel.py:
//   gram_matvec        (pallas_call at :75)   B = 1, bv >= 1: the Lanczos
//                      matvec (bv = 1) and the block-Lanczos form;
//   gram_matvec_batch  (pallas_call at :127)  B slices, bv = 1: the
//                      lockstep Lanczos over the campaign's stacked
//                      covariance batches.
//
// What bounds it on this card: bytes. The function reads X once and V
// and writes out once, for 4 * bv flops per 4-byte element of X -- below
// the H100's 20 float32 flops per byte (67 TFLOP/s over 3.35 TB/s) for
// every bv < 20, and the path uses bv <= 8; the least time is
// (B R k + 2 B bv k) * 4 bytes over 3.35 TB/s.
//
// Design. The Pallas kernels carry one (bv, k) accumulator through a
// sequential grid over row strips. Blocks on this card run in no order,
// so here each CTA owns one strip of rows of one slice
// (blockIdx = (strip, slice)) and writes its own (bv, k) partial:
//   1. y = X_strip V^T: one warp per row, lanes striding the row (and V)
//      with eight right-hand sides per pass, shuffle-tree sums, into
//      shared memory (rows_per_strip * bv floats);
//   2. partial = y^T X_strip: threads stride the k columns and walk the
//      strip's rows in order with eight fp32 accumulators per pass.
// A second kernel sums the partials of each slice in strip order. The
// strip is read twice (step 2 re-reads the rows step 1 just streamed,
// which sit in L1/L2), so device memory sees X about once; the bound
// above counts one read. Strips are sized on the host (kernel.py) so
// that the CTAs fill the card and the partials stay below an eighth of
// X. No atomics anywhere: the result is the same bits run after run,
// which keeps a Lanczos run on the card reproducible. The kernels
// allocate nothing (the partial buffer comes from the caller) and run on
// the caller's stream; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;               // right-hand sides per pass
constexpr int kMaxSmemFloats = 12288;   // 48 KB; kernel.py sizes to it
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kErrBadArgs = -1;

__global__ void __launch_bounds__(kThreads)
    gram_strip_kernel(const float* __restrict__ x,
                      const float* __restrict__ v,
                      float* __restrict__ partial, int R, int k, int bv,
                      int rows_per_strip) {
  extern __shared__ float y_s[];  // (rows_per_strip, bv)
  const int strip = blockIdx.x, b = blockIdx.y;
  const int r0 = strip * rows_per_strip;
  const int nr = min(R, r0 + rows_per_strip) - r0;
  const float* xs = x + ((long long)b * R + r0) * k;
  const float* vb = v + (long long)b * bv * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int rr = warp; rr < nr; rr += kWarps) {
    const float* row = xs + (long long)rr * k;
    for (int j0 = 0; j0 < bv; j0 += kChunk) {
      const int nj = min(kChunk, bv - j0);
      float acc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) acc[jj] = 0.f;
      for (int c = lane; c < k; c += 32) {
        const float xv = row[c];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
          if (jj < nj)
            acc[jj] += xv * __ldg(vb + (long long)(j0 + jj) * k + c);
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float s = acc[jj];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0 && jj < nj) y_s[rr * bv + j0 + jj] = s;
      }
    }
  }
  __syncthreads();

  float* pb = partial + ((long long)strip * gridDim.y + b) * bv * k;
  for (int c = threadIdx.x; c < k; c += kThreads) {
    for (int j0 = 0; j0 < bv; j0 += kChunk) {
      const int nj = min(kChunk, bv - j0);
      float acc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) acc[jj] = 0.f;
      for (int rr = 0; rr < nr; ++rr) {
        const float xv = xs[(long long)rr * k + c];
        const float* yr = y_s + rr * bv + j0;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
          if (jj < nj) acc[jj] += yr[jj] * xv;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
        if (jj < nj) pb[(long long)(j0 + jj) * k + c] = acc[jj];
    }
  }
}

// out[i] = sum_s partial[s][i] over the strips in order, i < total.
__global__ void __launch_bounds__(kThreads)
    reduce_strips_kernel(const float* __restrict__ partial,
                         float* __restrict__ out, int strips,
                         long long total) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int s = 0; s < strips; ++s) acc += partial[(long long)s * total + i];
    out[i] = acc;
  }
}

}  // namespace

// x: (B, R, k), v: (B, bv, k), partial: (strips, B, bv, k) scratch and
// out: (B, bv, k), all contiguous float32, with strips =
// ceil(R / rows_per_strip). Returns 0, a cudaError_t, or a negative code
// for a rejected argument.
extern "C" int gram_matvec_launch(const void* x, const void* v,
                                  void* partial, void* out, int B, int R,
                                  int k, int bv, int rows_per_strip,
                                  void* stream) {
  if (B < 1 || B > 65535 || R < 1 || k < 1 || bv < 1 ||
      rows_per_strip < 1 || (long long)rows_per_strip * bv > kMaxSmemFloats)
    return kErrBadArgs;
  const int strips = (R + rows_per_strip - 1) / rows_per_strip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)rows_per_strip * bv * sizeof(float);
  gram_strip_kernel<<<dim3(strips, B), kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<float*>(partial), R, k, bv, rows_per_strip);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = (long long)B * bv * k;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  reduce_strips_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), strips,
      total);
  return (int)cudaGetLastError();
}

extern "C" const char* spectral_matvec_error_string(int code) {
  if (code == kErrBadArgs)
    return "gram_matvec: need 1 <= B <= 65535, R, k, bv >= 1 and "
           "rows_per_strip * bv <= 12288";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
