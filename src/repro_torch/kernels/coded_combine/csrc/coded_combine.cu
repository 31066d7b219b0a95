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
// (n * D * sizeof(x) + D * sizeof(out)) / 3.35 TB/s. For the int8 and
// packed payloads the float32 output is most of those bytes: 80 % of
// them at one int8 row, 97 % at one packed row.
//
// Routes. The host plans each launch from shape and alignment
// (kernel.py plan_combine) and passes the plan in; nothing here falls
// back after a failure.
//
// * generic: every thread owns whole output positions of a grid-stride
//   loop over D and walks the n rows itself, one fp32 accumulator per
//   position. coded_combine (K3) and the float32 payload of
//   quantized_combine always take it: 16-byte vectors where every row is
//   16-byte aligned, else scalars. The int8 and packed payloads take it
//   only when a row is not a whole number of 16-byte vectors or the
//   payload is misaligned (combine_scalar; packed_sign_kernel, a payload
//   byte a thread). Its int8 and packed kernels store badly: a thread
//   that loads one 16-byte int8 vector writes 64 bytes as four 16-byte
//   stores, so one store instruction of a warp touches 16 bytes every
//   64 (a byte a thread: 32 bytes every 32) and half-fills the sectors
//   it spreads over 2 KB; and a thread has one load in flight, issued
//   after its stores. At one row the time hardly moved with the rows
//   (0.3217 / 0.3263 / 0.3340 ms at 4 / 2 / 1 int8 rows of 104.9 M on an
//   H100): the stores, not the payload, set the pace. The lane route
//   below, the same grid-stride register design with lane-contiguous
//   stores, takes 0.197 ms at that one row: the strided stores were the
//   cause.
// * bulk (int8 and packed, rows 16-byte aligned, 2^24 positions and
//   more, kernel.py BULK_MIN_D): a persistent grid of one or two CTAs
//   an SM walks tiles of D. One thread of a producer warp brings each
//   row's contiguous payload tile into a ring of shared-
//   memory stages with 1-D bulk asynchronous copies
//   (cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor map), one
//   mbarrier a stage counting the bytes, so the payload in flight is the
//   ring (96 KB an SM at one int8 row), not one load a thread. Eight
//   consumer warps fold each position over the rows in order into a
//   float32 tile in shared memory -- a lane reads 4 int8 (or a nibble of
//   signs) and writes one float4, so reads and writes are lane-
//   contiguous -- and one thread writes the tile back with one bulk
//   store (cp.async.bulk.global.shared::cta.bulk_group). Output tiles
//   are double-buffered: a buffer is written again only after its store
//   has been read out (cp.async.bulk.wait_group.read), which the thread
//   that issues the stores waits for a whole tile later. Every byte to
//   and from device memory then moves in whole lines, and no thread
//   waits on its own stores. Copies and stores mark their lines
//   evict-first in L2. The last tile is shorter: its copies and store
//   are too (byte counts stay multiples of 16); a packed tail of fewer
//   than 4 positions is stored by the consumers directly.
//   On an H100 at D = 104,857,600 this took one int8 row from 0.334 to
//   0.186 ms and one packed row from 0.267 to 0.154 (84 % of the
//   bound). Past that the time hardly depends on how the bytes move:
//   3, 4 or 6 output tiles in flight, smaller tiles (2048: 2-5 %
//   slower), a bulk store a warp (2 KB) instead of one a CTA (5-7 %
//   slower) all land within a few per cent; larger tiles (8192, the
//   planner's first), 3 CTAs an SM and the L2 hints gain 1-5 %.
// * lane (int8 and packed, rows 16-byte aligned, fewer than 2^24
//   positions; packed from 2^20): a lane loads 4 int8 (one 32-bit word
//   a row) and stores one float4, kLaneUnroll words of kLaneRows rows
//   in flight; for the packed payload a warp loads 32 words of each
//   row, kLaneRows rows at once, and each lane takes a nibble of one of
//   them through __shfl_sync, eight float4 stores a lane. A warp's
//   store covers 512 contiguous bytes. Below 2^24 positions it beats
//   the bulk route (by up to 2.6x at the norm scales' 8192, where the
//   bulk route's persistent CTAs get a tile or two and its pipeline
//   never fills); from 2^24 on the bulk route is 2-17 % faster.
//
// Every multiply and add is rounded on its own (__fmul_rn, __fadd_rn:
// no FMA contraction), rows in order b = 0..n-1, so the result is the
// plain torch chain `acc = acc + u[b] * x[b]` bit for bit, whatever the
// input and route; a dead row (u[b] = 0) adds exact zeros. Offsets are
// 64-bit (n * D reaches 4 x 104.9 M on the training path). No atomics:
// results are deterministic. The kernels allocate nothing and run on the
// caller's stream; each entry point returns cudaGetLastError() after its
// launch. The bulk kernel's dynamic shared-memory limit is raised once,
// at its first launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 CTAs per SM, H100 SXM
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;
constexpr int kRouteGeneric = 0;
constexpr int kRouteBulk = 1;
constexpr int kRouteLane = 2;
constexpr int kConsumerWarps = 8;             // bulk: consumer warps a CTA
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kBulkThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxSmem = 232448;              // a CTA's dynamic maximum
constexpr int kOutBufs = 2;                   // bulk: output tiles a CTA
constexpr int kLaneUnroll = 4;                // lane: words a lane a pass
constexpr int kLaneRows = 4;                  // lane: rows loaded at once
constexpr int kMaxDevices = 64;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;
constexpr int kErrPlan = -3;

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

// acc += u * x for the four int8 of a little-endian 32-bit word, and
// for four sign bits (bit k of `nib` is +1 when set, -1 when clear:
// u * (+-1) is +-u exactly).
__device__ __forceinline__ float int8_at(unsigned w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}
__device__ __forceinline__ void fold_int8(float4& a, float u, unsigned w) {
  a.x = __fadd_rn(a.x, __fmul_rn(u, int8_at(w, 0)));
  a.y = __fadd_rn(a.y, __fmul_rn(u, int8_at(w, 1)));
  a.z = __fadd_rn(a.z, __fmul_rn(u, int8_at(w, 2)));
  a.w = __fadd_rn(a.w, __fmul_rn(u, int8_at(w, 3)));
}
__device__ __forceinline__ void fold_signs(float4& a, float u,
                                           unsigned nib) {
  a.x = __fadd_rn(a.x, (nib & 1u) ? u : -u);
  a.y = __fadd_rn(a.y, (nib & 2u) ? u : -u);
  a.z = __fadd_rn(a.z, (nib & 4u) ? u : -u);
  a.w = __fadd_rn(a.w, (nib & 8u) ? u : -u);
}

// Stores the first `count` (< 4) lanes of a float4 one by one.
__device__ __forceinline__ void store_head(float* o, float4 a, int count) {
  const float v[4] = {a.x, a.y, a.z, a.w};
  for (int j = 0; j < count; ++j) o[j] = v[j];
}

// ---------------------------------------------------------------- generic

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

// ------------------------------------------------------------------- bulk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// Arrives once and adds `bytes` to the transaction count of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// Both directions stream: each payload and output byte is touched once,
// so the copies mark their lines evict-first in L2 (2-5 % faster on an
// H100 than without the hint).
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(pol)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes, uint64_t pol) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
               " [%0], [%1], %2, %3;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(pol)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// KIND 0: int8 payload, a byte a position; KIND 1: packed signs, 8
// positions a byte. `tile` output positions a tile (tile / kPerByte
// payload bytes a row, a multiple of 16); `stages` payload stages of n
// row tiles each. Shared memory: kOutBufs float32 output tiles, the
// ring, then a full and an empty mbarrier a stage.
template <int KIND>
__global__ void __launch_bounds__(kBulkThreads)
    bulk_combine(const uint8_t* __restrict__ x, const float* __restrict__ u,
                 float* __restrict__ out, int n, long long row_bytes,
                 long long d, int tile, int stages) {
  constexpr int kPerByte = KIND == 0 ? 1 : 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_in = tile / kPerByte;
  const size_t stage_bytes = (size_t)n * tile_in;
  float* obuf = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + kOutBufs * sizeof(float) * (size_t)tile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const long long ntiles = (row_bytes + tile_in - 1) / tile_in;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one thread copies
    if (lane == 0) {
      const uint64_t pol = evict_first();
      int s = 0;
      unsigned round = 0;
      for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
        const long long off = t * tile_in;
        const unsigned bytes =
            (unsigned)min((long long)tile_in, row_bytes - off);
        mbar_expect_tx(full + s, bytes * (unsigned)n);
        unsigned char* dst = ring + s * stage_bytes;
        for (int b = 0; b < n; ++b)
          bulk_load(dst + (size_t)b * tile_in, x + b * row_bytes + off,
                    bytes, full + s, pol);
        if (++s == stages) { s = 0; ++round; }
      }
    }
    return;
  }

  // the consumer warps: threadIdx.x 0 .. kConsumers - 1
  const int ct = threadIdx.x;
  const uint64_t pol = evict_first();
  int s = 0, k = 0;
  unsigned round = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    mbar_wait(full + s, round & 1);
    const long long off = t * tile_in;
    const int bytes = (int)min((long long)tile_in, row_bytes - off);
    const long long pos0 = off * kPerByte;
    const int count = (int)min((long long)bytes * kPerByte, d - pos0);
    const int whole = count & ~3;  // positions the bulk store writes
    const unsigned char* stage = ring + s * stage_bytes;
    float4* ob = reinterpret_cast<float4*>(obuf + (size_t)k * tile);
    for (int g = ct; 4 * g < count; g += kConsumers) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = 0; b < n; ++b) {
        const float ub = __ldg(u + b);
        const unsigned char* row = stage + (size_t)b * tile_in;
        if (KIND == 0)
          fold_int8(a, ub, reinterpret_cast<const unsigned*>(row)[g]);
        else
          fold_signs(a, ub, (unsigned)row[g >> 1] >> (4 * (g & 1)));
      }
      if (4 * g < whole)
        ob[g] = a;
      else
        store_head(out + pos0 + 4 * g, a, count - 4 * g);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done reading
    // make this thread's tile writes visible to the bulk store, and let
    // the store that last used the next tile's buffer finish reading it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (ct == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;"
                   :: "n"(kOutBufs - 2) : "memory");
    asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
    if (ct == 0 && whole > 0)
      bulk_store(out + pos0, obuf + (size_t)k * tile, 4u * whole, pol);
    if (++s == stages) { s = 0; ++round; }
    if (++k == kOutBufs) k = 0;
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ------------------------------------------------------------------- lane

// int8: a lane folds one 32-bit word (4 positions) a row and stores one
// float4; kLaneUnroll words a lane a pass, a grid-stride apart, the
// words of kLaneRows rows loaded before any is folded.
__global__ void __launch_bounds__(kThreads)
    lane_int8(const int8_t* __restrict__ q, const float* __restrict__ u,
              float* __restrict__ out, int n, long long d) {
  const long long words = d / 4;
  const long long stride = grid_stride();
  const unsigned* q32 = reinterpret_cast<const unsigned*>(q);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long g0 = first_index(); g0 < words;
       g0 += kLaneUnroll * stride) {
    float4 acc[kLaneUnroll];
#pragma unroll
    for (int j = 0; j < kLaneUnroll; ++j)
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b0 = 0; b0 < n; b0 += kLaneRows) {
      unsigned raw[kLaneRows][kLaneUnroll];
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r)
#pragma unroll
        for (int j = 0; j < kLaneUnroll; ++j) {
          const long long g = g0 + j * stride;
          raw[r][j] = b0 + r < n && g < words
                          ? __ldcs(q32 + (b0 + r) * words + g) : 0u;
        }
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        if (b0 + r == n) break;
        const float ub = __ldg(u + b0 + r);
#pragma unroll
        for (int j = 0; j < kLaneUnroll; ++j)
          fold_int8(acc[j], ub, raw[r][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneUnroll; ++j) {
      const long long g = g0 + j * stride;
      if (g < words) __stcs(o4 + g, acc[j]);
    }
  }
}

// packed: a warp loads 32 words (128 bytes, 1024 positions) of each row,
// kLaneRows rows at once; lane l folds nibble l % 8 of word 4j + l / 8,
// j = 0..7 (positions 4 (32 j + l) .. + 3 of the chunk), taken through
// __shfl_sync.
__global__ void __launch_bounds__(kThreads)
    lane_packed(const uint8_t* __restrict__ q, const float* __restrict__ u,
                float* __restrict__ out, int n, long long db, long long d) {
  const long long words = db / 4;
  const long long chunks = (words + 31) / 32;
  const int lane = threadIdx.x % 32;
  const unsigned* q32 = reinterpret_cast<const unsigned*>(q);
  for (long long c = first_index() / 32; c < chunks;
       c += grid_stride() / 32) {  // warp-uniform: every lane shuffles
    float4 acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long wi = c * 32 + lane;
    for (int b0 = 0; b0 < n; b0 += kLaneRows) {
      unsigned raw[kLaneRows];
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r)
        raw[r] = b0 + r < n && wi < words
                     ? __ldcs(q32 + (b0 + r) * words + wi) : 0u;
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        if (b0 + r == n) break;   // warp-uniform
        const float ub = __ldg(u + b0 + r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned src =
              __shfl_sync(0xffffffffu, raw[r], 4 * j + lane / 8);
          fold_signs(acc[j], ub, src >> (4 * (lane % 8)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long p = c * 1024 + 4 * (32 * j + lane);
      if (p + 4 <= d)
        __stcs(reinterpret_cast<float4*>(out + p), acc[j]);
      else if (p < d)
        store_head(out + p, acc[j], (int)(d - p));
    }
  }
}

// ---------------------------------------------------------------- launch

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The generic grid: a CTA of kThreads for every kThreads vectors (or
// scalars where the rows are not whole aligned vectors), at most
// kMaxBlocks. kernel.py plan_combine computes the same.
template <typename TIn>
bool vec_rows(const void* x, const void* out, long long d) {
  return d % (16 / sizeof(TIn)) == 0 && aligned16(x) && aligned16(out);
}
template <typename TIn>
unsigned generic_blocks(const void* x, const void* out, long long d) {
  return blocks_for(vec_rows<TIn>(x, out, d) ? d / (16 / sizeof(TIn)) : d);
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* u, void* out, int n, long long d,
           unsigned blocks, cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* ot = static_cast<TOut*>(out);
  if (vec_rows<TIn>(x, out, d))
    combine_vec<TIn, TOut><<<blocks, kThreads, 0, stream>>>(xt, u, ot, n,
                                                             d);
  else
    combine_scalar<TIn, TOut><<<blocks, kThreads, 0, stream>>>(xt, u, ot,
                                                               n, d);
  return (int)cudaGetLastError();
}

// The bulk kernel of KIND, after raising its dynamic shared-memory limit
// on the current device (once a device, at its first launch there).
template <int KIND>
int launch_bulk(const void* x, const float* u, void* out, int n,
                long long row_bytes, long long d, int ctas, int tile,
                int stages, int smem, cudaStream_t stream) {
  constexpr int kPerByte = KIND == 0 ? 1 : 8;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return kErrPlan;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(bulk_combine<KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const long long tile_in = tile / kPerByte;
  const long long need = 4LL * kOutBufs * tile +
                         (long long)stages * n * tile_in +
                         16LL * stages;
  if (ctas < 1 || stages < 1 || tile < 1 || tile % (16 * kPerByte) ||
      row_bytes % 16 || smem < need ||
      smem > kMaxSmem || !aligned16(x) || !aligned16(out))
    return kErrPlan;
  bulk_combine<KIND><<<ctas, kBulkThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), u, static_cast<float*>(out), n,
      row_bytes, d, tile, stages);
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
  if (dtype == kF32)
    return launch<float, float>(grads, wf, out, n, d,
                                generic_blocks<float>(grads, out, d), st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        grads, wf, out, n, d, generic_blocks<__nv_bfloat16>(grads, out, d),
        st);
  return kErrDtype;
}

// q: (n, d) contiguous, dtype 2 = int8 or 0 = float32; u = w * scales:
// (n,) float32; out: (d,) float32. The plan (kernel.py plan_combine):
// route 0 generic (ctas CTAs of kThreads; the only route of a float32
// payload), 1 bulk, 2 lane; tile, stages and smem bytes of the bulk
// route.
extern "C" int quantized_combine_launch(int dtype, const void* q,
                                        const void* u, void* out, int n,
                                        long long d, int route, int ctas,
                                        int tile, int stages, int smem,
                                        void* stream) {
  if (bad(n, d)) return kErrBadArgs;
  const float* uf = static_cast<const float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kInt8 && dtype != kF32) return kErrDtype;
  if (ctas < 1 || (dtype == kF32 && route != kRouteGeneric))
    return kErrPlan;
  if (route == kRouteGeneric)
    return dtype == kInt8
               ? launch<int8_t, float>(q, uf, out, n, d, ctas, st)
               : launch<float, float>(q, uf, out, n, d, ctas, st);
  if (route == kRouteBulk)
    return launch_bulk<0>(q, uf, out, n, d, d, ctas, tile, stages, smem,
                          st);
  if (route != kRouteLane || d % 16 || !aligned16(q) || !aligned16(out))
    return kErrPlan;
  lane_int8<<<ctas, kThreads, 0, st>>>(static_cast<const int8_t*>(q), uf,
                                       static_cast<float*>(out), n, d);
  return (int)cudaGetLastError();
}

// q: (n, db) contiguous uint8 with db = ceil(d / 8); u: (n,) float32;
// out: (d,) float32, 16-byte aligned. The plan as above.
extern "C" int packed_sign_combine_launch(const void* q, const void* u,
                                          void* out, int n, long long db,
                                          long long d, int route, int ctas,
                                          int tile, int stages, int smem,
                                          void* stream) {
  if (bad(n, d) || db != (d + 7) / 8 || !aligned16(out)) return kErrBadArgs;
  if (ctas < 1) return kErrPlan;
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteGeneric) {
    packed_sign_kernel<<<ctas, kThreads, 0, st>>>(qb, uf, of, n, db, d);
    return (int)cudaGetLastError();
  }
  if (route == kRouteBulk)
    return launch_bulk<1>(q, uf, out, n, db, d, ctas, tile, stages, smem,
                          st);
  if (route != kRouteLane || db % 16 || !aligned16(q)) return kErrPlan;
  lane_packed<<<ctas, kThreads, 0, st>>>(qb, uf, of, n, db, d);
  return (int)cudaGetLastError();
}

extern "C" const char* coded_combine_error_string(int code) {
  if (code == kErrBadArgs)
    return "coded_combine: need n >= 1 rows, d >= 1, a packed width of "
           "ceil(d/8) and a 16-byte aligned output";
  if (code == kErrDtype)
    return "coded_combine: unsupported payload dtype";
  if (code == kErrPlan)
    return "coded_combine: the launch plan does not fit this payload "
           "(route, CTAs, tile, stages or shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
