// Decode attention for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, grouped-query.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/kernel.py:decode_attention
// (_decode_attn_kernel). Same function: q (B, H, Dh), k and v
// (B, S, KVH, Dh), lengths (B,); query head h reads kv head h / G with
// G = H / KVH; positions >= lengths[b] are masked; softmax(q k^T * Dh^-0.5)
// v is taken with an fp32 online softmax (running max m, sum l,
// accumulator acc); the output (B, H, Dh) is written in q's dtype.
//
// What bounds it on this card: bytes. Every cached key and value up to
// lengths[b] is read once and used by the G query heads of its group for
// 2 * G flops per element, about 4 flops per byte at G = 4 in bf16 -- far
// below the ~295 at which the tensor cores would be the limit. The least
// time is (sum_b lengths[b] * KVH * Dh * 2 + 2 * B * H * Dh) * sizeof(T)
// over 3.35 TB/s.
//
// Design. The TPU kernel walks the KV blocks of one (batch, kv head) in a
// sequential grid axis and carries (m, l, acc) in VMEM scratch from one
// block to the next. CUDA blocks run in parallel and carry nothing, so the
// walk over the cache is a loop inside one CTA: one CTA per (batch,
// kv head, group of up to GT query heads), four warps. A warp splits into
// lane groups of LPK lanes, one cached position per lane group at a time;
// each lane holds EPL consecutive elements of Dh, loaded as 16-byte
// vectors (8 bf16 values), and its slice of the GT query rows in
// registers. A lane group reduces its partial dot products with xor
// shuffles and keeps its own fp32 (m, l, acc) state for the positions it
// visited. Each lane group issues the loads of kUnroll positions before
// using any of them, to keep loads in flight. At the end the lane groups
// of a warp merge their states by shuffles, the warps merge theirs through
// shared memory, and the CTA writes acc / l. The loop stops at lengths[b]
// where the TPU kernel masked every block up to S: the positions it skips
// carry zero softmax weight there, so the function is the same, and a
// ragged S needs no tiling restriction. Only H % KVH == 0 is required.
//
// B * KVH = 64 CTAs at the serving shape leaves half of the 132 SMs idle;
// splitting S across CTAs (flash-decoding) is the first optimisation left.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;
constexpr int kErrHeadDim = -3;
constexpr int kErrHeads = -4;

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

// Merge online-softmax state (mo, lo) into (m, l); returns the factors by
// which the two accumulators are scaled. An empty state has m = -inf.
__device__ __forceinline__ void merge_factors(float& m, float& l, float mo,
                                              float lo, float& a, float& c) {
  const float mm = fmaxf(m, mo);
  a = m == -INFINITY ? 0.f : expf(m - mm);
  c = mo == -INFINITY ? 0.f : expf(mo - mm);
  l = l * a + lo * c;
  m = mm;
}

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int S, int KVH, int G,
                            float scale) {
  constexpr int VEC = 16 / sizeof(T);                     // per 16-byte load
  constexpr int EPL = DH / 32 > VEC ? DH / 32 : VEC;      // elements a lane
  constexpr int LOADS = EPL / VEC;                        // loads a lane
  constexpr int LPK = DH / EPL;                           // lanes a position
  constexpr int KPW = 32 / LPK;                           // positions a warp
  constexpr int PASS = kWarps * KPW;                      // positions a CTA
  static_assert(EPL % VEC == 0 && DH % EPL == 0, "head dim tiling");
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "lane groups");

  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][DH];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g0 = blockIdx.z * GT;
  const int H = KVH * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPK;
  const int d0 = (lane % LPK) * EPL;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g0 + g < G) {
      const T* qp = q + ((size_t)b * H + (size_t)kvh * G + g0 + g) * DH + d0;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const uint4 raw = reinterpret_cast<const uint4*>(qp)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[g][i * VEC + j] = to_f32(e[j]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t pos_stride = (size_t)KVH * DH;  // elements between positions
  const size_t head_off = ((size_t)b * S * KVH + kvh) * DH + d0;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  const int first = warp * KPW + grp;

  for (int base = 0; base < len; base += PASS * kUnroll) {
    uint4 kr[kUnroll][LOADS], vr[kUnroll][LOADS];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * PASS + first;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        if (t < len) {
          kr[u][i] = reinterpret_cast<const uint4*>(kb + t * pos_stride)[i];
          vr[u][i] = reinterpret_cast<const uint4*>(vb + t * pos_stride)[i];
        } else {
          kr[u][i] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * PASS + first;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const T* ke = reinterpret_cast<const T*>(&kr[u][i]);
        const T* ve = reinterpret_cast<const T*>(&vr[u][i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kf[i * VEC + j] = to_f32(ke[j]);
          vf[i * VEC + j] = to_f32(ve[j]);
        }
      }
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kf[e];
        s[g] = dot;
      }
      // Every lane takes part in the shuffles; the mask comes after.
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (t < len) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float sg = s[g] * scale;
          const float mn = fmaxf(m[g], sg);
          const float corr = expf(m[g] - mn);  // 0 while m is -inf
          const float p = expf(sg - mn);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
          m[g] = mn;
        }
      }
    }
  }

  // Merge the lane groups of this warp: partners share the same Dh slice.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      float a, c;
      merge_factors(m[g], l[g], mo, lo, a, c);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // Merge the warps and write acc / l.
  for (int idx = threadIdx.x; idx < GT * DH; idx += kWarps * 32) {
    const int g = idx / DH;
    const int d = idx % DH;
    if (g0 + g >= G) continue;
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float a, c;
      merge_factors(mm, ll, sm_m[w][g], sm_l[w][g], a, c);
      aa = aa * a + sm_acc[w][g][d] * c;
    }
    out[((size_t)b * H + (size_t)kvh * G + g0 + g) * DH + d] =
        from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const int* lengths,
              void* out, int B, int KVH, int G, int S, float scale,
              cudaStream_t stream) {
  const int gt = G >= 4 ? 4 : (G >= 2 ? 2 : 1);
  const dim3 grid((unsigned)B, (unsigned)KVH, (unsigned)((G + gt - 1) / gt));
  const dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (gt == 4)
    decode_attention_kernel<T, DH, 4><<<grid, block, 0, stream>>>(
        qt, kt, vt, lengths, ot, S, KVH, G, scale);
  else if (gt == 2)
    decode_attention_kernel<T, DH, 2><<<grid, block, 0, stream>>>(
        qt, kt, vt, lengths, ot, S, KVH, G, scale);
  else
    decode_attention_kernel<T, DH, 1><<<grid, block, 0, stream>>>(
        qt, kt, vt, lengths, ot, S, KVH, G, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int KVH, int G, int S, int Dh, float scale,
           cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, lengths, out, B, KVH, G, S, scale, stream);
    case 64:
      return launch_dh<T, 64>(q, k, v, lengths, out, B, KVH, G, S, scale, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, lengths, out, B, KVH, G, S, scale, stream);
    case 256:
      return launch_dh<T, 256>(q, k, v, lengths, out, B, KVH, G, S, scale, stream);
    default:
      return kErrHeadDim;
  }
}

}  // namespace

// q, out: (B, H, Dh); k, v: (B, S, KVH, Dh); lengths: (B,) int32; all
// contiguous and 16-byte aligned, dtype 0 = float32, 1 = bfloat16.
// scale is Dh^-0.5 as the caller rounds it. Returns 0, a cudaError_t, or
// a negative code.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* lengths, void* out, int B,
                                       int H, int KVH, int S, int Dh,
                                       float scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || KVH > 65535) return kErrBadArgs;
  if (H < KVH || H % KVH) return kErrHeads;
  const int G = H / KVH;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch<float>(q, k, v, len, out, B, KVH, G, S, Dh, scale, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, k, v, len, out, B, KVH, G, S, Dh, scale,
                                 st);
  return kErrDtype;
}

extern "C" const char* decode_attention_error_string(int code) {
  switch (code) {
    case kErrBadArgs:
      return "decode_attention: need B, S, KVH >= 1 and KVH <= 65535";
    case kErrDtype:
      return "decode_attention: dtype must be float32 or bfloat16";
    case kErrHeadDim:
      return "decode_attention: head dim must be 32, 64, 128 or 256";
    case kErrHeads:
      return "decode_attention: H must be a multiple of KVH";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
