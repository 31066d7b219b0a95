// Decode attention for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, grouped-query, split over the cache (flash-decoding).
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/kernel.py:decode_attention
// (pallas_call at :90, body _decode_attn_kernel at :28). Same function:
// q (B, H, Dh), k and v (B, S, KVH, Dh), lengths (B,); query head h reads
// kv head h / G with G = H / KVH; positions >= lengths[b] are masked;
// softmax(q k^T * Dh^-0.5) v is taken with an fp32 online softmax
// (running max m, sum l, accumulator acc); the output (B, H, Dh) is
// written in q's dtype, zeros where lengths[b] = 0.
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
// block to the next. Here the walk is cut into chunks of `chunk`
// positions (flash-decoding), and the grid is (B * KVH * head groups,
// chunks): one CTA of four warps per (batch, kv head, group of up to GT
// query heads, chunk). The chunk length is chosen on the host from S,
// the number of (batch, kv head, group) triples and the SM count
// (kernel.py plan_chunks), never from lengths, so there is no host sync
// and the launch is graph-capturable. A CTA whose chunk starts at or past
// lengths[b] returns at once; only chunk 0 runs when lengths[b] = 0.
//   1. Staging: the chunk's K and V rows stream through a ring of shared-
//      memory stages with 16-byte cp.async copies, the stages but one in
//      flight ahead of the one being used. Positions past lengths[b] are
//      zero-filled, never read.
//   2. bf16 with Dh >= 64 (decode_attention_mma_kernel): a warp takes 16
//      positions of a 64-position tile; S = Q K^T and O += P V run as
//      m16n8k16 tensor-core products (Q's GT rows padded to 16, K and V
//      through ldmatrix from XOR-swizzled rows), the online softmax on
//      S's fragments in fp32 with P rounded to bf16 for the second
//      product. float32, and bf16 at Dh = 32, run on the CUDA cores
//      (decode_attention_kernel): lane groups of LPK lanes form a
//      position's dot products with the query rows held in registers,
//      one lane per position takes the exponentials, and the lane groups
//      add p * v into their slices of acc.
//   3. The warps merge their states through shared memory in warp order.
//   4. With one active chunk the CTA writes acc / l. Otherwise it writes
//      its (m, l, acc) to the caller's scratch, takes an integer ticket for
//      its (batch, kv head, group), and the CTA that draws the last ticket
//      merges the chunks' states in chunk order and resets the ticket to
//      0 for the next launch. The order of every sum is fixed by the
//      shapes alone, so two launches give the same bits; there are no
//      float atomics.
// What still holds it back: at a long cache, how fully the ring keeps the
// memory busy; at a short one, the chain of launch, first tile, ticket
// and merge (PERF.md).
// The kernel allocates nothing (scratch and tickets come from the caller,
// which keeps them with its plan of the shape) and runs on the caller's
// stream; the entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;      // K and V rows of one tile
constexpr int kMaxDevices = 64;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kErrBadArgs = -1;
constexpr int kErrDtype = -2;
constexpr int kErrHeadDim = -3;
constexpr int kErrHeads = -4;
constexpr int kErrChunk = -5;

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

// 16 bytes global -> shared; src_bytes = 0 zero-fills and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part;    // (B*KVH*NG, chunks, 2*GT + GT*DH) chunk states
  int* tickets;   // (B*KVH*NG,) zero between launches
  int S, KVH, G, NG, chunk, chunks;
  float scale;
};

// The end of every CTA, after its warps' states are in `ws` ([warp][2 GT
// + GT DH] floats of shared memory, m then l then acc): merge the warps in
// warp order; with one active chunk write acc / l, else write the chunk's
// state to the scratch and take a ticket; the CTA drawing the last ticket
// merges the chunks in chunk order, writes the output and resets the
// ticket. `ws` must have room for kWarps states and 2 * chunks * GT more
// floats.
template <typename T, int DH, int GT>
__device__ __forceinline__ void cta_epilogue(const Params& p, float* ws,
                                             int bh, int c, int b, int kvh,
                                             int g0, int active) {
  constexpr int STATE = 2 * GT + GT * DH;
  __shared__ int s_last;
  const int H = p.KVH * p.G;
  T* out = static_cast<T*>(p.out);
  float* mine = p.part + ((size_t)bh * p.chunks + c) * STATE;
  for (int idx = threadIdx.x; idx < GT * DH; idx += kThreads) {
    const int g = idx / DH;
    const int d = idx % DH;
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float a, cc;
      merge_factors(mm, ll, ws[w * STATE + g], ws[w * STATE + GT + g], a,
                    cc);
      aa = aa * a + ws[w * STATE + 2 * GT + g * DH + d] * cc;
    }
    if (active == 1) {
      if (g0 + g < p.G)
        out[((size_t)b * H + (size_t)kvh * p.G + g0 + g) * DH + d] =
            from_f32<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      if (d == 0) {
        mine[g] = mm;
        mine[GT + g] = ll;
      }
      mine[2 * GT + g * DH + d] = aa;
    }
  }
  if (active == 1) return;

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.tickets + bh, 1) == active - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the chunks' m and l side by side in shared memory, loaded at once
  const float* all = p.part + (size_t)bh * p.chunks * STATE;
  float* cm = ws + kWarps * STATE;        // [chunk][GT]: m, then weight
  float* cl = cm + active * GT;           // [chunk][GT]: l
  for (int idx = threadIdx.x; idx < active * GT; idx += kThreads) {
    const float* st = all + (size_t)(idx / GT) * STATE;
    cm[idx] = __ldcg(st + idx % GT);
    cl[idx] = __ldcg(st + GT + idx % GT);
  }
  __syncthreads();
  float* tot = cl + active * GT;          // [GT]: 1 / sum of weighted l
  if (threadIdx.x < GT) {
    const int g = threadIdx.x;
    float mt = -INFINITY;
    for (int cc = 0; cc < active; ++cc) mt = fmaxf(mt, cm[cc * GT + g]);
    float ll = 0.f;
    for (int cc = 0; cc < active; ++cc) {
      const float mc = cm[cc * GT + g];
      const float w = mc == -INFINITY ? 0.f : expf(mc - mt);
      cm[cc * GT + g] = w;
      ll += cl[cc * GT + g] * w;
    }
    tot[g] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * DH; idx += kThreads) {
    const int g = idx / DH;
    const int d = idx % DH;
    if (g0 + g >= p.G) continue;
    const float* ap = all + 2 * GT + g * DH + d;
    float aa = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < active; ++cc)
      aa += __ldcg(ap + (size_t)cc * STATE) * cm[cc * GT + g];
    out[((size_t)b * H + (size_t)kvh * p.G + g0 + g) * DH + d] =
        from_f32<T>(aa / tot[g]);
  }
  if (threadIdx.x == 0) p.tickets[bh] = 0;
}

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);                     // per 16-byte load
  constexpr int EPL = DH / 32 > VEC ? DH / 32 : VEC;      // elements a lane
  constexpr int LOADS = EPL / VEC;                        // loads a lane
  constexpr int LPK = DH / EPL;                           // lanes a position
  constexpr int KPW = 32 / LPK;                           // positions at once
  constexpr int ROW = DH * (int)sizeof(T);                // bytes a position
  constexpr int TP0 = kStageBytes / (2 * ROW);
  constexpr int TP = TP0 > 4 * 32 ? 4 * 32 : TP0;         // positions a tile
  constexpr int TPW = TP / kWarps;                        // ... a warp
  constexpr int CPR = ROW / 16;                           // copies a row
  constexpr int STATE = 2 * GT + GT * DH;                 // floats a state
  static_assert(EPL % VEC == 0 && DH % EPL == 0, "head dim tiling");
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "lane groups");
  static_assert(TPW >= KPW && TPW % KPW == 0 && TPW <= 32, "tile split");
  static_assert(kStages * 2 * TP * ROW >= kWarps * STATE * 4,
                "warp states alias the ring");

  extern __shared__ __align__(16) unsigned char ring[];  // kStages tiles
  __shared__ float sc[kWarps][GT][TPW];                   // scores, then p

  const int bh = blockIdx.x;          // (b * KVH + kvh) * NG + ng
  const int c = blockIdx.y;
  const int ng = bh % p.NG;
  const int kvh = (bh / p.NG) % p.KVH;
  const int b = bh / p.NG / p.KVH;
  const int g0 = ng * GT;
  const int H = p.KVH * p.G;

  int len = p.lengths[b];
  len = len < 0 ? 0 : (len > p.S ? p.S : len);
  const int active = len == 0 ? 1 : (len + p.chunk - 1) / p.chunk;
  if (c >= active) return;
  const int t0 = c * p.chunk;
  const int t1 = min(t0 + p.chunk, len);
  const int tiles = t1 > t0 ? (t1 - t0 + TP - 1) / TP : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPK;
  const int d0 = (lane % LPK) * EPL;
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);

  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g0 + g < p.G) {
      const T* qp = static_cast<const T*>(p.q) +
                    ((size_t)b * H + (size_t)kvh * p.G + g0 + g) * DH + d0;
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

  // tile i of the chunk -> ring stage i % kStages: K rows, then V rows
  auto fetch = [&](int tile) {
    unsigned char* st = ring + (size_t)(tile % kStages) * 2 * TP * ROW;
    const int base = t0 + tile * TP;
    for (int idx = threadIdx.x; idx < 2 * TP * CPR; idx += kThreads) {
      const int kv = idx / (TP * CPR);
      const int i = (idx / CPR) % TP;
      const int ch = idx % CPR;
      const int t = base + i;
      const T* src = (kv ? vp : kp) +
                     (((size_t)b * p.S + (t < t1 ? t : 0)) * p.KVH + kvh) * DH +
                     ch * VEC;
      cp_async16(st + (size_t)(kv * TP + i) * ROW + ch * 16, src,
                 t < t1 ? 16 : 0);
    }
  };

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) fetch(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();   // this tile's copies have landed
    __syncthreads();                // ... all threads'; tile - 1 is done
    if (tile + kStages - 1 < tiles) fetch(tile + kStages - 1);
    cp_async_commit();

    const T* ks = reinterpret_cast<const T*>(
        ring + (size_t)(tile % kStages) * 2 * TP * ROW);
    const T* vs = ks + TP * DH;
    const int valid = min(TP, t1 - (t0 + tile * TP)) - warp * TPW;

    // scores of this warp's positions, one lane group per position
#pragma unroll
    for (int r = 0; r < TPW / KPW; ++r) {
      const int j = r * KPW + grp;
      const T* row = ks + (warp * TPW + j) * DH + d0;
      float kf[EPL];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int x = 0; x < VEC; ++x) kf[i * VEC + x] = to_f32(e[x]);
      }
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kf[e];
        s[g] = dot;
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (lane % LPK == 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) sc[warp][g][j] = s[g] * p.scale;
      }
    }
    __syncwarp();

    // one lane per position: tile max, exponentials, sum
    float corr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float sv =
          (lane < TPW && lane < valid) ? sc[warp][g][lane] : -INFINITY;
      const float mn = fmaxf(m[g], warp_max(sv));
      corr[g] = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float pv = sv == -INFINITY ? 0.f : expf(sv - mn);
      l[g] = l[g] * corr[g] + warp_sum(pv);
      m[g] = mn;
      if (lane < TPW) sc[warp][g][lane] = pv;
    }
    __syncwarp();

#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr[g];
#pragma unroll
    for (int r = 0; r < TPW / KPW; ++r) {
      const int j = r * KPW + grp;
      if (j >= valid) break;      // the rest of the warp's tile is masked
      const T* row = vs + (warp * TPW + j) * DH + d0;
      float vf[EPL];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int x = 0; x < VEC; ++x) vf[i * VEC + x] = to_f32(e[x]);
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pg = sc[warp][g][j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += pg * vf[e];
      }
    }
    __syncwarp();                   // sc is rewritten by the next tile
  }
  cp_async_wait<0>();

  // The lane groups of a warp share (m, l): their accumulators add.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);

  __syncthreads();                  // the ring is free: warp states alias it
  float* ws = reinterpret_cast<float*>(ring);   // [warp][STATE]
  if (grp == 0) {
    float* w = ws + warp * STATE;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        w[g] = m[g];
        w[GT + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) w[2 * GT + g * DH + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  cta_epilogue<T, DH, GT>(p, ws, bh, c, b, kvh, g0, active);
}

// bf16 with Dh >= 64: the same walk with the products on the tensor
// cores. A warp takes 16 positions of a tile: S = Q K^T as two
// m16n8k16 products per 16 dims (Q's GT rows padded to 16, K rows from
// shared memory through ldmatrix), the softmax on S's fragments (a row's
// four lanes share its max), P = exp(S - m) rounded to bf16 as the A
// operand of O += P V (V through ldmatrix.trans). Rows are stored with
// their 16-byte chunks XOR-swizzled by row % 8, so ldmatrix reads no
// bank twice.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr int kMmaStages = 3;
constexpr int kMmaTPW = 16;                       // positions a warp a tile
constexpr int kMmaTP = kWarps * kMmaTPW;          // positions a tile

template <int DH, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_mma_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr int ROW = DH * 2;                     // bytes a position
  constexpr int CPR = ROW / 16;                   // 16-byte chunks a row
  constexpr int TP = kMmaTP;
  constexpr int KS = DH / 16;                     // k-steps of S = Q K^T
  constexpr int ND = DH / 8;                      // n-tiles of O
  constexpr int STATE = 2 * GT + GT * DH;
  static_assert(CPR >= 8 && CPR % 8 == 0, "swizzle needs 8 chunks a row");

  extern __shared__ __align__(128) unsigned char ring[];

  const int bh = blockIdx.x;          // (b * KVH + kvh) * NG + ng
  const int c = blockIdx.y;
  const int ng = bh % p.NG;
  const int kvh = (bh / p.NG) % p.KVH;
  const int b = bh / p.NG / p.KVH;
  const int g0 = ng * GT;
  const int H = p.KVH * p.G;

  int len = p.lengths[b];
  len = len < 0 ? 0 : (len > p.S ? p.S : len);
  const int active = len == 0 ? 1 : (len + p.chunk - 1) / p.chunk;
  if (c >= active) return;
  const int t0 = c * p.chunk;
  const int t1 = min(t0 + p.chunk, len);
  const int tiles = t1 > t0 ? (t1 - t0 + TP - 1) / TP : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;      // mma fragment coordinates
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);

  // Q as the A operand: row gid is query head g0 + gid (zero past GT)
  uint32_t qa[KS][2];
  const bool qrow = gid < GT && g0 + gid < p.G;
  const T* qp = static_cast<const T*>(p.q) +
                ((size_t)b * H + (size_t)kvh * p.G + g0 + (qrow ? gid : 0)) *
                    DH;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = qrow ? *reinterpret_cast<const uint32_t*>(
                           qp + 16 * ks + 2 * tig) : 0u;
    qa[ks][1] = qrow ? *reinterpret_cast<const uint32_t*>(
                           qp + 16 * ks + 8 + 2 * tig) : 0u;
  }

  auto fetch = [&](int tile) {
    unsigned char* st = ring + (size_t)(tile % kMmaStages) * 2 * TP * ROW;
    const int base = t0 + tile * TP;
    for (int idx = threadIdx.x; idx < 2 * TP * CPR; idx += kThreads) {
      const int kv = idx / (TP * CPR);
      const int i = (idx / CPR) % TP;
      const int ch = idx % CPR;
      const int t = base + i;
      const T* src = (kv ? vp : kp) +
                     (((size_t)b * p.S + (t < t1 ? t : 0)) * p.KVH + kvh) * DH +
                     ch * 8;
      cp_async16(st + (size_t)(kv * TP + i) * ROW + ((ch ^ (i & 7)) * 16),
                 src, t < t1 ? 16 : 0);
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m = -INFINITY, l = 0.f;       // row gid; l is this lane's share

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < tiles) fetch(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (tile + kMmaStages - 1 < tiles) fetch(tile + kMmaStages - 1);
    cp_async_commit();

    const unsigned char* ks_base =
        ring + (size_t)(tile % kMmaStages) * 2 * TP * ROW;
    const unsigned char* vs_base = ks_base + TP * ROW;
    const int pb = warp * kMmaTPW;
    const int valid = min(TP, t1 - (t0 + tile * TP)) - pb;
    if (valid <= 0) continue;         // warp-uniform

    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const int j = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int row = pb + (j >> 1) * 8 + rr;
      const int ch = 2 * ks + (j & 1);
      uint32_t kb[4];
      ldmatrix_x4(kb, ks_base + row * ROW + ((ch ^ (row & 7)) * 16));
      mma_bf16(sc[0], qa[ks][0], qa[ks][1], kb[0], kb[1]);
      mma_bf16(sc[1], qa[ks][0], qa[ks][1], kb[2], kb[3]);
    }
    // sc[n][e], e < 2: head gid, position pb + 8 n + 2 tig + e
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sv =
            8 * n + 2 * tig + e < valid ? sc[n][e] * p.scale : -INFINITY;
        sc[n][e] = sv;
        mx = fmaxf(mx, sv);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);    // finite: position pb is valid
    const float corr = m == -INFINITY ? 0.f : expf(m - mn);
    float pr[2][2];
    float ps = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[n][e] = sc[n][e] == -INFINITY ? 0.f : expf(sc[n][e] - mn);
        ps += pr[n][e];
      }
    l = l * corr + ps;
    m = mn;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }
    const uint32_t pa0 = pack_bf16(pr[0][0], pr[0][1]);
    const uint32_t pa2 = pack_bf16(pr[1][0], pr[1][1]);
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      const int row = pb + (j & 1) * 8 + rr;
      const int ch = n + (j >> 1);
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs_base + row * ROW + ((ch ^ (row & 7)) * 16));
      mma_bf16(o[n], pa0, pa2, vb[0], vb[1]);
      mma_bf16(o[n + 1], pa0, pa2, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();

  // a row's l is spread over its four lanes
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();                    // the ring is free: warp states alias it
  float* ws = reinterpret_cast<float*>(ring);   // [warp][STATE]
  if (gid < GT) {
    float* w = ws + warp * STATE;
    if (tig == 0) {
      w[gid] = m;
      w[GT + gid] = l;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      w[2 * GT + gid * DH + 8 * n + 2 * tig] = o[n][0];
      w[2 * GT + gid * DH + 8 * n + 2 * tig + 1] = o[n][1];
    }
  }
  __syncthreads();
  cta_epilogue<T, DH, GT>(p, ws, bh, c, b, kvh, g0, active);
}

// Positions a ring stage holds, as kernel.py tile_positions computes it.
template <typename T, int DH>
constexpr bool use_mma() {
  return sizeof(T) == 2 && DH >= 64;
}
template <typename T, int DH>
constexpr int tile_positions() {
  return use_mma<T, DH>() ? kMmaTP
         : kStageBytes / (2 * DH * (int)sizeof(T)) > 4 * 32
             ? 4 * 32
             : kStageBytes / (2 * DH * (int)sizeof(T));
}

template <typename Kern>
int set_smem(Kern kern, int smem, bool* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return kErrBadArgs;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  return 0;
}

template <typename T, int DH, int GT>
int launch_gt(const Params& p, int B, cudaStream_t stream) {
  constexpr int ROW = DH * (int)sizeof(T);
  constexpr int TP = tile_positions<T, DH>();
  constexpr int STATE = 2 * GT + GT * DH;
  if (p.chunk % TP) return kErrChunk;
  const dim3 grid((unsigned)(B * p.KVH * p.NG), (unsigned)p.chunks);
  const int smem = (use_mma<T, DH>() ? kMmaStages : kStages) * 2 * TP * ROW;
  // the epilogue's warp states and chunk merge alias the ring
  if ((long long)(kWarps * STATE + 2 * GT * p.chunks + GT) * 4 > smem)
    return kErrChunk;
  static bool configured[kMaxDevices] = {};
  int rc;
  if constexpr (use_mma<T, DH>()) {
    rc = set_smem(decode_attention_mma_kernel<DH, GT>, smem, configured);
    if (rc) return rc;
    decode_attention_mma_kernel<DH, GT><<<grid, kThreads, smem, stream>>>(p);
  } else {
    rc = set_smem(decode_attention_kernel<T, DH, GT>, smem, configured);
    if (rc) return rc;
    decode_attention_kernel<T, DH, GT><<<grid, kThreads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dh(const Params& p, int B, int gt, cudaStream_t stream) {
  if (gt == 4) return launch_gt<T, DH, 4>(p, B, stream);
  if (gt == 2) return launch_gt<T, DH, 2>(p, B, stream);
  return launch_gt<T, DH, 1>(p, B, stream);
}

template <typename T>
int launch(const Params& p, int B, int Dh, int gt, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch_dh<T, 32>(p, B, gt, stream);
    case 64: return launch_dh<T, 64>(p, B, gt, stream);
    case 128: return launch_dh<T, 128>(p, B, gt, stream);
    case 256: return launch_dh<T, 256>(p, B, gt, stream);
    default: return kErrHeadDim;
  }
}

}  // namespace

// q, out: (B, H, Dh); k, v: (B, S, KVH, Dh); lengths: (B,) int32; all
// contiguous and 16-byte aligned, dtype 0 = float32, 1 = bfloat16.
// gt query heads per CTA (1, 2 or 4), chunk positions per CTA (a multiple
// of the kernel's tile), chunks = ceil(S / chunk). part: float32 scratch
// of B * KVH * ceil(H / KVH / gt) * chunks * (2 + Dh) * gt floats and
// tickets: as many int32 zeros, one per (batch, kv head, group); both
// may be null when chunks = 1. scale is Dh^-0.5 as the caller rounds it.
// Returns 0, a cudaError_t, or a negative code.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* lengths, void* out,
                                       void* part, void* tickets, int B,
                                       int H, int KVH, int S, int Dh, int gt,
                                       int chunk, int chunks, float scale,
                                       void* stream) {
  if (B < 1 || S < 1 || KVH < 1) return kErrBadArgs;
  if (H < KVH || H % KVH) return kErrHeads;
  const int G = H / KVH;
  if ((gt != 1 && gt != 2 && gt != 4) || gt > G) return kErrBadArgs;
  if (chunk < 1 || chunks < 1 || chunks > 65535 ||
      (long long)(chunks - 1) * chunk >= S || (long long)chunks * chunk < S)
    return kErrChunk;
  if (chunks > 1 && (part == nullptr || tickets == nullptr))
    return kErrBadArgs;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  p.NG = (G + gt - 1) / gt;
  p.chunk = chunk;
  p.chunks = chunks;
  p.scale = scale;
  if ((long long)B * KVH * p.NG > 0x7fffffffLL) return kErrBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) return launch<float>(p, B, Dh, gt, st);
  if (dtype == kDtypeBF16) return launch<__nv_bfloat16>(p, B, Dh, gt, st);
  return kErrDtype;
}

extern "C" const char* decode_attention_error_string(int code) {
  switch (code) {
    case kErrBadArgs:
      return "decode_attention: need B, S, KVH >= 1, gt in {1, 2, 4} "
             "dividing into H / KVH, and scratch when chunks > 1";
    case kErrDtype:
      return "decode_attention: dtype must be float32 or bfloat16";
    case kErrHeadDim:
      return "decode_attention: head dim must be 32, 64, 128 or 256";
    case kErrHeads:
      return "decode_attention: H must be a multiple of KVH";
    case kErrChunk:
      return "decode_attention: chunk must be a multiple of the kernel's "
             "tile, chunks = ceil(S / chunk) <= 65535, and the chunks' "
             "merge must fit in the kernel's shared memory";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
