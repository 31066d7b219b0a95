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
// Design: one launch per call. The Pallas kernels carry one (bv, k)
// accumulator through a sequential grid over row strips; CTAs here run in
// no order, so each CTA owns one strip of rows of one slice, for one pass
// of JB right-hand sides (1 when bv = 1, else 8) and one block of up to
// 4 * ct columns: grid = (strips, passes * column blocks, B). The host
// plans the strips by bytes (kernel.py plan_gram) in one of two regimes:
// a small X is latency-bound (at most one CTA an SM, each with at least
// 16 KB of X, its whole strip requested at once), a large one streams
// (every CTA the card holds, a three-stage ring of 32 KB tiles).
//   1. Rows arrive through a ring of shared-memory tiles filled with
//      cp.async (16-byte copies from the first aligned element, 4-byte
//      ones for the ragged tail), or, for rows too wide for a ring of two
//      stages (k past about 20,000), straight from device memory into
//      registers. X is read once.
//   2. y = X_tile V^T. At k <= 32 a thread takes a row (two for tiles
//      past 256 rows), v staged in shared memory, the row walked from
//      column r % k at even k so that neighbouring threads hit different
//      banks. Wider rows sit in registers: thread (row group g, column
//      lane lc) holds x[r][lc + i ct] for its rows and forms its share of
//      their dot products; the shares are summed over the ct lanes of the
//      group by a fixed transposing shuffle tree (xsum), and across the
//      group's warps in warp order.
//   3. y^T X_tile from the same tile (shared memory or registers), with
//      fp32 accumulators for 4 columns x JB right-hand sides a thread.
//      The 256 / ct row groups merge in group order.
//   4. The CTAs of a thread-block cluster (up to 8; up to 16 for a single
//      slice) sum their partials through distributed shared memory in rank
//      order, each CTA one slice of the elements. With one cluster per
//      slice that is the result; otherwise each cluster writes its
//      partial to the caller's scratch and takes an integer ticket per
//      (slice, pass, column block, element slice); the CTA that draws the
//      last ticket sums the clusters' partials in cluster order and resets
//      the ticket to 0 for the next launch. The caller keeps scratch and
//      tickets with its plan of the shape.
// Every sum runs in an order fixed by the shapes alone -- no float
// atomics -- so two launches give the same bits, which keeps a Lanczos
// run on the card reproducible. What still holds it back at the smallest
// shapes is latency: from the launch to the first tile, and the cluster
// barriers, fences and the last CTA's sum after the last row (PERF.md).
// The kernel allocates nothing (scratch and tickets come from the
// caller) and runs on the caller's stream; the entry point returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJB = 8;                  // right-hand sides per pass
constexpr int kCPT = 4;                 // columns per thread per block
constexpr int kMaxCluster = 16;         // past 8: non-portable
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
constexpr int kMaxVsFloats = 16384;     // 64 KB of staged v at most
constexpr int kMaxSmemBytes = 232448 - 1024;   // static smem aside
constexpr int kErrBadArgs = -1;

struct Params {
  const float* x;     // (B, R, k)
  const float* v;     // (B, bv, k)
  float* out;         // (B, bv, k)
  float* part;        // (B, passes, blocks, clusters, kJB * CW)
  int* tickets;       // (B, passes, blocks, cluster)
  int B, R, k, bv;
  int rows;           // rows per strip
  int tile;           // rows per ring stage
  int stages;         // ring stages (2-8), 0 = read X from device memory
  int ct;             // column lanes: 32, 64, 128 or 256
  int blocks;         // column blocks of kCPT * ct columns
  int passes;         // ceil(bv / kJB)
  int cluster;        // CTAs per cluster
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n copy groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait_all_but(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// floats of one ring stage: the tile plus room for the alignment shift
__host__ __device__ inline long long slot_floats(int tile, int k) {
  return ((long long)tile * k + 4 + 3) / 4 * 4;
}

// floats of v staged in shared memory: its JB rows when k <= 32, or
// when JB = 8 and they fit kMaxVsFloats; otherwise v is read from device
// memory (into registers when JB = 1)
__host__ __device__ inline int vs_floats(int jbt, int k) {
  const int n = (jbt * k + 3) / 4 * 4;
  return k <= 32 || (jbt > 1 && n <= kMaxVsFloats) ? n : 0;
}

// Sum NV values per lane over the 32 lanes of a warp by a fixed
// transposing tree: at offset O a lane keeps the half of its values that
// (lane & O) selects and adds its partner's copy of that half; once one
// value is left the rest of the levels are a plain butterfly. Lane l ends
// with max(NV / 32, 1) sums, those of indices xbase(l) and on.
template <int NV, int O>
__device__ __forceinline__ void xsum(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (NV >= 2) {
      constexpr int H = NV / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      xsum<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      xsum<1, O / 2>(v, lane);
    }
  }
}
template <int NV, int O>
__device__ __forceinline__ int xbase(int lane) {
  if constexpr (O > 0 && NV >= 2)
    return (lane & O ? NV / 2 : 0) + xbase<NV / 2, O / 2>(lane);
  else
    return 0;
}

// JB right-hand sides a pass: 1 when bv = 1, else 8 (a pass with fewer
// uses zero rows of v). Every loop over them has a constant trip count.
template <int JB>
__global__ void __launch_bounds__(kThreads, 2)
    gram_kernel(const Params p) {
  constexpr int RT = JB == 1 ? 8 : 4;             // rows a thread, wide path
  constexpr int NV = RT * JB;                     // its dot-product shares
  extern __shared__ __align__(16) float smem[];
  __shared__ float red2[kWarps][NV];              // warp sums, wide path
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int strip = blockIdx.x;
  const int pass = blockIdx.y / p.blocks;
  const int cb = blockIdx.y % p.blocks;
  const int b = blockIdx.z;
  const int k = p.k;
  const int jb = min(JB, p.bv - pass * JB);        // live rows of v
  const int CW = kCPT * p.ct;
  const int kc0 = cb * CW;
  const int kw = min(CW, k - kc0);                 // columns this block
  const int RG = kThreads / p.ct;
  const int g = threadIdx.x / p.ct;
  const int lc = threadIdx.x % p.ct;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nvs = vs_floats(JB, k);
  float* vs = smem;                                // [JB][k] or nothing
  float* yt = smem + nvs;                          // [tile][JB]
  float* uni = yt + ((p.tile * JB + 3) & ~3);     // ring, then merge

  const int r0 = min(p.R, strip * p.rows);
  const int r1 = min(p.R, r0 + p.rows);
  const int tiles = (r1 - r0 + p.tile - 1) / p.tile;
  const long long slice0 = (long long)b * p.R * k;   // floats before slice
  const float* vb = p.v + ((long long)b * p.bv + pass * JB) * k;
  const long long sf = slot_floats(p.tile, k);
  const int S = p.stages;

  auto fetch = [&](int t) {
    const long long o0 = slice0 + (long long)(r0 + t * p.tile) * k;
    const long long o1 =
        slice0 + (long long)min(r1, r0 + (t + 1) * p.tile) * k;
    const long long a0 = o0 & ~3LL;
    const long long e16 = (o1 & ~3LL) > a0 ? (o1 & ~3LL) : a0;
    float* st = uni + (t % S) * sf;
    const int n16 = (int)((e16 - a0) / 4);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      cp_async16(st + 4 * i, p.x + a0 + 4 * i);
    for (int i = threadIdx.x; i < (int)(o1 - e16); i += kThreads)
      cp_async4(st + (e16 - a0) + i, p.x + e16 + i);
  };
  // v[j][c], zero for the rows past jb
  auto vat = [&](int j, int c) -> float {
    if (nvs) return vs[j * k + c];
    return j < jb ? __ldg(vb + (long long)j * k + c) : 0.f;
  };

  float acc[kCPT][JB];
#pragma unroll
  for (int i = 0; i < kCPT; ++i)
#pragma unroll
    for (int j = 0; j < JB; ++j) acc[i][j] = 0.f;

  if (S > 0) {
    for (int s = 0; s < S - 1; ++s) {
      if (s < tiles) fetch(s);
      cp_async_commit();
    }
  }
  // v after the first tiles' copies are on their way (the first barrier
  // of the loop publishes it)
  for (int i = threadIdx.x; i < nvs; i += kThreads)
    vs[i] = i < jb * k ? vb[i] : 0.f;
  float vr[kCPT];                     // JB = 1, wide rows: v in registers
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int c = kc0 + lc + i * p.ct;
    vr[i] = JB == 1 && k > 32 && c < k ? __ldg(vb + c) : 0.f;
  }

  // steps 2 and 3 on one tile of tr rows at xt: called with a pointer
  // into shared memory (the ring) or into device memory, so that each
  // call compiles to loads of its own address space
  auto body = [&](const float* __restrict__ xt, int tr) {
    // 2. y = X_tile V^T
    if (k <= 32) {
      // a thread per row, v staged (JB k <= 256 floats); a row of even
      // width is walked from column r % k, so neighbouring threads read
      // shared memory at an odd stride; two partial sums per row
      // (the tile has at most 2 * kThreads rows: a thread's two rows run
      // side by side)
      const int rot = k & 1 ? 0 : 1;
      const int ra = threadIdx.x, rb = threadIdx.x + kThreads;
      if (ra < tr) {
        const bool two = rb < tr;
        float d0[JB], d1[JB];
#pragma unroll
        for (int j = 0; j < JB; ++j) d0[j] = d1[j] = 0.f;
        const float* xa = xt + (long long)ra * k;
        const float* xb = xt + (long long)(two ? rb : ra) * k;
        const int ca = rot * (ra % k), cb2 = rot * ((two ? rb : ra) % k);
#pragma unroll 4
        for (int i = 0; i < k; ++i) {
          const int c = ca + i < k ? ca + i : ca + i - k;
          const int e = cb2 + i < k ? cb2 + i : cb2 + i - k;
          const float a = xa[c];
          const float bb = xb[e];
#pragma unroll
          for (int j = 0; j < JB; ++j) {
            d0[j] += a * vs[j * k + c];
            d1[j] += bb * vs[j * k + e];
          }
        }
#pragma unroll
        for (int j = 0; j < JB; ++j) {
          yt[ra * JB + j] = d0[j];
          if (two) yt[rb * JB + j] = d1[j];
        }
      }
      __syncthreads();
      // 3. acc += y^T X_tile: row group g, column lane lc
#pragma unroll 8
      for (int r = g; r < tr; r += RG) {
        float yv[JB];
#pragma unroll
        for (int j = 0; j < JB; ++j) yv[j] = yt[r * JB + j];
        const float* xr = xt + (long long)r * k + kc0;
#pragma unroll
        for (int i = 0; i < kCPT; ++i) {
          const int c = lc + i * p.ct;
          const float xv = c < kw ? xr[c] : 0.f;
#pragma unroll
          for (int j = 0; j < JB; ++j) acc[i][j] += yv[j] * xv;
        }
      }
    } else {
      // Wide rows, a register tile: thread (g, lc) holds x[r][kc0 + lc +
      // i ct] for its rows r = g + rr RG (rr < RT, i < kCPT) and forms its
      // share of their dot products from them (and from shared memory past
      // its column block); the shares are summed over the ct lanes of the
      // row group by the fixed tree of xsum and, above 32 lanes, over the
      // group's warps in warp order.
      float xg[RT][kCPT];
      float pd[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) pd[i] = 0.f;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {   // every load of the tile first
        const int r = g + rr * RG;
        const float* xr = xt + (long long)(r < tr ? r : 0) * k;
#pragma unroll
        for (int i = 0; i < kCPT; ++i) {
          const int c = kc0 + lc + i * p.ct;
          xg[rr][i] = r < tr && c < k ? xr[c] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        const int c = kc0 + lc + i * p.ct;
#pragma unroll
        for (int j = 0; j < JB; ++j) {
          const float vv = JB == 1 ? vr[i] : (c < k ? vat(j, c) : 0.f);
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) pd[rr * JB + j] += xg[rr][i] * vv;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const int r = g + rr * RG;
        const bool live = r < tr;
        const float* xr = xt + (long long)(live ? r : 0) * k;
        if (p.blocks > 1 && live) {
          for (int c = lc; c < k; c += p.ct) {
            if (c >= kc0 && c < kc0 + CW) continue;   // its own block
            const float xv = xr[c];
#pragma unroll
            for (int j = 0; j < JB; ++j) pd[rr * JB + j] += xv * vat(j, c);
          }
        }
      }
      xsum<NV, 16>(pd, lane);
      constexpr int M = NV >= 32 ? NV / 32 : 1;     // sums this lane holds
      const int base = xbase<NV, 16>(lane);
      const bool writer = NV >= 32 || (lane & (32 / NV - 1)) == 0;
      const int wpg = p.ct / 32;                    // warps a row group
      if (wpg == 1) {
        if (writer)
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int idx = base + m;
            const int r = g + (idx / JB) * RG;
            if (r < tr) yt[r * JB + idx % JB] = pd[m];
          }
      } else {
        if (writer)
#pragma unroll
          for (int m = 0; m < M; ++m) red2[warp][base + m] = pd[m];
        __syncthreads();
        for (int idx = threadIdx.x; idx < tr * JB; idx += kThreads) {
          const int r = idx / JB, j = idx % JB;
          const int gg = r % RG, rr = r / RG;
          float sum = 0.f;
          for (int q = 0; q < wpg; ++q)
            sum += red2[gg * wpg + q][rr * JB + j];
          yt[idx] = sum;
        }
      }
      __syncthreads();
      // 3. acc += y^T X_tile from the register tile
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const int r = g + rr * RG;
        if (r < tr) {
          float yv[JB];
#pragma unroll
          for (int j = 0; j < JB; ++j) yv[j] = yt[r * JB + j];
#pragma unroll
          for (int i = 0; i < kCPT; ++i)
#pragma unroll
            for (int j = 0; j < JB; ++j) acc[i][j] += yv[j] * xg[rr][i];
        }
      }
    }
  };

  for (int t = 0; t < tiles; ++t) {
    const int rt = r0 + t * p.tile;
    const int tr = min(p.tile, r1 - rt);
    if (S > 0) {
      cp_async_wait_all_but(S - 2);   // tile t has landed
      __syncthreads();                // ... for all threads; t - 1 is done
      if (t + S - 1 < tiles) fetch(t + S - 1);
      cp_async_commit();
      const long long o0 = slice0 + (long long)rt * k;
      body(uni + (t % S) * sf + (o0 - (o0 & ~3LL)), tr);
    } else {
      __syncthreads();                // t - 1 is done with its y tile
      body(p.x + slice0 + (long long)rt * k, tr);
    }
  }
  if (S > 0) cp_async_wait_all_but(0);
  __syncthreads();                    // the ring is free for the merge

  // Row groups merge in group order: red[g][j][c], summed into red[0].
  float* red = uni;
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int c = lc + i * p.ct;
#pragma unroll
    for (int j = 0; j < JB; ++j)
      red[((long long)g * JB + j) * CW + c] = acc[i][j];
  }
  __syncthreads();
  const int F = jb * CW;              // partial elements, [j][c] layout
  for (int e = threadIdx.x; e < F; e += kThreads) {
    float s = red[e];
    for (int q = 1; q < RG; ++q) s += red[(long long)q * JB * CW + e];
    red[e] = s;
  }

  // 4. the cluster's CTAs sum their partials in rank order, each its own
  // slice of the F elements
  cluster.sync();
  const int CL = p.cluster;
  const int e0 = (int)((long long)F * rank / CL);
  const int e1 = (int)((long long)F * (rank + 1) / CL);
  const int clusters = gridDim.x / CL;
  const int cid = strip / CL;
  const long long unit = (((long long)b * p.passes + pass) * p.blocks + cb);
  float* outb = p.out + ((long long)b * p.bv + pass * JB) * k + kc0;
  float* mine = p.part + (unit * clusters + cid) * kJB * CW;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    if (e % CW >= kw) continue;
    float pv[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      pv[q] = q < CL ? cluster.map_shared_rank(red, q)[e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CL) s += pv[q];
    if (clusters == 1)
      outb[(long long)(e / CW) * k + e % CW] = s;
    else
      mine[e] = s;
  }
  cluster.sync();                     // peers' shared memory stays alive
  if (clusters == 1) return;

  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + unit * CL + rank;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == clusters - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // a thread per element, four elements at a time, each summing the
  // clusters' partials in cluster order, eight clusters' loads in flight
  const float* all = p.part + unit * clusters * kJB * CW;
  const int per = (e1 - e0 + kThreads - 1) / kThreads;   // elements a thread
  for (int u0 = 0; u0 < per; u0 += 4) {
    float sum[4];
    int ee[4];
    bool live[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ee[u] = e0 + threadIdx.x + (u0 + u) * kThreads;
      live[u] = u0 + u < per && ee[u] < e1 && ee[u] % CW < kw;
      sum[u] = 0.f;
    }
    for (int q0 = 0; q0 < clusters; q0 += 8) {
      float got[8][4];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int q = q0 + w;
        const float* pq = all + (long long)(q < clusters ? q : 0) * kJB * CW;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          got[w][u] = live[u] && q < clusters ? __ldcg(pq + ee[u]) : 0.f;
      }
#pragma unroll
      for (int w = 0; w < 8; ++w)
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[u] += got[w][u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (live[u]) outb[(long long)(ee[u] / CW) * k + ee[u] % CW] = sum[u];
  }
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace

// x: (B, R, k), v: (B, bv, k), out: (B, bv, k), contiguous float32, x
// 16-byte aligned. rows, tile, stages, ct, cluster: the plan of
// kernel.py plan_gram, from which strips = cluster * clusters with
// clusters = ceil(ceil(R / rows) / cluster), blocks = ceil(k / (4 ct))
// and passes = ceil(bv / 8). part: float32 scratch of B * passes * blocks
// * clusters * 8 * 4 * ct floats and tickets: B * passes * blocks *
// cluster int32 zeros; both may be null when clusters = 1. Returns 0, a
// cudaError_t, or a negative code for a rejected argument.
extern "C" int gram_matvec_launch(const void* x, const void* v, void* out,
                                  void* part, void* tickets, int B, int R,
                                  int k, int bv, int rows, int tile,
                                  int stages, int ct, int cluster,
                                  void* stream) {
  if (B < 1 || B > 65535 || R < 1 || k < 1 || bv < 1 || rows < 1 ||
      tile < 1 || stages < 0 || stages > kMaxStages || stages == 1 ||
      cluster < 1 ||
      cluster > kMaxCluster ||
      (ct != 32 && ct != 64 && ct != 128 && ct != 256))
    return kErrBadArgs;
  Params p;
  p.x = static_cast<const float*>(x);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.R = R;
  p.k = k;
  p.bv = bv;
  p.rows = rows;
  p.tile = tile;
  p.stages = stages;
  p.ct = ct;
  p.blocks = (k + kCPT * ct - 1) / (kCPT * ct);
  p.passes = (bv + kJB - 1) / kJB;
  p.cluster = cluster;
  const long long strips = (R + (long long)rows - 1) / rows;
  const long long clusters = (strips + cluster - 1) / cluster;
  if (clusters > 1 && (part == nullptr || tickets == nullptr))
    return kErrBadArgs;
  if (clusters * cluster > 0x7fffffffLL ||
      (long long)p.passes * p.blocks > 65535)
    return kErrBadArgs;
  const int jbt = bv == 1 ? 1 : kJB;
  const long long ring = stages * slot_floats(tile, k);
  const long long red = (long long)jbt * kCPT * kThreads;   // row groups
  const long long smem = 4 * (vs_floats(jbt, k) +
                              (((long long)tile * jbt + 3) & ~3LL) +
                              (ring > red ? ring : red));
  if (smem > kMaxSmemBytes) return kErrBadArgs;
  auto kern = jbt == 1 ? gram_kernel<1> : gram_kernel<kJB>;

  static long long configured[2][kMaxDevices] = {};  // bytes set, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return kErrBadArgs;
  long long& done = configured[jbt == 1 ? 0 : 1][dev];
  if (done < smem) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
    done = smem;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster),
                     (unsigned)(p.passes * p.blocks), (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* spectral_matvec_error_string(int code) {
  if (code == kErrBadArgs)
    return "gram_matvec: need 1 <= B <= 65535, R, k, bv, rows, tile >= 1, "
           "stages 0 or 2-8, ct in {32, 64, 128, 256}, 1 <= cluster "
           "<= 16, scratch when more than one cluster, and the plan's "
           "shared memory within 227 KB";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
