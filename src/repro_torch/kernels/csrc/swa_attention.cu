// Causal sliding-window attention (prefill), MHA layout: q, k, v
// (B, S, H, D) float / bf16 -> out (B, S, H, D) of the same type. Query i
// attends to keys j with i - window < j <= i, softmax in f32 with scale
// 1/sqrt(D).
//
// Replaces (Pallas, TPU):
//   swa_attention  <- src/repro/kernels/swa_attention.py:66
//
// Bound on the H100: operations. Each (query, visible key) pair costs
// 4 * D flops (score and weighted value); at Hymba-1.5B's shapes (D 64,
// window 1024, S 2048) a query sees up to 1024 keys, some 380 flops per
// byte of q, k, v and out: above even the bf16 tensor-core ridge (295).
//
// bf16 with D a multiple of 16 up to 128 (swa_attention_tc_kernel): the
// tensor-core tile loop of paged_prefill.cu's B4 on the dense MHA layout,
// with a window bound on the key walk. One block of 4 warps per (tile of
// 64 queries, head, batch row), 16 query rows per warp; the blocks with
// the longest walks are numbered first. Q sits in registers as mma A
// fragments loaded from global memory (row stride H * D). The block walks
// the 64-key tiles from floor(max(0, q0 - window + 1) / 64) * 64 to its
// last query (at most 17 tiles at a window of 1024): each tile's K and V
// rows, contiguous D-element runs at stride H * D, go through a two-stage
// ring of 16-byte cp.async.cg copies into rows padded to D + 8 bf16, keys
// past S zero-filled. Each tile takes mma.cuh's three steps: S = Q K^T by
// mma.sync m16n8k16 (bf16 in, f32 accumulators), the online softmax in
// registers, O += P V with P split hi + lo in bf16. The mask is key <= i
// && key > i - window && key < S; a tile that every row of the warp sees
// whole skips it (most of the 17 tiles at Hymba-1.5B's shape). O is
// divided by max(l, 1e-20); rows past S are not written. Shared memory is
// 4 * 64 * (D + 8) * 2 bytes (36.9 KB at D = 64); registers, not shared
// memory, bound the blocks per SM.
//
// f32, and bf16 outside those shapes (swa_attention_kernel): one thread
// block per (tile of 64 queries, head, batch row). The
// Pallas kernel's static grid visits every KV block and masks the ones
// outside the window; here the block visits only the 64-key tiles that
// overlap [q_start - window + 1, q_end], so its work is O(window). The
// query tile sits in shared memory as f32; each key tile's K and V are
// staged as f32 (with 16-byte loads where rows allow). 256 threads as a
// 16 x 16 grid: each computes a 4 x 4 register tile of scores (query rows
// ty + 16 r, keys tx + 16 s), reading Q and K four dims at a time as
// float4 (rows padded to an odd number of float4s, so the 16 key rows read
// at once spread over all 32 banks); the online softmax reduces each row
// across its 16 lanes with shuffles, keeps m and l in registers and writes
// the weights to shared memory; then each thread accumulates its 4 query
// rows at dims 4 tx .. 4 tx + 3 (and 64 further for D > 64) in registers,
// four keys at a time, again from float4 reads: about three float4 loads
// per 16 FMAs, where scalar reads (the first version) needed one load per
// two. The finaliser divides by max(l, 1e-20), as the Pallas kernel does.
// Rows past S (a ragged last tile) are masked and not written. What it
// leaves: scalar f32 FMAs from shared memory, synchronous staging, and
// masked work on the diagonal and window-edge tiles.
#include "common.cuh"
#include "mma.cuh"

constexpr int SWA_THREADS = 256;   // a 16 x 16 grid of threads
constexpr int SWA_QT = 64;         // queries per block
constexpr int SWA_KT = 64;         // keys per tile
constexpr int SWA_MAX_D = 128;

// Rows [0, rows) of a (rows, D) tile into dst (row stride ld) as f32; rows
// at or past `valid` are zero. Row t starts at src + t * row_stride. With
// vec (D * sizeof(T) a multiple of 16 and 16-byte aligned rows) each
// thread loads 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int64_t row_stride, int rows,
                                           int valid, int D, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int vpr = D / E;
    for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
      const int t = i / vpr, c = i % vpr;
      float* d = dst + t * ld + c * E;
      if (t < valid) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            src + t * row_stride + c * E);
        const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
        for (int u = 0; u < E; ++u) d[u] = to_f32(e[u]);
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u) d[u] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int t = i / D, c = i % D;
      dst[t * ld + c] = t < valid ? to_f32(src[t * row_stride + c]) : 0.f;
    }
  }
}

// Row stride of D-wide f32 tiles that 16 lanes read as float4 at 16
// different rows: an odd number of float4s puts those rows on all eight
// 4-bank groups twice
__host__ __device__ __forceinline__ int swa_ld(int d) {
  const int d4 = (d + 3) / 4 * 4;
  return (d4 / 4) % 2 ? d4 : d4 + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// DG: float4 groups of head dims per thread (dims 4 (tx + 16 g) .. + 3,
// g < DG), so D <= 64 * DG
template <typename T, int DG>
__global__ void __launch_bounds__(SWA_THREADS) swa_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int D,
    int window, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int LD = swa_ld(D), D4 = (D + 3) / 4 * 4;
  constexpr int PL = SWA_KT + 4;           // weights row stride
  float* q_s = smem;                       // (QT, LD)
  float* k_s = q_s + SWA_QT * LD;          // (KT, LD)
  float* v_s = k_s + SWA_KT * LD;          // (KT, D4)
  float* p_s = v_s + SWA_KT * D4;          // (QT, PL) softmax weights

  const int q0 = blockIdx.x * SWA_QT;
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t base = (bb * S * H + h) * (int64_t)D;   // (bb, 0, h, 0)
  const int q_valid = min(SWA_QT, S - q0);

  // the columns past D stay zero: staging writes only [0, D)
  for (int i = tid; i < (SWA_QT + SWA_KT) * LD + SWA_KT * D4;
       i += blockDim.x)
    smem[i] = 0.f;
  __syncthreads();
  stage_rows<T>(q_s, LD, q + base + q0 * row_stride, row_stride, SWA_QT,
                q_valid, D, vec);

  float m[4], l[4];
  float4 acc[4][DG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int dg[DG];                              // float4 group (clamped)
#pragma unroll
  for (int g = 0; g < DG; ++g) dg[g] = 4 * min(tx + 16 * g, D4 / 4 - 1);

  const int q_last = q0 + q_valid - 1;
  const int lo = max(0, q0 - window + 1);
  for (int t0 = lo / SWA_KT * SWA_KT; t0 <= q_last; t0 += SWA_KT) {
    const int k_valid = min(SWA_KT, S - t0);
    stage_rows<T>(k_s, LD, k + base + t0 * row_stride, row_stride, SWA_KT,
                  k_valid, D, vec);
    stage_rows<T>(v_s, D4, v + base + t0 * row_stride, row_stride, SWA_KT,
                  k_valid, D, vec);
    __syncthreads();

    // scores: query rows ty + 16 r against keys tx + 16 s, four dims at a
    // time
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) sc[r][s] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = ld4(q_s + (ty + 16 * u) * LD + d);
        kv[u] = ld4(k_s + (tx + 16 * u) * LD + d);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          sc[r][s] += qv[r].x * kv[s].x + qv[r].y * kv[s].y +
                      qv[r].z * kv[s].z + qv[r].w * kv[s].w;
    }

    // online softmax: the 16 lanes of a row (same ty) hold its 64 keys
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty + 16 * r;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int kp = t0 + tx + 16 * s;
        live[s] = qp < S && kp <= qp && kp > qp - window;
        sc[r][s] = live[s] ? sc[r][s] * scale : NEG_INF;
        mx = fmaxf(mx, sc[r][s]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float p = live[s] ? expf(sc[r][s] - m_new) : 0.f;
        p_s[(ty + 16 * r) * PL + tx + 16 * s] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        acc[r][g].x *= alpha;
        acc[r][g].y *= alpha;
        acc[r][g].z *= alpha;
        acc[r][g].w *= alpha;
      }
    }
    __syncthreads();

    // weighted values: four keys at a time (weights past k_valid are zero
    // and so are the staged value rows)
    const int t_end = (k_valid + 3) / 4 * 4;
    for (int t = 0; t < t_end; t += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ld4(p_s + (ty + 16 * r) * PL + t);
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        float4 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = ld4(v_s + (t + u) * D4 + dg[g]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][g].x += pv[r].x * vv[0].x + pv[r].y * vv[1].x +
                         pv[r].z * vv[2].x + pv[r].w * vv[3].x;
          acc[r][g].y += pv[r].x * vv[0].y + pv[r].y * vv[1].y +
                         pv[r].z * vv[2].y + pv[r].w * vv[3].y;
          acc[r][g].z += pv[r].x * vv[0].z + pv[r].y * vv[1].z +
                         pv[r].z * vv[2].z + pv[r].w * vv[3].z;
          acc[r][g].w += pv[r].x * vv[0].w + pv[r].y * vv[1].w +
                         pv[r].z * vv[2].w + pv[r].w * vv[3].w;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = ty + 16 * r;
    if (qi >= q_valid) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const float a4[4] = {acc[r][g].x, acc[r][g].y, acc[r][g].z,
                           acc[r][g].w};
      const int d0 = 4 * (tx + 16 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D)
          out[base + (q0 + qi) * row_stride + d0 + e] =
              from_f32<T>(a4[e] / den);
    }
  }
}

template <typename T, int DG>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int64_t batch, int S, int H, int D, int window, float scale,
                  cudaStream_t s) {
  const size_t ld = swa_ld(D), d4 = (D + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((SWA_QT + SWA_KT) * ld +
                                       SWA_KT * d4 + SWA_QT * (SWA_KT + 4));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_attention_kernel<T, DG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (D * sizeof(T)) % 16 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const dim3 grid((unsigned)((S + SWA_QT - 1) / SWA_QT), (unsigned)H,
                  (unsigned)batch);
  swa_attention_kernel<T, DG><<<grid, SWA_THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, D, window, scale,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dims(const void* q, const void* k, const void* v,
                       void* out, int64_t batch, int S, int H, int D,
                       int window, float scale, cudaStream_t s) {
  if (D <= 64)
    return launch<T, 1>(q, k, v, out, batch, S, H, D, window, scale, s);
  return launch<T, 2>(q, k, v, out, batch, S, H, D, window, scale, s);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile loop
// ---------------------------------------------------------------------------

constexpr int SWA_TC_THREADS = 128;   // 4 warps
constexpr int SWA_TC_ROWS = 64;       // queries per block, 16 per warp
constexpr int SWA_TC_KEYS = 64;       // keys per tile

template <int D>
constexpr size_t swa_tc_smem_bytes() {
  return 4 * SWA_TC_KEYS * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(SWA_TC_THREADS, D <= 64 ? 4 : 2)
    swa_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int H,
                            int window, float scale_log2) {
  constexpr int LD = D + 8;                 // shared row stride (bf16)
  constexpr int TILE = SWA_TC_KEYS * LD;    // elements of one K or V tile
  constexpr int KSTEPS = D / 16;            // k-steps of Q K^T
  constexpr int DT = D / 8;                 // n-tiles of O
  constexpr int CPR = D / 8;                // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // [stage][K, V][TILE]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * SWA_TC_ROWS;
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t base = (bb * S * H + h) * (int64_t)D;   // (bb, 0, h, 0)
  const int w_lo = q0 + warp * 16;          // the warp's rows w_lo .. + 15
  const int row[2] = {w_lo + grp, w_lo + grp + 8};   // this lane's rows

  // Q as A fragments: qa[kk] = rows (grp, grp + 8), dims kk * 16 + ...
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x & 1, half = x >> 1;
      qa[kk][x] = row[i] < S
                      ? *reinterpret_cast<const uint32_t*>(
                            q + base + row[i] * row_stride + kk * 16 +
                            half * 8 + 2 * tig)
                      : 0u;
    }

  const int q_last = min(q0 + SWA_TC_ROWS - 1, S - 1);
  const int t_first = max(0, q0 - window + 1) / SWA_TC_KEYS * SWA_TC_KEYS;
  const int n_tiles = (q_last - t_first) / SWA_TC_KEYS + 1;

  // cp.async of the K and V rows of tile `tile` into ring stage `st`
  auto issue = [&](int tile, int st) {
    const int t0 = t_first + tile * SWA_TC_KEYS;
    __nv_bfloat16* ks = kv_s + 2 * st * TILE;
    __nv_bfloat16* vs = ks + TILE;
#pragma unroll
    for (int i0 = 0; i0 < SWA_TC_KEYS * CPR; i0 += SWA_TC_THREADS) {
      const int i = i0 + tid, t = i / CPR, c = i % CPR;
      const bool live = t0 + t < S;
      const int64_t src = live ? base + (t0 + t) * row_stride + c * 8 : 0;
      const int n = live ? 16 : 0;   // 0: zero-fill the chunk
      cp_async_16(smem_u32(ks + t * LD + c * 8), k + src, n);
      cp_async_16(smem_u32(vs + t * LD + c * 8), v + src, n);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int k_lane = k_lane_offset(lane, LD);
  const int v_lane = v_lane_offset(lane, LD);

  if (n_tiles > 0) {   // no tiles only for windows below 1
    issue(0, 0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = t_first + it * SWA_TC_KEYS;
    // the other stage is free once every warp is past the previous
    // iteration
    __syncthreads();
    if (it + 1 < n_tiles) issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of tile `it` have landed
    __syncthreads();      // and everyone's
    const __nv_bfloat16* ks = kv_s + 2 * st * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    float s[8][4];
    tile_scores<D>(s, qa, ks, k_lane);
    // every row of the warp sees every key of the tile: all keys at or
    // before the warp's first row, after its last row's window start, and
    // before S
    const bool full = t0 + SWA_TC_KEYS - 1 <= w_lo &&
                      t0 > w_lo + 15 - window && t0 + SWA_TC_KEYS <= S;
    tile_softmax<DT>(s, m_r, l_r, o, scale_log2, full, [&](int n, int x) {
      const int key = t0 + n * 8 + 2 * tig + (x & 1), i = row[x >> 1];
      return key <= i && key > i - window && key < S;
    });
    tile_pv<D>(o, s, vs, v_lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-20f);
    if (row[i] >= S) continue;
    __nv_bfloat16* dst = out + base + row[i] * row_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * i] / l, o[n][2 * i + 1] / l);
  }
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* out,
                     int64_t batch, int S, int H, int window, float scale,
                     cudaStream_t s) {
  constexpr size_t smem = swa_tc_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_attention_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((S + SWA_TC_ROWS - 1) / SWA_TC_ROWS),
                  (unsigned)H, (unsigned)batch);
  swa_attention_tc_kernel<D><<<grid, SWA_TC_THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, H, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// The tensor-core kernel's shapes: D a multiple of 16 up to 128, q/k/v
// and out 16-byte aligned (cp.async of whole 16-byte row chunks).
static bool tc_takes(const void* q, const void* k, const void* v,
                     const void* out, int D) {
  return D % 16 == 0 && D <= 128 &&
         ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) %
                 16 == 0;
}

static int launch_tc_dim(const void* q, const void* k, const void* v,
                         void* out, int64_t batch, int S, int H, int D,
                         int window, float scale, cudaStream_t s) {
#define SWA_TC_CASE(DIM)                                                    \
  case DIM:                                                                 \
    return launch_tc<DIM>(q, k, v, out, batch, S, H, window, scale, s);
  switch (D) {
    SWA_TC_CASE(16)
    SWA_TC_CASE(32)
    SWA_TC_CASE(48)
    SWA_TC_CASE(64)
    SWA_TC_CASE(80)
    SWA_TC_CASE(96)
    SWA_TC_CASE(112)
    SWA_TC_CASE(128)
  }
#undef SWA_TC_CASE
  return (int)cudaErrorInvalidValue;
}

// bf16 in the tensor-core kernel's shapes (tc_takes) takes it; f32 and
// other bf16 shapes the scalar template
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* out, int64_t batch, int S, int H, int D,
                             int window, float scale, int dtype,
                             void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0) return 0;
  if (D < 1 || D > SWA_MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16 && tc_takes(q, k, v, out, D))
    return launch_tc_dim(q, k, v, out, batch, S, H, D, window, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_dims<__nv_bfloat16>(q, k, v, out, batch, S, H, D, window,
                                      scale, s);
  return launch_dims<float>(q, k, v, out, batch, S, H, D, window, scale, s);
}
