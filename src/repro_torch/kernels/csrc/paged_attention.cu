// Decode attention over the paged KV pool: one query token per sequence,
// grouped-query heads, keys and values reached through a block table.
//
// Replaces (Pallas, TPU):
//   paged_attention  <- src/repro/kernels/paged_attention.py:293
//
// Bound on the H100: memory. A step reads each sequence's live K and V
// once (context_len * Hkv * D elements per tensor: 2 MiB of K and 2 MiB
// of V per 1024 tokens at Qwen2.5-14B's Hkv=8, D=128 in bf16), plus the
// query and the table; it does ~4 * H * D flops per cached token, far
// below the 295 flop/byte at which the tensor cores would become the limit.
//
// Design: one thread block per (kv head, sequence). The G = H / Hkv query
// heads of the group share every K/V load, so K and V are read from device
// memory once per kv head, not once per query head. The block walks the
// context in tiles of up to 64 tokens (several pages), stopping at
// context_len instead of the padded table. Each tile's K and V rows are
// staged into shared memory as f32 with batched 16-byte loads, several in
// flight per thread, so a tile costs one memory round trip rather than one
// per token. Then a warp per token computes the G dot products (lanes
// stride over D, then a shuffle reduction), a warp per query head updates
// the f32 online softmax (running max m, sum l, rescale alpha) with
// shuffles, and each thread owns one output dim of the G f32 accumulators
// for one slice of the tile's tokens (256 threads = 256 / D slices), in
// registers; the slices are summed through shared memory at the end. The
// finaliser divides by max(l, 1e-20): a row with context_len = 0 writes
// zeros, which padded decode rows rely on.
// Positions past context_len are never read. Offsets are int64_t.
//
// What the simple design leaves: at batch 8 with Hkv = 8 the grid has 64
// blocks for 132 SMs, and each block walks its tiles serially; splitting
// the context across blocks (flash-decoding) and staging tiles through
// shared memory with cp.async or TMA is later work.
#include "common.cuh"

constexpr int PA_THREADS = 256;   // also the largest D: one dim per thread
constexpr int PA_TILE_TOKENS = 64;

template <typename T, int MAXG>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, T* __restrict__ out,
    int num_pages, int block_size, int tile_pages, int n_kv, int group,
    int head_dim, float scale, int vec) {
  extern __shared__ float smem[];
  const int G = group, D = head_dim, bs = block_size;
  const int TT = tile_pages * bs;            // tokens per tile
  const int n_slices = blockDim.x / D;       // token slices of the V pass
  float* q_s = smem;                         // (G, D) queries in f32
  float* k_s = q_s + G * D;                  // (TT, D) staged keys
  float* v_s = k_s + TT * D;                 // (TT, D) staged values
  float* p_s = v_s + TT * D;                 // (G, TT) scores, then weights
  float* r_s = p_s + G * TT;                 // (n_slices, G, D) partial sums
  float* m_s = r_s + n_slices * G * D;       // (G,) running max
  float* l_s = m_s + G;                      // (G,) running sum
  float* a_s = l_s + G;                      // (G,) rescale of this tile
  int* pg_s = reinterpret_cast<int*>(a_s + G);  // (tile_pages,) page ids

  const int kvh = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // V pass: thread (slice, d) accumulates dim d over the tile's tokens
  // slice, slice + n_slices, ...; the slices are summed at the end
  const int slice = tid / D, d = tid % D;
  const bool v_thread = slice < n_slices;
  const int64_t H = (int64_t)n_kv * G;
  int n_tok = ctx_lens[b];
  if (n_tok > num_pages * bs) n_tok = num_pages * bs;

  const T* qb = q + (b * H + (int64_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const int64_t tok_stride = (int64_t)n_kv * D;
  const int64_t page_stride = (int64_t)bs * tok_stride;
  const int64_t head_off = (int64_t)kvh * D;
  const int32_t* tbl = tables + b * num_pages;

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int valid = min(TT, n_tok - t0);
    for (int i = tid; i < tile_pages; i += blockDim.x) {
      const int p = t0 / bs + i;
      pg_s[i] = p < num_pages ? tbl[p] : 0;
    }
    __syncthreads();
    stage_kv_f32<T>(k_s, D, v_s, D, k_pages, v_pages, pg_s, valid, bs,
                    page_stride, tok_stride, head_off, D, vec);
    __syncthreads();

    for (int t = warp; t < valid; t += n_warps) {
      const float* kt = k_s + t * D;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      for (int dd = lane; dd < D; dd += 32) {
        const float kv = kt[dd];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) part[g] += q_s[g * D + dd] * kv;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {                          // G is uniform: no divergence
          float x = part[g];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane == 0) p_s[g * TT + t] = x * scale;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += n_warps) {
      float* row = p_s + g * TT;
      float m_cur = NEG_INF;
      for (int t = lane; t < valid; t += 32) m_cur = fmaxf(m_cur, row[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float e = expf(row[t] - m_new);
        row[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    if (v_thread) {
      float vs[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) vs[g] = 0.f;
#pragma unroll 4
      for (int t = slice; t < valid; t += n_slices) {
        const float vv = v_s[t * D + d];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) vs[g] += p_s[g * TT + t] * vv;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = acc[g] * a_s[g] + vs[g];
    }
    __syncthreads();
  }

  if (v_thread) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) r_s[(slice * G + g) * D + d] = acc[g];
  }
  __syncthreads();
  T* ob = out + (b * H + (int64_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, dd = i % D;
    float s = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) s += r_s[(sl * G + g) * D + dd];
    ob[i] = from_f32<T>(s / fmaxf(l_s[g], 1e-20f));
  }
}

template <typename T, int MAXG>
static int launch(const void* q, const void* k, const void* v,
                  const void* tables, const void* ctx, void* out,
                  int64_t batch, int num_pages, int block_size, int n_kv,
                  int group, int head_dim, float scale, cudaStream_t s) {
  const int tile_pages = block_size >= PA_TILE_TOKENS
                             ? 1 : PA_TILE_TOKENS / block_size;
  const size_t TT = (size_t)tile_pages * block_size, D = head_dim;
  const size_t n_slices = PA_THREADS / D;
  const size_t smem =
      sizeof(float) * ((size_t)group * D + 2 * TT * D + (size_t)group * TT +
                       n_slices * group * D + 3 * (size_t)group) +
      sizeof(int) * (size_t)tile_pages;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (D * sizeof(T)) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid((unsigned)n_kv, (unsigned)batch);
  paged_attention_kernel<T, MAXG><<<grid, PA_THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)tables,
      (const int32_t*)ctx, (T*)out, num_pages, block_size, tile_pages, n_kv,
      group, head_dim, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_group(const void* q, const void* k, const void* v,
                        const void* tables, const void* ctx, void* out,
                        int64_t batch, int num_pages, int block_size,
                        int n_kv, int group, int head_dim, float scale,
                        cudaStream_t s) {
  if (group <= 4)
    return launch<T, 4>(q, k, v, tables, ctx, out, batch, num_pages,
                        block_size, n_kv, group, head_dim, scale, s);
  if (group <= 8)
    return launch<T, 8>(q, k, v, tables, ctx, out, batch, num_pages,
                        block_size, n_kv, group, head_dim, scale, s);
  return launch<T, 16>(q, k, v, tables, ctx, out, batch, num_pages,
                       block_size, n_kv, group, head_dim, scale, s);
}

extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* ctx_lens, void* out,
                               int64_t batch, int num_pages, int block_size,
                               int n_kv, int group, int head_dim,
                               float scale, int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (group < 1 || group > 16 || head_dim > PA_THREADS || block_size > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_group<__nv_bfloat16>(q, k_pages, v_pages, tables, ctx_lens,
                                       out, batch, num_pages, block_size,
                                       n_kv, group, head_dim, scale, s);
  return launch_group<float>(q, k_pages, v_pages, tables, ctx_lens, out,
                             batch, num_pages, block_size, n_kv, group,
                             head_dim, scale, s);
}
