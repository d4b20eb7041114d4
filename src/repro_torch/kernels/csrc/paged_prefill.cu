// Chunked suffix-prefill attention over the paged KV pool: C queries per
// sequence at absolute positions q_pos attend causally (kv_pos <= q_pos)
// to the cached prefix and the chunk's own, already written, keys. The
// pool is float / bf16 (paged_prefill_attention) or int8 with one f32
// scale per (page, kv head) (paged_prefill_attention_quant).
//
// Replaces (Pallas, TPU):
//   paged_prefill_attention        <- src/repro/kernels/paged_prefill.py:290
//   paged_prefill_attention_quant  <- src/repro/kernels/paged_prefill.py:230
//
// Bound on the H100: memory at serving chunk sizes. The least traffic is
// each sequence's K and V up to its last query position read once, plus
// q and out (B*C*H*D elements each); the work is ~4 * H * D flops per
// (query, visible key) pair. At C = 32 and G = 5 that is about 20 flops
// per byte of bf16 K/V, under the 295 flop/byte ridge.
//
// Design: one thread block per (query tile of QT queries, kv head,
// sequence). The tile's QT * G query rows sit in shared memory in f32.
// The block walks the keys up to the tile's largest q_pos in tiles of up
// to 64 tokens (several pages): each tile's K and V are staged once into
// shared memory as f32 with batched 16-byte loads, several in flight per
// thread (K rows padded by four floats so float4 reads of different rows
// are free of bank conflicts), and serve all rows. A thread per (query,
// key) pair computes the G scores of that query's heads from float4 reads,
// loading each key element once for all G heads; a warp per row updates
// the f32 online softmax with shuffles; a thread per (query, dim) pair
// rescales and accumulates the G f32 accumulators of that query (weights
// read four keys at a time), which live in shared memory. The float4 reads
// need D and bs to be multiples of 4. Rows with
// q_pos = -1 finish at l = 0 and write zeros. Keys past the tile's largest
// q_pos are never read. Offsets are int64_t.
//
// int8 pages (paged_prefill_attention_quant): the same kernel with the
// page type as a template parameter, as in paged_attention.cu. Each tile
// page's two scales are read once, beside its page id, and the staging
// step dequantizes (float(q) * scale, one f32 product rounded once); the
// rest is the float kernel's arithmetic, QT query rows per block included.
// The 16-byte vector path needs D % 16 == 0 for int8 pages.
//
// What the simple design leaves: every query tile of a sequence re-reads
// its keys (C / QT times), scores and values are plain f32 FMAs instead of
// wgmma on bf16 tiles, and tiles are staged synchronously; a tensor-core
// tile loop with a TMA ring is later work.
#include "common.cuh"

constexpr int PP_THREADS = 256;
constexpr int PP_TILE_TOKENS = 64;

// T: query and output type; P: page type (T, or int8_t with scales)
template <typename T, typename P, int MAXG>
__global__ void __launch_bounds__(PP_THREADS) paged_prefill_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int chunk,
    int num_pages, int block_size, int tile_pages, int n_kv, int group,
    int head_dim, int q_tile, float scale, int vec) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
  const int G = group, D = head_dim, bs = block_size, QT = q_tile;
  const int TT = tile_pages * bs;    // keys per tile
  const int R = QT * G;              // query rows of the tile: r = jj*G + g
  const int KLD = D + 4;             // K row stride: 16-byte aligned rows,
                                     // float4 reads by row free of conflicts
  float* q_s = smem;                 // (R, D)
  float* k_s = q_s + R * D;          // (TT, KLD)
  float* v_s = k_s + TT * KLD;       // (TT, D)
  float* p_s = v_s + TT * D;         // (R, TT) scores, then weights
  float* acc_s = p_s + R * TT;       // (R, D)
  float* m_s = acc_s + R * D;        // (R,)
  float* l_s = m_s + R;              // (R,)
  float* a_s = l_s + R;              // (R,)
  int* qp_s = reinterpret_cast<int*>(a_s + R);  // (QT,)
  int* pg_s = qp_s + QT;                        // (tile_pages,)
  // (tile_pages,) K and V scales of the tile's pages (int8 pages only)
  float* ksc_s = reinterpret_cast<float*>(pg_s + tile_pages);
  float* vsc_s = ksc_s + tile_pages;

  const int j0 = blockIdx.x * QT;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t H = (int64_t)n_kv * G;

  for (int jj = tid; jj < QT; jj += blockDim.x)
    qp_s[jj] = (j0 + jj < chunk) ? q_pos[b * chunk + j0 + jj] : -1;
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D, jj = r / G, g = r % G;
    const int j = j0 + jj;
    q_s[i] = (j < chunk)
                 ? to_f32(q[((b * chunk + j) * H + (int64_t)kvh * G + g) * D + d])
                 : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  int max_pos = -1;
  for (int jj = 0; jj < QT; ++jj) max_pos = max(max_pos, qp_s[jj]);
  int n_tok = max_pos + 1;
  if (n_tok > num_pages * bs) n_tok = num_pages * bs;

  const int64_t tok_stride = (int64_t)n_kv * D;
  const int64_t page_stride = (int64_t)bs * tok_stride;
  const int64_t head_off = (int64_t)kvh * D;
  const int32_t* tbl = tables + b * num_pages;

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int valid = min(TT, n_tok - t0);
    for (int i = tid; i < tile_pages; i += blockDim.x) {
      const int p = t0 / bs + i;
      const int pg = p < num_pages ? tbl[p] : 0;
      pg_s[i] = pg;
      if constexpr (QUANT) {
        ksc_s[i] = k_scale[(int64_t)pg * n_kv + kvh];
        vsc_s[i] = v_scale[(int64_t)pg * n_kv + kvh];
      }
    }
    __syncthreads();
    stage_kv_f32<P>(k_s, KLD, v_s, D, k_pages, v_pages, pg_s, ksc_s, vsc_s,
                    valid, bs, page_stride, tok_stride, head_off, D, vec);
    __syncthreads();

    // scores: one thread per (query, key); each float4 of the key is
    // loaded once for the G heads of the query
    for (int i = tid; i < QT * TT; i += blockDim.x) {
      const int jj = i / TT, t = i % TT;
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
      if (t < valid) {
        const float4* kt = reinterpret_cast<const float4*>(k_s + t * KLD);
        const float4* qr = reinterpret_cast<const float4*>(q_s + jj * G * D);
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = kt[d4];
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float4 qv = qr[g * (D / 4) + d4];
              s[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
            }
          }
        }
      }
      const bool live = t < valid && t0 + t <= qp_s[jj];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) p_s[(jj * G + g) * TT + t] = live ? s[g] * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < R; r += n_warps) {
      float* row = p_s + r * TT;
      const int qp = qp_s[r / G];
      float m_cur = NEG_INF;
      for (int t = lane; t < valid; t += 32) m_cur = fmaxf(m_cur, row[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float e = (t0 + t <= qp) ? expf(row[t] - m_new) : 0.f;
        row[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // accumulate: one thread per (query, dim); each value element is
    // loaded once for the G heads of the query, the weights four keys at a
    // time as a float4
    for (int i = tid; i < QT * D; i += blockDim.x) {
      const int jj = i / D, d = i % D;
      float a[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) a[g] = 0.f;
      int t = 0;
      for (; t + 4 <= valid; t += 4) {
        const float v0 = v_s[t * D + d], v1 = v_s[(t + 1) * D + d];
        const float v2 = v_s[(t + 2) * D + d], v3 = v_s[(t + 3) * D + d];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 w = *reinterpret_cast<const float4*>(
                p_s + (jj * G + g) * TT + t);
            a[g] += w.x * v0 + w.y * v1 + w.z * v2 + w.w * v3;
          }
        }
      }
      for (; t < valid; ++t) {
        const float vv = v_s[t * D + d];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) a[g] += p_s[(jj * G + g) * TT + t] * vv;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const int r = jj * G + g;
          acc_s[r * D + d] = acc_s[r * D + d] * a_s[r] + a[g];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D, jj = r / G, g = r % G;
    const int j = j0 + jj;
    if (j < chunk)
      out[((b * chunk + j) * H + (int64_t)kvh * G + g) * D + d] =
          from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename T, typename P, int MAXG>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const void* tables,
                  const void* q_pos, void* out, int64_t batch, int chunk,
                  int num_pages, int block_size, int n_kv, int group,
                  int head_dim, int q_tile, float scale, cudaStream_t s) {
  const int tile_pages = block_size >= PP_TILE_TOKENS
                             ? 1 : PP_TILE_TOKENS / block_size;
  const size_t R = (size_t)q_tile * group, D = head_dim;
  const size_t TT = (size_t)tile_pages * block_size;
  const size_t smem =
      sizeof(float) * (R * D + TT * (D + 4) + TT * D + R * TT + R * D +
                       3 * R) +
      sizeof(int) * ((size_t)q_tile + tile_pages) +
      (std::is_same<P, int8_t>::value ? 2 * sizeof(float) * tile_pages : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, P, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (D * sizeof(P)) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid((unsigned)((chunk + q_tile - 1) / q_tile), (unsigned)n_kv,
                  (unsigned)batch);
  paged_prefill_kernel<T, P, MAXG><<<grid, PP_THREADS, smem, s>>>(
      (const T*)q, (const P*)k, (const P*)v, ks, vs, (const int32_t*)tables,
      (const int32_t*)q_pos, (T*)out, chunk, num_pages, block_size,
      tile_pages, n_kv, group, head_dim, q_tile, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
static int launch_group(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs,
                        const void* tables, const void* q_pos, void* out,
                        int64_t batch, int chunk, int num_pages,
                        int block_size, int n_kv, int group, int head_dim,
                        int q_tile, float scale, cudaStream_t s) {
  if (group <= 4)
    return launch<T, P, 4>(q, k, v, ks, vs, tables, q_pos, out, batch, chunk,
                           num_pages, block_size, n_kv, group, head_dim,
                           q_tile, scale, s);
  if (group <= 8)
    return launch<T, P, 8>(q, k, v, ks, vs, tables, q_pos, out, batch, chunk,
                           num_pages, block_size, n_kv, group, head_dim,
                           q_tile, scale, s);
  return launch<T, P, 16>(q, k, v, ks, vs, tables, q_pos, out, batch, chunk,
                          num_pages, block_size, n_kv, group, head_dim,
                          q_tile, scale, s);
}

static int check_args(int q_tile, int group, int head_dim, int block_size) {
  if (q_tile < 1 || group < 1 || group > 16 || head_dim % 4 != 0 ||
      block_size % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* q_pos, void* out, int64_t batch,
    int chunk, int num_pages, int block_size, int n_kv, int group,
    int head_dim, int q_tile, float scale, int dtype, void* stream) {
  if (batch <= 0 || chunk <= 0) return 0;
  if (int e = check_args(q_tile, group, head_dim, block_size)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_group<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tables, q_pos, out, batch,
        chunk, num_pages, block_size, n_kv, group, head_dim, q_tile, scale,
        s);
  return launch_group<float, float>(
      q, k_pages, v_pages, nullptr, nullptr, tables, q_pos, out, batch,
      chunk, num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
}

// int8 pages with f32 scales (N, Hkv); dtype is that of q and out
extern "C" int paged_prefill_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* q_pos, void* out, int64_t batch, int chunk, int num_pages,
    int block_size, int n_kv, int group, int head_dim, int q_tile,
    float scale, int dtype, void* stream) {
  if (batch <= 0 || chunk <= 0) return 0;
  if (int e = check_args(q_tile, group, head_dim, block_size)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  if (dtype == DTYPE_BF16)
    return launch_group<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, ks, vs, tables, q_pos, out, batch, chunk,
        num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
  return launch_group<float, int8_t>(
      q, k_pages, v_pages, ks, vs, tables, q_pos, out, batch, chunk,
      num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
}
