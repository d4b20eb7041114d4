// Chunked suffix-prefill attention over the paged KV pool: C queries per
// sequence at absolute positions q_pos attend causally (kv_pos <= q_pos)
// to the cached prefix and the chunk's own, already written, keys. The
// pool is bf16 or f32 (paged_prefill_attention) or int8 with one f32
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
// bf16 pools: a tensor-core tile loop (paged_prefill_tc_kernel), in the
// manner of FlashAttention-2. The C * G query rows of one kv head are
// ordered r = j * G + g (query j, head kvh * G + g); a block of 4 warps
// takes 64 of them, 16 per warp (one m16 fragment), so the grid is
// (ceil(C * G / 64), Hkv, B) and a sequence's keys are read once per 64
// rows instead of once per query tile. The block walks the keys only up
// to the largest q_pos among its rows, in tiles of 64 tokens that may span
// pages, through a two-stage shared-memory ring of K and V tiles filled
// by 16-byte cp.async.cg copies: the next tile's copies are in flight
// while the block computes on the current one. For each tile one thread
// per key reads its page id and divides by bs once, leaving the key's
// pool offset in shared memory; the copy threads only add their chunk's
// column. Keys past those the block needs are zero-filled. Rows are padded
// by 16 bytes (D + 8 bf16), an odd number of 16-byte units, so the eight
// rows of every ldmatrix fall in eight different bank groups.
//   Q sits in registers as mma A fragments for the whole walk. S = Q K^T
// is mma.sync m16n8k16 (bf16 in, f32 accumulators), K read with ldmatrix
// as the B operand. The online softmax runs in registers: the running max
// m is kept in raw score units and p = 2^(s c - m c), c = log2(e) /
// sqrt(D), is one FMA and one MUFU ex2; row max and row sum are reduced
// over the four lanes of a quad by shuffles, O is rescaled only when some
// row's max moved, and a tile that every row of the warp sees whole skips
// the mask. A masked key gets probability 0 explicitly, not
// exp(NEG_INF - m): NEG_INF is finite, and a row whose keys are all masked
// so far would otherwise count exp(0) = 1 per key. Rows with q_pos = -1
// end with l = 0 and write zeros. O += P V reuses the S accumulators as A
// fragments (FA2's register layout), V read with ldmatrix.trans. P is
// split as hi + lo, both bf16, with two MMAs per k-step, so P keeps about
// 16 bits: bf16 P alone leaves the output up to one bf16 step from the
// plain version's f32 softmax, at the edge of the 2e-3 tolerance; the
// split costs 1.5x the MMA work, which the byte bound pays for. O is
// divided by max(l, 1e-20) and written as bf16 straight from registers.
// D is a template parameter (every multiple of 16 up to 128), G <= 16, bs
// any multiple of 4. Offsets are int64_t. Shared memory is 4 * 64 *
// (D + 8) * 2 bytes for the ring plus 1 KB of offsets (69 KB at D = 128),
// so two blocks fit on an SM. At the main path's shape the kernel is
// bound by latency and shared-memory reads, not bytes from HBM: with one
// or two blocks per SM, every warp reads the whole K and V tile through
// ldmatrix for its 16 rows. Left for later: wgmma with a TMA ring and a
// producer warp (A and B from shared memory for 64 rows at once), and
// key splits for long contexts at small batch.
//
// f32 pools and int8 pages (paged_prefill_kernel): the first design, with
// the page type as a template parameter, as in paged_attention.cu. One
// thread block per (query tile of QT queries, kv head, sequence); the
// tile's QT * G query rows sit in shared memory in f32. The block walks
// the keys up to the tile's largest q_pos in tiles of up to 64 tokens:
// each tile's K and V are staged once into shared memory as f32 with
// batched 16-byte loads (K rows padded by four floats so float4 reads of
// different rows are free of bank conflicts). A thread per (query, key)
// pair computes the G scores of that query's heads from float4 reads; a
// warp per row updates the f32 online softmax with shuffles; a thread per
// (query, dim) pair rescales and accumulates the G f32 accumulators of
// that query, which live in shared memory. The float4 reads need D and bs
// to be multiples of 4. For int8 pages each tile page's two scales are
// read once, beside its page id, and the staging step dequantizes
// (float(q) * scale, one f32 product rounded once); the 16-byte vector
// path needs D % 16 == 0. What this design leaves: every query tile
// re-reads its keys (C / QT times), scores and values are scalar f32
// FMAs, and tiles are staged synchronously; bringing int8 pages into the
// tensor-core loop is the next step.
#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 pools: the tensor-core tile loop
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps
constexpr int TC_ROWS = 64;       // query rows per block, 16 per warp
constexpr int TC_KEYS = 64;       // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return 4 * TC_KEYS * (D + 8) * sizeof(__nv_bfloat16) +
         2 * TC_KEYS * sizeof(int64_t);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ q_pos,
    __nv_bfloat16* __restrict__ out, int chunk, int num_pages,
    int block_size, int n_kv, int group, float scale_log2) {
  constexpr int LD = D + 8;            // shared row stride (bf16)
  constexpr int TILE = TC_KEYS * LD;   // elements of one K or V tile
  constexpr int KSTEPS = D / 16;       // k-steps of Q K^T
  constexpr int DT = D / 8;            // n-tiles of O
  constexpr int CPR = D / 8;           // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stage][K, V][TILE], then [stage][TC_KEYS] key offsets
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int64_t* off_s = reinterpret_cast<int64_t*>(kv_s + 4 * TILE);
  __shared__ int max_pos_s;

  const int G = group, bs = block_size, rows = chunk * group;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int64_t H = (int64_t)n_kv * G;

  // this lane's two rows: warp * 16 + grp and + 8 of the block's 64
  int qp[2];
  int64_t row_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = blockIdx.x * TC_ROWS + warp * 16 + grp + 8 * i;
    const int j = r / G, g = r % G;
    qp[i] = r < rows ? q_pos[b * chunk + j] : -1;
    row_off[i] = r < rows ? ((b * chunk + j) * H + (int64_t)kvh * G + g) * D
                          : -1;
  }
  if (tid == 0) max_pos_s = -1;
  __syncthreads();
  // the largest q_pos of the block and the smallest of the warp
  int mp = max(qp[0], qp[1]), warp_min_qp = min(qp[0], qp[1]);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    mp = max(mp, __shfl_xor_sync(0xffffffffu, mp, sh));
    warp_min_qp =
        min(warp_min_qp, __shfl_xor_sync(0xffffffffu, warp_min_qp, sh));
  }
  if (lane == 0) atomicMax(&max_pos_s, mp);

  // Q as A fragments: qa[kk] = rows (grp, grp + 8), dims kk * 16 + ...
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x & 1, half = x >> 1;
      qa[kk][x] = row_off[i] >= 0
                      ? *reinterpret_cast<const uint32_t*>(
                            q + row_off[i] + kk * 16 + half * 8 + 2 * tig)
                      : 0u;
    }
  __syncthreads();
  const int n_tok = min(max_pos_s + 1, num_pages * bs);
  const int n_tiles = n_tok > 0 ? (n_tok + TC_KEYS - 1) / TC_KEYS : 0;

  const int64_t tok_stride = (int64_t)n_kv * D;
  const int64_t page_stride = (int64_t)bs * tok_stride;
  const __nv_bfloat16* k_head = k_pages + (int64_t)kvh * D;
  const __nv_bfloat16* v_head = v_pages + (int64_t)kvh * D;
  const int32_t* tbl = tables + b * num_pages;

  // the pool offset of each key of tile `tile` (-1 past the keys the
  // block needs) into offset slot `st`: one thread per key reads its page
  // id and divides by bs
  auto load_offsets = [&](int tile, int st) {
    if (tid < TC_KEYS) {
      const int pos = tile * TC_KEYS + tid;
      off_s[st * TC_KEYS + tid] =
          pos < n_tok ? (int64_t)tbl[pos / bs] * page_stride +
                            (int64_t)(pos % bs) * tok_stride
                      : -1;
    }
  };
  // cp.async of the K and V rows in offset slot `st` into ring stage `st`
  auto issue = [&](int st) {
    const int64_t* off = off_s + st * TC_KEYS;
    __nv_bfloat16* ks = kv_s + 2 * st * TILE;
    __nv_bfloat16* vs = ks + TILE;
#pragma unroll
    for (int i0 = 0; i0 < TC_KEYS * CPR; i0 += TC_THREADS) {
      const int i = i0 + tid, t = i / CPR, c = i % CPR;
      const int64_t key_off = off[t];
      const int64_t src = key_off >= 0 ? key_off + c * 8 : 0;
      const int n = key_off >= 0 ? 16 : 0;   // 0: zero-fill the chunk
      cp_async_16(smem_u32(ks + t * LD + c * 8), k_head + src, n);
      cp_async_16(smem_u32(vs + t * LD + c * 8), v_head + src, n);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  // ldmatrix row addresses of this lane inside a tile: K (keys as n, dims
  // as k) and V transposed (keys as k, dims as n)
  const int k_lane =
      ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane =
      (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;

  if (n_tiles > 0) {
    load_offsets(0, 0);
    __syncthreads();
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = it * TC_KEYS;
    if (it + 1 < n_tiles) load_offsets(it + 1, st ^ 1);
    // the other stage's tile and offsets are free once every warp is past
    // the previous iteration
    __syncthreads();
    if (it + 1 < n_tiles) issue(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of tile `it` have landed
    __syncthreads();      // and everyone's
    const __nv_bfloat16* ks = kv_s + 2 * st * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + np * 16 * LD + kk * 16 + k_lane));
        mma_bf16_16816(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }

    // online softmax: m in raw score units, p = 2^(s c - m c) with
    // c = log2(e) / sqrt(D); s[n][x] is row grp + 8 (x >> 1), key
    // t0 + 8 n + 2 tig + (x & 1). A tile whose keys every row of the warp
    // sees skips the mask (a warp-uniform branch).
    const bool full =
        t0 + TC_KEYS <= n_tok && t0 + TC_KEYS - 1 <= warp_min_qp;
    if (!full) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = t0 + n * 8 + 2 * tig + (x & 1);
          if (!(key <= qp[x >> 1] && key < n_tok)) s[n][x] = NEG_INF;
        }
    }
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) mt[x >> 1] = fmaxf(mt[x >> 1], s[n][x]);
    float alpha[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_r[i], mt[i]);
      alpha[i] = fast_exp2((m_r[i] - m_new) * scale_log2);
      m_r[i] = m_new;
      mc[i] = m_new * scale_log2;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float p = fast_exp2(fmaf(s[n][x], scale_log2, -mc[x >> 1]));
        if (!full) {   // masked keys: 0, never exp(NEG_INF - m)
          const int key = t0 + n * 8 + 2 * tig + (x & 1);
          if (!(key <= qp[x >> 1] && key < n_tok)) p = 0.f;
        }
        s[n][x] = p;
        l_r[x >> 1] += p;
      }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V: keys kk * 16 .. + 15 are S n-tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + kk * 16 * LD + dp * 16 + v_lane));
        mma_bf16_16816(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16_16816(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-20f);
    if (row_off[i] < 0) continue;
    __nv_bfloat16* dst = out + row_off[i] + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * i] / l, o[n][2 * i + 1] / l);
  }
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* tables, const void* q_pos, void* out,
                     int64_t batch, int chunk, int num_pages, int block_size,
                     int n_kv, int group, float scale, cudaStream_t s) {
  constexpr size_t smem = tc_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t rows = (int64_t)chunk * group;
  const dim3 grid((unsigned)((rows + TC_ROWS - 1) / TC_ROWS), (unsigned)n_kv,
                  (unsigned)batch);
  paged_prefill_tc_kernel<D><<<grid, TC_THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)tables,
      (const int32_t*)q_pos, (__nv_bfloat16*)out, chunk, num_pages,
      block_size, n_kv, group, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The tensor-core kernel's shapes: D a multiple of 16 up to 128, G <= 16,
// bs a multiple of 4, K/V 16-byte aligned (cp.async) and q/out 4-byte
// aligned; anything else is refused.
static int launch_tc_dim(const void* q, const void* k, const void* v,
                         const void* tables, const void* q_pos, void* out,
                         int64_t batch, int chunk, int num_pages,
                         int block_size, int n_kv, int group, int head_dim,
                         float scale, cudaStream_t s) {
  if (((uintptr_t)k | (uintptr_t)v) % 16 != 0 ||
      ((uintptr_t)q | (uintptr_t)out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
#define PP_TC_CASE(DIM)                                                     \
  case DIM:                                                                 \
    return launch_tc<DIM>(q, k, v, tables, q_pos, out, batch, chunk,        \
                          num_pages, block_size, n_kv, group, scale, s);
  switch (head_dim) {
    PP_TC_CASE(16)
    PP_TC_CASE(32)
    PP_TC_CASE(48)
    PP_TC_CASE(64)
    PP_TC_CASE(80)
    PP_TC_CASE(96)
    PP_TC_CASE(112)
    PP_TC_CASE(128)
  }
#undef PP_TC_CASE
  return (int)cudaErrorInvalidValue;
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
  if (dtype == DTYPE_BF16)      // the tensor-core kernel; q_tile unused
    return launch_tc_dim(q, k_pages, v_pages, tables, q_pos, out, batch,
                         chunk, num_pages, block_size, n_kv, group, head_dim,
                         scale, s);
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
