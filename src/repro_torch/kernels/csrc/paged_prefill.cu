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
// bf16 queries (paged_prefill_tc_kernel, with the page type as a template
// parameter: bf16 pools for B4, int8 pages for B10): a tensor-core tile
// loop, in the manner of FlashAttention-2. The C * G query rows of one kv
// head are ordered r = j * G + g (query j, head kvh * G + g); a block of 4
// warps takes 64 of them, 16 per warp (one m16 fragment), so the grid is
// (ceil(C * G / 64), Hkv, B) and a sequence's keys are read once per 64
// rows instead of once per query tile. The block walks the keys only up
// to the largest q_pos among its rows, in tiles of 64 tokens that may span
// pages, through a two-stage shared-memory ring filled by 16-byte
// cp.async.cg copies: the next tile's copies are in flight while the
// block computes on the current one. For each tile one thread per key
// reads its page id and divides by bs once, leaving the key's pool offset
// in shared memory; the copy threads only add their chunk's column. Keys
// past those the block needs are zero-filled. Rows are padded by 16 bytes
// (D + 8 bf16), an odd number of 16-byte units, so the eight rows of every
// ldmatrix fall in eight different bank groups.
//   Q sits in registers as mma A fragments for the whole walk. Each tile
// takes the three steps of mma.cuh: S = Q K^T (mma.sync m16n8k16, bf16 in,
// f32 accumulators, K read with ldmatrix), the online softmax in
// registers (raw score units, MUFU ex2; a tile that every row of the warp
// sees whole skips the mask; masked keys get probability 0 explicitly),
// and O += P V with P split hi + lo in bf16, so P keeps about 16 bits
// (bf16 P alone leaves the output up to one bf16 step from the plain
// version's f32 softmax, at the edge of the 2e-3 tolerance; the split
// costs 1.5x the MMA work, which the byte bound pays for). Rows with
// q_pos = -1 end with l = 0 and write zeros. O is divided by max(l,
// 1e-20) and written as bf16 straight from registers. D is a template
// parameter (every multiple of 16 up to 128), G <= 16, bs any multiple of
// 4. Offsets are int64_t.
//   int8 pages (B10): the ring holds the int8 rows (D bytes, half of
// bf16's), and once a thread's copies of a tile have landed it converts
// the same chunks to bf16 into one K/V tile pair that the ldmatrix
// addressing reads (exact: |q| <= 127 fits bf16's significand), so the
// conversion needs no barrier of its own. The page scales are folded into
// the arithmetic, not into the tile: the thread that loads a key's offset
// also loads its page's K and V scale (0 past the keys the block needs)
// into per-tile slots; S = (Q K_int) * k_scale[key] in f32 before the
// mask, l sums the unscaled p, and P V takes p * v_scale[key] before the
// hi/lo split. Dequantizing into the bf16 tile instead would round every
// K and V element to bf16 (up to 2^-9 of it); folded, the kernel differs
// from the plain version (dequantize in f32, then f32 attention) only in
// f32 summation order and the hi/lo P, as B4 does.
//   Shared memory at D = 128: bf16 pages 4 * 64 * 136 * 2 bytes for the
// ring plus 1 KB of offsets (69 KB); int8 pages 34 KB for the tile pair,
// 32 KB for the int8 ring and 1.5 KB of offsets and scales (68 KB); two
// blocks fit on an SM. At the main path's shape the kernel is bound by
// latency and shared-memory reads, not bytes from HBM: with one or two
// blocks per SM, every warp reads the whole K and V tile through ldmatrix
// for its 16 rows. Left for later: wgmma with a TMA ring and a producer
// warp (A and B from shared memory for 64 rows at once), and key splits
// for long contexts at small batch.
//
// f32 queries, and bf16 queries over int8 pages outside the tensor-core
// kernel's shapes (paged_prefill_kernel): the first design, with the page
// type as a template parameter, as in paged_attention.cu. One
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
// FMAs, and tiles are staged synchronously.
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
// bf16 queries over bf16 pools (B4) or int8 pages (B10): the tensor-core
// tile loop
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps
constexpr int TC_ROWS = 64;       // query rows per block, 16 per warp
constexpr int TC_KEYS = 64;       // keys per tile

// bf16 pages: a two-stage ring of K/V tiles and the ring's key offsets.
// int8 pages: one bf16 K/V tile pair, a two-stage int8 ring, the key
// offsets and a two-stage K/V scale per key.
template <typename P, int D>
constexpr size_t tc_smem_bytes() {
  return std::is_same<P, int8_t>::value
             ? 2 * TC_KEYS * (D + 8) * sizeof(__nv_bfloat16) +
                   4 * TC_KEYS * D + 2 * TC_KEYS * sizeof(int64_t) +
                   4 * TC_KEYS * sizeof(float)
             : 4 * TC_KEYS * (D + 8) * sizeof(__nv_bfloat16) +
                   2 * TC_KEYS * sizeof(int64_t);
}

template <typename P, int D>
__global__ void __launch_bounds__(TC_THREADS, 2) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ q_pos, __nv_bfloat16* __restrict__ out,
    int chunk, int num_pages, int block_size, int n_kv, int group,
    float scale_log2) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int LD = D + 8;            // shared row stride (bf16)
  constexpr int TILE = TC_KEYS * LD;   // elements of one K or V tile
  constexpr int KSTEPS = D / 16;       // k-steps of Q K^T
  constexpr int DT = D / 8;            // n-tiles of O
  constexpr int E = 16 / sizeof(P);    // page elements per 16-byte chunk
  constexpr int CPR = D / E;           // 16-byte chunks per K/V row
  constexpr int CHUNKS = TC_KEYS * CPR;
  constexpr int RING8 = QUANT ? 4 * TC_KEYS * D : 0;   // int8 ring bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16: [stage][K, V][TILE]; int8: [K, V][TILE], then the int8 ring
  // [stage][K, V][TC_KEYS * D]; then [stage][TC_KEYS] key offsets; int8:
  // then [stage][K, V][TC_KEYS] scales
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring8 =
      smem_raw + (QUANT ? 2 : 4) * TILE * sizeof(__nv_bfloat16);
  int64_t* off_s = reinterpret_cast<int64_t*>(ring8 + RING8);
  float* sc_s = reinterpret_cast<float*>(off_s + 2 * TC_KEYS);
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
  const P* k_head = k_pages + (int64_t)kvh * D;
  const P* v_head = v_pages + (int64_t)kvh * D;
  const int32_t* tbl = tables + b * num_pages;

  // int8: the K and V scales of the key whose offset this thread loaded
  // last; they go to shared memory only after the next barrier, when no
  // warp reads that scale slot any more
  float key_ks = 0.f, key_vs = 0.f;
  // the pool offset of each key of tile `tile` (-1 past the keys the
  // block needs) into offset slot `st`: one thread per key reads its page
  // id and divides by bs (int8: and reads the page's two scales, 0 past
  // the keys the block needs)
  auto load_offsets = [&](int tile, int st) {
    if (tid < TC_KEYS) {
      const int pos = tile * TC_KEYS + tid;
      const int pg = pos < n_tok ? tbl[pos / bs] : 0;
      off_s[st * TC_KEYS + tid] =
          pos < n_tok ? (int64_t)pg * page_stride +
                            (int64_t)(pos % bs) * tok_stride
                      : -1;
      if constexpr (QUANT) {
        key_ks = pos < n_tok ? k_scale[(int64_t)pg * n_kv + kvh] : 0.f;
        key_vs = pos < n_tok ? v_scale[(int64_t)pg * n_kv + kvh] : 0.f;
      }
    }
  };
  // cp.async of the K and V rows in offset slot `st` into ring stage `st`
  // (int8: the int8 ring, rows of D bytes; and the scales into slot st)
  auto issue = [&](int st) {
    const int64_t* off = off_s + st * TC_KEYS;
#pragma unroll
    for (int i0 = 0; i0 < CHUNKS; i0 += TC_THREADS) {
      const int i = i0 + tid, t = i / CPR, c = i % CPR;
      if (CHUNKS % TC_THREADS != 0 && i >= CHUNKS) break;
      const int64_t key_off = off[t];
      const int64_t src = key_off >= 0 ? key_off + c * E : 0;
      const int n = key_off >= 0 ? 16 : 0;   // 0: zero-fill the chunk
      uint32_t kd, vd;
      if constexpr (QUANT) {
        kd = smem_u32(ring8 + 2 * st * TC_KEYS * D + i * 16);
        vd = kd + TC_KEYS * D;
      } else {
        kd = smem_u32(kv_s + 2 * st * TILE + t * LD + c * 8);
        vd = kd + TILE * sizeof(__nv_bfloat16);
      }
      cp_async_16(kd, k_head + src, n);
      cp_async_16(vd, v_head + src, n);
    }
    if constexpr (QUANT) {
      if (tid < TC_KEYS) {
        sc_s[2 * st * TC_KEYS + tid] = key_ks;
        sc_s[(2 * st + 1) * TC_KEYS + tid] = key_vs;
      }
    }
  };
  // int8: once this thread's copies of ring stage `st` have landed, it
  // converts the same chunks to bf16 (exact: |q| <= 127) in the K/V tile
  // pair, so no barrier sits between the copy and the conversion
  auto convert = [&](int st) {
#pragma unroll
    for (int i0 = 0; i0 < CHUNKS; i0 += TC_THREADS) {
      const int i = i0 + tid, t = i / CPR, c = i % CPR;
      if (CHUNKS % TC_THREADS != 0 && i >= CHUNKS) break;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ring8 + (2 * st + kv) * TC_KEYS * D + i * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w[u] = pack_bf16((float)e[2 * u], (float)e[2 * u + 1]);
        uint4* dst = reinterpret_cast<uint4*>(kv_s + kv * TILE + t * LD +
                                              c * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
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

  if (n_tiles > 0) {
    load_offsets(0, 0);
    __syncthreads();
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = it * TC_KEYS;
    if (it + 1 < n_tiles) load_offsets(it + 1, st ^ 1);
    // the other stage's tile, offsets and scales (int8: and the bf16 tile
    // pair) are free once every warp is past the previous iteration
    __syncthreads();
    if (it + 1 < n_tiles) issue(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of tile `it` have landed
    if constexpr (QUANT) convert(st);
    __syncthreads();      // and everyone's
    const __nv_bfloat16* ks = kv_s + (QUANT ? 0 : 2 * st * TILE);
    const __nv_bfloat16* vs = ks + TILE;

    float s[8][4];
    tile_scores<D>(s, qa, ks, k_lane);
    // int8: S = (Q K_int) * k_scale[key], in f32 before the mask
    if constexpr (QUANT) {
      const float* ksc = sc_s + 2 * st * TC_KEYS + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(ksc + n * 8);
        s[n][0] *= f.x;
        s[n][1] *= f.y;
        s[n][2] *= f.x;
        s[n][3] *= f.y;
      }
    }
    // a tile whose keys every row of the warp sees skips the mask
    const bool full =
        t0 + TC_KEYS <= n_tok && t0 + TC_KEYS - 1 <= warp_min_qp;
    tile_softmax<DT>(s, m_r, l_r, o, scale_log2, full, [&](int n, int x) {
      const int key = t0 + n * 8 + 2 * tig + (x & 1);
      return key <= qp[x >> 1] && key < n_tok;
    });
    // int8: l sums the unscaled p; P V takes p * v_scale[key]
    if constexpr (QUANT) {
      const float* vsc = sc_s + (2 * st + 1) * TC_KEYS + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(vsc + n * 8);
        s[n][0] *= f.x;
        s[n][1] *= f.y;
        s[n][2] *= f.x;
        s[n][3] *= f.y;
      }
    }
    tile_pv<D>(o, s, vs, v_lane);
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

template <typename P, int D>
static int launch_tc(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const void* tables,
                     const void* q_pos, void* out, int64_t batch, int chunk,
                     int num_pages, int block_size, int n_kv, int group,
                     float scale, cudaStream_t s) {
  constexpr size_t smem = tc_smem_bytes<P, D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_tc_kernel<P, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t rows = (int64_t)chunk * group;
  const dim3 grid((unsigned)((rows + TC_ROWS - 1) / TC_ROWS), (unsigned)n_kv,
                  (unsigned)batch);
  paged_prefill_tc_kernel<P, D><<<grid, TC_THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const P*)k, (const P*)v, ks, vs,
      (const int32_t*)tables, (const int32_t*)q_pos, (__nv_bfloat16*)out,
      chunk, num_pages, block_size, n_kv, group, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The tensor-core kernel's shapes: D a multiple of 16 up to 128, G <= 16,
// bs a multiple of 4, K/V 16-byte aligned (cp.async) and q/out 4-byte
// aligned.
static bool tc_takes(const void* q, const void* k, const void* v,
                     const void* out, int head_dim) {
  return head_dim % 16 == 0 && head_dim <= 128 &&
         ((uintptr_t)k | (uintptr_t)v) % 16 == 0 &&
         ((uintptr_t)q | (uintptr_t)out) % 4 == 0;
}

// P = __nv_bfloat16 (B4) or int8_t (B10, with scales ks, vs); a shape
// outside tc_takes is refused
template <typename P>
static int launch_tc_dim(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs,
                         const void* tables, const void* q_pos, void* out,
                         int64_t batch, int chunk, int num_pages,
                         int block_size, int n_kv, int group, int head_dim,
                         float scale, cudaStream_t s) {
  if (!tc_takes(q, k, v, out, head_dim)) return (int)cudaErrorInvalidValue;
#define PP_TC_CASE(DIM)                                                     \
  case DIM:                                                                 \
    return launch_tc<P, DIM>(q, k, v, ks, vs, tables, q_pos, out, batch,    \
                             chunk, num_pages, block_size, n_kv, group,     \
                             scale, s);
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
    return launch_tc_dim<__nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tables, q_pos, out, batch,
        chunk, num_pages, block_size, n_kv, group, head_dim, scale, s);
  return launch_group<float, float>(
      q, k_pages, v_pages, nullptr, nullptr, tables, q_pos, out, batch,
      chunk, num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
}

// int8 pages with f32 scales (N, Hkv); dtype is that of q and out. bf16 q
// in the tensor-core kernel's shapes (tc_takes) takes its int8
// instantiation; f32 q and other bf16 shapes the first template.
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
  if (dtype == DTYPE_BF16 && tc_takes(q, k_pages, v_pages, out, head_dim))
    return launch_tc_dim<int8_t>(
        q, k_pages, v_pages, ks, vs, tables, q_pos, out, batch, chunk,
        num_pages, block_size, n_kv, group, head_dim, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_group<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, ks, vs, tables, q_pos, out, batch, chunk,
        num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
  return launch_group<float, int8_t>(
      q, k_pages, v_pages, ks, vs, tables, q_pos, out, batch, chunk,
      num_pages, block_size, n_kv, group, head_dim, q_tile, scale, s);
}
