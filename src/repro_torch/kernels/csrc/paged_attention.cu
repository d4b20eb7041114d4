// Decode attention over the paged KV pool: one query token per sequence,
// grouped-query heads, keys and values reached through a block table;
// the pool is float / bf16 (paged_attention) or int8 with one f32 scale
// per (page, kv head) (paged_attention_quant).
//
// Replaces (Pallas, TPU):
//   paged_attention        <- src/repro/kernels/paged_attention.py:293
//   paged_attention_quant  <- src/repro/kernels/paged_attention.py:230
//
// Bound on the H100: memory. A step reads each sequence's live K and V
// once (context_len * Hkv * D elements per tensor: 2 MiB of K and 2 MiB
// of V per 1024 tokens at Qwen2.5-14B's Hkv=8, D=128 in bf16), plus the
// query and the table; it does ~4 * H * D flops per cached token, far
// below the 295 flop/byte at which the tensor cores would become the limit.
// So what a decode kernel needs is enough bytes in flight on every SM:
// parallelism over the context and copies that run under the compute.
//
// Two routes, chosen by dtype and shape; each shape has one kernel:
//
// bf16 queries with D a multiple of 16 up to 128 (paged_decode_tc_kernel,
// with the page type as a template parameter: bf16 pools for B2, int8
// pages for B9), the split-context tensor-core kernel (flash-decoding).
// The grid is (splits, Hkv, B): each (sequence, kv head) context is cut
// into `splits` runs of whole 64-key tiles, and one warp takes one run.
// The split count comes from the shapes alone (B, Hkv, the table width
// and the kernel's blocks per SM; paged_decode_splits), never from
// context_lens, so the call needs no sync and a CUDA graph can capture it:
// about one full wave of blocks, e.g. 6 runs of 3 tiles per (sequence, kv
// head) at B 8, Hkv 8 and 64-page tables of 16 tokens (3 one-warp blocks
// of 70,656 bytes fit an SM at D 128), 4 runs of one tile at 16-page
// tables. The warp's 16 mma rows are the kv head's G <= 16 query heads
// (rows g >= G are zero and never written), held as A fragments. It walks
// its run's tiles, which may span pages, through its own two-stage
// shared-memory ring filled by 16-byte cp.async copies from per-key pool
// offsets (one lane per two keys reads the page id), so the next tile's
// copies are in flight while it computes on this one; keys past
// context_len (and past the table) are zero-filled and masked. Each tile
// takes mma.cuh's three steps as B4 does: S = Q K^T, the online softmax in
// raw score units, O += P V with P split hi + lo in bf16. A run that starts
// at or past context_len does no work and writes an empty partial (m =
// NEG_INF, l = 0, O = 0). Each warp writes its unnormalised partial (m, l,
// O) in f32 to a scratch (B, H, splits, D) + (B, H, splits, 2) that the
// wrapper allocates; a second kernel of the same C entry
// (paged_decode_combine_kernel) takes m* = max m_s, l* = sum l_s
// 2^((m_s - m*) c), O = sum O_s 2^((m_s - m*) c) / max(l*, 1e-20) and
// rounds once to bf16. A row with context_len = 0 has only empty partials
// and comes out as exact zeros (NEG_INF is finite, so every empty O_s is
// 0 itself). Blocks hold DC_WARPS = 1 warp: with its own ring and run, a
// warp never waits on another and syncs with __syncwarp only; two warps per
// block (one 141 KB block per SM at D 128) measured slower (PERF.md).
//   int8 pages (B9), as B10 (paged_prefill.cu): the ring holds the int8
// rows, each lane converts to bf16 exactly the 16-byte chunks it copied,
// once its own copies have landed (exact: |q| <= 127), into one bf16 K/V
// tile pair; the page scales stay in f32: S is multiplied by k_scale[key]
// before the mask, l sums the unscaled p, and P V takes p * v_scale[key]
// before the hi/lo split. The conversion takes a byte permute and an f32
// subtraction per element (int8x4_to_bf16) instead of the quarter-rate
// I2F conversion B10 uses: 20 % off B9's time on an H100 (PERF.md).
//
// f32 queries, and bf16 queries with D not a multiple of 16
// (paged_attention_kernel), the first design: one thread block per (kv
// head, sequence). The G = H / Hkv query heads of the group share every
// K/V load. The block walks the context in tiles of up to 64 tokens
// (several pages), stopping at context_len. Each tile's K and V rows are
// staged into shared memory as f32 with batched 16-byte loads, several in
// flight per thread; then a warp per token computes the G dot products
// (lanes stride over D, then a shuffle reduction), a warp per query head
// updates the f32 online softmax (running max m, sum l, rescale alpha)
// with shuffles, and each thread owns one output dim of the G f32
// accumulators for one slice of the tile's tokens (256 threads = 256 / D
// slices), in registers; the slices are summed through shared memory at
// the end. The finaliser divides by max(l, 1e-20): a row with
// context_len = 0 writes zeros, which padded decode rows rely on. For
// int8 pages the block reads each tile page's two scales once, beside its
// page id, and the staging step dequantizes (float(q) * scale, one f32
// product rounded once, as dequantize_block_ref does); the 16-byte vector
// path needs D % 16 == 0, other D take the scalar path. Its 16 dequantized
// floats go to shared memory as four float4 stores (scalar stores from
// lanes 16 floats apart hit 2 of the 32 banks). What this design leaves:
// at batch 8 with Hkv = 8 the grid has 64 blocks for 132 SMs, each walking
// its context serially with staging and compute one after the other.
// Positions past context_len are never read. Offsets are int64_t.
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

constexpr int PA_THREADS = 256;   // also the largest D: one dim per thread
constexpr int PA_TILE_TOKENS = 64;

// T: query and output type; P: page type (T, or int8_t with scales)
template <typename T, typename P, int MAXG>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, T* __restrict__ out,
    int num_pages, int block_size, int tile_pages, int n_kv, int group,
    int head_dim, float scale, int vec) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
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
  // (tile_pages,) K and V scales of the tile's pages (int8 pages only)
  float* ksc_s = reinterpret_cast<float*>(pg_s + tile_pages);
  float* vsc_s = ksc_s + tile_pages;

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
      const int pg = p < num_pages ? tbl[p] : 0;
      pg_s[i] = pg;
      if constexpr (QUANT) {
        ksc_s[i] = k_scale[(int64_t)pg * n_kv + kvh];
        vsc_s[i] = v_scale[(int64_t)pg * n_kv + kvh];
      }
    }
    __syncthreads();
    stage_kv_f32<P>(k_s, D, v_s, D, k_pages, v_pages, pg_s, ksc_s, vsc_s,
                    valid, bs, page_stride, tok_stride, head_off, D, vec);
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

template <typename T, typename P, int MAXG>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const void* tables,
                  const void* ctx, void* out, int64_t batch, int num_pages,
                  int block_size, int n_kv, int group, int head_dim,
                  float scale, cudaStream_t s) {
  const int tile_pages = block_size >= PA_TILE_TOKENS
                             ? 1 : PA_TILE_TOKENS / block_size;
  const size_t TT = (size_t)tile_pages * block_size, D = head_dim;
  const size_t n_slices = PA_THREADS / D;
  const size_t smem =
      sizeof(float) * ((size_t)group * D + 2 * TT * D + (size_t)group * TT +
                       n_slices * group * D + 3 * (size_t)group) +
      sizeof(int) * (size_t)tile_pages +
      (std::is_same<P, int8_t>::value ? 2 * sizeof(float) * tile_pages : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, P, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (D * sizeof(P)) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid((unsigned)n_kv, (unsigned)batch);
  paged_attention_kernel<T, P, MAXG><<<grid, PA_THREADS, smem, s>>>(
      (const T*)q, (const P*)k, (const P*)v, ks, vs, (const int32_t*)tables,
      (const int32_t*)ctx, (T*)out, num_pages, block_size, tile_pages, n_kv,
      group, head_dim, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
static int launch_group(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs,
                        const void* tables, const void* ctx, void* out,
                        int64_t batch, int num_pages, int block_size,
                        int n_kv, int group, int head_dim, float scale,
                        cudaStream_t s) {
  if (group <= 4)
    return launch<T, P, 4>(q, k, v, ks, vs, tables, ctx, out, batch,
                           num_pages, block_size, n_kv, group, head_dim,
                           scale, s);
  if (group <= 8)
    return launch<T, P, 8>(q, k, v, ks, vs, tables, ctx, out, batch,
                           num_pages, block_size, n_kv, group, head_dim,
                           scale, s);
  return launch<T, P, 16>(q, k, v, ks, vs, tables, ctx, out, batch,
                          num_pages, block_size, n_kv, group, head_dim,
                          scale, s);
}

// ---------------------------------------------------------------------------
// bf16 queries over bf16 pools (B2) or int8 pages (B9): the split-context
// tensor-core kernel and its combine
// ---------------------------------------------------------------------------

constexpr int DC_KEYS = 64;    // keys per tile (mma.cuh's tile steps)
constexpr int DC_WARPS = 1;    // warps per block, each with its own run

// per warp: bf16 pages, a two-stage ring of K/V tiles and the ring's key
// offsets; int8 pages, one bf16 K/V tile pair, a two-stage int8 ring, the
// key offsets and a two-stage K/V scale per key (a multiple of 16 bytes)
template <typename P, int D>
__host__ __device__ constexpr size_t dc_warp_smem() {
  return std::is_same<P, int8_t>::value
             ? 2 * DC_KEYS * (D + 8) * sizeof(__nv_bfloat16) +
                   4 * DC_KEYS * D + 2 * DC_KEYS * sizeof(int64_t) +
                   4 * DC_KEYS * sizeof(float)
             : 4 * DC_KEYS * (D + 8) * sizeof(__nv_bfloat16) +
                   2 * DC_KEYS * sizeof(int64_t);
}

// Four int8 values (one 32-bit word, the lowest first) as two bf16 pairs,
// exactly and without the quarter-rate I2F: each byte, offset by 128 to
// unsigned, becomes the low byte of the f32 2^23 + u (one byte permute),
// and subtracting 2^23 + 128 leaves the integer; |x| <= 128 fits bf16.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = pack_bf16(f0 - MAGIC, f1 - MAGIC);
  hi = pack_bf16(f2 - MAGIC, f3 - MAGIC);
}

template <typename P, int D>
__global__ void __launch_bounds__(32 * DC_WARPS) paged_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, float* __restrict__ part_o,
    float* __restrict__ part_ml, int num_pages, int block_size, int n_kv,
    int group, int splits, int split_tiles, float scale_log2) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int LD = D + 8;            // shared row stride (bf16)
  constexpr int TILE = DC_KEYS * LD;   // elements of one K or V tile
  constexpr int KSTEPS = D / 16;       // k-steps of Q K^T
  constexpr int DT = D / 8;            // n-tiles of O
  constexpr int E = 16 / sizeof(P);    // page elements per 16-byte chunk
  constexpr int CPR = D / E;           // 16-byte chunks per K/V row
  constexpr int CHUNKS = DC_KEYS * CPR;   // a multiple of 32
  constexpr int RING8 = QUANT ? 4 * DC_KEYS * D : 0;   // int8 ring bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's part: bf16: [stage][K, V][TILE]; int8: [K, V][TILE], then
  // the int8 ring [stage][K, V][DC_KEYS * D]; then [stage][DC_KEYS] key
  // offsets; int8: then [stage][K, V][DC_KEYS] scales
  unsigned char* base = smem_raw + warp * dc_warp_smem<P, D>();
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(base);
  unsigned char* ring8 = base + (QUANT ? 2 : 4) * TILE * sizeof(__nv_bfloat16);
  int64_t* off_s = reinterpret_cast<int64_t*>(ring8 + RING8);
  float* sc_s = reinterpret_cast<float*>(off_s + 2 * DC_KEYS);

  const int split = blockIdx.x * DC_WARPS + warp;
  if (split >= splits) return;         // the whole warp; no block barrier
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int grp = lane >> 2, tig = lane & 3;
  const int G = group, bs = block_size;
  const int64_t H = (int64_t)n_kv * G;
  const int n_tok = max(0, min(ctx_lens[b], num_pages * bs));
  // this warp's run of keys: [t_begin, t_end), whole tiles but the last
  const int t_begin = split * split_tiles * DC_KEYS;
  const int t_end = min(n_tok, t_begin + split_tiles * DC_KEYS);
  const int n_tiles =
      t_end > t_begin ? (t_end - t_begin + DC_KEYS - 1) / DC_KEYS : 0;

  // Q as A fragments: qa[kk] = rows (grp, grp + 8), dims kk * 16 + ...;
  // rows g >= G are zero
  const __nv_bfloat16* qh = q + (b * H + (int64_t)kvh * G) * D;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int g = grp + 8 * (x & 1), half = x >> 1;
      qa[kk][x] = g < G ? *reinterpret_cast<const uint32_t*>(
                              qh + g * D + kk * 16 + half * 8 + 2 * tig)
                        : 0u;
    }

  const int64_t tok_stride = (int64_t)n_kv * D;
  const int64_t page_stride = (int64_t)bs * tok_stride;
  const P* k_head = k_pages + (int64_t)kvh * D;
  const P* v_head = v_pages + (int64_t)kvh * D;
  const int32_t* tbl = tables + b * num_pages;

  // int8: the K and V scales of the two keys whose offsets this lane
  // loaded last; they go to shared memory in issue(), after the next
  // __syncwarp, when no lane reads that scale slot any more
  float key_ks[2] = {0.f, 0.f}, key_vs[2] = {0.f, 0.f};
  // the pool offset of each key of the run's tile `tile` (-1 past t_end)
  // into offset slot `st`: lane and lane + 32 read their key's page id
  // (int8: and the page's two scales, 0 past t_end)
  auto load_offsets = [&](int tile, int st) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = lane + 32 * j;
      const int pos = t_begin + tile * DC_KEYS + t;
      const bool live = pos < t_end;
      const int pg = live ? tbl[pos / bs] : 0;
      off_s[st * DC_KEYS + t] = live ? (int64_t)pg * page_stride +
                                           (int64_t)(pos % bs) * tok_stride
                                     : -1;
      if constexpr (QUANT) {
        key_ks[j] = live ? k_scale[(int64_t)pg * n_kv + kvh] : 0.f;
        key_vs[j] = live ? v_scale[(int64_t)pg * n_kv + kvh] : 0.f;
      }
    }
  };
  // cp.async of the K and V rows in offset slot `st` into ring stage `st`
  // (int8: the int8 ring, rows of D bytes; and the scales into slot st)
  auto issue = [&](int st) {
    const int64_t* off = off_s + st * DC_KEYS;
#pragma unroll
    for (int i0 = 0; i0 < CHUNKS; i0 += 32) {
      const int i = i0 + lane, t = i / CPR, c = i % CPR;
      const int64_t key_off = off[t];
      const int64_t src = key_off >= 0 ? key_off + c * E : 0;
      const int n = key_off >= 0 ? 16 : 0;   // 0: zero-fill the chunk
      uint32_t kd, vd;
      if constexpr (QUANT) {
        kd = smem_u32(ring8 + 2 * st * DC_KEYS * D + i * 16);
        vd = kd + DC_KEYS * D;
      } else {
        kd = smem_u32(kv_s + 2 * st * TILE + t * LD + c * 8);
        vd = kd + TILE * sizeof(__nv_bfloat16);
      }
      cp_async_16(kd, k_head + src, n);
      cp_async_16(vd, v_head + src, n);
    }
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc_s[2 * st * DC_KEYS + lane + 32 * j] = key_ks[j];
        sc_s[(2 * st + 1) * DC_KEYS + lane + 32 * j] = key_vs[j];
      }
    }
  };
  // int8: once this lane's copies of ring stage `st` have landed, it
  // converts the same chunks to bf16 (exact: |q| <= 127) in the K/V tile
  // pair, so the conversion needs no sync of its own
  auto convert = [&](int st) {
#pragma unroll 2
    for (int i0 = 0; i0 < CHUNKS; i0 += 32) {
      const int i = i0 + lane, t = i / CPR, c = i % CPR;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ring8 + (2 * st + kv) * DC_KEYS * D + i * 16);
        uint32_t w[8];
        int8x4_to_bf16(raw.x, w[0], w[1]);
        int8x4_to_bf16(raw.y, w[2], w[3]);
        int8x4_to_bf16(raw.z, w[4], w[5]);
        int8x4_to_bf16(raw.w, w[6], w[7]);
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
    __syncwarp();
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = t_begin + it * DC_KEYS;
    if (it + 1 < n_tiles) load_offsets(it + 1, st ^ 1);
    // the other stage's tile, offsets and scales (int8: and the bf16 tile
    // pair) are free once every lane is past the previous iteration
    __syncwarp();
    if (it + 1 < n_tiles) issue(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this lane's copies of tile `it` have landed
    if constexpr (QUANT) convert(st);
    __syncwarp();         // and every lane's
    const __nv_bfloat16* ks = kv_s + (QUANT ? 0 : 2 * st * TILE);
    const __nv_bfloat16* vs = ks + TILE;

    float s[8][4];
    tile_scores<D>(s, qa, ks, k_lane);
    // int8: S = (Q K_int) * k_scale[key], in f32 before the mask
    if constexpr (QUANT) {
      const float* ksc = sc_s + 2 * st * DC_KEYS + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(ksc + n * 8);
        s[n][0] *= f.x;
        s[n][1] *= f.y;
        s[n][2] *= f.x;
        s[n][3] *= f.y;
      }
    }
    // every row sees every key before t_end: only the tile that holds
    // t_end is masked
    tile_softmax<DT>(s, m_r, l_r, o, scale_log2, t0 + DC_KEYS <= t_end,
                     [&](int n, int x) {
                       return t0 + n * 8 + 2 * tig + (x & 1) < t_end;
                     });
    // int8: l sums the unscaled p; P V takes p * v_scale[key]
    if constexpr (QUANT) {
      const float* vsc = sc_s + (2 * st + 1) * DC_KEYS + 2 * tig;
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

  // the run's partial: unnormalised O, its max m (raw score units) and sum
  // l, for rows g < G
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = grp + 8 * i;
    if (g >= G) continue;
    const int64_t slot = (b * H + (int64_t)kvh * G + g) * splits + split;
    float* dst = part_o + slot * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
    if (tig == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * slot) = make_float2(m_r[i], l);
  }
}

// One block of D threads per (sequence, query head) row: the row's
// partials weighted by 2^((m_s - m*) c), summed in f32 and divided by the
// weighted l, rounded once to bf16.
__global__ void paged_decode_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int splits, int head_dim,
    float scale_log2) {
  const int64_t row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      // the difference first: for a row of empty runs m_s - m* is 0
      // exactly, where fmaf(m_s, c, -m* c) leaves the rounding error of
      // m* c, up to 2^72 at NEG_INF
      const float w = exp2f((ml[2 * s] - m) * scale_log2);
      l = fmaf(ml[2 * s + 1], w, l);
      acc = fmaf(part_o[(row * splits + s) * head_dim + d], w, acc);
    }
    out[row * head_dim + d] = __float2bfloat16(acc / fmaxf(l, 1e-20f));
  }
}

// The kernel's dynamic shared memory, and the largest shared-memory
// carveout, so that as many blocks fit an SM as the memory allows (three
// at D 128); set once per device, since a decode step calls the kernel
// once per layer and its host cost counts in an eager loop
template <typename P, int D>
static int dc_set_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev]) return 0;
  constexpr size_t smem = DC_WARPS * dc_warp_smem<P, D>();
  e = cudaFuncSetAttribute(paged_decode_tc_kernel<P, D>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(paged_decode_tc_kernel<P, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return (int)e;
}

// Runs per (sequence, kv head) context for B blocks of n_kv kv heads over
// tables of num_pages pages: about one wave of the kernel's blocks on the
// current device, in whole 64-key tiles, never more runs than tiles.
// Returns the count (>= 1) or -cudaError.
template <typename P, int D>
static int dc_splits(int64_t batch, int num_pages, int block_size,
                     int n_kv) {
  if (int e = dc_set_smem<P, D>()) return -e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_decode_tc_kernel<P, D>, 32 * DC_WARPS,
        DC_WARPS * dc_warp_smem<P, D>());
  if (e != cudaSuccess) return -(int)e;
  const int64_t n_tiles =
      ((int64_t)num_pages * block_size + DC_KEYS - 1) / DC_KEYS;
  const int64_t rows = batch * n_kv;
  const int64_t slots = (int64_t)sms * per_sm * DC_WARPS;
  int64_t want = rows > 0 ? (slots + rows - 1) / rows : 1;
  want = std::max<int64_t>(1, std::min(want, n_tiles));
  const int64_t per_run = (n_tiles + want - 1) / want;
  return (int)std::max<int64_t>(1, (n_tiles + per_run - 1) / per_run);
}

template <typename P, int D>
static int launch_dc(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const void* tables,
                     const void* ctx, void* out, void* scratch,
                     int64_t batch, int num_pages, int block_size, int n_kv,
                     int group, int splits, float scale, cudaStream_t s) {
  if (int e = dc_set_smem<P, D>()) return e;
  const int64_t H = (int64_t)n_kv * group;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + batch * H * splits * D;
  const int n_tiles = (num_pages * block_size + DC_KEYS - 1) / DC_KEYS;
  const int split_tiles = std::max(1, (n_tiles + splits - 1) / splits);
  const float scale_log2 = scale * LOG2E;
  const dim3 grid((unsigned)((splits + DC_WARPS - 1) / DC_WARPS),
                  (unsigned)n_kv, (unsigned)batch);
  paged_decode_tc_kernel<P, D>
      <<<grid, 32 * DC_WARPS, DC_WARPS * dc_warp_smem<P, D>(), s>>>(
          (const __nv_bfloat16*)q, (const P*)k, (const P*)v, ks, vs,
          (const int32_t*)tables, (const int32_t*)ctx, part_o, part_ml,
          num_pages, block_size, n_kv, group, splits, split_tiles,
          scale_log2);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  paged_decode_combine_kernel<<<(unsigned)(batch * H), D, 0, s>>>(
      part_o, part_ml, (__nv_bfloat16*)out, splits, D, scale_log2);
  return (int)cudaGetLastError();
}

// The tensor-core kernel's shapes: D a multiple of 16 up to 128, K/V
// 16-byte aligned (cp.async) and q 4-byte aligned; with bf16 q these take
// paged_decode_tc_kernel and nothing else.
static bool dc_takes(const void* q, const void* k, const void* v,
                     int head_dim) {
  return head_dim % 16 == 0 && head_dim <= 128 &&
         ((uintptr_t)k | (uintptr_t)v) % 16 == 0 && (uintptr_t)q % 4 == 0;
}

#define DC_DIMS(CASE) CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) \
  CASE(112) CASE(128)

template <typename P>
static int dc_splits_dim(int64_t batch, int num_pages, int block_size,
                         int n_kv, int head_dim) {
#define DC_CASE(DIM) \
  case DIM: return dc_splits<P, DIM>(batch, num_pages, block_size, n_kv);
  switch (head_dim) { DC_DIMS(DC_CASE) }
#undef DC_CASE
  return -(int)cudaErrorInvalidValue;
}

// P = __nv_bfloat16 (B2) or int8_t (B9, with scales ks, vs)
template <typename P>
static int launch_dc_dim(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs,
                         const void* tables, const void* ctx, void* out,
                         void* scratch, int64_t batch, int num_pages,
                         int block_size, int n_kv, int group, int head_dim,
                         int splits, float scale, cudaStream_t s) {
  if (group < 1 || group > 16 || splits < 1 || scratch == nullptr ||
      !dc_takes(q, k, v, head_dim))
    return (int)cudaErrorInvalidValue;
#define DC_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return launch_dc<P, DIM>(q, k, v, ks, vs, tables, ctx, out, scratch,    \
                             batch, num_pages, block_size, n_kv, group,     \
                             splits, scale, s);
  switch (head_dim) { DC_DIMS(DC_CASE) }
#undef DC_CASE
  return (int)cudaErrorInvalidValue;
}

static int check_args(int group, int head_dim, int block_size) {
  if (group < 1 || group > 16 || head_dim > PA_THREADS || block_size > 256)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The scalar entries: f32 q, and bf16 q outside dc_takes (bf16 shapes in
// dc_takes are refused here: they take paged_attention_tc)
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* ctx_lens, void* out,
                               int64_t batch, int num_pages, int block_size,
                               int n_kv, int group, int head_dim,
                               float scale, int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (int e = check_args(group, head_dim, block_size)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    if (dc_takes(q, k_pages, v_pages, head_dim))
      return (int)cudaErrorInvalidValue;
    return launch_group<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tables, ctx_lens, out, batch,
        num_pages, block_size, n_kv, group, head_dim, scale, s);
  }
  return launch_group<float, float>(
      q, k_pages, v_pages, nullptr, nullptr, tables, ctx_lens, out, batch,
      num_pages, block_size, n_kv, group, head_dim, scale, s);
}

// int8 pages with f32 scales (N, Hkv); dtype is that of q and out
extern "C" int paged_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* ctx_lens, void* out, int64_t batch, int num_pages,
    int block_size, int n_kv, int group, int head_dim, float scale,
    int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (int e = check_args(group, head_dim, block_size)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  if (dtype == DTYPE_BF16) {
    if (dc_takes(q, k_pages, v_pages, head_dim))
      return (int)cudaErrorInvalidValue;
    return launch_group<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, ks, vs, tables, ctx_lens, out, batch, num_pages,
        block_size, n_kv, group, head_dim, scale, s);
  }
  return launch_group<float, int8_t>(
      q, k_pages, v_pages, ks, vs, tables, ctx_lens, out, batch, num_pages,
      block_size, n_kv, group, head_dim, scale, s);
}

// The split-context entries, bf16 q and out: both kernels on `stream`.
// scratch holds B * H * splits * (D + 2) floats: the partial O, then the
// partial (m, l) pairs.
extern "C" int paged_attention_tc(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* ctx_lens, void* out,
                                  void* scratch, int64_t batch,
                                  int num_pages, int block_size, int n_kv,
                                  int group, int head_dim, int splits,
                                  float scale, void* stream) {
  if (batch <= 0) return 0;
  return launch_dc_dim<__nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, tables, ctx_lens, out, scratch,
      batch, num_pages, block_size, n_kv, group, head_dim, splits, scale,
      (cudaStream_t)stream);
}

extern "C" int paged_attention_quant_tc(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* ctx_lens, void* out, void* scratch, int64_t batch,
    int num_pages, int block_size, int n_kv, int group, int head_dim,
    int splits, float scale, void* stream) {
  if (batch <= 0) return 0;
  return launch_dc_dim<int8_t>(
      q, k_pages, v_pages, (const float*)k_scale, (const float*)v_scale,
      tables, ctx_lens, out, scratch, batch, num_pages, block_size, n_kv,
      group, head_dim, splits, scale, (cudaStream_t)stream);
}

// The split count paged_attention_tc / paged_attention_quant_tc (quant = 1)
// take for these shapes on the current device (see dc_splits), or
// -cudaError. It reads no tensor and enqueues nothing.
extern "C" int paged_decode_splits(int64_t batch, int num_pages,
                                   int block_size, int n_kv, int head_dim,
                                   int quant) {
  return quant ? dc_splits_dim<int8_t>(batch, num_pages, block_size, n_kv,
                                       head_dim)
               : dc_splits_dim<__nv_bfloat16>(batch, num_pages, block_size,
                                              n_kv, head_dim);
}
