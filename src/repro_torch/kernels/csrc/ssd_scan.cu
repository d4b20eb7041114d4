// Mamba2 SSD chunk scan from a zero state: x (B, S, H, P) float / bf16,
// dt and a = dt * A (B, S, H) f32, b and c (B, S, N) f32 shared by every
// head -> y (B, S, H, P) f32 and the final state (B, H, P, N) f32.
//
// Replaces (Pallas, TPU):
//   ssd_scan  <- src/repro/kernels/ssd_scan.py:64
//
// What it computes, per (batch, head), chunk after chunk of Q tokens with
// the (P, N) state carried from one to the next:
//   y_i   = sum_{j <= i} (c_i . b_j) exp(seg_ij) dt_j x_j
//           + exp(pre_i) (c_i . state^T)
//   state = state exp(pre_last) + sum_j x_j^T dt_j exp(seg_last,j) b_j
// with pre_i = a_0 + ... + a_i and seg_ij = a_{j+1} + ... + a_i within the
// chunk (the Pallas kernel takes seg as a difference of two cumsums).
//
// Both routes split the scan as the SSD paper's chunked algorithm does, so
// that only an elementwise recurrence stays sequential: a chunk pass
// writes each (batch, head, chunk)'s own state contribution to the scratch
// `cs` and its decay exp(pre_last) to `decay`; ssd_state_kernel, one
// thread per (batch, head, state element), runs state = state * decay_c +
// cs_c over the chunks, overwriting cs_c with the state that enters chunk
// c (eight chunks' loads in flight), the last value being the final
// state; a last pass adds each chunk's y. The scratch holds one (P, N) f32
// state per (batch, head, chunk): 100 MB for Mamba2-130M at B 4, S 2048.
// The C entries choose the route from the shapes before any launch; each
// refuses the shapes of the other.
//
// Tensor-core route (ssd_scan_tc: Q 64, P 64, N 16, 32, 64 or 128 as a
// template parameter, x, b and c on 16-byte boundaries; Mamba2-130M and
// Hymba-1.5B), four launches of 128 threads (four warps of 16 rows), all
// products on mma.sync m16n8k16 with f32 accumulators:
//   1. ssd_gram_tc_kernel, one block per (chunk, batch row): G = c b^T,
//      only its 10 lower 16 x 16 tiles, once for all heads, into a
//      (B, S / Q, Q, Q) f32 buffer (2 MB for Mamba2, read back from L2);
//   2. ssd_chunk_tc_kernel, one block per (chunk, head, batch row): the
//      chunk's state contribution cs = x^T (dec o b), a (P x Q)(Q x N)
//      product, dec_j = dt_j exp(a_{j+1} + ... + a_{Q-1}), and the chunk
//      decay; b is loaded into registers before dec is known;
//   3. ssd_state_kernel, as on the scalar route;
//   4. ssd_out_tc_kernel, one block per (chunk, head, batch row): y =
//      (exp(pre_i) c) state_in^T + w x with w = G o L, L_ij = dt_j
//      exp(seg_ij) on and below the diagonal and 0 above it, written once.
// Precision: a float32 operand is split into three bf16 parts, x = h + m
// + l (each the bf16 rounding of what the parts before it leave; together
// about 24 bits), and a product keeps the six terms of parts i + j <= 2,
// smallest first. A bf16 x is exact, so its products take three MMAs, and
// f32 products six. At Mamba2's prefill shape (B 4, S 2048) with bf16 x,
// two parts (three MMAs) put y 2.2e-3 from a float64 run, farther than
// the scalar route (1.87e-3); three parts put it 3.2e-4 there, and 6.6e-5
// when every MMA starts from a zeroed accumulator added in f32 (as the
// emulation in tests/torch_ssd_emulation.py sums, 6.4e-5): the rest is
// the MMA's own sum of its products with a large running accumulator
// (tools/ssd_breakdown.py, H100). Zeroed accumulators cost 8 % of the
// call, so the route accumulates in place. The decay exponents are
// sums of a over the run they cover, built from in-block sums (see the
// tensor-core section): with a <= 0 there is no cancellation, so their
// error is relative to the exponent itself and does not grow with the
// chunk's cumulative decay, as a difference of two cumsums does (about
// 1e-4 absolute at |cumsum| ~ 10^3). exp is only ever taken of such a sum
// (or of 0 above the diagonal), and entries above the diagonal are 0.
// Bound on the H100 (bf16 x, Mamba2): 88.6 MB of x, y, dt, a, b, c and
// the state, and 31 GFLOP of MMAs (three or six per product), so 0.032 ms
// of operations at 989 TFLOP/s, close to 0.026 ms of bytes; the scratch
// round trip (about 400 MB through the state pass) is outside that bound
// and holds the route back, with the staging latency of its blocks.
// Shared memory per block: the split operands that ldmatrix reads (b for
// G; dec o b and x for cs; the entering state and x for y) and, for y,
// the in-block sums D; c and G are read into registers in the A-fragment
// layout straight from global memory, before the staging.
//
// Scalar route (ssd_scan, every other shape: Q up to 64, P any, N up to
// 128): ssd_chunk_kernel, one block per (chunk, head, batch row, 64 rows
// of P), computes the intra term into y, the chunk's cs and its decay
// from the in-chunk cumsum; ssd_inter_kernel adds exp(pre_i) (c_i .
// state_in^T) for chunks after the first. 256 threads as a 16 x 16 grid
// compute register tiles of strided rows and columns from f32 operands
// staged in shared memory with 16-byte loads, several in flight; one
// position per thread sums a in order. Scalar f32 FMAs, the full Q x Q
// score tile and c b^T once per head: bound by operations at the f32 peak.
#include "common.cuh"
#include "mma.cuh"

constexpr int SSD_THREADS = 256;   // a 16 x 16 grid of threads
constexpr int SSD_PB = 64;         // rows of P per block
constexpr int SSD_MAX_Q = 64;      // chunk length (rows i = ty + 16 r, r < 4)
constexpr int SSD_MAX_N = 128;     // state width (float4 groups tx + 16 s)

// N rounded up to a float4, and the row stride of N-wide tiles read as
// float4 by 16 lanes at 16 different rows: an odd number of float4s per
// row puts those rows on all eight 4-bank groups twice
__host__ __device__ __forceinline__ int ssd_n4(int n) {
  return (n + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int ssd_ld(int n) {
  const int n4 = ssd_n4(n);
  return (n4 / 4) % 2 ? n4 : n4 + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// rows [0, rows) of an N-wide f32 tile at src (row stride N) into dst (row
// stride ld); rows at or past `valid` and columns [N, ld) zero. With vec
// (N % 4 == 0 and src 16-byte aligned) one float4 per trip, four trips'
// loads in flight, so staging is not a chain of global-memory latencies
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int rows, int valid, int N,
                                          bool vec) {
  if (vec) {
    const int g4 = ld / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * g4; i += blockDim.x) {
      const int j = i / g4, n = 4 * (i % g4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < valid && n < N)
        v = *reinterpret_cast<const float4*>(src + (int64_t)j * N + n);
      *reinterpret_cast<float4*>(dst + j * ld + n) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
      const int j = i / ld, n = i % ld;
      dst[i] = (j < valid && n < N) ? src[(int64_t)j * N + n] : 0.f;
    }
  }
}

// x rows of Q4 tokens, columns [p0, p0 + PB) of head h, into x_s (row
// stride PB) as f32; rows past Q and columns past pb zero. With vec
// (P * sizeof(T) % 16 == 0 and x 16-byte aligned) 16 bytes per load.
template <typename T>
__device__ __forceinline__ void stage_x(float* x_s, const T* __restrict__ x,
                                        int64_t tok0, int H, int h, int P,
                                        int p0, int pb, int Q, int Q4,
                                        bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int VPR = SSD_PB / E;
#pragma unroll 2
    for (int i = threadIdx.x; i < Q4 * VPR; i += blockDim.x) {
      const int j = i / VPR, p = E * (i % VPR);
      float v[E];
      if (j < Q && p < pb) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            x + ((tok0 + j) * H + h) * (int64_t)P + p0 + p);
        const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
        for (int u = 0; u < E; ++u) v[u] = to_f32(e[u]);
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u) v[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < E; u += 4)
        *reinterpret_cast<float4*>(x_s + j * SSD_PB + p + u) =
            make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < Q4 * SSD_PB; i += blockDim.x) {
      const int j = i / SSD_PB, p = i % SSD_PB;
      x_s[i] = (j < Q && p < pb)
                   ? to_f32(x[((tok0 + j) * H + h) * (int64_t)P + p0 + p])
                   : 0.f;
    }
  }
}

// cumulative log decay of the chunk: one thread per position sums a in
// order, so the prefix at the last position is the chunk total bit for bit
__device__ __forceinline__ void chunk_cumsum(float* acum_s, const float* a_s,
                                            int Q) {
  if ((int)threadIdx.x < Q) {
    float run = 0.f;
    for (int j = 0; j <= (int)threadIdx.x; ++j) run += a_s[j];
    acum_s[threadIdx.x] = run;
  }
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 2) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ cs, float* __restrict__ decay, int S, int H, int P,
    int N, int Q, int n_pslices, int vec_bc, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  const int LD = ssd_ld(N), N4 = ssd_n4(N);
  const int Q4 = (Q + 3) / 4 * 4, WL = Q4 + 4;
  float* b_s = smem;                  // (Q, LD)
  float* c_s = b_s + Q * LD;          // (Q, LD)
  float* x_s = c_s + Q * LD;          // (Q4, PB), rows past Q zero
  float* w_s = x_s + Q4 * SSD_PB;     // (Q, WL), columns past Q zero
  float* acum_s = w_s + Q * WL;       // (Q,)
  float* dt_s = acum_s + Q;           // (Q,)
  float* dec_s = dt_s + Q;            // (Q,) dt_j exp(acum_last - acum_j)
  float* a_s = dec_s + Q;             // (Q,)

  const int C = S / Q;
  const int ck = blockIdx.x / n_pslices;
  const int p0 = (blockIdx.x % n_pslices) * SSD_PB;
  const int pb = min(SSD_PB, P - p0);
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t tok0 = bb * S + (int64_t)ck * Q;

  stage_f32(b_s, LD, bm + tok0 * N, Q, Q, N, vec_bc);
  stage_f32(c_s, LD, cm + tok0 * N, Q, Q, N, vec_bc);
  stage_x<T>(x_s, x, tok0, H, h, P, p0, pb, Q, Q4, vec_x);
  for (int j = tid; j < Q; j += blockDim.x) {
    a_s[j] = a[(tok0 + j) * H + h];
    dt_s[j] = dt[(tok0 + j) * H + h];
  }
  __syncthreads();
  chunk_cumsum(acum_s, a_s, Q);
  __syncthreads();
  if (tid < Q) dec_s[tid] = dt_s[tid] * expf(acum_s[Q - 1] - acum_s[tid]);
  if (tid == 0 && p0 == 0)
    decay[((int64_t)bb * H + h) * C + ck] = expf(acum_s[Q - 1]);

  // w[i][j] = (c_i . b_j) exp(acum_i - acum_j) dt_j for j <= i, else 0;
  // rows i = ty + 16 r, columns j = tx + 16 s (clamped, then discarded)
  {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
    int ri[4], cj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ri[u] = min(ty + 16 * u, Q - 1);
      cj[u] = min(tx + 16 * u, Q - 1);
    }
    for (int n = 0; n < N4; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = ld4(c_s + ri[u] * LD + n);
        bv[u] = ld4(b_s + cj[u] * LD + n);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] += dot4(cv[r], bv[s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = tx + 16 * s;
        if (i < Q && j < Q4)
          w_s[i * WL + j] =
              (j < Q && j <= i)
                  ? acc[r][s] * expf(acum_s[i] - acum_s[j]) * dt_s[j]
                  : 0.f;
      }
    }
  }
  __syncthreads();

  // intra term y[i][p] = sum_j w[i][j] x[j][p]: rows i = ty + 16 r,
  // columns p = 4 tx .. 4 tx + 3, four j at a time
  {
    float4 acc[4];
    int ri[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      ri[r] = min(ty + 16 * r, Q - 1);
    }
    for (int j = 0; j < Q4; j += 4) {
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = ld4(x_s + (j + u) * SSD_PB + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 w = ld4(w_s + ri[r] * WL + j);
        acc[r].x += w.x * xv[0].x + w.y * xv[1].x + w.z * xv[2].x + w.w * xv[3].x;
        acc[r].y += w.x * xv[0].y + w.y * xv[1].y + w.z * xv[2].y + w.w * xv[3].y;
        acc[r].z += w.x * xv[0].z + w.y * xv[1].z + w.z * xv[2].z + w.w * xv[3].z;
        acc[r].w += w.x * xv[0].w + w.y * xv[1].w + w.z * xv[2].w + w.w * xv[3].w;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      float* yr = y + ((tok0 + i) * H + h) * (int64_t)P + p0;
      const float v[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * tx + e < pb) yr[4 * tx + e] = v[e];
    }
  }

  // the chunk's state contribution cs[p][n] = sum_j x[j][p] dec_j b[j][n]:
  // rows p = ty + 16 r, columns n = 4 g .. 4 g + 3 for g = tx + 16 s
  {
    float4 acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) acc[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);
    int cg[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) cg[s] = 4 * min(tx + 16 * s, N4 / 4 - 1);
    for (int j = 0; j < Q; ++j) {
      const float d = dec_s[j];
      float xd[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xd[r] = x_s[j * SSD_PB + ty + 16 * r] * d;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float4 bv = ld4(b_s + j * LD + cg[s]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][s].x += xd[r] * bv.x;
          acc[r][s].y += xd[r] * bv.y;
          acc[r][s].z += xd[r] * bv.z;
          acc[r][s].w += xd[r] * bv.w;
        }
      }
    }
    float* out = cs + (((int64_t)bb * H + h) * C + ck) * (int64_t)P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= pb) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int n0 = 4 * (tx + 16 * s);
        const float v[4] = {acc[r][s].x, acc[r][s].y, acc[r][s].z,
                            acc[r][s].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + e < N) out[(int64_t)(p0 + p) * N + n0 + e] = v[e];
      }
    }
  }
}

// state entering each chunk, in place over cs, and the final state
__global__ void __launch_bounds__(SSD_THREADS) ssd_state_kernel(
    float* __restrict__ cs, const float* __restrict__ decay,
    float* __restrict__ state_out, int C, int PN, int H) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  float* col = cs + bh * C * (int64_t)PN + e;
  const float* dec = decay + bh * C;
  float s = 0.f;
  for (int c0 = 0; c0 < C; c0 += 8) {
    float t[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < C) {
        t[u] = col[(int64_t)(c0 + u) * PN];
        d[u] = dec[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < C) {
        col[(int64_t)(c0 + u) * PN] = s;
        s = s * d[u] + t[u];
      }
    }
  }
  state_out[bh * PN + e] = s;
}

// y[i][p] += exp(acum_i) (c_i . state_in[p]) for chunks after the first
__global__ void __launch_bounds__(SSD_THREADS, 2) ssd_inter_kernel(
    const float* __restrict__ a, const float* __restrict__ cm,
    const float* __restrict__ cs, float* __restrict__ y, int S, int H,
    int P, int N, int Q, int n_pslices, int vec_bc) {
  extern __shared__ __align__(16) float smem[];
  const int LD = ssd_ld(N), N4 = ssd_n4(N);
  float* c_s = smem;                  // (Q, LD)
  float* st_s = c_s + Q * LD;         // (PB, LD) state entering the chunk
  float* acum_s = st_s + SSD_PB * LD; // (Q,)
  float* a_s = acum_s + Q;            // (Q,)

  const int C = S / Q;
  const int ck = blockIdx.x / n_pslices;
  if (ck == 0) return;                // a zero state enters chunk 0
  const int p0 = (blockIdx.x % n_pslices) * SSD_PB;
  const int pb = min(SSD_PB, P - p0);
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t tok0 = bb * S + (int64_t)ck * Q;

  stage_f32(c_s, LD, cm + tok0 * N, Q, Q, N, vec_bc);
  // the scratch is 16-byte aligned, and so is every row when N % 4 == 0
  stage_f32(st_s, LD,
            cs + (((int64_t)bb * H + h) * C + ck) * (int64_t)P * N +
                (int64_t)p0 * N,
            SSD_PB, pb, N, N % 4 == 0);
  for (int j = tid; j < Q; j += blockDim.x) a_s[j] = a[(tok0 + j) * H + h];
  __syncthreads();
  chunk_cumsum(acum_s, a_s, Q);
  __syncthreads();

  // rows i = ty + 16 r, columns p = tx + 16 s
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
  int ri[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) ri[r] = min(ty + 16 * r, Q - 1);
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4], sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cv[u] = ld4(c_s + ri[u] * LD + n);
      sv[u] = ld4(st_s + (tx + 16 * u) * LD + n);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] += dot4(cv[r], sv[s]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= Q) continue;
    const float eac = expf(acum_s[i]);
    float* yr = y + ((tok0 + i) * H + h) * (int64_t)P + p0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tx + 16 * s;
      if (p < pb) yr[p] = yr[p] + eac * acc[r][s];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core route: Q 64, P 64, N 16, 32, 64 or 128 (NK = N / 16)
// ---------------------------------------------------------------------------
// Fragment layouts are those of mma.cuh (lane = 4 grp + tig). A warp owns
// 16 rows of every Q x P, Q x Q or P x N product. The decay exponents are
// built from the in-block sums of a over the chunk's four 16-token blocks
// (D below): with seg_ij = a_{j+1} + ... + a_i,
//   D_ij = seg_ij for i, j in one block (a column scan down the block),
//   R_i  = a_{16 I} + D_{i, 16 I}       (block start .. i, I = i / 16),
//   S_j  = D_{16 J + 15, j}             (j + 1 .. block end, J = j / 16),
//   T_K  = R_{16 K + 15}                (block K's total),
//   seg_ij = (R_i + (T_{J+1} + ... + T_{I-1})) + S_j   for J < I,
//   pre_i  = (T_0 + ... + T_{I-1}) + R_i,
//   the suffix of dec_j = S_j + (T_{J+1} + ... + T_3), the chunk's total
//   ((T_0 + T_1) + T_2) + T_3:
// sums of terms of one sign (a <= 0), so each is exact to a few ulps of
// itself, in at most 15 sequential steps.

constexpr int TC_Q = 64, TC_P = 64;      // chunk length, head dim
constexpr int TC_THREADS = 128;          // four warps of 16 rows
constexpr int TC_LDX = TC_P + 8;         // bf16 row stride of an x tile
constexpr int TC_LDD = 24;               // f32 row stride of D: the float2
                                         // reads of a half-warp hit 32 banks

// bf16 row stride of an N-wide tile: an odd number of 16-byte units (N a
// multiple of 16), so the eight rows of an ldmatrix hit eight bank groups
__host__ __device__ constexpr int tc_ldn(int n) { return n + 8; }

// Three bf16 parts of two floats, x = p[0] + p[1] + p[2] to about 24 bits:
// each part is the bf16 rounding of what the parts before it leave (each
// remainder is exact in f32). In every register the lower half holds x's.
__device__ __forceinline__ void split3_bf16(float x, float y,
                                            uint32_t (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
    x -= hf.x;
    y -= hf.y;
  }
}

// d += A B with A the sum of NA bf16 parts and B of NB (an exact bf16
// operand is one part): the products of parts i + j <= 2, smallest first;
// b[k] holds two n-tiles of part k, half selects one
template <int NA, int NB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][4],
                                          int half) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < NB)
        mma_bf16_16816(d, a[i], b[j][2 * half], b[j][2 * half + 1]);
    }
}

// ldmatrix.trans row offset (elements) of this lane for an A fragment
// stored transposed: memory rows are k, m runs along a row
__device__ __forceinline__ int at_lane_offset(int lane, int ld) {
  return (((lane >> 4) & 1) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// The A fragment of rows r0 + grp, r0 + grp + 8 and columns k0 + 2 tig,
// k0 + 2 tig + 8 (+1) of a row-major f32 matrix in global memory: p
// points at (r0 + grp, k0 + 2 tig), ld is the row stride. f[0, 1, 4, 5]
// are row r0 + grp, f[2, 3, 6, 7] row r0 + grp + 8.
__device__ __forceinline__ void load_a_f32(float (&f)[8],
                                           const float* __restrict__ p,
                                           int64_t ld) {
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  f[0] = v0.x; f[1] = v0.y; f[2] = v1.x; f[3] = v1.y;
  f[4] = v2.x; f[5] = v2.y; f[6] = v3.x; f[7] = v3.y;
}

__device__ __forceinline__ void split_a(uint32_t (&a)[3][4],
                                        const float (&f)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t p[3];
    split3_bf16(f[2 * r], f[2 * r + 1], p);
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k][r] = p[k];
  }
}

// A 64 x (4 C4) f32 block in global memory (row stride ld, 16-byte
// aligned rows), C4 / 2 16-byte vectors per thread: thread t holds column
// 4 (t % C4) of rows t / C4 + u 128 / C4
template <int C4>
__device__ __forceinline__ void load_rows(float4 (&v)[C4 / 2],
                                          const float* __restrict__ src,
                                          int64_t ld) {
  const int c = 4 * (threadIdx.x % C4), r = threadIdx.x / C4;
#pragma unroll
  for (int u = 0; u < C4 / 2; ++u)
    v[u] = *reinterpret_cast<const float4*>(
        src + (int64_t)(r + u * (TC_THREADS / C4)) * ld + c);
}

// load_rows' vectors, each row times row_scale[row] when that is given,
// as NP bf16 parts at dst + k * part (row stride ld)
template <int NP, int C4>
__device__ __forceinline__ void store_split(__nv_bfloat16* dst, int part,
                                            int ld,
                                            const float4 (&v)[C4 / 2],
                                            const float* row_scale) {
  const int c = 4 * (threadIdx.x % C4), r0 = threadIdx.x / C4;
#pragma unroll
  for (int u = 0; u < C4 / 2; ++u) {
    const int r = r0 + u * (TC_THREADS / C4);
    float4 w = v[u];
    if (row_scale != nullptr) {
      const float sc = row_scale[r];
      w.x *= sc;
      w.y *= sc;
      w.z *= sc;
      w.w *= sc;
    }
    uint32_t lo[3], hi[3];
    split3_bf16(w.x, w.y, lo);
    split3_bf16(w.z, w.w, hi);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      *reinterpret_cast<uint2*>(dst + k * part + r * ld + c) =
          make_uint2(lo[k], hi[k]);
  }
}

// the chunk's Q x P block of x for head h (rows of H * P elements from
// x + off) into shared memory: bf16 as it is, f32 as three parts
template <typename T>
__device__ __forceinline__ void stage_x_tc(__nv_bfloat16* xs,
                                           const T* __restrict__ x,
                                           int64_t off, int64_t ld) {
  if constexpr (std::is_same<T, float>::value) {
    float4 v[TC_P / 8];
    load_rows<TC_P / 4>(v, x + off, ld);
    store_split<3, TC_P / 4>(xs, TC_Q * TC_LDX, TC_LDX, v, nullptr);
  } else {
    constexpr int VPR = TC_P / 8;          // 16-byte vectors per row
    uint4 v[TC_Q * VPR / TC_THREADS];
    const int c = 8 * (threadIdx.x % VPR), r = threadIdx.x / VPR;
#pragma unroll
    for (int u = 0; u < TC_Q * VPR / TC_THREADS; ++u)
      v[u] = *reinterpret_cast<const uint4*>(
          x + off + (r + u * (TC_THREADS / VPR)) * ld + c);
#pragma unroll
    for (int u = 0; u < TC_Q * VPR / TC_THREADS; ++u)
      *reinterpret_cast<uint4*>(
          xs + (r + u * (TC_THREADS / VPR)) * TC_LDX + c) = v[u];
  }
}

// D: column j of its 16-token block summed down from j (D_jj = 0), by
// threads 0 .. 63, one column each
__device__ __forceinline__ void block_segments(float* d_s, const float* a_s) {
  const int j = threadIdx.x;
  if (j < TC_Q) {
    const int end = j | 15;
    float s = 0.f;
    d_s[j * TC_LDD + (j & 15)] = 0.f;
    for (int i = j + 1; i <= end; ++i) {
      s += a_s[i];
      d_s[i * TC_LDD + (j & 15)] = s;
    }
  }
}

// the four block totals T_K = a_{16 K} + D_{16 K + 15, 16 K}
__device__ __forceinline__ void block_totals(float (&t)[4], const float* a_s,
                                             const float* d_s) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    t[k] = a_s[16 * k] + d_s[(16 * k + 15) * TC_LDD];
}

// 1. G = c b^T of one chunk, its 10 lower 16 x 16 tiles: warp w computes
// rows 16 w .. 16 w + 15, columns 0 .. 16 w + 15
template <int NK>
__global__ void __launch_bounds__(TC_THREADS) ssd_gram_tc_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    float* __restrict__ gram, int S) {
  constexpr int N = 16 * NK, LDN = tc_ldn(N), PART = TC_Q * LDN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int C = S / TC_Q, ck = blockIdx.x;
  const int64_t bb = blockIdx.y, tok0 = bb * S + (int64_t)ck * TC_Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;

  // this warp's rows of c, as A fragments, in flight while b is staged
  float cf[NK][8];
  const float* crow = cm + (tok0 + 16 * warp + grp) * N + 2 * tig;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) load_a_f32(cf[kk], crow + 16 * kk, N);
  {
    float4 v[N / 8];
    load_rows<N / 4>(v, bm + tok0 * N, N);
    store_split<3, N / 4>(bs, PART, LDN, v, nullptr);
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  const int kl = k_lane_offset(lane, LDN);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ca[3][4];
    split_a(ca, cf[kk]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) break;
      uint32_t bf[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ldmatrix_x4(bf[k],
                    smem_u32(bs + k * PART + np * 16 * LDN + kk * 16 + kl));
      mma_split<3, 3>(acc[2 * np], ca, bf, 0);
      mma_split<3, 3>(acc[2 * np + 1], ca, bf, 1);
    }
  }
  float* g = gram + (((int64_t)bb * C + ck) * TC_Q + 16 * warp + grp) * TC_Q +
             2 * tig;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t >= 2 * (warp + 1)) break;
    *reinterpret_cast<float2*>(g + 8 * t) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(g + 8 * TC_Q + 8 * t) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// 2. the chunk's state contribution cs = x^T (dec o b), P x N, and its
// decay exp(pre_last); warp w computes rows p = 16 w .. 16 w + 15. b is
// loaded into registers first and scaled once dec is known.
template <typename T, int NK>
__global__ void __launch_bounds__(TC_THREADS, 3) ssd_chunk_tc_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ cs, float* __restrict__ decay, int S, int H) {
  constexpr int NX = std::is_same<T, float>::value ? 3 : 1;
  constexpr int N = 16 * NK, LDN = tc_ldn(N), PART = TC_Q * LDN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 3 parts
  __nv_bfloat16* xs = ds + 3 * PART;                          // NX parts
  float* a_s = reinterpret_cast<float*>(xs + NX * TC_Q * TC_LDX);
  float* sfx_s = a_s + TC_Q;               // S_j, then dec_j

  const int C = S / TC_Q, ck = blockIdx.x, h = blockIdx.y;
  const int64_t bb = blockIdx.z, tok0 = bb * S + (int64_t)ck * TC_Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  float4 bv[N / 8];
  load_rows<N / 4>(bv, bm + tok0 * N, N);
  float dtj = 0.f;
  if (tid < TC_Q) {
    a_s[tid] = a[(tok0 + tid) * H + h];
    dtj = dt[(tok0 + tid) * H + h];
  }
  stage_x_tc<T>(xs, x, (tok0 * H + h) * TC_P, (int64_t)H * TC_P);
  __syncthreads();
  if (tid < TC_Q) {              // S_j: j + 1 .. block end, summed down
    float s = 0.f;
    for (int i = tid + 1; i <= (tid | 15); ++i) s += a_s[i];
    sfx_s[tid] = s;
  }
  __syncthreads();
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = a_s[16 * k] + sfx_s[16 * k];
  __syncthreads();
  if (tid < TC_Q) {
    // dec_j = dt_j exp(S_j + T_{J+1} + ... + T_3)
    float tail = 0.f;
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (k > (tid >> 4)) tail += t[k];
    sfx_s[tid] = dtj * expf(sfx_s[tid] + tail);
    if (tid == 0)
      decay[((int64_t)bb * H + h) * C + ck] =
          expf(((t[0] + t[1]) + t[2]) + t[3]);
  }
  __syncthreads();
  store_split<3, N / 4>(ds, PART, LDN, bv, sfx_s);
  __syncthreads();

  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int atl = at_lane_offset(lane, TC_LDX), vl = v_lane_offset(lane, LDN);
#pragma unroll
  for (int kk = 0; kk < TC_Q / 16; ++kk) {
    uint32_t xa[NX][4];
#pragma unroll
    for (int k = 0; k < NX; ++k)
      ldmatrix_x4_trans(xa[k], smem_u32(xs + k * TC_Q * TC_LDX +
                                        kk * 16 * TC_LDX + 16 * warp + atl));
#pragma unroll
    for (int np = 0; np < NK; ++np) {
      uint32_t bf[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ldmatrix_x4_trans(bf[k], smem_u32(ds + k * PART + kk * 16 * LDN +
                                          np * 16 + vl));
      mma_split<NX, 3>(acc[2 * np], xa, bf, 0);
      mma_split<NX, 3>(acc[2 * np + 1], xa, bf, 1);
    }
  }
  float* out = cs + (((int64_t)bb * H + h) * C + ck) * (int64_t)TC_P * N +
               (int64_t)(16 * warp + grp) * N + 2 * tig;
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * N + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// 4. y = (exp(pre_i) c) state_in^T + (G o L) x for one chunk and head,
// L_ij = dt_j exp(seg_ij) for j <= i and 0 above; warp w computes rows i
// = 16 w .. 16 w + 15, all P columns. The first k-step of G and of c is
// loaded before the staging, each next one while one is multiplied. At
// N <= 32 the block's shared memory leaves room for five blocks per SM,
// and registers are capped at 96 to let them in (at most 16 bytes spill,
// f32 x at N 32; none for bf16 x at N 16).
template <typename T, int NK>
__global__ void __launch_bounds__(TC_THREADS, NK <= 2 ? 5 : 3)
ssd_out_tc_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ cm,
    const float* __restrict__ gram, const float* __restrict__ cs,
    float* __restrict__ y, int S, int H) {
  constexpr int NX = std::is_same<T, float>::value ? 3 : 1;
  constexpr int N = 16 * NK, LDN = tc_ldn(N), PART = TC_P * LDN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sts = reinterpret_cast<__nv_bfloat16*>(smem_raw); // 3 parts
  __nv_bfloat16* xs = sts + 3 * PART;                         // NX parts
  float* d_s = reinterpret_cast<float*>(xs + NX * TC_Q * TC_LDX);
  float* a_s = d_s + TC_Q * TC_LDD;
  float* dt_s = a_s + TC_Q;

  const int C = S / TC_Q, ck = blockIdx.x, h = blockIdx.y;
  const int64_t bb = blockIdx.z, tok0 = bb * S + (int64_t)ck * TC_Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int i0 = 16 * warp + grp;          // this lane's rows i0, i0 + 8

  float gn[8];                             // G, the next k-step's
  const float* grow =
      gram + (((int64_t)bb * C + ck) * TC_Q + i0) * TC_Q + 2 * tig;
  load_a_f32(gn, grow, TC_Q);
  float cn[8];                             // c, the next k-step's rows
  const float* crow = cm + (tok0 + i0) * N + 2 * tig;
  if (ck > 0) load_a_f32(cn, crow, N);     // a zero state enters chunk 0
  if (tid < TC_Q) {
    a_s[tid] = a[(tok0 + tid) * H + h];
    dt_s[tid] = dt[(tok0 + tid) * H + h];
  }
  stage_x_tc<T>(xs, x, (tok0 * H + h) * TC_P, (int64_t)H * TC_P);
  if (ck > 0) {
    float4 v[N / 8];
    load_rows<N / 4>(v, cs + (((int64_t)bb * H + h) * C + ck) *
                                 (int64_t)TC_P * N, N);
    store_split<3, N / 4>(sts, PART, LDN, v, nullptr);
  }
  __syncthreads();
  block_segments(d_s, a_s);
  __syncthreads();
  float t[4];
  block_totals(t, a_s, d_s);
  float r_lo = a_s[16 * warp] + d_s[i0 * TC_LDD];       // R of rows i0,
  float r_hi = a_s[16 * warp] + d_s[(i0 + 8) * TC_LDD]; // i0 + 8

  float acc[TC_P / 8][4];
#pragma unroll
  for (int n = 0; n < TC_P / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (ck > 0) {
    float tpre = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < warp) tpre += t[k];
    const float e_lo = expf(tpre + r_lo), e_hi = expf(tpre + r_hi);
    const int kl = k_lane_offset(lane, LDN);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = cn[e] * ((e & 2) ? e_hi : e_lo);
      if (kk + 1 < NK) load_a_f32(cn, crow + 16 * (kk + 1), N);
      uint32_t ca[3][4];
      split_a(ca, f);
#pragma unroll
      for (int np = 0; np < TC_P / 16; ++np) {
        uint32_t bf[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          ldmatrix_x4(bf[k], smem_u32(sts + k * PART + np * 16 * LDN +
                                      kk * 16 + kl));
        mma_split<3, 3>(acc[2 * np], ca, bf, 0);
        mma_split<3, 3>(acc[2 * np + 1], ca, bf, 1);
      }
    }
  }

  // intra term: the k-steps of columns j up to this warp's diagonal tile
  const int vl = v_lane_offset(lane, TC_LDX);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > warp) break;
    float mid = 0.f;                       // T_{kk+1} + ... + T_{warp-1}
#pragma unroll
    for (int k = 1; k < 3; ++k)
      if (k > kk && k < warp) mid += t[k];
    const float row_lo = r_lo + mid, row_hi = r_hi + mid;
    float w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = gn[e];
    if (kk < warp) load_a_f32(gn, grow + 16 * (kk + 1), TC_Q);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // a0 (i0, j), a1 (i0 + 8, j), a2 (i0, j + 8), a3 (i0 + 8, j + 8)
      const int i = i0 + 8 * (r & 1), j = 16 * kk + 2 * tig + 8 * (r >> 1);
      const float2 d = *reinterpret_cast<const float2*>(dt_s + j);
      float2 seg;
      if (kk < warp) {
        const float2 sj = *reinterpret_cast<const float2*>(
            d_s + (16 * kk + 15) * TC_LDD + (j & 15));
        const float row = (r & 1) ? row_hi : row_lo;
        seg = make_float2(row + sj.x, row + sj.y);
      } else {                             // D above the diagonal: 0
        seg = *reinterpret_cast<const float2*>(d_s + i * TC_LDD + (j & 15));
        seg = make_float2(j <= i ? seg.x : 0.f, j + 1 <= i ? seg.y : 0.f);
      }
      w[2 * r] = j <= i ? w[2 * r] * (d.x * expf(seg.x)) : 0.f;
      w[2 * r + 1] = j + 1 <= i ? w[2 * r + 1] * (d.y * expf(seg.y)) : 0.f;
    }
    uint32_t wa[3][4];
    split_a(wa, w);
#pragma unroll
    for (int np = 0; np < TC_P / 16; ++np) {
      uint32_t xb[NX][4];
#pragma unroll
      for (int k = 0; k < NX; ++k)
        ldmatrix_x4_trans(xb[k], smem_u32(xs + k * TC_Q * TC_LDX +
                                          kk * 16 * TC_LDX + np * 16 + vl));
      mma_split<3, NX>(acc[2 * np], wa, xb, 0);
      mma_split<3, NX>(acc[2 * np + 1], wa, xb, 1);
    }
  }
  float* yr = y + ((tok0 + i0) * H + h) * (int64_t)TC_P + 2 * tig;
  const int64_t row8 = 8 * (int64_t)H * TC_P;
#pragma unroll
  for (int n = 0; n < TC_P / 8; ++n) {
    *reinterpret_cast<float2*>(yr + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(yr + row8 + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the state pass, shared by both routes
static int launch_state(void* cs, const void* decay, void* state,
                        int64_t batch, int C, int H, int PN, cudaStream_t s) {
  ssd_state_kernel<<<dim3((unsigned)((PN + SSD_THREADS - 1) / SSD_THREADS),
                          (unsigned)H, (unsigned)batch), SSD_THREADS, 0, s>>>(
      (float*)cs, (const float*)decay, (float*)state, C, PN, H);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* dt, const void* a,
                  const void* b, const void* c, void* y, void* state,
                  void* cs, void* decay, int64_t batch, int S, int H, int P,
                  int N, int Q, cudaStream_t s) {
  const int C = S / Q, LD = ssd_ld(N), Q4 = (Q + 3) / 4 * 4;
  const int n_ps = (P + SSD_PB - 1) / SSD_PB;
  const size_t smem1 = sizeof(float) *
      (2 * (size_t)Q * LD + (size_t)Q4 * SSD_PB + (size_t)Q * (Q4 + 4) +
       4 * (size_t)Q);
  const size_t smem3 =
      sizeof(float) * ((size_t)(Q + SSD_PB) * LD + 2 * (size_t)Q);
  if (int e = set_smem((const void*)ssd_chunk_kernel<T>, smem1)) return e;
  if (int e = set_smem((const void*)ssd_inter_kernel, smem3)) return e;
  const int vec_bc = N % 4 == 0 && (uintptr_t)b % 16 == 0 &&
                     (uintptr_t)c % 16 == 0;
  const int vec_x = (P * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  const float* af = (const float*)a;
  const float* cf = (const float*)c;
  float* yf = (float*)y;
  float* csf = (float*)cs;
  float* dec = (float*)decay;
  if (C > 0) {
    ssd_chunk_kernel<T><<<dim3((unsigned)(C * n_ps), (unsigned)H,
                               (unsigned)batch), SSD_THREADS, smem1, s>>>(
        (const T*)x, (const float*)dt, af, (const float*)b, cf, yf, csf, dec,
        S, H, P, N, Q, n_ps, vec_bc, vec_x);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (int e = launch_state(cs, decay, state, batch, C, H, P * N, s)) return e;
  if (C > 1) {
    ssd_inter_kernel<<<dim3((unsigned)(C * n_ps), (unsigned)H,
                            (unsigned)batch), SSD_THREADS, smem3, s>>>(
        af, cf, csf, yf, S, H, P, N, Q, n_ps, vec_bc);
  }
  return (int)cudaGetLastError();
}

// The tensor-core route's four launches in order
template <typename T, int NK>
static int launch_tc(const void* x, const void* dt, const void* a,
                     const void* b, const void* c, void* y, void* state,
                     void* cs, void* decay, void* gram, int64_t batch, int S,
                     int H, cudaStream_t s) {
  constexpr int NX = std::is_same<T, float>::value ? 3 : 1;
  const int C = S / TC_Q;
  const size_t split_n = 3 * sizeof(__nv_bfloat16) * TC_Q * tc_ldn(16 * NK);
  const size_t x_b = NX * sizeof(__nv_bfloat16) * TC_Q * TC_LDX;
  const size_t smem_g = split_n;
  const size_t smem_c = split_n + x_b + 2 * sizeof(float) * TC_Q;
  const size_t smem_y = split_n + x_b +
                        sizeof(float) * (TC_Q * TC_LDD + 2 * TC_Q);
  if (int e = set_smem((const void*)ssd_gram_tc_kernel<NK>, smem_g)) return e;
  if (int e = set_smem((const void*)ssd_chunk_tc_kernel<T, NK>, smem_c))
    return e;
  if (int e = set_smem((const void*)ssd_out_tc_kernel<T, NK>, smem_y))
    return e;
  const dim3 grid((unsigned)C, (unsigned)H, (unsigned)batch);
  if (C > 0) {
    ssd_gram_tc_kernel<NK><<<dim3((unsigned)C, (unsigned)batch), TC_THREADS,
                             smem_g, s>>>((const float*)b, (const float*)c,
                                          (float*)gram, S);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    ssd_chunk_tc_kernel<T, NK><<<grid, TC_THREADS, smem_c, s>>>(
        (const T*)x, (const float*)dt, (const float*)a, (const float*)b,
        (float*)cs, (float*)decay, S, H);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (int e = launch_state(cs, decay, state, batch, C, H, TC_P * 16 * NK, s))
    return e;
  if (C > 0) {
    ssd_out_tc_kernel<T, NK><<<grid, TC_THREADS, smem_y, s>>>(
        (const T*)x, (const float*)dt, (const float*)a, (const float*)c,
        (const float*)gram, (const float*)cs, (float*)y, S, H);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_tc_n(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, void* y, void* state,
                       void* cs, void* decay, void* gram, int64_t batch,
                       int S, int H, int N, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_tc<T, 1>(x, dt, a, b, c, y, state, cs, decay, gram,
                             batch, S, H, s);
    case 32:
      return launch_tc<T, 2>(x, dt, a, b, c, y, state, cs, decay, gram,
                             batch, S, H, s);
    case 64:
      return launch_tc<T, 4>(x, dt, a, b, c, y, state, cs, decay, gram,
                             batch, S, H, s);
    default:
      return launch_tc<T, 8>(x, dt, a, b, c, y, state, cs, decay, gram,
                             batch, S, H, s);
  }
}

// the tensor-core route's shapes: Q 64, P 64, N 16, 32, 64 or 128, x, b
// and c on 16-byte boundaries (mirrored by ops._ssd_tc)
static bool tc_takes(const void* x, const void* b, const void* c, int P,
                     int N, int Q) {
  return Q == TC_Q && P == TC_P &&
         (N == 16 || N == 32 || N == 64 || N == 128) &&
         ((uintptr_t)x | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

// cs: scratch of (B, H, S / Q, P, N) f32; decay: scratch of (B, H, S / Q)
// f32. The scalar route; refuses the tensor-core route's shapes.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, void* state,
                        void* cs, void* decay, int64_t batch, int S, int H,
                        int P, int N, int Q, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || P <= 0) return 0;
  if (Q < 1 || Q > SSD_MAX_Q || N < 1 || N > SSD_MAX_N || S < 0 || S % Q ||
      tc_takes(x, b, c, P, N, Q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, state, cs, decay, batch,
                                 S, H, P, N, Q, s);
  return launch<float>(x, dt, a, b, c, y, state, cs, decay, batch, S, H, P,
                       N, Q, s);
}

// The tensor-core route, with the scratch of the scalar route and gram, a
// (B, S / Q, Q, Q) f32 buffer for G; refuses every other shape.
extern "C" int ssd_scan_tc(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, void* y,
                           void* state, void* cs, void* decay, void* gram,
                           int64_t batch, int S, int H, int P, int N, int Q,
                           int dtype, void* stream) {
  if (batch <= 0 || H <= 0) return 0;
  if (!tc_takes(x, b, c, P, N, Q) || S < 0 || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch_tc_n<__nv_bfloat16>(x, dt, a, b, c, y, state, cs, decay,
                                      gram, batch, S, H, N, s);
  return launch_tc_n<float>(x, dt, a, b, c, y, state, cs, decay, gram,
                            batch, S, H, N, s);
}
