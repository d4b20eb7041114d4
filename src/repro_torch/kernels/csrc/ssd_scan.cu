// Mamba2 SSD chunk scan from a zero state: x (B, S, H, P) float / bf16,
// dt and a = dt * A (B, S, H) f32, b and c (B, S, N) f32 shared by every
// head -> y (B, S, H, P) f32 and the final state (B, H, P, N) f32.
//
// Replaces (Pallas, TPU):
//   ssd_scan  <- src/repro/kernels/ssd_scan.py:64
//
// What it computes, per (batch, head), chunk after chunk of Q tokens with
// the (P, N) state carried from one to the next (acum = cumsum(a) within
// the chunk):
//   y_i   = sum_{j <= i} (c_i . b_j) exp(acum_i - acum_j) dt_j x_j
//           + exp(acum_i) (c_i . state^T)
//   state = state exp(acum_last) + sum_j x_j^T dt_j exp(acum_last - acum_j) b_j
//
// Bound on the H100: operations. At Mamba2-130M's shapes (P 64, N 128,
// Q 64) a (batch, head, chunk) needs about 1.8 M multiply-adds (3.7 MFLOP)
// for about 27 KB of x, y and its share of b and c, some 135 flops per
// byte, and this kernel uses the scalar f32 units, whose peak is 67
// TFLOP/s: flops, not bytes, set its bound.
//
// Design. The Pallas kernel walks the chunks in order (the grid's
// innermost axis) with the state in VMEM. A first version here did the
// same, one block per (batch, head, 32 rows of P) looping over the chunks:
// 192 blocks for Mamba2 on 132 SMs, each chunk a chain of dependent
// shared-memory phases (PERF.md has its times). This version splits the
// scan as the SSD paper's chunked algorithm does, so that only an
// elementwise recurrence stays sequential:
//   1. ssd_chunk_kernel, one block per (chunk, head, batch row) (and per
//      64 rows of P): the chunk's intra term y = w x with the weights
//      w = (c b^T) exp(acum_i - acum_j) dt_j on and below the diagonal (exp
//      is never evaluated for j > i, where it would overflow), written to
//      y; the chunk's own state contribution sum_j x_j^T dec_j b_j, written
//      to the scratch `cs`; and the chunk decay exp(acum_last);
//   2. ssd_state_kernel, one thread per (batch, head, state element):
//      state = state * decay_c + cs_c over the chunks, overwriting cs_c
//      with the state that enters chunk c, eight chunks' loads in flight;
//      the last value is the final state;
//   3. ssd_inter_kernel, one block per (chunk > 0, head, batch row): y +=
//      exp(acum_i) (c_i . state_in^T).
// Each block stages its operands in shared memory as f32 with 16-byte
// loads, several in flight per thread; 256 threads as a
// 16 x 16 grid compute register tiles of strided rows and columns, reading
// shared memory as float4 (rows padded so that the 16 rows read at once
// spread over all 32 banks), about three float4 loads per 16 FMAs. One
// position per thread sums a in order (the prefix and the chunk total).
// Shared memory passes 48 KB at N = 128 (about 100 KB for kernel 1), so
// the launch raises the dynamic limit. The scratch holds one (P, N) f32
// state per (batch, head, chunk): 100 MB for Mamba2 at B = 4, S = 2048.
//
// What the simple design leaves: scalar f32 FMAs instead of tensor-core
// tiles, the full Q x Q score tile where only the lower triangle is
// needed, c b^T recomputed for every head of a batch row, and the state
// round trip through device memory.
#include "common.cuh"

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

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  const int PN = P * N;
  ssd_state_kernel<<<dim3((unsigned)((PN + SSD_THREADS - 1) / SSD_THREADS),
                          (unsigned)H, (unsigned)batch), SSD_THREADS, 0, s>>>(
      csf, dec, (float*)state, C, PN, H);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (C > 1) {
    ssd_inter_kernel<<<dim3((unsigned)(C * n_ps), (unsigned)H,
                            (unsigned)batch), SSD_THREADS, smem3, s>>>(
        af, cf, csf, yf, S, H, P, N, Q, n_ps, vec_bc);
  }
  return (int)cudaGetLastError();
}

// cs: scratch of (B, H, S / Q, P, N) f32; decay: scratch of (B, H, S / Q) f32
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, void* state,
                        void* cs, void* decay, int64_t batch, int S, int H,
                        int P, int N, int Q, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || P <= 0) return 0;
  if (Q < 1 || Q > SSD_MAX_Q || N < 1 || N > SSD_MAX_N || S < 0 || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, state, cs, decay, batch,
                                 S, H, P, N, Q, s);
  return launch<float>(x, dt, a, b, c, y, state, cs, decay, batch, S, H, P,
                       N, Q, s);
}
