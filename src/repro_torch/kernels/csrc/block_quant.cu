// The int8 host tier's data plane: quantize KV blocks on their way to the
// host (offload) and dequantize them on their way back (upload,
// promotion), fused with the all-layer block gather / scatter, plus the
// same quantization of staged blocks with no index and no layer axis.
//
// Replaces (Pallas, TPU):
//   block_gather_quant_layers     <- src/repro/kernels/block_copy.py:93
//   block_scatter_dequant_layers  <- src/repro/kernels/block_copy.py:134
//   kv_block_quant                <- src/repro/kernels/kv_write.py:154
//   kv_block_dequant              <- src/repro/kernels/kv_write.py:189
//
// Numerics (the contract of quantize_block_ref, bit for bit): per (layer,
// block, kv head) the scale is max(amax / 127, 1e-8) over the head's
// (token, dim) plane, and q = clamp(rint(x / scale), -127, 127). Both
// divisions are IEEE divisions (nvcc's default -prec-div=true; no
// reciprocal, no fast math), and rintf rounds half to even as torch.round
// and jnp.round do; roundf would round half away from zero. Dequantize is
// float(q) * scale, rounded once to the output type.
//
// Bound on the H100: memory. One (layer, block) pair reads bs*Hkv*D pool
// elements once and writes as many int8 bytes plus Hkv fp32 scales
// (quantize), or the reverse (dequantize): at Qwen2.5-14B's bs=16, Hkv=8,
// D=128 in bf16, 32 KiB of pool and 16 KiB of int8 per pair.
//
// Design: one thread block per (block id, layer) pair, grid (M, L), as in
// block_copy.cu: the pair's pool block is one contiguous (bs, Hkv, D) run.
// The plane of kv head h is strided inside the run (row t at (t*Hkv+h)*D),
// so each warp owns one head (looping when Hkv exceeds the warps) and
// walks its plane with 16-byte loads where D and the bases allow. The
// quantizer takes amax with warp shuffles and then quantizes; one lane
// writes the scale. A plane of up to 256 vectors (16 x 128 in bf16) stays
// in registers, every load issued before any is used; a larger one is
// read twice, the second time from L1/L2. The dequantizer reads the head's
// scale once and streams int8 in, pool type out. Offsets are int64_t: at
// the serve pool the last layer's byte offset passes 3.2e9. Block ids
// outside [0, N) are skipped, as in block_copy.cu.
#include "common.cuh"

#define QUANT_MAX_WARPS 8
// 16-byte vectors per lane a quantizing warp keeps in registers: a head
// plane of up to 32 * QUANT_REG_VECS vectors (Qwen2.5-14B's 16 x 128 in
// bf16) is read from memory once
#define QUANT_REG_VECS 8

template <int E> struct I8Vec;                   // E int8 values, one store
template <> struct I8Vec<8> { using type = uint2; };
template <> struct I8Vec<4> { using type = uint32_t; };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
  return (int8_t)(int)r;
}

// x: the pool run of one (layer, block); q: its int8 slot in staging.
template <typename T, bool VEC>
__device__ __forceinline__ void quant_head(const T* __restrict__ x,
                                           int8_t* __restrict__ q,
                                           float* scale_out, int bs, int hkv,
                                           int d, int h, int lane) {
  constexpr int E = 16 / sizeof(T);
  using QV = typename I8Vec<E>::type;
  float amax = 0.0f;
  if constexpr (VEC) {
    const int vpr = d / E, n = bs * vpr;
    if (n <= 32 * QUANT_REG_VECS) {   // one read, all loads in flight
      uint4 r[QUANT_REG_VECS];
      int64_t off[QUANT_REG_VECS];
#pragma unroll
      for (int u = 0; u < QUANT_REG_VECS; ++u) {
        const int i = lane + 32 * u;
        off[u] = ((int64_t)(i / vpr) * hkv + h) * d + (int64_t)(i % vpr) * E;
        if (i < n) r[u] = *reinterpret_cast<const uint4*>(x + off[u]);
      }
#pragma unroll
      for (int u = 0; u < QUANT_REG_VECS; ++u) {
        if (lane + 32 * u >= n) continue;
        const T* e = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
        for (int k = 0; k < E; ++k) amax = fmaxf(amax, fabsf(to_f32(e[k])));
      }
      const float scale = fmaxf(warp_max(amax) / 127.0f, 1e-8f);
      if (lane == 0) *scale_out = scale;
#pragma unroll
      for (int u = 0; u < QUANT_REG_VECS; ++u) {
        if (lane + 32 * u >= n) continue;
        const T* e = reinterpret_cast<const T*>(&r[u]);
        QV out;
        int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
        for (int k = 0; k < E; ++k) b[k] = quant1(to_f32(e[k]), scale);
        *reinterpret_cast<QV*>(q + off[u]) = out;
      }
      return;
    }
    for (int i = lane; i < n; i += 32) {
      const int64_t off = ((int64_t)(i / vpr) * hkv + h) * d +
                          (int64_t)(i % vpr) * E;
      const uint4 r = *reinterpret_cast<const uint4*>(x + off);
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int k = 0; k < E; ++k) amax = fmaxf(amax, fabsf(to_f32(e[k])));
    }
  } else {
    for (int i = lane; i < bs * d; i += 32)
      amax = fmaxf(amax, fabsf(to_f32(
                             x[((int64_t)(i / d) * hkv + h) * d + i % d])));
  }
  const float scale = fmaxf(warp_max(amax) / 127.0f, 1e-8f);
  if (lane == 0) *scale_out = scale;
  if constexpr (VEC) {
    const int vpr = d / E, n = bs * vpr;
    for (int i = lane; i < n; i += 32) {
      const int64_t off = ((int64_t)(i / vpr) * hkv + h) * d +
                          (int64_t)(i % vpr) * E;
      const uint4 r = *reinterpret_cast<const uint4*>(x + off);
      const T* e = reinterpret_cast<const T*>(&r);
      QV out;
      int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) b[k] = quant1(to_f32(e[k]), scale);
      *reinterpret_cast<QV*>(q + off) = out;
    }
  } else {
    for (int i = lane; i < bs * d; i += 32) {
      const int64_t off = ((int64_t)(i / d) * hkv + h) * d + i % d;
      q[off] = quant1(to_f32(x[off]), scale);
    }
  }
}

// q: int8 staging run of one (layer, block); y: its pool run (or output).
template <typename T, bool VEC>
__device__ __forceinline__ void dequant_head(const int8_t* __restrict__ q,
                                             T* __restrict__ y, float scale,
                                             int bs, int hkv, int d, int h,
                                             int lane) {
  constexpr int E = 16 / sizeof(T);
  using QV = typename I8Vec<E>::type;
  if constexpr (VEC) {
    const int vpr = d / E, n = bs * vpr;
    for (int i = lane; i < n; i += 32) {
      const int64_t off = ((int64_t)(i / vpr) * hkv + h) * d +
                          (int64_t)(i % vpr) * E;
      const QV in = *reinterpret_cast<const QV*>(q + off);
      const int8_t* b = reinterpret_cast<const int8_t*>(&in);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) e[k] = from_f32<T>((float)b[k] * scale);
      *reinterpret_cast<uint4*>(y + off) = out;
    }
  } else {
    for (int i = lane; i < bs * d; i += 32) {
      const int64_t off = ((int64_t)(i / d) * hkv + h) * d + i % d;
      y[off] = from_f32<T>((float)q[off] * scale);
    }
  }
}

// Pool block idx[m] (or m when idx is null) of layer l -> staging (l, m).
template <typename T, bool VEC>
__global__ void quant_layers_kernel(const T* __restrict__ pools,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ scales,
                                    const int32_t* __restrict__ idx,
                                    int64_t n_blocks, int64_t m_blocks,
                                    int bs, int hkv, int d) {
  const int64_t m = blockIdx.x, l = blockIdx.y;
  const int64_t blk = idx ? (int64_t)idx[m] : m;
  if (blk < 0 || blk >= n_blocks) return;
  const int64_t run = (int64_t)bs * hkv * d;
  const int lane = threadIdx.x % 32;
  for (int h = threadIdx.x / 32; h < hkv; h += blockDim.x / 32)
    quant_head<T, VEC>(pools + (l * n_blocks + blk) * run,
                       q + (l * m_blocks + m) * run,
                       scales + (l * m_blocks + m) * hkv + h, bs, hkv, d, h,
                       lane);
}

// Staging (l, m) -> pool block idx[m] (or m when idx is null) of layer l.
template <typename T, bool VEC>
__global__ void dequant_layers_kernel(T* __restrict__ pools,
                                      const int8_t* __restrict__ q,
                                      const float* __restrict__ scales,
                                      const int32_t* __restrict__ idx,
                                      int64_t n_blocks, int64_t m_blocks,
                                      int bs, int hkv, int d) {
  const int64_t m = blockIdx.x, l = blockIdx.y;
  const int64_t blk = idx ? (int64_t)idx[m] : m;
  if (blk < 0 || blk >= n_blocks) return;
  const int64_t run = (int64_t)bs * hkv * d;
  const int lane = threadIdx.x % 32;
  for (int h = threadIdx.x / 32; h < hkv; h += blockDim.x / 32)
    dequant_head<T, VEC>(q + (l * m_blocks + m) * run,
                         pools + (l * n_blocks + blk) * run,
                         scales[(l * m_blocks + m) * hkv + h], bs, hkv, d, h,
                         lane);
}

struct QuantArgs {
  void* pools;          // float pool (or blocks / output): T
  void* q;              // int8 payload
  void* scales;         // float32 (L, M, Hkv)
  const int32_t* idx;   // (M,) block ids, or null for the identity
  int64_t n_layers, n_blocks, m_blocks;
  int bs, hkv, d;
};

template <typename T>
static int launch_t(bool quant, const QuantArgs& a, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = a.d % E == 0 && (uintptr_t)a.pools % 16 == 0 &&
                   (uintptr_t)a.q % E == 0;
  const dim3 grid((unsigned)a.m_blocks, (unsigned)a.n_layers);
  const int threads = 32 * (a.hkv < QUANT_MAX_WARPS ? a.hkv : QUANT_MAX_WARPS);
  T* p = (T*)a.pools;
  int8_t* q = (int8_t*)a.q;
  float* sc = (float*)a.scales;
#define QUANT_ARGS p, q, sc, a.idx, a.n_blocks, a.m_blocks, a.bs, a.hkv, a.d
  if (quant && vec)
    quant_layers_kernel<T, true><<<grid, threads, 0, s>>>(QUANT_ARGS);
  else if (quant)
    quant_layers_kernel<T, false><<<grid, threads, 0, s>>>(QUANT_ARGS);
  else if (vec)
    dequant_layers_kernel<T, true><<<grid, threads, 0, s>>>(QUANT_ARGS);
  else
    dequant_layers_kernel<T, false><<<grid, threads, 0, s>>>(QUANT_ARGS);
#undef QUANT_ARGS
  return (int)cudaGetLastError();
}

static int launch(bool quant, int dtype, const QuantArgs& a, void* stream) {
  if (a.n_layers <= 0 || a.m_blocks <= 0) return 0;
  if (a.bs <= 0 || a.hkv <= 0 || a.d <= 0 || a.n_layers > 65535 ||
      a.m_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == DTYPE_BF16 ? launch_t<__nv_bfloat16>(quant, a, s)
                             : launch_t<float>(quant, a, s);
}

extern "C" int block_gather_quant_layers(const void* pools, void* q,
                                         void* scales, const void* idx,
                                         int64_t n_layers, int64_t n_blocks,
                                         int64_t m_blocks, int bs, int hkv,
                                         int d, int dtype, void* stream) {
  return launch(true, dtype,
                {(void*)pools, q, scales, (const int32_t*)idx, n_layers,
                 n_blocks, m_blocks, bs, hkv, d},
                stream);
}

extern "C" int block_scatter_dequant_layers(void* pools, const void* q,
                                            const void* scales,
                                            const void* idx, int64_t n_layers,
                                            int64_t n_blocks,
                                            int64_t m_blocks, int bs, int hkv,
                                            int d, int dtype, void* stream) {
  return launch(false, dtype,
                {pools, (void*)q, (void*)scales, (const int32_t*)idx,
                 n_layers, n_blocks, m_blocks, bs, hkv, d},
                stream);
}

extern "C" int kv_block_quant(const void* blocks, void* q, void* scales,
                              int64_t m_blocks, int bs, int hkv, int d,
                              int dtype, void* stream) {
  return launch(true, dtype,
                {(void*)blocks, q, scales, nullptr, 1, m_blocks, m_blocks,
                 bs, hkv, d},
                stream);
}

extern "C" int kv_block_dequant(const void* q, const void* scales, void* out,
                                int64_t m_blocks, int bs, int hkv, int d,
                                int dtype, void* stream) {
  return launch(false, dtype,
                {out, (void*)q, (void*)scales, nullptr, 1, m_blocks,
                 m_blocks, bs, hkv, d},
                stream);
}
