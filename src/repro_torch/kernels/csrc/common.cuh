// Shared helpers for the kernels: float conversion for the two pool types
// (f32, bf16) and for int8 pages, the dtype codes the Python wrappers
// pass, and a block-wide copy of one contiguous run with the widest vector
// that the run's alignment allows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes shared with ops.py
#define DTYPE_F32 0
#define DTYPE_BF16 1

#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// One page element as f32. An int8 element of tile page tp is dequantized
// with that page's scale sc[tp]: one f32 product, rounded once, as
// dequantize_block_ref computes it; other page types ignore sc.
template <typename P>
__device__ __forceinline__ float page_f32(P x, const float* sc, int tp) {
  if constexpr (std::is_same<P, int8_t>::value) return to_f32(x) * sc[tp];
  else return to_f32(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA and torch do
}

// All threads of the block copy n_vec vectors of type V from src to dst.
template <typename V>
__device__ __forceinline__ void copy_run(char* dst, const char* src,
                                         int64_t n_vec) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int64_t i = threadIdx.x; i < n_vec; i += blockDim.x) d[i] = s[i];
}

// Stage the K and V rows of one kv head for n_tok consecutive positions
// of a paged sequence into shared memory as f32: k_dst[t * k_ld + d],
// v_dst[t * v_ld + d]. Position t lives in page pg[t / bs] at row t % bs.
// Pages of type P are float, bf16 or int8; int8 pages are dequantized on
// the way with the per-tile-page scales k_sc[t / bs] and v_sc[t / bs]
// (unused, and may be null, for float pages). With vec (every row 16-byte
// aligned, D * sizeof(P) a multiple of 16) each thread issues four 16-byte
// loads per tensor before it uses any, so a tile's bytes are in flight
// together instead of one load per thread; int8 vectors are then written
// as float4 stores, so k_dst, v_dst and their row strides must keep rows
// 16-byte aligned.
template <typename P>
__device__ __forceinline__ void stage_kv_f32(
    float* k_dst, int k_ld, float* v_dst, int v_ld,
    const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const int* pg, const float* k_sc, const float* v_sc, int n_tok, int bs,
    int64_t page_stride, int64_t tok_stride, int64_t head_off, int D,
    bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(P);   // elements per 16-byte vector
    constexpr int U = 4;                // vectors in flight per tensor
    const int vpr = D / E;              // vectors per row
    const int n = n_tok * vpr;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * blockDim.x) {
      uint4 kr[U], vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n) {
          const int t = i / vpr, c = i % vpr;
          const int64_t off = (int64_t)pg[t / bs] * page_stride +
                              (int64_t)(t % bs) * tok_stride + head_off +
                              (int64_t)c * E;
          kr[u] = *reinterpret_cast<const uint4*>(k_pages + off);
          vr[u] = *reinterpret_cast<const uint4*>(v_pages + off);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n) {
          const int t = i / vpr, c = i % vpr;
          const P* ke = reinterpret_cast<const P*>(&kr[u]);
          const P* ve = reinterpret_cast<const P*>(&vr[u]);
          if constexpr (std::is_same<P, int8_t>::value) {
            // 16 floats per vector, written as four float4 stores: scalar
            // stores from lanes 16 floats apart would hit 2 of the 32
            // banks (needs 16-byte aligned rows: k_ld, v_ld multiples of 4)
            const float ks = k_sc[t / bs], vs = v_sc[t / bs];
            float4* kd = reinterpret_cast<float4*>(k_dst + t * k_ld + c * E);
            float4* vd = reinterpret_cast<float4*>(v_dst + t * v_ld + c * E);
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              kd[e / 4] = make_float4(
                  to_f32(ke[e]) * ks, to_f32(ke[e + 1]) * ks,
                  to_f32(ke[e + 2]) * ks, to_f32(ke[e + 3]) * ks);
              vd[e / 4] = make_float4(
                  to_f32(ve[e]) * vs, to_f32(ve[e + 1]) * vs,
                  to_f32(ve[e + 2]) * vs, to_f32(ve[e + 3]) * vs);
            }
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              k_dst[t * k_ld + c * E + e] = to_f32(ke[e]);
              v_dst[t * v_ld + c * E + e] = to_f32(ve[e]);
            }
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_tok * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      const int64_t off = (int64_t)pg[t / bs] * page_stride +
                          (int64_t)(t % bs) * tok_stride + head_off + d;
      k_dst[t * k_ld + d] = page_f32(k_pages[off], k_sc, t / bs);
      v_dst[t * v_ld + d] = page_f32(v_pages[off], v_sc, t / bs);
    }
  }
}

// Widest copy unit (16, 4 or 2 bytes) for runs that start at base + i *
// run_bytes for every i: every base and the run length must be multiples.
static inline int pick_vec(uintptr_t bases, int64_t run_bytes) {
  uintptr_t m = bases | static_cast<uintptr_t>(run_bytes);
  if (m % 16 == 0) return 16;
  if (m % 4 == 0) return 4;
  return 2;
}
