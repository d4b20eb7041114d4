// Warp-level tensor-core and asynchronous-copy helpers (sm_80 and later,
// built here for sm_90a): mma.sync m16n8k16 on bf16 with f32
// accumulation, ldmatrix from shared memory, and 16-byte cp.async copies
// from global to shared memory with commit / wait groups.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * grp + tig):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 (grp,     2tig..2tig+1)   a1 (grp + 8, 2tig..2tig+1)
//     a2 (grp, 2tig+8..2tig+9)     a3 (grp + 8, 2tig+8..2tig+9)
//   B (16 x 8, k by n), 2 registers: b0 (k 2tig..2tig+1, n grp),
//     b1 (k 2tig+8..2tig+9, n grp)
//   C, D (16 x 8, f32): c0, c1 (grp, 2tig..2tig+1),
//     c2, c3 (grp + 8, 2tig..2tig+1)
// In every register the lower 16 bits hold the element of lower index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives (row lane / 4, columns 2 (lane % 4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: r[i] receives (rows 2 (lane % 4), +1; column
// lane / 4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 copies nothing
// and fills the 16 bytes with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x with the MUFU unit (relative error about 2^-22; results below 2^-126
// flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (x in the lower half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as two bf16 pairs with x ~= hi.x + lo.x (and y likewise):
// hi is x rounded to bf16, lo the exact f32 remainder rounded to bf16, so
// hi + lo keeps about 16 significant bits
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
