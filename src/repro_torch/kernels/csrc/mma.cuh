// Warp-level tensor-core and asynchronous-copy helpers (sm_80 and later,
// built here for sm_90a): mma.sync m16n8k16 on bf16 with f32
// accumulation, ldmatrix from shared memory, and 16-byte cp.async copies
// from global to shared memory with commit / wait groups; and the three
// steps of one 64-key tile of a flash-attention loop that the bf16
// attention kernels share (paged_prefill_tc_kernel, B4 and B10;
// swa_attention_tc_kernel, B15): S = Q K^T, the online softmax, O += P V.
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

#include "common.cuh"

constexpr float LOG2E = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// one 64-key tile of a flash-attention loop, per warp of 16 query rows
// ---------------------------------------------------------------------------
// Q sits in registers as A fragments, qa[kk] = rows (grp, grp + 8), dims
// kk * 16 ..; K and V tiles are 64 rows of D bf16 in shared memory with
// row stride D + 8 (an odd number of 16-byte units, so the eight rows of
// every ldmatrix fall in eight different bank groups). s[n][x] is row
// grp + 8 (x >> 1), key 8 n + 2 tig + (x & 1) of the tile.

// ldmatrix row offsets (elements) of this lane inside a tile of row stride
// ld: K as the B operand of Q K^T (keys as n, dims as k) and V transposed
// as the B operand of P V (keys as k, dims as n)
__device__ __forceinline__ int k_lane_offset(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int v_lane_offset(int lane, int ld) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
}

// S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const __nv_bfloat16* ks,
                                            int k_lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[n][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(ks + np * 16 * LD + kk * 16 + k_lane));
      mma_bf16_16816(s[2 * np], qa[kk], kb[0], kb[1]);
      mma_bf16_16816(s[2 * np + 1], qa[kk], kb[2], kb[3]);
    }
}

// One online-softmax step over the tile's scores s, which it replaces by
// the probabilities p. The running max m is kept in raw score units and p
// = 2^(s c - m c), c = scale_log2 = log2(e) * softmax scale: one FMA and
// one MUFU ex2. Row max and row sum are reduced over the four lanes of a
// quad by shuffles; l gathers this lane's part of the row sum (the quad's
// lanes are summed at the end). O is rescaled only when some row's max
// moved. live(n, x) says whether s[n][x]'s key is visible to its row; a
// tile that every row of the warp sees whole passes full (a warp-uniform
// branch) and skips the mask. A masked key gets probability 0
// explicitly, not exp(NEG_INF - m): NEG_INF is finite, and a row whose
// keys are all masked so far would otherwise count exp(0) = 1 per key.
template <int DT, typename Live>
__device__ __forceinline__ void tile_softmax(float (&s)[8][4],
                                             float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&o)[DT][4],
                                             float scale_log2, bool full,
                                             Live live) {
  if (!full) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (!live(n, x)) s[n][x] = NEG_INF;
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
      // nested: written as one `!full && !live` test, this step cost the
      // B4 instantiation two registers and 7 % of its time on an H100
      if (!full) {
        if (!live(n, x)) p = 0.f;
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
}

// O += P V. The probabilities' accumulators serve as A fragments (FA2's
// register layout: keys kk * 16 .. + 15 are n-tiles 2 kk and 2 kk + 1),
// V is read with ldmatrix.trans. P is split as hi + lo, both bf16, with
// two MMAs per k-step, so P keeps about 16 bits: bf16 P alone leaves the
// output up to one bf16 step from an f32 softmax.
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 8][4],
                                        const float (&p)[8][4],
                                        const __nv_bfloat16* vs,
                                        int v_lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
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

