// KV writes into the paged pool: one decode token per sequence, and one
// suffix chunk per sequence.
//
// Replaces (Pallas, TPU):
//   kv_token_write  <- src/repro/kernels/kv_write.py:276 kv_token_write
//   kv_chunk_write  <- src/repro/kernels/kv_write.py:221 kv_chunk_write
//
// Bound on the H100: memory. Each written token moves Hkv*D elements of K
// and of V once from the new-token tensors into the pool (2 KiB per tensor
// at Qwen2.5-14B's Hkv=8, D=128 in bf16), and reads 4 bytes of slot id or
// window metadata. There is no arithmetic to speak of.
//
// Design: one thread block per (token, K or V); the token's Hkv*D elements
// are one contiguous run both in the source and at the destination slot,
// so the block copies it with 16-byte vectors (falling back to 4 or 2
// bytes when the run or a base pointer is not 16-byte aligned). Element
// offsets are computed in int64_t: a pool at this model's width with 4096
// blocks, and the layer-folded slot ids of PagedKVCache.write_tokens,
// pass INT32_MAX elements. The TPU kernel revisits whole pages through
// aliased grid steps; here each token touches only its own row, so a
// chunk's tokens that share a page need no ordering. Slots outside the
// pool and tokens past wcount are not written; several padded decode rows
// may write the scratch slot at once, which is dead memory.
#include "common.cuh"

template <typename V>
__global__ void kv_token_write_kernel(char* k_pool, char* v_pool,
                                      const char* k_new, const char* v_new,
                                      const int32_t* slots, int64_t n_slots,
                                      int64_t row_bytes) {
  const int64_t b = blockIdx.x;
  const bool is_v = blockIdx.y;
  const int64_t slot = slots[b];
  if (slot < 0 || slot >= n_slots) return;
  char* dst = (is_v ? v_pool : k_pool) + slot * row_bytes;
  const char* src = (is_v ? v_new : k_new) + b * row_bytes;
  copy_run<V>(dst, src, row_bytes / (int64_t)sizeof(V));
}

template <typename V>
__global__ void kv_chunk_write_kernel(char* k_pool, char* v_pool,
                                      const char* k_new, const char* v_new,
                                      const int32_t* wpages,
                                      const int32_t* wstart,
                                      const int32_t* wcount, int chunk,
                                      int win_pages, int block_size,
                                      int64_t n_pages, int64_t row_bytes) {
  const int j = blockIdx.x;
  const int64_t b = blockIdx.y;
  const bool is_v = blockIdx.z;
  if (j >= wcount[b]) return;
  const int pos = wstart[b] + j;
  const int pi = pos / block_size;
  if (pi >= win_pages) return;
  const int64_t page = wpages[b * win_pages + pi];
  if (page < 0 || page >= n_pages) return;
  const int64_t slot = page * block_size + pos % block_size;
  char* dst = (is_v ? v_pool : k_pool) + slot * row_bytes;
  const char* src = (is_v ? v_new : k_new) + (b * chunk + j) * row_bytes;
  copy_run<V>(dst, src, row_bytes / (int64_t)sizeof(V));
}

#define LAUNCH_BY_VEC(vec, KERNEL, grid, threads, stream, ...)            \
  switch (vec) {                                                          \
    case 16:                                                              \
      KERNEL<uint4><<<grid, threads, 0, stream>>>(__VA_ARGS__);           \
      break;                                                              \
    case 4:                                                               \
      KERNEL<uint32_t><<<grid, threads, 0, stream>>>(__VA_ARGS__);        \
      break;                                                              \
    default:                                                              \
      KERNEL<uint16_t><<<grid, threads, 0, stream>>>(__VA_ARGS__);        \
  }

extern "C" int kv_token_write(void* k_pool, void* v_pool, const void* k_new,
                              const void* v_new, const void* slots,
                              int64_t batch, int64_t n_slots,
                              int64_t row_bytes, void* stream) {
  if (batch <= 0) return 0;
  const int vec = pick_vec((uintptr_t)k_pool | (uintptr_t)v_pool |
                               (uintptr_t)k_new | (uintptr_t)v_new,
                           row_bytes);
  const dim3 grid((unsigned)batch, 2);
  const int threads = 128;
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_VEC(vec, kv_token_write_kernel, grid, threads, s, (char*)k_pool,
                (char*)v_pool, (const char*)k_new, (const char*)v_new,
                (const int32_t*)slots, n_slots, row_bytes);
  return (int)cudaGetLastError();
}

extern "C" int kv_chunk_write(void* k_pool, void* v_pool, const void* k_new,
                              const void* v_new, const void* wpages,
                              const void* wstart, const void* wcount,
                              int64_t batch, int chunk, int win_pages,
                              int block_size, int64_t n_pages,
                              int64_t row_bytes, void* stream) {
  if (batch <= 0 || chunk <= 0) return 0;
  const int vec = pick_vec((uintptr_t)k_pool | (uintptr_t)v_pool |
                               (uintptr_t)k_new | (uintptr_t)v_new,
                           row_bytes);
  const dim3 grid((unsigned)chunk, (unsigned)batch, 2);
  const int threads = 128;
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_VEC(vec, kv_chunk_write_kernel, grid, threads, s, (char*)k_pool,
                (char*)v_pool, (const char*)k_new, (const char*)v_new,
                (const int32_t*)wpages, (const int32_t*)wstart,
                (const int32_t*)wcount, chunk, win_pages, block_size,
                n_pages, row_bytes);
  return (int)cudaGetLastError();
}
