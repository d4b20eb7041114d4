// All-layer KV block migration: gather pool blocks into a staging buffer
// (offload, COW source) and scatter a staging buffer into pool blocks
// (upload, promotion, COW destination, whole-prompt prefill write).
//
// Replaces (Pallas, TPU):
//   block_gather_layers   <- src/repro/kernels/block_copy.py:41
//   block_scatter_layers  <- src/repro/kernels/block_copy.py:63
//
// Bound on the H100: memory. Each (layer, block) pair is read once and
// written once: bs*Hkv*D elements, 32 KiB at Qwen2.5-14B's bs=16, Hkv=8,
// D=128 in bf16, so one block id across 48 layers moves 1.5 MiB each way
// per tensor. The block-id vector adds 4 bytes per block.
//
// Design: one thread block per (block, layer) pair. In the pool layout
// (L, N, bs, Hkv, D) that pair is one contiguous run, and so is its slot
// in the (L, M, bs, Hkv, D) staging buffer, so the copy is a straight
// 16-byte-vector stream with every load and store coalesced; grid.x walks
// the M block ids and grid.y the L layers, so a migration of M blocks
// fills the card with L*M independent copies. Offsets are int64_t. Block
// ids outside [0, N) are skipped.
#include "common.cuh"

template <typename V>
__global__ void gather_layers_kernel(const char* pools, char* staging,
                                     const int32_t* idx, int64_t n_blocks,
                                     int64_t m_blocks, int64_t run_bytes) {
  const int64_t m = blockIdx.x;
  const int64_t l = blockIdx.y;
  const int64_t blk = idx[m];
  if (blk < 0 || blk >= n_blocks) return;
  copy_run<V>(staging + (l * m_blocks + m) * run_bytes,
              pools + (l * n_blocks + blk) * run_bytes,
              run_bytes / (int64_t)sizeof(V));
}

template <typename V>
__global__ void scatter_layers_kernel(char* pools, const char* staging,
                                      const int32_t* idx, int64_t n_blocks,
                                      int64_t m_blocks, int64_t run_bytes) {
  const int64_t m = blockIdx.x;
  const int64_t l = blockIdx.y;
  const int64_t blk = idx[m];
  if (blk < 0 || blk >= n_blocks) return;
  copy_run<V>(pools + (l * n_blocks + blk) * run_bytes,
              staging + (l * m_blocks + m) * run_bytes,
              run_bytes / (int64_t)sizeof(V));
}

#define DEFINE_LAUNCH(NAME, KERNEL, A_T, B_T)                           \
  static int NAME(A_T a, B_T b, const int32_t* idx, int64_t n_layers,   \
                  int64_t n_blocks, int64_t m_blocks, int64_t run_bytes,    \
                  cudaStream_t s) {                                         \
    if (n_layers <= 0 || m_blocks <= 0) return 0;                          \
    const int vec = pick_vec((uintptr_t)a | (uintptr_t)b, run_bytes);       \
    const dim3 grid((unsigned)m_blocks, (unsigned)n_layers);                \
    const int threads = 256;                                                \
    switch (vec) {                                                          \
      case 16:                                                              \
        KERNEL<uint4><<<grid, threads, 0, s>>>(a, b, idx, n_blocks,         \
                                               m_blocks, run_bytes);        \
        break;                                                              \
      case 4:                                                               \
        KERNEL<uint32_t><<<grid, threads, 0, s>>>(a, b, idx, n_blocks,      \
                                                  m_blocks, run_bytes);     \
        break;                                                              \
      default:                                                              \
        KERNEL<uint16_t><<<grid, threads, 0, s>>>(a, b, idx, n_blocks,      \
                                                  m_blocks, run_bytes);     \
    }                                                                       \
    return (int)cudaGetLastError();                                         \
  }

DEFINE_LAUNCH(launch_gather, gather_layers_kernel, const char*, char*)
DEFINE_LAUNCH(launch_scatter, scatter_layers_kernel, char*, const char*)

extern "C" int block_gather_layers(const void* pools, void* staging,
                                   const void* idx, int64_t n_layers,
                                   int64_t n_blocks, int64_t m_blocks,
                                   int64_t run_bytes, void* stream) {
  return launch_gather((const char*)pools, (char*)staging,
                       (const int32_t*)idx, n_layers, n_blocks, m_blocks,
                       run_bytes, (cudaStream_t)stream);
}

extern "C" int block_scatter_layers(void* pools, const void* staging,
                                    const void* idx, int64_t n_layers,
                                    int64_t n_blocks, int64_t m_blocks,
                                    int64_t run_bytes, void* stream) {
  return launch_scatter((char*)pools, (const char*)staging,
                        (const int32_t*)idx, n_layers, n_blocks, m_blocks,
                        run_bytes, (cudaStream_t)stream);
}
