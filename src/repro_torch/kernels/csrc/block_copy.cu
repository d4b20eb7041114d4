// All-layer KV block migration: gather pool blocks into a staging buffer
// (offload, COW source) and scatter a staging buffer into pool blocks
// (upload, promotion, COW destination, whole-prompt prefill write); and
// the same copies of one layer's (N, bs, Hkv, D) pool.
//
// Replaces (Pallas, TPU):
//   block_gather_layers   <- src/repro/kernels/block_copy.py:41
//   block_scatter_layers  <- src/repro/kernels/block_copy.py:63
//   block_gather          <- src/repro/kernels/block_copy.py:22
//   block_scatter         <- src/repro/kernels/block_copy.py:175
//
// Bound on the H100: memory. Each (layer, block) pair is read once and
// written once: bs*Hkv*D elements, 32 KiB at Qwen2.5-14B's bs=16, Hkv=8,
// D=128 in bf16, so one block id across 48 layers moves 1.5 MiB each way
// per tensor. The block-id vector adds 4 bytes per block.
//
// All-layer design: one thread block per (block, layer) pair. In the pool
// layout (L, N, bs, Hkv, D) that pair is one contiguous run, and so is its
// slot in the (L, M, bs, Hkv, D) staging buffer, so the copy is a straight
// 16-byte-vector stream with every load and store coalesced; grid.x walks
// the M block ids and grid.y the L layers, so a migration of M blocks
// fills the card with L*M independent copies. Offsets are int64_t. Block
// ids outside [0, N) are skipped.
//
// Single-layer design (B13a, B13b): one layer moves M runs, 32 blocks of
// 32 KiB at the measured shape, 2 MiB in all: bound by latency, not by
// bytes (0.6 us at 3.35 TB/s, under the launch floor of a kernel in a
// graph). So each run is split into chunks of COPY_THREADS * COPY_VECS
// vectors (4 KiB of 16-byte vectors; the plan comes from ops._copy_split
// and is checked here), one 128-thread block per (block, chunk), read
// straight off a 2-D grid (no division on the path to the id): 256
// blocks at M = 32, about two per SM, all resident at once. Each thread
// issues all of its loads into registers before its first store, through
// __restrict__ pointers, so a block pays one memory round trip for its
// data; the scatter reads its staging vectors before its block id, so the
// id's round trip overlaps them. The last chunk of a run that is not a
// multiple of the chunk (Kimi-K2's 28 KiB, odd test shapes) is shorter;
// runs and bases aligned to 4 or 2 bytes only take 4- or 2-byte vectors.
// Destination ids of a scatter are distinct, as every caller passes them
// (two blocks writing one pool block would race). Block ids outside
// [0, N) are skipped; a gather leaves their staging rows unwritten.
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

// threads per block and vectors per thread of the single-layer copies
// (ops.COPY_THREADS, ops.COPY_VECS)
#define COPY_THREADS 128
#define COPY_VECS 2

template <typename V>
__global__ void __launch_bounds__(COPY_THREADS)
    gather_chunks_kernel(const char* __restrict__ pages,
                         char* __restrict__ staging,
                         const int32_t* __restrict__ idx, int64_t n_blocks,
                         int64_t run_bytes, int64_t chunk_bytes) {
  const int64_t m = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * chunk_bytes;
  const int64_t len = run_bytes - lo < chunk_bytes ? run_bytes - lo
                                                    : chunk_bytes;
  const int n_vec = (int)(len / (int64_t)sizeof(V));
  const int64_t blk = idx[m];
  if (blk < 0 || blk >= n_blocks) return;
  const V* __restrict__ src =
      reinterpret_cast<const V*>(pages + blk * run_bytes + lo);
  V* __restrict__ dst = reinterpret_cast<V*>(staging + m * run_bytes + lo);
  V r[COPY_VECS];
#pragma unroll
  for (int u = 0; u < COPY_VECS; ++u) {
    const int i = threadIdx.x + u * COPY_THREADS;
    if (i < n_vec) r[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < COPY_VECS; ++u) {
    const int i = threadIdx.x + u * COPY_THREADS;
    if (i < n_vec) dst[i] = r[u];
  }
}

template <typename V>
__global__ void __launch_bounds__(COPY_THREADS)
    scatter_chunks_kernel(char* __restrict__ pages,
                          const char* __restrict__ staging,
                          const int32_t* __restrict__ idx, int64_t n_blocks,
                          int64_t run_bytes, int64_t chunk_bytes) {
  const int64_t m = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * chunk_bytes;
  const int64_t len = run_bytes - lo < chunk_bytes ? run_bytes - lo
                                                    : chunk_bytes;
  const int n_vec = (int)(len / (int64_t)sizeof(V));
  const V* __restrict__ src =
      reinterpret_cast<const V*>(staging + m * run_bytes + lo);
  V r[COPY_VECS];
#pragma unroll
  for (int u = 0; u < COPY_VECS; ++u) {
    const int i = threadIdx.x + u * COPY_THREADS;
    if (i < n_vec) r[u] = src[i];
  }
  const int64_t blk = idx[m];
  if (blk < 0 || blk >= n_blocks) return;
  V* __restrict__ dst = reinterpret_cast<V*>(pages + blk * run_bytes + lo);
#pragma unroll
  for (int u = 0; u < COPY_VECS; ++u) {
    const int i = threadIdx.x + u * COPY_THREADS;
    if (i < n_vec) dst[i] = r[u];
  }
}

// The plan (vector bytes, chunk bytes, chunks per run) must cover each run
// exactly with chunks a thread block copies in one pass, on bases and a
// run length that are multiples of the vector, in a grid that fits:
// grid.x walks the M block ids, grid.y a run's chunks.
static bool split_ok(uintptr_t bases, int64_t m_blocks, int64_t run_bytes,
                     int vec, int64_t chunk_bytes, int64_t n_chunks) {
  if (vec != 16 && vec != 4 && vec != 2) return false;
  if ((bases | (uintptr_t)run_bytes) % vec != 0) return false;
  if (chunk_bytes <= 0 || chunk_bytes % vec != 0 ||
      chunk_bytes / vec > COPY_THREADS * COPY_VECS)
    return false;
  if (m_blocks > 0x7fffffff || n_chunks <= 0 || n_chunks > 65535)
    return false;
  return n_chunks * chunk_bytes >= run_bytes &&
         (n_chunks - 1) * chunk_bytes < run_bytes;
}

#define DEFINE_CHUNK_LAUNCH(NAME, KERNEL, A_T, B_T)                        \
  static int NAME(A_T a, B_T b, const int32_t* idx, int64_t n_blocks,      \
                  int64_t m_blocks, int64_t run_bytes, int vec,             \
                  int64_t chunk_bytes, int64_t n_chunks, cudaStream_t s) {  \
    if (m_blocks <= 0) return 0;                                           \
    if (!split_ok((uintptr_t)a | (uintptr_t)b, m_blocks, run_bytes, vec,   \
                  chunk_bytes, n_chunks))                                  \
      return (int)cudaErrorInvalidValue;                                   \
    const dim3 grid((unsigned)m_blocks, (unsigned)n_chunks);               \
    switch (vec) {                                                         \
      case 16:                                                             \
        KERNEL<uint4><<<grid, COPY_THREADS, 0, s>>>(a, b, idx, n_blocks,   \
                                                    run_bytes, chunk_bytes); \
        break;                                                             \
      case 4:                                                              \
        KERNEL<uint32_t><<<grid, COPY_THREADS, 0, s>>>(                    \
            a, b, idx, n_blocks, run_bytes, chunk_bytes);                  \
        break;                                                             \
      default:                                                             \
        KERNEL<uint16_t><<<grid, COPY_THREADS, 0, s>>>(                    \
            a, b, idx, n_blocks, run_bytes, chunk_bytes);                  \
    }                                                                      \
    return (int)cudaGetLastError();                                        \
  }

DEFINE_CHUNK_LAUNCH(launch_gather_chunks, gather_chunks_kernel, const char*,
                    char*)
DEFINE_CHUNK_LAUNCH(launch_scatter_chunks, scatter_chunks_kernel, char*,
                    const char*)

extern "C" int block_gather(const void* pages, void* staging,
                            const void* idx, int64_t n_blocks,
                            int64_t m_blocks, int64_t run_bytes, int vec,
                            int64_t chunk_bytes, int64_t n_chunks,
                            void* stream) {
  return launch_gather_chunks((const char*)pages, (char*)staging,
                              (const int32_t*)idx, n_blocks, m_blocks,
                              run_bytes, vec, chunk_bytes, n_chunks,
                              (cudaStream_t)stream);
}

extern "C" int block_scatter(void* pages, const void* staging,
                             const void* idx, int64_t n_blocks,
                             int64_t m_blocks, int64_t run_bytes, int vec,
                             int64_t chunk_bytes, int64_t n_chunks,
                             void* stream) {
  return launch_scatter_chunks((char*)pages, (const char*)staging,
                               (const int32_t*)idx, n_blocks, m_blocks,
                               run_bytes, vec, chunk_bytes, n_chunks,
                               (cudaStream_t)stream);
}
