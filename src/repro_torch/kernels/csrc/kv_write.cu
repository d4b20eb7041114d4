// KV writes into the paged pool: one decode token per sequence, and one
// suffix chunk per sequence; each either alone or fused with the rotary
// embedding (RoPE) of the layer's queries and keys.
//
// Replaces (Pallas, TPU):
//   kv_token_write, rope_kv_token_write
//       <- src/repro/kernels/kv_write.py:276 kv_token_write
//   kv_chunk_write, rope_kv_chunk_write
//       <- src/repro/kernels/kv_write.py:221 kv_chunk_write
//
// Why the RoPE is inside: the JAX package's serving step is one jitted
// layer scan, so XLA fuses the split-half RoPE of Q and K
// (repro/models/layers.py apply_rope) into one pass beside the Pallas
// write. The port runs its layers eagerly, where that RoPE is about 17
// small kernels per tensor, each with its own launch and host cost. The
// rope_ entries apply it inside the write: one launch per layer, and the
// rotated Q and K never make a round trip through device memory before
// the write.
//
// Bound on the H100: the launch (a few microseconds of host and device
// overhead), then memory: q read and written once, k and v read once and
// written once into the pool (2 KiB per token per tensor at Qwen2.5-14B's
// Hkv=8, D=128 in bf16, 10 KiB of q), plus 4 bytes of slot id, position or
// window metadata per token and the (D/2,) f32 frequency table. The
// rotation is 6 f32 operations per pair of elements, far below the card's
// rate.
//
// Design: a thread block takes one token and up to KVW_HEADS of its head
// slots (query heads, then key heads, then value heads; the plain writes
// have no query heads), as a 2-D block: x
// the 16-byte vectors of a head row (a scalar path where D/2 (rope) or D
// (plain) is not a multiple of the vector width or a base pointer is not
// 16-byte aligned), y the head slot, so no division maps a thread to its
// work. Each thread loads its vector of both halves x1 = x[:D/2] and x2 =
// x[D/2:] of its head row first; while those loads are in flight, the
// token's pool slot is resolved (slots outside the pool, and chunk tokens
// past wcount or outside the row's window pages, are not written) and,
// for the rope entries, the block computes the token's cos and sin of
// each frequency once into shared memory. After the block's barrier (rope
// entries only) each thread rotates q and k and stores q to the output
// and k to the pool; v is copied. Blocks of runs of tokens (one row's
// tokens that share a page) were measured slower on the H100 than one
// token per block, for the plain and the fused chunk writes alike
// (tools/prefill_breakdown.py). Element offsets are int64_t: a pool at
// this model's width with 4096 blocks, and the layer-folded slot ids of
// PagedKVCache.write_tokens, pass INT32_MAX elements. The TPU kernel
// revisits whole pages through aliased grid steps; here each token touches
// only its own row, so tokens that share a page need no ordering. Several
// padded decode rows may write the scratch slot at once: dead memory.
//
// Exactness: the rotation reproduces the plain version's torch ops on the
// card bit for bit: angle = float(pos) * freq, cosf / sinf (not the
// __cosf / __sinf intrinsics), x1*cos - x2*sin and x2*cos + x1*sin with
// each product, sum and difference rounded on its own (__fmul_rn,
// __fadd_rn and __fsub_rn, which nvcc never contracts into an FMA), and
// one round to nearest even into bf16. The frequency table comes from the
// wrapper, computed by the same torch expression as the plain version's.
#include "common.cuh"

constexpr int KVW_HEADS = 16;     // head slots per block
constexpr int KVW_THREADS = 512;  // most threads per block

template <typename T>
__device__ __forceinline__ T round_rn(float x);
template <>
__device__ __forceinline__ float round_rn<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_rn<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES>
struct RawT;
template <>
struct RawT<16> { using type = uint4; };
template <>
struct RawT<4> { using type = uint32_t; };
template <>
struct RawT<2> { using type = uint16_t; };

// E consecutive elements of type T, loaded and stored as one unit
template <typename T, int E>
struct Chunk {
  using Raw = typename RawT<sizeof(T) * E>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<Raw*>(p) = raw;
  }
  __device__ __forceinline__ T& operator[](int e) {
    return reinterpret_cast<T*>(&raw)[e];
  }
};

struct KvwArgs {
  const void* q;       // (rows, H, D), rope entries only
  void* q_out;         // (rows, H, D), rope entries only
  const void* k_new;   // (rows, Hkv, D)
  const void* v_new;   // (rows, Hkv, D)
  void* k_pool;        // (n_slots, Hkv, D)
  void* v_pool;        // (n_slots, Hkv, D)
  const int32_t* pos;  // (rows,) rope positions, rope entries only
  const float* freqs;  // (D/2,) rope frequencies, rope entries only
  int64_t n_slots;
  int H, Hkv, D;       // H = 0 for the plain writes
};

// The head row of slot s (query heads, then key heads, then value heads;
// the plain writes have no query heads) of row tok: its source, and its
// destination (q_out, or the pool row at slot; null where slot < 0).
template <typename T, bool ROPE>
__device__ __forceinline__ const T* head_src(const KvwArgs& a, int64_t tok,
                                             int s) {
  const int hq = ROPE ? a.H : 0;
  if (s < hq) return static_cast<const T*>(a.q) + (tok * a.H + s) * a.D;
  const bool is_v = s >= hq + a.Hkv;
  const int kh = s - hq - (is_v ? a.Hkv : 0);
  return static_cast<const T*>(is_v ? a.v_new : a.k_new) +
         (tok * a.Hkv + kh) * a.D;
}

template <typename T, bool ROPE>
__device__ __forceinline__ T* head_dst(const KvwArgs& a, int64_t tok, int s,
                                       int64_t slot) {
  const int hq = ROPE ? a.H : 0;
  if (s < hq) return static_cast<T*>(a.q_out) + (tok * a.H + s) * a.D;
  if (slot < 0) return nullptr;
  const bool is_v = s >= hq + a.Hkv;
  const int kh = s - hq - (is_v ? a.Hkv : 0);
  return static_cast<T*>(is_v ? a.v_pool : a.k_pool) +
         (slot * a.Hkv + kh) * a.D;
}

// One block's work: head slot blockIdx.y * blockDim.y + threadIdx.y of
// row tok. Thread (x, y) takes elements [x * E, x * E + E) (and on,
// blockDim.x * E apart) of both halves of the head row (ROPE) or of the
// whole row (plain); no division maps a thread to its work. It loads its
// first vector before it waits for anything else. The token's pool slot
// comes from slot_of() (< 0: not written): plain writes resolve it in
// every thread, with no barrier; ROPE: thread (0, 0) resolves it into
// shared memory and the block computes the token's cos / sin table, cs[f]
// = cos of frequency f (f < D/2), else sin of frequency f - D/2, before
// one barrier.
template <typename T, int E, bool ROPE, typename SlotOf>
__device__ __forceinline__ void write_token(const KvwArgs& a, int64_t tok,
                                            SlotOf slot_of) {
  extern __shared__ float cs[];
  __shared__ int64_t dst;
  const int half = a.D / 2, row = ROPE ? half : a.D;
  const int hq = ROPE ? a.H : 0;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  const bool on = s < hq + 2 * a.Hkv;
  const int c0 = threadIdx.x * E;
  const T* src = head_src<T, ROPE>(a, tok, s);
  Chunk<T, E> x1, x2;
  if (on && c0 < row) {
    x1.load(src + c0);
    if constexpr (ROPE) x2.load(src + half + c0);
  }
  if constexpr (ROPE) {
    if (threadIdx.x == 0 && threadIdx.y == 0) dst = slot_of();
    if (blockIdx.y * blockDim.y < a.H + a.Hkv) {   // a q or k head is here
      const float p = __int2float_rn(a.pos[tok]);
      for (int f = threadIdx.y * blockDim.x + threadIdx.x; f < a.D;
           f += blockDim.x * blockDim.y)
        cs[f] = f < half ? cosf(__fmul_rn(p, a.freqs[f]))
                         : sinf(__fmul_rn(p, a.freqs[f - half]));
    }
    __syncthreads();
  }
  if (!on) return;
  T* out = head_dst<T, ROPE>(a, tok, s, s < hq ? -1 : ROPE ? dst : slot_of());
  if (out == nullptr) return;
  for (int c = c0; c < row; c += blockDim.x * E) {
    if (c != c0) {
      x1.load(src + c);
      if constexpr (ROPE) x2.load(src + half + c);
    }
    if constexpr (ROPE) {
      if (s < a.H + a.Hkv) {                    // q and k heads: rotate
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = to_f32(x1[e]), y = to_f32(x2[e]);
          const float co = cs[c + e], si = cs[half + c + e];
          x1[e] = round_rn<T>(__fsub_rn(__fmul_rn(x, co), __fmul_rn(y, si)));
          x2[e] = round_rn<T>(__fadd_rn(__fmul_rn(y, co), __fmul_rn(x, si)));
        }
      }
      x2.store(out + half + c);
    }
    x1.store(out + c);
  }
}

// Grid (B, head-slot groups): row b's one token goes to slots[b].
template <typename T, int E, bool ROPE>
__global__ void __launch_bounds__(KVW_THREADS)
    kv_token_write_kernel(KvwArgs a, const int32_t* __restrict__ slots) {
  const int64_t b = blockIdx.x;
  write_token<T, E, ROPE>(a, b, [&]() -> int64_t {
    const int64_t slot = slots[b];
    return slot >= 0 && slot < a.n_slots ? slot : -1;
  });
}

// Grid (B, head-slot groups, C): token j of row b goes to in-window
// position wstart + j, page wpages[b, (wstart + j) / bs], while j < wcount.
template <typename T, int E, bool ROPE>
__global__ void __launch_bounds__(KVW_THREADS)
    kv_chunk_write_kernel(KvwArgs a, const int32_t* __restrict__ wpages,
                          const int32_t* __restrict__ wstart,
                          const int32_t* __restrict__ wcount, int chunk,
                          int win_pages, int block_size) {
  const int64_t b = blockIdx.x;
  const int j = blockIdx.z;
  write_token<T, E, ROPE>(a, b * chunk + j, [&]() -> int64_t {
    const int ws = wstart[b];
    if (j >= wcount[b] || ws < 0 || ws > INT32_MAX - j) return -1;
    const int p = ws + j, pi = p / block_size;
    if (pi >= win_pages) return -1;
    const int64_t page = wpages[b * win_pages + pi];
    const int64_t slot = page * block_size + p % block_size;
    return page >= 0 && slot < a.n_slots ? slot : -1;
  });
}

// The launch shape of one call: E-element vectors (16 bytes, or 1 element
// where D/2 (rope) or D (plain) is not a multiple of 16 bytes or a base is
// not 16-byte aligned), head-slot groups, the block (vectors of a head row
// (at most 32), up to KVW_HEADS head slots) and the rope table's dynamic
// shared memory.
struct KvwLaunch {
  bool vec;
  unsigned head_groups;
  dim3 block;
  size_t smem;
};

static KvwLaunch kvw_launch(const KvwArgs& a, int dtype, bool rope) {
  const int ev = dtype == DTYPE_BF16 ? 8 : 4;
  uintptr_t bases = (uintptr_t)a.k_new | (uintptr_t)a.v_new |
                    (uintptr_t)a.k_pool | (uintptr_t)a.v_pool;
  if (rope) bases |= (uintptr_t)a.q | (uintptr_t)a.q_out;
  const int row = rope ? a.D / 2 : a.D;
  KvwLaunch l;
  l.vec = bases % 16 == 0 && row % ev == 0;
  const int n_heads = (rope ? a.H : 0) + 2 * a.Hkv;
  const int bx = min(32, row / (l.vec ? ev : 1));
  const int by = min(min(KVW_HEADS, n_heads), KVW_THREADS / bx);
  l.head_groups = (unsigned)((n_heads + by - 1) / by);
  l.block = dim3(bx, by);
  l.smem = rope ? (size_t)a.D * sizeof(float) : 0;
  return l;
}

#define KVW_DISPATCH(KERNEL, ROPE, dtype, l, grid, s, ...)                    \
  do {                                                                        \
    if ((dtype) == DTYPE_BF16) {                                              \
      if ((l).vec)                                                            \
        KERNEL<__nv_bfloat16, 8, ROPE>                                        \
            <<<grid, (l).block, (l).smem, s>>>(__VA_ARGS__);                  \
      else                                                                    \
        KERNEL<__nv_bfloat16, 1, ROPE>                                        \
            <<<grid, (l).block, (l).smem, s>>>(__VA_ARGS__);                  \
    } else {                                                                  \
      if ((l).vec)                                                            \
        KERNEL<float, 4, ROPE><<<grid, (l).block, (l).smem, s>>>(            \
            __VA_ARGS__);                                                     \
      else                                                                    \
        KERNEL<float, 1, ROPE><<<grid, (l).block, (l).smem, s>>>(            \
            __VA_ARGS__);                                                     \
    }                                                                         \
  } while (0)

static int token_write(const KvwArgs& a, const void* slots, int64_t batch,
                       int dtype, bool rope, void* stream) {
  if (batch <= 0 || a.D <= 0 || a.Hkv <= 0) return 0;
  const KvwLaunch l = kvw_launch(a, dtype, rope);
  const dim3 grid((unsigned)batch, l.head_groups);
  cudaStream_t s = (cudaStream_t)stream;
  if (rope)
    KVW_DISPATCH(kv_token_write_kernel, true, dtype, l, grid, s, a,
                 (const int32_t*)slots);
  else
    KVW_DISPATCH(kv_token_write_kernel, false, dtype, l, grid, s, a,
                 (const int32_t*)slots);
  return (int)cudaGetLastError();
}

static int chunk_write(const KvwArgs& a, const void* wpages,
                       const void* wstart, const void* wcount, int64_t batch,
                       int chunk, int win_pages, int block_size, int dtype,
                       bool rope, void* stream) {
  if (batch <= 0 || chunk <= 0 || a.D <= 0 || a.Hkv <= 0) return 0;
  if (chunk > 65535) return (int)cudaErrorInvalidValue;   // grid.z
  const KvwLaunch l = kvw_launch(a, dtype, rope);
  const dim3 grid((unsigned)batch, l.head_groups, (unsigned)chunk);
  cudaStream_t s = (cudaStream_t)stream;
  if (rope)
    KVW_DISPATCH(kv_chunk_write_kernel, true, dtype, l, grid, s, a,
                 (const int32_t*)wpages, (const int32_t*)wstart,
                 (const int32_t*)wcount, chunk, win_pages, block_size);
  else
    KVW_DISPATCH(kv_chunk_write_kernel, false, dtype, l, grid, s, a,
                 (const int32_t*)wpages, (const int32_t*)wstart,
                 (const int32_t*)wcount, chunk, win_pages, block_size);
  return (int)cudaGetLastError();
}

extern "C" int kv_token_write(void* k_pool, void* v_pool, const void* k_new,
                              const void* v_new, const void* slots,
                              int64_t batch, int64_t n_slots, int hkv, int d,
                              int dtype, void* stream) {
  const KvwArgs a{nullptr, nullptr, k_new,   v_new, k_pool, v_pool,
                  nullptr, nullptr, n_slots, 0,     hkv,    d};
  return token_write(a, slots, batch, dtype, false, stream);
}

extern "C" int rope_kv_token_write(const void* q, void* q_out,
                                   const void* k_new, const void* v_new,
                                   void* k_pool, void* v_pool,
                                   const void* slots, const void* positions,
                                   const void* freqs, int64_t batch,
                                   int64_t n_slots, int h, int hkv, int d,
                                   int dtype, void* stream) {
  const KvwArgs a{q,
                  q_out,
                  k_new,
                  v_new,
                  k_pool,
                  v_pool,
                  (const int32_t*)positions,
                  (const float*)freqs,
                  n_slots,
                  h,
                  hkv,
                  d};
  return token_write(a, slots, batch, dtype, true, stream);
}

extern "C" int kv_chunk_write(void* k_pool, void* v_pool, const void* k_new,
                              const void* v_new, const void* wpages,
                              const void* wstart, const void* wcount,
                              int64_t batch, int chunk, int win_pages,
                              int block_size, int64_t n_slots, int hkv, int d,
                              int dtype, void* stream) {
  const KvwArgs a{nullptr, nullptr, k_new,   v_new, k_pool, v_pool,
                  nullptr, nullptr, n_slots, 0,     hkv,    d};
  return chunk_write(a, wpages, wstart, wcount, batch, chunk, win_pages,
                     block_size, dtype, false, stream);
}

extern "C" int rope_kv_chunk_write(
    const void* q, void* q_out, const void* k_new, const void* v_new,
    void* k_pool, void* v_pool, const void* wpages, const void* wstart,
    const void* wcount, const void* positions, const void* freqs,
    int64_t batch, int chunk, int win_pages, int block_size, int64_t n_slots,
    int h, int hkv, int d, int dtype, void* stream) {
  const KvwArgs a{q,
                  q_out,
                  k_new,
                  v_new,
                  k_pool,
                  v_pool,
                  (const int32_t*)positions,
                  (const float*)freqs,
                  n_slots,
                  h,
                  hkv,
                  d};
  return chunk_write(a, wpages, wstart, wcount, batch, chunk, win_pages,
                     block_size, dtype, true, stream);
}
