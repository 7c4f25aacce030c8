// K3: paged KV write with the int8 quantize and the K/V interleave fused in.
//
// Replaces hydrainfer_tpu/ops/pallas/kv_writer.py:write_kv_pages (the TPU DMA
// writer), together with the int8 quantize of models/decoder.py:_write_kv
// (clip(round(x / kv_scale), -127, 127)) and the K/V interleave of
// ops/cache_ops.py:write_kv_cache. Each token row's K and V heads are read
// once, quantized or cast, and stored interleaved (K at even combined heads,
// V at odd) into the row's slot of the layer's pages, in place. A slot below
// 0 is a padded token and is dropped. With a null v the write is
// single-plane: the row's n_kv_heads planes of k are stored as they are, with
// the same quantize (the MLA latent cache: one [c_kv | k_pe] vector per
// token, the JAX MLA layer's quantize plus ops/cache_ops.py:write_token_cache).
//
// Bound on H100: bytes. It reads T*2*KVH*D inputs and writes the same count
// of cache elements, with no reuse. The design spreads that traffic over the
// card: one work item is one input vector of VEC elements (16 bytes where
// the wrapper's plan finds the addresses, row strides and head width
// aligned; 8, 4 or 2 bytes, or one element, otherwise) of one (row, combined
// head), one item a thread, so a decode step of 8 rows x 64 combined heads x
// d128 is 8192 items over 64 blocks instead of 8 blocks that each walk a
// whole row, and a 512-row prefill 4096 blocks. (Four items a thread, their
// loads issued together, was slower at every serving path's decode and
// prefill shape on an H100.) The row, combined head and source offset are
// worked out once per vector, by multiply-and-shift division (Divisor), and
// the store is packed: 8 int8 values as one 8-byte store, bf16 as 16 bytes,
// f32 as 16-byte pieces. A padded row's items read their slot and nothing
// else.
//
// Not carried over: the TPU kernel's plan of whole-page and single-row DMAs
// (hydrainfer_tpu/ops/pallas/kv_writer.py:_write_plan and _writer_kernel).
// Here a row's destination is already one contiguous run (8 KiB at 32 kv
// heads x d128 in int8, 512 B at 2 x d128, 576 B for the latent plane), so
// the per-vector stores of neighbouring threads coalesce without it.
//
// Every element is written once and nothing is allocated or accumulated, so
// two replays of a CUDA graph that captured the launch give identical pages.
#include "common.cuh"

constexpr int THREADS = 128;  // ops/cuda/kv_writer.py:THREADS

// i / d as (i * mul) >> shift, exact for 0 <= i < 2^31; mul and shift come
// from ops/cuda/kv_writer.py:divisor (shift = 31 + ceil(log2 d),
// mul = ceil(2^shift / d)).
struct Divisor {
  unsigned d, mul;
  int shift;
  __device__ __forceinline__ unsigned div(unsigned i) const {
    return static_cast<unsigned>((static_cast<unsigned long long>(i) * mul) >> shift);
  }
};

// VEC elements of one type, aligned to their size, moved as machine words.
template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E v[N];
};
template <int B> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<1> { using T = unsigned char; };

// the pack at p in one load of its width (at most 16 bytes: inputs are)
template <typename P>
__device__ __forceinline__ P load_pack(const void* p) {
  static_assert(sizeof(P) <= 16, "an input vector is at most 16 bytes");
  using W = typename Word<sizeof(P)>::T;
  P x;
  *reinterpret_cast<W*>(&x) = __ldg(reinterpret_cast<const W*>(p));
  return x;
}

// the pack to p in stores of its width, 16-byte pieces above 16 bytes
template <typename P>
__device__ __forceinline__ void store_pack(void* p, const P& x) {
  constexpr int B = sizeof(P) < 16 ? sizeof(P) : 16;
  using W = typename Word<B>::T;
#pragma unroll
  for (int c = 0; c < static_cast<int>(sizeof(P)) / B; ++c)
    reinterpret_cast<W*>(p)[c] = reinterpret_cast<const W*>(&x)[c];
}

template <typename OUT>
__device__ __forceinline__ OUT store_kv(float x, float scale);
template <>
__device__ __forceinline__ float store_kv<float>(float x, float) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_kv<__nv_bfloat16>(float x, float) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ int8_t store_kv<int8_t>(float x, float scale) {
  // IEEE division and round-half-to-even, as jnp.round(x / scale)
  float q = rintf(x / scale);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// n_vec = T * row.d items; row.d = the vectors of a cache row (planes * D /
// VEC), head.d = the vectors of one head (D / VEC).
template <typename IN, typename OUT, int VEC>
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(const IN* __restrict__ k, const IN* __restrict__ v,
                long long k_row_stride, long long v_row_stride,
                const int32_t* __restrict__ slot_ids, OUT* __restrict__ pages,
                int n_vec, Divisor row, Divisor head, int head_dim, float scale) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_vec) return;
  const int t = static_cast<int>(row.div(static_cast<unsigned>(i)));
  const int slot = __ldg(slot_ids + t);
  if (slot < 0) return;  // a padded row: nothing to read or write
  const int j = i - t * static_cast<int>(row.d);
  const IN* src;
  if (v == nullptr) {  // single plane: the row's heads are contiguous
    src = k + t * k_row_stride + j * VEC;
  } else {
    const int c = static_cast<int>(head.div(static_cast<unsigned>(j)));
    const int w = j - c * static_cast<int>(head.d);
    src = (c & 1 ? v + t * v_row_stride : k + t * k_row_stride) + (c >> 1) * head_dim +
          w * VEC;
  }
  const Pack<IN, VEC> x = load_pack<Pack<IN, VEC>>(src);
  Pack<OUT, VEC> y;
#pragma unroll
  for (int e = 0; e < VEC; ++e) y.v[e] = store_kv<OUT>(to_f32(x.v[e]), scale);
  store_pack(pages + static_cast<long long>(slot) * row.d * VEC + j * VEC, y);
}

template <typename IN, typename OUT, int VEC>
static int launch_vec(const void* k, const void* v, long long ks, long long vs,
                      const void* slots, void* pages, int n_vec, Divisor row,
                      Divisor head, int d, int blocks, float scale, cudaStream_t stream) {
  kv_write_kernel<IN, OUT, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const IN*>(k), static_cast<const IN*>(v), ks, vs,
      static_cast<const int32_t*>(slots), static_cast<OUT*>(pages), n_vec, row, head, d,
      scale);
  return launch_status();
}

// VEC in elements: 16, 8, 4 or 2 bytes of input, or one element
template <typename IN, typename OUT>
static int launch(int vec, const void* k, const void* v, long long ks, long long vs,
                  const void* slots, void* pages, int n_vec, Divisor row, Divisor head,
                  int d, int blocks, float scale, cudaStream_t stream) {
#define KV_WRITE_VEC(N)                                                                 \
  case N:                                                                               \
    return launch_vec<IN, OUT, N>(k, v, ks, vs, slots, pages, n_vec, row, head, d, blocks, \
                                  scale, stream);
  if constexpr (sizeof(IN) == 2) {
    switch (vec) { KV_WRITE_VEC(8) KV_WRITE_VEC(4) KV_WRITE_VEC(2) KV_WRITE_VEC(1) }
  } else {
    switch (vec) { KV_WRITE_VEC(4) KV_WRITE_VEC(2) KV_WRITE_VEC(1) }
  }
#undef KV_WRITE_VEC
  return -1;
}

template <typename IN>
static int dispatch_out(int cache_dtype, int vec, const void* k, const void* v,
                        long long ks, long long vs, const void* slots, void* pages,
                        int n_vec, Divisor row, Divisor head, int d, int blocks,
                        float scale, cudaStream_t stream) {
  switch (cache_dtype) {
    case kF32:
      return launch<IN, float>(vec, k, v, ks, vs, slots, pages, n_vec, row, head, d,
                               blocks, scale, stream);
    case kBF16:
      return launch<IN, __nv_bfloat16>(vec, k, v, ks, vs, slots, pages, n_vec, row, head,
                                       d, blocks, scale, stream);
    case kI8:
      return launch<IN, int8_t>(vec, k, v, ks, vs, slots, pages, n_vec, row, head, d,
                                blocks, scale, stream);
    default:
      return -1;
  }
}

// The launch of ops/cuda/kv_writer.py:plan: n_tokens rows of `planes`
// combined heads (2 * n_kv_heads, or n_kv_heads with a null v) x head_dim,
// vec input elements an item, one item a thread, `blocks` blocks;
// (row_mul, row_shift) and (head_mul, head_shift) divide by the vectors of a
// row and of a head.
extern "C" int hydra_kv_write(const void* k, const void* v, long long k_row_stride,
                              long long v_row_stride, const void* slot_ids,
                              void* pages, int n_tokens, int planes, int head_dim,
                              int in_dtype, int cache_dtype, int vec, int blocks,
                              long long row_mul, int row_shift, long long head_mul,
                              int head_shift, float scale, void* stream) {
  if (n_tokens <= 0 || blocks <= 0) return 0;
  if (vec <= 0 || head_dim % vec != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned row_vecs = static_cast<unsigned>(planes * head_dim / vec);
  const Divisor row{row_vecs, static_cast<unsigned>(row_mul), row_shift};
  const Divisor head{static_cast<unsigned>(head_dim / vec), static_cast<unsigned>(head_mul),
                     head_shift};
  const int n_vec = n_tokens * static_cast<int>(row_vecs);
  switch (in_dtype) {
    case kF32:
      return dispatch_out<float>(cache_dtype, vec, k, v, k_row_stride, v_row_stride,
                                 slot_ids, pages, n_vec, row, head, head_dim, blocks,
                                 scale, s);
    case kBF16:
      return dispatch_out<__nv_bfloat16>(cache_dtype, vec, k, v, k_row_stride,
                                         v_row_stride, slot_ids, pages, n_vec, row, head,
                                         head_dim, blocks, scale, s);
    default:
      return -1;
  }
}
