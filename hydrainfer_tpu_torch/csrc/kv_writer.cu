// K3: paged KV write with the int8 quantize and the K/V interleave fused in.
//
// Replaces hydrainfer_tpu/ops/pallas/kv_writer.py:write_kv_pages (the TPU DMA
// writer), together with the int8 quantize of models/decoder.py:_write_kv
// (clip(round(x / kv_scale), -127, 127)) and the K/V interleave of
// ops/cache_ops.py:write_kv_cache. One block per token row: it reads the row's
// K and V heads once, quantizes or casts them, and stores them interleaved
// (K at even combined heads, V at odd) into the row's slot of the layer's
// pages, in place. A slot below 0 is a padded token and is dropped. With a
// null v the write is single-plane: the row's n_kv_heads planes of k are
// stored as they are, with the same quantize (the MLA latent cache: one
// [c_kv | k_pe] vector per token, the JAX MLA layer's quantize plus
// ops/cache_ops.py:write_token_cache).
//
// Bound on H100: bytes. It reads T*2*KVH*D inputs and writes the same count of
// cache elements, with no reuse; the TPU kernel's whole-page/single-row DMA
// plan is a TPU artefact and is not carried over.
#include "common.cuh"

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

template <typename IN, typename OUT>
__global__ void kv_write_kernel(const IN* __restrict__ k, const IN* __restrict__ v,
                                long long k_row_stride, long long v_row_stride,
                                const int32_t* __restrict__ slot_ids,
                                OUT* __restrict__ pages, int n_kv_heads,
                                int head_dim, float scale) {
  const int t = blockIdx.x;
  const int slot = slot_ids[t];
  if (slot < 0) return;
  const IN* krow = k + t * k_row_stride;
  if (v == nullptr) {  // single plane: the row as it is
    const int n = n_kv_heads * head_dim;
    OUT* dst = pages + static_cast<long long>(slot) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = store_kv<OUT>(to_f32(krow[i]), scale);
    return;
  }
  const int ckv = 2 * n_kv_heads;
  const int n = ckv * head_dim;
  OUT* dst = pages + static_cast<long long>(slot) * n;
  const IN* vrow = v + t * v_row_stride;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / head_dim;
    const int e = i - c * head_dim;
    const IN* src = (c & 1) ? vrow : krow;
    dst[i] = store_kv<OUT>(to_f32(src[(c >> 1) * head_dim + e]), scale);
  }
}

template <typename IN, typename OUT>
static void launch(const void* k, const void* v, long long ks, long long vs,
                   const void* slots, void* pages, int n_tokens, int kvh, int d,
                   float scale, cudaStream_t stream) {
  kv_write_kernel<IN, OUT><<<n_tokens, 128, 0, stream>>>(
      static_cast<const IN*>(k), static_cast<const IN*>(v), ks, vs,
      static_cast<const int32_t*>(slots), static_cast<OUT*>(pages), kvh, d, scale);
}

template <typename IN>
static int dispatch_out(const void* k, const void* v, long long ks, long long vs,
                        const void* slots, void* pages, int n_tokens, int kvh,
                        int d, int cache_dtype, float scale, cudaStream_t stream) {
  switch (cache_dtype) {
    case kF32: launch<IN, float>(k, v, ks, vs, slots, pages, n_tokens, kvh, d, scale, stream); break;
    case kBF16: launch<IN, __nv_bfloat16>(k, v, ks, vs, slots, pages, n_tokens, kvh, d, scale, stream); break;
    case kI8: launch<IN, int8_t>(k, v, ks, vs, slots, pages, n_tokens, kvh, d, scale, stream); break;
    default: return -1;
  }
  return launch_status();
}

extern "C" int hydra_kv_write(const void* k, const void* v, long long k_row_stride,
                              long long v_row_stride, const void* slot_ids,
                              void* pages, int n_tokens, int n_kv_heads,
                              int head_dim, int in_dtype, int cache_dtype,
                              float scale, void* stream) {
  if (n_tokens <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32:
      return dispatch_out<float>(k, v, k_row_stride, v_row_stride, slot_ids, pages,
                                 n_tokens, n_kv_heads, head_dim, cache_dtype, scale, s);
    case kBF16:
      return dispatch_out<__nv_bfloat16>(k, v, k_row_stride, v_row_stride, slot_ids,
                                         pages, n_tokens, n_kv_heads, head_dim,
                                         cache_dtype, scale, s);
    default:
      return -1;
  }
}
