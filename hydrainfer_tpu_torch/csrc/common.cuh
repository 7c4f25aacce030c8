// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes plain C entry points (bound with ctypes from
// hydrainfer_tpu_torch/ops/cuda/build.py). Tensors arrive as raw pointers with
// a dtype code, the stream as a cudaStream_t, and each entry point returns the
// launch's cudaError_t so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with ops/cuda/build.py:DTYPE_CODES
enum DTypeCode { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// ------------------------------------------------- tensor-core building blocks

// D += A.B, m16n8k16, bf16 in, f32 accumulate (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: from a row-major (kv, d) tile, the B fragments of
// two n-tiles of P.V.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x by the special-function unit (2^-inf = 0); the softmax's exponentials.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 int8 values -> 16 bf16 values (exact), two 16-byte shared stores. Each
// byte b becomes the float 2^23 + (b + 128) by placing b ^ 0x80 in the low
// mantissa byte of 2^23; subtracting 2^23 + 128 leaves b exactly. Byte
// permutes and adds run at full rate where an int-to-float conversion does
// not.
__device__ __forceinline__ void int8x16_to_bf16(const int8_t* src, __nv_bfloat16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650 + j)) - 8388736.0f;
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte asynchronous copy global -> shared; `bytes` = 0 writes 16 zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes));
}

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raises a kernel's dynamic shared-memory limit once per size (not per
// launch); fails for more than a block can have.
template <typename K>
int allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  return 0;
}

// ------------------------------------------------------- split-KV (K1, K6)
//
// A decode row's kv range [0, kv_len) is cut into n_splits contiguous
// ranges of ceil(kv_len / n_splits) rows; split i covers [lo, hi), empty
// past the end. n_splits comes from shapes only (the wrappers'
// ops/cuda/split_kv.py:num_splits, which mirrors this arithmetic in
// split_range); the cut itself reads kv_len on the device, so no host sync.
// Each split block leaves, per (row, head), its partial softmax state in f32:
// m (the running max of the scores in log2 units), l (the sum of 2^(s - m))
// and acc[D] (the sum of 2^(s - m) v, unscaled). A split that saw no row
// writes m = -inf, l = 0 and no acc.
__device__ __forceinline__ void split_range(int kv_len, int n_splits, int i, int& lo,
                                            int& hi) {
  const int chunk = (kv_len + n_splits - 1) / n_splits;
  lo = min(kv_len, i * chunk);
  hi = min(kv_len, lo + chunk);
}

// The second launch: out[r] = sum_i acc_i[r] 2^(m_i - M) / sum_i l_i 2^(m_i - M)
// x v_scale, M = max_i m_i, over the splits in a fixed order (deterministic,
// no atomics). Splits with m = -inf are skipped, their acc never read; a row
// whose splits are all empty comes out as zeros, and so, when cu_q_lens is
// given, does every row from cu_q_lens[num_seqs] x heads_per_token on (the
// padding tokens, which no split block wrote).
// acc (n_splits, n_rows, D) f32, ml (n_splits, n_rows, 2) f32 -> out (n_rows, D).
template <typename OutT>
__global__ void __launch_bounds__(256)
split_merge_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                   OutT* __restrict__ out, const int32_t* __restrict__ cu_q_lens,
                   const int32_t* __restrict__ num_seqs, int heads_per_token, int n_rows,
                   int n_splits, int D, float v_scale) {
  const int d4 = D / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_rows) * d4) return;
  const int r = static_cast<int>(i / d4), c = static_cast<int>(i - static_cast<long long>(r) * d4) * 4;
  const int live_end =
      cu_q_lens != nullptr ? cu_q_lens[num_seqs[0]] * heads_per_token : n_rows;
  float M = -INFINITY;
  if (r < live_end)
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, ml[(static_cast<long long>(s) * n_rows + r) * 2]);
  float den = 0.0f, num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (M != -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const long long sr = static_cast<long long>(s) * n_rows + r;
      const float m = ml[sr * 2];
      if (m == -INFINITY) continue;
      const float w = exp2f(m - M);
      den += ml[sr * 2 + 1] * w;
      const float4 a = *reinterpret_cast<const float4*>(acc + sr * D + c);
      num[0] += a.x * w;
      num[1] += a.y * w;
      num[2] += a.z * w;
      num[3] += a.w * w;
    }
  }
  const float inv = den > 0.0f ? v_scale / den : 0.0f;
  OutT* o = out + static_cast<long long>(r) * D + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = from_f32<OutT>(num[k] * inv);
}

template <typename OutT>
int launch_split_merge(const float* acc, const float* ml, void* out, const void* cu_q_lens,
                       const void* num_seqs, int heads_per_token, int n_rows, int n_splits,
                       int D, float v_scale, cudaStream_t s) {
  const long long n = static_cast<long long>(n_rows) * (D / 4);
  const int blocks = static_cast<int>((n + 255) / 256);
  if (blocks == 0) return 0;
  split_merge_kernel<OutT><<<blocks, 256, 0, s>>>(
      acc, ml, static_cast<OutT*>(out), static_cast<const int32_t*>(cu_q_lens),
      static_cast<const int32_t*>(num_seqs), heads_per_token, n_rows, n_splits, D, v_scale);
  return launch_status();
}
