// K5: segment-masked varlen flash attention (ViT towers over concatenated
// images; also the causal form over gathered pages).
//
// Replaces hydrainfer_tpu/ops/pallas/mha_varlen.py:mha_varlen_flash. Per
// head, q row i attends kv row j iff seq_id[i] == kv_seq_id[j] >= 0 and, when
// positions are given, kv_pos[j] <= q_pos[i]; a missing position array counts
// as all zeros, as in the TPU kernel. Rows that see nothing (padding, id -1)
// come out as finite zeros. q (Tq, H, D), k/v (Tk, H, D) and the output
// (Tq, H, D) each have their own row stride (heads contiguous inside a row),
// so V can stay a strided view of a fused qkv projection.
//
// The TPU kernel walks every kv block of every q block on a sequential grid
// with the softmax state in VMEM scratch. Here one block owns one (64-row q
// tile, head); its four warps own 16 q rows each and loop over the kv tiles
// themselves, with the running max, sum and output accumulator in f32
// registers. A small pre-pass records each 64-row tile's smallest and largest
// segment id (and its largest q position / smallest kv position), so a block
// skips every kv tile whose id range cannot meet its own and, on the causal
// leg, every tile wholly in its future; a q tile of padding writes zeros and
// exits. The work stays near sum_i n_i^2 and not T^2, which is what matters
// when a batch of images of different sizes is one long T.
//
// Bound on H100: operations at the ViT's sizes (about 4 * H * D * sum n_i^2
// against 989 TF/s bf16), bytes only at small T. bf16 inputs take the tensor
// cores through mma.sync m16n8k16 (f32 accumulate) for both Q.K^T and P.V;
// f32 inputs (the f32 correctness configuration) take an FMA path in shared
// memory. Neither pipelines its loads (no cp.async/TMA, no wgmma, no warp
// specialisation): that is later work. D is a multiple of 16 up to 128.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kTile = 64;      // q rows per block and kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr int kPad = 8;        // bf16 shared-memory row padding (16 bytes)

// stats[3 * t + {0, 1, 2}] of tile t (q tiles first, then kv tiles): the
// smallest and largest valid segment id, and the largest q position (q tile)
// or the smallest kv position (kv tile) over the valid rows. An empty tile has
// min > max.
__global__ void tile_stats_kernel(const int32_t* __restrict__ q_ids,
                                  const int32_t* __restrict__ kv_ids,
                                  const int32_t* __restrict__ q_pos,
                                  const int32_t* __restrict__ kv_pos, int Tq, int Tk,
                                  int n_q_tiles, int* __restrict__ stats) {
  __shared__ int s_min, s_max, s_pos;
  const int t = blockIdx.x;
  const bool is_q = t < n_q_tiles;
  const int tile = is_q ? t : t - n_q_tiles;
  const int T = is_q ? Tq : Tk;
  const int32_t* ids = is_q ? q_ids : kv_ids;
  const int32_t* pos = is_q ? q_pos : kv_pos;
  if (threadIdx.x == 0) {
    s_min = INT_MAX;
    s_max = INT_MIN;
    s_pos = is_q ? INT_MIN : INT_MAX;
  }
  __syncthreads();
  const int r = tile * kTile + threadIdx.x;
  if (r < T) {
    const int id = ids[r];
    if (id >= 0) {
      atomicMin(&s_min, id);
      atomicMax(&s_max, id);
      const int p = pos != nullptr ? pos[r] : 0;
      if (is_q)
        atomicMax(&s_pos, p);
      else
        atomicMin(&s_pos, p);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[3 * t] = s_min;
    stats[3 * t + 1] = s_max;
    stats[3 * t + 2] = s_pos;
  }
}

// Whether kv tile kt can hold a row visible to q tile qt.
__device__ __forceinline__ bool tile_meets(const int* __restrict__ stats, int qt,
                                           int kt_global) {
  const int q_min = stats[3 * qt], q_max = stats[3 * qt + 1], q_pos = stats[3 * qt + 2];
  const int k_min = stats[3 * kt_global], k_max = stats[3 * kt_global + 1];
  const int k_pos = stats[3 * kt_global + 2];
  return k_min <= k_max && k_max >= q_min && k_min <= q_max && k_pos <= q_pos;
}

template <typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, long long so, int q0, int Tq,
                                          int h, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (q0 + r < Tq) out[static_cast<long long>(q0 + r) * so + h * D + d] = from_f32<T>(0.0f);
  }
}

// ------------------------------------------------------------ bf16, tensor cores

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Loads 8 consecutive bf16 of one row (one 16-byte load when `vec`).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ src, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint4 r;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = src[i];
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_varlen_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       long long sq, long long sk, long long sv, long long so,
                       const int32_t* __restrict__ q_ids, const int32_t* __restrict__ kv_ids,
                       const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
                       const int* __restrict__ stats, int Tq, int Tk, int n_q_tiles,
                       int n_kv_tiles, float scale_log2, bool vec) {
  constexpr int DP = D + kPad;       // Q/K row stride in shared memory
  constexpr int KP = kTile + kPad;   // row stride of the transposed V tile
  constexpr int KS_D = D / 16;       // k-steps of Q.K^T
  constexpr int NT_S = kTile / 8;    // n-tiles of one 16 x 64 score strip
  constexpr int NT_O = D / 8;        // n-tiles of one 16 x D output strip
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kTile x DP
  __nv_bfloat16* Ks = Qs + kTile * DP;                              // kTile x DP
  __nv_bfloat16* Vt = Ks + kTile * DP;                              // D x KP
  int* kid_s = reinterpret_cast<int*>(Vt + D * KP);                 // kTile
  int* kpos_s = kid_s + kTile;                                      // kTile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y;
  const int q0 = qt * kTile;
  if (stats[3 * qt] > stats[3 * qt + 1]) {  // padding rows only
    zero_rows(out, so, q0, Tq, h, D);
    return;
  }

  for (int i = tid; i < kTile * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    const uint4 vals = q0 + r < Tq
                           ? load8(q + static_cast<long long>(q0 + r) * sq + h * D + c, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = vals;
  }
  // this thread's two q rows: g and g + 8 of the warp's 16
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int qid_a = row_a < Tq ? q_ids[row_a] : -1;
  const int qid_b = row_b < Tq ? q_ids[row_b] : -1;
  const int qpos_a = (q_pos != nullptr && row_a < Tq) ? q_pos[row_a] : 0;
  const int qpos_b = (q_pos != nullptr && row_b < Tq) ? q_pos[row_b] : 0;
  __syncthreads();
  uint32_t qf[KS_D][4];
  {
    const __nv_bfloat16* qw = Qs + (warp * 16) * DP;
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      qf[ks][0] = ld32(qw + g * DP + ks * 16 + t4 * 2);
      qf[ks][1] = ld32(qw + (g + 8) * DP + ks * 16 + t4 * 2);
      qf[ks][2] = ld32(qw + g * DP + ks * 16 + t4 * 2 + 8);
      qf[ks][3] = ld32(qw + (g + 8) * DP + ks * 16 + t4 * 2 + 8);
    }
  }

  float o[NT_O][4];
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    if (!tile_meets(stats, qt, n_q_tiles + kt)) continue;  // uniform over the block
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < kTile * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
      const int gr = k0 + r;
      // masked rows read as zeros: garbage there could be NaN
      const bool live = gr < Tk && kv_ids[gr] >= 0;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 k8 = live ? load8(k + static_cast<long long>(gr) * sk + h * D + c, vec) : zero;
      const uint4 v8 = live ? load8(v + static_cast<long long>(gr) * sv + h * D + c, vec) : zero;
      *reinterpret_cast<uint4*>(Ks + r * DP + c) = k8;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * KP + r] = ve[e];
    }
    for (int r = tid; r < kTile; r += kThreads) {
      const int gr = k0 + r;
      kid_s[r] = gr < Tk ? kv_ids[gr] : -1;
      kpos_s[r] = (kv_pos != nullptr && gr < Tk) ? kv_pos[gr] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv rows
    float s[NT_S][4];
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni) {
        const __nv_bfloat16* kr = Ks + (ni * 8 + g) * DP + ks * 16 + t4 * 2;
        mma_bf16(s[ni], qf[ks], ld32(kr), ld32(kr + 8));
      }
    }
    // mask, scale (to log2 units) and the row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + t4 * 2 + (e & 1);
        const bool lo = e < 2;
        const int qid = lo ? qid_a : qid_b;
        const bool ok = qid >= 0 && kid_s[col] == qid && kpos_s[col] <= (lo ? qpos_a : qpos_b);
        const float val = ok ? s[ni][e] * scale_log2 : -INFINITY;
        s[ni][e] = val;
        if (lo)
          mx_a = fmaxf(mx_a, val);
        else
          mx_b = fmaxf(mx_b, val);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // nothing visible yet: subtract 0 so exp2(-inf) stays 0 and not NaN
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni) {
      s[ni][0] = exp2f(s[ni][0] - mu_a);
      s[ni][1] = exp2f(s[ni][1] - mu_a);
      s[ni][2] = exp2f(s[ni][2] - mu_b);
      s[ni][3] = exp2f(s[ni][3] - mu_b);
      sum_a += s[ni][0] + s[ni][1];
      sum_b += s[ni][2] + s[ni][3];
    }
    l_a = l_a * al_a + sum_a;  // per-thread partial sums, reduced at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int ni = 0; ni < NT_O; ++ni) {
      o[ni][0] *= al_a;
      o[ni][1] *= al_a;
      o[ni][2] *= al_b;
      o[ni][3] *= al_b;
    }
    // O += P V: the score accumulators are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int ni = 0; ni < NT_O; ++ni) {
        const __nv_bfloat16* vr = Vt + (ni * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(o[ni], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni) {
    const int col = h * D + ni * 8 + t4 * 2;
    if (row_a < Tq) {
      __nv_bfloat16* dst = out + static_cast<long long>(row_a) * so + col;
      dst[0] = __float2bfloat16(o[ni][0] * inv_a);
      dst[1] = __float2bfloat16(o[ni][1] * inv_a);
    }
    if (row_b < Tq) {
      __nv_bfloat16* dst = out + static_cast<long long>(row_b) * so + col;
      dst[0] = __float2bfloat16(o[ni][2] * inv_b);
      dst[1] = __float2bfloat16(o[ni][3] * inv_b);
    }
  }
}

// ------------------------------------------------------------------ f32, FMA

__global__ void __launch_bounds__(kThreads)
mha_varlen_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, long long sq,
                      long long sk, long long sv, long long so,
                      const int32_t* __restrict__ q_ids, const int32_t* __restrict__ kv_ids,
                      const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
                      const int* __restrict__ stats, int Tq, int Tk, int n_q_tiles,
                      int n_kv_tiles, int D, float sm_scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // padded stride: consecutive rows on distinct banks
  float* qs = smem;                    // kTile x DP
  float* acc = qs + kTile * DP;        // kTile x D
  float* ks = acc + kTile * D;         // kTile x DP
  float* vs = ks + kTile * DP;         // kTile x D
  float* ps = vs + kTile * D;          // kTile x kTile
  float* m = ps + kTile * kTile;       // kTile
  float* l = m + kTile;                // kTile
  float* al = l + kTile;               // kTile
  int* qid = reinterpret_cast<int*>(al + kTile);
  int* qpos = qid + kTile;
  int* kid = qpos + kTile;
  int* kpos = kid + kTile;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y;
  const int q0 = qt * kTile;
  if (stats[3 * qt] > stats[3 * qt + 1]) {
    zero_rows(out, so, q0, Tq, h, D);
    return;
  }
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * DP + d] = q0 + r < Tq ? q[static_cast<long long>(q0 + r) * sq + h * D + d] * sm_scale
                                 : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < kTile; r += kThreads) {
    qid[r] = q0 + r < Tq ? q_ids[q0 + r] : -1;
    qpos[r] = (q_pos != nullptr && q0 + r < Tq) ? q_pos[q0 + r] : 0;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    if (!tile_meets(stats, qt, n_q_tiles + kt)) continue;
    const int k0 = kt * kTile;
    __syncthreads();
    for (int r = tid; r < kTile; r += kThreads) {
      const int gr = k0 + r;
      kid[r] = gr < Tk ? kv_ids[gr] : -1;
      kpos[r] = (kv_pos != nullptr && gr < Tk) ? kv_pos[gr] : 0;
    }
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int gr = k0 + r;
      const bool live = gr < Tk && kv_ids[gr] >= 0;
      ks[r * DP + d] = live ? k[static_cast<long long>(gr) * sk + h * D + d] : 0.0f;
      vs[r * D + d] = live ? v[static_cast<long long>(gr) * sv + h * D + d] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int j = i / kTile, r = i - j * kTile;
      float sc = -INFINITY;
      if (qid[r] >= 0 && kid[j] == qid[r] && kpos[j] <= qpos[r]) {
        const float* qr = qs + r * DP;
        const float* kr = ks + j * DP;
        sc = 0.0f;
        for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      }
      ps[r * kTile + j] = sc;
    }
    __syncthreads();
    for (int r = tid; r < kTile; r += kThreads) {
      float* pr = ps + r * kTile;
      float mx = m[r];
      for (int j = 0; j < kTile; ++j) mx = fmaxf(mx, pr[j]);
      if (mx == -INFINITY) {
        for (int j = 0; j < kTile; ++j) pr[j] = 0.0f;
        al[r] = 1.0f;
        continue;
      }
      const float alpha = expf(m[r] - mx);
      float sum = 0.0f;
      for (int j = 0; j < kTile; ++j) {
        const float p = pr[j] == -INFINITY ? 0.0f : expf(pr[j] - mx);
        pr[j] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
      al[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * kTile;
      float a = acc[i] * al[r];
      for (int j = 0; j < kTile; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (q0 + r >= Tq) continue;
    const float den = l[r];
    out[static_cast<long long>(q0 + r) * so + h * D + d] = den > 0.0f ? acc[i] / den : 0.0f;
  }
}

template <int D>
int launch_bf16(const dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                void* out, long long sq, long long sk, long long sv, long long so,
                const int32_t* q_ids, const int32_t* kv_ids, const int32_t* q_pos,
                const int32_t* kv_pos, const int* stats, int Tq, int Tk, int n_q_tiles,
                int n_kv_tiles, float scale_log2, bool vec) {
  const size_t smem = sizeof(__nv_bfloat16) * (2 * kTile * (D + kPad) + D * (kTile + kPad)) +
                      sizeof(int) * 2 * kTile;
  auto kernel = mha_varlen_bf16_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sv, so,
      q_ids, kv_ids, q_pos, kv_pos, stats, Tq, Tk, n_q_tiles, n_kv_tiles, scale_log2, vec);
  return launch_status();
}

}  // namespace

// stats: int32 scratch of 3 * (ceil(Tq / 64) + ceil(Tk / 64)) entries.
// q_pos / kv_pos may be null (all zeros). dtype: kF32 or kBF16 for q, k, v and
// the output alike.
extern "C" int hydra_mha_varlen(const void* q, const void* k, const void* v, void* out,
                                long long sq, long long sk, long long sv, long long so,
                                const void* q_ids, const void* kv_ids, const void* q_pos,
                                const void* kv_pos, void* stats, int Tq, int Tk, int n_heads,
                                int head_dim, float sm_scale, int dtype, void* stream) {
  if (Tq <= 0 || n_heads <= 0) return 0;
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_q_tiles = (Tq + kTile - 1) / kTile;
  const int n_kv_tiles = Tk > 0 ? (Tk + kTile - 1) / kTile : 0;
  const int32_t* qi = static_cast<const int32_t*>(q_ids);
  const int32_t* ki = static_cast<const int32_t*>(kv_ids);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  int* st = static_cast<int*>(stats);
  tile_stats_kernel<<<n_q_tiles + n_kv_tiles, kTile, 0, s>>>(qi, ki, qp, kp, Tq, Tk, n_q_tiles,
                                                             st);
  const int err = launch_status();
  if (err != 0) return err;
  const dim3 grid(n_q_tiles, n_heads);
  if (dtype == kF32) {
    const int D = head_dim;
    const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + 2 * kTile * D +
                                         kTile * kTile + 3 * kTile) +
                        sizeof(int) * 4 * kTile;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          mha_varlen_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    mha_varlen_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, sv, so, qi, ki, qp, kp,
        st, Tq, Tk, n_q_tiles, n_kv_tiles, D, sm_scale);
    return launch_status();
  }
  if (dtype != kBF16) return -1;
  // 16-byte loads need 16-byte aligned rows
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                   sq % 8 == 0 && sk % 8 == 0 && sv % 8 == 0;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
#define HYDRA_MHA_VARLEN_CASE(DD)                                                         \
  case DD:                                                                                \
    return launch_bf16<DD>(grid, s, q, k, v, out, sq, sk, sv, so, qi, ki, qp, kp, st, Tq, \
                           Tk, n_q_tiles, n_kv_tiles, scale_log2, vec);
  switch (head_dim) {
    HYDRA_MHA_VARLEN_CASE(16)
    HYDRA_MHA_VARLEN_CASE(32)
    HYDRA_MHA_VARLEN_CASE(48)
    HYDRA_MHA_VARLEN_CASE(64)
    HYDRA_MHA_VARLEN_CASE(80)
    HYDRA_MHA_VARLEN_CASE(96)
    HYDRA_MHA_VARLEN_CASE(112)
    HYDRA_MHA_VARLEN_CASE(128)
    default:
      return -1;
  }
#undef HYDRA_MHA_VARLEN_CASE
}
