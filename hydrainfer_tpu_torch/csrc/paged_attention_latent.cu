// K6: latent (MLA) paged attention over a single-plane cache.
//
// Replaces hydrainfer_tpu/ops/pallas/paged_attention.py:layered_paged_attention
// in its CKV = 1 form: every cached row is one [c_kv | k_pe] vector that
// serves as both K and V, so the attention is an MQA of all Hq query heads over
// one plane (D = 512 + 64 = 576 for DeepSeek-V2-Lite). T flattened query tokens
// are grouped into sequences by cu_q_lens; token t of sequence s sits at cache
// position kv_len - q_len + (t - cu_q_lens[s]) and attends causally to its
// sequence's pages. An int8 plane is dequantized with one static scale for
// both roles: the scores take it with the softmax scale and the output once
// more. Rows past cu_q_lens[num_seqs] come out as zeros (the blocks past the
// last tile write them). The TPU kernel's whole-multi-layer-cache operand is a
// TPU workaround: here the layer's pages (NB, BS, 1, D) are a plain view.
//
// Layout of the work. A block owns 16 query rows: the Hq heads of 16 / Hq
// tokens of one sequence (Hq divides 16). At Hq = 16 (mla-2b-lm) a decode
// token is therefore exactly one m16 strip.
// The block walks the sequence's pages in tiles of 64 kv rows up to its
// causal limit, staging each tile in shared memory ONCE, as bf16 (an int8
// plane is converted on the way in, exactly), and reads that same tile for
// Q.K^T and for P.V: the plane is read once for all heads and both roles.
//
// The output accumulator does not fit one warp: 16 rows x 576 f32 would be
// 288 registers a thread. So the four warps split the D columns (144 each).
// Each warp takes the partial Q.K^T over its own columns (mma.sync m16n8k16,
// bf16 in, f32 out), the four partial score strips are summed through shared
// memory in a fixed order (so every warp holds bit-identical scores and runs
// an identical online softmax), and each warp then accumulates P.V for its
// own 144 output columns in registers (72 f32 a thread); V's B fragments come
// from the row-major tile through ldmatrix.trans. A q row sees kv rows up to
// its own cache position; kv rows that are masked or past kv_len are loaded as
// zeros, so garbage (NaN) in unused pages cannot reach P.V.
//
// The bf16 path is built for D = 576 only (mla-2b-lm). f32 queries (the f32
// correctness configuration, any D) take an FMA path in shared memory with
// the same block layout.
//
// Bound on H100: bytes at decode (the plane is read once: kv_len x D bytes a
// sequence, against 4 x Hq x D flops a kv row), operations for long prefill
// chunks. This version is simple: one pass over the kv axis per block (no
// split-KV, so a decode batch of 32 sequences fills 32 of 132 SMs), no
// cp.async/TMA double buffering, no wgmma. Those are later work.
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per block: one m16 strip
constexpr int kKv = 64;        // kv rows per tile (bf16 path)
constexpr int kKvF = 32;       // kv rows per tile (f32 path)
constexpr int kWarps = 4;      // warps per block; they split the D columns
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;        // bf16 shared-memory row padding (16 bytes)

// Finds this block's (sequence, q tile): tiles of bq tokens are numbered
// sequence by sequence. A block past the last tile gets seq -1 and, in tile,
// its index among those blocks (it zeroes that chunk of the padding rows).
__device__ __forceinline__ void find_tile(const int32_t* __restrict__ cu_q_lens,
                                          const int32_t* __restrict__ num_seqs_ptr,
                                          int bq, int* s_seq, int* s_tile) {
  if (threadIdx.x == 0) {
    const int ns = num_seqs_ptr[0];
    int b = blockIdx.x, seq = -1;
    for (int s = 0; s < ns; ++s) {
      const int nt = (cu_q_lens[s + 1] - cu_q_lens[s] + bq - 1) / bq;
      if (b < nt) {
        seq = s;
        break;
      }
      b -= nt;
    }
    *s_seq = seq;
    *s_tile = b;
  }
  __syncthreads();
}

// Zeroes the padding tokens [total + z * bq, + bq).
template <typename QT>
__device__ void zero_padding(QT* __restrict__ out, const int32_t* __restrict__ cu_q_lens,
                             const int32_t* __restrict__ num_seqs_ptr, int z, int bq,
                             int n_tokens, int n_heads, int D) {
  const long long t0 = cu_q_lens[num_seqs_ptr[0]] + z * bq;
  const long long end = min(static_cast<long long>(n_tokens), t0 + bq) * n_heads * D;
  for (long long i = t0 * n_heads * D + threadIdx.x; i < end; i += blockDim.x)
    out[i] = from_f32<QT>(0.0f);
}

// ------------------------------------------------------------ bf16, tensor cores

// Stages 16 bytes of one plane row into the bf16 tile: 8 bf16 values as they
// are, or 16 int8 values converted exactly (|x| <= 127 fits bf16).
__device__ __forceinline__ void stage16(const __nv_bfloat16* __restrict__ src,
                                        __nv_bfloat16* dst, bool live) {
  *reinterpret_cast<uint4*>(dst) =
      live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void stage16(const int8_t* __restrict__ src, __nv_bfloat16* dst,
                                        bool live) {
  uint4 raw = live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint4 lo, hi;
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = pack_bf16(static_cast<float>(b[2 * i]), static_cast<float>(b[2 * i + 1]));
    h[i] = pack_bf16(static_cast<float>(b[8 + 2 * i]), static_cast<float>(b[8 + 2 * i + 1]));
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

template <int DW, typename KVT>
__global__ void __launch_bounds__(kThreads)
latent_bf16_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
                   const int32_t* __restrict__ kv_lens, const int32_t* __restrict__ page_indices,
                   const int32_t* __restrict__ cu_q_lens, const int32_t* __restrict__ num_seqs,
                   __nv_bfloat16* __restrict__ out, int n_tokens, int n_heads, int block_size,
                   int pages_per_seq, float scale_log2, float v_scale) {
  constexpr int D = kWarps * DW;
  constexpr int DP = D + kPad;          // tile row stride (bank-conflict free)
  constexpr int KS = DW / 16;           // k-steps of a warp's share of Q.K^T
  constexpr int NT_S = kKv / 8;         // n-tiles of the 16 x 64 score strip
  constexpr int NT_O = DW / 8;          // n-tiles of a warp's output columns
  constexpr int PER16 = 16 / sizeof(KVT);  // plane elements per 16-byte load
  static_assert(DW % 16 == 0, "a warp's columns must be whole k-steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* lat = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kKv x DP
  float* part = reinterpret_cast<float*>(lat + kKv * DP);  // kWarps x (NT_S*4) x 32
  __shared__ int s_seq, s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hs = n_heads;            // heads of one token in the strip
  const int bq = kRows / hs;         // tokens in the strip
  find_tile(cu_q_lens, num_seqs, bq, &s_seq, &s_tile);
  const int seq = s_seq;
  if (seq < 0) {
    zero_padding(out, cu_q_lens, num_seqs, s_tile, bq, n_tokens, n_heads, D);
    return;
  }
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = kv_lens[seq];
  const int local0 = s_tile * bq;
  const int n_tok = min(bq, q_len - local0);
  const int ctx0 = kv_len - q_len + local0;      // cache position of the strip's first token
  const int kv_end = min(kv_len, ctx0 + n_tok);  // causal limit of its last token
  const int32_t* table = page_indices + static_cast<long long>(seq) * pages_per_seq;

  // this thread's two rows of the strip: g and g + 8
  const int tok_a = g / hs, tok_b = (g + 8) / hs;
  const bool ok_a = tok_a < n_tok, ok_b = tok_b < n_tok;
  const long long row_a = (static_cast<long long>(q_start + local0 + tok_a) * n_heads +
                           g % hs) * D;
  const long long row_b = (static_cast<long long>(q_start + local0 + tok_b) * n_heads +
                           (g + 8) % hs) * D;
  const int lim_a = ctx0 + tok_a, lim_b = ctx0 + tok_b;

  // Q fragments of this warp's columns, straight from global memory
  const int c0 = warp * DW;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = c0 + ks * 16 + t4 * 2;
    qf[ks][0] = ok_a ? ld32(q + row_a + col) : 0u;
    qf[ks][1] = ok_b ? ld32(q + row_b + col) : 0u;
    qf[ks][2] = ok_a ? ld32(q + row_a + col + 8) : 0u;
    qf[ks][3] = ok_b ? ld32(q + row_b + col + 8) : 0u;
  }

  float o[NT_O][4];
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  for (int k0 = 0; k0 < kv_end; k0 += kKv) {
    __syncthreads();  // the previous tile and partials are no longer read
    for (int i = tid; i < kKv * (D / PER16); i += kThreads) {
      const int j = i / (D / PER16), c = (i - j * (D / PER16)) * PER16;
      const int pos = k0 + j;
      const bool live = pos < kv_end;
      const KVT* src = pages;
      if (live)
        src += (static_cast<long long>(table[pos / block_size]) * block_size +
                pos % block_size) * D + c;
      stage16(src, lat + j * DP + c, live);
    }
    __syncthreads();

    // the partial scores over this warp's columns
    float s[NT_S][4];
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni) {
        const __nv_bfloat16* kr = lat + (ni * 8 + g) * DP + c0 + ks * 16 + t4 * 2;
        mma_bf16(s[ni], qf[ks], ld32(kr), ld32(kr + 8));
      }
    }
    // summed across the warps in fragment order (conflict-free, fixed order)
    float* mine = part + warp * (NT_S * 4 * 32);
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(ni * 4 + e) * 32 + lane] = s[ni][e];
    __syncthreads();
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += part[w * (NT_S * 4 * 32) + (ni * 4 + e) * 32 + lane];
        s[ni][e] = acc;
      }

    // mask, scale (to log2 units) and the row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = k0 + ni * 8 + t4 * 2 + (e & 1);
        const bool lo = e < 2;
        const bool vis = pos < kv_end && (lo ? ok_a && pos <= lim_a : ok_b && pos <= lim_b);
        const float val = vis ? s[ni][e] * scale_log2 : -INFINITY;
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
    // O += P V over this warp's columns: the score accumulators are the A
    // fragments of P, the same tile (row-major) gives V through ldmatrix.trans
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = lat + (kk * 16 + (mat & 1) * 8 + mrow) * DP + c0 + (mat >> 1) * 8;
#pragma unroll
      for (int n2 = 0; n2 < NT_O / 2; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + n2 * 16);
        mma_bf16(o[2 * n2], pa, b[0], b[1]);
        mma_bf16(o[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a > 0.0f ? v_scale / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? v_scale / l_b : 0.0f;
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni) {
    const int col = c0 + ni * 8 + t4 * 2;
    if (ok_a)
      *reinterpret_cast<uint32_t*>(out + row_a + col) = pack_bf16(o[ni][0] * inv_a, o[ni][1] * inv_a);
    if (ok_b)
      *reinterpret_cast<uint32_t*>(out + row_b + col) = pack_bf16(o[ni][2] * inv_b, o[ni][3] * inv_b);
  }
}

// ------------------------------------------------------------------ f32, FMA

template <typename KVT>
__global__ void __launch_bounds__(kThreads)
latent_f32_kernel(const float* __restrict__ q, const KVT* __restrict__ pages,
                  const int32_t* __restrict__ kv_lens, const int32_t* __restrict__ page_indices,
                  const int32_t* __restrict__ cu_q_lens, const int32_t* __restrict__ num_seqs,
                  float* __restrict__ out, int n_tokens, int n_heads, int head_dim,
                  int block_size, int pages_per_seq, float q_scale, float v_scale) {
  extern __shared__ float smem[];
  const int D = head_dim, DP = head_dim + 1;  // padded stride: no bank conflicts
  float* qs = smem;                   // kRows x DP
  float* acc = qs + kRows * DP;       // kRows x D
  float* lat = acc + kRows * D;       // kKvF x DP: the plane tile, K and V
  float* ps = lat + kKvF * DP;        // kRows x kKvF
  float* m = ps + kRows * kKvF;       // kRows
  float* l = m + kRows;               // kRows
  float* al = l + kRows;              // kRows
  __shared__ int s_seq, s_tile;

  const int tid = threadIdx.x;
  const int hs = n_heads;
  const int bq = kRows / hs;
  find_tile(cu_q_lens, num_seqs, bq, &s_seq, &s_tile);
  const int seq = s_seq;
  if (seq < 0) {
    zero_padding(out, cu_q_lens, num_seqs, s_tile, bq, n_tokens, n_heads, D);
    return;
  }
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = kv_lens[seq];
  const int local0 = s_tile * bq;
  const int n_tok = min(bq, q_len - local0);
  const int ctx0 = kv_len - q_len + local0;
  const int kv_end = min(kv_len, ctx0 + n_tok);
  const int32_t* table = page_indices + static_cast<long long>(seq) * pages_per_seq;
  const int rows = bq * hs;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int tok = r / hs;
    float val = 0.0f;
    if (r < rows && tok < n_tok)
      val = q[(static_cast<long long>(q_start + local0 + tok) * n_heads + r % hs) * D + d] *
            q_scale;
    qs[r * DP + d] = val;
    acc[r * D + d] = 0.0f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kKvF) {
    __syncthreads();
    for (int i = tid; i < kKvF * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int pos = k0 + j;
      float val = 0.0f;
      if (pos < kv_end)
        val = to_f32(pages[(static_cast<long long>(table[pos / block_size]) * block_size +
                            pos % block_size) * D + d]);
      lat[j * DP + d] = val;
    }
    __syncthreads();
    // scores: consecutive threads take consecutive rows (distinct banks via DP)
    for (int i = tid; i < kRows * kKvF; i += kThreads) {
      const int j = i / kRows, r = i - j * kRows;
      const int tok = r / hs;
      const int pos = k0 + j;
      float sc = -INFINITY;
      if (r < rows && tok < n_tok && pos < kv_end && pos <= ctx0 + tok) {
        const float* qr = qs + r * DP;
        const float* kr = lat + j * DP;
        sc = 0.0f;
        for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      }
      ps[r * kKvF + j] = sc;
    }
    __syncthreads();
    for (int r = tid; r < kRows; r += kThreads) {
      float* pr = ps + r * kKvF;
      float mx = m[r];
      for (int j = 0; j < kKvF; ++j) mx = fmaxf(mx, pr[j]);
      if (mx == -INFINITY) {  // nothing visible yet for this row
        for (int j = 0; j < kKvF; ++j) pr[j] = 0.0f;
        al[r] = 1.0f;
        continue;
      }
      const float alpha = expf(m[r] - mx);
      float sum = 0.0f;
      for (int j = 0; j < kKvF; ++j) {
        const float p = pr[j] == -INFINITY ? 0.0f : expf(pr[j] - mx);
        pr[j] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
      al[r] = alpha;
    }
    __syncthreads();
    // P.V with V = the same tile
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * kKvF;
      float a = acc[i] * al[r];
      for (int j = 0; j < kKvF; ++j) a = fmaf(pr[j], lat[j * DP + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int tok = r / hs;
    if (tok >= n_tok) continue;
    const float den = l[r];
    out[(static_cast<long long>(q_start + local0 + tok) * n_heads + r % hs) * D + d] =
        den > 0.0f ? acc[i] / den * v_scale : 0.0f;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

struct Args {
  const void *q, *pages, *kv_lens, *page_indices, *cu_q_lens, *num_seqs;
  void* out;
  int n_tokens, n_heads, head_dim, block_size, pages_per_seq;
  dim3 grid;
};

template <int DW, typename KVT>
int launch_bf16(const Args& a, float scale_log2, float v_scale, cudaStream_t s) {
  constexpr int D = kWarps * DW;
  const size_t smem = sizeof(__nv_bfloat16) * kKv * (D + kPad) +
                      sizeof(float) * kWarps * (kKv / 8) * 4 * 32;
  auto kernel = latent_bf16_kernel<DW, KVT>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<a.grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<__nv_bfloat16*>(a.out), a.n_tokens, a.n_heads, a.block_size,
      a.pages_per_seq, scale_log2, v_scale);
  return launch_status();
}

template <typename KVT>
int launch_f32(const Args& a, float q_scale, float v_scale, cudaStream_t s) {
  const int D = a.head_dim;
  const size_t smem = sizeof(float) * (kRows * (D + 1) + kRows * D + kKvF * (D + 1) +
                                       kRows * kKvF + 3 * kRows);
  auto kernel = latent_f32_kernel<KVT>;
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<a.grid, kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<float*>(a.out), a.n_tokens, a.n_heads, D, a.block_size, a.pages_per_seq,
      q_scale, v_scale);
  return launch_status();
}

}  // namespace

// q (T, Hq, D) f32 or bf16; pages (NB, BS, 1, D) f32/bf16/int8 (a bf16 q takes
// bf16 or int8 pages and D = 576); out (T, Hq, D) in q's dtype, every row
// written. Hq must divide 16.
extern "C" int hydra_paged_attention_latent(const void* q, const void* pages,
                                            const void* kv_lens, const void* page_indices,
                                            const void* cu_q_lens, const void* num_seqs,
                                            void* out, int n_tokens, int n_seqs, int n_heads,
                                            int head_dim, int block_size, int pages_per_seq,
                                            float sm_scale, float kv_scale, int q_dtype,
                                            int kv_dtype, void* stream) {
  if (n_tokens <= 0) return 0;
  if (n_heads <= 0 || n_heads > kRows || kRows % n_heads) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bq = kRows / n_heads;
  // every sequence contributes at most one partial tile beyond T / bq; the
  // blocks left over zero the padding rows
  Args a{q, pages, kv_lens, page_indices, cu_q_lens, num_seqs, out, n_tokens, n_heads,
         head_dim, block_size, pages_per_seq,
         dim3((n_tokens + bq - 1) / bq + n_seqs)};
  if (q_dtype == kF32) {
    const float q_scale = sm_scale * kv_scale;
    switch (kv_dtype) {
      case kF32: return launch_f32<float>(a, q_scale, kv_scale, s);
      case kBF16: return launch_f32<__nv_bfloat16>(a, q_scale, kv_scale, s);
      case kI8: return launch_f32<int8_t>(a, q_scale, kv_scale, s);
      default: return -1;
    }
  }
  if (q_dtype != kBF16 || head_dim != 576) return -1;
  const float scale_log2 = sm_scale * kv_scale * 1.4426950408889634f;
  switch (kv_dtype) {
    case kBF16: return launch_bf16<144, __nv_bfloat16>(a, scale_log2, kv_scale, s);
    case kI8: return launch_bf16<144, int8_t>(a, scale_log2, kv_scale, s);
    default: return -1;
  }
}
