// K1: decode paged attention, one query token per sequence (MHA and GQA).
//
// Replaces hydrainfer_tpu/ops/pallas/mha_decode.py:mha_decode_attention. Row
// i of q is sequence i's query; out[i] = softmax(q_i . K^T * sm_scale) . V over
// the sequence's kv_len cached tokens, read through its block table from the
// combined-head pages (K at even combined heads, V at odd). An int8 cache is
// dequantized with one static scale: k_scale folds into the softmax scale,
// v_scale into the final normalisation. Rows at or past num_seqs, and rows
// with kv_len == 0, come out as zeros. Heads stay in their natural order (the
// TPU kernel's byte-lane head permutation is a TPU artefact).
//
// Bound on H100: bytes (each sequence's K/V of a kv head are read once for
// its R = Hq / Hkv query heads: 2 x D bytes a token at int8, against 4 x R x
// D flops). At the serving paths' shapes the bytes take well under a
// microsecond, so the kernel is bound by latency: how many blocks run at once
// and how long each one's chain of dependent loads and reductions is. One
// block per (sequence, kv head), each warp walking its tokens one at a time
// with a shuffle reduction and two exponentials per query head in series,
// ran 16 blocks at qwen2-vl-2b-lm's GQA 6:1 (8 sequences x 2 kv heads) on 132
// SMs.
//
// bf16 queries over an int8 or bf16 cache take the tensor-core form:
// - split-KV (flash-decoding): block (sequence, kv head, split) takes split i
//   of the sequence's kv range (common.cuh:split_range). The wrapper picks
//   the split count from shapes alone (ops/cuda/split_kv.py:num_splits):
//   one where the (sequence x kv head) grid fills the card (llava-7b-lm's 8
//   x 32 = 256 blocks: no merge launch), else enough for 132 blocks (9 at
//   8 x 2, 144 blocks). With more than one split each block leaves its
//   partial (m, l, acc) in f32 scratch and common.cuh:split_merge_kernel
//   merges them in a fixed order in a second launch.
// - the R query heads of the kv head are one m16 strip (padded to 16 rows):
//   Q.K^T and P.V run on mma.sync m16n8k16 (bf16 in, f32 out), K by ldmatrix
//   and V by ldmatrix.trans from one row-major K | V tile, P re-packed from
//   the score accumulators. The four warps walk interleaved 16-row sub-tiles
//   of the block's range, each an online softmax of its own, merged through
//   shared memory at the end.
// - staging: a token's K and V of one kv head are 2 x D contiguous elements.
//   Each warp copies its sub-tiles in 16-byte cp.async pieces into a ring of
//   two stages of its own (so it needs only warp barriers), sub-tile j + 1 in
//   flight while j is multiplied; rows past the range are zero-filled, so
//   NaN in unused pages never reaches P.V. An int8 cache lands raw and each
//   lane converts its own pieces to bf16 by byte permutes (exact for |x| <=
//   127). The block's page-table entries are read once, into shared memory.
//   Shared memory: a 16 x (D + 8) bf16 Q tile, plus per warp 128 x D + 256
//   B (int8) or 128 x D + 512 B (bf16): 70,912 B at D128, int8.
// D in {32, 64, 128, 256}; R up to 8, MHA (R = 1) included: at llava-7b-lm's
// serve shape it ran faster than the scalar form below.
//
// f32 queries or an f32 cache (the f32 correctness configuration) take the
// scalar form: one block per (sequence, kv head), four warps striding over
// the tokens, D / 32 elements of q, K and V a lane, an online softmax per
// head in f32, the warps' states merged through shared memory.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kMaxRatio = 8;

// ------------------------------------------------- bf16 q: tensor-core form

constexpr int kSub = 16;      // kv rows of a warp's sub-tile
constexpr int kTcWarps = 4;

template <int D, typename KVT>
struct DecodeLayout {
  static constexpr bool kInt8 = std::is_same<KVT, int8_t>::value;
  static constexpr int EPP = 16 / sizeof(KVT);     // cache elements a 16-byte piece
  static constexpr int PPT = 2 * D / EPP;          // pieces a token (K | V)
  static constexpr int TP = 2 * D + 8;             // bf16 tile row: K | V | padding
  static constexpr int SUB = kSub * TP;            // elements of a bf16 sub-tile
  static constexpr int RAW = kSub * 2 * D;         // bytes of a raw int8 sub-tile
  // int8: raw[2] then one bf16 sub-tile; bf16: a ring of two bf16 sub-tiles
  static constexpr int WARP_BYTES = kInt8 ? 2 * RAW + SUB * 2 : 2 * SUB * 2;
  static constexpr int QP = D + 8;                 // Q tile row stride
  static constexpr int OP = D + 4;                 // f32 row stride of the warps' merge
  static constexpr int SMEM = 16 * QP * 2 + kTcWarps * WARP_BYTES;  // + page-table entries
  static_assert((kSub * PPT) % 32 == 0, "a warp's staging loop must divide evenly");
  static_assert(kTcWarps * 16 * OP * 4 <= kTcWarps * WARP_BYTES, "merge scratch fits");
};

template <int D, typename KVT>
__global__ void __launch_bounds__(kTcWarps * 32)
mha_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
                      const int32_t* __restrict__ kv_lens,
                      const int32_t* __restrict__ page_indices,
                      const int32_t* __restrict__ num_seqs, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part_acc, float* __restrict__ part_ml, int n_rows,
                      int n_seqs, int n_heads, int n_kv_heads, int block_size,
                      int pages_per_seq, int n_splits, float scale_log2, float v_scale) {
  using L = DecodeLayout<D, KVT>;
  constexpr int TP = L::TP, PPT = L::PPT, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* warps = smem + 16 * L::QP * 2;
  int* tbl = reinterpret_cast<int*>(warps + kTcWarps * L::WARP_BYTES);
  __shared__ float sm_m[kTcWarps][16], sm_l[kTcWarps][16];

  const int row = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int ratio = n_heads / n_kv_heads;
  const int kv_len = row < num_seqs[0] && row < n_seqs ? kv_lens[row] : 0;
  int k_lo, k_hi;
  split_range(kv_len, n_splits, split, k_lo, k_hi);
  const int n_sub = k_hi > k_lo ? (k_hi - k_lo + kSub - 1) / kSub : 0;
  const int p0 = k_lo / block_size;
  const long long head0 = static_cast<long long>(row) * n_heads + kvh * ratio;

  float o[NT_O][4];
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  if (n_sub > 0) {
    const int32_t* table = page_indices + static_cast<long long>(row) * pages_per_seq;
    for (int p = tid; p < (k_hi - 1) / block_size - p0 + 1; p += kTcWarps * 32)
      tbl[p] = table[p0 + p];
    // the kv head's R query rows, zeros below them
    for (int i = tid; i < 16 * (D / 8); i += kTcWarps * 32) {
      const int r = i / (D / 8), c = i - r * (D / 8);
      *reinterpret_cast<uint4*>(qs + r * L::QP + c * 8) =
          r < ratio ? *reinterpret_cast<const uint4*>(q + (head0 + r) * D + c * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    // this warp's sub-tiles: warp, warp + 4, ... of the block's range
    const int cnt = n_sub > warp ? (n_sub - 1 - warp) / kTcWarps + 1 : 0;
    unsigned char* mine = warps + warp * L::WARP_BYTES;
    int8_t* raw = reinterpret_cast<int8_t*>(mine);
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mine + (L::kInt8 ? 2 * L::RAW : 0));
    const long long tok_stride = 2LL * n_kv_heads * D;  // cache elements a token slot
    const KVT* head = pages + 2LL * kvh * D;
    auto issue = [&](int it, int stage) {
      const int base = k_lo + (warp + it * kTcWarps) * kSub;
#pragma unroll
      for (int u = 0; u < kSub * PPT / 32; ++u) {
        const int i = lane + u * 32;
        const int j = i / PPT, c = i - j * PPT;
        const int pos = base + j;
        const bool live = pos < k_hi;
        const KVT* src = head;
        if (live)
          src += (static_cast<long long>(tbl[pos / block_size - p0]) * block_size +
                  pos % block_size) * tok_stride + c * L::EPP;
        void* dst = L::kInt8 ? static_cast<void*>(raw + stage * L::RAW + j * 2 * D + c * 16)
                             : static_cast<void*>(ring + stage * L::SUB + j * TP + c * 8);
        cp_async16(dst, src, live ? 16 : 0);
      }
    };
    if (cnt > 0) issue(0, 0);
    cp_async_commit();
    for (int it = 0; it < cnt; ++it) {
      const int k0 = k_lo + (warp + it * kTcWarps) * kSub;
      const __nv_bfloat16* kv;
      if constexpr (L::kInt8) {
        if (it + 1 < cnt) issue(it + 1, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();   // this lane's pieces of sub-tile it
        __syncwarp();         // the previous sub-tile is no longer read
#pragma unroll
        for (int u = 0; u < kSub * PPT / 32; ++u) {
          const int i = lane + u * 32;
          const int j = i / PPT, c = i - j * PPT;
          int8x16_to_bf16(raw + (it & 1) * L::RAW + j * 2 * D + c * 16, ring + j * TP + c * 16);
        }
        __syncwarp();
        kv = ring;
      } else {
        cp_async_wait<0>();
        __syncwarp();         // sub-tile it landed; sub-tile it - 1 is no longer read
        if (it + 1 < cnt) issue(it + 1, (it + 1) & 1);
        cp_async_commit();
        kv = ring + (it & 1) * L::SUB;
      }
      // S = Q K^T: 16 (padded) query rows x 16 kv rows
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, qs + (lane & 15) * L::QP + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(kb, kv + (mrow + (mat >> 1) * 8) * TP + ks * 16 + (mat & 1) * 8);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
      // rows past the range, then an online softmax per row in log2 units
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + ni * 8 + t4 * 2 + (e & 1) >= k_hi) s[ni][e] = -INFINITY;
      float mx_a = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
      float mx_b = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // a sub-tile always holds a live row at its start, so mn is finite
      const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float al_a = fast_exp2(m_a - mn_a), al_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        s[ni][0] = fast_exp2(fmaf(s[ni][0], scale_log2, -mn_a));
        s[ni][1] = fast_exp2(fmaf(s[ni][1], scale_log2, -mn_a));
        s[ni][2] = fast_exp2(fmaf(s[ni][2], scale_log2, -mn_b));
        s[ni][3] = fast_exp2(fmaf(s[ni][3], scale_log2, -mn_b));
      }
      l_a = l_a * al_a + (s[0][0] + s[0][1] + s[1][0] + s[1][1]);
      l_b = l_b * al_b + (s[0][2] + s[0][3] + s[1][2] + s[1][3]);
      // O += P V: V's B fragments by ldmatrix.trans from the tile's V half
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const __nv_bfloat16* vrow = kv + ((mat & 1) * 8 + mrow) * TP + D + (mat >> 1) * 8;
#pragma unroll
      for (int n2 = 0; n2 < NT_O / 2; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + n2 * 16);
        o[2 * n2][0] *= al_a;
        o[2 * n2][1] *= al_a;
        o[2 * n2][2] *= al_b;
        o[2 * n2][3] *= al_b;
        o[2 * n2 + 1][0] *= al_a;
        o[2 * n2 + 1][1] *= al_a;
        o[2 * n2 + 1][2] *= al_b;
        o[2 * n2 + 1][3] *= al_b;
        mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
        mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // merge the four warps' states (their staging areas are free now)
  __syncthreads();
  float* os = reinterpret_cast<float*>(warps);   // kTcWarps x 16 x OP
  if (t4 == 0) {
    sm_m[warp][g] = m_a;
    sm_m[warp][g + 8] = m_b;
    sm_l[warp][g] = l_a;
    sm_l[warp][g + 8] = l_b;
  }
  float* ow = os + warp * 16 * L::OP + t4 * 2;
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni) {
    *reinterpret_cast<float2*>(ow + g * L::OP + ni * 8) = make_float2(o[ni][0], o[ni][1]);
    *reinterpret_cast<float2*>(ow + (g + 8) * L::OP + ni * 8) = make_float2(o[ni][2], o[ni][3]);
  }
  __syncthreads();
  for (int i = tid; i < ratio * D; i += kTcWarps * 32) {
    const int r = i / D, d = i - r * D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float den = 0.0f, num = 0.0f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        // a warp that saw no row holds m = -inf and contributes nothing
        if (sm_m[w][r] == -INFINITY) continue;
        const float wgt = exp2f(sm_m[w][r] - M);
        den += sm_l[w][r] * wgt;
        num += os[(w * 16 + r) * L::OP + d] * wgt;
      }
    }
    if (n_splits == 1) {
      out[(head0 + r) * D + d] = __float2bfloat16(den > 0.0f ? num * (v_scale / den) : 0.0f);
    } else {
      const long long pr = static_cast<long long>(split) * n_rows * n_heads + head0 + r;
      if (d == 0) *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(M, den);
      if (M != -INFINITY) part_acc[pr * D + d] = num;
    }
  }
}

template <int D, typename KVT>
int launch_mma(const void* q, const void* pages, const void* kv_lens, const void* page_indices,
               const void* num_seqs, void* out, float* part_acc, float* part_ml, int n_rows,
               int n_seqs, int n_heads, int n_kv_heads, int block_size, int pages_per_seq,
               int n_splits, float scale_log2, float v_scale, cudaStream_t s) {
  const size_t smem = DecodeLayout<D, KVT>::SMEM + sizeof(int) * pages_per_seq;
  auto kernel = mha_decode_mma_kernel<D, KVT>;
  static size_t allowed = 48 * 1024;   // raised once per size, not per launch
  int err = allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<dim3(n_rows, n_kv_heads, n_splits), kTcWarps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(pages),
      static_cast<const int32_t*>(kv_lens), static_cast<const int32_t*>(page_indices),
      static_cast<const int32_t*>(num_seqs), static_cast<__nv_bfloat16*>(out), part_acc,
      part_ml, n_rows, n_seqs, n_heads, n_kv_heads, block_size, pages_per_seq, n_splits,
      scale_log2, v_scale);
  err = launch_status();
  if (err != 0 || n_splits == 1) return err;
  return launch_split_merge<__nv_bfloat16>(part_acc, part_ml, out, nullptr, nullptr, 1,
                                           n_rows * n_heads, n_splits, D, v_scale, s);
}

template <typename KVT>
int launch_mma_d(int head_dim, const void* q, const void* pages, const void* kv_lens,
                 const void* page_indices, const void* num_seqs, void* out, float* part_acc,
                 float* part_ml, int n_rows, int n_seqs, int n_heads, int n_kv_heads,
                 int block_size, int pages_per_seq, int n_splits, float scale_log2,
                 float v_scale, cudaStream_t s) {
#define HYDRA_MHAD_MMA(DD)                                                                \
  case DD:                                                                                \
    return launch_mma<DD, KVT>(q, pages, kv_lens, page_indices, num_seqs, out, part_acc,  \
                               part_ml, n_rows, n_seqs, n_heads, n_kv_heads, block_size,  \
                               pages_per_seq, n_splits, scale_log2, v_scale, s);
  switch (head_dim) {
    HYDRA_MHAD_MMA(32)
    HYDRA_MHAD_MMA(64)
    HYDRA_MHAD_MMA(128)
    HYDRA_MHAD_MMA(256)
    default:
      return -1;
  }
#undef HYDRA_MHAD_MMA
}

// ------------------------------------------ f32 q or an f32 cache: scalar form

constexpr int kWarps = 4;

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ pages,
                  const int32_t* __restrict__ kv_lens,
                  const int32_t* __restrict__ page_indices,
                  const int32_t* __restrict__ num_seqs, QT* __restrict__ out, int n_seqs,
                  int n_heads, int n_kv_heads, int block_size, int pages_per_seq,
                  float q_scale, float v_scale) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sm_m[kWarps][kMaxRatio];
  __shared__ float sm_l[kWarps][kMaxRatio];
  __shared__ float sm_acc[kWarps][kMaxRatio][D];

  const int row = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ratio = n_heads / n_kv_heads;
  const int ckv = 2 * n_kv_heads;
  QT* orow = out + (static_cast<long long>(row) * n_heads + kvh * ratio) * D;
  const int kv_len = row < num_seqs[0] && row < n_seqs ? kv_lens[row] : 0;
  if (kv_len <= 0) {
    for (int i = tid; i < ratio * D; i += blockDim.x) orow[i] = from_f32<QT>(0.0f);
    return;
  }

  float qv[kMaxRatio][EPL];
  const QT* qrow = q + (static_cast<long long>(row) * n_heads + kvh * ratio) * D;
#pragma unroll
  for (int r = 0; r < kMaxRatio; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[r][e] = r < ratio ? to_f32(qrow[r * D + lane * EPL + e]) * q_scale : 0.0f;

  float m[kMaxRatio], l[kMaxRatio], acc[kMaxRatio][EPL];
#pragma unroll
  for (int r = 0; r < kMaxRatio; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
  }

  const int32_t* table = page_indices + static_cast<long long>(row) * pages_per_seq;
  for (int t = warp; t < kv_len; t += kWarps) {
    const int page = table[t / block_size];
    const KVT* base =
        pages + (static_cast<long long>(page * block_size + t % block_size) * ckv +
                 2 * kvh) * D;
    float kk[EPL], vv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kk[e] = to_f32(base[lane * EPL + e]);
      vv[e] = to_f32(base[D + lane * EPL + e]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRatio; ++r) {
      if (r >= ratio) break;
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s = fmaf(qv[r][e], kk[e], s);
      s = warp_sum(s);
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e] * alpha);
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRatio; ++r) {
    if (r >= ratio) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < ratio * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no token holds m = -inf and contributes nothing
      const float wgt = sm_m[w][r] == -INFINITY ? 0.0f : expf(sm_m[w][r] - mx);
      den += sm_l[w][r] * wgt;
      num += sm_acc[w][r][d] * wgt;
    }
    orow[i] = from_f32<QT>(den > 0.0f ? num / den * v_scale : 0.0f);
  }
}

template <typename QT, typename KVT>
int launch_d(const void* q, const void* pages, const void* kv_lens,
             const void* page_indices, const void* num_seqs, void* out, int n_rows,
             int n_seqs, int n_heads, int n_kv_heads, int head_dim, int block_size,
             int pages_per_seq, float q_scale, float v_scale, cudaStream_t s) {
  const dim3 grid(n_rows, n_kv_heads);
#define HYDRA_MHAD_CASE(DD)                                                       \
  case DD:                                                                        \
    mha_decode_kernel<QT, KVT, DD><<<grid, kWarps * 32, 0, s>>>(                  \
        static_cast<const QT*>(q), static_cast<const KVT*>(pages),                \
        static_cast<const int32_t*>(kv_lens),                                     \
        static_cast<const int32_t*>(page_indices),                                \
        static_cast<const int32_t*>(num_seqs), static_cast<QT*>(out), n_seqs,     \
        n_heads, n_kv_heads, block_size, pages_per_seq, q_scale, v_scale);        \
    break;
  switch (head_dim) {
    HYDRA_MHAD_CASE(32)
    HYDRA_MHAD_CASE(64)
    HYDRA_MHAD_CASE(128)
    HYDRA_MHAD_CASE(256)
    default:
      return -1;
  }
#undef HYDRA_MHAD_CASE
  return launch_status();
}

}  // namespace

// q (T, Hq, D) f32 or bf16; pages (NB, BS, 2 * KVH, D) f32/bf16/int8; out
// (T, Hq, D) in q's dtype, every row written. A bf16 q over an int8 or bf16
// cache takes the tensor-core form with n_splits splits, and for n_splits > 1
// part_acc (n_splits, T, Hq, D) and part_ml (n_splits, T, Hq, 2) f32
// scratch; f32 q or an f32 cache the scalar form (n_splits 1).
extern "C" int hydra_mha_decode(const void* q, const void* pages, const void* kv_lens,
                                const void* page_indices, const void* num_seqs, void* out,
                                void* part_acc, void* part_ml, int n_rows, int n_seqs,
                                int n_heads, int n_kv_heads, int head_dim, int block_size,
                                int pages_per_seq, int n_splits, float sm_scale,
                                float k_scale, float v_scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (n_rows <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads || n_heads / n_kv_heads > kMaxRatio ||
      n_splits < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float q_scale = sm_scale * k_scale;
  if (q_dtype == kBF16 && (kv_dtype == kI8 || kv_dtype == kBF16)) {
    const float scale_log2 = q_scale * 1.4426950408889634f;
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
    return kv_dtype == kI8
               ? launch_mma_d<int8_t>(head_dim, q, pages, kv_lens, page_indices, num_seqs,
                                      out, pa, pm, n_rows, n_seqs, n_heads, n_kv_heads,
                                      block_size, pages_per_seq, n_splits, scale_log2,
                                      v_scale, s)
               : launch_mma_d<__nv_bfloat16>(head_dim, q, pages, kv_lens, page_indices,
                                             num_seqs, out, pa, pm, n_rows, n_seqs, n_heads,
                                             n_kv_heads, block_size, pages_per_seq,
                                             n_splits, scale_log2, v_scale, s);
  }
  if (n_splits != 1) return -1;
#define HYDRA_MHAD_SCALAR(QT, KVT)                                                      \
  return launch_d<QT, KVT>(q, pages, kv_lens, page_indices, num_seqs, out, n_rows, n_seqs, \
                           n_heads, n_kv_heads, head_dim, block_size, pages_per_seq,       \
                           q_scale, v_scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32) HYDRA_MHAD_SCALAR(__nv_bfloat16, float)
  if (q_dtype != kF32) return -1;
  switch (kv_dtype) {
    case kF32: HYDRA_MHAD_SCALAR(float, float)
    case kBF16: HYDRA_MHAD_SCALAR(float, __nv_bfloat16)
    case kI8: HYDRA_MHAD_SCALAR(float, int8_t)
    default: return -1;
  }
#undef HYDRA_MHAD_SCALAR
}
