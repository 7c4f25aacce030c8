// K2: ragged mixed prefill + decode paged attention (combined-head K/V cache).
//
// Replaces hydrainfer_tpu/ops/pallas/paged_attention.py:layered_paged_attention
// in its CKV-even form: T flattened query tokens grouped into sequences by
// cu_q_lens; token t of sequence s sits at cache position
// kv_len - q_len + (t - cu_q_lens[s]) and attends causally to its sequence's
// pages (K at even combined heads, V at odd), dequantized with one static
// scale for an int8 cache. The TPU kernel's whole-multi-layer-cache operand
// is a TPU workaround: here the layer's pages are a plain view.
//
// Bound on H100: bytes at the serving paths' shapes (each K/V row a batch
// needs, read once, against 4 x Hq x D flops per visible (query, kv) pair:
// the operations bound lies below the bytes bound at both paths). In practice
// a block is bound by latency: it walks a few 64-row kv tiles of one
// sequence, and waits on page-table lookups and HBM round trips.
//
// bf16 queries over an int8 or bf16 cache (what the serving paths run) take
// the tensor-core path. A block owns 64 query rows that share one kv head:
// the (token, query head of the group) pairs of up to 64 / ratio consecutive
// tokens of one sequence, so a staged kv tile serves 64 rows under MHA and 60
// at GQA 6:1. Four warps take one m16 strip each and walk the sequence's
// pages in tiles of 64 kv rows, up to the causal limit of the block's last
// token:
// - staging: a token's K and V rows of one kv head are 2 x D contiguous
//   elements. They are copied in 16-byte cp.async pieces into a ring of two
//   stages, so tile j + 1 is in flight while tile j is multiplied. Rows past
//   the limit are zero-filled, so NaN in unused pages cannot reach P.V. An
//   int8 cache lands raw in the ring, and each thread converts the pieces it
//   copied into one bf16 tile (|x| <= 127 is exact in bf16); a bf16 cache is
//   multiplied from the ring as it lands. The page-table entries a block
//   needs are read once, into shared memory.
// - products: Q.K^T and P.V on mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   K's B fragments come through ldmatrix, V's through ldmatrix.trans from
//   the same row-major tile, and P is re-packed from the score accumulators
//   as P.V's A operand. k_scale folds into the softmax scale and v_scale into
//   the output, in f32. Only kv tiles that cross the causal diagonal are
//   masked element by element.
// - tiles: sequence s's tiles take grid slots from cu_q_lens[s] / bq + s on
//   (monotone in s), so a block finds its sequence by a binary search over
//   cu_q_lens, and slots between two sequences' tiles exit at once. The
//   blocks after the slots zero the padding rows past cu_q_lens[num_seqs]:
//   the output needs no memset.
// D is a multiple of 16 up to 128.
//
// f32 queries (the f32 correctness configuration), and bf16 queries over an
// f32 cache, take an FMA path in shared memory: 16 / ratio tokens a block
// found by a serial scan of cu_q_lens, scalar products, loads not overlapped
// with compute. Its output rows past the last sequence are left as the
// wrapper's zeros.
#include "common.cuh"

#include <type_traits>

namespace {

// ------------------------------------------------ bf16 q: tensor-core path

constexpr int kRows = 64;          // query rows per block
constexpr int kKv = 64;            // kv rows per tile
constexpr int kMmaThreads = 128;   // four warps, one m16 strip each
constexpr int kPad = 8;            // bf16 tile row padding (16 bytes): conflict-free ldmatrix

template <int D, typename KVT>
struct MmaLayout {
  static constexpr bool kInt8 = std::is_same<KVT, int8_t>::value;
  static constexpr int TP = 2 * D + kPad;          // bf16 tile row: K | V | padding
  static constexpr int EPP = 16 / sizeof(KVT);     // cache elements per 16-byte piece
  static constexpr int PPT = 2 * D / EPP;          // pieces per token
  static constexpr int TILE = kKv * TP * 2;        // bytes of one bf16 tile
  static constexpr int RAW = kKv * 2 * D;          // bytes of one raw int8 tile
  // int8: raw[2] then one bf16 tile; bf16: a ring of two bf16 tiles
  static constexpr int RING = kInt8 ? 2 * RAW + TILE : 2 * TILE;
};

// One kv tile (K | V rows of stride TP from kv, cache positions from k0) for
// a warp's strip: S = Q K^T, the causal mask where kMask (a tile below the
// diagonal carries no mask code), an online softmax per row, O += P V.
template <int D, bool kMask>
__device__ __forceinline__ void paged_tile(float (&o)[D / 8][4], float& m_a, float& m_b,
                                           float& l_a, float& l_b,
                                           const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16* kv, int k0, bool ok_a,
                                           bool ok_b, int lim_a, int lim_b, float scale_log2) {
  constexpr int TP = 2 * D + kPad;
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int NT_S = kKv / 8;      // n-tiles of a 16 x 64 score strip
  constexpr int NT_O = D / 8;        // n-tiles of a 16 x D output strip
  const int lane = threadIdx.x & 31, t4 = lane & 3, mat = lane >> 3, mrow = lane & 7;
  // S = Q K^T for this warp's 16 rows x 64 kv rows
  float s[NT_S][4];
#pragma unroll
  for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[ni][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n2 = 0; n2 < NT_S / 2; ++n2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kv + (n2 * 16 + mrow + (mat >> 1) * 8) * TP + ks * 16 + (mat & 1) * 8);
      mma_bf16(s[2 * n2], qf[ks], kb[0], kb[1]);
      mma_bf16(s[2 * n2 + 1], qf[ks], kb[2], kb[3]);
    }
  }
  // the causal mask, then an online softmax per row in log2 units (the
  // running max m is kept scaled)
  if constexpr (kMask) {
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = k0 + ni * 8 + t4 * 2 + (e & 1);
        if (!(e < 2 ? ok_a && pos <= lim_a : ok_b && pos <= lim_b)) s[ni][e] = -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int ni = 0; ni < NT_S; ++ni) {
    mx_a = fmaxf(mx_a, fmaxf(s[ni][0], s[ni][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[ni][2], s[ni][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
  // nothing visible yet: subtract 0 so 2^-inf stays 0 and not NaN
  const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
  const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
  const float al_a = fast_exp2(m_a - mu_a), al_b = fast_exp2(m_b - mu_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int ni = 0; ni < NT_S; ++ni) {
    s[ni][0] = fast_exp2(fmaf(s[ni][0], scale_log2, -mu_a));
    s[ni][1] = fast_exp2(fmaf(s[ni][1], scale_log2, -mu_a));
    s[ni][2] = fast_exp2(fmaf(s[ni][2], scale_log2, -mu_b));
    s[ni][3] = fast_exp2(fmaf(s[ni][3], scale_log2, -mu_b));
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
  // O += P V: the score accumulators are P's A fragments, V's B fragments
  // come from the tile's V half through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < kKv / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const __nv_bfloat16* vrow = kv + (kk * 16 + (mat & 1) * 8 + mrow) * TP + D + (mat >> 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < NT_O / 2; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + n2 * 16);
      mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
      mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
    }
  }
}

// The minimum of one block an SM keeps ptxas from trimming registers toward a
// higher occupancy, which spilled at some D; the staging loops have
// compile-time trip counts (kKv * PPT is a multiple of the block).
template <int D, typename KVT>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
                           const int32_t* __restrict__ kv_lens,
                           const int32_t* __restrict__ page_indices,
                           const int32_t* __restrict__ cu_q_lens,
                           const int32_t* __restrict__ num_seqs_ptr,
                           __nv_bfloat16* __restrict__ out, int n_tokens, int n_heads,
                           int n_kv_heads, int block_size, int pages_per_seq, int n_slots,
                           float scale_log2, float v_scale) {
  using L = MmaLayout<D, KVT>;
  constexpr int TP = L::TP, EPP = L::EPP, PPT = L::PPT;
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int NT_O = D / 8;        // n-tiles of a 16 x D output strip
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* raw = reinterpret_cast<int8_t*>(smem_raw);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw + (L::kInt8 ? 2 * L::RAW : 0));
  int* tbl = reinterpret_cast<int*>(smem_raw + L::RING);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.x;
  const int ratio = n_heads / n_kv_heads;
  const int bq = kRows / ratio;      // tokens per block
  const int ns = num_seqs_ptr[0];

  if (b >= n_slots) {
    // zero kRows padding tokens past the last sequence, this kv head's heads
    const int t0 = cu_q_lens[ns] + (b - n_slots) * kRows;
    const int per_tok = ratio * D / 8;
    for (int i = tid; i < kRows * per_tok; i += kMmaThreads) {
      const int tok = i / per_tok, c = i - tok * per_tok;
      if (t0 + tok < n_tokens)
        *reinterpret_cast<uint4*>(out + (static_cast<long long>(t0 + tok) * n_heads +
                                         kvh * ratio) * D + c * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  if (ns <= 0) return;
  // the last sequence whose first slot is at or before b
  int lo = 0, hi = ns - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cu_q_lens[mid] / bq + mid <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int seq = lo;
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int local0 = (b - (q_start / bq + seq)) * bq;
  if (local0 >= q_len) return;                   // a slot between two sequences' tiles
  const int kv_len = kv_lens[seq];
  const int n_tok = min(bq, q_len - local0);
  const int ctx0 = kv_len - q_len + local0;      // cache position of the first token
  const int kv_end = min(kv_len, ctx0 + n_tok);  // causal limit of the last token
  const int n_tiles = (kv_end + kKv - 1) / kKv;
  const int32_t* table = page_indices + static_cast<long long>(seq) * pages_per_seq;
  const int n_pages = min(pages_per_seq, (kv_end + block_size - 1) / block_size);
  for (int p = tid; p < n_pages; p += kMmaThreads) tbl[p] = table[p];

  // this thread's two rows of the warp's strip: g and g + 8
  const int r_a = warp * 16 + g, r_b = r_a + 8;
  const int tok_a = r_a / ratio, tok_b = r_b / ratio;
  const bool ok_a = tok_a < n_tok, ok_b = tok_b < n_tok;
  const long long row_a = (static_cast<long long>(q_start + local0 + tok_a) * n_heads +
                           kvh * ratio + r_a % ratio) * D;
  const long long row_b = (static_cast<long long>(q_start + local0 + tok_b) * n_heads +
                           kvh * ratio + r_b % ratio) * D;
  const int lim_a = ctx0 + tok_a, lim_b = ctx0 + tok_b;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + t4 * 2;
    qf[ks][0] = ok_a ? ld32(q + row_a + col) : 0u;
    qf[ks][1] = ok_b ? ld32(q + row_b + col) : 0u;
    qf[ks][2] = ok_a ? ld32(q + row_a + col + 8) : 0u;
    qf[ks][3] = ok_b ? ld32(q + row_b + col + 8) : 0u;
  }
  __syncthreads();  // the page-table entries

  const long long tok_stride = 2LL * n_kv_heads * D;  // cache elements per token slot
  const KVT* head = pages + 2LL * kvh * D;
  // Issues kv tile `tile` into ring stage `st`: 16-byte pieces, rows past the
  // causal limit zero-filled.
  auto issue = [&](int tile, int st) {
#pragma unroll
    for (int it = 0; it < kKv * PPT / kMmaThreads; ++it) {
      const int i = tid + it * kMmaThreads;
      const int j = i / PPT, c = i - j * PPT;
      const int pos = tile * kKv + j;
      const bool live = pos < kv_end;
      const KVT* src = head;
      if (live)
        src += (static_cast<long long>(tbl[pos / block_size]) * block_size + pos % block_size) *
                   tok_stride + c * EPP;
      void* dst = L::kInt8 ? static_cast<void*>(raw + st * L::RAW + j * 2 * D + c * 16)
                           : static_cast<void*>(tiles + st * (L::TILE / 2) + j * TP + c * 8);
      cp_async16(dst, src, live ? 16 : 0);
    }
  };

  float o[NT_O][4];
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kKv;
    cp_async_wait<0>();  // this thread's pieces of tile jt
    __syncthreads();     // everyone's pieces landed; tile jt - 1 no longer read
    if (jt + 1 < n_tiles) issue(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* kv;
    if constexpr (L::kInt8) {
      // convert the pieces this thread copied (the raw stage is private to it)
      const int8_t* src = raw + (jt & 1) * L::RAW;
#pragma unroll
      for (int it = 0; it < kKv * PPT / kMmaThreads; ++it) {
        const int i = tid + it * kMmaThreads;
        const int j = i / PPT, c = i - j * PPT;
        int8x16_to_bf16(src + j * 2 * D + c * 16, tiles + j * TP + c * 16);
      }
      __syncthreads();
      kv = tiles;
    } else {
      kv = tiles + (jt & 1) * (L::TILE / 2);
    }

    if (k0 + kKv <= ctx0 + 1)   // every row sees the whole tile
      paged_tile<D, false>(o, m_a, m_b, l_a, l_b, qf, kv, k0, ok_a, ok_b, lim_a, lim_b,
                           scale_log2);
    else
      paged_tile<D, true>(o, m_a, m_b, l_a, l_b, qf, kv, k0, ok_a, ok_b, lim_a, lim_b,
                          scale_log2);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a > 0.0f ? __fdividef(v_scale, l_a) : 0.0f;
  const float inv_b = l_b > 0.0f ? __fdividef(v_scale, l_b) : 0.0f;
#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni) {
    const int col = ni * 8 + t4 * 2;
    if (ok_a)
      *reinterpret_cast<uint32_t*>(out + row_a + col) =
          pack_bf16(o[ni][0] * inv_a, o[ni][1] * inv_a);
    if (ok_b)
      *reinterpret_cast<uint32_t*>(out + row_b + col) =
          pack_bf16(o[ni][2] * inv_b, o[ni][3] * inv_b);
  }
}

struct Args {
  const void *q, *pages, *kv_lens, *page_indices, *cu_q_lens, *num_seqs;
  void* out;
  int n_tokens, n_seqs, n_heads, n_kv_heads, head_dim, block_size, pages_per_seq;
};

template <int D, typename KVT>
int launch_mma(const Args& a, float scale_log2, float v_scale, cudaStream_t s) {
  const int bq = kRows / (a.n_heads / a.n_kv_heads);
  // sequence s's tiles end at slot cu_q_lens[s + 1] / bq + s at most, so
  // T / bq + S slots hold them all; then one block per 64 padding tokens
  const int n_slots = a.n_tokens / bq + a.n_seqs;
  const dim3 grid(n_slots + (a.n_tokens + kRows - 1) / kRows, a.n_kv_heads);
  const size_t smem = MmaLayout<D, KVT>::RING + sizeof(int) * a.pages_per_seq;
  auto kernel = paged_attention_mma_kernel<D, KVT>;
  static size_t allowed = 48 * 1024;   // raised once per size, not per launch
  const int err = allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<__nv_bfloat16*>(a.out), a.n_tokens, a.n_heads, a.n_kv_heads, a.block_size,
      a.pages_per_seq, n_slots, scale_log2, v_scale);
  return launch_status();
}

template <typename KVT>
int launch_mma_d(const Args& a, float scale_log2, float v_scale, cudaStream_t s) {
  switch (a.head_dim) {
    case 16: return launch_mma<16, KVT>(a, scale_log2, v_scale, s);
    case 32: return launch_mma<32, KVT>(a, scale_log2, v_scale, s);
    case 48: return launch_mma<48, KVT>(a, scale_log2, v_scale, s);
    case 64: return launch_mma<64, KVT>(a, scale_log2, v_scale, s);
    case 80: return launch_mma<80, KVT>(a, scale_log2, v_scale, s);
    case 96: return launch_mma<96, KVT>(a, scale_log2, v_scale, s);
    case 112: return launch_mma<112, KVT>(a, scale_log2, v_scale, s);
    case 128: return launch_mma<128, KVT>(a, scale_log2, v_scale, s);
    default: return -1;
  }
}

// ------------------------------------- f32 q, or an f32 cache: FMA path

constexpr int kThreads = 128;
constexpr int kChunk = 32;

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ pages,
                       const int32_t* __restrict__ kv_lens,
                       const int32_t* __restrict__ page_indices,
                       const int32_t* __restrict__ cu_q_lens,
                       const int32_t* __restrict__ num_seqs_ptr,
                       QT* __restrict__ out, int n_heads, int n_kv_heads,
                       int head_dim, int block_size, int pages_per_seq, int bq,
                       float q_scale, float v_scale) {
  extern __shared__ float smem[];
  const int D = head_dim, DP = head_dim + 1;  // padded stride: no bank conflicts
  const int ratio = n_heads / n_kv_heads;
  const int rows = bq * ratio;
  const int ckv = 2 * n_kv_heads;
  float* qs = smem;                  // rows x DP
  float* acc = qs + rows * DP;       // rows x D
  float* ks = acc + rows * D;        // kChunk x DP
  float* vs = ks + kChunk * DP;      // kChunk x D
  float* ps = vs + kChunk * D;       // rows x kChunk
  float* m = ps + rows * kChunk;     // rows
  float* l = m + rows;               // rows
  float* al = l + rows;              // rows
  __shared__ int s_seq, s_tile;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  if (tid == 0) {
    // map this block to (sequence, q tile): tiles are numbered sequence by
    // sequence; blocks past the last tile have nothing to do
    const int ns = num_seqs_ptr[0];
    int b = blockIdx.x, seq = -1, tile = 0;
    for (int s = 0; s < ns; ++s) {
      const int nt = (cu_q_lens[s + 1] - cu_q_lens[s] + bq - 1) / bq;
      if (b < nt) {
        seq = s;
        tile = b;
        break;
      }
      b -= nt;
    }
    s_seq = seq;
    s_tile = tile;
  }
  __syncthreads();
  const int seq = s_seq;
  if (seq < 0) return;
  const int q_start = cu_q_lens[seq];
  const int q_len = cu_q_lens[seq + 1] - q_start;
  const int kv_len = kv_lens[seq];
  const int local0 = s_tile * bq;
  const int n_tok = min(bq, q_len - local0);
  const int ctx0 = kv_len - q_len + local0;   // cache position of the tile's first token
  const int kv_end = min(kv_len, ctx0 + n_tok);  // causal limit of its last token
  const int32_t* table = page_indices + static_cast<long long>(seq) * pages_per_seq;

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int tok = r / ratio, h = r - tok * ratio;
    float val = 0.0f;
    if (tok < n_tok)
      val = to_f32(q[(static_cast<long long>(q_start + local0 + tok) * n_heads +
                      kvh * ratio + h) * D + d]) * q_scale;
    qs[r * DP + d] = val;
    acc[r * D + d] = 0.0f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int pos = c0 + j;
      float kf = 0.0f, vf = 0.0f;
      if (pos < kv_end) {
        const int page = table[pos / block_size];
        const long long base =
            (static_cast<long long>(page * block_size + pos % block_size) * ckv +
             2 * kvh) * D;
        kf = to_f32(pages[base + d]);
        vf = to_f32(pages[base + D + d]);
      }
      ks[j * DP + d] = kf;
      vs[j * D + d] = vf;
    }
    __syncthreads();
    // scores: consecutive threads take consecutive rows (distinct banks via DP)
    for (int i = tid; i < rows * kChunk; i += kThreads) {
      const int j = i / rows, r = i - j * rows;
      const int tok = r / ratio;
      const int pos = c0 + j;
      float s = -INFINITY;
      if (tok < n_tok && pos < kv_end && pos <= ctx0 + tok) {
        const float* qr = qs + r * DP;
        const float* kr = ks + j * DP;
        s = 0.0f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      ps[r * kChunk + j] = s;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float* pr = ps + r * kChunk;
      float mx = m[r];
      for (int j = 0; j < kChunk; ++j) mx = fmaxf(mx, pr[j]);
      if (mx == -INFINITY) {  // nothing visible yet for this row
        for (int j = 0; j < kChunk; ++j) pr[j] = 0.0f;
        al[r] = 1.0f;
        continue;
      }
      const float alpha = expf(m[r] - mx);
      float sum = 0.0f;
      for (int j = 0; j < kChunk; ++j) {
        const float p = pr[j] == -INFINITY ? 0.0f : expf(pr[j] - mx);
        pr[j] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
      al[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * kChunk;
      float a = acc[i] * al[r];
      for (int j = 0; j < kChunk; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int tok = r / ratio, h = r - tok * ratio;
    if (tok >= n_tok) continue;
    const float den = l[r];
    out[(static_cast<long long>(q_start + local0 + tok) * n_heads + kvh * ratio + h) * D +
        d] = from_f32<QT>(den > 0.0f ? acc[i] / den * v_scale : 0.0f);
  }
}

template <typename QT, typename KVT>
int launch(const Args& a, float q_scale, float v_scale, cudaStream_t s) {
  const int ratio = a.n_heads / a.n_kv_heads;
  const int bq = ratio >= 16 ? 1 : 16 / ratio;
  const int rows = bq * ratio;
  const int D = a.head_dim;
  const size_t smem = sizeof(float) * (rows * (D + 1) + rows * D + kChunk * (D + 1) +
                                       kChunk * D + rows * kChunk + 3 * rows);
  auto kernel = paged_attention_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // every sequence contributes at most one partial tile beyond T / bq
  const dim3 grid((a.n_tokens + bq - 1) / bq + a.n_seqs, a.n_kv_heads);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<QT*>(a.out), a.n_heads, a.n_kv_heads, D, a.block_size, a.pages_per_seq,
      bq, q_scale, v_scale);
  return launch_status();
}

}  // namespace

// q (T, Hq, D) f32 or bf16; pages (NB, BS, 2 * KVH, D) f32/bf16/int8; out
// (T, Hq, D) in q's dtype. A bf16 q over an int8 or bf16 cache (D a multiple
// of 16 up to 128) writes every row of out; the FMA path leaves rows past the
// last sequence as they are (the wrapper hands it zeros).
extern "C" int hydra_paged_attention(const void* q, const void* pages,
                                     const void* kv_lens, const void* page_indices,
                                     const void* cu_q_lens, const void* num_seqs,
                                     void* out, int n_tokens, int n_seqs, int n_heads,
                                     int n_kv_heads, int head_dim, int block_size,
                                     int pages_per_seq, float sm_scale, float k_scale,
                                     float v_scale, int q_dtype, int kv_dtype,
                                     void* stream) {
  if (n_tokens <= 0 || n_seqs <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads || n_heads / n_kv_heads > 64) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, pages, kv_lens, page_indices, cu_q_lens, num_seqs, out, n_tokens, n_seqs,
               n_heads, n_kv_heads, head_dim, block_size, pages_per_seq};
  const float q_scale = sm_scale * k_scale;
  if (q_dtype == kBF16 && (kv_dtype == kI8 || kv_dtype == kBF16)) {
    const float scale_log2 = q_scale * 1.4426950408889634f;
    return kv_dtype == kI8 ? launch_mma_d<int8_t>(a, scale_log2, v_scale, s)
                           : launch_mma_d<__nv_bfloat16>(a, scale_log2, v_scale, s);
  }
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float>(a, q_scale, v_scale, s);
  if (q_dtype != kF32) return -1;
  switch (kv_dtype) {
    case kF32: return launch<float, float>(a, q_scale, v_scale, s);
    case kBF16: return launch<float, __nv_bfloat16>(a, q_scale, v_scale, s);
    case kI8: return launch<float, int8_t>(a, q_scale, v_scale, s);
    default: return -1;
  }
}
