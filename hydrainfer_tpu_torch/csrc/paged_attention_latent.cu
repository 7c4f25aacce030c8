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
// more. Rows past cu_q_lens[num_seqs] come out as zeros. The TPU kernel's
// whole-multi-layer-cache operand is a TPU workaround: here the layer's pages
// (NB, BS, 1, D) are a plain view.
//
// Bound on H100: bytes. A mixed batch reads its queries and writes its
// outputs, 2 x T x Hq x 576 x 2 bytes (75 MB at 2048 tokens x 16 heads),
// far more than the plane; a decode window reads the plane once (kv_len x
// 576 bytes a sequence, 3.5 MB at 32 sequences). The operations (4 x Hq x
// 576 a visible (token, kv row) pair) lie below the bytes at both paths.
// In practice the decode form is bound by latency (a few kv tiles a
// sequence) and the mixed form by staging and the tensor-core loop.
//
// bf16 queries over an int8 or bf16 plane (what mla-2b-lm serves) take the
// tensor-core forms, D = 576 only. Both stage a plane tile of 32 rows once in
// shared memory, as bf16, and read it for Q.K^T (ldmatrix) and for P.V
// (ldmatrix.trans): the plane is read once for all heads and both roles.
// - tiles: a cp.async ring of two stages, so tile j + 1 is in flight while
//   tile j is multiplied. An int8 plane lands raw (36,864 B for two stages)
//   and each thread converts the pieces it copied into one of two bf16 tiles
//   (2 x 37,376 B; byte permutes, exact for |x| <= 127); a bf16 plane lands
//   in the bf16 tiles as it is. Rows past a block's range are zero-filled,
//   so garbage (NaN, -128) in unused pages never reaches P.V. The queries
//   land by cp.async too (a 584-element row stride: conflict-free ldmatrix)
//   and the block's page-table entries are read once, into shared memory.
// - registers: an output strip of 16 rows x 576 f32 would be 288 registers
//   a thread, so a strip's columns are split over CG warps, each holding
//   16 x (576 / CG) accumulators. Each warp takes the partial Q.K^T over its
//   own columns (mma.sync m16n8k16, bf16 in, f32 out); the CG partial score
//   strips are summed through shared memory in a fixed order (2 KB a warp a
//   tile, one barrier), so every warp of the strip holds bit-identical
//   scores and runs an identical online softmax (log2 units), then
//   accumulates P.V for its own columns. A tile costs two barriers: the
//   tile has landed (after the int8 conversion), and the partials are
//   written. Only tiles that cross a row's causal limit or the range's end
//   carry mask code.
// - mixed form (a batch with prefill chunks, max_q > 1): a block owns 64
//   query rows, the Hq heads of 64 / Hq consecutive tokens of one sequence
//   (4 tokens at Hq = 16), so one staged tile serves 64 rows. 12 warps: 4
//   strips of 16 rows x 3 column groups of 192 (96 accumulators a thread,
//   168 registers at most at 384 threads). Shared memory: 36,864 (raw) +
//   74,752 (bf16 tiles) + 74,752 (Q, 64 x 584 bf16) + 24,576 (partial
//   scores) = 210,944 B, plus 4 B a page-table entry, one block an SM.
//   With one block an SM a block's query reads and output writes (147 KB)
//   do not overlap another block's products, and a block's work grows with
//   its causal prefix (1 to 4 tiles for a 128-token prompt, up to 8 for a
//   decode row): so the slots run in reverse, the longest first, and the
//   output tile goes through the Q tile's shared memory to leave in
//   16-byte stores of whole rows. (On the card, 2 column groups ran no
//   faster and 4 spilled at the 128-register cap of 512 threads.)
//   Sequence s's q tiles take grid slots from cu_q_lens[s] / bq + s on
//   (monotone in s): a block finds its tile by binary search over
//   cu_q_lens, slots between two sequences' tiles exit at once, and the
//   blocks after the slots zero the padding rows.
// - decode form (max_q == 1): split-KV (flash-decoding). Block (s, i)
//   takes split i of sequence s's kv range (common.cuh:split_range), so a
//   window of 32 sequences runs 32 x n_splits blocks (5 splits: 160 on 132
//   SMs) where one block a sequence filled 32. A block is one 16-row strip
//   (the Hq heads of the sequence's token) x 4 column groups of 144
//   (128 threads; 36,864 + 74,752 + 18,688 + 8,192 = 138,496 B). Each split
//   writes its partial (m, l, acc) in f32 to scratch from the wrapper, and
//   common.cuh:split_merge_kernel merges them in a fixed order in a second
//   launch; a split with no rows writes m = -inf and no acc. With one split
//   (>= 132 sequences) the wrapper runs the mixed form.
//
// f32 queries (the f32 correctness configuration, any D) take an FMA path in
// shared memory: 16 query rows a block found by a serial scan of cu_q_lens,
// scalar products, loads not overlapped with compute.
#include "common.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------- bf16, tensor cores

constexpr int kD = 576;          // the bf16 forms' head dim: kv_lora + rope
constexpr int kDP = kD + 8;      // bf16 row stride in shared memory (16 B padding)
constexpr int kKv = 32;          // kv rows a tile
constexpr int kPadTok = 64;      // padding tokens zeroed by one mixed-form block
constexpr int kMixCG = 3;        // the mixed form's column groups (x 4 strips)
constexpr int kMixThreads = 32 * 4 * kMixCG;

template <int STRIPS, int CG, typename KVT>
struct Latent {
  static constexpr bool kInt8 = std::is_same<KVT, int8_t>::value;
  static constexpr int WARPS = STRIPS * CG, THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * STRIPS;      // query rows a block
  static constexpr int DW = kD / CG;             // output columns a warp
  static constexpr int EPP = 16 / sizeof(KVT);   // plane elements a 16-byte piece
  static constexpr int PPR = kD / EPP;           // pieces a plane row
  static constexpr int TILE = kKv * kDP;         // elements of one bf16 tile
  static constexpr int RAW = kKv * kD;           // bytes of one raw int8 tile
  static constexpr int RAWS = kInt8 ? 2 * RAW : 0;
  static constexpr int PART = 16 * kKv;          // floats of one warp's partial scores
  static constexpr int SMEM = RAWS + 2 * TILE * 2 + ROWS * kDP * 2 + WARPS * PART * 4;
  static constexpr int STAGE_IT = kKv * PPR / THREADS;   // a tile's pieces a thread
  static_assert(DW % 16 == 0, "a warp's columns must be whole k-steps");
  static_assert((kKv * PPR) % THREADS == 0 && (ROWS * (kD / 8)) % THREADS == 0,
                "staging loops must have compile-time trip counts");
};

// One block's rows over kv positions [k_lo, k_hi): row r of the block is flat
// query row q_row0 + r (token r / n_heads of the block, head r % n_heads),
// live below n_live, and sees cache positions up to ctx0 + r / n_heads.
// Leaves each thread's rows g and g + 8 of its warp's strip in (o, m, l),
// l summed over the quad: o = sum 2^(s - m) v over its DW columns, m in log2
// units (-inf if the row saw nothing).
template <int STRIPS, int CG, typename KVT>
__device__ __forceinline__ void latent_rows(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
    const int32_t* __restrict__ table, unsigned char* smem, int q_row0, int n_live,
    int ctx0, int k_lo, int k_hi, int n_heads, int block_size, float scale_log2,
    float (&o)[kD / CG / 8][4], float& m_a, float& m_b, float& l_a, float& l_b) {
  using L = Latent<STRIPS, CG, KVT>;
  constexpr int DW = L::DW, KS = DW / 16, NT_O = DW / 8, NT_S = kKv / 8;
  int8_t* raw = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem + L::RAWS);
  __nv_bfloat16* qs = tiles + 2 * L::TILE;
  float* part = reinterpret_cast<float*>(qs + L::ROWS * kDP);
  int* tbl = reinterpret_cast<int*>(part + L::WARPS * L::PART);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int st = warp / CG, c0 = (warp % CG) * DW;
  const int r_a = st * 16 + g, r_b = r_a + 8;
  const bool ok_a = r_a < n_live, ok_b = r_b < n_live;
  const int lim_a = ctx0 + r_a / n_heads, lim_b = ctx0 + r_b / n_heads;

#pragma unroll
  for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.0f;
  m_a = m_b = -INFINITY;
  l_a = l_b = 0.0f;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKv - 1) / kKv : 0;
  if (n_tiles > 0) {
    // the block's query rows, zeros past n_live (in flight while the
    // page-table entries are read)
#pragma unroll
    for (int it = 0; it < L::ROWS * (kD / 8) / L::THREADS; ++it) {
      const int i = tid + it * L::THREADS;
      const int r = i / (kD / 8), c = i - r * (kD / 8);
      const bool live = r < n_live;
      cp_async16(qs + r * kDP + c * 8,
                 q + static_cast<long long>(q_row0 + (live ? r : 0)) * kD + c * 8,
                 live ? 16 : 0);
    }
    const int p0 = k_lo / block_size, n_pages = (k_hi - 1) / block_size - p0 + 1;
    for (int p = tid; p < n_pages; p += L::THREADS) tbl[p] = table[p0 + p];
    __syncthreads();   // the page-table entries

    // Issues tile jt into ring stage `stage`: 16-byte pieces, rows past k_hi
    // zero-filled.
    auto issue = [&](int jt, int stage) {
#pragma unroll
      for (int it = 0; it < L::STAGE_IT; ++it) {
        const int i = tid + it * L::THREADS;
        const int j = i / L::PPR, c = i - j * L::PPR;
        const int pos = k_lo + jt * kKv + j;
        const bool live = pos < k_hi;
        const KVT* src = pages;
        if (live)
          src += (static_cast<long long>(tbl[pos / block_size - p0]) * block_size +
                  pos % block_size) * kD + c * L::EPP;
        void* dst = L::kInt8 ? static_cast<void*>(raw + stage * L::RAW + j * kD + c * 16)
                             : static_cast<void*>(tiles + stage * L::TILE + j * kDP + c * 8);
        cp_async16(dst, src, live ? 16 : 0);
      }
    };
    issue(0, 0);
    cp_async_commit();

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int k0 = k_lo + jt * kKv;
      const __nv_bfloat16* kv = tiles + (jt & 1) * L::TILE;
      if constexpr (L::kInt8) {
        if (jt + 1 < n_tiles) issue(jt + 1, (jt + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();   // this thread's pieces of tile jt (and of Q)
        // convert the pieces this thread copied (the raw stage is private to
        // it); the bf16 tile was last read two tiles ago, before the last
        // partial-score barrier
#pragma unroll
        for (int it = 0; it < L::STAGE_IT; ++it) {
          const int i = tid + it * L::THREADS;
          const int j = i / L::PPR, c = i - j * L::PPR;
          int8x16_to_bf16(raw + (jt & 1) * L::RAW + j * kD + c * 16,
                          tiles + (jt & 1) * L::TILE + j * kDP + c * 16);
        }
        __syncthreads();      // tile jt is in place for every warp
      } else {
        cp_async_wait<0>();
        __syncthreads();      // tile jt landed; tile jt - 1 is no longer read
        if (jt + 1 < n_tiles) issue(jt + 1, (jt + 1) & 1);
        cp_async_commit();
      }

      // the partial scores over this warp's columns
      float s[NT_S][4];
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qs + (st * 16 + (lane & 15)) * kDP + c0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NT_S / 2; ++n2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kv + (n2 * 16 + mrow + (mat >> 1) * 8) * kDP + c0 + ks * 16 +
                              (mat & 1) * 8);
          mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
        }
      }
      // summed over the strip's CG warps in a fixed order (fragment order:
      // conflict-free)
      float* mine = part + warp * L::PART;
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(ni * 4 + e) * 32 + lane] = s[ni][e];
      __syncthreads();
      const float* strip = part + st * CG * L::PART;
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float acc = 0.0f;
#pragma unroll
          for (int w = 0; w < CG; ++w) acc += strip[w * L::PART + (ni * 4 + e) * 32 + lane];
          s[ni][e] = acc;
        }

      // the mask, where a row's causal limit or the range's end cuts the tile
      if (k0 + kKv > min(k_hi, ctx0 + 1)) {
#pragma unroll
        for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = k0 + ni * 8 + t4 * 2 + (e & 1);
            if (!(pos < k_hi && (e < 2 ? ok_a && pos <= lim_a : ok_b && pos <= lim_b)))
              s[ni][e] = -INFINITY;
          }
      }
      // online softmax per row in log2 units (the running max is kept scaled)
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
      l_a = l_a * al_a + sum_a;   // per-thread partial sums, reduced at the end
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int ni = 0; ni < NT_O; ++ni) {
        o[ni][0] *= al_a;
        o[ni][1] *= al_a;
        o[ni][2] *= al_b;
        o[ni][3] *= al_b;
      }
      // O += P V over this warp's columns: the score accumulators are P's A
      // fragments, V's B fragments come from the same tile by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* vrow = kv + (kk * 16 + (mat & 1) * 8 + mrow) * kDP + c0 +
                                    (mat >> 1) * 8;
#pragma unroll
        for (int n2 = 0; n2 < NT_O / 2; ++n2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + n2 * 16);
          mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
          mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
}

// Mixed form: 4 strips x kMixCG column groups, one 64-row q tile a block.
template <typename KVT>
__global__ void __launch_bounds__(kMixThreads, 1)
latent_mixed_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
                    const int32_t* __restrict__ kv_lens,
                    const int32_t* __restrict__ page_indices,
                    const int32_t* __restrict__ cu_q_lens,
                    const int32_t* __restrict__ num_seqs_ptr, __nv_bfloat16* __restrict__ out,
                    int n_tokens, int n_heads, int block_size, int pages_per_seq, int n_slots,
                    float scale_log2, float v_scale) {
  using L = Latent<4, kMixCG, KVT>;
  constexpr int CG = kMixCG, DW = kD / CG;
  extern __shared__ __align__(16) unsigned char smem[];
  // the slots in reverse: a sequence's last q tiles (the longest causal
  // prefixes) and the batch's last sequences (decodes behind prefills) start
  // first, so the longest blocks do not trail the grid
  const int tid = threadIdx.x;
  const int b = blockIdx.x < n_slots ? n_slots - 1 - blockIdx.x : blockIdx.x;
  const int bq = 64 / n_heads;       // tokens a block
  const int ns = num_seqs_ptr[0];
  if (b >= n_slots) {
    // zero kPadTok padding tokens past the last sequence
    const long long t0 = cu_q_lens[ns] + static_cast<long long>(b - n_slots) * kPadTok;
    const long long t1 = min(static_cast<long long>(n_tokens), t0 + kPadTok);
    const long long per_tok = static_cast<long long>(n_heads) * (kD / 8);
    for (long long i = t0 * per_tok + tid; i < t1 * per_tok; i += kMixThreads)
      reinterpret_cast<uint4*>(out)[i] = make_uint4(0u, 0u, 0u, 0u);
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
  const int q_row0 = (q_start + local0) * n_heads;
  const int n_live = n_tok * n_heads;

  float o[DW / 8][4], m_a, m_b, l_a, l_b;
  latent_rows<4, CG, KVT>(q, pages, page_indices + static_cast<long long>(seq) * pages_per_seq,
                          smem, q_row0, n_live, ctx0, 0, min(kv_len, ctx0 + n_tok), n_heads,
                          block_size, scale_log2, o, m_a, m_b, l_a, l_b);

  // the output tile goes through the Q tile's shared memory (every warp
  // read Q before the last partial-score barrier), then out in 16-byte
  // stores of whole rows
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int r_a = (warp / CG) * 16 + g, c0 = (warp % CG) * DW;
  const float inv_a = l_a > 0.0f ? __fdividef(v_scale, l_a) : 0.0f;
  const float inv_b = l_b > 0.0f ? __fdividef(v_scale, l_b) : 0.0f;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem + L::RAWS) + 2 * L::TILE;
  uint32_t* os_a = reinterpret_cast<uint32_t*>(os + r_a * kDP + c0 + t4 * 2);
  uint32_t* os_b = reinterpret_cast<uint32_t*>(os + (r_a + 8) * kDP + c0 + t4 * 2);
#pragma unroll
  for (int ni = 0; ni < DW / 8; ++ni) {
    os_a[ni * 4] = pack_bf16(o[ni][0] * inv_a, o[ni][1] * inv_a);
    os_b[ni * 4] = pack_bf16(o[ni][2] * inv_b, o[ni][3] * inv_b);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < L::ROWS * (kD / 8) / kMixThreads; ++it) {
    const int i = tid + it * kMixThreads;
    const int r = i / (kD / 8), c = i - r * (kD / 8);
    if (r < n_live)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(q_row0 + r) * kD + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * kDP + c * 8);
  }
}

// Decode form: block (s, split) of a window whose sequences hold one query
// token each; 1 strip x 4 column groups; partial states to part_acc/part_ml.
template <typename KVT>
__global__ void __launch_bounds__(128, 1)
latent_split_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pages,
                    const int32_t* __restrict__ kv_lens,
                    const int32_t* __restrict__ page_indices,
                    const int32_t* __restrict__ cu_q_lens,
                    const int32_t* __restrict__ num_seqs_ptr, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int n_tokens, int n_heads, int block_size,
                    int pages_per_seq, int n_splits, float scale_log2) {
  constexpr int CG = 4, DW = kD / CG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int seq = blockIdx.x, split = blockIdx.y;
  if (seq >= num_seqs_ptr[0]) return;
  const int q_start = cu_q_lens[seq];
  if (cu_q_lens[seq + 1] <= q_start) return;     // no token: no partial rows
  const int kv_len = kv_lens[seq];
  int k_lo, k_hi;
  split_range(kv_len, n_splits, split, k_lo, k_hi);
  const int q_row0 = q_start * n_heads;

  float o[DW / 8][4], m_a, m_b, l_a, l_b;
  latent_rows<1, CG, KVT>(q, pages, page_indices + static_cast<long long>(seq) * pages_per_seq,
                          smem, q_row0, n_heads, kv_len - 1, k_lo, k_hi, n_heads, block_size,
                          scale_log2, o, m_a, m_b, l_a, l_b);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(split) * n_tokens * n_heads + q_row0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= n_heads) continue;
    const float m = h ? m_b : m_a, l = h ? l_b : l_a;
    if (warp == 0 && t4 == 0)
      *reinterpret_cast<float2*>(part_ml + (base + r) * 2) = make_float2(m, l);
    if (m == -INFINITY) continue;                // an empty split: acc is never read
    float* acc = part_acc + (base + r) * kD + warp * DW + t4 * 2;
#pragma unroll
    for (int ni = 0; ni < DW / 8; ++ni)
      *reinterpret_cast<float2*>(acc + ni * 8) = make_float2(o[ni][2 * h], o[ni][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ f32, FMA

constexpr int kRows = 16;      // query rows a block
constexpr int kKvF = 32;       // kv rows a tile
constexpr int kThreads = 128;

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

template <typename KVT>
__global__ void __launch_bounds__(kThreads)
latent_f32_kernel(const float* __restrict__ q, const KVT* __restrict__ pages,
                  const int32_t* __restrict__ kv_lens, const int32_t* __restrict__ page_indices,
                  const int32_t* __restrict__ cu_q_lens, const int32_t* __restrict__ num_seqs,
                  float* __restrict__ out, int n_tokens, int n_heads, int head_dim,
                  int block_size, int pages_per_seq, float q_scale, float v_scale) {
  extern __shared__ float smem_f[];
  const int D = head_dim, DP = head_dim + 1;  // padded stride: no bank conflicts
  float* qs = smem_f;                 // kRows x DP
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

struct Args {
  const void *q, *pages, *kv_lens, *page_indices, *cu_q_lens, *num_seqs;
  void* out;
  int n_tokens, n_seqs, n_heads, head_dim, block_size, pages_per_seq;
};

template <typename KVT>
int launch_mixed(const Args& a, float scale_log2, float v_scale, cudaStream_t s) {
  const int bq = 64 / a.n_heads;
  // sequence s's tiles end at slot cu_q_lens[s + 1] / bq + s at most, so
  // T / bq + S slots hold them all; then one block per kPadTok padding tokens
  const int n_slots = a.n_tokens / bq + a.n_seqs;
  const dim3 grid(n_slots + (a.n_tokens + kPadTok - 1) / kPadTok);
  const size_t smem = Latent<4, kMixCG, KVT>::SMEM + sizeof(int) * a.pages_per_seq;
  auto kernel = latent_mixed_kernel<KVT>;
  static size_t allowed = 48 * 1024;   // raised once per size, not per launch
  const int err = allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<grid, kMixThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<__nv_bfloat16*>(a.out), a.n_tokens, a.n_heads, a.block_size,
      a.pages_per_seq, n_slots, scale_log2, v_scale);
  return launch_status();
}

template <typename KVT>
int launch_split(const Args& a, float* part_acc, float* part_ml, int n_splits,
                 float scale_log2, float v_scale, cudaStream_t s) {
  const size_t smem = Latent<1, 4, KVT>::SMEM + sizeof(int) * a.pages_per_seq;
  auto kernel = latent_split_kernel<KVT>;
  static size_t allowed = 48 * 1024;
  int err = allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<dim3(a.n_seqs, n_splits), 128, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      part_acc, part_ml, a.n_tokens, a.n_heads, a.block_size, a.pages_per_seq, n_splits,
      scale_log2);
  err = launch_status();
  if (err != 0) return err;
  return launch_split_merge<__nv_bfloat16>(part_acc, part_ml, a.out, a.cu_q_lens, a.num_seqs,
                                           a.n_heads, a.n_tokens * a.n_heads, n_splits, kD,
                                           v_scale, s);
}

template <typename KVT>
int launch_f32(const Args& a, float q_scale, float v_scale, cudaStream_t s) {
  const int D = a.head_dim;
  const size_t smem = sizeof(float) * (kRows * (D + 1) + kRows * D + kKvF * (D + 1) +
                                       kRows * kKvF + 3 * kRows);
  auto kernel = latent_f32_kernel<KVT>;
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  const int bq = kRows / a.n_heads;
  // every sequence contributes at most one partial tile beyond T / bq; the
  // blocks left over zero the padding rows
  kernel<<<dim3((a.n_tokens + bq - 1) / bq + a.n_seqs), kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const KVT*>(a.pages),
      static_cast<const int32_t*>(a.kv_lens), static_cast<const int32_t*>(a.page_indices),
      static_cast<const int32_t*>(a.cu_q_lens), static_cast<const int32_t*>(a.num_seqs),
      static_cast<float*>(a.out), a.n_tokens, a.n_heads, D, a.block_size, a.pages_per_seq,
      q_scale, v_scale);
  return launch_status();
}

}  // namespace

// q (T, Hq, D) f32 or bf16; pages (NB, BS, 1, D) f32/bf16/int8 (a bf16 q
// takes bf16 or int8 pages and D = 576); out (T, Hq, D) in q's dtype, every
// row written. Hq must divide 16. n_splits > 1 (bf16 q, every sequence at
// most one query token) takes the split-KV decode form, with part_acc
// (n_splits, T, Hq, D) and part_ml (n_splits, T, Hq, 2) f32 scratch;
// n_splits = 1 the mixed form (or the f32 path).
extern "C" int hydra_paged_attention_latent(const void* q, const void* pages,
                                            const void* kv_lens, const void* page_indices,
                                            const void* cu_q_lens, const void* num_seqs,
                                            void* out, void* part_acc, void* part_ml,
                                            int n_tokens, int n_seqs, int n_heads,
                                            int head_dim, int block_size, int pages_per_seq,
                                            int n_splits, float sm_scale, float kv_scale,
                                            int q_dtype, int kv_dtype, void* stream) {
  if (n_tokens <= 0) return 0;
  if (n_heads <= 0 || n_heads > kRows || kRows % n_heads || n_splits < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, pages, kv_lens, page_indices, cu_q_lens, num_seqs, out, n_tokens, n_seqs,
               n_heads, head_dim, block_size, pages_per_seq};
  if (q_dtype == kF32) {
    if (n_splits != 1) return -1;
    const float q_scale = sm_scale * kv_scale;
    switch (kv_dtype) {
      case kF32: return launch_f32<float>(a, q_scale, kv_scale, s);
      case kBF16: return launch_f32<__nv_bfloat16>(a, q_scale, kv_scale, s);
      case kI8: return launch_f32<int8_t>(a, q_scale, kv_scale, s);
      default: return -1;
    }
  }
  if (q_dtype != kBF16 || head_dim != kD || (kv_dtype != kI8 && kv_dtype != kBF16)) return -1;
  const float scale_log2 = sm_scale * kv_scale * 1.4426950408889634f;
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (n_splits > 1)
    return kv_dtype == kI8 ? launch_split<int8_t>(a, pa, pm, n_splits, scale_log2, kv_scale, s)
                           : launch_split<__nv_bfloat16>(a, pa, pm, n_splits, scale_log2,
                                                         kv_scale, s);
  return kv_dtype == kI8 ? launch_mixed<int8_t>(a, scale_log2, kv_scale, s)
                         : launch_mixed<__nv_bfloat16>(a, scale_log2, kv_scale, s);
}
