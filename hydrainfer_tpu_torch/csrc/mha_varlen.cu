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
// Bound on H100: operations at the ViT's sizes (about 4 * H * D * sum n_i^2
// against 989 TF/s bf16), bytes only at small T.
//
// The TPU kernel walks every kv block of every q block on a sequential grid
// with the softmax state in VMEM scratch. Here a small pre-pass records, per
// tile, the smallest and largest segment id, the smallest and largest
// position and the count of valid rows. A block owns one (q tile, head) and
// walks only the kv tiles whose id range meets its own and that are not
// wholly in its future (the work stays near sum_i n_i^2, not T^2, when a
// batch of images of different sizes is one long T); a q tile of padding
// writes zeros and exits.
//
// bf16 inputs (what the ViT runs) take the tensor-core path, a flash-attention
// forward on mma.sync m16n8k16 (bf16 in, f32 accumulate):
// - 128 q rows a block, so each staged kv tile serves 128 rows. At D <= 80
//   four warps take two m16 strips each (each K or V fragment read from
//   shared memory feeds two products); at D >= 96 eight warps take one, to
//   stay within the register file.
// - K and V tiles of 64 rows arrive by 16-byte cp.async in a ring of three
//   stages (two at D >= 96), so the next tiles load while one is multiplied.
//   Q's fragments come through ldmatrix at every k-step (kept in registers
//   they would leave too few at D = 80), K's through ldmatrix, and V stays
//   row-major and gives its B fragments through ldmatrix.trans (no
//   transposing stores). The scores' accumulators are re-packed as P.V's A
//   operand.
// - Only kv tiles that do not lie wholly inside the q tile's one segment (and
//   wholly in its past) are masked element by element, and the tile body is
//   built twice so that the others carry no mask code. kv rows past Tk are
//   zero-filled; the V rows of padding (id -1) inside Tk are zeroed before
//   use, so NaN there cannot reach P.V.
// - The output goes through shared memory to 16-byte stores.
// wgmma (the only way to the full tensor-core rate) is not used: at D = 80 a
// K tile is 160 bytes a row, wider than a 128-byte swizzle atom and not a
// multiple of it, so wgmma's descriptors would need a split K tile or
// padding to 96 or 128 columns.
//
// f32 inputs (the f32 correctness configuration) take an FMA path in shared
// memory with 64-row q tiles. D is a multiple of 16 up to 128.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kTile = 64;      // kv rows per tile; q rows per block on the f32 path
constexpr int kQTile = 128;    // q rows per block on the bf16 path
constexpr int kThreads = 128;  // f32 path and the pre-pass
constexpr int kPad = 8;        // bf16 shared-memory row padding (16 bytes)
constexpr int kStat = 5;       // ints of a tile's stats

// stats[kStat * t + {0..4}] of tile t (q tiles of q_tile rows first, then kv
// tiles of kTile rows): the smallest and largest valid segment id, the
// smallest and largest position over the valid rows, and the number of valid
// rows. An empty tile has min > max.
__global__ void __launch_bounds__(kThreads)
tile_stats_kernel(const int32_t* __restrict__ q_ids, const int32_t* __restrict__ kv_ids,
                  const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
                  int Tq, int Tk, int n_q_tiles, int q_tile, int* __restrict__ stats) {
  __shared__ int s_min, s_max, s_plo, s_phi, s_n;
  const int t = blockIdx.x;
  const bool is_q = t < n_q_tiles;
  const int rows = is_q ? q_tile : kTile;
  const int r0 = (is_q ? t : t - n_q_tiles) * rows;
  const int T = is_q ? Tq : Tk;
  const int32_t* ids = is_q ? q_ids : kv_ids;
  const int32_t* pos = is_q ? q_pos : kv_pos;
  if (threadIdx.x == 0) {
    s_min = s_plo = INT_MAX;
    s_max = s_phi = INT_MIN;
    s_n = 0;
  }
  __syncthreads();
  int mn = INT_MAX, mx = INT_MIN, plo = INT_MAX, phi = INT_MIN, n = 0;
  for (int r = threadIdx.x; r < rows && r0 + r < T; r += kThreads) {
    const int id = ids[r0 + r];
    if (id < 0) continue;
    const int p = pos != nullptr ? pos[r0 + r] : 0;
    mn = min(mn, id);
    mx = max(mx, id);
    plo = min(plo, p);
    phi = max(phi, p);
    ++n;
  }
  if (n > 0) {
    atomicMin(&s_min, mn);
    atomicMax(&s_max, mx);
    atomicMin(&s_plo, plo);
    atomicMax(&s_phi, phi);
    atomicAdd(&s_n, n);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* st = stats + kStat * t;
    st[0] = s_min;
    st[1] = s_max;
    st[2] = s_plo;
    st[3] = s_phi;
    st[4] = s_n;
  }
}

// Whether kv tile kt can hold a row visible to q tile qt.
__device__ __forceinline__ bool tile_meets(const int* __restrict__ stats, int qt,
                                           int kt_global) {
  const int* qs = stats + kStat * qt;
  const int* ks = stats + kStat * kt_global;
  return ks[0] <= ks[1] && ks[1] >= qs[0] && ks[0] <= qs[1] && ks[2] <= qs[3];
}

template <typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, long long so, int q0, int rows,
                                          int Tq, int h, int D) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    if (q0 + r < Tq) out[static_cast<long long>(q0 + r) * so + h * D + d] = from_f32<T>(0.0f);
  }
}

// ------------------------------------------------------------ bf16, tensor cores

template <int D>
struct Bf16Cfg {
  static constexpr int MS = D <= 80 ? 2 : 1;          // m16 strips per warp
  static constexpr int WARPS = kQTile / (16 * MS);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NST = D <= 80 ? 3 : 2;         // K/V ring stages
  static constexpr int DP = D + kPad;                 // row stride in shared memory
  static constexpr int Q_BYTES = kQTile * DP * 2;
  static constexpr int KV_BYTES = kTile * DP * 2;     // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES + 2 * kTile * 4;  // K, V, kv ids, kv positions
  static constexpr int SMEM = Q_BYTES + NST * STAGE;
};

// One kv tile for a warp's MS strips (Q rows from qw): S = Q K^T, the mask
// where kMask (a tile without masks carries no mask code), an online softmax
// per row, O += P V.
template <int D, int MS, bool kMask>
__device__ __forceinline__ void varlen_tile(float (&o)[MS][D / 8][4], float (&m)[MS][2],
                                            float (&l)[MS][2], const __nv_bfloat16* qw,
                                            const __nv_bfloat16* ks_t,
                                            const __nv_bfloat16* vs_t, const int* kid,
                                            const int* kpos, const int (&qid)[MS][2],
                                            const int (&qpos)[MS][2], float scale_log2) {
  constexpr int DP = D + kPad;
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int NT_S = kTile / 8;    // n-tiles of a 16 x 64 score strip
  constexpr int NT_O = D / 8;        // n-tiles of a 16 x D output strip
  const int lane = threadIdx.x & 31, t4 = lane & 3, mat = lane >> 3, mrow = lane & 7;
  // S = Q K^T: Q's A fragments come from shared memory at each k-step (in
  // registers they would cost 40 of them at D = 80); each K fragment feeds
  // the MS strips
  float s[MS][NT_S][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ms][ni][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qa[MS][4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
      ldmatrix_x4(qa[ms], qw + (ms * 16 + mrow + (mat & 1) * 8) * DP + ks * 16 +
                              (mat >> 1) * 8);
#pragma unroll
    for (int n2 = 0; n2 < NT_S / 2; ++n2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks_t + (n2 * 16 + mrow + (mat >> 1) * 8) * DP + ks * 16 + (mat & 1) * 8);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        mma_bf16(s[ms][2 * n2], qa[ms], kb[0], kb[1]);
        mma_bf16(s[ms][2 * n2 + 1], qa[ms], kb[2], kb[3]);
      }
    }
  }
  // the mask, then an online softmax per row in log2 units (the running
  // max m is kept scaled)
  if constexpr (kMask) {
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = ni * 8 + t4 * 2 + (e & 1);
          const int hf = e >> 1;
          if (!(qid[ms][hf] >= 0 && kid[col] == qid[ms][hf] && kpos[col] <= qpos[ms][hf]))
            s[ms][ni][e] = -INFINITY;
        }
  }
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[ms][ni][e]);
    float al[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], off));
      const float mn = fmaxf(m[ms][hf], mx[hf] * scale_log2);
      // nothing visible yet: subtract 0 so 2^-inf stays 0 and not NaN
      const float mu = mn == -INFINITY ? 0.0f : mn;
      al[hf] = fast_exp2(m[ms][hf] - mu);
      m[ms][hf] = mn;
      mx[hf] = mu;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ni = 0; ni < NT_S; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ms][ni][e] = fast_exp2(fmaf(s[ms][ni][e], scale_log2, -mx[e >> 1]));
        sum[e >> 1] += s[ms][ni][e];
      }
    }
    // per-thread partial sums, reduced at the end
    l[ms][0] = l[ms][0] * al[0] + sum[0];
    l[ms][1] = l[ms][1] * al[1] + sum[1];
#pragma unroll
    for (int ni = 0; ni < NT_O; ++ni) {
      o[ms][ni][0] *= al[0];
      o[ms][ni][1] *= al[0];
      o[ms][ni][2] *= al[1];
      o[ms][ni][3] *= al[1];
    }
  }
  // O += P V: P's A fragments from the score accumulators, V's B fragments
  // through ldmatrix.trans, each feeding the MS strips
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t pa[MS][4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      pa[ms][0] = pack_bf16(s[ms][2 * kk][0], s[ms][2 * kk][1]);
      pa[ms][1] = pack_bf16(s[ms][2 * kk][2], s[ms][2 * kk][3]);
      pa[ms][2] = pack_bf16(s[ms][2 * kk + 1][0], s[ms][2 * kk + 1][1]);
      pa[ms][3] = pack_bf16(s[ms][2 * kk + 1][2], s[ms][2 * kk + 1][3]);
    }
    const __nv_bfloat16* vrow = vs_t + (kk * 16 + (mat & 1) * 8 + mrow) * DP + (mat >> 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < NT_O / 2; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + n2 * 16);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        mma_bf16(o[ms][2 * n2], pa[ms], vb[0], vb[1]);
        mma_bf16(o[ms][2 * n2 + 1], pa[ms], vb[2], vb[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Cfg<D>::THREADS)
mha_varlen_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       long long sq, long long sk, long long sv, long long so,
                       const int32_t* __restrict__ q_ids, const int32_t* __restrict__ kv_ids,
                       const int32_t* __restrict__ q_pos, const int32_t* __restrict__ kv_pos,
                       const int* __restrict__ stats, int Tq, int Tk, int n_heads,
                       int n_q_tiles, int n_kv_tiles, float scale_log2) {
  using C = Bf16Cfg<D>;
  constexpr int MS = C::MS, NST = C::NST, DP = C::DP, THREADS = C::THREADS;
  constexpr int NT_O = D / 8;        // n-tiles of a 16 x D output strip
  constexpr int PPR = D / 8;         // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kQTile x DP
  auto k_stage = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q_BYTES + st * C::STAGE);
  };
  auto v_stage = [&](int st) { return k_stage(st) + kTile * DP; };
  auto id_stage = [&](int st) {
    return reinterpret_cast<int*>(smem_raw + C::Q_BYTES + st * C::STAGE + 2 * C::KV_BYTES);
  };
  __shared__ int s_first, s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // the heads of one q tile are neighbours in the grid
  const int qt = blockIdx.x / n_heads, h = blockIdx.x - qt * n_heads;
  const int q0 = qt * kQTile;
  const int* qst = stats + kStat * qt;
  if (qst[0] > qst[1]) {  // padding rows only
    zero_rows(out, so, q0, kQTile, Tq, h, D);
    return;
  }
  const bool q_single = qst[0] == qst[1];

  // the span [first, last] of kv tiles that can meet this q tile
  if (tid == 0) {
    s_first = INT_MAX;
    s_last = -1;
  }
  __syncthreads();
  {
    int f = INT_MAX, l = -1;
    for (int kt = tid; kt < n_kv_tiles; kt += THREADS)
      if (tile_meets(stats, qt, n_q_tiles + kt)) {
        f = min(f, kt);
        l = max(l, kt);
      }
    if (l >= 0) {
      atomicMin(&s_first, f);
      atomicMax(&s_last, l);
    }
  }
  // the Q tile (in the first cp.async group, with the first kv tile)
  for (int i = tid; i < kQTile * PPR; i += THREADS) {
    const int r = i / PPR, c = i - r * PPR;
    const bool live = q0 + r < Tq;
    cp_async16(Qs + r * DP + c * 8, live ? q + (q0 + r) * sq + h * D + c * 8 : q, live ? 16 : 0);
  }
  __syncthreads();
  const int last = s_last;
  auto next_tile = [&](int kt) {
    while (kt <= last && !tile_meets(stats, qt, n_q_tiles + kt)) ++kt;
    return kt;
  };
  // Issues kv tile kt into ring stage st: rows past Tk zero-filled, their ids -1.
  auto issue = [&](int kt, int st) {
    const int k0 = kt * kTile;
    __nv_bfloat16* ks = k_stage(st);
    __nv_bfloat16* vs = v_stage(st);
    for (int i = tid; i < kTile * PPR; i += THREADS) {
      const int r = i / PPR, c = i - r * PPR;
      const int gr = k0 + r;
      const bool live = gr < Tk;
      cp_async16(ks + r * DP + c * 8, live ? k + gr * sk + h * D + c * 8 : k, live ? 16 : 0);
      cp_async16(vs + r * DP + c * 8, live ? v + gr * sv + h * D + c * 8 : v, live ? 16 : 0);
    }
    int* ids = id_stage(st);
    for (int r = tid; r < kTile; r += THREADS) {
      const int gr = k0 + r;
      if (gr < Tk) {
        cp_async4(ids + r, kv_ids + gr);
        if (kv_pos != nullptr)
          cp_async4(ids + kTile + r, kv_pos + gr);
        else
          ids[kTile + r] = 0;
      } else {
        ids[r] = -1;
        ids[kTile + r] = 0;
      }
    }
  };

  // this thread's rows: g and g + 8 of each of its warp's strips
  int qid[MS][2], qpos[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + (warp * MS + ms) * 16 + g + hf * 8;
      qid[ms][hf] = row < Tq ? q_ids[row] : -1;
      qpos[ms][hf] = (q_pos != nullptr && row < Tq) ? q_pos[row] : 0;
    }
  float o[MS][NT_O][4];
  float m[MS][2], l[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
#pragma unroll
    for (int ni = 0; ni < NT_O; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ms][ni][e] = 0.0f;
    m[ms][0] = m[ms][1] = -INFINITY;
    l[ms][0] = l[ms][1] = 0.0f;
  }

  const int first = s_first <= last ? s_first : last + 1;
  int fetch = first;
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (fetch <= last) {
      issue(fetch, p);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
  }
  int st = 0;
  for (int kt = first; kt <= last; kt = next_tile(kt + 1)) {
    cp_async_wait<NST - 2>();  // this thread's pieces of tile kt (and of Q)
    __syncthreads();           // everyone's pieces landed; the stage read last is free
    if (fetch <= last) {
      issue(fetch, (st + NST - 1) % NST);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
    const int k0 = kt * kTile;
    const int* kst = stats + kStat * (n_q_tiles + kt);
    const __nv_bfloat16* ks_t = k_stage(st);
    __nv_bfloat16* vs_t = v_stage(st);
    const int* kid = id_stage(st);
    const int* kpos = kid + kTile;
    if (kst[4] < min(kTile, Tk - k0)) {
      // padding rows inside the tile: zero their V (0 x NaN would be NaN)
      for (int i = tid; i < kTile * PPR; i += THREADS) {
        const int r = i / PPR, c = i - r * PPR;
        if (kid[r] < 0)
          *reinterpret_cast<uint4*>(vs_t + r * DP + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
    }
    // every row of the q tile sees every row of this kv tile
    const bool full = q_single && kst[0] == qst[0] && kst[1] == qst[0] && kst[4] == kTile &&
                      kst[3] <= qst[2];

    const __nv_bfloat16* qw = Qs + warp * MS * 16 * DP;
    if (full)
      varlen_tile<D, MS, false>(o, m, l, qw, ks_t, vs_t, kid, kpos, qid, qpos, scale_log2);
    else
      varlen_tile<D, MS, true>(o, m, l, qw, ks_t, vs_t, kid, kpos, qid, qpos, scale_log2);
    st = st + 1 == NST ? 0 : st + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every Q copy landed, also where no kv tile was walked

  // normalise into this warp's own rows of the Q tile (read only by this
  // warp, before), then 16-byte stores. A padding row (id -1) is written as
  // zeros by a select: in a tile without masks its scores may be NaN.
  const int wrow0 = warp * MS * 16;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    float inv[2];
    bool live[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float den = l[ms][hf];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
      live[hf] = qid[ms][hf] >= 0 && den > 0.0f;
      inv[hf] = live[hf] ? __fdividef(1.0f, den) : 0.0f;
    }
#pragma unroll
    for (int ni = 0; ni < NT_O; ++ni) {
      __nv_bfloat16* dst = Qs + (wrow0 + ms * 16 + g) * DP + ni * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          live[0] ? pack_bf16(o[ms][ni][0] * inv[0], o[ms][ni][1] * inv[0]) : 0u;
      *reinterpret_cast<uint32_t*>(dst + 8 * DP) =
          live[1] ? pack_bf16(o[ms][ni][2] * inv[1], o[ms][ni][3] * inv[1]) : 0u;
    }
  }
  __syncwarp();
  for (int i = lane; i < MS * 16 * PPR; i += 32) {
    const int r = i / PPR, c = i - r * PPR;
    const int row = q0 + wrow0 + r;
    if (row < Tq)
      *reinterpret_cast<uint4*>(out + row * so + h * D + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + (wrow0 + r) * DP + c * 8);
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
  if (stats[kStat * qt] > stats[kStat * qt + 1]) {
    zero_rows(out, so, q0, kTile, Tq, h, D);
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
int launch_bf16(cudaStream_t s, const void* q, const void* k, const void* v, void* out,
                long long sq, long long sk, long long sv, long long so, const int32_t* q_ids,
                const int32_t* kv_ids, const int32_t* q_pos, const int32_t* kv_pos,
                const int* stats, int Tq, int Tk, int n_heads, int n_q_tiles,
                int n_kv_tiles, float scale_log2) {
  using C = Bf16Cfg<D>;
  auto kernel = mha_varlen_bf16_kernel<D>;
  static bool allowed = false;   // raised once, not per launch
  if (C::SMEM > 48 * 1024 && !allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  kernel<<<n_q_tiles * n_heads, C::THREADS, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sv, so,
      q_ids, kv_ids, q_pos, kv_pos, stats, Tq, Tk, n_heads, n_q_tiles, n_kv_tiles,
      scale_log2);
  return launch_status();
}

}  // namespace

// stats: int32 scratch of 5 * (ceil(Tq / 64) + ceil(Tk / 64)) entries, the
// tiles' stats (the bf16 path's q tiles of 128 rows need fewer).
// q_pos / kv_pos may be null (all zeros). dtype: kF32 or kBF16 for q, k, v and
// the output alike; bf16 rows (pointers and row strides) must be 16-byte
// aligned.
extern "C" int hydra_mha_varlen(const void* q, const void* k, const void* v, void* out,
                                long long sq, long long sk, long long sv, long long so,
                                const void* q_ids, const void* kv_ids, const void* q_pos,
                                const void* kv_pos, void* stats, int Tq, int Tk, int n_heads,
                                int head_dim, float sm_scale, int dtype, void* stream) {
  if (Tq <= 0 || n_heads <= 0) return 0;
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return -1;
  if (dtype != kF32 && dtype != kBF16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_tile = dtype == kBF16 ? kQTile : kTile;
  const int n_q_tiles = (Tq + q_tile - 1) / q_tile;
  const int n_kv_tiles = Tk > 0 ? (Tk + kTile - 1) / kTile : 0;
  const int32_t* qi = static_cast<const int32_t*>(q_ids);
  const int32_t* ki = static_cast<const int32_t*>(kv_ids);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  int* st = static_cast<int*>(stats);
  tile_stats_kernel<<<n_q_tiles + n_kv_tiles, kThreads, 0, s>>>(qi, ki, qp, kp, Tq, Tk,
                                                                n_q_tiles, q_tile, st);
  const int err = launch_status();
  if (err != 0) return err;
  if (dtype == kF32) {
    const dim3 grid(n_q_tiles, n_heads);
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
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0 &&
                       sq % 8 == 0 && sk % 8 == 0 && sv % 8 == 0 && so % 8 == 0;
  if (!aligned) return -1;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
#define HYDRA_MHA_VARLEN_CASE(DD)                                                         \
  case DD:                                                                                \
    return launch_bf16<DD>(s, q, k, v, out, sq, sk, sv, so, qi, ki, qp, kp, st, Tq, Tk,  \
                           n_heads, n_q_tiles, n_kv_tiles, scale_log2);
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
