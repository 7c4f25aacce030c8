// K4: W8A16 GEMM, out = (x @ dequant(w)) with int8 weights converted in-kernel.
//
// Replaces hydrainfer_tpu/ops/pallas/quant_matmul.py:41 quant_matmul_int8
// (its pallas_call at :64; dispatched by ops/quant.py:qmatmul and
// qmatmul_f32). x is (M, K) bf16 or f32, w_q is (K, N) int8 row-major (the
// JAX package's layout), scale is (N,) f32: out[m, n] = (sum_k x[m, k]
// w_q[k, n]) x scale[n], the sum in f32, the output bf16 or f32. The int8
// tiles are converted to bf16 in registers, so
// a dequantized weight never exists in device memory.
//
// The TPU kernel carries its f32 sum across a sequential grid axis over K.
// Here the K range is cut into `splits` slices that run in parallel as the
// blocks of one thread-block cluster; the cluster sums the slices' partial
// tiles through distributed shared memory in a fixed order (rank 0 first),
// then scales and casts: deterministic, one launch, no scratch in device
// memory, so it also runs under CUDA-graph capture. The form, the column
// strip and the split count come from ops/cuda/quant_matmul.py:plan (shapes
// only); this file does not re-derive them.
//
// Two bf16 forms:
// - skinny (M <= 64: every decode step and lm_head call). Bound: the K x N
//   weight read (bytes). The operands are swapped, out^T = w^T x^T on
//   mma.sync m16n8k16, so N fills the 16-row side and the activation rows
//   the 8-wide side (M = 16 wastes nothing). A block of 4 or 8 warps owns a
//   64-, 128- or 256-column strip and one K slice; 16-byte cp.async streams
//   the int8 weight and x tiles (BK = 64) through a 4-stage ring; each warp
//   reads its columns of the int8 tile with ldmatrix.trans and converts them
//   to bf16 A fragments in registers (byte permutes and one bf16x2
//   subtraction a pair), with no repack of w_q and no bf16 copy of the tile.
// - wide (M > 64: prefill chunks). Bound: tensor-core operations. The
//   operands are swapped again; each of two warpgroups runs wgmma
//   m64n128k16 with A (its 64 weight columns) converted from the int8 ring
//   into registers as in the skinny form, and B the 128-row x tile in the
//   128-byte swizzle (BK = 64), read from the ring by descriptor. A 4-stage
//   cp.async ring keeps two tiles loading; tile t's wgmma group runs while
//   tile t + 1 is converted. Split where the tiles alone do not fill the
//   card. It reaches about a third of the bf16 peak: each 128 x 128 tile
//   re-reads its x rows and weight strip from L2 (no multicast), and each
//   K tile ends in a block barrier.
// Ragged K tails and the M and N edges are zero-filled by cp.async with a
// source size of 0; a 16-byte piece that crosses the N or K edge or is not
// 16-byte aligned (N or K not a multiple of 16 or 8) is read with masked
// scalar loads instead.
//
// f32 activations (the f32 correctness configuration, on no timed path) take
// a plain FMA tile, unchanged.
//
// ptxas (-Xptxas -v, sm_90a, built on an H100 host): no spill stores in any
// form, and no wgmma serialization. Registers a thread, skinny form at 8 /
// 16 / 32 / 64 padded rows: bn 64: 35 / 35 / 39 / 56; bn 128: 35 / 40 / 56 /
// 96; bn 256: 35 / 40 / 64 / 96. Wide form 94 (two blocks an SM); f32 form
// 48.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64, BN = 64;    // the f32 form's output tile
constexpr int STAGES = 4;          // cp.async ring depth of both bf16 forms

// ------------------------------------------------------------- tile loaders

// One 16-byte piece of the int8 weight: row k, columns n..n+15.
__device__ __forceinline__ void load_w16(int8_t* dst, const int8_t* __restrict__ w, int k,
                                         int n, int K, int N) {
  if (k >= K || n >= N) {
    cp_async16(dst, w, 0);
    return;
  }
  const int8_t* src = w + static_cast<long long>(k) * N + n;
  if (n + 16 <= N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
    return;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n + j < N) v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * (j & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// One 16-byte piece of x: row m, columns k..k+7.
__device__ __forceinline__ void load_x16(__nv_bfloat16* dst,
                                         const __nv_bfloat16* __restrict__ x, int m, int k,
                                         int M, int K) {
  if (m >= M || k >= K) {
    cp_async16(dst, x, 0);
    return;
  }
  const __nv_bfloat16* src = x + static_cast<long long>(m) * K + k;
  if (k + 8 <= K && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
    return;
  }
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k + j < K) v[j >> 1] |= static_cast<uint32_t>(s16[j]) << (16 * (j & 1));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// The K tiles [lo, hi) of split `split` of `splits`: ceil(tiles / splits)
// consecutive tiles each, empty past the end (ops/cuda/quant_matmul.py:
// split_tiles mirrors this).
__device__ __forceinline__ void split_tiles(int tiles, int splits, int split, int& lo,
                                            int& hi) {
  const int per = (tiles + splits - 1) / splits;
  lo = min(tiles, split * per);
  hi = min(tiles, lo + per);
}

// The ring's prologue: the first AHEAD tiles, one commit group each.
template <int AHEAD, typename Load>
__device__ __forceinline__ void prefetch(Load load, int lo, int n_tiles) {
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load(s, lo + s);
    cp_async_commit();
  }
}

// ------------------------------------------------------------- cluster merge

// Every block of the cluster has left its partial f32 tile in `red` (rows x
// RS floats, row r = output row m0 + r, column c = output column n0 + c).
// The cluster's blocks share the tile's live rows by 4-column groups; each
// sums the partials of ranks 0, 1, ... in that order, scales and stores.
template <typename OUT, int THREADS>
__device__ __forceinline__ void cluster_merge_store(float* red, int rows, int cols,
                                                    int RS, int m0, int n0, int M, int N,
                                                    const float* __restrict__ scale,
                                                    OUT* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                                      // every partial is written
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int live = min(rows, M - m0);
  const int groups = cols / 4;
  for (int i = rank * THREADS + static_cast<int>(threadIdx.x); i < live * groups;
       i += S * THREADS) {
    const int r = i / groups, c = (i - r * groups) * 4;
    const int n = n0 + c;
    if (n >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red + r * RS + c, q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    OUT* o = out + static_cast<long long>(m0 + r) * N + n;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) o[j] = from_f32<OUT>(sv[j] * scale[n + j]);
  }
  cluster.sync();                      // no block leaves while its tile is read
}

// ------------------------------------------------------------- skinny form

// Two 8x8 b16 matrices from shared memory, transposed; lanes 0-15 give the
// row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Two int8 values at bits 0-7 and 16-23 of t (zeros elsewhere) -> bf16x2,
// exactly: 128 + (b & 127) minus 128 + (b & 128), both held exactly by a
// bf16 of exponent 2^7 (0x4300 | low 7 bits; 0x4300 or 0x4380).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t t) {
  const uint32_t v = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// The skinny form reads its int8 weight tile [k][n] with ldmatrix.trans as
// b16 pairs of columns: lane (g, t) gets w[2t][2g], w[2t][2g+1],
// w[2t+1][2g], w[2t+1][2g+1] of an 8 x 16-byte block. Bytes 0 and 2 are the
// A fragment (k 2t, 2t+1) of tile row g standing for column 2g, bytes 1 and
// 3 that of row g + 8 standing for column 2g + 1: an m16 tile of w^T covers
// 16 consecutive columns, even ones in rows 0-7 and odd ones in rows 8-15,
// and the weight goes from the ring to the tensor cores through registers
// only.
template <int BN_, int MT>
struct Skinny {
  static constexpr int BK = 64;
  static constexpr int WARPS = BN_ == 256 ? 8 : 4, THREADS = 32 * WARPS;
  static constexpr int WN = BN_ / WARPS;               // columns of one warp
  static constexpr int AT = WN / 16;                   // its m16 A tiles (n side)
  static constexpr int ROWS = MT * 8;                  // x rows, padded
  static constexpr int WS = BN_ + 16;                  // int8 row stride: conflict-free ldmatrix
  static constexpr int XS = BK + 8;                    // x row stride, bf16
  static constexpr int W_BYTES = BK * WS;
  static constexpr int X_BYTES = ROWS * XS * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int RS = BN_ + 4;                   // merge tile row stride, floats
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(ROWS * RS * 4 <= SMEM, "merge tile must fit the ring");
  static_assert(SMEM <= 227 * 1024, "a block has at most 227 KB of shared memory");
};

template <typename OUT, int BN_, int MT>
__global__ void __launch_bounds__(Skinny<BN_, MT>::THREADS)
qmm_skinny_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, OUT* __restrict__ out, int M, int K,
                  int N, int splits) {
  using L = Skinny<BN_, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * BN_;
  int lo, hi;
  split_tiles((K + L::BK - 1) / L::BK, splits, blockIdx.x, lo, hi);
  const int n_tiles = hi - lo;

  auto load_w = [&](int slot, int tile) {
    int8_t* ws = reinterpret_cast<int8_t*>(smem + slot * L::STAGE);
    const int k0 = tile * L::BK;
#pragma unroll
    for (int c = tid; c < L::BK * (BN_ / 16); c += L::THREADS) {
      const int r = c / (BN_ / 16), col = (c % (BN_ / 16)) * 16;
      load_w16(ws + r * L::WS + col, w, k0 + r, n0 + col, K, N);
    }
  };
  auto load_x = [&](int slot, int tile) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + slot * L::STAGE + L::W_BYTES);
    const int k0 = tile * L::BK;
    for (int c = tid; c < L::ROWS * (L::BK / 8); c += L::THREADS) {
      const int r = c / (L::BK / 8), col = (c % (L::BK / 8)) * 8;
      load_x16(xs + r * L::XS + col, x, r, k0 + col, M, K);
    }
  };

  float acc[L::AT][MT][4];
#pragma unroll
  for (int i = 0; i < L::AT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  prefetch<STAGES - 1>([&](int slot, int tile) { load_w(slot, tile); load_x(slot, tile); },
                       lo, n_tiles);
  // this lane's ldmatrix row: k = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
  // 16-column group lane >> 4 of the warp's columns
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * L::WS + warp * L::WN +
                    (L::AT == 2 ? (lane >> 4) * 16 : 0);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // tile t landed; every warp is done with tile t - 1
    if (t + STAGES - 1 < n_tiles) {
      load_w((t + STAGES - 1) % STAGES, lo + t + STAGES - 1);
      load_x((t + STAGES - 1) % STAGES, lo + t + STAGES - 1);
    }
    cp_async_commit();
    const unsigned char* stage = smem + (t % STAGES) * L::STAGE;
    const int8_t* ws = reinterpret_cast<const int8_t*>(stage) + a_off;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage + L::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk) {
      // r[2i] holds k rows 0-7 of A tile i, r[2i + 1] rows 8-15
      uint32_t r[2 * L::AT];
      if constexpr (L::AT == 2) {
        uint32_t q[4];
        ldmatrix_x4_trans(q, ws + kk * 16 * L::WS);
        r[0] = q[0]; r[1] = q[1]; r[2] = q[2]; r[3] = q[3];
      } else {
        uint32_t q[2];
        ldmatrix_x2_trans(q, ws + kk * 16 * L::WS);
        r[0] = q[0]; r[1] = q[1];
      }
      uint32_t a[L::AT][4];
#pragma unroll
      for (int i = 0; i < L::AT; ++i) {
        a[i][0] = i8pair_to_bf16x2(__byte_perm(r[2 * i], 0, 0x4240));
        a[i][1] = i8pair_to_bf16x2(__byte_perm(r[2 * i], 0, 0x4341));
        a[i][2] = i8pair_to_bf16x2(__byte_perm(r[2 * i + 1], 0, 0x4240));
        a[i][3] = i8pair_to_bf16x2(__byte_perm(r[2 * i + 1], 0, 0x4341));
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const __nv_bfloat16* xr = xs + (j * 8 + g) * L::XS + kk * 16 + 2 * t4;
        const uint32_t b0 = ld32(xr), b1 = ld32(xr + 8);
#pragma unroll
        for (int i = 0; i < L::AT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the ring is free: it holds the partial tile now

  // acc[i][j] holds out^T: c0, c1 = (column 2g, m 2t and 2t + 1), c2, c3 =
  // (column 2g + 1, the same m)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < L::AT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (j * 8 + 2 * t4 + h) * L::RS + warp * L::WN +
                                   i * 16 + 2 * g) = make_float2(acc[i][j][h], acc[i][j][2 + h]);
  cluster_merge_store<OUT, L::THREADS>(red, L::ROWS, BN_, L::RS, 0, n0, M, N, scale, out);
}

// --------------------------------------------------------------- wide form
//
// Warpgroup products (wgmma) with A from registers: out^T = w^T x^T again,
// so the converted weight never goes back to shared memory. Each of the
// block's two warpgroups owns 64 weight columns, one m64 tile of A, read from
// the int8 ring by ldmatrix.trans and converted in registers as in the
// skinny form (A rows 0-7 of a warp's 16 columns = the even columns, 8-15 =
// the odd ones); B is the x tile, 128 rows x 64 bf16 (128 bytes), K-major in
// the 128-byte swizzle (16-byte piece c of row r at piece c ^ (r % 8)),
// written so by cp.async and read by the descriptor. Each K tile is one
// wgmma group of 4 k16 steps; the group of tile t runs while the block
// converts tile t + 1, and tile t + 2 loads meanwhile.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory (cp.async included)
// become visible to the wgmma reads that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO 64 x 16 bytes), the tile
// 1024-byte aligned; +2 in the address field per k16 step (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 128, f32) += a (64 x 16 bf16, registers) . b (16 x 128 bf16,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

struct Wide {
  static constexpr int BM_ = 128;                      // x rows: the n of wgmma
  static constexpr int BN_ = 128;                      // weight columns: 64 a warpgroup
  static constexpr int BK = 64;                        // one 128-byte swizzle row of x
  static constexpr int THREADS = 256;
  // tiles loading ahead of the one being converted: one wgmma group stays
  // running, and a slot is reloaded only once the group that read it has
  // been waited for
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int WS = BN_ + 16;                  // int8 row stride: conflict-free ldmatrix
  static constexpr int X_BYTES = BM_ * BK * 2;
  static constexpr int W_BYTES = BK * WS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int RS = BN_ + 4;                   // merge tile row stride, floats
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + the 1024-byte alignment
  static_assert(STAGE % 1024 == 0, "every x tile must start 1024-byte aligned");
  static_assert(BM_ * RS * 4 <= STAGES * STAGE, "merge tile must fit the ring");
  static_assert(SMEM <= 227 * 1024, "a block has at most 227 KB of shared memory");
};

template <typename OUT>
__global__ void __launch_bounds__(256)
qmm_wide_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, OUT* __restrict__ out, int M, int K, int N,
                int splits) {
  using L = Wide;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;             // warpgroup, its warp
  const int m0 = blockIdx.y * L::BM_, n0 = blockIdx.z * L::BN_;
  int lo, hi;
  split_tiles((K + L::BK - 1) / L::BK, splits, blockIdx.x, lo, hi);
  const int n_tiles = hi - lo;

  auto load = [&](int slot, int tile) {
    unsigned char* st = smem + slot * L::STAGE;
    const int k0 = tile * L::BK;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
#pragma unroll
    for (int c = tid; c < L::BM_ * 8; c += L::THREADS) {
      const int r = c >> 3, p = c & 7;
      load_x16(xs + r * L::BK + ((p ^ (r & 7)) << 3), x, m0 + r, k0 + p * 8, M, K);
    }
    int8_t* ws = reinterpret_cast<int8_t*>(st + L::X_BYTES);
#pragma unroll
    for (int c = tid; c < L::BK * (L::BN_ / 16); c += L::THREADS) {
      const int r = c / (L::BN_ / 16), col = (c % (L::BN_ / 16)) * 16;
      load_w16(ws + r * L::WS + col, w, k0 + r, n0 + col, K, N);
    }
  };

  float acc[L::BM_ / 2];
#pragma unroll
  for (int e = 0; e < L::BM_ / 2; ++e) acc[e] = 0.f;

  prefetch<L::AHEAD>(load, lo, n_tiles);
  // this lane's ldmatrix row: k = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  // the warp's weight columns wg * 64 + wq * 16 ..
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * L::WS + wg * 64 + wq * 16;
  // K tile t: its A fragments go to `a`, which the wgmma group of tile t - 1
  // (still running) does not read: tiles alternate between two sets
  auto step = [&](int t, uint32_t (&a)[4][4]) {
    cp_async_wait<L::AHEAD - 1>();
    fence_proxy_async();
    // tile t landed; every warpgroup has waited for the group of tile t - 2,
    // so the slot loaded next is free
    __syncthreads();
    const unsigned char* st = smem + (t % STAGES) * L::STAGE;
    const int8_t* ws = reinterpret_cast<const int8_t*>(st + L::X_BYTES) + a_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[2];
      ldmatrix_x2_trans(r, ws + kk * 16 * L::WS);
      a[kk][0] = i8pair_to_bf16x2(__byte_perm(r[0], 0, 0x4240));
      a[kk][1] = i8pair_to_bf16x2(__byte_perm(r[0], 0, 0x4341));
      a[kk][2] = i8pair_to_bf16x2(__byte_perm(r[1], 0, 0x4240));
      a[kk][3] = i8pair_to_bf16x2(__byte_perm(r[1], 0, 0x4341));
    }
    const uint64_t desc = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc + 2 * kk);
    wgmma_commit();
    // the next loads go out behind the products (their issue hides under them)
    if (t + L::AHEAD < n_tiles) load((t + L::AHEAD) % STAGES, lo + t + L::AHEAD);
    cp_async_commit();
    wgmma_wait<1>();
  };
  uint32_t a0[4][4], a1[4][4];
  for (int t = 0; t < n_tiles; t += 2) {
    step(t, a0);
    if (t + 1 < n_tiles) step(t + 1, a1);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();              // the ring is free: it holds the partial tile now

  // acc holds out^T: d[4j + h] = (column 2g, x row 8j + 2 t4 + h), d[4j + 2 +
  // h] = (column 2g + 1, the same row), columns counted from the warp's 16
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < L::BM_ / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (8 * j + 2 * t4 + h) * L::RS + wg * 64 + wq * 16 +
                                 2 * g) = make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
  cluster_merge_store<OUT, L::THREADS>(red, L::BM_, L::BN_, L::RS, m0, n0, M, N, scale, out);
}

// ------------------------------------------------------------ f32 form

// f32 activations: 64x64 output tile, 256 threads, 4x4 outputs per thread.
template <typename OUT>
__global__ void __launch_bounds__(256)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, OUT* __restrict__ out, int M, int K,
               int N) {
  constexpr int TK = 16;
  __shared__ float As[TK][BM];
  __shared__ float Bs[TK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < BM * TK; i += 256) {
      const int r = i / TK, c = i % TK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[static_cast<long long>(gm) * K + gk] : 0.0f;
    }
    for (int i = tid; i < TK * BN; i += 256) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N)
                     ? static_cast<float>(w[static_cast<long long>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N)
        out[static_cast<long long>(row) * N + col] = from_f32<OUT>(acc[i][j] * scale[col]);
    }
  }
}

// ------------------------------------------------------------------ launches

template <typename Kern, typename... Args>
int launch_clustered(Kern kernel, size_t& allowed, dim3 grid, int threads, int smem,
                     int splits, cudaStream_t s, Args... args) {
  const int e = allow_smem(kernel, smem, allowed);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;   // the splits of one output tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? static_cast<int>(err) : launch_status();
}

template <typename OUT, int BN_, int MT>
int launch_skinny(const __nv_bfloat16* x, const int8_t* w, const float* scale, OUT* out,
                  int M, int K, int N, int splits, cudaStream_t s) {
  static size_t allowed = 0;
  using L = Skinny<BN_, MT>;
  const dim3 grid(splits, (N + BN_ - 1) / BN_);
  return launch_clustered(qmm_skinny_kernel<OUT, BN_, MT>, allowed, grid, L::THREADS,
                          L::SMEM, splits, s, x, w, scale, out, M, K, N, splits);
}

// padded x rows: 8 (MT = 1), 16, 32 or 64
template <int BN_>
int skinny_smem(int M) {
  return M <= 8 ? Skinny<BN_, 1>::SMEM : M <= 16 ? Skinny<BN_, 2>::SMEM
       : M <= 32 ? Skinny<BN_, 4>::SMEM : Skinny<BN_, 8>::SMEM;
}

template <typename OUT, int BN_>
int skinny_rows(const __nv_bfloat16* x, const int8_t* w, const float* scale, OUT* out,
                int M, int K, int N, int splits, cudaStream_t s) {
  if (M <= 8) return launch_skinny<OUT, BN_, 1>(x, w, scale, out, M, K, N, splits, s);
  if (M <= 16) return launch_skinny<OUT, BN_, 2>(x, w, scale, out, M, K, N, splits, s);
  if (M <= 32) return launch_skinny<OUT, BN_, 4>(x, w, scale, out, M, K, N, splits, s);
  return launch_skinny<OUT, BN_, 8>(x, w, scale, out, M, K, N, splits, s);
}

template <typename OUT>
int launch_wide(const __nv_bfloat16* x, const int8_t* w, const float* scale, OUT* out, int M,
                int K, int N, int splits, cudaStream_t s) {
  static size_t allowed = 0;
  using L = Wide;
  // the x-row tiles of one weight strip run next to each other (the strip is
  // read from device memory once, then from L2)
  const dim3 grid(splits, (M + L::BM_ - 1) / L::BM_, (N + L::BN_ - 1) / L::BN_);
  return launch_clustered(qmm_wide_kernel<OUT>, allowed, grid, L::THREADS, L::SMEM,
                          splits, s, x, w, scale, out, M, K, N, splits);
}

// form 0 = skinny (bn 64, 128 or 256, M <= 64), 1 = wide (bn 128)
template <typename OUT>
int launch_bf16(const __nv_bfloat16* x, const int8_t* w, const float* scale, OUT* out,
                int M, int K, int N, int form, int bn, int splits, cudaStream_t s) {
  if (splits < 1 || splits > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0 && M <= 64) {
    if (bn == 64) return skinny_rows<OUT, 64>(x, w, scale, out, M, K, N, splits, s);
    if (bn == 128) return skinny_rows<OUT, 128>(x, w, scale, out, M, K, N, splits, s);
    if (bn == 256) return skinny_rows<OUT, 256>(x, w, scale, out, M, K, N, splits, s);
  } else if (form == 1 && bn == Wide::BN_) {
    return launch_wide<OUT>(x, w, scale, out, M, K, N, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The dynamic shared memory of a bf16 launch (form, bn) at M rows, or -1
// for a form the kernel does not have: ops/cuda/quant_matmul.py:
// Plan.smem_bytes restates it, and the card tests hold the two equal.
extern "C" int hydra_quant_matmul_smem(int form, int bn, int M) {
  if (form == 0 && M <= 64) {
    if (bn == 64) return skinny_smem<64>(M);
    if (bn == 128) return skinny_smem<128>(M);
    if (bn == 256) return skinny_smem<256>(M);
  } else if (form == 1 && bn == Wide::BN_) {
    return Wide::SMEM;
  }
  return -1;
}

// (form, bn, splits) are ops/cuda/quant_matmul.py:plan's choice for bf16 x;
// f32 x takes the FMA tile and ignores them.
extern "C" int hydra_quant_matmul(const void* x, const void* w, const void* scale,
                                  void* out, int M, int K, int N, int x_dtype,
                                  int out_dtype, int form, int bn, int splits,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (x_dtype == kBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (out_dtype == kBF16)
      return launch_bf16(xb, wq, sc, static_cast<__nv_bfloat16*>(out), M, K, N, form, bn,
                         splits, s);
    if (out_dtype == kF32)
      return launch_bf16(xb, wq, sc, static_cast<float*>(out), M, K, N, form, bn, splits, s);
    return -1;
  }
  if (x_dtype != kF32) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* xf = static_cast<const float*>(x);
  if (out_dtype == kF32)
    qmm_f32_kernel<float><<<grid, 256, 0, s>>>(xf, wq, sc, static_cast<float*>(out), M, K, N);
  else if (out_dtype == kBF16)
    qmm_f32_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        xf, wq, sc, static_cast<__nv_bfloat16*>(out), M, K, N);
  else
    return -1;
  return launch_status();
}
