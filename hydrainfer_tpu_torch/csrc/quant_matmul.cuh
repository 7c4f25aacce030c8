// K4: weight-only GEMM, out = x @ dequant(w), the weight converted in-kernel.
//
// The templates of every K4 form; quant_matmul.cu (int8),
// quant_matmul_int4.cu and quant_matmul_fp8.cu instantiate them, one library
// each, so the three build in parallel.
//
// int8 replaces hydrainfer_tpu/ops/pallas/quant_matmul.py:41
// quant_matmul_int8 (its pallas_call at :64; dispatched by ops/quant.py:
// qmatmul and qmatmul_f32). int4 and fp8 replace no pallas_call: the JAX
// package runs them through XLA's dequant-in-dot (hydrainfer_tpu/ops/
// quant.py:169-203). Here they are the same kernel with another conversion,
// so the packed weight is read once and a dequantized weight never exists in
// device memory.
//
// x is (M, K) bf16 or f32; out is (M, N) bf16 or f32, the sum in f32. The
// weight, in the JAX package's layouts (ops/quant.py):
// - int8: (K, N) int8, row-major;
// - e4m3: (K, N) float8_e4m3fn;
// - int4: (K/2, N) bytes, row i holding k = 2i in its low nibble and k = 2i + 1
//   in its high one, two's complement in [-7, 7].
// Its scale is either per column, (N,) f32, applied to the f32 sum
// (out = (x . q) s, JAX's qmatmul without a group), or per (group, column),
// (K/group, N) f32, applied to the converted weight, which is then rounded to
// bf16 before the product (out = x . bf16(q s), JAX's dequantize(w, x.dtype)
// then the dot: the f32 product q s, two at a time through
// cvt.rn.bf16x2.f32). A group divides 64 or is a multiple of it, so each
// 16-deep K step lies in one group; a K tile's group rows (one for each group
// the tile touches) ride the ring with it.
//
// The TPU kernel carries its f32 sum across a sequential grid axis over K.
// Here the K range is cut into `splits` slices that run in parallel as the
// blocks of one thread-block cluster; the cluster sums the slices' partial
// tiles through distributed shared memory in a fixed order (rank 0 first),
// then scales and casts: deterministic, one launch, no scratch in device
// memory, so it also runs under CUDA-graph capture. The form, the column
// strip, the split count and the K tile come from ops/cuda/quant_matmul.py:
// plan(M, K, N, fmt) (shapes and format only); this file does not re-derive
// them.
//
// Three bf16 forms:
// - skinny (M <= 64: every decode step and lm_head call). Bound: the weight
//   read (bytes). The operands are swapped, out^T = w^T x^T on mma.sync
//   m16n8k16, so N fills the 16-row side and the activation rows the 8-wide
//   side (M = 16 wastes nothing). A block owns a 64-, 128- or 256-column
//   strip and one K slice; 16-byte cp.async streams the weight and x tiles
//   through a 4-stage ring. Every format's stage carries 64 weight byte
//   rows: the K tile is 64 deep for int8 and fp8 and 128 deep for int4 (two
//   k a byte), so int4 keeps int8's bytes in flight with int8's strips and
//   splits. 4 or 8 warps span the strip's columns. Each warp reads its
//   columns of the weight tile with ldmatrix.trans and converts them to bf16
//   A fragments in registers, with no repack of the weight and no bf16 copy
//   of the tile. One A register
//   holds two consecutive k of one column: for the 8-bit formats two bytes of
//   two rows (e4m3 by cvt.rn.f16x2.e4m3x2, then f16 -> f32 -> bf16), for
//   int4 one packed byte, turned into bf16x2 by one prmt, one lop3 (the
//   nibbles XOR 8 under the exponent of 128) and one bf16x2 subtraction of
//   136. A lane holds its columns' group scales in registers from the K step
//   where a group starts to the next group's.
// - tma (M > 64, int4 and fp8, N a multiple of 16 and K of 8: every prefill
//   chunk and lm_head of the serving paths). Bound: tensor-core operations.
//   Warp-specialized: 384 threads, one producer warpgroup and two consumer
//   warpgroups. One producer thread streams each K tile (64 deep) with TMA
//   (cp.async.bulk.tensor; the descriptors are __grid_constant__ kernel
//   parameters made for each launch, so a CUDA graph's replay reads the
//   weight it was captured with) into a ring of 5 stages (6 at 128 x rows):
//   the x rows and the 128 weight columns (64 byte rows, 32 for int4) each
//   in the 128-byte swizzle, and the tile's group-scale rows. Each stage has
//   a full mbarrier (the producer's expected bytes) and an empty one (one
//   arrival from each consumer warp); there is no block barrier in the K
//   loop. setmaxnreg moves registers from the producer (40) to the consumers
//   (232). Each consumer warpgroup owns 64 weight columns (one m64 tile) and
//   runs wgmma m64n256k16 over 256 x rows (m64n128k16 over 128 where M <=
//   128) with A, its weight, converted from the ring into registers (int4 as
//   in the skinny form; e4m3 by placing its sign, exponent and mantissa in
//   bf16's bit positions and multiplying by 2^120 in bf16, exact for every
//   code; NaN codes give bf16 NaN), and B the x tile read by descriptor. A
//   fragments rotate through four register sets, so three wgmma groups stay
//   in flight while the next K step converts. Split in 2 or 3 where the
//   tiles alone leave the card's SMs idle (one block an SM: a cluster of 4 or
//   more such blocks leaves SMs of a GPC unused, and timed slower).
// - wide (M > 64 otherwise: int8, and the int4 / fp8 shapes whose rows TMA
//   cannot address: N not a multiple of 16 or K not of 8, or an operand not
//   16-byte aligned; chosen by shape and address, not on failure). The
//   operands are swapped again; each of two warpgroups runs wgmma
//   m64n128k16 with A (its 64 weight columns) converted from the ring into
//   registers as in the skinny form, and B the 128-row x tile in the
//   128-byte swizzle (BK = 64), read from the ring by descriptor. A 4-stage
//   cp.async ring keeps two tiles loading; tile t's wgmma group runs while
//   tile t + 1 is converted. Split where the tiles alone do not fill the
//   card. It reaches about a third of the bf16 peak: each 128 x 128 tile
//   re-reads its x rows and weight strip from L2 (no multicast), and each K
//   tile ends in a block barrier.
// Ragged K tails and the M and N edges are zero-filled, and so are the
// group-scale rows that a ragged last K tile reaches past the last group: by
// cp.async with a source size of 0 (a 16-byte piece that crosses the N or K
// edge or is not 16-byte aligned is read with masked scalar loads instead),
// or by TMA's out-of-bounds fill.
//
// f32 activations (the f32 correctness configuration, on no timed path) take
// a plain FMA tile.
//
// ptxas (-Xptxas -v, sm_90a): chip_smoke.py's build phase writes every
// entry's registers and spills to ptxas.json; PERF.md lists them by form.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64, BN = 64;    // the f32 form's output tile
constexpr int STAGES = 4;          // cp.async ring depth of the skinny and wide forms

// weight formats
enum WeightFormat { kWI8 = 0, kWE4M3 = 1, kWI4 = 2 };

// rows of the weight array that a K tile of depth bk covers
template <int FMT>
__host__ __device__ constexpr int weight_rows(int bk) {
  return FMT == kWI4 ? bk / 2 : bk;
}

// the skinny form's K tile: 64 weight byte rows in every format
template <int FMT>
__host__ __device__ constexpr int skinny_bk() {
  return FMT == kWI4 ? 128 : 64;
}

// A group the kernel takes: each 16-deep K step in one group.
static inline bool group_ok(int group) {
  return group > 0 && group % 16 == 0 && (group % 64 == 0 || 64 % group == 0);
}

// ------------------------------------------------------------- bit helpers

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// (a & b) ^ c in one instruction
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ------------------------------------------------------------- tile loaders

// One 16-byte piece of the weight: row `row` of `rows`, bytes n..n+15.
__device__ __forceinline__ void load_w16(int8_t* dst, const int8_t* __restrict__ w, int row,
                                         int n, int rows, int N) {
  if (row >= rows || n >= N) {
    cp_async16(dst, w, 0);
    return;
  }
  const int8_t* src = w + static_cast<long long>(row) * N + n;
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

// One 16-byte piece of the group scales: row `row` of `rows`, columns n..n+3.
__device__ __forceinline__ void load_s16(float* dst, const float* __restrict__ s, int row,
                                         int n, int rows, int N) {
  if (row >= rows || n >= N) {
    cp_async16(dst, s, 0);
    return;
  }
  const float* src = s + static_cast<long long>(row) * N + n;
  if (n + 4 <= N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
    return;
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v[j] = src[j];
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The group-scale rows of the K tile [k0, k0 + bk), columns n0..n0+BN_-1,
// into `ss` (BN_ floats a row): row h holds group k0 / group + h, for each
// group the tile's K steps reach (at most SR), past K too: the K loop runs
// every step of a ragged last tile, so a row of a group past the last one is
// written as zeros (the weight there is zero-filled; a stale word would make
// its product NaN). A K step at k reads row k / group - k0 / group.
template <int BN_, int SR, int THREADS>
__device__ __forceinline__ void load_group_scales(float* ss, const float* __restrict__ gs,
                                                  int k0, int bk, int n0, int K, int N,
                                                  int group) {
  const int groups = (K + group - 1) / group;
  const int g0 = k0 / group;
  const int rows = min(SR, (k0 + bk - 1) / group - g0 + 1);
  for (int c = static_cast<int>(threadIdx.x); c < rows * (BN_ / 4); c += THREADS) {
    const int h = c / (BN_ / 4), col = (c % (BN_ / 4)) * 4;
    load_s16(ss + h * BN_ + col, gs, g0 + h, n0 + col, groups, N);
  }
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
// sums the partials of ranks 0, 1, ... in that order, scales by the column
// scale (none: `scale` null, a group form) and stores. Every thread of the
// block calls it; those with tid < 0 (a tma block's producer warpgroup) only
// take part in the two cluster barriers, the others (tid in [0, THREADS))
// share the work.
template <typename OUT, int THREADS>
__device__ __forceinline__ void cluster_merge_store(float* red, int rows, int cols,
                                                    int RS, int m0, int n0, int M, int N,
                                                    const float* __restrict__ scale,
                                                    OUT* __restrict__ out, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                                      // every partial is written
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int live = min(rows, M - m0);
  const int groups = cols / 4;
  if (tid >= 0) {
    for (int i = rank * THREADS + tid; i < live * groups; i += S * THREADS) {
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
        if (n + j < N) o[j] = from_f32<OUT>(scale != nullptr ? sv[j] * scale[n + j] : sv[j]);
    }
  }
  cluster.sync();                      // no block leaves while its tile is read
}

// ------------------------------------------------ weights to bf16 A fragments

// Two 8x8 b16 matrices from shared memory, transposed; lanes 0-15 give the
// row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Two int8 values at bits 0-7 and 16-23 of t (zeros elsewhere) -> bf16x2,
// exactly: 128 + (b & 127) minus 128 + (b & 128), both held exactly by a
// bf16 of exponent 2^7 (0x4300 | low 7 bits; 0x4300 or 0x4380).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t t) {
  const uint32_t v = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (t & 0x00800080u) | 0x43004300u;
  return bf16x2_bits(__hsub2(as_bf16x2(v), as_bf16x2(s)));
}

// Two e4m3 values in the low 16 bits (the first in the low byte) -> bf16x2,
// exactly: cvt.rn.f16x2.e4m3x2 (every e4m3 value, subnormals included, is an
// f16), then f16 -> f32 -> bf16, exact again. The skinny and wide forms'
// conversion: bit placement (below) takes more instructions, and the fp8
// skinny form timed 7-14% slower with it on an H100 (PERF.md).
__device__ __forceinline__ uint32_t e4m3pair_to_bf16x2(uint32_t b16) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(b16), __NV_E4M3);
  return bf16x2_bits(__float22bfloat162_rn(__half22float2(__half2(h))));
}

// Two e4m3 codes -> bf16x2 by bit placement: `sel` (a prmt selector) puts
// the first code in byte 0 and its sign replicated in byte 1, the second in
// byte 2 and its sign in byte 3. Shifted left by 4, each code's exponent and
// mantissa bits (eeeemmm) land on bf16's bits 4-10 (the low four exponent
// bits and the top three mantissa bits) and its sign on bit 15: the bf16
// 2^(e - 127) 1.mmm, or 2^-126 0.mmm for e = 0, which 2^120 (bf16 0x7B80)
// turns into e4m3's 2^(e - 7) 1.mmm or 2^-6 0.mmm, exactly (bf16 products
// keep subnormal inputs). The codes 0x7F and 0xFF (NaN; no finite e4m3
// reaches 480) come out as 480 and are replaced by bf16's NaN, 0x7FFF, as
// cvt gives them. The tma form's conversion (cvt timed 3-4% faster there
// too on an H100, PERF.md: one conversion is the next step).
__device__ __forceinline__ uint32_t e4m3_place_bf16x2(uint32_t src, uint32_t sel) {
  const uint32_t r = (prmt(src, 0u, sel) << 4) & 0x87F087F0u;
  const uint32_t y = bf16x2_bits(__hmul2(as_bf16x2(r), as_bf16x2(0x7B807B80u)));
  uint32_t nan;
  asm("set.eq.u32.bf16x2 %0, %1, %2;\n" : "=r"(nan) : "r"(y & 0x7FFF7FFFu), "r"(0x43F043F0u));
  return (y & ~nan) | (0x7FFF7FFFu & nan);
}

// The nibbles of byte j of p (k even low, k odd high) -> bf16x2, exactly:
// p4 = p >> 4 holds the high nibble in the low half of byte j, so one prmt
// puts the low nibble at bits 0-3 and the high one at bits 16-19; one lop3
// keeps them and XORs 8 under 0x4300 (bf16 128 + (n ^ 8), and n ^ 8 = v + 8
// for the two's complement v); subtracting 136 leaves v.
template <int J>
__device__ __forceinline__ uint32_t i4_to_bf16x2(uint32_t p, uint32_t p4) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t v = and_xor(prmt(p, p4, sel), 0x000F000Fu, 0x43084308u);
  return bf16x2_bits(__hsub2(as_bf16x2(v), as_bf16x2(0x43084308u)));
}

// A converted pair times its column's group scale, in f32, rounded to bf16
// (JAX's dequantize(w, bf16): f32(q) * s, then the cast), the two values in
// one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t scaled(uint32_t v, float s) {
  const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xFFFF0000u);
  return pack_bf16(lo * s, hi * s);
}

// The A fragment of one m16 tile of w^T and one 16-deep K step, 8-bit
// formats. ldmatrix.trans of the [k][n] byte tile as b16 pairs of columns
// gives lane (g, t) w[2t][2g], w[2t][2g+1], w[2t+1][2g], w[2t+1][2g+1] of an
// 8 x 16-byte block: bytes 0 and 2 are the A fragment (k 2t, 2t+1) of tile
// row g standing for column 2g, bytes 1 and 3 that of row g + 8 standing for
// column 2g + 1. `lo` holds k rows 0-7 of the step, `hi` rows 8-15; s.x and
// s.y are the group scales of columns 2g and 2g + 1. PLACE: e4m3 by bit
// placement (the tma form), else by cvt.
template <int FMT, bool GROUP, bool PLACE = false>
__device__ __forceinline__ void a_frag8(uint32_t (&a)[4], uint32_t lo, uint32_t hi, float2 s) {
  if constexpr (FMT == kWI8) {
    a[0] = i8pair_to_bf16x2(__byte_perm(lo, 0, 0x4240));
    a[1] = i8pair_to_bf16x2(__byte_perm(lo, 0, 0x4341));
    a[2] = i8pair_to_bf16x2(__byte_perm(hi, 0, 0x4240));
    a[3] = i8pair_to_bf16x2(__byte_perm(hi, 0, 0x4341));
  } else if constexpr (PLACE) {
    a[0] = e4m3_place_bf16x2(lo, 0xA280u);
    a[1] = e4m3_place_bf16x2(lo, 0xB391u);
    a[2] = e4m3_place_bf16x2(hi, 0xA280u);
    a[3] = e4m3_place_bf16x2(hi, 0xB391u);
  } else {
    a[0] = e4m3pair_to_bf16x2(__byte_perm(lo, 0, 0x4420));
    a[1] = e4m3pair_to_bf16x2(__byte_perm(lo, 0, 0x4431));
    a[2] = e4m3pair_to_bf16x2(__byte_perm(hi, 0, 0x4420));
    a[3] = e4m3pair_to_bf16x2(__byte_perm(hi, 0, 0x4431));
  }
  if constexpr (GROUP) {
    a[0] = scaled(a[0], s.x);
    a[1] = scaled(a[1], s.y);
    a[2] = scaled(a[2], s.x);
    a[3] = scaled(a[3], s.y);
  }
}

// The same for int4. The packed tile has 8 byte rows a K step (row i = k 2i,
// 2i + 1); ldmatrix.trans reads them in the order 0, 4, 1, 5, 2, 6, 3, 7
// (lane r of a matrix gives row r / 2 + 4 (r % 2)), so lane (g, t) gets
// p[t][2g], p[t][2g+1], p[t+4][2g], p[t+4][2g+1]: byte j is A register j
// (k 2t, 2t+1 and 2t+8, 2t+9 of columns 2g and 2g + 1), k in its natural
// order, so x's fragments are the 8-bit formats'.
template <bool GROUP>
__device__ __forceinline__ void a_frag4(uint32_t (&a)[4], uint32_t p, float2 s) {
  const uint32_t p4 = p >> 4;
  a[0] = i4_to_bf16x2<0>(p, p4);
  a[1] = i4_to_bf16x2<1>(p, p4);
  a[2] = i4_to_bf16x2<2>(p, p4);
  a[3] = i4_to_bf16x2<3>(p, p4);
  if constexpr (GROUP) {
    a[0] = scaled(a[0], s.x);
    a[1] = scaled(a[1], s.y);
    a[2] = scaled(a[2], s.x);
    a[3] = scaled(a[3], s.y);
  }
}

// Lane `lane`'s ldmatrix.x4 row of a packed int4 tile: matrix lane / 8 is K
// step lane / 8, its row r = lane % 8 the byte row 8 (lane / 8) + r / 2 +
// 4 (r % 2).
__device__ __forceinline__ int i4_ldm_row(int lane) {
  return 8 * (lane >> 3) + ((lane & 7) >> 1) + 4 * (lane & 1);
}

// ------------------------------------------------------------- skinny form

template <int FMT, bool GROUP, int BN_, int MT>
struct Skinny {
  static constexpr int BK = skinny_bk<FMT>();
  static constexpr int WR = weight_rows<FMT>(BK);     // weight byte rows a stage: 64
  static constexpr int WARPS = BN_ == 256 ? 8 : 4, THREADS = 32 * WARPS;
  static constexpr int WN = BN_ / WARPS;               // columns of one warp
  static constexpr int AT = WN / 16;                   // its m16 A tiles (n side)
  static constexpr int KS = BK / 16;                   // K steps a tile
  static constexpr int ROWS = MT * 8;                  // x rows, padded
  static constexpr int WS = BN_ + 16;                  // weight row stride: conflict-free ldmatrix
  static constexpr int XS = BK + 8;                    // x row stride, bf16
  static constexpr int SR = KS;                        // group-scale rows a stage, at most
  static constexpr int W_BYTES = WR * WS;
  static constexpr int X_BYTES = ROWS * XS * 2;
  static constexpr int S_BYTES = GROUP ? SR * BN_ * 4 : 0;
  static constexpr int STAGE = W_BYTES + X_BYTES + S_BYTES;
  static constexpr int RS = BN_ + 4;                   // merge tile row stride, floats
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(ROWS * RS * 4 <= SMEM, "merge tile must fit the ring");
  static_assert(SMEM <= 227 * 1024, "a block has at most 227 KB of shared memory");
};

template <int FMT, bool GROUP, typename OUT, int BN_, int MT>
__global__ void __launch_bounds__(Skinny<FMT, GROUP, BN_, MT>::THREADS)
qmm_skinny_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, OUT* __restrict__ out, int M, int K,
                  int N, int group, int splits) {
  using L = Skinny<FMT, GROUP, BN_, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * BN_;
  const int w_rows = FMT == kWI4 ? K / 2 : K;         // rows of w in device memory
  int lo, hi;
  split_tiles((K + L::BK - 1) / L::BK, splits, blockIdx.x, lo, hi);
  const int n_tiles = hi - lo;

  auto load_w = [&](int slot, int tile) {
    unsigned char* st = smem + slot * L::STAGE;
    int8_t* ws = reinterpret_cast<int8_t*>(st);
    const int r0 = tile * L::WR;
#pragma unroll
    for (int c = tid; c < L::WR * (BN_ / 16); c += L::THREADS) {
      const int r = c / (BN_ / 16), col = (c % (BN_ / 16)) * 16;
      load_w16(ws + r * L::WS + col, w, r0 + r, n0 + col, w_rows, N);
    }
    if constexpr (GROUP)
      load_group_scales<BN_, L::SR, L::THREADS>(
          reinterpret_cast<float*>(st + L::W_BYTES + L::X_BYTES), scale, tile * L::BK, L::BK, n0,
          K, N, group);
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
  // 8-bit formats: this lane's ldmatrix row k = kk * 16 + (lane & 7) + 8 *
  // ((lane >> 3) & 1), 16-column group lane >> 4 of the warp's columns; int4:
  // its byte row i4_ldm_row(lane) of each 32-row half of the tile, every A
  // tile by its own x4
  const int a_off = FMT == kWI4
                        ? i4_ldm_row(lane) * L::WS + warp * L::WN
                        : ((lane & 7) + ((lane >> 3) & 1) * 8) * L::WS + warp * L::WN +
                              (L::AT == 2 ? (lane >> 4) * 16 : 0);
  float2 s[L::AT];              // this lane's group scales (columns 2g, 2g + 1 of each A tile)
#pragma unroll
  for (int i = 0; i < L::AT; ++i) s[i] = make_float2(1.f, 1.f);
  // k0 % group of the current tile, kept without a division a tile: a group
  // divides the K tile (then 0) or is larger than it
  int rem = GROUP ? (lo * L::BK) % group : 0;
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
    const float* ss = reinterpret_cast<const float*>(stage + L::W_BYTES + L::X_BYTES) +
                      warp * L::WN + 2 * g;
    // the stage's scale row (row h: group k0 / group + h) and the tile
    // offset where the next group starts
    int row = 0, next = GROUP ? group - rem : 0;
    uint32_t p4[L::AT][L::KS];  // int4: the tile's packed registers, K step kk in [kk]
    if constexpr (FMT == kWI4) {
#pragma unroll
      for (int i = 0; i < L::AT; ++i)
#pragma unroll
        for (int h = 0; h < L::KS / 4; ++h) {
          uint32_t q[4];
          ldmatrix_x4_trans(q, ws + h * 32 * L::WS + i * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) p4[i][4 * h + e] = q[e];
        }
    }
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      if constexpr (GROUP) {
        // a group starts at this step: its scales stay in registers until
        // the next group's
        const bool starts = kk * 16 == next;
        if (kk == 0 || starts) {
          if (starts) {
            ++row;
            next += group;
          }
#pragma unroll
          for (int i = 0; i < L::AT; ++i)
            s[i] = *reinterpret_cast<const float2*>(ss + row * BN_ + i * 16);
        }
      }
      uint32_t a[L::AT][4];
      if constexpr (FMT == kWI4) {
#pragma unroll
        for (int i = 0; i < L::AT; ++i) a_frag4<GROUP>(a[i], p4[i][kk], s[i]);
      } else {
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
#pragma unroll
        for (int i = 0; i < L::AT; ++i) a_frag8<FMT, GROUP>(a[i], r[2 * i], r[2 * i + 1], s[i]);
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const __nv_bfloat16* xr = xs + (j * 8 + g) * L::XS + kk * 16 + 2 * t4;
        const uint32_t b0 = ld32(xr), b1 = ld32(xr + 8);
#pragma unroll
        for (int i = 0; i < L::AT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    if constexpr (GROUP) {
      if (L::BK % group != 0) {
        rem += L::BK;
        if (rem >= group) rem -= group;
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
  cluster_merge_store<OUT, L::THREADS>(red, L::ROWS, BN_, L::RS, 0, n0, M, N,
                                       GROUP ? nullptr : scale, out, tid);
}

// --------------------------------------------------------- wgmma helpers

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

// d (64 x N, f32) += a (64 x 16 bf16, registers) . b (16 x N bf16, K-major
// in shared memory), N = 128 or 256
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
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

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 0;\n"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// --------------------------------------------------------------- wide form
//
// Warpgroup products (wgmma) with A from registers: out^T = w^T x^T again,
// so the converted weight never goes back to shared memory. Each of the
// block's two warpgroups owns 64 weight columns, one m64 tile of A, read from
// the weight ring by ldmatrix.trans and converted in registers as in the
// skinny form (A rows 0-7 of a warp's 16 columns = the even columns, 8-15 =
// the odd ones); B is the x tile, 128 rows x 64 bf16 (128 bytes), K-major in
// the 128-byte swizzle (16-byte piece c of row r at piece c ^ (r % 8)),
// written so by cp.async and read by the descriptor. Each K tile is one
// wgmma group of 4 k16 steps; the group of tile t runs while the block
// converts tile t + 1, and tile t + 2 loads meanwhile.

template <int FMT, bool GROUP>
struct Wide {
  static constexpr int BM_ = 128;                      // x rows: the n of wgmma
  static constexpr int BN_ = 128;                      // weight columns: 64 a warpgroup
  static constexpr int BK = 64;                        // one 128-byte swizzle row of x
  static constexpr int WR = weight_rows<FMT>(BK);
  static constexpr int THREADS = 256;
  // tiles loading ahead of the one being converted: one wgmma group stays
  // running, and a slot is reloaded only once the group that read it has
  // been waited for
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int WS = BN_ + 16;                  // weight row stride: conflict-free ldmatrix
  static constexpr int X_BYTES = BM_ * BK * 2;
  static constexpr int W_BYTES = WR * WS;
  static constexpr int S_BYTES = GROUP ? 4 * BN_ * 4 : 0;
  // every x tile starts 1024-byte aligned
  static constexpr int STAGE = (X_BYTES + W_BYTES + S_BYTES + 1023) / 1024 * 1024;
  static constexpr int RS = BN_ + 4;                   // merge tile row stride, floats
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + the 1024-byte alignment
  static_assert(BM_ * RS * 4 <= STAGES * STAGE, "merge tile must fit the ring");
  static_assert(SMEM <= 227 * 1024, "a block has at most 227 KB of shared memory");
};

template <int FMT, bool GROUP, typename OUT>
__global__ void __launch_bounds__(256)
qmm_wide_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, OUT* __restrict__ out, int M, int K, int N,
                int group, int splits) {
  using L = Wide<FMT, GROUP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;             // warpgroup, its warp
  const int m0 = blockIdx.y * L::BM_, n0 = blockIdx.z * L::BN_;
  const int w_rows = FMT == kWI4 ? K / 2 : K;
  const int span = GROUP ? min(group, 64) : 64;
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
    const int r0 = tile * L::WR;
#pragma unroll
    for (int c = tid; c < L::WR * (L::BN_ / 16); c += L::THREADS) {
      const int r = c / (L::BN_ / 16), col = (c % (L::BN_ / 16)) * 16;
      load_w16(ws + r * L::WS + col, w, r0 + r, n0 + col, w_rows, N);
    }
    // a 64-deep tile touches 64 / span groups (span = min(group, 64)): row
    // h = group (k0 + h span) / group, as a K step kk reads it
    if constexpr (GROUP)
      load_group_scales<L::BN_, 4, L::THREADS>(
          reinterpret_cast<float*>(st + L::X_BYTES + L::W_BYTES), scale, k0, L::BK, n0, K, N,
          group);
  };

  float acc[L::BM_ / 2];
#pragma unroll
  for (int e = 0; e < L::BM_ / 2; ++e) acc[e] = 0.f;

  prefetch<L::AHEAD>(load, lo, n_tiles);
  // this lane's ldmatrix row (8-bit: k = kk * 16 + (lane & 7) + 8 * ((lane >>
  // 3) & 1); int4: i4_ldm_row); the warp's weight columns wg * 64 + wq * 16 ..
  const int a_off = (FMT == kWI4 ? i4_ldm_row(lane)
                                 : (lane & 7) + ((lane >> 3) & 1) * 8) * L::WS +
                    wg * 64 + wq * 16;
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
    const float* ss = reinterpret_cast<const float*>(st + L::X_BYTES + L::W_BYTES) + wg * 64 +
                      wq * 16 + 2 * g;
    uint32_t p4[4];
    if constexpr (FMT == kWI4) ldmatrix_x4_trans(p4, ws);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 s = GROUP ? *reinterpret_cast<const float2*>(ss + (kk * 16 / span) * L::BN_)
                             : make_float2(1.f, 1.f);
      if constexpr (FMT == kWI4) {
        a_frag4<GROUP>(a[kk], p4[kk], s);
      } else {
        uint32_t r[2];
        ldmatrix_x2_trans(r, ws + kk * 16 * L::WS);
        a_frag8<FMT, GROUP>(a[kk], r[0], r[1], s);
      }
    }
    const uint64_t desc = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<128>(acc, a[kk], desc + 2 * kk);
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
  cluster_merge_store<OUT, L::THREADS>(red, L::BM_, L::BN_, L::RS, m0, n0, M, N,
                                       GROUP ? nullptr : scale, out, tid);
}

// ---------------------------------------------------------------- tma form
//
// One producer warpgroup (its first thread issues every TMA load) and two
// consumer warpgroups over a ring of STAGES_ stages. Stage layout, each piece
// 1024-byte aligned: the x tile (BM_ rows x 64 bf16, the 128-byte swizzle),
// the weight tile (WR byte rows x 128 columns, the same swizzle: 16-byte
// piece c of row r at piece c ^ (r % 8)), then, with groups, the tile's
// group-scale rows (128 floats a row, row h = group k0 / group + h).
// Consumer warpgroup wg owns weight columns wg * 64 + [0, 64), one m64 A
// tile, against all BM_ x rows (wgmma n = BM_: 256, or 128 where M <= 128),
// so each converted weight value feeds BM_ products. Its A fragments rotate
// through four register sets: the conversion of K step q waits only for
// step q - 4's group, and three groups stay in flight behind it.


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// the producer's arrival, with the bytes the stage's TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// A 2-D TMA load of the box at (c0 innermost, c1) into dst, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier 1 over the block's 384 threads, reached from the producer's and
// the consumers' separate paths.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 1, 384;\n" ::: "memory");
}

// Byte offset of (row r, 16-byte piece c) in a 128-byte-swizzled tile.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

template <int FMT, bool GROUP, int BM>
struct Tma {
  static constexpr int BM_ = BM;                       // x rows: the n of wgmma, 128 or 256
  static constexpr int BN_ = 128;                      // weight columns: 64 a consumer warpgroup
  static constexpr int BK = 64;
  static constexpr int WR = weight_rows<FMT>(BK);     // weight byte rows a K tile
  static constexpr int THREADS = 384;
  static constexpr int STAGES_ = BM == 256 ? 5 : 6;
  static constexpr int X_BYTES = BM_ * BK * 2;
  static constexpr int W_BYTES = WR * BN_;
  static constexpr int S_ROWS = 4;                     // group rows a K tile, at most
  static constexpr int S_BYTES = GROUP ? S_ROWS * BN_ * 4 : 0;
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int RS = BN_ + 4;                   // merge tile row stride, floats
  static constexpr int RED = BM_ * RS * 4;
  static constexpr int BODY = STAGES_ * STAGE > RED ? STAGES_ * STAGE : RED;
  // the ring (or the merge tile), the full and empty barriers, the alignment
  static constexpr int SMEM = BODY + 2 * STAGES_ * 8 + 1024;
  static_assert(STAGE % 1024 == 0 && W_BYTES % 1024 == 0, "swizzled tiles are 1024-aligned");
  static_assert(SMEM <= 227 * 1024, "a block has at most 227 KB of shared memory");
};

template <int FMT, bool GROUP, typename OUT, int BM>
__global__ void __launch_bounds__(384, 1)
qmm_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap ts, const float* __restrict__ scale,
               OUT* __restrict__ out, int M, int K, int N, int group, int splits) {
  using L = Tma<FMT, GROUP, BM>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BODY);
  uint64_t* empty = full + L::STAGES_;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * L::BM_, n0 = blockIdx.z * L::BN_;
  int lo, hi;
  split_tiles((K + L::BK - 1) / L::BK, splits, blockIdx.x, lo, hi);
  const int n_tiles = hi - lo;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES_; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                         // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = (warp >> 2) - 1, wq = warp & 3;       // consumer warpgroup (-1: producer)
  const int g = lane >> 2, t4 = lane & 3;
  float* red = reinterpret_cast<float*>(smem);
  // The two roles hold different register counts after setmaxnreg, so their
  // paths never join: each ends in its own copy of the block barrier (ring
  // free) and of the cluster merge.
  if (wg < 0) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      const uint32_t bytes =
          L::X_BYTES + L::W_BYTES + (GROUP ? (group >= 64 ? 1 : 64 / group) * L::BN_ * 4 : 0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % L::STAGES_, k = lo + t;
        // the consumers have released what the slot held STAGES_ tiles ago
        if (t >= L::STAGES_) mbar_wait(&empty[s], ((t / L::STAGES_) + 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], bytes);
        tma_load(st, &tx, &full[s], k * L::BK, m0);
        tma_load(st + L::X_BYTES, &tw, &full[s], n0, k * L::WR);
        if constexpr (GROUP)
          tma_load(st + L::X_BYTES + L::W_BYTES, &ts, &full[s], n0, k * L::BK / group);
      }
    }
    block_sync();               // the consumers are done with the ring
    cluster_merge_store<OUT, 256>(red, L::BM_, L::BN_, L::RS, m0, n0, M, N,
                                  GROUP ? nullptr : scale, out, -1);
    return;
  }
  setmaxnreg_inc<232>();
  float acc[L::BM_ / 2];        // the warpgroup's m64 x BM_ tile of out^T
#pragma unroll
  for (int e = 0; e < L::BM_ / 2; ++e) acc[e] = 0.f;
  const int span = GROUP ? min(group, 64) : 64;
  // this lane's ldmatrix row (8-bit: k = kk * 16 + rl; int4: the packed
  // row), the 16-byte piece of its warp's 16 columns (4 wg + wq) and their
  // scales
  const int rl = FMT == kWI4 ? i4_ldm_row(lane) : (lane & 7) + ((lane >> 3) & 1) * 8;
  const int piece = 4 * wg + wq;
  uint32_t a[4][4];             // the A fragments of K steps 0-3 of a tile
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::STAGES_;
    mbar_wait(&full[s], (t / L::STAGES_) & 1);
    const unsigned char* st = smem + s * L::STAGE;
    const unsigned char* ws = st + L::X_BYTES;
    const float* ss =
        reinterpret_cast<const float*>(ws + L::W_BYTES) + wg * 64 + wq * 16 + 2 * g;
    const uint64_t desc = sw128_desc(st);
    uint32_t p4[4];
    if constexpr (FMT == kWI4) ldmatrix_x4_trans(p4, ws + sw128(rl, piece));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // set kk was last read by step kk of the tile before, four groups ago:
      // the wait below leaves at most three in flight
      const float2 sc = GROUP ? *reinterpret_cast<const float2*>(ss + (kk * 16 / span) * L::BN_)
                              : make_float2(1.f, 1.f);
      if constexpr (FMT == kWI4) {
        a_frag4<GROUP>(a[kk], p4[kk], sc);
      } else {
        uint32_t r[2];
        ldmatrix_x2_trans(r, ws + sw128(kk * 16 + rl, piece));
        a_frag8<FMT, GROUP, true>(a[kk], r[0], r[1], sc);
      }
      wgmma_fence();
      wgmma_rs<L::BM_>(acc, a[kk], desc + 2 * kk);
      wgmma_commit();
      wgmma_wait<3>();
      // step 3 of the tile before is done: its x slot is no longer read
      if (kk == 2 && t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % L::STAGES_]);
    }
  }
  wgmma_wait<0>();
  block_sync();                 // every consumer is done with the ring: it holds the partial tile now

  // acc holds out^T: d[4j + h] = (column 2g, x row 8j + 2 t4 + h), d[4j + 2 +
  // h] = (column 2g + 1, the same row), columns counted from the warp's 16
  const int c0 = wg * 64 + wq * 16 + 2 * g;
#pragma unroll
  for (int j = 0; j < L::BM_ / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (8 * j + 2 * t4 + h) * L::RS + c0) =
          make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
  cluster_merge_store<OUT, 256>(red, L::BM_, L::BN_, L::RS, m0, n0, M, N,
                                GROUP ? nullptr : scale, out, tid - 128);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a row-major (rows, cols) array of `elem`-byte elements, boxes of
// box_rows x box_cols, zeros outside the array.
static int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int elem,
                      long long rows, long long cols, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estrides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tma form's shapes and addresses: TMA takes 16-byte aligned bases and
// row strides (ops/cuda/quant_matmul.py:tma_ok mirrors this).
static inline bool tma_ok(const void* x, const void* w, const void* scale, int K, int N) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return K % 8 == 0 && N % 16 == 0 && aligned(x) && aligned(w) && aligned(scale);
}

// ------------------------------------------------------------ f32 form

// Weight (k, n) as f32: the format's value, times its group scale in a group
// form (JAX's dequantize(w, f32)).
template <int FMT, bool GROUP>
__device__ __forceinline__ float weight_at(const int8_t* __restrict__ w,
                                           const float* __restrict__ scale, int k, int n,
                                           int N, int group) {
  float v;
  if constexpr (FMT == kWI8) {
    v = static_cast<float>(w[static_cast<long long>(k) * N + n]);
  } else if constexpr (FMT == kWE4M3) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<__nv_fp8_storage_t>(w[static_cast<long long>(k) * N + n]);
    v = static_cast<float>(f);
  } else {
    const uint32_t b = static_cast<uint8_t>(w[static_cast<long long>(k >> 1) * N + n]);
    const uint32_t nib = (k & 1) ? (b >> 4) : (b & 15u);
    v = static_cast<float>(static_cast<int>(nib & 7u) - static_cast<int>(nib & 8u));
  }
  if constexpr (GROUP) v *= scale[static_cast<long long>(k / group) * N + n];
  return v;
}

// f32 activations: 64x64 output tile, 256 threads, 4x4 outputs per thread.
template <int FMT, bool GROUP, typename OUT>
__global__ void __launch_bounds__(256)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, OUT* __restrict__ out, int M, int K,
               int N, int group) {
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
      Bs[r][c] = (gk < K && gn < N) ? weight_at<FMT, GROUP>(w, scale, gk, gn, N, group) : 0.0f;
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
        out[static_cast<long long>(row) * N + col] =
            from_f32<OUT>(GROUP ? acc[i][j] : acc[i][j] * scale[col]);
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

// One bf16-x launch: x, w, scale, out, M, K, N, group, splits and the stream.
template <typename OUT>
struct LaunchArgs {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  OUT* out;
  int M, K, N, group, splits;
  cudaStream_t s;
};

template <int FMT, bool GROUP, typename OUT, int BN_, int MT>
int launch_skinny(const LaunchArgs<OUT>& a) {
  static size_t allowed = 0;
  using L = Skinny<FMT, GROUP, BN_, MT>;
  const dim3 grid(a.splits, (a.N + BN_ - 1) / BN_);
  return launch_clustered(qmm_skinny_kernel<FMT, GROUP, OUT, BN_, MT>, allowed, grid,
                          L::THREADS, L::SMEM, a.splits, a.s, a.x, a.w, a.scale, a.out, a.M,
                          a.K, a.N, a.group, a.splits);
}

// padded x rows: 8 (MT = 1), 16, 32 or 64
template <int FMT, bool GROUP, int BN_>
int skinny_smem(int M) {
  return M <= 8    ? Skinny<FMT, GROUP, BN_, 1>::SMEM
         : M <= 16 ? Skinny<FMT, GROUP, BN_, 2>::SMEM
         : M <= 32 ? Skinny<FMT, GROUP, BN_, 4>::SMEM
                   : Skinny<FMT, GROUP, BN_, 8>::SMEM;
}

template <int FMT, bool GROUP, typename OUT, int BN_>
int skinny_rows(const LaunchArgs<OUT>& a) {
  if (a.M <= 8) return launch_skinny<FMT, GROUP, OUT, BN_, 1>(a);
  if (a.M <= 16) return launch_skinny<FMT, GROUP, OUT, BN_, 2>(a);
  if (a.M <= 32) return launch_skinny<FMT, GROUP, OUT, BN_, 4>(a);
  return launch_skinny<FMT, GROUP, OUT, BN_, 8>(a);
}

template <int FMT, bool GROUP, typename OUT>
int launch_wide(const LaunchArgs<OUT>& a) {
  static size_t allowed = 0;
  using L = Wide<FMT, GROUP>;
  // the x-row tiles of one weight strip run next to each other (the strip is
  // read from device memory once, then from L2)
  const dim3 grid(a.splits, (a.M + L::BM_ - 1) / L::BM_, (a.N + L::BN_ - 1) / L::BN_);
  return launch_clustered(qmm_wide_kernel<FMT, GROUP, OUT>, allowed, grid, L::THREADS,
                          L::SMEM, a.splits, a.s, a.x, a.w, a.scale, a.out, a.M, a.K, a.N,
                          a.group, a.splits);
}

// The tma form: the three maps are made for this launch's tensors; 256 x
// rows a block, 128 where M <= 128.
template <int FMT, bool GROUP, typename OUT, int BM>
int launch_tma_rows(const LaunchArgs<OUT>& a) {
  static size_t allowed = 0;
  using L = Tma<FMT, GROUP, BM>;
  if (!tma_ok(a.x, a.w, a.scale, a.K, a.N)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw, ts;
  int e = tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, 2, a.M, a.K, L::BK, L::BM_,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, 1, weight_rows<FMT>(a.K), a.N,
                   L::BN_, L::WR, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0) {
    if constexpr (GROUP)
      e = tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.scale, 4,
                     (a.K + a.group - 1) / a.group, a.N, L::BN_, a.group >= 64 ? 1 : 64 / a.group,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
    else
      ts = tw;                                         // not read
  }
  if (e != 0) return e;
  // the x-row tiles of one weight strip run next to each other
  const dim3 grid(a.splits, (a.M + L::BM_ - 1) / L::BM_, (a.N + L::BN_ - 1) / L::BN_);
  return launch_clustered(qmm_tma_kernel<FMT, GROUP, OUT, BM>, allowed, grid, L::THREADS,
                          L::SMEM, a.splits, a.s, tx, tw, ts, a.scale, a.out, a.M, a.K, a.N,
                          a.group, a.splits);
}

template <int FMT, bool GROUP, typename OUT>
int launch_tma(const LaunchArgs<OUT>& a) {
  return a.M <= 128 ? launch_tma_rows<FMT, GROUP, OUT, 128>(a)
                    : launch_tma_rows<FMT, GROUP, OUT, 256>(a);
}

// form 0 = skinny (bn 64, 128 or 256, M <= 64), 1 = wide (bn 128), 2 = tma
// (bn 128; int4 and fp8)
template <int FMT, bool GROUP, typename OUT>
int launch_bf16(const LaunchArgs<OUT>& a, int form, int bn) {
  if (a.splits < 1 || a.splits > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0 && a.M <= 64) {
    if (bn == 64) return skinny_rows<FMT, GROUP, OUT, 64>(a);
    if (bn == 128) return skinny_rows<FMT, GROUP, OUT, 128>(a);
    if (bn == 256) return skinny_rows<FMT, GROUP, OUT, 256>(a);
  } else if (form == 1 && bn == Wide<FMT, GROUP>::BN_) {
    return launch_wide<FMT, GROUP, OUT>(a);
  } else if constexpr (FMT != kWI8) {
    if (form == 2 && bn == Tma<FMT, GROUP, 256>::BN_) return launch_tma<FMT, GROUP, OUT>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a bf16 launch (form, bn) at M rows, or -1
// for a form the kernel does not have: ops/cuda/quant_matmul.py:
// Plan.smem_bytes restates it, and the card tests hold the two equal.
template <int FMT, bool GROUP>
int smem_of(int form, int bn, int M) {
  if (form == 0 && M <= 64) {
    if (bn == 64) return skinny_smem<FMT, GROUP, 64>(M);
    if (bn == 128) return skinny_smem<FMT, GROUP, 128>(M);
    if (bn == 256) return skinny_smem<FMT, GROUP, 256>(M);
  } else if (form == 1 && bn == Wide<FMT, GROUP>::BN_) {
    return Wide<FMT, GROUP>::SMEM;
  } else if constexpr (FMT != kWI8) {
    if (form == 2 && bn == Tma<FMT, GROUP, 256>::BN_)
      return M <= 128 ? Tma<FMT, GROUP, 128>::SMEM : Tma<FMT, GROUP, 256>::SMEM;
  }
  return -1;
}

// A launch of format FMT: (form, bn, splits) are ops/cuda/quant_matmul.py:
// plan's choice for bf16 x; f32 x takes the FMA tile and ignores them.
// `group` > 0 selects the group-scale form.
template <int FMT, bool GROUP>
int run(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
        int group, int x_dtype, int out_dtype, int form, int bn, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (GROUP && !group_ok(group)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (x_dtype == kBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (out_dtype == kBF16)
      return launch_bf16<FMT, GROUP>(
          LaunchArgs<__nv_bfloat16>{xb, wq, sc, static_cast<__nv_bfloat16*>(out), M, K, N, group,
                              splits, s},
          form, bn);
    if (out_dtype == kF32)
      return launch_bf16<FMT, GROUP>(
          LaunchArgs<float>{xb, wq, sc, static_cast<float*>(out), M, K, N, group, splits, s}, form,
          bn);
    return -1;
  }
  if (x_dtype != kF32) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* xf = static_cast<const float*>(x);
  if (out_dtype == kF32)
    qmm_f32_kernel<FMT, GROUP, float>
        <<<grid, 256, 0, s>>>(xf, wq, sc, static_cast<float*>(out), M, K, N, group);
  else if (out_dtype == kBF16)
    qmm_f32_kernel<FMT, GROUP, __nv_bfloat16>
        <<<grid, 256, 0, s>>>(xf, wq, sc, static_cast<__nv_bfloat16*>(out), M, K, N, group);
  else
    return -1;
  return launch_status();
}

}  // namespace
