// K4, int4 weights: the forms of quant_matmul.cuh over (K/2, N) packed bytes
// (two k a byte, the low nibble first), with a per-column scale or one per
// (group, column). Replaces no pallas_call: the JAX package's int4
// (hydrainfer_tpu/ops/quant.py:86 quantize_int4) runs through XLA's
// dequant-in-dot (ops/quant.py:169-203). Bound at decode: the packed read,
// half of int8's bytes, plus the group scales; its skinny K tile is 128 deep,
// so a stage carries int8's bytes.
#include "quant_matmul.cuh"

// The dynamic shared memory of a bf16 launch (form, bn) at M rows, with or
// without group scales, or -1.
extern "C" int hydra_quant_matmul_int4_smem(int form, int bn, int M, int grouped) {
  return grouped ? smem_of<kWI4, true>(form, bn, M) : smem_of<kWI4, false>(form, bn, M);
}

// group > 0: scale is (K / group, N), applied to the weight before the
// product; 0: scale is (N,), applied to the sum.
extern "C" int hydra_quant_matmul_int4(const void* x, const void* w, const void* scale,
                                       void* out, int M, int K, int N, int group,
                                       int x_dtype, int out_dtype, int form, int bn,
                                       int splits, void* stream) {
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return group > 0 ? run<kWI4, true>(x, w, scale, out, M, K, N, group, x_dtype, out_dtype,
                                     form, bn, splits, stream)
                   : run<kWI4, false>(x, w, scale, out, M, K, N, 0, x_dtype, out_dtype, form,
                                      bn, splits, stream);
}
