// K4, fp8 weights: the forms of quant_matmul.cuh over (K, N) float8_e4m3fn,
// converted to bf16 exactly in registers (cvt in the skinny and wide forms,
// bit placement in the tma form), with a per-column scale or one per (group,
// column). Replaces no pallas_call: the JAX package's fp8
// (hydrainfer_tpu/ops/quant.py:107 quantize_fp8) runs through XLA's
// dequant-in-dot (ops/quant.py:169-203). Bound at decode: the weight read,
// int8's bytes.
#include "quant_matmul.cuh"

extern "C" int hydra_quant_matmul_fp8_smem(int form, int bn, int M, int grouped) {
  return grouped ? smem_of<kWE4M3, true>(form, bn, M) : smem_of<kWE4M3, false>(form, bn, M);
}

// group > 0: scale is (K / group, N), applied to the weight before the
// product; 0: scale is (N,), applied to the sum.
extern "C" int hydra_quant_matmul_fp8(const void* x, const void* w, const void* scale,
                                      void* out, int M, int K, int N, int group,
                                      int x_dtype, int out_dtype, int form, int bn,
                                      int splits, void* stream) {
  return group > 0 ? run<kWE4M3, true>(x, w, scale, out, M, K, N, group, x_dtype, out_dtype,
                                       form, bn, splits, stream)
                   : run<kWE4M3, false>(x, w, scale, out, M, K, N, 0, x_dtype, out_dtype,
                                        form, bn, splits, stream);
}
