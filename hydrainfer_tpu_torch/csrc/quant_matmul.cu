// K4, int8 weights: the forms of quant_matmul.cuh with the int8 conversion and
// a per-column scale. Replaces hydrainfer_tpu/ops/pallas/quant_matmul.py:41
// quant_matmul_int8 (its pallas_call at :64).
#include "quant_matmul.cuh"

// The dynamic shared memory of a bf16 launch (form, bn) at M rows, or -1.
extern "C" int hydra_quant_matmul_smem(int form, int bn, int M) {
  return smem_of<kWI8, false>(form, bn, M);
}

// (form, bn, splits) are ops/cuda/quant_matmul.py:plan's choice for bf16 x;
// f32 x takes the FMA tile and ignores them.
extern "C" int hydra_quant_matmul(const void* x, const void* w, const void* scale,
                                  void* out, int M, int K, int N, int x_dtype,
                                  int out_dtype, int form, int bn, int splits,
                                  void* stream) {
  return run<kWI8, false>(x, w, scale, out, M, K, N, 0, x_dtype, out_dtype, form, bn, splits,
                          stream);
}
