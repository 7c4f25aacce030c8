"""K1, the port's decode attention (ops/cuda/mha_decode.py), against the JAX
Pallas decode kernel (ops/pallas/mha_decode.py) in interpret mode, on the CPU.

Cases come from tests/ops/test_paged_attention.py:build_case (numpy, seeded):
one query token per sequence, MHA and GQA (ratios 4 and 6), multi-page walks,
padded rows and sequences, an int8 cache with a static scale, and a block
table wider than 64 pages. Tolerance 1e-4 on an f32 cache (summation order
only); 1e-2 on an int8 cache, because the JAX kernel computes int8-cache
scores and P.V with bf16 operands.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest

from hydrainfer_tpu.ops.attention import paged_attention_mha_decode
from hydrainfer_tpu_torch.ops.cuda import mha_decode_attention
from tests.test_torch_attention import SCALE, TOL, make, port_params, t

DECODE_CASES = {
    "one": ([(1, 1)], dict(H=4, KVH=4)),
    "batch": ([(1, 4), (1, 7), (1, 12)], dict(H=4, KVH=4)),
    "multi_page": ([(1, 37), (1, 21)], dict(H=4, KVH=4)),
    "padded": ([(1, 6), (1, 3)], dict(T_pad=8, S_pad=4, H=4, KVH=4)),
    "gqa_ratio_4": ([(1, 9), (1, 14)], dict(H=8, KVH=2)),
    "gqa_ratio_6": ([(1, 4), (1, 7), (1, 12)], dict(H=12, KVH=2)),
    "wide_table": ([(1, 300), (1, 7)], dict(H=4, KVH=4, n_blocks=96)),
}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_k1_matches_decode_pallas_kernel(name, int8):
    specs, kw = DECODE_CASES[name]
    q, cache, params, _ = make(specs, seed=2, int8=int8, **kw)
    scale = SCALE if int8 else None
    sm = 1.0 / float(np.sqrt(q.shape[-1]))
    ref = paged_attention_mha_decode(
        jnp.asarray(q), jnp.asarray(cache).astype(
            jnp.int8 if int8 else jnp.float32), 0, params, sm, kv_scale=scale,
        pages_per_block=2, interpret=True)
    p = port_params(params)
    got = mha_decode_attention(t(q), t(cache)[0, 0], p.kv_lens,
                               p.block_tables.clamp(min=0), p.num_seqs, sm, scale)
    n = len(specs)
    tol = dict(rtol=1e-2, atol=1e-2) if int8 else TOL
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n], **tol)
    assert np.all(got.numpy()[n:] == 0)
