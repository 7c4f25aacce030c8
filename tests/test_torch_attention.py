"""The port's paged attention against the JAX package, on the CPU.

Cases come from tests/ops/test_paged_attention.py:build_case (numpy, seeded):
single and multi-sequence prefill, decode with history, mixed
prefill/decode/chunked batches, padded tokens and sequences, multi-page walks,
GQA ratios 4 and 6, a 70-token chunk starting mid-tile, an int8 KV cache with
a static scale, and block tables wider than 64 pages. K2
(ops/cuda/paged_attention.py) is held against the JAX Pallas layered kernel
in interpret mode; the dispatcher and `paged_attention_plain` against
`paged_attention_jnp`. Tolerance 1e-4 (f32; summation order only).
K1 has its own file, test_torch_mha_decode.py; the kernels themselves are
held against these plain versions on the card in test_torch_kernels_cuda.py.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops.attention import (paged_attention as jax_paged_attention,
                                          paged_attention_jnp)
from hydrainfer_tpu.ops.pallas.paged_attention import layered_paged_attention
from hydrainfer_tpu_torch.ops.attention import (PagedAttentionParams,
                                                paged_attention,
                                                paged_attention_plain)
from hydrainfer_tpu_torch.ops.cuda import paged_attention_varlen
from tests.ops.test_paged_attention import build_case

TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.05


def t(a):
    return torch.from_numpy(np.array(a))


def port_params(params) -> PagedAttentionParams:
    return PagedAttentionParams(**{f: t(getattr(params, f)) for f in (
        "q_seq_ids", "q_local_ids", "positions", "kv_lens", "block_tables",
        "new_kv_slot_ids", "cu_q_lens", "num_seqs")})


def make(seq_specs, seed=0, int8=False, **kw):
    q, cache, params, expected = build_case(np.random.default_rng(seed), seq_specs,
                                            **kw)
    if int8:
        cache = np.clip(np.round(cache / SCALE), -127, 127).astype(np.int8)
    return q, cache, params, expected


CASES = {
    "single_token_prefill": ([(1, 1)], {}),
    "prefill": ([(5, 5)], {}),
    "decode_history": ([(1, 9)], {}),
    "mixed_chunked": ([(6, 6), (1, 9), (3, 11)], {}),
    "padded": ([(2, 6), (1, 3)], dict(T_pad=8, S_pad=4)),
    "multi_page": ([(1, 37), (2, 21)], {}),
    "gqa_ratio_4": ([(3, 8), (1, 5)], dict(H=8, KVH=2)),
    "wide_table": ([(4, 300), (1, 270)], dict(n_blocks=160)),  # 75 pages
    # the GQA ratio of qwen2-vl-2b-lm's 12 q / 2 kv heads
    "gqa_ratio_6": ([(5, 9), (1, 7), (2, 2)], dict(H=12, KVH=2)),
    # a chunk longer than K2's 64-row tensor-core tile, starting at cache
    # position 31 (off a tile boundary), beside a decode
    "long_chunk_mid_tile": ([(70, 101), (1, 9)], {}),
}


@pytest.mark.parametrize("name,int8", [("mixed_chunked", False), ("padded", True),
                                       ("gqa_ratio_4", True), ("wide_table", False)])
def test_plain_matches_paged_attention_jnp(name, int8):
    specs, kw = CASES[name]
    q, cache, params, _ = make(specs, int8=int8, **kw)
    scale = SCALE if int8 else None
    max_q = max(ql for ql, _ in specs)
    ref = paged_attention_jnp(jnp.asarray(q), jnp.asarray(cache), 0, params,
                              1.0 / np.sqrt(q.shape[-1]), max_q, kv_scale=scale)
    got = paged_attention_plain(t(q), t(cache), 0, port_params(params),
                                1.0 / np.sqrt(q.shape[-1]), max_q, kv_scale=scale)
    n = sum(ql for ql, _ in specs)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n], **TOL)


# Pallas block sizes: (8 q rows, 2 pages) unless named. At those sizes the
# JAX kernel gets the rows of a 17- to 70-token chunk past its first q block
# wrong in interpret mode (against paged_attention_jnp; ROADMAP section 3),
# so the long chunk runs at the kernel's default sizes, where it agrees.
PALLAS_BLOCKS = {"long_chunk_mid_tile": dict(num_queries_per_block=None,
                                             num_kv_pages_per_block=None)}

K2_CASES = [(name, False) for name in sorted(CASES)] + [
    (name, True) for name in ("mixed_chunked", "padded", "gqa_ratio_4", "wide_table",
                              "gqa_ratio_6", "long_chunk_mid_tile")]


@pytest.mark.parametrize("name,int8", K2_CASES)
def test_k2_matches_layered_pallas_kernel(name, int8):
    specs, kw = CASES[name]
    q, cache, params, _ = make(specs, seed=1, int8=int8, **kw)
    scale = SCALE if int8 else None
    sm = 1.0 / float(np.sqrt(q.shape[-1]))
    ref = layered_paged_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray([0], jnp.int32),
        params.kv_lens, jnp.maximum(params.block_tables, 0), params.cu_q_lens,
        params.num_seqs, sm_scale=sm, k_scale=scale, v_scale=scale, interpret=True,
        **PALLAS_BLOCKS.get(name, dict(num_queries_per_block=8, num_kv_pages_per_block=2)))
    p = port_params(params)
    got = paged_attention_varlen(t(q), t(cache)[0, 0], p.kv_lens,
                                 p.block_tables.clamp(min=0), p.cu_q_lens,
                                 p.num_seqs, sm, scale)
    n = sum(ql for ql, _ in specs)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n], **TOL)
    assert np.all(got.numpy()[n:] == 0)          # padding rows: finite zeros


@pytest.mark.parametrize("specs,max_q", [([(1, 4), (1, 7), (1, 12)], 1),
                                         ([(6, 6), (1, 9), (3, 11)], 6)])
def test_dispatcher_matches_jax_dispatcher(specs, max_q):
    """max_q == 1 goes to K1, anything else to K2; both give the JAX numbers."""
    q, cache, params, _ = make(specs, seed=3)
    sm = 1.0 / np.sqrt(q.shape[-1])
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(cache), 0, params, sm,
                              max_q)
    got = paged_attention(t(q), t(cache), 0, port_params(params), sm, max_q)
    n = sum(ql for ql, _ in specs)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n], **TOL)
