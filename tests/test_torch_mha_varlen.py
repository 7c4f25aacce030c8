"""The port's segment-masked varlen attention against the JAX package, on the CPU.

The port's `mha_varlen` (and K5's wrapper `mha_varlen_flash`, which takes its
plain version for CPU tensors) against JAX `_mha_varlen_dense` and the Pallas
kernel `mha_varlen_flash` in interpret mode, on the same numpy inputs made
from a seed: the ViT form (one image, two unequal, three plus 12 padding
rows, at D=32 and D=80), the causal form built as
hydrainfer_tpu/ops/attention.py:paged_attention_varlen_prefill builds it,
and the `return_scores` form. Tolerance 2e-5 (f32, summation order only), as
the JAX test of the kernel uses; padded rows must be finite.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops.attention import _mha_varlen_dense
from hydrainfer_tpu.ops.attention import mha_varlen as jax_mha_varlen
from hydrainfer_tpu.ops.attention import paged_attention_varlen_prefill
from hydrainfer_tpu.ops.pallas.mha_varlen import mha_varlen_flash as jax_flash
from hydrainfer_tpu_torch.ops.attention import mha_varlen
from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_flash
from tests.ops.test_paged_attention import build_case

TOL = dict(rtol=2e-5, atol=2e-5)
VIT_CASES = [([64], 0), ([40, 88], 0), ([100, 28, 60], 12)]


def vit_inputs(segments, pad, d, h=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.asarray(sum(([i] * n for i, n in enumerate(segments)), []) + [-1] * pad,
                     np.int32)
    q, k, v = (rng.standard_normal((len(ids), h, d)).astype(np.float32)
               for _ in range(3))
    return q, k, v, ids


@pytest.mark.parametrize("segments,pad", VIT_CASES,
                         ids=["one_image", "two_unequal", "three_padded"])
@pytest.mark.parametrize("d", [32, 80])
def test_vit_form_matches_jax(segments, pad, d):
    q, k, v, ids = vit_inputs(segments, pad, d)
    valid = ids >= 0
    ref_dense, _ = _mha_varlen_dense(*(jnp.asarray(a) for a in (q, k, v, ids)))
    ref_flash = jax_flash(*(jnp.asarray(a) for a in (q, k, v, ids)), sm_scale=d ** -0.5,
                          block_q=64, block_kv=64, interpret=True)
    got, scores = mha_varlen(*(torch.from_numpy(a) for a in (q, k, v, ids)))
    assert scores is None
    got = got.numpy()
    np.testing.assert_allclose(got[valid], np.asarray(ref_dense)[valid], **TOL)
    np.testing.assert_allclose(got[valid], np.asarray(ref_flash)[valid], **TOL)
    assert np.isfinite(got).all() and np.all(got[~valid] == 0)


@pytest.mark.parametrize("specs", [[(6, 6), (1, 9), (3, 11)], [(13, 13), (5, 21)]],
                         ids=["mixed_chunked", "two_prefills"])
def test_causal_form_matches_jax(specs):
    """Gathered pages with segment ids (-1 past each kv_len) and cache
    positions, as paged_attention_varlen_prefill lays them out; held against
    that JAX function and against the Pallas kernel on the same rows."""
    q, cache, params, _ = build_case(np.random.default_rng(1), specs, H=4, KVH=2,
                                     T_pad=sum(ql for ql, _ in specs) + 3)
    sm = 1.0 / np.sqrt(q.shape[-1])
    ref = np.asarray(paged_attention_varlen_prefill(
        jnp.asarray(q), jnp.asarray(cache), 0, params, sm, interpret=True))

    tables = np.maximum(np.asarray(params.block_tables), 0)
    kv_lens = np.asarray(params.kv_lens)
    S, mb = tables.shape
    pages = cache[0, 0][tables]                              # (S, MB, BS, 2KVH, D)
    rows = pages.reshape(S * mb * pages.shape[2], *pages.shape[3:])
    k = np.repeat(rows[:, 0::2], 2, axis=1)                  # GQA 2: kv heads -> q heads
    v = np.repeat(rows[:, 1::2], 2, axis=1)
    max_kv = mb * pages.shape[2]
    kv_pos = np.tile(np.arange(max_kv, dtype=np.int32), S)
    kv_seg = np.where(kv_pos < np.repeat(kv_lens, max_kv),
                      np.repeat(np.arange(S, dtype=np.int32), max_kv), -1).astype(np.int32)
    q_ids = np.array(params.q_seq_ids)
    q_lens = np.diff(np.asarray(params.cu_q_lens))
    q_pos = ((kv_lens - q_lens)[np.maximum(q_ids, 0)]
             + np.asarray(params.q_local_ids)).astype(np.int32)

    t = torch.from_numpy
    got = mha_varlen_flash(t(q), t(np.ascontiguousarray(k)), t(np.ascontiguousarray(v)),
                           t(q_ids), float(sm), kv_seq_ids=t(kv_seg), q_pos=t(q_pos),
                           kv_pos=t(kv_pos)).numpy()
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(q_ids), float(sm), kv_seq_ids=jnp.asarray(kv_seg),
                                  q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                                  block_q=64, block_kv=64, interpret=True))
    valid = q_ids >= 0
    np.testing.assert_allclose(got[valid], ref[valid], **TOL)
    np.testing.assert_allclose(got[valid], pallas[valid], **TOL)
    assert np.isfinite(got).all() and np.all(got[~valid] == 0)


def test_return_scores_matches_jax():
    q, k, v, ids = vit_inputs([16, 9], 3, 32, seed=2)
    ref_out, ref_p = jax_mha_varlen(*(jnp.asarray(a) for a in (q, k, v, ids)),
                                    return_scores=True)
    got_out, got_p = mha_varlen(*(torch.from_numpy(a) for a in (q, k, v, ids)),
                                return_scores=True)
    assert got_p.shape == (4, len(ids), len(ids))
    valid = ids >= 0
    np.testing.assert_allclose(got_out.numpy()[valid], np.asarray(ref_out)[valid], **TOL)
    np.testing.assert_allclose(got_p.numpy()[:, valid], np.asarray(ref_p)[:, valid], **TOL)
