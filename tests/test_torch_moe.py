"""The port's MoE ops (hydrainfer_tpu_torch/ops/moe.py) against the JAX
package's (hydrainfer_tpu/ops/moe.py), on the CPU.

The same seeded numpy logits go through every routing function of both
packages: greedy top-k over softmax and sigmoid scores, norm_topk on and
off, routed scaling, and group-limited routing (noaux_tc: sigmoid + a
correction bias, groups by their top-2 sum; group_limited_greedy: softmax,
groups by their max). The expert ids must be equal and the weights within
1e-6 (the scores are distinct, so no tie decides an id). The grouped expert
FFN is held to JAX's moe_ffn and to the dense oracle: in f32 within 2e-4
(the JAX test's bound), in bf16 within 2e-2 of max |out| (bf16 rounding of
the activations and of the down product, which the JAX one keeps in f32),
with an expert that no token picked. tests/ops/test_moe.py's first four
tests are mirrored (normalized softmax top-k, the group limit, the dense
oracle, the jitted step: here the dispatch with no host read).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops import moe as jax_moe
from hydrainfer_tpu_torch.ops import moe

F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _logits(T, E, seed):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)


def _same_routing(got, ref):
    (w, idx), (jw, jidx) = got, ref
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k,scaling", [(1, 1.0), (2, 1.0), (6, 2.5)])
def test_route_matches_jax(scoring, norm_topk, top_k, scaling):
    x = _logits(9, 16, seed=top_k)
    _same_routing(moe.route(torch.from_numpy(x), top_k, scoring, norm_topk, scaling),
                  jax_moe.route(jnp.asarray(x), top_k, scoring, norm_topk, scaling))


@pytest.mark.parametrize("method", ["noaux_tc", "group_limited_greedy"])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_grouped_topk_matches_jax(method, norm_topk):
    T, E, G = 7, 16, 4
    x = _logits(T, E, seed=3)
    bias = (np.random.default_rng(4).uniform(-0.3, 0.3, E).astype(np.float32)
            if method == "noaux_tc" else None)
    kw = (dict(scoring="sigmoid", group_agg="top2sum") if method == "noaux_tc"
          else dict(scoring="softmax", group_agg="max"))
    got = moe.grouped_topk(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias),
                           G, 2, 4, norm_topk=norm_topk, routed_scaling=1.5, **kw)
    ref = jax_moe.grouped_topk(jnp.asarray(x), None if bias is None else jnp.asarray(bias),
                               G, 2, 4, norm_topk=norm_topk, routed_scaling=1.5, **kw)
    _same_routing(got, ref)


def test_topk_softmax_weights_normalized():
    x = _logits(5, 8, seed=0)
    w, idx = moe.topk_softmax(torch.from_numpy(x), 2)
    assert w.shape == (5, 2) and idx.shape == (5, 2)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1),
                                  np.sort(np.argsort(-x, axis=-1)[:, :2], -1))
    _same_routing((w, idx), jax_moe.topk_softmax(jnp.asarray(x), 2))


def test_grouped_topk_sigmoid_group_limit():
    T, E, G = 4, 16, 4
    x = _logits(T, E, seed=1)
    bias = np.random.default_rng(2).uniform(-0.1, 0.1, E).astype(np.float32)
    w, idx = moe.grouped_topk_sigmoid(torch.from_numpy(x), torch.from_numpy(bias), G, 2, 4,
                                      routed_scaling=2.5)
    groups = idx.numpy() // (E // G)
    assert all(len(set(groups[t])) <= 2 for t in range(T))
    np.testing.assert_allclose(w.sum(-1).numpy(), 2.5, rtol=1e-5)
    _same_routing((w, idx), jax_moe.grouped_topk_sigmoid(jnp.asarray(x), jnp.asarray(bias),
                                                         G, 2, 4, routed_scaling=2.5))


def _ffn_case(T, E, k, d=16, I=32, seed=2, empty=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    gate_up = (rng.standard_normal((E, d, 2 * I)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((E, I, d)) * 0.1).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if empty is not None:
        logits[:, empty] = -30.0        # no token picks this expert
    return x, gate_up, down, logits


@pytest.mark.parametrize("T,E,k", [(6, 4, 2), (16, 8, 2), (3, 4, 1), (12, 8, 6)])
def test_moe_ffn_matches_jax_and_dense_oracle(T, E, k):
    x, gate_up, down, logits = _ffn_case(T, E, k, empty=E - 1)
    w, idx = moe.route(torch.from_numpy(logits), k)
    assert not (idx == E - 1).any()
    t = [torch.from_numpy(a) for a in (x, gate_up, down)]
    got = moe.moe_ffn(*t, w, idx)
    np.testing.assert_allclose(got.numpy(), moe.moe_ffn_dense(*t, w, idx).numpy(), **F32_TOL)
    jw, jidx = jax_moe.route(jnp.asarray(logits), k)
    j = [jnp.asarray(a) for a in (x, gate_up, down)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_moe.moe_ffn(*j, jw, jidx)),
                               **F32_TOL)
    np.testing.assert_allclose(moe.moe_ffn_dense(*t, w, idx).numpy(),
                               np.asarray(jax_moe.moe_ffn_dense(*j, jw, jidx)), **F32_TOL)


def test_moe_ffn_bf16_close_to_jax():
    x, gate_up, down, logits = _ffn_case(24, 8, 2, d=32, I=48, seed=5, empty=3)
    w, idx = moe.route(torch.from_numpy(logits), 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = moe.moe_ffn(bf(x), bf(gate_up), bf(down), w, idx)
    assert got.dtype == torch.bfloat16
    jw, jidx = jax_moe.route(jnp.asarray(logits), 2)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = np.asarray(jax_moe.moe_ffn(jb(x), jb(gate_up), jb(down), jw, jidx)).astype(np.float32)
    dense = moe.moe_ffn_dense(*(torch.from_numpy(a) for a in (x, gate_up, down)), w, idx)
    scale = np.abs(dense.numpy()).max()
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * scale
    assert np.abs(got.float().numpy() - dense.numpy()).max() <= 2e-2 * scale


def test_moe_dispatch_reads_nothing_on_the_host(monkeypatch):
    """The dispatch's shapes are static and it never reads a tensor on the
    host (no .item(), .tolist() or bincount), so it can be captured in a CUDA
    graph: every such call raises here."""
    x, gate_up, down, logits = _ffn_case(8, 4, 2, d=16, I=16, seed=3)
    w, idx = moe.route(torch.from_numpy(logits), 2)
    t = [torch.from_numpy(a) for a in (x, gate_up, down)]
    ref = moe.moe_ffn(*t, w, idx)

    def boom(*a, **k):
        raise AssertionError("host read")

    for name in ("item", "tolist", "__bool__", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch, "bincount", boom)
    out = moe.moe_ffn(*t, w, idx)
    monkeypatch.undo()
    assert out.shape == (8, 16) and torch.isfinite(out).all()
    assert torch.equal(out, ref)
