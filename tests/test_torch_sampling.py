"""The port's sampling chain (hydrainfer_tpu_torch/ops/sampling.py) against
the JAX package's (hydrainfer_tpu/ops/sampling.py), on the CPU.

The same numpy-seeded logits go through both: every filter's output must
agree to 1e-6 (random normal logits, and integer-valued ones full of ties for
top-k and top-p), `process_logits(greedy=True)` must give JAX's argmax, and
the greedy `spec_verify_tokens` must give JAX's emitted tokens and accepted
counts exactly, over every draft length and drafts that partly match the
argmax. Draws cannot match jax.random seed for seed, so the stochastic
paths are held to the target distribution instead: total-variation distance
below 0.05 over N = 4000 draws in one call, for plain sampling and for the
spec-sampling theorem (the first emitted token of a rejection-sampled verify
follows the target distribution whether the draft is accepted or not). The
cases of tests/ops/test_sampling.py are mirrored on the port.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops import sampling as jax_sampling
from hydrainfer_tpu_torch.ops import sampling

TOL = dict(rtol=1e-6, atol=1e-6)
S, V = 6, 40


def _logits(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # integer values in a narrow range: every row is full of ties
        return rng.integers(-3, 4, size=(S, V)).astype(np.float32)
    return rng.standard_normal((S, V)).astype(np.float32)


def _both(fn_name: str, logits: np.ndarray, *args):
    """fn_name on the port (torch) and on JAX, with numpy arguments."""
    got = getattr(sampling, fn_name)(torch.from_numpy(logits),
                                     *(torch.from_numpy(a) for a in args))
    ref = getattr(jax_sampling, fn_name)(jnp.asarray(logits),
                                         *(jnp.asarray(a) for a in args))
    return got.numpy(), np.asarray(ref)


TOP_K = np.asarray([1, 3, 0, -1, 7, 100], np.int32)
TOP_P = np.asarray([0.05, 0.5, 0.9, 1.0, 0.3, 0.75], np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("fn", ["apply_temperature", "apply_top_k", "apply_top_p",
                                "apply_count_penalties", "apply_repetition_penalty"])
def test_filter_matches_jax(fn, kind):
    logits = _logits(kind)
    rng = np.random.default_rng(1)
    args = {
        "apply_temperature": (np.asarray([0.5, 1.0, 1.5, 0.0, 2.0, 0.7], np.float32),),
        "apply_top_k": (TOP_K,),
        "apply_top_p": (TOP_P,),
        "apply_count_penalties": (rng.integers(0, 3, (S, V)).astype(np.float32),
                                  rng.random(S).astype(np.float32),
                                  rng.random(S).astype(np.float32)),
        "apply_repetition_penalty": (rng.random((S, V)) < 0.3,
                                     (1 + rng.random(S)).astype(np.float32)),
    }[fn]
    got, ref = _both(fn, logits, *args)
    np.testing.assert_allclose(got, ref, **TOL)
    if fn in ("apply_top_k", "apply_top_p"):
        # the same tokens survive
        np.testing.assert_array_equal(got > sampling.NEG_INF, ref > jax_sampling.NEG_INF)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_filter_chain_and_greedy_match_jax(kind):
    """temperature -> top-k -> top-p as process_logits chains them, and its
    greedy token."""
    logits = _logits(kind, seed=2)
    temps = np.asarray([0.8, 1.0, 1.3, 0.5, 2.0, 1.0], np.float32)
    lg, ref = torch.from_numpy(logits), jnp.asarray(logits)
    lg = sampling.apply_top_p(sampling.apply_top_k(
        sampling.apply_temperature(lg, torch.from_numpy(temps)), torch.from_numpy(TOP_K)),
        torch.from_numpy(TOP_P))
    ref = jax_sampling.apply_top_p(jax_sampling.apply_top_k(
        jax_sampling.apply_temperature(ref, jnp.asarray(temps)), jnp.asarray(TOP_K)),
        jnp.asarray(TOP_P))
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref), **TOL)
    got = sampling.process_logits(torch.from_numpy(logits),
                                  temperature=torch.from_numpy(temps),
                                  top_k=torch.from_numpy(TOP_K),
                                  top_p=torch.from_numpy(TOP_P), greedy=True)
    want = jax_sampling.process_logits(jnp.asarray(logits), temperature=jnp.asarray(temps),
                                       top_k=jnp.asarray(TOP_K), top_p=jnp.asarray(TOP_P),
                                       greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_spec_verify_matches_jax():
    """Greedy acceptance over every draft length 0..K1-1, with drafts that
    match the argmax for a seeded prefix and then diverge."""
    K1, Vs = 5, 12
    rng = np.random.default_rng(3)
    n = 4 * K1
    logits = rng.standard_normal((n, K1, Vs)).astype(np.float32)
    argmax = logits.argmax(-1)
    draft_next = rng.integers(0, Vs, (n, K1)).astype(np.int32)
    for i in range(n):
        m = rng.integers(0, K1 + 1)      # the first m drafts match
        draft_next[i, :m] = argmax[i, :m]
    draft_lens = (np.arange(n) % K1).astype(np.int32)
    emitted, acc = sampling.spec_verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(draft_next), torch.from_numpy(draft_lens))
    j_emitted, j_acc = jax_sampling.spec_verify_tokens(
        jnp.asarray(logits), jnp.asarray(draft_next), jnp.asarray(draft_lens))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(j_emitted))
    assert len(set(acc.tolist())) == K1        # every accepted count occurs


def _tv(tokens: np.ndarray, target: np.ndarray) -> float:
    emp = np.bincount(tokens, minlength=target.shape[0]) / tokens.shape[0]
    return 0.5 * float(np.abs(emp - target).sum())


def test_sampling_follows_the_filtered_distribution():
    """N = 4000 draws in one call from rows of the same logits, at
    temperature 0.7 with top-k 8 and top-p 0.9, against the softmax of the
    JAX package's filtered logits."""
    N, Vs = 4000, 16
    row = np.random.default_rng(4).standard_normal(Vs).astype(np.float32)
    target = np.asarray(jax.nn.softmax(jax_sampling.apply_top_p(
        jax_sampling.apply_top_k(jax_sampling.apply_temperature(
            jnp.asarray(row[None]), jnp.asarray([0.7])), jnp.asarray([8])),
        jnp.asarray([0.9]))[0]))
    ones = torch.ones(N)
    toks = sampling.process_logits(
        torch.from_numpy(np.tile(row, (N, 1))), temperature=0.7 * ones,
        top_k=torch.full((N,), 8, dtype=torch.int32), top_p=0.9 * ones,
        generator=torch.Generator().manual_seed(0))
    assert _tv(toks.numpy(), target) < 0.05
    assert set(np.flatnonzero(target)) >= set(toks.tolist())


def test_spec_rejection_sampling_preserves_distribution():
    """The spec-sampling theorem (tests/engine/test_spec_decode.py): with a
    one-hot draft, the first emitted token follows the target distribution,
    accepted or not. N = 4000 segments in one call."""
    N, K1, Vs = 4000, 2, 16
    logits = np.random.default_rng(0).standard_normal((1, K1, Vs)).astype(np.float32)
    target = np.asarray(jax.nn.softmax(jnp.asarray(logits[0, 0]) / 0.7))
    emitted, acc = sampling.spec_verify_tokens(
        torch.from_numpy(np.tile(logits, (N, 1, 1))),
        torch.tensor([[3, 0]], dtype=torch.int32).repeat(N, 1),
        torch.ones(N, dtype=torch.int32), temperature=torch.full((N,), 0.7),
        top_k=torch.full((N,), -1, dtype=torch.int32), top_p=torch.ones(N),
        generator=torch.Generator().manual_seed(42))
    assert _tv(emitted[:, 0].numpy(), target) < 0.05
    # both branches occurred: accepted drafts (3) and residual draws
    assert 0 < int(acc.sum()) < N


def test_same_generator_seed_same_draws():
    logits = torch.from_numpy(_logits("normal"))
    temps = torch.ones(S)
    draw = lambda seed: sampling.process_logits(
        logits, temperature=temps, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(5)
    a, b = (sampling.process_logits(logits, temperature=temps, generator=gen)
            for _ in range(2))
    assert torch.equal(draw(5), a) and torch.equal(draw(5), draw(5))
    flat = torch.zeros((256, V))
    g = torch.Generator().manual_seed(5)
    assert not torch.equal(sampling.process_logits(flat, generator=g),
                           sampling.process_logits(flat, generator=g))


def test_top_k_1_sampling_is_argmax():
    logits = torch.from_numpy(_logits("normal", seed=6))
    toks = sampling.process_logits(logits, temperature=torch.full((S,), 0.8),
                                   top_k=torch.ones(S, dtype=torch.int32),
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(toks, torch.argmax(logits, -1).to(torch.int32))


# ------------------------------------------- tests/ops/test_sampling.py cases

def test_top_k_keeps_exactly_k():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 50))
                              .astype(np.float32))
    out = sampling.apply_top_k(logits, torch.tensor([5, 1, 0]))
    kept = (out > -1e30).sum(-1).tolist()
    assert kept == [5, 1, 50]      # 0 disables


def test_top_p_nucleus():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    # 0.5 alone < 0.7 -> include the next; 0.5 + 0.3 >= 0.7 -> stop at 2
    assert int((sampling.apply_top_p(logits, torch.tensor([0.7])) > -1e30).sum()) == 2
    assert int((sampling.apply_top_p(logits, torch.tensor([1.0])) > -1e30).sum()) == 4
    # a tiny p keeps at least the argmax
    assert int((sampling.apply_top_p(logits, torch.tensor([1e-9])) > -1e30).sum()) == 1


def test_repetition_penalty_direction():
    out = sampling.apply_repetition_penalty(torch.tensor([[2.0, -2.0, 1.0]]),
                                            torch.tensor([[True, True, False]]),
                                            torch.tensor([2.0]))
    assert out.tolist() == [[1.0, -4.0, 1.0]]   # divided, multiplied, untouched


def test_temperature_sharpens():
    out = sampling.apply_temperature(torch.tensor([[1.0, 2.0]]), torch.tensor([2.0]))
    assert out.tolist() == [[0.5, 1.0]]


def test_process_logits_greedy_pipeline():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20))
                              .astype(np.float32))
    toks = sampling.process_logits(logits, temperature=torch.ones(2),
                                   top_k=torch.tensor([3, 3]),
                                   top_p=torch.tensor([0.9, 0.9]), greedy=True)
    assert torch.equal(toks, torch.argmax(logits, -1).to(torch.int32))


def test_process_logits_sampling_respects_filtering():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 10))
                              .astype(np.float32))
    logits[:, 7] = 10.0
    toks = sampling.process_logits(logits, top_k=torch.ones(4, dtype=torch.int32),
                                   generator=torch.Generator().manual_seed(0))
    assert toks.tolist() == [7] * 4
