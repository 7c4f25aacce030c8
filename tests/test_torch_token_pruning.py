"""The port's focal token pruning against the JAX functions, on the CPU.

Mirrors tests/ops/test_token_pruning.py (hot tokens are kept, order-
preserving, the features gathered) and holds every result to the JAX
function's on the same seeded scores: random scores, scores with exact ties
(top-k keeps the lower index first, as jax.lax.top_k does; dyadic values,
so the means are exact and no tie hangs on summation order), both strategies,
with and without the class-token query, and the scores of a real CLIP tower
(return_last_layer_attention).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops import token_pruning as jax_tp
from hydrainfer_tpu_torch.models.factory import VisionModelParameters
from hydrainfer_tpu_torch.models.random_init import CLIP_TINY, RandomWeightFactory
from hydrainfer_tpu_torch.ops.token_pruning import (focal_pruning, focal_pruning_rank,
                                                    focal_pruning_row)


def make_scores(n_heads=2, n_tokens=9, hot=(3, 5, 7)):
    """Class token + 8 visual tokens; `hot` visual indices get high mass."""
    rng = np.random.default_rng(0)
    s = rng.random((n_heads, n_tokens, n_tokens)).astype(np.float32) * 0.01
    for h in hot:
        s[:, :, 1 + h] = 1.0
    return s / s.sum(-1, keepdims=True)


def tied_scores(n_heads=2, n_tokens=17, seed=1):
    """Scores of four dyadic values, so that many tokens tie exactly: every
    sum is exact in f32, whatever order the two packages add in."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, (n_heads, n_tokens, n_tokens)).astype(np.float32) / 4


def test_rank_selects_hot_tokens():
    idx = focal_pruning_rank(torch.from_numpy(make_scores(hot=(3, 5, 7))), 3).numpy()
    assert set(idx) == {3, 5, 7}
    assert list(idx) == sorted(idx)  # order-preserving


def test_row_selects_hot_tokens():
    idx = focal_pruning_row(torch.from_numpy(make_scores(hot=(1, 6))), 2).numpy()
    assert set(idx) == {1, 6}


def test_focal_pruning_gathers_features():
    scores = torch.from_numpy(make_scores(hot=(0, 2)))
    feats = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    kept, idx = focal_pruning(feats, scores, 2, strategy="rank")
    np.testing.assert_array_equal(idx.numpy(), [0, 2])
    np.testing.assert_array_equal(kept.numpy(), feats.numpy()[[0, 2]])


CASES = {"random": lambda: np.random.default_rng(2).random((3, 11, 11)).astype(np.float32),
         "hot": lambda: make_scores(hot=(1, 4, 6)),
         "ties": tied_scores,
         "all_equal": lambda: np.ones((2, 9, 9), np.float32) / 9}


@pytest.mark.parametrize("n_keep", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_matches_jax(case, n_keep):
    s = CASES[case]()
    n_keep = min(n_keep, s.shape[-1] - 1)
    for cls in (True, False):
        ref = np.asarray(jax_tp.focal_pruning_rank(jnp.asarray(s), n_keep, cls))
        got = focal_pruning_rank(torch.from_numpy(s), n_keep, cls).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_keep", [1, 3, 8, 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_matches_jax(case, n_keep):
    s = CASES[case]()
    n_keep = min(n_keep, s.shape[-1] - 1)
    ref = np.asarray(jax_tp.focal_pruning_row(jnp.asarray(s), n_keep))
    np.testing.assert_array_equal(focal_pruning_row(torch.from_numpy(s), n_keep).numpy(), ref)


@pytest.mark.parametrize("strategy", ["rank", "row"])
def test_pruning_of_a_clip_towers_scores_matches_jax(strategy):
    """The scores of the tiny CLIP tower (return_last_layer_attention) for
    two images, each pruned to 6 of its 16 feature tokens."""
    vm = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu", multimodal=True,
                             clip_cfg=CLIP_TINY).getVisionModel()
    px = np.random.default_rng(5).random((2, 3, 56, 56)).astype(np.float32)
    out = vm.forward(px, VisionModelParameters(return_last_layer_attention=True))
    assert out.scores.shape == (2, CLIP_TINY.n_heads, 17, 17)
    for feats, scores in zip(out.image_features, out.scores):
        kept, idx = focal_pruning(feats, scores, 6, strategy)
        ref_kept, ref_idx = jax_tp.focal_pruning(jnp.asarray(feats.numpy()),
                                                 jnp.asarray(scores.numpy()), 6, strategy)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(kept.numpy(), np.asarray(ref_kept))
