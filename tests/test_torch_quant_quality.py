"""The port's quantization-quality script against the JAX script, on the CPU.

- metrics_vs_baseline equal to JAX's (1e-6) on seeded logits.
- markov_sampler's sequences identical to JAX's for the same seeds.
- train_ckpt deterministic on the CPU: two 5-step runs from the same
  checkpoint save identical weights (and not the untrained ones) and
  report the same loss.
- evaluate_model's table (all six CONFIGS, bf16) against the JAX script's on
  a small untrained Llama (2 layers x 64, GQA 4:2, vocab 256) and the
  script's untrained DeepSeek-V3 MLA checkpoint (q-LoRA, 8 experts top-2),
  2 sequences x 32 tokens: NLL within 1e-2, and the same top-1 agreement
  but for positions at a bf16 near tie. An untrained init's margins sit
  near zero, so a position may agree in one package's table and not in the
  other's; each such position must have, in one of the four bf16 rows
  (either package, the config or the baseline), a top-2 gap within twice
  the largest logit difference between the packages.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from evaluation import quant_quality as jax_qq  # noqa: E402
from hydrainfer_tpu_torch.evaluation import quant_quality as qq  # noqa: E402


def test_configs_match_jax():
    assert qq.CONFIGS == jax_qq.CONFIGS


def test_metrics_vs_baseline_matches_jax():
    rng = np.random.default_rng(4)
    seqs = rng.integers(0, 50, size=(3, 20))
    base = rng.standard_normal((3, 20, 50)).astype(np.float32) * 3
    logits = base + rng.standard_normal(base.shape).astype(np.float32) * 0.3
    ours = qq.metrics_vs_baseline(logits, base, seqs)
    theirs = jax_qq.metrics_vs_baseline(logits, base, seqs)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-6, k
    assert qq.metrics_vs_baseline(base, base, seqs)["mean_kl_nats"] == 0.0


@pytest.mark.parametrize("vocab,seed", [(2048, 7), (256, 9)])
def test_markov_sampler_matches_jax(vocab, seed):
    ours, theirs = qq.markov_sampler(vocab, seed=seed), jax_qq.markov_sampler(vocab, seed=seed)
    for seed2 in (10_000, 777, 778):
        np.testing.assert_array_equal(ours(4, 48, seed2), theirs(4, 48, seed2))


def _small_llama(path, vocab=256):
    cfg = transformers.LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128,
                                   tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().float().save_pretrained(
        path, safe_serialization=True)
    return str(path)


def test_train_ckpt_is_deterministic(tmp_path):
    from safetensors.torch import load_file
    sampler = qq.markov_sampler(256, seed=9)
    states, losses = [], []
    for run in ("a", "b"):
        path = _small_llama(tmp_path / run)
        losses.append(qq.train_ckpt(path, sampler, 5, batch=4, T=16, device="cpu"))
        states.append(load_file(f"{path}/model.safetensors"))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert not torch.equal(states[0]["lm_head.weight"],
                           load_file(f"{_small_llama(tmp_path / 'c')}/model.safetensors")
                           ["lm_head.weight"])
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def _top2_gap(x: np.ndarray) -> np.ndarray:
    top = np.sort(x, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("family", ["llama", "mla"])
def test_evaluate_model_matches_jax(family, tmp_path):
    if family == "llama":
        path, vocab = _small_llama(tmp_path / "llama"), 256
    else:
        path, vocab = qq.make_mla_ckpt(str(tmp_path)), 256
    seqs = qq.eval_sequences(2, 32, vocab, seed=1)
    np.testing.assert_array_equal(
        seqs, np.random.default_rng(1).integers(0, vocab, size=(2, 32)))
    ours_lg = {c[0]: qq.all_position_logits(path, c[1], c[2], seqs, device="cpu")
               for c in qq.CONFIGS}
    theirs_lg = {c[0]: jax_qq.all_position_logits(path, c[1], c[2], seqs)
                 for c in qq.CONFIGS}
    ours = qq.evaluate_model(path, 2, 32, vocab, seed=1, device="cpu")
    assert ours == qq.table(ours_lg, seqs)
    theirs = {k: jax_qq.metrics_vs_baseline(v, theirs_lg["bf16"], seqs)
              for k, v in theirs_lg.items()}
    assert list(ours) == list(theirs) == [c[0] for c in qq.CONFIGS]
    assert ours["bf16"]["top1_agreement"] == 1.0 and ours["bf16"]["mean_kl_nats"] == 0.0
    base_err = np.abs(ours_lg["bf16"] - theirs_lg["bf16"]).max()
    for label in ours:
        assert abs(ours[label]["nll"] - theirs[label]["nll"]) <= 1e-2, (label, ours[label],
                                                                      theirs[label])
        # a position counts differently in the two tables only where a bf16
        # row of either package sits at a near tie: its top-2 gap within twice
        # the packages' largest logit difference (beyond it, no perturbation
        # of that size can move the argmax)
        bound = 2 * max(base_err, np.abs(ours_lg[label] - theirs_lg[label]).max())
        mine = ours_lg[label].argmax(-1) == ours_lg["bf16"].argmax(-1)
        jaxs = theirs_lg[label].argmax(-1) == theirs_lg["bf16"].argmax(-1)
        differ = mine != jaxs
        gaps = np.minimum.reduce([_top2_gap(x)[differ] for x in (
            ours_lg[label], ours_lg["bf16"], theirs_lg[label], theirs_lg["bf16"])])
        assert (gaps <= bound).all(), (label, gaps, bound)
        assert abs(ours[label]["top1_agreement"] - theirs[label]["top1_agreement"]) \
            <= differ.sum() / differ.size + 1e-4, (label, ours[label], theirs[label])
