"""The port's correctness-dump script against the JAX script, on the CPU.

- compare (and compare_dumps) equal to the JAX script's compare on the same
  dump files: equal dumps, a divergence, a shorter run.
- run_generate in f32 on a tiny Llama checkpoint (2 layers x 64, GQA 4:2,
  vocab 64) with the word-level tokenizer saved beside it: the prompts and
  the greedy token ids equal the JAX script's run_generate on the same
  directory, through each package's OfflineEngine at its defaults.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from evaluation import test_correctness as jax_tc  # noqa: E402
from hydrainfer_tpu_torch.evaluation import test_correctness as tc  # noqa: E402


def _dump(ids_list):
    return [{"prompt": f"p{i}", "output_token_ids": ids, "text": ""}
            for i, ids in enumerate(ids_list)]


@pytest.mark.parametrize("a,b", [
    ([[1, 2, 3], [4, 5]], [[1, 2, 3], [4, 5]]),
    ([[1, 2, 3], [4, 5, 6]], [[1, 9, 3], [4, 5, 7]]),
    ([[1, 2, 3], [4]], [[1, 2], [5, 6]]),
], ids=["equal", "diverge", "shorter"])
def test_compare_matches_jax(a, b, tmp_path):
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(_dump(a)))
    pb.write_text(json.dumps(_dump(b)))
    ours = tc.compare(str(pa), str(pb))
    assert ours == jax_tc.compare(str(pa), str(pb))
    assert ours == tc.compare_dumps(_dump(a), _dump(b))


def test_prompts_are_the_jax_scripts():
    rng = np.random.default_rng(0)
    words = ["the", "a", "of", "to", "and", "in", "is", "it", "you", "that"]
    expect = [" ".join(rng.choice(words, size=rng.integers(8, 32))) for _ in range(5)]
    assert tc.prompts(5) == expect


@pytest.fixture(scope="module")
def word_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("correctness_llama")
    cfg = transformers.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=256,
                                   eos_token_id=2, bos_token_id=1)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().float().save_pretrained(
        path, safe_serialization=True)
    tc.save_word_tokenizer(str(path), 64)
    return str(path)


def test_word_tokenizer_gives_each_word_one_id(word_ckpt):
    tok = transformers.AutoTokenizer.from_pretrained(word_ckpt)
    assert tok.encode("the a that", add_special_tokens=True) == [3, 4, 12]
    assert len(tok) == 64


def test_run_generate_matches_jax(word_ckpt):
    ours = tc.run_generate(word_ckpt, 3, 6, dtype="float32", device="cpu")
    theirs = jax_tc.run_generate(word_ckpt, 3, 6, dtype="float32")
    assert [r["prompt"] for r in ours] == [r["prompt"] for r in theirs]
    assert [r["output_token_ids"] for r in ours] == [r["output_token_ids"] for r in theirs]
    assert all(len(r["output_token_ids"]) == 6 for r in ours)
    assert tc.compare_dumps(ours, theirs)["match_rate"] == 1.0
