"""Logit parity of the port's paged-cache Llama with HF transformers (the
port's mirror of tests/models/test_llama_vs_hf.py).

A tiny random-weight LlamaForCausalLM checkpoint (2 layers, hidden 64, GQA
4:2, vocab 128) is built in process with transformers and loaded through
the port's getModelFactory(path). One sequence on a paged cache of 4-token
blocks, in f32 on the CPU: the prefill's last logits and five greedy decode
steps' logits, each against HF's full forward over the same tokens, and a
prefill in two chunks (6 + 4 tokens) against HF's whole-prompt logits, all
within 2e-3 (the JAX test's bound); every greedy token is HF's argmax.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from hydrainfer_tpu_torch.models.decoder import decoder_forward  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig, getModelFactory)
from hydrainfer_tpu_torch.models.text_only import TextOnlyModelFactory  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402

VOCAB = 128
BLOCK = 4
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_llama")
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    factory = getModelFactory(ModelFactoryConfig(path=str(path), dtype="float32"), "cpu")
    assert isinstance(factory, TextOnlyModelFactory)
    return factory, model


def _step(lm, cache, chunk, n_past):
    """Append `chunk` after n_past cached tokens of the one sequence; returns
    (the greedy token, the last position's logits)."""
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    pos = i32(list(range(n_past, kv_len)))
    attn = PagedAttentionParams(
        q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))), positions=pos,
        kv_lens=i32([kv_len]), block_tables=i32([list(range(-(-kv_len // BLOCK)))]),
        new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1]))
    batch = LanguageModelBatch(token_ids=i32(chunk), positions=pos, attention=attn,
                               sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
                               sample_dst_slots=i32([-1]))
    table = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        tok, logits = decoder_forward(lm.weights, cache, batch, lm.cos_tab, lm.sin_tab,
                                      lm.cfg, T, table, return_logits=True)
    return int(tok[0]), logits[0].numpy()


def _cache(factory):
    c = factory.getLanguageModelConfig()
    return torch.zeros((c.n_layers, 1, 16, BLOCK, 2 * c.n_kv_heads, c.head_dim))


def _hf_last_logits(model, tokens):
    with torch.no_grad():
        return model(torch.tensor([tokens])).logits[0, -1].numpy()


def test_prefill_and_decode_logits_match_hf(tiny_llama):
    factory, hf = tiny_llama
    lm = factory.getLanguageModel()
    cfg = factory.getLanguageModelConfig()
    assert (cfg.n_layers, cfg.n_kv_heads, cfg.vocab_size) == (2, 2, VOCAB)
    cache = _cache(factory)
    prompt = np.random.default_rng(0).integers(0, VOCAB, size=9).tolist()
    tok, logits = _step(lm, cache, prompt, 0)
    generated = list(prompt)
    for step in range(6):
        ref = _hf_last_logits(hf, generated)
        np.testing.assert_allclose(logits, ref, **TOL)
        assert tok == int(ref.argmax()), f"divergence at step {step}"
        if step == 5:
            break
        generated.append(tok)
        tok, logits = _step(lm, cache, [tok], len(generated) - 1)


def test_chunked_prefill_matches_hf(tiny_llama):
    factory, hf = tiny_llama
    lm = factory.getLanguageModel()
    cache = _cache(factory)
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=10).tolist()
    _step(lm, cache, prompt[:6], 0)
    tok, logits = _step(lm, cache, prompt[6:], 6)
    ref = _hf_last_logits(hf, prompt)
    np.testing.assert_allclose(logits, ref, **TOL)
    assert tok == int(ref.argmax())
