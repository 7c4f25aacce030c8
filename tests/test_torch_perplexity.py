"""The port's perplexity script against HF's loss and the JAX script, on the
CPU (the port's mirror of tests/test_perplexity.py).

A tiny Llama checkpoint (2 layers x 64, GQA 4:2, vocab 128) is built in
process with transformers.

- sequence_nll in f32 within 2e-3 of HF's loss and within 1e-4 of the JAX
  script's sequence_nll (its jnp attention) on the same 40 tokens.
- evaluate's NLL under int8, int4 and fp8 weights and the int8 KV cache
  within 5% of the f32 baseline's (the JAX test's bounds, int4 added).
- make_full_logit_batch equal to the JAX script's, field by field.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from evaluation import perplexity as jax_ppl  # noqa: E402
from hydrainfer_tpu.models import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu_torch.evaluation import perplexity  # noqa: E402
from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory  # noqa: E402


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    path = tmp_path_factory.mktemp("ppl_llama_port")
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def test_nll_matches_hf_and_jax(tiny_llama):
    path, hf = tiny_llama
    factory = getModelFactory(ModelFactoryConfig(path=path, dtype="float32"), device="cpu")
    lm, lcfg = factory.getLanguageModel(), factory.getLanguageModelConfig()
    seq = np.random.default_rng(0).integers(0, 128, size=40).tolist()
    ours = perplexity.sequence_nll(lm, lcfg, seq, block_size=8, cache_dtype=torch.float32)
    with torch.no_grad():
        ids = torch.tensor([seq])
        hf_loss = hf(input_ids=ids, labels=ids).loss.item()
    assert abs(ours - hf_loss) < 2e-3, (ours, hf_loss)
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp"))
    theirs = jax_ppl.sequence_nll(jf.getLanguageModel(), jf.getLanguageModelConfig(), seq,
                                  block_size=8, cache_dtype=jnp.float32)
    assert abs(ours - theirs) < 1e-4, (ours, theirs)


def test_quantization_deltas_small(tiny_llama):
    path, _ = tiny_llama
    kw = dict(dtype="float32", num_seqs=2, seq_len=48, device="cpu")
    base = perplexity.evaluate(path, **kw)
    for quant, kv_int8 in (("int8", False), ("int4", False), ("fp8", False),
                           ("none", True)):
        got = perplexity.evaluate(path, quant=quant, kv_int8=kv_int8, **kw)
        assert got["quant"] == quant and got["kv_int8"] == kv_int8
        assert abs(got["nll"] - base["nll"]) < 0.05 * max(base["nll"], 1.0), (quant, got)
    assert set(base) == {"nll", "perplexity", "num_seqs", "seq_len", "dtype", "quant",
                         "kv_int8"}


@pytest.mark.parametrize("T,block_size", [(40, 8), (37, 16), (1, 16)])
def test_make_full_logit_batch_matches_jax(T, block_size):
    ids = np.random.default_rng(T).integers(0, 100, size=T).tolist()
    ours = perplexity.make_full_logit_batch(ids, block_size, 64)
    theirs = jax_ppl.make_full_logit_batch(ids, block_size, 64)
    for name in ("token_ids", "positions", "sample_token_idx", "token_src_slots",
                 "sample_dst_slots", "image_features", "image_dst_idx"):
        a, b = getattr(ours, name), np.asarray(getattr(theirs, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for name in ("q_seq_ids", "q_local_ids", "positions", "kv_lens", "block_tables",
                 "new_kv_slot_ids", "cu_q_lens", "num_seqs"):
        a, b = getattr(ours.attention, name), np.asarray(getattr(theirs.attention, name))
        assert tuple(a.shape) == b.shape and a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
