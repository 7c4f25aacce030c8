"""The port's tensor- and expert-parallel engine on the MoE models against
the JAX single-device engine (CPU; see tests/test_torch_tp_engine.py for
tiny-lm): one node over a list of CPU devices must emit the JAX engine's
greedy tokens at tp 2 and 4, in f32 and with int8 weights and an int8 KV
cache, for
- a tiny DeepSeek-V3 checkpoint with q-LoRA (MLA over the latent cache,
  which every rank holds a copy of; 8 routed experts split by expert, a
  shared expert split by columns and rows), as
  tests/models/test_deepseek_mla_vs_hf.py:154 runs its TP case;
- a tiny Mixtral checkpoint (GQA 4:2, top-2 of 4 experts: one expert a rank
  at tp 4, where each KV head is copied on two ranks).
The requests, node settings and JAX references are those of
tests/test_torch_deepseek.py and tests/test_torch_mixtral.py, run once a
module.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import pytest

from hydrainfer_tpu_torch.request import Request, SamplingParameters
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer
from tests import test_torch_deepseek as deepseek
from tests import test_torch_mixtral as mixtral
from tests.test_torch_mixtral import ckpt  # noqa: F401  (the checkpoint fixture)
from tests.test_torch_tp_engine import QUANT_IDS, serve


@pytest.fixture(scope="module")
def qlora_path(tmp_path_factory):
    """The q-LoRA checkpoint of tests/test_torch_deepseek.py."""
    path = str(tmp_path_factory.mktemp("tiny_dsv3_qlora"))
    deepseek._hf_model(q_lora_rank=24).save_pretrained(path, safe_serialization=True)
    return path


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)], ids=QUANT_IDS)
def test_mla_moe_tp_engine_matches_jax_single_device(qlora_path, quant, kv_int8, tp):
    """The q-LoRA DeepSeek-V3 checkpoint: 4 heads, 8 routed experts of which
    2 a token, one shared expert; the latent cache copied on every rank."""
    path = qlora_path
    _, pf = deepseek._factories(path, quant, kv_int8)
    pf.getTokenizer = lambda: SimpleTokenizer(image_token="<image>", image_token_id=0,
                                              eos_token_id=1)
    engine, got = serve(pf, ["cpu"] * tp, deepseek._requests(Request, SamplingParameters))
    caches = engine.node.kv_cache_manager.cache_array
    assert [tuple(c.shape[-2:]) for c in caches] == [(1, 24)] * tp
    ranks = engine.node.worker.language_model.weights.ranks
    assert [r["layers"][1]["moe_gate_up"].shape[0] for r in ranks] == [8 // tp] * tp
    assert got == deepseek._jax_tokens(path, quant, kv_int8)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)], ids=QUANT_IDS)
def test_mixtral_tp_engine_matches_jax_single_device(ckpt, quant, kv_int8, tp):  # noqa: F811
    path = ckpt[0]
    _, pf = mixtral._factories(path, quant, kv_int8)
    pf.getTokenizer = lambda: SimpleTokenizer(image_token="<image>", image_token_id=0,
                                              eos_token_id=1)
    _, got = serve(pf, ["cpu"] * tp, mixtral._requests(Request, SamplingParameters),
                   max_running=5)
    assert got == mixtral._jax_tokens(path, quant, kv_int8)
