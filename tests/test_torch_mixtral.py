"""The port's Mixtral against HF and the JAX package, on the CPU (the port's
mirror of tests/models/test_mixtral_gpt2_vs_hf.py:test_mixtral_token_exact).

A tiny MixtralForCausalLM checkpoint is built in process with transformers
(2 layers x 48, 4 q / 2 kv heads, 4 experts of 64, top-2) and loaded through
both packages' getModelFactory(path); the JAX side runs its jnp attention.

- The decoder config equals JAX's, field for field (routing included).
- int8 quantization picks JAX's keys: qkv, o_proj and the lm_head; the
  experts and the router stay as they are.
- One sequence in f32: the prefill's and five decode steps' logits within
  1e-4 relative of the JAX model's, and six greedy tokens equal to JAX's and
  to HF's generate.
- The port's PD OfflineEngine gives the JAX engine's greedy tokens over a
  16-token budget (chunked prefills), single steps (K = 1) and fused windows
  (K = 4), f32 and int8 weights with an int8 KV cache.
- The weight bridge carries the JAX converter's tree leaf for leaf, and a
  model built on it gives the port loader's logits.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import mixtral as jax_mixtral  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.models.weight_loader import WeightStore as JaxWeightStore  # noqa: E402
from hydrainfer_tpu.ops.quant import QuantizedTensor as JaxQT  # noqa: E402
from hydrainfer_tpu.ops.quant import quantize_tree as jax_quantize_tree  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine import executor as port_executor  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import mixtral  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import DecoderConfig, decoder_forward  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig, getModelFactory)
from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM  # noqa: E402
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_loader import WeightStore  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402
from hydrainfer_tpu_torch.ops.quant import QuantizedTensor, quantize_tree  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402

VOCAB = 64
BLOCK = 4
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(path, the HF model) of a tiny Mixtral checkpoint."""
    cfg = transformers.MixtralConfig(
        vocab_size=VOCAB, hidden_size=48, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(cfg).eval().float()
    hf.generation_config.eos_token_id = None
    path = str(tmp_path_factory.mktemp("tiny_mixtral"))
    hf.save_pretrained(path, safe_serialization=True)
    return path, hf


def _factories(path, quant="none", kv_int8=False):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype="fp32", quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_mixtral.MixtralModelFactory)
    assert isinstance(pf, mixtral.MixtralModelFactory)
    return jf, pf


def test_decoder_config_matches_jax(ckpt):
    jf, pf = _factories(ckpt[0])
    pc, jc = pf.decoder_cfg, jf.decoder_cfg
    for field in DecoderConfig.__dataclass_fields__:
        assert getattr(pc, field) == getattr(jc, field), field
    assert (pc.moe_top_k, pc.n_experts, pc.moe_scoring, pc.moe_norm_topk) == \
        (2, 4, "softmax", True)
    lc, jl = pf.getLanguageModelConfig(), jf.getLanguageModelConfig()
    for field in ("n_layers", "max_position_embeddings", "n_qo_heads", "n_kv_heads",
                  "head_dim", "eos_token_id", "hidden_size", "vocab_size"):
        assert getattr(lc, field) == getattr(jl, field), field
    assert pf.getVisionModel() is None and pf.getVisionModelConfig() is None


def test_quantized_keys_match_jax(ckpt):
    path = ckpt[0]
    jf, pf = _factories(path)
    pw = quantize_tree(mixtral.convert_mixtral_weights(WeightStore(path, "fp32", "cpu"),
                                                       pf.decoder_cfg), "int8")
    jw = jax_quantize_tree(jax_mixtral.convert_mixtral_weights(
        JaxWeightStore(path, cast_dtype="float32"), jf.decoder_cfg), "int8")

    def picked(w, cls):
        return ([{k for k, v in lw.items() if isinstance(v, cls)} for lw in w["layers"]],
                isinstance(w["lm_head"], cls))

    got = picked(pw, QuantizedTensor)
    assert got == picked(jw, JaxQT)
    assert got == ([{"qkv_proj", "o_proj"}] * 2, True)
    lw = pw["layers"][0]
    assert lw["moe_gate_up"].shape == (4, 48, 128) and lw["moe_down"].shape == (4, 64, 48)
    assert lw["moe_router"].shape == (48, 4)
    for key, v in lw.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jw["layers"][0][key]),
                                          err_msg=key)


# ------------------------------------------------------------ one sequence

def _port_step(lm, cache, chunk, n_past):
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    attn = PagedAttentionParams(
        q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))), positions=pos,
        kv_lens=i32([kv_len]), block_tables=i32([list(range(-(-kv_len // BLOCK)))]),
        new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1]))
    batch = LanguageModelBatch(token_ids=i32(chunk), positions=pos, attention=attn,
                               sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
                               sample_dst_slots=i32([-1]))
    with torch.no_grad():
        tok, logits = decoder_forward(lm.weights, cache, batch, lm.cos_tab, lm.sin_tab,
                                      lm.cfg, T, torch.zeros(2, dtype=torch.int32),
                                      return_logits=True)
    return int(tok[0]), logits[0].numpy()


def _generate(lm, n_layers, n_kv_heads, head_dim, prompt, n_new):
    """Greedy tokens and every step's logits through the port model."""
    cache = torch.zeros((n_layers, 1, 16, BLOCK, 2 * n_kv_heads, head_dim))
    tok, logits = _port_step(lm, cache, prompt, 0)
    out, all_logits = [tok], [logits]
    for _ in range(n_new - 1):
        tok, logits = _port_step(lm, cache, [out[-1]], len(prompt) + len(out) - 1)
        out.append(tok)
        all_logits.append(logits)
    return out, all_logits


def _jax_batch(chunk, n_past):
    """The JAX batch of one sequence: `chunk` after n_past cached tokens."""
    from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch
    from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxParams
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    return JaxBatch(
        token_ids=i32(chunk), positions=pos,
        image_features=jnp.zeros((0, 64), jnp.float32), image_dst_idx=i32([]),
        attention=JaxParams(q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))),
                            positions=pos, kv_lens=i32([kv_len]),
                            block_tables=i32([list(range(-(-kv_len // BLOCK)))]),
                            new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1])),
        sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
        sample_dst_slots=i32([-1]))


def _jax_generate(lm, lcfg, prompt, n_new):
    cache = jnp.zeros((lcfg.n_layers, 1, 16, BLOCK, 2 * lcfg.n_kv_heads, lcfg.head_dim),
                      jnp.float32)
    out, all_logits, ids = [], [], list(prompt)
    for step in range(n_new):
        chunk = prompt if step == 0 else [ids[-1]]
        batch = _jax_batch(chunk, len(ids) - len(chunk))
        cache, tokens, logits = lm.forward_with_logits(cache, batch, max_q=len(chunk))
        out.append(int(tokens[0]))
        all_logits.append(np.asarray(logits[0]))
        ids.append(out[-1])
    return out, all_logits


def test_logits_and_tokens_match_jax_and_hf(ckpt):
    path, hf = ckpt
    jf, pf = _factories(path)
    lc = pf.getLanguageModelConfig()
    prompt = np.random.default_rng(0).integers(0, VOCAB, size=8).tolist()
    ours, logits = _generate(pf.getLanguageModel(), lc.n_layers, lc.n_kv_heads,
                             lc.head_dim, prompt, 6)
    ref, ref_logits = _jax_generate(jf.getLanguageModel(), jf.getLanguageModelConfig(),
                                    prompt, 6)
    for step, (a, b) in enumerate(zip(logits, ref_logits)):
        np.testing.assert_allclose(a, b, err_msg=f"step {step}", **JAX_TOL)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.tensor([prompt]), max_new_tokens=6,
                             do_sample=False)
    assert ours == ref == hf_out[0, len(prompt):].tolist()


# ------------------------------------------------------------ engines

PROMPTS = ["! %&", "&&! %%", "%! &! %% &&! !", "&", "%%%&!& !&%! &%%! !&!% &"]
MAX_TOKENS = (8, 8, 6, 10, 7)
_JAX_TOKENS = {}
_PORT_TOKENS = {}


def _requests(req_cls, sp_cls):
    return [req_cls(request_id=f"r{i}", prompt=p,
                    sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _jax_tokens(path, quant, kv_int8):
    key = (path, quant)
    if key not in _JAX_TOKENS:
        jf, _ = _factories(path, quant, kv_int8)
        jf.getTokenizer = lambda: JaxTok(image_token="<image>", image_token_id=0,
                                         eos_token_id=1)
        cfg = JaxNodeConfig(
            batch_scheduler=JaxBSConfig(max_running_requests=5),
            request_processor=JaxRPConfig(num_request_process_workers=1, block_size=BLOCK),
            kv_block_size=BLOCK, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
            spec_ngram_k=0)
        cfg.model.dtype = "fp32"
        cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
        engine = JaxOfflineEngine(cfg, model_factory=jf, node_type="PD")
        engine.node.batch_scheduler.token_budget = 16
        _JAX_TOKENS[key] = [o.output_token_ids for o in engine.generate(
            _requests(JaxRequest, JaxSP), timeout_s=600)]
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("k", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
def test_engine_matches_jax_engine(ckpt, quant, kv_int8, k, monkeypatch):
    path = ckpt[0]
    _, pf = _factories(path, quant, kv_int8)
    pf.getTokenizer = lambda: SimpleTokenizer(image_token="<image>", image_token_id=0,
                                              eos_token_id=1)
    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=5),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=BLOCK),
        kv_block_size=BLOCK, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=k,
        spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=pf, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 16
    cache = engine.node.kv_cache_manager.cache_array
    assert cache.shape[-2:] == (4, 12)
    assert cache.dtype == (torch.int8 if kv_int8 else torch.float32)
    got = [o.output_token_ids for o in engine.generate(_requests(Request, SamplingParameters),
                                                       timeout_s=600)]
    assert [len(t) for t in got] == list(MAX_TOKENS)
    assert got == _jax_tokens(path, quant, kv_int8)
    assert max(windows) == k
    _PORT_TOKENS[quant, k] = got
    if (quant, 1) in _PORT_TOKENS and (quant, 4) in _PORT_TOKENS:
        assert _PORT_TOKENS[quant, 1] == _PORT_TOKENS[quant, 4]


def test_weight_bridge_carries_the_jax_mixtral_tree(ckpt):
    """The JAX converter's tree (fused qkv, the router, the stacked experts),
    carried over by from_jax_numpy, is the port converter's leaf for leaf,
    and a model built on it gives the same prefill logits."""
    from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
    path = ckpt[0]
    jf, pf = _factories(path)
    jtree = jax_mixtral.convert_mixtral_weights(JaxWeightStore(path, cast_dtype="float32"),
                                                jf.decoder_cfg)
    bridged = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    ported = mixtral.convert_mixtral_weights(WeightStore(path, "fp32", "cpu"),
                                             pf.decoder_cfg)
    assert bridged.keys() == ported.keys()
    for key in ("embed", "norm", "lm_head"):
        torch.testing.assert_close(bridged[key], ported[key], rtol=0, atol=0)
    for a, b in zip(bridged["layers"], ported["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    prompt = np.random.default_rng(5).integers(0, VOCAB, size=7).tolist()
    cache = lambda: torch.zeros((2, 1, 16, BLOCK, 4, 12))  # noqa: E731
    lm = LlamaForCausalLM(bridged, pf.decoder_cfg)
    ref = LlamaForCausalLM(ported, pf.decoder_cfg)
    np.testing.assert_array_equal(_port_step(lm, cache(), prompt, 0)[1],
                                  _port_step(ref, cache(), prompt, 0)[1])
