"""The port's DeepSeek V2/V3 language models against HF and the JAX
package, on the CPU (the port's mirror of
tests/models/test_deepseek_mla_vs_hf.py).

Tiny DeepseekV3ForCausalLM checkpoints are built in process with
transformers (3 layers x 64, 4 heads, MLA with kv_lora 16, rope 8, nope 16,
v 16; 8 routed experts in 4 groups, 2 a token, noaux_tc with a nonzero
correction bias, one shared expert, the first layer dense): with q-LoRA
(rank 24), with a plain q projection, and (2 layers) with YaRN at factor 2
and mscale 1. A DeepSeek-V2-Lite-shaped one is the plain-q checkpoint with
its config rewritten to V2-Lite's routing and rope: model_type deepseek_v2,
greedy softmax top-2 with norm_topk_prob false, and YaRN with mscale =
mscale_all_dim = 0.707.

- The decoder config and the YaRN rope tables equal JAX's (the tables at
  V2-Lite's published factor 40 over 163840 positions too, within 1e-6).
- The weight bridge carries the JAX converter's tree (q-LoRA, the router
  and its bias, the stacked experts) leaf for leaf.
- int8 quantization picks the keys JAX's quantize_tree picks: attention's
  o_proj, the dense layer's and the shared experts' gate_up and down, and
  the lm_head; the experts, the router and MLA's q and latent projections
  stay as they are.
- One sequence on the latent paged cache (f32): the prefill's logits within
  3e-3 of HF's (the JAX test's bound) and six greedy tokens equal to HF's
  generate, for q-LoRA, plain q and YaRN; with an int8 latent cache the
  logits within the JAX test's 0.35 + 0.1 x |logit| of the f32 cache's.
- The port's PD OfflineEngine gives the JAX engine's greedy tokens over a
  16-token budget (chunked prefills), single steps (K = 1) and fused
  windows (K = 4), f32 and int8 weights with an int8 KV cache, on the
  q-LoRA and the V2-Lite-shaped checkpoints; the K = 4 tokens equal K = 1's.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import deepseek_v3 as jax_ds  # noqa: E402
from hydrainfer_tpu.models.decoder import DecoderConfig as JaxDecoderConfig  # noqa: E402
from hydrainfer_tpu.models.decoder import init_rope_tables as jax_rope_tables  # noqa: E402
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
from hydrainfer_tpu_torch.models import deepseek_v3  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import DecoderConfig, decoder_forward  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import init_rope_tables  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig, getModelFactory)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_loader import WeightStore  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402
from hydrainfer_tpu_torch.ops.quant import QuantizedTensor, quantize_tree  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402

VOCAB = 64
BLOCK = 4
HF_TOL = dict(rtol=3e-3, atol=3e-3)
# DeepSeek-V2-Lite's config.json: rope and routing
V2_LITE_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


def _hf_model(q_lora_rank, n_layers=3, rope_scaling=None, seed=1, scaling=1.5):
    cfg = transformers.DeepseekV3Config(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=n_layers, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, n_group=4,
        topk_group=2, routed_scaling_factor=scaling, norm_topk_prob=True,
        first_k_dense_replace=1, kv_lora_rank=16, q_lora_rank=q_lora_rank,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, max_position_embeddings=128,
        rope_interleave=True, attention_bias=False, tie_word_embeddings=False,
        rope_scaling=rope_scaling)
    torch.manual_seed(seed)
    model = transformers.DeepseekV3ForCausalLM(cfg).eval().float()
    with torch.no_grad():
        for layer in model.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.05, 0.05)
    model.generation_config.eos_token_id = None
    return model


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{name: (path, the HF model or None)}."""
    out = {}
    for name, kw in (("qlora", dict(q_lora_rank=24)), ("plain", dict(q_lora_rank=None)),
                     ("yarn", dict(q_lora_rank=24, n_layers=2, seed=7, scaling=1.0,
                                   rope_scaling={"type": "yarn", "factor": 2.0,
                                                 "original_max_position_embeddings": 64,
                                                 "mscale": 1.0, "mscale_all_dim": 1.0,
                                                 "beta_fast": 32, "beta_slow": 1}))):
        path = str(tmp_path_factory.mktemp(f"tiny_dsv3_{name}"))
        model = _hf_model(**kw)
        model.save_pretrained(path, safe_serialization=True)
        out[name] = (path, model)
    v2 = str(tmp_path_factory.mktemp("tiny_dsv2_lite"))
    for f in os.listdir(out["plain"][0]):
        if f.endswith(".safetensors"):
            shutil.copy(os.path.join(out["plain"][0], f), v2)
    with open(os.path.join(out["plain"][0], "config.json")) as fh:
        cfg = json.load(fh)
    cfg.update(model_type="deepseek_v2", architectures=["DeepseekV2ForCausalLM"],
               topk_method="greedy", scoring_func="softmax", norm_topk_prob=False,
               routed_scaling_factor=1.0, rope_scaling=dict(V2_LITE_YARN, factor=4,
                                                            original_max_position_embeddings=32))
    with open(os.path.join(v2, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    out["v2lite"] = (v2, None)
    return out


def _factories(path, quant="none", kv_int8=False):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype="fp32", quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_ds.DeepSeekModelFactory)
    assert isinstance(pf, deepseek_v3.DeepSeekModelFactory)
    return jf, pf


@pytest.mark.parametrize("name", ["qlora", "plain", "yarn", "v2lite"])
def test_decoder_config_matches_jax(ckpts, name):
    jf, pf = _factories(ckpts[name][0])
    pc, jc = pf.decoder_cfg, jf.decoder_cfg
    for field in DecoderConfig.__dataclass_fields__:
        assert getattr(pc, field) == getattr(jc, field), field
    assert pc.mla_kv_lora == 16 and pc.head_dim == 24 and pc.n_kv_heads == 1
    lc, jl = pf.getLanguageModelConfig(), jf.getLanguageModelConfig()
    assert lc.kv_single_plane and jl.kv_single_plane
    assert (lc.n_layers, lc.n_kv_heads, lc.head_dim, lc.eos_token_id) == \
        (jl.n_layers, jl.n_kv_heads, jl.head_dim, jl.eos_token_id)
    if name == "v2lite":
        assert (pc.moe_scoring, pc.moe_norm_topk, pc.moe_n_groups) == ("softmax", False, 0)


@pytest.mark.parametrize("use_mla", [None, True, False])
def test_use_mla_false_beside_kv_lora_rank_is_refused(ckpts, use_mla):
    """MLA is keyed on kv_lora_rank, as in JAX; a config that also says
    use_mla: false (deepseek-vl2-tiny's language_config does) is refused
    rather than loaded as MLA without its q/k/v weights."""
    with open(os.path.join(ckpts["plain"][0], "config.json")) as fh:
        text_cfg = json.load(fh)
    if use_mla is not None:
        text_cfg["use_mla"] = use_mla
    if use_mla is False:
        with pytest.raises(ValueError, match="use_mla: false"):
            deepseek_v3.deepseek_decoder_config(text_cfg)
        text_cfg.pop("kv_lora_rank")
        assert deepseek_v3.deepseek_decoder_config(text_cfg).mla_kv_lora == 0
    else:
        assert deepseek_v3.deepseek_decoder_config(text_cfg).mla_kv_lora == 16


def _v2_lite_cfg(**kw):
    base = dict(n_layers=27, hidden_size=2048, intermediate_size=10944, n_qo_heads=16,
                n_kv_heads=1, head_dim=576, vocab_size=102400, max_position_embeddings=163840,
                rope_head_dim=64, mla_kv_lora=512, mla_rope_dim=64, mla_nope_dim=128,
                mla_v_dim=128, yarn=(40.0, 4096, 32.0, 1.0, 1.0, True))
    base.update(kw)
    return base


@pytest.mark.parametrize("yarn", [(40.0, 4096, 32.0, 1.0, 1.0, True),
                                  (2.0, 64, 32.0, 1.0, 1.1, True),
                                  (4.0, 32, 16.0, 2.0, 0.9, False)],
                         ids=["v2_lite", "tiny", "untruncated"])
def test_yarn_rope_tables_match_jax(yarn):
    kw = _v2_lite_cfg(yarn=yarn) if yarn[0] == 40.0 else dict(
        n_layers=1, hidden_size=64, intermediate_size=96, n_qo_heads=4, n_kv_heads=1,
        head_dim=24, vocab_size=64, max_position_embeddings=256, rope_head_dim=8,
        yarn=yarn)
    cos, sin = init_rope_tables(DecoderConfig(**kw))
    jcos, jsin = jax_rope_tables(JaxDecoderConfig(**kw))
    assert cos.dtype == torch.float32 and cos.shape == jcos.shape
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=1e-6)
    plain_cos, _ = init_rope_tables(DecoderConfig(**{**kw, "yarn": ()}))
    assert not np.allclose(cos.numpy(), plain_cos.numpy())


@pytest.mark.parametrize("name", ["qlora", "v2lite"])
def test_quantized_keys_match_jax(ckpts, name):
    path = ckpts[name][0]
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype="fp32"), "cpu")
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp"))
    pw = quantize_tree(deepseek_v3.convert_deepseek_weights(
        WeightStore(path, "fp32", "cpu"), pf.decoder_cfg, pf.text_cfg), "int8")
    jw = jax_quantize_tree(jax_ds.convert_deepseek_weights(
        JaxWeightStore(path, cast_dtype="float32"), jf.decoder_cfg, jf.text_cfg), "int8")

    def picked(w, cls):
        keys = [{k for k, v in lw.items() if isinstance(v, cls)} for lw in w["layers"]]
        return keys, isinstance(w["lm_head"], cls)

    got = picked(pw, QuantizedTensor)
    assert got == picked(jw, JaxQT)
    dense, moe_layer = got[0][0], got[0][1]
    assert dense == {"o_proj", "gate_up", "down"} and moe_layer == {"o_proj", "gate_up", "down"}
    assert got[1]
    lw = pw["layers"][1]
    for key in ("moe_gate_up", "moe_down", "moe_router", "kv_a", "w_uk", "w_uv"):
        assert isinstance(lw[key], torch.Tensor), key
    assert lw["moe_gate_up"].shape == (8, 64, 64) and lw["moe_down"].shape == (8, 32, 64)
    assert ("q_a" in lw) == (name == "qlora") and ("q_proj" in lw) == (name != "qlora")
    for key, v in pw["layers"][1].items():
        if isinstance(v, torch.Tensor):
            jv = jw["layers"][1][key]
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv), err_msg=key)


# ------------------------------------------------------------ one sequence

def _step(lm, cache, chunk, n_past):
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
    with torch.no_grad():
        tok, logits = decoder_forward(lm.weights, cache, batch, lm.cos_tab, lm.sin_tab,
                                      lm.cfg, T, torch.zeros(2, dtype=torch.int32),
                                      return_logits=True)
    return int(tok[0]), logits[0].numpy()


def _generate(factory, prompt, n_new, cache_dtype=torch.float32):
    lm = factory.getLanguageModel()
    c = factory.getLanguageModelConfig()
    cache = torch.zeros((c.n_layers, 1, 16, BLOCK, 1, c.head_dim), dtype=cache_dtype)
    tok, logits = _step(lm, cache, prompt, 0)
    out = [tok]
    for _ in range(n_new - 1):
        tok, _ = _step(lm, cache, [out[-1]], len(prompt) + len(out) - 1)
        out.append(tok)
    return out, logits


@pytest.mark.parametrize("name,seed", [("qlora", 3), ("plain", 4), ("yarn", 11)])
def test_mla_matches_hf(ckpts, name, seed):
    path, hf = ckpts[name]
    _, pf = _factories(path)
    prompt = np.random.default_rng(seed).integers(0, VOCAB, size=9).tolist()
    ours, logits = _generate(pf, prompt, 6)
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.tensor([prompt])).logits[0, -1].numpy()
        hf_out = hf.generate(input_ids=torch.tensor([prompt]), max_new_tokens=6,
                             do_sample=False)
    np.testing.assert_allclose(logits, hf_logits, **HF_TOL)
    assert ours == hf_out[0, len(prompt):].tolist()


def test_mla_int8_kv_close_to_fp32(ckpts):
    path = ckpts["qlora"][0]
    prompt = np.random.default_rng(7).integers(0, VOCAB, size=9).tolist()
    _, f32 = _factories(path)
    _, q = _factories(path, kv_int8=True)
    fp_out, fp_logits = _generate(f32, prompt, 5)
    q_out, q_logits = _generate(q, prompt, 5, torch.int8)
    np.testing.assert_allclose(q_logits, fp_logits, atol=0.35, rtol=0.1)
    assert len(q_out) == 5 and all(0 <= t < VOCAB for t in q_out)


# ------------------------------------------------------------ engines

PROMPTS = ["! %&", "&&! %%", "%! &! %% &&! !", "&"]
MAX_TOKENS = (8, 8, 6, 10)


def _requests(req_cls, sp_cls):
    return [req_cls(request_id=f"r{i}", prompt=p,
                    sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


_JAX_TOKENS = {}
_PORT_TOKENS = {}


def _jax_tokens(path, quant, kv_int8):
    key = (path, quant)
    if key not in _JAX_TOKENS:
        jf, _ = _factories(path, quant, kv_int8)
        jf.getTokenizer = lambda: JaxTok(image_token="<image>", image_token_id=0,
                                         eos_token_id=1)
        cfg = JaxNodeConfig(
            batch_scheduler=JaxBSConfig(max_running_requests=4),
            request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
            kv_block_size=4, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
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
@pytest.mark.parametrize("name", ["qlora", "v2lite"])
def test_engine_matches_jax_engine(ckpts, name, quant, kv_int8, k, monkeypatch):
    path = ckpts[name][0]
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
        batch_scheduler=BatchSchedulerConfig(max_running_requests=4),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=k,
        spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=pf, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 16
    cache = engine.node.kv_cache_manager.cache_array
    assert cache.shape[-2:] == (1, 24)
    assert cache.dtype == (torch.int8 if kv_int8 else torch.float32)
    got = [o.output_token_ids for o in engine.generate(_requests(Request, SamplingParameters),
                                                       timeout_s=600)]
    assert [len(t) for t in got] == list(MAX_TOKENS)
    assert got == _jax_tokens(path, quant, kv_int8)
    assert max(windows) == k
    _PORT_TOKENS[name, quant, k] = got
    if (name, quant, 1) in _PORT_TOKENS and (name, quant, 4) in _PORT_TOKENS:
        assert _PORT_TOKENS[name, quant, 1] == _PORT_TOKENS[name, quant, 4]



def test_weight_bridge_carries_the_jax_deepseek_tree(ckpts):
    """The JAX converter's tree (q-LoRA, the router and its correction bias,
    the 3-D stacked experts, the shared experts), carried over by
    from_jax_numpy, is the port converter's leaf for leaf, and a model built
    on it gives the same prefill logits."""
    import jax
    from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
    from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
    path = ckpts["qlora"][0]
    jf, pf = _factories(path)
    jtree = jax_ds.convert_deepseek_weights(JaxWeightStore(path, cast_dtype="float32"),
                                            jf.decoder_cfg, jf.text_cfg)
    bridged = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    ported = deepseek_v3.convert_deepseek_weights(WeightStore(path, "fp32", "cpu"),
                                                  pf.decoder_cfg, pf.text_cfg)
    layer = bridged["layers"][1]
    assert {"q_a", "q_a_norm", "q_b", "moe_router", "moe_router_bias", "moe_gate_up",
            "moe_down", "gate_up", "down"} <= set(layer)
    assert layer["moe_gate_up"].shape == (8, 64, 64)
    for a, b in zip(bridged["layers"], ported["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    prompt = np.random.default_rng(5).integers(0, VOCAB, size=7).tolist()
    cache = lambda: torch.zeros((3, 1, 16, BLOCK, 1, 24))
    lm = LlamaForCausalLM(bridged, pf.decoder_cfg)
    ref = LlamaForCausalLM(ported, pf.decoder_cfg)
    np.testing.assert_array_equal(_step(lm, cache(), prompt, 0)[1],
                                  _step(ref, cache(), prompt, 0)[1])
