"""getModelFactory's dispatch, and TextOnlyModelFactory against the JAX one.

`random:<arch>` gives RandomWeightFactory with the config's dtype ("auto" is
bf16, as in the JAX package), quantization and KV scale; `+mm` makes it
multimodal (CLIP_TINY for a tiny arch, else CLIP-L/14-336); `fake` or no
path gives FakeModelFactory; a
checkpoint directory dispatches on its config.json (LLaVA-NeXT, InternVL
in both its layouts, and the DeepSeek V2 / V3 and DeepSeek-VL2 families, to
the factories the JAX package picks, among them; Mixtral and GPT-2 too), and
an architecture neither package has raises. A tiny Llama
checkpoint built in process with transformers goes through both packages'
getModelFactory(path) and serves the same greedy tokens on a PD node.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json

import pytest
import torch

from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer


def test_get_model_factory_dispatch(tmp_path):
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    from hydrainfer_tpu_torch.models.fake import FakeModelFactory
    f = getModelFactory(ModelFactoryConfig(name="random:tiny-lm", dtype="float32",
                                           quantization="int8", kv_cache_dtype="int8",
                                           kv_scale=0.07), "cpu")
    assert isinstance(f, RandomWeightFactory)
    assert (f.dtype, f.quantization, f.kv_scale) == (torch.float32, "int8", 0.07)
    assert getModelFactory(ModelFactoryConfig(name="random:tiny-lm"), "cpu").dtype \
        == torch.bfloat16                       # "auto" is bf16, as in JAX
    assert isinstance(getModelFactory(ModelFactoryConfig(), "cpu"), FakeModelFactory)
    assert isinstance(getModelFactory(ModelFactoryConfig(name="fake", path="x"), "cpu"),
                      FakeModelFactory)
    from hydrainfer_tpu_torch.models.random_init import CLIP_L_336, CLIP_TINY
    mm = getModelFactory(ModelFactoryConfig(name="random:tiny-lm+mm"), "cpu")
    assert isinstance(mm, RandomWeightFactory) and mm.multimodal
    assert mm.clip_cfg == CLIP_TINY and mm.getVisionModelConfig().image_token == "<image>"
    big = getModelFactory(ModelFactoryConfig(name="random:llava-7b-lm+mm"), "cpu")
    assert (big.multimodal, big.clip_cfg, big.cfg.hidden_size) == (True, CLIP_L_336, 4096)
    assert big.getVisionModelConfig().image_token_calculator.get_num_image_tokens(
        (336, 336)) == 576
    assert getModelFactory(ModelFactoryConfig(name="random:tiny-lm"), "cpu") \
        .getVisionModelConfig() is None
    from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC
    from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory
    for arch, extra, name in (
            ("MixtralForCausalLM", {**_TEXT, "num_local_experts": 4,
                                    "num_experts_per_tok": 2}, "MixtralModelFactory"),
            ("GPT2LMHeadModel", {"vocab_size": 64, "n_embd": 48, "n_layer": 2, "n_head": 4,
                                 "n_positions": 128}, "GPT2ModelFactory"),
            ("SomethingElse", {}, None)):
        d = tmp_path / arch
        d.mkdir()
        (d / "config.json").write_text(json.dumps({"architectures": [arch], **extra}))
        if name is None:
            with pytest.raises(ValueError, match="no queue item"):
                getModelFactory(ModelFactoryConfig(path=str(d)), "cpu")
            continue
        f = getModelFactory(ModelFactoryConfig(path=str(d)), "cpu")
        assert type(f).__name__ == name
        assert type(jax_get_factory(JaxMFC(path=str(d)))).__name__ == name
        lc = f.getLanguageModelConfig()
        assert (lc.n_layers, lc.hidden_size, lc.vocab_size) == (2, 48, 64)
        assert lc.greedy_only == (name == "GPT2ModelFactory")


_TEXT = {"model_type": "llama", "vocab_size": 64, "hidden_size": 48,
         "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2}
_VIT = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "image_size": 56, "patch_size": 14}


@pytest.mark.parametrize("config,factory_name", [
    ({"architectures": ["LlavaNextForConditionalGeneration"], "text_config": _TEXT,
      "vision_config": {**_VIT, "image_size": 28}}, "LlavaNextModelFactory"),
    ({"architectures": ["InternVLChatModel"], "vision_config": _VIT,
      "llm_config": {**_TEXT, "model_type": "internlm2"}}, "InternVLModelFactory"),
    ({"architectures": ["InternVLForConditionalGeneration"], "model_type": "internvl",
      "vision_config": {**_VIT, "image_size": [56, 56], "patch_size": [14, 14]},
      "text_config": _TEXT}, "InternVLModelFactory"),
], ids=["llavanext", "internvl_original", "internvl_native"])
def test_multimodal_families_dispatch(tmp_path, config, factory_name):
    """LLaVA-NeXT and both InternVL layouts dispatch to the port's factories
    (by architecture, or by model_type "internvl"), as in the JAX package."""
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    (tmp_path / "config.json").write_text(json.dumps(config))
    f = getModelFactory(ModelFactoryConfig(path=str(tmp_path)), "cpu")
    assert type(f).__name__ == factory_name
    lc = f.getLanguageModelConfig()
    assert (lc.n_layers, lc.n_qo_heads, lc.n_kv_heads, lc.hidden_size) == (2, 4, 2, 48)
    vcfg = f.getVisionModelConfig()
    if factory_name == "InternVLModelFactory":
        assert f.hf_style == (config.get("model_type") == "internvl")
        assert vcfg.image_token_id == 92546        # the JAX default
        assert vcfg.image_token_calculator.get_num_image_tokens((56, 56)) == 4
    else:
        assert f.pinpoints[0] == [336, 672] and vcfg.image_token_id == 32000


_DS_TEXT = {"vocab_size": 64, "hidden_size": 48, "intermediate_size": 96,
            "moe_intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "n_routed_experts": 4, "num_experts_per_tok": 2,
            "n_shared_experts": 1, "first_k_dense_replace": 1, "topk_method": "greedy"}


@pytest.mark.parametrize("config,factory_name", [
    ({"architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2", **_DS_TEXT},
     "DeepSeekModelFactory"),
    ({"architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3", **_DS_TEXT,
      "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16},
     "DeepSeekModelFactory"),
    ({"architectures": ["DeepseekForCausalLM"], **_DS_TEXT}, "DeepSeekModelFactory"),
    ({"model_type": "deepseek_v3", **_DS_TEXT}, "DeepSeekModelFactory"),
    ({"model_type": "deepseek_vl_v2", "language_config": _DS_TEXT,
      "vision_config": {"params": {"width": 64, "layers": 2, "heads": 4}}},
     "DeepSeekVL2ModelFactory"),
], ids=["v2", "v3_mla", "deepseek_arch", "v3_model_type", "vl2"])
def test_deepseek_families_dispatch(tmp_path, config, factory_name):
    """The DeepSeek architectures and model types dispatch to the port's
    DeepSeek factories, as the JAX package's getModelFactory does; an MLA
    config asks for the single-plane cache."""
    from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC
    from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    (tmp_path / "config.json").write_text(json.dumps(config))
    f = getModelFactory(ModelFactoryConfig(path=str(tmp_path)), "cpu")
    assert type(f).__name__ == factory_name
    assert type(jax_get_factory(JaxMFC(path=str(tmp_path)))).__name__ == factory_name
    lc = f.getLanguageModelConfig()
    assert (lc.n_layers, lc.hidden_size, lc.vocab_size) == (2, 48, 64)
    assert lc.kv_single_plane == ("kv_lora_rank" in config)
    assert f.decoder_cfg.moe_top_k == 2 and f.decoder_cfg.n_experts == 4
    if factory_name == "DeepSeekVL2ModelFactory":
        assert f.getVisionModelConfig().image_token_id == 128815     # the JAX default
    else:
        assert f.getVisionModel() is None and f.getVisionModelConfig() is None


def test_text_only_factory_matches_jax(tmp_path, monkeypatch):
    """A tiny Llama checkpoint built in process, loaded through both
    packages' getModelFactory(path) (TextOnlyModelFactory) and served on a
    PD node: the same greedy tokens."""
    transformers = pytest.importorskip("transformers")
    from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
    from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
    from hydrainfer_tpu.models import text_only as jax_text_only
    from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC
    from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory
    from hydrainfer_tpu.request import Request as JaxRequest
    from hydrainfer_tpu.request import SamplingParameters as JaxSP
    from hydrainfer_tpu_torch.cluster.node import NodeConfig
    from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
    from hydrainfer_tpu_torch.models import text_only
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    cfg = transformers.LlamaConfig(
        vocab_size=160, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().float().save_pretrained(
        tmp_path, safe_serialization=True)
    monkeypatch.setattr(jax_text_only.TextOnlyModelFactory, "getTokenizer",
                        lambda self: JaxTok())
    monkeypatch.setattr(text_only.TextOnlyModelFactory, "getTokenizer",
                        lambda self: SimpleTokenizer())
    prompts = ["abc def", "0123456789 tokens"]
    jf = jax_get_factory(JaxMFC(path=str(tmp_path), dtype="float32", attention_impl="jnp"))
    jcfg = JaxNodeConfig(n_kv_blocks=64, n_image_blocks=1, kv_block_size=4, spec_ngram_k=0)
    jcfg.model.dtype = "float32"
    jax_out = JaxOfflineEngine(jcfg, model_factory=jf, node_type="PD").generate(
        [JaxRequest(request_id=str(i), prompt=p,
                    sampling_params=JaxSP(max_tokens=6, ignore_eos=True))
         for i, p in enumerate(prompts)])
    pf = getModelFactory(ModelFactoryConfig(path=str(tmp_path), dtype="float32"), "cpu")
    assert isinstance(pf, text_only.TextOnlyModelFactory)
    port_out = OfflineEngine(NodeConfig(n_kv_blocks=64, kv_block_size=4), pf,
                             device="cpu").generate(
        [Request(request_id=str(i), prompt=p,
                 sampling_params=SamplingParameters(max_tokens=6, ignore_eos=True))
         for i, p in enumerate(prompts)])
    assert [o.output_token_ids for o in port_out] == [o.output_token_ids for o in jax_out]
