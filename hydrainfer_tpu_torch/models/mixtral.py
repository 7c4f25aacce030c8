"""Mixtral: the top-2 sparse-MoE Llama-family decoder (port of
hydrainfer_tpu/models/mixtral.py).

Each layer's attention is Llama's (fused qkv, GQA, rope); its MLP is the
decoder's MoE branch (models/decoder.py:_mlp): the router's softmax, the
top-k experts renormalised, and one grouped product a projection over the
stacked experts (ops/moe.py:moe_ffn). Each expert's w1 and w3 are fused into
moe_gate_up (E, d, 2I) and the w2s stacked into moe_down (E, I, d). int8
weights follow quantize_tree's keys: qkv, o_proj and lm_head; the experts and
the router stay in the model's dtype, as in the JAX package.
"""
import dataclasses
import json
import os

import torch

from ..utils.device import resolve_device
from .decoder import DecoderConfig
from .factory import LanguageModelConfig, ModelFactory, ModelFactoryConfig
from .llama import LlamaForCausalLM, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


def mixtral_decoder_config(hf_cfg: dict) -> DecoderConfig:
    """Llama's config plus the routing: num_experts_per_tok of
    num_local_experts (softmax, renormalised top-k: the decoder's default)."""
    return dataclasses.replace(decoder_config_from_hf(hf_cfg),
                               moe_top_k=hf_cfg.get("num_experts_per_tok", 2),
                               n_experts=hf_cfg.get("num_local_experts", 8))


def convert_mixtral_weights(store: WeightStore, cfg: DecoderConfig, prefix: str = "model.",
                            lm_head_name: str = "lm_head") -> dict:
    """HF Mixtral names -> the decoder's weight dict."""
    w = {"embed": store.get(f"{prefix}embed_tokens.weight"), "layers": []}
    for layer in range(cfg.n_layers):
        p = f"{prefix}layers.{layer}."
        e = f"{p}block_sparse_moe.experts."
        w["layers"].append({
            "qkv_proj": store.fused_linear([p + "self_attn.q_proj", p + "self_attn.k_proj",
                                            p + "self_attn.v_proj"]),
            "o_proj": store.linear(p + "self_attn.o_proj"),
            "moe_router": store.linear(p + "block_sparse_moe.gate"),
            "moe_gate_up": torch.stack([store.fused_linear([f"{e}{i}.w1", f"{e}{i}.w3"])
                                        for i in range(cfg.n_experts)]),
            "moe_down": torch.stack([store.linear(f"{e}{i}.w2")
                                     for i in range(cfg.n_experts)]),
            "input_norm": store.get(p + "input_layernorm.weight"),
            "post_norm": store.get(p + "post_attention_layernorm.weight"),
        })
    w["norm"] = store.get(f"{prefix}norm.weight")
    if cfg.tie_word_embeddings or not store.has(f"{lm_head_name}.weight"):
        w["lm_head"] = w["embed"].t().contiguous()
    else:
        w["lm_head"] = store.linear(lm_head_name)
    return w


class MixtralModelFactory(ModelFactory):
    """MixtralForCausalLM checkpoints (text only)."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        self.decoder_cfg = mixtral_decoder_config(self.hf_cfg)
        self._lm = None

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            store = WeightStore(self.config.path, self.config.dtype, self.device)
            weights = convert_mixtral_weights(store, self.decoder_cfg)
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg, self.config.quantization,
                                        kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self):
        return None

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        c = self.decoder_cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=self.hf_cfg.get("eos_token_id", 2),
            hidden_size=c.hidden_size, vocab_size=c.vocab_size)

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))
