"""Factory for text-only decoder checkpoints: Llama, Qwen2 (port of
hydrainfer_tpu/models/text_only.py).

It serves LM-only nodes. Where the JAX factory returns an empty vision
config (no image token, no tower), the port's returns None, as its other
text-only factories do: a node then allocates no image cache.
"""
import json
import os

from ..utils.device import resolve_device
from .factory import LanguageModelConfig, ModelFactory, ModelFactoryConfig
from .llama import LlamaForCausalLM, convert_llama_weights, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


class TextOnlyModelFactory(ModelFactory):
    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        self.decoder_cfg = decoder_config_from_hf(self.hf_cfg)
        self._lm = None

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            store = WeightStore(self.config.path, self.config.dtype, self.device)
            weights = convert_llama_weights(store, self.decoder_cfg)
            store.assert_consumed()
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg,
                                        self.config.quantization, kv_scale=kv_scale)
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
