"""LLaVA-1.5: the CLIP tower, a two-layer GELU projector and a Llama language
model (port of hydrainfer_tpu/models/llava.py).

The tower runs to the feature layer (-2), the class token is dropped
(select strategy "default"), the projector maps the features to the LM's
hidden size, and the features overwrite the embeddings of the prompt's
image tokens. Every image is one fixed-size (3, H, W) tensor, so the tower
also runs in layer segments (`encode_segments`, `forward_embed`,
`forward_segment`, `forward_project`): the layer-chunked encode of
engine/executor.py:ImageEmbedExecutor.

The JAX tower runs in f32 whenever its pixels arrive in f32 (jnp type
promotion, as the processors hand them); here the pixels are cast to the
weights' dtype, so a bf16 model runs a bf16 tower (its distance from the JAX
tower at the same weights is held in tests/test_torch_llava.py).
"""
import json
import os

import numpy as np
import torch

from ..ops.activation import gelu_exact
from ..utils.device import resolve_device
from .clip import (CLIPVisionConfig, clip_config_from_hf, clip_embed, clip_forward,
                   clip_run_layers, convert_clip_weights)
from .factory import (ImageProcessor, ImageTokenCalculator, LanguageModelConfig,
                      ModelFactory, ModelFactoryConfig, VisionModel, VisionModelConfig,
                      VisionModelOutput, VisionModelParameters)
from .llama import LlamaForCausalLM, convert_llama_weights, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore

# the llava-1.5 conversation template (vicuna style), for tokenizers that
# ship none of their own
LLAVA_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{% if message.role == 'user' %}USER: {{ message.content }}\n"
    "{% elif message.role == 'assistant' %}ASSISTANT: {{ message.content }}</s>"
    "{% elif message.role == 'system' %}{{ message.content }}\n"
    "{% endif %}{% endfor %}"
    "{% if add_generation_prompt %}ASSISTANT:{% endif %}"
)


class LlavaImageTokenCalculator(ImageTokenCalculator):
    def __init__(self, n_tokens: int):
        self.n_tokens = n_tokens

    def get_num_image_tokens(self, image_size) -> int:
        return self.n_tokens


class LlavaVisionModel(VisionModel):
    """CLIP, the feature select (the class token dropped), the projector.
    weights: {"clip": convert_clip_weights' tree, "proj1", "proj2": (w, b)}."""

    fixed_resolution = True

    def __init__(self, weights: dict, clip_cfg: CLIPVisionConfig,
                 select_strategy: str = "default"):
        self.weights = weights
        self.clip_cfg = clip_cfg
        self.select_strategy = select_strategy
        self.device = weights["clip"]["patch_embed"].device
        self.dtype = weights["clip"]["patch_embed"].dtype

    def _pixels(self, pixel_values) -> torch.Tensor:
        return torch.as_tensor(pixel_values).to(self.device, self.dtype)

    def forward_project(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tower output (N, 1 + n_patches, hidden) -> features (N, n_tokens,
        lm_hidden)."""
        if self.select_strategy == "default":
            hidden = hidden[:, 1:]
        (w1, b1), (w2, b2) = self.weights["proj1"], self.weights["proj2"]
        return gelu_exact(hidden @ w1 + b1) @ w2 + b2

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        """pixel_values: (N, 3, H, W), numpy or a tensor; the image sizes are
        not read. Returns features (N, n_tokens, lm_hidden) and, with
        params.return_last_layer_attention, the last layer's probabilities
        (N, H, L, L)."""
        hidden, scores = clip_forward(self.weights["clip"], self._pixels(pixel_values),
                                      self.clip_cfg, params.return_last_layer_attention)
        return VisionModelOutput(image_features=self.forward_project(hidden), scores=scores)

    # the layer-chunked encode: the executor runs the embedding and one
    # segment of chunk_layers layers a step, then the projection, so that
    # decode windows reach the card between segments

    def encode_segments(self, chunk_layers: int) -> int:
        return -(-len(self.weights["clip"]["layers"]) // max(1, chunk_layers))

    def forward_embed(self, pixel_values) -> torch.Tensor:
        return clip_embed(self.weights["clip"], self._pixels(pixel_values), self.clip_cfg)

    def forward_segment(self, hidden: torch.Tensor, seg: int,
                        chunk_layers: int) -> torch.Tensor:
        layers = self.weights["clip"]["layers"][seg * chunk_layers:(seg + 1) * chunk_layers]
        return clip_run_layers(layers, hidden, self.clip_cfg)[0]


class HFImageProcessorAdapter(ImageProcessor):
    """A transformers image processor behind the ImageProcessor contract:
    one image -> (3, H, W) float32 numpy."""

    def __init__(self, hf_image_processor):
        self.proc = hf_image_processor

    def process(self, image) -> np.ndarray:
        return np.asarray(self.proc(images=image, return_tensors="np")["pixel_values"][0])


class LlavaModelFactory(ModelFactory):
    """LLaVA-1.5 from an HF LlavaForConditionalGeneration checkpoint
    directory (config.json + safetensors), in either weight-name layout."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        self.text_cfg = self.hf_cfg["text_config"]
        if "vocab_size" not in self.text_cfg:
            self.text_cfg["vocab_size"] = self.hf_cfg.get("vocab_size", 32000)
        self.decoder_cfg = decoder_config_from_hf(self.text_cfg)
        self.clip_cfg = clip_config_from_hf(self.hf_cfg["vision_config"],
                                            self.hf_cfg.get("vision_feature_layer", -2))
        self.select_strategy = self.hf_cfg.get("vision_feature_select_strategy", "default")
        self._store = None
        self._lm = None
        self._vm = None

    def _get_store(self) -> WeightStore:
        if self._store is None:
            self._store = WeightStore(self.config.path, self.config.dtype, self.device)
        return self._store

    def _prefixes(self):
        """(LM, tower, projector, lm_head) names: transformers >= 4.52 nests
        everything under "model."; older checkpoints (the HF hub's
        llava-1.5 weights) use the flat names."""
        if self._get_store().has("model.language_model.embed_tokens.weight"):
            return ("model.language_model.", "model.vision_tower.vision_model.",
                    "model.multi_modal_projector.", "lm_head")
        return ("language_model.model.", "vision_tower.vision_model.",
                "multi_modal_projector.", "language_model.lm_head")

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            lm_prefix, _, _, head = self._prefixes()
            weights = convert_llama_weights(self._get_store(), self.decoder_cfg,
                                            prefix=lm_prefix, lm_head_name=head)
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg,
                                        self.config.quantization, kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self) -> LlavaVisionModel:
        if self._vm is None:
            store = self._get_store()
            _, clip_prefix, proj_prefix, _ = self._prefixes()
            weights = {"clip": convert_clip_weights(store, self.clip_cfg, clip_prefix),
                       "proj1": store.linear(proj_prefix + "linear_1", bias=True),
                       "proj2": store.linear(proj_prefix + "linear_2", bias=True)}
            self._vm = LlavaVisionModel(weights, self.clip_cfg, self.select_strategy)
        return self._vm

    def getVisionModelConfig(self) -> VisionModelConfig:
        n_tokens = self.clip_cfg.n_patches + (self.select_strategy != "default")
        return VisionModelConfig(
            image_token="<image>",
            image_token_id=self.hf_cfg.get("image_token_index", 32000),
            image_token_calculator=LlavaImageTokenCalculator(n_tokens))

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        c = self.decoder_cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=self.text_cfg.get("eos_token_id", 2),
            hidden_size=c.hidden_size, vocab_size=c.vocab_size)

    def getProcessor(self) -> HFImageProcessorAdapter:
        from transformers import AutoImageProcessor
        return HFImageProcessorAdapter(AutoImageProcessor.from_pretrained(self.config.path))

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(self.config.path)
        return HFTokenizerAdapter(tok, chat_template=tok.chat_template or LLAVA_CHAT_TEMPLATE)
