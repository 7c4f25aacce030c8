"""Weightless fake models for engine and server tests (port of
hydrainfer_tpu/models/fake.py).

Instant deterministic outputs behind the real contracts, so the engine path
runs without weights:
  - the language model draws each step's tokens with numpy from the sum of
    the step's padded token ids (the first T entries of the flat buffer), as
    the JAX fake does: given the same flat token prefix, its tokens equal the
    JAX fake's. It writes nothing to the cache or the token table, and runs
    one step a call (no fused window);
  - the vision tower's features are normal draws from a torch.Generator
    seeded with the batch's image count. The JAX fake draws them with
    jax.random, so the two are not bit-equal (the fake language model never
    reads them).
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from .factory import (TORCH_DTYPES, FillDims, ImageProcessor, ImageTokenCalculator,
                      LanguageModel, LanguageModelConfig, LanguageModelOutput,
                      ModelFactory, ModelFactoryConfig, VisionModel, VisionModelConfig,
                      VisionModelOutput, VisionModelParameters)
from .tokenizer import SimpleTokenizer


@dataclass
class FakeConfig:
    image_token: str = "<image>"
    image_token_id: int = 9
    num_image_tokens: int = 16
    n_layers: int = 2
    max_position_embeddings: int = 4096
    hidden_size: int = 64
    n_qo_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    vocab_size: int = 1000
    eos_token_id: int = 2
    image_size: int = 32


class _FixedImageTokens(ImageTokenCalculator):
    def __init__(self, n: int):
        self.n = n

    def get_num_image_tokens(self, image_size):
        return self.n


class FakeVisionModel(VisionModel):
    def __init__(self, cfg: FakeConfig, device: torch.device, dtype: torch.dtype):
        self.cfg = cfg
        self.device = device
        self.dtype = dtype

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        n_images = pixel_values.shape[0]
        gen = torch.Generator().manual_seed(n_images)
        feats = torch.randn((n_images, self.cfg.num_image_tokens, self.cfg.hidden_size),
                            generator=gen, dtype=torch.float32)
        return VisionModelOutput(image_features=feats.to(self.device, self.dtype))


class FakeLanguageModel(LanguageModel):
    def __init__(self, cfg: FakeConfig, dtype: torch.dtype):
        self.cfg = cfg
        self.dtype = dtype

    def forward_flat(self, cache, token_table, flat, dims: FillDims, n_steps: int = 1,
                     fused_k=None, image_cache=None, graphs=None,
                     generator=None) -> LanguageModelOutput:
        seed = int(flat[:dims.T].sum()) % (2 ** 31)
        tokens = np.random.default_rng(seed).integers(
            10, self.cfg.vocab_size, size=(dims.S,), dtype=np.int32)
        return LanguageModelOutput(sample_token_ids=torch.from_numpy(tokens).to(flat.device))


class FakeImageProcessor(ImageProcessor):
    def __init__(self, cfg: FakeConfig):
        self.cfg = cfg

    def process(self, image) -> np.ndarray:
        arr = np.asarray(image.resize((self.cfg.image_size, self.cfg.image_size)),
                         dtype=np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        return arr.transpose(2, 0, 1) / 255.0


class FakeModelFactory(ModelFactory):
    def __init__(self, config: ModelFactoryConfig = None, fake_config: FakeConfig = None,
                 device=None):
        self.cfg = fake_config or FakeConfig()
        self.device = resolve_device(device)
        self.dtype = TORCH_DTYPES[(config or ModelFactoryConfig()).dtype]

    def getVisionModel(self) -> FakeVisionModel:
        return FakeVisionModel(self.cfg, self.device, self.dtype)

    def getLanguageModel(self) -> FakeLanguageModel:
        return FakeLanguageModel(self.cfg, self.dtype)

    def getVisionModelConfig(self) -> VisionModelConfig:
        return VisionModelConfig(
            image_token=self.cfg.image_token, image_token_id=self.cfg.image_token_id,
            image_token_calculator=_FixedImageTokens(self.cfg.num_image_tokens))

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        c = self.cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=c.eos_token_id, hidden_size=c.hidden_size,
            vocab_size=c.vocab_size)

    def getProcessor(self) -> FakeImageProcessor:
        return FakeImageProcessor(self.cfg)

    def getTokenizer(self) -> SimpleTokenizer:
        return SimpleTokenizer(self.cfg.image_token, self.cfg.image_token_id,
                               self.cfg.eos_token_id)
