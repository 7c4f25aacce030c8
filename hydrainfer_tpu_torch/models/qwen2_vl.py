"""Qwen2-VL: ViT with 2D vision RoPE and a patch merger, Qwen2 LM with M-RoPE
(port of hydrainfer_tpu/models/qwen2_vl.py).

The vision tower runs over flat patches (n_patches, temporal * 3 * patch^2)
of every image in the batch at once, in the merged-block patch order the HF
processor emits, with per-patch 2D rope tables and attention masked to each
image's own patches (kernel K5 through ops/attention.py:mha_varlen). Its
dense products are torch.matmul, as the JAX package leaves them to XLA.

The JAX model pads the patch count up to PATCH_BUCKETS only to bound its jit
recompiles; PyTorch runs eagerly, so the port runs the exact patch count.
The JAX model also runs the tower in f32 whenever the pixels arrive in f32
(jnp type promotion); here the patches are cast to the weights' dtype, so a
bf16 model runs a bf16 tower (its features' distance from the JAX tower at
the same weights is held in tests/test_torch_qwen2_vl.py).
"""
import json
import math
import os
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.activation import gelu_exact, quick_gelu
from ..ops.attention import mha_varlen
from ..ops.norm import layer_norm
from ..utils.device import resolve_device
from .factory import (ImageProcessor, ImageTokenCalculator, LanguageModelConfig,
                      ModelFactory, ModelFactoryConfig, VisionModel,
                      VisionModelConfig, VisionModelOutput, VisionModelParameters)
from .llama import LlamaForCausalLM, convert_llama_weights, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


@dataclass(frozen=True)
class Qwen2VisionConfig:
    depth: int
    embed_dim: int
    hidden_size: int        # LM hidden (merger output)
    num_heads: int
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: float = 4.0
    in_channels: int = 3

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """HF Qwen2-VL resize rule: round to multiples of `factor` within the
    pixel budget."""
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class Qwen2VLImageTokenCalculator(ImageTokenCalculator):
    def __init__(self, patch_size: int = 14, merge_size: int = 2):
        self.patch_size = patch_size
        self.merge_size = merge_size

    def get_num_image_tokens(self, image_size: Tuple[int, int]) -> int:
        h, w = smart_resize(image_size[0], image_size[1],
                            factor=self.patch_size * self.merge_size)
        return (h // self.patch_size) * (w // self.patch_size) // (self.merge_size ** 2)

    def get_image_grid(self, image_size: Tuple[int, int]):
        """Merged-token (t, h, w) grid for the M-RoPE position ladders (the
        merger emits tokens in merged-grid row-major order)."""
        h, w = smart_resize(image_size[0], image_size[1],
                            factor=self.patch_size * self.merge_size)
        return (1, h // self.patch_size // self.merge_size,
                w // self.patch_size // self.merge_size)


def vision_rope_tables(grids: List[Tuple[int, int, int]], head_dim: int,
                       merge_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-patch cos/sin of the 2D rope (float64 math, float32 tables), in
    the merged-block patch order the HF processor emits. grids: [(t, h, w)]
    in patches."""
    half = head_dim // 4  # rotary dims per axis
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) * 2 / (head_dim // 2)))
    pos_list = []
    for t, h, w in grids:
        hpos = np.arange(h)[:, None] * np.ones((1, w), np.int64)
        wpos = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

        def blockify(p):
            p = p.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
            return p.transpose(0, 2, 1, 3).reshape(-1)

        pos = np.stack([blockify(hpos), blockify(wpos)], axis=-1)  # (h*w, 2)
        pos_list.append(np.tile(pos, (t, 1)))
    pos = np.concatenate(pos_list, axis=0) if pos_list else np.zeros((0, 2), np.int64)
    freqs = np.concatenate([pos[:, 0:1] * inv[None], pos[:, 1:2] * inv[None]], axis=1)
    emb = np.concatenate([freqs, freqs], axis=1)          # (P, head_dim)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def convert_qwen2_vision_weights(store: WeightStore, cfg: Qwen2VisionConfig,
                                 prefix: str) -> dict:
    """HF vision-tower names -> {"patch_embed": (patch_dim, embed), "blocks":
    [{ln1, qkv, proj, ln2, fc1, fc2}: (weight, bias) pairs], "merger":
    {ln_q, mlp0, mlp2}}, linears stored (in, out)."""
    p = prefix
    conv = store.get_np(p + "patch_embed.proj.weight")  # (embed, 3, T, P, P)
    w = {"patch_embed": store.to_tensor(conv.reshape(conv.shape[0], -1).T), "blocks": []}
    pair = lambda name: (store.get(name + ".weight"), store.get(name + ".bias"))
    for i in range(cfg.depth):
        bp = f"{p}blocks.{i}."
        w["blocks"].append({
            "ln1": pair(bp + "norm1"),
            "qkv": store.linear(bp + "attn.qkv", bias=True),
            "proj": store.linear(bp + "attn.proj", bias=True),
            "ln2": pair(bp + "norm2"),
            "fc1": store.linear(bp + "mlp.fc1", bias=True),
            "fc2": store.linear(bp + "mlp.fc2", bias=True),
        })
    w["merger"] = {"ln_q": pair(p + "merger.ln_q"),
                   "mlp0": store.linear(p + "merger.mlp.0", bias=True),
                   "mlp2": store.linear(p + "merger.mlp.2", bias=True)}
    return w


def qwen2_vision_forward(weights: dict, patches: torch.Tensor, seq_ids: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         cfg: Qwen2VisionConfig) -> torch.Tensor:
    """patches: (P, patch_dim) flat across images, merged-block order;
    seq_ids: (P,) int32 image index per patch (-1 pad); cos/sin: (P,
    head_dim) f32. Returns merged features (P // merge^2, lm_hidden)."""
    P = patches.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    dtype = patches.dtype
    # the patch embedding accumulates in f32
    x = (patches.float() @ weights["patch_embed"].float()).to(dtype)
    cf, sf = cos[:, None, :], sin[:, None, :]
    for bw in weights["blocks"]:
        h = layer_norm(x, *bw["ln1"], 1e-6)
        qkv_w, qkv_b = bw["qkv"]
        qkv = (h @ qkv_w + qkv_b).reshape(P, 3, H, D)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]   # v stays a strided view
        # rope in f32 (bf16 q/k times f32 tables promote), cast back
        q = (q.float() * cf + _rotate_half(q).float() * sf).to(dtype)
        k = (k.float() * cf + _rotate_half(k).float() * sf).to(dtype)
        attn, _ = mha_varlen(q, k, v, seq_ids)
        pw, pb = bw["proj"]
        x = x + (attn.reshape(P, H * D) @ pw + pb)
        h = layer_norm(x, *bw["ln2"], 1e-6)
        f1w, f1b = bw["fc1"]
        f2w, f2b = bw["fc2"]
        x = x + (quick_gelu(h @ f1w + f1b) @ f2w + f2b)
    # merger: 2x2 consecutive patches (merged-block order) -> one token
    m = weights["merger"]
    x = layer_norm(x, *m["ln_q"], 1e-6)
    x = x.reshape(P // cfg.spatial_merge_size ** 2, -1)
    w0, b0 = m["mlp0"]
    w2, b2 = m["mlp2"]
    return gelu_exact(x @ w0 + b0) @ w2 + b2


class Qwen2VLVisionModel(VisionModel):
    def __init__(self, weights: dict, cfg: Qwen2VisionConfig):
        self.weights = weights
        self.cfg = cfg
        self.device = weights["patch_embed"].device
        self.dtype = weights["patch_embed"].dtype

    def grids(self, image_sizes: List[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
        """(t, h, w) patch grid of each image after smart_resize."""
        c = self.cfg
        out = []
        for (h, w) in image_sizes:
            rh, rw = smart_resize(h, w, factor=c.patch_size * c.spatial_merge_size)
            out.append((1, rh // c.patch_size, rw // c.patch_size))
        return out

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        """pixel_values: (total_patches, patch_dim) concatenated across
        images (numpy or tensor); grids from params.original_image_sizes.
        Returns features (1, total_patches // merge^2, lm_hidden)."""
        grids = self.grids(params.original_image_sizes)
        n_patches = sum(t * h * w for t, h, w in grids)
        patches = torch.as_tensor(pixel_values).to(self.device, self.dtype)
        assert n_patches == patches.shape[0], \
            f"patches {patches.shape[0]} != grids {n_patches}"
        seq_ids = np.concatenate([np.full(t * h * w, i, np.int32)
                                  for i, (t, h, w) in enumerate(grids)])
        cos, sin = vision_rope_tables(grids, self.cfg.head_dim,
                                      self.cfg.spatial_merge_size)
        on = lambda a: torch.from_numpy(a).to(self.device)
        feats = qwen2_vision_forward(self.weights, patches, on(seq_ids), on(cos), on(sin),
                                     self.cfg)
        return VisionModelOutput(image_features=feats[None])


class Qwen2VLImageProcessorAdapter(ImageProcessor):
    """Flatten an image into Qwen2-VL patch vectors (merged-block order),
    the HF image processor's layout. Takes a PIL image; returns (P,
    patch_dim) float32 numpy."""

    def __init__(self, cfg: Qwen2VisionConfig,
                 image_mean=(0.48145466, 0.4578275, 0.40821073),
                 image_std=(0.26862954, 0.26130258, 0.27577711)):
        self.cfg = cfg
        self.mean = np.asarray(image_mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(image_std, np.float32).reshape(3, 1, 1)

    def process(self, image) -> np.ndarray:
        c = self.cfg
        h, w = smart_resize(image.height, image.width,
                            factor=c.patch_size * c.spatial_merge_size)
        img = image.convert("RGB").resize((w, h))
        arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        arr = (arr - self.mean) / self.std                          # (3, h, w)
        arr = np.tile(arr[None], (c.temporal_patch_size, 1, 1, 1))  # (T, 3, h, w)
        gh, gw = h // c.patch_size, w // c.patch_size
        m, ps = c.spatial_merge_size, c.patch_size
        arr = arr.reshape(c.temporal_patch_size, 3, gh // m, m, ps, gw // m, m, ps)
        # (block_h, block_w, merge_h, merge_w, 3, T, ps, ps): patch-major
        arr = arr.transpose(2, 5, 3, 6, 1, 0, 4, 7)
        return np.ascontiguousarray(
            arr.reshape(gh * gw, c.in_channels * c.temporal_patch_size * ps * ps))


class Qwen2VLModelFactory(ModelFactory):
    """Qwen2-VL from an HF checkpoint directory (config.json + safetensors)."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        v = self.hf_cfg["vision_config"]
        self.vision_cfg = Qwen2VisionConfig(
            depth=v["depth"], embed_dim=v.get("embed_dim", v.get("hidden_size")),
            hidden_size=v.get("hidden_size") or self.hf_cfg["hidden_size"],
            num_heads=v["num_heads"], patch_size=v.get("patch_size", 14),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            mlp_ratio=v.get("mlp_ratio", 4.0))
        self.decoder_cfg = decoder_config_from_hf(dict(self.hf_cfg, model_type="qwen2"))
        # M-RoPE: HF keeps the (t, h, w) frequency sections in rope_scaling
        rs = self.hf_cfg.get("rope_scaling") or {}
        self.mrope_section = tuple(rs.get("mrope_section", ()))
        if self.mrope_section:
            self.decoder_cfg = replace(self.decoder_cfg, mrope_section=self.mrope_section)
        self._store: Optional[WeightStore] = None
        self._lm = None
        self._vm = None

    def _get_store(self) -> WeightStore:
        if self._store is None:
            self._store = WeightStore(self.config.path, self.config.dtype, self.device)
        return self._store

    def _prefixes(self):
        if self._get_store().has("model.language_model.embed_tokens.weight"):
            return "model.language_model.", "model.visual.", "lm_head"
        return "model.", "visual.", "lm_head"

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            lm_prefix, _, head = self._prefixes()
            weights = convert_llama_weights(self._get_store(), self.decoder_cfg,
                                            prefix=lm_prefix, lm_head_name=head)
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg,
                                        self.config.quantization, kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self) -> Qwen2VLVisionModel:
        if self._vm is None:
            _, vprefix, _ = self._prefixes()
            weights = convert_qwen2_vision_weights(self._get_store(), self.vision_cfg,
                                                   vprefix)
            self._vm = Qwen2VLVisionModel(weights, self.vision_cfg)
        return self._vm

    def getVisionModelConfig(self) -> VisionModelConfig:
        return VisionModelConfig(
            image_token="<|vision_start|><|image_pad|><|vision_end|>",
            image_token_id=self.hf_cfg.get("image_token_id", 151655),
            image_token_calculator=Qwen2VLImageTokenCalculator(
                self.vision_cfg.patch_size, self.vision_cfg.spatial_merge_size))

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        c = self.decoder_cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=self.hf_cfg.get("eos_token_id", 151645),
            hidden_size=c.hidden_size, vocab_size=c.vocab_size,
            mrope_section=self.mrope_section)

    def getProcessor(self) -> Qwen2VLImageProcessorAdapter:
        return Qwen2VLImageProcessorAdapter(self.vision_cfg)

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))
