"""InternVL2: InternViT, the pixel-shuffle downsample, the MLP projector and
a Llama-form language model (port of hydrainfer_tpu/models/internvl.py).

InternViT has layer scales (ls1, ls2), an optional qk-norm over the
flattened heads, and a layer norm or an RMS norm by whether the checkpoint
carries a norm bias. Its attention goes through ops/attention.py:mha_varlen,
one segment a tile: kernel K5 on the card (the JAX tower computes the same
function as a dense einsum per tile). Both checkpoint layouts load: the
HF-native one (model.vision_tower.*, model.multi_modal_projector.*,
model.language_model.*) and the original InternVLChatModel one
(vision_model.*, mlp1.*, language_model.*), including InternLM2's fused,
per-kv-head grouped wqkv.

The JAX model pads the tile count up to TILE_BUCKETS only to bound its jit
keys; the port encodes eagerly and runs the exact tile count. The pixels are
cast to the weights' dtype, so a bf16 model runs a bf16 tower.
"""
import json
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.activation import gelu_exact
from ..ops.attention import mha_varlen
from ..ops.norm import layer_norm, rms_norm
from ..utils.device import resolve_device
from .factory import (ImageProcessor, ImageTokenCalculator, LanguageModelConfig,
                      ModelFactory, ModelFactoryConfig, VisionModel, VisionModelConfig,
                      VisionModelOutput, VisionModelParameters)
from .llama import LlamaForCausalLM, convert_llama_weights, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


@dataclass(frozen=True)
class InternViTConfig:
    hidden_size: int
    intermediate_size: int
    n_layers: int
    n_heads: int
    image_size: int
    patch_size: int
    qk_normalization: bool = False
    layer_norm_eps: float = 1e-6
    norm_type: str = "layer_norm"   # 26B uses rms_norm

    @property
    def n_patches_side(self) -> int:
        return self.image_size // self.patch_size


def convert_internvit_weights(store: WeightStore, cfg: InternViTConfig, prefix: str,
                              hf_style: bool) -> dict:
    """hf_style: the model.vision_tower.* names; else the original
    vision_model.* ones. -> {"patch_embed": (3 * P * P, hidden) in (c, i, j)
    order, "patch_bias", "cls", "pos", "layers": [{qkv, proj, ls1, ls2,
    norm1, norm2, fc1, fc2[, q_norm, k_norm]}]}: linears (in, out) with
    their biases, norms (weight, bias or None)."""
    p = prefix
    if hf_style:
        conv = store.get_np(p + "embeddings.patch_embeddings.projection.weight")
        conv_b = store.get(p + "embeddings.patch_embeddings.projection.bias")
        cls = store.get(p + "embeddings.cls_token").reshape(-1)
        pos = store.get(p + "embeddings.position_embeddings")[0]
    else:
        conv = store.get_np(p + "embeddings.patch_embedding.weight")
        conv_b = store.get(p + "embeddings.patch_embedding.bias")
        cls = store.get(p + "embeddings.class_embedding").reshape(-1)
        pos = store.get(p + "embeddings.position_embedding")[0]
    w = {"patch_embed": store.to_tensor(np.ascontiguousarray(conv.reshape(conv.shape[0], -1).T)),
         "patch_bias": conv_b, "cls": cls, "pos": pos, "layers": []}
    for i in range(cfg.n_layers):
        if hf_style:
            lp = f"{p}encoder.layer.{i}."
            lw = {"qkv": store.fused_linear([lp + "attention.q_proj", lp + "attention.k_proj",
                                             lp + "attention.v_proj"], bias=True),
                  "proj": store.linear(lp + "attention.projection_layer", bias=True),
                  "ls1": store.get(lp + "lambda_1"), "ls2": store.get(lp + "lambda_2"),
                  "norm1": _norm_pair(store, lp + "layernorm_before"),
                  "norm2": _norm_pair(store, lp + "layernorm_after"),
                  "fc1": store.linear(lp + "mlp.fc1", bias=True),
                  "fc2": store.linear(lp + "mlp.fc2", bias=True)}
            qn, kn = lp + "attention.q_norm.weight", lp + "attention.k_norm.weight"
        else:
            lp = f"{p}encoder.layers.{i}."
            lw = {"qkv": store.linear(lp + "attn.qkv", bias=True),
                  "proj": store.linear(lp + "attn.proj", bias=True),
                  "ls1": store.get(lp + "ls1"), "ls2": store.get(lp + "ls2"),
                  "norm1": _norm_pair(store, lp + "norm1"),
                  "norm2": _norm_pair(store, lp + "norm2"),
                  "fc1": store.linear(lp + "mlp.fc1", bias=True),
                  "fc2": store.linear(lp + "mlp.fc2", bias=True)}
            qn, kn = lp + "attn.q_norm.weight", lp + "attn.k_norm.weight"
        if cfg.qk_normalization:
            lw["q_norm"], lw["k_norm"] = store.get(qn), store.get(kn)
        w["layers"].append(lw)
    return w


def _norm_pair(store: WeightStore, name: str):
    bias = store.get(name + ".bias") if store.has(name + ".bias") else None
    return store.get(name + ".weight"), bias


def _vit_norm(x, pair, cfg: InternViTConfig):
    w, b = pair
    if b is None:
        return rms_norm(x, w, cfg.layer_norm_eps)
    return layer_norm(x, w, b, cfg.layer_norm_eps)


def internvit_embed(weights: dict, pixel_values: torch.Tensor,
                    cfg: InternViTConfig) -> torch.Tensor:
    """Patch (accumulated in f32), class and position embeddings:
    (N, 3, S, S) -> (N, 1 + P², hidden), in the pixels' dtype."""
    N, P, g = pixel_values.shape[0], cfg.patch_size, cfg.n_patches_side
    x = pixel_values.reshape(N, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(N, g * g, 3 * P * P)
    x = (x.float() @ weights["patch_embed"].float()).to(pixel_values.dtype)
    x = x + weights["patch_bias"]
    cls = weights["cls"].to(x.dtype).expand(N, 1, cfg.hidden_size)
    return torch.cat([cls, x], dim=1) + weights["pos"][None]


def internvit_forward(weights: dict, pixel_values: torch.Tensor,
                      cfg: InternViTConfig) -> torch.Tensor:
    """(N, 3, S, S) tiles -> hidden states (N, 1 + P², hidden); attention
    within each tile (one mha_varlen segment a tile)."""
    x = internvit_embed(weights, pixel_values, cfg)
    N, L, hidden = x.shape
    H = cfg.n_heads
    D = hidden // H
    seq_ids = torch.arange(N, dtype=torch.int32, device=x.device).repeat_interleave(L)
    for lw in weights["layers"]:
        h = _vit_norm(x, lw["norm1"], cfg).reshape(N * L, hidden)
        qw, qb = lw["qkv"]
        qkv = h @ qw + (qb if qb is not None else 0)
        if "q_norm" in lw:
            # InternViT-6B's qk-norm, over the flattened heads
            q = rms_norm(qkv[:, :hidden], lw["q_norm"], cfg.layer_norm_eps)
            k = rms_norm(qkv[:, hidden:2 * hidden], lw["k_norm"], cfg.layer_norm_eps)
            q, k = q.reshape(N * L, H, D), k.reshape(N * L, H, D)
            v = qkv[:, 2 * hidden:].reshape(N * L, H, D)
        else:
            proj = qkv.reshape(N * L, 3, H, D)
            q, k, v = proj[:, 0], proj[:, 1], proj[:, 2]     # v stays a strided view
        o, _ = mha_varlen(q, k, v, seq_ids, D ** -0.5)
        pw, pb = lw["proj"]
        x = x + ((o.reshape(N * L, hidden) @ pw + pb) * lw["ls1"]).reshape(N, L, hidden)
        h = _vit_norm(x, lw["norm2"], cfg)
        (f1w, f1b), (f2w, f2b) = lw["fc1"], lw["fc2"]
        x = x + (gelu_exact(h @ f1w + f1b) @ f2w + f2b) * lw["ls2"]
    return x


def pixel_shuffle_downsample(feats: torch.Tensor, side: int, scale: float = 0.5) -> torch.Tensor:
    """(N, side², d) -> (N, (side * scale)², d / scale²), HF pixel_shuffle-exact."""
    N, _, d = feats.shape
    s = int(1 / scale)
    x = feats.reshape(N, side, side // s, d * s)
    x = x.transpose(1, 2).reshape(N, side // s, side // s, d * s * s)
    return x.transpose(1, 2).reshape(N, (side // s) ** 2, d * s * s)


# ------------------------------------------------------------ dynamic tiling

def _tile_ratios(min_num: int, max_num: int):
    return sorted({(i, j) for n in range(min_num, max_num + 1)
                   for i in range(1, n + 1) for j in range(1, n + 1)
                   if min_num <= i * j <= max_num}, key=lambda r: r[0] * r[1])


def find_closest_aspect_ratio(aspect: float, ratios, width, height, tile_size):
    best, best_diff, area = (1, 1), float("inf"), width * height
    for r in ratios:
        diff = abs(aspect - r[0] / r[1])
        if diff < best_diff or (diff == best_diff
                                and area > 0.5 * tile_size ** 2 * r[0] * r[1]):
            best, best_diff = r, diff
    return best


def dynamic_tile(image, tile_size: int = 448, min_num: int = 1, max_num: int = 12,
                 use_thumbnail: bool = True):
    """Split a PIL image into aspect-preserving tiles (and a thumbnail of
    the whole image when there is more than one)."""
    ow, oh = image.size
    r = find_closest_aspect_ratio(ow / oh, _tile_ratios(min_num, max_num), ow, oh,
                                  tile_size)
    tw, th = tile_size * r[0], tile_size * r[1]
    resized = image.resize((tw, th))
    tiles = []
    for i in range(r[0] * r[1]):
        x0, y0 = (i % r[0]) * tile_size, (i // r[0]) * tile_size
        tiles.append(resized.crop((x0, y0, x0 + tile_size, y0 + tile_size)))
    if use_thumbnail and len(tiles) > 1:
        tiles.append(image.resize((tile_size, tile_size)))
    return tiles


class InternVLImageTokenCalculator(ImageTokenCalculator):
    def __init__(self, tokens_per_tile: int, tile_size: int = 448, max_num: int = 12,
                 use_thumbnail: bool = True):
        self.tokens_per_tile = tokens_per_tile
        self.tile_size = tile_size
        self.max_num = max_num
        self.use_thumbnail = use_thumbnail

    def n_tiles(self, image_size: Tuple[int, int]) -> int:
        h, w = image_size
        r = find_closest_aspect_ratio(w / h, _tile_ratios(1, self.max_num), w, h,
                                      self.tile_size)
        n = r[0] * r[1]
        return n + (1 if self.use_thumbnail and n > 1 else 0)

    def get_num_image_tokens(self, image_size: Tuple[int, int]) -> int:
        return self.n_tiles(image_size) * self.tokens_per_tile


class InternVLVisionModel(VisionModel):
    """InternViT, the class token dropped, the pixel shuffle and the mlp1
    projector (LayerNorm, linear, exact GELU, linear). weights: {"vit",
    "proj_norm", "proj1", "proj2"}."""

    def __init__(self, weights: dict, vit_cfg: InternViTConfig,
                 downsample_ratio: float = 0.5):
        self.weights = weights
        self.cfg = vit_cfg
        self.downsample_ratio = downsample_ratio
        self.device = weights["vit"]["patch_embed"].device
        self.dtype = weights["vit"]["patch_embed"].dtype

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        """pixel_values: (n_tiles, 3, S, S) of every image in turn (numpy or a
        tensor). Returns (1, n_tiles * tokens a tile, lm_hidden)."""
        tiles = torch.as_tensor(pixel_values).to(self.device, self.dtype)
        hidden = internvit_forward(self.weights["vit"], tiles, self.cfg)[:, 1:]
        feats = pixel_shuffle_downsample(hidden, self.cfg.n_patches_side,
                                         self.downsample_ratio)
        x = layer_norm(feats, *self.weights["proj_norm"])
        (w1, b1), (w2, b2) = self.weights["proj1"], self.weights["proj2"]
        x = gelu_exact(x @ w1 + b1) @ w2 + b2
        return VisionModelOutput(image_features=x.reshape(1, -1, x.shape[-1]))


class InternVLImageProcessorAdapter(ImageProcessor):
    """Dynamic tiling, then each tile scaled to [0, 1] and normalised with
    the ImageNet mean and std: one PIL image -> (n_tiles, 3, S, S) float32
    numpy."""

    def __init__(self, tile_size: int = 448, max_num: int = 12,
                 image_mean=(0.485, 0.456, 0.406), image_std=(0.229, 0.224, 0.225)):
        self.tile_size = tile_size
        self.max_num = max_num
        self.mean = np.asarray(image_mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(image_std, np.float32).reshape(3, 1, 1)

    def process(self, image) -> np.ndarray:
        tiles = dynamic_tile(image.convert("RGB"), self.tile_size, max_num=self.max_num)
        arrs = [(np.asarray(t, np.float32).transpose(2, 0, 1) / 255.0 - self.mean) / self.std
                for t in tiles]
        return np.stack(arrs)


def convert_internlm2_weights(store: WeightStore, cfg, prefix: str,
                              lm_head_name: str = "language_model.output") -> dict:
    """InternLM2's original names, its fused wqkv rows grouped per kv head
    as [q_0 .. q_{r-1}, k, v] (r = n_qo_heads / n_kv_heads), into the
    decoder's fused [q | k | v] qkv_proj."""
    r = cfg.n_qo_heads // cfg.n_kv_heads
    kv, D, hid = cfg.n_kv_heads, cfg.head_dim, cfg.hidden_size
    w = {"embed": store.get(f"{prefix}model.tok_embeddings.weight"), "layers": []}
    for layer in range(cfg.n_layers):
        p = f"{prefix}model.layers.{layer}."
        wqkv = store.get_np(p + "attention.wqkv.weight").reshape(kv, r + 2, D, hid)
        fused = np.concatenate([wqkv[:, :r].reshape(kv * r * D, hid),
                                wqkv[:, r].reshape(kv * D, hid),
                                wqkv[:, r + 1].reshape(kv * D, hid)])
        w["layers"].append({
            "qkv_proj": store.to_tensor(np.ascontiguousarray(fused.T)),
            "o_proj": store.linear(p + "attention.wo"),
            "gate_up": store.fused_linear([p + "feed_forward.w1", p + "feed_forward.w3"]),
            "down": store.linear(p + "feed_forward.w2"),
            "input_norm": store.get(p + "attention_norm.weight"),
            "post_norm": store.get(p + "ffn_norm.weight"),
        })
    w["norm"] = store.get(f"{prefix}model.norm.weight")
    w["lm_head"] = store.linear(lm_head_name)
    return w


class InternVLModelFactory(ModelFactory):
    """InternVL from a checkpoint directory: HF-native (model_type
    "internvl") or the original InternVLChatModel, whose language model is
    InternLM2 (fused wqkv) or a Llama / Qwen2 form."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        v = self.hf_cfg["vision_config"]
        first = lambda x, default: x[0] if isinstance(x, list) else (x or default)
        self.hf_style = self.hf_cfg.get("model_type") == "internvl"
        self.vit_cfg = InternViTConfig(
            hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
            n_layers=v["num_hidden_layers"], n_heads=v["num_attention_heads"],
            image_size=first(v.get("image_size"), 448),
            patch_size=first(v.get("patch_size"), 14),
            qk_normalization=bool(v.get("qk_normalization", False)),
            norm_type=v.get("norm_type", "layer_norm"))
        self.downsample_ratio = float(self.hf_cfg.get("downsample_ratio", 0.5))
        self.text_cfg = self.hf_cfg.get("text_config") or self.hf_cfg.get("llm_config")
        self.lm_type = self.text_cfg.get("model_type", "llama")
        self.decoder_cfg = decoder_config_from_hf(self.text_cfg)
        self._store = None
        self._lm = None
        self._vm = None

    def _get_store(self) -> WeightStore:
        if self._store is None:
            self._store = WeightStore(self.config.path, self.config.dtype, self.device)
        return self._store

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            store = self._get_store()
            if self.lm_type == "internlm2":
                weights = convert_internlm2_weights(store, self.decoder_cfg, "language_model.")
            elif store.has("model.language_model.embed_tokens.weight"):
                weights = convert_llama_weights(store, self.decoder_cfg,
                                                prefix="model.language_model.",
                                                lm_head_name="lm_head")
            else:
                weights = convert_llama_weights(store, self.decoder_cfg,
                                                prefix="language_model.model.",
                                                lm_head_name="language_model.lm_head")
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg, self.config.quantization,
                                        kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self) -> InternVLVisionModel:
        if self._vm is None:
            store = self._get_store()
            if self.hf_style:
                vprefix = ("model.vision_tower."
                           if store.has("model.vision_tower.embeddings.cls_token")
                           else "vision_tower.")
                proj = ("model.multi_modal_projector."
                        if store.has("model.multi_modal_projector.layer_norm.weight")
                        else "multi_modal_projector.")
                weights = {"vit": convert_internvit_weights(store, self.vit_cfg, vprefix, True),
                           "proj_norm": (store.get(proj + "layer_norm.weight"),
                                         store.get(proj + "layer_norm.bias")),
                           "proj1": store.linear(proj + "linear_1", bias=True),
                           "proj2": store.linear(proj + "linear_2", bias=True)}
            else:
                weights = {"vit": convert_internvit_weights(store, self.vit_cfg,
                                                            "vision_model.", False),
                           "proj_norm": (store.get("mlp1.0.weight"), store.get("mlp1.0.bias")),
                           "proj1": store.linear("mlp1.1", bias=True),
                           "proj2": store.linear("mlp1.3", bias=True)}
            self._vm = InternVLVisionModel(weights, self.vit_cfg, self.downsample_ratio)
        return self._vm

    def _tokens_per_tile(self) -> int:
        return int((self.vit_cfg.n_patches_side * self.downsample_ratio) ** 2)

    def getVisionModelConfig(self) -> VisionModelConfig:
        return VisionModelConfig(
            image_token="<image>",
            image_token_id=self.hf_cfg.get("image_token_id",
                                           self.hf_cfg.get("image_token_index", 92546)),
            image_token_calculator=InternVLImageTokenCalculator(
                self._tokens_per_tile(), self.vit_cfg.image_size,
                self.hf_cfg.get("max_dynamic_patch", 12),
                self.hf_cfg.get("use_thumbnail", True)))

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        c = self.decoder_cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=self.text_cfg.get("eos_token_id", 2),
            hidden_size=c.hidden_size, vocab_size=c.vocab_size)

    def getProcessor(self) -> InternVLImageProcessorAdapter:
        return InternVLImageProcessorAdapter(self.vit_cfg.image_size,
                                             self.hf_cfg.get("max_dynamic_patch", 12))

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))
