"""DeepSeek-VL2: the SigLIP tower, the 2x2 downsample MLP projector and a
DeepSeek MoE language model (port of hydrainfer_tpu/models/deepseek_vl2.py).

An image is a global 384 view and aspect-fitted local tiles (the candidate
resolution that keeps the most pixels and wastes the fewest); every tile
goes through SigLIP (no class token; 384 pixels pad to 28 x 28 patches of
14), the projector concatenates each 2 x 2 cell (channel-major, as
F.unfold) and maps it to the LM width, and the merge lays the global view's
rows and the local grid's rows out with an image_newline after each row and
the view_seperator between the two.

SigLIP's attention goes through ops/attention.py:mha_varlen, one segment a
tile: kernel K5 on the card (the JAX tower computes the same function as a
dense einsum per tile). SigLIP-so400m's head dim is 1152 / 16 = 72, and K5
takes a multiple of 16: the tower pads each head to the next multiple of 16
when it is built (`pad_siglip_heads`: zero qkv columns and zero proj rows),
so the qkv projection writes q, k and v already padded, the zero columns add
nothing to any score, the padded output columns meet zero proj rows, and no
copy runs at encode time; the softmax scale stays 1 / sqrt(72). The JAX
model pads the tile count up to TILE_BUCKETS only to bound its jit keys; the
port encodes eagerly and runs the exact tile count. The pixels are cast to
the weights' dtype, so a bf16 model runs a bf16 tower.

The language config carries kv_single_plane for an MLA language model, as
DeepSeekModelFactory does; the JAX VL2 factory leaves it out.
"""
import json
import math
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.activation import gelu_exact
from ..ops.attention import mha_varlen
from ..ops.norm import layer_norm
from ..utils.device import resolve_device
from .deepseek_v3 import (convert_deepseek_weights, deepseek_decoder_config,
                          deepseek_language_config)
from .factory import (ImageProcessor, ImageTokenCalculator, LanguageModelConfig,
                      ModelFactory, ModelFactoryConfig, VisionModel, VisionModelConfig,
                      VisionModelOutput, VisionModelParameters)
from .llama import LlamaForCausalLM
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


@dataclass(frozen=True)
class SigLIPConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    n_layers: int = 27
    n_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def n_patches_side(self) -> int:
        # timm's dynamic_img_pad: 384 / 14 -> 28 patches a side
        return math.ceil(self.image_size / self.patch_size)


def convert_siglip_weights(store: WeightStore, cfg: SigLIPConfig, prefix: str = "vision.") -> dict:
    """timm SigLIP names -> {"patch_embed": (3 * P * P, d) in (c, i, j) order,
    "patch_bias", "pos" (n_side², d), "layers": [{ln1, qkv, proj, ln2, fc1,
    fc2}], "norm"}: linears (in, out) with their biases, norms (weight,
    bias)."""
    p = prefix
    conv = store.get_np(p + "patch_embed.proj.weight")
    pair = lambda name: (store.get(name + ".weight"), store.get(name + ".bias"))
    return {"patch_embed": store.to_tensor(np.ascontiguousarray(conv.reshape(conv.shape[0], -1).T)),
            "patch_bias": store.get(p + "patch_embed.proj.bias"),
            "pos": store.get(p + "pos_embed")[0],
            "layers": [{"ln1": pair(f"{p}blocks.{i}.norm1"),
                        "qkv": store.linear(f"{p}blocks.{i}.attn.qkv", bias=True),
                        "proj": store.linear(f"{p}blocks.{i}.attn.proj", bias=True),
                        "ln2": pair(f"{p}blocks.{i}.norm2"),
                        "fc1": store.linear(f"{p}blocks.{i}.mlp.fc1", bias=True),
                        "fc2": store.linear(f"{p}blocks.{i}.mlp.fc2", bias=True)}
                       for i in range(cfg.n_layers)],
            "norm": pair(p + "norm")}


def padded_head_dim(cfg: SigLIPConfig) -> int:
    """The head dim K5 runs: the real one rounded up to a multiple of 16."""
    return -(-(cfg.hidden_size // cfg.n_heads) // 16) * 16


def pad_siglip_heads(vit: dict, cfg: SigLIPConfig) -> dict:
    """The tower with each head's q, k and v columns padded with zeros to
    padded_head_dim and proj's rows to match (a new tree; the caller's is
    left as it was). Unchanged where the head dim is already a multiple of
    16, or where the tree is already padded."""
    H, E = cfg.n_heads, cfg.hidden_size
    D, Dp = E // H, padded_head_dim(cfg)
    if Dp == D or vit["layers"][0]["qkv"][0].shape[1] == 3 * H * Dp:
        return vit

    def pad(w, axis_shape, dim):
        w = w.reshape(axis_shape)
        pads = [0, 0] * (w.dim() - 1 - dim) + [0, Dp - D]
        return F.pad(w, pads)

    layers = []
    for lw in vit["layers"]:
        (qw, qb), (pw, pb) = lw["qkv"], lw["proj"]
        qw = pad(qw, (E, 3, H, D), 3).reshape(E, 3 * H * Dp)
        qb = pad(qb, (3, H, D), 2).reshape(3 * H * Dp)
        pw = pad(pw, (H, D, E), 1).reshape(H * Dp, E)
        layers.append({**lw, "qkv": (qw, qb), "proj": (pw, pb)})
    return {**vit, "layers": layers}


def siglip_forward(weights: dict, pixel_values: torch.Tensor,
                   cfg: SigLIPConfig) -> torch.Tensor:
    """(N, 3, S, S) tiles -> patch tokens (N, n_side², d); no class token.
    Attention within each tile (one mha_varlen segment a tile) at the head
    dim the qkv weights carry (padded or not), scaled by the real one."""
    N, P, g = pixel_values.shape[0], cfg.patch_size, cfg.n_patches_side
    pad = g * P - cfg.image_size
    x = F.pad(pixel_values, (0, pad, 0, pad)) if pad else pixel_values
    x = x.reshape(N, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5).reshape(N, g * g, 3 * P * P)
    x = (x.float() @ weights["patch_embed"].float()).to(pixel_values.dtype)
    x = x + weights["patch_bias"] + weights["pos"][None]
    L, E, H = g * g, cfg.hidden_size, cfg.n_heads
    Dp = weights["layers"][0]["qkv"][0].shape[1] // (3 * H)
    sm_scale = (E // H) ** -0.5
    seq_ids = torch.arange(N, dtype=torch.int32, device=x.device).repeat_interleave(L)
    for lw in weights["layers"]:
        h = layer_norm(x, *lw["ln1"], cfg.layer_norm_eps).reshape(N * L, E)
        qw, qb = lw["qkv"]
        qkv = (h @ qw + qb).reshape(N * L, 3, H, Dp)
        o, _ = mha_varlen(qkv[:, 0], qkv[:, 1], qkv[:, 2], seq_ids, sm_scale)
        pw, pb = lw["proj"]
        x = x + (o.reshape(N * L, H * Dp) @ pw + pb).reshape(N, L, E)
        h = layer_norm(x, *lw["ln2"], cfg.layer_norm_eps)
        (f1w, f1b), (f2w, f2b) = lw["fc1"], lw["fc2"]
        x = x + F.gelu((h @ f1w + f1b).float(), approximate="tanh").to(x.dtype) @ f2w + f2b
    return layer_norm(x, *weights["norm"], cfg.layer_norm_eps)


def mlp_projector_forward(weights: List, feats: torch.Tensor, downsample: int = 2) -> torch.Tensor:
    """(N, hw, d) -> the downsample x downsample cells concatenated
    channel-major (as F.unfold) -> the MLP (exact GELU between layers) ->
    (N, hw / downsample², n_embed)."""
    N, hw, d = feats.shape
    side = int(hw ** 0.5)
    pad = (downsample - side % downsample) % downsample
    x = feats.reshape(N, side, side, d)
    if pad:
        x = F.pad(x, (0, 0, 0, pad, 0, pad))
    s = (side + pad) // downsample
    x = x.reshape(N, s, downsample, s, downsample, d).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(N, s * s, d * downsample * downsample)
    for i, (w, b) in enumerate(weights):
        if i > 0:
            x = gelu_exact(x)
        x = x @ w + b
    return x


class DeepSeekVL2ImageTokenCalculator(ImageTokenCalculator):
    def __init__(self, candidate_resolutions, image_size: int = 384, patch_size: int = 14,
                 downsample_ratio: int = 2):
        self.candidates = candidate_resolutions
        self.image_size = image_size
        self.h = math.ceil((image_size // patch_size) / downsample_ratio)

    def select_best_resolution(self, wh: Tuple[int, int]) -> Tuple[int, int]:
        """(width, height) -> the candidate (width, height) that keeps the
        most pixels and, among those, wastes the fewest."""
        ow, oh = wh
        best, best_eff, best_waste = None, 0, float("inf")
        for bw, bh in self.candidates:
            scale = min(bw / ow, bh / oh)
            eff = min(int(ow * scale) * int(oh * scale), ow * oh)
            waste = bw * bh - eff
            if eff > best_eff or (eff == best_eff and waste < best_waste):
                best, best_eff, best_waste = (bw, bh), eff, waste
        return best

    def tiles(self, image_size: Tuple[int, int]) -> Tuple[int, int]:
        """(height, width) -> the local grid (tiles across, tiles down)."""
        height, width = image_size
        bw, bh = self.select_best_resolution((width, height))
        return bw // self.image_size, bh // self.image_size

    def n_tiles(self, image_size: Tuple[int, int]) -> int:
        nw, nh = self.tiles(image_size)
        return 1 + nw * nh

    def get_num_image_tokens(self, image_size: Tuple[int, int]) -> int:
        nw, nh = self.tiles(image_size)
        h = w = self.h
        return h * (w + 1) + (nh * h) * (nw * w + 1) + 1


class DeepSeekVL2VisionModel(VisionModel):
    """SigLIP over all tiles of a batch, the projector, then the per-image
    merge. weights: {"vit": convert_siglip_weights' tree, "proj": [(w, b),
    ...], "newline": (lm_hidden,), "view_sep": (lm_hidden,)}; the tower's
    heads are padded here (pad_siglip_heads)."""

    def __init__(self, weights: dict, cfg: SigLIPConfig,
                 calculator: DeepSeekVL2ImageTokenCalculator, downsample: int = 2,
                 global_view_pos: str = "head"):
        self.weights = {**weights, "vit": pad_siglip_heads(weights["vit"], cfg)}
        self.cfg = cfg
        self.calc = calculator
        self.downsample = downsample
        self.global_view_pos = global_view_pos
        self.device = weights["vit"]["patch_embed"].device
        self.dtype = weights["vit"]["patch_embed"].dtype

    def forward_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """(n_tiles, 3, S, S) -> projected features (n_tiles, h * w, lm_hidden)."""
        feats = siglip_forward(self.weights["vit"], tiles, self.cfg)
        return mlp_projector_forward(self.weights["proj"], feats, self.downsample)

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        """pixel_values: (total_tiles, 3, S, S), each image's global view then
        its local tiles, image after image (numpy or a tensor);
        params.original_image_sizes gives each image's (h, w) and so its
        tile count. Returns (1, sum of tokens, lm_hidden)."""
        sizes = params.original_image_sizes
        tiles = torch.as_tensor(pixel_values).to(self.device, self.dtype)
        counts = [self.calc.n_tiles(hw) for hw in sizes]
        assert sum(counts) == tiles.shape[0], \
            f"tiles {tiles.shape[0]} != expected {sum(counts)}"
        embeds = self.forward_tiles(tiles)
        merged = [self._merge(part, hw) for part, hw in zip(torch.split(embeds, counts), sizes)]
        return VisionModelOutput(image_features=torch.cat(merged)[None])

    def _merge(self, embeds: torch.Tensor, hw_size) -> torch.Tensor:
        """(1 + nw * nh, h * w, d) -> (n_tokens, d): the global view's rows,
        the view separator and the local grid's rows (or the local grid
        first, with global_view_pos "tail"), an image_newline after every
        row."""
        h = w = int(embeds.shape[1] ** 0.5)
        d = embeds.shape[-1]
        nw, nh = self.calc.tiles(hw_size)
        newline = self.weights["newline"].to(embeds.dtype)
        view_sep = self.weights["view_sep"].to(embeds.dtype)
        g = torch.cat([embeds[0].reshape(h, w, d), newline.expand(h, 1, d)], dim=1)
        local = embeds[1:1 + nw * nh].reshape(nh, nw, h, w, d).permute(0, 2, 1, 3, 4)
        local = local.reshape(nh * h, nw * w, d)
        local = torch.cat([local, newline.expand(nh * h, 1, d)], dim=1)
        g, local = g.reshape(-1, d), local.reshape(-1, d)
        if self.global_view_pos == "head":
            return torch.cat([g, view_sep[None], local])
        return torch.cat([local, view_sep[None], g])


class DeepSeekVL2ImageProcessorAdapter(ImageProcessor):
    """The global view (the image fitted into S x S, centred, padded with the
    mean colour) then the local tiles of the image fitted into the best
    candidate resolution, row by row; each scaled to [0, 1] and normalised:
    one PIL image -> (1 + tiles, 3, S, S) float32 numpy."""

    def __init__(self, calculator: DeepSeekVL2ImageTokenCalculator,
                 image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5)):
        self.calc = calculator
        self.mean = np.asarray(image_mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(image_std, np.float32).reshape(3, 1, 1)

    def _fit_pad(self, image, tw: int, th: int):
        from PIL import Image
        ow, oh = image.size
        scale = min(tw / ow, th / oh)
        nw, nh = max(1, int(ow * scale)), max(1, int(oh * scale))
        canvas = Image.new("RGB", (tw, th), tuple(int(m * 255) for m in self.mean[:, 0, 0]))
        canvas.paste(image.resize((nw, nh)), ((tw - nw) // 2, (th - nh) // 2))
        return canvas

    def _to_array(self, img) -> np.ndarray:
        return (np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0 - self.mean) / self.std

    def process(self, image) -> np.ndarray:
        image = image.convert("RGB")
        s = self.calc.image_size
        bw, bh = self.calc.select_best_resolution(image.size)
        views = [self._to_array(self._fit_pad(image, s, s))]
        tiled = self._fit_pad(image, bw, bh)
        for ty in range(bh // s):
            for tx in range(bw // s):
                views.append(self._to_array(tiled.crop((tx * s, ty * s, (tx + 1) * s,
                                                        (ty + 1) * s))))
        return np.stack(views)


DEFAULT_CANDIDATES = [[384, 384], [384, 768], [768, 384], [768, 768], [384, 1152],
                      [1152, 384]]


class DeepSeekVL2ModelFactory(ModelFactory):
    """DeepSeek-VL2 checkpoints in the original naming (vision.*,
    projector.layers.*, image_newline, view_seperator, language.*)."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        v = self.hf_cfg.get("vision_config", {})
        params = v.get("params", v)
        self.vit_cfg = SigLIPConfig(
            hidden_size=params.get("width", params.get("hidden_size", 1152)),
            intermediate_size=params.get("intermediate_size",
                                         int(params.get("width", 1152) * 3.7362)),
            n_layers=params.get("layers", params.get("num_hidden_layers", 27)),
            n_heads=params.get("heads", params.get("num_attention_heads", 16)),
            image_size=params.get("image_size", 384),
            patch_size=params.get("patch_size", 14))
        proj = self.hf_cfg.get("projector_config", {})
        self.proj_depth = proj.get("depth", 2)
        self.downsample = proj.get("downsample_ratio", 2)
        self.candidates = self.hf_cfg.get("candidate_resolutions", DEFAULT_CANDIDATES)
        self.text_cfg = self.hf_cfg.get("language_config", self.hf_cfg.get("text_config", {}))
        self.decoder_cfg = deepseek_decoder_config(self.text_cfg)
        self._store = None
        self._lm = None
        self._vm = None

    def _get_store(self) -> WeightStore:
        if self._store is None:
            self._store = WeightStore(self.config.path, self.config.dtype, self.device)
        return self._store

    def _calculator(self) -> DeepSeekVL2ImageTokenCalculator:
        return DeepSeekVL2ImageTokenCalculator(self.candidates, self.vit_cfg.image_size,
                                               self.vit_cfg.patch_size, self.downsample)

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            weights = convert_deepseek_weights(self._get_store(), self.decoder_cfg,
                                               self.text_cfg, prefix="language.model.",
                                               lm_head_name="language.lm_head")
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg, self.config.quantization,
                                        kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self) -> DeepSeekVL2VisionModel:
        if self._vm is None:
            store = self._get_store()
            weights = {"vit": convert_siglip_weights(store, self.vit_cfg, "vision."),
                       "proj": [store.linear(f"projector.layers.{i}", bias=True)
                                for i in range(0, 2 * self.proj_depth - 1, 2)],
                       "newline": store.get("image_newline"),
                       "view_sep": store.get("view_seperator")}
            self._vm = DeepSeekVL2VisionModel(weights, self.vit_cfg, self._calculator(),
                                              self.downsample,
                                              self.hf_cfg.get("global_view_pos", "head"))
        return self._vm

    def getVisionModelConfig(self) -> VisionModelConfig:
        return VisionModelConfig(image_token="<image>",
                                 image_token_id=self.hf_cfg.get("image_token_id", 128815),
                                 image_token_calculator=self._calculator())

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        return deepseek_language_config(self.decoder_cfg, self.text_cfg)

    def getProcessor(self) -> DeepSeekVL2ImageProcessorAdapter:
        return DeepSeekVL2ImageProcessorAdapter(self._calculator())

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))
