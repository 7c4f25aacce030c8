"""LLaVA-NeXT (1.6): anyres tiling, the base tile and the grid tiles, the
spatial unpad and the newline tokens (port of
hydrainfer_tpu/models/llavanext.py).

The CLIP tower runs over every tile of the batch at once, one K5 segment a
tile (models/clip.py), then each image's tiles are merged: the grid
reshape, the centred unpad crop to the original aspect ratio, the
`image_newline` column and the base tile's features first, as HF's
pack_image_features lays them out. The tile count of an image follows from
its size, so the tower takes the sizes (it is not fixed-resolution, and the
layer-chunked encode stays off for it, as in JAX).

The JAX model pads the tile count up to TILE_BUCKETS only to bound its jit
keys; the port encodes eagerly, and pad tiles would only add tower work, so
it runs the exact tile count. As for LLaVA-1.5, the pixels are cast to the
weights' dtype, so a bf16 model runs a bf16 tower.
"""
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.activation import gelu_exact
from .clip import CLIPVisionConfig, clip_forward, convert_clip_weights
from .factory import (ImageProcessor, ImageTokenCalculator, VisionModel, VisionModelConfig,
                      VisionModelOutput, VisionModelParameters)
from .llava import HFImageProcessorAdapter, LlavaModelFactory

# llava-v1.6's image_grid_pinpoints, (height, width)
DEFAULT_PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
# the OpenAI CLIP normalisation of LlavaNextImageProcessor
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def select_best_resolution(original_hw: Tuple[int, int],
                           pinpoints: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """Max effective resolution, then min waste (HF-exact)."""
    oh, ow = original_hw
    best, best_eff, best_waste = None, 0, float("inf")
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = h * w - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


def anyres_geometry(original_hw: Tuple[int, int], pinpoints: Sequence[Sequence[int]],
                    tile_size: int, n_side: int):
    """-> (grid_h, grid_w, unpadded_h, unpadded_w) in feature cells."""
    best_h, best_w = select_best_resolution(original_hw, pinpoints)
    gh, gw = best_h // tile_size, best_w // tile_size
    cur_h, cur_w = gh * n_side, gw * n_side
    oh, ow = original_hw
    if ow / oh > cur_w / cur_h:
        scale = cur_w / ow
        new_h = int(round(oh * scale, 7))
        pad = (cur_h - new_h) // 2
        return gh, gw, cur_h - 2 * pad, cur_w
    scale = cur_h / oh
    new_w = int(round(ow * scale, 7))
    pad = (cur_w - new_w) // 2
    return gh, gw, cur_h, cur_w - 2 * pad


class LlavaNextImageTokenCalculator(ImageTokenCalculator):
    def __init__(self, pinpoints, tile_size: int, n_side: int):
        self.pinpoints = pinpoints
        self.tile_size = tile_size
        self.n_side = n_side

    def n_tiles(self, image_size: Tuple[int, int]) -> int:
        gh, gw, _, _ = anyres_geometry(image_size, self.pinpoints, self.tile_size,
                                       self.n_side)
        return 1 + gh * gw

    def get_num_image_tokens(self, image_size: Tuple[int, int]) -> int:
        gh, gw, uh, uw = anyres_geometry(image_size, self.pinpoints, self.tile_size,
                                         self.n_side)
        return self.n_side ** 2 + uh * (uw + 1)


class LlavaNextVisionModel(VisionModel):
    """CLIP over all tiles, then the per-image anyres merge. weights:
    {"clip": convert_clip_weights' tree, "proj1", "proj2": (w, b),
    "newline": (lm_hidden,)}."""

    def __init__(self, weights: dict, clip_cfg: CLIPVisionConfig, pinpoints,
                 select_strategy: str = "default"):
        self.weights = weights
        self.clip_cfg = clip_cfg
        self.pinpoints = pinpoints
        self.select_strategy = select_strategy
        self.n_side = clip_cfg.image_size // clip_cfg.patch_size
        self.device = weights["clip"]["patch_embed"].device
        self.dtype = weights["clip"]["patch_embed"].dtype

    def forward_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """(n_tiles, 3, S, S) -> projected features (n_tiles, n_side², lm_hidden)."""
        hidden, _ = clip_forward(self.weights["clip"], tiles, self.clip_cfg)
        if self.select_strategy == "default":
            hidden = hidden[:, 1:]
        (w1, b1), (w2, b2) = self.weights["proj1"], self.weights["proj2"]
        return gelu_exact(hidden @ w1 + b1) @ w2 + b2

    def forward(self, pixel_values, params: VisionModelParameters) -> VisionModelOutput:
        """pixel_values: (total_tiles, 3, S, S), each image's tiles in turn
        (numpy or a tensor); params.original_image_sizes gives each image's
        (h, w) and so its tile count. Returns (1, sum of tokens, lm_hidden)."""
        sizes = params.original_image_sizes
        tile_counts = []
        for hw in sizes:
            gh, gw, _, _ = anyres_geometry(hw, self.pinpoints, self.clip_cfg.image_size,
                                           self.n_side)
            tile_counts.append(1 + gh * gw)
        tiles = torch.as_tensor(pixel_values).to(self.device, self.dtype)
        assert sum(tile_counts) == tiles.shape[0], \
            f"tiles {tiles.shape[0]} != expected {sum(tile_counts)}"
        feats = self.forward_tiles(tiles)
        merged = [self._merge(part, hw)
                  for part, hw in zip(torch.split(feats, tile_counts), sizes)]
        return VisionModelOutput(image_features=torch.cat(merged)[None])

    def _merge(self, tile_feats: torch.Tensor, original_hw) -> torch.Tensor:
        """(1 + gh * gw, n_side², d) -> (n_tokens, d), HF pack_image_features-exact."""
        n = self.n_side
        d = tile_feats.shape[-1]
        gh, gw, uh, uw = anyres_geometry(original_hw, self.pinpoints,
                                         self.clip_cfg.image_size, n)
        base = tile_feats[0]
        grid = tile_feats[1:1 + gh * gw].reshape(gh, gw, n, n, d)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(gh * n, gw * n, d)
        # unpad: the centred crop to the original aspect ratio
        top, left = (gh * n - uh) // 2, (gw * n - uw) // 2
        grid = grid[top:top + uh, left:left + uw]
        newline = self.weights["newline"].to(grid.dtype).expand(uh, 1, d)
        grid = torch.cat([grid, newline], dim=1).reshape(uh * (uw + 1), d)
        return torch.cat([base, grid])


class AnyresImageProcessor(ImageProcessor):
    """LlavaNextImageProcessor's anyres tiling with PIL and numpy only: the
    base tile (the image resized to S x S), then the image resized to fit
    its best pinpoint with the aspect ratio kept (bicubic), centred on a
    zero canvas of that pinpoint and cut into S x S tiles row by row; each
    tile scaled to [0, 1] and normalised. One image -> (n_tiles, 3, S, S)
    float32 numpy. tests/test_torch_llavanext.py holds it to the HF
    processor."""

    def __init__(self, pinpoints, tile_size: int = 336, image_mean=CLIP_MEAN,
                 image_std=CLIP_STD):
        self.pinpoints = pinpoints
        self.size = tile_size
        self.mean = np.asarray(image_mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(image_std, np.float32).reshape(3, 1, 1)

    def process(self, image) -> np.ndarray:
        from PIL import Image
        img = image.convert("RGB")
        S = self.size
        th, tw = select_best_resolution((img.height, img.width), self.pinpoints)
        # transformers' get_patch_output_size
        sw, sh = tw / img.width, th / img.height
        if sw < sh:
            nw, nh = tw, min(math.ceil(img.height * sw), th)
        else:
            nw, nh = min(math.ceil(img.width * sh), tw), th
        canvas = np.zeros((th, tw, 3), np.uint8)
        top, left = (th - nh) // 2, (tw - nw) // 2
        canvas[top:top + nh, left:left + nw] = np.asarray(
            img.resize((nw, nh), Image.BICUBIC))
        tiles = [np.asarray(img.resize((S, S), Image.BICUBIC))]
        tiles += [canvas[i:i + S, j:j + S] for i in range(0, th, S) for j in range(0, tw, S)]
        arr = np.stack(tiles).astype(np.float32).transpose(0, 3, 1, 2) / np.float32(255.0)
        return ((arr - self.mean) / self.std).astype(np.float32)


class LlavaNextModelFactory(LlavaModelFactory):
    """LLaVA-NeXT from an HF LlavaNextForConditionalGeneration checkpoint
    directory: the LLaVA factory with the anyres tower."""

    def __init__(self, config, device=None):
        super().__init__(config, device)
        self.pinpoints = self.hf_cfg.get("image_grid_pinpoints") or DEFAULT_PINPOINTS

    def getVisionModel(self) -> LlavaNextVisionModel:
        if self._vm is None:
            store = self._get_store()
            _, clip_prefix, proj_prefix, _ = self._prefixes()
            newline = ("model.image_newline" if store.has("model.image_newline")
                       else "image_newline")
            weights = {"clip": convert_clip_weights(store, self.clip_cfg, clip_prefix),
                       "proj1": store.linear(proj_prefix + "linear_1", bias=True),
                       "proj2": store.linear(proj_prefix + "linear_2", bias=True),
                       "newline": store.get(newline)}
            self._vm = LlavaNextVisionModel(weights, self.clip_cfg, self.pinpoints,
                                            self.select_strategy)
        return self._vm

    def getVisionModelConfig(self) -> VisionModelConfig:
        n_side = self.clip_cfg.image_size // self.clip_cfg.patch_size
        return VisionModelConfig(
            image_token="<image>",
            image_token_id=self.hf_cfg.get("image_token_index", 32000),
            image_token_calculator=LlavaNextImageTokenCalculator(
                self.pinpoints, self.clip_cfg.image_size, n_side))

    def getProcessor(self) -> HFImageProcessorAdapter:
        from transformers.models.llava_next.image_processing_llava_next import (
            LlavaNextImageProcessor)
        try:
            from transformers import AutoImageProcessor
            proc = AutoImageProcessor.from_pretrained(self.config.path)
        except Exception:
            s = self.clip_cfg.image_size
            proc = LlavaNextImageProcessor(
                image_grid_pinpoints=[list(p) for p in self.pinpoints],
                size={"shortest_edge": s}, crop_size={"height": s, "width": s})
        return HFImageProcessorAdapter(proc)
