"""The CLIP vision transformer of LLaVA-1.5 (port of
hydrainfer_tpu/models/clip.py).

Patch, class and position embeddings, the pre-LayerNorm, then the encoder
layers up to the feature layer (the early exit), with the last layer's
attention probabilities on request (the focal token-pruning input). The
patch convolution is an unfold and one product, accumulated in f32.

The JAX tower attends with a dense batched einsum over (N, L) images; here
the images' rows are flattened to (N * L, H, D) with each row's image index
as its segment id, and attention goes through ops/attention.py:mha_varlen:
kernel K5 for CUDA tensors, its plain version for CPU tensors and whenever
the scores are asked for. That is the same function, image by image.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.activation import quick_gelu
from ..ops.attention import mha_varlen
from ..ops.norm import layer_norm
from .weight_loader import WeightStore


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int
    intermediate_size: int
    n_layers: int            # the layers to run (the early exit applied)
    n_heads: int
    image_size: int
    patch_size: int
    layer_norm_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_config_from_hf(cfg: dict, vision_feature_layer: int = -2) -> CLIPVisionConfig:
    n_total = cfg["num_hidden_layers"]
    # a negative feature layer indexes the hidden states (the embedding
    # output first): -2 runs all but the last layer
    n_run = (n_total + 1 + vision_feature_layer if vision_feature_layer < 0
             else vision_feature_layer)
    return CLIPVisionConfig(
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        n_layers=n_run,
        n_heads=cfg["num_attention_heads"],
        image_size=cfg["image_size"],
        patch_size=cfg["patch_size"],
        layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-5)),
    )


def convert_clip_weights(store: WeightStore, cfg: CLIPVisionConfig, prefix: str) -> dict:
    """HF names under `prefix` (e.g. 'model.vision_tower.vision_model.') ->
    {"patch_embed": (3 * P * P, hidden) in (c, i, j) order, "class_embed",
    "pos_embed", "pre_norm", "layers": [{ln1, qkv (q, k, v fused with their
    biases), out, ln2, fc1, fc2}]}: (weight, bias) pairs, linears (in, out)."""
    p = prefix
    conv = store.get_np(p + "embeddings.patch_embedding.weight")   # (hidden, 3, P, P)
    pair = lambda name: (store.get(name + ".weight"), store.get(name + ".bias"))
    w = {
        "patch_embed": store.to_tensor(np.ascontiguousarray(conv.reshape(conv.shape[0], -1).T)),
        "class_embed": store.get(p + "embeddings.class_embedding"),
        "pos_embed": store.get(p + "embeddings.position_embedding.weight"),
        "pre_norm": pair(p + "pre_layrnorm"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        lp = f"{p}encoder.layers.{i}."
        w["layers"].append({
            "ln1": pair(lp + "layer_norm1"),
            "qkv": store.fused_linear([lp + "self_attn.q_proj", lp + "self_attn.k_proj",
                                       lp + "self_attn.v_proj"], bias=True),
            "out": store.linear(lp + "self_attn.out_proj", bias=True),
            "ln2": pair(lp + "layer_norm2"),
            "fc1": store.linear(lp + "mlp.fc1", bias=True),
            "fc2": store.linear(lp + "mlp.fc2", bias=True),
        })
    return w


def _attention(x: torch.Tensor, qkv, out, n_heads: int, return_scores: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bidirectional attention within each image: x (N, L, hidden). Returns
    (out (N, L, hidden), the probabilities (N, H, L, L) or None)."""
    N, L, hidden = x.shape
    D = hidden // n_heads
    w, b = qkv
    proj = (x.reshape(N * L, hidden) @ w + b).reshape(N * L, 3, n_heads, D)
    q, k, v = proj[:, 0], proj[:, 1], proj[:, 2]     # v stays a strided view
    seq_ids = torch.arange(N, dtype=torch.int32, device=x.device).repeat_interleave(L)
    o, p = mha_varlen(q, k, v, seq_ids, D ** -0.5, return_scores=return_scores)
    if p is not None:
        # the (H, N*L, N*L) probabilities' per-image diagonal blocks
        p = p.reshape(n_heads, N, L, N, L).diagonal(dim1=1, dim2=3).permute(3, 0, 1, 2)
    ow, ob = out
    return (o.reshape(N * L, hidden) @ ow + ob).reshape(N, L, hidden), p


def clip_embed(weights: dict, pixel_values: torch.Tensor,
               cfg: CLIPVisionConfig) -> torch.Tensor:
    """Patch, class and position embeddings and the pre-norm:
    (N, 3, H, W) -> (N, 1 + n_patches, hidden), in the pixels' dtype."""
    N = pixel_values.shape[0]
    P = cfg.patch_size
    g = cfg.image_size // P
    # patch vectors in (c, i, j) order, patches row-major
    x = pixel_values.reshape(N, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(N, g * g, 3 * P * P)
    x = (x.float() @ weights["patch_embed"].float()).to(pixel_values.dtype)
    cls = weights["class_embed"].to(x.dtype).expand(N, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + weights["pos_embed"][None]
    return layer_norm(x, *weights["pre_norm"], cfg.layer_norm_eps)


def clip_run_layers(layers: list, x: torch.Tensor, cfg: CLIPVisionConfig,
                    score_layer: int = -1) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run a slice of the encoder layers over hidden states (N, L, hidden):
    the segment unit of the layer-chunked encode. score_layer: the local
    index whose attention probabilities to return (-1 = none)."""
    scores = None
    for i, lw in enumerate(layers):
        h = layer_norm(x, *lw["ln1"], cfg.layer_norm_eps)
        attn, s = _attention(h, lw["qkv"], lw["out"], cfg.n_heads, i == score_layer)
        if s is not None:
            scores = s
        x = x + attn
        h = layer_norm(x, *lw["ln2"], cfg.layer_norm_eps)
        h = quick_gelu(h @ lw["fc1"][0] + lw["fc1"][1])
        x = x + (h @ lw["fc2"][0] + lw["fc2"][1])
    return x, scores


def clip_forward(weights: dict, pixel_values: torch.Tensor, cfg: CLIPVisionConfig,
                 return_scores: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(N, 3, H, W) -> hidden states (N, 1 + n_patches, hidden), the class
    token at position 0, and the last layer's probabilities (N, H, L, L)
    when return_scores is set."""
    x = clip_embed(weights, pixel_values, cfg)
    return clip_run_layers(weights["layers"], x, cfg,
                           score_layer=cfg.n_layers - 1 if return_scores else -1)
