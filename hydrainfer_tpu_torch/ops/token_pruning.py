"""Focal visual-token pruning (port of hydrainfer_tpu/ops/token_pruning.py).

Picks the most-attended visual tokens of one image from its ViT's last-layer
attention probabilities (VisionModelParameters.return_last_layer_attention):
  - 'rank': score each token by the class token's attention (or the mean
    over queries without a class token) and keep the top n;
  - 'row': each query row votes for its top tokens, and the n tokens with
    the most votes are kept (ties broken by the mean score).
Top-k keeps the lower index first among equal values, as jax.lax.top_k
does (torch.topk does not promise an order among ties). As in the JAX
package, no engine path applies pruning: callers opt in.
"""
from typing import Tuple

import torch


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, largest first,
    the lower index first among equal values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def focal_pruning_rank(scores: torch.Tensor, n_keep: int,
                       use_cls_query: bool = True) -> torch.Tensor:
    """scores: (n_heads, n_q, n_k) last-layer attention of one image.
    Returns the sorted indices (n_keep,) of the kept tokens (class token
    excluded)."""
    s = scores.mean(dim=0)                                   # (n_q, n_k)
    token_scores = s[0, 1:] if use_cls_query else s[:, 1:].mean(dim=0)
    return torch.sort(_top_k_indices(token_scores, n_keep)).values


def focal_pruning_row(scores: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Row strategy: each query row votes for its top n_keep // n_q tokens
    (at least one); keep the n_keep tokens with the most votes."""
    s = scores.mean(dim=0)[:, 1:]                            # (n_q, n_k - 1)
    per_row = max(1, n_keep // s.shape[0])
    row_top = _top_k_indices(s, per_row).reshape(-1)
    votes = torch.zeros(s.shape[1], dtype=torch.float32, device=s.device)
    votes.index_add_(0, row_top, torch.ones_like(row_top, dtype=torch.float32))
    votes = votes + s.mean(dim=0)                            # the tie-break
    return torch.sort(_top_k_indices(votes, n_keep)).values


def focal_pruning(features: torch.Tensor, scores: torch.Tensor, n_keep: int,
                  strategy: str = "rank") -> Tuple[torch.Tensor, torch.Tensor]:
    """features: (n_tokens, d) of one image (class token dropped); scores:
    (n_heads, n_q, n_k). Returns (the kept features, their indices)."""
    idx = (focal_pruning_rank(scores, n_keep) if strategy == "rank"
           else focal_pruning_row(scores, n_keep))
    return features[idx], idx
