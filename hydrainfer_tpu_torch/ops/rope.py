"""Rotary position embeddings (port of hydrainfer_tpu/ops/rope.py).

Both the half-rotated (NeoX) and the interleaved (GPT-J pair) forms, applied
to the leading rotary_dim of each head, in f32, and the multimodal (M-RoPE)
gather of Qwen2-VL.
"""
from typing import Sequence, Tuple

import torch


def compute_default_inv_freq(rotary_dim: int, theta: float) -> torch.Tensor:
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32) / rotary_dim
    return 1.0 / (theta ** exponents)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     interleaved: bool = False) -> torch.Tensor:
    """x: (n_tokens, n_heads, head_dim); cos, sin: (n_tokens, rotary_dim // 2),
    already gathered per token."""
    rotary_dim = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    cos = cos[:, None, :].float()
    sin = sin[:, None, :].float()
    xf = x_rot.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(x_rot.shape)
    else:
        half = rotary_dim // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def mrope_gather(cos_tab: torch.Tensor, sin_tab: torch.Tensor, pos_t: torch.Tensor,
                 pos_h: torch.Tensor, pos_w: torch.Tensor,
                 section: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): three position streams share one frequency
    table; frequency dim d takes its angle from the stream of its section
    (sections [s_t, s_h, s_w] sum to rotary_dim / 2, HF's mrope_section).
    Text tokens carry equal t/h/w positions, so for them this is 1D RoPE.
    Returns per-token (cos, sin) of shape (T, rotary_dim / 2)."""
    assert len(section) == 3, section
    # section id of each frequency column, built on the device (a host tensor
    # would cost a blocking copy in every step)
    cols = torch.arange(sum(section), device=cos_tab.device)
    sec_id = (cols >= section[0]).long() + (cols >= section[0] + section[1]).long()
    pos = torch.stack([pos_t, pos_h, pos_w]).long()          # (3, T)
    rows = pos[sec_id]                                        # (rd/2, T)
    return cos_tab[rows, cols[:, None]].t(), sin_tab[rows, cols[:, None]].t()
