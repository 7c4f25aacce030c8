"""K5: segment-masked varlen flash attention (csrc/mha_varlen.cu).

Replaces hydrainfer_tpu/ops/pallas/mha_varlen.py:mha_varlen_flash: per head,
q row i attends kv row j iff seq_ids[i] == kv_seq_ids[j] >= 0 and, when
positions are given, kv_pos[j] <= q_pos[i]. The ViT towers call it over the
patches of every image in a batch (one segment per image); the causal form
(separate kv ids and positions) is the one the JAX package builds over
gathered pages. Bound on H100: operations at ViT sizes, bytes at small T.
bf16 inputs take a flash-attention forward on mma.sync with 128-row q tiles
and K/V tiles staged by cp.async in a ring ahead of their use; f32 inputs
take a scalar FMA form. This module also holds the plain version, the port of
hydrainfer_tpu/ops/attention.py:_mha_varlen_dense with the kernel's kv ids
and positions added.
"""
import math
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -0.7 * torch.finfo(torch.float32).max
TILE = 64          # the smallest tile of the kernel's tile-range pre-pass
STAT = 5           # ints the pre-pass records per tile


def mha_varlen_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seq_ids: torch.Tensor, sm_scale: Optional[float] = None,
                     return_scores: bool = False,
                     kv_seq_ids: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None,
                     kv_pos: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense masked attention over (H, Tq, Tk) scores in f32. Returns
    (out (Tq, H, D) in q's dtype, probabilities (H, Tq, Tk) or None); rows
    that see nothing are zeros. A missing position array counts as zeros."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    kv_ids = seq_ids if kv_seq_ids is None else kv_seq_ids
    scores = torch.einsum("qhd,khd->hqk", q.float() * scale, k.float())
    same = (seq_ids[:, None] == kv_ids[None, :]) & (seq_ids >= 0)[:, None]
    if q_pos is not None or kv_pos is not None:
        qp = q_pos if q_pos is not None else torch.zeros_like(seq_ids)
        kp = kv_pos if kv_pos is not None else torch.zeros_like(kv_ids)
        same = same & (kp[None, :] <= qp[:, None])
    scores = torch.where(same[None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    del scores
    e = torch.where(same[None], e, 0.0)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    del e
    out = torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
    return (out, p) if return_scores else (out, None)


def _check_rows(name: str, t: torch.Tensor, H: int, D: int) -> None:
    if t.dim() != 3 or t.shape[1:] != (H, D):
        raise ValueError(f"{name}: expected (T, {H}, {D}), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(-2) != D:
        raise ValueError(f"{name}: heads must be contiguous within a row")


def _check_ids(name: str, t: Optional[torch.Tensor], n: int, dev) -> None:
    if t is None:
        return
    if t.shape != (n,) or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) int32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, q on {dev}")


def mha_varlen_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seq_ids: torch.Tensor, sm_scale: float,
                     kv_seq_ids: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None,
                     kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-masked attention.

    q: (Tq, H, D); k, v: (Tk, H, D), f32 or bf16 alike, rows may be strided
    (heads contiguous); seq_ids (Tq,) and kv_seq_ids (Tk,, default seq_ids)
    int32, -1 = padding; q_pos (Tq,) / kv_pos (Tk,) int32 or None. D is a
    multiple of 16 up to 128. Returns (Tq, H, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return mha_varlen_plain(q, k, v, seq_ids, sm_scale, kv_seq_ids=kv_seq_ids,
                                q_pos=q_pos, kv_pos=kv_pos)[0]
    Tq, H, D = q.shape
    Tk = k.shape[0]
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"head_dim {D} not supported (a multiple of 16 up to 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, H, D)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if kv_seq_ids is None:
        kv_seq_ids = seq_ids
    for name, t, n in (("seq_ids", seq_ids, Tq), ("kv_seq_ids", kv_seq_ids, Tk),
                       ("q_pos", q_pos, Tq), ("kv_pos", kv_pos, Tk)):
        _check_ids(name, t, n, q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share a device")
    code = build.dtype_code(q, (torch.float32, torch.bfloat16))
    if q.dtype == torch.bfloat16:
        # the kernel copies rows in 16-byte pieces
        q, k, v = (t if t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
                   else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((Tq, H, D), dtype=q.dtype, device=q.device)
    stats = torch.empty(STAT * (-(-Tq // TILE) + -(-Tk // TILE)), dtype=torch.int32,
                        device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    build.launch("mha_varlen", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.stride(0), k.stride(0), v.stride(0), out.stride(0),
                 seq_ids.data_ptr(), kv_seq_ids.data_ptr(), ptr(q_pos), ptr(kv_pos),
                 stats.data_ptr(), Tq, Tk, H, D, float(sm_scale), code)
    mha_varlen_flash.launches += 1
    return out


mha_varlen_flash.launches = 0
