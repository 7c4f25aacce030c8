"""Weight-only quantization, int8 / int4 / fp8-e4m3 (port of hydrainfer_tpu/ops/quant.py).

Symmetric scales (amax times the f32 reciprocal of the largest level, as XLA
folds JAX's division by a constant, so the scales are JAX's bit for bit);
activations keep their dtype and the dequant happens inside
the matmul:
  - int8: per output column;
  - int4: per (input group, output column), g = 128 by default (the largest of
    g, g/2, g/4 that divides the input dim, else per column), two nibbles a
    byte along the input axis;
  - fp8: e4m3 with amax -> 448, per column by default.
On the card every quantized matmul goes through a form of kernel K4
(ops/cuda/quant_matmul.py); the CPU takes their plain versions, JAX's
arithmetic. `quantize_tree` keeps the lm_head at int8 in int4 mode, as JAX
does.
"""
from dataclasses import dataclass
from typing import Union

import torch

from .cuda.quant_matmul import (dequantize_weight, quant_matmul_fp8, quant_matmul_int4,
                                quant_matmul_int8)

GROUP_SIZE = 128        # the default input-axis scale group


@dataclass(frozen=True)
class QuantizedTensor:
    """q: int8 (in, out) for int8, float8_e4m3fn (in, out) for fp8, or
    (in/2, out) packed int8 for int4; scale: (out,) f32 per column, or
    (in/group, out) f32 when group > 0."""
    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8       # 8 for both int8 and fp8
    fmt: str = "int"    # "int" | "fp8"
    group: int = 0      # input-axis scale group (0 = per column only)


Weight = Union[torch.Tensor, QuantizedTensor]


def _group_for(in_dim: int, group: int) -> int:
    """Effective group size: the largest of {group, group/2, group/4} that
    divides the input dim (with more than one group), else 0 (per column)."""
    g = group
    while g >= max(1, group // 4):
        if g and in_dim % g == 0 and in_dim > g:
            return g
        g //= 2
    return 0


def _group_scales(wf: torch.Tensor, group: int, qmax: float):
    """amax scales over (input-group, output-column) tiles: (scaled w ready
    to quantize, scales (in/group, out))."""
    in_dim, out = wf.shape
    g = wf.reshape(in_dim // group, group, out)
    scale = torch.clamp(g.abs().amax(dim=1) * (1.0 / qmax), min=1e-8)
    return (g / scale[:, None, :]).reshape(in_dim, out), scale


def quantize_int8(w: torch.Tensor) -> QuantizedTensor:
    """(in, out) float -> per-column symmetric int8."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def quantize_int4(w: torch.Tensor, group: int = GROUP_SIZE) -> QuantizedTensor:
    """(in, out) float -> symmetric int4, two values a byte along the input
    axis (in must be even): row 2i in the low nibble, 2i + 1 in the high one.
    Scales (in/group, out) where a group fits the input dim, else per
    column."""
    wf = w.float()
    if wf.shape[0] % 2:
        raise ValueError("int4 packing needs an even input dim")
    grp = _group_for(wf.shape[0], group)
    if grp:
        scaled, scale = _group_scales(wf, grp, 7.0)
    else:
        scale = torch.clamp(wf.abs().amax(dim=0) * (1.0 / 7.0), min=1e-8)
        scaled = wf / scale[None, :]
    q = torch.clamp(torch.round(scaled), -7, 7).to(torch.int8).view(torch.uint8)
    packed = (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)
    return QuantizedTensor(q=packed.view(torch.int8), scale=scale, bits=4, group=grp)


def quantize_fp8(w: torch.Tensor, group: int = 0) -> QuantizedTensor:
    """(in, out) float -> float8_e4m3fn (amax -> 448), per-column scales by
    default; group > 0 asks for (input-group, column) scales."""
    wf = w.float()
    grp = _group_for(wf.shape[0], group)
    if grp:
        scaled, scale = _group_scales(wf, grp, 448.0)
    else:
        scale = torch.clamp(wf.abs().amax(dim=0) * (1.0 / 448.0), min=1e-12)
        scaled = wf / scale[None, :]
    q = scaled.to(torch.float8_e4m3fn)
    return QuantizedTensor(q=q, scale=scale, bits=8, fmt="fp8", group=grp)


def _fmt(qt: QuantizedTensor) -> str:
    return "int4" if qt.bits == 4 else "fp8" if qt.fmt == "fp8" else "int8"


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return dequantize_weight(qt.q, qt.scale, _fmt(qt), qt.group, dtype)


def _quant_matmul(x: torch.Tensor, w: QuantizedTensor, out_dtype) -> torch.Tensor:
    """x times a quantized weight through K4's form for its format (looked
    up by name at call time, so a caller can swap in the plain versions)."""
    fmt = _fmt(w)
    if fmt == "int4":
        return quant_matmul_int4(x, w.q, w.scale, w.group, out_dtype)
    if fmt == "fp8":
        return quant_matmul_fp8(x, w.q, w.scale, w.group, out_dtype)
    if w.group:
        raise ValueError("int8 weights take per-column scales only")
    return quant_matmul_int8(x, w.q, w.scale, out_dtype=out_dtype)


def qmatmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ W for plain or quantized weights; output in x's dtype. With a
    group the weight is dequantized and rounded to x's dtype before the
    product; without one the column scale follows the f32 sum (JAX's
    dispatch)."""
    if isinstance(w, QuantizedTensor):
        return _quant_matmul(x, w, x.dtype)
    return x @ w


def qmatmul_f32(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """Like qmatmul but with f32 output (the logits)."""
    if isinstance(w, QuantizedTensor):
        return _quant_matmul(x, w, torch.float32)
    return x.float() @ w.float()


def quantize_tree(weights: dict, mode: str,
                  keys=("qkv_proj", "o_proj", "gate_up", "down", "lm_head")) -> dict:
    """Quantize the matmul weights of a decoder weight dict; mode 'none' |
    'int8' | 'int4' | 'fp8'. Norms, embeddings and MoE experts stay as they
    are; int4 keeps the lm_head at int8 (its error lands on the logits with
    no later layer to wash it out). Idempotent: leaves that are already
    quantized pass through. Returns a new dict and leaves the caller's dict
    as it was."""
    if mode in (None, "none", ""):
        return weights
    quants = {"int8": quantize_int8, "int4": quantize_int4, "fp8": quantize_fp8}
    if mode not in quants:
        raise ValueError(f"unknown quantization {mode!r} (none | int8 | int4 | fp8)")
    quant = quants[mode]
    head_quant = quantize_int8 if mode == "int4" else quant

    def convert(d):
        return {k: (quant(v) if k in keys and isinstance(v, torch.Tensor) else v)
                for k, v in d.items()}

    out = dict(weights)
    if "layers" in out:
        out["layers"] = [convert(lw) for lw in out["layers"]]
    if "lm_head" in keys and isinstance(out.get("lm_head"), torch.Tensor):
        out["lm_head"] = head_quant(out["lm_head"])
    return out
