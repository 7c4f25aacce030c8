"""Carries the JAX package's weights over to the port.

`from_jax_numpy` takes the tree that
hydrainfer_tpu.models.random_init.init_decoder_weights returns, with every
leaf already turned into numpy (a quantized leaf is any object with `.q` and
`.scale` numpy arrays; its `bits`, `fmt` and `group` carry over: int8,
int4 packed two a byte, fp8 as ml_dtypes float8_e4m3fn), and returns the
port's weight dict. It imports
nothing of the JAX package: the caller does the JAX-side conversion, e.g.
``jax.tree_util.tree_map(np.asarray, tree)``, BEFORE handing the tree to the
JAX model (whose weight packing consumes it). Every leaf carries over as it
is, so a DeepSeek layer's leaves do too: the q-LoRA stack (q_a, q_a_norm,
q_b), the router and its correction bias, and the 3-D stacked experts
(moe_gate_up (E, H, 2I), moe_down (E, I, H)), and so do Mixtral's (the
Llama tree plus the router and the stacked experts). GPT-2's tree
(hydrainfer_tpu/models/gpt2.py:convert_gpt2_weights: top-level "wte", "wpe"
and the (weight, bias) pair "ln_f"; layers of (weight, bias) pairs) carries
over pair by pair.

`from_jax_vision_numpy` does the same for a vision tower's weights, numpy
leaves again, copying the nested dicts, lists and (weight, bias) tuples as
they are, and an absent leaf (None) as None. It carries every tower the
port has: Qwen2-VL's, in the layout of
hydrainfer_tpu/models/qwen2_vl.py:convert_qwen2_vision_weights (patch_embed,
blocks, merger); LLaVA's, in the layout of
hydrainfer_tpu/models/random_init.py:init_clip_weights(lm_hidden=...) and of
the JAX LlavaModelFactory (the CLIP tower under "clip", then the projector);
LLaVA-NeXT's (LLaVA's plus "newline"); and InternVL's (the InternViT tree
under "vit", with its layer scales and optional qk-norms, then "proj_norm",
"proj1" and "proj2"); and DeepSeek-VL2's (the SigLIP tree under "vit", the
projector's layers as a list of (weight, bias) under "proj", "newline" and
"view_sep"; the port's tower pads SigLIP's heads itself when it is built).
"""
import numpy as np
import torch

from ..ops.quant import QuantizedTensor
from ..utils.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    # ml_dtypes bfloat16 and float8_e4m3fn: share the bits
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf(x, device):
    if isinstance(x, tuple):                # GPT-2's (weight, bias) pairs
        return tuple(_leaf(v, device) for v in x)
    if hasattr(x, "q") and hasattr(x, "scale"):
        return QuantizedTensor(_tensor(x.q, device), _tensor(x.scale, device),
                               bits=getattr(x, "bits", 8), fmt=getattr(x, "fmt", "int"),
                               group=getattr(x, "group", 0))
    return _tensor(x, device)


def from_jax_numpy(tree: dict, device=None) -> dict:
    """{"embed", "layers": [dict], "norm", "lm_head"} (GPT-2: {"wte", "wpe",
    "layers", "ln_f"}) of numpy leaves -> the port's weights on `device` (the
    card unless "cpu" is asked for). None entries (absent biases) are
    dropped."""
    device = resolve_device(device)
    out = {k: _leaf(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: _leaf(v, device) for k, v in lw.items() if v is not None}
                     for lw in tree["layers"]]
    return out


def _nested(x, device):
    if isinstance(x, dict):
        return {k: _nested(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_nested(v, device) for v in x)
    return None if x is None else _tensor(x, device)


def from_jax_vision_numpy(tree: dict, device=None) -> dict:
    """A vision tower's tree of numpy leaves -> the same structure of
    tensors on `device`. Qwen2-VL: {"patch_embed", "blocks": [{ln1, qkv,
    proj, ln2, fc1, fc2}], "merger": {ln_q, mlp0, mlp2}}. LLaVA: {"clip":
    {patch_embed, class_embed, pos_embed, pre_norm, "layers": [{ln1, qkv,
    out, ln2, fc1, fc2}]}, "proj1", "proj2"}, plus "newline" for LLaVA-NeXT.
    InternVL: {"vit": {patch_embed, patch_bias, cls, pos, "layers": [{qkv,
    proj, ls1, ls2, norm1, norm2, fc1, fc2[, q_norm, k_norm]}]}, "proj_norm",
    "proj1", "proj2"}. DeepSeek-VL2: {"vit": {patch_embed, patch_bias, pos,
    "layers": [{ln1, qkv, proj, ln2, fc1, fc2}], norm}, "proj": [(w, b), ...],
    "newline", "view_sep"}. Every pair is (weight, bias); a norm's bias may be
    None (InternViT's RMS norm)."""
    return _nested(tree, resolve_device(device))
