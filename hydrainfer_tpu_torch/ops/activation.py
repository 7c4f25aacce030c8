"""Activation ops (port of hydrainfer_tpu/ops/activation.py).

The fused gate activations take the concatenated [gate, up] projection and
return act(gate) * up, with the activation taken in f32 (silu_and_mul;
gelu_and_mul with the tanh or the exact GELU). quick_gelu (the CLIP-style
x * sigmoid(1.702 x) of the ViT blocks), the exact, erf-based GELU (the
Qwen2-VL merger's jax.nn.gelu(approximate=False)) and the tanh GELU (GPT-2's
gelu_new, jax.nn.gelu(approximate=True)) also compute in f32 and return the
input's dtype; new_gelu is the JAX package's name for the tanh GELU.
"""
import torch
import torch.nn.functional as F


def silu_and_mul(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return F.silu(gate.float()).to(up.dtype) * up


def gelu_and_mul(gate_up: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    act = F.gelu(gate.float(), approximate="tanh" if approximate else "none")
    return act.to(up.dtype) * up


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def new_gelu(x: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(x)
