"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each module holds the kernel's wrapper and its plain PyTorch version: the
wrapper takes the plain version for CPU tensors only, launches the CUDA kernel
(built from ``csrc/``) for CUDA tensors or raises, and counts its launches in
the wrapper's ``launches`` attribute. A CUDA graph replay runs no wrapper:
``add_launch_counts`` credits the launches its capture recorded
(models/step_graphs.py), so the counts mean the same either way. The MoE dispatch's grouped product
(ops/moe.py:grouped_mm, a library call that replaces no TPU kernel) is
counted the same way, so a path's runs can show it.
"""
from ..moe import grouped_mm
from .kv_writer import write_kv_pages
from .mha_decode import mha_decode_attention
from .mha_varlen import mha_varlen_flash
from .paged_attention import paged_attention_varlen
from .paged_attention_latent import paged_attention_latent
from .quant_matmul import quant_matmul_fp8, quant_matmul_int4, quant_matmul_int8

WRAPPERS = {
    "mha_decode": mha_decode_attention,
    "paged_attention": paged_attention_varlen,
    "kv_writer": write_kv_pages,
    "quant_matmul": quant_matmul_int8,
    "quant_matmul_int4": quant_matmul_int4,
    "quant_matmul_fp8": quant_matmul_fp8,
    "mha_varlen": mha_varlen_flash,
    "paged_attention_latent": paged_attention_latent,
    "grouped_mm": grouped_mm,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def add_launch_counts(counts: dict) -> None:
    for name, n in counts.items():
        WRAPPERS[name].launches += n
