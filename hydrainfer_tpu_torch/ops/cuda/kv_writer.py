"""K3: paged KV write with the int8 quantize fused in (csrc/kv_writer.cu).

Replaces hydrainfer_tpu/ops/pallas/kv_writer.py:write_kv_pages, and fuses the
int8 quantize of models/decoder.py:_write_kv and the K/V interleave of
ops/cache_ops.py:write_kv_cache into the same pass. Its single-plane form (no
v) writes MLA's latent rows as they are, with the same quantize: the port of
the JAX MLA layer's quantize plus ops/cache_ops.py:write_token_cache. The
pages are updated in place. Bound on H100: bytes (every row is read once and
written once).

The kernel's work item is one input vector of one (row, combined head).
`plan` picks the vector's width and the grid from shapes, strides and
addresses only (no device call, no host sync, so the CPU tests reach it and
a CUDA graph can capture the launch): 16 bytes where every input address,
row stride and head width allows it, else 8, 4 or 2 bytes, else one element.
`divisor` gives the multiply-and-shift constants by which the kernel divides
an item's index into its row and combined head.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

THREADS = 128          # threads a block (csrc/kv_writer.cu:THREADS)
VEC_BYTES = 16         # the widest load a thread issues


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def alignment(bits: int) -> int:
    """The largest power of two, at most VEC_BYTES, that divides `bits`: the
    OR of byte addresses and byte strides, so that it divides each of them."""
    return min(VEC_BYTES, bits & -bits) if bits else VEC_BYTES


class Plan(NamedTuple):
    """A launch of K3: `vec` input elements an item, one item a thread,
    `blocks` blocks of THREADS threads; the (mul, shift) of `divisor` for the
    vectors of a cache row and of a head."""
    vec: int
    blocks: int
    row_div: Tuple[int, int]
    head_div: Tuple[int, int]


@functools.lru_cache(maxsize=1024)
def plan(T: int, planes: int, D: int, in_size: int, out_size: int, in_align: int,
         out_align: int) -> Plan:
    """K3's launch for T rows of `planes` heads x D elements of in_size bytes
    into a cache of out_size-byte elements. in_align: `alignment` of the
    input addresses and row strides in bytes; out_align: of the pages'
    address. The vector is the widest of 16, 8, 4, 2 bytes (or one element)
    that divides D, in_align and, as stored (16-byte pieces at most),
    out_align."""
    vec = VEC_BYTES // in_size
    while vec > 1 and (D % vec or in_align % (vec * in_size)
                       or out_align % min(VEC_BYTES, vec * out_size)):
        vec //= 2
    return Plan(vec, _cdiv(T * planes * D // vec, THREADS), divisor(planes * D // vec),
                divisor(D // vec))


def divisor(d: int) -> Tuple[int, int]:
    """(mul, shift) with i // d == (i * mul) >> shift for 0 <= i < 2^31, as
    csrc/kv_writer.cu:Divisor divides: shift = 31 + ceil(log2 d), mul =
    ceil(2^shift / d) < 2^32."""
    shift = 31 + (d - 1).bit_length()
    return _cdiv(1 << shift, d), shift


def _interleave(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(T, KVH, D) K and V -> (T, 2*KVH, D), K at even heads, V at odd."""
    T, kvh, d = k.shape
    return torch.stack([k, v], dim=2).reshape(T, 2 * kvh, d)


def quantize_kv(x: torch.Tensor, kv_scale: float) -> torch.Tensor:
    """Symmetric int8 with one static scale: clip(round(x / s), -127, 127)."""
    return torch.clamp(torch.round(x.float() / kv_scale), -127, 127).to(torch.int8)


def _check_scale(pages: torch.Tensor, kv_scale: Optional[float]) -> None:
    if (kv_scale is not None) != (pages.dtype == torch.int8):
        raise ValueError("an int8 cache needs kv_scale, and kv_scale needs an "
                         f"int8 cache (cache {pages.dtype}, kv_scale {kv_scale})")


def scatter_rows(flat: torch.Tensor, slot_ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """flat[slot_ids[i]] = rows[i] for every slot >= 0, in place, without a
    host synchronisation (no nonzero): a padding row (slot < 0) repeats the
    first real row's write, same slot and same values, or, when no row is
    real, writes row 0 back as it was. Duplicate writes of equal values leave
    one result whatever their order."""
    keep = slot_ids >= 0
    first = torch.argmax(keep.to(torch.int32))          # 0 when no row is real
    slot0 = slot_ids[first].clamp(min=0).long()
    row0 = torch.where(keep[first], rows[first], flat[slot0])
    idx = torch.where(keep, slot_ids.long(), slot0)
    vals = torch.where(keep.view(-1, *([1] * (rows.dim() - 1))), rows, row0)
    return flat.index_copy_(0, idx, vals)


def write_kv_pages_plain(pages: torch.Tensor, k: torch.Tensor,
                         v: Optional[torch.Tensor], slot_ids: torch.Tensor,
                         kv_scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: quantize (int8 cache) or cast, interleave (unless
    single-plane), scatter."""
    _check_scale(pages, kv_scale)
    kv = k if v is None else _interleave(k, v)
    kv = quantize_kv(kv, kv_scale) if kv_scale is not None else kv.to(pages.dtype)
    scatter_rows(pages.view(-1, pages.shape[-2], pages.shape[-1]), slot_ids, kv)
    return pages


def write_kv_pages(pages: torch.Tensor, k: torch.Tensor, v: Optional[torch.Tensor],
                   slot_ids: torch.Tensor,
                   kv_scale: Optional[float] = None) -> torch.Tensor:
    """Write token rows into one layer's pages, in place.

    pages:    (NB, BS, 2*KVH, D) f32/bf16/int8, K even / V odd heads; or, in
              the single-plane form (v None), (NB, BS, C, D) taking k as is
    k, v:     (T, KVH, D) f32/bf16 (k: (T, C, D) when v is None); rows may be
              strided, heads contiguous
    slot_ids: (T,) int32 physical slot (block * BS + offset); < 0 = dropped
    kv_scale: the static int8 scale (required iff the cache is int8)
    """
    if pages.device.type == "cpu":
        return write_kv_pages_plain(pages, k, v, slot_ids, kv_scale)
    _check_scale(pages, kv_scale)
    T, kvh, d = k.shape
    planes = kvh if v is None else 2 * kvh
    if (v is not None and v.shape != k.shape) or pages.shape[-2:] != (planes, d) \
            or slot_ids.shape != (T,):
        raise ValueError(f"shape mismatch: pages {tuple(pages.shape)}, k "
                         f"{tuple(k.shape)}, v {None if v is None else tuple(v.shape)}, "
                         f"slots {tuple(slot_ids.shape)}")
    rows = (k,) if v is None else (k, v)
    if any(t.dtype != k.dtype for t in rows) or slot_ids.dtype != torch.int32:
        raise TypeError("k and v must share a dtype; slot_ids must be int32")
    for t in rows:
        if t.stride(-1) != 1 or t.stride(-2) != d:
            raise ValueError("k/v heads must be contiguous within a row")
        if t.device != pages.device:
            raise ValueError("k, v and pages must share a device")
    build.check_cuda(pages, slot_ids)
    in_code = build.dtype_code(k, (torch.float32, torch.bfloat16))
    cache_code = build.dtype_code(pages, (torch.float32, torch.bfloat16, torch.int8))
    in_size = k.element_size()
    k_ptr, v_ptr = k.data_ptr(), None if v is None else v.data_ptr()
    k_stride, v_stride = k.stride(0), 0 if v is None else v.stride(0)
    p = plan(T, planes, d, in_size, pages.element_size(),
             alignment(k_ptr | (v_ptr or 0) | (k_stride | v_stride) * in_size),
             alignment(pages.data_ptr()))
    # a null v pointer selects the single-plane form
    build.launch("kv_writer", k_ptr, v_ptr, k_stride, v_stride, slot_ids.data_ptr(),
                 pages.data_ptr(), T, planes, d, in_code, cache_code, p.vec, p.blocks,
                 *p.row_div, *p.head_div, float(kv_scale or 1.0))
    write_kv_pages.launches += 1
    return pages


write_kv_pages.launches = 0
