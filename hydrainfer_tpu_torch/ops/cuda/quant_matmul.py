"""K4: weight-only GEMM (csrc/quant_matmul.cuh), int8, int4 and fp8 weights.

int8 (csrc/quant_matmul.cu) replaces hydrainfer_tpu/ops/pallas/quant_matmul.py:
quant_matmul_int8: x (M, K) bf16/f32 times w_q (K, N) int8, accumulated in f32
and scaled per output column. int4 (csrc/quant_matmul_int4.cu: (K/2, N) bytes,
two k a byte along the input axis) and fp8 (csrc/quant_matmul_fp8.cu: (K, N)
float8_e4m3fn) replace no pallas_call: the JAX package runs them through XLA's
dequant-in-dot (hydrainfer_tpu/ops/quant.py:169-203). Their scale is per column
(applied to the f32 sum) or per (group, column) (applied to the weight, which
is rounded to x's dtype before the product, as JAX's dequantize then dot).
Every form converts its tile inside the kernel, so a dequantized weight never
exists in device memory.

bf16 activations take one of two forms, chosen by `plan` from (M, K, N) only
(no device call, no host sync, so the CPU tests reach it and a CUDA graph can
capture the launch):

- skinny (M <= 64, decode steps and the lm_head): bound by the K x N weight
  read. A block owns a 64-, 128- or 256-column strip and one K slice;
- wide (M > 64, prefill chunks): bound by tensor-core operations, wgmma
  on output tiles of 128 x rows by 128 columns.

Either form may cut K into `splits` slices (at most 8: one portable
thread-block cluster) when the output tiles alone give too few blocks; the
cluster sums the slices' partials in a fixed order in the same launch.
`quant_matmul_int8_split_plain` is that arithmetic in PyTorch.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8         # the portable thread-block cluster size
SKINNY_MAX_M = 64      # the skinny form's rows: eight n8 tiles of mma.sync
STAGES = 4             # cp.async ring depth (csrc/quant_matmul.cuh:STAGES)
BK = 64                # the K tile of both forms
WIDE_ROWS = 128        # the wide form's x rows a block
MIN_SLICE_TILES = 4    # K tiles a split keeps at least
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may have
FORM_CODES = {"skinny": 0, "wide": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """A launch of K4: the form, the output columns of a block (bn) and the
    K slices of one output tile (splits: the blocks of one thread-block
    cluster)."""
    form: str
    bn: int
    splits: int

    def blocks(self, M: int, N: int) -> int:
        rows = 1 if self.form == "skinny" else _cdiv(M, WIDE_ROWS)
        return self.splits * _cdiv(N, self.bn) * rows

    def smem_bytes(self, M: int, fmt: str = "int8", grouped: bool = False) -> int:
        """Dynamic shared memory of a block: the ring of weight tiles (BK rows
        of bytes, BK / 2 packed ones for int4, padded by 16 bytes), bf16 x
        tiles (the skinny form's rows padded by 8 values; the wide form's
        1024-byte aligned: its stages rounded up to 1024 bytes, plus 1024
        bytes to align them) and, with group scales, 4 f32 rows of the
        strip's scales. The merge tile reuses the ring. The card tests hold
        this to the hydra_quant_matmul*_smem of csrc/quant_matmul*.cu."""
        w_bytes = (BK // 2 if fmt == "int4" else BK) * (self.bn + 16)
        s_bytes = 4 * self.bn * 4 if grouped else 0
        if self.form == "skinny":
            rows = 8 * (1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8)
            return STAGES * (w_bytes + rows * (BK + 8) * 2 + s_bytes)
        return STAGES * 1024 * _cdiv(WIDE_ROWS * BK * 2 + w_bytes + s_bytes, 1024) + 1024


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int) -> Plan:
    """K4's launch for bf16 x, from shapes only. The skinny rules keep the
    fastest of the candidate plans timed on an H100 at the serving paths'
    decode shapes.

    skinny (M <= 64): the widest outputs (lm_heads) take 2 slices, of
    128-column strips where those alone are four waves of the card, else of
    256-column strips; the others 128-column strips where those alone reach
    the SM count, else 64, split to two blocks an SM. wide: 128-row by
    128-column tiles, split to about 1.5 blocks an SM (at least 2 slices)
    below four waves. Every slice keeps at least MIN_SLICE_TILES K tiles."""
    k_tiles = _cdiv(K, BK)
    if M <= SKINNY_MAX_M:
        form = "skinny"
        strips = _cdiv(N, 128)
        if strips >= 4 * SMS:
            bn, want = 128, 2
        elif 2 * strips >= 3 * SMS:
            bn, want = 256, 2
        else:
            bn = 128 if strips >= SMS else 64
            tiles = _cdiv(N, bn)
            want = 1 if tiles >= 2 * SMS else _cdiv(2 * SMS, tiles)
    else:
        form, bn = "wide", 128
        tiles = _cdiv(N, bn) * _cdiv(M, WIDE_ROWS)
        want = 1 if tiles >= 4 * SMS else max(2, round(1.5 * SMS / tiles))
    return Plan(form, bn, max(1, min(MAX_SPLITS, want, k_tiles // MIN_SLICE_TILES)))


def split_tiles(tiles: int, splits: int, i: int) -> Tuple[int, int]:
    """K tiles [lo, hi) of split i: ceil(tiles / splits) each, empty past
    the end, as csrc/quant_matmul.cu:split_tiles cuts them."""
    per = _cdiv(tiles, splits)
    lo = min(tiles, i * per)
    return lo, min(tiles, lo + per)


def quant_matmul_int8_plain(x: torch.Tensor, w_q: torch.Tensor,
                            scale: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: (x @ float(w_q)) * scale in f32, cast to out_dtype."""
    out_dtype = out_dtype or x.dtype
    return ((x.float() @ w_q.float()) * scale.float()[None, :]).to(out_dtype)


def quant_matmul_int8_split_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic: K cut as `plan` cuts it, each slice's f32
    partial product, the partials summed from slice 0 on, then scaled and
    cast."""
    out_dtype = out_dtype or x.dtype
    parts = split_partials(x, w_q)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return (acc * scale.float()[None, :]).to(out_dtype)


def split_partials(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(splits, M, N) f32: each K slice's partial product, as `plan` cuts K.
    w_q: the (K, N) weight values the kernel multiplies (int8 values, or an
    unpacked or dequantized weight)."""
    (M, K), N = x.shape, w_q.shape[1]
    splits = plan(M, K, N).splits
    parts = torch.zeros((splits, M, N), dtype=torch.float32, device=x.device)
    for i in range(splits):
        lo, hi = split_tiles(_cdiv(K, BK), splits, i)
        k0, k1 = lo * BK, min(K, hi * BK)
        if k0 < k1:
            parts[i] = x[:, k0:k1].float() @ w_q[k0:k1].float()
    return parts


def quant_matmul_int8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) x (K, N) int8 * scale (N,) -> (M, N) in out_dtype (x's dtype by
    default). CPU tensors take the plain version; CUDA tensors the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, w_q, scale, out_dtype)
    M, K = x.shape
    K2, N = w_q.shape
    if K != K2 or scale.shape != (N,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("w_q must be int8 and scale float32")
    build.check_cuda(x, w_q, scale)
    x_code = build.dtype_code(x, (torch.float32, torch.bfloat16))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    out_code = build.dtype_code(out, (torch.float32, torch.bfloat16))
    p = plan(M, K, N)
    build.launch("quant_matmul", x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), M, K, N, x_code, out_code, FORM_CODES[p.form], p.bn,
                 p.splits)
    quant_matmul_int8.launches += 1
    return out


quant_matmul_int8.launches = 0


# ------------------------------------------------------ int4 and fp8 forms

def group_ok(group: int) -> bool:
    """A group scale the kernel takes: each 16-deep K step of a 64-deep tile
    in one group (csrc/quant_matmul.cuh:group_ok)."""
    return group > 0 and group % 16 == 0 and (group % 64 == 0 or 64 % group == 0)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed bytes -> (K, N) int8 in [-7, 7]: row 2i from the low
    nibble of row i, row 2i + 1 from the high one."""
    b = packed.view(torch.uint8).to(torch.int16)
    lo, hi = b & 0x0F, (b >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    K2, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).to(torch.int8)


def weight_values(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """The (K, N) weight values before scaling, exactly, in f32."""
    return (unpack_int4(w) if fmt == "int4" else w).float()


def dequantize_weight(w: torch.Tensor, scale: torch.Tensor, fmt: str, group: int,
                      dtype) -> torch.Tensor:
    """JAX's dequantize (hydrainfer_tpu/ops/quant.py:138): f32 values times
    their scale, cast to dtype."""
    q = weight_values(w, fmt)
    if group:
        K, N = q.shape
        return (q.reshape(-1, group, N) * scale.float()[:, None, :]).reshape(K, N).to(dtype)
    return (q * scale.float()[None, :]).to(dtype)


def _plain(fmt: str):
    def plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, group: int = 0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        if group:
            # the weight dequantized and rounded to x's dtype, then the product
            w_x = dequantize_weight(w, scale, fmt, group, x.dtype)
            return (x.float() @ w_x.float()).to(out_dtype)
        return ((x.float() @ weight_values(w, fmt)) * scale.float()[None, :]).to(out_dtype)
    plain.__name__ = f"quant_matmul_{fmt}_plain"
    plain.__doc__ = (f"The plain version of the {fmt} form, JAX's arithmetic "
                     "(hydrainfer_tpu/ops/quant.py:qmatmul): with a group, x times "
                     "the weight dequantized to x's dtype; without, x times the "
                     "weight's values, then the column scale, in f32.")
    return plain


quant_matmul_int4_plain = _plain("int4")
quant_matmul_fp8_plain = _plain("fp8")


def quant_matmul_split_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                             fmt: str, group: int = 0,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int4 / fp8 kernels' arithmetic: the weight converted (and, with a
    group, scaled and rounded to x's dtype), K cut as `plan` cuts it, the
    slices' f32 partials summed from slice 0 on, then the column scale (none
    with a group) and the cast."""
    out_dtype = out_dtype or x.dtype
    w_eff = (dequantize_weight(w, scale, fmt, group, x.dtype) if group
             else weight_values(w, fmt))
    parts = split_partials(x, w_eff)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return (acc if group else acc * scale.float()[None, :]).to(out_dtype)


def _launch_form(name: str, fn, x, w, scale, group: int, out_dtype, w_dtype, k_rows: int):
    M, K = x.shape
    if w.shape[0] * k_rows != K or w.dim() != 2:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    N = w.shape[1]
    want = (K // group, N) if group else (N,)
    if group and (K % group or not group_ok(group)):
        raise ValueError(f"group {group} does not suit K = {K} (a multiple of 64 or a "
                         "divisor of 64 that is a multiple of 16, dividing K)")
    if tuple(scale.shape) != want:
        raise ValueError(f"scale {tuple(scale.shape)}, expected {want}")
    if w.dtype != w_dtype or scale.dtype != torch.float32:
        raise TypeError(f"w must be {w_dtype} and scale float32")
    build.check_cuda(x, w, scale)
    x_code = build.dtype_code(x, (torch.float32, torch.bfloat16))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    out_code = build.dtype_code(out, (torch.float32, torch.bfloat16))
    p = plan(M, K, N)
    build.launch(name, x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N,
                 group, x_code, out_code, FORM_CODES[p.form], p.bn, p.splits)
    fn.launches += 1
    return out


def quant_matmul_int4(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, group: int = 0,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) x int4 (K/2, N) packed int8 -> (M, N) in out_dtype (x's dtype
    by default); scale (N,) without a group, (K / group, N) with one. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, w, scale, group, out_dtype)
    return _launch_form("quant_matmul_int4", quant_matmul_int4, x, w, scale, group, out_dtype,
                        torch.int8, 2)


def quant_matmul_fp8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, group: int = 0,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) x float8_e4m3fn (K, N) -> (M, N) in out_dtype (x's dtype by
    default); scale (N,) without a group, (K / group, N) with one. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_fp8_plain(x, w, scale, group, out_dtype)
    return _launch_form("quant_matmul_fp8", quant_matmul_fp8, x, w, scale, group, out_dtype,
                        torch.float8_e4m3fn, 1)


quant_matmul_int4.launches = 0
quant_matmul_fp8.launches = 0
