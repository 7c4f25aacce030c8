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

bf16 activations take one of three forms, chosen by `plan(M, K, N, fmt)` from
shapes and the weight format only (no device call, no host sync, so the CPU
tests reach it and a CUDA graph can capture the launch):

- skinny (M <= 64, decode steps and the lm_head): bound by the K x N weight
  read. A block owns a 64-, 128- or 256-column strip and one K slice. Every
  format's stage carries 64 weight byte rows, so the K tile is 64 deep for
  int8 and fp8 and 128 deep for int4 (two k a byte): int4 keeps int8's bytes
  in flight with half as many K tiles, and its splits are counted in those
  tiles;
- tma (M > 64, int4 and fp8, K a multiple of 8 and N of 16, 16-byte aligned
  operands): bound by tensor-core operations. Warp-specialized, TMA-fed wgmma
  on output tiles of 256 x rows (128 where M <= 128) by 128 columns, one
  block an SM, split in 2 or 3 where the tiles alone leave SMs idle;
- wide (M > 64 otherwise: every int8 shape, and the int4 / fp8 shapes TMA
  cannot address): cp.async-fed wgmma on tiles of 128 x rows by 128 columns.

Any form may cut K into `splits` slices (at most 8: one portable
thread-block cluster) when the output tiles alone give too few blocks; the
cluster sums the slices' partials in a fixed order in the same launch.
`quant_matmul_int8_split_plain` and `quant_matmul_split_plain` are that
arithmetic in PyTorch.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8         # the portable thread-block cluster size
SKINNY_MAX_M = 64      # the skinny form's rows: eight n8 tiles of mma.sync
STAGES = 4             # cp.async ring depth (csrc/quant_matmul.cuh:STAGES)
BK = 64                # the K tile of every form but int4's skinny one
INT4_SKINNY_BK = 128   # int4's skinny K tile: 64 packed byte rows, int8's bytes
WIDE_ROWS = 128        # the wide form's x rows a block (the tma form's at M <= 128)
TMA_ROWS = 256         # the tma form's x rows a block above M 128
TMA_COLS = 128         # the tma form's weight columns a block
# the tma form's split counts, each with the blocks its clusters keep resident
# at once (one block an SM; clusters of 3 leave SMs of some GPCs idle):
# larger clusters timed slower at every llava-7b-lm projection on an H100
TMA_RESIDENT = {1: SMS, 2: SMS, 3: 126}
MIN_SLICE_TILES = 4    # 64-deep K tiles a split keeps at least (K 256)
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may have
FORM_CODES = {"skinny": 0, "wide": 1, "tma": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """A launch of K4: the form, the output columns of a block (bn), the K
    slices of one output tile (splits: the blocks of one thread-block
    cluster) and the K tile (bk) those slices are counted in."""
    form: str
    bn: int
    splits: int
    bk: int = BK

    def blocks(self, M: int, N: int) -> int:
        return self.splits * _cdiv(N, self.bn) * _cdiv(M, self.rows(M))

    def rows(self, M: int) -> int:
        """x rows of a block: the skinny form's M padded to 8, 16, 32 or 64
        (all of M); the tma form's 256, or 128 where M <= 128; the wide
        form's 128."""
        if self.form == "skinny":
            return 8 * (1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8)
        return TMA_ROWS if self.form == "tma" and M > WIDE_ROWS else WIDE_ROWS

    def smem_bytes(self, M: int, fmt: str = "int8", grouped: bool = False) -> int:
        """Dynamic shared memory of a block. skinny and wide: the ring of
        weight tiles (bk rows of bytes, bk / 2 packed ones for int4, padded
        by 16 bytes), bf16 x tiles (the skinny form's rows padded by 8
        values; the wide form's 1024-byte aligned: its stages rounded up to
        1024 bytes, plus 1024 bytes to align them) and, with group scales,
        bk / 16 f32 rows of the strip's scales. tma: 5 stages (6 at 128 x
        rows) of the x tile, 128 weight columns and, with groups, 4 scale
        rows, or the merge tile where that is larger, its 2 barriers a stage
        and 1024 bytes to align. The merge tile reuses the ring. The card
        tests hold this to the hydra_quant_matmul*_smem of
        csrc/quant_matmul*.cu."""
        w_rows = self.bk // 2 if fmt == "int4" else self.bk
        if self.form == "tma":
            rows = self.rows(M)
            stages = 5 if rows == TMA_ROWS else 6
            stage = rows * self.bk * 2 + w_rows * self.bn + (4 * self.bn * 4 if grouped else 0)
            return max(stages * stage, rows * (self.bn + 4) * 4) + 2 * stages * 8 + 1024
        w_bytes = w_rows * (self.bn + 16)
        s_bytes = (self.bk // 16) * self.bn * 4 if grouped else 0
        if self.form == "skinny":
            return STAGES * (w_bytes + self.rows(M) * (self.bk + 8) * 2 + s_bytes)
        return STAGES * 1024 * _cdiv(WIDE_ROWS * self.bk * 2 + w_bytes + s_bytes, 1024) + 1024


def tma_ok(K: int, N: int) -> bool:
    """The tma form's shapes: x rows (K bf16) and weight and scale rows (N
    bytes, N floats) 16-byte strides, as TMA needs
    (csrc/quant_matmul.cuh:tma_ok, which also checks the addresses)."""
    return K % 8 == 0 and N % 16 == 0


def _wide_plan(M: int, N: int, k_tiles: int) -> Plan:
    """128-row by 128-column tiles, split to about 1.5 blocks an SM (at
    least 2 slices) below four waves."""
    tiles = _cdiv(N, 128) * _cdiv(M, WIDE_ROWS)
    want = 1 if tiles >= 4 * SMS else max(2, round(1.5 * SMS / tiles))
    return Plan("wide", 128, max(1, min(MAX_SPLITS, want, k_tiles // MIN_SLICE_TILES)))


def _tma_plan(M: int, K: int, N: int) -> Plan:
    """256-row (128 where M <= 128) by 128-column tiles, one block an SM:
    the split count s of TMA_RESIDENT (every slice at least MIN_SLICE_TILES
    K tiles) that finishes soonest, ceil(tiles s / resident blocks) waves of
    1 / s of a tile's K each; the fewest splits among those within 2% of the
    best (a split adds a merge)."""
    tiles = _cdiv(N, TMA_COLS) * _cdiv(M, TMA_ROWS if M > WIDE_ROWS else WIDE_ROWS)
    most = max(1, _cdiv(K, BK) // MIN_SLICE_TILES)
    cost = {s: _cdiv(tiles * s, r) / s for s, r in TMA_RESIDENT.items() if s <= most}
    best = min(cost.values())
    return Plan("tma", TMA_COLS, min(s for s, c in cost.items() if c <= 1.02 * best))


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int, fmt: str = "int8") -> Plan:
    """K4's launch for bf16 x, from shapes and the weight format only. The
    skinny rules keep the fastest of the candidate plans timed on an H100 at
    the serving paths' decode shapes (int8).

    skinny (M <= 64): the widest outputs (lm_heads) take 2 slices, of
    128-column strips where those alone are four waves of the card, else of
    256-column strips; the others 128-column strips where those alone reach
    the SM count, else 64, split to two blocks an SM. int4 counts its K in
    128-deep tiles (INT4_SKINNY_BK): a tile carries int8's bytes, so the same
    strips and block counts keep int8's bytes in flight. M > 64: int4 and
    fp8 take the tma form where TMA can address the rows (`tma_ok`), every
    other shape the wide form. Every slice keeps at least MIN_SLICE_TILES
    64-deep K tiles' depth (two of int4's 128-deep ones)."""
    if M <= SKINNY_MAX_M:
        bk = INT4_SKINNY_BK if fmt == "int4" else BK
        k_tiles = _cdiv(K, bk) * bk // BK
        strips = _cdiv(N, 128)
        if strips >= 4 * SMS:
            bn, want = 128, 2
        elif 2 * strips >= 3 * SMS:
            bn, want = 256, 2
        else:
            bn = 128 if strips >= SMS else 64
            tiles = _cdiv(N, bn)
            want = 1 if tiles >= 2 * SMS else _cdiv(2 * SMS, tiles)
        return Plan("skinny", bn, max(1, min(MAX_SPLITS, want, k_tiles // MIN_SLICE_TILES)), bk)
    if fmt != "int8" and tma_ok(K, N):
        return _tma_plan(M, K, N)
    return _wide_plan(M, N, _cdiv(K, BK))


def split_tiles(tiles: int, splits: int, i: int) -> Tuple[int, int]:
    """K tiles [lo, hi) of split i: ceil(tiles / splits) each, empty past
    the end, as csrc/quant_matmul.cuh:split_tiles cuts them."""
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


def split_partials(x: torch.Tensor, w_q: torch.Tensor, fmt: str = "int8") -> torch.Tensor:
    """(splits, M, N) f32: each K slice's partial product, as `plan` cuts K
    for the format (in its K tiles). w_q: the (K, N) weight values the
    kernel multiplies (int8 values, or an unpacked or dequantized weight)."""
    (M, K), N = x.shape, w_q.shape[1]
    p = plan(M, K, N, fmt)
    parts = torch.zeros((p.splits, M, N), dtype=torch.float32, device=x.device)
    for i in range(p.splits):
        lo, hi = split_tiles(_cdiv(K, p.bk), p.splits, i)
        k0, k1 = lo * p.bk, min(K, hi * p.bk)
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
    group, scaled and rounded to x's dtype), K cut as `plan` cuts it for the
    format, the
    slices' f32 partials summed from slice 0 on, then the column scale (none
    with a group) and the cast."""
    out_dtype = out_dtype or x.dtype
    w_eff = (dequantize_weight(w, scale, fmt, group, x.dtype) if group
             else weight_values(w, fmt))
    parts = split_partials(x, w_eff, fmt)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return (acc if group else acc * scale.float()[None, :]).to(out_dtype)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def form_plan(M: int, K: int, N: int, fmt: str, x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor) -> Plan:
    """`plan` for the format, with the tma form's addresses checked: an
    operand that is not 16-byte aligned (a view into another tensor) takes
    the wide form, as the shapes TMA cannot address do. Reads no data."""
    p = plan(M, K, N, fmt)
    if p.form == "tma" and not _aligned(x, w, scale):
        return _wide_plan(M, N, _cdiv(K, BK))
    return p


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
    p = form_plan(M, K, N, "int4" if k_rows == 2 else "fp8", x, w, scale)
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
