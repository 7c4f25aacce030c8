"""Split-KV (flash-decoding) for the decode kernels K1 and K6.

A decode block of K1 (one sequence x one kv head) or of K6's decode form (one
sequence's query token) has only its own kv range to walk, so a window of a
few sequences leaves most of the card's SMs idle. Cutting each kv range into
`n_splits` contiguous pieces multiplies the blocks; each piece leaves a
partial softmax state and a second launch merges them
(csrc/common.cuh:split_merge_kernel).

`num_splits` picks the count from shapes only, never from kv_lens: the fused
decode window runs with no host sync. `split_range` and `merge_partials` are
the plain versions of the device arithmetic (csrc/common.cuh:split_range and
split_merge_kernel), which the CPU tests hold to the plain attention.
"""
import torch

SMS = 132          # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 16    # more pieces only add partial-state traffic
MIN_CHUNK = 16     # kv rows: no more pieces than max_kv // MIN_CHUNK


def num_splits(blocks: int, max_kv: int) -> int:
    """Pieces of each decode row's kv range, from shapes only: 1 where the
    grid without splits (`blocks`) already fills the card, else enough for
    SMS blocks, at most MAX_SPLITS and max_kv // MIN_CHUNK (max_kv = the
    block table's MB x BS)."""
    if blocks >= SMS:
        return 1
    return max(1, min(MAX_SPLITS, -(-SMS // blocks), max_kv // MIN_CHUNK))


def partials(n_splits: int, T: int, H: int, D: int, device):
    """The f32 scratch a split decode launch leaves its partial states in:
    acc (n_splits, T, H, D) and (m, l) (n_splits, T, H, 2); none for one
    split."""
    if n_splits == 1:
        return None, None
    return (torch.empty((n_splits, T, H, D), dtype=torch.float32, device=device),
            torch.empty((n_splits, T, H, 2), dtype=torch.float32, device=device))


def split_range(kv_len: int, n_splits: int, i: int):
    """Piece i of [0, kv_len): ceil(kv_len / n_splits) rows, empty past the
    end, as csrc/common.cuh:split_range cuts it."""
    chunk = -(-kv_len // n_splits)
    lo = min(kv_len, i * chunk)
    return lo, min(kv_len, lo + chunk)


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   v_scale: float = 1.0) -> torch.Tensor:
    """The merge rule of csrc/common.cuh:split_merge_kernel. acc (n, R, D),
    m and l (n, R): per piece, the running max of the scores in log2 units,
    the sum of 2^(s - m) and the sum of 2^(s - m) v. A piece with m = -inf
    saw no row and its acc is never read; a row with no rows at all comes out
    as zeros. -> (R, D) f32."""
    M = m.amax(dim=0)
    seen = m != float("-inf")
    w = torch.where(seen, torch.exp2(m - torch.where(seen, M, 0.0)), 0.0)
    den = (l * w).sum(dim=0)
    num = torch.where(seen[..., None], acc * w[..., None], 0.0).sum(dim=0)
    inv = torch.where(den > 0, v_scale / torch.where(den > 0, den, 1.0), 0.0)
    return num * inv[:, None]
