"""Tensor and expert parallelism over one node's devices (port of
hydrainfer_tpu/parallel/mesh.py).

The JAX node drives a mesh of its devices from one process, and XLA's SPMD
partitioner inserts the collectives. The port keeps that shape: one node
object owns a list of torch devices, one a rank, each rank holds its own
weight shard and its own KV-cache shard on its device, and the decoder
(models/decoder.py) loops over the ranks in Python, Megatron-style:
  - qkv_proj and gate_up are column-parallel. A rank's columns are
    [q_r | k_r | v_r] and [gate_r | up_r]: a contiguous split of the fused
    [q | k | v] would hand rank 0 all of q and half of k (GSPMD splits the
    logical concat; the JAX package's manual form is
    parallel/pipeline.py:_tp_permute_cols);
  - attention runs on the rank's heads over the rank's cache shard;
  - o_proj and down are row-parallel, and the ranks' partial outputs are
    summed (`RankGroup.all_reduce`);
  - embed splits its vocabulary rows: each rank looks up the ids of its
    range, writes zeros elsewhere, and the ranks are summed, which is exact.
    lm_head splits its vocabulary columns, and the logits are gathered on
    rank 0, where the argmax (first index on ties) and the sampling see
    full rows;
  - MoE experts split by expert (ops/moe.py:moe_ffn_ep), the router
    replicates, and shared experts are column- and row-parallel like a
    dense MLP;
  - MLA shards its q heads, w_uk, w_uv, q_b / q_proj and o_proj; kv_a, q_a
    and the norms replicate, and so does the single-plane latent cache:
    every rank holds, and writes, a full copy.
Sums run in a fixed rank order: each partial is copied to rank 0's device
with `.to` and added there, and each rank reads the sum with `.to` of its
own device. Where ranks share a device the copies do nothing, so one card,
the CPU and a many-card box run the same code.

A node's KV cache is one tensor a CacheShard: a rank's run of the head axis
of every layer here, a pipeline stage's run of the layer axis
(parallel/pipeline.py), or both for a rank inside a stage.
`shard_kv_cache` and `merge_kv_shards` move a cache or a migration's block
payload between that list and the single-device layout.

Weights are sharded after quantization. A column split takes the columns'
scales with it; a row split keeps per-column scales whole and splits a
group scale (K/g, N) with its rows, so K/tp must stay a multiple of the
group. Every rank's product is then the single-device quantized weight's.

Where the tp size divides the q heads but not the KV heads (and the KV heads
divide the tp size), each rank holds a copy of the one KV head its q heads
read: the replicated-K/V form, which gives the function of the JAX package's
partitioned-oracle fallback (hydrainfer_tpu/ops/attention.py:379-384). Any
other split that is not even is refused at load, naming the shape: q heads,
vocabulary, MLP widths, experts, int4 groups.
"""
from dataclasses import dataclass, replace
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.quant import QuantizedTensor

# The axis each decoder-layer weight splits over the ranks ("tp"), as the
# JAX package's PartitionSpecs (None = replicated). qkv_proj, qkv_bias and
# gate_up are permuted per rank before their split (see the module text).
DECODER_WEIGHT_RULES = {
    "qkv_proj": (None, "tp"),
    "qkv_bias": ("tp",),
    "o_proj": ("tp", None),
    "gate_up": (None, "tp"),
    "down": ("tp", None),
    "input_norm": (None,),
    "post_norm": (None,),
    "moe_router": (None, None),
    "moe_router_bias": (None,),
    "moe_gate_up": ("tp", None, None),
    "moe_down": ("tp", None, None),
    "q_a": (None, None),
    "q_a_norm": (None,),
    "q_b": (None, "tp"),
    "q_proj": (None, "tp"),
    "kv_a": (None, None),
    "kv_a_norm": (None,),
    "w_uk": (None, "tp", None),
    "w_uv": (None, "tp", None),
}
# the top-level weights: vocabulary-parallel embed and lm_head
HEAD_WEIGHT_RULES = {"embed": ("tp", None), "norm": (None,), "lm_head": (None, "tp")}


@dataclass(frozen=True)
class RankGroup:
    """The devices of a node's ranks, rank 0 first (ranks may share one)."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' partials summed in rank order on rank 0's device; a
        rank reads the sum back with `.to` of its own device."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(out.device)
        return out

    def gather(self, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """The ranks' slices concatenated in rank order on rank 0's device."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)


@dataclass(frozen=True)
class TPLayout:
    """The heads of each of `tp` ranks: q heads in contiguous runs of
    `q_heads`; K/V heads from kv_first[rank], `kv_heads` of them (in KV
    heads), or the one latent plane on every rank (`single_plane`)."""
    tp: int
    q_heads: int
    kv_first: Tuple[int, ...]
    kv_heads: int
    single_plane: bool

    def cache_heads(self, rank: int) -> Tuple[int, int]:
        """(first, count) of the rank's shard along the cache's head axis
        (combined K/V heads, K even and V odd: whole pairs)."""
        if self.single_plane:
            return 0, 1
        return 2 * self.kv_first[rank], 2 * self.kv_heads


def tp_layout(cfg, tp: int) -> TPLayout:
    """The head split of a DecoderConfig over tp ranks; refuses what does
    not split evenly."""
    hq, hkv = cfg.n_qo_heads, cfg.n_kv_heads
    if hq % tp:
        raise NotImplementedError(f"tp_size {tp} does not divide the {hq} q heads")
    q = hq // tp
    if cfg.mla_kv_lora > 0:
        return TPLayout(tp, q, (0,) * tp, 1, True)
    if hkv % tp == 0:
        n = hkv // tp
        return TPLayout(tp, q, tuple(r * n for r in range(tp)), n, False)
    if tp % hkv == 0:
        # each rank's q heads read one KV head, which the ranks of its group
        # each hold a copy of
        return TPLayout(tp, q, tuple(r * q // (hq // hkv) for r in range(tp)), 1, False)
    raise NotImplementedError(f"tp_size {tp} splits neither the {hkv} KV heads nor "
                              f"into them")


def rank_config(cfg, layout: TPLayout):
    """The DecoderConfig one rank runs: its own head counts."""
    return replace(cfg, n_qo_heads=layout.q_heads,
                   n_kv_heads=1 if layout.single_plane else layout.kv_heads)


class CacheShard(NamedTuple):
    """One tensor of a node's KV cache: its device, its run of the combined
    head axis (first, count) and its run of the layer axis (layer0, layers;
    None = every layer). A tensor-parallel rank holds a head run of every
    layer, a pipeline stage every head of a layer run
    (parallel/pipeline.py), a rank of a stage both. A (device, first, count)
    tuple is a shard of every layer."""
    device: torch.device
    first: int
    count: int
    layer0: int = 0
    layers: Optional[int] = None


@dataclass
class ShardedWeights:
    """A decoder's weights over a RankGroup: one weight dict a rank (the
    single-device dict's keys), their head layout and the rank config."""
    ranks: List[dict]
    group: RankGroup
    layout: TPLayout
    cfg: object

    def cache_shards(self) -> List[CacheShard]:
        """Each rank's KV-cache shard: its head run of every layer."""
        return [CacheShard(dev, *self.layout.cache_heads(r))
                for r, dev in enumerate(self.group.devices)]


def _per_rank(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise NotImplementedError(f"tp_size {tp} does not divide {what} ({n})")
    return n // tp


def _out_dim(w) -> int:
    return (w.q if isinstance(w, QuantizedTensor) else w).shape[-1]


def _in_dim(w) -> int:
    if isinstance(w, QuantizedTensor):
        return w.q.shape[0] * (2 if w.bits == 4 else 1)
    return w.shape[0]


def _cols(w, idx: torch.Tensor):
    """The output columns `idx` of a weight (or a bias); a QuantizedTensor's
    scales (per column, or per (group, column)) go with them."""
    if isinstance(w, QuantizedTensor):
        idx = idx.to(w.q.device)
        return replace(w, q=w.q.index_select(-1, idx), scale=w.scale.index_select(-1, idx))
    return w.index_select(-1, idx.to(w.device))


def _rows(w, lo: int, hi: int, name: str):
    """Input rows lo:hi of a weight: a view. A QuantizedTensor keeps its
    per-column scales whole and takes its group scales' rows; int4's packed
    rows hold two inputs a byte."""
    if not isinstance(w, QuantizedTensor):
        return w[lo:hi]
    g = w.group
    if (g and (lo % g or hi % g)) or (w.bits == 4 and lo % 2):
        raise NotImplementedError(
            f"{name}: a quantized weight of input dim {_in_dim(w)} (stored "
            f"{tuple(w.q.shape)}, scale group {g}) cannot give rows {lo}:{hi} to a "
            f"rank: {hi - lo} rows a rank is not a multiple of the group")
    pack = 2 if w.bits == 4 else 1
    return replace(w, q=w.q[lo // pack:hi // pack],
                   scale=w.scale[lo // g:hi // g] if g else w.scale)


def _span(r: int, n: int) -> torch.Tensor:
    return torch.arange(r * n, (r + 1) * n)


def _qkv_columns(cfg, layout: TPLayout, r: int) -> torch.Tensor:
    """Rank r's columns of the fused [q | k | v]: [q_r | k_r | v_r]."""
    d, hq, hkv = cfg.head_dim, cfg.n_qo_heads, cfg.n_kv_heads
    kv = torch.arange(layout.kv_first[r] * d, (layout.kv_first[r] + layout.kv_heads) * d)
    return torch.cat([_span(r, layout.q_heads * d), hq * d + kv, (hq + hkv) * d + kv])


def _shard(name: str, w, rule, r: int, cfg, layout: TPLayout):
    """Rank r's part of one weight under its rule."""
    if w is None or "tp" not in rule:
        return w
    tp = layout.tp
    if name in ("qkv_proj", "qkv_bias"):
        return _cols(w, _qkv_columns(cfg, layout, r))
    if name == "gate_up":
        half = _out_dim(w) // 2
        n = _per_rank(half, tp, f"the MLP width of {name}")
        return _cols(w, torch.cat([_span(r, n), half + _span(r, n)]))
    axis = rule.index("tp") - len(rule)
    if isinstance(w, QuantizedTensor) or w.dim() == 2 or axis == -1:
        if axis == -1:
            n = _per_rank(_out_dim(w), tp, f"the output dim of {name}")
            return _cols(w, _span(r, n))
        n = _per_rank(_in_dim(w), tp, f"the input dim of {name}")
        return _rows(w, r * n, (r + 1) * n, name)
    n = _per_rank(w.shape[axis], tp, f"axis {axis} of {name} {tuple(w.shape)}")
    out = w.narrow(axis, r * n, n)
    # an expert slice (the leading axis) is a contiguous view; a head slice
    # of w_uk / w_uv is copied into its own storage
    return out if axis == -w.dim() else out.contiguous()


def _to(w, device: torch.device):
    if isinstance(w, QuantizedTensor):
        return replace(w, q=w.q.to(device), scale=w.scale.to(device))
    return None if w is None else w.to(device)


def shard_layers(layers: Sequence[dict], cfg, group: RankGroup,
                 layout: TPLayout) -> List[List[dict]]:
    """Rank r's dicts of decoder layers under DECODER_WEIGHT_RULES, each on
    its rank's device, one list a rank."""
    return [[{k: _to(_shard(k, v, DECODER_WEIGHT_RULES[k], r, cfg, layout), dev)
              for k, v in lw.items()} for lw in layers]
            for r, dev in enumerate(group.devices)]


def shard_decoder_weights(weights: dict, cfg, group: RankGroup) -> ShardedWeights:
    """One weight dict a rank from the single-device decoder dict
    ({"embed", "layers", "norm", "lm_head"}, quantized or not) under
    DECODER_WEIGHT_RULES and HEAD_WEIGHT_RULES, each on its rank's device.
    Row and expert slices are views of the caller's tensors, so sharding on
    the weights' own device adds only the permuted column copies."""
    layout = tp_layout(cfg, group.size)
    _per_rank(weights["embed"].shape[0], group.size, "the vocabulary")
    ranks = []
    for r, (dev, layers) in enumerate(zip(group.devices, shard_layers(
            weights["layers"], cfg, group, layout))):
        rank = {k: _to(_shard(k, weights[k], rule, r, cfg, layout), dev)
                for k, rule in HEAD_WEIGHT_RULES.items()}
        rank["layers"] = layers
        ranks.append(rank)
    return ShardedWeights(ranks, group, layout, rank_config(cfg, layout))


def shard_kv_cache(cache: torch.Tensor, shards, layer_dim: int = 0) -> List[torch.Tensor]:
    """A single-device cache (layers, ..., heads, head_dim), or a
    migration's block payload in that layout (layer_dim 1), as copies of
    each shard's head run of its layer run on its device (a latent plane:
    every rank a whole copy)."""
    out = []
    for dev, first, n, layer0, layers in map(lambda s: CacheShard(*s), shards):
        part = cache.narrow(-2, first, n)
        if layers is not None:
            part = part.narrow(layer_dim, layer0, layers)
        out.append(torch.empty(part.shape, dtype=part.dtype, device=dev).copy_(part))
    return out


def merge_kv_shards(parts: Sequence[torch.Tensor], shards, dim: int = -2,
                    layer_dim: int = 0) -> torch.Tensor:
    """The inverse of shard_kv_cache, on the first shard's device: each
    head from the first shard of its layer run that holds it (along `dim`),
    the layer runs in order along `layer_dim`."""
    dev = parts[0].device
    runs = {}
    for part, shard in zip(parts, map(lambda s: CacheShard(*s), shards)):
        runs.setdefault(shard.layer0, []).append((part, shard))
    out = []
    for layer0 in sorted(runs):
        heads, covered = [], 0
        for part, (_, first, n, _, _) in runs[layer0]:
            if first + n > covered:
                heads.append(part.narrow(dim, covered - first, first + n - covered).to(dev))
                covered = first + n
        out.append(heads[0] if len(heads) == 1 else torch.cat(heads, dim=dim))
    return out[0] if len(out) == 1 else torch.cat(out, dim=layer_dim)
