"""Pipeline parallelism over one node's devices (port of
hydrainfer_tpu/parallel/pipeline.py).

The JAX package shards the layer axis of its weight stacks and of the paged
KV cache over a 'pp' mesh axis, and one shard_map program relays the
activations stage to stage with lax.ppermute. The port keeps the function
with one controller a node, as its tensor parallelism does
(parallel/mesh.py):
  - `pp_split_layers` cuts the L decoder layers into P contiguous stages of
    L/P (pp_pack_weights' split, with its two refusals: L not a multiple of
    P, and layers whose weight keys differ, as in a MoE model whose first
    layers are dense);
  - `pp_stages` places them: stage s holds layers [s*L/P, (s+1)*L/P) on its
    device as the loaded layer dicts (on the weights' own device, the very
    tensors); with tp > 1 a stage is a RankGroup of tp devices and each
    rank holds its shard of the stage's layers (mesh.py:shard_layers, the
    per-rank qkv / gate_up columns of the JAX pp_tp_pack_weights); a
    quantized TP-split weight is refused there, as in the JAX package;
  - the embedding, the final norm, lm_head and the rope tables stay on
    stage 0's device, where the batch arrives. The JAX package replicates
    them on every stage; one copy computes the same function;
  - the KV cache is one tensor a stage (a rank shard a rank under TP)
    holding the stage's layers only (`cache_shards`: mesh.py:CacheShard's
    layer runs), so the kernels index its layer axis by the LOCAL layer id,
    the layer's index within its stage.

`decoder_forward_pp` is the relay: the embedding, the image splice and the
rope rows (M-RoPE included) on stage 0, then each stage's layers in turn,
x handed on with `.to`; the last layer's token discard and the head run as
in the one-device step (models/decoder.py). `decoder_forward_pp_decode` is
the microbatched decode (GPipe) of pure single-token decode batches: the S
rows split into n_micro microbatches of S / n_micro consecutive rows, each
its own attention problem (`micro_params`); at tick t stage s runs
microbatch t - s; the head then runs on all S rows on stage 0. `pp_step`
picks between them by the JAX gate (`step_form`).

No torch.distributed: one process drives every stage. The tick loop only
enqueues work on each stage's device and nothing in it waits for a device
(no .item(), no blocking copy), so stages on different cards may overlap;
on one card every `.to` is a no-op.
"""
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from ..models.decoder import (DecoderConfig, Rank, _embed, _head, _input_ids, _last_layer,
                              _rank_layer, _rope_rows, _splice_images)
from ..models.factory import FillDims, LanguageModelBatch
from ..ops.attention import PagedAttentionParams, params_to
from ..ops.quant import QuantizedTensor
from .mesh import CacheShard, RankGroup, TPLayout, _to, rank_config, shard_layers, tp_layout

# the weights TP splits inside a stage; quantized, the JAX package refuses
# them there (hydrainfer_tpu/parallel/pipeline.py:112-115)
TP_SPLIT_KEYS = ("qkv_proj", "qkv_bias", "gate_up", "o_proj", "down")


def layer_signature(lw: dict) -> tuple:
    """The keys of a layer's weights that are set."""
    return tuple(sorted(k for k, v in lw.items() if v is not None))


def pp_split_layers(layers: Sequence[dict], pp: int) -> List[List[dict]]:
    """The layers in pp contiguous stages of len(layers) / pp each."""
    L = len(layers)
    if L % pp:
        raise NotImplementedError(f"{L} layers do not split into {pp} pipeline stages")
    sig = layer_signature(layers[0])
    for i, lw in enumerate(layers):
        if layer_signature(lw) != sig:
            raise NotImplementedError(
                f"pipeline stages need a uniform layer signature: layer {i}'s weights "
                f"and layer 0's differ in {sorted(set(layer_signature(lw)) ^ set(sig))}")
    n = L // pp
    return [list(layers[s * n:(s + 1) * n]) for s in range(pp)]


@dataclass
class Stage:
    """One pipeline stage: its ranks' devices (one without TP), its first
    layer, each rank's layer dicts, and the DecoderConfig its ranks run."""
    group: RankGroup
    first: int
    ranks: List[List[dict]]
    cfg: DecoderConfig

    @property
    def device(self) -> torch.device:
        return self.group.devices[0]

    @property
    def n_layers(self) -> int:
        return len(self.ranks[0])


@dataclass
class PipelineStages:
    """A decoder's weights over pipeline stages: the stages, the head
    weights (embed, norm, lm_head) on stage 0's device, the model's
    config, the head split of TP inside the stages (None without), and the
    steps run in each form."""
    stages: List[Stage]
    head: dict
    cfg: DecoderConfig
    layout: Optional[TPLayout] = None
    steps: dict = field(default_factory=lambda: {"relay": 0, "micro": 0})

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def tp(self) -> int:
        return self.stages[0].group.size

    @property
    def device(self) -> torch.device:
        return self.stages[0].device

    @property
    def devices(self) -> tuple:
        return tuple(d for st in self.stages for d in st.group.devices)

    def cache_shards(self) -> List[CacheShard]:
        """One KV-cache shard a rank of each stage, stage by stage: the
        stage's layer run, the rank's head run (every head without TP)."""
        heads = ([self.layout.cache_heads(r) for r in range(self.tp)] if self.layout
                 else [(0, 1 if self.cfg.mla_kv_lora > 0 else 2 * self.cfg.n_kv_heads)])
        return [CacheShard(dev, first, n, st.first, st.n_layers)
                for st in self.stages for dev, (first, n) in zip(st.group.devices, heads)]

    def stage_caches(self, caches: Sequence[torch.Tensor]) -> list:
        """A cache_shards() list of tensors, by stage: the stage's tensor,
        or under TP the list of its ranks'."""
        tp = self.tp
        return [caches[s * tp] if tp == 1 else list(caches[s * tp:(s + 1) * tp])
                for s in range(self.pp)]


def pp_stages(weights: dict, cfg: DecoderConfig, devices, tp: int = 1) -> PipelineStages:
    """The decoder's weights ({"embed", "layers", "norm", "lm_head"}) over
    len(devices) / tp stages of tp ranks each, the devices taken in order.
    Without TP a stage's layers hold the caller's tensors, moved to its
    device (nothing is copied on the weights' own device)."""
    devices = [torch.device(d) for d in devices]
    if tp < 1 or len(devices) % tp:
        raise ValueError(f"{len(devices)} devices do not form stages of {tp} ranks")
    split = pp_split_layers(weights["layers"], len(devices) // tp)
    layout = None
    if tp > 1:
        for k in TP_SPLIT_KEYS:
            if any(isinstance(lw.get(k), QuantizedTensor) for lw in weights["layers"]):
                raise NotImplementedError(
                    f"tensor parallelism inside pipeline stages with a quantized {k}: "
                    "the JAX package shards only bf16 / f32 stage weights over 'tp'")
        layout = tp_layout(cfg, tp)
    stages = []
    for s, layers in enumerate(split):
        group = RankGroup(tuple(devices[s * tp:(s + 1) * tp]))
        if layout is None:
            ranks = [[{k: _to(v, group.devices[0]) for k, v in lw.items()} for lw in layers]]
            stages.append(Stage(group, s * len(layers), ranks, cfg))
        else:
            stages.append(Stage(group, s * len(layers), shard_layers(layers, cfg, group, layout),
                                rank_config(cfg, layout)))
    head = {k: _to(weights[k], devices[0]) for k in ("embed", "norm", "lm_head")}
    return PipelineStages(stages, head, cfg, layout)


def _on(device: torch.device):
    """Kernels launched inside run on `device`'s card."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _stage_ranks(stage: Stage, cache, batch: LanguageModelBatch, cos, sin) -> List[Rank]:
    """The stage's ranks, each with its cache and the batch and rope rows
    on its device."""
    caches = cache if isinstance(cache, list) else [cache]
    return [Rank(dev, c, params_to(batch, dev), cos.to(dev), sin.to(dev))
            for dev, c in zip(stage.group.devices, caches)]


def _run_stage(stage: Stage, x: torch.Tensor, ranks: List[Rank], max_q: int,
               last: bool = False) -> torch.Tensor:
    """x through the stage's layers, at their local ids; with `last`, its
    last layer discards all but the sampled rows before its MLP."""
    group = stage.group if stage.group.size > 1 else None
    n = stage.n_layers - last
    with _on(stage.device):
        x = x.to(stage.device)
        for i in range(n):
            x = _rank_layer(x, ranks, [r[i] for r in stage.ranks], i, stage.cfg, max_q, group)
        if last:
            x = _last_layer(x, ranks, [r[n] for r in stage.ranks], n, stage.cfg, max_q, group)
    return x


def decoder_forward_pp(stages: PipelineStages, caches: Sequence[torch.Tensor],
                       batch: LanguageModelBatch, cos_tab: torch.Tensor,
                       sin_tab: torch.Tensor, max_q: int, token_table: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       return_logits: bool = False):
    """One fill step of any mix of prefill and decode through the stage
    relay: the (S,) sampled tokens (and the (S, V) f32 logits if asked).
    `caches` is the cache_shards() list; the batch, the tables and the
    token table live on stage 0's device. The cache and the token table are
    updated in place."""
    cfg = stages.cfg
    x = _splice_images(_embed(stages.head, _input_ids(batch, token_table)), batch)
    cos, sin = _rope_rows(cos_tab, sin_tab, batch, cfg)
    for s, (stage, cache) in enumerate(zip(stages.stages, stages.stage_caches(caches))):
        x = _run_stage(stage, x, _stage_ranks(stage, cache, batch, cos, sin), max_q,
                       last=s == stages.pp - 1)
    return _head(stages.head, x.to(stages.device), batch, cfg, token_table, return_logits,
                 generator=generator)


def micro_params(a: PagedAttentionParams, row0: int, n_rows: int) -> PagedAttentionParams:
    """The attention problem of decode rows [row0, row0 + n_rows) (row i =
    sequence i, one query each): its live rows are those with kv_len > 0
    (packed before the padding rows), and cu_q_lens and num_seqs count them
    on the device (the JAX micro_geometry)."""
    rows = slice(row0, row0 + n_rows)
    kv = a.kv_lens[rows]
    valid = kv > 0
    n = valid.sum().to(torch.int32)
    ar = torch.arange(n_rows + 1, dtype=torch.int32, device=kv.device)
    return PagedAttentionParams(
        q_seq_ids=torch.where(valid, ar[:n_rows], -1),
        q_local_ids=torch.zeros_like(kv),
        positions=a.positions[rows],
        kv_lens=kv,
        block_tables=a.block_tables[rows],
        new_kv_slot_ids=a.new_kv_slot_ids[rows],
        cu_q_lens=torch.minimum(ar, n),
        num_seqs=n.reshape(1))


def _micro_batch(batch: LanguageModelBatch, row0: int, n_rows: int) -> LanguageModelBatch:
    """Decode rows [row0, row0 + n_rows) as a batch of their own."""
    rows = slice(row0, row0 + n_rows)
    return LanguageModelBatch(
        token_ids=batch.token_ids[rows], positions=batch.positions[rows],
        attention=micro_params(batch.attention, row0, n_rows),
        sample_token_idx=batch.sample_token_idx[rows],
        token_src_slots=batch.token_src_slots[rows],
        sample_dst_slots=batch.sample_dst_slots[rows])


def decoder_forward_pp_decode(stages: PipelineStages, caches: Sequence[torch.Tensor],
                              batch: LanguageModelBatch, cos_tab: torch.Tensor,
                              sin_tab: torch.Tensor, token_table: torch.Tensor,
                              n_micro: int, generator: Optional[torch.Generator] = None,
                              return_logits: bool = False):
    """One pure single-token decode step (row i = sequence i) in the GPipe
    schedule: n_micro microbatches of S / n_micro consecutive rows; at tick
    t stage s runs microbatch t - s, so a step takes n_micro + P - 1 stage
    ticks where the relay takes n_micro * P. The last layer keeps every row
    (as in the JAX schedule); the head then runs on the sampled rows of all
    S on stage 0. Returns as decoder_forward_pp."""
    cfg = stages.cfg
    S = batch.attention.kv_lens.shape[0]
    if S % n_micro or S < n_micro:
        raise ValueError(f"{S} decode rows do not split into {n_micro} microbatches")
    Sm = S // n_micro
    x = _embed(stages.head, _input_ids(batch, token_table)[:S])
    cos, sin = _rope_rows(cos_tab, sin_tab, batch, cfg)
    micro = [_micro_batch(batch, m * Sm, Sm) for m in range(n_micro)]
    ranks = [[_stage_ranks(stage, cache, micro[m], cos[m * Sm:(m + 1) * Sm],
                           sin[m * Sm:(m + 1) * Sm]) for m in range(n_micro)]
             for stage, cache in zip(stages.stages, stages.stage_caches(caches))]
    xs = [x[m * Sm:(m + 1) * Sm] for m in range(n_micro)]
    for t in range(n_micro + stages.pp - 1):
        for s in range(max(0, t - n_micro + 1), min(stages.pp, t + 1)):
            xs[t - s] = _run_stage(stages.stages[s], xs[t - s], ranks[s][t - s], 1)
    x = torch.cat([xm.to(stages.device) for xm in xs])
    x = x[batch.sample_token_idx.clamp(min=0).long()]
    return _head(stages.head, x, batch, cfg, token_table, return_logits, generator=generator)


def step_form(dims: FillDims, pp: int) -> str:
    """"micro" where the JAX model takes the microbatched decode (a pure
    single-token decode batch, no image features, S a multiple of the
    stage count and at least it), else "relay"."""
    micro = dims.max_q == 1 and dims.Ti == 0 and dims.S % pp == 0 and dims.S >= pp
    return "micro" if micro else "relay"


def pp_step(stages: PipelineStages, caches: Sequence[torch.Tensor],
            batch: LanguageModelBatch, cos_tab: torch.Tensor, sin_tab: torch.Tensor,
            dims: FillDims, token_table: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One fill step of a pipeline-parallel model in the form step_form
    gives its dims (the JAX model's _flat_pp_fn)."""
    if step_form(dims, stages.pp) == "micro":
        return decoder_forward_pp_decode(stages, caches, batch, cos_tab, sin_tab,
                                         token_table, stages.pp, generator)
    return decoder_forward_pp(stages, caches, batch, cos_tab, sin_tab, dims.max_q,
                              token_table, generator)
