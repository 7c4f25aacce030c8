"""Shared paged-attention decoder for Llama-family language models (port of
hydrainfer_tpu/models/decoder.py: standard attention or DeepSeek's
multi-head latent attention, a dense or a mixture-of-experts MLP).

One step runs embed -> the image splice (vision features overwrite the
embeddings at <image> positions) -> a Python loop over the decoder layers ->
the last layer with the token discard (only each sequence's sampled row goes through
the final MLP, norm and lm_head) -> the token (greedy argmax, or where a
sequence's temperature is above 0 a draw from its temperature/top-k/top-p
filtered distribution, ops/sampling.py) -> scatter into the device token
table. The KV cache and the token table are updated IN PLACE. Draws come from
the caller's torch.Generator (the executor's), so each step, and each step of
a fused window, draws fresh numbers.

A speculative-verify step (`spec` = K1 = 1 + K_draft > 0) is S segments of
K1 rows: the last layer skips the token discard, and `_spec_verify_head`
takes every row's logits, accepts drafts on the device
(ops/sampling.py:spec_verify_tokens) and writes each sequence's final token
into the token table. Rejected rows' KV lies past the accepted kv length and
is overwritten later: there is no rollback.

`decoder_forward_multi` runs a fused window of K decode steps as a loop of
device work with no host synchronisation inside: each step's geometry is
computed on the device from step 0's and every step reads its input token
from the token table, where the previous step wrote it.

Under M-RoPE (Qwen2-VL) the rope tables are gathered from three position
streams (batch.positions and batch.positions_hw), and rope positions are
compressed relative to cache positions after an image: the write slots and
the attention masks therefore come from cache positions (kv_len - q_len +
local id), never from `positions`.

Tensor (and expert) parallelism: with ShardedWeights (parallel/mesh.py) in
place of the weight dict and one KV-cache shard a rank in place of the
cache, the same layer body runs on every rank in turn: each rank's q and
K/V write (`_attention_q`), the paged attention on every rank's heads
(ops/attention.py:paged_attention_tp), each rank's o_proj partial
(`_attention_out`); then each rank's MLP partial, the routed experts by
ops/moe.py:moe_ffn_ep. The ranks' partials are summed in rank order on rank
0's device and added to the residual there (`_rank_layer`), and every rank
reads the residual back. The embedding
is vocabulary-parallel (`_embed`) and the lm_head's logits are gathered on
rank 0 (`_head_logits`), where the token choice, the speculative acceptance
and the token-table write run as on one device. A single-device step is one
rank with no sum.

Weights: {"embed": (V, H), "layers": [per-layer dict], "norm": (H,),
"lm_head": (H, V) tensor or QuantizedTensor}; each layer holds qkv_proj,
o_proj, gate_up, down (tensors or QuantizedTensors), input_norm, post_norm
and optionally qkv_bias. An MLA layer (cfg.mla_kv_lora > 0) holds q_proj
(or the q-LoRA stack q_a, q_a_norm, q_b), kv_a, kv_a_norm, w_uk (r, H, dn)
and w_uv (r, H, dv) in place of qkv_proj; its KV cache is the single-plane
latent cache (L, 1, NB, BS, 1, r + dr), one [c_kv | k_pe] vector per token.
Its rope weights are stored pair-interleaved unless cfg.mla_rope_interleave
is off, and its softmax scale is cfg.mla_softmax_scale (0: 1/sqrt(nope +
rope)). A MoE layer (cfg.moe_top_k > 0 and a moe_router in the layer)
holds moe_router (H, E), moe_router_bias (E,) under group-limited routing,
the stacked experts moe_gate_up (E, H, 2I) and moe_down (E, I, H), and its
shared experts, if any, as gate_up and down (ops/moe.py); the other layers
of such a model are dense.
"""
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import moe
from ..ops.activation import silu_and_mul
from ..ops.attention import paged_attention_tp, params_to
from ..ops.cache_ops import write_kv_cache, write_latent_cache
from ..ops.norm import rms_norm
from ..ops.quant import qmatmul, qmatmul_f32
from ..ops.rope import apply_rotary_emb, mrope_gather
from ..ops.sampling import process_logits, spec_verify_tokens
from ..parallel.mesh import ShardedWeights
from .factory import LanguageModelBatch


@dataclass(frozen=True)
class DecoderConfig:
    n_layers: int
    hidden_size: int
    intermediate_size: int
    n_qo_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    max_position_embeddings: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    qkv_bias: bool = False
    rope_interleaved: bool = False
    tie_word_embeddings: bool = False
    # multimodal RoPE (Qwen2-VL): per-axis frequency sections (t, h, w)
    # summing to head_dim / 2; () = standard 1D rope (ops/rope.py:mrope_gather)
    mrope_section: tuple = ()
    # int8 KV cache: K/V quantized with this static scale on write and
    # dequantized inside the attention kernels; None = cache in model dtype
    kv_scale: Optional[float] = None
    # Multi-head Latent Attention (DeepSeek V2/V3; 0 = off): the cache holds
    # one [c_kv (mla_kv_lora) | rotated k_pe (mla_rope_dim)] vector per token,
    # so head_dim = mla_kv_lora + mla_rope_dim and n_kv_heads = 1
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    mla_nope_dim: int = 0
    mla_v_dim: int = 0
    # HF rope_interleave: the MLA rope weights are stored pair-interleaved
    mla_rope_interleave: bool = True
    # 0 = 1/sqrt(nope + rope); YaRN checkpoints bake mscale^2 in here
    mla_softmax_scale: float = 0.0
    # width of the rope tables when it differs from head_dim (MLA ropes only
    # mla_rope_dim of each head); 0 = head_dim
    rope_head_dim: int = 0
    # YaRN rope scaling: (factor, original_max_pos, beta_fast, beta_slow,
    # attention_factor, truncate); () = plain rope. attention_factor scales
    # cos/sin (HF modeling_rope_utils._compute_yarn_parameters)
    yarn: tuple = ()
    # sparse MoE MLP (0 = dense): such layers carry moe_router, moe_gate_up
    # and moe_down (ops/moe.py)
    moe_top_k: int = 0
    n_experts: int = 0
    moe_scoring: str = "softmax"       # softmax | sigmoid
    moe_norm_topk: bool = True
    moe_routed_scaling: float = 1.0
    # group-limited routing: experts in moe_n_groups groups, the best
    # moe_topk_groups kept, then top-k inside; 0 = plain top-k routing.
    # "noaux_tc" (V3: sigmoid + correction bias, groups by top-2 sum) or
    # "group_limited_greedy" (V2: softmax, no bias, groups by max)
    moe_n_groups: int = 0
    moe_topk_groups: int = 0
    moe_group_method: str = "noaux_tc"


def init_rope_tables(cfg: DecoderConfig, device=None):
    """(max_position, rope_dim // 2) f32 cos and sin tables. Under YaRN the
    inverse frequencies blend the interpolated and the extrapolated ones
    with a linear ramp over the correction range (in f64, as JAX), and
    cos/sin carry the attention factor."""
    d = cfg.rope_head_dim or cfg.head_dim
    base, att = cfg.rope_theta, 1.0
    if cfg.yarn:
        factor, orig_max, bfast, bslow, att, trunc = cfg.yarn
        pos_freqs = base ** (np.arange(0, d, 2, dtype=np.float64) / d)

        def corr_dim(rot):
            return (d * math.log(orig_max / (rot * 2 * math.pi))) / (2 * math.log(base))

        low, high = corr_dim(bfast), corr_dim(bslow)
        if trunc:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, d - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low) / (high - low), 0, 1)
        ex_f = 1.0 - ramp
        inv = torch.from_numpy(
            (1.0 / (factor * pos_freqs) * (1 - ex_f) + 1.0 / pos_freqs * ex_f)
            .astype(np.float32))
    else:
        inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    t = torch.arange(cfg.max_position_embeddings, dtype=torch.float32)
    freqs = torch.outer(t, inv)
    return (torch.cos(freqs) * att).to(device), (torch.sin(freqs) * att).to(device)


def _attention_q(x, cache, layer_id, lw, batch: LanguageModelBatch, cos, sin,
                 cfg: DecoderConfig) -> torch.Tensor:
    """Pre-norm attention of one layer up to the paged attention: writes this
    step's K/V into the cache (kernel K3) and returns q, (T, H, D). Under TP,
    one rank's: its heads, into its cache shard."""
    if cfg.mla_kv_lora > 0:
        return _mla_q(x, cache, layer_id, lw, batch, cos, sin, cfg)
    T = x.shape[0]
    Hq, Hkv, D = cfg.n_qo_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lw["input_norm"], cfg.rms_norm_eps)
    qkv = qmatmul(h, lw["qkv_proj"])
    if "qkv_bias" in lw:
        qkv = qkv + lw["qkv_bias"]
    q, k, v = torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1)
    q = apply_rotary_emb(q.reshape(T, Hq, D), cos, sin, cfg.rope_interleaved)
    k = apply_rotary_emb(k.reshape(T, Hkv, D), cos, sin, cfg.rope_interleaved)
    # in place: the cache tensor itself receives this step's K/V (kernel K3)
    write_kv_cache(cache, layer_id, batch.attention.new_kv_slot_ids, k,
                   v.reshape(T, Hkv, D), cfg.kv_scale)
    return q


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[x0, x1, x2, x3, ...] -> [x0, x2, ..., x1, x3, ...]: pair-interleaved
    rope weights reordered for the rotate-half rope."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _mla_q(x, cache, layer_id, lw, batch: LanguageModelBatch, cos, sin,
           cfg: DecoderConfig) -> torch.Tensor:
    """The attention half of hydrainfer_tpu/models/decoder.py:_mla_layer up
    to the paged attention, in the absorbed form: q_nope is projected into
    the latent space with W_UK, and scores are taken against the cached
    [c_kv | k_pe] vectors directly (one plane serving as K and V, kernel
    K6). q comes from q_proj or from the q-LoRA stack (q_a -> q_a_norm ->
    q_b). The JAX layer pads q and the cached vector to a 128-lane cache
    width; the port's cache is exactly kv_lora + rope wide, so nothing is
    padded. Writes the step's latent vectors and returns the (T, H, r + dr)
    latent query (under TP: the rank's heads, over its own copy of the
    latent cache)."""
    T = x.shape[0]
    H = cfg.n_qo_heads
    r, dr = cfg.mla_kv_lora, cfg.mla_rope_dim
    dn = cfg.mla_nope_dim
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lw["input_norm"], eps)
    if "q_a" in lw:
        q = qmatmul(rms_norm(qmatmul(h, lw["q_a"]), lw["q_a_norm"], eps), lw["q_b"])
    else:
        q = qmatmul(h, lw["q_proj"])
    q = q.reshape(T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = qmatmul(h, lw["kv_a"])                              # (T, r + dr)
    c_kv = rms_norm(ckv[:, :r], lw["kv_a_norm"], eps)
    k_pe = ckv[:, None, r:]                                   # (T, 1, dr)
    if cfg.mla_rope_interleave:
        q_pe, k_pe = _deinterleave(q_pe), _deinterleave(k_pe)
    q_pe = apply_rotary_emb(q_pe, cos, sin, False)
    k_pe = apply_rotary_emb(k_pe, cos, sin, False)
    # absorbed latent query: W_UK is (r, H, dn)
    q_lat = torch.einsum("thn,rhn->thr", q_nope, lw["w_uk"])
    kv_vec = torch.cat([c_kv[:, None, :], k_pe], dim=-1)     # (T, 1, r + dr)
    # in place, with the int8 quantize fused in (kernel K3's single-plane form)
    write_latent_cache(cache, layer_id, batch.attention.new_kv_slot_ids, kv_vec,
                       cfg.kv_scale)
    return torch.cat([q_lat, q_pe], dim=-1)                  # (T, H, r + dr)


def _sm_scale(cfg: DecoderConfig) -> float:
    if cfg.mla_kv_lora > 0:
        return cfg.mla_softmax_scale or 1.0 / ((cfg.mla_nope_dim + cfg.mla_rope_dim) ** 0.5)
    return 1.0 / (cfg.head_dim ** 0.5)


def _attention_out(attn: torch.Tensor, lw: dict, cfg: DecoderConfig) -> torch.Tensor:
    """o_proj of the paged attention's output (MLA: the first kv_lora
    columns, the latent context, expanded per head with W_UV first): the
    attention block's output before the residual add, under TP one rank's
    partial (its heads, its o_proj rows)."""
    T, H = attn.shape[:2]
    if cfg.mla_kv_lora > 0:
        attn = torch.einsum("thr,rhv->thv", attn[..., :cfg.mla_kv_lora], lw["w_uv"])
    return qmatmul(attn.reshape(T, -1), lw["o_proj"])


def router_logits(h: torch.Tensor, lw: dict) -> torch.Tensor:
    """A MoE layer's router logits, in f32."""
    return h.float() @ lw["moe_router"].float()


def _route(h: torch.Tensor, lw: dict, cfg: DecoderConfig):
    """A MoE layer's routing from f32 router logits: (weights, expert ids),
    (T, k) each."""
    logits = router_logits(h, lw)
    if cfg.moe_n_groups > 0:
        if cfg.moe_group_method == "group_limited_greedy":
            return moe.grouped_topk(logits, None, cfg.moe_n_groups, cfg.moe_topk_groups,
                                    cfg.moe_top_k, scoring="softmax", group_agg="max",
                                    norm_topk=cfg.moe_norm_topk,
                                    routed_scaling=cfg.moe_routed_scaling)
        return moe.grouped_topk_sigmoid(logits, lw["moe_router_bias"], cfg.moe_n_groups,
                                        cfg.moe_topk_groups, cfg.moe_top_k,
                                        routed_scaling=cfg.moe_routed_scaling)
    return moe.route(logits, cfg.moe_top_k, scoring=cfg.moe_scoring,
                     norm_topk=cfg.moe_norm_topk, routed_scaling=cfg.moe_routed_scaling)


def _is_moe(lw: dict, cfg: DecoderConfig) -> bool:
    return cfg.moe_top_k > 0 and "moe_router" in lw


def _dense_mlp(h: torch.Tensor, lw: dict) -> torch.Tensor:
    """gate_up -> SiLU-and-mul -> down: a dense layer's MLP or a MoE layer's
    shared experts (under TP one rank's partial: its gate_up columns and
    down rows)."""
    return qmatmul(silu_and_mul(qmatmul(h, lw["gate_up"])), lw["down"])


def _mlp(h: torch.Tensor, lw: dict, cfg: DecoderConfig) -> torch.Tensor:
    """The dense MLP, or in a MoE layer the routed experts (ops/moe.py) plus
    the shared experts, if the layer has them, on one device."""
    if _is_moe(lw, cfg):
        weights, idx = _route(h, lw, cfg)
        out = moe.moe_ffn(h, lw["moe_gate_up"], lw["moe_down"], weights, idx)
        if "gate_up" in lw:
            out = out + _dense_mlp(h, lw)
        return out
    return _dense_mlp(h, lw)


@dataclass(frozen=True)
class Rank:
    """One rank's view of a step: its device, its KV-cache shard, and the
    step's batch and rope rows on its device. A single-device step is one
    rank with no group."""
    device: torch.device
    cache: torch.Tensor
    batch: LanguageModelBatch
    cos: torch.Tensor
    sin: torch.Tensor


def _sum(group, parts):
    """The ranks' partials summed in rank order (RankGroup.all_reduce); one
    rank's partial itself."""
    return parts[0] if group is None else group.all_reduce(parts)


def _layer_attention(x, ranks, lws, layer_id: int, cfg: DecoderConfig, max_q: int,
                     group=None):
    """x plus the layer's attention (lws[r], rank r's layer weights): each
    rank's q and K/V write, the paged attention on every rank's heads
    (ops/attention.py:paged_attention_tp), each rank's o_proj partial, and
    their sum."""
    qs = [_attention_q(x.to(r.device), r.cache, layer_id, lw, r.batch, r.cos, r.sin, cfg)
          for r, lw in zip(ranks, lws)]
    attns = paged_attention_tp(qs, [r.cache for r in ranks], layer_id,
                               [r.batch.attention for r in ranks], _sm_scale(cfg), max_q,
                               kv_scale=cfg.kv_scale)
    return x + _sum(group, [_attention_out(a, lw, cfg) for a, lw in zip(attns, lws)])


def _layer_mlp(x, ranks, lws, cfg: DecoderConfig, group=None):
    """x plus the layer's MLP over its post-norm. Under TP each rank's
    partial, summed: its gate_up columns and down rows, and in a MoE layer
    its run of the experts (ops/moe.py:moe_ffn_ep, over the routing taken
    once on rank 0) with its share of the shared experts joining the same
    sum."""
    lw0 = lws[0]
    h = rms_norm(x, lw0["post_norm"], cfg.rms_norm_eps)
    if group is None:
        return x + _mlp(h, lw0, cfg)
    dense = ([_dense_mlp(h.to(r.device), lw) for r, lw in zip(ranks, lws)]
             if "gate_up" in lw0 else None)
    if _is_moe(lw0, cfg):
        weights, idx = _route(h, lw0, cfg)
        return x + moe.moe_ffn_ep(h, [lw["moe_gate_up"] for lw in lws],
                                  [lw["moe_down"] for lw in lws], weights, idx, group,
                                  extra=dense)
    return x + group.all_reduce(dense)


def _rank_layer(x, ranks, lws, layer_id: int, cfg: DecoderConfig, max_q: int,
                group=None):
    """One decoder layer over the ranks: attention block + MLP block, each
    summed over the ranks before its residual add."""
    x = _layer_attention(x, ranks, lws, layer_id, cfg, max_q, group)
    return _layer_mlp(x, ranks, lws, cfg, group)


def _layer_body(x, cache, layer_id, lw, batch: LanguageModelBatch, cos, sin,
                cfg: DecoderConfig, max_q: int):
    """One decoder layer on one device: _rank_layer over a single rank."""
    return _rank_layer(x, [Rank(x.device, cache, batch, cos, sin)], [lw], layer_id,
                       cfg, max_q)


def _ranks(weights, cache, batch: LanguageModelBatch, cos, sin):
    """(the ranks of a step, their RankGroup or None, their weight dicts):
    one rank for a single-device weight dict; under TP (ShardedWeights)
    each rank with its cache shard and the batch and rope rows on its
    device."""
    if not isinstance(weights, ShardedWeights):
        return [Rank(cos.device, cache, batch, cos, sin)], None, [weights]
    ranks = [Rank(dev, cache[r], params_to(batch, dev), cos.to(dev), sin.to(dev))
             for r, dev in enumerate(weights.group.devices)]
    return ranks, weights.group, weights.ranks


def _embed(weights, token_ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of token_ids. Under TP each rank looks up the ids
    of its vocabulary range, zeros elsewhere, and the ranks are summed."""
    if not isinstance(weights, ShardedWeights):
        return weights["embed"][token_ids.long()]
    parts = []
    for r, (w, dev) in enumerate(zip(weights.ranks, weights.group.devices)):
        e = w["embed"]
        local = token_ids.to(dev).long() - r * e.shape[0]
        inside = (local >= 0) & (local < e.shape[0])
        parts.append(torch.where(inside[:, None], e[local.clamp(0, e.shape[0] - 1)], 0))
    return weights.group.all_reduce(parts)


def _head_logits(weights, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Final norm -> lm_head: (rows, V) f32 logits. Under TP each rank's
    vocabulary columns are gathered on rank 0's device."""
    if not isinstance(weights, ShardedWeights):
        return qmatmul_f32(rms_norm(x, weights["norm"], cfg.rms_norm_eps),
                           weights["lm_head"])
    h = rms_norm(x, weights.ranks[0]["norm"], cfg.rms_norm_eps)
    return weights.group.gather([qmatmul_f32(h.to(dev), w["lm_head"])
                                 for w, dev in zip(weights.ranks, weights.group.devices)])


def decoder_forward(weights: dict, cache: torch.Tensor, batch: LanguageModelBatch,
                    cos_tab: torch.Tensor, sin_tab: torch.Tensor,
                    cfg: DecoderConfig, max_q: int, token_table: torch.Tensor,
                    return_logits: bool = False, spec: int = 0,
                    generator: Optional[torch.Generator] = None,
                    input_embeds: Optional[torch.Tensor] = None):
    """Full LM step. Returns the (S,) sampled tokens (and the (S, V) f32
    logits if asked), or with spec > 0 the verify step's
    [emitted (S * spec) | acc (S)]. token_table's last entry is a discard
    slot. A batch with sampling controls draws from `generator`.
    input_embeds, (T, hidden), replaces the embedding lookup and the image
    splice. Under TP `weights` is ShardedWeights and `cache` the list of its
    ranks' shards; the batch and the tables live on rank 0's device."""
    if input_embeds is None:
        x = _splice_images(_embed(weights, _input_ids(batch, token_table)), batch)
    else:
        x = input_embeds
    cos, sin = _rope_rows(cos_tab, sin_tab, batch, cfg)
    ranks, group, rank_weights = _ranks(weights, cache, batch, cos, sin)
    if group is not None:
        cfg = weights.cfg
    for layer_id in range(cfg.n_layers - 1):
        x = _rank_layer(x, ranks, [w["layers"][layer_id] for w in rank_weights],
                        layer_id, cfg, max_q, group)
    x = _last_layer(x, ranks, [w["layers"][-1] for w in rank_weights], cfg.n_layers - 1,
                    cfg, max_q, group, spec)
    return _head(weights, x, batch, cfg, token_table, return_logits, spec, generator)


def _input_ids(batch: LanguageModelBatch, token_table: torch.Tensor) -> torch.Tensor:
    """The step's input token of each row: from the token table where the
    row names a slot (the previous step's sampled token), else as packed."""
    src = batch.token_src_slots
    return torch.where(src >= 0, token_table[src.clamp(min=0).long()], batch.token_ids)


def _rope_rows(cos_tab, sin_tab, batch: LanguageModelBatch, cfg: DecoderConfig):
    """The (T, rope_dim // 2) cos and sin rows of the step's positions (under
    M-RoPE gathered from the three position streams)."""
    if cfg.mrope_section and batch.positions_hw is not None:
        return mrope_gather(cos_tab, sin_tab, batch.positions, batch.positions_hw[0],
                            batch.positions_hw[1], cfg.mrope_section)
    return cos_tab[batch.positions.long()], sin_tab[batch.positions.long()]


def _splice_images(x: torch.Tensor, batch: LanguageModelBatch) -> torch.Tensor:
    """Overwrite the embeddings at image_dst_idx with the image features.
    Padding destinations (-1) go to one extra row that is cut off again: a
    negative index would wrap, and dropping them by a host-side filter would
    cost a synchronisation."""
    if batch.image_features is None:
        return x
    T = x.shape[0]
    dst = torch.where(batch.image_dst_idx < 0, T, batch.image_dst_idx).long()
    x = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    x.index_copy_(0, dst, batch.image_features.to(x.dtype))
    return x[:T]


def _last_layer(x, ranks, lws, layer_id: int, cfg: DecoderConfig, max_q: int, group=None,
                spec: int = 0):
    """The last layer. Its attention sees all T tokens (their KV must be
    written); then only the sampled rows continue through the MLP (every
    row in a speculative verify step, whose every next token matters). (The
    JAX MLA last layer runs its MLP over all T rows and discards after it;
    the MLP is row-wise, and so is a MoE layer's routing, so discarding
    first gives the same numbers.)"""
    x = _layer_attention(x, ranks, lws, layer_id, cfg, max_q, group)
    if spec == 0:
        x = x[ranks[0].batch.sample_token_idx.clamp(min=0).long()]      # token discard
    return _layer_mlp(x, ranks, lws, cfg, group)


def _head(weights, x, batch: LanguageModelBatch, cfg: DecoderConfig, token_table,
          return_logits: bool, spec: int = 0, generator=None):
    """The step's head on the last layer's rows: the verify head of a
    speculative step, else the tokens (and the logits if asked)."""
    if spec > 0:
        return _spec_verify_head(weights, x, batch, cfg, token_table, spec, generator)
    tokens, logits = _final_head(weights, x, batch, cfg, token_table, generator)
    return (tokens, logits) if return_logits else tokens


def _sampling_controls(batch: LanguageModelBatch, generator) -> dict:
    """The batch's sampling controls as keyword arguments of the sampling
    chain; {} when no sequence samples."""
    if batch.temperatures is None:
        return {}
    if generator is None:
        raise ValueError("a batch with sampling controls needs a generator")
    return dict(temperature=batch.temperatures, top_k=batch.top_ks,
                top_p=batch.top_ps, generator=generator)


def _spec_verify_head(weights, x, batch: LanguageModelBatch, cfg: DecoderConfig,
                      token_table: torch.Tensor, K1: int, generator=None):
    """Verification head of n-gram speculative decoding. Row 0 of each
    segment is the real next-token input, rows 1..K1-1 the host's drafts.
    Acceptance runs on the device (exact argmax match for greedy sequences,
    rejection sampling for sampled ones); the final token goes into the
    token table. Returns [emitted (S * K1) | acc (S)]."""
    logits = _head_logits(weights, x, cfg)
    S = batch.sample_dst_slots.shape[0]
    lg = logits[:S * K1].reshape(S, K1, -1)     # T is bucket-padded past S * K1
    ids = batch.token_ids[:S * K1].reshape(S, K1)      # drafts in columns 1..K1-1
    draft_next = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
    dl = torch.clamp(batch.draft_lens, 0, K1 - 1)
    emitted, acc = spec_verify_tokens(lg, draft_next, dl,
                                      **_sampling_controls(batch, generator))
    final = emitted.gather(1, acc.long()[:, None])[:, 0]
    dst = batch.sample_dst_slots
    dst = torch.where(dst < 0, token_table.shape[0] - 1, dst)
    token_table.index_copy_(0, dst.long(), final)
    return torch.cat([emitted.reshape(-1), acc])


def _final_head(weights, x, batch: LanguageModelBatch, cfg: DecoderConfig,
                token_table: torch.Tensor, generator=None):
    """Final norm -> lm_head on the sampled rows -> token -> scatter into the
    token table (dst < 0 lands in the trailing discard slot). A sequence with
    temperature > 0 takes a draw from its filtered distribution, every other
    the argmax."""
    logits = _head_logits(weights, x, cfg)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    controls = _sampling_controls(batch, generator)
    if controls:
        sampled = process_logits(logits, **controls)
        tokens = torch.where(batch.temperatures > 0, sampled, tokens)
    dst = batch.sample_dst_slots
    dst = torch.where(dst < 0, token_table.shape[0] - 1, dst)
    token_table.index_copy_(0, dst.long(), tokens)
    return tokens, logits


def decoder_forward_multi(weights: dict, cache: torch.Tensor,
                          batch: LanguageModelBatch, cos_tab: torch.Tensor,
                          sin_tab: torch.Tensor, cfg: DecoderConfig, n_steps: int,
                          token_table: torch.Tensor,
                          fused_k: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """K fused decode steps; returns the (n_steps, S) sampled tokens. Each
    step of a sampling batch takes fresh draws from `generator` (the JAX
    window gives step s the seed sample_seed + s instead).

    Every sequence is a single-token decode whose position, kv length and
    cache slot advance by exactly 1 per step. fused_k ((S,) int32, n_steps by
    default) caps each sequence's participation: sequence r runs steps
    0..fused_k[r]-1; on later steps its geometry freezes and both of its
    state writes (cache slot, token-table slot) are dropped, so a request near
    its token limit rides along without corrupting state. The block tables
    must already cover positions[0] + fused_k - 1 (the executor reallocs
    ahead). Rows s >= fused_k[r] of column r are garbage the host drops.
    """
    a = batch.attention
    bs = (cache[0] if isinstance(cache, list) else cache).shape[3]
    valid_tok = a.q_seq_ids >= 0
    seq_of_tok = a.q_seq_ids.clamp(min=0).long()
    valid_seq = a.kv_lens > 0
    if fused_k is None:
        fused_k = torch.full_like(a.kv_lens, n_steps)
    last = torch.clamp(fused_k - 1, min=0)
    chained_src = torch.where(valid_tok, batch.sample_dst_slots[seq_of_tok], -1)
    zero = torch.zeros((), dtype=torch.int32, device=a.kv_lens.device)
    out = []
    for s in range(n_steps):
        s_seq = torch.clamp(last, max=s)
        act_seq = fused_k > s
        act_tok = valid_tok & (fused_k[seq_of_tok] > s)
        pos = a.positions + torch.where(valid_tok, s_seq[seq_of_tok], zero)
        kv = a.kv_lens + torch.where(valid_seq, s_seq, zero)
        # the write slot comes from the CACHE position (kv_len - 1)
        cache_pos = torch.clamp(kv[seq_of_tok] - 1, min=0)
        blk = a.block_tables[seq_of_tok, (cache_pos // bs).long()]
        slots = torch.where(act_tok & (blk >= 0), blk * bs + cache_pos % bs, -1)
        hw = batch.positions_hw
        if hw is not None:
            # decode advances all three M-RoPE axes together
            hw = hw + torch.where(valid_tok, s_seq[seq_of_tok], zero)[None, :]
        step = batch.replace(
            positions=pos, positions_hw=hw,
            attention=a.replace(positions=pos, kv_lens=kv, new_kv_slot_ids=slots),
            # step 0 takes its input however the host packed it; later steps
            # read the previous step's sampled token from the table
            token_src_slots=batch.token_src_slots if s == 0 else chained_src,
            sample_dst_slots=torch.where(act_seq, batch.sample_dst_slots, -1))
        out.append(decoder_forward(weights, cache, step, cos_tab, sin_tab, cfg,
                                   1, token_table, generator=generator))
    return torch.stack(out)
