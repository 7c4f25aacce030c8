"""Llama-family causal LM over the paged cache (port of
hydrainfer_tpu/models/llama.py: LlamaForCausalLM, decoder_config_from_hf and
convert_llama_weights; Qwen2 text decoders are the same with a qkv bias).

The weights stay a plain per-layer dict (no stacking: the layer loop is a
Python loop). `forward` and `forward_with_logits` take a caller-built
LanguageModelBatch (the JAX model's interface, which the quality scripts of
hydrainfer_tpu_torch/evaluation use), and `forward_flat` takes the engine's
single flat int32 buffer;
its all-decode steps and speculative-verify steps run from CUDA graphs when
the node passes its StepGraphs (models/step_graphs.py, the counterpart of the
jitted programs). A step whose dims carry `spec` > 0 is a verify step (the
counterpart of the JAX model's `_flat_spec`); the sampling draws come from
the caller's generator. The caller's weight dict is not consumed.

`shard_to(devices)` makes the model tensor-parallel (every family served
through this class: Llama, Qwen2, Mixtral, DeepSeek and the language towers
of LLaVA, LLaVA-NeXT, InternVL, Qwen2-VL and DeepSeek-VL2; their vision
towers stay whole on rank 0's device). Its cache is then a list of per-rank
shards.
"""
from dataclasses import replace
from typing import Optional

import torch

from ..ops.quant import quantize_tree
from ..parallel.mesh import RankGroup, ShardedWeights, shard_decoder_weights
from .decoder import (DecoderConfig, decoder_forward, decoder_forward_multi,
                      init_rope_tables)
from .factory import (FillDims, LanguageModel, LanguageModelBatch, LanguageModelOutput,
                      unpack_fill_batch)
from .step_graphs import StepGraphs, graphed
from .weight_loader import WeightStore


def decoder_config_from_hf(cfg: dict) -> DecoderConfig:
    hidden = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return DecoderConfig(
        n_layers=cfg["num_hidden_layers"],
        hidden_size=hidden,
        intermediate_size=cfg["intermediate_size"],
        n_qo_heads=heads,
        n_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or hidden // heads,
        vocab_size=cfg["vocab_size"],
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        qkv_bias=(cfg.get("model_type") == "qwen2"
                  or bool(cfg.get("attention_bias", False))),
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )


def convert_llama_weights(store: WeightStore, cfg: DecoderConfig,
                          prefix: str = "model.", lm_head_name: str = "lm_head") -> dict:
    """HF checkpoint names -> the decoder's weight dict (fused qkv, gate_up)."""
    w = {"embed": store.get(f"{prefix}embed_tokens.weight"), "layers": []}
    for layer in range(cfg.n_layers):
        p = f"{prefix}layers.{layer}."
        qkv, qkv_b = store.fused_linear(
            [p + "self_attn.q_proj", p + "self_attn.k_proj", p + "self_attn.v_proj"],
            bias=True)
        lw = {
            "qkv_proj": qkv,
            "o_proj": store.linear(p + "self_attn.o_proj"),
            "gate_up": store.fused_linear([p + "mlp.gate_proj", p + "mlp.up_proj"]),
            "down": store.linear(p + "mlp.down_proj"),
            "input_norm": store.get(p + "input_layernorm.weight"),
            "post_norm": store.get(p + "post_attention_layernorm.weight"),
        }
        if cfg.qkv_bias and qkv_b is not None:
            lw["qkv_bias"] = qkv_b
        w["layers"].append(lw)
    w["norm"] = store.get(f"{prefix}norm.weight")
    if cfg.tie_word_embeddings or not store.has(f"{lm_head_name}.weight"):
        w["lm_head"] = w["embed"].t().contiguous()
    else:
        w["lm_head"] = store.linear(lm_head_name)
    return w


class LlamaForCausalLM(LanguageModel):
    supports_multi_step = True

    def __init__(self, weights: dict, cfg: DecoderConfig,
                 quantization: str = "none", kv_scale: Optional[float] = None):
        if kv_scale is not None:
            cfg = replace(cfg, kv_scale=kv_scale)
        self.cfg = cfg
        self.weights = quantize_tree(weights, quantization)
        self.device = self.weights["embed"].device
        self.dtype = self.weights["embed"].dtype
        self.cos_tab, self.sin_tab = init_rope_tables(cfg, self.device)

    @property
    def tp_size(self) -> int:
        return self.weights.group.size if isinstance(self.weights, ShardedWeights) else 1

    def shard_to(self, devices) -> None:
        """Tensor- and expert-parallel placement over `devices`, one rank
        each (port of the JAX shard_to; parallel/mesh.py): the weights become
        one dict a rank, and the node gives forward_flat one KV-cache shard a
        rank (`weights.cache_shards()`). The rope tables stay on rank 0's
        device, where the batch arrives. Call before the first forward; the
        same devices again is a no-op. The unsharded weights are let go: row
        and expert slices are views of them, the permuted columns copies."""
        group = RankGroup(tuple(torch.device(d) for d in devices))
        if isinstance(self.weights, ShardedWeights):
            if self.weights.group == group:
                return
            raise ValueError(f"the model is already sharded over {self.weights.group.devices}; "
                             f"a node on {group.devices} needs a model of its own")
        self.weights = shard_decoder_weights(self.weights, self.cfg, group)

    def forward(self, cache: torch.Tensor, token_table: torch.Tensor,
                batch: LanguageModelBatch, max_q: int) -> LanguageModelOutput:
        """One greedy step on a caller-built batch: the cache and the token
        table are updated in place and returned with the (S,) tokens."""
        tokens = decoder_forward(self.weights, cache, batch, self.cos_tab, self.sin_tab,
                                 self.cfg, max_q, token_table)
        return LanguageModelOutput(sample_token_ids=tokens, cache=cache,
                                   token_table=token_table)

    def forward_with_logits(self, cache: torch.Tensor, batch: LanguageModelBatch,
                            max_q: int, input_embeds: Optional[torch.Tensor] = None):
        """One greedy step on a caller-built batch: (cache, (S,) tokens, (S, V)
        f32 logits at the sampled rows). The token table is a scratch one of
        a single slot: rows with sample_dst_slots -1 (every row, where a
        batch samples all its positions) all land in it, and it is never
        read, since the batch's token_src_slots must be -1."""
        table = torch.zeros(1, dtype=torch.int32, device=self.device)
        tokens, logits = decoder_forward(self.weights, cache, batch, self.cos_tab,
                                         self.sin_tab, self.cfg, max_q, table,
                                         return_logits=True, input_embeds=input_embeds)
        return cache, tokens, logits

    def forward_flat(self, cache: torch.Tensor, token_table: torch.Tensor,
                     flat: torch.Tensor, dims: FillDims, n_steps: int = 1,
                     fused_k: Optional[torch.Tensor] = None,
                     image_cache: Optional[torch.Tensor] = None,
                     graphs: Optional[StepGraphs] = None,
                     generator: Optional[torch.Generator] = None) -> LanguageModelOutput:
        """One fill step (n_steps == 1, any mix of prefill and decode), a
        fused window of n_steps decode steps, or a speculative-verify step
        (dims.spec > 0). The cache and the token table are updated in place;
        returns the sampled tokens, (n_steps * S,), or a verify step's
        [emitted (S * spec) | acc (S)]. image_cache is read only when the
        batch carries image features; `generator` only when it samples. With
        `graphs` (a node's StepGraphs), an all-decode or verify step runs
        from its CUDA graph, and flat and fused_k must be that key's
        buffers."""
        if graphs is not None and graphed(dims):
            tokens = graphs.run(self._step, cache, token_table, flat, dims, n_steps,
                                fused_k, generator)
        else:
            tokens = self._step(cache, token_table, flat, dims, n_steps, fused_k,
                                image_cache, generator)
        return LanguageModelOutput(sample_token_ids=tokens)

    def _step(self, cache, token_table, flat, dims: FillDims, n_steps: int,
              fused_k=None, image_cache=None, generator=None) -> torch.Tensor:
        batch = unpack_fill_batch(flat, dims, image_cache, self.cfg.hidden_size)
        if n_steps > 1:
            tokens = decoder_forward_multi(self.weights, cache, batch, self.cos_tab,
                                           self.sin_tab, self.cfg, n_steps,
                                           token_table, fused_k, generator)
        else:
            tokens = decoder_forward(self.weights, cache, batch, self.cos_tab,
                                     self.sin_tab, self.cfg, dims.max_q, token_table,
                                     spec=dims.spec, generator=generator)
        return tokens.reshape(-1)
