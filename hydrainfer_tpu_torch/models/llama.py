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

`shard_to(devices)` makes the model tensor-parallel and `shard_to_pp(devices)`
pipeline-parallel (every family served through this class: Llama, Qwen2,
Mixtral, DeepSeek and the language towers of LLaVA, LLaVA-NeXT, InternVL,
Qwen2-VL and DeepSeek-VL2; their vision towers stay whole on the first
device). Its cache is then a list of shards (`cache_shards`). A
pipeline-parallel model takes, as the JAX model does, the microbatched
decode for pure single-token decode steps and the stage relay for every
other step (parallel/pipeline.py), runs no fused window or verify step
(supports_multi_step is False) and has no `forward` / `forward_with_logits`.
"""
from dataclasses import replace
from typing import Optional

import torch

from ..ops.quant import quantize_tree
from ..parallel.mesh import RankGroup, ShardedWeights, shard_decoder_weights
from ..parallel.pipeline import PipelineStages, pp_stages, pp_step, step_form
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
    # the pipeline stages (shard_to_pp); None on one device or under TP
    stages: Optional[PipelineStages] = None

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
        self._single_device("tensor-parallel", group.devices)
        self.weights = shard_decoder_weights(self.weights, self.cfg, group)

    def shard_to_pp(self, devices) -> None:
        """Pipeline-parallel placement over `devices` (port of the JAX
        shard_to_pp; parallel/pipeline.py): one stage of contiguous layers a
        device. The node gives forward_flat one KV-cache shard a stage
        (`cache_shards`). Embed, norm, lm_head and the rope tables stay on
        the first device. The unsharded weight dict is let go, as the JAX
        model lets it go: the stages hold its tensors. Call before the
        first forward; the same devices again is a no-op."""
        devices = tuple(torch.device(d) for d in devices)
        if self.stages is not None:
            if self.stages.devices == devices:
                return
            raise ValueError(f"the model is already pipeline-parallel over "
                             f"{self.stages.devices}; a node on {devices} needs a model of "
                             "its own")
        self._single_device("pipeline-parallel", devices)
        self.stages = pp_stages(self.weights, self.cfg, devices)
        self.weights = None
        self.device = devices[0]
        self.cos_tab, self.sin_tab = self.cos_tab.to(self.device), self.sin_tab.to(self.device)
        # the relay and the microbatched decode are single steps
        self.supports_multi_step = False

    def _single_device(self, what: str, devices) -> None:
        if self.stages is not None or isinstance(self.weights, ShardedWeights):
            raise ValueError(f"a {what} node on {devices} needs a model of its own: this "
                             "one is already sharded")

    def cache_shards(self):
        """The KV-cache shards forward_flat takes (parallel/mesh.py:
        CacheShard), one a rank or stage; None for one device."""
        if self.stages is not None:
            return self.stages.cache_shards()
        if isinstance(self.weights, ShardedWeights):
            return self.weights.cache_shards()
        return None

    def _whole(self, what: str) -> None:
        if self.stages is not None:
            # the JAX model's forward reads self.weights, which its
            # shard_to_pp sets to None
            raise NotImplementedError(
                f"{what} under pipeline parallelism: the stages hold the weights and the "
                "whole dict is let go; serve through forward_flat (the node)")

    def forward(self, cache: torch.Tensor, token_table: torch.Tensor,
                batch: LanguageModelBatch, max_q: int) -> LanguageModelOutput:
        """One greedy step on a caller-built batch: the cache and the token
        table are updated in place and returned with the (S,) tokens."""
        self._whole("forward")
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
        self._whole("forward_with_logits")
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
        buffers. A pipeline-parallel step counts its form in
        `stages.steps`."""
        if self.stages is not None:
            self.stages.steps[step_form(dims, self.stages.pp)] += 1
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
        if self.stages is not None:
            if n_steps > 1 or dims.spec > 0:
                raise ValueError("a pipeline-parallel model runs single fill steps only")
            return pp_step(self.stages, cache, batch, self.cos_tab, self.sin_tab, dims,
                           token_table, generator).reshape(-1)
        if n_steps > 1:
            tokens = decoder_forward_multi(self.weights, cache, batch, self.cos_tab,
                                           self.sin_tab, self.cfg, n_steps,
                                           token_table, fused_k, generator)
        else:
            tokens = decoder_forward(self.weights, cache, batch, self.cos_tab,
                                     self.sin_tab, self.cfg, dims.max_q, token_table,
                                     spec=dims.spec, generator=generator)
        return tokens.reshape(-1)
