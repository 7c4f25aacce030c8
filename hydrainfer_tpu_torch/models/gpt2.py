"""GPT-2 over the paged cache (port of hydrainfer_tpu/models/gpt2.py).

A pre-LN transformer with learned positions: per layer, layer_norm -> the
fused c_attn projection with its bias -> this step's K/V into the cache
(kernel K3) -> paged attention (K1 on all-decode steps, K2 on mixed ones) ->
c_proj with its bias; layer_norm -> c_fc -> the tanh GELU -> c_proj; then
ln_f on each sequence's sampled row, f32 logits against the tied wte, the
argmax, and the token-table scatter. Conv1D weights are stored (in, out)
already. The cache and the token table are updated in place; all-decode
steps run from CUDA graphs when the node passes its StepGraphs.

As in the JAX package, GPT-2 decodes greedily one step at a time: it takes
no fused window (supports_multi_step is False, so the executor neither fuses
nor speculates), and it has no sampling head. Where JAX would quietly decode
a temperature > 0 request greedily, the port refuses the request at the node
(LanguageModelConfig.greedy_only). The JAX model ignores an int8 KV cache's
scale and int8 weight quantization; the port's factory refuses both.
"""
import json
import os
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.activation import gelu_tanh
from ..ops.attention import paged_attention
from ..ops.cache_ops import write_kv_cache
from ..ops.norm import layer_norm
from ..utils.device import resolve_device
from .factory import (FillDims, LanguageModel, LanguageModelBatch, LanguageModelConfig,
                      LanguageModelOutput, ModelFactory, ModelFactoryConfig,
                      unpack_fill_batch)
from .step_graphs import StepGraphs, graphed
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


@dataclass(frozen=True)
class GPT2Config:
    n_layers: int
    hidden_size: int
    n_qo_heads: int
    vocab_size: int
    max_position_embeddings: int = 1024

    @property
    def n_kv_heads(self) -> int:
        return self.n_qo_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_qo_heads


def gpt2_config_from_hf(hf_cfg: dict) -> GPT2Config:
    return GPT2Config(n_layers=hf_cfg["n_layer"], hidden_size=hf_cfg["n_embd"],
                      n_qo_heads=hf_cfg["n_head"], vocab_size=hf_cfg["vocab_size"],
                      max_position_embeddings=hf_cfg.get("n_positions", 1024))


def convert_gpt2_weights(store: WeightStore, n_layers: int) -> dict:
    """HF GPT-2 names (with or without the `transformer.` prefix) -> {"wte",
    "wpe", "layers": [{ln1, c_attn, c_proj, ln2, c_fc, c_proj2}], "ln_f"},
    every layer entry a (weight, bias) pair."""
    p = "transformer." if store.has("transformer.wte.weight") else ""
    pair = lambda name: (store.get(name + ".weight"), store.get(name + ".bias"))  # noqa: E731
    w = {"wte": store.get(p + "wte.weight"), "wpe": store.get(p + "wpe.weight"),
         "layers": [], "ln_f": pair(p + "ln_f")}
    for layer in range(n_layers):
        lp = f"{p}h.{layer}."
        w["layers"].append({"ln1": pair(lp + "ln_1"), "c_attn": pair(lp + "attn.c_attn"),
                            "c_proj": pair(lp + "attn.c_proj"), "ln2": pair(lp + "ln_2"),
                            "c_fc": pair(lp + "mlp.c_fc"),
                            "c_proj2": pair(lp + "mlp.c_proj")})
    return w


def gpt2_forward(weights: dict, head: torch.Tensor, cache: torch.Tensor,
                 batch: LanguageModelBatch, cfg: GPT2Config, max_q: int,
                 token_table: torch.Tensor, return_logits: bool = False):
    """One step; returns the (S,) greedy tokens (and the (S, V) f32 logits if
    asked). `head` is the tied wte transposed, (H, V) in f32. token_table's
    last entry is a discard slot."""
    src = batch.token_src_slots
    token_ids = torch.where(src >= 0, token_table[src.clamp(min=0).long()],
                            batch.token_ids).long()
    x = weights["wte"][token_ids] + weights["wpe"][batch.positions.long()]
    T, hidden = x.shape
    H, D = cfg.n_qo_heads, cfg.head_dim
    for layer_id, lw in enumerate(weights["layers"]):
        h = layer_norm(x, *lw["ln1"])
        cw, cb = lw["c_attn"]
        q, k, v = torch.split(h @ cw + cb, hidden, dim=-1)
        # in place: the cache receives this step's K/V (kernel K3)
        write_kv_cache(cache, layer_id, batch.attention.new_kv_slot_ids,
                       k.reshape(T, H, D), v.reshape(T, H, D))
        # the kernels take a contiguous q; k and v go to K3 as strided views
        attn = paged_attention(q.reshape(T, H, D).contiguous(), cache, layer_id,
                               batch.attention, 1.0 / (D ** 0.5), max_q)
        pw, pb = lw["c_proj"]
        x = x + (attn.reshape(T, hidden) @ pw + pb)
        h = layer_norm(x, *lw["ln2"])
        (fw, fb), (p2w, p2b) = lw["c_fc"], lw["c_proj2"]
        x = x + (gelu_tanh(h @ fw + fb) @ p2w + p2b)
    x = x[batch.sample_token_idx.clamp(min=0).long()]
    logits = layer_norm(x, *weights["ln_f"]).float() @ head
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    dst = batch.sample_dst_slots
    dst = torch.where(dst < 0, token_table.shape[0] - 1, dst)
    token_table.index_copy_(0, dst.long(), tokens)
    return (tokens, logits) if return_logits else tokens


class GPT2ForCausalLM(LanguageModel):
    supports_multi_step = False

    def __init__(self, weights: dict, cfg: GPT2Config):
        self.weights = weights
        self.cfg = cfg
        self.device = weights["wte"].device
        self.dtype = weights["wte"].dtype
        # the tied head in f32 (the JAX dot's f32 accumulation of the
        # model-dtype products), made once rather than every step
        self.head = weights["wte"].t().float()

    def forward_flat(self, cache: torch.Tensor, token_table: torch.Tensor,
                     flat: torch.Tensor, dims: FillDims, n_steps: int = 1,
                     fused_k: Optional[torch.Tensor] = None,
                     image_cache: Optional[torch.Tensor] = None,
                     graphs: Optional[StepGraphs] = None,
                     generator: Optional[torch.Generator] = None) -> LanguageModelOutput:
        """One fill step (n_steps is ignored, as in JAX: the executor never
        asks a model without multi-step support for more); an all-decode
        step runs from its CUDA graph when `graphs` is given. No step
        verifies drafts (the executor speculates only with multi-step
        support) or samples (the node refuses such requests)."""
        if graphs is not None and graphed(dims):
            tokens = graphs.run(self._step, cache, token_table, flat, dims, n_steps,
                                fused_k, generator)
        else:
            tokens = self._step(cache, token_table, flat, dims, n_steps)
        return LanguageModelOutput(sample_token_ids=tokens)

    def _step(self, cache, token_table, flat, dims: FillDims, n_steps: int = 1,
              fused_k=None, image_cache=None, generator=None) -> torch.Tensor:
        batch = unpack_fill_batch(flat, dims)
        return gpt2_forward(self.weights, self.head, cache, batch, self.cfg, dims.max_q,
                            token_table)

    def forward(self, cache: torch.Tensor, token_table: torch.Tensor,
                batch: LanguageModelBatch, max_q: int) -> LanguageModelOutput:
        """One greedy step on a caller-built batch: the cache and the token
        table are updated in place and returned with the (S,) tokens."""
        tokens = gpt2_forward(self.weights, self.head, cache, batch, self.cfg, max_q,
                              token_table)
        return LanguageModelOutput(sample_token_ids=tokens, cache=cache,
                                   token_table=token_table)

    def forward_with_logits(self, cache: torch.Tensor, batch: LanguageModelBatch,
                            max_q: int, input_embeds: Optional[torch.Tensor] = None):
        """One step on a caller-built batch: (cache, tokens, f32 logits), as
        the JAX model returns them. The token table is a scratch one.
        input_embeds is taken for the interface's sake and ignored, as in
        the JAX model."""
        table = torch.zeros(1, dtype=torch.int32, device=cache.device)
        tokens, logits = gpt2_forward(self.weights, self.head, cache, batch, self.cfg,
                                      max_q, table, return_logits=True)
        return cache, tokens, logits


class GPT2ModelFactory(ModelFactory):
    """GPT2LMHeadModel checkpoints. An int8 KV cache or int8 weights are
    refused: the JAX model reads neither and would store an int8 cache's
    K/V truncated, without a scale."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        if config.kv_cache_dtype == "int8":
            raise ValueError("GPT-2 takes no int8 KV cache: its attention reads no KV "
                             "scale (the JAX model would store K/V truncated to int8); "
                             "serve it with kv_cache_dtype auto")
        if config.quantization not in (None, "", "none"):
            raise ValueError(f"GPT-2 takes no weight quantization ({config.quantization!r}): "
                             "its projections are plain matmuls with biases; serve it "
                             "with quantization none")
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        self.cfg = gpt2_config_from_hf(self.hf_cfg)
        self._lm = None

    def getLanguageModel(self) -> GPT2ForCausalLM:
        if self._lm is None:
            store = WeightStore(self.config.path, self.config.dtype, self.device)
            self._lm = GPT2ForCausalLM(convert_gpt2_weights(store, self.cfg.n_layers),
                                       self.cfg)
        return self._lm

    def getVisionModel(self):
        return None

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        return gpt2_language_config(self.cfg, self.hf_cfg.get("eos_token_id", 50256))

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))


def gpt2_language_config(cfg: GPT2Config, eos_token_id: int = 50256) -> LanguageModelConfig:
    """The node's view of a GPT-2 LM: multi-head attention, greedy only."""
    return LanguageModelConfig(
        n_layers=cfg.n_layers, max_position_embeddings=cfg.max_position_embeddings,
        n_qo_heads=cfg.n_qo_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        eos_token_id=eos_token_id, hidden_size=cfg.hidden_size,
        vocab_size=cfg.vocab_size, greedy_only=True)
