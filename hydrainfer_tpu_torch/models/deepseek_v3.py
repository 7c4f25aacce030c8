"""DeepSeek V2/V3 mixture-of-experts language models, with multi-head
latent attention (port of hydrainfer_tpu/models/deepseek_v3.py).

The first `first_k_dense_replace` layers are dense; the others route each
token to `num_experts_per_tok` of `n_routed_experts` experts (greedy softmax
or sigmoid, group_limited_greedy or noaux_tc with its correction bias) and
add the shared experts. An MLA checkpoint converts natively: the optional
q-LoRA stack, kv_a with its norm, and kv_b split into the absorbed W_UK and
W_UV; the KV cache then holds one [c_kv | k_pe] vector per token
(models/decoder.py). YaRN rope scaling goes into the rope tables and, with
mscale_all_dim, into the softmax scale. As in JAX, MLA is keyed on
kv_lora_rank; a config that sets `use_mla: false` beside it is refused.
"""
import dataclasses
import json
import math
import os

import torch

from ..utils.device import resolve_device
from .factory import LanguageModelConfig, ModelFactory, ModelFactoryConfig
from .llama import LlamaForCausalLM, decoder_config_from_hf
from .tokenizer import HFTokenizerAdapter
from .weight_loader import WeightStore


def deepseek_decoder_config(text_cfg: dict):
    """The decoder config of a DeepSeek V2/V3 text config (its routing, YaRN
    and MLA fields)."""
    base = decoder_config_from_hf(text_cfg)
    method = text_cfg.get("topk_method", "noaux_tc")
    base = dataclasses.replace(
        base,
        moe_top_k=text_cfg.get("num_experts_per_tok", 0) or 0,
        n_experts=text_cfg.get("n_routed_experts", 0) or 0,
        moe_scoring=text_cfg.get("scoring_func", "softmax"),
        moe_norm_topk=bool(text_cfg.get("norm_topk_prob", True)),
        moe_routed_scaling=float(text_cfg.get("routed_scaling_factor", 1.0)),
        moe_n_groups=((text_cfg.get("n_group", 0) or 0)
                      if method in ("noaux_tc", "group_limited_greedy") else 0),
        moe_topk_groups=text_cfg.get("topk_group", 0) or 0,
        moe_group_method=method)
    rs = text_cfg.get("rope_scaling") or {}
    rs_type = rs.get("type") or rs.get("rope_type")
    if rs and rs_type == "yarn":
        f = float(rs.get("factor", 1.0))
        mscale, msad = rs.get("mscale"), rs.get("mscale_all_dim")

        def _ms(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        att = rs.get("attention_factor")
        if att is None:
            att = _ms(f, mscale) / _ms(f, msad) if (mscale and msad) else _ms(f)
        base = dataclasses.replace(base, yarn=(
            f, int(rs.get("original_max_position_embeddings")
                   or text_cfg.get("max_position_embeddings", 4096)),
            float(rs.get("beta_fast") or 32), float(rs.get("beta_slow") or 1),
            float(att), bool(rs.get("truncate", True))))
    elif rs and rs_type not in (None, "default"):
        raise ValueError(f"unsupported rope_scaling type {rs_type!r} for DeepSeek: only "
                         "yarn is wired")
    r = text_cfg.get("kv_lora_rank") or 0
    if r and text_cfg.get("use_mla") is False:
        # MLA is keyed on kv_lora_rank (as in JAX): such a checkpoint would
        # load as MLA and miss its q/k/v weights (ROADMAP queue 3)
        raise ValueError("DeepSeek config sets use_mla: false beside kv_lora_rank "
                         f"{r}; MLA is keyed on kv_lora_rank, so drop it from the "
                         "config to load the model's q/k/v attention")
    if r:
        # MLA: one [c_kv | k_pe] vector per token -> kv head 1 of dim r + rope;
        # rope tables sized to the rope dims only
        dr, dn = text_cfg["qk_rope_head_dim"], text_cfg["qk_nope_head_dim"]
        scale = (dn + dr) ** -0.5
        if rs.get("mscale_all_dim"):
            f = float(rs.get("factor", 1.0))
            m = 0.1 * float(rs["mscale_all_dim"]) * math.log(f) + 1.0 if f > 1 else 1.0
            scale = scale * m * m
        base = dataclasses.replace(
            base, mla_kv_lora=r, mla_rope_dim=dr, mla_nope_dim=dn,
            mla_v_dim=text_cfg["v_head_dim"],
            mla_rope_interleave=bool(text_cfg.get("rope_interleave", True)),
            mla_softmax_scale=scale, n_kv_heads=1, head_dim=r + dr, rope_head_dim=dr)
    return base


def convert_deepseek_weights(store: WeightStore, cfg, text_cfg: dict, prefix: str = "model.",
                             lm_head_name: str = "lm_head") -> dict:
    """HF DeepSeek names -> the decoder's weight dict: MLA or fused-qkv
    attention, a dense MLP in the first first_k_dense_replace layers, then
    the router (with its correction bias under group-limited routing, zeros
    where the checkpoint has none), the experts stacked (E, in, out) and the
    shared experts as gate_up / down."""
    first_dense = text_cfg.get("first_k_dense_replace", 0)
    n_shared = text_cfg.get("n_shared_experts", 0) or 0
    w = {"embed": store.get(f"{prefix}embed_tokens.weight"), "layers": []}
    for layer in range(cfg.n_layers):
        p = f"{prefix}layers.{layer}."
        if cfg.mla_kv_lora > 0:
            lw = _mla_attention_weights(store, cfg, p)
        else:
            lw = {"qkv_proj": store.fused_linear([p + "self_attn.q_proj", p + "self_attn.k_proj",
                                                  p + "self_attn.v_proj"]),
                  "o_proj": store.linear(p + "self_attn.o_proj")}
        lw["input_norm"] = store.get(p + "input_layernorm.weight")
        lw["post_norm"] = store.get(p + "post_attention_layernorm.weight")
        if cfg.moe_top_k > 0 and layer >= first_dense:
            lw["moe_router"] = store.linear(p + "mlp.gate")
            if cfg.moe_n_groups > 0:
                bias = p + "mlp.gate.e_score_correction_bias"
                lw["moe_router_bias"] = (store.get(bias) if store.has(bias) else
                                         torch.zeros(cfg.n_experts, dtype=torch.float32,
                                                     device=store.device))
            lw["moe_gate_up"] = torch.stack([
                store.fused_linear([f"{p}mlp.experts.{e}.gate_proj",
                                    f"{p}mlp.experts.{e}.up_proj"])
                for e in range(cfg.n_experts)])
            lw["moe_down"] = torch.stack([store.linear(f"{p}mlp.experts.{e}.down_proj")
                                          for e in range(cfg.n_experts)])
            if n_shared:
                lw["gate_up"] = store.fused_linear([p + "mlp.shared_experts.gate_proj",
                                                    p + "mlp.shared_experts.up_proj"])
                lw["down"] = store.linear(p + "mlp.shared_experts.down_proj")
        else:
            lw["gate_up"] = store.fused_linear([p + "mlp.gate_proj", p + "mlp.up_proj"])
            lw["down"] = store.linear(p + "mlp.down_proj")
        w["layers"].append(lw)
    w["norm"] = store.get(f"{prefix}norm.weight")
    if cfg.tie_word_embeddings or not store.has(lm_head_name + ".weight"):
        w["lm_head"] = w["embed"].t().contiguous()
    else:
        w["lm_head"] = store.linear(lm_head_name)
    return w


def _mla_attention_weights(store: WeightStore, cfg, p: str) -> dict:
    """MLA projections; kv_b (H * (dn + dv), r) split into the absorbed W_UK
    (r, H, dn) and W_UV (r, H, dv)."""
    H, r = cfg.n_qo_heads, cfg.mla_kv_lora
    dn, dv = cfg.mla_nope_dim, cfg.mla_v_dim
    lw = {"kv_a": store.linear(p + "self_attn.kv_a_proj_with_mqa"),
          "kv_a_norm": store.get(p + "self_attn.kv_a_layernorm.weight"),
          "o_proj": store.linear(p + "self_attn.o_proj")}
    if store.has(p + "self_attn.q_a_proj.weight"):
        lw["q_a"] = store.linear(p + "self_attn.q_a_proj")
        lw["q_a_norm"] = store.get(p + "self_attn.q_a_layernorm.weight")
        lw["q_b"] = store.linear(p + "self_attn.q_b_proj")
    else:
        lw["q_proj"] = store.linear(p + "self_attn.q_proj")
    kv_b = store.get(p + "self_attn.kv_b_proj.weight").reshape(H, dn + dv, r).permute(2, 0, 1)
    lw["w_uk"] = kv_b[:, :, :dn].contiguous()
    lw["w_uv"] = kv_b[:, :, dn:].contiguous()
    return lw


def deepseek_language_config(cfg, text_cfg: dict) -> LanguageModelConfig:
    """The node's view of a DeepSeek LM: an MLA model's cache holds one
    plane (the latent vector) a token."""
    return LanguageModelConfig(
        n_layers=cfg.n_layers, max_position_embeddings=cfg.max_position_embeddings,
        n_qo_heads=cfg.n_qo_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        eos_token_id=text_cfg.get("eos_token_id", 1), hidden_size=cfg.hidden_size,
        vocab_size=cfg.vocab_size, kv_single_plane=cfg.mla_kv_lora > 0)


class DeepSeekModelFactory(ModelFactory):
    """Text-only DeepSeek V2/V3 checkpoints, MLA and plain attention alike."""

    def __init__(self, config: ModelFactoryConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        with open(os.path.join(config.path, "config.json")) as f:
            self.hf_cfg = json.load(f)
        self.text_cfg = self.hf_cfg.get("text_config", self.hf_cfg)
        self.decoder_cfg = deepseek_decoder_config(self.text_cfg)
        self._lm = None

    def getLanguageModel(self) -> LlamaForCausalLM:
        if self._lm is None:
            store = WeightStore(self.config.path, self.config.dtype, self.device)
            weights = convert_deepseek_weights(store, self.decoder_cfg, self.text_cfg)
            kv_scale = (self.config.kv_scale if self.config.kv_cache_dtype == "int8"
                        else None)
            self._lm = LlamaForCausalLM(weights, self.decoder_cfg, self.config.quantization,
                                        kv_scale=kv_scale)
        return self._lm

    def getVisionModel(self):
        return None

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        return deepseek_language_config(self.decoder_cfg, self.text_cfg)

    def getTokenizer(self) -> HFTokenizerAdapter:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(AutoTokenizer.from_pretrained(self.config.path))
