"""Model contracts (port of hydrainfer_tpu/models/factory.py).

The LanguageModelBatch holds one fill step's device tensors, all padded to
shape buckets. The host packs every int32 field into ONE flat buffer
(`pack_fill_batch`), so a step costs a single host-to-device copy, and the
device side slices it back (`unpack_fill_batch`), gathering the step's image
features from the image cache on the way. The layout is the JAX buffer's: the
core fields, the image slots and destinations (Ti each), the M-RoPE h/w
streams (2 * T) when the model uses M-RoPE, the speculative-verify draft
lengths (S) when the step verifies drafts (`dims.spec > 0`), and the sampling
controls when a sequence samples (`dims.sampling`): temperatures (S, f32
bitcast), top-k (S), top-p (S, f32 bitcast) and a seed (1).
"""
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import PagedAttentionParams


class ImageTokenCalculator:
    """Number of feature tokens the vision tower emits for an image size."""

    def get_num_image_tokens(self, image_size: Tuple[int, int]) -> int:
        raise NotImplementedError

    def get_image_grid(self, image_size: Tuple[int, int]):
        """Merged-token grid (t, h, w) for M-RoPE positions; None for models
        whose rope is 1D."""
        return None


@dataclass
class VisionModelConfig:
    image_token: str                      # e.g. "<image>"
    image_token_id: int
    image_token_calculator: ImageTokenCalculator


@dataclass
class LanguageModelConfig:
    n_layers: int
    max_position_embeddings: int
    n_qo_heads: int
    n_kv_heads: int
    head_dim: int
    eos_token_id: int
    hidden_size: int = 0
    vocab_size: int = 0
    # multimodal RoPE sections (t, h, w); non-empty turns on the per-batch
    # h/w position streams end to end (Qwen2-VL M-RoPE)
    mrope_section: tuple = ()
    # the KV cache holds one plane per token (the MLA latent vector) instead
    # of interleaved K/V heads
    kv_single_plane: bool = False
    # the model decodes greedily only (GPT-2): a request with temperature > 0
    # is refused at the node
    greedy_only: bool = False


@dataclass
class VisionModelParameters:
    return_last_layer_attention: bool = False
    original_image_sizes: Optional[List[Tuple[int, int]]] = None


@dataclass
class VisionModelOutput:
    image_features: Optional[torch.Tensor] = None  # (n_images, n_tokens, lm_hidden)
    scores: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class LanguageModelBatch:
    """One fill step's device-side inputs (all padded to shape buckets).

    token_ids:        (T,) int32; image positions carry the image token id
    positions:        (T,) int32 rope position (the t stream under M-RoPE)
    attention:        PagedAttentionParams for every layer
    sample_token_idx: (S,) int32 flat-token index whose logits are sampled
                      per sequence; -1 = this slot samples nothing
    token_src_slots:  (T,) int32 device token-table slot to read this token
                      from (-1 = token_ids already holds it): the async-decode
                      feedback path
    sample_dst_slots: (S,) int32 token-table slot receiving the sampled
                      token (-1 = discard)
    image_features:   (Ti, hidden) features to splice into the embeddings, or
                      None
    image_dst_idx:    (Ti,) int32 flat-token index each feature overwrites;
                      -1 = padding
    positions_hw:     (2, T) int32 h/w position streams of M-RoPE, or None
    draft_lens:       (S,) int32 real draft length per sequence of a
                      speculative-verify step, or None
    temperatures, top_ks, top_ps: (S,) sampling controls (f32, int32, f32),
                      or None when no sequence samples
    sample_seed:      (1,) int32 the builder's seed (the JAX layout's; the
                      port draws from the executor's generator instead)
    """
    token_ids: torch.Tensor
    positions: torch.Tensor
    attention: PagedAttentionParams
    sample_token_idx: torch.Tensor
    token_src_slots: torch.Tensor
    sample_dst_slots: torch.Tensor
    image_features: Optional[torch.Tensor] = None
    image_dst_idx: Optional[torch.Tensor] = None
    positions_hw: Optional[torch.Tensor] = None
    draft_lens: Optional[torch.Tensor] = None
    temperatures: Optional[torch.Tensor] = None
    top_ks: Optional[torch.Tensor] = None
    top_ps: Optional[torch.Tensor] = None
    sample_seed: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "LanguageModelBatch":
        return replace(self, **kw)


@dataclass
class LanguageModelOutput:
    sample_token_ids: Optional[torch.Tensor] = None   # (n_steps * S,) int32
    # `forward` returns the cache and the token table it updated in place,
    # where the JAX model returns their donated successors
    cache: Optional[torch.Tensor] = None
    token_table: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class FillDims:
    """Static shape key of one fill batch; with the window's n_steps, the
    key of its step graph (models/step_graphs.py)."""
    T: int          # padded token count
    S: int          # padded sequence count
    MB: int         # padded blocks-per-seq
    max_q: int = 1  # padded longest q chunk
    Ti: int = 0     # padded image-feature token count
    mrope: bool = False  # the buffer carries the (2, T) M-RoPE h/w tail
    # a sequence samples (temperature > 0): the step runs the sampling chain
    # and the buffer carries the sampling tail
    sampling: bool = False
    # speculative-verify segment length (1 + K_draft); 0 = a normal step. The
    # buffer carries the (S,) draft lengths after the M-RoPE tail
    spec: int = 0


def pack_fill_batch(token_ids, positions, q_seq_ids, q_local_ids,
                    new_kv_slot_ids, token_src_slots, kv_lens,
                    sample_token_idx, sample_dst_slots, block_tables,
                    cu_q_lens, num_seqs, image_slot_ids=(), image_dst_idx=(),
                    positions_hw=None) -> np.ndarray:
    """Host side: concatenate every int32 field into ONE flat buffer."""
    parts = [token_ids, positions, q_seq_ids, q_local_ids, new_kv_slot_ids,
             token_src_slots, kv_lens, sample_token_idx, sample_dst_slots,
             np.asarray(block_tables).reshape(-1), cu_q_lens, num_seqs,
             image_slot_ids, image_dst_idx]
    if positions_hw is not None:
        parts.append(np.asarray(positions_hw).reshape(-1))
    return np.concatenate([np.asarray(p, np.int32) for p in parts])


def fill_sizes(dims: FillDims) -> List[int]:
    """Lengths of the flat buffer's fields, in order; their sum is the
    buffer's length for `dims`."""
    T, S, MB, Ti = dims.T, dims.S, dims.MB, dims.Ti
    return ([T, T, T, T, T, T, S, S, S, S * MB, S + 1, 1, Ti, Ti]
            + ([2 * T] if dims.mrope else []) + ([S] if dims.spec > 0 else [])
            + ([S, S, S, 1] if dims.sampling else []))


def unpack_fill_batch(flat: torch.Tensor, dims: FillDims,
                      image_cache: Optional[torch.Tensor] = None,
                      hidden: int = 0) -> LanguageModelBatch:
    """Device side: slice the flat buffer back into the batch (views, no
    copy) and gather this step's image features from the image cache
    (n_layers=1, 1, n_blocks, block_size, n_heads, head_dim): each feature
    row spans one slot's n_heads * head_dim values, cut to `hidden`."""
    T, S, MB, Ti = dims.T, dims.S, dims.MB, dims.Ti
    sizes = fill_sizes(dims)
    parts = torch.split(flat[:sum(sizes)], sizes)
    (token_ids, positions, q_seq_ids, q_local_ids, new_kv_slot_ids,
     token_src_slots, kv_lens, sample_token_idx, sample_dst_slots, tables,
     cu_q_lens, num_seqs, image_slot_ids, image_dst_idx) = parts[:14]
    feats = dst = None
    if Ti > 0:
        rows = image_cache[0, 0].reshape(-1, image_cache.shape[-2] * image_cache.shape[-1])
        # padded slots (-1) read row 0; their destination is -1, so the
        # decoder drops them
        feats = rows[image_slot_ids.clamp(min=0).long()][:, :hidden]
        dst = image_dst_idx
    tails = list(parts[14:])
    hw = tails.pop(0).reshape(2, T) if dims.mrope else None
    draft_lens = tails.pop(0) if dims.spec > 0 else None
    temps = top_ks = top_ps = seed = None
    if dims.sampling:
        temps, top_ks, top_ps, seed = tails
        temps, top_ps = temps.view(torch.float32), top_ps.view(torch.float32)
    return LanguageModelBatch(
        token_ids=token_ids,
        positions=positions,
        attention=PagedAttentionParams(
            q_seq_ids=q_seq_ids, q_local_ids=q_local_ids, positions=positions,
            kv_lens=kv_lens, block_tables=tables.reshape(S, MB),
            new_kv_slot_ids=new_kv_slot_ids, cu_q_lens=cu_q_lens,
            num_seqs=num_seqs),
        sample_token_idx=sample_token_idx,
        token_src_slots=token_src_slots,
        sample_dst_slots=sample_dst_slots,
        image_features=feats,
        image_dst_idx=dst,
        positions_hw=hw,
        draft_lens=draft_lens,
        temperatures=temps,
        top_ks=top_ks,
        top_ps=top_ps,
        sample_seed=seed,
    )


# ModelFactoryConfig.dtype names -> torch dtypes ("auto" resolves to bf16)
TORCH_DTYPES = {"auto": torch.bfloat16, "bf16": torch.bfloat16,
                "bfloat16": torch.bfloat16, "float32": torch.float32,
                "f32": torch.float32, "fp32": torch.float32,
                "fp16": torch.float16, "float16": torch.float16}


@dataclass
class ModelFactoryConfig:
    """Which model a node serves and how its factory loads it
    (`getModelFactory`)."""
    path: str = ""                  # HF checkpoint directory
    # "fake" = the weightless test factory; "random:<arch>" = seeded random
    # weights at a models/random_init.py architecture
    name: str = ""
    dtype: str = "auto"             # auto (= bf16) | bf16 | fp32 | fp16
    # TPU-only (cluster/node.py:TPU_ONLY_FIELDS): the JAX package's attention
    # implementation and layer-loop strategy; the port has one of each
    attention_impl: str = "auto"
    layer_loop: str = "auto"
    quantization: str = "none"      # weight-only: none | int8 | int4 | fp8
    kv_cache_dtype: str = "auto"    # auto (= model dtype) | int8
    kv_scale: float = 0.05          # static scale of an int8 KV cache


class VisionModel:
    # Contract: a model that sets `fixed_resolution = True` (models/llava.py)
    # takes every image as the same (3, H, W) tensor and MUST ignore
    # params.original_image_sizes. The encode executor may then run its
    # tower in layer segments across steps (the chunked encode, which
    # passes no sizes). The JAX executor also pads such batches to a
    # power-of-two image count to bound its jit keys; the port runs eagerly
    # and pads nothing.
    fixed_resolution: bool = False

    def forward(self, pixel_values: torch.Tensor,
                params: VisionModelParameters) -> VisionModelOutput:
        raise NotImplementedError


class LanguageModel:
    # True when forward_flat accepts n_steps > 1 (the fused decode window)
    supports_multi_step: bool = False

    def forward(self, cache: torch.Tensor, token_table: torch.Tensor,
                batch: LanguageModelBatch, max_q: int) -> LanguageModelOutput:
        raise NotImplementedError

    def forward_flat(self, cache: torch.Tensor, token_table: torch.Tensor,
                     flat: torch.Tensor, dims: FillDims, n_steps: int = 1,
                     fused_k=None, image_cache=None, graphs=None,
                     generator=None) -> LanguageModelOutput:
        raise NotImplementedError


class Tokenizer:
    def encode(self, prompt: str) -> List[int]:
        raise NotImplementedError

    def decode(self, token_id: int) -> str:
        raise NotImplementedError

    def decode_ids(self, token_ids: List[int]) -> str:
        return "".join(self.decode(t) for t in token_ids)

    def apply_chat_template(self, messages: List[dict]) -> str:
        raise NotImplementedError


class ImageProcessor:
    def process(self, image) -> np.ndarray:
        raise NotImplementedError


@dataclass
class ModelParamsCount:
    vision_model_params: int
    language_model_params: int


def count_elements(tree) -> int:
    """Elements of a weight tree as stored: tensors, a QuantizedTensor's
    values and scales (a packed int4 tensor counts its bytes, as JAX's
    tree_leaves do), through dicts, lists and tuples; None counts nothing."""
    if isinstance(tree, dict):
        return sum(count_elements(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_elements(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if hasattr(tree, "q") and hasattr(tree, "scale"):        # QuantizedTensor
        return tree.q.numel() + tree.scale.numel()
    return 0


class ModelFactory:
    def getVisionModel(self) -> VisionModel:
        raise NotImplementedError

    def getLanguageModel(self) -> LanguageModel:
        raise NotImplementedError

    def getVisionModelConfig(self) -> Optional[VisionModelConfig]:
        """None for text-only factories."""
        return None

    def getLanguageModelConfig(self) -> LanguageModelConfig:
        raise NotImplementedError

    def getProcessor(self) -> Optional[ImageProcessor]:
        return None

    def getTokenizer(self) -> Tokenizer:
        raise NotImplementedError

    def getModelParamsCount(self) -> ModelParamsCount:
        """Elements of the vision and the language weight trees as stored
        (count_elements): a quantized model counts its stored values and
        scales. Builds the models if they are not built yet."""
        vm = getattr(self.getVisionModel(), "weights", {})
        lm = getattr(self.getLanguageModel(), "weights", {})
        return ModelParamsCount(count_elements(vm), count_elements(lm))


def getModelFactory(config: ModelFactoryConfig, device=None) -> ModelFactory:
    """The factory `config` names (port of the JAX package's getModelFactory),
    on `device` (the card unless "cpu" is asked for):
      - name "random:<arch>[+mm]": RandomWeightFactory at that architecture,
        with the config's dtype, quantization and KV scale; "+mm" adds a
        random CLIP tower and the LLaVA projector (CLIP-L/14-336, or
        CLIP_TINY for an arch whose name contains "tiny");
      - name "fake", or no path: FakeModelFactory;
      - a checkpoint directory whose config.json names
        LlavaForConditionalGeneration: LlavaModelFactory;
        LlavaNextForConditionalGeneration: LlavaNextModelFactory; Qwen2-VL:
        Qwen2VLModelFactory; InternVLChatModel or model_type "internvl":
        InternVLModelFactory; model_type "deepseek_vl_v2":
        DeepSeekVL2ModelFactory; model_type "deepseek_v2" / "deepseek_v3" or
        a DeepSeek causal-LM architecture: DeepSeekModelFactory;
        MixtralForCausalLM: MixtralModelFactory; GPT2LMHeadModel:
        GPT2ModelFactory; LlamaForCausalLM or Qwen2ForCausalLM:
        TextOnlyModelFactory (the JAX package's order).
    Every other architecture raises, as in the JAX package. dtype "auto"
    becomes bf16, as in the JAX package."""
    import json
    import os
    if config.dtype == "auto":
        config.dtype = "bf16"
    if config.name.startswith("random:"):
        from .random_init import CLIP_TINY, RandomWeightFactory
        spec = config.name[len("random:"):]
        multimodal = spec.endswith("+mm")
        arch = spec[:-len("+mm")] if multimodal else spec
        return RandomWeightFactory(
            arch, dtype=TORCH_DTYPES[config.dtype], quantization=config.quantization,
            kv_scale=config.kv_scale if config.kv_cache_dtype == "int8" else None,
            device=device, multimodal=multimodal,
            clip_cfg=CLIP_TINY if "tiny" in arch else None)
    if config.name == "fake" or not config.path:
        from .fake import FakeModelFactory
        return FakeModelFactory(config, device=device)
    if not os.path.isdir(config.path):
        # an "org/name" repository id downloads where HYDRAINFER_ALLOW_DOWNLOAD=1
        from .downloader import ensure_local_model
        config.path = ensure_local_model(config.path)
    if not os.path.isdir(config.path):
        raise FileNotFoundError(
            f"no checkpoint directory at {config.path!r} (a Hugging Face "
            "repository id downloads only with HYDRAINFER_ALLOW_DOWNLOAD=1)")
    with open(os.path.join(config.path, "config.json"), encoding="utf-8") as f:
        json_config = json.load(f)
    architecture = (json_config.get("architectures") or [None])[0]
    model_type = json_config.get("model_type")
    if architecture == "LlavaForConditionalGeneration":
        from .llava import LlavaModelFactory
        return LlavaModelFactory(config, device=device)
    if architecture == "LlavaNextForConditionalGeneration":
        from .llavanext import LlavaNextModelFactory
        return LlavaNextModelFactory(config, device=device)
    if architecture == "Qwen2VLForConditionalGeneration" or model_type == "qwen2_vl":
        from .qwen2_vl import Qwen2VLModelFactory
        return Qwen2VLModelFactory(config, device=device)
    if architecture == "InternVLChatModel" or model_type == "internvl":
        from .internvl import InternVLModelFactory
        return InternVLModelFactory(config, device=device)
    if model_type == "deepseek_vl_v2":
        from .deepseek_vl2 import DeepSeekVL2ModelFactory
        return DeepSeekVL2ModelFactory(config, device=device)
    if model_type in ("deepseek_v2", "deepseek_v3") or architecture in (
            "DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM", "DeepseekForCausalLM"):
        from .deepseek_v3 import DeepSeekModelFactory
        return DeepSeekModelFactory(config, device=device)
    if architecture == "MixtralForCausalLM":
        from .mixtral import MixtralModelFactory
        return MixtralModelFactory(config, device=device)
    if architecture == "GPT2LMHeadModel":
        from .gpt2 import GPT2ModelFactory
        return GPT2ModelFactory(config, device=device)
    if architecture in ("LlamaForCausalLM", "Qwen2ForCausalLM"):
        from .text_only import TextOnlyModelFactory
        return TextOnlyModelFactory(config, device=device)
    raise ValueError(f"unsupported architecture {architecture} / model_type "
                     f"{model_type}: not ported (no queue item yet)")
