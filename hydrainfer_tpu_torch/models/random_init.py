"""Random weights at real architectures (port of
hydrainfer_tpu/models/random_init.py).

The tensors have the shapes and dtypes of the converted checkpoints, so the
run's cost is that of the real model. Weights come from a seeded
torch.Generator on the target device; with quantization (int8, int4 or fp8)
each layer is quantized as it is built, so the full-precision tree never
exists whole.
A multimodal factory adds a random CLIP tower (CLIP-L/14-336 by default)
with the LLaVA projector to the language model's hidden size.
(torch and jax.random give different numbers from one seed: tests that compare
the two packages carry the JAX weights over with models/weight_bridge.py.)
"""
from typing import Optional

import numpy as np
import torch

from ..ops.quant import quantize_tree
from ..utils.device import resolve_device
from .clip import CLIPVisionConfig
from .decoder import DecoderConfig
from .factory import ImageProcessor, LanguageModelConfig, ModelFactory, VisionModelConfig

# shapes from the HF configs of the models the reference serves
ARCH_CONFIGS = {
    # vicuna-7b inside llava-1.5-7b-hf
    "llava-7b-lm": DecoderConfig(
        n_layers=32, hidden_size=4096, intermediate_size=11008,
        n_qo_heads=32, n_kv_heads=32, head_dim=128, vocab_size=32064,
        max_position_embeddings=4096),
    # vicuna-13b inside llava-v1.6 (LLaVA-NeXT-13B); int8 weights ~13.0 GB
    "llava-13b-lm": DecoderConfig(
        n_layers=40, hidden_size=5120, intermediate_size=13824,
        n_qo_heads=40, n_kv_heads=40, head_dim=128, vocab_size=32064,
        max_position_embeddings=4096),
    # Qwen2-VL-2B language tower (its M-RoPE sections [16, 24, 24] come with
    # the checkpoint's rope_scaling, not with the architecture)
    "qwen2-vl-2b-lm": DecoderConfig(
        n_layers=28, hidden_size=1536, intermediate_size=8960,
        n_qo_heads=12, n_kv_heads=2, head_dim=128, vocab_size=151936,
        max_position_embeddings=32768, qkv_bias=True, rope_theta=1e6,
        tie_word_embeddings=True),
    # CPU-runnable smoke size
    "tiny-lm": DecoderConfig(
        n_layers=2, hidden_size=128, intermediate_size=256,
        n_qo_heads=4, n_kv_heads=2, head_dim=32, vocab_size=1024,
        max_position_embeddings=2048),
    # DeepSeek-V2-Lite-shaped MLA decoder with a dense MLP in place of the
    # MoE body: latent dim 512 + 64 = 576 (head_dim), 16 q heads over one
    # single-plane latent cache
    "mla-2b-lm": DecoderConfig(
        n_layers=27, hidden_size=2048, intermediate_size=5472,
        n_qo_heads=16, n_kv_heads=1, head_dim=576, vocab_size=32064,
        max_position_embeddings=4096, rope_head_dim=64,
        mla_kv_lora=512, mla_rope_dim=64, mla_nope_dim=128, mla_v_dim=128),
    # CPU-runnable MLA smoke size
    "mla-tiny-lm": DecoderConfig(
        n_layers=2, hidden_size=64, intermediate_size=128,
        n_qo_heads=4, n_kv_heads=1, head_dim=24, vocab_size=512,
        max_position_embeddings=1024, rope_head_dim=8,
        mla_kv_lora=16, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16),
}


# LLaVA-1.5's vision tower: CLIP ViT-L/14 at 336 pixels, run to its
# feature layer (23 of 24 layers)
CLIP_L_336 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, n_layers=23,
                              n_heads=16, image_size=336, patch_size=14)
# CPU-runnable tower for multimodal engine tests: a 4 x 4 patch grid, 16
# feature tokens an image
CLIP_TINY = CLIPVisionConfig(hidden_size=64, intermediate_size=128, n_layers=2,
                             n_heads=2, image_size=56, patch_size=14)


def int8_matmul_shapes(cfg: DecoderConfig) -> dict:
    """{name: (K, N)} of the matmuls that int8 quantization (`quantize_tree`'s
    keys) covers: one layer's qkv (not in an MLA layer, whose q and latent
    projections stay bf16), o, gate_up and down, then the lm_head."""
    H = cfg.hidden_size
    shapes = {}
    if cfg.mla_kv_lora > 0:
        o_in = cfg.n_qo_heads * cfg.mla_v_dim
    else:
        o_in = cfg.n_qo_heads * cfg.head_dim
        shapes["qkv"] = (H, (cfg.n_qo_heads + 2 * cfg.n_kv_heads) * cfg.head_dim)
    shapes.update({"o": (o_in, H), "gate_up": (H, 2 * cfg.intermediate_size),
                   "down": (cfg.intermediate_size, H), "lm_head": (H, cfg.vocab_size)})
    return shapes


def quant_matmul_forms(cfg: DecoderConfig, mode: str) -> dict:
    """{name: (K, N, fmt, group)} of int8_matmul_shapes' matmuls as
    quantize_tree stores them in `mode` (int8 | int4 | fp8): int4 at the
    group ops/quant.py:_group_for picks for K (0 = per column), its lm_head
    int8; fp8 per column."""
    from ..ops.quant import GROUP_SIZE, _group_for
    out = {}
    for name, (K, N) in int8_matmul_shapes(cfg).items():
        if mode == "int4" and name != "lm_head":
            out[name] = (K, N, "int4", _group_for(K, GROUP_SIZE))
        else:
            out[name] = (K, N, "fp8" if mode == "fp8" else "int8", 0)
    return out


def quant_weight_bytes(K: int, N: int, fmt: str, group: int = 0) -> int:
    """Bytes of one quantized (K, N) weight as stored: the values (int4 two
    a byte) and the f32 scales, (K / group, N) with a group, else (N,)."""
    values = K * N // 2 if fmt == "int4" else K * N
    return values + 4 * N * (K // group if group else 1)


def _initializer(seed: int, dtype, device):
    """init(*shape): N(0, 0.02^2) values from a generator seeded with `seed`;
    on the "meta" device, shapes and dtypes only."""
    if device.type == "meta":
        return lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def init(*shape):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)
    return init


def init_decoder_weights(cfg: DecoderConfig, seed: int = 0,
                         dtype=torch.bfloat16, quantization: str = "none",
                         device=None) -> dict:
    device = resolve_device(device)
    init = _initializer(seed, dtype, device)

    H = cfg.hidden_size
    qkv_out = (cfg.n_qo_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    w = {"embed": init(cfg.vocab_size, H), "layers": []}
    for _ in range(cfg.n_layers):
        if cfg.mla_kv_lora > 0:
            # MLA attention block, plain-q form (no q-LoRA)
            r, dr = cfg.mla_kv_lora, cfg.mla_rope_dim
            dn, dv, Hq = cfg.mla_nope_dim, cfg.mla_v_dim, cfg.n_qo_heads
            lw = {
                "q_proj": init(H, Hq * (dn + dr)),
                "kv_a": init(H, r + dr),
                "kv_a_norm": torch.ones(r, dtype=dtype, device=device),
                "w_uk": init(r, Hq, dn),
                "w_uv": init(r, Hq, dv),
                "o_proj": init(Hq * dv, H),
            }
        else:
            lw = {
                "qkv_proj": init(H, qkv_out),
                "o_proj": init(cfg.n_qo_heads * cfg.head_dim, H),
            }
            if cfg.qkv_bias:
                lw["qkv_bias"] = torch.zeros(qkv_out, dtype=dtype, device=device)
        lw.update({
            "gate_up": init(H, 2 * cfg.intermediate_size),
            "down": init(cfg.intermediate_size, H),
            "input_norm": torch.ones(H, dtype=dtype, device=device),
            "post_norm": torch.ones(H, dtype=dtype, device=device),
        })
        w["layers"].append(quantize_tree({"layers": [lw]}, quantization)["layers"][0])
    w["norm"] = torch.ones(H, dtype=dtype, device=device)
    w["lm_head"] = init(H, cfg.vocab_size)
    return quantize_tree(w, quantization)


def init_clip_weights(cfg: CLIPVisionConfig, seed: int = 1, dtype=torch.bfloat16,
                      lm_hidden: Optional[int] = None, device=None) -> dict:
    """CLIP tower weights in convert_clip_weights' layout; with lm_hidden,
    {"clip": tower, "proj1", "proj2"}: the LLaVA projector added."""
    device = resolve_device(device)
    init = _initializer(seed, dtype, device)
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    H, M = cfg.hidden_size, cfg.intermediate_size
    w = {"patch_embed": init(3 * cfg.patch_size ** 2, H), "class_embed": init(H),
         "pos_embed": init(cfg.n_patches + 1, H), "pre_norm": (ones(H), zeros(H)),
         "layers": [{"ln1": (ones(H), zeros(H)), "qkv": (init(H, 3 * H), zeros(3 * H)),
                     "out": (init(H, H), zeros(H)), "ln2": (ones(H), zeros(H)),
                     "fc1": (init(H, M), zeros(M)), "fc2": (init(M, H), zeros(H))}
                    for _ in range(cfg.n_layers)]}
    if lm_hidden is None:
        return w
    return {"clip": w, "proj1": (init(H, lm_hidden), zeros(lm_hidden)),
            "proj2": (init(lm_hidden, lm_hidden), zeros(lm_hidden))}


class _RawImageProcessor(ImageProcessor):
    """Resize to the tower's size, CHW, scaled to [0, 1]: (3, size, size)
    float32 numpy."""

    def __init__(self, size: int):
        self.size = size

    def process(self, image) -> np.ndarray:
        return np.asarray(image.convert("RGB").resize((self.size, self.size)),
                          np.float32).transpose(2, 0, 1) / 255.0


class RandomWeightFactory(ModelFactory):
    """ModelFactory over random weights at a named architecture; with
    `multimodal`, a random CLIP tower (`clip_cfg`, CLIP_L_336 by default)
    projected to the LM's hidden size, seeded with seed + 1. `weights` and
    `vision_weights` (e.g. carried over from the JAX package) replace the
    random inits of the LM and of the tower with its projector."""

    def __init__(self, arch: str, dtype=torch.bfloat16, quantization: str = "none",
                 kv_scale: Optional[float] = None, device=None, seed: int = 0,
                 weights: Optional[dict] = None, multimodal: bool = False,
                 clip_cfg: Optional[CLIPVisionConfig] = None,
                 vision_weights: Optional[dict] = None):
        self.cfg = ARCH_CONFIGS[arch]
        self.dtype = dtype
        self.quantization = quantization
        self.kv_scale = kv_scale
        self.device = resolve_device(device)
        self.seed = seed
        self._weights = weights
        self.multimodal = multimodal
        self.clip_cfg = (clip_cfg or CLIP_L_336) if multimodal else None
        self._vision_weights = vision_weights
        self._lm = None
        self._vm = None

    def getLanguageModel(self):
        if self._lm is None:
            from .llama import LlamaForCausalLM
            w = self._weights
            if w is None:
                w = init_decoder_weights(self.cfg, self.seed, self.dtype,
                                         self.quantization, self.device)
            self._lm = LlamaForCausalLM(w, self.cfg, self.quantization,
                                        kv_scale=self.kv_scale)
        return self._lm

    def getVisionModel(self):
        if not self.multimodal:
            return None
        if self._vm is None:
            from .llava import LlavaVisionModel
            w = self._vision_weights
            if w is None:
                w = init_clip_weights(self.clip_cfg, self.seed + 1, self.dtype,
                                      self.cfg.hidden_size, self.device)
            self._vm = LlavaVisionModel(w, self.clip_cfg)
        return self._vm

    def getVisionModelConfig(self) -> Optional[VisionModelConfig]:
        """"<image>" = token 9 of SimpleTokenizer, one feature token a patch;
        None for a text-only factory (no image cache)."""
        if not self.multimodal:
            return None
        from .llava import LlavaImageTokenCalculator
        return VisionModelConfig("<image>", 9,
                                 LlavaImageTokenCalculator(self.clip_cfg.n_patches))

    def getProcessor(self) -> Optional[ImageProcessor]:
        return _RawImageProcessor(self.clip_cfg.image_size) if self.multimodal else None

    def getLanguageModelConfig(self):
        c = self.cfg
        return LanguageModelConfig(
            n_layers=c.n_layers, max_position_embeddings=c.max_position_embeddings,
            n_qo_heads=c.n_qo_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
            eos_token_id=2, hidden_size=c.hidden_size, vocab_size=c.vocab_size,
            mrope_section=c.mrope_section, kv_single_plane=c.mla_kv_lora > 0)

    def getTokenizer(self):
        from .tokenizer import SimpleTokenizer
        return SimpleTokenizer()

    def param_count(self) -> int:
        """The logical, unquantized parameter count of the language model:
        the elements of its bf16 tree, built on the "meta" device (shapes
        only, no weights; JAX's eval_shape), so int4 packing and quantization
        scales do not change it."""
        from .factory import count_elements
        return count_elements(init_decoder_weights(self.cfg, self.seed, torch.bfloat16,
                                                   "none", torch.device("meta")))

    def param_bytes(self) -> int:
        """Bytes of the language model's weights as stored."""
        total = 0
        w = self.getLanguageModel().weights
        leaves = [w["embed"], w["norm"], w["lm_head"]] + [
            v for lw in w["layers"] for v in lw.values()]
        for v in leaves:
            for t in ((v.q, v.scale) if hasattr(v, "q") else (v,)):
                total += t.numel() * t.element_size()
        return total
