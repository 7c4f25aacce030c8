"""The port's InternVL2 path against the JAX package and HF, on the CPU.

A tiny HF-native InternVL checkpoint (model_type "internvl") is built in
process with transformers: InternViT 2 layers x 64 wide, 4 heads, 56-pixel
tiles of 14-pixel patches with qkv biases and layer scales, the pixel
shuffle at 0.5 (4 tokens a tile), the projector, and a 2-layer Llama 48 wide
(GQA 2:1); image token 60. From it an original-layout InternVLChatModel
checkpoint is written with the same weights: vision_model.* with fused qkv,
mlp1.*, and an InternLM2 language model whose wqkv rows are grouped per kv
head. A third, synthetic original-layout tower carries InternViT-6B's
qk-norm and RMS norms. Both packages load each through getModelFactory(path).

Held against JAX in f32 within 1e-4: the tower's features (both layouts,
the qk-norm one, the weight-bridged JAX tower), the pixel shuffle, and the
dynamic tiling, processor and token calculator (exact; the sizes the card
phase serves included); against HF's get_image_features within the JAX
test's 3e-3. The wqkv unpacking equals assembling q, k and v apart
(tests/models/test_internvl_vs_hf.py's case), and the two layouts give the
same features and LM weights exactly. With bf16 weights the port's bf16
tower is held beside JAX's f32-promoting one. The gate: the port's EPD
OfflineEngine gives the JAX engine's greedy tokens (an image request of 7
tiles, 28 image tokens, over a 16-token budget, and a text request; K = 1
and 4; f32 and int8 weights with an int8 KV cache; both layouts; the JAX
engine serves each layout and format once, at K = 1).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.profiler import \
    BatchSchedulerProfilerConfig as JaxProfilerConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import VisionModelParameters as JaxVMP  # noqa: E402
from hydrainfer_tpu.models import internvl as jax_ivl  # noqa: E402
from hydrainfer_tpu.models.decoder import DecoderConfig as JaxDecoderConfig  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.models.weight_loader import WeightStore as JaxWeightStore  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import internvl  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import DecoderConfig  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (ModelFactoryConfig,  # noqa: E402
                                                 VisionModelParameters, getModelFactory)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_vision_numpy  # noqa: E402
from hydrainfer_tpu_torch.models.weight_loader import WeightStore  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402

VOCAB = 64
IMAGE_ID = 60
TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=3e-3, atol=3e-3)
# the internvl card phase's sizes: (h, w) -> (tiles, image tokens) at 448
# pixels, max_dynamic_patch 12, the thumbnail, 256 tokens a tile
CARD_SIZES = [((448, 448), 1, 256), ((448, 896), 3, 768), ((896, 1344), 7, 1792),
              ((480, 640), 13, 3328)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_internvl")
    cfg = transformers.InternVLConfig(
        vision_config=dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, image_size=[56, 56], patch_size=[14, 14],
                           use_qkv_bias=True, attention_bias=True),
        text_config=dict(model_type="llama", vocab_size=VOCAB, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=256),
        image_token_id=IMAGE_ID, downsample_ratio=0.5, vision_feature_layer=-1,
        vision_feature_select_strategy="default")
    torch.manual_seed(0)
    model = transformers.InternVLForConditionalGeneration(cfg).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def _original_tensors(native: dict, n_vit_layers: int, n_lm_layers: int, r: int, kv: int):
    """The HF-native tensors under the original InternVLChatModel names:
    the tower's q, k, v fused into attn.qkv, the projector as mlp1, and the
    Llama LM as InternLM2 (wqkv grouped per kv head as [q_0 .. q_{r-1}, k,
    v], w1 / w3 / w2, tok_embeddings, output)."""
    nv, v = "model.vision_tower.", "vision_model."
    out = {v + "embeddings.patch_embedding.weight":
           native[nv + "embeddings.patch_embeddings.projection.weight"],
           v + "embeddings.patch_embedding.bias":
           native[nv + "embeddings.patch_embeddings.projection.bias"],
           v + "embeddings.class_embedding": native[nv + "embeddings.cls_token"],
           v + "embeddings.position_embedding": native[nv + "embeddings.position_embeddings"]}
    for i in range(n_vit_layers):
        a, b = f"{nv}encoder.layer.{i}.", f"{v}encoder.layers.{i}."
        for part in ("weight", "bias"):
            out[b + f"attn.qkv.{part}"] = np.concatenate(
                [native[a + f"attention.{x}_proj.{part}"] for x in "qkv"])
            out[b + f"attn.proj.{part}"] = native[a + f"attention.projection_layer.{part}"]
            out[b + f"norm1.{part}"] = native[a + f"layernorm_before.{part}"]
            out[b + f"norm2.{part}"] = native[a + f"layernorm_after.{part}"]
            for fc in ("fc1", "fc2"):
                out[b + f"mlp.{fc}.{part}"] = native[a + f"mlp.{fc}.{part}"]
        out[b + "ls1"], out[b + "ls2"] = native[a + "lambda_1"], native[a + "lambda_2"]
    for j, name in ((0, "layer_norm"), (1, "linear_1"), (3, "linear_2")):
        for part in ("weight", "bias"):
            out[f"mlp1.{j}.{part}"] = native[f"model.multi_modal_projector.{name}.{part}"]
    nl, lm = "model.language_model.", "language_model.model."
    out[lm + "tok_embeddings.weight"] = native[nl + "embed_tokens.weight"]
    out[lm + "norm.weight"] = native[nl + "norm.weight"]
    out["language_model.output.weight"] = native["lm_head.weight"]
    for i in range(n_lm_layers):
        a, b = f"{nl}layers.{i}.", f"{lm}layers.{i}."
        q = native[a + "self_attn.q_proj.weight"]
        hid = q.shape[1]
        q = q.reshape(kv, r, -1, hid)
        k = native[a + "self_attn.k_proj.weight"].reshape(kv, 1, -1, hid)
        vv = native[a + "self_attn.v_proj.weight"].reshape(kv, 1, -1, hid)
        out[b + "attention.wqkv.weight"] = np.concatenate([q, k, vv], axis=1).reshape(-1, hid)
        out[b + "attention.wo.weight"] = native[a + "self_attn.o_proj.weight"]
        out[b + "feed_forward.w1.weight"] = native[a + "mlp.gate_proj.weight"]
        out[b + "feed_forward.w3.weight"] = native[a + "mlp.up_proj.weight"]
        out[b + "feed_forward.w2.weight"] = native[a + "mlp.down_proj.weight"]
        out[b + "attention_norm.weight"] = native[a + "input_layernorm.weight"]
        out[b + "ffn_norm.weight"] = native[a + "post_attention_layernorm.weight"]
    return {k: np.ascontiguousarray(x) for k, x in out.items()}


def _write_original(path, tensors, qk_norm=False, rms=False):
    cfg = {"architectures": ["InternVLChatModel"], "model_type": "internvl_chat",
           "downsample_ratio": 0.5, "image_token_id": IMAGE_ID, "max_dynamic_patch": 12,
           "use_thumbnail": True,
           "vision_config": {"hidden_size": 64, "intermediate_size": 128,
                             "num_hidden_layers": 2, "num_attention_heads": 4,
                             "image_size": 56, "patch_size": 14,
                             "qk_normalization": qk_norm,
                             "norm_type": "rms_norm" if rms else "layer_norm"},
           "llm_config": {"architectures": ["InternLM2ForCausalLM"], "model_type": "internlm2",
                          "vocab_size": VOCAB, "hidden_size": 48, "intermediate_size": 96,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "num_key_value_heads": 2, "max_position_embeddings": 256,
                          "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "bias": False,
                          "eos_token_id": 2}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    safetensors_numpy.save_file(tensors, os.path.join(path, "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def orig_ckpt(ckpt, tmp_path_factory):
    native = {k: v.numpy() for k, v in ckpt[1].state_dict().items()}
    return _write_original(tmp_path_factory.mktemp("tiny_internvl_orig"),
                           _original_tensors(native, 2, 2, r=2, kv=2))


@pytest.fixture(scope="module")
def qknorm_ckpt(orig_ckpt, tmp_path_factory):
    """The original layout with InternViT-6B's options: qk-norm weights
    and RMS norms (no norm biases)."""
    rng = np.random.default_rng(4)
    tensors = dict(safetensors_numpy.load_file(os.path.join(orig_ckpt, "model.safetensors")))
    for i in range(2):
        p = f"vision_model.encoder.layers.{i}."
        for n in ("norm1", "norm2"):
            del tensors[p + n + ".bias"]
            tensors[p + n + ".weight"] = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
        for n in ("q_norm", "k_norm"):
            tensors[p + f"attn.{n}.weight"] = (
                1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    return _write_original(tmp_path_factory.mktemp("tiny_internvl_qknorm"), tensors,
                           qk_norm=True, rms=True)


def factories(path, quant="none", kv_int8=False, dtype=("float32", "fp32")):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype=dtype[0], attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype=dtype[1], quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_ivl.InternVLModelFactory)
    assert isinstance(pf, internvl.InternVLModelFactory)
    return jf, pf


def image(h, w, seed=9):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def tiles(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3, 56, 56)).astype(np.float32)


def _features(factory, px, jax_side=False):
    vm = factory.getVisionModel()
    if jax_side:
        return np.asarray(vm.forward(jnp.asarray(px), JaxVMP()).image_features)
    return vm.forward(px, VisionModelParameters()).image_features.numpy()


def test_vision_features_match_jax_and_hf(ckpt):
    path, hf = ckpt
    jf, pf = factories(path)
    assert pf.hf_style and pf.lm_type == "llama"
    assert pf.vit_cfg.__dict__ == jf.vit_cfg.__dict__
    px = tiles(3, seed=0)
    got = _features(pf, px)
    assert got.shape == (1, 12, 48)
    np.testing.assert_allclose(got, _features(jf, px, True), **TOL)
    with torch.no_grad():
        hf_feats = hf.model.get_image_features(pixel_values=torch.tensor(px)).numpy()
    np.testing.assert_allclose(got[0], hf_feats.reshape(12, 48), **HF_TOL)


@pytest.mark.parametrize("side", [4, 8])
def test_pixel_shuffle_matches_jax(side):
    feats = np.random.default_rng(side).standard_normal((3, side * side, 10)).astype(np.float32)
    got = internvl.pixel_shuffle_downsample(torch.from_numpy(feats), side, 0.5)
    ref = np.asarray(jax_ivl.pixel_shuffle_downsample(jnp.asarray(feats), side, 0.5))
    assert got.shape == ref.shape == (3, side * side // 4, 40)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw", [(56, 112), (50, 50), (112, 56), (112, 168), (100, 300),
                                (61, 61), (200, 90)])
def test_dynamic_tiling_processor_and_calculator_match_jax(ckpt, hw):
    jf, pf = factories(ckpt[0])
    img = image(*hw, seed=hw[1])
    got = pf.getProcessor().process(img)
    np.testing.assert_array_equal(got, np.asarray(jf.getProcessor().process(img)))
    pcalc = pf.getVisionModelConfig().image_token_calculator
    jcalc = jf.getVisionModelConfig().image_token_calculator
    assert got.shape == (pcalc.n_tiles(hw), 3, 56, 56)
    assert pcalc.n_tiles(hw) == jcalc.n_tiles(hw)
    assert pcalc.get_num_image_tokens(hw) == jcalc.get_num_image_tokens(hw) \
        == 4 * pcalc.n_tiles(hw)
    pv, jv = pf.getVisionModelConfig(), jf.getVisionModelConfig()
    assert (pv.image_token, pv.image_token_id) == (jv.image_token, jv.image_token_id) \
        == ("<image>", IMAGE_ID)
    ratios = internvl._tile_ratios(1, 12)
    assert (internvl.find_closest_aspect_ratio(hw[1] / hw[0], ratios, hw[1], hw[0], 56)
            == jax_ivl.find_closest_aspect_ratio(hw[1] / hw[0], ratios, hw[1], hw[0], 56))


@pytest.mark.parametrize("hw,n_tiles,n_tokens", CARD_SIZES)
def test_card_sizes(hw, n_tiles, n_tokens):
    calc = internvl.InternVLImageTokenCalculator(256, 448, 12, True)
    ref = jax_ivl.InternVLImageTokenCalculator(256, 448, 12, True)
    assert calc.n_tiles(hw) == ref.n_tiles(hw) == n_tiles
    assert calc.get_num_image_tokens(hw) == ref.get_num_image_tokens(hw) == n_tokens
    assert internvl.InternVLImageProcessorAdapter(448, 12).process(
        image(*hw)).shape == (n_tiles, 3, 448, 448)


def test_internlm2_wqkv_conversion(tmp_path):
    """tests/models/test_internvl_vs_hf.py's case: the fused-wqkv unpacking
    gives the fused qkv matmul of q, k and v assembled apart, as JAX's."""
    rng = np.random.default_rng(3)
    hid, kv, r, D = 32, 2, 2, 8   # 4 q heads, 2 kv heads
    kw = dict(n_layers=1, hidden_size=hid, intermediate_size=64, n_qo_heads=kv * r,
              n_kv_heads=kv, head_dim=D, vocab_size=50, max_position_embeddings=64)
    q = rng.standard_normal((kv, r, D, hid)).astype(np.float32)
    k = rng.standard_normal((kv, 1, D, hid)).astype(np.float32)
    v = rng.standard_normal((kv, 1, D, hid)).astype(np.float32)
    wqkv = np.concatenate([q, k, v], axis=1).reshape((r + 2) * kv * D, hid)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    p = "language_model.model.layers.0."
    tensors = {"language_model.model.tok_embeddings.weight": f(50, hid),
               p + "attention.wqkv.weight": wqkv, p + "attention.wo.weight": f(hid, kv * r * D),
               p + "feed_forward.w1.weight": f(64, hid), p + "feed_forward.w3.weight": f(64, hid),
               p + "feed_forward.w2.weight": f(hid, 64),
               p + "attention_norm.weight": np.ones(hid, np.float32),
               p + "ffn_norm.weight": np.ones(hid, np.float32),
               "language_model.model.norm.weight": np.ones(hid, np.float32),
               "language_model.output.weight": f(50, hid)}
    safetensors_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    w = internvl.convert_internlm2_weights(WeightStore(str(tmp_path), device="cpu"),
                                           DecoderConfig(**kw), "language_model.")
    expected = np.concatenate([q.reshape(kv * r * D, hid), k.reshape(kv * D, hid),
                               v.reshape(kv * D, hid)]).T
    np.testing.assert_array_equal(w["layers"][0]["qkv_proj"].numpy(), expected)
    jw = jax_ivl.convert_internlm2_weights(JaxWeightStore(str(tmp_path)),
                                           JaxDecoderConfig(**kw), "language_model.")
    for key in ("qkv_proj", "o_proj", "gate_up", "down", "input_norm", "post_norm"):
        np.testing.assert_array_equal(w["layers"][0][key].numpy(),
                                      np.asarray(jw["layers"][0][key]))
    for key in ("embed", "norm", "lm_head"):
        np.testing.assert_array_equal(w[key].numpy(), np.asarray(jw[key]))


def test_original_layout_loads_the_same_model(ckpt, orig_ckpt):
    """The original InternVLChatModel names (vision_model.*, mlp1.*, an
    InternLM2 LM) give the HF-native checkpoint's features and LM weights
    bit for bit, and JAX's features from the same directory."""
    _, native = factories(ckpt[0])
    jf, orig = factories(orig_ckpt)
    assert not orig.hf_style and orig.lm_type == "internlm2"
    assert orig.decoder_cfg == native.decoder_cfg
    px = tiles(2, seed=3)
    got = _features(orig, px)
    np.testing.assert_array_equal(got, _features(native, px))
    np.testing.assert_allclose(got, _features(jf, px, True), **TOL)
    a, b = orig.getLanguageModel().weights, native.getLanguageModel().weights
    for key in ("embed", "norm", "lm_head"):
        assert torch.equal(a[key], b[key])
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)
    fields = ("n_layers", "max_position_embeddings", "n_qo_heads", "n_kv_heads", "head_dim",
              "eos_token_id", "hidden_size", "vocab_size")
    assert ([getattr(orig.getLanguageModelConfig(), f) for f in fields]
            == [getattr(jf.getLanguageModelConfig(), f) for f in fields])


def test_qk_norm_and_rms_norm_tower_matches_jax(qknorm_ckpt):
    jf, pf = factories(qknorm_ckpt)
    assert pf.vit_cfg.qk_normalization and pf.vit_cfg.norm_type == "rms_norm"
    layer = pf.getVisionModel().weights["vit"]["layers"][0]
    assert layer["norm1"][1] is None and "q_norm" in layer and "k_norm" in layer
    px = tiles(2, seed=8)
    np.testing.assert_allclose(_features(pf, px), _features(jf, px, True), **TOL)


@pytest.mark.parametrize("layout", ["native", "qknorm"])
def test_weight_bridge_carries_the_jax_tower(ckpt, qknorm_ckpt, layout):
    path = ckpt[0] if layout == "native" else qknorm_ckpt
    jf, _ = factories(path)
    jvm = jf.getVisionModel()
    tree = jax.tree_util.tree_map(np.asarray, jvm.weights)
    assert set(tree) == {"vit", "proj_norm", "proj1", "proj2"}
    vm = internvl.InternVLVisionModel(from_jax_vision_numpy(tree, "cpu"), jvm.cfg, 0.5)
    px = tiles(2, seed=6)
    np.testing.assert_allclose(vm.forward(px, VisionModelParameters()).image_features.numpy(),
                               _features(jf, px, True), **TOL)


def test_bf16_vision_tower_gap_to_jax(ckpt, record_property):
    """With bf16 weights the port runs InternViT in bf16 activations, while
    the JAX tower, fed f32 pixels, promotes to f32. The port's bf16 features
    are held to 2e-2 of max |feature| from JAX's bf16-weight tower and from
    the f32 tower. Its distance from the f32 tower is 4.2x JAX's here (the
    bf16 rounding of the activations added to that of the weights; LLaVA's
    CLIP stays under 4x), so no multiple of JAX's distance is held; the
    relative distances are recorded as junit properties."""
    px = tiles(3, seed=11)
    feats = {}
    for dtype in (("float32", "fp32"), ("bfloat16", "bf16")):
        jf, pf = factories(ckpt[0], dtype=dtype)
        feats["jax", dtype[1]] = _features(jf, px, True).astype(np.float32)
        got = pf.getVisionModel().forward(px, VisionModelParameters()).image_features
        feats["port", dtype[1]] = got.float().numpy()
    assert got.dtype == torch.bfloat16
    ref = feats["jax", "fp32"]
    scale = np.abs(ref).max()
    gap = np.abs(feats["port", "bf16"] - feats["jax", "bf16"]).max()
    port_to_f32 = np.abs(feats["port", "bf16"] - ref).max()
    jax_to_f32 = np.abs(feats["jax", "bf16"] - ref).max()
    for name, d in (("port_vs_jax_bf16", gap), ("port_bf16_vs_f32", port_to_f32),
                    ("jax_bf16_vs_f32", jax_to_f32)):
        record_property(name, float(d / scale))
    assert np.isfinite(feats["port", "bf16"]).all()
    assert gap <= 2e-2 * scale
    assert port_to_f32 <= 2e-2 * scale


# ------------------------------------------------------------ engine parity

def _requests(req_cls, sp_cls, max_tokens=8):
    """An image request of 7 tiles (112 x 168: 2 x 3 tiles and the
    thumbnail), 28 image tokens over a budget of 16, and a text request."""
    sp = lambda: sp_cls(max_tokens=max_tokens, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=image(112, 168),
                    sampling_params=sp()),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp())]


def run_jax(factory, k, kv_int8, budget):
    factory.getTokenizer = lambda: JaxTok(image_token="<image>", image_token_id=IMAGE_ID,
                                          eos_token_id=63)
    cfg = JaxNodeConfig(
        profiler=JaxProfilerConfig(enabled=False, default_token_budget=budget),
        batch_scheduler=JaxBSConfig(max_running_requests=2),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=0)
    cfg.model.dtype = "float32"
    cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
    engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="EPD")
    return [o.output_token_ids for o in engine.generate(_requests(JaxRequest, JaxSP),
                                                        timeout_s=600)]


# The JAX engine serves each checkpoint layout and format once a module, at K = 1, and every port
# setting is held to those tokens: the JAX package's own tests hold its
# tokens equal across K (tests/engine/test_multi_step_engine.py).
_JAX_TOKENS = {}


def jax_tokens(key, run):
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = run()
    return _JAX_TOKENS[key]


def run_port(factory, k, budget):
    factory.getTokenizer = lambda: SimpleTokenizer(image_token="<image>",
                                                   image_token_id=IMAGE_ID, eos_token_id=63)
    cfg = NodeConfig(
        profiler=BatchSchedulerProfilerConfig(enabled=False, default_token_budget=budget),
        batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=factory, node_type="EPD", device="cpu")
    outs = engine.generate(_requests(Request, SamplingParameters), timeout_s=600)
    return [o.output_token_ids for o in outs]


@pytest.mark.parametrize("layout", ["native", "original"])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_epd_engine_matches_jax_engine(ckpt, orig_ckpt, layout, quant, kv_int8, k):
    jf, pf = factories(ckpt[0] if layout == "native" else orig_ckpt, quant, kv_int8)
    n_image = pf.getVisionModelConfig().image_token_calculator.get_num_image_tokens((112, 168))
    assert n_image == 28 > 16
    got = run_port(pf, k, 16)
    ref = jax_tokens((layout, quant), lambda: run_jax(jf, 1, kv_int8, 16))
    assert [len(t) for t in got] == [8, 8]
    assert got == ref


def test_over_budget_prompt_equals_the_whole_prompt(ckpt):
    """The 7-tile image prompt prefilled over chunks of 16 tokens gives the
    tokens of its prefill in one step (budget 2048)."""
    _, pf = factories(ckpt[0])
    assert run_port(pf, 4, 16) == run_port(pf, 4, 2048)
