"""The port's LLaVA-1.5 path against the JAX package and HF, on the CPU.

A tiny LLaVA checkpoint is built in process with transformers, with the
config of tests/models/test_llava_vs_hf.py (CLIP 3 layers x 32 wide, 2
heads, 28-pixel images of 14-pixel patches; a 2-layer Llama 48 wide; image
token 60; feature layer -2), plus a CLIP image processor at 28 pixels, and
loaded through both packages' getModelFactory(path). Held against JAX in
f32 within 1e-4: the CLIP config and the early exit, the tower's hidden
states and its last layer's probabilities (N, H, L, L), the projected
features, one multimodal prefill's logits (argmax exact); against HF within
the JAX tests' own bounds (features 2e-3, logits 3e-3). Port-only: the
segment API (embed, segments of 1-3 layers, project) equals forward; the
old flat weight names load the same model; with bf16 weights the port's
bf16 tower is held beside JAX's f32-promoting one (the gap is recorded).
`random:tiny-lm+mm`: the JAX random tower carried over through the weight
bridge gives JAX's features, and the port's own init has JAX's tree.
The gate: the port's EPD OfflineEngine gives the JAX engine's greedy tokens
on the tiny LLaVA (an image request and a text request; K = 1 and 4; f32
and int8 weights with an int8 KV cache; chunked encode off and on) and on
tiny-lm + CLIP_TINY with the JAX weights carried over; the JAX engine
serves each model and format once (K = 1, whole encode).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import VisionModelParameters as JaxVMP  # noqa: E402
from hydrainfer_tpu.models import clip as jax_clip  # noqa: E402
from hydrainfer_tpu.models import llava as jax_llava  # noqa: E402
from hydrainfer_tpu.models import random_init as jax_random  # noqa: E402
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxPAP  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import clip, llava  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import decoder_forward  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig,
                                                 VisionModelParameters, getModelFactory)
from hydrainfer_tpu_torch.models.random_init import (CLIP_L_336, CLIP_TINY,  # noqa: E402
                                                     RandomWeightFactory,
                                                     init_clip_weights)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import (from_jax_numpy,  # noqa: E402
                                                       from_jax_vision_numpy)
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402

VOCAB = 64
IMAGE_ID = 60
N_IMAGE_TOKENS = 4          # (28 / 14) ** 2
TOL = dict(rtol=1e-4, atol=1e-4)
HF_FEATURES_TOL = dict(rtol=2e-3, atol=2e-3)
HF_LOGITS_TOL = dict(rtol=3e-3, atol=3e-3)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_llava")
    cfg = transformers.LlavaConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                           num_attention_heads=2, image_size=28, patch_size=14,
                           num_channels=3, hidden_act="quick_gelu"),
        text_config=dict(model_type="llama", vocab_size=VOCAB, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=128),
        image_token_index=IMAGE_ID, vision_feature_layer=-2,
        vision_feature_select_strategy="default")
    torch.manual_seed(0)
    model = transformers.LlavaForConditionalGeneration(cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    transformers.CLIPImageProcessor(size={"shortest_edge": 28},
                                    crop_size={"height": 28, "width": 28}).save_pretrained(path)
    return str(path), model


def factories(path, quant="none", kv_int8=False, dtype=("float32", "fp32")):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype=dtype[0], attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype=dtype[1], quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_llava.LlavaModelFactory)
    assert isinstance(pf, llava.LlavaModelFactory)
    return jf, pf


def pixels(n, seed, size=28):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def image(h, w, seed=9):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("feature_layer", [-2, -1, 2])
def test_clip_config_and_model_configs_match_jax(ckpt, feature_layer):
    hf = ckpt[1].config.vision_config.to_dict()
    assert (clip.clip_config_from_hf(hf, feature_layer).__dict__
            == jax_clip.clip_config_from_hf(hf, feature_layer).__dict__)
    assert clip.clip_config_from_hf(hf, -2).n_layers == 2           # 3 + 1 - 2
    assert CLIP_L_336.__dict__ == jax_random.CLIP_L_336.__dict__
    assert CLIP_TINY.__dict__ == jax_random.CLIP_TINY.__dict__
    jf, pf = factories(ckpt[0])
    jv, pv = jf.getVisionModelConfig(), pf.getVisionModelConfig()
    assert (pv.image_token, pv.image_token_id) == (jv.image_token, jv.image_token_id) \
        == ("<image>", IMAGE_ID)
    assert (pv.image_token_calculator.get_num_image_tokens((28, 28))
            == jv.image_token_calculator.get_num_image_tokens((28, 28)) == N_IMAGE_TOKENS)
    fields = ("n_layers", "max_position_embeddings", "n_qo_heads", "n_kv_heads",
              "head_dim", "eos_token_id", "hidden_size", "vocab_size")
    assert ([getattr(pf.getLanguageModelConfig(), f) for f in fields]
            == [getattr(jf.getLanguageModelConfig(), f) for f in fields])
    assert llava.LLAVA_CHAT_TEMPLATE == jax_llava.LLAVA_CHAT_TEMPLATE


def test_processor_matches_jax(ckpt):
    jf, pf = factories(ckpt[0])
    img = image(40, 50)
    got = pf.getProcessor().process(img)
    assert got.shape == (3, 28, 28) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jf.getProcessor().process(img)))


@pytest.mark.parametrize("n_images", [1, 3])
def test_clip_forward_and_scores_match_jax(ckpt, n_images):
    """The tower's hidden states (the class token included) and its last
    layer's probabilities, (N, H, L, L) as the JAX tower lays them out."""
    jf, pf = factories(ckpt[0])
    jvm, pvm = jf.getVisionModel(), pf.getVisionModel()
    px = pixels(n_images, seed=n_images)
    ref_h, ref_s = jax_clip.clip_forward(jvm.weights["clip"], jnp.asarray(px), jvm.clip_cfg,
                                         return_scores=True)
    got_h, got_s = clip.clip_forward(pvm.weights["clip"], torch.from_numpy(px), pvm.clip_cfg,
                                     return_scores=True)
    assert got_s.shape == (n_images, 2, 5, 5) == ref_s.shape
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), **TOL)
    np.testing.assert_allclose(got_s.sum(-1).numpy(), 1.0, **TOL)
    h, s = clip.clip_forward(pvm.weights["clip"], torch.from_numpy(px), pvm.clip_cfg)
    assert s is None
    np.testing.assert_array_equal(h.numpy(), got_h.numpy())
    out = pvm.forward(px, VisionModelParameters(return_last_layer_attention=True))
    np.testing.assert_array_equal(out.scores.numpy(), got_s.numpy())


def test_vision_features_match_jax_and_hf(ckpt):
    path, hf = ckpt
    jf, pf = factories(path)
    px = pixels(2, seed=0)
    ref = np.asarray(jf.getVisionModel().forward(jnp.asarray(px), JaxVMP()).image_features)
    got = pf.getVisionModel().forward(px, VisionModelParameters()).image_features
    assert got.shape == (2, N_IMAGE_TOKENS, 48)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    with torch.no_grad():
        hf_feats = hf.get_image_features(pixel_values=torch.tensor(px),
                                         vision_feature_layer=-2,
                                         vision_feature_select_strategy="default")
        if isinstance(hf_feats, (list, tuple)):
            hf_feats = (torch.stack(list(hf_feats)) if hf_feats[0].dim() == 2
                        else hf_feats[0])
    np.testing.assert_allclose(got.numpy(), hf_feats.numpy().reshape(2, N_IMAGE_TOKENS, 48),
                               **HF_FEATURES_TOL)


@pytest.mark.parametrize("chunk_layers", [1, 2, 3])
def test_segment_api_equals_forward(ckpt, chunk_layers):
    """embed -> segments of chunk_layers layers -> project is forward."""
    _, pf = factories(ckpt[0])
    vm = pf.getVisionModel()
    assert vm.fixed_resolution
    px = pixels(3, seed=4)
    n_segs = vm.encode_segments(chunk_layers)
    assert n_segs == -(-2 // chunk_layers)
    h = vm.forward_embed(px)
    for seg in range(n_segs):
        h = vm.forward_segment(h, seg, chunk_layers)
    np.testing.assert_array_equal(
        vm.forward_project(h).numpy(),
        vm.forward(px, VisionModelParameters()).image_features.numpy())


def _batches(tokens, dst, feats):
    """One single-sequence prefill of `tokens` for both packages, the
    features spliced at `dst`, on a fresh cache of 4-token blocks."""
    T = len(tokens)
    f = lambda v: np.asarray(v, np.int32)
    core = dict(token_ids=f(tokens), positions=np.arange(T, dtype=np.int32),
                q_seq_ids=np.zeros(T, np.int32), q_local_ids=np.arange(T, dtype=np.int32),
                kv_lens=f([T]), block_tables=np.arange(-(-T // 4), dtype=np.int32)[None],
                new_kv_slot_ids=np.arange(T, dtype=np.int32), cu_q_lens=f([0, T]),
                num_seqs=f([1]), sample_token_idx=f([T - 1]),
                token_src_slots=np.full(T, -1, np.int32), sample_dst_slots=f([-1]))
    attn_keys = ("q_seq_ids", "q_local_ids", "positions", "kv_lens", "block_tables",
                 "new_kv_slot_ids", "cu_q_lens", "num_seqs")
    j = {k: jnp.asarray(v) for k, v in core.items()}
    jb = JaxBatch(token_ids=j["token_ids"], positions=j["positions"],
                  image_features=jnp.asarray(feats), image_dst_idx=jnp.asarray(f(dst)),
                  attention=JaxPAP(**{k: j[k] for k in attn_keys}),
                  sample_token_idx=j["sample_token_idx"],
                  token_src_slots=j["token_src_slots"],
                  sample_dst_slots=j["sample_dst_slots"])
    t = {k: torch.from_numpy(v) for k, v in core.items()}
    pb = LanguageModelBatch(
        token_ids=t["token_ids"], positions=t["positions"],
        attention=PagedAttentionParams(**{k: t[k] for k in attn_keys}),
        sample_token_idx=t["sample_token_idx"], token_src_slots=t["token_src_slots"],
        sample_dst_slots=t["sample_dst_slots"], image_features=torch.from_numpy(feats),
        image_dst_idx=torch.from_numpy(f(dst)))
    return jb, pb


def _port_logits(lm, batch, T):
    c = lm.cfg
    cache = torch.zeros((c.n_layers, 1, 8, 4, 2 * c.n_kv_heads, c.head_dim))
    table = torch.zeros(2, dtype=torch.int32)
    tok, logits = decoder_forward(lm.weights, cache, batch, lm.cos_tab, lm.sin_tab, c, T,
                                  table, return_logits=True)
    return int(tok[0]), logits


def test_multimodal_prefill_logits_match_jax_and_hf(ckpt):
    path, hf = ckpt
    jf, pf = factories(path)
    px = pixels(1, seed=1)
    feats = pf.getVisionModel().forward(px, VisionModelParameters()).image_features
    prompt = [1, 5, 8] + [IMAGE_ID] * N_IMAGE_TOKENS + [9, 12, 3]
    T = len(prompt)
    jb, pb = _batches(prompt, range(3, 3 + N_IMAGE_TOKENS), feats[0].numpy())
    jlm = jf.getLanguageModel()
    c = jlm.cfg
    jcache = jnp.zeros((c.n_layers, 1, 8, 4, 2 * c.n_kv_heads, c.head_dim), jnp.float32)
    _, jtok, jlogits = jlm.forward_with_logits(jcache, jb, max_q=T)
    tok, logits = _port_logits(pf.getLanguageModel(), pb, T)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert tok == int(jtok[0])
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.tensor([prompt]),
                       pixel_values=torch.tensor(px)).logits[0].numpy()
    np.testing.assert_allclose(logits[0].numpy(), hf_logits[-1], **HF_LOGITS_TOL)
    assert tok == int(hf_logits[-1].argmax())


def test_flat_weight_names_load_the_same_model(ckpt, tmp_path):
    """The checkpoint's names rewritten to the pre-4.52 flat layout (as the
    HF hub's llava-1.5 weights have them) load the same towers."""
    import shutil

    from safetensors.numpy import load_file, save_file
    path = ckpt[0]
    for name in ("config.json", "preprocessor_config.json"):
        shutil.copy(f"{path}/{name}", tmp_path / name)
    renames = (("model.language_model.", "language_model.model."),
               ("model.vision_tower.", "vision_tower."),
               ("model.multi_modal_projector.", "multi_modal_projector."),
               ("lm_head.", "language_model.lm_head."))
    tensors = {}
    for f in sorted(__import__("glob").glob(f"{path}/*.safetensors")):
        for k, v in load_file(f).items():
            for old, new in renames:
                if k.startswith(old):
                    k = new + k[len(old):]
                    break
            tensors[k] = v
    assert "language_model.model.embed_tokens.weight" in tensors
    save_file(tensors, str(tmp_path / "model.safetensors"))
    _, new = factories(path)
    _, old = factories(str(tmp_path))
    assert old._prefixes()[0] == "language_model.model."
    px = pixels(2, seed=3)
    p = VisionModelParameters()
    np.testing.assert_array_equal(old.getVisionModel().forward(px, p).image_features.numpy(),
                                  new.getVisionModel().forward(px, p).image_features.numpy())
    for key in ("embed", "lm_head", "norm"):
        assert torch.equal(old.getLanguageModel().weights[key],
                           new.getLanguageModel().weights[key])


def test_bf16_vision_tower_gap_to_jax(ckpt, record_property):
    """With bf16 weights the port runs the tower in bf16 activations, while
    the JAX tower, fed f32 pixels, promotes to f32 activations. The port's
    bf16 features are held to 2e-2 of max |feature| from JAX's bf16-weight
    tower, and to 4x JAX's distance from the f32 tower; the distances,
    relative to max |feature|, are recorded as junit properties."""
    px = pixels(2, seed=11)
    feats = {}
    for dtype in (("float32", "fp32"), ("bfloat16", "bf16")):
        jf, pf = factories(ckpt[0], dtype=dtype)
        feats["jax", dtype[1]] = np.asarray(
            jf.getVisionModel().forward(jnp.asarray(px), JaxVMP()).image_features,
            np.float32)
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
    assert port_to_f32 <= 4 * jax_to_f32


def _jax_tiny_mm_trees(quant="none"):
    """The trees the JAX RandomWeightFactory("tiny-lm", f32, quant,
    multimodal) builds (LM from key 0, tower from key 1), as numpy."""
    lm = jax_random.init_decoder_weights(jax_random.ARCH_CONFIGS["tiny-lm"],
                                         jax.random.PRNGKey(0), jnp.float32,
                                         quantization=quant)
    vision = jax_random.init_clip_weights(jax_random.CLIP_TINY, jax.random.PRNGKey(1),
                                          jnp.float32, lm_hidden=128)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(lm), to_np(vision)


def tiny_mm_factory(quant="none", kv_scale=None):
    """The port's random:tiny-lm+mm with the JAX random weights carried over."""
    lm, vision = _jax_tiny_mm_trees(quant)
    return RandomWeightFactory("tiny-lm", dtype=torch.float32, quantization=quant,
                               kv_scale=kv_scale, device="cpu",
                               weights=from_jax_numpy(lm, "cpu"), multimodal=True,
                               clip_cfg=CLIP_TINY,
                               vision_weights=from_jax_vision_numpy(vision, "cpu"))


def test_random_tiny_mm_bridges_from_jax():
    jf = jax_get_factory(JaxMFC(name="random:tiny-lm+mm", dtype="float32"))
    pf = getModelFactory(ModelFactoryConfig(name="random:tiny-lm+mm", dtype="float32"), "cpu")
    assert pf.multimodal and pf.clip_cfg == CLIP_TINY
    assert isinstance(pf.getVisionModel(), llava.LlavaVisionModel)
    # the port's own init has the JAX tree's structure and shapes
    _, vision = _jax_tiny_mm_trees()
    own = init_clip_weights(CLIP_TINY, 1, torch.float32, 128, "cpu")
    shapes = lambda t, leaf: jax.tree_util.tree_map(leaf, t)
    assert shapes(own, lambda x: tuple(x.shape)) == shapes(vision, lambda x: x.shape)
    # the bridged tower gives the JAX factory's features
    px = np.stack([jf.getProcessor().process(image(56, 56, s)) for s in (1, 2)])
    ref = np.asarray(jf.getVisionModel().forward(jnp.asarray(px), JaxVMP()).image_features)
    got = tiny_mm_factory().getVisionModel().forward(px, VisionModelParameters())
    assert got.image_features.shape == (2, 16, 128)
    np.testing.assert_allclose(got.image_features.numpy(), ref, **TOL)
    pv, jv = pf.getVisionModelConfig(), jf.getVisionModelConfig()
    assert (pv.image_token, pv.image_token_id) == (jv.image_token, jv.image_token_id)
    img = image(60, 70)
    np.testing.assert_array_equal(pf.getProcessor().process(img),
                                  np.asarray(jf.getProcessor().process(img)))


# ------------------------------------------------------------ engine parity

def _requests(req_cls, sp_cls, img, max_tokens=10):
    sp = lambda: sp_cls(max_tokens=max_tokens, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=img, sampling_params=sp()),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp())]


def run_jax(factory, k, kv_int8, chunk_layers, img):
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=2),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        encode_chunk_layers=chunk_layers)
    cfg.model.dtype = "float32"
    cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
    engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="EPD")
    return [o.output_token_ids for o in engine.generate(
        _requests(JaxRequest, JaxSP, img), timeout_s=600)]


# The JAX engine serves each model and format once a module, at K = 1 with
# the whole-tower encode, and every port setting is held to those tokens: the
# JAX package's own tests hold its tokens equal across K
# (tests/engine/test_multi_step_engine.py) and between the whole and the
# chunked encode (tests/engine/test_chunked_encode.py).
_JAX_TOKENS = {}


def jax_tokens(key, run):
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = run()
    return _JAX_TOKENS[key]


def run_port(factory, k, chunk_layers, img):
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        encode_chunk_layers=chunk_layers)
    engine = OfflineEngine(cfg, model_factory=factory, node_type="EPD", device="cpu")
    return [o.output_token_ids for o in engine.generate(
        _requests(Request, SamplingParameters, img), timeout_s=600)]


@pytest.mark.parametrize("chunk_layers", [0, 1], ids=["whole", "chunked"])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_epd_engine_matches_jax_engine(ckpt, quant, kv_int8, k, chunk_layers, monkeypatch):
    monkeypatch.setattr(jax_llava.LlavaModelFactory, "getTokenizer", lambda self: JaxTok(
        image_token="<image>", image_token_id=IMAGE_ID, eos_token_id=63))
    monkeypatch.setattr(llava.LlavaModelFactory, "getTokenizer", lambda self: SimpleTokenizer(
        image_token="<image>", image_token_id=IMAGE_ID, eos_token_id=63))
    jf, pf = factories(ckpt[0], quant, kv_int8)
    img = image(40, 50)
    got = run_port(pf, k, chunk_layers, img)
    ref = jax_tokens(("ckpt", quant), lambda: run_jax(jf, 1, kv_int8, 0, img))
    assert [len(t) for t in got] == [10, 10]
    assert got == ref


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_random_tiny_mm_engine_matches_jax_engine(quant, kv_scale, k):
    jf = jax_random.RandomWeightFactory("tiny-lm", dtype=jnp.float32, quantization=quant,
                                        kv_scale=kv_scale, multimodal=True,
                                        clip_cfg=jax_random.CLIP_TINY)
    img = image(64, 48)
    got = run_port(tiny_mm_factory(quant, kv_scale), k, 0, img)
    ref = jax_tokens(("random", quant), lambda: run_jax(jf, 1, kv_scale is not None, 0, img))
    assert [len(t) for t in got] == [10, 10]
    assert got == ref
