"""The port's LLaVA-NeXT (anyres) path against the JAX package and HF, on the CPU.

A tiny LLaVA-NeXT checkpoint is built in process with transformers, with the
config of tests/models/test_llavanext_vs_hf.py (CLIP 3 layers x 32 wide, 2
heads, 28-pixel tiles of 14-pixel patches, so 2 x 2 feature cells a tile;
pinpoints (28, 56), (56, 28), (56, 56); a 2-layer Llama 48 wide; image token
60; feature layer -2), plus its LlavaNextImageProcessor at 28 pixels, and
loaded through both packages' getModelFactory(path). Held against JAX in f32
within 1e-4: the pinpoint choice, the geometry and the token count (the
tiny and the llava-v1.6 pinpoints, the sizes the card phase serves
included), the merged features of the three anyres cases (square, wide,
tall) and of several images in one call; against HF within the JAX test's
own 3e-3. The JAX vision weights carried over through the weight bridge give
JAX's features. The port's PIL-and-numpy AnyresImageProcessor equals
LlavaNextImageProcessor within 1e-5. The encode executor lands each image's
(tokens, hidden) features at its own cache slots, in order. With bf16
weights the port's bf16 tower is held beside JAX's f32-promoting one. The
gates: the port's EPD OfflineEngine gives the JAX engine's greedy tokens (an
image request whose 24 image tokens exceed a 16-token budget, so its prefill
spans chunks, and a text request; K = 1 and 4; f32 and int8 weights with an
int8 KV cache; budget 16 and 2048; the JAX engine serves each format once,
at K = 1 and budget 2048); the layer-chunked encode stays off (the
tower is not fixed-resolution); and an in-process EP + D Cluster gives the
EPD node's tokens.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

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
from hydrainfer_tpu.models import llavanext as jax_next  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.cluster import Cluster, ClusterConfig, NodeSpec  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.executor import ImageEmbedExecutor  # noqa: E402
from hydrainfer_tpu_torch.engine.output_token_processor import (  # noqa: E402
    OfflineOutputTokenProcessor, OutputTokenParams)
from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import (  # noqa: E402
    RequestProcessorConfig, RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,  # noqa: E402
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models import llavanext  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (ModelFactoryConfig,  # noqa: E402
                                                 VisionModelParameters, getModelFactory)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_vision_numpy  # noqa: E402
from hydrainfer_tpu_torch.request import (OfflineInferenceOutput, Request,  # noqa: E402
                                          SamplingParameters)

VOCAB = 64
IMAGE_ID = 60
PINPOINTS = [[28, 56], [56, 28], [56, 56]]
TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=3e-3, atol=3e-3)
# (h, w) -> tiles: square, wide, tall (tests/models/test_llavanext_vs_hf.py)
ANYRES_CASES = [((50, 50), 5), ((30, 60), 3), ((60, 30), 3)]
# the llavanext card phase's sizes: (h, w) -> (tiles, image tokens) at the
# llava-v1.6 pinpoints and CLIP-L/14-336
CARD_SIZES = [((672, 672), 5, 2928), ((480, 640), 5, 2340), ((336, 672), 3, 1752),
              ((1008, 336), 4, 2376)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_llavanext")
    cfg = transformers.LlavaNextConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                           num_attention_heads=2, image_size=28, patch_size=14,
                           hidden_act="quick_gelu"),
        text_config=dict(model_type="llama", vocab_size=VOCAB, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=256),
        image_token_index=IMAGE_ID, vision_feature_layer=-2,
        image_grid_pinpoints=PINPOINTS)
    torch.manual_seed(0)
    model = transformers.LlavaNextForConditionalGeneration(cfg).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    transformers.LlavaNextImageProcessor(
        image_grid_pinpoints=PINPOINTS, size={"shortest_edge": 28},
        crop_size={"height": 28, "width": 28}).save_pretrained(path)
    return str(path), model


def factories(path, quant="none", kv_int8=False, dtype=("float32", "fp32")):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype=dtype[0], attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype=dtype[1], quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_next.LlavaNextModelFactory)
    assert isinstance(pf, llavanext.LlavaNextModelFactory)
    return jf, pf


def image(h, w, seed=9):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def tiles(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("hw", [(50, 50), (30, 60), (60, 30), (28, 28), (100, 37),
                                (13, 90), (56, 56), (57, 29)])
def test_geometry_and_calculator_match_jax(ckpt, hw):
    jf, pf = factories(ckpt[0])
    assert pf.pinpoints == jf.pinpoints == PINPOINTS
    assert (llavanext.select_best_resolution(hw, PINPOINTS)
            == jax_next.select_best_resolution(hw, PINPOINTS))
    assert (llavanext.anyres_geometry(hw, PINPOINTS, 28, 2)
            == jax_next.anyres_geometry(hw, PINPOINTS, 28, 2))
    pv, jv = pf.getVisionModelConfig(), jf.getVisionModelConfig()
    assert (pv.image_token, pv.image_token_id) == (jv.image_token, jv.image_token_id) \
        == ("<image>", IMAGE_ID)
    assert (pv.image_token_calculator.get_num_image_tokens(hw)
            == jv.image_token_calculator.get_num_image_tokens(hw))


@pytest.mark.parametrize("hw,n_tiles,n_tokens", CARD_SIZES)
def test_card_sizes_at_the_default_pinpoints(hw, n_tiles, n_tokens):
    """The card phase's table: tiles and image tokens at llava-v1.6's
    pinpoints and CLIP-L/14-336, as the JAX calculator counts them."""
    assert llavanext.DEFAULT_PINPOINTS == [[336, 672], [672, 336], [672, 672],
                                           [1008, 336], [336, 1008]]
    calc = llavanext.LlavaNextImageTokenCalculator(llavanext.DEFAULT_PINPOINTS, 336, 24)
    ref = jax_next.LlavaNextImageTokenCalculator(llavanext.DEFAULT_PINPOINTS, 336, 24)
    assert calc.n_tiles(hw) == n_tiles
    assert calc.get_num_image_tokens(hw) == ref.get_num_image_tokens(hw) == n_tokens
    assert n_tiles == len(llavanext.AnyresImageProcessor(llavanext.DEFAULT_PINPOINTS)
                          .process(image(*hw)))


@pytest.mark.parametrize("orig_hw,n_tiles", ANYRES_CASES, ids=["square", "wide", "tall"])
def test_anyres_features_match_jax_and_hf(ckpt, orig_hw, n_tiles):
    path, hf = ckpt
    jf, pf = factories(path)
    px = tiles(n_tiles, seed=sum(orig_hw))
    ref = np.asarray(jf.getVisionModel().forward(
        jnp.asarray(px), JaxVMP(original_image_sizes=[orig_hw])).image_features)
    got = pf.getVisionModel().forward(
        px, VisionModelParameters(original_image_sizes=[orig_hw])).image_features
    n_tokens = pf.getVisionModelConfig().image_token_calculator.get_num_image_tokens(orig_hw)
    assert got.shape == (1, n_tokens, 48) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    with torch.no_grad():
        hf_feats = hf.model.get_image_features(
            pixel_values=torch.tensor(px)[None], image_sizes=torch.tensor([list(orig_hw)]),
            vision_feature_layer=-2, vision_feature_select_strategy="default")[0].numpy()
    assert hf_feats.shape == (n_tokens, 48)
    np.testing.assert_allclose(got[0].numpy(), hf_feats, **HF_TOL)


def test_several_images_in_one_call_match_jax(ckpt):
    """Three images of different tile and token counts in one call: the
    features in image order, each equal to its own call's."""
    jf, pf = factories(ckpt[0])
    sizes = [hw for hw, _ in ANYRES_CASES]
    px = tiles(sum(n for _, n in ANYRES_CASES), seed=7)
    vm = pf.getVisionModel()
    got = vm.forward(px, VisionModelParameters(original_image_sizes=sizes)).image_features
    ref = np.asarray(jf.getVisionModel().forward(
        jnp.asarray(px), JaxVMP(original_image_sizes=sizes)).image_features)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    parts, t0 = [], 0
    for hw, n in ANYRES_CASES:
        parts.append(vm.forward(px[t0:t0 + n], VisionModelParameters(
            original_image_sizes=[hw])).image_features[0])
        t0 += n
    np.testing.assert_allclose(got[0].numpy(), torch.cat(parts).numpy(), rtol=1e-6, atol=1e-6)


def test_weight_bridge_carries_the_jax_tower(ckpt):
    jf, _ = factories(ckpt[0])
    jvm = jf.getVisionModel()
    tree = jax.tree_util.tree_map(np.asarray, jvm.weights)
    assert set(tree) == {"clip", "proj1", "proj2", "newline"}
    vm = llavanext.LlavaNextVisionModel(from_jax_vision_numpy(tree, "cpu"), jvm.clip_cfg,
                                        PINPOINTS)
    px = tiles(3, seed=5)
    params = dict(original_image_sizes=[(30, 60)])
    np.testing.assert_allclose(
        vm.forward(px, VisionModelParameters(**params)).image_features.numpy(),
        np.asarray(jvm.forward(jnp.asarray(px), JaxVMP(**params)).image_features), **TOL)


@pytest.mark.parametrize("hw", [(50, 50), (30, 60), (60, 30), (41, 97)])
def test_processors_match_hf_and_jax(ckpt, hw):
    """getProcessor (the saved LlavaNextImageProcessor) equals the JAX
    factory's; the port's AnyresImageProcessor equals it within 1e-5."""
    jf, pf = factories(ckpt[0])
    img = image(*hw, seed=hw[0])
    got = pf.getProcessor().process(img)
    np.testing.assert_array_equal(got, np.asarray(jf.getProcessor().process(img)))
    n_tiles = pf.getVisionModelConfig().image_token_calculator.n_tiles(hw)
    assert got.shape == (n_tiles, 3, 28, 28)
    own = llavanext.AnyresImageProcessor(PINPOINTS, 28).process(img)
    assert own.shape == got.shape and own.dtype == np.float32
    np.testing.assert_allclose(own, got, rtol=1e-5, atol=1e-5)


def test_bf16_vision_tower_gap_to_jax(ckpt, record_property):
    """With bf16 weights the port runs the tower in bf16 activations, while
    the JAX tower, fed f32 pixels, promotes to f32. The port's bf16 features
    are held to 2e-2 of max |feature| from JAX's bf16-weight tower and to 4x
    JAX's distance from the f32 tower; the relative distances are recorded
    as junit properties."""
    px = tiles(5, seed=11)
    params = dict(original_image_sizes=[(50, 50)])
    feats = {}
    for dtype in (("float32", "fp32"), ("bfloat16", "bf16")):
        jf, pf = factories(ckpt[0], dtype=dtype)
        feats["jax", dtype[1]] = np.asarray(jf.getVisionModel().forward(
            jnp.asarray(px), JaxVMP(**params)).image_features, np.float32)
        got = pf.getVisionModel().forward(px, VisionModelParameters(**params)).image_features
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


def test_encode_scatter_lands_each_image_in_order(ckpt):
    """ImageEmbedExecutor.execute on one batch of two requests whose images
    have different tile and token counts: the (1, sum of tokens, hidden)
    features land at each request's own image-cache slots, in order."""
    _, pf = factories(ckpt[0])
    vm = pf.getVisionModel()
    calc = pf.getVisionModelConfig().image_token_calculator
    mgr = TokenCacheBlockManager(TokenCacheBlockManagerConfig(
        n_layers=1, n_tensors=1, n_blocks=16, block_size=8, n_heads=4, head_dim=12,
        dtype="float32"), "cpu", "t")
    mgr.allocate_virtual_cache()            # so the requests' blocks are not 0, 1, ...
    sizes = [(30, 60), (50, 50)]
    pxs = [tiles(calc.n_tiles(hw), seed=20 + i) for i, hw in enumerate(sizes)]
    counts = [calc.get_num_image_tokens(hw) for hw in sizes]
    assert counts == [14, 24]
    # the batch's features, split by image in order (each image alone is the
    # same within f32 rounding: test_several_images_in_one_call_match_jax)
    expect = torch.split(vm.forward(np.concatenate(pxs), VisionModelParameters(
        original_image_sizes=sizes)).image_features[0], counts)
    rcbs = []
    for px, hw, n in zip(pxs, sizes, counts):
        vc = mgr.allocate_virtual_cache()
        mgr.realloc(vc, n)
        inst = SimpleNamespace(pixel_values=px, cache_ids=list(range(n)), images_size=[hw])
        rcbs.append(SimpleNamespace(virtual_image_cache=vc, inst=inst))
    batch = SimpleNamespace(items=[(r, r.inst) for r in rcbs], stepped=[])
    batch_obj = type("Batch", (), {
        "__iter__": lambda self: iter(batch.items), "__len__": lambda self: 2,
        "step": lambda self: batch.stepped.append(True)})()
    iee = ImageEmbedExecutor(mgr, SimpleNamespace(vision_model=vm,
                                                  execute_vision_model=vm.forward))
    iee.execute(batch_obj)
    assert batch.stepped == [True]
    rows = mgr.cache_array[0, 0].reshape(-1, 48)
    for r, feats in zip(rcbs, expect):
        slots = mgr.v2p(r.virtual_image_cache, r.inst.cache_ids)
        np.testing.assert_array_equal(rows[slots].numpy(), feats.numpy())


# ------------------------------------------------------------ engine parity

def _requests(req_cls, sp_cls, max_tokens=8):
    """An image request whose 24 image tokens (a 50 x 50 image: the 56 x 56
    pinpoint, 4 + 4 x 5) exceed a budget of 16, and a text request."""
    sp = lambda: sp_cls(max_tokens=max_tokens, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=image(50, 50),
                    sampling_params=sp()),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp())]


def _tokenizers(monkeypatch):
    monkeypatch.setattr(jax_next.LlavaNextModelFactory, "getTokenizer", lambda self: JaxTok(
        image_token="<image>", image_token_id=IMAGE_ID, eos_token_id=63))
    monkeypatch.setattr(llavanext.LlavaNextModelFactory, "getTokenizer",
                        lambda self: SimpleTokenizer(image_token="<image>",
                                                     image_token_id=IMAGE_ID,
                                                     eos_token_id=63))


def run_jax(factory, k, kv_int8, budget):
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


# The JAX engine serves each format once a module, at K = 1 with the whole prompt in one step (budget 2048), and every port
# setting is held to those tokens: the JAX package's own tests hold its
# tokens equal across K (tests/engine/test_multi_step_engine.py), and test_over_budget_prompt_prefills_in_chunks holds the port's
# chunked prefill to its whole one.
_JAX_TOKENS = {}


def jax_tokens(key, run):
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = run()
    return _JAX_TOKENS[key]


def port_config(k, budget):
    return NodeConfig(
        profiler=BatchSchedulerProfilerConfig(enabled=False, default_token_budget=budget),
        batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=0, encode_chunk_layers=1)


def run_port(factory, k, budget):
    """The port's EPD engine's tokens (encode_chunk_layers = 1 is asked for
    and must stay off: the anyres tower is not fixed-resolution)."""
    engine = OfflineEngine(port_config(k, budget), model_factory=factory, node_type="EPD",
                           device="cpu")
    iee = engine.node.image_embed_executor
    assert iee.chunk_layers == 1 and not iee.chunking_enabled()
    outs = engine.generate(_requests(Request, SamplingParameters), timeout_s=600)
    return [o.output_token_ids for o in outs]


@pytest.mark.parametrize("budget", [16, 2048], ids=["over_budget", "whole"])
@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_epd_engine_matches_jax_engine(ckpt, quant, kv_int8, k, budget, monkeypatch):
    _tokenizers(monkeypatch)
    jf, pf = factories(ckpt[0], quant, kv_int8)
    prompt = SimpleTokenizer(image_token="<image>", image_token_id=IMAGE_ID).encode(
        "<image> !%&!")
    n_prompt = len(prompt) - 1 + pf.getVisionModelConfig().image_token_calculator \
        .get_num_image_tokens((50, 50))
    assert n_prompt == 29 and (n_prompt > budget) == (budget == 16)
    got = run_port(pf, k, budget)
    ref = jax_tokens(quant, lambda: run_jax(jf, 1, kv_int8, 2048))
    assert [len(t) for t in got] == [8, 8]
    assert got == ref


def test_over_budget_prompt_prefills_in_chunks(ckpt, monkeypatch):
    """At budget 16 the image request's 29-token prompt is prefilled over two
    fill steps, each reading its own image rows (its features spliced at the
    chunk's offsets); the tokens equal the whole-prompt run's."""
    from hydrainfer_tpu_torch.engine import executor as port_executor
    _tokenizers(monkeypatch)
    _, pf = factories(ckpt[0])
    image_rows = []
    orig = port_executor.FillExecutor.execute

    def spy(self, batch, n_steps=1):
        for rcb, inst in batch:
            if rcb.request_id == "m0" and getattr(inst, "image_token_cache_ids", None):
                image_rows.append(len(inst.image_token_cache_ids))
        return orig(self, batch, n_steps)

    monkeypatch.setattr(port_executor.FillExecutor, "execute", spy)
    chunked = run_port(pf, 4, 16)
    assert len(image_rows) >= 2 and sum(image_rows) == 24, image_rows
    monkeypatch.setattr(port_executor.FillExecutor, "execute", orig)
    assert chunked == run_port(pf, 4, 2048)


async def _cluster_tokens(cluster, reqs):
    tokenizer = cluster.nodes[0].model_factory.getTokenizer()
    outs, done = [], []
    await cluster.start()
    try:
        for req in reqs:
            outs.append(OfflineInferenceOutput(arrival_time=time.perf_counter()))
            proc = OfflineOutputTokenProcessor(outs[-1], tokenizer, on_finish=done.append)
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc],
                output_token_params=OutputTokenParams(stream_output=False)))
        deadline = time.perf_counter() + 300
        while len(done) < len(reqs):
            await asyncio.sleep(0.002)
            assert time.perf_counter() < deadline, f"{len(done)}/{len(reqs)} finished"
    finally:
        await cluster.stop()
    return [o.output_token_ids for o in outs]


@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
def test_ep_d_cluster_matches_the_epd_node(ckpt, quant, kv_int8, monkeypatch):
    """An in-process Cluster of an EP node and a D node (the hybrid
    topology) on one factory: the image request's KV migrates EP -> D after
    its chunked prefill; the tokens equal the EPD engine's."""
    _tokenizers(monkeypatch)
    _, pf = factories(ckpt[0], quant, kv_int8)
    ref = run_port(pf, 4, 16)
    cfg = ClusterConfig(nodes=[NodeSpec(node_type="EP"), NodeSpec(node_type="D")],
                        node=port_config(4, 16), platform="cpu")
    cluster = Cluster(cfg, model_factory=pf)
    assert [n.name for n in cluster.nodes] == ["EPNode:ep0", "DNode:d0"]
    got = asyncio.run(_cluster_tokens(cluster, _requests(Request, SamplingParameters)))
    assert got == ref
    assert cluster.nodes[1]._pull_stats["n"] == 2
