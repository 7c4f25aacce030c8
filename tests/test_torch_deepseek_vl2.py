"""The port's DeepSeek-VL2 path against the JAX package, on the CPU (the
port's mirror of tests/models/test_deepseek.py).

A tiny VL2 checkpoint in the original naming is written with
safetensors.numpy by the JAX test's own writer
(tests/models/test_deepseek.py:make_deepseek_vl2_checkpoint) with a SigLIP
tower 144 wide over 2 heads, so the head dim is SigLIP-so400m's 72 and the
port pads it to 80: 2 layers over 28-pixel tiles of 14-pixel patches, the
depth-2 projector (576 -> 32 -> 32), image_newline and view_seperator, a
3-layer DeepSeek-V2 LM 32 wide (4 q / 2 kv heads, the first layer dense,
then 4 experts, 2 a token, greedy softmax, one shared expert), candidate
resolutions 28 x 28, 28 x 56 and 56 x 28; image token 60. Both packages
load it through getModelFactory(path).

Held against JAX in f32 within 1e-4: SigLIP's patch tokens (the port's
padded heads, and the padding itself against the unpadded tower within
1e-5), the projector (an odd side included), the merge of a batch of two
images at global_view_pos head and tail, and the tower carried over by the
weight bridge; exactly: the token calculator and the processor (the card
phase's sizes at the default candidates included). The gate: the port's
EPD OfflineEngine gives the JAX engine's greedy tokens (an image request
whose prompt is over an 8-token budget, and a text request; K = 1 and 4;
f32 and int8 weights with an int8 KV cache; the JAX engine serves each
format once, at K = 1), and an in-process EP + D
Cluster gives the EPD node's. A VL2 checkpoint over an MLA LM (kv_lora 16):
the port serves it on the single-plane latent cache with hidden-wide image
slots; the JAX VL2 factory asks for two cache planes, and the JAX node's
image slots are heads x the latent width, so an image request raises there
(test_mla_language_model); a text request gives the same tokens in both.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("safetensors")
Image = pytest.importorskip("PIL.Image")

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.profiler import \
    BatchSchedulerProfilerConfig as JaxProfilerConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import VisionModelParameters as JaxVMP  # noqa: E402
from hydrainfer_tpu.models import deepseek_vl2 as jax_vl2  # noqa: E402
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxPAP  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.cluster import Cluster, ClusterConfig, NodeSpec  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.output_token_processor import (  # noqa: E402
    OfflineOutputTokenProcessor, OutputTokenParams)
from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import (  # noqa: E402
    RequestProcessorConfig, RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import deepseek_vl2  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (ModelFactoryConfig,  # noqa: E402
                                                 VisionModelParameters, getModelFactory)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_vision_numpy  # noqa: E402
from hydrainfer_tpu_torch.request import (OfflineInferenceOutput, Request,  # noqa: E402
                                          SamplingParameters)
from tests.models.test_deepseek import make_deepseek_vl2_checkpoint  # noqa: E402

IMAGE_ID = 60
VIT_HIDDEN = 144           # 2 heads of 72, SigLIP-so400m's head dim
TOL = dict(rtol=1e-4, atol=1e-4)
# the vl2 card phase's images (h, w) at the default candidates -> (tiles,
# image tokens): 384 x 384, 768 x 768, 1152 wide x 384, 384 wide x 768
CARD_SIZES = [((384, 384), 2, 421), ((768, 768), 5, 1023), ((384, 1152), 4, 813),
              ((768, 384), 3, 631)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_dsvl2")
    make_deepseek_vl2_checkpoint(path, vit_hidden=VIT_HIDDEN)
    return str(path)


def _mla_language(t: dict, cfg: dict, rng, n_layers=3, hidden=32, heads=4):
    """Replace the checkpoint's LM attention by MLA projections (kv_lora 16,
    rope 8, nope 16, v 16, plain q)."""
    r, dr, dn, dv = 16, 8, 16, 16
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    for layer in range(n_layers):
        p = f"language.model.layers.{layer}.self_attn."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            del t[p + name + ".weight"]
        t[p + "q_proj.weight"] = f(heads * (dn + dr), hidden)
        t[p + "kv_a_proj_with_mqa.weight"] = f(r + dr, hidden)
        t[p + "kv_a_layernorm.weight"] = np.ones(r, np.float32)
        t[p + "kv_b_proj.weight"] = f(heads * (dn + dv), r)
        t[p + "o_proj.weight"] = f(hidden, heads * dv)
    cfg["language_config"].update(kv_lora_rank=r, qk_rope_head_dim=dr, qk_nope_head_dim=dn,
                                  v_head_dim=dv, num_key_value_heads=heads)


@pytest.fixture(scope="module")
def mla_ckpt(ckpt, tmp_path_factory):
    from safetensors.numpy import load_file, save_file
    path = tmp_path_factory.mktemp("tiny_dsvl2_mla")
    t = dict(load_file(os.path.join(ckpt, "model.safetensors")))
    with open(os.path.join(ckpt, "config.json")) as fh:
        cfg = json.load(fh)
    _mla_language(t, cfg, np.random.default_rng(5))
    save_file(t, str(path / "model.safetensors"))
    with open(path / "config.json", "w") as fh:
        json.dump(cfg, fh)
    return str(path)


def factories(path, quant="none", kv_int8=False):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp",
                                quantization=quant, kv_cache_dtype=kv, kv_scale=0.05))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype="fp32", quantization=quant,
                                            kv_cache_dtype=kv, kv_scale=0.05), "cpu")
    assert isinstance(jf, jax_vl2.DeepSeekVL2ModelFactory)
    assert isinstance(pf, deepseek_vl2.DeepSeekVL2ModelFactory)
    return jf, pf


def image(h, w, seed=9):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def tiles(n, seed, size=28):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def test_siglip_padded_heads_match_jax(ckpt):
    jf, pf = factories(ckpt)
    cfg = pf.vit_cfg
    assert cfg.__dict__ == jf.vit_cfg.__dict__ and cfg.hidden_size // cfg.n_heads == 72
    assert deepseek_vl2.padded_head_dim(cfg) == 80
    vit = pf.getVisionModel().weights["vit"]
    (qw, qb), (pw, _) = vit["layers"][0]["qkv"], vit["layers"][0]["proj"]
    assert qw.shape == (144, 3 * 2 * 80) and qb.shape == (480,) and pw.shape == (160, 144)
    pad_cols = qw.reshape(144, 3, 2, 80)[..., 72:]
    assert not pad_cols.any() and not pw.reshape(2, 80, 144)[:, 72:].any()
    px = tiles(3, seed=0)
    got = deepseek_vl2.siglip_forward(vit, torch.from_numpy(px), cfg)
    ref = jax_vl2.siglip_forward(jf.getVisionModel().weights["vit"], jnp.asarray(px), jf.vit_cfg)
    assert got.shape == (3, 4, 144)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    raw = deepseek_vl2.convert_siglip_weights(pf._get_store(), cfg)
    unpadded = deepseek_vl2.siglip_forward(raw, torch.from_numpy(px), cfg)
    np.testing.assert_allclose(got.numpy(), unpadded.numpy(), rtol=1e-5, atol=1e-5)
    assert deepseek_vl2.pad_siglip_heads(vit, cfg) is vit


@pytest.mark.parametrize("side", [2, 3, 4])
def test_projector_matches_jax(side):
    rng = np.random.default_rng(side)
    feats = rng.standard_normal((2, side * side, 8)).astype(np.float32)
    w = [(rng.standard_normal((32, 12)).astype(np.float32),
          rng.standard_normal(12).astype(np.float32)),
         (rng.standard_normal((12, 10)).astype(np.float32),
          rng.standard_normal(10).astype(np.float32))]
    got = deepseek_vl2.mlp_projector_forward(
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in w], torch.from_numpy(feats))
    ref = jax_vl2.mlp_projector_forward([(jnp.asarray(a), jnp.asarray(b)) for a, b in w],
                                        jnp.asarray(feats))
    assert got.shape == (2, ((side + 1) // 2) ** 2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw", [(30, 30), (28, 50), (50, 28), (61, 17), (100, 300),
                                (20, 90)])
def test_processor_and_calculator_match_jax(ckpt, hw):
    jf, pf = factories(ckpt)
    img = image(*hw, seed=hw[1])
    got = pf.getProcessor().process(img)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jf.getProcessor().process(img)))
    pcalc = pf.getVisionModelConfig().image_token_calculator
    jcalc = jf.getVisionModelConfig().image_token_calculator
    assert pcalc.tiles(hw) == jcalc.tiles(hw)
    assert got.shape[0] == pcalc.n_tiles(hw)
    assert pcalc.get_num_image_tokens(hw) == jcalc.get_num_image_tokens(hw)
    pv, jv = pf.getVisionModelConfig(), jf.getVisionModelConfig()
    assert (pv.image_token, pv.image_token_id) == (jv.image_token, jv.image_token_id) \
        == ("<image>", IMAGE_ID)


@pytest.mark.parametrize("hw,n_tiles,n_tokens", CARD_SIZES)
def test_card_sizes(hw, n_tiles, n_tokens):
    cands = deepseek_vl2.DEFAULT_CANDIDATES
    calc = deepseek_vl2.DeepSeekVL2ImageTokenCalculator(cands)
    ref = jax_vl2.DeepSeekVL2ImageTokenCalculator(cands)
    assert calc.n_tiles(hw) == 1 + np.prod(ref.tiles(hw)) == n_tiles
    assert calc.get_num_image_tokens(hw) == ref.get_num_image_tokens(hw) == n_tokens
    assert deepseek_vl2.DeepSeekVL2ImageProcessorAdapter(calc).process(
        image(*hw)).shape == (n_tiles, 3, 384, 384)


def _jax_features(vm, px, sizes):
    return np.asarray(vm.forward(jnp.asarray(px), JaxVMP(original_image_sizes=sizes))
                      .image_features)


@pytest.mark.parametrize("view_pos", ["head", "tail"])
def test_vision_model_merge_matches_jax(ckpt, view_pos):
    jf, pf = factories(ckpt)
    jvm, pvm = jf.getVisionModel(), pf.getVisionModel()
    jvm.global_view_pos = pvm.global_view_pos = view_pos
    imgs = [image(28, 50, seed=1), image(61, 17, seed=2)]
    sizes = [(i.height, i.width) for i in imgs]
    px = np.concatenate([pf.getProcessor().process(i) for i in imgs])
    assert px.shape[0] == 3 + 3
    got = pvm.forward(px, VisionModelParameters(original_image_sizes=sizes)).image_features
    calc = pf.getVisionModelConfig().image_token_calculator
    assert got.shape == (1, sum(calc.get_num_image_tokens(s) for s in sizes), 32)
    np.testing.assert_allclose(got.numpy(), _jax_features(jvm, px, sizes), **TOL)


def test_weight_bridge_carries_the_jax_tower(ckpt):
    jf, pf = factories(ckpt)
    jvm = jf.getVisionModel()
    tree = jax.tree_util.tree_map(np.asarray, jvm.weights)
    assert set(tree) == {"vit", "proj", "newline", "view_sep"}
    vm = deepseek_vl2.DeepSeekVL2VisionModel(from_jax_vision_numpy(tree, "cpu"), jvm.cfg,
                                             pf._calculator())
    px, sizes = pf.getProcessor().process(image(50, 28)), [(50, 28)]
    got = vm.forward(px, VisionModelParameters(original_image_sizes=sizes)).image_features
    np.testing.assert_allclose(got.numpy(), _jax_features(jvm, px, sizes), **TOL)


# ------------------------------------------------------------ engine parity

BUDGET = 8


def _requests(req_cls, sp_cls, max_tokens=8):
    """An image request of 3 tiles (28 x 50: the 56 x 28 candidate), whose
    11-token prompt is over the budget of 8, and a text request."""
    sp = lambda: sp_cls(max_tokens=max_tokens, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=image(28, 50),
                    sampling_params=sp()),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp())]


def _tokenizers(monkeypatch):
    monkeypatch.setattr(jax_vl2.DeepSeekVL2ModelFactory, "getTokenizer", lambda self: JaxTok(
        image_token="<image>", image_token_id=IMAGE_ID, eos_token_id=63))
    monkeypatch.setattr(deepseek_vl2.DeepSeekVL2ModelFactory, "getTokenizer",
                        lambda self: SimpleTokenizer(image_token="<image>",
                                                     image_token_id=IMAGE_ID,
                                                     eos_token_id=63))


def _jax_config(k, kv_int8):
    cfg = JaxNodeConfig(
        profiler=JaxProfilerConfig(enabled=False, default_token_budget=BUDGET),
        batch_scheduler=JaxBSConfig(max_running_requests=2),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=0)
    cfg.model.dtype = "float32"
    cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
    return cfg


def run_jax(factory, k, kv_int8):
    engine = JaxOfflineEngine(_jax_config(k, kv_int8), model_factory=factory,
                              node_type="EPD")
    return [o.output_token_ids for o in engine.generate(_requests(JaxRequest, JaxSP),
                                                        timeout_s=600)]


def port_config(k):
    return NodeConfig(
        profiler=BatchSchedulerProfilerConfig(enabled=False, default_token_budget=BUDGET),
        batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=0)


# The JAX engine serves each format once a module, at K = 1, and every port
# setting is held to those tokens: the JAX package's own tests hold its
# tokens equal across K (tests/engine/test_multi_step_engine.py).
_JAX_TOKENS = {}


def jax_tokens(key, run):
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = run()
    return _JAX_TOKENS[key]


def run_port(factory, k):
    engine = OfflineEngine(port_config(k), model_factory=factory, node_type="EPD",
                           device="cpu")
    outs = engine.generate(_requests(Request, SamplingParameters), timeout_s=600)
    return [o.output_token_ids for o in outs]


@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_epd_engine_matches_jax_engine(ckpt, quant, kv_int8, k, monkeypatch):
    _tokenizers(monkeypatch)
    jf, pf = factories(ckpt, quant, kv_int8)
    n_image = pf.getVisionModelConfig().image_token_calculator.get_num_image_tokens((28, 50))
    assert n_image == 6 and n_image + 5 - 1 > BUDGET
    got = run_port(pf, k)
    assert [len(t) for t in got] == [8, 8]
    assert got == jax_tokens(quant, lambda: run_jax(jf, 1, kv_int8))


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
    """An in-process Cluster of an EP node and a D node on one factory: the
    image request's KV migrates EP -> D; the tokens equal the EPD node's."""
    _tokenizers(monkeypatch)
    _, pf = factories(ckpt, quant, kv_int8)
    ref = run_port(pf, 4)
    cfg = ClusterConfig(nodes=[NodeSpec(node_type="EP"), NodeSpec(node_type="D")],
                        node=port_config(4), platform="cpu")
    cluster = Cluster(cfg, model_factory=pf)
    assert [n.name for n in cluster.nodes] == ["EPNode:ep0", "DNode:d0"]
    got = asyncio.run(_cluster_tokens(cluster, _requests(Request, SamplingParameters)))
    assert got == ref
    assert cluster.nodes[1]._pull_stats["n"] == 2


def _jax_greedy(jf, req, n_tokens):
    """The reference for an image request: the JAX tower's features spliced
    into the JAX decoder at the prompt's image positions, the whole sequence
    prefilled afresh for each greedy token (no cache carried, no engine)."""
    img = req.image
    sizes = [(img.height, img.width)]
    feats = np.asarray(jf.getVisionModel().forward(
        jnp.asarray(jf.getProcessor().process(img)),
        JaxVMP(original_image_sizes=sizes)).image_features)[0]
    prompt = []
    for tid in jf.getTokenizer().encode(req.prompt):
        prompt.extend([tid] * (len(feats) if tid == IMAGE_ID else 1))
    dst = np.flatnonzero(np.asarray(prompt) == IMAGE_ID).astype(np.int32)
    assert len(dst) == len(feats)
    lm, c = jf.getLanguageModel(), jf.getLanguageModelConfig()
    planes = c.n_kv_heads if c.kv_single_plane else 2 * c.n_kv_heads
    tokens, out = list(prompt), []
    for _ in range(n_tokens):
        T = len(tokens)
        i32 = lambda v: jnp.asarray(np.asarray(v, np.int32))
        ar = i32(np.arange(T))
        batch = JaxBatch(
            token_ids=i32(tokens), positions=ar, image_features=jnp.asarray(feats),
            image_dst_idx=i32(dst),
            attention=JaxPAP(q_seq_ids=i32(np.zeros(T)), q_local_ids=ar, positions=ar,
                             kv_lens=i32([T]), block_tables=i32(np.arange(-(-T // 4))[None]),
                             new_kv_slot_ids=ar, cu_q_lens=i32([0, T]), num_seqs=i32([1])),
            sample_token_idx=i32([T - 1]), token_src_slots=i32(np.full(T, -1)),
            sample_dst_slots=i32([-1]))
        cache = jnp.zeros((c.n_layers, 1, -(-T // 4), 4, planes, c.head_dim), jnp.float32)
        _, tok, _ = lm.forward_with_logits(cache, batch, max_q=T)
        tokens.append(int(tok[0]))
        out.append(int(tok[0]))
    return out


def test_mla_language_model(mla_ckpt, monkeypatch):
    """A VL2 checkpoint over an MLA LM. The port's language config asks for
    the single-plane latent cache (as DeepSeekModelFactory's does) and its
    node's image slot is one hidden-wide row; the JAX VL2 factory leaves
    kv_single_plane out (its node keeps two planes of the latent vector a
    token) and its node sizes the image slot by heads x the latent width,
    so its encode's scatter cannot reshape the features and an image
    request raises there. The port serves both requests: the image
    request's tokens equal a greedy loop over the JAX tower and decoder
    (_jax_greedy), and the text request's equal the JAX engine's (two
    planes or one, the same attention)."""
    _tokenizers(monkeypatch)
    jf, pf = factories(mla_ckpt)
    assert pf.getLanguageModelConfig().kv_single_plane
    assert not jf.getLanguageModelConfig().kv_single_plane
    engine = OfflineEngine(port_config(4), model_factory=pf, node_type="EPD", device="cpu")
    assert engine.node.kv_cache_manager.cache_array.shape[-2:] == (1, 24)
    assert engine.node.image_cache_manager.cache_array.shape[-2:] == (1, 32)
    got = [o.output_token_ids for o in engine.generate(_requests(Request, SamplingParameters),
                                                       timeout_s=600)]
    assert [len(t) for t in got] == [8, 8]
    assert got[0] == _jax_greedy(jf, _requests(JaxRequest, JaxSP)[0], 8)
    with pytest.raises(TypeError, match="cannot reshape"):
        run_jax(jf, 4, False)
    jax_engine = JaxOfflineEngine(_jax_config(4, False), model_factory=jf, node_type="EPD")
    text = _requests(JaxRequest, JaxSP)[1:]
    assert [o.output_token_ids for o in jax_engine.generate(text, timeout_s=600)] == got[1:]
