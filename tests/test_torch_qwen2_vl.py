"""The port's Qwen2-VL path against the JAX package, on the CPU.

A tiny Qwen2-VL checkpoint is built in process with transformers, exactly as
tests/models/test_qwen2_vl_vs_hf.py builds it (depth 2, embed 64, 4 heads,
M-RoPE sections (2, 2, 2)), and loaded through both packages'
Qwen2VLModelFactory. Held against JAX: smart_resize, the token calculator,
the vision rope tables and the processor's patch layout (exact); mrope_gather
and the M-RoPE positions (exact); the vision tower for one image and for two
of different grids (f32, 1e-4: summation order over two blocks and the
merger); with bf16 weights, the port's bf16 tower against JAX's (which
promotes to f32 activations); one multimodal prefill plus 4 decode steps of
the decoder (logits 1e-4, tokens exact). The gate: the port's EPD
OfflineEngine against the JAX one over the same checkpoint, an image request
and a text request, fused windows K=1 and K=4, in f32 and with int8 weights
plus an int8 KV cache: the greedy tokens must be identical.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import RequestProcessor as JaxRP  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import VisionModelParameters as JaxVMP  # noqa: E402
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models import qwen2_vl as jax_qvl  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxPAP  # noqa: E402
from hydrainfer_tpu.ops.rope import mrope_gather as jax_mrope_gather  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine import executor as port_executor  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import (  # noqa: E402
    RequestProcessor, RequestProcessorConfig)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import qwen2_vl  # noqa: E402
from hydrainfer_tpu_torch.models.decoder import decoder_forward  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig,
                                                 VisionModelParameters)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_vision_numpy  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402
from hydrainfer_tpu_torch.ops.rope import mrope_gather  # noqa: E402

VOCAB = 64
IMAGE_ID = 60
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_qwen2vl")
    cfg = transformers.Qwen2VLConfig(
        vision_config=dict(depth=2, embed_dim=64, hidden_size=48, num_heads=4,
                           patch_size=14, spatial_merge_size=2,
                           temporal_patch_size=2, mlp_ratio=2),
        hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=VOCAB,
        max_position_embeddings=256, image_token_id=IMAGE_ID,
        vision_start_token_id=61, vision_end_token_id=62,
        rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]})
    torch.manual_seed(0)
    model = transformers.Qwen2VLForConditionalGeneration(cfg).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def factories(path, quant="none", kv_int8=False):
    kv = "int8" if kv_int8 else "auto"
    jf = jax_qvl.Qwen2VLModelFactory(
        JaxMFC(path=path, dtype="float32", attention_impl="jnp", quantization=quant,
               kv_cache_dtype=kv, kv_scale=0.05), None)
    pf = qwen2_vl.Qwen2VLModelFactory(
        ModelFactoryConfig(path=path, dtype="fp32", quantization=quant,
                           kv_cache_dtype=kv, kv_scale=0.05), device="cpu")
    return jf, pf


def image(h, w, seed=9):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("size", [(56, 84), (60, 80), (224, 224), (672, 448), (30, 500)])
def test_resize_calculator_rope_tables_and_patches_match_jax(ckpt, size):
    jf, pf = factories(ckpt[0])
    h, w = size
    assert qwen2_vl.smart_resize(h, w) == jax_qvl.smart_resize(h, w)
    jc = jf.getVisionModelConfig().image_token_calculator
    pc = pf.getVisionModelConfig().image_token_calculator
    assert pc.get_num_image_tokens(size) == jc.get_num_image_tokens(size)
    assert pc.get_image_grid(size) == jc.get_image_grid(size)
    grids = pf.getVisionModel().grids([size, (56, 56)])
    n = sum(t * h * w for t, h, w in grids)
    for got, ref in zip(qwen2_vl.vision_rope_tables(grids, 16, 2),
                        jax_qvl.vision_rope_tables(grids, 16, 2, n)):
        np.testing.assert_array_equal(got, ref)
    img = image(h, w)
    np.testing.assert_array_equal(pf.getProcessor().process(img),
                                  np.asarray(jf.getProcessor().process(img)))


def test_mrope_gather_matches_jax():
    rng = np.random.default_rng(3)
    cos, sin = (rng.standard_normal((40, 6)).astype(np.float32) for _ in range(2))
    pos = [rng.integers(0, 40, 17).astype(np.int32) for _ in range(3)]
    ref = jax_mrope_gather(jnp.asarray(cos), jnp.asarray(sin), *map(jnp.asarray, pos),
                           (2, 2, 2))
    got = mrope_gather(torch.from_numpy(cos), torch.from_numpy(sin),
                       *map(torch.from_numpy, pos), (2, 2, 2))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_mrope_positions_match_jax(ckpt):
    """Text before, between and after two images of different grids."""
    _, pf = factories(ckpt[0])
    calc = pf.getVisionModelConfig().image_token_calculator

    class Shim:
        image_token_id = IMAGE_ID
        image_token_calculator = calc

    sizes = [(56, 84), (112, 56)]
    n = [calc.get_num_image_tokens(s) for s in sizes]
    ids = [5, 6, 61] + [IMAGE_ID] * n[0] + [62, 7] + [IMAGE_ID] * n[1] + [8, 9, 10]
    got = RequestProcessor._mrope_positions(Shim(), ids, sizes)
    assert got == JaxRP._mrope_positions(Shim(), ids, sizes)
    assert got[3] < len(ids)            # rope positions compress after images


def _vision_inputs(vm, sizes, seed):
    n = sum(t * h * w for t, h, w in vm.grids(sizes))
    return np.random.default_rng(seed).standard_normal((n, vm.cfg.patch_dim)).astype(
        np.float32)


@pytest.mark.parametrize("sizes", [[(56, 84)], [(56, 56), (84, 56)]],
                         ids=["one_image", "two_grids"])
def test_vision_tower_matches_jax(ckpt, sizes):
    jf, pf = factories(ckpt[0])
    patches = _vision_inputs(pf.getVisionModel(), sizes, seed=len(sizes))
    ref = np.asarray(jf.getVisionModel().forward(
        jnp.asarray(patches), JaxVMP(original_image_sizes=sizes)).image_features)
    got = pf.getVisionModel().forward(
        patches, VisionModelParameters(original_image_sizes=sizes)).image_features
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("sizes", [[(56, 84)], [(56, 56), (84, 56)]],
                         ids=["one_image", "two_grids"])
def test_bf16_vision_tower_gap_to_jax(ckpt, sizes, record_property):
    """With bf16 weights the port runs the tower in bf16 activations, while
    the JAX tower, fed f32 pixels, promotes to f32 activations. The port's
    bf16 features are held to 2e-2 of max |feature| from JAX's bf16-weight
    tower, and to 4x JAX's distance from the f32 tower; the distances,
    relative to max |feature|, are recorded as junit properties."""
    path = ckpt[0]
    feats = {}
    for jdt, pdt in (("float32", "fp32"), ("bfloat16", "bf16")):
        jf = jax_qvl.Qwen2VLModelFactory(JaxMFC(path=path, dtype=jdt, attention_impl="jnp"),
                                         None)
        pvm = qwen2_vl.Qwen2VLModelFactory(ModelFactoryConfig(path=path, dtype=pdt),
                                           device="cpu").getVisionModel()
        patches = _vision_inputs(pvm, sizes, seed=11)
        feats["jax", pdt] = np.asarray(jf.getVisionModel().forward(
            jnp.asarray(patches), JaxVMP(original_image_sizes=sizes)).image_features,
            np.float32)
        got = pvm.forward(patches, VisionModelParameters(original_image_sizes=sizes))
        feats["port", pdt] = got.image_features.float().numpy()
    assert got.image_features.dtype == torch.bfloat16
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


def test_vision_weight_bridge_and_hf(ckpt):
    """The JAX vision weights carried over through numpy give the port's own
    loaded tower exactly; and the tower agrees with HF's (2e-3, as the JAX
    package's own HF test)."""
    path, hf = ckpt
    jf, pf = factories(path)
    jvm, pvm = jf.getVisionModel(), pf.getVisionModel()
    import jax
    bridged = qwen2_vl.Qwen2VLVisionModel(
        from_jax_vision_numpy(jax.tree_util.tree_map(np.asarray, jvm.weights), "cpu"),
        pvm.cfg)
    sizes = [(56, 84)]
    patches = _vision_inputs(pvm, sizes, seed=5)
    params = VisionModelParameters(original_image_sizes=sizes)
    got = pvm.forward(patches, params).image_features
    np.testing.assert_array_equal(bridged.forward(patches, params).image_features.numpy(),
                                  got.numpy())
    with torch.no_grad():
        ref = hf.model.visual(torch.tensor(patches), grid_thw=torch.tensor([[1, 4, 6]]))
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)


def _batches(tokens, pt, ph, pw, n_past, feats=None, dst=None, bs=4):
    """The same single-sequence step for both packages: the tokens' K/V land
    at cache positions n_past.. in blocks 0.. of a fresh cache."""
    T = len(tokens)
    kv_len = n_past + T
    nb = -(-kv_len // bs)
    f = lambda v: np.asarray(v, np.int32)
    core = dict(token_ids=f(tokens), positions=f(pt), q_seq_ids=np.zeros(T, np.int32),
                q_local_ids=np.arange(T, dtype=np.int32), kv_lens=f([kv_len]),
                block_tables=np.arange(nb, dtype=np.int32)[None],
                new_kv_slot_ids=np.arange(n_past, kv_len, dtype=np.int32),
                cu_q_lens=f([0, T]), num_seqs=f([1]), sample_token_idx=f([T - 1]),
                token_src_slots=np.full(T, -1, np.int32), sample_dst_slots=f([-1]),
                positions_hw=f([ph, pw]))
    attn_keys = ("q_seq_ids", "q_local_ids", "positions", "kv_lens", "block_tables",
                 "new_kv_slot_ids", "cu_q_lens", "num_seqs")
    feats = np.zeros((0, 48), np.float32) if feats is None else feats
    dst = np.zeros(0, np.int32) if dst is None else f(dst)
    j = {k: jnp.asarray(v) for k, v in core.items()}
    jb = JaxBatch(token_ids=j["token_ids"], positions=j["positions"],
                  image_features=jnp.asarray(feats), image_dst_idx=jnp.asarray(dst),
                  attention=JaxPAP(**{k: j[k] for k in attn_keys}),
                  sample_token_idx=j["sample_token_idx"],
                  token_src_slots=j["token_src_slots"],
                  sample_dst_slots=j["sample_dst_slots"], positions_hw=j["positions_hw"])
    t = {k: torch.from_numpy(v) for k, v in core.items()}
    pb = LanguageModelBatch(
        token_ids=t["token_ids"], positions=t["positions"],
        attention=PagedAttentionParams(**{k: t[k] for k in attn_keys}),
        sample_token_idx=t["sample_token_idx"], token_src_slots=t["token_src_slots"],
        sample_dst_slots=t["sample_dst_slots"], positions_hw=t["positions_hw"],
        image_features=torch.from_numpy(feats) if len(dst) else None,
        image_dst_idx=torch.from_numpy(dst) if len(dst) else None)
    return jb, pb


def test_multimodal_prefill_and_decode_match_jax(ckpt):
    jf, pf = factories(ckpt[0])
    jlm, plm = jf.getLanguageModel(), pf.getLanguageModel()
    assert plm.cfg.mrope_section == (2, 2, 2) and plm.cfg.tie_word_embeddings is False
    calc = pf.getVisionModelConfig().image_token_calculator

    class Shim:
        image_token_id = IMAGE_ID
        image_token_calculator = calc

    sizes = [(56, 84)]
    feats = pf.getVisionModel().forward(
        _vision_inputs(pf.getVisionModel(), sizes, 7),
        VisionModelParameters(original_image_sizes=sizes)).image_features[0].numpy()
    # text after the image, so its positions are compressed
    ids = [5, 6, 7, 61] + [IMAGE_ID] * 6 + [62, 8, 9]
    pt, ph, pw, st = RequestProcessor._mrope_positions(Shim(), ids, sizes)
    dst = [i for i, t in enumerate(ids) if t == IMAGE_ID]

    c = plm.cfg
    shape = (c.n_layers, 1, 16, 4, 2 * c.n_kv_heads, c.head_dim)
    jcache, pcache = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    table = torch.zeros(2, dtype=torch.int32)
    n_past, tok = 0, None
    steps = [(ids, pt, ph, pw, feats, dst)] + [None] * 4
    for k, step in enumerate(steps):
        if step is None:
            p = st + k - 1
            step = ([tok], [p], [p], [p], None, None)
        jb, pb = _batches(*step[:4], n_past, step[4], step[5])
        jcache, jtok, jlogits = jlm.forward_with_logits(jcache, jb, max_q=len(step[0]))
        ptok, plogits = decoder_forward(plm.weights, pcache, pb, plm.cos_tab, plm.sin_tab,
                                        plm.cfg, len(step[0]), table, return_logits=True)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), **TOL)
        assert int(ptok[0]) == int(jtok[0])
        tok = int(ptok[0])
        n_past += len(step[0])


def _serve(engine, requests):
    return [o.output_token_ids for o in engine.generate(requests, timeout_s=600)]


def run_jax(path, quant, kv_int8, k, monkeypatch, spec_k=0, max_tokens=10,
            max_running=2):
    monkeypatch.setattr(jax_qvl.Qwen2VLModelFactory, "getTokenizer", lambda self: JaxTok(
        image_token="<image>", image_token_id=IMAGE_ID, eos_token_id=63))
    jf, _ = factories(path, quant, kv_int8)
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=max_running),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=spec_k)
    cfg.model.dtype = "fp32"
    cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
    engine = JaxOfflineEngine(cfg, model_factory=jf, node_type="EPD")
    return _serve(engine, [
        JaxRequest(request_id="m0", prompt="<image> !%&!", image=image(56, 84),
                   sampling_params=JaxSP(max_tokens=max_tokens, ignore_eos=True)),
        JaxRequest(request_id="t0", prompt="!! % &&",
                   sampling_params=JaxSP(max_tokens=max_tokens, ignore_eos=True))])


def run_port(path, quant, kv_int8, k, monkeypatch, spec_k=0, max_tokens=10,
             max_running=2, spec_steps=None):
    """The port engine's tokens; `spec_steps`, a list, receives its executor's
    verify-step count."""
    monkeypatch.setattr(qwen2_vl.Qwen2VLModelFactory, "getTokenizer", lambda self:
                        SimpleTokenizer(image_token="<image>", image_token_id=IMAGE_ID,
                                        eos_token_id=63))
    _, pf = factories(path, quant, kv_int8)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=k,
        spec_ngram_k=spec_k)
    engine = OfflineEngine(cfg, model_factory=pf, node_type="EPD", device="cpu")
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    sp = lambda: SamplingParameters(max_tokens=max_tokens, ignore_eos=True)
    tokens = _serve(engine, [
        Request(request_id="m0", prompt="<image> !%&!", image=image(56, 84),
                sampling_params=sp()),
        Request(request_id="t0", prompt="!! % &&", sampling_params=sp())])
    if spec_steps is not None:
        spec_steps.append(engine.node.fill_executor.spec_steps)
    return tokens


@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("k", [1, 4])
def test_epd_engine_matches_jax_engine(ckpt, quant, kv_int8, k, monkeypatch):
    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    got = run_port(ckpt[0], quant, kv_int8, k, monkeypatch)
    ref = run_jax(ckpt[0], quant, kv_int8, k, monkeypatch)
    assert [len(t) for t in got] == [10, 10]
    assert got == ref
    assert max(windows) == k


@pytest.mark.parametrize("quant,kv_int8", [("none", False), ("int8", True)],
                         ids=["f32", "int8w_int8kv"])
def test_epd_engine_speculates_like_jax(ckpt, quant, kv_int8, monkeypatch):
    """Speculation on (spec_ngram_k = 3) behind an image: the verify plan
    packs no M-RoPE tail (a decode token's three rope axes are equal), so
    its tokens must still be the JAX engine's. Two requests on a node that
    runs up to four take single steps, each a chance to speculate."""
    kw = dict(spec_k=3, max_tokens=24, max_running=4)
    steps = []
    got = run_port(ckpt[0], quant, kv_int8, 4, monkeypatch, spec_steps=steps, **kw)
    assert steps[0] > 0
    ref = run_jax(ckpt[0], quant, kv_int8, 4, monkeypatch, **kw)
    assert [len(t) for t in got] == [24, 24]
    assert got == ref
