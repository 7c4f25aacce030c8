"""The port's GPT-2 against HF and the JAX package, on the CPU (the port's
mirror of tests/models/test_mixtral_gpt2_vs_hf.py:test_gpt2_token_exact).

A tiny GPT2LMHeadModel checkpoint is built in process with transformers (2
layers x 48, 4 heads of 12, vocab 96, 128 positions, gelu_new) and loaded
through both packages' getModelFactory(path); the JAX side runs its jnp
attention.

- The node's view (heads, eos, positions) equals JAX's.
- One sequence in f32: the prefill's and five decode steps' logits within
  1e-4 relative of the JAX model's, and six greedy tokens equal to JAX's and
  to HF's generate.
- The port's PD OfflineEngine gives the JAX engine's greedy tokens over a
  16-token budget (chunked prefills), in single steps whatever window is
  configured, and with n-gram speculation asked for neither engine
  speculates (GPT-2 takes no multi-step window), so the tokens stay equal.
- The weight bridge carries the JAX converter's tree of (weight, bias)
  pairs, and a model built on it gives the port loader's logits.
- The refusals: the JAX model stores an int8 cache's K/V truncated, without
  a scale (shown here against its f32 cache), so the port's factory refuses
  kv_cache_dtype int8; it refuses int8 weights, which JAX ignores; and the
  node refuses a request with temperature > 0, which JAX would decode
  greedily.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import gpt2 as jax_gpt2  # noqa: E402
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.models.weight_loader import WeightStore as JaxWeightStore  # noqa: E402
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxParams  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine import executor as port_executor  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import gpt2  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 ModelFactoryConfig, getModelFactory)
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_loader import WeightStore  # noqa: E402
from hydrainfer_tpu_torch.ops.activation import gelu_tanh  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402

VOCAB = 96
BLOCK = 4
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(path, the HF model) of a tiny GPT-2 checkpoint."""
    cfg = transformers.GPT2Config(vocab_size=VOCAB, n_positions=128, n_embd=48, n_layer=2,
                                  n_head=4)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(cfg).eval().float()
    hf.generation_config.eos_token_id = None
    path = str(tmp_path_factory.mktemp("tiny_gpt2"))
    hf.save_pretrained(path, safe_serialization=True)
    return path, hf


def _factories(path, **kw):
    jf = jax_get_factory(JaxMFC(path=path, dtype="float32", attention_impl="jnp"))
    pf = getModelFactory(ModelFactoryConfig(path=path, dtype="fp32", **kw), "cpu")
    assert isinstance(jf, jax_gpt2.GPT2ModelFactory)
    assert isinstance(pf, gpt2.GPT2ModelFactory)
    return jf, pf


def test_language_config_matches_jax(ckpt):
    jf, pf = _factories(ckpt[0])
    lc, jl = pf.getLanguageModelConfig(), jf.getLanguageModelConfig()
    for field in ("n_layers", "max_position_embeddings", "n_qo_heads", "n_kv_heads",
                  "head_dim", "eos_token_id", "hidden_size", "vocab_size"):
        assert getattr(lc, field) == getattr(jl, field), field
    assert (lc.n_kv_heads, lc.head_dim, lc.max_position_embeddings) == (4, 12, 128)
    assert lc.greedy_only and not pf.getLanguageModel().supports_multi_step
    assert pf.getVisionModel() is None and pf.getVisionModelConfig() is None


def test_gelu_tanh_matches_jax():
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32) * 4
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
                               rtol=1e-6, atol=1e-6)
    assert gelu_tanh(torch.ones(3, dtype=torch.bfloat16)).dtype == torch.bfloat16


# ------------------------------------------------------------ one sequence

def _port_batch(chunk, n_past):
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    attn = PagedAttentionParams(
        q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))), positions=pos,
        kv_lens=i32([kv_len]), block_tables=i32([list(range(-(-kv_len // BLOCK)))]),
        new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1]))
    return LanguageModelBatch(token_ids=i32(chunk), positions=pos, attention=attn,
                              sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
                              sample_dst_slots=i32([-1]))


def _jax_batch(chunk, n_past):
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    return JaxBatch(
        token_ids=i32(chunk), positions=pos,
        image_features=jnp.zeros((0, 48), jnp.float32), image_dst_idx=i32([]),
        attention=JaxParams(q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))),
                            positions=pos, kv_lens=i32([kv_len]),
                            block_tables=i32([list(range(-(-kv_len // BLOCK)))]),
                            new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1])),
        sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
        sample_dst_slots=i32([-1]))


def _generate(step, prompt, n_new):
    """Greedy tokens and every step's logits; step(chunk, n_past) -> (token,
    (V,) logits)."""
    out, all_logits, ids = [], [], list(prompt)
    for i in range(n_new):
        chunk = prompt if i == 0 else [ids[-1]]
        tok, logits = step(chunk, len(ids) - len(chunk))
        out.append(tok)
        all_logits.append(logits)
        ids.append(tok)
    return out, all_logits


def _port_stepper(lm, cache):
    def step(chunk, n_past):
        with torch.no_grad():
            _, tok, logits = lm.forward_with_logits(cache, _port_batch(chunk, n_past),
                                                    len(chunk))
        return int(tok[0]), logits[0].numpy()
    return step


def _jax_stepper(lm, cache):
    state = {"cache": cache}

    def step(chunk, n_past):
        state["cache"], tok, logits = lm.forward_with_logits(
            state["cache"], _jax_batch(chunk, n_past), max_q=len(chunk))
        return int(tok[0]), np.asarray(logits[0])
    return step, state


def test_logits_and_tokens_match_jax_and_hf(ckpt):
    path, hf = ckpt
    jf, pf = _factories(path)
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=9).tolist()
    ours, logits = _generate(_port_stepper(pf.getLanguageModel(),
                                           torch.zeros((2, 1, 16, BLOCK, 8, 12))), prompt, 6)
    jstep, _ = _jax_stepper(jf.getLanguageModel(), jnp.zeros((2, 1, 16, BLOCK, 8, 12)))
    ref, ref_logits = _generate(jstep, prompt, 6)
    for i, (a, b) in enumerate(zip(logits, ref_logits)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **JAX_TOL)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.tensor([prompt]), max_new_tokens=6,
                             do_sample=False)
    assert ours == ref == hf_out[0, len(prompt):].tolist()


def test_jax_int8_cache_stores_truncated_kv(ckpt):
    """The fault the port's refusal answers: with an int8 cache the JAX GPT-2
    casts K/V to int8 without a scale, so every |value| < 1 is stored as 0
    and the logits leave the f32 cache's."""
    jf, _ = _factories(ckpt[0])
    lm = jf.getLanguageModel()
    prompt = np.random.default_rng(2).integers(0, VOCAB, size=9).tolist()
    runs = {}
    for dtype in (jnp.float32, jnp.int8):
        step, state = _jax_stepper(lm, jnp.zeros((2, 1, 16, BLOCK, 8, 12), dtype))
        runs[dtype] = (step(prompt, 0)[1], np.asarray(state["cache"]))
    (f32_logits, f32_cache), (i8_logits, i8_cache) = runs[jnp.float32], runs[jnp.int8]
    written = f32_cache[:, 0].reshape(2, -1, 8, 12)[:, :len(prompt)]
    stored = i8_cache[:, 0].reshape(2, -1, 8, 12)[:, :len(prompt)]
    assert np.abs(written).max() < 127
    np.testing.assert_array_equal(stored, np.trunc(written).astype(np.int8))
    assert (stored == 0).mean() > 0.5
    assert np.abs(i8_logits - f32_logits).max() > 1e3 * JAX_TOL["atol"]


def test_int8_kv_and_int8_weights_are_refused(ckpt):
    with pytest.raises(ValueError, match="no int8 KV cache"):
        getModelFactory(ModelFactoryConfig(path=ckpt[0], dtype="fp32",
                                           kv_cache_dtype="int8"), "cpu")
    with pytest.raises(ValueError, match="no weight quantization"):
        getModelFactory(ModelFactoryConfig(path=ckpt[0], dtype="fp32",
                                           quantization="int8"), "cpu")


# ------------------------------------------------------------ engines

PROMPTS = ["! %&", "&&! %%", "%! &! %% &&! !", "&", "!% !% !% !% !% !%"]
MAX_TOKENS = (8, 8, 6, 10, 12)


def _requests(req_cls, sp_cls, temperature=0.0):
    return [req_cls(request_id=f"r{i}", prompt=p,
                    sampling_params=sp_cls(max_tokens=m, ignore_eos=True,
                                           temperature=temperature))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _port_engine(path, k=1, spec=0):
    _, pf = _factories(path)
    pf.getTokenizer = lambda: SimpleTokenizer(image_token="<image>", image_token_id=0,
                                              eos_token_id=1)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=16),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=BLOCK),
        kv_block_size=BLOCK, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=k,
        spec_ngram_k=spec)
    engine = OfflineEngine(cfg, model_factory=pf, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 16
    return engine


_JAX_TOKENS = {}


def _jax_tokens(path, spec=0):
    if spec not in _JAX_TOKENS:
        jf, _ = _factories(path)
        jf.getTokenizer = lambda: JaxTok(image_token="<image>", image_token_id=0,
                                         eos_token_id=1)
        cfg = JaxNodeConfig(
            batch_scheduler=JaxBSConfig(max_running_requests=16),
            request_processor=JaxRPConfig(num_request_process_workers=1, block_size=BLOCK),
            kv_block_size=BLOCK, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
            spec_ngram_k=spec)
        cfg.model.dtype = "fp32"
        engine = JaxOfflineEngine(cfg, model_factory=jf, node_type="PD")
        engine.node.batch_scheduler.token_budget = 16
        _JAX_TOKENS[spec] = ([o.output_token_ids for o in engine.generate(
            _requests(JaxRequest, JaxSP), timeout_s=600)],
            engine.node.executor.fill_executor.spec_steps)
    return _JAX_TOKENS[spec]


@pytest.mark.parametrize("k,spec", [(1, 0), (4, 0), (1, 3)], ids=["K1", "K4", "spec3"])
def test_engine_matches_jax_engine(ckpt, k, spec, monkeypatch):
    """GPT-2 runs single steps whatever window is configured (JAX's executor
    clamps it too), and neither engine speculates on it."""
    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    engine = _port_engine(ckpt[0], k, spec)
    cache = engine.node.kv_cache_manager.cache_array
    assert cache.shape[-2:] == (8, 12) and cache.dtype == torch.float32
    got = [o.output_token_ids for o in engine.generate(_requests(Request, SamplingParameters),
                                                       timeout_s=600)]
    ref, ref_spec_steps = _jax_tokens(ckpt[0], spec)
    assert [len(t) for t in got] == list(MAX_TOKENS)
    assert got == ref
    assert set(windows) == {1}
    assert engine.node.fill_executor.spec_steps == ref_spec_steps == 0


def test_sampled_request_is_refused(ckpt):
    engine = _port_engine(ckpt[0])
    with pytest.raises(ValueError, match="greedily only"):
        engine.generate(_requests(Request, SamplingParameters, temperature=0.8)[:1],
                        timeout_s=60)


def test_weight_bridge_carries_the_jax_gpt2_tree(ckpt):
    """The JAX converter's tree of (weight, bias) pairs, carried over by
    from_jax_numpy, is the port converter's leaf for leaf, and a model built
    on it gives the same prefill logits."""
    from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
    path = ckpt[0]
    jtree = jax_gpt2.convert_gpt2_weights(JaxWeightStore(path, cast_dtype="float32"), 2)
    bridged = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    ported = gpt2.convert_gpt2_weights(WeightStore(path, "fp32", "cpu"), 2)
    flat_b, spec_b = jax.tree_util.tree_flatten(bridged)
    flat_p, spec_p = jax.tree_util.tree_flatten(ported)
    assert spec_b == spec_p and len(flat_b) == 4 + 2 * 12
    for a, b in zip(flat_b, flat_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert isinstance(bridged["layers"][0]["c_attn"], tuple)
    cfg = gpt2.GPT2Config(n_layers=2, hidden_size=48, n_qo_heads=4, vocab_size=VOCAB,
                          max_position_embeddings=128)
    prompt = np.random.default_rng(5).integers(0, VOCAB, size=7).tolist()
    cache = lambda: torch.zeros((2, 1, 16, BLOCK, 8, 12))  # noqa: E731
    got = _port_stepper(gpt2.GPT2ForCausalLM(bridged, cfg), cache())(prompt, 0)[1]
    ref = _port_stepper(gpt2.GPT2ForCausalLM(ported, cfg), cache())(prompt, 0)[1]
    np.testing.assert_array_equal(got, ref)
