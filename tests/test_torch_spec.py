"""N-gram speculative decoding in the port against the JAX package, on the CPU
(mirrors tests/engine/test_spec_decode.py).

The proposer must return the JAX proposer's drafts (its cases and seeded
random contexts), and the backoff must walk 2 -> 4 -> ... -> 64. The gate:
the port's OfflineEngine at spec_ngram_k = 3 against the JAX one, both on the
same tiny-lm weights (and on mla-tiny-lm), two requests resident at a time so
that single steps speculate: the greedy tokens, and on tiny-lm the
executors' `spec_steps` and `spec_tokens`, must be identical, in f32 and
with int8 weights plus an int8 KV cache, with and without an eos token. The
port's own tokens must not change when speculation is turned off, and a
sampled batch (temperature 0.8, top-k 8, top-p 0.95) must speculate and end
with its token counts.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine.executor import FillExecutor as JaxFillExecutor
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine.executor import FillExecutor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.request import Request, SamplingParameters

REPETITIVE = "abc abc abc abc abc abc"
MIXED = ["the quick brown fox", REPETITIVE, "xyzw", "ab ab ab ab ab"]
MAX_TOKENS = 24
EOS = 40


@pytest.mark.parametrize("ctx,k,n", [
    ([1, 2, 7, 8, 9, 4, 5, 6, 3, 7, 8, 9], 3, 3),   # trigram hit
    ([1, 2, 7, 8, 9, 4, 5, 6, 3, 7, 8, 9], 2, 3),
    ([5, 6, 9, 9, 5, 6], 2, 3),                     # bigram fallback
    ([1, 2, 3, 4, 5], 4, 3),                        # no repeat
    ([1], 4, 3)])
def test_propose_ngram_jax_cases(ctx, k, n):
    assert FillExecutor.propose_ngram(ctx, k, n) == JaxFillExecutor.propose_ngram(ctx, k, n)


@pytest.mark.parametrize("seed", range(4))
def test_propose_ngram_random_contexts(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ctx = rng.integers(0, 6, size=rng.integers(1, 60)).tolist()
        k, n = int(rng.integers(1, 13)), int(rng.integers(2, 5))
        assert FillExecutor.propose_ngram(ctx, k, n) == \
            JaxFillExecutor.propose_ngram(ctx, k, n)


def test_spec_backoff_after_misses():
    """A proposer miss skips the next 2, 4, ... 64 eligible steps; a hit
    resets the ramp."""
    fx = FillExecutor.__new__(FillExecutor)
    fx._spec_skip = 0
    fx._spec_backoff = 0
    assert fx.spec_should_try()
    fx._spec_miss()
    assert [fx.spec_should_try() for _ in range(3)] == [False, False, True]
    fx._spec_miss()
    assert fx._spec_skip == 4
    for _ in range(4):
        fx.spec_should_try()
    for _ in range(8):
        fx._spec_miss()
    assert fx._spec_skip == 64
    fx._spec_hit()
    fx._spec_skip = 0
    assert fx.spec_should_try()
    fx._spec_miss()
    assert fx._spec_skip == 2


def _sp(cls, eos: bool, **kw):
    return cls(max_tokens=MAX_TOKENS, ignore_eos=not eos,
               eos_token_ids=[EOS] if eos else [], **kw)


def _node_kwargs(spec_k):
    return dict(kv_block_size=4, n_kv_blocks=512, spec_ngram_k=spec_k)


def run_jax(arch, quant, kv_scale, eos, spec_k=3, prompts=MIXED, max_running=2):
    factory = JaxFactory(arch, dtype=jnp.float32, quantization=quant, kv_scale=kv_scale)
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=max_running),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        n_image_blocks=1, **_node_kwargs(spec_k))
    cfg.model.dtype = "float32"
    if kv_scale is not None:
        cfg.model.kv_cache_dtype = "int8"
    engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="PD")
    reqs = [JaxRequest(request_id=f"r{i}", prompt=p, sampling_params=_sp(JaxSP, eos))
            for i, p in enumerate(prompts)]
    outs = engine.generate(reqs, timeout_s=600)
    fx = engine.node.executor.fill_executor
    return [o.output_token_ids for o in outs], (fx.spec_steps, fx.spec_tokens)


def port_engine(arch, quant, kv_scale, spec_k, weights=None, max_running=2):
    factory = RandomWeightFactory(arch, dtype=torch.float32, quantization=quant,
                                  kv_scale=kv_scale, device="cpu", weights=weights)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        **_node_kwargs(spec_k))
    return OfflineEngine(cfg, model_factory=factory, node_type="PD", device="cpu")


def run_port(arch, quant, kv_scale, eos, spec_k=3, weights=None, prompts=MIXED,
             max_running=2, **sampling):
    engine = port_engine(arch, quant, kv_scale, spec_k, weights, max_running)
    reqs = [Request(request_id=f"r{i}", prompt=p,
                    sampling_params=_sp(SamplingParameters, eos, **sampling))
            for i, p in enumerate(prompts)]
    outs = engine.generate(reqs, timeout_s=600)
    fx = engine.node.fill_executor
    return [o.output_token_ids for o in outs], (fx.spec_steps, fx.spec_tokens)


def jax_weights(arch, quant):
    tree = init_decoder_weights(JAX_ARCHS[arch], jax.random.PRNGKey(0), jnp.float32,
                                quantization=quant)
    return from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("eos", [False, True], ids=["ignore_eos", "eos"])
@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_port_spec_engine_matches_jax(quant, kv_scale, eos):
    got, got_counts = run_port("tiny-lm", quant, kv_scale, eos,
                               weights=jax_weights("tiny-lm", quant))
    ref, ref_counts = run_jax("tiny-lm", quant, kv_scale, eos)
    assert got == ref
    assert got_counts == ref_counts
    steps, tokens = got_counts
    assert steps > 0 and tokens > steps, "no verify step accepted a draft"
    if not eos:
        assert all(len(t) == MAX_TOKENS for t in got)


def test_port_spec_engine_matches_jax_mla():
    """The two repetitive prompts on a node that runs up to four: nothing
    waits, so the node takes single steps, each a chance to speculate."""
    kw = dict(prompts=MIXED[1::2], max_running=4)
    got, (steps, _) = run_port("mla-tiny-lm", "none", None, False,
                               weights=jax_weights("mla-tiny-lm", "none"), **kw)
    ref, _ = run_jax("mla-tiny-lm", "none", None, False, **kw)
    assert got == ref
    assert steps > 0


def test_spec_on_equals_spec_off():
    on, (steps, tokens) = run_port("tiny-lm", "none", None, False)
    off, off_counts = run_port("tiny-lm", "none", None, False, spec_k=0)
    assert on == off
    assert off_counts == (0, 0) and tokens > steps > 0


def test_spec_with_temperature(monkeypatch):
    """Sampled requests speculate too (rejection sampling): with drafts
    pinned (sampled contexts rarely repeat an n-gram), every request ends
    with its token count and the verify path ran."""
    monkeypatch.setattr(FillExecutor, "propose_ngram",
                        staticmethod(lambda ctx, k, n=3: [5, 6, 7][:k]))
    got, (steps, _) = run_port("tiny-lm", "none", None, False,
                               temperature=0.8, top_k=8, top_p=0.95)
    assert [len(t) for t in got] == [MAX_TOKENS] * len(MIXED)
    assert steps > 0


def _flat_inputs(pkg):
    """Three decoding requests, two of them sampling, in `pkg`'s types: the
    KV manager and the (rcb, inst) pairs, and drafts for a verify plan."""
    from hydrainfer_tpu import memory as jax_memory
    from hydrainfer_tpu.engine import isa as jax_isa
    from hydrainfer_tpu.engine.rcb import RequestControlBlock as JaxRCB
    from hydrainfer_tpu_torch import memory
    from hydrainfer_tpu_torch.engine import isa
    from hydrainfer_tpu_torch.engine.rcb import RequestControlBlock
    port = pkg == "port"
    mem, ns = (memory, isa) if port else (jax_memory, jax_isa)
    kv_cfg = mem.TokenCacheBlockManagerConfig(n_layers=1, n_tensors=1, n_blocks=64,
                                              block_size=4, n_heads=4, head_dim=8,
                                              dtype="fp32")
    kv = mem.TokenCacheBlockManager(kv_cfg, "cpu") if port else \
        mem.TokenCacheBlockManager(kv_cfg)
    sp = SamplingParameters if port else JaxSP
    pairs = []
    for i, (n_ctx, tok, controls) in enumerate([
            (9, -1, dict(temperature=0.7, top_k=5, top_p=0.9)),
            (14, 42, {}), (21, -1, dict(temperature=1.3))]):
        rcb = (RequestControlBlock if port else JaxRCB)()
        rcb.sampling_params = sp(max_tokens=32, **controls)
        rcb.token_slot = 3 + i
        rcb.virtual_kv_cache = kv.allocate_virtual_cache()
        kv.realloc(rcb.virtual_kv_cache, n_ctx + 4)
        nxt = ns.TextFill([-1], [n_ctx], [n_ctx], True, None, None)
        inst = ns.TextFill([tok], [n_ctx - 1], [n_ctx - 1], True, nxt, None)
        insts = ns.InstructionListBuilder()
        insts.append(inst)
        insts.append(nxt)
        rcb.instructions = insts.build()
        pairs.append((rcb, inst))
    return kv, pairs, [[5, 6, 7], [], [8]]


def test_sampled_buffers_match_jax():
    """The sampled fill buffer of the batch builder and the speculative
    verify plan (draft-length and sampling tails) are the JAX package's,
    seed included, with both seed counters at the same value."""
    from hydrainfer_tpu.engine.params_builder import \
        LanguageModelBatchBuilder as JaxBuilder
    from hydrainfer_tpu.models.factory import LanguageModelConfig as JaxLMConfig
    from hydrainfer_tpu_torch.engine.params_builder import LanguageModelBatchBuilder
    from hydrainfer_tpu_torch.engine.rcb import BatchRequest
    from hydrainfer_tpu.engine.rcb import BatchRequest as JaxBatchRequest
    plans = {}
    for pkg in ("jax", "port"):
        kv, pairs, drafts = _flat_inputs(pkg)
        if pkg == "port":
            builder = LanguageModelBatchBuilder(kv)
        else:
            builder = JaxBuilder(kv, None, JaxLMConfig(
                n_layers=1, max_position_embeddings=64, n_qo_heads=2, n_kv_heads=2,
                head_dim=16, eos_token_id=2, hidden_size=32, vocab_size=100), 9)
        (LanguageModelBatchBuilder if pkg == "port" else JaxBuilder)._seed_counter = 40
        for rcb, inst in pairs:
            builder.add(rcb, inst)
        fill = builder.build(s_floor=4)
        fx = (FillExecutor if pkg == "port" else JaxFillExecutor).__new__(
            FillExecutor if pkg == "port" else JaxFillExecutor)
        fx.kv, fx._s_highwater, fx._mb_highwater = kv, 4, 8
        batch = (BatchRequest if pkg == "port" else JaxBatchRequest)([r for r, _ in pairs])
        plans[pkg] = (fill, fx._build_spec_plan(batch, drafts, 4))
    for got, ref in zip(plans["port"], plans["jax"]):
        for f in ("T", "S", "MB", "max_q", "Ti", "sampling", "spec"):
            assert getattr(got.dims, f) == getattr(ref.dims, f), f
        np.testing.assert_array_equal(got.flat, np.asarray(ref.flat))
    fill, spec = plans["port"]
    assert fill.dims.sampling and spec.dims.sampling and spec.dims.spec == 4
