"""The port's shape-key floors and boot decode warm-up against the JAX
package, on the CPU (tiny-lm, f32).

The floors on S, MB and Ti bound the key set of the port's CUDA graphs as
they bound the JAX package's compile keys:
  (a) the batch builder with floors gives the JAX builder's T, S, MB, max_q,
      Ti and flat buffer for the same batch (text, M-RoPE, image-bearing);
  (b) with the boot warm-up, the port's executor dispatches exactly the JAX
      executor's (dims, n_steps) keys for the same requests, and the greedy
      tokens match;
  (c) warm_decode gives back every KV block and token slot it took, dispatches
      the JAX warm-up's keys, and the engine serves afterwards;
  (d) after the boot warm-up a serving pass moves no floor;
  (e) during a drain the decode keys' S and MB never fall, and the tail of
      a run adds at most 2 keys;
  (f) a CPU node builds no graph, whatever cuda_graphs says;
  (g) graph captures and token waits from other threads never overlap,
      under contention (a stand-in event).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine import isa as jax_isa
from hydrainfer_tpu.engine.params_builder import \
    LanguageModelBatchBuilder as JaxBuilder
from hydrainfer_tpu.engine.profiler import BatchSchedulerProfiler as JaxProfiler
from hydrainfer_tpu.engine.profiler import \
    BatchSchedulerProfilerConfig as JaxProfilerConfig
from hydrainfer_tpu.engine.rcb import RequestControlBlock as JaxRCB
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.memory import TokenCacheBlockManager as JaxKV
from hydrainfer_tpu.memory import TokenCacheBlockManagerConfig as JaxKVConfig
from hydrainfer_tpu.models.factory import LanguageModelConfig as JaxLMConfig
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine import executor as port_executor
from hydrainfer_tpu_torch.engine import isa
from hydrainfer_tpu_torch.engine.params_builder import LanguageModelBatchBuilder
from hydrainfer_tpu_torch.engine.profiler import warm_decode
from hydrainfer_tpu_torch.engine.rcb import RequestControlBlock
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.factory import fill_sizes
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.request import Request, SamplingParameters

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk", "mid size one"]
MAX_TOKENS = (24, 5, 24, 20, 24)
KEY = lambda d, n: (d.T, d.S, d.MB, d.max_q, d.Ti, n)   # noqa: E731


# ------------------------------------------------------- (a) the builders

def _kv_pair(block_size=4, n_blocks=256):
    cfg = dict(n_layers=1, n_tensors=1, n_blocks=n_blocks, block_size=block_size,
               n_heads=4, head_dim=8, dtype="fp32")
    img = dict(n_layers=1, n_tensors=1, n_blocks=32, block_size=8, n_heads=2,
               head_dim=16, dtype="fp32")
    return ((JaxKV(JaxKVConfig(**cfg)), JaxKV(JaxKVConfig(**img))),
            (TokenCacheBlockManager(TokenCacheBlockManagerConfig(**cfg), "cpu"),
             TokenCacheBlockManager(TokenCacheBlockManagerConfig(**img), "cpu")))


def _batch(kind: str, rng):
    """A fill batch as (n_ctx, token_slot, n_img_tokens, fill args, image
    mask or None) rows: a prefill, a resolved and an unresolved decode, a
    chunk head, and for "image" an image prefill; "decode" is three decodes."""
    rows = []
    toks = [int(t) for t in rng.integers(0, 90, 7)]
    rows.append((7, 5, 0, (toks, list(range(7)), list(range(7)), True, True), None))
    rows.append((13, 6, 0, ([42], [12], [12], True, True), None))
    rows.append((21, 7, 0, ([-1], [20], [20], True, True), None))
    head = [int(t) for t in rng.integers(0, 90, 6)]
    rows.append((6, 8, 0, (head, list(range(6)), list(range(6)), True, False), None))
    if kind == "decode":
        rows = [rows[1], rows[2], (40, 9, 0, ([-1], [39], [39], True, True), None)]
    if kind == "image":
        rows.append((5, 9, 3, ([1, 9, 9, 9, 2], list(range(5)), list(range(5)), True, True),
                     [False, True, True, True, False]))
    return rows


def _build(pkg, kv, img, rows, mrope, floors):
    ns = isa if pkg == "port" else jax_isa
    dummy = ns.TextFill([-1], [99], [99], True, None, None)
    if pkg == "port":
        builder = LanguageModelBatchBuilder(kv, img, mrope)
    else:
        lcfg = JaxLMConfig(n_layers=1, max_position_embeddings=1024, n_qo_heads=2,
                           n_kv_heads=2, head_dim=16, eos_token_id=2, hidden_size=32,
                           vocab_size=100, mrope_section=(2, 3, 3) if mrope else ())
        builder = JaxBuilder(kv, img, lcfg, image_token_id=9)
    vcs = []
    for n_ctx, slot, n_img, (toks, pos, cids, sample, dst), mask in rows:
        rcb = (RequestControlBlock if pkg == "port" else JaxRCB)()
        rcb.sampling_params = (SamplingParameters if pkg == "port" else JaxSP)(max_tokens=8)
        rcb.token_slot = slot
        rcb.virtual_kv_cache = kv.allocate_virtual_cache()
        kv.realloc(rcb.virtual_kv_cache, n_ctx)
        vcs.append((kv, rcb.virtual_kv_cache))
        if mask is not None:
            rcb.virtual_image_cache = img.allocate_virtual_cache()
            img.realloc(rcb.virtual_image_cache, n_img)
            vcs.append((img, rcb.virtual_image_cache))
            inst = ns.ImageEmbedFill(list(range(n_img)), mask, toks, pos, cids, sample,
                                     dummy if dst else None, None)
        else:
            inst = ns.TextFill(toks, pos, cids, sample, dummy if dst else None, None)
        if mrope:
            inst.mrope_hw = [[p + 1 for p in pos], [2 * p for p in pos]]
        builder.add(rcb, inst)
    plan = builder.build(*floors)
    for mgr, vc in vcs:
        mgr.realloc(vc, 0)
    return plan


@pytest.mark.parametrize("floors", [(1, 1, 0), (8, 64, 0), (5, 51, 1152), (3, 7, 100)],
                         ids=["none", "s8_mb64", "s5_mb51_ti1152", "s3_mb7_ti100"])
@pytest.mark.parametrize("kind,mrope", [("text", False), ("decode", False),
                                        ("text", True), ("image", True),
                                        ("image", False)])
def test_builder_floors_match_jax(kind, mrope, floors):
    (jkv, jimg), (pkv, pimg) = _kv_pair()
    rows = _batch(kind, np.random.default_rng(0))
    ref = _build("jax", jkv, jimg, rows, mrope, floors)
    got = _build("port", pkv, pimg, rows, mrope, floors)
    for f in ("T", "S", "MB", "max_q", "Ti", "mrope"):
        assert getattr(got.dims, f) == getattr(ref.dims, f), f
    np.testing.assert_array_equal(got.flat, np.asarray(ref.flat))
    # a graph key's device buffer is exactly this long
    assert len(got.flat) == sum(fill_sizes(got.dims))


# --------------------------------------------------- engines (b) - (f)

def _jax_weights():
    tree = init_decoder_weights(JaxFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                                jnp.float32)
    return from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _jax_engine(boot_warmup: bool, max_running: int = 5):
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=max_running, priority="prefill"),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        n_image_blocks=1, kv_block_size=4, n_kv_blocks=256, multi_step_decode=16,
        spec_ngram_k=0)
    cfg.model.dtype = "float32"
    cfg.boot_warmup = boot_warmup
    # no budget search: it would add timed fills (and their keys) at boot
    cfg.profiler.enabled = False
    engine = JaxOfflineEngine(cfg, model_factory=JaxFactory("tiny-lm", dtype=jnp.float32),
                              node_type="PD")
    engine.node.batch_scheduler.token_budget = 24
    return engine


def _port_engine(weights=None, max_running: int = 5, **node_kw):
    factory = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu",
                                  weights=weights)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=256, **{"multi_step_decode": 16, **node_kw})
    engine = OfflineEngine(cfg, model_factory=factory, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 24
    return engine


def _requests(req, sp, prompts=PROMPTS, max_tokens=MAX_TOKENS):
    return [req(request_id=f"r{i}", prompt=p,
                sampling_params=sp(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(prompts, max_tokens))]


def test_boot_warmup_key_set_matches_jax():
    jax_engine = _jax_engine(boot_warmup=True)
    ref = [o.output_token_ids for o in jax_engine.generate(
        _requests(JaxRequest, JaxSP), timeout_s=600)]
    jfx = jax_engine.node.executor.fill_executor
    port = _port_engine(_jax_weights(), boot_warmup=True)
    got = [o.output_token_ids for o in port.generate(_requests(Request, SamplingParameters),
                                                     timeout_s=600)]
    fx = port.node.fill_executor
    assert got == ref
    assert ({KEY(d, n) for d, n in fx._seen_fill_keys}
            == {KEY(d, n) for d, n in jfx._seen_fill_keys})
    # (Ti: the JAX PD node keeps an image cache even for a text-only model,
    # and floors Ti for it; the port's text-only node has none)
    assert (fx._s_highwater, fx._mb_highwater) == (jfx._s_highwater, jfx._mb_highwater)


def test_warm_decode_matches_jax_and_leaves_nothing_behind():
    engine = _port_engine()
    fx, kv = engine.node.fill_executor, engine.node.kv_cache_manager
    free_blocks, free_slots = kv.n_available_blocks(), len(fx._free_slots)
    warm_decode(fx, kv, 4, 4)
    assert kv.n_available_blocks() == free_blocks
    assert len(fx._free_slots) == free_slots
    assert fx._s_highwater >= 4

    jax_engine = _jax_engine(boot_warmup=False)
    jfx = jax_engine.node.executor.fill_executor
    JaxProfiler(JaxProfilerConfig(enabled=True), jax_engine.node.executor,
                jax_engine.node.kv_cache_manager,
                jax_engine.node.image_cache_manager).warm_decode(4, 4)
    assert ({KEY(d, n) for d, n in fx._seen_fill_keys}
            == {KEY(d, n) for d, n in jfx._seen_fill_keys})
    # the engine still serves afterwards
    outs = engine.generate([Request(request_id="w0", prompt="hello there",
                                    sampling_params=SamplingParameters(
                                        max_tokens=6, ignore_eos=True))], timeout_s=300)
    assert len(outs[0].output_token_ids) == 6


def test_boot_warmup_converges_floors():
    engine = _port_engine(boot_warmup=True, multi_step_decode=4)
    fx = engine.node.fill_executor
    # the envelope: S >= max_running, MB >= the fair-share context in blocks
    assert fx._s_highwater >= 5
    assert fx._mb_highwater >= (256 * 4 // 5) // 4
    floors = (fx._s_highwater, fx._mb_highwater)
    reqs = [Request(request_id=f"b{i}", prompt="some words here to prefill",
                    sampling_params=SamplingParameters(max_tokens=20, ignore_eos=True))
            for i in range(5)]
    outs = engine.generate(reqs, timeout_s=600)
    assert [len(o.output_token_ids) for o in outs] == [20] * 5
    assert (fx._s_highwater, fx._mb_highwater) == floors


@pytest.mark.parametrize("boot_warmup", [False, True], ids=["ratchet", "boot_warmup"])
def test_drain_makes_no_key_churn(boot_warmup, monkeypatch):
    dims_seen = []
    orig = port_executor.FillExecutor.execute

    def spy(self, batch, n_steps=1):
        fut = orig(self, batch, n_steps=n_steps)
        if getattr(fut, "plan", None) is not None:
            dims_seen.append(fut.plan.dims)
        return fut

    monkeypatch.setattr(port_executor.FillExecutor, "execute", spy)
    engine = _port_engine(boot_warmup=boot_warmup, multi_step_decode=4)
    dims_seen.clear()       # the warm-up's own steps
    outs = engine.generate(_requests(Request, SamplingParameters,
                                     max_tokens=(12, 3, 12, 7, 12)), timeout_s=600)
    assert [len(o.output_token_ids) for o in outs] == [12, 3, 12, 7, 12]
    decode = [d for d in dims_seen if d.max_q == 1]
    assert decode, "no decode steps observed"
    for a, b in zip(decode, decode[1:]):
        assert b.S >= a.S and b.MB >= a.MB
    assert len({(d.T, d.S, d.MB, d.max_q) for d in decode[len(decode) // 2:]}) <= 2


@pytest.mark.parametrize("cuda_graphs", [True, False], ids=["graphs_on", "graphs_off"])
def test_cpu_node_builds_no_graph(cuda_graphs):
    engine = _port_engine(cuda_graphs=cuda_graphs, boot_warmup=True)
    assert engine.node.fill_executor.graphs is None
    outs = engine.generate(_requests(Request, SamplingParameters), timeout_s=600)
    assert [len(o.output_token_ids) for o in outs] == list(MAX_TOKENS)
    assert engine.node.fill_executor.graphs is None


def test_capture_gate_holds_under_contention():
    """The order between graph captures and token waits from other threads
    (models/step_graphs.py) under contention, on the CPU with a stand-in
    event: 16 threads wait over and over while the main thread enters the
    capture gate 200 times; no wait's synchronize ever runs inside the
    gate, and inside it no wait is counted."""
    import sys
    import threading
    import time
    from hydrainfer_tpu_torch.models import step_graphs
    state = {"capturing": False, "overlaps": 0, "waits": 0}

    class Event:
        def synchronize(self):
            if state["capturing"]:
                state["overlaps"] += 1
            time.sleep(0.0002)
            state["waits"] += 1

    stop = threading.Event()

    def waiter():
        while not stop.is_set():
            step_graphs.wait_event(Event())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=waiter) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for _ in range(200):
            with step_graphs._no_waits():
                assert step_graphs._waits == 0
                state["capturing"] = True
                time.sleep(0.0002)
                state["capturing"] = False
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert state["overlaps"] == 0 and state["waits"] > 0
    assert step_graphs._waits == 0 and not step_graphs._capturing
