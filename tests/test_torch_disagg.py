"""EPD disaggregation in process: the port's nodes against the JAX package's.

E, P and D nodes (and the hybrid EP) run in one process on the CPU and hand
requests to each other through the 4-step migration protocol, pulling KV and
image-cache blocks from the source node (cluster/node.py).

  - Token parity: the same requests through JAX `AsyncEPDNode`s and the
    port's, wired P + D (tiny-lm in f32 and int8 weights / int8 KV, and
    mla-tiny-lm, whose single-plane latent cache migrates), and E + P + D and
    EP + D on random:tiny-lm+mm (CLIP_TINY) with the whole-tower and the
    layer-chunked encode (the JAX nodes serve each topology and format
    once, whole), with the JAX random weights carried over through the
    weight bridge: the greedy tokens must be equal (exact).
  - The data plane: `gather_blocks` / `scatter_blocks` against the JAX
    manager's on the same cache contents, for the combined-head KV cache
    (f32 and int8), MLA's single plane and the image cache (exact).
  - The protocol on the fake model (mirrors of
    tests/cluster/test_epd_migration.py and the in-process cases of
    tests/cluster/test_failure_recovery.py): P + D, E + P + D and EP + D
    serve, migrated blocks equal the source's (exact), decode windows are
    dispatched while a pull is in flight and /metrics reports the pulls,
    token slots do not leak, a failed hand-off retries on the next target
    (or falls back to the source itself), exhausted retries terminate and
    free, and a failed pull frees both sides.
  - Boot: with the budget search and the warm-up on, an E node builds no
    language model, KV pool or fill executor, a P node warms the decode
    keys and a D node probes no image.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hydrainfer_tpu.cluster.migrate import MigrateGraphBuilder as JaxGraphBuilder
from hydrainfer_tpu.cluster.migrate import NodeType as JaxNodeType
from hydrainfer_tpu.cluster.node import AsyncEPDNode as JaxNode
from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.cluster.node import NodeContext as JaxNodeContext
from hydrainfer_tpu.engine.output_token_processor import \
    OfflineOutputTokenProcessor as JaxOfflineProc
from hydrainfer_tpu.engine.output_token_processor import \
    OutputTokenParams as JaxOutputTokenParams
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessParameters as JaxRPParams
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.memory.token_cache import TokenCacheBlockManager as JaxTCBM
from hydrainfer_tpu.memory.token_cache import \
    TokenCacheBlockManagerConfig as JaxTCBMConfig
from hydrainfer_tpu.models import random_init as jax_random
from hydrainfer_tpu.request import OfflineInferenceOutput as JaxOutput
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.cluster import node_metrics
from hydrainfer_tpu_torch.cluster.migrate import MigrateGraphBuilder, NodeType
from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeConfig, NodeContext
from hydrainfer_tpu_torch.engine.output_token_processor import (
    LogOutputTokenProcessor, OfflineOutputTokenProcessor, OutputTokenParams)
from hydrainfer_tpu_torch.engine.request_processor import (RequestProcessorConfig,
                                                           RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig
from hydrainfer_tpu_torch.models.fake import FakeConfig, FakeModelFactory
from hydrainfer_tpu_torch.models.random_init import CLIP_TINY, RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy, from_jax_vision_numpy
from hydrainfer_tpu_torch.request import OfflineInferenceOutput, Request, SamplingParameters


# ------------------------------------------------------------------ helpers

def wire(nodes, builder_cls):
    builder = builder_cls()
    for node in nodes:
        builder.add_node(node.name, node.context.node_type, node, tpot_slo=0.4)
    graph = builder.build_graph()
    for node in nodes:
        node.update_migrate_graph(graph)


async def run_to_completion(nodes, requests, proc_cls, params_cls, out_cls,
                            token_params, timeout_s=120):
    """Send each request to the first node that takes it, as the cluster
    routes (an image request to an encoding node, a text one to a
    prefilling node), and step every node in turn until each has finished;
    the outputs in request order."""
    outs = [out_cls(arrival_time=time.perf_counter()) for _ in requests]
    done = []
    tokenizer = nodes[0].model_factory.getTokenizer()
    for req, out in zip(requests, outs):
        proc = proc_cls(out, tokenizer, on_finish=done.append)
        entry = next(n for n in nodes if (n.context.node_type.can_encode
                                           if req.image is not None
                                           else n.context.node_type.can_prefill))
        await entry.add_request(req, params_cls(output_token_processors=[proc],
                                                output_token_params=token_params))
    deadline = time.perf_counter() + timeout_s
    while len(done) < len(requests):
        for node in nodes:
            await node.step()
        await asyncio.sleep(0)
        assert time.perf_counter() < deadline, f"stalled: {len(done)}/{len(requests)}"
    return outs


def port_run(nodes, requests):
    return [o.output_token_ids for o in asyncio.run(run_to_completion(
        nodes, requests, OfflineOutputTokenProcessor, RequestProcessParameters,
        OfflineInferenceOutput, OutputTokenParams(stream_output=False)))]


def jax_run(nodes, requests):
    return [o.output_token_ids for o in asyncio.run(run_to_completion(
        nodes, requests, JaxOfflineProc, JaxRPParams, JaxOutput,
        JaxOutputTokenParams(stream_output=False)))]


def node_kwargs(k, n_image_blocks=4, chunk_layers=0):
    return dict(kv_block_size=4, n_kv_blocks=128, n_image_blocks=n_image_blocks,
                multi_step_decode=k, spec_ngram_k=0, encode_chunk_layers=chunk_layers)


def port_nodes(factory, types, max_running=4, k=4, token_budget=None, **kw):
    nodes = []
    for i, t in enumerate(types):
        cfg = NodeConfig(batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
                         request_processor=RequestProcessorConfig(
                             num_request_process_workers=1, block_size=4),
                         **node_kwargs(k, **kw))
        node = AsyncEPDNode(cfg, NodeContext(name=f"{t.lower()}{i}", node_type=NodeType(t),
                                             device="cpu"))
        node.init(factory)
        if token_budget:
            node.batch_scheduler.token_budget = token_budget
        nodes.append(node)
    wire(nodes, MigrateGraphBuilder)
    return nodes


def jax_nodes(factory, types, kv_int8, max_running=4, k=4, token_budget=None, **kw):
    nodes = []
    for i, t in enumerate(types):
        cfg = JaxNodeConfig(batch_scheduler=JaxBSConfig(max_running_requests=max_running),
                            request_processor=JaxRPConfig(num_request_process_workers=1,
                                                          block_size=4),
                            **node_kwargs(k, **kw))
        cfg.model.dtype = "float32"
        cfg.model.kv_cache_dtype = "int8" if kv_int8 else "auto"
        node = JaxNode(cfg, JaxNodeContext(name=f"{t.lower()}{i}", node_type=JaxNodeType(t)))
        node.init(factory)
        if token_budget:
            node.batch_scheduler.token_budget = token_budget
        nodes.append(node)
    wire(nodes, JaxGraphBuilder)
    return nodes


# ------------------------------------------------- token parity: P + D text

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk", "mid size one"]
MAX_TOKENS = (20, 5, 20, 16, 20)


def text_requests(req_cls, sp_cls):
    return [req_cls(request_id=f"r{i}", prompt=p,
                    sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch,quant,kv_scale", [
    ("tiny-lm", "none", None), ("tiny-lm", "int8", 0.05),
    ("mla-tiny-lm", "none", None), ("mla-tiny-lm", "int8", 0.05)],
    ids=["tiny_f32", "tiny_int8w_int8kv", "mla_f32", "mla_int8w_int8kv"])
def test_pd_tokens_match_jax_nodes(arch, quant, kv_scale):
    """P + D: the prompts prefill on P (chunked at a 16-token budget), their
    KV (MLA: the single latent plane) migrates to D, which decodes in fused
    K = 4 windows; the greedy tokens equal the JAX nodes'."""
    tree = jax_random.init_decoder_weights(jax_random.ARCH_CONFIGS[arch],
                                           jax.random.PRNGKey(0), jnp.float32,
                                           quantization=quant)
    pf = RandomWeightFactory(arch, dtype=torch.float32, quantization=quant,
                             kv_scale=kv_scale, device="cpu",
                             weights=from_jax_numpy(_np(tree), "cpu"))
    jf = jax_random.RandomWeightFactory(arch, dtype=jnp.float32, quantization=quant,
                                        kv_scale=kv_scale)
    port = port_nodes(pf, ["P", "D"], token_budget=16)
    got = port_run(port, text_requests(Request, SamplingParameters))
    ref = jax_run(jax_nodes(jf, ["P", "D"], kv_scale is not None, token_budget=16),
                  text_requests(JaxRequest, JaxSP))
    assert [len(t) for t in got] == list(MAX_TOKENS)
    assert got == ref
    p, d = port
    assert d._pull_stats["n"] == len(PROMPTS) and p._pull_stats["n"] == 0
    for node in port:
        kv = node.kv_cache_manager
        assert kv.block_allocator.n_free + len(kv.shared_cache._evictable) == kv.n_blocks
        assert node.batch_scheduler.metrics().n_requests_waiting_migrate == 0
        assert node.batch_scheduler._reserved_blocks == 0


# ------------------------------------ token parity: E + P + D and EP + D images

def image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def mm_requests(req_cls, sp_cls):
    sp = lambda n: sp_cls(max_tokens=n, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=image(64, 48, 1),
                    sampling_params=sp(8)),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp(8)),
            req_cls(request_id="m1", prompt="describe <image> now", image=image(56, 56, 2),
                    sampling_params=sp(6))]


def tiny_mm_factories(quant, kv_scale):
    lm = jax_random.init_decoder_weights(jax_random.ARCH_CONFIGS["tiny-lm"],
                                         jax.random.PRNGKey(0), jnp.float32,
                                         quantization=quant)
    vision = jax_random.init_clip_weights(jax_random.CLIP_TINY, jax.random.PRNGKey(1),
                                          jnp.float32, lm_hidden=128)
    pf = RandomWeightFactory("tiny-lm", dtype=torch.float32, quantization=quant,
                             kv_scale=kv_scale, device="cpu",
                             weights=from_jax_numpy(_np(lm), "cpu"), multimodal=True,
                             clip_cfg=CLIP_TINY,
                             vision_weights=from_jax_vision_numpy(_np(vision), "cpu"))
    jf = jax_random.RandomWeightFactory("tiny-lm", dtype=jnp.float32, quantization=quant,
                                        kv_scale=kv_scale, multimodal=True,
                                        clip_cfg=jax_random.CLIP_TINY)
    return pf, jf


# The JAX nodes serve each topology and format once a module, with the
# whole-tower encode, and the port's whole and chunked encodes are held to
# those tokens: the JAX package's own tests hold its chunked encode's tokens
# to the whole tower's (tests/engine/test_chunked_encode.py).
_JAX_TOKENS = {}


@pytest.mark.parametrize("chunk_layers", [0, 1], ids=["whole", "chunked"])
@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
@pytest.mark.parametrize("types", [["E", "P", "D"], ["EP", "D"]], ids=["e_p_d", "ep_d"])
def test_image_disagg_tokens_match_jax_nodes(types, quant, kv_scale, chunk_layers):
    """Image and text requests enter the encode node; image features migrate
    E -> P (general) and KV P -> D (both), with the whole-tower or the
    one-layer-segment encode on the encoding node; the greedy tokens equal
    the JAX nodes'."""
    pf, jf = tiny_mm_factories(quant, kv_scale)
    port = port_nodes(pf, types, chunk_layers=chunk_layers)
    got = port_run(port, mm_requests(Request, SamplingParameters))
    key = (tuple(types), quant)
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = jax_run(jax_nodes(jf, types, kv_scale is not None),
                                   mm_requests(JaxRequest, JaxSP))
    ref = _JAX_TOKENS[key]
    assert [len(t) for t in got] == [8, 8, 6]
    assert got == ref
    if types[0] == "E":
        e, p, d = port
        assert e.kv_cache_manager is None and e.fill_executor is None
        assert p._pull_stats["n"] == 2      # the two image requests' features
        assert d._pull_stats["n"] == 3
    else:
        assert port[1]._pull_stats["n"] == 3


# -------------------------------------------------- the data plane vs JAX's

@pytest.mark.parametrize("form", ["kv_f32", "kv_int8", "mla_plane", "image", "odd_int8"])
def test_gather_scatter_match_jax(form):
    """The same cache contents in the port's manager and in the JAX one:
    gather_blocks gives the JAX payload, and scatter_blocks of one payload
    leaves both caches equal (a float payload into the int8 cache is cast
    as JAX's astype casts it). odd_int8's blocks (45 bytes) do not divide
    into 8-byte words, so its copies index single elements."""
    layers, heads, dim, bs, dtype = {"kv_f32": (3, 4, 8, 4, "float32"),
                                     "kv_int8": (3, 4, 8, 4, "int8"),
                                     "mla_plane": (2, 1, 24, 4, "int8"),
                                     "image": (1, 4, 8, 4, "float32"),
                                     "odd_int8": (2, 3, 5, 3, "int8")}[form]
    kw = dict(n_layers=layers, n_tensors=1, n_blocks=12, block_size=bs, n_heads=heads,
              head_dim=dim, dtype=dtype)
    port = TokenCacheBlockManager(TokenCacheBlockManagerConfig(**kw), "cpu")
    ref = JaxTCBM(JaxTCBMConfig(**kw))
    rng = np.random.default_rng(0)
    shape = tuple(port.cache_array.shape)
    if dtype == "int8":
        contents = rng.integers(-127, 128, shape).astype(np.int8)
        payload = rng.integers(-127, 128, (3,) + shape[:2] + shape[3:]).astype(np.float32)
    else:
        contents = rng.standard_normal(shape).astype(np.float32)
        payload = rng.standard_normal((3,) + shape[:2] + shape[3:]).astype(np.float32)
    port.cache_array.copy_(torch.from_numpy(contents))
    ref.scatter_blocks(list(range(12)), np.moveaxis(contents, 2, 0))
    ids = [7, 2, 11, 0]
    got = port.gather_blocks(ids)
    assert tuple(got.shape) == (4,) + shape[:2] + shape[3:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.gather_blocks(ids)))
    port.scatter_blocks([5, 9, 1], payload)
    ref.scatter_blocks([5, 9, 1], payload)
    whole = np.moveaxis(np.asarray(ref.gather_blocks(list(range(12)))), 0, 2)
    np.testing.assert_array_equal(port.cache_array.numpy(), whole)
    assert port.cache_array.dtype == {"float32": torch.float32, "int8": torch.int8}[dtype]


# ------------------------------------------- the protocol on the fake model

def make_node(name, node_type, migrate_retries=2):
    cfg = NodeConfig(batch_scheduler=BatchSchedulerConfig(max_running_requests=8),
                     request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                              block_size=4),
                     kv_block_size=4, n_kv_blocks=128, n_image_blocks=16,
                     migrate_retries=migrate_retries)
    node = AsyncEPDNode(cfg, NodeContext(name=name, node_type=NodeType(node_type),
                                         device="cpu"))
    node.init(FakeModelFactory(ModelFactoryConfig(dtype="float32"), FakeConfig(), "cpu"))
    return node


def fake_wire(nodes):
    wire(nodes, MigrateGraphBuilder)


def fake_run(nodes, requests):
    return asyncio.run(run_to_completion(
        nodes, requests, OfflineOutputTokenProcessor, RequestProcessParameters,
        OfflineInferenceOutput, OutputTokenParams(stream_output=False), timeout_s=60))


def test_pd_disaggregation_text():
    """P node prefills, D node decodes; KV blocks migrate P -> D."""
    p, d = make_node("p0", "P"), make_node("d0", "D")
    fake_wire([p, d])
    reqs = [Request(request_id=i, prompt=f"hello number {i}",
                    sampling_params=SamplingParameters(max_tokens=6, ignore_eos=True))
            for i in range(4)]
    for out in fake_run([p, d], reqs):
        assert len(out.output_token_ids) == 6
    assert d.kv_cache_manager.block_allocator.n_free < d.kv_cache_manager.n_blocks
    assert p.batch_scheduler.metrics().n_requests_waiting_migrate == 0
    assert d._pull_stats["n"] == 4


def test_epd_disaggregation_image():
    """E encodes, P prefills (with the migrated image cache), D decodes."""
    e, p, d = make_node("e0", "E"), make_node("p1", "P"), make_node("d1", "D")
    fake_wire([e, p, d])
    assert e.kv_cache_manager is None and e.fill_executor is None
    assert e.worker.language_model is None and d.image_cache_manager is None
    reqs = [Request(request_id=f"img{i}", prompt="<image> describe", image=image(64, 64, i),
                    sampling_params=SamplingParameters(max_tokens=4, ignore_eos=True))
            for i in range(3)]
    for out in fake_run([e, p, d], reqs):
        assert len(out.output_token_ids) == 4
    assert p.kv_cache_manager.block_allocator.n_free < p.kv_cache_manager.n_blocks
    img = e.image_cache_manager
    assert img.block_allocator.n_free + len(img.shared_cache._evictable) == img.n_blocks
    assert (p._pull_stats["n"], d._pull_stats["n"]) == (3, 3)
    assert "kv_free_blocks" not in node_metrics(e) and node_metrics(e)["migrating_requests"] == 0


def test_hybrid_ep_d():
    """The EP node encodes and prefills, the D node decodes."""
    ep, d = make_node("ep0", "EP"), make_node("d2", "D")
    fake_wire([ep, d])
    reqs = [Request(request_id="mm", prompt="<image> what", image=image(64, 64, 1),
                    sampling_params=SamplingParameters(max_tokens=4, ignore_eos=True)),
            Request(request_id="tt", prompt="plain text",
                    sampling_params=SamplingParameters(max_tokens=4, ignore_eos=True))]
    assert all(len(o.output_token_ids) == 4 for o in fake_run([ep, d], reqs))
    assert (ep._pull_stats["n"], d._pull_stats["n"]) == (0, 2)


def test_migrated_kv_blocks_content():
    """The migrated KV content on the destination equals the source's."""
    p, d = make_node("p2", "P"), make_node("d3", "D")
    fake_wire([p, d])
    src = p.kv_cache_manager
    vc = src.allocate_virtual_cache()
    src.realloc(vc, 8)
    shape = tuple(src.cache_array.shape)
    data = np.random.default_rng(2).standard_normal(
        (2,) + shape[:2] + shape[3:]).astype(np.float32)
    src.scatter_blocks(vc.block_table, data)
    dst_vc = asyncio.run(d._pull_virtual_cache(p, vc, is_kv=True))
    assert dst_vc.n_cache_tokens == 8 and len(dst_vc.block_table) == 2
    np.testing.assert_array_equal(
        d.kv_cache_manager.gather_blocks(dst_vc.block_table).numpy(), data)
    assert d._pull_stats["bytes"] == data.nbytes


def test_decode_proceeds_during_pull():
    """A pull is a background task: while a migrated request's blocks are in
    transit (here a slowed pull that yields), the destination keeps
    dispatching decode windows for its resident request; /metrics reports
    the pulls."""
    p, d = make_node("p5", "P"), make_node("d5", "D")
    fake_wire([p, d])
    pull_windows = []
    orig_pull = d._pull_virtual_cache

    async def slow_pull(src_node, src_vc, is_kv):
        t0 = time.perf_counter()
        for _ in range(10):
            await asyncio.sleep(0.02)
        out = await orig_pull(src_node, src_vc, is_kv)
        pull_windows.append((t0, time.perf_counter()))
        return out

    d._pull_virtual_cache = slow_pull
    fill_times = []
    orig_exec = d.fill_executor.execute

    def spy(batch, n_steps=1):
        if len(batch):
            fill_times.append(time.perf_counter())
        return orig_exec(batch, n_steps=n_steps)

    d.fill_executor.execute = spy

    async def scenario():
        done, outs = [], []
        tokenizer = p.model_factory.getTokenizer()

        async def submit(req):
            out = OfflineInferenceOutput(arrival_time=time.perf_counter())
            outs.append(out)
            proc = OfflineOutputTokenProcessor(out, tokenizer, on_finish=done.append)
            await p.add_request(req, RequestProcessParameters(
                output_token_processors=[proc],
                output_token_params=OutputTokenParams(stream_output=False)))

        await submit(Request(request_id="resident", prompt="long decoder",
                             sampling_params=SamplingParameters(max_tokens=60,
                                                                ignore_eos=True)))
        deadline = time.perf_counter() + 60
        sent = False
        while len(done) < 2:
            for node in (p, d):
                await node.step()
            await asyncio.sleep(0)
            if not sent and len(outs[0].output_token_ids) >= 3:
                sent = True
                await submit(Request(request_id="migrator", prompt="late arriving request",
                                     sampling_params=SamplingParameters(max_tokens=5,
                                                                        ignore_eos=True)))
            assert time.perf_counter() < deadline, "stalled"
        return outs

    outs = asyncio.run(scenario())
    assert len(outs[0].output_token_ids) == 60 and len(outs[1].output_token_ids) == 5
    assert len(pull_windows) == 2
    t0, t1 = pull_windows[1]
    overlapped = [t for t in fill_times if t0 < t < t1]
    assert len(overlapped) >= 3, f"{len(overlapped)} fills in the {t1 - t0:.3f} s pull"
    m = node_metrics(d)
    assert m["migration_pulls"] == 2
    assert m["migration_pull_s_total"] > 0.4
    assert m["migration_pull_mb"] > 0


def test_migration_does_not_leak_token_slots():
    """A migrated request takes no token slot of the source to the
    destination: no duplicate or foreign slot in either free list, and
    every slot back at the end."""
    p, d = make_node("p4", "P"), make_node("d4", "D")
    fake_wire([p, d])
    reqs = [Request(request_id=f"s{i}", prompt=f"slot check {i}",
                    sampling_params=SamplingParameters(max_tokens=5, ignore_eos=True))
            for i in range(6)]
    fake_run([p, d], reqs)
    for node in (p, d):
        free = node.fill_executor._free_slots
        table = int(node.fill_executor.token_table.shape[0])
        assert len(free) == len(set(free)), f"{node.name}: duplicate slots"
        assert all(0 <= s < table - 1 for s in free), f"{node.name}: foreign slot id"
        assert len(free) == node.config.token_table_size


# ----------------------------------------------------- failure recovery

def fail_requests(n, max_tokens=6):
    return [Request(request_id=f"f{i}", prompt=f"failure test req {i}",
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


async def drive(nodes, procs, timeout_s=30):
    deadline = time.perf_counter() + timeout_s
    while not all(p.finished for p in procs):
        for node in nodes:
            await node.step()
        await asyncio.sleep(0)
        assert time.perf_counter() < deadline, f"stalled: {[p.finished for p in procs]}"


def reclaimed(node) -> bool:
    """Every KV block free or unpinned into the prefix cache."""
    mgr = node.kv_cache_manager
    return mgr.block_allocator.n_free + len(mgr.shared_cache._evictable) == mgr.n_blocks


async def _broken_migrate(src_node, rcb):
    raise ConnectionError("node down")


def test_migrate_retry_lands_on_next_target():
    """A dead decode node's migrate fails; the retry picks the next target
    and the request completes there."""
    p, d_bad, d_good = make_node("p0", "P"), make_node("dbad", "D"), make_node("dgood", "D")
    fake_wire([p, d_bad, d_good])
    d_bad.migrate = _broken_migrate

    async def run():
        procs = [LogOutputTokenProcessor() for _ in range(4)]
        for req, proc in zip(fail_requests(4), procs):
            await p.add_request(req, RequestProcessParameters(output_token_processors=[proc]))
        await drive([p, d_good], procs)
        return procs

    procs = asyncio.run(run())
    assert all(pr.finished and not pr.terminated for pr in procs)
    assert all(len(pr.token_ids) == 6 for pr in procs)
    assert d_good.kv_cache_manager.block_allocator.n_free < d_good.kv_cache_manager.n_blocks
    assert p.batch_scheduler.metrics().n_requests_waiting_migrate == 0
    assert p.batch_scheduler._reserved_blocks == 0 and reclaimed(p)


def test_migrate_retry_falls_back_to_this_node():
    """Two EPD replicas: a hand-off whose target fails and whose retry picks
    the source itself serves the request there, with its reservation given
    back; nothing is left migrating or reserved."""
    a, b = make_node("epd0", "EPD"), make_node("epd1", "EPD")
    fake_wire([a, b])
    failed, restored = [], []

    async def broken(src_node, rcb):
        failed.append(rcb.request_id)
        raise ConnectionError("node down")

    b.migrate = broken
    orig_restore = a.batch_scheduler.restore_reservation
    a.batch_scheduler.restore_reservation = lambda rcb, need: (
        restored.append(need), orig_restore(rcb, need))

    async def run():
        procs = [LogOutputTokenProcessor() for _ in range(2)]
        for req, proc in zip(fail_requests(2), procs):
            await a.add_request(req, RequestProcessParameters(output_token_processors=[proc]))
        await drive([a], procs)
        return procs

    procs = asyncio.run(run())
    assert all(pr.finished and not pr.terminated and len(pr.token_ids) == 6
               for pr in procs)
    assert a.batch_scheduler.metrics().n_requests_waiting_migrate == 0
    assert a.batch_scheduler._reserved_blocks == 0 and reclaimed(a)
    assert a._pull_stats["n"] == 0 and b._pull_stats["n"] == 0
    # the second request's hand-off went to epd1, failed, and came back
    assert failed == ["f1"] and len(restored) == 1 and restored[0] > 0


def test_migrate_exhausted_retries_terminates_and_frees():
    """Every decode target down: after the retries the request is terminated
    (no fabricated token) and the source frees its blocks and migrating
    count."""
    p, d = make_node("p1", "P", migrate_retries=1), make_node("d1", "D")
    fake_wire([p, d])
    d.migrate = _broken_migrate

    async def run():
        procs = [LogOutputTokenProcessor() for _ in range(2)]
        for req, proc in zip(fail_requests(2), procs):
            await p.add_request(req, RequestProcessParameters(output_token_processors=[proc]))
        await drive([p], procs)
        return procs

    procs = asyncio.run(run())
    assert all(pr.terminated and len(pr.token_ids) <= 1 for pr in procs)
    assert p.batch_scheduler.metrics().n_requests_waiting_migrate == 0
    assert p.batch_scheduler._reserved_blocks == 0 and reclaimed(p)
    assert len(p.fill_executor._free_slots) == p.config.token_table_size


def test_failed_pull_frees_source_blocks():
    """A pull that fails mid-transfer frees the source's blocks and
    migrating count and the destination's, and terminates the request."""
    p, d = make_node("p2", "P"), make_node("d2", "D")
    fake_wire([p, d])
    orig = d._pull_virtual_cache
    fail = {"n": 2}

    async def flaky_pull(src_node, src_vc, is_kv):
        if fail["n"] > 0:
            fail["n"] -= 1
            raise ConnectionError("transfer interrupted")
        return await orig(src_node, src_vc, is_kv)

    d._pull_virtual_cache = flaky_pull

    async def run():
        procs = [LogOutputTokenProcessor() for _ in range(3)]
        for req, proc in zip(fail_requests(3), procs):
            await p.add_request(req, RequestProcessParameters(output_token_processors=[proc]))
        await drive([p, d], procs)
        return procs

    procs = asyncio.run(run())
    assert sum(pr.terminated for pr in procs) == 2
    assert sum(pr.finished and not pr.terminated for pr in procs) == 1
    for node in (p, d):
        assert reclaimed(node), node.name
        assert node.batch_scheduler.metrics().n_requests_waiting_migrate == 0
        assert node.batch_scheduler._reserved_blocks == 0
        assert len(node.fill_executor._free_slots) == node.config.token_table_size


def test_each_node_type_boots(monkeypatch):
    """With the budget search and the boot warm-up on (tiny-lm + CLIP_TINY,
    CPU): an E node builds no language model, KV pool or fill executor and
    searches only its image budget; a P node warms the decode keys, as the
    JAX node does (it guards on the KV cache only); a D node has no image
    cache, probes no image and ratchets no image-gather floor."""
    from hydrainfer_tpu_torch.engine import profiler as port_profiler
    from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig
    encodes = []
    orig = port_profiler.BatchSchedulerProfiler._time_encode
    monkeypatch.setattr(port_profiler.BatchSchedulerProfiler, "_time_encode",
                        lambda self, n: encodes.append(n) or orig(self, n))
    pf, _ = tiny_mm_factories("none", None)
    nodes = {}
    for t in ("E", "P", "D"):
        cfg = NodeConfig(profiler=BatchSchedulerProfilerConfig(enabled=True, max_image_budget=2,
                                                               max_token_budget=64),
                         boot_warmup=True, multi_step_decode=4,
                         batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
                         request_processor=RequestProcessorConfig(
                             num_request_process_workers=1, block_size=4),
                         kv_block_size=4, n_kv_blocks=64, n_image_blocks=4)
        before = len(encodes)
        node = AsyncEPDNode(cfg, NodeContext(name=t.lower(), node_type=NodeType(t),
                                             device="cpu"))
        node.init(pf)
        nodes[t] = (node, len(encodes) - before)
    e, e_probes = nodes["E"]
    assert e.worker.language_model is None and e.kv_cache_manager is None
    assert e.fill_executor is None and e.image_embed_executor is not None and e_probes > 0
    assert e.image_cache_manager.n_blocks == 4
    p, p_probes = nodes["P"]
    assert p_probes == 0 and p.image_cache_manager is not None
    decode_keys = {n for d, n in p.fill_executor._seen_fill_keys if d.max_q == 1}
    assert decode_keys == {1, 2, 4}
    d, d_probes = nodes["D"]
    assert d_probes == 0 and d.image_cache_manager is None
    assert d.fill_executor._ti_highwater == 0
    assert {n for dims, n in d.fill_executor._seen_fill_keys if dims.max_q == 1} == {1, 2, 4}
