"""The process deployment as a whole against the JAX package, on the CPU.

A tiny 2-layer Llama checkpoint is built in process with transformers,
with a character-level tokenizer saved beside it, so that a node process
loads everything from the directory. The port's ProcessCluster serves it
with its nodes in spawned children (the LLaVA-1.5 case is
tests/test_torch_process_llava.py, which shares these helpers):

  - P + D on the Llama (prefill chunked at a 16-token budget, KV migrating
    between the processes), f32 and int8 weights with an int8 KV cache:
    the greedy tokens equal the JAX nodes' (P + D in process, as
    tests/test_torch_disagg.py wires them) on the same checkpoint;
  - P + D on the Llama against the JAX package's own ProcessCluster (its
    children run JAX on the CPU): the same tokens;
  - the entry point with deployment=process behind the API server (mirrors
    tests/entrypoint/test_api_server.py::test_api_server_over_process_cluster):
    a chat, a streamed chat and /metrics with both nodes' rows.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import string
import time

import aiohttp
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from hydrainfer_tpu.cluster.cluster import NodeSpec as JaxNodeSpec  # noqa: E402
from hydrainfer_tpu.cluster.migrate import MigrateGraphBuilder as JaxGraphBuilder  # noqa: E402
from hydrainfer_tpu.cluster.migrate import NodeType as JaxNodeType  # noqa: E402
from hydrainfer_tpu.cluster.node import AsyncEPDNode as JaxNode  # noqa: E402
from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.cluster.node import NodeContext as JaxNodeContext  # noqa: E402
from hydrainfer_tpu.cluster.process_node import ProcessCluster as JaxProcessCluster  # noqa: E402
from hydrainfer_tpu.cluster.process_node import \
    ProcessClusterConfig as JaxProcessClusterConfig  # noqa: E402
from hydrainfer_tpu.engine.output_token_processor import \
    LogOutputTokenProcessor as JaxLogProc  # noqa: E402
from hydrainfer_tpu.engine.output_token_processor import \
    OfflineOutputTokenProcessor as JaxOfflineProc  # noqa: E402
from hydrainfer_tpu.engine.output_token_processor import \
    OutputTokenParams as JaxOutputTokenParams  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessParameters as JaxRPParams  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.request import OfflineInferenceOutput as JaxOutput  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.cluster import NodeSpec  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.cluster.process_node import (ProcessCluster,  # noqa: E402
                                                       ProcessClusterConfig)
from hydrainfer_tpu_torch.engine.output_token_processor import \
    LogOutputTokenProcessor  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import (  # noqa: E402
    RequestProcessorConfig, RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402
from hydrainfer_tpu_torch.utils.socket_utils import find_free_port  # noqa: E402

TOKEN_BUDGET = 16


def save_char_tokenizer(path, vocab_size, image_id=None):
    """One token a character (ids 3 on), "<image>" at image_id as a special
    token; filler tokens up to vocab_size."""
    from transformers import PreTrainedTokenizerFast
    chars = list(string.ascii_lowercase + string.digits + " .,!?%&'-")
    vocab = ["<unk>", "<s>", "</s>"] + chars
    vocab += [f"<x{i}>" for i in range(vocab_size - len(vocab))]
    if image_id is not None:
        vocab[image_id] = "<image>"
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {t: i for i, t in enumerate(vocab)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Split("", "isolated")
    tok.decoder = tokenizers.decoders.Fuse()
    PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
        additional_special_tokens=["<image>"] if image_id is not None else None,
    ).save_pretrained(path)


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("process_llama")
    cfg = transformers.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=256)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().float().save_pretrained(
        path, safe_serialization=True)
    save_char_tokenizer(path, 256)
    return str(path)


QUANT = [("none", False), ("int8", True)]
QUANT_IDS = ["f32", "int8w_int8kv"]


def node_fields():
    return dict(kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=4,
                spec_ngram_k=0)


def set_model(model_cfg, path, quant, kv_int8, **extra):
    model_cfg.path = path
    model_cfg.dtype = "float32"
    model_cfg.quantization = quant
    model_cfg.kv_cache_dtype = "int8" if kv_int8 else "auto"
    model_cfg.kv_scale = 0.05
    for k, v in extra.items():
        setattr(model_cfg, k, v)


def port_node_config(path, quant, kv_int8) -> NodeConfig:
    cfg = NodeConfig(batch_scheduler=BatchSchedulerConfig(max_running_requests=4),
                     request_processor=RequestProcessorConfig(
                         num_request_process_workers=1, block_size=4),
                     **node_fields())
    cfg.profiler.default_token_budget = TOKEN_BUDGET
    set_model(cfg.model, path, quant, kv_int8)
    return cfg


def jax_node_config(path, quant, kv_int8) -> JaxNodeConfig:
    cfg = JaxNodeConfig(batch_scheduler=JaxBSConfig(max_running_requests=4),
                        request_processor=JaxRPConfig(num_request_process_workers=1,
                                                      block_size=4),
                        **node_fields())
    cfg.profiler.default_token_budget = TOKEN_BUDGET
    set_model(cfg.model, path, quant, kv_int8, attention_impl="jnp")
    return cfg


async def wait_done(procs, timeout_s=180):
    deadline = time.perf_counter() + timeout_s
    while not all(p.finished for p in procs):
        assert time.perf_counter() < deadline, \
            f"stalled: {[len(p.token_ids) for p in procs]}"
        await asyncio.sleep(0.05)


def serve(cluster, requests, params_cls, proc_cls):
    """Every request through a process cluster at once (its children were
    spawned when it was built); the tokens in request order, and the nodes'
    metrics rows."""
    async def run():
        procs = [proc_cls() for _ in requests]
        try:
            await cluster.start()
            for req, proc in zip(requests, procs):
                await cluster.add_request(req, params_cls(output_token_processors=[proc]))
            await wait_done(procs)
            metrics = await cluster.metrics_async()
        finally:
            await cluster.stop()
        assert not any(p.terminated for p in procs)
        return [p.token_ids for p in procs], metrics
    return asyncio.run(run())


def port_cluster(types, cfg):
    return ProcessCluster(ProcessClusterConfig(nodes=[NodeSpec(t, 1) for t in types],
                                               node=cfg, platform="cpu"))


def serve_port(cluster, requests):
    return serve(cluster, requests, RequestProcessParameters, LogOutputTokenProcessor)


def jax_in_process(types, cfg, requests):
    """The JAX nodes of `types` wired in this process, stepped in turn, each
    request entering the first node that takes it (the cluster's routing)."""
    factory = jax_get_factory(cfg.model)
    nodes = []
    for i, t in enumerate(types):
        node = JaxNode(cfg, JaxNodeContext(name=f"{t.lower()}{i}", node_type=JaxNodeType(t)))
        node.init(factory)
        nodes.append(node)
    builder = JaxGraphBuilder()
    for node in nodes:
        builder.add_node(node.name, node.context.node_type, node, tpot_slo=0.4)
    graph = builder.build_graph()
    for node in nodes:
        node.update_migrate_graph(graph)

    async def run():
        outs = [JaxOutput(arrival_time=time.perf_counter()) for _ in requests]
        done = []
        tokenizer = factory.getTokenizer()
        for req, out in zip(requests, outs):
            proc = JaxOfflineProc(out, tokenizer, on_finish=done.append)
            entry = next(n for n in nodes if (n.context.node_type.can_encode
                                               if req.image is not None
                                               else n.context.node_type.can_prefill))
            await entry.add_request(req, JaxRPParams(
                output_token_processors=[proc],
                output_token_params=JaxOutputTokenParams(stream_output=False)))
        deadline = time.perf_counter() + 300
        while len(done) < len(requests):
            for node in nodes:
                await node.step()
            await asyncio.sleep(0)
            assert time.perf_counter() < deadline, f"stalled: {len(done)}/{len(requests)}"
        return [o.output_token_ids for o in outs]
    return asyncio.run(run())


PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk", "mid size one"]
MAX_TOKENS = (20, 5, 20, 16, 20)


def text_requests(req_cls, sp_cls):
    return [req_cls(request_id=f"r{i}", prompt=p,
                    sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


@pytest.mark.parametrize("quant,kv_int8", QUANT, ids=QUANT_IDS)
def test_pd_processes_match_jax_nodes(llama_ckpt, quant, kv_int8):
    # the children boot while the JAX nodes serve the reference
    cluster = port_cluster(["P", "D"], port_node_config(llama_ckpt, quant, kv_int8))
    ref = jax_in_process(["P", "D"], jax_node_config(llama_ckpt, quant, kv_int8),
                         text_requests(JaxRequest, JaxSP))
    got, metrics = serve_port(cluster, text_requests(Request, SamplingParameters))
    assert [len(t) for t in got] == list(MAX_TOKENS)
    assert got == ref
    d_row = metrics["DNode:d0"]
    assert d_row["migration_pulls"] == len(PROMPTS)
    assert d_row["migration_shm_pulls"] == len(PROMPTS)


def test_pd_processes_match_jax_process_cluster(llama_ckpt):
    # the reference's liveness monitor is off (health_interval_s=0): it is
    # not what this test compares, and on a loaded CPU it declares a D child
    # dead while XLA compiles a decode window there; the JAX parent then ends
    # only the requests keyed to their entry node, and the rest hang. The
    # port cluster keeps its monitor.
    jax_cluster = JaxProcessCluster(JaxProcessClusterConfig(
        nodes=[JaxNodeSpec("P", 1), JaxNodeSpec("D", 1)],
        node=jax_node_config(llama_ckpt, "none", False), platform="cpu",
        health_interval_s=0))
    cluster = port_cluster(["P", "D"], port_node_config(llama_ckpt, "none", False))
    got, _ = serve_port(cluster, text_requests(Request, SamplingParameters))
    ref, jax_metrics = serve(jax_cluster, text_requests(JaxRequest, JaxSP), JaxRPParams,
                             JaxLogProc)
    assert got == ref
    assert jax_metrics["DNode:d0"]["migration_pulls"] == len(PROMPTS)


def test_api_server_over_process_cluster():
    """EntryPoint with deployment=process: the API server fronts nodes in
    separate OS processes; tokens stream back over the collector, and the
    migration crosses the P -> D process boundary."""
    cfg = EntryPointConfig()
    cfg.api_server.port = find_free_port()
    cfg.cluster.deployment = "process"
    cfg.cluster.platform = "cpu"
    cfg.cluster.nodes = [NodeSpec("P", 1), NodeSpec("D", 1)]
    cfg.cluster.node = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=8),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=256, n_image_blocks=16)
    cfg.cluster.node.model.name = "fake"
    cfg.cluster.node.model.dtype = "float32"
    entry = EntryPoint(cfg)
    assert isinstance(entry.cluster, ProcessCluster)
    assert len(entry.cluster.handles) == 2

    async def body():
        await entry.cluster.start()
        runner = await entry.api_server.start()
        base = f"http://127.0.0.1:{cfg.api_server.port}"
        try:
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{base}/health") as resp:
                    assert resp.status == 200
                payload = {"messages": [{"role": "user", "content": "hi you"}],
                           "max_tokens": 5, "ignore_eos": True}
                async with session.post(f"{base}/v1/chat/completions",
                                        json=payload) as resp:
                    assert resp.status == 200
                    data = await resp.json()
                    assert len(data["choices"][0]["message"]["content"]) > 0
                payload["stream"] = True
                async with session.post(f"{base}/v1/chat/completions",
                                        json=payload) as resp:
                    assert resp.status == 200
                    chunks, done = 0, False
                    async for line in resp.content:
                        if line.startswith(b"data:") and b"[DONE]" not in line:
                            chunks += 1
                        done = done or b"[DONE]" in line
                    assert chunks >= 5 and done
                async with session.get(f"{base}/metrics") as resp:
                    rows = await resp.json()
            assert set(rows) == {"PNode:p0", "DNode:d0"}
            assert rows["DNode:d0"]["migration_pulls"] == 2
        finally:
            await entry.cluster.stop()
            await runner.cleanup()

    asyncio.run(body())
    assert not any(h.proc.is_alive() for h in entry.cluster.handles)
