"""The port's pipeline-parallel engine against the JAX single-device engine
(CPU; the JAX package's own tests/parallel/test_pipeline.py holds its PP
engine to its single-device tokens, so no JAX PP engine is compiled here).

A node over two CPU devices with `parallel="pp"` (each stage one of
tiny-lm's two layers, both on the one CPU) serves the requests of
tests/test_torch_tp_engine.py and must emit the JAX single-device engine's
greedy tokens, in f32 and with int8 weights and an int8 KV cache, with both
of its step forms run: the relay (prefill and mixed steps) and the
microbatched decode (pure decode steps of an even S). Also:

- one resident request, whose decode steps (S = 1 < pp) all take the relay;
- migration between PP degrees: P pp 2 -> D pp 1 and P pp 1 -> D pp 2;
- `ClusterConfig(pp_size=2)` over four devices forms two node groups of two
  stages (EP + D), and the entry point serves at `cluster.pp_size=2` on
  `cluster.platform=cpu` as at 1;
- the refusals: pp_size with tp_size in the cluster (as the JAX cluster),
  pp_size with deployment=process, GPT-2 (no pipeline-parallel form), a
  model whose first layer is dense and the others MoE (DeepSeek-V2-Lite's
  shape; the JAX pp_pack_weights asserts the same), and `forward` and
  `forward_with_logits` of a pipeline-parallel model.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time

import pytest
import torch

from hydrainfer_tpu_torch.cluster.cluster import Cluster, ClusterConfig
from hydrainfer_tpu_torch.cluster.migrate import MigrateGraphBuilder, NodeType
from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeConfig, NodeContext
from hydrainfer_tpu_torch.config import load_config
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from tests.test_torch_tp_engine import (PROMPTS, QUANT_IDS, QUANTS, _node_cfg, _requests,
                                        jax_tiny_tokens, tiny_factory)

PP = ["cpu", "cpu"]


def serve(factory, devices, requests, parallel="pp", **cfg_kw):
    engine = OfflineEngine(NodeConfig(**_node_cfg(**cfg_kw)), model_factory=factory,
                           node_type="PD", device=devices, parallel=parallel)
    engine.node.batch_scheduler.token_budget = 16
    return engine, [o.output_token_ids for o in engine.generate(requests, timeout_s=600)]


@pytest.mark.parametrize("quant,kv_scale", QUANTS, ids=QUANT_IDS)
def test_tiny_lm_pp_engine_matches_jax_single_device(quant, kv_scale):
    engine, got = serve(tiny_factory(quant, kv_scale), PP, _requests())
    lm = engine.node.worker.language_model
    assert lm.weights is None and not lm.supports_multi_step
    assert [(st.first, st.n_layers) for st in lm.stages.stages] == [(0, 1), (1, 1)]
    steps = lm.stages.steps
    assert steps["relay"] > 0 and steps["micro"] > 0, steps
    caches = engine.node.kv_cache_manager.cache_array
    # one layer a stage, every head
    assert [tuple(c.shape[:1]) + tuple(c.shape[-2:]) for c in caches] == [(1, 4, 32)] * 2
    assert caches[0].dtype == (torch.int8 if kv_scale else torch.float32)
    assert got == jax_tiny_tokens(quant, kv_scale)[:len(PROMPTS)]


def test_single_request_takes_the_relay():
    """One resident request: its decode batches have S = 1, fewer rows than
    stages, so every step takes the relay (the JAX gate's S >= pp), and its
    tokens are the JAX engine's for that prompt."""
    engine, got = serve(tiny_factory("none", None), PP, _requests(PROMPTS[:1], (16,)))
    steps = engine.node.worker.language_model.stages.steps
    assert steps["micro"] == 0 and steps["relay"] > 0, steps
    assert got == jax_tiny_tokens("none", None)[:1]
    _, one = serve(tiny_factory("none", None), "cpu", _requests(PROMPTS[:1], (16,)),
                   parallel="tp")
    assert got == one


def _node(name, node_type, devices, quant="none", kv_scale=None):
    node = AsyncEPDNode(NodeConfig(**_node_cfg()), NodeContext(
        name=name, node_type=NodeType(node_type), device=devices, parallel="pp"))
    node.init(tiny_factory(quant, kv_scale))
    node.batch_scheduler.token_budget = 16
    return node


def _serve_nodes(nodes, add):
    """Every node stepped in turn until the requests, added through
    `add`, finish."""
    async def run():
        procs = [LogOutputTokenProcessor() for _ in PROMPTS]
        for req, proc in zip(_requests(), procs):
            await add(req, RequestProcessParameters(output_token_processors=[proc]))
        deadline = time.perf_counter() + 120
        while not all(p.finished for p in procs):
            for node in nodes:
                await node.step()
            await asyncio.sleep(0)
            assert time.perf_counter() < deadline, [len(p.token_ids) for p in procs]
        return [p.token_ids for p in procs]

    return asyncio.run(run())


@pytest.mark.parametrize("p_pp,d_pp", [(2, 1), (1, 2)])
def test_migration_between_pp_degrees(p_pp, d_pp):
    """A P node hands its requests to a D node, which pulls their KV blocks:
    gathered from the source's stage shards (its layer runs) into the
    single-device layout and scattered into the destination's."""
    devices = lambda pp: "cpu" if pp == 1 else ["cpu"] * pp  # noqa: E731
    p, d = _node("p", "P", devices(p_pp)), _node("d", "D", devices(d_pp))
    for node, pp in ((p, p_pp), (d, d_pp)):
        cache = node.kv_cache_manager.cache_array
        assert isinstance(cache, list) == (pp > 1)
    builder = MigrateGraphBuilder()
    for node in (p, d):
        builder.add_node(node.name, node.context.node_type, node, tpot_slo=0.4)
    graph = builder.build_graph()
    for node in (p, d):
        node.update_migrate_graph(graph)
    assert _serve_nodes([p, d], p.add_request) == jax_tiny_tokens("none", None)[:len(PROMPTS)]
    assert d.metrics()["migration_pulls"] == len(PROMPTS)
    steps = (d if d_pp > 1 else p).worker.language_model.stages.steps
    assert steps["micro" if d_pp > 1 else "relay"] > 0


def test_cluster_pp_groups_serve_disaggregated():
    """pp_size=2 over four devices: two node groups of two stages each,
    which the auto topology makes EP + D; the D group decodes in the
    microbatched form, and the tokens are the JAX engine's."""
    cfg = ClusterConfig(pp_size=2)
    cfg.node = NodeConfig(**_node_cfg())
    cluster = Cluster(cfg, devices=[torch.device("cpu")] * 4,
                      model_factory_provider=lambda: tiny_factory("none", None))
    assert [(n.name, len(n.devices), n.context.parallel) for n in cluster.nodes] == \
        [("EPNode:ep0", 2, "pp"), ("DNode:d0", 2, "pp")]
    for n in cluster.nodes:
        assert n.worker.language_model.stages.pp == 2
        n.batch_scheduler.token_budget = 16
    assert _serve_nodes(cluster.nodes, cluster.add_request) == \
        jax_tiny_tokens("none", None)[:len(PROMPTS)]
    assert cluster.nodes[1].metrics()["migration_pulls"] == len(PROMPTS)
    assert cluster.nodes[1].worker.language_model.stages.steps["micro"] > 0


def test_entry_point_serves_at_pp_size_2():
    """The OpenAI-compatible entry point in process with cluster.pp_size=2
    on the CPU (both stages on it): a chat completion over HTTP equals pp
    1's."""
    from tests.test_torch_online import SERVE_YAML, TINY, ServedEntryPoint, free_port, post

    texts = []
    for pp in (1, 2):
        port = free_port()
        entry = EntryPoint(load_config(EntryPointConfig, SERVE_YAML, [
            *TINY, "cluster.node.model.name=random:tiny-lm", f"cluster.pp_size={pp}",
            f"api_server.port={port}"]))
        lm = entry.cluster.nodes[0].worker.language_model
        assert (lm.stages is not None) == (pp > 1)
        server = ServedEntryPoint(entry, port)
        try:
            out = post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "pipeline parallel"}],
                "max_tokens": 8, "ignore_eos": True})
        finally:
            assert server.stop() == []
        assert out["usage"]["completion_tokens"] == 8
        texts.append(out["choices"][0]["message"])
    assert texts[0] == texts[1]


@pytest.mark.parametrize("overrides,refusal", [
    (("cluster.pp_size=2", "cluster.tp_size=2"), "pp_size > 1 with tp_size > 1"),
    (("cluster.pp_size=2", "cluster.deployment=process"),
     "pp_size > 1 with deployment=process")], ids=["pp_and_tp", "process"])
def test_cluster_refuses_pp_with_tp_or_process(overrides, refusal):
    cfg = load_config(EntryPointConfig, None, [
        "cluster.node.model.name=fake", "cluster.platform=cpu", *overrides])
    with pytest.raises(NotImplementedError, match=refusal):
        EntryPoint(cfg)


def test_models_without_a_uniform_pipeline_form_are_refused():
    """GPT-2's layer loop has no stage form; a model whose first layer is
    dense and whose other layers are MoE (DeepSeek-V2-Lite's shape) has no
    uniform layer signature. A node on two stages refuses both where the
    JAX node would run GPT-2 unsharded."""
    from hydrainfer_tpu_torch.models.gpt2 import GPT2ForCausalLM

    class GPT2Factory(RandomWeightFactory):
        def getLanguageModel(self):
            return GPT2ForCausalLM({"wte": torch.zeros(8, 4)}, None)

    class DenseFirstFactory(RandomWeightFactory):
        def getLanguageModel(self):
            lm = super().getLanguageModel()
            for lw in lm.weights["layers"][1:]:
                lw["moe_router"] = torch.zeros(128, 4)
            return lm

    for factory, refusal in ((GPT2Factory, "GPT2ForCausalLM has no pipeline-parallel form"),
                             (DenseFirstFactory, r"layer 1's weights and layer 0's differ "
                                                 r"in \['moe_router'\]")):
        node = AsyncEPDNode(NodeConfig(**_node_cfg()), NodeContext(
            node_type=NodeType("PD"), device=PP, parallel="pp"))
        with pytest.raises(NotImplementedError, match=refusal):
            node.init(factory("tiny-lm", device="cpu"))


def test_pp_model_has_no_whole_weight_forward():
    """Under PP the unsharded weights are let go (as in the JAX model, whose
    forward then has no weights to read): forward and forward_with_logits
    raise, and the model serves through forward_flat only. The same
    devices again are a no-op; other devices need a model of their own."""
    lm = tiny_factory("none", None).getLanguageModel()
    lm.shard_to_pp(PP)
    stages = lm.stages
    lm.shard_to_pp(PP)
    assert lm.stages is stages
    with pytest.raises(ValueError, match="needs a model of its own"):
        lm.shard_to_pp(["cpu"] * 4)
    with pytest.raises(ValueError, match="already sharded"):
        lm.shard_to(PP)
    for call in (lambda: lm.forward(None, None, None, 1),
                 lambda: lm.forward_with_logits(None, None, 1)):
        with pytest.raises(NotImplementedError, match="under pipeline parallelism"):
            call()
