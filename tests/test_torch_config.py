"""The port's config tree against the JAX package's (mirrors tests/test_config.py).

Every YAML preset under config/, config/cluster/ and config/node/ loads
through both packages' loaders, and every field the two dataclass trees
share has the same value (`DIVERGENT` lists the shared fields whose default
differs on purpose: none since speculative decoding is ported, with the JAX
default spec_ngram_k = 12). Overrides coerce alike, unknown keys raise in both, a TPU-only key is
accepted and logged, a still-to-port feature raises with its queue item (the
in-process Cluster refuses the process deployment's settings, which
EntryPoint hands to a ProcessCluster with the JAX topology's nodes),
and every preset builds its cluster on the CPU: the multi-node ones (general
E / P / D, hybrid EP + D, explicit node lists and replicas) with the JAX
cluster's node names, types and migrate tables.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import dataclasses
import glob
import os
import textwrap

import pytest
import torch

from hydrainfer_tpu.cluster.cluster import spec_node_config as jax_spec_node_config
from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.cluster.process_node import ProcessCluster as JaxProcessCluster
from hydrainfer_tpu.cluster.process_node import \
    ProcessClusterConfig as JaxProcessClusterConfig
from hydrainfer_tpu.config import load_config as jax_load_config
from hydrainfer_tpu.entrypoint.entrypoint import EntryPointConfig as JaxEntryPointConfig
from hydrainfer_tpu_torch.cluster import node as node_mod
from hydrainfer_tpu_torch.cluster.cluster import (Cluster, NodeSpec,
                                                  resolve_cluster_topology,
                                                  spec_node_config)
from hydrainfer_tpu_torch.cluster.migrate import NodeType
from hydrainfer_tpu_torch.cluster.node import (TPU_ONLY_FIELDS, AsyncEPDNode, NodeConfig,
                                               NodeContext, tpu_only_settings)
from hydrainfer_tpu_torch.cluster.process_node import ProcessCluster
from hydrainfer_tpu_torch.config import build_dataclass, load_config
from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml"))
             + glob.glob(os.path.join(REPO, "config", "cluster", "*.yaml")))
NODE = sorted(glob.glob(os.path.join(REPO, "config", "node", "*.yaml")))
# shared fields whose default differs on purpose
DIVERGENT = {}
FAKE = ["cluster.node.model.name=fake", "cluster.node.n_kv_blocks=32",
        "cluster.node.n_image_blocks=4", "cluster.node.profiler.enabled=false",
        "cluster.platform=cpu"]


def shared_diffs(a, b, path=""):
    """(path, a_value, b_value) of every field both trees hold with
    different values; dataclass fields only one side has are skipped."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        names_b = {f.name for f in dataclasses.fields(b)}
        out = []
        for f in dataclasses.fields(a):
            if f.name in names_b:
                out += shared_diffs(getattr(a, f.name), getattr(b, f.name),
                                    f"{path}.{f.name}" if path else f.name)
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in shared_diffs(x, y, f"{path}[{i}]")]
    return [] if a == b else [(path, a, b)]


def assert_shared_equal(jax_cfg, port_cfg):
    diffs = shared_diffs(jax_cfg, port_cfg)
    for path, a, b in diffs:
        leaf = path.rsplit(".", 1)[-1]
        assert DIVERGENT.get(leaf) == (a, b), f"{path}: JAX {a!r}, port {b!r}"


@pytest.mark.parametrize("path", TOP + NODE,
                         ids=[os.path.relpath(p, REPO) for p in TOP + NODE])
def test_every_preset_loads_in_both_trees_with_equal_shared_values(path):
    if path in NODE:
        jax_cfg = jax_load_config(JaxNodeConfig, path)
        port_cfg = load_config(NodeConfig, path)
    else:
        jax_cfg = jax_load_config(JaxEntryPointConfig, path)
        port_cfg = load_config(EntryPointConfig, path)
    assert_shared_equal(jax_cfg, port_cfg)
    if path in TOP:
        # each node spec's materialized config (its config/node/*.yaml overlay
        # over the cluster-wide node config)
        assert len(port_cfg.cluster.nodes) == len(jax_cfg.cluster.nodes)
        for jax_spec, spec in zip(jax_cfg.cluster.nodes, port_cfg.cluster.nodes):
            assert isinstance(spec, NodeSpec)
            assert_shared_equal(jax_spec_node_config(jax_cfg.cluster.node, jax_spec),
                                spec_node_config(port_cfg.cluster.node, spec))


def test_serve_preset_values():
    cfg = load_config(EntryPointConfig, os.path.join(REPO, "config", "serve.yaml"))
    node = cfg.cluster.node
    assert (node.batch_scheduler.max_running_requests, node.multi_step_decode,
            node.profiler.enabled, node.profiler.tpot_slo, node.n_kv_blocks,
            node.spec_ngram_k, node.batch_scheduler.chunked_prefill) == \
        (64, 8, True, 0.4, -1, 0, True)
    assert cfg.cluster.platform is None      # the card


OVERRIDES = [
    "api_server.port=9123", "api_server.host=0.0.0.0",
    "cluster.node.n_kv_blocks=512", "cluster.node.hbm_utilization=0.75",
    "cluster.node.batch_scheduler.chunked_prefill=false",
    "cluster.node.batch_scheduler.priority=decode",
    "cluster.node.profiler.enabled=yes", "cluster.node.profiler.tpot_slo=0.25",
    "cluster.node.boot_warmup=true", "cluster.node.model.name=random:tiny-lm",
    "cluster.node.model.kv_scale=0.1", "cluster.platform=cpu",
    "cluster.nodes=[{node_type: P, n_replicas: 2}, {node_type: D}]",
]


def test_overrides_coerce_alike():
    jax_cfg = jax_load_config(JaxEntryPointConfig, None, OVERRIDES)
    port_cfg = load_config(EntryPointConfig, None, OVERRIDES)
    assert_shared_equal(jax_cfg, port_cfg)
    node = port_cfg.cluster.node
    assert (node.n_kv_blocks, node.hbm_utilization, node.profiler.enabled,
            node.boot_warmup, node.batch_scheduler.chunked_prefill) == (512, 0.75, True,
                                                                        True, False)
    assert all(isinstance(s, NodeSpec) for s in port_cfg.cluster.nodes)
    assert port_cfg.cluster.nodes[0].n_replicas == 2


@pytest.mark.parametrize("text", ["api_server:\n  portt: 1\n",
                                  "cluster:\n  node:\n    tokn_budget: 4\n",
                                  "cluster:\n  node:\n    model:\n      nme: x\n"])
def test_unknown_key_raises_in_both(tmp_path, text):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    with pytest.raises(ValueError, match="unknown config keys"):
        jax_load_config(JaxEntryPointConfig, str(p))
    with pytest.raises(ValueError, match="unknown config keys"):
        load_config(EntryPointConfig, str(p))


def test_token_budget_moved_to_the_profiler_config():
    """NodeConfig.token_budget is gone: the budget is
    profiler.default_token_budget (the search's default), as in JAX."""
    assert "token_budget" not in {f.name for f in dataclasses.fields(NodeConfig)}
    with pytest.raises(ValueError, match="unknown config keys"):
        build_dataclass(NodeConfig, {"token_budget": 8})
    cfg = load_config(NodeConfig, None, ["profiler.default_token_budget=24"])
    node = AsyncEPDNode(cfg, NodeContext(node_type=NodeType("PD"), device="cpu"))
    node.init(_fake_factory())
    assert node.batch_scheduler.token_budget == 24


def _fake_factory():
    from hydrainfer_tpu_torch.models.fake import FakeModelFactory
    return FakeModelFactory(device="cpu")


@pytest.mark.parametrize("override,value", [
    ("kv_cache_ref=false", False), ("pipeline_mode=sync", "sync"),
    ("threaded_postprocess=true", True), ("max_threaded_backlog=8", 8),
    ("boot_warmup_prefill_ladder=true", True), ("model.attention_impl=pallas", "pallas"),
    ("model.layer_loop=unroll", "unroll")])
def test_tpu_only_key_is_accepted_and_logged(override, value, monkeypatch):
    key = override.split("=")[0]
    assert key in TPU_ONLY_FIELDS
    cfg = load_config(NodeConfig, None, [override])
    assert tpu_only_settings(cfg) == {key: value}
    logged = []
    monkeypatch.setattr(node_mod.logger, "warning", lambda msg: logged.append(msg))
    AsyncEPDNode(cfg, NodeContext(node_type=NodeType("PD"), device="cpu"))
    assert len(logged) == 1 and key in logged[0] and "TPU-only" in logged[0]
    logged.clear()
    AsyncEPDNode(NodeConfig(), NodeContext(node_type=NodeType("PD"), device="cpu"))
    assert logged == []


def test_strict_preset_logs_its_tpu_only_key(monkeypatch):
    cfg = load_config(NodeConfig, os.path.join(REPO, "config", "node", "strict.yaml"))
    assert tpu_only_settings(cfg) == {"kv_cache_ref": False}
    assert (cfg.multi_step_decode, cfg.async_pipeline_depth,
            cfg.adaptive_postprocess) == (4, 12, False)


@pytest.mark.parametrize("override,item", [("log_latency_breakdown=true", "item 10")])
def test_still_to_port_feature_raises_with_its_queue_item(override, item):
    """No node setting is refused any more: each one a queue item once
    refused (log_latency_breakdown, item 10) now loads and builds a node
    that keeps it (tests/test_torch_breakdown.py runs it)."""
    key, value = override.split("=")
    cfg = load_config(NodeConfig, None, [override])
    assert getattr(cfg, key) is (value == "true")
    node = AsyncEPDNode(cfg, NodeContext(node_type=NodeType("PD"), device="cpu"))
    assert getattr(node.config, key) is (value == "true")
    node.init(_fake_factory())


@pytest.mark.parametrize("node_type", ["EPD", "PD"])
def test_encode_chunk_layers_builds_a_node(node_type):
    """The layer-chunked encode is ported: encode_chunk_layers=2 builds a
    node, on random:tiny-lm+mm with chunking enabled where it encodes."""
    cfg = load_config(NodeConfig, None, ["encode_chunk_layers=2", "model.name=random:tiny-lm+mm",
                                         "model.dtype=float32", "n_kv_blocks=64",
                                         "n_image_blocks=4", "kv_block_size=4"])
    node = AsyncEPDNode(cfg, NodeContext(node_type=NodeType(node_type), device="cpu"))
    node.init()
    iee = node.image_embed_executor
    if node_type == "EPD":
        assert iee.chunk_layers == 2 and iee.chunking_enabled() and not iee.busy
    else:
        assert iee is None


@pytest.mark.parametrize("override", ["spec_ngram_k=4", "spec_ngram_k=0"])
def test_spec_ngram_k_builds_a_node(override):
    """Speculative decoding is ported: any spec_ngram_k builds a node, and
    the default is the JAX package's."""
    cfg = load_config(NodeConfig, None, [override])
    assert cfg.spec_ngram_k == int(override.split("=")[1])
    AsyncEPDNode(cfg, NodeContext(node_type=NodeType("PD"), device="cpu"))
    assert NodeConfig().spec_ngram_k == JaxNodeConfig().spec_ngram_k == 12


@pytest.mark.parametrize("override,refusal", [
    (("cluster.deployment=process", "cluster.tp_size=2"),
     "tp_size > 1 with deployment=process"),
    # pipeline parallelism is ported; with tensor parallelism it is refused,
    # as the JAX cluster refuses it (the case keeps its first id)
    pytest.param(("cluster.pp_size=2", "cluster.tp_size=2"), "pp_size > 1 with tp_size > 1",
                 id="cluster.pp_size=2-queue 1, item 9b"),
    ("cluster.deployment=process", "ProcessCluster"),
    ("cluster.nodes=[{node_type: P, attach_addr: 'tcp://127.0.0.1:5555'}, "
     "{node_type: D}]", "ProcessCluster")])
def test_cluster_refuses_what_is_not_ported(override, refusal):
    """The in-process Cluster refuses pipeline parallelism together with
    tensor parallelism (as the JAX Cluster does) and the process
    deployment's settings, which belong to ProcessCluster (the JAX Cluster
    ignores them and builds the nodes in process); the entry point refuses
    tp_size > 1 with deployment=process, whose node processes run on one
    device each (the JAX ProcessCluster ignores tp_size). With deployment=process, EntryPoint builds a ProcessCluster
    whose nodes have the JAX ProcessCluster's names and types (one EPD node
    for a cluster_type preset, as the JAX one resolves it); an attach spec
    spawns nothing and takes its name from the node's first ping."""
    overrides = list(override) if isinstance(override, tuple) else [override]
    cfg = load_config(EntryPointConfig, None, FAKE + overrides)
    if cfg.cluster.tp_size > 1:
        with pytest.raises(NotImplementedError, match=refusal):
            EntryPoint(cfg)
        return
    with pytest.raises(NotImplementedError, match=refusal):
        Cluster(cfg.cluster)
    if refusal != "ProcessCluster":
        return
    overrides = FAKE + [override, "cluster.deployment=process"]
    cluster = EntryPoint(load_config(EntryPointConfig, None, overrides)).cluster
    c = jax_load_config(JaxEntryPointConfig, None, overrides).cluster
    jax_cluster = JaxProcessCluster(JaxProcessClusterConfig(
        cluster_type=c.cluster_type, nodes=c.nodes, node=c.node, platform="cpu"))
    try:
        assert isinstance(cluster, ProcessCluster)
        assert ([(h.name, str(h.node_type), h.addr if h.proc is None else None)
                 for h in cluster.handles]
                == [(h.name, str(h.node_type), h.addr if h.proc is None else None)
                    for h in jax_cluster.handles])
        assert [h.proc.name for h in cluster.handles if h.proc is not None] == \
            [h.name for h in cluster.handles if h.proc is not None]
    finally:
        for cl in (cluster, jax_cluster):     # children that were never started
            for h in cl.handles:
                h.client.close()
                if h.proc is not None:
                    h.proc.terminate()
                    h.proc.join(timeout=30)
                    assert not h.proc.is_alive()
            cl.token_sock.close(linger=0)


def test_tp_size_2_builds_a_cluster_on_the_cpu():
    """cluster.tp_size=2 with cluster.platform=cpu: the one CPU device wraps
    round into one node of two ranks, which shards tiny-lm over them."""
    cfg = load_config(EntryPointConfig, None, [
        "cluster.node.model.name=random:tiny-lm", "cluster.node.model.dtype=float32",
        "cluster.node.n_kv_blocks=32", "cluster.node.profiler.enabled=false",
        "cluster.platform=cpu", "cluster.tp_size=2"])
    cluster = Cluster(cfg.cluster)
    assert [(n.name, [str(d) for d in n.devices]) for n in cluster.nodes] == \
        [("EPDNode:epd0", ["cpu", "cpu"])]
    assert cluster.nodes[0].worker.language_model.tp_size == 2
    assert len(cluster.nodes[0].kv_cache_manager.cache_array) == 2


def topology(cluster):
    """Node names and types, and the migrate graph as {source: [target,
    ...]} per table (every node holds the same graph)."""
    graph = cluster.nodes[0].context.migrate_graph
    assert all(n.context.migrate_graph is graph for n in cluster.nodes)
    return ([(n.name, str(n.context.node_type)) for n in cluster.nodes],
            {k: [t.name for t in v] for k, v in graph.ep_table.items()},
            {k: [t.name for t in v] for k, v in graph.pd_table.items()})


def jax_topology(path, overrides):
    """The JAX cluster's topology, built on the CPU from the same config."""
    from hydrainfer_tpu.cluster.cluster import Cluster as JaxCluster
    return topology(JaxCluster(jax_load_config(JaxEntryPointConfig, path, overrides).cluster))


def check_nodes(cluster):
    """Each node holds the models and caches of its type, on the CPU."""
    for n in cluster.nodes:
        nt = n.context.node_type
        assert n.device == torch.device("cpu")
        assert (n.kv_cache_manager is not None) == nt.has_kv_cache
        assert (n.image_cache_manager is not None) == nt.has_image_cache
        assert (n.fill_executor is not None) == nt.has_kv_cache
        assert (n.worker.language_model is not None) == nt.has_language_model
        assert (n.worker.vision_model is not None) == nt.has_vision_model


@pytest.mark.parametrize("override", [
    "cluster.nodes=[{node_type: EP}, {node_type: D}]",
    "cluster.nodes=[{node_type: EPD, n_replicas: 2}]",
    "cluster.nodes=[{node_type: E}, {node_type: P}, {node_type: D, n_replicas: 2}]",
    "cluster.nodes=[{node_type: P}, {node_type: D}, {node_type: D}]"],
    ids=["ep_d", "epd_x2", "e_p_dx2", "p_d_d_two_specs"])
def test_cluster_builds_multi_node_topology(override):
    """Explicit node lists and replicas build on the one CPU device with the
    JAX cluster's names (unique within a type, two specs of one type too),
    types and migrate tables."""
    cfg = load_config(EntryPointConfig, None, FAKE + [override])
    cluster = Cluster(cfg.cluster)
    assert len(cluster.nodes) > 1
    assert topology(cluster) == jax_topology(None, FAKE + [override])
    check_nodes(cluster)


def test_cluster_model_factory_choices():
    """The nodes share a factory given to the cluster (one weight copy),
    take one each from a provider, or build one each from the config."""
    from hydrainfer_tpu_torch.models.fake import FakeModelFactory
    cfg = load_config(EntryPointConfig, None, FAKE + [
        "cluster.nodes=[{node_type: EP}, {node_type: D}]"])
    shared = FakeModelFactory(device="cpu")
    made = []
    for kw in ({"model_factory": shared},
               {"model_factory_provider": lambda: made.append(FakeModelFactory(
                   device="cpu")) or made[-1]},
               {}):
        factories = [n.model_factory for n in Cluster(cfg.cluster, **kw).nodes]
        if "model_factory" in kw:
            assert factories == [shared, shared]
        else:
            assert len(set(map(id, factories))) == 2
            assert isinstance(factories[0], FakeModelFactory)
    assert len(made) == 2


def test_defaults():
    cfg = load_config(EntryPointConfig)
    assert cfg.api_server.port == 8000
    assert cfg.cluster.cluster_type == "auto"
    assert cfg.cluster.node.kv_block_size == 16
    assert cfg.cluster.node.profiler.enabled is False
    assert cfg.cluster.node.profiler.default_token_budget == 2048


def test_topology_presets():
    assert [s.node_type for s in resolve_cluster_topology("auto", 1)] == ["EPD"]
    assert [s.node_type for s in resolve_cluster_topology("single", 4)] == ["EPD"]
    assert [s.node_type for s in resolve_cluster_topology("auto", 2)] == ["EP", "D"]
    assert [s.node_type for s in resolve_cluster_topology("general", 8)] == ["E", "P", "D"]
    assert sum(s.n_replicas for s in resolve_cluster_topology("auto", 8)) == 8


def test_include_composition_and_cycle(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "api_server: {port: 7000, host: 1.2.3.4}\ncluster: {node: {kv_block_size: 32}}\n")
    (tmp_path / "frag.yaml").write_text("n_kv_blocks: 99\n")
    (tmp_path / "top.yaml").write_text(textwrap.dedent("""
        include: [base.yaml]
        api_server: {port: 9001}
        cluster:
          nodes:
            - {node_type: P, node: {include: [frag.yaml], hbm_utilization: 0.5}}
    """))
    cfg = load_config(EntryPointConfig, str(tmp_path / "top.yaml"))
    assert (cfg.api_server.port, cfg.api_server.host) == (9001, "1.2.3.4")
    assert cfg.cluster.node.kv_block_size == 32
    assert cfg.cluster.nodes[0].node == {"n_kv_blocks": 99, "hbm_utilization": 0.5}
    (tmp_path / "a.yaml").write_text("include: [b.yaml]\n")
    (tmp_path / "b.yaml").write_text("include: [a.yaml]\n")
    with pytest.raises(ValueError, match="cycle"):
        load_config(EntryPointConfig, str(tmp_path / "a.yaml"))


def test_spec_node_overlay_merges_over_cluster_node():
    base = load_config(EntryPointConfig, None, [
        "cluster.node.model.path=/models/x", "cluster.node.kv_block_size=32"])
    cfg = spec_node_config(base.cluster.node, NodeSpec(
        "D", node={"batch_scheduler": {"priority": "decode"}, "n_kv_blocks": 4096}))
    assert isinstance(cfg, NodeConfig)
    assert (cfg.model.path, cfg.kv_block_size, cfg.batch_scheduler.priority,
            cfg.batch_scheduler.chunked_prefill, cfg.n_kv_blocks) == \
        ("/models/x", 32, "decode", True, 4096)


@pytest.mark.parametrize("name", ["single.yaml", "auto.yaml", "general.yaml", "hybrid.yaml"])
def test_cluster_presets_boot_or_refuse(name):
    """single and auto (one CPU device) boot one EPD node on the fake model;
    general boots E, P and D and hybrid EP and D on that one device, with
    each spec's node preset merged in and the migrate tables wired."""
    cfg = load_config(EntryPointConfig, os.path.join(REPO, "config", "cluster", name), FAKE)
    if name in ("general.yaml", "hybrid.yaml"):
        cluster = Cluster(cfg.cluster)
        path = os.path.join(REPO, "config", "cluster", name)
        assert topology(cluster) == jax_topology(path, FAKE)
        assert [str(n.context.node_type) for n in cluster.nodes] == (
            ["E", "P", "D"] if name == "general.yaml" else ["EP", "D"])
        check_nodes(cluster)
        d = cluster.nodes[-1]
        assert (d.config.batch_scheduler.priority, d.config.tpot_slo, d.spec.tpot_slo) == \
            ("decode", 0.1, 0.1)
        return
    cluster = Cluster(cfg.cluster)
    assert [str(n.context.node_type) for n in cluster.nodes] == ["EPD"]
    assert cluster.nodes[0].device == torch.device("cpu")
    assert cluster.nodes[0].config.model.name == "fake"


def test_cluster_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    cfg = load_config(EntryPointConfig, None, FAKE[:-1])
    with pytest.raises(RuntimeError, match="cluster.platform=cpu"):
        Cluster(cfg.cluster)
