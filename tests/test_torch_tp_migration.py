"""Migration between nodes of different tensor-parallel degrees (the port's
tests/cluster/test_tp_migration.py): a P node hands its requests to a D
node, and the D node pulls their KV blocks, gathered from the source's rank
shards into the single-device layout (each head from the first rank that
holds it) and scattered into the destination's shards. P tp 2 -> D tp 2,
P tp 2 -> D tp 1 and P tp 1 -> D tp 2, on tiny-lm's JAX weights in f32, and
P tp 2 -> D tp 1 with int8 weights and an int8 KV cache (the int8 payload),
must give the JAX single-device engine's greedy tokens on the same requests
and node settings (its run once a module), and those of one PD node of the
port on one device. Every rank is on the CPU.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time

import pytest

from hydrainfer_tpu_torch.cluster.migrate import MigrateGraphBuilder, NodeType
from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeConfig, NodeContext
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
from tests.test_torch_tp_engine import _node_cfg, _requests, jax_tiny_tokens, tiny_factory

QUANTS = {"f32": ("none", None), "int8w_int8kv": ("int8", 0.05)}
PROMPTS = [f"tensor parallel migration check {i}" for i in range(3)]
MAX_TOKENS = (8, 8, 8)
_BASELINE = {}


def make_node(name: str, node_type: str, devices, quant: str) -> AsyncEPDNode:
    """A node on `devices` ("cpu" or a list, one rank each) with its own
    model over tiny-lm's JAX weights, with the JAX reference's settings."""
    node = AsyncEPDNode(NodeConfig(**_node_cfg()), NodeContext(
        name=name, node_type=NodeType(node_type), device=devices))
    node.init(tiny_factory(*QUANTS[quant]))
    node.batch_scheduler.token_budget = 16
    return node


def wire(nodes):
    builder = MigrateGraphBuilder()
    for node in nodes:
        builder.add_node(node.name, node.context.node_type, node, tpot_slo=0.4)
    graph = builder.build_graph()
    for node in nodes:
        node.update_migrate_graph(graph)


def serve(nodes):
    async def run():
        procs = [LogOutputTokenProcessor() for _ in PROMPTS]
        for req, proc in zip(_requests(PROMPTS, MAX_TOKENS), procs):
            await nodes[0].add_request(req, RequestProcessParameters(
                output_token_processors=[proc]))
        deadline = time.perf_counter() + 120
        while not all(p.finished for p in procs):
            for node in nodes:
                await node.step()
            await asyncio.sleep(0)
            assert time.perf_counter() < deadline, [len(p.token_ids) for p in procs]
        return [p.token_ids for p in procs]

    return asyncio.run(run())


def baseline(quant: str):
    """One PD node on one device: no migration, no TP."""
    if quant not in _BASELINE:
        node = make_node("base", "PD", "cpu", quant)
        wire([node])
        _BASELINE[quant] = serve([node])
    return _BASELINE[quant]


@pytest.mark.parametrize("p_tp,d_tp,quant", [(2, 2, "f32"), (2, 1, "f32"), (1, 2, "f32"),
                                             (2, 1, "int8w_int8kv")])
def test_migration_between_tp_degrees(p_tp, d_tp, quant):
    devices = lambda tp: "cpu" if tp == 1 else ["cpu"] * tp  # noqa: E731
    p = make_node("p", "P", devices(p_tp), quant)
    d = make_node("d", "D", devices(d_tp), quant)
    for node, tp in ((p, p_tp), (d, d_tp)):
        cache = node.kv_cache_manager.cache_array
        assert (isinstance(cache, list) and len(cache) == tp) or tp == 1
    wire([p, d])
    got = serve([p, d])
    assert got == jax_tiny_tokens(*QUANTS[quant], PROMPTS, MAX_TOKENS)
    assert got == baseline(quant)
    assert d.metrics()["migration_pulls"] == len(PROMPTS)
