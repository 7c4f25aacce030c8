"""Offline (batch) inference entry point (port of
hydrainfer_tpu/entrypoint/offline.py:OfflineEngine).

One node with a self-pointing migrate graph, driven to completion. It runs
on the card unless the caller passes device="cpu". A list of devices
(`device=["cuda:0", "cuda:0"]`, or `["cpu"] * 4`), as the JAX
`OfflineEngine(devices=...)` takes it, makes the node tensor-parallel: one
rank a device; with `parallel="pp"`, pipeline-parallel: one stage of
contiguous layers a device.
"""
import asyncio
import time
from typing import List

from ..cluster.migrate import MigrateGraphBuilder, NodeType
from ..cluster.node import AsyncEPDNode, NodeConfig, NodeContext
from ..engine.output_token_processor import (OfflineOutputTokenProcessor,
                                             OutputTokenParams)
from ..engine.request_processor import RequestProcessParameters
from ..models.factory import ModelFactory
from ..request import OfflineInferenceOutput, Request


class OfflineEngine:
    def __init__(self, config: NodeConfig, model_factory: ModelFactory,
                 node_type: str = "PD", device=None, parallel: str = "tp"):
        context = NodeContext(name="offline0", node_type=NodeType(node_type),
                              device=device, parallel=parallel)
        self.node = AsyncEPDNode(config, context)
        self.node.init(model_factory)
        builder = MigrateGraphBuilder()
        builder.add_node(self.node.name, context.node_type, self.node,
                         config.tpot_slo)
        self.node.update_migrate_graph(builder.build_graph())
        self.tokenizer = self.node.model_factory.getTokenizer()

    def generate(self, requests: List[Request],
                 timeout_s: float = 300.0) -> List[OfflineInferenceOutput]:
        return asyncio.run(self.generate_async(requests, timeout_s))

    async def generate_async(self, requests: List[Request],
                             timeout_s: float = 300.0) -> List[OfflineInferenceOutput]:
        outputs = [OfflineInferenceOutput(arrival_time=time.perf_counter())
                   for _ in requests]
        done = []
        for req, out in zip(requests, outputs):
            proc = OfflineOutputTokenProcessor(out, self.tokenizer,
                                               on_finish=done.append)
            await self.node.add_request(req, RequestProcessParameters(
                output_token_processors=[proc],
                output_token_params=OutputTokenParams(stream_output=False)))

        deadline = time.perf_counter() + timeout_s
        while len(done) < len(requests):
            await self.node.step()
            await asyncio.sleep(0)
            if time.perf_counter() > deadline:
                raise TimeoutError(f"offline generate timed out: "
                                   f"{len(done)}/{len(requests)} finished")
        return outputs
