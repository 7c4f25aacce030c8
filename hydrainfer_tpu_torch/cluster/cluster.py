"""Cluster: the control plane over the engine nodes (port of
hydrainfer_tpu/cluster/cluster.py, its in-process deployment).

It builds the nodes of a topology, wires the migrate graph, and routes each
incoming request to an encode-capable node (image requests) or a
prefill-capable node (text requests) through round-robin balancers. The
nodes are asyncio actors in this process that hand requests to each other
and pull their cache blocks (cluster/node.py). The devices are the cards
`torch.cuda.device_count()` reports, or one CPU when `platform` is "cpu";
the nodes take them in turn and wrap round, so several nodes may share one
card, as in the JAX package.

The topology is the explicit `nodes:` list (with replicas), or the
`cluster_type` preset over the device count: on one device `auto` and
`single` are one EPD node, and a preset file's `nodes:` (general: E, P, D;
hybrid: EP, D) builds its nodes on however many devices there are. Node
names are unique within a type (e0, p0, d0, d1, ...). The nodes share one
model factory when one is given (one copy of the weights on a shared card),
else build each from a `model_factory_provider`, else each its own from
`config.node.model`. Nodes with auto-sized caches size them in turn from
the free memory of their card, so on a shared card set the block counts.

Tensor parallelism (`tp_size` > 1) and pipeline parallelism (`pp_size` >
1): each node owns a group of tp_size * pp_size devices, taken by the JAX
cluster's wrap-around rule (group g's device i is devices[(g * n + i) %
len(devices)], n the group size), and shards its language model and KV cache
over them (cluster/node.py): one rank a device under TP, one stage of
contiguous layers a device under PP. Both at once are refused, as the JAX
cluster refuses them (TP inside pipeline stages exists at function level
only, parallel/pipeline.py). The preset topologies are resolved over
len(devices) // n groups. On one card or on the CPU every rank or stage of
every node shares the one device. Nodes that share a factory share its
model, sharded once, so a shared factory needs every node on the same
devices: elsewhere pass a `model_factory_provider`. The `process` deployment (one
OS process per node) and `attach_addr` belong to
cluster/process_node.py:ProcessCluster, which EntryPoint builds for
`deployment: process`; this class refuses both, where the JAX `Cluster`
ignores them and builds the nodes in process.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..config import build_dataclass, deep_merge
from ..engine.request_processor import RequestProcessParameters
from ..entrypoint.api_server import RequestObserver
from ..models.factory import ModelFactory
from ..request import Request
from ..utils.logger import getLogger
from .loadbalancer import LoadBalancer, LoadBalancerConfig
from .migrate import MigrateGraphBuilder, NodeType
from .node import AsyncEPDNode, NodeConfig, NodeContext

logger = getLogger(__name__)


@dataclass
class NodeSpec:
    node_type: str = "EPD"
    n_replicas: int = 1
    tpot_slo: float = 0.4
    # per-spec engine config overlay (config/node/*.yaml): a raw dict
    # deep-merged over the cluster-wide `node` config
    node: Optional[dict] = None
    # ProcessCluster only: attach to a node already serving at this
    # tcp://host:port (launched standalone with `python -m
    # hydrainfer_tpu_torch.cluster.process_node`) instead of spawning one;
    # n_replicas must be 1
    attach_addr: Optional[str] = None


def spec_node_config(base: NodeConfig, spec: NodeSpec) -> NodeConfig:
    """One spec's NodeConfig: base deep-merged with the spec's dict overlay."""
    overlay = spec.node
    if not overlay:
        return base
    if dataclasses.is_dataclass(overlay):
        overlay = dataclasses.asdict(overlay)
    return build_dataclass(NodeConfig, deep_merge(dataclasses.asdict(base), overlay))


@dataclass
class ClusterConfig:
    cluster_type: str = "auto"          # auto | general | hybrid | single
    nodes: List[NodeSpec] = field(default_factory=list)
    node: NodeConfig = field(default_factory=NodeConfig)
    # tensor-parallel ranks a node: its LM weights and KV cache sharded over
    # tp_size devices (the wrap-around rule; one card: all on it)
    tp_size: int = 1
    # pipeline stages a node: its LM layers and their KV cache split over
    # pp_size devices, as for tp_size; not with tp_size > 1
    pp_size: int = 1
    # "inprocess" = asyncio actors in this process; "process" = one OS
    # process per node (cluster/process_node.py:ProcessCluster, which
    # EntryPoint builds)
    deployment: str = "inprocess"
    host: str = "127.0.0.1"             # the process deployment's bind host
    # the port's device choice: "cpu" asks for the CPU, None means the card
    platform: Optional[str] = None
    xla_flags: Optional[str] = None     # TPU-only: no effect here


def resolve_cluster_topology(cluster_type: str, n_devices: int) -> List[NodeSpec]:
    """Preset -> node specs (the JAX package's heuristics)."""
    if cluster_type == "single" or n_devices == 1:
        return [NodeSpec("EPD", 1)]
    if cluster_type == "general":
        n_d = max(1, n_devices - 2)
        return [NodeSpec("E", 1), NodeSpec("P", 1), NodeSpec("D", n_d)]
    if cluster_type == "hybrid":
        n_ep = max(1, n_devices // 2)
        return [NodeSpec("EP", n_ep), NodeSpec("D", n_devices - n_ep)]
    if n_devices == 2:
        return [NodeSpec("EP", 1), NodeSpec("D", 1)]
    if n_devices == 3:
        return [NodeSpec("E", 1), NodeSpec("P", 1), NodeSpec("D", 1)]
    return [NodeSpec("E", 1), NodeSpec("P", (n_devices - 1) // 2),
            NodeSpec("D", n_devices - 1 - (n_devices - 1) // 2)]


def cluster_devices(config: ClusterConfig) -> List[torch.device]:
    """The devices a cluster's nodes take: one CPU when `platform` is "cpu",
    else every visible card (none raises)."""
    if config.platform == "cpu":
        return [torch.device("cpu")]
    if config.platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown platform {config.platform!r}: the port runs on "
                         "the card (None) or the CPU ('cpu')")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; set cluster.platform=cpu "
                           "to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def node_metrics(node) -> dict:
    """One node's serving metrics as plain JSON (backs /metrics)."""
    return node.metrics()


class Cluster(RequestObserver):
    """The in-process cluster (the API server's request observer)."""

    def __init__(self, config: ClusterConfig, model_factory: Optional[ModelFactory] = None,
                 devices: Optional[list] = None, model_factory_provider=None):
        if config.deployment != "inprocess":
            raise NotImplementedError(f"deployment={config.deployment!r}: Cluster builds "
                                      "the nodes in this process; one process a node is "
                                      "ProcessCluster's (cluster/process_node.py), which "
                                      "EntryPoint builds for deployment=process")
        if config.pp_size > 1 and config.tp_size > 1:
            # the JAX cluster's assertion (hydrainfer_tpu/cluster/cluster.py)
            raise NotImplementedError("pp_size > 1 with tp_size > 1: a node is either "
                                      "tensor- or pipeline-parallel (TP inside pipeline "
                                      "stages is parallel/pipeline.py's, at function "
                                      "level only)")
        if config.xla_flags:
            logger.warning(f"cluster.xla_flags is TPU-only and has no effect here: "
                           f"{config.xla_flags!r}")
        self.config = config
        devices = devices if devices is not None else cluster_devices(config)
        n = max(1, config.tp_size) * max(1, config.pp_size)
        specs = config.nodes or resolve_cluster_topology(config.cluster_type,
                                                         max(1, len(devices) // n))
        if any(spec.attach_addr for spec in specs):
            raise NotImplementedError("attach_addr: Cluster builds the nodes in this "
                                      "process; attaching to a running node is "
                                      "ProcessCluster's (cluster/process_node.py), which "
                                      "EntryPoint builds for deployment=process")
        self.nodes: List[AsyncEPDNode] = []
        name_counts = {}
        for spec in specs:
            for _ in range(spec.n_replicas):
                idx = name_counts.get(spec.node_type, 0)
                name_counts[spec.node_type] = idx + 1
                g = len(self.nodes)
                group = [devices[(g * n + i) % len(devices)] for i in range(n)]
                device = group if n > 1 else group[0]
                node = AsyncEPDNode(spec_node_config(config.node, spec), NodeContext(
                    name=f"{spec.node_type.lower()}{idx}",
                    node_type=NodeType(spec.node_type), device=device,
                    parallel="pp" if config.pp_size > 1 else "tp"))
                node.spec = spec
                self.nodes.append(node)
        for node in self.nodes:
            if model_factory is not None:
                node.init(model_factory)
            elif model_factory_provider is not None:
                node.init(model_factory_provider())
            else:
                node.init(None)      # built from config.node.model

        builder = MigrateGraphBuilder()
        for n in self.nodes:
            builder.add_node(n.name, n.context.node_type, n, n.spec.tpot_slo)
        graph = builder.build_graph()
        for n in self.nodes:
            n.update_migrate_graph(graph)

        # request entry balancers
        self.ebalancer = LoadBalancer(LoadBalancerConfig("round"))
        self.pbalancer = LoadBalancer(LoadBalancerConfig("round"))
        for n in self.nodes:
            if n.context.node_type.can_encode:
                self.ebalancer.register_worker(n)
            if n.context.node_type.can_prefill:
                self.pbalancer.register_worker(n)
        if not len(self.pbalancer):
            raise ValueError("the cluster has no prefill-capable node")
        logger.info(f"cluster up: {[(n.name, str(n.device)) for n in self.nodes]}")

    def metrics(self) -> dict:
        """Per-node serving metrics (the API server's /metrics)."""
        return {node.name: node_metrics(node) for node in self.nodes}

    async def add_request(self, request: Request, params: RequestProcessParameters) -> None:
        has_image = request.image is not None or request.image_base64 is not None
        balancer = self.ebalancer if has_image and len(self.ebalancer) else self.pbalancer
        await balancer.choice().add_request(request, params)

    async def start(self) -> None:
        for node in self.nodes:
            await node.start()

    async def stop(self) -> None:
        for node in self.nodes:
            await node.stop()
