"""Serve entry point (port of hydrainfer_tpu/entrypoint/entrypoint.py):

    python -m hydrainfer_tpu_torch.entrypoint.entrypoint --config config/serve.yaml \
        [key.path=value ...]

builds the cluster and the OpenAI-compatible API server from the config (the
YAML presets under config/ are read as they are) and serves on the card;
`cluster.platform=cpu` serves on the CPU. The cluster is the in-process one
(cluster/cluster.py), or with `cluster.deployment=process` one OS process a
node (cluster/process_node.py:ProcessCluster: spawned children, or nodes
attached by `attach_addr`), in which case this process builds the model
factory only for its tokenizer and vision config and holds nothing on the
card. `cluster.tp_size=2` makes every in-process node tensor-parallel over
two devices, and `cluster.pp_size=2` pipeline-parallel over two stages (on
one card, or with `cluster.platform=cpu`, both share the one device).
SIGTERM or SIGINT stops the cluster and the server, and the
process exits 0.
"""
import argparse
import asyncio
import signal
from dataclasses import dataclass, field

from ..cluster.cluster import Cluster, ClusterConfig
from ..config import load_config
from ..utils.logger import getLogger
from .api_server import APIServer, APIServerConfig

logger = getLogger(__name__)


@dataclass
class EntryPointConfig:
    api_server: APIServerConfig = field(default_factory=APIServerConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)


class EntryPoint:
    def __init__(self, config: EntryPointConfig, model_factory=None):
        self.config = config
        c = config.cluster
        if c.deployment == "process":
            for size in ("tp_size", "pp_size"):
                if getattr(c, size) > 1:
                    # the JAX ProcessCluster ignores both and runs each node
                    # on one device
                    raise NotImplementedError(
                        f"{size} > 1 with deployment=process: a node process runs on one "
                        "device; tensor and pipeline parallelism are the in-process "
                        "Cluster's (deployment=inprocess)")
            if c.xla_flags:
                logger.warning(f"cluster.xla_flags is TPU-only and has no effect here: "
                               f"{c.xla_flags!r}")
            from ..cluster.process_node import ProcessCluster, ProcessClusterConfig
            from ..models.factory import getModelFactory
            self.cluster = ProcessCluster(ProcessClusterConfig(
                cluster_type=c.cluster_type, nodes=c.nodes, node=c.node, host=c.host,
                platform=c.platform))
            # the tokenizer and the vision config only: no weights are built
            factory = model_factory or getModelFactory(c.node.model, "cpu")
        else:
            self.cluster = Cluster(c, model_factory=model_factory)
            factory = self.cluster.nodes[0].model_factory
        vision_cfg = factory.getVisionModelConfig()
        self.api_server = APIServer(
            config.api_server, factory.getTokenizer(),
            image_token=(vision_cfg.image_token if vision_cfg else None) or "<image>",
            image_token_calculator=vision_cfg.image_token_calculator if vision_cfg else None)
        self.api_server.register_observer(self.cluster)

    async def run(self, stop: asyncio.Event = None) -> None:
        """Serve until `stop` is set (SIGTERM or SIGINT when not given), then
        stop the cluster and the server."""
        if stop is None:
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
        await self.cluster.start()
        runner = await self.api_server.start()
        try:
            await stop.wait()
            logger.info("stopping")
        finally:
            await self.cluster.stop()
            await runner.cleanup()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = parser.parse_args()
    config = load_config(EntryPointConfig, args.config, args.overrides)
    entry = EntryPoint(config)
    asyncio.run(entry.run())


if __name__ == "__main__":
    main()
