"""The port's multi-host deployment path, on the CPU (mirrors
tests/cluster/test_attach_cluster.py).

Nodes are launched standalone, each its own `python -m
hydrainfer_tpu_torch.cluster.process_node` command as an operator would
start them on separate hosts, and a parent ProcessCluster attaches by
address instead of spawning: peers and the token plane are wired over RPC
at cluster start. Also: a node killed mid-flight has its in-flight
requests terminated by the parent's health monitor instead of hanging.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import os
import signal
import subprocess
import sys
import time

from hydrainfer_tpu_torch.cluster.cluster import NodeSpec
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.cluster.process_node import ProcessCluster, ProcessClusterConfig
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from hydrainfer_tpu_torch.utils.socket_utils import find_free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_OVERRIDES = [
    "model.name=fake", "model.dtype=float32",
    "kv_block_size=4", "n_kv_blocks=128", "n_image_blocks=16",
    "request_processor.block_size=4",
    "request_processor.num_request_process_workers=1",
    "batch_scheduler.max_running_requests=8",
]


def launch_standalone(name: str, node_type: str, port: int):
    """Start a node exactly as an operator would on another host."""
    cmd = [sys.executable, "-m", "hydrainfer_tpu_torch.cluster.process_node",
           "--name", name, "--node-type", node_type,
           "--host", "127.0.0.1", "--port", str(port),
           "--platform", "cpu"] + FAKE_OVERRIDES
    return subprocess.Popen(cmd, cwd=REPO)


def reap(*procs):
    for sp in procs:
        try:
            sp.wait(timeout=10)       # cluster.stop() asked the node to exit
        except subprocess.TimeoutExpired:
            sp.terminate()
            try:
                sp.wait(timeout=10)
            except subprocess.TimeoutExpired:
                sp.kill()
                sp.wait()


def text_requests(n, max_tokens=8):
    return [Request(request_id=f"r{i}",
                    prompt=f"hello world request number {i} padded text",
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


async def serve_attached(specs, requests, timeout_s=120, **cluster_kw):
    cluster = ProcessCluster(ProcessClusterConfig(
        nodes=specs, node=NodeConfig(), platform="cpu", **cluster_kw))
    procs = [LogOutputTokenProcessor() for _ in requests]
    try:
        await cluster.start()
        for req, proc in zip(requests, procs):
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc]))
        deadline = time.perf_counter() + timeout_s
        while not all(p.finished for p in procs):
            assert time.perf_counter() < deadline, (
                f"timed out; counts={[len(p.token_ids) for p in procs]}")
            await asyncio.sleep(0.05)
        metrics = await cluster.metrics_async()
    finally:
        await cluster.stop()
    return procs, cluster, metrics


def test_attach_two_standalone_nodes():
    """P and D nodes launched as independent commands; the parent attaches
    by tcp address and serves with cross-process PD migration; the nodes
    report their names at attach, and exit when the cluster stops."""
    p_port, d_port = find_free_port(), find_free_port()
    p_proc = launch_standalone("p0", "P", p_port)
    d_proc = launch_standalone("d0", "D", d_port)
    try:
        specs = [NodeSpec("P", attach_addr=f"tcp://127.0.0.1:{p_port}"),
                 NodeSpec("D", attach_addr=f"tcp://127.0.0.1:{d_port}")]
        procs, cluster, metrics = asyncio.run(serve_attached(specs, text_requests(4)))
        for p in procs:
            assert p.finished and not p.terminated and len(p.token_ids) == 8
        assert [h.name for h in cluster.handles] == ["PNode:p0", "DNode:d0"]
        assert metrics["DNode:d0"]["migration_pulls"] == 4
    finally:
        reap(p_proc, d_proc)
    assert p_proc.returncode == 0 and d_proc.returncode == 0


def test_attach_mixed_with_spawned():
    """One attached node and one spawned child in the same cluster: each is
    in the other's migrate graph (wired over RPC after boot)."""
    d_port = find_free_port()
    d_proc = launch_standalone("d0", "D", d_port)
    spawn_cfg = {"model": {"name": "fake", "dtype": "float32"},
                 "kv_block_size": 4, "n_kv_blocks": 128, "n_image_blocks": 16,
                 "request_processor": {"block_size": 4,
                                       "num_request_process_workers": 1},
                 "batch_scheduler": {"max_running_requests": 8}}
    try:
        specs = [NodeSpec("P", 1, node=spawn_cfg),
                 NodeSpec("D", attach_addr=f"tcp://127.0.0.1:{d_port}")]
        procs, cluster, metrics = asyncio.run(serve_attached(specs, text_requests(3)))
        for p in procs:
            assert p.finished and not p.terminated and len(p.token_ids) == 8
        assert cluster.handles[0].proc is not None and cluster.handles[1].proc is None
        assert metrics["DNode:d0"]["migration_pulls"] == 3
    finally:
        reap(d_proc)


def test_mid_flight_node_death_terminates_requests():
    """Kill a node while requests are in flight: the parent's health
    monitor terminates those requests' streams (no hang until an RPC
    timeout)."""

    async def run():
        cluster = ProcessCluster(ProcessClusterConfig(
            nodes=[NodeSpec("PD", 1, node={
                "model": {"name": "fake", "dtype": "float32"},
                "kv_block_size": 4, "n_kv_blocks": 512, "n_image_blocks": 16,
                # a slow step loop: the generations are still in flight at
                # the kill
                "step_interval_s": 0.02,
                "request_processor": {"block_size": 4,
                                      "num_request_process_workers": 1},
                "batch_scheduler": {"max_running_requests": 8}})],
            node=NodeConfig(), platform="cpu",
            health_interval_s=0.3, health_strikes=2, max_respawns=0))
        procs = [LogOutputTokenProcessor() for _ in range(2)]
        try:
            await cluster.start()
            for req, proc in zip(text_requests(2, max_tokens=1000), procs):
                await cluster.add_request(req, RequestProcessParameters(
                    output_token_processors=[proc]))
            deadline = time.perf_counter() + 60
            while not any(p.token_ids for p in procs):
                assert time.perf_counter() < deadline
                await asyncio.sleep(0.05)
            h = cluster.handles[0]
            os.kill(h.proc.pid, signal.SIGKILL)
            deadline = time.perf_counter() + 15
            while not all(p.finished for p in procs):
                assert time.perf_counter() < deadline, \
                    "the health monitor did not terminate in-flight requests"
                await asyncio.sleep(0.1)
            assert all(p.terminated for p in procs)
            assert not h.alive
        finally:
            await cluster.stop()

    asyncio.run(run())
