"""The port's process deployment: nodes in separate OS processes on the CPU
(mirrors tests/cluster/test_process_cluster.py, and
test_spawned_node_respawns_after_death of
tests/cluster/test_failure_recovery.py).

PD and EPD migration cross the process boundary over the RPC plane, the
blocks over shared memory (same host) or RPC (HYDRAINFER_DISABLE_SHM_PULL),
and tokens stream back to the parent's collector. The children build the
weightless fake model from their config. Port-only: a decode node killed
mid-decode has the requests it holds (which entered at the P node)
terminated, and is respawned and rewired.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time

import numpy as np
from PIL import Image

from hydrainfer_tpu_torch.cluster.cluster import NodeSpec
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.cluster.process_node import ProcessCluster, ProcessClusterConfig
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import (RequestProcessorConfig,
                                                           RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.request import Request, SamplingParameters


def make_node_config() -> NodeConfig:
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=8),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=16)
    cfg.model.name = "fake"      # the child builds the weightless factory itself
    cfg.model.dtype = "float32"
    return cfg


async def wait_finished(procs, timeout_s=120):
    deadline = time.perf_counter() + timeout_s
    while not all(p.finished for p in procs):
        assert time.perf_counter() < deadline, (
            f"timed out; finished={[p.finished for p in procs]} "
            f"counts={[len(p.token_ids) for p in procs]}")
        await asyncio.sleep(0.05)


async def serve(specs, requests, timeout_s=120):
    """Serve `requests` on a cluster of `specs`; the processors and the
    nodes' metrics rows at the end."""
    cluster = ProcessCluster(ProcessClusterConfig(
        nodes=specs, node=make_node_config(), platform="cpu"))
    procs = [LogOutputTokenProcessor() for _ in requests]
    try:
        await cluster.start()
        for req, proc in zip(requests, procs):
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc]))
        await wait_finished(procs, timeout_s)
        metrics = await cluster.metrics_async()
    finally:
        await cluster.stop()
    for h in cluster.handles:
        assert not h.proc.is_alive()
    return procs, metrics


def text_requests(n, max_tokens=8):
    return [Request(request_id=f"r{i}",
                    prompt=f"hello world request number {i} padded text",
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


def row(metrics, prefix):
    return next(v for k, v in metrics.items() if k.startswith(prefix))


def test_pd_two_processes():
    """P node + D node in separate processes: prefill on one, PD migration
    (the block pull crosses the process boundary), decode on the other."""
    procs, metrics = asyncio.run(serve([NodeSpec("P", 1), NodeSpec("D", 1)],
                                       text_requests(4)))
    for p in procs:
        assert p.finished and not p.terminated and len(p.token_ids) == 8
    p_row, d_row = row(metrics, "PNode:p0"), row(metrics, "DNode:d0")
    assert d_row["migration_pulls"] == 4 and "migration_pulls" not in p_row
    for r in (p_row, d_row):
        assert r["migrating_requests"] == 0 and r["running_requests"] == 0
        assert r["kv_available_blocks"] == r["kv_total_blocks"]


def test_epd_three_processes():
    """E, P, D nodes in three processes; an image request flows E -> P -> D
    with image-cache and KV-cache blocks migrating between processes."""
    rng = np.random.default_rng(0)
    reqs = text_requests(2)
    img = Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    reqs.append(Request(request_id="img0", prompt="<image> describe this", image=img,
                        sampling_params=SamplingParameters(max_tokens=8,
                                                           ignore_eos=True)))
    procs, metrics = asyncio.run(serve(
        [NodeSpec("E", 1), NodeSpec("P", 1), NodeSpec("D", 1)], reqs))
    for p in procs:
        assert p.finished and not p.terminated and len(p.token_ids) == 8
    # the image request's features E -> P; every request's KV P -> D
    assert row(metrics, "PNode")["migration_pulls"] == 1
    assert row(metrics, "DNode")["migration_pulls"] == 3
    assert set(row(metrics, "PNode")["migration_last_pulls"]) == {"ENode:e0"}
    assert set(row(metrics, "PNode")["migration_last_pulls"]["ENode:e0"]) == {"image"}


def test_same_host_pull_uses_shared_memory(monkeypatch):
    """Same-host cross-process block pulls ride the shared-memory plane (the
    caches live on the CPU here, so not CUDA IPC), not the RPC payload, and
    the count reaches the worker's metrics row."""
    monkeypatch.delenv("HYDRAINFER_DISABLE_SHM_PULL", raising=False)
    procs, metrics = asyncio.run(serve([NodeSpec("P", 1), NodeSpec("D", 1)],
                                       text_requests(3)))
    assert all(p.finished and len(p.token_ids) == 8 for p in procs)
    d_row = row(metrics, "DNode")
    assert d_row["migration_pulls"] == 3
    assert d_row["migration_shm_pulls"] == 3
    assert "migration_ipc_pulls" not in d_row


def test_cross_host_pull_falls_back_to_rpc(monkeypatch):
    """With the shared-memory plane unavailable (another host, or turned
    off), pulls take the RPC payload and serving still completes."""
    monkeypatch.setenv("HYDRAINFER_DISABLE_SHM_PULL", "1")
    procs, metrics = asyncio.run(serve([NodeSpec("P", 1), NodeSpec("D", 1)],
                                       text_requests(2)))
    assert all(p.finished and len(p.token_ids) == 8 for p in procs)
    d_row = row(metrics, "DNode")
    assert d_row["migration_pulls"] == 2
    assert "migration_shm_pulls" not in d_row and "migration_ipc_pulls" not in d_row


def test_process_cluster_matches_inprocess_tokens():
    """The same fake-model request through a node behind a process boundary
    and an in-process node gives the same tokens. One request: the fake LM
    seeds on the batch's content, so the batch must not depend on timing."""
    procs, _ = asyncio.run(serve([NodeSpec("PD", 1)], text_requests(1, max_tokens=6)))
    engine = OfflineEngine(make_node_config(), None, node_type="PD", device="cpu")
    outs = engine.generate(text_requests(1, max_tokens=6), timeout_s=60)
    for p, o in zip(procs, outs):
        assert p.token_ids == list(o.output_token_ids)


def test_spawned_node_respawns_after_death():
    """Kill a spawned node mid-cluster: the health loop finds it dead,
    terminates its in-flight requests, respawns it once, and later requests
    are served by the restarted node."""

    async def serve_one(cluster, rid, max_tokens=5):
        proc = LogOutputTokenProcessor()
        await cluster.add_request(
            Request(request_id=rid, prompt=f"respawn check {rid}",
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True)),
            RequestProcessParameters(output_token_processors=[proc]))
        return proc

    async def run():
        cfg = make_node_config()
        # one token a step, 20 ms apart: the long request is still in flight
        # at the kill
        cfg.step_interval_s, cfg.multi_step_decode = 0.02, 1
        cfg.n_kv_blocks = 512           # room for its 1000 tokens
        cluster = ProcessCluster(ProcessClusterConfig(
            nodes=[NodeSpec("PD", 1)], node=cfg, platform="cpu",
            health_interval_s=0.3, health_strikes=1))
        try:
            await cluster.start()
            first = await serve_one(cluster, "before")
            await wait_finished([first])
            assert len(first.token_ids) == 5 and not first.terminated

            long = await serve_one(cluster, "in_flight", max_tokens=1000)
            deadline = time.perf_counter() + 60
            while not long.token_ids:
                assert time.perf_counter() < deadline and not long.finished
                await asyncio.sleep(0.02)
            h = cluster.handles[0]
            old_pid = h.proc.pid
            h.proc.kill()
            deadline = time.perf_counter() + 120
            while not (h.alive and h.respawns == 1):
                assert time.perf_counter() < deadline, (
                    f"respawn never completed (alive={h.alive}, "
                    f"respawns={h.respawns})")
                await asyncio.sleep(0.1)
            assert long.finished and long.terminated, len(long.token_ids)
            assert h.proc.pid != old_pid

            second = await serve_one(cluster, "after")
            await wait_finished([second])
            assert len(second.token_ids) == 5 and not second.terminated
        finally:
            await cluster.stop()

    asyncio.run(run())


def test_killed_decode_node_terminates_the_requests_it_holds():
    """Requests enter the P node and move on to the D node (its hand-off
    notices tell the parent): when D is killed mid-decode, the health loop
    terminates exactly those requests, respawns D, rewires P to the new D,
    and a request afterwards is served P -> D again."""
    slow_d = {"step_interval_s": 0.02, "multi_step_decode": 1, "n_kv_blocks": 512}

    async def run():
        cfg = make_node_config()
        cfg.n_kv_blocks = 512
        cluster = ProcessCluster(ProcessClusterConfig(
            nodes=[NodeSpec("P", 1), NodeSpec("D", 1, node=slow_d)], node=cfg,
            platform="cpu", health_interval_s=0.3, health_strikes=1))
        try:
            await cluster.start()
            procs = [LogOutputTokenProcessor() for _ in range(3)]
            # 300 tokens at one a step take 6 s or more; D holds all three
            for req, proc in zip(text_requests(3, max_tokens=300), procs):
                await cluster.add_request(req, RequestProcessParameters(
                    output_token_processors=[proc]))
            deadline = time.perf_counter() + 60
            while not all(len(p.token_ids) > 3 for p in procs):   # decoding on D
                assert time.perf_counter() < deadline and not any(p.finished for p in procs), \
                    [(p.token_ids[:5], len(p.token_ids), p.terminated) for p in procs]
                await asyncio.sleep(0.02)
            assert all(held == ("DNode:d0", 1) for held in cluster._node_by_request.values())
            d = cluster.handles[1]
            d.proc.kill()
            await wait_finished(procs, 30)
            assert all(p.terminated for p in procs)
            deadline = time.perf_counter() + 120
            while not (d.alive and d.respawns == 1):
                assert time.perf_counter() < deadline, "respawn never completed"
                await asyncio.sleep(0.1)
            after = LogOutputTokenProcessor()
            await cluster.add_request(text_requests(1, max_tokens=5)[0],
                                      RequestProcessParameters(output_token_processors=[after]))
            await wait_finished([after])
            assert len(after.token_ids) == 5 and not after.terminated
            assert (await cluster.metrics_async())["DNode:d0"]["migration_pulls"] == 1
        finally:
            await cluster.stop()

    asyncio.run(run())
