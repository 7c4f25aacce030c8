"""Back-pressure and the two inherited online hazards, the port against the
JAX package, on the CPU.

- KV exhaustion serializes requests, it does not crash the node (the port's
  mirror of tests/engine/test_backpressure.py): 6 x (30 prompt + 10 output)
  tokens on a 24-block pool of 4-token blocks all finish, on the fake
  model, and the pool comes back whole.
- The invariant dump: a scheduler state in which every resident request
  defers (the pool's free blocks taken away, one request holding more than
  its worst case) logs the same rows (alloc, worst, resv, OVER) and the
  same header as the JAX scheduler's on the same state; the port's
  pool-naming deferral warning is logged beside it.
- No disconnect reaper: a streaming client that resets its connection after
  its first delta does not stop its request; it runs to max_tokens on the
  port's server, as on the JAX server (the fake model behind each).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json
import logging
import socket
import struct
import time

from hydrainfer_tpu import memory as jax_memory
from hydrainfer_tpu import request as jax_request
from hydrainfer_tpu.config import load_config as jax_load_config
from hydrainfer_tpu.engine import isa as jax_isa
from hydrainfer_tpu.engine import rcb as jax_rcb
from hydrainfer_tpu.engine import scheduler as jax_sched
from hydrainfer_tpu.engine.output_token_processor import \
    LogOutputTokenProcessor as JaxLogProcessor
from hydrainfer_tpu.entrypoint.entrypoint import EntryPoint as JaxEntryPoint
from hydrainfer_tpu.entrypoint.entrypoint import EntryPointConfig as JaxEntryPointConfig
from hydrainfer_tpu_torch import memory, request
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.config import load_config
from hydrainfer_tpu_torch.engine import isa, rcb, scheduler
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.fake import FakeConfig, FakeModelFactory
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from tests.test_torch_online import SERVE_YAML, TINY, ServedEntryPoint, free_port


def test_kv_exhaustion_backpressure():
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=16),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4,
        n_kv_blocks=24,          # 96 KV tokens in all
        n_image_blocks=4)
    cfg.model.dtype = "float32"
    engine = OfflineEngine(cfg, model_factory=FakeModelFactory(fake_config=FakeConfig(),
                                                               device="cpu"),
                           device="cpu")
    # 6 requests x (30 prompt + 10 out) = 240 KV tokens against a 96-token pool
    reqs = [Request(request_id=i, prompt="x" * 30,
                    sampling_params=SamplingParameters(max_tokens=10, ignore_eos=True))
            for i in range(6)]
    outs = engine.generate(reqs, timeout_s=60)
    assert all(len(o.output_token_ids) == 10 for o in outs)
    kv = engine.node.kv_cache_manager
    assert kv.n_available_blocks() == 24 - kv.block_allocator.reserved
    assert engine.node.batch_scheduler._reserved_blocks == 0


# ------------------------------------------------------------- the dump

def _dump_state(mods):
    """Two requests admitted and prefilled on a 10-block pool of 4-token
    blocks, then the pool's free blocks taken and one request grown past its
    worst case: the next step defers both. Returns the scheduler after it."""
    isa_m, rcb_m, sched_m, mem_m, req_m, device = mods
    kw = {} if device is None else {"device": device}
    kv = mem_m.TokenCacheBlockManager(mem_m.TokenCacheBlockManagerConfig(
        n_layers=1, n_tensors=1, n_blocks=10, block_size=4, n_heads=2, head_dim=8,
        dtype="fp32"), **kw)
    sched = sched_m.BatchScheduler(sched_m.BatchSchedulerConfig(max_running_requests=4),
                                   kv, image_cache_manager=None, token_budget=64)
    rcbs = []
    for rid, n_prompt, decode_at in (("a", 8, 16), ("b", 12, 12)):
        r = rcb_m.RequestControlBlock()
        r.request_id = rid
        r.sampling_params = req_m.SamplingParameters(max_tokens=4)
        r.request_metadata = req_m.RequestMetadata(n_images=0, n_prompt_tokens=n_prompt,
                                                   n_text_tokens=n_prompt, n_image_tokens=0)
        b = isa_m.InstructionListBuilder()
        b.append(isa_m.TextFill(list(range(10, 10 + n_prompt)), list(range(n_prompt)),
                                list(range(n_prompt)), True, None, None))
        b.append(isa_m.TextFill([7], [decode_at], [decode_at], True, None, None))
        r.instructions = b.build()
        sched.schedule_new(r)
        rcbs.append(r)
    batch = sched.step()
    assert len(batch) == 2
    for r, _ in batch:
        r.step()                              # the prefill ran: on to the decode
        sched.schedule_running(r)
    kv.realloc(rcbs[0].virtual_kv_cache, 16)  # a: 4 blocks, past its worst case of 3
    kv.block_allocator.allocate(kv.block_allocator.n_free)
    return sched


def _logged(mod, fn, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mod.logger.addHandler(caplog.handler)
        try:
            out = fn()
        finally:
            mod.logger.removeHandler(caplog.handler)
    return out, [r.getMessage() for r in caplog.records]


def test_invariant_dump_matches_jax(caplog):
    jax_s = _dump_state((jax_isa, jax_rcb, jax_sched, jax_memory, jax_request, None))
    port_s = _dump_state((isa, rcb, scheduler, memory, request, "cpu"))
    jax_batch, jax_lines = _logged(jax_sched, jax_s.step, caplog)
    port_batch, port_lines = _logged(scheduler, port_s.step, caplog)
    assert len(jax_batch) == len(port_batch) == 0
    jax_dump = [m for m in jax_lines if m.startswith("back-pressure invariant dump")]
    port_dump = [m for m in port_lines if m.startswith("back-pressure invariant dump")]
    assert len(port_dump) == 1 and port_dump == jax_dump
    assert port_dump[0].splitlines()[1:] == ["  a: alloc=4 worst=3 resv=3 OVER",
                                             "  b: alloc=3 worst=4 resv=4"]
    assert any("deferred (kv free blocks: 0)" in m for m in port_lines)
    # the dump repeats every 20,000th deferral round, not every round
    _, again = _logged(scheduler, port_s.step, caplog)
    assert not [m for m in again if m.startswith("back-pressure invariant dump")]


def test_invariant_dump_on_a_node_without_kv():
    """An E node (no KV manager) deferred on its image pool dumps rows of
    zeros instead of failing."""
    sched = scheduler.BatchScheduler(scheduler.BatchSchedulerConfig(), None)
    r = rcb.RequestControlBlock()
    r.request_id = "e"
    sched._reserved_blocks = 0
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    scheduler.logger.addHandler(handler)
    try:
        sched._log_invariant_dump([r])
    finally:
        scheduler.logger.removeHandler(handler)
    assert records[0].getMessage().splitlines()[1:] == ["  e: alloc=0 worst=0 resv=-1"]


# ----------------------------------------------------- no disconnect reaper

class Tap:
    """Stands between the API server and the cluster: gives every request a
    token log beside its stream."""

    def __init__(self, inner, log_cls):
        self.inner, self.log_cls, self.logs = inner, log_cls, []

    async def add_request(self, req, params):
        log = self.log_cls()
        params.output_token_processors.append(log)
        self.logs.append(log)
        await self.inner.add_request(req, params)


def _reset_after_first_delta(port: int, max_tokens: int) -> None:
    body = json.dumps({"messages": [{"role": "user", "content": "go"}],
                       "max_tokens": max_tokens, "ignore_eos": True,
                       "stream": True}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    got = b""
    while b"data: {" not in got:
        chunk = s.recv(4096)
        assert chunk, "the stream closed before its first delta"
        got += chunk
    # close with a reset (SO_LINGER 0), not an orderly shutdown
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()


def test_no_disconnect_reaper_request_runs_to_max_tokens():
    max_tokens = 600
    overrides = ["cluster.node.model.name=fake", "cluster.node.n_kv_blocks=512"]
    servers, taps = [], []
    try:
        for load, cfg_cls, entry_cls, log_cls in (
                (jax_load_config, JaxEntryPointConfig, JaxEntryPoint, JaxLogProcessor),
                (load_config, EntryPointConfig, EntryPoint, LogOutputTokenProcessor)):
            port = free_port()
            entry = entry_cls(load(cfg_cls, SERVE_YAML,
                                   [*TINY, *overrides, f"api_server.port={port}"]))
            taps.append(Tap(entry.cluster, log_cls))
            entry.api_server.observers[:] = [taps[-1]]
            servers.append(ServedEntryPoint(entry, port))
        for server, tap in zip(servers, taps):
            _reset_after_first_delta(server.port, max_tokens)
            (log,) = tap.logs
            assert len(log.token_ids) < max_tokens      # reset while it decodes
            deadline = time.time() + 120
            while not log.finished and time.time() < deadline:
                time.sleep(0.05)
            assert log.finished and not log.terminated
            assert len(log.token_ids) == max_tokens
    finally:
        for s in servers:
            s.stop()
