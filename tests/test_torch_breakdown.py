"""The latency breakdown (NodeConfig.log_latency_breakdown) against the JAX node's.

The same requests through the port's nodes and the JAX package's on a tiny
LLaVA (random:tiny-lm+mm, CLIP_TINY, the JAX random weights carried over),
with log_latency_breakdown on: one EPD node (the whole-tower and the
layer-chunked encode), P + D (text), E + P + D and EP + D (images and
text). Each finished request logs its breakdown once (engine/metric.py:
log_latency_breakdown), and the port's logged stage names, request by
request, are the JAX node's; every span is non-negative and fits inside the
request's wall time (arrival to the last log). The port's execute spans end
where a step's tokens reach the host (cluster/node.py:_stamp_execute_end).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import time

import pytest

from hydrainfer_tpu.cluster import node as jax_node_mod
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster import node as node_mod
from hydrainfer_tpu_torch.engine import metric as metric_mod
from hydrainfer_tpu_torch.engine.metric import RequestMetric, STAGES
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from tests.test_torch_disagg import (jax_nodes, jax_run, mm_requests, port_nodes, port_run,
                                     text_requests, tiny_mm_factories)


def _record(monkeypatch, module):
    """Every breakdown `module`'s node logs: (its stages and spans, the
    log's time), in log order."""
    logged = []
    monkeypatch.setattr(module, "log_latency_breakdown",
                        lambda m: logged.append((m.breakdown(), time.perf_counter(),
                                                 m.arrival_time)))
    return logged


def _names(logged):
    return sorted(tuple(sorted(b)) for b, _, _ in logged)


@pytest.mark.parametrize("types,chunk_layers,images", [
    (["EPD"], 0, True), (["EPD"], 1, True), (["P", "D"], 0, False), (["E", "P", "D"], 0, True),
    (["EP", "D"], 0, True)], ids=["epd", "epd_chunked", "p_d", "e_p_d", "ep_d"])
def test_breakdown_logs_the_jax_nodes_stage_names(types, chunk_layers, images, monkeypatch):
    pf, jf = tiny_mm_factories("none", None)
    reqs = mm_requests if images else text_requests
    port = port_nodes(pf, types, chunk_layers=chunk_layers)
    jax = jax_nodes(jf, types, False, chunk_layers=chunk_layers)
    for node in port + jax:
        node.config.log_latency_breakdown = True
    got_log = _record(monkeypatch, node_mod)
    ref_log = _record(monkeypatch, jax_node_mod)
    t0 = time.perf_counter()
    got = port_run(port, reqs(Request, SamplingParameters))
    ref = jax_run(jax, reqs(JaxRequest, JaxSP))
    assert got == ref
    assert len(got_log) == len(ref_log) == len(got)         # one log a request
    assert _names(got_log) == _names(ref_log)
    names = {n for b, _, _ in got_log for n in b}
    assert {"prefill_queueing", "prefill_execute", "decode_execute"} <= names
    if images:
        assert "encode_execute" in names
    if len(types) > 1:
        # JAX's rule: a request's first pull is its ep_transfer, a second
        # (E -> P, then P -> D) its pd_transfer
        assert "ep_transfer" in names
    assert ("pd_transfer" in names) == (types == ["E", "P", "D"])
    for spans, logged_at, arrival in got_log:
        assert set(spans) <= set(STAGES)
        for stage, dt in spans.items():
            assert 0.0 <= dt <= logged_at - max(arrival, t0), (stage, dt)
    # the port's nodes log nothing with the breakdown off
    for node in port:
        node.config.log_latency_breakdown = False
    got_log.clear()
    port_run(port, reqs(Request, SamplingParameters))
    assert got_log == []


def test_log_latency_breakdown_logs_each_complete_stage(monkeypatch):
    lines = []
    monkeypatch.setattr(metric_mod.logger, "info", lines.append)
    m = RequestMetric(prefill_queueing=[1.0, 1.5], prefill_execute=[1.5, 2.25],
                      decode_execute=[3.0])
    metric_mod.log_latency_breakdown(m)
    assert lines == ["prefill_queueing time: 0.5", "prefill_execute time: 0.75"]
