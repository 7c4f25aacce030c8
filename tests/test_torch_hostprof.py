"""The host profiler's window timeline (HYDRAINFER_HOST_PROF=2) against the
JAX package's: on tiny-lm at K = 4, with the timeline on in both packages,
each fill window of the port's engine records the same events, in the same
order, as the JAX engine's window of the same rank: `dispatched` when its
step is queued, `ready` when a drain first finds its tokens landed,
`read_start` and `read_done` around the host read. Whether a window gets
its `ready` depends on the clock: the probe runs once a drain, so a window
whose tokens land only after the drain that reads it has none. On the CPU
the port's steps run synchronously (every window is ready at its first
probe) while JAX dispatches asynchronously (most are not), so `ready` is
held to its place, between `dispatched` and `read_start`, and the other
three events are held exactly. Spans keep working beside the timeline, and
`reset` clears it."""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine.request_processor import RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu.utils import hostprof as jax_hostprof
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from hydrainfer_tpu_torch.utils import hostprof

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs"]
MAX_TOKENS = (12, 6, 10)
NODE = dict(kv_block_size=4, n_kv_blocks=256, multi_step_decode=4, spec_ngram_k=0)


def _windows(events):
    """Each window's event names in order, windows in order of dispatch."""
    order, by_tag = [], {}
    for name, tag, _ in events:
        if tag not in by_tag:
            order.append(tag)
            by_tag[tag] = []
        by_tag[tag].append(name)
    return [by_tag[t] for t in order]


def _run_jax():
    cfg = JaxNodeConfig(batch_scheduler=JaxBSConfig(max_running_requests=3,
                                                    priority="prefill"),
                        request_processor=JaxRPConfig(num_request_process_workers=1,
                                                      block_size=4),
                        n_image_blocks=1, **NODE)
    cfg.model.dtype = "float32"
    engine = JaxOfflineEngine(cfg, model_factory=JaxFactory("tiny-lm", dtype=jnp.float32),
                              node_type="PD")
    reqs = [JaxRequest(request_id=f"r{i}", prompt=p,
                       sampling_params=JaxSP(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]
    jax_hostprof.reset()
    outs = engine.generate(reqs, timeout_s=600)
    return [o.output_token_ids for o in outs], list(jax_hostprof.events)


def _run_port():
    tree = init_decoder_weights(JaxFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                                jnp.float32)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    cfg = NodeConfig(batch_scheduler=BatchSchedulerConfig(max_running_requests=3),
                     request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                              block_size=4),
                     **NODE)
    engine = OfflineEngine(cfg, model_factory=RandomWeightFactory(
        "tiny-lm", dtype=torch.float32, device="cpu", weights=weights),
        node_type="PD", device="cpu")
    reqs = [Request(request_id=f"r{i}", prompt=p,
                    sampling_params=SamplingParameters(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]
    hostprof.reset()
    outs = engine.generate(reqs, timeout_s=600)
    return [o.output_token_ids for o in outs], list(hostprof.events)


def test_window_timeline_matches_jax(monkeypatch):
    for module in (hostprof, jax_hostprof):
        monkeypatch.setattr(module, "enabled", True)
        monkeypatch.setattr(module, "events_enabled", True)
    port_tokens, port_events = _run_port()
    jax_tokens, jax_events = _run_jax()
    assert port_tokens == jax_tokens
    port, ref = _windows(port_events), _windows(jax_events)
    assert len(port) == len(ref) > 1, (port, ref)
    for windows in (port, ref):
        for w in windows:
            assert w in (["dispatched", "ready", "read_start", "read_done"],
                         ["dispatched", "read_start", "read_done"]), w
    without_ready = lambda ws: [[n for n in w if n != "ready"] for w in ws]   # noqa: E731
    assert without_ready(port) == without_ready(ref)
    assert all("ready" in w for w in port), port      # synchronous on the CPU
    times = [t for _, _, t in port_events]
    assert times == sorted(times)
    assert hostprof.report()["fill.d2h_read"]["n"] == len(port)
    hostprof.reset()
    assert hostprof.events == [] and hostprof.report() == {}


def test_timeline_is_off_below_level_2(monkeypatch):
    monkeypatch.setattr(hostprof, "events_enabled", False)
    hostprof.reset()
    hostprof.event("dispatched", 1)
    assert hostprof.events == []
    monkeypatch.setattr(hostprof, "events_enabled", True)
    hostprof.event("dispatched", 1)
    assert [(n, t) for n, t, _ in hostprof.events] == [("dispatched", 1)]
    hostprof.reset()
