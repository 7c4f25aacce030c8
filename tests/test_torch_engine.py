"""The port's OfflineEngine against the JAX OfflineEngine on tiny-lm (CPU, f32).

Both engines serve the same requests over the same weights (the JAX random
init, carried over through numpy), with speculative decoding off on both, and
must emit the same greedy tokens: once with plain f32 weights and once with
int8 weights and an int8 KV cache. The traffic covers mixed prefill/decode
batches, chunked prefill (a 24-token budget), a prefix-cache hit (a second
call re-sending a served prompt) and fused K=16 decode windows.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine import executor as port_executor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.request import Request, SamplingParameters

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk", "mid size one"]
MAX_TOKENS = (24, 5, 24, 20, 24)
# second call: a served prompt again (prefix-cache hit) plus a fresh one
PROMPTS_2 = ["jumps over the lazy dog and runs", "zz top"]
MAX_TOKENS_2 = (18, 18)


def _node_kwargs():
    return dict(kv_block_size=4, n_kv_blocks=256, multi_step_decode=16,
                spec_ngram_k=0)


def run_jax(quant: str, kv_scale):
    factory = JaxFactory("tiny-lm", dtype=jnp.float32, quantization=quant,
                         kv_scale=kv_scale)
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=5, priority="prefill"),
        request_processor=JaxRPConfig(num_request_process_workers=1,
                                      block_size=4),
        n_image_blocks=1, **_node_kwargs())
    cfg.model.dtype = "float32"
    if kv_scale is not None:
        cfg.model.kv_cache_dtype = "int8"
    engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="PD")
    engine.node.batch_scheduler.token_budget = 24
    out = []
    for prompts, max_tokens in ((PROMPTS, MAX_TOKENS), (PROMPTS_2, MAX_TOKENS_2)):
        reqs = [JaxRequest(request_id=f"r{i}", prompt=p,
                           sampling_params=JaxSP(max_tokens=m, ignore_eos=True))
                for i, (p, m) in enumerate(zip(prompts, max_tokens))]
        out.append([o.output_token_ids for o in engine.generate(reqs, timeout_s=600)])
    return out


def run_port(quant: str, kv_scale, weights):
    factory = RandomWeightFactory("tiny-lm", dtype=torch.float32,
                                  quantization=quant, kv_scale=kv_scale,
                                  device="cpu", weights=weights)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=5),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        **_node_kwargs())
    engine = OfflineEngine(cfg, model_factory=factory, node_type="PD",
                           device="cpu")
    engine.node.batch_scheduler.token_budget = 24
    out, hit_rates = [], []
    for prompts, max_tokens in ((PROMPTS, MAX_TOKENS), (PROMPTS_2, MAX_TOKENS_2)):
        reqs = [Request(request_id=f"r{i}", prompt=p,
                        sampling_params=SamplingParameters(max_tokens=m,
                                                           ignore_eos=True))
                for i, (p, m) in enumerate(zip(prompts, max_tokens))]
        out.append([o.output_token_ids for o in engine.generate(reqs, timeout_s=600)])
        hit_rates.append(engine.node.kv_cache_manager.metrics().prefix_cache_hit_rate)
    return out, hit_rates


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_port_engine_matches_jax_engine(quant, kv_scale, monkeypatch):
    tree = init_decoder_weights(JaxFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                                jnp.float32, quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")

    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    got, hit_rates = run_port(quant, kv_scale, weights)
    ref = run_jax(quant, kv_scale)
    assert got == ref
    assert [len(t) for t in got[0]] == list(MAX_TOKENS)
    assert [len(t) for t in got[1]] == list(MAX_TOKENS_2)
    assert 16 in windows, f"no fused K=16 window ran: {sorted(set(windows))}"
    assert hit_rates[1] > hit_rates[0], "the second call hit no cached prefix"
