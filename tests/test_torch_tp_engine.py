"""The port's tensor-parallel engine against the JAX single-device engine
(CPU; the JAX package's own tests/parallel/test_tp_engine.py holds its TP
engine to the same tokens, so no JAX TP engine is compiled here).

One node over a list of CPU devices (`device=["cpu"] * tp`, every rank on
the one CPU) serves the same requests as the JAX OfflineEngine on the same
weights, and must emit the same greedy tokens, at tp 2 and 4, in f32 and
with int8 weights and an int8 KV cache, for tiny-lm (4 q over 2 KV heads):
at tp 2 each rank holds one KV pair, at tp 4 each KV head is copied on the
two ranks whose q heads read it (the replicated-K/V form). The MoE models
are in tests/test_torch_tp_moe_engine.py. Also: a
`ClusterConfig(tp_size=4)` cluster over eight CPU devices forms two node
groups and serves disaggregated (EP + D); the entry point serves at
`cluster.tp_size=2` over HTTP as at 1; the verify step of n-gram
speculation under TP gives plain decoding's tokens, the JAX single-device
engine's (tests/engine/test_spec_decode.py:163); GPT-2, which has no
tensor-parallel form, is refused on a device list. The JAX engine serves
the module's tiny-lm requests (PROMPTS and SPEC_PROMPTS) in one run a
format.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import time

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
from hydrainfer_tpu_torch.cluster.cluster import Cluster, ClusterConfig
from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeConfig, NodeContext
from hydrainfer_tpu_torch.cluster.migrate import NodeType
from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
from hydrainfer_tpu_torch.engine.request_processor import (RequestProcessorConfig,
                                                           RequestProcessParameters)
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.parallel.mesh import ShardedWeights
from hydrainfer_tpu_torch.request import Request, SamplingParameters

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk"]
MAX_TOKENS = (16, 5, 16, 12)
# they repeat themselves, for the n-gram drafts of the verify test; the JAX
# engine serves them in the same run as PROMPTS
SPEC_PROMPTS = ["abc abc abc abc abc abc", "ab ab ab ab ab"]
SPEC_MAX_TOKENS = (24, 24)
QUANTS = [("none", None), ("int8", 0.05)]
QUANT_IDS = ["f32", "int8w_int8kv"]


def _node_cfg(spec_k: int = 0, max_running: int = 4, n_steps: int = 4) -> dict:
    return dict(batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
                request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                         block_size=4),
                kv_block_size=4, n_kv_blocks=128, n_image_blocks=1,
                multi_step_decode=n_steps, spec_ngram_k=spec_k)


def _requests(prompts=PROMPTS, max_tokens=MAX_TOKENS, cls=Request, sp=SamplingParameters):
    return [cls(request_id=f"r{i}", prompt=p,
                sampling_params=sp(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(prompts, max_tokens))]


_WEIGHTS, _JAX = {}, {}


def tiny_weights(quant: str) -> dict:
    """The JAX random init of tiny-lm, carried over through numpy."""
    if quant not in _WEIGHTS:
        tree = init_decoder_weights(JaxFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                                    jnp.float32, quantization=quant)
        _WEIGHTS[quant] = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    return _WEIGHTS[quant]


def jax_tiny_tokens(quant: str, kv_scale, prompts=PROMPTS + SPEC_PROMPTS,
                    max_tokens=MAX_TOKENS + SPEC_MAX_TOKENS) -> list:
    """The JAX single-device engine's greedy tokens on tiny-lm (the node
    settings of _node_cfg(), a token budget of 16), one run a module for
    each set of requests."""
    key = (quant, tuple(prompts), tuple(max_tokens))
    if key not in _JAX:
        factory = JaxFactory("tiny-lm", dtype=jnp.float32, quantization=quant,
                             kv_scale=kv_scale)
        cfg = JaxNodeConfig(
            batch_scheduler=JaxBSConfig(max_running_requests=4),
            request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
            kv_block_size=4, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
            spec_ngram_k=0)
        cfg.model.dtype = "float32"
        if kv_scale is not None:
            cfg.model.kv_cache_dtype = "int8"
        engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="PD")
        engine.node.batch_scheduler.token_budget = 16
        _JAX[key] = [o.output_token_ids for o in engine.generate(
            _requests(prompts, max_tokens, cls=JaxRequest, sp=JaxSP), timeout_s=600)]
    return _JAX[key]


def tiny_factory(quant: str, kv_scale) -> RandomWeightFactory:
    return RandomWeightFactory("tiny-lm", dtype=torch.float32, quantization=quant,
                               kv_scale=kv_scale, device="cpu", weights=tiny_weights(quant))


def serve(factory, devices, requests, token_budget=16, **cfg_kw):
    engine = OfflineEngine(NodeConfig(**_node_cfg(**cfg_kw)), model_factory=factory,
                           node_type="PD", device=devices)
    engine.node.batch_scheduler.token_budget = token_budget
    return engine, [o.output_token_ids for o in engine.generate(requests, timeout_s=600)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant,kv_scale", QUANTS, ids=QUANT_IDS)
def test_tiny_lm_tp_engine_matches_jax_single_device(quant, kv_scale, tp):
    engine, got = serve(tiny_factory(quant, kv_scale), ["cpu"] * tp, _requests())
    lm = engine.node.worker.language_model
    assert isinstance(lm.weights, ShardedWeights) and lm.tp_size == tp
    caches = engine.node.kv_cache_manager.cache_array
    # 2 KV heads: one pair a rank at tp 2, a copy of one pair a rank at tp 4
    assert [c.shape[-2] for c in caches] == [2] * tp
    assert caches[0].dtype == (torch.int8 if kv_scale else torch.float32)
    assert got == jax_tiny_tokens(quant, kv_scale)[:len(PROMPTS)]


def test_cluster_tp4_groups_serve_disaggregated():
    """tp_size=4 over eight devices: two node groups of four ranks each,
    which the auto topology makes EP + D; a text request is prefilled on the
    EP group and decoded on the D group, whose tokens are the JAX engine's."""
    cfg = ClusterConfig(tp_size=4)
    cfg.node = NodeConfig(**_node_cfg())
    cluster = Cluster(cfg, devices=[torch.device("cpu")] * 8,
                      model_factory_provider=lambda: tiny_factory("none", None))
    assert [(n.name, len(n.devices)) for n in cluster.nodes] == [("EPNode:ep0", 4),
                                                                 ("DNode:d0", 4)]
    for n in cluster.nodes:
        assert n.worker.language_model.tp_size == 4
        n.batch_scheduler.token_budget = 16

    async def run():
        procs = [LogOutputTokenProcessor() for _ in PROMPTS]
        for req, proc in zip(_requests(), procs):
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc]))
        deadline = time.perf_counter() + 120
        while not all(p.finished for p in procs):
            for node in cluster.nodes:
                await node.step()
            await asyncio.sleep(0)
            assert time.perf_counter() < deadline
        return [p.token_ids for p in procs]

    assert asyncio.run(run()) == jax_tiny_tokens("none", None)[:len(PROMPTS)]
    assert cluster.nodes[1].metrics()["migration_pulls"] == len(PROMPTS)


@pytest.mark.parametrize("quant,kv_scale", QUANTS, ids=QUANT_IDS)
def test_verify_step_under_tp_gives_plain_decoding(quant, kv_scale):
    """n-gram speculation at k = 3 on a tp-2 node: the verify steps' logits
    are gathered on rank 0, where the drafts are accepted, and the tokens
    are plain decoding's: the JAX single-device engine's, and the port's
    own single-device node's. Two repetitive prompts on a node that runs four
    take single steps, each a chance to speculate."""
    reqs = lambda: _requests(SPEC_PROMPTS, SPEC_MAX_TOKENS)  # noqa: E731
    engine, got = serve(tiny_factory(quant, kv_scale), ["cpu"] * 2, reqs(), spec_k=3)
    fx = engine.node.fill_executor
    assert fx.spec_steps > 0 and fx.spec_tokens > fx.spec_steps
    assert got == jax_tiny_tokens(quant, kv_scale)[len(PROMPTS):]
    _, plain = serve(tiny_factory(quant, kv_scale), "cpu", reqs())
    assert got == plain


def test_entry_point_serves_at_tp_size_2():
    """The OpenAI-compatible entry point in process with cluster.tp_size=2
    on the CPU (both ranks on it): a chat completion over HTTP equals tp
    1's."""
    from hydrainfer_tpu_torch.config import load_config
    from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig
    from tests.test_torch_online import SERVE_YAML, TINY, ServedEntryPoint, free_port, post

    texts = []
    for tp in (1, 2):
        port = free_port()
        entry = EntryPoint(load_config(EntryPointConfig, SERVE_YAML, [
            *TINY, "cluster.node.model.name=random:tiny-lm", f"cluster.tp_size={tp}",
            f"api_server.port={port}"]))
        assert entry.cluster.nodes[0].worker.language_model.tp_size == tp
        server = ServedEntryPoint(entry, port)
        try:
            out = post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "tensor parallel"}],
                "max_tokens": 8, "ignore_eos": True})
        finally:
            assert server.stop() == []
        assert out["usage"]["completion_tokens"] == 8
        texts.append(out["choices"][0]["message"])
    assert texts[0] == texts[1]


def test_gpt2_refuses_tensor_parallel_ranks():
    """GPT-2's layer loop is its own and has no TP form: a node on two
    devices refuses it where the JAX node would run it on its first
    device."""
    from hydrainfer_tpu_torch.models.gpt2 import GPT2ForCausalLM

    class Factory(RandomWeightFactory):
        def getLanguageModel(self):
            return GPT2ForCausalLM({"wte": torch.zeros(8, 4)}, None)

    node = AsyncEPDNode(NodeConfig(**_node_cfg()), NodeContext(
        node_type=NodeType("PD"), device=["cpu", "cpu"]))
    with pytest.raises(NotImplementedError, match="GPT2ForCausalLM has no tensor-parallel"):
        node.init(Factory("tiny-lm", device="cpu"))
