"""Stochastic sampling through the port's engine, on the CPU (mirrors
tests/engine/test_stochastic_sampling.py).

A tiny Llama checkpoint is built in process with transformers, as the JAX
test builds it, and served by the port's OfflineEngine in f32: greedy is
deterministic, temperature varies the output, top-k 1 at temperature 0.8
gives the greedy tokens (the JAX engine's, over the same checkpoint), and in
a batch mixing a greedy and a sampled request the greedy one is unaffected.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import pytest
import torch

transformers = pytest.importorskip("transformers")

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig  # noqa: E402
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig  # noqa: E402
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig  # noqa: E402
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine  # noqa: E402
from hydrainfer_tpu.models import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok  # noqa: E402
from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory  # noqa: E402
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("sampling_llama")
    cfg_hf = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg_hf).eval().float().save_pretrained(
        path, safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def engine(ckpt):
    factory = getModelFactory(ModelFactoryConfig(path=ckpt, dtype="float32"), "cpu")
    factory.getTokenizer = lambda: SimpleTokenizer()
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=8),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=256)
    return OfflineEngine(cfg, model_factory=factory, node_type="PD", device="cpu")


def gen(engine, temperature, n=12, top_k=-1, top_p=1.0, prompt="sample me"):
    out = engine.generate([Request(
        request_id="s", prompt=prompt, sampling_params=SamplingParameters(
            max_tokens=n, ignore_eos=True, temperature=temperature, top_k=top_k,
            top_p=top_p))], timeout_s=120)[0]
    return out.output_token_ids


def test_greedy_is_deterministic(engine):
    assert gen(engine, 0.0) == gen(engine, 0.0)


def test_temperature_varies_output(engine):
    a, b, c = gen(engine, 1.5), gen(engine, 1.5), gen(engine, 0.0)
    assert a != b and a != c
    assert all(0 <= t < 256 for t in a + b)


def test_top_k_1_equals_greedy_and_jax_greedy(engine, ckpt):
    greedy = gen(engine, 0.0)
    assert gen(engine, 0.8, top_k=1) == greedy
    factory = jax_get_factory(JaxMFC(path=ckpt, dtype="float32", attention_impl="jnp"))
    factory.getTokenizer = lambda: JaxTok()
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=8),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=256, n_image_blocks=2)
    cfg.model.dtype = "float32"
    jax_engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="PD")
    ref = jax_engine.generate([JaxRequest(
        request_id="s", prompt="sample me",
        sampling_params=JaxSP(max_tokens=12, ignore_eos=True))], timeout_s=120)[0]
    assert greedy == ref.output_token_ids


def test_mixed_batch_greedy_and_sampled(engine):
    outs = engine.generate([
        Request(request_id="g", prompt="mixed", sampling_params=SamplingParameters(
            max_tokens=8, ignore_eos=True, temperature=0.0)),
        Request(request_id="s", prompt="mixed", sampling_params=SamplingParameters(
            max_tokens=8, ignore_eos=True, temperature=1.5))], timeout_s=120)
    assert outs[0].output_token_ids == gen(engine, 0.0, n=8, prompt="mixed")
    assert len(outs[1].output_token_ids) == 8
