"""The port's pipeline-parallel engine on the other decoder forms, against
the JAX single-device engine (CPU): mla-tiny-lm (MLA over the single-plane
latent cache, each stage holding its layers' plane) and a tiny Mixtral
checkpoint (every layer MoE, a uniform signature) on one PD node of two
stages, both on the one CPU; the requests, node settings and JAX references
of tests/test_torch_mla.py and tests/test_torch_mixtral.py. The tokens must
equal the JAX engine's, and both step forms must run.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS  # noqa: E402
from hydrainfer_tpu.models.random_init import init_decoder_weights  # noqa: E402
from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory  # noqa: E402
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402
from tests import test_torch_mixtral as mixtral_tests  # noqa: E402
from tests import test_torch_mla as mla_tests  # noqa: E402
from tests.test_torch_mixtral import ckpt  # noqa: E402,F401  (the tiny Mixtral fixture)


def serve_pp(factory, requests, max_running: int):
    """One PD node over two pipeline stages on the CPU (block 4, 128 blocks,
    a 16-token budget): (its tokens, its steps by form, its cache)."""
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
        spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=factory, node_type="PD", device=["cpu"] * 2,
                           parallel="pp")
    engine.node.batch_scheduler.token_budget = 16
    got = [o.output_token_ids for o in engine.generate(requests, timeout_s=600)]
    return (got, engine.node.worker.language_model.stages.steps,
            engine.node.kv_cache_manager.cache_array)


def test_mla_tiny_lm_pp_engine_matches_jax():
    tree = init_decoder_weights(JAX_ARCHS[mla_tests.ARCH], jax.random.PRNGKey(0), jnp.float32)
    factory = RandomWeightFactory(mla_tests.ARCH, dtype=torch.float32, device="cpu",
                                  weights=from_jax_numpy(jax.tree_util.tree_map(
                                      np.asarray, tree), "cpu"))
    got, steps, caches = serve_pp(factory, mla_tests._requests(Request, SamplingParameters), 4)
    assert [tuple(c.shape[:1]) + tuple(c.shape[-2:]) for c in caches] == [(1, 1, 24)] * 2
    assert steps["relay"] > 0 and steps["micro"] > 0, steps
    assert got == mla_tests.jax_tokens("none", None)


def test_mixtral_pp_engine_matches_jax(ckpt):  # noqa: F811
    path = ckpt[0]
    _, factory = mixtral_tests._factories(path)
    factory.getTokenizer = lambda: SimpleTokenizer(image_token="<image>", image_token_id=0,
                                                   eos_token_id=1)
    got, steps, caches = serve_pp(factory, mixtral_tests._requests(Request, SamplingParameters),
                                  5)
    assert [c.shape[0] for c in caches] == [1, 1]
    assert steps["relay"] > 0 and steps["micro"] > 0, steps
    assert got == mixtral_tests._jax_tokens(path, "none", False)
