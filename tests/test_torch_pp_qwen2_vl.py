"""The port's pipeline-parallel EPD node on Qwen2-VL against the JAX
single-device engine (CPU): the tiny checkpoint of tests/test_torch_qwen2_vl.py
(two decoder layers, M-RoPE sections (2, 2, 2)) on one EPD node of two
stages, both on the one CPU. The vision tower, the image cache, the image
splice and the M-RoPE gather stay on stage 0's device, before the relay;
an image request and a text request, K = 1 windows (a pipeline-parallel
node runs single steps). The tokens must equal the JAX engine's, with the
image prefill through the relay and the decode steps microbatched.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import pytest

pytest.importorskip("transformers")
pytest.importorskip("PIL.Image")

from hydrainfer_tpu_torch.cluster.node import NodeConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig  # noqa: E402
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig  # noqa: E402
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine  # noqa: E402
from hydrainfer_tpu_torch.models import qwen2_vl  # noqa: E402
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402
from tests.test_torch_qwen2_vl import (IMAGE_ID, ckpt, factories, image,  # noqa: E402,F401
                                       run_jax)


def test_epd_pp_engine_matches_jax_engine(ckpt, monkeypatch):  # noqa: F811
    monkeypatch.setattr(qwen2_vl.Qwen2VLModelFactory, "getTokenizer", lambda self:
                        SimpleTokenizer(image_token="<image>", image_token_id=IMAGE_ID,
                                        eos_token_id=63))
    _, pf = factories(ckpt[0])
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=2),
        request_processor=RequestProcessorConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=128, n_image_blocks=4, multi_step_decode=1,
        spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=pf, node_type="EPD", device=["cpu"] * 2,
                           parallel="pp")
    sp = lambda: SamplingParameters(max_tokens=10, ignore_eos=True)  # noqa: E731
    got = [o.output_token_ids for o in engine.generate([
        Request(request_id="m0", prompt="<image> !%&!", image=image(56, 84),
                sampling_params=sp()),
        Request(request_id="t0", prompt="!! % &&", sampling_params=sp())], timeout_s=600)]
    node = engine.node
    steps = node.worker.language_model.stages.steps
    assert steps["relay"] > 0 and steps["micro"] > 0, steps
    assert node.image_cache_manager.cache_array.device == node.device
    assert [len(t) for t in got] == [10, 10]
    assert got == run_jax(ckpt[0], "none", False, 1, monkeypatch)
