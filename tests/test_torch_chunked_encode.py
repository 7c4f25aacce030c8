"""The port's layer-chunked encode, against its whole-tower encode and the
JAX package's, on the CPU.

Mirrors tests/engine/test_chunked_encode.py on the port (tiny-lm with the
CLIP_TINY tower, f32, one EPD node): the tower split into one-layer segments
across engine steps gives the same tokens as the whole-tower encode, and a
batch of image requests only (no fills resident, so most steps schedule
nothing) keeps the encode advancing and its requests rejoin the scheduler.
With the JAX random weights carried over (models/weight_bridge.py), the
chunked port gives the chunked JAX engine's tokens. While an encode is in
flight the decode window is at most encode_chunk_window, image batches
scheduled meanwhile go back to the scheduler, and the serving loop takes no
pause between steps.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine.request_processor import RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.models import random_init as jax_random
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine import executor as port_executor
from hydrainfer_tpu_torch.engine.isa import ImageEmbed
from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import CLIP_TINY, RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy, from_jax_vision_numpy
from hydrainfer_tpu_torch.request import Request, SamplingParameters


def _image():
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8))


def _mixed(req_cls, sp_cls, n=3, max_tokens=6):
    """Image requests at even indices, text requests between them."""
    img = _image()
    return [req_cls(request_id=f"r{i}",
                    prompt=("<image> describe " if i % 2 == 0 else "plain ") + f"req {i}",
                    image=img if i % 2 == 0 else None,
                    sampling_params=sp_cls(max_tokens=max_tokens, ignore_eos=True))
            for i in range(n)]


def _port_cfg(chunk_layers, max_running=4, n_image_blocks=8, image_budget=8):
    return NodeConfig(
        profiler=BatchSchedulerProfilerConfig(enabled=False,
                                              default_image_budget=image_budget),
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=256, n_image_blocks=n_image_blocks,
        encode_chunk_layers=chunk_layers, image_block_size=CLIP_TINY.n_patches)


def _port_engine(chunk_layers, factory=None, **kw):
    factory = factory or RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu",
                                             multimodal=True, clip_cfg=CLIP_TINY)
    return OfflineEngine(_port_cfg(chunk_layers, **kw), model_factory=factory,
                         node_type="EPD", device="cpu")


def _tokens(engine, reqs):
    return [o.output_token_ids for o in engine.generate(reqs, timeout_s=120)]


def test_chunked_encode_token_identical():
    base = _tokens(_port_engine(0), _mixed(Request, SamplingParameters))
    chunked = _tokens(_port_engine(1), _mixed(Request, SamplingParameters))
    assert all(len(t) == 6 for t in base), base
    assert base == chunked, (base, chunked)


def test_chunked_encode_all_image_batch():
    """Image requests only: most steps schedule nothing while the encode
    runs, and the encode must still advance and hand its requests back."""
    engine = _port_engine(1, max_running=8, n_image_blocks=16)
    img = _image()
    reqs = [Request(request_id=f"e{i}", prompt="<image> x", image=img,
                    sampling_params=SamplingParameters(max_tokens=2, ignore_eos=True))
            for i in range(6)]
    outs = engine.generate(reqs, timeout_s=120)
    assert all(len(o.output_token_ids) == 2 for o in outs)
    assert not engine.node.image_embed_executor.busy


def test_window_is_capped_and_embeds_requeue_while_encoding(monkeypatch):
    """While the encode is in flight: decode windows of at most
    encode_chunk_window steps, and an image batch scheduled meanwhile goes
    back to the scheduler (it starts only once the encoder is free). One
    image a step (image budget 1), so the second image is scheduled while
    the first is still encoding."""
    engine = _port_engine(1, max_running=8, image_budget=1)
    node, iee = engine.node, engine.node.image_embed_executor
    windows, starts, bounced = [], [], []
    orig_exec, orig_start = port_executor.FillExecutor.execute, iee.start_chunked
    orig_schedule = node.batch_scheduler.step

    def spy_schedule():
        batch = orig_schedule()
        bounced.extend(rcb for rcb, inst in batch
                       if iee.busy and isinstance(inst, ImageEmbed))
        return batch

    def spy_exec(self, batch, n_steps=1):
        windows.append((iee.busy, n_steps))
        return orig_exec(self, batch, n_steps)

    def spy_start(batch):
        assert not iee.busy
        starts.append(len(batch))
        return orig_start(batch)

    monkeypatch.setattr(port_executor.FillExecutor, "execute", spy_exec)
    monkeypatch.setattr(iee, "start_chunked", spy_start)
    monkeypatch.setattr(node.batch_scheduler, "step", spy_schedule)
    img = _image()
    text = [Request(request_id=f"t{i}", prompt=f"plain text {i}",
                    sampling_params=SamplingParameters(max_tokens=40, ignore_eos=True))
            for i in range(4)]
    images = [Request(request_id=f"m{i}", prompt="<image> x", image=img,
                      sampling_params=SamplingParameters(max_tokens=4, ignore_eos=True))
              for i in range(3)]
    outs = engine.generate(text + images, timeout_s=120)
    assert [len(o.output_token_ids) for o in outs] == [40] * 4 + [4] * 3
    assert starts == [1, 1, 1] and bounced
    busy = [n for b, n in windows if b]
    assert busy and max(busy) <= node.config.encode_chunk_window
    assert max(n for b, n in windows if not b) > node.config.encode_chunk_window


def test_serving_loop_runs_segments_back_to_back():
    """The node's own serving loop (as the API server drives it) steps
    without its step_interval_s pause while a chunked encode holds requests,
    and with it otherwise; every request finishes."""
    import asyncio
    import time

    from hydrainfer_tpu_torch.engine.output_token_processor import (
        OfflineOutputTokenProcessor, OutputTokenParams)
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
    from hydrainfer_tpu_torch.request import OfflineInferenceOutput
    engine = _port_engine(1, max_running=8)
    node = engine.node
    node.config.step_interval_s = 0.05
    pauses, pause = [], node._pause

    def spy():
        pauses.append((node.image_embed_executor.busy, pause()))
        return pauses[-1][1]

    node._pause = spy
    reqs = _mixed(Request, SamplingParameters, n=4)

    async def serve():
        outs, done = [], []
        for req in reqs:
            outs.append(OfflineInferenceOutput(arrival_time=time.perf_counter()))
            proc = OfflineOutputTokenProcessor(outs[-1], engine.tokenizer,
                                               on_finish=done.append)
            await node.add_request(req, RequestProcessParameters(
                output_token_processors=[proc],
                output_token_params=OutputTokenParams(stream_output=False)))
        await node.start()
        try:
            deadline = time.perf_counter() + 120
            while len(done) < len(reqs) and time.perf_counter() < deadline:
                await asyncio.sleep(0.01)
        finally:
            await node.stop()
        return outs

    outs = asyncio.run(serve())
    assert [len(o.output_token_ids) for o in outs] == [6] * 4
    assert {p for busy, p in pauses if busy} == {0.0}
    assert {p for busy, p in pauses if not busy} == {0.05}


def _jax_trees():
    lm = jax_random.init_decoder_weights(jax_random.ARCH_CONFIGS["tiny-lm"],
                                         jax.random.PRNGKey(0), jnp.float32)
    vision = jax_random.init_clip_weights(jax_random.CLIP_TINY, jax.random.PRNGKey(1),
                                          jnp.float32, lm_hidden=128)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(lm), to_np(vision)


@pytest.mark.parametrize("chunk_layers", [1, 2])
def test_chunked_port_matches_chunked_jax(chunk_layers):
    lm, vision = _jax_trees()
    factory = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu",
                                  weights=from_jax_numpy(lm, "cpu"), multimodal=True,
                                  clip_cfg=CLIP_TINY,
                                  vision_weights=from_jax_vision_numpy(vision, "cpu"))
    got = _tokens(_port_engine(chunk_layers, factory),
                  _mixed(Request, SamplingParameters, n=4))
    cfg = JaxNodeConfig(
        batch_scheduler=JaxBSConfig(max_running_requests=4),
        request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
        kv_block_size=4, n_kv_blocks=256, n_image_blocks=8,
        encode_chunk_layers=chunk_layers, image_block_size=CLIP_TINY.n_patches)
    cfg.model.dtype = "float32"
    jf = jax_random.RandomWeightFactory("tiny-lm", dtype=jnp.float32, multimodal=True,
                                        clip_cfg=jax_random.CLIP_TINY)
    ref = _tokens(JaxOfflineEngine(cfg, model_factory=jf, node_type="EPD"),
                  _mixed(JaxRequest, JaxSP, n=4))
    assert all(len(t) == 6 for t in got)
    assert got == ref
