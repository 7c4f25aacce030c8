"""The port's online serving path against the JAX package's, on the CPU.

Each package's entry point (EntryPoint: the in-process cluster behind the
OpenAI-compatible aiohttp server) is built from config/serve.yaml by that
package's own loader, with the same tiny overrides (one EPD node on the CPU,
the budget search off, one request-processing worker), and served over a
real socket from a thread of its own; the JAX servers are shared by the
module. Requests go one at a time, so both schedules match, and the answers
must be equal: /v1/completions text, non-stream chat text and usage, and the
stream's deltas one by one (which holds the incremental detokenizer too).
Models: tiny-lm with the JAX weights carried over (models/weight_bridge.py),
in f32 and with int8 weights and an int8 KV cache; the fake model (through
getModelFactory on both sides), text and image; a tiny Qwen2-VL checkpoint
built in process with transformers and loaded through getModelFactory(path)
on both sides, for an image chat; `random:tiny-lm+mm` (LLaVA's CLIP tower at
CLIP_TINY over tiny-lm), the JAX weights carried over, for an image chat,
and the port alone from that name, its own random weights, for an image
chat whose prompt counts the image's 16 tokens.

Sampling: top-k 1 at temperature 0.8 gives the JAX server's chat text; a
sampled completion answers, and a sampled stream ends with its deltas.
Port-only cases: a malformed body gets a 400, a burst of 8 concurrent streams each ends with its max_tokens,
stop() leaves no task running. Disaggregated (the fake model, EP + D behind
the server): concurrent chats answer, /metrics lists both nodes and the D
node's pulls, and a lone completion gives the JAX EP + D server's text. The budget search: with one timer on both
profilers the budgets are equal; a real search on the CPU executor gives
back every KV block, image block and token-table slot; a failed search takes
the default and is counted. IncrementalDecoder equals the JAX decoder on the
surrogate streams of tests/models/test_streaming_detokenizer.py and on
multi-byte characters split across byte tokens.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import base64
import http.client
import io
import json
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hydrainfer_tpu.config import load_config as jax_load_config
from hydrainfer_tpu.engine.profiler import BatchSchedulerProfiler as JaxProfiler
from hydrainfer_tpu.engine.profiler import \
    BatchSchedulerProfilerConfig as JaxProfilerConfig
from hydrainfer_tpu.entrypoint.entrypoint import EntryPoint as JaxEntryPoint
from hydrainfer_tpu.entrypoint.entrypoint import EntryPointConfig as JaxEntryPointConfig
from hydrainfer_tpu.models import qwen2_vl as jax_qvl
from hydrainfer_tpu.models.random_init import CLIP_TINY as JAX_CLIP_TINY
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxRandomFactory
from hydrainfer_tpu.models.random_init import init_clip_weights, init_decoder_weights
from hydrainfer_tpu.models.tokenizer import IncrementalDecoder as JaxDecoder
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok
from hydrainfer_tpu_torch.config import load_config
from hydrainfer_tpu_torch.engine.profiler import (BatchSchedulerProfiler,
                                                  BatchSchedulerProfilerConfig)
from hydrainfer_tpu_torch.entrypoint.api_server import APIServer, APIServerConfig
from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPoint, EntryPointConfig
from hydrainfer_tpu_torch.models import qwen2_vl
from hydrainfer_tpu_torch.models.random_init import CLIP_TINY, RandomWeightFactory
from hydrainfer_tpu_torch.models.tokenizer import IncrementalDecoder, SimpleTokenizer
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy, from_jax_vision_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_YAML = os.path.join(REPO, "config", "serve.yaml")
TINY = ["cluster.cluster_type=single", "cluster.platform=cpu",
        "cluster.node.kv_block_size=4", "cluster.node.n_kv_blocks=256",
        "cluster.node.n_image_blocks=4", "cluster.node.profiler.enabled=false",
        "cluster.node.request_processor.num_request_process_workers=1",
        "cluster.node.batch_scheduler.max_running_requests=8",
        "cluster.node.model.dtype=float32"]
INT8 = ["cluster.node.model.quantization=int8", "cluster.node.model.kv_cache_dtype=int8"]
VL_TOKEN = "<|vision_start|><|image_pad|><|vision_end|>"
VL_IMAGE_ID, VL_VOCAB = 150, 160


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServedEntryPoint:
    """An entry point's run() on an event loop of its own thread; stop()
    cancels it (its finally stops the cluster and the server) and returns
    the tasks still pending on that loop."""

    def __init__(self, entry, port: int):
        self.port = port
        self.loop = asyncio.new_event_loop()
        self.leftover = None
        self.thread = threading.Thread(target=self._main, args=(entry,), daemon=True)
        self.thread.start()
        deadline = time.time() + 60
        while True:
            try:
                if request(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)

    def _main(self, entry):
        asyncio.set_event_loop(self.loop)
        stop = asyncio.Event()
        self.task = self.loop.create_task(
            entry.run(stop) if isinstance(entry, EntryPoint) else entry.run())
        try:
            self.loop.run_until_complete(self.task)
        except asyncio.CancelledError:
            pass
        self.leftover = [t for t in asyncio.all_tasks(self.loop) if not t.done()]
        self.loop.close()

    def stop(self):
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        return self.leftover


def request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        data = raw if raw is not None else (None if body is None
                                            else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def post(port, path, body):
    status, data = request(port, "POST", path, body)
    assert status == 200, data
    return json.loads(data)


def stream_chat(port, body):
    """The stream's chunks, parsed, and whether it ended in [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(dict(body, stream=True)).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        chunks, done = [], False
        for line in resp.read().decode().splitlines():
            if line.startswith("data: "):
                if line == "data: [DONE]":
                    done = True
                else:
                    chunks.append(json.loads(line[len("data: "):]))
        return chunks, done
    finally:
        conn.close()


def deltas(chunks):
    return [(c["choices"][0]["delta"].get("role"), c["choices"][0]["delta"].get("content"),
             c["choices"][0]["finish_reason"]) for c in chunks]


def serve_pair(overrides, jax_factory=None, port_factory=None):
    """(JAX server, port server) from config/serve.yaml and `overrides`."""
    servers = []
    for load, cfg_cls, entry_cls, factory in (
            (jax_load_config, JaxEntryPointConfig, JaxEntryPoint, jax_factory),
            (load_config, EntryPointConfig, EntryPoint, port_factory)):
        port = free_port()
        cfg = load(cfg_cls, SERVE_YAML, [*TINY, *overrides, f"api_server.port={port}"])
        servers.append(ServedEntryPoint(entry_cls(cfg, model_factory=factory), port))
    return servers


@pytest.fixture(scope="module", params=["f32", "int8w_int8kv"])
def tiny_lm(request):
    quant, kv_scale, extra = (("none", None, []) if request.param == "f32"
                              else ("int8", 0.05, INT8))
    tree = init_decoder_weights(JaxRandomFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                                jnp.float32, quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    jf = JaxRandomFactory("tiny-lm", dtype=jnp.float32, quantization=quant,
                          kv_scale=kv_scale)
    pf = RandomWeightFactory("tiny-lm", dtype=torch.float32, quantization=quant,
                             kv_scale=kv_scale, device="cpu", weights=weights)
    servers = serve_pair(extra, jf, pf)
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def test_completion_text_matches_jax(tiny_lm):
    body = {"prompt": "the quick brown fox", "max_tokens": 12, "ignore_eos": True}
    jax_out, port_out = (post(p, "/v1/completions", body) for p in tiny_lm)
    assert port_out["object"] == "text_completion"
    assert port_out["choices"][0]["text"] == jax_out["choices"][0]["text"]
    assert len(port_out["choices"][0]["text"]) > 0


def test_chat_text_and_usage_match_jax(tiny_lm):
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hello there"}],
            "max_tokens": 10, "ignore_eos": True}
    jax_out, port_out = (post(p, "/v1/chat/completions", body) for p in tiny_lm)
    assert port_out["choices"][0]["message"] == jax_out["choices"][0]["message"]
    assert port_out["usage"] == jax_out["usage"]
    assert port_out["usage"]["completion_tokens"] == 10


def test_stream_deltas_match_jax(tiny_lm):
    body = {"messages": [{"role": "user", "content": "stream me a story"}],
            "max_tokens": 9, "ignore_eos": True}
    (jax_chunks, jax_done), (port_chunks, port_done) = (stream_chat(p, body)
                                                        for p in tiny_lm)
    assert jax_done and port_done
    assert deltas(port_chunks) == deltas(jax_chunks)
    assert len(port_chunks) == 9 + 1      # a chunk a token, then the finish chunk


def test_port_serves_sampling(tiny_lm):
    """temperature > 0 on both routes: top-k 1 at temperature 0.8 gives the
    JAX server's text, a sampled completion answers, a sampled stream ends
    in [DONE] with a delta a token; malformed bodies still get a 400."""
    body = {"messages": [{"role": "user", "content": "sample this"}],
            "max_tokens": 10, "ignore_eos": True, "temperature": 0.8, "top_k": 1}
    jax_out, port_out = (post(p, "/v1/chat/completions", body) for p in tiny_lm)
    assert port_out["choices"][0]["message"] == jax_out["choices"][0]["message"]
    assert port_out["usage"]["completion_tokens"] == 10
    port = tiny_lm[1]
    out = post(port, "/v1/completions", {"prompt": "x", "max_tokens": 7,
                                         "ignore_eos": True, "temperature": 0.7,
                                         "top_p": 0.9})
    assert out["choices"][0]["text"]
    chunks, done = stream_chat(port, {
        "messages": [{"role": "user", "content": "stream a sample"}], "max_tokens": 8,
        "ignore_eos": True, "temperature": 0.8})
    assert done and len(chunks) == 8 + 1
    status, _ = request(port, "POST", "/v1/completions", raw=b"{not json")
    assert status == 400
    status, _ = request(port, "POST", "/v1/chat/completions", {"messages": "nope"})
    assert status == 400
    # the node is still serving
    assert post(port, "/v1/completions", {"prompt": "ok", "max_tokens": 2,
                                          "ignore_eos": True})["choices"][0]["text"]


def test_port_burst_of_concurrent_streams(tiny_lm):
    port = tiny_lm[1]
    results = [None] * 8

    def one(i):
        results[i] = stream_chat(port, {
            "messages": [{"role": "user", "content": "burst " * (i + 1)}],
            "max_tokens": 6 + i, "ignore_eos": True})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (chunks, done) in enumerate(results):
        assert done
        assert len(chunks) == 6 + i + 1
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    status, data = request(port, "GET", "/metrics")
    (row,) = json.loads(data).values()
    assert row["running_requests"] + row["waiting_requests"] <= 8
    assert request(port, "GET", "/debug/streams")[0] == 200
    assert request(port, "GET", "/debug/tasks")[0] == 200


@pytest.fixture(scope="module")
def fake_servers():
    servers = serve_pair(["cluster.node.model.name=fake"])
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def png_b64(h, w, seed=3):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def image_chat(text, b64, max_tokens):
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": text},
        {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}}]}],
        "max_tokens": max_tokens, "ignore_eos": True}


def test_fake_model_tokens_match_jax(fake_servers):
    body = {"prompt": "once upon a time", "max_tokens": 7, "ignore_eos": True}
    jax_out, port_out = (post(p, "/v1/completions", body) for p in fake_servers)
    assert port_out["choices"][0]["text"] == jax_out["choices"][0]["text"]
    chat = image_chat("describe", png_b64(40, 48), 5)
    jax_out, port_out = (post(p, "/v1/chat/completions", chat) for p in fake_servers)
    assert port_out["choices"][0]["message"] == jax_out["choices"][0]["message"]
    assert port_out["usage"] == jax_out["usage"]
    (jax_chunks, _), (port_chunks, _) = (stream_chat(p, chat) for p in fake_servers)
    assert deltas(port_chunks) == deltas(jax_chunks)


def test_disaggregated_cluster_serving():
    """Requests served across an EP + D split through the HTTP surface (the
    fake model): four concurrent chats each answer, /metrics lists both
    nodes with the D node's pulls, and a lone completion (the schedules
    match) gives the JAX EP + D server's text."""
    split = ["cluster.node.model.name=fake", "cluster.nodes=[{node_type: EP}, {node_type: D}]"]
    jax_server, port_server = serve_pair(split)
    try:
        port = port_server.port
        payload = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                   "ignore_eos": True}
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda _: post(port, "/v1/chat/completions", payload),
                                 range(4)))
        assert all(len(o["choices"][0]["message"]["content"]) > 0 for o in outs)
        nodes = json.loads(request(port, "GET", "/metrics")[1])
        assert set(nodes) == {"EPNode:ep0", "DNode:d0"}
        assert nodes["DNode:d0"]["migration_pulls"] == 4
        assert nodes["EPNode:ep0"]["migrating_requests"] == 0
        body = {"prompt": "once upon a time", "max_tokens": 6, "ignore_eos": True}
        assert post(port, "/v1/completions", body)["choices"][0]["text"] == \
            post(jax_server.port, "/v1/completions", body)["choices"][0]["text"]
    finally:
        jax_server.stop()
        port_server.stop()


@pytest.fixture(scope="module")
def qwen2vl_servers(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    path = tmp_path_factory.mktemp("tiny_qwen2vl_online")
    cfg = transformers.Qwen2VLConfig(
        vision_config=dict(depth=2, embed_dim=64, hidden_size=48, num_heads=4,
                           patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
                           mlp_ratio=2),
        hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=VL_VOCAB, max_position_embeddings=512,
        image_token_id=VL_IMAGE_ID, vision_start_token_id=151, vision_end_token_id=152,
        rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]})
    torch.manual_seed(0)
    transformers.Qwen2VLForConditionalGeneration(cfg).eval().float().save_pretrained(
        path, safe_serialization=True)
    # the checkpoint carries no tokenizer: both sides take a codepoint one
    # whose image token is the model's
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_qvl.Qwen2VLModelFactory, "getTokenizer", lambda self: JaxTok(
            image_token=VL_TOKEN, image_token_id=VL_IMAGE_ID, eos_token_id=2))
        mp.setattr(qwen2_vl.Qwen2VLModelFactory, "getTokenizer", lambda self: SimpleTokenizer(
            image_token=VL_TOKEN, image_token_id=VL_IMAGE_ID, eos_token_id=2))
        servers = serve_pair([f"cluster.node.model.path={path}",
                              "cluster.node.model.attention_impl=jnp"])
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def test_qwen2vl_image_chat_matches_jax(qwen2vl_servers):
    chat = image_chat("what is it", png_b64(56, 84), 6)
    jax_out, port_out = (post(p, "/v1/chat/completions", chat) for p in qwen2vl_servers)
    assert port_out["choices"][0]["message"] == jax_out["choices"][0]["message"]
    assert port_out["usage"] == jax_out["usage"]
    assert port_out["usage"]["prompt_tokens"] > 12     # the image's tokens counted


@pytest.fixture(scope="module")
def llava_mm_servers():
    """The JAX server on random:tiny-lm+mm; the port's with the same random
    weights carried over (LM from key 0, tower and projector from key 1)."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    lm = init_decoder_weights(JaxRandomFactory("tiny-lm").cfg, jax.random.PRNGKey(0),
                              jnp.float32)
    tower = init_clip_weights(JAX_CLIP_TINY, jax.random.PRNGKey(1), jnp.float32,
                              lm_hidden=128)
    pf = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu",
                             weights=from_jax_numpy(to_np(lm), "cpu"), multimodal=True,
                             clip_cfg=CLIP_TINY,
                             vision_weights=from_jax_vision_numpy(to_np(tower), "cpu"))
    servers = serve_pair(["cluster.node.model.name=random:tiny-lm+mm"], port_factory=pf)
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def test_llava_random_mm_image_chat_matches_jax(llava_mm_servers):
    chat = image_chat("what is it", png_b64(64, 48), 6)
    jax_out, port_out = (post(p, "/v1/chat/completions", chat) for p in llava_mm_servers)
    assert port_out["choices"][0]["message"] == jax_out["choices"][0]["message"]
    assert port_out["usage"] == jax_out["usage"]
    (jax_chunks, _), (port_chunks, _) = (stream_chat(p, chat) for p in llava_mm_servers)
    assert deltas(port_chunks) == deltas(jax_chunks)


def test_port_serves_llava_images_from_its_name():
    """The port's server built from the name alone (its own random weights,
    as on the card), mirroring tests/entrypoint/test_api_server.py's image
    chat: the answer has text and the prompt counts the image's tokens."""
    port = free_port()
    cfg = load_config(EntryPointConfig, SERVE_YAML,
                      [*TINY, "cluster.node.model.name=random:tiny-lm+mm",
                       f"api_server.port={port}"])
    server = ServedEntryPoint(EntryPoint(cfg), port)
    try:
        text_only = post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "describe"}], "max_tokens": 4,
            "ignore_eos": True})
        out = post(port, "/v1/chat/completions", image_chat("describe", png_b64(64, 64), 4))
    finally:
        assert server.stop() == []
    assert len(out["choices"][0]["message"]["content"]) > 0
    assert out["usage"]["completion_tokens"] == 4
    # the image's feature tokens, and the space that joins its part to the text
    assert (out["usage"]["prompt_tokens"] - text_only["usage"]["prompt_tokens"]
            == CLIP_TINY.n_patches + 1)


def test_stop_leaves_no_task_running():
    port = free_port()
    cfg = load_config(EntryPointConfig, SERVE_YAML,
                      [*TINY, "cluster.node.model.name=fake", f"api_server.port={port}"])
    served = ServedEntryPoint(EntryPoint(cfg), port)
    chunks, done = stream_chat(port, {"messages": [{"role": "user", "content": "x"}],
                                      "max_tokens": 3, "ignore_eos": True})
    assert done and len(chunks) == 4
    assert served.stop() == []


def test_token_read_waits_off_the_loop():
    """A window whose tokens have not landed is waited for on a worker
    thread: the loop polls it once, then serves its other tasks until the
    wait returns, and get() runs once, on the loop's thread."""
    from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode

    landed = threading.Event()
    seen = {"polls": 0, "wait": None, "get": []}

    class Window:
        def is_ready(self):
            seen["polls"] += 1
            return landed.is_set()

        def wait(self):
            seen["wait"] = threading.get_ident()
            landed.wait(10)

        def get(self):
            seen["get"].append(threading.get_ident())

    async def main():
        read = asyncio.ensure_future(AsyncEPDNode._read(Window()))
        ticks = 0
        while not read.done():
            await asyncio.sleep(0.005)
            ticks += 1
            if ticks == 5:
                landed.set()
        await read
        return ticks

    loop_thread = threading.get_ident()
    assert asyncio.run(main()) >= 5
    assert seen["polls"] == 1
    assert seen["wait"] not in (None, loop_thread)
    assert seen["get"] == [loop_thread]


def test_zmq_token_path_is_refused():
    """zmq_pull_addr, once refused, is the API server's ZMQ token path: the
    (request_id, text | None) tuples a ZmqOutputTokenProcessor in another
    process PUSHes there end up in the request's stream, in order, and None
    ends it; tuples for unknown requests are dropped."""
    from hydrainfer_tpu_torch.engine.output_token_processor import ZmqOutputTokenProcessor
    from hydrainfer_tpu_torch.utils.socket_utils import find_free_port
    from hydrainfer_tpu_torch.utils.zmq_utils import ZmqConfig, init_zmq_send
    zmq_port = find_free_port()
    server = APIServer(APIServerConfig(port=find_free_port(),
                                       zmq_pull_addr=f"tcp://127.0.0.1:{zmq_port}"),
                       SimpleTokenizer())
    tokens = [ord(c) + SimpleTokenizer.OFFSET for c in "zmq ok"]

    async def main():
        runner = await server.start()
        send = init_zmq_send(ZmqConfig(host="127.0.0.1", port=zmq_port))
        try:
            stream = server.make_stream("r0")
            send.send_pyobj(("nobody", "dropped"))
            proc = ZmqOutputTokenProcessor("r0", send, SimpleTokenizer())
            for i, t in enumerate(tokens):
                proc.append_token_id(t, is_last_token=i == len(tokens) - 1)
            return [text async for text in stream]
        finally:
            send.close(linger=0)
            await runner.cleanup()

    assert asyncio.run(asyncio.wait_for(main(), 30)) == list("zmq ok")


# ------------------------------------------------------------ budget search

class _Sentinel:
    pass


def linear_timer(per_token_s):
    return lambda n, *_: per_token_s * n


@pytest.mark.parametrize("slo,per_item", [(0.4, 2e-4), (0.1, 1e-3), (0.05, 0.2),
                                          (0.4, 1e-6), (0.02, 1.0)])
def test_budget_search_matches_jax_with_one_timer(slo, per_item, monkeypatch):
    timer = linear_timer(per_item)
    jax_p = JaxProfiler(JaxProfilerConfig(enabled=True, tpot_slo=slo), _Sentinel(),
                        _Sentinel(), _Sentinel())
    port_p = BatchSchedulerProfiler(BatchSchedulerProfilerConfig(enabled=True, tpot_slo=slo),
                                    _Sentinel(), _Sentinel(), _Sentinel(),
                                    image_embed_executor=_Sentinel(),
                                    image_processor=_Sentinel())
    for p in (jax_p, port_p):
        monkeypatch.setattr(p, "_time_fill", timer)
        monkeypatch.setattr(p, "_time_encode", timer)
    assert port_p.profile_token_budgets() == jax_p.profile_token_budgets()
    assert port_p.profile_image_budgets() == jax_p.profile_image_budgets()
    assert port_p.fallbacks == 0


def test_failed_search_takes_the_default_and_is_counted(monkeypatch):
    def broken(*_):
        raise RuntimeError("probe failed")

    cfg = BatchSchedulerProfilerConfig(enabled=True, default_token_budget=333,
                                       default_image_budget=5)
    p = BatchSchedulerProfiler(cfg, _Sentinel(), _Sentinel(), _Sentinel(),
                               image_embed_executor=_Sentinel(), image_processor=_Sentinel())
    monkeypatch.setattr(p, "_time_fill", broken)
    monkeypatch.setattr(p, "_time_encode", broken)
    assert (p.profile_token_budgets(), p.profile_image_budgets()) == (333, 5)
    assert p.fallbacks == 2
    jax_p = JaxProfiler(JaxProfilerConfig(enabled=True, default_token_budget=333),
                        _Sentinel(), _Sentinel())
    monkeypatch.setattr(jax_p, "_time_fill", broken)
    assert jax_p.profile_token_budgets() == 333


@pytest.mark.parametrize("model", ["random:tiny-lm", "fake"])
def test_real_search_gives_back_blocks_and_slots(model):
    """A budget search on the CPU executor leaves the KV pool's (and the
    image cache's) available blocks and the token table's free slots as they
    were: every probe releases its slot as well as its blocks."""
    cfg = load_config(EntryPointConfig, SERVE_YAML, [
        *TINY, f"cluster.node.model.name={model}", "cluster.node.profiler.enabled=true",
        "cluster.node.profiler.max_token_budget=64", "cluster.node.profiler.max_image_budget=3",
        "cluster.node.profiler.tpot_slo=1000"])
    entry = EntryPoint(cfg)
    node = entry.cluster.nodes[0]
    assert node.profiler_fallbacks == 0
    assert node.batch_scheduler.token_budget == 64       # every probe under the SLO
    kv, img, fx = node.kv_cache_manager, node.image_cache_manager, node.fill_executor
    before = (kv.n_available_blocks(), img.n_available_blocks() if img else None,
              sorted(fx._free_slots))
    assert len(before[2]) == node.config.token_table_size
    prof = BatchSchedulerProfiler(cfg.cluster.node.profiler, fx, kv, img,
                                  n_image_tokens=16 if model == "fake" else 576,
                                  image_embed_executor=node.image_embed_executor,
                                  image_processor=node.model_factory.getProcessor())
    assert prof.profile_token_budgets() == 64
    if model == "fake":
        assert node.batch_scheduler.image_budget == 3
        assert prof.profile_image_budgets() == 3
    after = (kv.n_available_blocks(), img.n_available_blocks() if img else None,
             sorted(fx._free_slots))
    assert after == before
    assert prof.fallbacks == 0


# ------------------------------------------------------- streaming decoder

class SurrogateTokenizer:
    """decode_ids maps ids straight to characters, including surrogates
    (tests/models/test_streaming_detokenizer.py)."""

    TABLE = {0: "a", 1: "\udec5", 2: "b", 3: "\ud8a7", 4: "c", 5: "�"}

    def decode_ids(self, ids):
        return "".join(self.TABLE[i % len(self.TABLE)] for i in ids)


class ByteTokenizer:
    """One token per UTF-8 byte: a multi-byte character spans tokens."""

    def decode_ids(self, ids):
        return bytes(int(i) for i in ids).decode("utf-8", errors="replace")


TEXT = "naïve café — 東京 🙂 ok"


@pytest.mark.parametrize("tok,ids", [
    (SurrogateTokenizer(), [0, 1, 2, 3, 4, 0, 1, 1, 2]),
    (SurrogateTokenizer(), [0, 3, 2]),
    (SurrogateTokenizer(), [5, 5, 0, 3, 3, 1, 4]),
    (ByteTokenizer(), list(TEXT.encode("utf-8"))),
    (ByteTokenizer(), list("🙂🙂x".encode("utf-8")) + [-1, 97]),
], ids=["surrogates", "held_high_surrogate", "replacement_chars", "multibyte_text",
        "emoji_and_negative_id"])
def test_incremental_decoder_matches_jax(tok, ids):
    port, ref = IncrementalDecoder(tok), JaxDecoder(tok)
    got = [port.push(t) for t in ids]
    assert got == [ref.push(t) for t in ids]
    for text in got:
        text.encode("utf-8")
    if isinstance(tok, ByteTokenizer) and ids == list(TEXT.encode("utf-8")):
        assert "".join(got) == TEXT

