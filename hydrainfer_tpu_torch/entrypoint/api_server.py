"""OpenAI-compatible HTTP API server on aiohttp (port of
hydrainfer_tpu/entrypoint/api_server.py).

Routes: /health, /metrics, /v1/chat/completions (SSE stream and non-stream;
base64 `image_url` content parts fold into the model's image token),
/v1/completions, and the stall forensics /debug/streams and /debug/tasks.
Parsed requests go to the registered observers (the cluster). The engine
pushes each token into the request's AsyncStream through a callback
processor, with `loop.call_soon_threadsafe`: the engine and the server share
one event loop, and a processing worker thread may end a stream too. With
`zmq_pull_addr` set, the server also binds a ZMQ PULL socket there and feeds
the (request_id, text | None) tuples another process sends
(engine/output_token_processor.py:ZmqOutputTokenProcessor) into the
request's stream. /metrics takes each observer's `metrics()` or, for the
process deployment, its awaited `metrics_async()`.
"""
import asyncio
import contextlib
import inspect
import json
import time
import uuid
from dataclasses import dataclass
from typing import Dict, Optional

from aiohttp import web

from ..engine.output_token_processor import (CallbackOutputTokenProcessor,
                                             OutputTokenParams)
from ..engine.request_processor import RequestProcessParameters
from ..request import Request, SamplingParameters
from ..utils.async_stream import AsyncStream
from ..utils.logger import getLogger
from .api_protocol import (ChatCompletionChoice, ChatCompletionChunk,
                           ChatCompletionChunkChoice, ChatCompletionRequest,
                           ChatCompletionResponse, ChatMessage, CompletionRequest,
                           DeltaMessage, UsageInfo)

logger = getLogger(__name__)


class RequestObserver:
    """Implemented by the cluster: receives parsed requests."""

    async def add_request(self, request: Request,
                          params: RequestProcessParameters) -> None:
        raise NotImplementedError


@dataclass
class APIServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    model_name: str = "hydrainfer-tpu"
    # where other processes PUSH (request_id, text | None) tuples for the
    # streams of this server (None = no ZMQ token path)
    zmq_pull_addr: Optional[str] = None


@web.middleware
async def _error_middleware(request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except (json.JSONDecodeError, ValueError, TypeError) as e:
        return web.json_response(
            {"error": {"message": str(e), "type": "invalid_request_error"}},
            status=400)
    except Exception as e:
        logger.exception("request failed")
        return web.json_response(
            {"error": {"message": str(e), "type": "internal_error"}}, status=500)


class APIServer:
    def __init__(self, config: APIServerConfig, tokenizer,
                 image_token: str = "<image>", image_token_calculator=None):
        self.config = config
        self.tokenizer = tokenizer
        self.image_token = image_token
        # for usage accounting: expands the image token to its feature-token
        # count (None = count the raw templated prompt only)
        self.image_token_calculator = image_token_calculator
        self.observers = []
        self.streams: Dict[str, AsyncStream] = {}
        self._zmq_task: Optional[asyncio.Task] = None
        self.app = web.Application(middlewares=[_error_middleware])
        self.app.add_routes([
            web.get("/health", self.health),
            web.get("/metrics", self.metrics),
            web.post("/v1/chat/completions", self.create_chat_completion),
            web.post("/v1/completions", self.create_completion),
            web.get("/debug/streams", self.debug_streams),
            web.get("/debug/tasks", self.debug_tasks),
        ])

    def register_observer(self, observer: RequestObserver) -> None:
        self.observers.append(observer)

    # ---------------- token return path ----------------

    def make_stream(self, request_id: str) -> AsyncStream:
        stream = AsyncStream()
        self.streams[request_id] = stream
        return stream

    def token_callback(self, request_id: str, loop):
        """In-process delivery: engine (or a processing worker thread) ->
        the request's stream, on the loop's thread."""
        def cb(token_id: int, text: str, is_last: bool):
            stream = self.streams.get(request_id)
            if stream is None:
                return
            stream.pushed = getattr(stream, "pushed", 0) + 1
            stream.last_push = time.time()
            stream.saw_last = is_last
            stream.put_threadsafe(loop, text)
            if is_last:
                stream.put_threadsafe(loop, None)
        return cb

    async def debug_streams(self, _request) -> web.Response:
        """Every stream still open: tokens pushed, whether its final token
        arrived, the age of the last push, and what is queued unread."""
        now = time.time()
        rows = {
            rid: {"pushed": getattr(s, "pushed", 0),
                  "saw_last": getattr(s, "saw_last", False),
                  "since_last_push_s": (round(now - s.last_push, 1)
                                        if hasattr(s, "last_push") else None),
                  "queued": s._queue.qsize()}
            for rid, s in self.streams.items()}
        return web.json_response(rows)

    async def debug_tasks(self, _request) -> web.Response:
        """Where every asyncio task of this process is suspended."""
        rows = []
        for t in asyncio.all_tasks():
            frames = t.get_stack(limit=8)
            rows.append({
                "name": t.get_name(),
                "stack": [f"{fr.f_code.co_filename.rsplit('/', 1)[-1]}:"
                          f"{fr.f_lineno} {fr.f_code.co_name}" for fr in frames]})
        return web.json_response(rows)

    async def _zmq_recv_loop(self) -> None:
        """Multi-process delivery: (request_id, text | None) tuples over ZMQ
        into the request's stream (None ends it)."""
        import zmq
        import zmq.asyncio
        sock = zmq.asyncio.Context.instance().socket(zmq.PULL)
        sock.bind(self.config.zmq_pull_addr)
        try:
            while True:
                request_id, text = await sock.recv_pyobj()
                stream = self.streams.get(request_id)
                if stream is not None:
                    stream.put(text)
        finally:
            sock.close(linger=0)

    # ---------------- routes ----------------

    async def health(self, _request) -> web.Response:
        return web.Response(text="ok")

    async def metrics(self, _request) -> web.Response:
        """Per-node serving metrics from every observer with a metrics() or
        a metrics_async() (the process deployment's, over RPC)."""
        out = {}
        for obs in self.observers:
            m = getattr(obs, "metrics", None) or getattr(obs, "metrics_async", None)
            if callable(m):
                try:
                    rows = m()
                    if inspect.isawaitable(rows):
                        rows = await rows
                    out.update(rows)
                except Exception:
                    logger.exception("metrics collection failed")
        return web.json_response(out)

    def _count_prompt_tokens(self, prompt: str, image_b64) -> int:
        """Engine-accurate prompt token count (runs off the event loop): the
        templated prompt, with each image token expanded to its feature-token
        count when a calculator is wired."""
        n = len(self.tokenizer.encode(prompt))
        if image_b64 and self.image_token_calculator is not None:
            try:
                import base64
                import io
                from PIL import Image
                img = Image.open(io.BytesIO(base64.b64decode(image_b64)))
                n += self.image_token_calculator.get_num_image_tokens(
                    (img.height, img.width)) - 1
            except Exception:
                logger.exception("image token count failed")
        return n

    def _parse_chat_content(self, messages):
        """Flatten content parts; image parts become the image token and
        their base64 payloads are collected."""
        parsed = []
        image_b64 = None
        for m in messages:
            content = m.content
            if isinstance(content, str):
                parsed.append({"role": m.role, "content": content})
                continue
            parts = []
            for part in content:
                if part.get("type") == "text":
                    parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = part["image_url"]["url"]
                    if url.startswith("data:"):
                        image_b64 = url.split(",", 1)[1]
                    parts.append(self.image_token)
            parsed.append({"role": m.role, "content": " ".join(parts)})
        return parsed, image_b64

    async def _submit(self, request_id: str, prompt: str, image_b64: Optional[str],
                      sampling: SamplingParameters) -> AsyncStream:
        stream = self.make_stream(request_id)
        proc = CallbackOutputTokenProcessor(
            self.token_callback(request_id, asyncio.get_running_loop()), self.tokenizer)
        req = Request(request_id=request_id, prompt=prompt, image_base64=image_b64,
                      sampling_params=sampling)
        params = RequestProcessParameters(
            output_token_processors=[proc],
            output_token_params=OutputTokenParams(stream_output=True))
        for obs in self.observers:
            await obs.add_request(req, params)
        return stream

    async def create_chat_completion(self, request: web.Request) -> web.StreamResponse:
        body = await request.json()
        chat = ChatCompletionRequest(**body)
        messages, image_b64 = self._parse_chat_content(chat.messages)
        prompt = self.tokenizer.apply_chat_template(messages)
        request_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        max_tokens = chat.max_completion_tokens or chat.max_tokens or 128
        sampling = SamplingParameters(
            max_tokens=max_tokens, ignore_eos=chat.ignore_eos,
            temperature=chat.temperature, top_k=chat.top_k, top_p=chat.top_p)
        stream = await self._submit(request_id, prompt, image_b64, sampling)

        if chat.stream:
            resp = web.StreamResponse(headers={"Content-Type": "text/event-stream",
                                               "Cache-Control": "no-cache"})
            await resp.prepare(request)
            # once the stream has started the error middleware cannot answer:
            # encode with errors="replace" so no delta can raise, and reap the
            # stream and close the response on any exit
            try:
                first = True
                async for text in stream:
                    text = text.encode("utf-8", "replace").decode("utf-8")
                    delta = DeltaMessage(content=text)
                    if first:
                        delta.role = "assistant"
                        first = False
                    chunk = ChatCompletionChunk(
                        id=request_id, model=self.config.model_name,
                        choices=[ChatCompletionChunkChoice(delta=delta)])
                    await resp.write(f"data: {chunk.model_dump_json()}\n\n"
                                     .encode("utf-8", errors="replace"))
                final = ChatCompletionChunk(
                    id=request_id, model=self.config.model_name,
                    choices=[ChatCompletionChunkChoice(delta=DeltaMessage(),
                                                       finish_reason="stop")])
                await resp.write(f"data: {final.model_dump_json()}\n\n"
                                 .encode("utf-8", errors="replace"))
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            except ConnectionResetError:
                pass                      # the client went away mid-stream
            except Exception:
                logger.exception(f"{request_id} stream aborted")
                with contextlib.suppress(Exception):
                    await resp.write_eof()
            finally:
                self.streams.pop(request_id, None)
            return resp

        parts = [text async for text in stream]
        self.streams.pop(request_id, None)
        n_prompt = await asyncio.get_running_loop().run_in_executor(
            None, self._count_prompt_tokens, prompt, image_b64)
        response = ChatCompletionResponse(
            id=request_id, model=self.config.model_name,
            choices=[ChatCompletionChoice(
                message=ChatMessage(role="assistant", content="".join(parts)))],
            usage=UsageInfo(prompt_tokens=n_prompt, completion_tokens=len(parts),
                            total_tokens=n_prompt + len(parts)))
        return web.json_response(json.loads(response.model_dump_json()))

    async def create_completion(self, request: web.Request) -> web.StreamResponse:
        body = await request.json()
        comp = CompletionRequest(**body)
        prompt = comp.prompt if isinstance(comp.prompt, str) else comp.prompt[0]
        request_id = f"cmpl-{uuid.uuid4().hex[:24]}"
        sampling = SamplingParameters(
            max_tokens=comp.max_tokens or 128, ignore_eos=comp.ignore_eos,
            temperature=comp.temperature, top_p=comp.top_p)
        stream = await self._submit(request_id, prompt, None, sampling)
        parts = [text async for text in stream]
        self.streams.pop(request_id, None)
        return web.json_response({
            "id": request_id, "object": "text_completion",
            "model": self.config.model_name,
            "choices": [{"index": 0, "text": "".join(parts), "finish_reason": "stop"}]})

    # ---------------- lifecycle ----------------

    async def start(self) -> web.AppRunner:
        if self.config.zmq_pull_addr and self._zmq_task is None:
            self._zmq_task = asyncio.create_task(self._zmq_recv_loop())
        runner = web.AppRunner(self.app)
        await runner.setup()
        site = web.TCPSite(runner, self.config.host, self.config.port)
        await site.start()
        logger.info(f"API server on http://{self.config.host}:{self.config.port}")
        return runner
