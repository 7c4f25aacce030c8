"""Per-request async output stream (port of hydrainfer_tpu/utils/async_stream.py,
a copy).

An asyncio queue bridging the engine's token producer (possibly another
thread via call_soon_threadsafe) and the HTTP response generator. `None`
is the end-of-stream sentinel, matching the reference's ZMQ protocol.
"""
import asyncio
from typing import Any, AsyncIterator, Optional


class AsyncStream:
    STOP = object()

    def __init__(self, pacing_interval_s: float = 0.0):
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pacing_interval_s = pacing_interval_s
        self._finished = False

    def put(self, item: Any) -> None:
        """Producer side. `None` terminates the stream."""
        self._queue.put_nowait(self.STOP if item is None else item)

    def put_threadsafe(self, loop: asyncio.AbstractEventLoop, item: Any) -> None:
        loop.call_soon_threadsafe(self.put, item)

    async def get(self) -> Optional[Any]:
        item = await self._queue.get()
        if item is self.STOP:
            self._finished = True
            return None
        return item

    def __aiter__(self) -> AsyncIterator[Any]:
        return self._gen()

    async def _gen(self):
        while True:
            item = await self.get()
            if item is None:
                return
            if self._pacing_interval_s > 0:
                await asyncio.sleep(self._pacing_interval_s)
            yield item
