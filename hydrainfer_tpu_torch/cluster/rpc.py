"""Async pickle-RPC over ZMQ: the process deployment's control and data
plane (port of hydrainfer_tpu/cluster/rpc.py, a copy: it imports no JAX).

Every node process binds ONE ROUTER socket serving concurrent method calls;
cache-block payloads that do not ride CUDA IPC or shared memory ride the
same socket as pickled numpy arrays (cluster/process_node.py). Addresses
are tcp://host:port, so the same code spans hosts.

Protocol: request  = [identity | pickle((msg_id, method, args))]
          response = [identity | pickle((msg_id, ok: bool, payload))]
where payload is the return value, or (type_name, str) on error. Only this
program's processes speak it: unpickling runs what the peer sent.
"""
import asyncio
import pickle
import sys
from typing import Any, Callable, Dict, Optional

import zmq
import zmq.asyncio

from ..utils.logger import getLogger

logger = getLogger(__name__)

# instruction lists are linked objects (one node per decode token): the
# default pickler recursion handles ~1k; long generations need headroom
_PICKLE_RECURSION = 100_000


def dumps(obj: Any) -> bytes:
    limit = sys.getrecursionlimit()
    if limit < _PICKLE_RECURSION:
        sys.setrecursionlimit(_PICKLE_RECURSION)
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        sys.setrecursionlimit(limit)


loads = pickle.loads


class RpcServer:
    """Serves `handler(method: str, *args) -> awaitable` on a ROUTER socket.

    Every incoming call runs as its own asyncio task: a slow cache-block
    gather does not hold up a peer's control message.
    """

    def __init__(self, handler: Callable, host: str = "127.0.0.1",
                 port: int = 0, ctx: Optional[zmq.asyncio.Context] = None):
        self.handler = handler
        self.ctx = ctx or zmq.asyncio.Context.instance()
        self.sock = self.ctx.socket(zmq.ROUTER)
        if port in (0, -1, None):
            port = self.sock.bind_to_random_port(f"tcp://{host}")
        else:
            self.sock.bind(f"tcp://{host}:{port}")
        self.addr = f"tcp://{host}:{port}"
        self._task: Optional[asyncio.Task] = None
        self._calls = set()

    async def _serve_one(self, ident: bytes, raw: bytes) -> None:
        msg_id = None
        try:
            msg_id, method, args = loads(raw)
            result = await self.handler(method, *args)
            reply = dumps((msg_id, True, result))
        except Exception as e:  # noqa: BLE001 - errors travel to the caller
            logger.exception("rpc handler failed")
            reply = dumps((msg_id, False, (type(e).__name__, str(e))))
        await self.sock.send_multipart([ident, reply])

    async def _loop(self) -> None:
        while True:
            ident, raw = await self.sock.recv_multipart()
            task = asyncio.ensure_future(self._serve_one(ident, raw))
            self._calls.add(task)
            task.add_done_callback(self._calls.discard)

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        self.sock.close(linger=0)


class RpcError(RuntimeError):
    pass


class RpcClient:
    """DEALER client with out-of-order reply matching (msg ids), so many
    coroutines can have calls in flight on one connection."""

    def __init__(self, addr: str, ctx: Optional[zmq.asyncio.Context] = None):
        self.addr = addr
        self.ctx = ctx or zmq.asyncio.Context.instance()
        self.sock = self.ctx.socket(zmq.DEALER)
        self.sock.connect(addr)
        self._next_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._recv_task: Optional[asyncio.Task] = None

    async def _recv_loop(self) -> None:
        while True:
            raw, = await self.sock.recv_multipart()
            msg_id, ok, payload = loads(raw)
            fut = self._pending.pop(msg_id, None)
            if fut is None or fut.done():
                continue
            if ok:
                fut.set_result(payload)
            else:
                fut.set_exception(RpcError(f"{payload[0]} at {self.addr}: {payload[1]}"))

    async def call(self, method: str, *args, timeout: Optional[float] = None) -> Any:
        if self._recv_task is None:
            self._recv_task = asyncio.ensure_future(self._recv_loop())
        msg_id = self._next_id
        self._next_id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        await self.sock.send_multipart([dumps((msg_id, method, args))])
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(msg_id, None)

    def close(self) -> None:
        """Close the connection; calls still waiting for a reply raise
        RpcError (a peer replaced after its death never answers them)."""
        if self._recv_task is not None:
            self._recv_task.cancel()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RpcError(f"connection to {self.addr} closed"))
        self._pending.clear()
        self.sock.close(linger=0)
