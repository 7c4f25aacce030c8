"""The process deployment's wire pieces, on the CPU, without spawning nodes.

  - RPC (cluster/rpc.py): replies come back out of order and are matched by
    message id, errors travel back as RpcError, with the port's client
    against the port's server and against the JAX package's (one protocol);
    an instruction list of 20,000 decode Fills crosses `dumps` flat
    (engine/isa.py: InstructionList pickles its links as positions).
  - `rcb_to_payload`: a migrating request round-trips with torch tensors
    inside; an executed ImageEmbed's pixels are dropped, an un-executed
    one's cross as numpy (bf16 as f32, value for value); what belongs to the
    process (processors, token slot, source node) stays behind, and the
    source's RCB is left as it was.
  - The data plane's choice (`PeerNodeProxy.pull_blocks`) with a fake RPC:
    RPC when HYDRAINFER_DISABLE_SHM_PULL is set or the hosts differ, shared
    memory on one host, CUDA IPC when both caches are on cards (the shared
    buffer released after the copy was waited for), shared memory when the
    source's cache is on the CPU; an IPC export or open that fails demotes
    the peer to RPC. `test_shm_attach_failure_falls_back_to_rpc` mirrors
    tests/cluster/test_failure_recovery.py's. The shared-memory payload is
    bit for bit (f32, bf16, int8).
  - Tokens: `ZmqOutputTokenProcessor` sends the JAX one's tuples for the
    same tokens, over a real PUSH/PULL pair (utils/zmq_utils.py); the
    node's token socket takes sends from many threads at once.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import itertools
import pickle
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hydrainfer_tpu.cluster.rpc import RpcServer as JaxRpcServer
from hydrainfer_tpu.engine.output_token_processor import \
    ZmqOutputTokenProcessor as JaxZmqProc
from hydrainfer_tpu.models.tokenizer import SimpleTokenizer as JaxTok
from hydrainfer_tpu_torch.cluster import process_node
from hydrainfer_tpu_torch.cluster.process_node import (PeerInfo, PeerNodeProxy,
                                                       TokenPushProcessor, _TokenSocket,
                                                       blocks_from_shm, blocks_to_shm,
                                                       node_device, rcb_to_payload)
from hydrainfer_tpu_torch.cluster.rpc import (RpcClient, RpcError, RpcServer, dumps,
                                              loads)
from hydrainfer_tpu_torch.engine.isa import (ImageEmbed, InstructionListBuilder, PullCache,
                                             TextFill)
from hydrainfer_tpu_torch.engine.output_token_processor import (LogOutputTokenProcessor,
                                                                ZmqOutputTokenProcessor)
from hydrainfer_tpu_torch.engine.request_processor import (RequestProcessor,
                                                           RequestProcessorConfig,
                                                           RequestProcessParameters)
from hydrainfer_tpu_torch.memory import TokenCacheBlockManager, TokenCacheBlockManagerConfig
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from hydrainfer_tpu_torch.utils.zmq_utils import ZmqConfig, init_zmq_recv, init_zmq_send


# ------------------------------------------------------------------- RPC

async def _handler(method, *args):
    if method == "slow":
        await asyncio.sleep(0.3)
        return ("slow", args)
    if method == "fast":
        return ("fast", args)
    if method == "boom":
        raise ValueError(f"no good: {args[0]}")
    raise KeyError(method)


@pytest.mark.parametrize("server_cls", [RpcServer, JaxRpcServer], ids=["port", "jax"])
def test_rpc_out_of_order_replies_and_errors(server_cls):
    async def run():
        server = server_cls(_handler)
        server.start()
        client = RpcClient(server.addr)
        try:
            order = []

            async def call(method, *args):
                out = await client.call(method, *args, timeout=10)
                order.append(method)
                return out

            slow, fast = await asyncio.gather(call("slow", 1), call("fast", 2, [3]))
            assert slow == ("slow", (1,)) and fast == ("fast", (2, [3]))
            assert order == ["fast", "slow"]          # the later call came back first
            with pytest.raises(RpcError, match="ValueError.*no good: x"):
                await client.call("boom", "x", timeout=10)
            with pytest.raises(RpcError, match="KeyError"):
                await client.call("nope", timeout=10)
            # the connection still serves after errors
            assert await client.call("fast", timeout=10) == ("fast", ())
        finally:
            client.close()
            server.close()

    asyncio.run(run())


def test_rpc_times_out_when_nobody_answers():
    async def run():
        from hydrainfer_tpu_torch.utils.socket_utils import find_free_port
        client = RpcClient(f"tcp://127.0.0.1:{find_free_port()}")
        try:
            with pytest.raises(asyncio.TimeoutError):
                await client.call("ping", timeout=0.2)
            assert client._pending == {}
        finally:
            client.close()

    asyncio.run(run())


@pytest.mark.parametrize("n_decode", [3, 20_000])
def test_instruction_lists_cross_the_wire(n_decode):
    """A request's list as the request processor builds it (a prefill, then
    a decode Fill per token, each naming the next as its sampled token's
    destination) pickles through `dumps` at any length, links and cursor
    intact."""
    b = InstructionListBuilder()
    prefill = TextFill([5, 6, 7], [0, 1, 2], [0, 1, 2], True, None, [11])
    b.append(prefill)
    prev = prefill
    for i in range(n_decode):
        fill = TextFill(None, [3 + i], [3 + i], True, None, None)
        prev.sample_dst = fill
        b.append(fill)
        prev = fill
    insts = b.build()
    insts.curr = prefill.next
    back = loads(dumps(insts))
    nodes, orig = list(back), list(insts)
    assert [type(n) for n in nodes] == [type(n) for n in orig]
    assert back.head is nodes[0] and back.tail is nodes[-1] and back.curr is nodes[2]
    assert all(a.next is b and b.prev is a for a, b in zip(nodes, nodes[1:]))
    assert nodes[0].prev is None and nodes[-1].next is None
    fills = nodes[1:-1]
    assert all(a.sample_dst is b for a, b in zip(fills, fills[1:]))
    assert fills[-1].sample_dst is None
    assert [f.position_ids for f in fills] == [f.position_ids for f in orig[1:-1]]
    assert fills[0].token_ids == [5, 6, 7] and fills[0].hashes == [11]


# ---------------------------------------------------------- rcb_to_payload

@pytest.fixture(scope="module")
def mm_factory():
    return RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu",
                               multimodal=True)


def image_rcb(factory):
    from PIL import Image
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
    proc = RequestProcessor(RequestProcessorConfig(num_request_process_workers=1,
                                                   block_size=4), factory)
    return proc.build_rcb(
        Request(request_id="m0", prompt="<image> describe", image=img,
                sampling_params=SamplingParameters(max_tokens=4, ignore_eos=True)),
        RequestProcessParameters(output_token_processors=[LogOutputTokenProcessor()]))


def instructions(rcb):
    return list(rcb.instructions)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("executed", [False, True], ids=["pending", "executed"])
def test_rcb_to_payload_round_trip(mm_factory, executed, dtype):
    rcb = image_rcb(mm_factory)
    embed = next(i for i in instructions(rcb) if isinstance(i, ImageEmbed))
    pixels = torch.as_tensor(embed.pixel_values).to(dtype)
    embed.pixel_values = pixels
    if executed:
        rcb.instructions.curr = embed.next        # the encode ran here
    pull = PullCache()
    pull.src_node = object()                  # a live node: not picklable state
    rcb.instructions.curr.prev.insert_next(pull)
    rcb.token_slot = 5
    procs = list(rcb.output_token_processors)

    back = loads(rcb_to_payload(rcb))
    assert back.request_id == "m0" and back.output_token_processors == []
    assert back.token_slot == -1
    got = next(i for i in instructions(back) if isinstance(i, ImageEmbed))
    if executed:
        assert got.pixel_values is None
    else:
        assert isinstance(got.pixel_values, np.ndarray)
        assert got.pixel_values.dtype == np.float32
        np.testing.assert_array_equal(got.pixel_values, pixels.float().numpy())
    assert next(i for i in instructions(back) if isinstance(i, PullCache)).src_node is None
    assert [type(i) for i in instructions(back)] == [type(i) for i in instructions(rcb)]
    # the source's RCB is as it was
    assert embed.pixel_values is pixels and pull.src_node is not None
    assert rcb.token_slot == 5 and rcb.output_token_processors == procs


# ------------------------------------------------------------- data planes

def cache(dtype, n_blocks=8):
    return TokenCacheBlockManager(TokenCacheBlockManagerConfig(
        n_layers=2, n_tensors=1, n_blocks=n_blocks, block_size=4, n_heads=2,
        head_dim=3, dtype=dtype), "cpu")


def filled_cache(dtype, seed=0):
    mgr = cache(dtype)
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        vals = torch.from_numpy(rng.integers(-127, 128, mgr.cache_array.shape).astype(np.int8))
    else:
        vals = torch.from_numpy(rng.standard_normal(mgr.cache_array.shape).astype(np.float32))
    mgr.cache_array.copy_(vals.to(mgr.cache_array.dtype))
    return mgr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_shm_payload_is_bit_for_bit(dtype):
    from multiprocessing import shared_memory
    blocks = filled_cache(dtype).gather_blocks([5, 1, 3])
    name, shape, dt = blocks_to_shm(blocks)
    shm = shared_memory.SharedMemory(name=name)
    try:
        got = blocks_from_shm(shm, shape, dt)
    finally:
        shm.close()
        shm.unlink()
    assert got.dtype == blocks.dtype and got.shape == blocks.shape
    assert torch.equal(got.view(torch.uint8), blocks.contiguous().view(torch.uint8))


class FakeSource:
    """The RPC surface of a NodeWorker over one source cache (what a
    PeerNodeProxy calls), recording the calls."""

    def __init__(self, src, host_id, device_type="cpu", ipc_open_fails=False,
                 ipc_export_fails=False):
        self.src, self.host, self.device_type = src, host_id, device_type
        self.ipc_open_fails, self.ipc_export_fails = ipc_open_fails, ipc_export_fails
        self.calls, self.held = [], {}
        self.opened = []
        self.tokens = itertools.count()

    def _open(self, token):
        if self.ipc_open_fails:
            raise RuntimeError("cudaIpcOpenMemHandle failed")
        t = self.held[token]
        self.opened.append(t)
        return t

    async def call(self, method, *args, **kw):
        self.calls.append(method)
        if method == "host_id":
            return self.host
        if method == "device_type":
            return self.device_type
        if method == "gather_blocks":
            return self.src.gather_blocks(args[1])
        if method == "gather_blocks_shm":
            return blocks_to_shm(self.src.gather_blocks(args[1]))
        if method == "gather_blocks_ipc":
            if self.ipc_export_fails:
                raise RpcError("RuntimeError at tcp://x: cannot share")
            token = next(self.tokens)
            self.held[token] = self.src.gather_blocks(args[1]).contiguous()
            return token, (self._open, (token,))
        if method == "release_ipc":
            assert self.held.pop(args[0]) is not None
            return None
        raise AssertionError(method)


class FakeEvent:
    log = []

    def record(self):
        FakeEvent.log.append("record")

    def synchronize(self):
        FakeEvent.log.append("synchronize")


SRC_TABLE = [6, 2, 4]


@pytest.mark.parametrize("case,plane,calls", [
    ("disabled", "rpc", ["gather_blocks"]),
    ("other_host", "rpc", ["host_id", "gather_blocks"]),
    ("same_host_cpu", "shm", ["host_id", "gather_blocks_shm"]),
    ("same_host_card_src_cpu", "shm", ["host_id", "device_type", "gather_blocks_shm"]),
    ("same_host_cards", "ipc", ["host_id", "device_type", "gather_blocks_ipc",
                                "release_ipc"]),
    ("ipc_open_fails", "rpc", ["host_id", "device_type", "gather_blocks_ipc",
                               "release_ipc", "gather_blocks"]),
    ("ipc_export_fails", "rpc", ["host_id", "device_type", "gather_blocks_ipc",
                                 "gather_blocks"]),
])
def test_pull_picks_the_data_plane(case, plane, calls, monkeypatch):
    if case == "disabled":
        monkeypatch.setenv("HYDRAINFER_DISABLE_SHM_PULL", "1")
    else:
        monkeypatch.delenv("HYDRAINFER_DISABLE_SHM_PULL", raising=False)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.log = []
    src = filled_cache("int8")
    me = process_node._host_id()
    fake = FakeSource(src, "elsewhere" if case == "other_host" else me,
                      device_type="cpu" if case == "same_host_card_src_cpu" else "cuda",
                      ipc_open_fails=case == "ipc_open_fails",
                      ipc_export_fails=case == "ipc_export_fails")
    on_card = case not in ("same_host_cpu",)
    proxy = PeerNodeProxy(PeerInfo("PNode:p0", "P", 0.4, "tcp://127.0.0.1:1"), {},
                          device="cuda" if on_card else "cpu")
    proxy._client = fake
    dst = cache("int8")
    src_vc = SimpleNamespace(block_table=SRC_TABLE, n_cache_tokens=10)
    dst_vc = SimpleNamespace(block_table=[1, 7, 0])

    nbytes = asyncio.run(proxy.pull_blocks(True, src_vc, dst, dst_vc))
    assert fake.calls == calls
    assert nbytes == 3 * src.config.block_nbytes
    assert torch.equal(dst.gather_blocks([1, 7, 0]), src.gather_blocks(SRC_TABLE))
    assert (proxy.ipc_pulls, proxy.shm_pulls) == {"ipc": (1, 0), "shm": (0, 1),
                                                  "rpc": (0, 0)}[plane]
    assert fake.held == {}                        # every IPC export released
    if plane == "ipc":
        # the copy was waited for (the event, in a worker thread) before
        # the release
        assert FakeEvent.log == ["record", "synchronize"]
    assert proxy._same_host is (plane != "rpc")
    assert proxy.last_pulls["kv"] == {"src": SRC_TABLE, "dst": [1, 7, 0], "tokens": 10}
    if case.startswith("ipc_"):
        # demoted for good: the next pull goes straight over RPC
        fake.calls.clear()
        asyncio.run(proxy.pull_blocks(True, src_vc, dst, dst_vc))
        assert fake.calls == ["gather_blocks"]


class YieldingSource(FakeSource):
    """A FakeSource whose every call suspends first, as a real RPC does, so
    that concurrent pulls interleave."""

    async def call(self, method, *args, **kw):
        await asyncio.sleep(0)
        return await super().call(method, *args, **kw)


@pytest.mark.parametrize("n_pulls", [2, 8])
def test_concurrent_first_pulls_share_one_plane(n_pulls, monkeypatch):
    """Pulls that start together on a fresh proxy (a burst of requests at
    boot) wait for one resolution of the planes: every one rides CUDA IPC,
    and the peer is asked for its host and device once."""
    monkeypatch.delenv("HYDRAINFER_DISABLE_SHM_PULL", raising=False)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    src = filled_cache("int8")
    fake = YieldingSource(src, process_node._host_id(), device_type="cuda")
    proxy = PeerNodeProxy(PeerInfo("PNode:p0", "P", 0.4, "tcp://127.0.0.1:1"), {},
                          device="cuda")
    proxy._client = fake
    dst = cache("int8")
    tables = [[i] for i in range(n_pulls)]

    async def pulls():
        return await asyncio.gather(*(
            proxy.pull_blocks(True, SimpleNamespace(block_table=[SRC_TABLE[i % 3]],
                                                    n_cache_tokens=4),
                              dst, SimpleNamespace(block_table=t))
            for i, t in enumerate(tables)))

    asyncio.run(pulls())
    assert (proxy.ipc_pulls, proxy.shm_pulls) == (n_pulls, 0)
    assert fake.calls.count("host_id") == fake.calls.count("device_type") == 1
    assert fake.calls.count("gather_blocks_ipc") == n_pulls
    assert fake.held == {}
    for i, t in enumerate(tables):
        assert torch.equal(dst.gather_blocks(t), src.gather_blocks([SRC_TABLE[i % 3]]))


def test_shm_attach_failure_falls_back_to_rpc():
    """boot_id matches but /dev/shm is not shared (two containers on one
    kernel): the shm attach fails, the proxy demotes itself to the RPC data
    plane and the pull still succeeds."""
    blocks = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)

    class FakeRpc:
        def __init__(self):
            self.calls = []

        async def call(self, method, *args, **kw):
            self.calls.append(method)
            if method == "gather_blocks_shm":
                return ("/hydrainfer_no_such_segment", tuple(blocks.shape), "float32")
            if method == "gather_blocks":
                return blocks
            raise AssertionError(method)

    proxy = PeerNodeProxy(PeerInfo("PNode:x", "P", 0.4, "tcp://127.0.0.1:1"),
                          migrating_stash={})
    proxy._same_host = True
    rpc = FakeRpc()
    proxy._client = rpc

    got = asyncio.run(proxy.gather_blocks(True, [0, 1]))
    assert torch.equal(got, blocks)
    assert proxy._same_host is False          # demoted for good
    assert rpc.calls == ["gather_blocks_shm", "gather_blocks"]
    got2 = asyncio.run(proxy.gather_blocks(True, [0]))
    assert torch.equal(got2, blocks)
    assert rpc.calls[-1] == "gather_blocks"


def test_node_device_choice():
    assert node_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        node_device("tpu", 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            node_device(None, 0)


# ------------------------------------------------------------------ tokens

class Capture:
    def __init__(self):
        self.sent = []

    def send_pyobj(self, obj):
        self.sent.append(obj)


TOKENS = [ord(c) + SimpleTokenizer.OFFSET for c in "hi 你!"]


@pytest.mark.parametrize("end", ["last_token", "terminate"])
def test_zmq_processor_sends_the_jax_tuples(end):
    port, jax_ = Capture(), Capture()
    procs = (ZmqOutputTokenProcessor("r0", port, SimpleTokenizer()),
             JaxZmqProc("r0", jax_, JaxTok()))
    for proc in procs:
        for i, t in enumerate(TOKENS):
            proc.append_token_id(t, is_last_token=end == "last_token" and i == len(TOKENS) - 1)
        if end == "terminate":
            proc.terminate()
    assert port.sent == jax_.sent
    assert port.sent[-1] == ("r0", None)
    assert "".join(t for _, t in port.sent if t) == SimpleTokenizer().decode_ids(TOKENS)


def test_zmq_processor_over_push_pull():
    cfg = ZmqConfig(host="127.0.0.1")
    recv = init_zmq_recv(cfg)
    send = init_zmq_send(cfg)
    try:
        proc = ZmqOutputTokenProcessor("r1", send, SimpleTokenizer())
        for i, t in enumerate(TOKENS[:3]):
            proc.append_token_id(t, is_last_token=i == 2)
        got = [recv.recv_pyobj() for _ in range(4)]
    finally:
        send.close(linger=0)
        recv.close(linger=0)
    assert got == [("r1", "h"), ("r1", "i"), ("r1", " "), ("r1", None)]


def test_token_socket_takes_many_threads():
    """TokenPushProcessors of many requests send from many threads at once
    (a request processor's workers end streams beside the event loop):
    every tuple arrives whole, in each request's order."""
    cfg = ZmqConfig(host="127.0.0.1")
    recv = init_zmq_recv(cfg)
    sock = _TokenSocket()
    sock.connect(f"tcp://127.0.0.1:{cfg.port}")
    n_threads, n_tokens = 16, 300
    procs = [TokenPushProcessor(f"r{i}", sock) for i in range(n_threads)]

    def run(proc):
        for t in range(n_tokens):
            proc.append_token_id(t, is_last_token=t == n_tokens - 1)

    threads = [threading.Thread(target=run, args=(p,)) for p in procs]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = {}
        for _ in range(n_threads * n_tokens):
            rid, tok, last = recv.recv_pyobj()
            got.setdefault(rid, []).append((tok, last))
    finally:
        recv.close(linger=0)
    assert sorted(got) == sorted(p.request_id for p in procs)
    for seq in got.values():
        assert seq == [(t, t == n_tokens - 1) for t in range(n_tokens)]


def test_token_push_terminate_is_the_none_token():
    cap = Capture()
    TokenPushProcessor("r9", cap).terminate()
    assert cap.sent == [("r9", None, True)]
    assert pickle.loads(pickle.dumps(cap.sent[0])) == ("r9", None, True)
