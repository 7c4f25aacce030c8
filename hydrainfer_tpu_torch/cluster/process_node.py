"""Multi-process EPD serving: one OS process per node (port of
hydrainfer_tpu/cluster/process_node.py).

Each node runs in its own process around the same `AsyncEPDNode` the
in-process cluster builds (cluster/node.py), served over the ZMQ pickle-RPC
plane (cluster/rpc.py). Every address is tcp://host:port, so the same code
spans hosts; within one host it is loopback. A node is spawned by a parent
`ProcessCluster`, or launched standalone (`main`, below) and attached to by
address.

Planes:
  control    parent -> node: add_request / start / stop / metrics; node ->
             node: the migration hand-off and free (steps 1 and 4 of the
             4-step protocol).
  cache data the destination pulls the blocks from the source (step 3,
             `PeerNodeProxy.pull_blocks`), over the plane the two share:
               - CUDA IPC where both caches live on cards of one host: the
                 source gathers into a fresh contiguous buffer and shares it
                 (torch's reduce_tensor: an IPC memory handle and an event
                 the destination's stream waits on); the destination
                 scatters it into its cache device to device, waits for that
                 copy off the event loop, drops the buffer, and only then
                 tells the source to drop its own (`release_ipc`);
               - POSIX shared memory on one host otherwise (one copy each
                 side; ownership of the segment passes with the reply);
               - the pickled RPC payload across hosts, or everywhere when
                 HYDRAINFER_DISABLE_SHM_PULL is set.
             A failed shared-memory attach or IPC open demotes that peer to
             RPC for good, with a warning.
  tokens     every node PUSHes (request_id, token_id, is_last) to the
             parent's collector, which fans them out to the request's
             output-token processors; token_id None ends the request as
             terminated. A node that takes a migrating request over first
             pushes a hand-off notice ("at", request_id, node name, hop), so
             that the parent knows which node holds each request: when a
             node dies, the requests it holds are terminated (the JAX
             collector knows only a request's entry node, so a request that
             had moved on to a dead decode node hung).
"""
import asyncio
import dataclasses
import itertools
import multiprocessing
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import zmq
import zmq.asyncio

from ..engine.isa import PullCache
from ..engine.output_token_processor import OutputTokenProcessor
from ..engine.request_processor import RequestProcessParameters
from ..entrypoint.api_server import RequestObserver
from ..request import Request
from ..utils.logger import getLogger
from ..utils.socket_utils import find_free_port
from .cluster import node_metrics, resolve_cluster_topology, spec_node_config
from .migrate import MigrateGraphBuilder, NodeType
from .node import NodeConfig
from .rpc import RpcClient, RpcError, RpcServer, dumps, loads

logger = getLogger(__name__)


# ---------------- wire helpers ----------------

def _host_array(x):
    """A payload that crosses the wire as host numpy (a tensor's bf16
    becomes f32, which holds it exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def rcb_to_payload(rcb) -> bytes:
    """Serialize an RCB for cross-process migration.

    What belongs to this process is stripped, and re-created on the
    destination: the output processors (sockets, callbacks), the token-table
    slot, the pixel values of executed ImageEmbeds and the source node of
    executed PullCaches (a live node or an RPC proxy). An un-executed
    ImageEmbed's pixels cross as host numpy and land on the destination's
    device when its tower runs.
    """
    mutations = []  # (obj, attr, original)

    def stash(obj, attr, new):
        mutations.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    node, executed = rcb.instructions.head, True
    while node is not None:
        if node is rcb.instructions.curr:
            executed = False
        pv = getattr(node, "pixel_values", None)
        if pv is not None and (executed or not isinstance(pv, np.ndarray)):
            stash(node, "pixel_values", None if executed else _host_array(pv))
        if getattr(node, "src_node", None) is not None:
            stash(node, "src_node", None)
        node = node.next

    procs, rcb.output_token_processors = rcb.output_token_processors, []
    slot, rcb.token_slot = rcb.token_slot, -1
    try:
        return dumps(rcb)
    finally:
        rcb.output_token_processors = procs
        rcb.token_slot = slot
        for obj, attr, orig in mutations:
            setattr(obj, attr, orig)


def _host_id() -> str:
    """Boot-stable machine identity: every process on one host sees the
    same value, so two nodes compare it to decide whether a same-host data
    plane (CUDA IPC, shared memory) is open between them."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket
        return socket.gethostname()


def _shm_untrack(shm) -> None:
    """Detach the CREATOR's resource_tracker from a segment whose ownership
    crosses processes (the source creates it, the destination unlinks it
    after copying): the per-process tracker cannot model that hand-off and
    would unlink it again at exit, with a warning. Only the creating side
    calls this (attaching never registers with the tracker)."""
    from multiprocessing import resource_tracker
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def blocks_to_shm(blocks: torch.Tensor) -> tuple:
    """Write a gathered payload into a new shared-memory segment; (segment
    name, shape, dtype name). The creator's handle closes here."""
    from multiprocessing import shared_memory
    raw = blocks.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
    shm = shared_memory.SharedMemory(create=True, size=max(1, raw.nbytes))
    np.ndarray(raw.shape, np.uint8, buffer=shm.buf)[...] = raw
    reply = (shm.name, tuple(blocks.shape), _dtype_name(blocks.dtype))
    _shm_untrack(shm)
    shm.close()
    return reply


def blocks_from_shm(shm, shape, dtype: str) -> torch.Tensor:
    """The payload a `blocks_to_shm` segment holds, copied out of it."""
    n = int(np.prod(shape)) * torch.empty((), dtype=getattr(torch, dtype)).element_size()
    raw = np.array(np.ndarray((n,), np.uint8, buffer=shm.buf))
    return torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(shape)


class _TokenSocket:
    """The node's PUSH socket to the parent's collector. A request
    processor's worker thread may end a stream beside the event loop, and a
    ZMQ socket is not thread-safe, so every use holds a lock."""

    def __init__(self):
        self._sock = zmq.Context.instance().socket(zmq.PUSH)
        self._lock = threading.Lock()
        self.addr = None

    def connect(self, addr: str) -> None:
        with self._lock:
            if self.addr == addr:
                return
            if self.addr:
                self._sock.disconnect(self.addr)
            self._sock.connect(addr)
            self.addr = addr

    def send_pyobj(self, obj) -> None:
        with self._lock:
            self._sock.send_pyobj(obj)


class TokenPushProcessor(OutputTokenProcessor):
    """Node-side processor streaming (request_id, token_id, is_last) to the
    parent's collector."""

    def __init__(self, request_id, send_sock):
        self.request_id = request_id
        self.send = send_sock

    def append_token_id(self, token_id, is_last_token=False):
        self.send.send_pyobj((self.request_id, int(token_id), bool(is_last_token)))

    def terminate(self):
        # token_id None = abort: the collector terminates the parent-side
        # processors instead of appending a made-up token
        self.send.send_pyobj((self.request_id, None, True))


@dataclass
class PeerInfo:
    name: str                   # control-plane name (AsyncEPDNode.name)
    node_type: str
    tpot_slo: float
    addr: str                   # tcp://host:port of the peer's RpcServer


class PeerNodeProxy:
    """Migrate-graph edge to a node in ANOTHER process: exactly the surface
    AsyncEPDNode's migration code touches on a peer. `device` is the device
    of the node that holds this proxy (where pulled blocks land)."""

    is_remote = True

    def __init__(self, info: PeerInfo, migrating_stash: Dict, device=None):
        self.info = info
        self.name = info.name
        self._stash = migrating_stash
        self.device = torch.device("cpu" if device is None else device)
        self._client: Optional[RpcClient] = None
        self._same_host: Optional[bool] = None   # resolved on the first pull
        self._ipc = False
        self._resolving = asyncio.Lock()          # concurrent first pulls wait
        self.shm_pulls = 0
        self.ipc_pulls = 0
        # seconds of the IPC pulls: waiting for the source's export (its
        # queue and gather), and for the copy on this card (the open, the
        # scatter and every window queued before it)
        self.ipc_export_s = 0.0
        self.ipc_copy_s = 0.0
        # the latest pull of each kind ("kv", "image"): source and
        # destination block tables and the tokens they hold
        self.last_pulls: Dict[str, dict] = {}

    def _rpc(self) -> RpcClient:
        if self._client is None:
            self._client = RpcClient(self.info.addr)
        return self._client

    # step 1: the source hands the RCB over (this process is the source)
    async def migrate(self, src_node, rcb) -> None:
        payload = rcb_to_payload(rcb)
        # keep the source's block tables alive until the peer pulled them
        self._stash[rcb.request_id] = rcb
        try:
            await self._rpc().call("migrate", src_node.name, payload)
        except Exception:
            self._stash.pop(rcb.request_id, None)
            raise

    async def _resolve_planes(self) -> None:
        """On the first pull: the same-host planes are open when the peer
        reports this host's boot id (and HYDRAINFER_DISABLE_SHM_PULL is not
        set); CUDA IPC when, besides, both caches live on cards."""
        if self._same_host is not None:
            return
        async with self._resolving:
            if self._same_host is not None:
                return             # another pull resolved them meanwhile
            if os.environ.get("HYDRAINFER_DISABLE_SHM_PULL"):
                self._same_host = False
                return
            try:
                same = (await self._rpc().call("host_id")) == _host_id()
                ipc = (same and self.device.type == "cuda"
                       and (await self._rpc().call("device_type")) == "cuda")
            except Exception:
                same = ipc = False
            # both at once: a pull that finds _same_host set reads _ipc too
            self._ipc, self._same_host = ipc, same

    def _demote(self, what: str) -> None:
        logger.warning(f"{what} from {self.name} failed; falling back to the RPC "
                       "data plane for this peer")
        self._same_host = self._ipc = False

    # step 3's data plane, called on the DESTINATION's proxy of the source
    async def pull_blocks(self, is_kv: bool, src_vc, dst_mgr, dst_vc) -> int:
        """Copy the source's blocks of `src_vc` into `dst_vc`'s blocks of
        `dst_mgr` (module docstring: CUDA IPC, shared memory or RPC); the
        payload's bytes."""
        await self._resolve_planes()
        self.last_pulls["kv" if is_kv else "image"] = {
            "src": list(src_vc.block_table), "dst": list(dst_vc.block_table),
            "tokens": src_vc.n_cache_tokens}
        if self._ipc:
            t0 = time.perf_counter()
            try:
                token, shared = await self._rpc().call(
                    "gather_blocks_ipc", is_kv, src_vc.block_table)
            except RpcError:
                self._demote("the CUDA IPC export")
            else:
                t1 = time.perf_counter()
                try:
                    nbytes = await self._land_ipc(shared, dst_mgr, dst_vc.block_table)
                finally:
                    await self._rpc().call("release_ipc", token)
                if nbytes is not None:
                    self.ipc_pulls += 1
                    self.ipc_export_s += t1 - t0
                    self.ipc_copy_s += time.perf_counter() - t1
                    return nbytes
        blocks = await self.gather_blocks(is_kv, src_vc.block_table)
        dst_mgr.scatter_blocks(dst_vc.block_table, blocks)
        return int(blocks.nbytes)

    async def _land_ipc(self, shared, dst_mgr, dst_table) -> Optional[int]:
        """Open the source's shared buffer, scatter it into `dst_table`,
        and wait (in a worker thread) until that copy has read it: only then
        may the buffer go. The payload's bytes, or None when the open fails
        (the peer is demoted to RPC)."""
        from ..models.step_graphs import wait_event
        rebuild, args = shared
        try:
            blocks = rebuild(*args)
        except RuntimeError:
            self._demote("the CUDA IPC open")
            return None
        copied = torch.cuda.Event()
        try:
            dst_mgr.scatter_blocks(dst_table, blocks)
            return blocks.numel() * blocks.element_size()
        finally:
            copied.record()
            await asyncio.to_thread(wait_event, copied)

    async def gather_blocks(self, is_kv: bool, block_table: List[int]) -> torch.Tensor:
        """The source's blocks as a host tensor, over shared memory on one
        host, else over RPC."""
        await self._resolve_planes()
        if self._same_host:
            from multiprocessing import shared_memory
            name, shape, dtype = await self._rpc().call(
                "gather_blocks_shm", is_kv, block_table)
            try:
                shm = shared_memory.SharedMemory(name=name)
            except (FileNotFoundError, OSError):
                # boot_id matches but /dev/shm is not shared (two containers
                # on one kernel): the source's segment leaks one payload,
                # and this pull and the later ones go over RPC
                self._demote(f"the shared-memory attach to {name}")
                return await self._rpc().call("gather_blocks", is_kv, block_table)
            try:
                blocks = blocks_from_shm(shm, shape, dtype)
            finally:
                shm.close()
                shm.unlink()     # the destination owns the segment
            self.shm_pulls += 1
            return blocks
        return await self._rpc().call("gather_blocks", is_kv, block_table)

    # step 4: the destination tells the source to free the migrated request
    async def free_migrate_request(self, rcb) -> None:
        await self._rpc().call("free_migrate", rcb.request_id)

    def close(self) -> None:
        if self._client is not None:
            self._client.close()


@dataclass
class NodeBoot:
    """Everything a child process needs to become a node.

    `token_addr` and `peers` may be empty at boot: a standalone node
    (launched with `python -m hydrainfer_tpu_torch.cluster.process_node` on
    any host) starts unwired and receives both over RPC (`connect_tokens`,
    `wire_peers`) when a parent cluster attaches to it."""
    name: str                    # short name, e.g. "p0"
    node_type: str
    config: NodeConfig
    rpc_host: str
    rpc_port: int
    token_addr: str = ""         # the parent's PULL for the token stream
    peers: List[PeerInfo] = field(default_factory=list)
    tpot_slo: float = 0.4
    platform: Optional[str] = None       # "cpu" asks for the CPU; None = the card
    device_index: int = 0


def node_device(platform: Optional[str], device_index: int) -> torch.device:
    """A node process's device: the CPU when `platform` is "cpu", else card
    `device_index` modulo the cards this process sees (none raises)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}: a node runs on the card "
                         "(None) or the CPU ('cpu')")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; set platform=cpu to run "
                           "the node on the CPU")
    index = device_index % n
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class NodeWorker:
    """Child-process server wrapping one AsyncEPDNode."""

    def __init__(self, boot: NodeBoot, device: torch.device):
        from .node import AsyncEPDNode, NodeContext
        self.boot = boot
        self.node = AsyncEPDNode(boot.config, NodeContext(
            name=boot.name, node_type=NodeType(boot.node_type), device=device))
        self.node.init(None)           # built from config.model
        self.migrating: Dict = {}      # request_id -> stashed source RCB
        self.token_sock = _TokenSocket()
        if boot.token_addr:
            self.connect_tokens(boot.token_addr)
        self.server: Optional[RpcServer] = None
        self._peer_proxies: Dict[str, PeerNodeProxy] = {}
        # CUDA IPC exports held until the destination releases them
        self._ipc_buffers: Dict[int, torch.Tensor] = {}
        self._ipc_tokens = itertools.count()

    def connect_tokens(self, token_addr: str) -> None:
        """(Re)connect the token plane to a parent's collector: at boot for
        spawned children, over RPC when a parent attaches."""
        self.token_sock.connect(token_addr)

    def wire_peers(self, peers: List[PeerInfo]) -> None:
        for p in self._peer_proxies.values():
            p.close()
        self._peer_proxies.clear()
        builder = MigrateGraphBuilder()
        builder.add_node(self.node.name, self.node.context.node_type,
                         self.node, tpot_slo=self.boot.tpot_slo)
        for p in peers:
            proxy = PeerNodeProxy(p, self.migrating, self.node.device)
            self._peer_proxies[p.name] = proxy
            builder.add_node(p.name, NodeType(p.node_type), proxy, tpot_slo=p.tpot_slo)
        self.node.update_migrate_graph(builder.build_graph())

    def _src_proxy(self, src_name: str) -> PeerNodeProxy:
        proxy = self._peer_proxies.get(src_name)
        if proxy is None:
            raise KeyError(f"unknown migration source {src_name}")
        return proxy

    def _cache(self, is_kv: bool):
        return self.node.kv_cache_manager if is_kv else self.node.image_cache_manager

    def metrics(self) -> dict:
        """The node's metrics row (cluster.node_metrics), its same-host
        pulls by plane (the IPC ones' seconds split into the export's wait
        and the copy's), the latest pull of each kind from each source, its
        caches' available blocks (free or evictable), and its process: pid
        and, on the card, allocated and peak memory and the allocator's
        settings."""
        node = self.node
        row = {"name": node.name, **node_metrics(node), "pid": os.getpid()}
        for key, attr in (("migration_shm_pulls", "shm_pulls"),
                          ("migration_ipc_pulls", "ipc_pulls"),
                          ("migration_ipc_export_s", "ipc_export_s"),
                          ("migration_ipc_copy_s", "ipc_copy_s")):
            n = sum(getattr(p, attr) for p in self._peer_proxies.values())
            if n:
                row[key] = round(n, 4) if isinstance(n, float) else n
        last = {p.name: p.last_pulls for p in self._peer_proxies.values() if p.last_pulls}
        if last:
            row["migration_last_pulls"] = last
        for kind, mgr in (("kv", node.kv_cache_manager), ("image", node.image_cache_manager)):
            if mgr is not None:
                row[f"{kind}_available_blocks"] = mgr.n_available_blocks()
        if node.device.type == "cuda":
            row.update(cuda_memory_allocated=torch.cuda.memory_allocated(node.device),
                       cuda_peak_memory_allocated=torch.cuda.max_memory_allocated(node.device),
                       cuda_alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))
        return row

    async def handle(self, method: str, *args):
        if method == "add_request":
            request, = args
            params = RequestProcessParameters(output_token_processors=[
                TokenPushProcessor(request.request_id, self.token_sock)])
            await self.node.add_request(request, params)
            return None
        if method == "migrate":
            src_name, payload = args
            rcb = loads(payload)
            # the hand-off notice first (it precedes this node's tokens on
            # the socket); hop = the PullCaches up to this one
            hop = 0
            for inst in rcb.instructions:
                hop += isinstance(inst, PullCache)
                if inst is rcb.instructions.curr:
                    break
            self.token_sock.send_pyobj(("at", rcb.request_id, self.node.name, hop))
            rcb.output_token_processors = [
                TokenPushProcessor(rcb.request_id, self.token_sock)]
            await self.node.migrate(self._src_proxy(src_name), rcb)
            return None
        if method == "gather_blocks":
            is_kv, block_table = args
            return self._cache(is_kv).gather_blocks(block_table).cpu()
        if method == "host_id":
            return _host_id()
        if method == "device_type":
            return self.node.device.type
        if method == "gather_blocks_shm":
            # same-host plane: the destination maps the segment, copies and
            # unlinks it (ownership passes with the reply)
            is_kv, block_table = args
            return blocks_to_shm(self._cache(is_kv).gather_blocks(block_table))
        if method == "gather_blocks_ipc":
            # same-host cards: a fresh contiguous buffer, held here until the
            # destination's copy has read it (release_ipc)
            from torch.multiprocessing.reductions import reduce_tensor
            is_kv, block_table = args
            blocks = self._cache(is_kv).gather_blocks(block_table).contiguous()
            token = next(self._ipc_tokens)
            self._ipc_buffers[token] = blocks
            return token, reduce_tensor(blocks)
        if method == "release_ipc":
            token, = args
            self._ipc_buffers.pop(token, None)
            torch.cuda.ipc_collect()
            return None
        if method == "free_migrate":
            request_id, = args
            old = self.migrating.pop(request_id, None)
            if old is not None:
                await self.node.free_migrate_request(old)
            return None
        if method == "start":
            await self.node.start()
            return None
        if method == "stop":
            await self.node.stop()
            asyncio.get_running_loop().call_later(0.2, self._shutdown)
            return None
        if method == "ping":
            return self.node.name
        if method == "wire_peers":
            peers, = args
            self.wire_peers(peers)
            return None
        if method == "connect_tokens":
            token_addr, = args
            self.connect_tokens(token_addr)
            return None
        if method == "metrics":
            return self.metrics()
        raise ValueError(f"unknown rpc method {method}")

    def _shutdown(self) -> None:
        for p in self._peer_proxies.values():
            p.close()
        if self.server is not None:
            self.server.close()
        asyncio.get_running_loop().stop()

    async def serve(self) -> None:
        self.server = RpcServer(self.handle, host=self.boot.rpc_host,
                                port=self.boot.rpc_port)
        self.server.start()
        self.wire_peers(self.boot.peers)
        logger.info(f"node worker {self.node.name} serving at {self.server.addr} "
                    f"on {self.node.device}")


def run_worker(worker: NodeWorker) -> None:
    """Serve `worker` on a new event loop until its `stop` call ends it."""
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    loop.run_until_complete(worker.serve())
    try:
        loop.run_forever()
    finally:
        tasks = asyncio.all_tasks(loop)
        for t in tasks:
            t.cancel()
        loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
        loop.close()


def node_worker_main(boot: NodeBoot) -> None:
    """Child-process entry point (spawn-safe: a module-level function)."""
    run_worker(NodeWorker(boot, node_device(boot.platform, boot.device_index)))


# ---------------- parent-side cluster ----------------

@dataclass
class ProcessClusterConfig:
    cluster_type: str = "auto"
    nodes: List = field(default_factory=list)           # List[NodeSpec]
    node: NodeConfig = field(default_factory=NodeConfig)
    host: str = "127.0.0.1"
    # the address other hosts reach THIS process at (the token plane);
    # defaults to `host`. Set it when `host` binds a wildcard or loopback
    # but attached nodes live on other machines
    advertise_host: Optional[str] = None
    platform: Optional[str] = None      # the children's: "cpu", or None = the card
    start_timeout_s: float = 120.0
    # mid-flight failure detection: ping cadence and misses before a node
    # is declared dead (its in-flight requests are then terminated instead
    # of hanging). 0 turns the monitor off
    health_interval_s: float = 2.0
    health_strikes: int = 2
    # how many times a dead SPAWNED node is restarted; an attached node is
    # re-attached when its address answers pings again
    max_respawns: int = 1


class NodeHandle:
    """The parent's view of one node process: spawned here (proc set) or
    attached over tcp (proc None, the node launched standalone)."""

    def __init__(self, name: str, node_type: NodeType, addr: str,
                 proc: Optional[multiprocessing.Process],
                 node_type_str: str = "", tpot_slo: float = 0.4,
                 boot: Optional[NodeBoot] = None):
        self.name = name            # full control name, e.g. "PNode:p0"
        self.node_type = node_type
        self.node_type_str = node_type_str or str(node_type)
        self.tpot_slo = tpot_slo
        self.addr = addr
        self.proc = proc
        self.client = RpcClient(addr)
        self.alive = True
        self.boot = boot            # spawned nodes only: the respawn recipe
        self.respawns = 0


class ProcessCluster(RequestObserver):
    """The control plane over node processes: the request-entry contract of
    the in-process `Cluster` (add_request, start, stop; per-node metrics
    over RPC with `metrics_async`), with the nodes behind a process
    boundary. Children start with `spawn`; on the card the parent builds
    the kernels first (ops/cuda/build.py), so that the children load them
    instead of running nvcc side by side."""

    def __init__(self, config: ProcessClusterConfig):
        self.config = config
        specs = config.nodes or resolve_cluster_topology(config.cluster_type, 1)
        spawned = [s for s in specs if not s.attach_addr]
        if spawned and config.platform != "cpu":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; set "
                                   "cluster.platform=cpu to run the nodes on the CPU")
            from ..ops.cuda.build import build_all
            build_all()

        # token collector (PULL): children connect and PUSH
        self._zctx = zmq.asyncio.Context.instance()
        self.token_sock = self._zctx.socket(zmq.PULL)
        token_port = self.token_sock.bind_to_random_port(f"tcp://{config.host}")
        self.token_addr = f"tcp://{config.advertise_host or config.host}:{token_port}"

        self._ctx = multiprocessing.get_context("spawn")
        self.handles: List[NodeHandle] = []
        name_counts: Dict[str, int] = {}
        n_spawned = 0
        for spec in specs:
            if spec.attach_addr:
                # attach mode: the node already serves at this address; its
                # full name comes back from its first ping (wait_ready), and
                # peers and tokens are wired over RPC in start()
                if spec.n_replicas != 1:
                    raise ValueError("an attach spec is one node")
                self.handles.append(NodeHandle(
                    name="", node_type=NodeType(spec.node_type),
                    addr=spec.attach_addr, proc=None,
                    node_type_str=spec.node_type, tpot_slo=spec.tpot_slo))
                continue
            for _ in range(spec.n_replicas):
                idx = name_counts.get(spec.node_type, 0)
                name_counts[spec.node_type] = idx + 1
                boot = NodeBoot(
                    name=f"{spec.node_type.lower()}{idx}", node_type=spec.node_type,
                    config=spec_node_config(config.node, spec),
                    rpc_host=config.host, rpc_port=find_free_port(),
                    token_addr=self.token_addr, tpot_slo=spec.tpot_slo,
                    platform=config.platform, device_index=n_spawned)
                n_spawned += 1
                full_name = f"{NodeType(boot.node_type)}Node:{boot.name}"
                self.handles.append(NodeHandle(
                    full_name, NodeType(boot.node_type),
                    f"tcp://{boot.rpc_host}:{boot.rpc_port}", self._spawn(boot, full_name),
                    node_type_str=boot.node_type, tpot_slo=boot.tpot_slo, boot=boot))

        self._procs_by_request: Dict = {}
        # request_id -> (the name of the node holding it, its hop count):
        # the entry node, then each hand-off notice's
        self._node_by_request: Dict = {}
        self._collector_task = None
        self._health_task = None
        self._recoveries = set()
        self._enodes = [h for h in self.handles if h.node_type.can_encode]
        self._pnodes = [h for h in self.handles if h.node_type.can_prefill]
        if not self._pnodes:
            raise ValueError("the cluster has no prefill-capable node")
        self._rr = {"e": 0, "p": 0}

    def _spawn(self, boot: NodeBoot, name: str):
        proc = self._ctx.Process(target=node_worker_main, args=(boot,), name=name,
                                 daemon=True)
        proc.start()
        return proc

    async def wait_ready(self) -> None:
        deadline = time.perf_counter() + self.config.start_timeout_s
        for h in self.handles:
            while True:
                try:
                    name = await h.client.call("ping", timeout=2.0)
                except (asyncio.TimeoutError, RpcError, zmq.ZMQError):
                    if h.proc is not None and not h.proc.is_alive():
                        raise RuntimeError(f"node process {h.name} died at startup")
                    if time.perf_counter() > deadline:
                        raise TimeoutError(f"node {h.name or h.addr} not ready")
                    await asyncio.sleep(0.2)
                    continue
                if not h.name:
                    h.name = name      # an attached node reports its name
                elif name != h.name:
                    raise RuntimeError(f"node at {h.addr} is {name}, expected {h.name}")
                break

    def _peer_infos(self, handles) -> List[PeerInfo]:
        return [PeerInfo(name=h.name, node_type=h.node_type_str, tpot_slo=h.tpot_slo,
                         addr=h.addr) for h in handles]

    async def start(self) -> None:
        await self.wait_ready()
        # wire the whole peer table and the token plane on every node
        # (spawned children got the token address at boot; re-wiring is
        # idempotent and folds attached nodes into the same migrate graph)
        infos = self._peer_infos(self.handles)
        for h in self.handles:
            await h.client.call("connect_tokens", self.token_addr)
            await h.client.call("wire_peers", [p for p in infos if p.name != h.name])
        for h in self.handles:
            await h.client.call("start")
        if self._collector_task is None:
            self._collector_task = asyncio.ensure_future(self._collect_tokens())
        if self._health_task is None and self.config.health_interval_s > 0:
            self._health_task = asyncio.ensure_future(self._health_loop())

    async def _health_loop(self) -> None:
        """Mid-flight failure detection: a node that stops answering pings
        (or whose process died) is declared dead after `health_strikes`
        misses; its in-flight requests are terminated, so callers see a
        closed stream instead of a hang."""
        strikes: Dict[str, int] = {}
        while True:
            await asyncio.sleep(self.config.health_interval_s)
            for h in list(self.handles):
                if not h.alive:
                    continue
                dead = h.proc is not None and not h.proc.is_alive()
                if not dead:
                    try:
                        await h.client.call("ping", timeout=self.config.health_interval_s)
                        strikes[h.name] = 0
                        continue
                    except Exception:
                        strikes[h.name] = strikes.get(h.name, 0) + 1
                        if strikes[h.name] < self.config.health_strikes:
                            continue
                self._mark_dead(h)

    def _mark_dead(self, h: NodeHandle) -> None:
        logger.error(f"node {h.name} ({h.addr}) is unreachable: terminating its "
                     "in-flight requests")
        h.alive = False
        if h in self._enodes:
            self._enodes.remove(h)
        if h in self._pnodes:
            self._pnodes.remove(h)
        victims = [rid for rid, (name, _) in self._node_by_request.items() if name == h.name]
        for rid in victims:
            self._node_by_request.pop(rid, None)
            for proc in self._procs_by_request.pop(rid, ()):
                proc.terminate()
        # restart a dead spawned node (up to max_respawns); keep probing an
        # attached node's address and fold it back in when it answers again
        if h.boot is not None and h.respawns < self.config.max_respawns:
            recovery = self._respawn(h)
        elif h.proc is None:
            recovery = self._reattach(h)
        else:
            return
        task = asyncio.ensure_future(recovery)
        self._recoveries.add(task)
        task.add_done_callback(self._recoveries.discard)

    async def _respawn(self, h: NodeHandle) -> None:
        h.respawns += 1
        logger.info(f"respawning node {h.name} "
                    f"(attempt {h.respawns}/{self.config.max_respawns})")
        try:
            if h.proc is not None:
                # a node marked dead on ping strikes may still be RUNNING
                # (hung, not exited), holding its card memory and the token
                # socket: terminate, join, kill, join before spawning anew
                if h.proc.is_alive():
                    h.proc.terminate()
                await asyncio.to_thread(h.proc.join, 5.0)
                if h.proc.is_alive():
                    h.proc.kill()
                    await asyncio.to_thread(h.proc.join, 5.0)
            boot = dataclasses.replace(h.boot, rpc_port=find_free_port())  # the old port may linger
            h.boot = boot
            h.proc = self._spawn(boot, h.name)
            h.client.close()
            h.addr = f"tcp://{boot.rpc_host}:{boot.rpc_port}"
            h.client = RpcClient(h.addr)
            await self._rejoin(h)
        except Exception:
            logger.exception(f"respawn of {h.name} failed; the node stays dead")

    async def _reattach(self, h: NodeHandle) -> None:
        deadline = time.perf_counter() + self.config.start_timeout_s
        while time.perf_counter() < deadline:
            await asyncio.sleep(max(1.0, self.config.health_interval_s))
            try:
                await h.client.call("ping", timeout=2.0)
            except Exception:
                continue
            try:
                await self._rejoin(h)
            except Exception:
                logger.exception(f"re-attach of {h.name} failed")
            return
        logger.error(f"node {h.name} ({h.addr}) never came back; giving up")

    async def _rejoin(self, h: NodeHandle) -> None:
        """Wait for a restarted or recovered node, rewire every peer table
        (its address may have changed), and put it back in the routing
        pools."""
        deadline = time.perf_counter() + self.config.start_timeout_s
        while True:
            try:
                await h.client.call("ping", timeout=2.0)
                break
            except Exception:
                if h.proc is not None and not h.proc.is_alive():
                    raise RuntimeError(f"restarted node {h.name} died again")
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"restarted node {h.name} not ready")
                await asyncio.sleep(0.2)
        infos = self._peer_infos([x for x in self.handles if x.alive or x is h])
        await h.client.call("connect_tokens", self.token_addr)
        await h.client.call("wire_peers", [p for p in infos if p.name != h.name])
        await h.client.call("start")
        for x in self.handles:
            if x.alive and x is not h:
                try:
                    await x.client.call("wire_peers", [p for p in infos if p.name != x.name])
                except Exception:
                    logger.exception(f"rewiring {x.name} after {h.name} rejoined failed")
        h.alive = True
        if h.node_type.can_encode and h not in self._enodes:
            self._enodes.append(h)
        if h.node_type.can_prefill and h not in self._pnodes:
            self._pnodes.append(h)
        logger.info(f"node {h.name} rejoined the cluster at {h.addr}")

    async def _collect_tokens(self) -> None:
        while True:
            msg = await self.token_sock.recv_pyobj()
            if len(msg) == 4:
                # a hand-off notice; the latest hop wins (notices of one
                # request come from different sockets)
                _, request_id, name, hop = msg
                held = self._node_by_request.get(request_id)
                if held is not None and hop > held[1]:
                    self._node_by_request[request_id] = (name, hop)
                continue
            request_id, token_id, is_last = msg
            for proc in self._procs_by_request.get(request_id, ()):
                if token_id is None:
                    proc.terminate()
                else:
                    proc.append_token_id(token_id, is_last)
            if is_last:
                self._procs_by_request.pop(request_id, None)
                self._node_by_request.pop(request_id, None)

    async def add_request(self, request: Request, params: RequestProcessParameters) -> None:
        self._procs_by_request[request.request_id] = list(params.output_token_processors)
        has_image = request.image is not None or request.image_base64 is not None
        pool, key = ((self._enodes, "e") if has_image and self._enodes
                     else (self._pnodes, "p"))
        if not pool:
            raise RuntimeError("no live node can accept this request")
        h = pool[self._rr[key] % len(pool)]
        self._rr[key] += 1
        # the entry node, until a hand-off notice names the next one
        self._node_by_request[request.request_id] = (h.name, 0)
        await h.client.call("add_request", request)

    async def metrics_async(self) -> dict:
        """Per-node metrics over the RPC plane (the rows of
        Cluster.metrics(), plus each process's own: NodeWorker.metrics)."""
        out = {}
        for h in self.handles:
            try:
                row = await h.client.call("metrics", timeout=5.0)
                out[row.pop("name", h.name)] = row
            except Exception:
                out[h.name] = {"error": "unreachable"}
        return out

    async def stop(self) -> None:
        for task in (self._collector_task, self._health_task, *self._recoveries):
            if task is not None:
                task.cancel()
        self._collector_task = self._health_task = None

        async def stop_one(h):
            try:
                await h.client.call("stop", timeout=5.0)
            except Exception:
                pass
        await asyncio.gather(*(stop_one(h) for h in self.handles))
        for h in self.handles:
            if h.proc is not None:
                await asyncio.to_thread(h.proc.join, 5.0)
                if h.proc.is_alive():
                    h.proc.terminate()
                    await asyncio.to_thread(h.proc.join, 5.0)
            h.client.close()
        self.token_sock.close(linger=0)


def main(argv=None) -> None:
    """Standalone node launcher: the multi-host deployment path.

    Start one node per card (or card group) on each host, then point a
    parent ProcessCluster (or the entry point) at their addresses with
    `NodeSpec(node_type=..., attach_addr="tcp://host:port")`. The parent
    wires the migrate graph and the token plane over RPC at cluster start;
    every plane is plain tcp, so the same command works on one machine or
    across hosts.

    Example (2 hosts):
      hostA$ python -m hydrainfer_tpu_torch.cluster.process_node \\
                 --name p0 --node-type P --port 18800 \\
                 --config config/node/p.yaml model.path=/models/llava
      hostB$ python -m hydrainfer_tpu_torch.cluster.process_node \\
                 --name d0 --node-type D --port 18800 \\
                 --config config/node/d.yaml model.path=/models/llava
      parent: ProcessClusterConfig(nodes=[
                  NodeSpec("P", attach_addr="tcp://hostA:18800"),
                  NodeSpec("D", attach_addr="tcp://hostB:18800")],
                  advertise_host=<the parent's routable address>)
    """
    import argparse
    ap = argparse.ArgumentParser(
        description="standalone hydrainfer_tpu_torch node (attach-mode worker)")
    ap.add_argument("--name", required=True, help="short node name, e.g. p0")
    ap.add_argument("--node-type", required=True, help="one of E/P/D/EP/ED/PD/EPD")
    ap.add_argument("--host", default="0.0.0.0", help="RPC bind host")
    ap.add_argument("--port", type=int, required=True, help="RPC bind port")
    ap.add_argument("--config", default=None, help="NodeConfig YAML (config/node/*.yaml)")
    ap.add_argument("--tpot-slo", type=float, default=0.4)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the node on the CPU; by default it takes a card")
    ap.add_argument("--device-index", type=int, default=0,
                    help="which local card this node takes")
    ap.add_argument("overrides", nargs="*", help="key.path=value NodeConfig overrides")
    args = ap.parse_args(argv)

    from ..config import load_config
    cfg = load_config(NodeConfig, args.config, args.overrides)
    node_worker_main(NodeBoot(name=args.name, node_type=args.node_type, config=cfg,
                              rpc_host=args.host, rpc_port=args.port,
                              tpot_slo=args.tpot_slo, platform=args.platform,
                              device_index=args.device_index))


if __name__ == "__main__":
    main()
