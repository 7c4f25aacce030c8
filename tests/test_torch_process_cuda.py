"""The process deployment's CUDA IPC data plane, on the card.

Every test here needs an NVIDIA card (the `cuda` marker) and skips
elsewhere. The file imports nothing of JAX, so it runs where JAX is not
installed (`python -m pytest --noconftest tests/test_torch_process_cuda.py`).

A source node (a P node of random:tiny-lm+mm: an int8 KV cache and a bf16
image cache, both on the card) runs in a spawned child process behind its
NodeWorker, its caches filled with seeded random values. This process pulls
blocks from it through a PeerNodeProxy into caches of its own on the card:

  - the pulls ride CUDA IPC (no shared-memory or RPC payload), and the
    landed KV and image blocks equal the source's bit for bit (read back
    over RPC);
  - 50 pulls in a row (KV and image in turn), after one warm-up pull, leave
    the source's and this process's allocated card memory where it was: no
    exported buffer is left behind in either process.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
from types import SimpleNamespace

import pytest
import torch

from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.cluster.process_node import (NodeBoot, NodeWorker, PeerInfo,
                                                       PeerNodeProxy, node_device, run_worker)
from hydrainfer_tpu_torch.cluster.rpc import RpcClient
from hydrainfer_tpu_torch.memory import TokenCacheBlockManager, TokenCacheBlockManagerConfig
from hydrainfer_tpu_torch.utils.socket_utils import find_free_port

pytestmark = pytest.mark.cuda

N_KV_BLOCKS, N_IMAGE_BLOCKS = 64, 8


def source_main(boot: NodeBoot, seed: int) -> None:
    """The child: a NodeWorker whose caches hold seeded random values."""
    device = node_device(boot.platform, boot.device_index)
    worker = NodeWorker(boot, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kv = worker.node.kv_cache_manager.cache_array
    kv.copy_(torch.randint(-127, 128, kv.shape, generator=gen, device=device,
                           dtype=torch.int8))
    img = worker.node.image_cache_manager.cache_array
    img.copy_(torch.randn(img.shape, generator=gen, device=device).to(img.dtype))
    run_worker(worker)


@pytest.fixture(scope="module")
def source():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import multiprocessing
    cfg = NodeConfig(kv_block_size=16, n_kv_blocks=N_KV_BLOCKS, n_image_blocks=N_IMAGE_BLOCKS,
                     cuda_graphs=False, boot_warmup=False, spec_ngram_k=0)
    cfg.model.name = "random:tiny-lm+mm"
    cfg.model.quantization = "int8"
    cfg.model.kv_cache_dtype = "int8"
    port = find_free_port()
    boot = NodeBoot(name="src", node_type="P", config=cfg, rpc_host="127.0.0.1",
                    rpc_port=port)
    proc = multiprocessing.get_context("spawn").Process(target=source_main,
                                                        args=(boot, 0), daemon=True)
    proc.start()
    addr = f"tcp://127.0.0.1:{port}"

    async def call(method, *args):
        client = RpcClient(addr)
        try:
            return await client.call(method, *args, timeout=300)
        finally:
            client.close()

    asyncio.run(call("ping"))
    yield SimpleNamespace(addr=addr, proc=proc, call=lambda *a: asyncio.run(call(*a)))
    try:
        asyncio.run(call("stop"))
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def local_cache(src, is_kv: bool, n_blocks: int) -> TokenCacheBlockManager:
    """A cache on this process's card with the source cache's geometry."""
    one = src.call("gather_blocks", is_kv, [0])
    _, layers, tensors, block, heads, dim = one.shape
    return TokenCacheBlockManager(TokenCacheBlockManagerConfig(
        n_layers=layers, n_tensors=tensors, n_blocks=n_blocks, block_size=block,
        n_heads=heads, head_dim=dim, dtype=str(one.dtype).replace("torch.", "")), "cuda")


def pull(proxy, is_kv, src_table, dst, dst_table):
    src_vc = SimpleNamespace(block_table=src_table,
                             n_cache_tokens=len(src_table) * dst.block_size)
    return proxy.pull_blocks(is_kv, src_vc, dst, SimpleNamespace(block_table=dst_table))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int8)


def test_ipc_pull_is_bit_for_bit(source):
    kv = local_cache(source, True, 16)
    img = local_cache(source, False, 4)
    assert kv.dtype == torch.int8 and img.dtype == torch.bfloat16
    kv_src, kv_dst = [40, 3, 17], [9, 0, 5]
    img_src, img_dst = [6, 1], [3, 2]

    async def run():
        proxy = PeerNodeProxy(PeerInfo("PNode:src", "P", 0.4, source.addr), {}, "cuda")
        try:
            n_kv = await pull(proxy, True, kv_src, kv, kv_dst)
            n_img = await pull(proxy, False, img_src, img, img_dst)
        finally:
            proxy.close()
        return proxy, n_kv, n_img

    proxy, n_kv, n_img = asyncio.run(run())
    assert (proxy.ipc_pulls, proxy.shm_pulls) == (2, 0)
    assert n_kv == 3 * kv.config.block_nbytes and n_img == 2 * img.config.block_nbytes
    for mgr, src_table, dst_table, is_kv in ((kv, kv_src, kv_dst, True),
                                             (img, img_src, img_dst, False)):
        want = source.call("gather_blocks", is_kv, src_table)
        got = mgr.gather_blocks(dst_table).cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(bits(got), bits(want))
        assert bits(want).abs().sum() > 0          # the blocks hold values


def test_fifty_pulls_leave_no_memory_behind(source):
    kv = local_cache(source, True, 16)
    img = local_cache(source, False, 4)

    async def run():
        proxy = PeerNodeProxy(PeerInfo("PNode:src", "P", 0.4, source.addr), {}, "cuda")
        try:
            await pull(proxy, True, [1, 2], kv, [3, 4])          # warm-up
            torch.cuda.synchronize()
            before = (torch.cuda.memory_allocated(),
                      (await proxy._rpc().call("metrics"))["cuda_memory_allocated"])
            for i in range(50):
                if i % 2:
                    await pull(proxy, False, [i % N_IMAGE_BLOCKS, (i + 3) % N_IMAGE_BLOCKS],
                               img, [0, 1])
                else:
                    await pull(proxy, True, [i, i + 1, i + 7], kv, [2, 8, 5])
            torch.cuda.synchronize()
            after = (torch.cuda.memory_allocated(),
                     (await proxy._rpc().call("metrics"))["cuda_memory_allocated"])
        finally:
            proxy.close()
        return proxy, before, after

    proxy, before, after = asyncio.run(run())
    assert proxy.ipc_pulls == 51 and proxy.shm_pulls == 0
    assert after == before
