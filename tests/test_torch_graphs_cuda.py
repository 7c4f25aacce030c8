"""The port's CUDA-graph decode steps against its eager steps, on the card.

Every test here needs an NVIDIA card with nvcc (the `cuda` marker) and skips
elsewhere. The file imports nothing of JAX, so it runs where JAX is not
installed (`python -m pytest --noconftest tests/test_torch_graphs_cuda.py`).

Two engines over one model (the same weights), at the same key floors (both
run the boot warm-up), one with cuda_graphs on and one with it off, must
give identical greedy tokens: tiny-lm and mla-tiny-lm (PD, f32, and with
int8 weights and an int8 KV cache) and a tiny Qwen2-VL (EPD, image and text
requests: seeded random weights at a 2-block, 64-wide vision tower over
tiny-lm with M-RoPE sections (4, 6, 6)), at fused windows K = 1, 4 and 16. A
request that ends inside a window leaves the KV cache and the token table
(its discard slot aside) bit for bit as the eager engine leaves them. A replay after the cache's
contents change gives the eager step's result on the new contents. The
kernel launch counts of a round with graphs equal the eager round's. A node
whose KV pool is sized from free memory boots and serves with graphs, and a
capture or replay that fails raises.

Speculation and sampling: with n-gram speculation at k = 3 (two
lookup-friendly requests), the verify key's replays give the eager engine's
tokens and verify counts. A sampled key (its generator registered with the
graph) draws fresh numbers at every replay over a flat distribution, and
reseeding the generator repeats the replays' draws.

With several nodes in one process, a node's token wait (another thread) and
another node's capture are ordered: neither begins while the other runs.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import gc
from dataclasses import replace

import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models import step_graphs
from hydrainfer_tpu_torch.models.factory import (FillDims, ModelFactory,
                                                 VisionModelConfig, pack_fill_batch)
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.step_graphs import StepGraphs
from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from hydrainfer_tpu_torch.request import Request, SamplingParameters

pytestmark = pytest.mark.cuda

PROMPTS = ["the quick brown fox", "a", "jumps over the lazy dog and runs",
           "hello world this is a long prompt to chunk", "mid size one"]
# two requests end inside a K = 4 window
MAX_TOKENS = (24, 3, 24, 7, 24)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qwen2vl_factory(dev):
    """A tiny Qwen2-VL over tiny-lm with seeded random f32 weights."""
    from hydrainfer_tpu_torch.models.qwen2_vl import (Qwen2VisionConfig,
                                                      Qwen2VLImageProcessorAdapter,
                                                      Qwen2VLImageTokenCalculator,
                                                      Qwen2VLVisionModel)
    from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer
    lm = RandomWeightFactory("tiny-lm", dtype=torch.float32, device=dev, seed=0)
    lm.cfg = replace(lm.cfg, mrope_section=(4, 6, 6))
    vcfg = Qwen2VisionConfig(depth=2, embed_dim=64, hidden_size=lm.cfg.hidden_size,
                             num_heads=4, mlp_ratio=2.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    init = lambda *s: torch.randn(s, generator=gen, device=dev) * 0.05  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=dev)                        # noqa: E731
    E, M = vcfg.embed_dim, int(vcfg.embed_dim * vcfg.mlp_ratio)
    vw = {"patch_embed": init(vcfg.patch_dim, E), "blocks": [
        {"ln1": (zeros(E) + 1, zeros(E)), "qkv": (init(E, 3 * E), zeros(3 * E)),
         "proj": (init(E, E), zeros(E)), "ln2": (zeros(E) + 1, zeros(E)),
         "fc1": (init(E, M), zeros(M)), "fc2": (init(M, E), zeros(E))}
        for _ in range(vcfg.depth)],
        "merger": {"ln_q": (zeros(E) + 1, zeros(E)),
                   "mlp0": (init(4 * E, 4 * E), zeros(4 * E)),
                   "mlp2": (init(4 * E, vcfg.hidden_size), zeros(vcfg.hidden_size))}}

    class Factory(ModelFactory):
        vision = Qwen2VLVisionModel(vw, vcfg)

        def getVisionModel(self):
            return self.vision

        def getLanguageModel(self):
            return lm.getLanguageModel()

        def getVisionModelConfig(self):
            return VisionModelConfig("<image>", 9, Qwen2VLImageTokenCalculator(
                vcfg.patch_size, vcfg.spatial_merge_size))

        def getLanguageModelConfig(self):
            return lm.getLanguageModelConfig()

        def getProcessor(self):
            return Qwen2VLImageProcessorAdapter(vcfg)

        def getTokenizer(self):
            return SimpleTokenizer()

    return Factory()


def _factory(arch, dev, quant="none"):
    if arch == "qwen2-vl-tiny":
        return _qwen2vl_factory(dev)
    return RandomWeightFactory(arch, dtype=torch.float32, device=dev, seed=0,
                               quantization=quant,
                               kv_scale=0.05 if quant == "int8" else None)


def _engine(factory, dev, cuda_graphs, k, node_type="PD", n_kv_blocks=256,
            spec_ngram_k=12, max_running=5):
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=n_kv_blocks, n_image_blocks=16,
        multi_step_decode=k, cuda_graphs=cuda_graphs, boot_warmup=True,
        spec_ngram_k=spec_ngram_k)
    engine = OfflineEngine(cfg, model_factory=factory, node_type=node_type, device=dev)
    engine.node.batch_scheduler.token_budget = 24
    return engine


def _requests(arch, tag="r"):
    from PIL import Image
    rng = np.random.default_rng(7)
    reqs = []
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS)):
        image = None
        if arch == "qwen2-vl-tiny" and i % 2 == 0:
            h, w = [(56, 56), (84, 112), (112, 56)][i // 2]
            image = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            p = p[:4] + "<image>" + p[4:]
        reqs.append(Request(request_id=f"{tag}{i}", prompt=p, image=image,
                            sampling_params=SamplingParameters(max_tokens=m,
                                                               ignore_eos=True)))
    return reqs


def _serve(engine, arch, tag="r"):
    outs = engine.generate(_requests(arch, tag), timeout_s=600)
    torch.cuda.synchronize()
    return [o.output_token_ids for o in outs]


ARCHS = [("tiny-lm", "none"), ("tiny-lm", "int8"), ("mla-tiny-lm", "none"),
         ("mla-tiny-lm", "int8"), ("qwen2-vl-tiny", "none")]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("arch,quant", ARCHS, ids=[f"{a}-{q}" for a, q in ARCHS])
def test_graph_tokens_match_eager(dev, arch, quant, k):
    factory = _factory(arch, dev, quant)
    node_type = "EPD" if arch == "qwen2-vl-tiny" else "PD"
    on = _engine(factory, dev, True, k, node_type)
    off = _engine(factory, dev, False, k, node_type)
    got, ref = _serve(on, arch), _serve(off, arch)
    assert got == ref
    assert [len(t) for t in got] == list(MAX_TOKENS)
    graphs = on.node.fill_executor.graphs
    assert graphs is not None and graphs.captures > 0 and graphs.replays > 0
    assert off.node.fill_executor.graphs is None


@pytest.fixture
def full_windows(monkeypatch):
    """Every window at the configured K. The node sizes a window by its load,
    and the load drops when the host has read a request's last tokens, which
    depends on timing; with the load out of the choice, both engines run one
    schedule, step for step."""
    from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode
    monkeypatch.setattr(AsyncEPDNode, "_load_k", lambda self, k_max: k_max)


@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_short_participation_leaves_eager_state(dev, arch, full_windows, monkeypatch):
    """Requests of 3 and 7 tokens end inside K = 4 windows (fused_k <
    n_steps): the cache and the token table end bit for bit as the eager
    engine leaves them."""
    from hydrainfer_tpu_torch.engine.executor import FillExecutor
    windows = []
    orig = FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append((n, ks))
        return n, ks

    monkeypatch.setattr(FillExecutor, "_multi_step_window", spy)
    factory = _factory(arch, dev)
    on, off = (_engine(factory, dev, g, 4) for g in (True, False))
    assert _serve(on, arch) == _serve(off, arch)
    assert on.node.fill_executor.graphs.replays > 0
    assert any(ks and min(ks) < n for n, ks in windows), windows
    assert torch.equal(on.node.kv_cache_manager.cache_array,
                       off.node.kv_cache_manager.cache_array)
    # (the table's last entry is the discard slot: every padded or masked
    # sequence writes its token there, in an order the card does not fix)
    assert torch.equal(on.node.fill_executor.token_table[:-1],
                       off.node.fill_executor.token_table[:-1])


def _decode_batch(dims: FillDims, kv_lens, bs: int, table_slots):
    """A packed all-decode batch: sequence s at kv_lens[s] (its token the
    last), blocks 1.. in order, its input token read from table_slots[s]."""
    S, T, MB = dims.S, dims.T, dims.MB
    n = len(kv_lens)
    tables = np.full((S, MB), -1, np.int32)
    nxt = 1
    for s, kv in enumerate(kv_lens):
        nb = -(-(kv + 16) // bs)
        tables[s, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    pad = lambda v, size, fill=0: np.concatenate(   # noqa: E731
        [np.asarray(v, np.int32), np.full(size - len(v), fill, np.int32)])
    slots = [tables[s, (kv - 1) // bs] * bs + (kv - 1) % bs for s, kv in enumerate(kv_lens)]
    return pack_fill_batch(
        token_ids=pad([], T), positions=pad([kv - 1 for kv in kv_lens], T),
        q_seq_ids=pad(range(n), T, -1), q_local_ids=pad([], T),
        new_kv_slot_ids=pad(slots, T, -1), token_src_slots=pad(table_slots, T, -1),
        kv_lens=pad(kv_lens, S), sample_token_idx=pad(range(n), S, -1),
        sample_dst_slots=pad(table_slots, S, -1), block_tables=tables,
        cu_q_lens=pad(range(n + 1), S + 1, n), num_seqs=np.asarray([n], np.int32),
        image_slot_ids=np.zeros(0, np.int32), image_dst_idx=np.zeros(0, np.int32))


@pytest.mark.parametrize("n_steps", [1, 4])
@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_replay_reads_the_live_cache(dev, arch, n_steps):
    """The same key replayed over new cache and token-table contents gives
    the eager step's tokens, cache and table on those contents."""
    lm = _factory(arch, dev).getLanguageModel()
    cfg = lm.cfg
    planes = 1 if cfg.mla_kv_lora else 2 * cfg.n_kv_heads
    bs, nb = 4, 64
    cache = torch.zeros((cfg.n_layers, 1, nb, bs, planes, cfg.head_dim), device=dev)
    table = torch.zeros(17, dtype=torch.int32, device=dev)
    graphs = StepGraphs(cache, table)
    dims = FillDims(T=8, S=4, MB=16, max_q=1)
    flat, fused_k = graphs.inputs(dims, n_steps)
    flat.copy_(torch.from_numpy(_decode_batch(dims, [5, 9, 22], bs, [3, 7, 11])))
    if fused_k is not None:
        fused_k.copy_(torch.tensor([n_steps, 2, n_steps, 0], dtype=torch.int32))
    gen = torch.Generator(device=dev).manual_seed(3)
    for contents in range(3):       # eager + capture, then two replays
        cache0 = torch.randn(cache.shape, generator=gen, device=dev)
        table0 = torch.randint(10, 500, table.shape, generator=gen, device=dev,
                               dtype=torch.int32)
        cache.copy_(cache0)
        table.copy_(table0)
        got = lm.forward_flat(cache, table, flat, dims, n_steps, fused_k,
                              graphs=graphs).sample_token_ids.clone()
        got_cache, got_table = cache.clone(), table.clone()
        cache.copy_(cache0)
        table.copy_(table0)
        ref = lm.forward_flat(cache, table, flat, dims, n_steps, fused_k).sample_token_ids
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        # (the table's last entry is the discard slot, written by every
        # padded or masked sequence in an order the card does not fix)
        assert torch.equal(got_cache, cache) and torch.equal(got_table[:-1], table[:-1])
    assert graphs.captures == 1 and graphs.replays == 2


@pytest.mark.parametrize("arch,quant", [("tiny-lm", "int8"), ("mla-tiny-lm", "int8")])
def test_launch_counts_include_replays(dev, arch, quant, full_windows):
    factory = _factory(arch, dev, quant)
    counts = []
    for cuda_graphs in (True, False):
        engine = _engine(factory, dev, cuda_graphs, 16)
        _serve(engine, arch, "warm")
        reset_launch_counts()
        _serve(engine, arch)
        counts.append(launch_counts())
    assert counts[0] == counts[1]
    assert counts[0]["kv_writer"] > 0 and counts[0]["quant_matmul"] > 0


def test_auto_sized_pool_boots_and_serves(dev):
    """n_kv_blocks = -1 sizes the KV pool from free memory before any
    capture; the graphs then fit in the headroom the sizing leaves."""
    engine = _engine(_factory("tiny-lm", dev), dev, True, 16, n_kv_blocks=-1)
    assert engine.node.kv_cache_manager.n_blocks > 256
    graphs = engine.node.fill_executor.graphs
    assert graphs.captures > 0
    assert [len(t) for t in _serve(engine, "tiny-lm")] == list(MAX_TOKENS)
    assert graphs.replays > 0 and graphs.pool_bytes() > 0
    del engine, graphs
    gc.collect()
    torch.cuda.empty_cache()


def test_failed_capture_raises(dev, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(step_graphs.torch.cuda, "graph", broken)
    with pytest.raises(RuntimeError, match="capture refused"):
        _engine(_factory("tiny-lm", dev), dev, True, 4)


def test_failed_replay_raises(dev, monkeypatch):
    engine = _engine(_factory("tiny-lm", dev), dev, True, 4)

    def broken(self):
        raise RuntimeError("replay refused")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", broken)
    with pytest.raises(RuntimeError, match="replay refused"):
        _serve(engine, "tiny-lm")


@pytest.mark.parametrize("arch,quant", [("tiny-lm", "none"), ("tiny-lm", "int8"),
                                        ("mla-tiny-lm", "none")])
def test_verify_replays_match_eager(dev, arch, quant):
    """Speculation at k = 3 on two lookup-friendly requests (single steps on
    a node of four): the graphed verify steps give the eager engine's tokens
    and verify counts, and the verify key is replayed."""
    factory = _factory(arch, dev, quant)
    runs = []
    for cuda_graphs in (True, False):
        engine = _engine(factory, dev, cuda_graphs, 16, spec_ngram_k=3, max_running=4)
        reqs = [Request(request_id=f"s{i}", prompt=p,
                        sampling_params=SamplingParameters(max_tokens=24, ignore_eos=True))
                for i, p in enumerate(["abc abc abc abc abc abc", "ab ab ab ab ab"])]
        tokens = [o.output_token_ids for o in engine.generate(reqs, timeout_s=600)]
        fx = engine.node.fill_executor
        replays = (sum(g.replays for (d, _), g in fx.graphs.graphs.items() if d.spec > 0)
                   if cuda_graphs else None)
        runs.append((tokens, fx.spec_steps, fx.spec_tokens, replays))
    (tokens, steps, emitted, replays), eager = runs
    assert (tokens, steps, emitted) == eager[:3]
    assert steps > 0 and replays > 0


def _flat_sampling_step(dev, seed):
    """tiny-lm with a zero lm_head (every logit 0: a flat distribution),
    a cache, a token table, StepGraphs with a generator, and a sampled
    decode batch at temperature 1 in its key's buffer."""
    lm = _factory("tiny-lm", dev).getLanguageModel()
    lm.weights["lm_head"] = torch.zeros_like(lm.weights["lm_head"])
    cfg = lm.cfg
    cache = torch.zeros((cfg.n_layers, 1, 64, 4, 2 * cfg.n_kv_heads, cfg.head_dim),
                        device=dev)
    table = torch.zeros(17, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    graphs = StepGraphs(cache, table, gen)
    dims = FillDims(T=8, S=4, MB=16, max_q=1, sampling=True)
    flat, _ = graphs.inputs(dims, 1)
    tail = np.concatenate([np.ones(4, np.float32).view(np.int32), np.full(4, -1, np.int32),
                           np.ones(4, np.float32).view(np.int32), [1]]).astype(np.int32)
    flat.copy_(torch.from_numpy(np.concatenate(
        [_decode_batch(dims, [5, 9, 22], 4, [3, 7, 11]), tail])))
    table0 = table.clone()

    def step():
        table.copy_(table0)             # the same inputs at every call
        out = lm.forward_flat(cache, table, flat, dims, 1, None, graphs=graphs,
                              generator=gen).sample_token_ids
        torch.cuda.synchronize()
        return out[:3].clone()

    return step, graphs, gen


def test_sampled_key_replays_draw_fresh(dev):
    step, graphs, _ = _flat_sampling_step(dev, 0)
    step()                          # eager, then the capture
    draws = [step() for _ in range(4)]
    assert graphs.captures == 1 and graphs.replays == 4
    assert len({tuple(d.tolist()) for d in draws}) > 1


def test_reseeded_generator_repeats_replays(dev):
    step, graphs, gen = _flat_sampling_step(dev, 0)
    step()
    runs = []
    for _ in range(2):
        gen.manual_seed(123)
        runs.append([step() for _ in range(3)])
    assert graphs.replays == 6
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not all(torch.equal(runs[0][0], d) for d in runs[0][1:])


def test_capture_orders_against_token_waits(dev):
    """A token wait in another thread (a node's FillFuture.wait) and a graph
    capture never overlap: a capture begins after the waits in progress end,
    and a wait that starts during a capture begins after it."""
    import threading
    import time
    order = []

    def wait(event, tag):
        step_graphs.wait_event(event)
        order.append(tag)

    torch.cuda._sleep(int(5e8))          # the card spins for a while
    busy = torch.cuda.Event()
    busy.record()
    early = threading.Thread(target=wait, args=(busy, "early wait"))
    early.start()
    time.sleep(0.05)                     # the thread is inside its wait
    x = torch.ones(8, device=dev)
    graph = torch.cuda.CUDAGraph()
    done = torch.cuda.Event()
    done.record()
    with step_graphs._no_waits():
        # the early wait has ended: its event fired and no wait is counted
        assert busy.query() and step_graphs._waits == 0
        order.append("capture begins")
        late = threading.Thread(target=wait, args=(done, "late wait"))
        late.start()
        time.sleep(0.05)
        with torch.cuda.graph(graph):
            y = x * 2
        order.append("capture ends")
    early.join(timeout=60)
    late.join(timeout=60)
    assert "early wait" in order
    assert order[-3:] == ["capture begins", "capture ends", "late wait"]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, 2 * x)
