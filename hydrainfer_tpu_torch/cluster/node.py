"""Engine node (port of hydrainfer_tpu/cluster/node.py:AsyncEPDNode, every
node type: E, P, D and their unions EP, ED, PD, EPD).

One node runs on one device, which other nodes of the same process may
share, or, given a list of devices, on one tensor-parallel rank a device or,
with `NodeContext.parallel` "pp", one pipeline stage a device (ranks and
stages may share one): its language model shards its weights over them
(models/llama.py:shard_to and shard_to_pp, parallel/mesh.py and
parallel/pipeline.py) and its KV cache holds one shard a rank (its heads) or
a stage (its layers), while the token table, the image cache and the vision
tower stay on the first device. Decode graphs need all ranks and stages on
one card (`check_graph_devices`). It holds the models its type runs (the vision tower
to encode, the language model to prefill or decode) and the caches they
need: the KV pool when it prefills or decodes, the image-feature cache when
it encodes or prefills. An encode-only node has no KV pool, no fill executor
and no decode warm-up, and its image cache takes the whole cache share. It
runs the scheduler -> batch builder -> model step loop, and keeps a bounded
pipeline of dispatched fill steps whose sampled tokens are read back
asynchronously (CUDA events; see engine/executor.py:FillFuture). The
pipeline is the JAX package's "incremental" mode: completed windows are
drained first, then at most the backlog overflow, oldest first, so at least
one later window stays queued on the card through every read. A read that
must wait yields to the event loop until its event has fired, so the API
server that shares the loop keeps answering. Each step dispatches its fills
before its encode, so resident decodes never queue behind a ViT forward they
do not depend on (an image's own prefill runs in a later step).

At boot (`init`), in the JAX order: the executor's shape-key floors are
raised to the serving envelope, the SLO budget search runs
(engine/profiler.py, `NodeConfig.profiler`), the image-gather floor follows
from the image budget, and the decode warm-up captures the decode steps'
CUDA graphs (`cuda_graphs`, `boot_warmup`). `start` runs the serving loop
(`step_loop`, one step every `step_interval_s`, back to back while a chunked
encode runs) and the perf log.

N-gram speculative decoding (`spec_ngram_k`, 12 by default as in the JAX
package): when at most `spec_max_batch` requests are scheduled, all single
decodes with enough decode Fills ahead, and the proposer's backoff allows,
the node drains its pipeline, runs one verify step
(engine/executor.py:execute_spec) and reads its result before going on; when
no request has a draft, the step takes the fused window as usual.

The layer-chunked encode (`encode_chunk_layers` > 0, fixed-resolution
towers such as LLaVA's CLIP): a step's image batch starts the encode, each
later step runs one more segment of the tower after its fills, and while an
encode is in flight the decode window is capped at `encode_chunk_window`, so
decodes reach the card between segments. A step that schedules nothing
still advances the encode; image batches scheduled while it runs go back to
the scheduler; the finished batch rejoins the scheduler like any other.

Migration, the JAX package's 4-step protocol between nodes (of this process,
or of other processes through cluster/process_node.py's PeerNodeProxy):
  1. the source's `_execute_batch_migrate` resolves its pending tokens on
     the host (the token table does not travel), picks a target from the
     migrate graph's balancer for the request's scenario, and hands the
     request over with `migrate`; a failed hand-off is retried against the
     next target `migrate_retries` times, then the request is terminated and
     its blocks freed. A target that is this node (the colocated EPD node's
     own hand-offs) skips the pull and keeps the request;
  2. the target's `migrate` queues the request, its PullCache at the head of
     the waiting queue;
  3. the target pulls the blocks in a background asyncio task (`_pull_one`):
     it allocates its own blocks, gathers the source's KV and image blocks
     and scatters them into its caches (memory/token_cache.py; a source in
     another process gathers on its side and the proxy lands the payload,
     `pull_blocks`), while its step loop goes on dispatching decode
     windows; the request rejoins its scheduler when the copy is queued;
  4. the source frees the request's blocks and token slot
     (`free_migrate_request`).
On one card the copies run on the current stream, where the source's cache
writes and the target's reads are queued too: a copy is ordered after the
source's last write to the blocks and before the target's first read, and a
block the source frees and hands to a new request is written only after the
copy has read it, with no event. The copies are short beside a decode
window, so a side stream would buy little overlap for three events.
"""
import asyncio
import copy
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..engine.executor import FillExecutor, ImageEmbedExecutor
from ..engine.isa import (EmptyInstruction, EPMigrate, Fill, ImageEmbed,
                          MigrateRequest, PullCache)
from ..engine.metric import log_latency_breakdown
from ..engine.profiler import BatchSchedulerProfiler, BatchSchedulerProfilerConfig
from ..engine.rcb import BatchRequest, RequestControlBlock
from ..engine.request_processor import (RequestProcessParameters,
                                        RequestProcessor, RequestProcessorConfig,
                                        RequestProcessorObserver)
from ..engine.scenario import ScenarioType
from ..engine.scheduler import BatchScheduler, BatchSchedulerConfig
from ..engine.worker import VanillaWorker, WorkerConfig
from ..memory import TokenCacheBlockManager, TokenCacheBlockManagerConfig
from ..models.factory import ModelFactory, ModelFactoryConfig, getModelFactory
from ..ops import cuda as kernels
from ..parallel.mesh import CacheShard
from ..utils import hostprof
from ..utils.device import resolve_device
from ..utils.logger import getLogger
from .loadbalancer import CompositeLoadBalancer, LoadBalancer, LoadBalancerConfig
from .migrate import MigrateGraph, NodeType

logger = getLogger(__name__)


# NodeConfig fields of TPU-only machinery: accepted so that every preset
# loads, not ported, and logged when set to anything but the JAX default
# (ROADMAP.md: the jax.Ref cache, the tunnel-tuned pipeline modes and their
# reader thread, the prefill jit-key ladder, the attention implementation
# and layer-loop choices)
TPU_ONLY_FIELDS = ("kv_cache_ref", "pipeline_mode", "threaded_postprocess",
                   "max_threaded_backlog", "boot_warmup_prefill_ladder",
                   "model.attention_impl", "model.layer_loop")


@dataclass
class NodeConfig:
    model: ModelFactoryConfig = field(default_factory=ModelFactoryConfig)
    batch_scheduler: BatchSchedulerConfig = field(default_factory=BatchSchedulerConfig)
    request_processor: RequestProcessorConfig = field(default_factory=RequestProcessorConfig)
    # the SLO-driven budget search at boot (off by default, as in the JAX
    # package; its default_* budgets apply when it is off)
    profiler: BatchSchedulerProfilerConfig = field(
        default_factory=lambda: BatchSchedulerProfilerConfig(enabled=False))
    kv_block_size: int = 16
    image_block_size: int = -1        # -1 = one 336x336 image's tokens
    n_kv_blocks: int = -1             # -1 = size from free device memory
    n_image_blocks: int = -1
    hbm_utilization: float = 0.9
    kv_cache_ref: bool = True         # TPU-only
    # log each finished request's stage spans (engine/metric.py:
    # log_latency_breakdown): queueing, execute, transfer
    log_latency_breakdown: bool = False
    tpot_slo: float = 0.4
    # the serving loop's pause between steps, and the perf log's period
    step_interval_s: float = 0.001
    perf_monitor_interval_s: float = 5.0
    # how many device steps may be in flight before the host reads their
    # sampled tokens
    async_pipeline_depth: int = 2
    # read the sampled tokens every K device steps at most (the backlog cap
    # under load; with adaptive_postprocess, single steps when nearly idle,
    # see adaptive_postprocess_k)
    postprocess_batch_steps: int = 4
    adaptive_postprocess: bool = True
    # fused multi-step decode: up to this many chained decode steps per
    # dispatch when the scheduled batch is pure decode; 1 = off
    multi_step_decode: int = 16
    # n-gram speculative decoding (prompt lookup): up to this many draft
    # tokens a request, proposed from its own history and verified in one
    # synchronous device step; 0 = off. spec_ngram_n is the longest n-gram
    # looked up, spec_max_batch the most requests a verify step takes
    spec_ngram_k: int = 12
    spec_ngram_n: int = 3
    # run the all-decode steps from CUDA graphs, one per shape key (the
    # counterpart of the JAX package's jitted step programs); the card only
    cuda_graphs: bool = True
    # at boot, raise the S / MB key floors to the serving envelope (S =
    # max_running_requests, MB = the pool's fair-share context a request,
    # capped at boot_warmup_max_context; Ti on an image node) and run the
    # decode warm-up (engine/profiler.py), which captures the decode graphs
    # at that batch size. None = on where the node runs on the card with
    # cuda_graphs on (the JAX default follows profiler.enabled)
    boot_warmup: Optional[bool] = None
    boot_warmup_max_context: int = 8192
    boot_warmup_prefill_ladder: bool = False     # TPU-only
    spec_max_batch: int = 4
    pipeline_mode: str = "incremental"           # TPU-only
    threaded_postprocess: bool = False           # TPU-only
    max_threaded_backlog: int = 4                # TPU-only
    # layer-chunked ViT encode of fixed-resolution towers: layers a segment,
    # one segment a step (0 = the whole tower at once); encode_chunk_window
    # caps the decode window while a chunked encode runs
    encode_chunk_layers: int = 0
    encode_chunk_window: int = 4
    token_table_size: int = 4096
    # retries of a failed hand-off to another node, each against the
    # balancer's next target, before the request is terminated
    migrate_retries: int = 2


def tpu_only_settings(config: NodeConfig) -> dict:
    """The TPU-only fields of `config` set to anything but their default."""
    default = NodeConfig()
    out = {}
    for name in TPU_ONLY_FIELDS:
        value, ref = config, default
        for part in name.split("."):
            value, ref = getattr(value, part), getattr(ref, part)
        if value != ref:
            out[name] = value
    return out


@dataclass
class NodeContext:
    name: str = "node0"
    node_type: NodeType = field(default_factory=lambda: NodeType("PD"))
    # None = the card; a list of devices = one tensor-parallel rank a device
    # (ranks may share one), as the JAX node's device list forms its mesh
    device: Optional[object] = None
    migrate_graph: Optional[MigrateGraph] = None
    # what a device list shards: "tp" (heads, one rank a device) or "pp"
    # (layers, one pipeline stage a device)
    parallel: str = "tp"


def check_graph_devices(devices, cuda_graphs: bool) -> None:
    """A decode graph captures one device's stream: ranks or pipeline stages
    on different cards cannot run from one graph, so such a node must turn
    cuda_graphs off rather than run eagerly unasked."""
    if cuda_graphs and len(set(devices)) > 1 and any(d.type == "cuda" for d in devices):
        raise NotImplementedError(
            f"cuda_graphs with tensor-parallel ranks or pipeline stages on different devices "
            f"{[str(d) for d in devices]}: a decode graph captures one card's stream "
            "(cross-card graphs are ROADMAP.md queue 1, item 11); set cuda_graphs=false")


class BatchSchedulerObserver(RequestProcessorObserver):
    def __init__(self, scheduler: BatchScheduler):
        self.scheduler = scheduler

    def update(self, rcb: RequestControlBlock) -> None:
        self.scheduler.schedule_new(rcb)


def adaptive_postprocess_k(n_running: int, n_waiting: int, max_running: int,
                           k_max: int) -> int:
    """Token-read batching factor (and fused-window cap) under the current
    load: the full k_max when saturated, per-step when nearly idle (streaming
    latency dominates), half in between."""
    if n_waiting > 0 or n_running >= max(1, int(0.75 * max_running)):
        return k_max
    if n_running <= 2:
        return 1
    return max(1, k_max // 2)




def _block_share_per_device(shards, n_layers: int, n_heads: int) -> dict:
    """{device: the share of a KV block its shards hold} of a CacheShard
    list (heads times layers over the whole block's)."""
    out = {}
    for dev, _, n, _, layers in shards:
        out[dev] = out.get(dev, 0.0) + n * (layers or n_layers) / (n_heads * n_layers)
    return out


class AsyncEPDNode:
    def __init__(self, config: NodeConfig, context: NodeContext):
        self.config = config
        self.context = context
        self.name = f"{context.node_type}Node:{context.name}"
        devices = (context.device if isinstance(context.device, (list, tuple))
                   else [context.device])
        # one a tensor-parallel rank; rank 0's holds the token table, the
        # image cache and the vision tower
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        if context.parallel not in ("tp", "pp"):
            raise ValueError(f"NodeContext.parallel is 'tp' or 'pp', not {context.parallel!r}")
        check_graph_devices(self.devices, config.cuda_graphs)
        tpu_only = tpu_only_settings(config)
        if tpu_only:
            logger.warning(f"{self.name}: TPU-only settings have no effect here: "
                           f"{tpu_only}")
        self._pending_fills = []
        # log_latency_breakdown: per request (id of its rcb), the fill steps
        # dispatched whose tokens have not reached the host yet
        self._unread = {}
        self._stop = False
        self._tasks = []
        # in-flight cache pulls (background tasks) and what they moved
        self._pull_tasks = set()
        self._pull_stats = {"n": 0, "seconds": 0.0, "bytes": 0}

    # ---------------- init ----------------

    def init(self, model_factory: Optional[ModelFactory] = None) -> None:
        """Build the node's models (from `config.model` through
        getModelFactory when no factory is given), caches and executors,
        then boot: key floors, budget search, image-gather floor, decode
        warm-up, in the JAX order (the floors and the warm-up only where
        the node has a KV cache)."""
        nt = self.context.node_type
        cfg = self.config
        self.model_factory = model_factory or getModelFactory(cfg.model, self.device)
        self.language_config = self.model_factory.getLanguageModelConfig()
        self.vision_config = self.model_factory.getVisionModelConfig()
        # prefix-hash granularity must equal the KV block size
        cfg.request_processor.block_size = cfg.kv_block_size
        self.worker = VanillaWorker(WorkerConfig(enable_vision=nt.has_vision_model,
                                                 enable_language=nt.has_language_model),
                                    self.model_factory)
        if len(self.devices) > 1:
            self._shard_language_model()
        self._init_caches()
        self.fill_executor = (
            FillExecutor(self.kv_cache_manager, self.worker, cfg.token_table_size,
                         image_cache_manager=self.image_cache_manager,
                         mrope=bool(self.language_config.mrope_section),
                         cuda_graphs=cfg.cuda_graphs)
            if self.kv_cache_manager is not None else None)
        self.image_embed_executor = (
            ImageEmbedExecutor(self.image_cache_manager, self.worker,
                               chunk_layers=cfg.encode_chunk_layers)
            if nt.has_vision_model and self.image_cache_manager is not None else None)

        n_img = (self.vision_config.image_token_calculator
                 .get_num_image_tokens((336, 336)) or 576
                 if self.vision_config is not None else 576)
        profiler = BatchSchedulerProfiler(
            cfg.profiler, self.fill_executor, self.kv_cache_manager,
            self.image_cache_manager, n_image_tokens=n_img,
            image_embed_executor=self.image_embed_executor,
            image_processor=self.model_factory.getProcessor())
        boot_warm = cfg.boot_warmup
        if boot_warm is None:
            boot_warm = self.device.type == "cuda" and cfg.cuda_graphs
        boot_warm = (boot_warm and self.kv_cache_manager is not None
                     and self.worker.supports_multi_step())
        fx, kv = self.fill_executor, self.kv_cache_manager
        max_running = cfg.batch_scheduler.max_running_requests
        if boot_warm:
            # the S / MB floors first, so every key the budget probes, the
            # warm-up and live traffic meet lands on the converged set
            fair_ctx = min(kv.n_blocks * kv.block_size // max(1, max_running),
                           cfg.boot_warmup_max_context)
            fx.preratchet(max_running, -(-fair_ctx // kv.block_size))
        image_budget = profiler.profile_image_budgets()
        token_budget = profiler.profile_token_budgets()
        self.profiler_fallbacks = profiler.fallbacks
        if boot_warm and self.image_cache_manager is not None:
            # the widest image gather one batch can carry: the image budget's
            # tokens, at most the token budget
            fx.preratchet(1, 1, min(image_budget * n_img, token_budget))
        if boot_warm:
            # a failure here stops the boot: on the card it is a failed capture
            profiler.warm_decode(max_running, max(cfg.multi_step_decode, 1))

        self.batch_scheduler = BatchScheduler(
            cfg.batch_scheduler, self.kv_cache_manager, token_budget,
            image_cache_manager=self.image_cache_manager, image_budget=image_budget)
        self.request_processor = RequestProcessor(cfg.request_processor,
                                                  self.model_factory)
        self.request_processor.register_observer(
            BatchSchedulerObserver(self.batch_scheduler))
        self.ep_loadbalancer = CompositeLoadBalancer()
        self.pd_loadbalancer = CompositeLoadBalancer()
        if self.context.migrate_graph is not None:
            self.update_migrate_graph(self.context.migrate_graph)
        caches = {name: m.n_blocks for name, m in (("kv", self.kv_cache_manager),
                                                  ("image", self.image_cache_manager))
                  if m is not None}
        logger.info(f"{self.name} initialized on {self.device} (blocks: {caches}; "
                    f"budgets: {image_budget} images, {token_budget} tokens)")

    def _shard_language_model(self) -> None:
        """Tensor or pipeline parallelism over the node's devices: the
        language model shards its weights (its shard_to, or shard_to_pp when
        the context says "pp"), and the KV cache follows in _init_caches. A
        node without a language model (E) runs its tower on the first
        device."""
        lm = self.worker.language_model
        if lm is None:
            return
        pp = self.context.parallel == "pp"
        method, what, size = (("shard_to_pp", "pipeline-parallel", "pp_size") if pp
                              else ("shard_to", "tensor-parallel", "tp_size"))
        if not hasattr(lm, method):
            # the JAX node quietly runs such a model on its first device
            raise NotImplementedError(
                f"{type(lm).__name__} has no {what} form (GPT-2's layer loop is its "
                f"own): serve it with {size} 1, not on {len(self.devices)} devices")
        getattr(lm, method)(self.devices)
        logger.info(f"{self.name} {what} over {len(self.devices)} "
                    f"{'stages' if pp else 'ranks'} on {[str(d) for d in self.devices]}")

    def _init_caches(self) -> None:
        """The caches of the node's type: the KV pool where it prefills or
        decodes, the image cache where it encodes or prefills (and the
        model has a vision tower)."""
        nt = self.context.node_type
        lc = self.language_config
        lm = self.worker.language_model
        model = lm if lm is not None else self.worker.vision_model
        model_dtype = str(model.dtype).replace("torch.", "")
        kv_cfg = None
        if nt.has_kv_cache:
            # combined-head layout (K even / V odd), or one plane per token
            # for an MLA latent cache (exactly kv_lora + rope wide: the JAX
            # node's padding to 128 lanes serves the TPU kernel's DMA only);
            # the cache is int8 exactly when the model quantizes K/V on write
            kv_scale = getattr(getattr(lm, "cfg", None), "kv_scale", None)
            kv_dtype = "int8" if kv_scale is not None else model_dtype
            kv_cfg = TokenCacheBlockManagerConfig(
                n_layers=lc.n_layers, n_tensors=1,
                n_blocks=max(self.config.n_kv_blocks, 1),
                block_size=self.config.kv_block_size,
                n_heads=lc.n_kv_heads if lc.kv_single_plane else 2 * lc.n_kv_heads,
                head_dim=lc.head_dim, dtype=kv_dtype)
        # one image-cache slot per feature token: one hidden-wide row holds
        # its LM-hidden feature (the JAX node sizes it n_qo_heads x head_dim,
        # the same width except for MLA, whose head_dim is the latent width);
        # a block holds a 336x336 image's tokens unless image_block_size says
        # otherwise
        with_images = nt.has_image_cache and self.vision_config is not None
        img_cfg = None
        if with_images:
            block = self.config.image_block_size
            if block == -1:
                block = self.vision_config.image_token_calculator \
                    .get_num_image_tokens((336, 336)) or 576
            img_cfg = TokenCacheBlockManagerConfig(
                n_layers=1, n_tensors=1, n_blocks=max(self.config.n_image_blocks, 1),
                block_size=block,
                n_heads=1, head_dim=lc.hidden_size,
                dtype=model_dtype)
        # a tensor- or pipeline-parallel model's KV cache: one shard a rank
        # or stage
        shards = lm.cache_shards() if kv_cfg is not None and len(self.devices) > 1 else None
        auto_kv = kv_cfg is not None and self.config.n_kv_blocks == -1
        auto_img = with_images and self.config.n_image_blocks == -1
        if auto_kv or auto_img:
            if self.device.type == "cuda":
                # activation headroom per resident model, then the cache split
                # of the JAX node (its 0.1 / 0.8 image / KV shares; a node
                # with one cache gives it the whole share). Nodes sharing a
                # card size in turn: the first takes its share of nearly all
                # the free memory, as the JAX node does
                frac = 1.0 - 0.1 * nt.has_vision_model - 0.1 * nt.has_language_model
                if with_images and kv_cfg is not None:
                    img_frac, kv_frac = 0.1 * frac, 0.8 * frac
                else:
                    img_frac, kv_frac = (frac, 0.0) if with_images else (0.0, frac)
                free = torch.cuda.mem_get_info(self.device)[0] * self.config.hbm_utilization
                if auto_kv:
                    # the ranks and stages that share a card divide its
                    # share: a block costs each card its shards' heads and
                    # layers
                    kv_cfg.n_blocks = max(1, min(
                        int(torch.cuda.mem_get_info(dev)[0] * self.config.hbm_utilization
                            * kv_frac / (kv_cfg.block_nbytes * share))
                        for dev, share in _block_share_per_device(
                            shards or [CacheShard(self.device, 0, kv_cfg.n_heads)],
                            kv_cfg.n_layers, kv_cfg.n_heads).items()))
                if auto_img:
                    img_cfg.n_blocks = max(1, TokenCacheBlockManager.compute_n_blocks(
                        img_cfg, int(free * img_frac)))
            else:
                if auto_kv:
                    kv_cfg.n_blocks = 1024
                if auto_img:
                    img_cfg.n_blocks = 64
            logger.info(f"{self.name} cache sizing: {kv_cfg.n_blocks if kv_cfg else 0} "
                        f"kv blocks, {img_cfg.n_blocks if img_cfg else 0} image blocks")
        self.kv_cache_manager = (TokenCacheBlockManager(kv_cfg, self.device, self.name,
                                                        shards=shards)
                                 if kv_cfg is not None else None)
        self.image_cache_manager = (TokenCacheBlockManager(img_cfg, self.device, self.name)
                                    if img_cfg is not None else None)

    def update_migrate_graph(self, graph: MigrateGraph) -> None:
        """Take the graph's targets into the EP and PD balancers, keyed by
        scenario: every target serves Relaxed requests, and a target whose
        tpot_slo is under 0.05 s serves Strict ones too (a Strict request
        with no such target goes to any)."""
        self.context.migrate_graph = graph
        self.ep_loadbalancer = CompositeLoadBalancer()
        self.pd_loadbalancer = CompositeLoadBalancer()
        for lb in (self.ep_loadbalancer, self.pd_loadbalancer):
            for scenario in ScenarioType:
                lb.register_loadbalancer(scenario, LoadBalancer(LoadBalancerConfig("round")))
        for table, lb in ((graph.ep_table.get(self.name, []), self.ep_loadbalancer),
                          (graph.pd_table.get(self.name, []), self.pd_loadbalancer)):
            for mnode in table:
                if mnode.tpot_slo < 0.05:
                    lb.register_worker(ScenarioType.Strict, mnode)
                lb.register_worker(ScenarioType.Relaxed, mnode)

    # ---------------- request intake ----------------

    async def add_request(self, request, params: RequestProcessParameters) -> None:
        if (self.language_config.greedy_only
                and request.sampling_params.temperature > 0):
            # the JAX model would decode such a request greedily in silence
            raise ValueError(f"request {request.request_id}: this model decodes "
                             "greedily only; send temperature 0")
        request.sampling_params.eos_token_ids = list(
            request.sampling_params.eos_token_ids)
        self.request_processor.process(request, params)

    # ---------------- the hot loop ----------------

    async def step(self) -> None:
        with hostprof.span("node.schedule"):
            batch = self.batch_scheduler.step()
        if len(batch) == 0:
            # a chunked encode advances with nothing scheduled too: its
            # requests are parked in the executor, and when it finishes they
            # must rejoin the scheduler
            self._finish_or_requeue(self._encode_tick())
            # idle: drain the pipeline so trailing tokens reach their processors
            await self.flush_fills()
            return

        fills, embeds, empties, migrates, pulls = (BatchRequest() for _ in range(5))
        for rcb, inst in batch:
            if isinstance(inst, Fill):
                fills.append(rcb)
            elif isinstance(inst, ImageEmbed):
                embeds.append(rcb)
            elif isinstance(inst, MigrateRequest):
                migrates.append(rcb)
            elif isinstance(inst, PullCache):
                pulls.append(rcb)
            elif isinstance(inst, EmptyInstruction):
                empties.append(rcb)
            else:
                raise RuntimeError(f"unsupported instruction {type(inst)}")

        iee = self.image_embed_executor
        stamped = (self._stamp_execute_begin(fills, embeds)
                   if self.config.log_latency_breakdown else None)
        if len(fills):
            if not await self._speculate(fills):
                # full fused window when throughput-bound, single steps when
                # streaming-bound; a short one while a chunked encode runs
                n_steps = self.config.multi_step_decode
                if iee is not None and iee.busy and self.config.encode_chunk_window > 0:
                    n_steps = min(n_steps, self.config.encode_chunk_window)
                if n_steps > 1:
                    n_steps = min(n_steps, self._load_k(n_steps))
                fut = self.fill_executor.execute(fills, n_steps=n_steps)
                if stamped is not None:
                    fut.on_read = lambda: self._stamp_execute_end(stamped)
                self._pending_fills.append(fut)
            elif stamped is not None:
                self._stamp_execute_end(stamped)      # the verify step was read
        else:
            await self.flush_fills()
        # the encode after the fills: decode windows stay ahead of it in the
        # device queue. A chunked encode runs its next segment; new embeds
        # start one, or go back to the scheduler while one runs
        finished_encode = self._encode_tick()
        if len(embeds) and iee.chunking_enabled():
            if iee.busy:
                for rcb, _ in embeds:
                    self.batch_scheduler.schedule_running(rcb)
            else:
                iee.start_chunked(embeds)
            embeds = BatchRequest()
        elif len(embeds):
            iee.execute(embeds)
            if stamped is not None:
                # the whole-tower encode's span ends where the JAX node's
                # does: after the step's encode call
                now = time.perf_counter()
                for rcb, _ in embeds:
                    rcb.metric.encode_execute.append(now)
        empties.step()
        await self._drain_pipeline()
        # the hand-offs after this step's dispatches and reads, as the JAX
        # node runs them (awaited here, not left as tasks: a task's flush
        # would read the pipeline beside the drain, out of order); pulls
        # start here and rejoin the scheduler from their own tasks
        await self._execute_batch_migrate(migrates)
        self._execute_pull_cache(pulls)
        for b in (embeds, fills, empties, finished_encode):
            self._finish_or_requeue(b)

    def _encode_tick(self) -> BatchRequest:
        """The in-flight chunked encode's next segment: the finished batch
        (to rejoin the scheduler), or an empty one."""
        iee = self.image_embed_executor
        if iee is None or not iee.busy:
            return BatchRequest()
        done = iee.advance() or BatchRequest()
        if self.config.log_latency_breakdown:
            now = time.perf_counter()
            for rcb, _ in done:
                rcb.metric.encode_execute.append(now)
        return done

    def _stamp_execute_begin(self, fills: BatchRequest, embeds: BatchRequest) -> list:
        """Open the execute spans of this step's requests, as the JAX node
        does: a fill's prefill_execute (more than one token) or
        decode_execute span begins at its first step, an embed's
        encode_execute span unless one is open. Returns (rcb, span) of each
        fill, for _stamp_execute_end."""
        now = time.perf_counter()
        stamped = []
        for rcb, inst in fills:
            m = rcb.metric
            span = m.prefill_execute if len(inst.position_ids) > 1 else m.decode_execute
            if not span:
                span.append(now)
            stamped.append((rcb, span))
            self._unread[id(rcb)] = self._unread.get(id(rcb), 0) + 1
        for rcb, _ in embeds:
            if len(rcb.metric.encode_execute) % 2 == 0:
                rcb.metric.encode_execute.append(now)
        return stamped

    def _stamp_execute_end(self, stamped: list) -> None:
        """Close (or move to now) the execute spans of one dispatched fill
        step. It is called where the step's sampled tokens reach the host
        (FillFuture.on_read, the async pipeline's read), not where the step
        was dispatched: the JAX node's end stamp follows its own drain. A
        request that finished before this read logs its breakdown here."""
        now = time.perf_counter()
        for rcb, span in stamped:
            if len(span) == 1:
                span.append(now)
            elif len(span) > 1:
                span[1] = now
            left = self._unread.pop(id(rcb)) - 1
            if left:
                self._unread[id(rcb)] = left
            elif rcb.metric.finished_time:
                log_latency_breakdown(rcb.metric)

    def _log_finished(self, rcb: RequestControlBlock) -> None:
        """A finished request's breakdown, once its last tokens are read."""
        if self.config.log_latency_breakdown and id(rcb) not in self._unread:
            log_latency_breakdown(rcb.metric)

    async def _speculate(self, fills: BatchRequest) -> bool:
        """One speculative verify step for `fills`, if they qualify; whether
        it ran. The cheap precheck keeps batches that can never speculate
        from draining the pipeline; the drain precedes the proposer, which
        needs every token so far."""
        k, fx = self.config.spec_ngram_k, self.fill_executor
        if not (k > 0 and len(fills) <= self.config.spec_max_batch
                and fx.spec_precheck(fills, k) and fx.spec_should_try()):
            return False
        await self.flush_fills()
        fut = fx.execute_spec(fills, k, self.config.spec_ngram_n)
        if fut is None:
            return False
        await self._read(fut)
        return True

    def _load_k(self, k_max: int) -> int:
        if not self.config.adaptive_postprocess:
            return k_max
        s = self.batch_scheduler
        return adaptive_postprocess_k(s.n_resident, len(s.waiting),
                                      s.config.max_running_requests, k_max)

    def _finish_or_requeue(self, b: BatchRequest) -> None:
        now = time.perf_counter()
        for rcb, _ in b:
            if rcb.is_finished():
                rcb.metric.finished_time = now
                self._free_cache(rcb)
                self._log_finished(rcb)
            else:
                self.batch_scheduler.schedule_running(rcb)

    @staticmethod
    async def _read(fut) -> None:
        """fut.get(), once its tokens have landed. A worker thread waits on the
        window's event (the wait drops the GIL), so meanwhile the loop runs
        its other tasks (the API server's) without spinning: a wait on the
        loop would stall every open stream for up to a window."""
        if not fut.is_ready():
            await asyncio.to_thread(fut.wait)
        fut.get()

    async def _drain_pipeline(self) -> None:
        """Keep the async fill pipeline bounded ("incremental" mode)."""
        if not self._pending_fills:
            return
        backlog_steps = max(self.config.async_pipeline_depth,
                            self._load_k(self.config.postprocess_batch_steps))
        if hostprof.events_enabled:
            # the window-completion probe: a window's first drain that finds
            # its tokens landed
            for f in self._pending_fills:
                if (getattr(f, "win_id", None) is not None
                        and not getattr(f, "seen_ready", False) and f.is_ready()):
                    f.seen_ready = True
                    hostprof.event("ready", f.win_id)
        # completed windows first (their read is a bare copy)...
        with hostprof.span("node.drain_ready"):
            while self._pending_fills and self._pending_fills[0].is_ready():
                self._pending_fills.pop(0).get()
        # ...then at most the backlog overflow, oldest first, so a later
        # window stays queued on the card through each read
        pending = sum(f.n_steps for f in self._pending_fills)
        with hostprof.span("node.drain_forced"):
            while pending > backlog_steps and len(self._pending_fills) >= 2:
                f = self._pending_fills.pop(0)
                pending -= f.n_steps
                await self._read(f)

    async def flush_fills(self) -> None:
        """Drain the async fill pipeline in dispatch order."""
        while self._pending_fills:
            await self._read(self._pending_fills.pop(0))

    # ---------------- the 4-step migration protocol ----------------

    def _keep(self, rcb: RequestControlBlock) -> None:
        """Serve a migrating request here: skip its PullCache."""
        rcb.step()
        self.batch_scheduler.schedule_running(rcb)

    async def _execute_batch_migrate(self, batch: BatchRequest) -> None:
        """1. Hand each request to its target node (module docstring). The
        pipeline is flushed once, before the first hand-off to another
        node, so the request's sampled tokens are on the host; a request
        kept here needs no flush. A handed-off request's KV reservation
        here ends at the hand-off: this node allocates nothing more for it,
        and its blocks are freed when the target has pulled them."""
        flushed = False
        for rcb, inst in batch:
            rcb.step()      # MigrateRequest -> PullCache
            lb = self.ep_loadbalancer if isinstance(inst, EPMigrate) else self.pd_loadbalancer
            target = lb.choice(key=rcb.scenario_type)
            if target.name == self.name:
                self._keep(rcb)
                continue
            if not flushed:
                await self.flush_fills()
                flushed = True
            need = self.batch_scheduler.release_reservation(rcb)
            self.batch_scheduler.migrating_acquire()
            for attempt in range(1 + max(0, self.config.migrate_retries)):
                try:
                    await target.node.migrate(self, rcb)
                    break
                except Exception:
                    logger.exception(f"{rcb.request_id} migrate to {target.name} "
                                     f"failed (attempt {attempt + 1})")
                    target = lb.choice(key=rcb.scenario_type)
                    if target.name == self.name:
                        self.batch_scheduler.migrating_release()
                        self.batch_scheduler.restore_reservation(rcb, need)
                        self._keep(rcb)
                        break
            else:
                await self.free_migrate_request(rcb)
                for proc in rcb.output_token_processors:
                    proc.terminate()

    async def migrate(self, src_node: "AsyncEPDNode", rcb: RequestControlBlock) -> None:
        """2. Take a request from src_node: its PullCache jumps the queue."""
        inst = rcb.current_instruction()
        assert isinstance(inst, PullCache)
        inst.src_node = src_node
        self.batch_scheduler.schedule_new(rcb)

    def _execute_pull_cache(self, batch: BatchRequest) -> None:
        """3. One background pull task a request (kept in _pull_tasks)."""
        for rcb, inst in batch:
            task = asyncio.create_task(self._pull_one(rcb, inst))
            self._pull_tasks.add(task)
            task.add_done_callback(self._pull_tasks.discard)

    async def _pull_one(self, rcb: RequestControlBlock, inst: PullCache) -> None:
        """Pull the request's KV blocks (where this node has a KV cache) and
        image blocks (where it has an image cache) from the source, have the
        source free its side, and requeue the request. A failed pull frees
        both sides and terminates the request."""
        t0 = time.perf_counter()
        src_node = inst.src_node
        src_kv, src_img = rcb.virtual_kv_cache, rcb.virtual_image_cache
        # the JAX node's rule: a request's first pull is its ep_transfer
        # span, a second its pd_transfer (so a text request's one P -> D
        # pull logs as ep_transfer there too)
        m = rcb.metric
        stage = m.ep_transfer if not m.ep_transfer else m.pd_transfer
        stage.append(t0)
        old = copy.copy(rcb)
        # the token slot is the source executor's (freed through `old`); this
        # node acquires its own, and the first decode token is a host literal
        rcb.token_slot = -1
        # the source's caches leave the rcb before the pull: a failed pull
        # frees only this node's caches through it
        rcb.virtual_kv_cache = rcb.virtual_image_cache = None
        nt = self.context.node_type
        try:
            if src_kv is not None and nt.has_kv_cache:
                rcb.virtual_kv_cache = await self._pull_virtual_cache(
                    src_node, src_kv, is_kv=True)
            if src_img is not None and self.image_cache_manager is not None:
                rcb.virtual_image_cache = await self._pull_virtual_cache(
                    src_node, src_img, is_kv=False)
            await src_node.free_migrate_request(old)
        except Exception:
            logger.exception(f"{rcb.request_id} cache pull from {src_node} failed")
            try:
                await src_node.free_migrate_request(old)
            except Exception:
                logger.warning(f"{rcb.request_id}: the source-side free on {src_node} "
                               "failed too; its blocks leak")
            self._free_cache(rcb)
            for proc in rcb.output_token_processors:
                proc.terminate()
            return
        rcb.step()
        now = time.perf_counter()
        stage.append(now)
        self._pull_stats["n"] += 1
        self._pull_stats["seconds"] += now - t0
        if rcb.is_finished():
            rcb.metric.finished_time = now
            self._free_cache(rcb)
            self._log_finished(rcb)
        else:
            self.batch_scheduler.schedule_running(rcb)

    async def _pull_virtual_cache(self, src_node, src_vc, is_kv: bool):
        """A virtual cache of this node holding src_vc's tokens, copied
        block for block from the source's cache (a node of this process, or
        another process's through its PeerNodeProxy)."""
        dst_mgr = self.kv_cache_manager if is_kv else self.image_cache_manager
        dst_vc = dst_mgr.allocate_virtual_cache()
        dst_mgr.realloc(dst_vc, src_vc.n_cache_tokens)
        if not src_vc.block_table:
            return dst_vc
        if getattr(src_node, "is_remote", False):
            # a node of another process (cluster/process_node.py): its proxy
            # gathers over the data plane the two processes share (CUDA IPC,
            # shared memory or RPC) and lands the payload with scatter_blocks
            nbytes = await src_node.pull_blocks(is_kv, src_vc, dst_mgr, dst_vc)
        else:
            src_mgr = src_node.kv_cache_manager if is_kv else src_node.image_cache_manager
            blocks = src_mgr.gather_blocks(src_vc.block_table)
            nbytes = blocks.numel() * blocks.element_size()
            dst_mgr.scatter_blocks(dst_vc.block_table, blocks)
        self._pull_stats["bytes"] += nbytes
        return dst_vc

    async def free_migrate_request(self, rcb: RequestControlBlock) -> None:
        """4. Free a handed-off request's blocks and token slot here (its
        reservation ended at the hand-off)."""
        self._free_cache(rcb, release_reservation=False)
        self.batch_scheduler.migrating_release()

    def _free_cache(self, rcb: RequestControlBlock, release_reservation: bool = True) -> None:
        if rcb.virtual_kv_cache is not None and self.kv_cache_manager is not None:
            self.kv_cache_manager.realloc(rcb.virtual_kv_cache, 0)
        if rcb.virtual_image_cache is not None and self.image_cache_manager is not None:
            self.image_cache_manager.realloc(rcb.virtual_image_cache, 0)
        if self.fill_executor is not None:
            self.fill_executor.release_slot(rcb)
        if release_reservation:
            self.batch_scheduler.release_reservation(rcb)

    # ---------------- the serving loop ----------------

    async def start(self) -> None:
        if self._tasks and not self._stop:
            return
        self._stop = False
        self._tasks = [asyncio.create_task(self.step_loop()),
                       asyncio.create_task(self.perf_monitor_loop())]

    async def stop(self) -> None:
        """Stop the loops and the cache pulls in flight, and wait until
        their tasks have ended."""
        self._stop = True
        tasks = self._tasks + list(self._pull_tasks)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks = []

    async def step_loop(self) -> None:
        while not self._stop:
            try:
                await self.step()
            except Exception:
                logger.exception(f"{self.name} step failed")
                raise
            await asyncio.sleep(self._pause())

    def _pause(self) -> float:
        """Seconds between two steps of the serving loop: none while a
        chunked encode is in flight (its segments run one a step, and the
        requests it holds wait for them; the loop still yields to the
        server's tasks), else step_interval_s."""
        iee = self.image_embed_executor
        return 0.0 if iee is not None and iee.busy else self.config.step_interval_s

    async def perf_monitor_loop(self) -> None:
        while not self._stop:
            line = f"{self.name} perf: {self.metrics()}"
            fx = self.fill_executor
            if fx is not None and fx.spec_steps:
                line += (f" spec={fx.spec_tokens}tok/{fx.spec_steps}steps "
                         f"({fx.spec_tokens / fx.spec_steps:.2f} tok/step)")
            logger.info(line)
            await asyncio.sleep(self.config.perf_monitor_interval_s)

    def metrics(self) -> dict:
        """Serving metrics as plain JSON (the API server's /metrics): the
        JAX node's pool and queue counts (the KV pool's where the node has
        one), its speculation counts when a verify step has run and its
        migration pulls when one has landed, plus the boot's budgets and
        search fallbacks, the fill keys met, the CUDA graphs captured, and
        the kernel wrappers' launch counts (process-wide)."""
        sched = self.batch_scheduler
        sm = sched.metrics()
        fx = self.fill_executor
        row = {}
        if self.kv_cache_manager is not None:
            kv = self.kv_cache_manager.metrics()
            row.update(kv_free_blocks=kv.allocator.n_free_blocks,
                       kv_total_blocks=kv.allocator.n_total_blocks,
                       prefix_cache_hit_rate=round(kv.prefix_cache_hit_rate, 4))
        row.update(running_requests=sm.n_running_requests,
                   waiting_requests=len(sched.waiting),
                   migrating_requests=sm.n_requests_waiting_migrate,
                   token_budget=sched.token_budget,
                   image_budget=sched.image_budget,
                   profiler_fallbacks=self.profiler_fallbacks,
                   launches=kernels.launch_counts())
        pulls = self._pull_stats
        if pulls["n"]:
            row["migration_pulls"] = pulls["n"]
            row["migration_pull_s_total"] = round(pulls["seconds"], 4)
            row["migration_pull_mb"] = round(pulls["bytes"] / 1e6, 3)
        if fx is None:
            return row
        row["fill_keys"] = len(fx._seen_fill_keys)
        if fx.spec_steps:
            row["spec_steps"] = fx.spec_steps
            row["spec_tokens"] = fx.spec_tokens
        if fx.graphs is not None:
            row["graph_keys"] = sorted(
                [d.T, d.S, d.MB, n] for (d, n), g in fx.graphs.graphs.items()
                if g.graph is not None)
            row["graph_captures"] = fx.graphs.captures
            row["graph_replays"] = fx.graphs.replays
        return row

    def __repr__(self):
        return self.name
