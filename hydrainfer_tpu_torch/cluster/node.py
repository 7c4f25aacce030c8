"""Engine node (port of hydrainfer_tpu/cluster/node.py:AsyncEPDNode, node
types holding a language model: P, D, PD, EP, EPD).

One node owns one device: it sizes the KV pool and, when it encodes or
prefills, the image-feature cache; it runs the scheduler -> batch builder ->
model step loop, and keeps a bounded pipeline of dispatched fill steps whose
sampled tokens are read back asynchronously (CUDA events; see
engine/executor.py:FillFuture). The pipeline is the JAX package's
"incremental" mode: completed windows are drained first, then at most the
backlog overflow, oldest first, so at least one later window stays queued on
the card through every blocking read. Each step dispatches its fills before
its encode, so resident decodes never queue behind a ViT forward they do not
depend on (an image's own prefill runs in a later step). At boot the node
raises the executor's shape-key floors to its serving envelope and runs the
decode warm-up, which captures the decode steps' CUDA graphs
(NodeConfig.cuda_graphs, boot_warmup). Migration is limited
to the colocated self graph (the EP and PD hand-offs to itself); cross-node
transfer, the chunked encode of fixed-resolution towers and speculative
decoding are later slices.
"""
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..engine.executor import FillExecutor, ImageEmbedExecutor
from ..engine.isa import EmptyInstruction, EPMigrate, Fill, ImageEmbed, MigrateRequest
from ..engine.profiler import warm_decode
from ..engine.rcb import BatchRequest, RequestControlBlock
from ..engine.request_processor import (RequestProcessParameters,
                                        RequestProcessor, RequestProcessorConfig,
                                        RequestProcessorObserver)
from ..engine.scheduler import BatchScheduler, BatchSchedulerConfig
from ..engine.worker import VanillaWorker
from ..memory import TokenCacheBlockManager, TokenCacheBlockManagerConfig
from ..models.factory import ModelFactory
from ..utils import hostprof
from ..utils.device import resolve_device
from ..utils.logger import getLogger
from .migrate import MigrateGraph, NodeType

logger = getLogger(__name__)


@dataclass
class NodeConfig:
    batch_scheduler: BatchSchedulerConfig = field(default_factory=BatchSchedulerConfig)
    request_processor: RequestProcessorConfig = field(default_factory=RequestProcessorConfig)
    kv_block_size: int = 16
    n_kv_blocks: int = -1             # -1 = size from free device memory
    n_image_blocks: int = -1
    hbm_utilization: float = 0.9
    tpot_slo: float = 0.4
    # tokens per scheduled batch (the JAX node's default when its budget
    # profiler is off)
    token_budget: int = 2048
    # how many device steps may be in flight before the host reads their
    # sampled tokens
    async_pipeline_depth: int = 2
    # read the sampled tokens every K device steps at most (the backlog cap
    # under load; single steps when nearly idle, see adaptive_postprocess_k)
    postprocess_batch_steps: int = 4
    # fused multi-step decode: up to this many chained decode steps per
    # dispatch when the scheduled batch is pure decode; 1 = off
    multi_step_decode: int = 16
    # n-gram speculative decoding is a later slice of the port, so it is off
    # here (the JAX default is 12); > 0 is refused
    spec_ngram_k: int = 0
    token_table_size: int = 4096
    # run the all-decode steps from CUDA graphs, one per shape key (the
    # counterpart of the JAX package's jitted step programs); the card only
    cuda_graphs: bool = True
    # at boot, raise the S / MB key floors to the serving envelope (S =
    # max_running_requests, MB = the pool's fair-share context a request,
    # capped at boot_warmup_max_context; Ti on an image node) and run the
    # decode warm-up (engine/profiler.py), which captures the decode graphs
    # at that batch size. None = on where the node runs on the card with
    # cuda_graphs on
    boot_warmup: Optional[bool] = None
    boot_warmup_max_context: int = 8192


@dataclass
class NodeContext:
    name: str = "node0"
    node_type: NodeType = field(default_factory=lambda: NodeType("PD"))
    device: Optional[object] = None      # None = the card
    migrate_graph: Optional[MigrateGraph] = None


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


class AsyncEPDNode:
    def __init__(self, config: NodeConfig, context: NodeContext):
        if not context.node_type.has_language_model:
            raise NotImplementedError("an encode-only (E) node hands off to other "
                                      "nodes, which is not ported yet")
        if config.spec_ngram_k > 0:
            raise NotImplementedError("speculative decoding is not ported yet")
        self.config = config
        self.context = context
        self.name = f"{context.node_type}Node:{context.name}"
        self.device = resolve_device(context.device)
        self._pending_fills = []

    # ---------------- init ----------------

    def init(self, model_factory: ModelFactory) -> None:
        nt = self.context.node_type
        self.model_factory = model_factory
        self.language_config = model_factory.getLanguageModelConfig()
        self.vision_config = model_factory.getVisionModelConfig()
        # prefix-hash granularity must equal the KV block size
        self.config.request_processor.block_size = self.config.kv_block_size
        self.worker = VanillaWorker(model_factory, enable_vision=nt.has_vision_model)
        self._init_caches()
        self.fill_executor = FillExecutor(
            self.kv_cache_manager, self.worker, self.config.token_table_size,
            image_cache_manager=self.image_cache_manager,
            mrope=bool(self.language_config.mrope_section),
            cuda_graphs=self.config.cuda_graphs)
        self.image_embed_executor = (
            ImageEmbedExecutor(self.image_cache_manager, self.worker)
            if nt.has_vision_model and self.image_cache_manager is not None else None)
        self.batch_scheduler = BatchScheduler(self.config.batch_scheduler,
                                              self.kv_cache_manager,
                                              self.config.token_budget,
                                              image_cache_manager=self.image_cache_manager)
        self.request_processor = RequestProcessor(self.config.request_processor,
                                                  model_factory)
        self.request_processor.register_observer(
            BatchSchedulerObserver(self.batch_scheduler))
        self._boot_warmup()
        logger.info(f"{self.name} initialized on {self.device} "
                    f"({self.kv_cache_manager.n_blocks} kv blocks, "
                    f"token budget {self.config.token_budget})")

    def _boot_warmup(self) -> None:
        """Pre-ratchet the key floors to the serving envelope, then warm the
        decode keys (port of the boot sequence of the JAX node's init). A
        failure here stops the boot: on the card it is a failed capture."""
        cfg = self.config
        on = cfg.boot_warmup
        if on is None:
            on = self.device.type == "cuda" and cfg.cuda_graphs
        if not (on and self.worker.supports_multi_step()):
            return
        fx, kv = self.fill_executor, self.kv_cache_manager
        max_running = cfg.batch_scheduler.max_running_requests
        fair_ctx = min(kv.n_blocks * kv.block_size // max(1, max_running),
                       cfg.boot_warmup_max_context)
        fx.preratchet(max_running, -(-fair_ctx // kv.block_size))
        if self.image_cache_manager is not None:
            # the widest image gather one batch can carry: the image budget's
            # tokens, at most the token budget
            n_img = self.vision_config.image_token_calculator \
                .get_num_image_tokens((336, 336)) or 576
            s = self.batch_scheduler
            fx.preratchet(1, 1, min(s.image_budget * n_img, s.token_budget))
        warm_decode(fx, kv, max_running, max(cfg.multi_step_decode, 1))

    def _init_caches(self) -> None:
        nt = self.context.node_type
        lc = self.language_config
        lm = self.worker.language_model
        model_dtype = str(lm.dtype).replace("torch.", "")
        # combined-head layout (K even / V odd), or one plane per token for
        # an MLA latent cache (exactly kv_lora + rope wide: the JAX node's
        # padding to 128 lanes serves the TPU kernel's DMA only); the cache is
        # int8 exactly when the model quantizes K/V on write
        kv_dtype = "int8" if lm.cfg.kv_scale is not None else model_dtype
        kv_cfg = TokenCacheBlockManagerConfig(
            n_layers=lc.n_layers, n_tensors=1,
            n_blocks=max(self.config.n_kv_blocks, 1),
            block_size=self.config.kv_block_size,
            n_heads=lc.n_kv_heads if lc.kv_single_plane else 2 * lc.n_kv_heads,
            head_dim=lc.head_dim, dtype=kv_dtype)
        # one image-cache slot per feature token: n_qo_heads * head_dim values
        # hold its LM-hidden feature; a block holds a 336x336 image's tokens
        with_images = nt.has_image_cache and self.vision_config is not None
        img_cfg = None
        if with_images:
            block = self.vision_config.image_token_calculator \
                .get_num_image_tokens((336, 336)) or 576
            img_cfg = TokenCacheBlockManagerConfig(
                n_layers=1, n_tensors=1, n_blocks=max(self.config.n_image_blocks, 1),
                block_size=block, n_heads=lc.n_qo_heads, head_dim=lc.head_dim,
                dtype=model_dtype)
        auto_kv = self.config.n_kv_blocks == -1
        auto_img = with_images and self.config.n_image_blocks == -1
        if auto_kv or auto_img:
            if self.device.type == "cuda":
                # activation headroom per resident model, then the cache split
                # of the JAX node (its 0.1 / 0.8 image / KV shares)
                free, _ = torch.cuda.mem_get_info(self.device)
                free = free * self.config.hbm_utilization
                frac = 1.0 - 0.1 * nt.has_vision_model - 0.1 * nt.has_language_model
                img_frac, kv_frac = (0.1 * frac, 0.8 * frac) if with_images else (0.0, frac)
                if auto_kv:
                    kv_cfg.n_blocks = max(1, TokenCacheBlockManager.compute_n_blocks(
                        kv_cfg, int(free * kv_frac)))
                if auto_img:
                    img_cfg.n_blocks = max(1, TokenCacheBlockManager.compute_n_blocks(
                        img_cfg, int(free * img_frac)))
            else:
                if auto_kv:
                    kv_cfg.n_blocks = 1024
                if auto_img:
                    img_cfg.n_blocks = 64
            logger.info(f"{self.name} cache sizing: {kv_cfg.n_blocks} kv blocks, "
                        f"{img_cfg.n_blocks if img_cfg else 0} image blocks")
        self.kv_cache_manager = TokenCacheBlockManager(kv_cfg, self.device, self.name)
        self.image_cache_manager = (TokenCacheBlockManager(img_cfg, self.device, self.name)
                                    if img_cfg is not None else None)

    def update_migrate_graph(self, graph: MigrateGraph) -> None:
        self.context.migrate_graph = graph

    # ---------------- request intake ----------------

    async def add_request(self, request, params: RequestProcessParameters) -> None:
        request.sampling_params.eos_token_ids = list(
            request.sampling_params.eos_token_ids)
        self.request_processor.process(request, params)

    # ---------------- the hot loop ----------------

    async def step(self) -> None:
        with hostprof.span("node.schedule"):
            batch = self.batch_scheduler.step()
        if len(batch) == 0:
            # idle: drain the pipeline so trailing tokens reach their processors
            self.flush_fills()
            return

        fills, embeds, empties, migrates = (BatchRequest() for _ in range(4))
        for rcb, inst in batch:
            if isinstance(inst, Fill):
                fills.append(rcb)
            elif isinstance(inst, ImageEmbed):
                embeds.append(rcb)
            elif isinstance(inst, MigrateRequest):
                migrates.append(rcb)
            elif isinstance(inst, EmptyInstruction):
                empties.append(rcb)
            else:
                raise RuntimeError(f"unsupported instruction {type(inst)}")

        self._execute_batch_migrate(migrates)
        if len(fills):
            # full fused window when throughput-bound, single steps when
            # streaming-bound
            n_steps = self.config.multi_step_decode
            if n_steps > 1:
                n_steps = min(n_steps, self._load_k(n_steps))
            self._pending_fills.append(
                self.fill_executor.execute(fills, n_steps=n_steps))
        else:
            self.flush_fills()
        # the encode after the fills: decode windows stay ahead of it in the
        # device queue
        if len(embeds):
            self.image_embed_executor.execute(embeds)
        empties.step()
        self._drain_pipeline()
        for b in (embeds, fills, empties):
            self._finish_or_requeue(b)

    def _load_k(self, k_max: int) -> int:
        s = self.batch_scheduler
        return adaptive_postprocess_k(s.n_resident, len(s.waiting),
                                      s.config.max_running_requests, k_max)

    def _finish_or_requeue(self, b: BatchRequest) -> None:
        now = time.perf_counter()
        for rcb, _ in b:
            if rcb.is_finished():
                rcb.metric.finished_time = now
                self._free_cache(rcb)
            else:
                self.batch_scheduler.schedule_running(rcb)

    def _drain_pipeline(self) -> None:
        """Keep the async fill pipeline bounded ("incremental" mode)."""
        if not self._pending_fills:
            return
        backlog_steps = max(self.config.async_pipeline_depth,
                            self._load_k(self.config.postprocess_batch_steps))
        # completed windows first (their read is a bare copy)...
        with hostprof.span("node.drain_ready"):
            while self._pending_fills and self._pending_fills[0].is_ready():
                self._pending_fills.pop(0).get()
        # ...then at most the backlog overflow, oldest first, so a later
        # window stays queued on the card through each blocking read
        pending = sum(f.n_steps for f in self._pending_fills)
        with hostprof.span("node.drain_forced"):
            while pending > backlog_steps and len(self._pending_fills) >= 2:
                f = self._pending_fills.pop(0)
                pending -= f.n_steps
                f.get()

    def flush_fills(self) -> None:
        """Drain the async fill pipeline in dispatch order."""
        while self._pending_fills:
            self._pending_fills.pop(0).get()

    def _execute_batch_migrate(self, batch: BatchRequest) -> None:
        """The EP and PD hand-offs of the colocated self graph: the target is
        this node, so the PullCache that follows has nothing to move."""
        graph = self.context.migrate_graph
        for rcb, inst in batch:
            table = graph.ep_table if isinstance(inst, EPMigrate) else graph.pd_table
            targets = table.get(self.name, [])
            if [t.name for t in targets] != [self.name]:
                raise NotImplementedError("migration to another node is not "
                                          "ported yet")
            rcb.step()      # MigrateRequest -> PullCache
            rcb.step()      # skip PullCache: nothing to move
            self.batch_scheduler.schedule_running(rcb)

    def _free_cache(self, rcb: RequestControlBlock) -> None:
        if rcb.virtual_kv_cache is not None:
            self.kv_cache_manager.realloc(rcb.virtual_kv_cache, 0)
        if rcb.virtual_image_cache is not None and self.image_cache_manager is not None:
            self.image_cache_manager.realloc(rcb.virtual_image_cache, 0)
        self.fill_executor.release_slot(rcb)
        self.batch_scheduler.release_reservation(rcb)

    def __repr__(self):
        return self.name
