"""Per-request latency breakdown metrics (port of hydrainfer_tpu/engine/metric.py).

Each stage list collects [begin, end] perf_counter stamps; the scheduler
stamps the queueing spans, the node (with NodeConfig.log_latency_breakdown)
the execute and transfer spans, and log_latency_breakdown emits each
stage's duration under the JAX package's names.
"""
from dataclasses import dataclass, field
from typing import List

from ..utils.logger import getLogger

logger = getLogger(__name__)

STAGES = ("encode_queueing", "encode_execute", "ep_transfer",
          "prefill_queueing", "prefill_execute", "pd_transfer",
          "decode_queueing", "decode_execute")


@dataclass
class RequestMetric:
    arrival_time: float = 0.0
    token_times: List[float] = field(default_factory=list)
    finished_time: float = 0.0

    encode_queueing: List[float] = field(default_factory=list)
    encode_execute: List[float] = field(default_factory=list)
    ep_transfer: List[float] = field(default_factory=list)
    prefill_queueing: List[float] = field(default_factory=list)
    prefill_execute: List[float] = field(default_factory=list)
    pd_transfer: List[float] = field(default_factory=list)
    decode_queueing: List[float] = field(default_factory=list)
    decode_execute: List[float] = field(default_factory=list)

    def breakdown(self) -> dict:
        out = {}
        for stage in STAGES:
            span = getattr(self, stage)
            if len(span) == 2:
                out[stage] = span[1] - span[0]
        return out


def log_latency_breakdown(metric: RequestMetric) -> None:
    for stage, dt in metric.breakdown().items():
        logger.info(f"{stage} time: {dt}")
