"""Request control block (port of hydrainfer_tpu/engine/rcb.py)."""
from typing import List, Optional, Tuple

from ..memory import VirtualTokenCache
from ..request import RequestMetadata, SamplingParameters
from .isa import Instruction, InstructionList
from .metric import RequestMetric
from .scenario import ScenarioType


class RequestControlBlock:
    def __init__(self):
        self.request_id = None
        self.sampling_params: Optional[SamplingParameters] = None
        self.request_metadata: Optional[RequestMetadata] = None
        self.instructions: Optional[InstructionList] = None
        self.virtual_kv_cache: Optional[VirtualTokenCache] = None
        self.virtual_image_cache: Optional[VirtualTokenCache] = None
        self.sid: int = -1
        # device token-table slot for async decode feedback (assigned by the
        # fill executor while the request is resident on a node)
        self.token_slot: int = -1
        self.output_token_processors: list = []
        self.output_token_params = None
        self.output_token_ids: List[int] = []
        self.scenario_type: Optional[ScenarioType] = None
        self.metric = RequestMetric()

    def current_instruction(self) -> Optional[Instruction]:
        return self.instructions.curr

    def step(self) -> None:
        self.instructions.curr = self.instructions.curr.next

    def is_finished(self) -> bool:
        if self.instructions.curr is None:
            return True
        if len(self.output_token_ids) >= self.sampling_params.max_tokens:
            return True
        if self.output_token_ids and not self.sampling_params.ignore_eos:
            if self.output_token_ids[-1] in self.sampling_params.eos_token_ids:
                return True
        return False

    def register_output_token_processor(self, processor) -> None:
        self.output_token_processors.append(processor)

    def __repr__(self):
        return f"RCB(sid={self.sid}, insts={self.instructions!r})"


class BatchRequest:
    """A scheduled batch: (rcb, its current instruction) pairs."""

    def __init__(self, rcbs: Optional[List[RequestControlBlock]] = None):
        self.rcbs = rcbs if rcbs is not None else []

    def __len__(self) -> int:
        return len(self.rcbs)

    def __getitem__(self, i: int) -> Tuple[RequestControlBlock, Instruction]:
        rcb = self.rcbs[i]
        return rcb, rcb.current_instruction()

    def __iter__(self):
        for rcb in self.rcbs:
            yield rcb, rcb.current_instruction()

    def append(self, rcb: RequestControlBlock) -> None:
        self.rcbs.append(rcb)

    def step(self) -> None:
        for rcb in self.rcbs:
            rcb.step()
