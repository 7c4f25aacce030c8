"""Request types (port of hydrainfer_tpu/request.py)."""
from dataclasses import dataclass, field
from typing import List, Optional, Union


@dataclass
class SamplingParameters:
    max_tokens: int = 50
    eos_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False
    temperature: float = 0.0
    top_k: int = -1
    top_p: float = 1.0


@dataclass
class Request:
    request_id: Union[int, str] = 0
    prompt: str = ""
    image: Optional[object] = None              # PIL.Image
    image_base64: Optional[str] = None
    sampling_params: SamplingParameters = field(default_factory=SamplingParameters)


@dataclass
class RequestMetadata:
    n_prompt_tokens: int
    n_text_tokens: int
    n_images: int = 0
    n_image_tokens: int = 0


@dataclass
class OfflineInferenceOutput:
    text: str = ""
    output_token_ids: List[int] = field(default_factory=list)
    arrival_time: float = 0.0
    finished_time: float = 0.0
    token_times: List[float] = field(default_factory=list)
    ttft: float = 0.0
    tpot: float = 0.0
