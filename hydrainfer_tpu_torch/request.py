"""Request types (port of hydrainfer_tpu/request.py)."""
from dataclasses import dataclass, field
from typing import List, Literal, Optional, Union


@dataclass
class SamplingParameters:
    max_tokens: int = 50
    eos_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False
    temperature: float = 0.0
    top_k: int = -1
    top_p: float = 1.0


@dataclass
class TokenParameters:
    """Per-request token-level policies. Inert: nothing in the engine reads
    them, as in the JAX package; they keep `Request(token_params=...)` valid."""
    kv_cache_eviction_policy: Literal[None, "random", "streamingllm"] = None
    window_size: int = 28
    attention_sink_size: int = 4
    token_pruning_policy: Literal[None, "focal"] = None
    n_embed_output_tokens: int = 64


@dataclass
class Request:
    request_id: Union[int, str] = 0
    prompt: str = ""
    image: Optional[object] = None              # PIL.Image
    image_base64: Optional[str] = None
    sampling_params: SamplingParameters = field(default_factory=SamplingParameters)
    token_params: TokenParameters = field(default_factory=TokenParameters)


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
