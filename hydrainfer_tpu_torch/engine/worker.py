"""Model execution worker (port of hydrainfer_tpu/engine/worker.py)."""
from dataclasses import dataclass
from typing import Optional

from ..models.factory import (LanguageModel, ModelFactory, VisionModel,
                              VisionModelOutput, VisionModelParameters)


@dataclass
class WorkerConfig:
    enable_vision: bool = True
    enable_language: bool = True


class Worker:
    def supports_multi_step(self) -> bool:
        """Whether execute_language_model takes n_steps > 1 (the fused
        decode window). The executor clamps its window to 1 otherwise."""
        return False

    def execute_vision_model(self, pixel_values,
                             params: VisionModelParameters) -> VisionModelOutput:
        raise NotImplementedError

    def execute_language_model(self, cache, token_table, flat, dims,
                               n_steps: int = 1, fused_k=None, image_cache=None,
                               graphs=None, generator=None):
        raise NotImplementedError


class VanillaWorker(Worker):
    """Holds the node's models: the vision tower when the node encodes, the
    language model when it prefills or decodes."""

    def __init__(self, config: WorkerConfig, model_factory: ModelFactory):
        self.vision_model: Optional[VisionModel] = (
            model_factory.getVisionModel() if config.enable_vision else None)
        self.language_model: Optional[LanguageModel] = (
            model_factory.getLanguageModel() if config.enable_language else None)

    def supports_multi_step(self) -> bool:
        return bool(getattr(self.language_model, "supports_multi_step", False))

    def execute_vision_model(self, pixel_values,
                             params: VisionModelParameters) -> VisionModelOutput:
        return self.vision_model.forward(pixel_values, params)

    def execute_language_model(self, cache, token_table, flat, dims,
                               n_steps: int = 1, fused_k=None, image_cache=None,
                               graphs=None, generator=None):
        return self.language_model.forward_flat(cache, token_table, flat, dims,
                                                n_steps=n_steps, fused_k=fused_k,
                                                image_cache=image_cache, graphs=graphs,
                                                generator=generator)
