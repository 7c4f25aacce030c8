"""Request -> RCB pipeline (port of hydrainfer_tpu/engine/request_processor.py).

Per request: sampling-params normalization (eos injection), instruction
creation (decode the image -> tokenize -> expand each <image> token into its
run of image tokens -> chained block hashes with the image's content hash in
place of its tokens -> M-RoPE positions -> the instruction list with every
decode Fill pre-created), scenario classification, output-processor
registration. Observers (the node's scheduler hook) receive the finished RCB.
"""
import base64
import io
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..memory import compute_image_hash, compute_prefix_hashes
from ..models.factory import ModelFactory
from ..request import Request, RequestMetadata
from ..utils.logger import getLogger
from .isa import (EPMigrate, ImageEmbed, ImageEmbedFill, InstructionListBuilder,
                  PDMigrate, PullCache, TextFill)
from .output_token_processor import OutputTokenParams
from .rcb import RequestControlBlock
from .scenario import ScenarioClassifier

logger = getLogger(__name__)


@dataclass
class RequestProcessorConfig:
    num_request_process_workers: int = 4
    block_size: int = 16


@dataclass
class RequestProcessParameters:
    output_token_processors: list = field(default_factory=list)
    output_token_params: OutputTokenParams = field(default_factory=OutputTokenParams)


class RequestProcessorObserver:
    """update() must be thread-safe: worker threads call it."""

    def update(self, rcb: RequestControlBlock) -> None:
        raise NotImplementedError


class RequestProcessor:
    def __init__(self, config: RequestProcessorConfig, model_factory: ModelFactory):
        self.config = config
        self.tokenizer = model_factory.getTokenizer()
        self.processor = model_factory.getProcessor()
        vision_cfg = model_factory.getVisionModelConfig()
        language_cfg = model_factory.getLanguageModelConfig()
        # text-only factories have no vision config: no token is an image
        self.image_token_id = vision_cfg.image_token_id if vision_cfg else None
        self.image_token_calculator = (vision_cfg.image_token_calculator
                                       if vision_cfg else None)
        self.eos_token_id = language_cfg.eos_token_id
        self.mrope_on = bool(language_cfg.mrope_section)
        self.scenario_classifier = ScenarioClassifier()
        self.observers: List[RequestProcessorObserver] = []
        self._pool = (ThreadPoolExecutor(config.num_request_process_workers)
                      if config.num_request_process_workers > 1 else None)
        self._lock = threading.Lock()

    def register_observer(self, observer: RequestProcessorObserver) -> None:
        self.observers.append(observer)

    def process(self, request: Request, params: RequestProcessParameters) -> None:
        if self._pool is not None:
            self._pool.submit(self._process_locked, request, params)
        else:
            self._process_locked(request, params)

    def _process_locked(self, request, params):
        try:
            with self._lock:
                rcb = self.build_rcb(request, params)
            for obs in self.observers:
                obs.update(rcb)
        except Exception:
            logger.exception(f"request {request.request_id} processing failed")
            # terminate the caller's stream: a malformed request must not
            # leave it waiting on tokens that never come
            for proc in params.output_token_processors:
                try:
                    proc.append_token_id(-1, True)
                except Exception:
                    logger.exception(
                        f"request {request.request_id} stream-terminate failed")

    def build_rcb(self, request: Request,
                  params: RequestProcessParameters) -> RequestControlBlock:
        rcb = RequestControlBlock()
        rcb.request_id = request.request_id
        rcb.output_token_params = params.output_token_params
        for p in params.output_token_processors:
            rcb.register_output_token_processor(p)

        rcb.sampling_params = request.sampling_params
        if not request.sampling_params.ignore_eos:
            if self.eos_token_id not in rcb.sampling_params.eos_token_ids:
                rcb.sampling_params.eos_token_ids.append(self.eos_token_id)

        self._create_instructions(request, rcb)
        rcb.scenario_type = self.scenario_classifier.classify(
            n_text_tokens=rcb.request_metadata.n_text_tokens,
            n_output_tokens=request.sampling_params.max_tokens)
        return rcb

    def _decode_image(self, request: Request):
        if request.image_base64 is not None:
            from PIL import Image
            return Image.open(io.BytesIO(base64.b64decode(request.image_base64)))
        return request.image

    def _expand_image_tokens(self, token_ids: List[int], image_hashes: List[int],
                             images_size: List[tuple]):
        """Each single image token becomes a run of N image tokens; the block
        hashes take the image's content hash in place of its tokens, so
        identical prompts with different images do not alias in the prefix
        cache."""
        expanded: List[int] = []
        hash_stream: List[int] = []
        img_idx = 0
        n_image_tokens = 0
        for tid in token_ids:
            if tid == self.image_token_id:
                n = self.image_token_calculator.get_num_image_tokens(images_size[img_idx])
                expanded.extend([self.image_token_id] * n)
                hash_stream.extend([image_hashes[img_idx]] * n)
                img_idx += 1
                n_image_tokens += n
            else:
                expanded.append(tid)
                hash_stream.append(tid)
        hashes = compute_prefix_hashes(hash_stream, self.config.block_size)
        return expanded, hashes, n_image_tokens

    def _create_instructions(self, request: Request, rcb: RequestControlBlock) -> None:
        image = self._decode_image(request)
        images_size, image_hashes, pixel_values = [], [], None
        if image is not None:
            width, height = image.size
            images_size.append((height, width))
            image_hashes.append(compute_image_hash(image))
            pixel_values = self.processor.process(image)

        token_ids = self.tokenizer.encode(request.prompt)
        n_images = token_ids.count(self.image_token_id)
        token_ids, hashes, n_image_tokens = self._expand_image_tokens(
            token_ids, image_hashes, images_size)
        n_prompt = len(token_ids)
        max_tokens = request.sampling_params.max_tokens
        rcb.request_metadata = RequestMetadata(
            n_prompt_tokens=n_prompt, n_text_tokens=n_prompt - n_image_tokens,
            n_images=n_images, n_image_tokens=n_image_tokens)

        mrope_hw = None
        if self.mrope_on:
            # text advances all three axes together; an image's merged grid
            # takes t/h/w ladders from one start and the stream resumes at
            # start + max(grid): rope positions COMPRESS relative to cache ids
            pt, ph, pw, st = self._mrope_positions(token_ids, images_size)
            positions = pt + list(range(st, st + max_tokens))
            mrope_hw = [ph, pw]
        else:
            positions = list(range(n_prompt + max_tokens))

        builder = InstructionListBuilder()
        if pixel_values is not None:
            pixel_values = np.asarray(pixel_values)
            image_cache_ids = list(range(n_image_tokens))
            builder.append(ImageEmbed(
                pixel_values=pixel_values[None] if pixel_values.ndim == 3 else pixel_values,
                cache_ids=image_cache_ids, images_size=images_size,
                hashes=image_hashes))
            # the EP hand-off; a colocated node's graph points at itself
            builder.append(EPMigrate())
            builder.append(PullCache())
            prefill = ImageEmbedFill(
                image_token_cache_ids=image_cache_ids,
                image_token_mask=[t == self.image_token_id for t in token_ids],
                token_ids=token_ids, position_ids=positions[:n_prompt],
                cache_ids=list(range(n_prompt)), sample=True, sample_dst=None,
                hashes=hashes)
        else:
            prefill = TextFill(token_ids=token_ids, position_ids=positions[:n_prompt],
                               cache_ids=list(range(n_prompt)), sample=True,
                               sample_dst=None, hashes=hashes)
        prefill.mrope_hw = mrope_hw
        builder.append(prefill)
        # the PD hand-off; a colocated node's graph points at itself and the
        # node skips the pull
        builder.append(PDMigrate())
        builder.append(PullCache())

        # pre-create all decode Fills, chained via sample_dst; the -1 token is
        # resolved on device through the token table (and on host, late, by
        # the producing step's postprocess). The cache id is the physical
        # position i; the rope position may lag it under M-RoPE
        last = prefill
        for i in range(n_prompt, n_prompt + max_tokens - 1):
            decode = TextFill(token_ids=[-1], position_ids=[positions[i]],
                              cache_ids=[i], sample=True, sample_dst=None,
                              hashes=None)
            builder.append(decode)
            last.sample_dst = decode
            last = decode
        rcb.instructions = builder.build()

    def _mrope_positions(self, token_ids: List[int], images_size: List[tuple]):
        """Per-token (t, h, w) rope positions over the EXPANDED prompt, plus
        the first decode position (HF Qwen2VL get_rope_index semantics)."""
        pos_t: List[int] = []
        pos_h: List[int] = []
        pos_w: List[int] = []
        st, img, i = 0, 0, 0
        while i < len(token_ids):
            if token_ids[i] == self.image_token_id:
                t, gh, gw = self.image_token_calculator.get_image_grid(images_size[img])
                for ti in range(t):
                    for hi in range(gh):
                        pos_t.extend([st + ti] * gw)
                        pos_h.extend([st + hi] * gw)
                        pos_w.extend(range(st, st + gw))
                st += max(t, gh, gw)
                img += 1
                i += t * gh * gw
            else:
                pos_t.append(st)
                pos_h.append(st)
                pos_w.append(st)
                st += 1
                i += 1
        return pos_t, pos_h, pos_w, st
