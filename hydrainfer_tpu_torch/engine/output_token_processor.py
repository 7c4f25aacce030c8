"""Output-token processors (port of
hydrainfer_tpu/engine/output_token_processor.py).

A request registers one or more processors; the fill executor calls them per
sampled token, with is_last on the request's final token.
"""
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..request import OfflineInferenceOutput
from ..utils.logger import getLogger

logger = getLogger(__name__)


@dataclass
class OutputTokenParams:
    print_output_text: bool = False
    stream_output: bool = True


class OutputTokenProcessor:
    def append_token_id(self, token_id: int, is_last_token: bool = False) -> None:
        raise NotImplementedError

    def terminate(self) -> None:
        """Abort the stream without emitting a token."""


class PrintOutputTokenProcessor(OutputTokenProcessor):
    def append_token_id(self, token_id, is_last_token=False):
        logger.info(f"output token {token_id}, last={is_last_token}")


class PrintTextOutputTokenProcessor(OutputTokenProcessor):
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def append_token_id(self, token_id, is_last_token=False):
        logger.info(f"output token {self.tokenizer.decode(token_id)!r}, "
                    f"last={is_last_token}")


class LogOutputTokenProcessor(OutputTokenProcessor):
    """Accumulates token ids (the test hook)."""

    def __init__(self):
        self.token_ids: List[int] = []
        self.finished = False
        self.terminated = False

    def append_token_id(self, token_id, is_last_token=False):
        self.token_ids.append(token_id)
        if is_last_token:
            self.finished = True

    def terminate(self):
        self.finished = True
        self.terminated = True


class CallbackOutputTokenProcessor(OutputTokenProcessor):
    """In-process streaming: delivers (token_id, text, is_last) straight to
    the API layer. The text comes from a per-request incremental
    detokenizer, so multi-byte characters stream whole."""

    def __init__(self, callback: Callable[[int, str, bool], None], tokenizer):
        from ..models.tokenizer import IncrementalDecoder
        self.callback = callback
        self.decoder = IncrementalDecoder(tokenizer)

    def append_token_id(self, token_id, is_last_token=False):
        self.callback(token_id, self.decoder.push(token_id), is_last_token)

    def terminate(self):
        self.callback(-1, "", True)


class ZmqOutputTokenProcessor(OutputTokenProcessor):
    """Cross-process streaming: (request_id, text) tuples over a ZMQ PUSH
    socket, with a None-text terminator (what an API server's
    `zmq_pull_addr` receives)."""

    def __init__(self, request_id, zmq_send, tokenizer):
        from ..models.tokenizer import IncrementalDecoder
        self.request_id = request_id
        self.zmq_send = zmq_send
        self.decoder = IncrementalDecoder(tokenizer)

    def append_token_id(self, token_id, is_last_token=False):
        self.zmq_send.send_pyobj((self.request_id, self.decoder.push(token_id)))
        if is_last_token:
            self.zmq_send.send_pyobj((self.request_id, None))

    def terminate(self):
        self.zmq_send.send_pyobj((self.request_id, None))


class OfflineOutputTokenProcessor(OutputTokenProcessor):
    """Fills an OfflineInferenceOutput with ttft/tpot bookkeeping."""

    def __init__(self, output: OfflineInferenceOutput, tokenizer,
                 on_finish: Optional[Callable] = None):
        self.output = output
        self.tokenizer = tokenizer
        self.on_finish = on_finish

    def append_token_id(self, token_id, is_last_token=False):
        now = time.perf_counter()
        self.output.output_token_ids.append(token_id)
        self.output.token_times.append(now)
        if len(self.output.output_token_ids) == 1:
            self.output.ttft = now - self.output.arrival_time
        else:
            self.output.tpot = now - self.output.token_times[-2]
        if is_last_token:
            self._finish(now)

    def terminate(self):
        self._finish(time.perf_counter())

    def _finish(self, now: float) -> None:
        self.output.finished_time = now
        self.output.text = self.tokenizer.decode_ids(self.output.output_token_ids)
        if self.on_finish is not None:
            self.on_finish(self.output)
