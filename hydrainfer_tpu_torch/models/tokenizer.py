"""Tokenizers (port of hydrainfer_tpu/models/tokenizer.py: IncrementalDecoder,
HFTokenizerAdapter and SimpleTokenizer).

Streaming text comes from IncrementalDecoder: it decodes a growing window
of ids and emits the text delta, so a multi-byte UTF-8 character split
across byte-level BPE tokens streams whole, not as replacement characters.
"""
from typing import List

from .factory import Tokenizer


class IncrementalDecoder:
    """Per-request streaming detokenizer.

    Decodes with a growing prefix window so byte-level BPE multi-byte
    characters and SentencePiece word boundaries come out exactly as a full
    decode would; emits only the new text each push. Holds back output while
    the window ends in an incomplete UTF-8 sequence (the replacement char) or
    a high surrogate, and never emits text that cannot be UTF-8 encoded.
    """

    def __init__(self, tokenizer: Tokenizer):
        self.tok = tokenizer
        self.ids: List[int] = []
        self.prefix_offset = 0   # window start
        self.read_offset = 0     # ids already reflected in emitted text

    def push(self, token_id: int) -> str:
        if token_id is None or int(token_id) < 0:
            return ""
        self.ids.append(int(token_id))
        prefix_text = self.tok.decode_ids(self.ids[self.prefix_offset:self.read_offset])
        new_text = self.tok.decode_ids(self.ids[self.prefix_offset:])
        if new_text.endswith("\ufffd"):
            # incomplete multi-byte character: wait for the next token
            return ""
        if new_text and 0xD800 <= ord(new_text[-1]) <= 0xDBFF:
            # trailing high surrogate: the next token's bytes may complete it
            return ""
        delta = new_text[len(prefix_text):]
        self.prefix_offset = self.read_offset
        self.read_offset = len(self.ids)
        try:
            delta.encode("utf-8")
        except UnicodeEncodeError:
            # a lone surrogate would break every UTF-8 encode downstream (the
            # SSE writer, json.dump): never let one out
            delta = delta.encode("utf-8", errors="replace").decode("utf-8")
        return delta


class HFTokenizerAdapter(Tokenizer):
    """A transformers tokenizer behind the engine's Tokenizer contract;
    `chat_template` replaces the tokenizer's own."""

    def __init__(self, hf_tokenizer, chat_template: str = None):
        self.tok = hf_tokenizer
        if chat_template is not None:
            self.tok.chat_template = chat_template

    def encode(self, prompt: str) -> List[int]:
        return self.tok.encode(prompt)

    def decode(self, token_id: int) -> str:
        tid = int(token_id)
        if tid < 0 or tid in (self.tok.all_special_ids or []):
            return ""
        token = self.tok.convert_ids_to_tokens(tid)
        if token is None:
            return ""
        text = self.tok.convert_tokens_to_string([token])
        # SentencePiece drops the word-boundary marker of a lone token
        if isinstance(token, str) and token.startswith("▁") and not text.startswith(" "):
            text = " " + text
        return text

    def decode_ids(self, token_ids: List[int]) -> str:
        ids = [int(t) for t in token_ids if int(t) >= 0]
        return self.tok.decode(ids, skip_special_tokens=True) if ids else ""

    def apply_chat_template(self, messages: List[dict]) -> str:
        return self.tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)


class SimpleTokenizer(Tokenizer):
    """Deterministic weightless tokenizer for engine tests and random-weight
    models: one token per unicode codepoint, offset past special ids."""

    OFFSET = 10

    def __init__(self, image_token: str = "<image>", image_token_id: int = 9,
                 eos_token_id: int = 2):
        self.image_token = image_token
        self.image_token_id = image_token_id
        self.eos_token_id = eos_token_id

    def encode(self, prompt: str) -> List[int]:
        ids: List[int] = []
        rest = prompt
        while rest:
            if rest.startswith(self.image_token):
                ids.append(self.image_token_id)
                rest = rest[len(self.image_token):]
            else:
                ids.append(ord(rest[0]) + self.OFFSET)
                rest = rest[1:]
        return ids

    def decode(self, token_id: int) -> str:
        tid = int(token_id)
        if tid < self.OFFSET:
            return ""
        return chr(tid - self.OFFSET)

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(parts) + "\nassistant:"
