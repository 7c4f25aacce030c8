"""Tokenizers (port of hydrainfer_tpu/models/tokenizer.py: SimpleTokenizer and
HFTokenizerAdapter)."""
from typing import List

from .factory import Tokenizer


class HFTokenizerAdapter(Tokenizer):
    """A transformers tokenizer behind the engine's Tokenizer contract."""

    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer

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
