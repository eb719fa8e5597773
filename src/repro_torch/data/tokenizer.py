"""Tokenizers for the serving/training substrate.

The join-operator *cost accounting* uses the lightweight counter in
``repro.core.accounting`` (backend-independent, like pricing by the API's
tokenizer).  The substrate below needs real, reversible token ids for the
hosted models, with vocab sizes dictated by each architecture config
(2,048 for musicgen EnCodec codes up to 131,072 for grok/pixtral).

* :class:`ByteTokenizer` — byte-level, lossless for any text, works with any
  ``vocab_size >= 259``; ids above the byte range are reserved (real
  deployments would fill them with BPE merges — the id space and special
  tokens match, which is what the serving engine needs).
* :class:`HashWordTokenizer` — words hashed into the vocab; not reversible
  byte-exactly but produces realistic (short) sequences for large-vocab
  demo runs; decode returns placeholder words from an id-keyed cache.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence


class SpecialTokens:
    PAD = 0
    BOS = 1
    EOS = 2
    SEP = 3
    N_SPECIAL = 4


class ByteTokenizer:
    """Lossless byte-level tokenizer: id = byte + N_SPECIAL."""

    def __init__(self, vocab_size: int):
        if vocab_size < 256 + SpecialTokens.N_SPECIAL:
            raise ValueError(f"vocab_size {vocab_size} too small for byte tokenizer")
        self.vocab_size = vocab_size
        self.pad_id = SpecialTokens.PAD
        self.bos_id = SpecialTokens.BOS
        self.eos_id = SpecialTokens.EOS

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [b + SpecialTokens.N_SPECIAL for b in text.encode("utf-8")]
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - SpecialTokens.N_SPECIAL
            for i in ids
            if SpecialTokens.N_SPECIAL <= i < 256 + SpecialTokens.N_SPECIAL
        )
        return data.decode("utf-8", errors="replace")


_WORD_RE = re.compile(r"\w+|[^\w\s]|\s")


class HashWordTokenizer:
    """Words/punctuation hashed into [N_SPECIAL, vocab). Decode uses the
    inverse cache populated during encode (sufficient for round-tripping the
    engine's own prompts/answers within one process)."""

    def __init__(self, vocab_size: int):
        if vocab_size < 1024:
            raise ValueError("HashWordTokenizer needs vocab_size >= 1024")
        self.vocab_size = vocab_size
        self.pad_id = SpecialTokens.PAD
        self.bos_id = SpecialTokens.BOS
        self.eos_id = SpecialTokens.EOS
        self._inverse: Dict[int, str] = {}

    def _word_id(self, w: str) -> int:
        h = hashlib.blake2b(w.encode(), digest_size=8).digest()
        rid = int.from_bytes(h[:4], "little")
        wid = SpecialTokens.N_SPECIAL + rid % (self.vocab_size - SpecialTokens.N_SPECIAL)
        self._inverse.setdefault(wid, w)
        return wid

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [self._word_id(w) for w in _WORD_RE.findall(text)]
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            self._inverse.get(i, "") for i in ids if i >= SpecialTokens.N_SPECIAL
        )


def make_tokenizer(vocab_size: int, kind: str = "byte"):
    if kind == "byte":
        return ByteTokenizer(vocab_size)
    if kind == "hashword":
        return HashWordTokenizer(vocab_size)
    raise ValueError(f"unknown tokenizer kind {kind!r}")
