"""Reversible UTF-8 byte-level tokenizer (+ special ids) for real text
flowing through pool models at smoke scale."""
from __future__ import annotations

from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_N_SPECIAL = 3


class ByteTokenizer:
    vocab_size = 256 + _N_SPECIAL
    pad_id, bos_id, eos_id = PAD_ID, BOS_ID, EOS_ID

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [b + _N_SPECIAL for b in text.encode("utf-8")]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids) -> str:
        # ids >= 259 (models with vocab > 259 sampling out of byte range,
        # e.g. random-weight smoke models) fold back into byte space
        bs = bytes((int(i) - _N_SPECIAL) % 256 for i in ids
                   if int(i) >= _N_SPECIAL)
        return bs.decode("utf-8", errors="replace")
