"""Port of ``repro.data.tokenizer`` (a copy: pure Python and numpy, the
same merges, ids and JSON file, so a tokenizer saved by either package
loads in the other).  A byte-level tokenizer (always available) and a
small trainable BPE (paper: "BPE tokenizer with a vocabulary size of 32K").

The BPE here is a faithful, self-contained implementation — greedy pair
merges learned from a corpus sample — adequate for the CPU-scale training
runs in examples/ and benchmarks/.  Vocabulary layout:
  [0] pad  [1] bos  [2] eos  [3..258] bytes  [259..] merges
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterable, Sequence

import numpy as np

PAD, BOS, EOS = 0, 1, 2
BYTE_OFFSET = 3


class ByteTokenizer:
    """Raw bytes + specials; vocab 259."""

    vocab_size = BYTE_OFFSET + 256

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + BYTE_OFFSET for b in text.encode("utf-8")]
        return ([BOS] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - BYTE_OFFSET for i in ids if i >= BYTE_OFFSET)
        return bs.decode("utf-8", errors="replace")


class BPETokenizer:
    """Byte-level BPE with learned merges."""

    def __init__(self, merges: list[tuple[int, int]] | None = None):
        self.merges: list[tuple[int, int]] = merges or []
        self._ranks = {tuple(m): i for i, m in enumerate(self.merges)}

    @property
    def vocab_size(self) -> int:
        return BYTE_OFFSET + 256 + len(self.merges)

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int, max_bytes: int = 1 << 22):
        """Greedy BPE merge learning over a corpus sample."""
        data: list[int] = []
        for text in corpus:
            data.extend(b + BYTE_OFFSET for b in text.encode("utf-8"))
            if len(data) >= max_bytes:
                break
        seq = np.asarray(data, np.int32)
        merges: list[tuple[int, int]] = []
        next_id = BYTE_OFFSET + 256
        while next_id < vocab_size and len(seq) > 1:
            pairs = collections.Counter(zip(seq[:-1].tolist(), seq[1:].tolist()))
            if not pairs:
                break
            (a, b), cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            merges.append((a, b))
            # apply merge
            out = []
            i = 0
            n = len(seq)
            sl = seq.tolist()
            while i < n:
                if i < n - 1 and sl[i] == a and sl[i + 1] == b:
                    out.append(next_id)
                    i += 2
                else:
                    out.append(sl[i])
                    i += 1
            seq = np.asarray(out, np.int32)
            next_id += 1
        return cls(merges)

    # -- encode/decode -----------------------------------------------------
    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + BYTE_OFFSET for b in text.encode("utf-8")]
        if self._ranks:
            while len(ids) > 1:
                best_rank, best_i = None, None
                for i in range(len(ids) - 1):
                    r = self._ranks.get((ids[i], ids[i + 1]))
                    if r is not None and (best_rank is None or r < best_rank):
                        best_rank, best_i = r, i
                if best_i is None:
                    break
                ids[best_i : best_i + 2] = [BYTE_OFFSET + 256 + best_rank]
        return ([BOS] if add_bos else []) + ids

    def _expand(self, tok: int, out: list[int]):
        if tok < BYTE_OFFSET + 256:
            out.append(tok)
            return
        a, b = self.merges[tok - BYTE_OFFSET - 256]
        self._expand(a, out)
        self._expand(b, out)

    def decode(self, ids: Sequence[int]) -> str:
        flat: list[int] = []
        for t in ids:
            if t >= BYTE_OFFSET:
                self._expand(int(t), flat)
        return bytes(i - BYTE_OFFSET for i in flat).decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------
    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"merges": self.merges}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]])
