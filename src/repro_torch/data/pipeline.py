"""Port of ``repro.data.pipeline`` (a numpy copy: its batches equal
upstream's array for array).  Deterministic host-sharded token streams
with background prefetch; the batches are numpy, and the trainer moves
them to its device.

Production posture: every host computes its own disjoint shard of the
global batch from (step, host_index) alone — no data server, no
coordination — so a restarted or replaced host resumes mid-run
deterministically (straggler/fault story, DESIGN.md §4).

Sources:
  * SyntheticSource — seeded Zipf-ish token stream (benchmarks, tests)
  * TextFileSource  — tokenized text file(s), memory-mapped token buffer
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    host_index: int = 0
    host_count: int = 1
    seed: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


class SyntheticSource:
    """Deterministic pseudo-text: Zipf-distributed tokens with local
    structure (bigram coupling) so models have something learnable."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # fixed bigram transition "grammar"
        self.trans = rng.integers(0, vocab_size, size=(vocab_size, 4))

    def tokens_for(self, step: int, row: int, length: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537 + row)
        out = np.empty(length + 1, np.int32)
        out[0] = rng.integers(0, self.vocab)
        zipf_jump = rng.random(length) < 0.3
        choices = rng.integers(0, 4, size=length)
        jumps = (rng.zipf(1.5, size=length) - 1) % self.vocab
        for i in range(length):
            out[i + 1] = (
                jumps[i] if zipf_jump[i] else self.trans[out[i], choices[i]]
            )
        return out


class TextFileSource:
    """Pre-tokenizes file(s) once into a flat int32 buffer."""

    def __init__(self, paths: list[str], tokenizer=None):
        tok = tokenizer or ByteTokenizer()
        bufs = []
        for p in paths:
            with open(p, "r", errors="replace") as f:
                bufs.append(np.asarray(tok.encode(f.read()), np.int32))
        self.buf = np.concatenate(bufs)
        self.vocab = tok.vocab_size

    def tokens_for(self, step: int, row: int, length: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537 + row)
        start = rng.integers(0, max(1, len(self.buf) - length - 1))
        return self.buf[start : start + length + 1]


def host_batch(source, cfg: DataConfig, step: int) -> dict:
    """Build this host's slice of global batch ``step``: next-token pairs."""
    rows = []
    base = cfg.host_index * cfg.host_batch
    for r in range(cfg.host_batch):
        rows.append(source.tokens_for(step, base + r, cfg.seq_len, cfg.seed))
    arr = np.stack(rows)  # (B, S+1)
    return {"tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32)}


class PrefetchIterator:
    """Background-thread prefetch of host batches."""

    def __init__(self, source, cfg: DataConfig, start_step: int = 0):
        self.source, self.cfg = source, cfg
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = host_batch(self.source, self.cfg, s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5.0)
