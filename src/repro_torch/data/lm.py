"""Deterministic, resumable LM token pipeline (a copy of the JAX
package's ``data/lm.py``, numpy only).

Batches are a pure function of (seed, step): restart-from-checkpoint
reproduces the exact stream with no persisted iterator state, so the
checkpoint manifest needs only the step counter.  Synthetic mode draws
Zipf-distributed tokens with a planted bigram structure (so loss curves
have signal); file mode shards a byte-level corpus.  For the same
``(seed, step)`` both packages give the same batch, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    path: Optional[str] = None      # byte corpus; synthetic if None

    def __post_init__(self):
        self._corpus = None
        if self.path is not None:
            self._corpus = np.fromfile(self.path, dtype=np.uint8)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for ``step``, a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        if self._corpus is not None:
            n = self._corpus.shape[0] - self.seq_len - 1
            starts = rng.integers(0, n, size=self.batch)
            toks = np.stack([self._corpus[s: s + self.seq_len + 1]
                             for s in starts]).astype(np.int32)
            return toks[:, :-1], toks[:, 1:]
        # Synthetic: Zipf marginals + deterministic "grammar" y = (3x+7)%V
        # half the time, so a model can learn something.
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        flip = rng.random((self.batch, self.seq_len)) < 0.5
        nxt = (3 * toks[:, :-1] + 7) % self.vocab
        labels = np.where(flip, nxt, toks[:, 1:]).astype(np.int32)
        tokens = toks[:, :-1].copy()
        tokens[:, 1:] = labels[:, :-1]  # teacher-forced continuation
        return tokens, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
