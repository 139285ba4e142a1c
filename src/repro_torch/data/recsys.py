"""Criteo-like synthetic recsys stream with a planted logistic model (a
copy of the JAX package's ``data/recsys.py``, numpy only).

Dense features ~ lognormal; sparse ids ~ per-field Zipf(1.2) (hot-head
skew like production traffic: id 0 is ~18% of a field's draws); labels
drawn from a ground-truth logistic model over a random projection of
(dense, id hash buckets), so AUC has headroom above 0.5 and training
curves are meaningful.  Deterministic in (seed, step) for resumable
pipelines, and equal to the JAX package's batches for the same
``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class RecsysStream:
    batch: int
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 1234)
        self._w_dense = rng.normal(size=self.n_dense).astype(np.float32)
        self._w_hash = rng.normal(size=(self.n_sparse, 64)).astype(np.float32)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        dense = rng.lognormal(0.0, 1.0,
                              (self.batch, self.n_dense)).astype(np.float32)
        dense = np.log1p(dense)                       # standard Criteo prep
        z = rng.zipf(1.2, size=(self.batch, self.n_sparse))
        sparse = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        # planted CTR model
        hb = self._w_hash[np.arange(self.n_sparse)[None, :],
                          sparse % 64]                # [B, F]
        logit = dense @ self._w_dense * 0.3 + hb.sum(1) * 0.5 - 1.0
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(self.batch) < p).astype(np.int32)
        return dense, sparse, labels
