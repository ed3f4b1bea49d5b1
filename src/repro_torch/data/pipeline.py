"""Deterministic, stateless-resumable synthetic data pipeline.

The port of the JAX package's ``data/pipeline.py``, which draws its
batches with numpy alone: every batch is a pure function of (seed, host,
step) through numpy's Philox generator, so a restart at step k reproduces
exactly the batches a run that never failed would have seen, and hosts
shard the batch with no coordination.  The batches are the JAX package's
bit for bit: int32 numpy arrays, which the caller moves to its device.

Batches are token/label pairs for the LM; modality frontends (audio
frames, vision patches) are stubs, synthesized as embeddings directly where
needed (``models.config.input_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Host-sharding: this host produces rows [host_index*rows : ...+rows).
    host_index: int = 0
    host_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide by host_count")
        return self.global_batch // self.host_count

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels), each (local_batch, seq_len) int32, pure f(step)."""
        # numpy Philox keyed on (seed, host | step) = stateless & coordination-free
        rng = np.random.default_rng(
            np.random.Philox(
                key=[(self.seed << 20) ^ self.host_index, (step << 1) | 1]
            )
        )
        tokens = rng.integers(
            0, self.vocab_size, size=(self.local_batch, self.seq_len + 1), dtype=np.int64
        ).astype(np.int32)
        return tokens[:, :-1], tokens[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
