"""Deterministic synthetic LM token pipeline.

The counterpart of ``repro.data.tokens``. Every batch is a pure function of
(seed, step), so a restored checkpoint resumes on exactly the batches it
would have seen. A Markov-ish structure makes the stream learnable: each
next token is (tok * 7 + 1) % vocab, or (tok * 31 + 17) % vocab at the 15 %
noise positions; labels are the tokens shifted by one, -1 last.

The draws come from numpy's generator seeded with (seed, step), not from
``jax.random``: the rule is the reference's, the bits are not. The parity
tests feed the reference's batches to the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        return synthetic_batch(self.vocab, self.batch, self.seq,
                               self.seed, step)


def synthetic_batch(vocab: int, batch: int, seq: int, seed: int,
                    step: int) -> dict:
    """{"tokens", "labels"}: [batch, seq] int32 CPU tensors."""
    rng = np.random.default_rng([seed, step])
    tok = rng.integers(0, vocab, batch, dtype=np.int64)
    noise = rng.random((batch, seq - 1)) < 0.15
    tokens = np.empty((batch, seq), np.int64)
    tokens[:, 0] = tok
    for t in range(seq - 1):
        tok = np.where(noise[:, t], (tok * 31 + 17) % vocab,
                       (tok * 7 + 1) % vocab)
        tokens[:, t + 1] = tok
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1)], axis=1)
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)),
            "labels": torch.from_numpy(labels.astype(np.int32))}
