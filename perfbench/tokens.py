"""Token batches of a cell, made from the run's seed.

A frozen copy of the program's synthetic stream rule (``data/tokens.py``
of the port): each row starts at a random token, and each next token is
(tok * 7 + 1) % vocab, or (tok * 31 + 17) % vocab at the 15 % noise
positions; labels are the tokens shifted by one, -1 at the end. Batch
``i`` of seed ``s`` comes from numpy's generator seeded with (s, i), so
every batch of a run differs and a seed gives the same batches on every
run.
"""
from __future__ import annotations

import numpy as np
import torch


def batch(vocab: int, rows: int, seq: int, seed: int, index: int) -> dict:
    """{"tokens", "labels"}: [rows, seq] int32 CPU tensors."""
    rng = np.random.default_rng([int(seed), int(index)])
    tok = rng.integers(0, vocab, rows, dtype=np.int64)
    noise = rng.random((rows, seq - 1)) < 0.15
    tokens = np.empty((rows, seq), np.int64)
    tokens[:, 0] = tok
    for t in range(seq - 1):
        tok = np.where(noise[:, t], (tok * 31 + 17) % vocab,
                       (tok * 7 + 1) % vocab)
        tokens[:, t + 1] = tok
    labels = np.concatenate([tokens[:, 1:], np.full((rows, 1), -1)], axis=1)
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)),
            "labels": torch.from_numpy(labels.astype(np.int32))}
