"""Synthetic token pipeline for LM training (copy of
`repro/data/tokens.py`, numpy only, so a seed gives the JAX package's
batches exactly): deterministic, seekable (exact resume after restart — the
fault-tolerance contract), with a planted bigram structure so loss visibly
decreases."""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Infinite deterministic stream of (tokens, labels) batches.

    Seekable: `state()` returns the step counter; constructing with
    `start_step` resumes bit-identically (checkpoint/restart safe).
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 start_step: int = 0):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = seed
        self.step = start_step
        # planted bigram table: next-token = perm[token] with prob .8
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab)

    def state(self) -> int:
        return self.step

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed, self.step))
        b, s, v = self.batch, self.seq_len, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < 0.2
        rand = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
