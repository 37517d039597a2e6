"""Deterministic synthetic LM data pipeline with a checkpointable cursor.

The stream is a seeded Zipfian token process with induced bigram structure so
tiny models have something learnable (loss decreases measurably within a few
hundred steps). ``state()``/``restore()`` make the pipeline resumable —
restarting from a checkpoint replays the exact same batch sequence.

A copy of the JAX package's ``repro/data/tokens.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np


class TokenDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, input_kind: str = "tokens",
                 d_model: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.input_kind = input_kind
        self.d_model = d_model
        self._step = 0
        # learnable structure: each token deterministically prefers a
        # successor; noise makes it a distribution
        rng = np.random.default_rng(seed)
        self._succ = rng.permutation(vocab_size)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._zipf = (1.0 / ranks) / np.sum(1.0 / ranks)

    # -- cursor (for fault-tolerant resume) ------------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: dict):
        assert state["seed"] == self.seed, "dataset seed mismatch"
        self._step = int(state["step"])

    # -- batches ------------------------------------------------------------------
    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self._zipf)
        follow = rng.random((B, S)) < 0.6     # 60% bigram-following
        fresh = rng.choice(V, size=(B, S), p=self._zipf)
        for t in range(S):
            nxt = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        batch = {"labels": toks[:, 1:].astype(np.int32)}
        if self.input_kind == "embeds":
            emb_rng = np.random.default_rng((self.seed, self._step, 7))
            batch["embeds"] = emb_rng.standard_normal(
                (B, S, self.d_model)).astype(np.float32) * 0.02
        else:
            batch["tokens"] = toks[:, :-1].astype(np.int32)
        return batch
