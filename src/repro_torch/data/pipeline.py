"""Deterministic synthetic LM data pipeline (the JAX package's
``data/pipeline.py``, which imports no JAX, copied so that the port stands
alone).

Multi-host layout: each host generates only its batch shard, derived purely
from ``(seed, step, host_id)`` — no coordination, bit-identical restarts.
The iterator state is a single integer (``step``), checkpointed alongside
the model so a restore resumes the exact stream (fault-tolerance contract).

The stream is an affine token recurrence with noise so that small models can
visibly learn it (loss-decreases tests / example runs), while the marginal
distribution stays near-uniform over the vocab. Batches are numpy arrays;
the model moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    noise: float = 0.1
    step: int = 0  # checkpointable iterator state

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = self.global_batch // self.n_hosts

    # -- stream --------------------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The (deterministic) host-local batch for a given step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.host_batch, self.seq_len, self.vocab_size
        x = np.empty((b, s + 1), np.int64)
        x[:, 0] = rng.integers(0, v, size=b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = (x[:, t] * 31 + 7) % v
            x[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": x.astype(np.int32)}

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed,
                "host_id": self.host_id}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.seed, "data seed mismatch on restore"
        self.step = int(state["step"])
