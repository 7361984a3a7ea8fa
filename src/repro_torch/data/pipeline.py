"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``; numpy, so its batches equal the reference's
array for array).

Produces a reproducible Markov-ish token stream (a fixed random transition
table drives next-token structure, so a model can actually reduce loss on
it; pure-uniform tokens would have irreducible loss log V). Batches are
per-host sharded: each host materializes only its slice of the global batch
(shape [global_batch // num_hosts, seq]).

Determinism: batch i of run (seed) is identical regardless of host count or
restart point, which exact checkpoint-resume equivalence needs.

``batch_spec`` is one global batch as meta tensors, for the dry-run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..training.loss import IGNORE


def batch_spec(global_batch: int, seq_len: int) -> dict:
    """One global batch as meta int32 tensors (shapes and dtypes, no data;
    the reference's ShapeDtypeStructs)."""
    return {k: torch.empty((global_batch, seq_len), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}


@dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8        # next-token candidates per state (entropy knob)
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self) -> None:
        assert self.global_batch % self.num_hosts == 0
        rng = np.random.default_rng(self.seed)
        # fixed transition structure: state -> `branching` candidate tokens
        self._table = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching),
            dtype=np.int64)

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _gen_sequences(self, step: int) -> np.ndarray:
        """[host_batch, seq_len + 1] tokens for global batch index `step`."""
        n = self.host_batch
        # per-(step, global row) independent streams => host-count invariant
        rows = np.arange(n) + self.host_id * n
        out = np.empty((n, self.seq_len + 1), dtype=np.int64)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 65_537 + r)
            toks = np.empty(self.seq_len + 1, dtype=np.int64)
            toks[0] = rng.integers(0, self.vocab_size)
            picks = rng.integers(0, self.branching, size=self.seq_len)
            for t in range(self.seq_len):
                toks[t + 1] = self._table[toks[t], picks[t]]
            out[i] = toks
        return out

    def batch(self, step: int) -> dict[str, np.ndarray]:
        seqs = self._gen_sequences(step)
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def mask_prefix(labels: np.ndarray, n: int) -> np.ndarray:
    """Exclude the first n positions from the loss (prompt masking)."""
    out = labels.copy()
    out[:, :n] = IGNORE
    return out
