"""Deterministic synthetic data pipeline with per-host sharding (a copy of
``repro/data/pipeline.py``: numpy only, so batches are bitwise the
reference's).

Production shape: each host feeds only its slice of the global batch; the
global batch is (re)constructible from (seed, step) alone, so a restarted or
re-meshed job resumes mid-epoch with zero coordination — the data half of
the fault-tolerance story (train.loop restores the step counter from the
checkpoint; the pipeline is pure state-free indexing after that).

The token stream is a mixture of Zipf-distributed "unigram" tokens and
repeated n-gram motifs so the LM loss actually decreases — enough signal for
the end-to-end examples without external corpora (the container is offline).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    num_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    num_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticLM:
    """Deterministic (seed, step) → batch generator."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"num_hosts {cfg.num_hosts}"
            )
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.num_hosts
        root = np.random.default_rng(cfg.seed)
        # motif bank (shared across hosts — derived from the seed only)
        self.motifs = root.integers(
            0, cfg.vocab_size, size=(cfg.num_motifs, cfg.motif_len), dtype=np.int32
        )
        # Zipf weights over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self.probs = w / w.sum()

    def _rng_for(self, step: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id])
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The host-local slice of global batch ``step``: tokens + labels."""
        c = self.cfg
        rng = self._rng_for(step)
        B, S = self.host_batch, c.seq_len
        toks = rng.choice(c.vocab_size, size=(B, S + 1), p=self.probs).astype(
            np.int32
        )
        # overwrite random spans with motifs (learnable structure)
        n_spans = int(c.motif_prob * (S // c.motif_len))
        if n_spans:
            for b in range(B):
                starts = rng.integers(0, S + 1 - c.motif_len, size=n_spans)
                ids = rng.integers(0, c.num_motifs, size=n_spans)
                for s0, mid in zip(starts, ids):
                    toks[b, s0 : s0 + c.motif_len] = self.motifs[mid]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def global_batch_for_test(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Assemble the full global batch by concatenating every host's slice —
    used by tests to assert host-sharding is a partition of the global batch."""
    parts = []
    for h in range(cfg.num_hosts):
        ds = SyntheticLM(dataclasses.replace(cfg, host_id=h))
        parts.append(ds.batch(step))
    return {
        k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
    }
