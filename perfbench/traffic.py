"""The benchmark's token generator: a frozen copy of the port's
``data/pipeline.SyntheticLM`` (numpy only), so that a later change to the
program's pipeline does not move the yardstick.

A batch is a pure function of (seed, step): Zipf-distributed tokens with
repeated 16-token motifs written over random spans.  ``tokens`` and
``labels`` are the first and last ``seq_len`` of ``seq_len + 1`` drawn
tokens of each row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mix:
    vocab_size: int
    seq_len: int
    rows: int
    seed: int
    zipf_a: float = 1.2
    motif_len: int = 16
    num_motifs: int = 64
    motif_prob: float = 0.5


class Generator:
    """(seed, step) -> {"tokens", "labels"}, each (rows, seq_len) int32."""

    def __init__(self, mix: Mix):
        self.mix = mix
        root = np.random.default_rng(mix.seed)
        self.motifs = root.integers(0, mix.vocab_size, size=(mix.num_motifs, mix.motif_len),
                                    dtype=np.int32)
        w = np.arange(1, mix.vocab_size + 1, dtype=np.float64) ** (-mix.zipf_a)
        self.probs = w / w.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        m = self.mix
        rng = np.random.default_rng(np.random.SeedSequence([m.seed, step, 0]))
        toks = rng.choice(m.vocab_size, size=(m.rows, m.seq_len + 1),
                          p=self.probs).astype(np.int32)
        n_spans = int(m.motif_prob * (m.seq_len // m.motif_len))
        if n_spans:
            for b in range(m.rows):
                starts = rng.integers(0, m.seq_len + 1 - m.motif_len, size=n_spans)
                ids = rng.integers(0, m.num_motifs, size=n_spans)
                for s0, mid in zip(starts, ids):
                    toks[b, s0:s0 + m.motif_len] = self.motifs[mid]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def from_files(config: dict, mix: dict, seed: int) -> Generator:
    """The generator of a cell: the configuration's vocabulary, the mix's
    rows, length and parameters, and the run's seed."""
    return Generator(Mix(vocab_size=config["port"]["vocab_size"], seq_len=mix["seq_len"],
                         rows=mix["rows"], seed=seed, **mix["generator"]))
